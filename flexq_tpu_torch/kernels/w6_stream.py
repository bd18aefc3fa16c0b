"""W6Ax matmul for K-tall decode shapes (port of
flexq_tpu/kernels/w6_stream.py::w6_matmul_stream).

The same function as ``w6_matmul`` and the same source
(csrc/w6ax_matmul.cu), for M <= 32 and K > N (down_proj at decode), where
the reference dispatches to its stream kernel. The route is
``int_matmul.w6ax_route``'s: up to STREAM_MAX_M[6] rows the streaming
route, whose blocks each stream a range of 128-deep groups of one
128-column tile through an 8-stage TMA ring of 128-byte plane row
segments. With N = 4096 there are only 32 column tiles, so K is split over
blocks (four for LLaMA-2-7B's 11264 -> 4096): each writes its groups' f32
terms to a scratch, and the last block of a tile to arrive adds them in
group order, so every output still sums as the plain version does. Above
the threshold, the int8 tensor cores. On the TPU the counterpart was a
manual triple-buffered DMA loop over K.
"""

from __future__ import annotations

import torch

from flexq_tpu_torch.kernels.common import on_card
from flexq_tpu_torch.kernels.int_matmul import launch
from flexq_tpu_torch.kernels.w6_matmul import check_operands, w6_matmul_plain


def w6_matmul_stream(x_q, x_scale, w_hi, w_lo, w_scale, *, out_dtype=torch.bfloat16):
    m = x_q.shape[0]
    if m > 32:
        raise ValueError(f"w6_matmul_stream is for decode shapes (M <= 32), got M={m}")
    check_operands(x_q, x_scale, w_hi, w_lo, w_scale)
    if not on_card(x_q):
        return w6_matmul_plain(x_q, x_scale, w_hi, w_lo, w_scale, out_dtype)
    out = launch(6, x_q, x_scale, (w_hi, w_lo), w_scale, out_dtype)
    w6_matmul_stream.launches += 1
    return out


w6_matmul_stream.launches = 0
