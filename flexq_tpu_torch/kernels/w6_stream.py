"""W6Ax matmul for K-tall decode shapes (port of
flexq_tpu/kernels/w6_stream.py::w6_matmul_stream).

The same function as ``w6_matmul`` (same CUDA source, csrc/int_matmul.cu) in
the launch shape for M <= 32 and K > N (down_proj at decode): 16 warps per
block split K, so each block keeps twice the plane bytes in flight of the
grid launch; with N small there are few column blocks to spread over the
card otherwise. On the TPU the counterpart was a manual triple-buffered DMA
loop over K.
"""

from __future__ import annotations

import torch

from flexq_tpu_torch.kernels.int_matmul import launch
from flexq_tpu_torch.kernels.w6_matmul import check_operands, w6_matmul_plain


def w6_matmul_stream(x_q, x_scale, w_hi, w_lo, w_scale, *, out_dtype=torch.bfloat16):
    m = x_q.shape[0]
    if m > 32:
        raise ValueError(f"w6_matmul_stream is for decode shapes (M <= 32), got M={m}")
    check_operands(x_q, x_scale, w_hi, w_lo, w_scale)
    if x_q.device.type == "cpu":
        return w6_matmul_plain(x_q, x_scale, w_hi, w_lo, w_scale, out_dtype)
    if x_q.device.type != "cuda":
        raise ValueError(f"unsupported device {x_q.device}")
    out = launch(6, x_q, x_scale, w_hi, w_lo, w_scale, out_dtype, ks=16)
    w6_matmul_stream.launches += 1
    return out


w6_matmul_stream.launches = 0
