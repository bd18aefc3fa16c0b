"""W6Ax quantized matmul (port of flexq_tpu/kernels/w6_matmul.py::w6_matmul).

    out[m, n] = sum_g (sum_{k in g} x_q * w_q) * x_scale[m, g] * w_scale[g, n]

with the weights as stored by packing/pack6.py (biased u6 nibble + crumb
planes, N-minor). The kernel is ``csrc/w6ax_matmul.cu`` (format 6) in one
of two routes that ``int_matmul.w6ax_route`` picks from (M, K, N): int8 tensor
cores (wgmma) for prompts, a streaming kernel for decode. Both are
bit-exact against ``w6_matmul_plain`` (``int_matmul.grouped_matmul_plain``
over the unpacked weight). Both read the planes, scales and codes with TMA,
so every base must be 16-byte aligned and N a multiple of 16; other
operands raise rather than fall back.
"""

from __future__ import annotations

import torch

from flexq_tpu_torch.kernels.common import GROUP_SIZE, check_tensor, count_launch, on_card
from flexq_tpu_torch.kernels.int_matmul import check_activations, grouped_matmul_plain, launch, plain_weight, split_k_warps
from flexq_tpu_torch.packing.pack6 import unpack6


def w6_matmul_plain(x_q, x_scale, w_hi, w_lo, w_scale, out_dtype=torch.float32):
    return grouped_matmul_plain(x_q, x_scale, plain_weight((w_hi, w_lo), unpack6), w_scale, out_dtype)


def check_operands(x_q, x_scale, w_hi, w_lo, w_scale) -> None:
    check_activations(x_q, x_scale)
    k, n, dev = x_q.shape[1], w_hi.shape[1], x_q.device
    check_tensor(w_hi, "w_hi", torch.int8, (k // 2, n), dev)
    check_tensor(w_lo, "w_lo", torch.int8, (k // 4, n), dev)
    check_tensor(w_scale, "w_scale", torch.float32, (k // GROUP_SIZE, n), dev)


def w6_matmul(
    x_q: torch.Tensor,  # int8 [M, K] quantized activations (6- or 8-bit values)
    x_scale: torch.Tensor,  # f32 [M, K/128]
    w_hi: torch.Tensor,  # int8 [K/2, N]
    w_lo: torch.Tensor,  # int8 [K/4, N]
    w_scale: torch.Tensor,  # f32 [K/128, N]
    *,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Exact W6Ax GEMM. Like the reference's dispatch, K-tall decode shapes
    (M <= 32, K > N: down_proj) go to ``w6_matmul_stream``."""
    m, k = x_q.shape
    n = w_hi.shape[1]
    if split_k_warps(m, k, n) == 16:
        from flexq_tpu_torch.kernels.w6_stream import w6_matmul_stream

        return w6_matmul_stream(x_q, x_scale, w_hi, w_lo, w_scale, out_dtype=out_dtype)
    check_operands(x_q, x_scale, w_hi, w_lo, w_scale)
    if not on_card(x_q):
        return w6_matmul_plain(x_q, x_scale, w_hi, w_lo, w_scale, out_dtype)
    out = launch(6, x_q, x_scale, (w_hi, w_lo), w_scale, out_dtype)
    count_launch(w6_matmul, m)
    return out


w6_matmul.launches = 0
w6_matmul.launches_by_m = {}  # M -> launches, beside the count (zeroed with it)
