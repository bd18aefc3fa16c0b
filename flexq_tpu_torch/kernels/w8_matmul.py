"""W8A8 dense-int8 matmul (port of flexq_tpu/kernels/w8_matmul.py::w8_matmul,
K12), the SmoothQuant-baseline GEMM:

    out[m, n] = sum_g (sum_{k in g} x_q * w_q) * x_scale[m, g] * w_scale[g, n]

with int8 weights stored dense [K, N] (no bias). The kernel is
``csrc/w6ax_matmul.cu`` with the format parameter 8 (its two routes,
``int_matmul.w6ax_route`` picks; see its header for the design and the
bound); the plain version follows its order of operations: exact integer
partials, f32 accumulation over the groups in order.
"""

from __future__ import annotations

import torch

from flexq_tpu_torch.kernels.common import GROUP_SIZE, check_tensor, count_launch, on_card
from flexq_tpu_torch.kernels.int_matmul import check_activations, grouped_matmul_plain, launch, plain_weight


def w8_matmul_plain(x_q, x_scale, w_q, w_scale, out_dtype=torch.float32):
    """Plain PyTorch version of the kernel (bit-exact with it)."""
    return grouped_matmul_plain(x_q, x_scale, plain_weight((w_q,), lambda w: w), w_scale, out_dtype)


def w8_matmul(
    x_q: torch.Tensor,  # int8 [M, K]
    x_scale: torch.Tensor,  # f32 [M, K/128]
    w_q: torch.Tensor,  # int8 [K, N]
    w_scale: torch.Tensor,  # f32 [K/128, N]
    *,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Exact W8A8 GEMM."""
    check_activations(x_q, x_scale)
    m, k = x_q.shape
    n = w_q.shape[1]
    check_tensor(w_q, "w_q", torch.int8, (k, n), x_q.device)
    check_tensor(w_scale, "w_scale", torch.float32, (k // GROUP_SIZE, n), x_q.device)
    if not on_card(x_q):
        return w8_matmul_plain(x_q, x_scale, w_q, w_scale, out_dtype)
    out = launch(8, x_q, x_scale, (w_q,), w_scale, out_dtype)
    count_launch(w8_matmul, m)
    return out


w8_matmul.launches = 0
w8_matmul.launches_by_m = {}  # M -> launches, beside the count (zeroed with it)
