"""W4 quantized matmuls (port of flexq_tpu/kernels/w4_matmul.py):

    w4_matmul       exact W4A8 (K10): int8 activations, per group the integer
                    partial sum x * (u - 8) times x_scale * w_scale, summed in
                    f32 over the groups in order;
    w4_matmul_bf16  W4A16 (K11): bf16 activations, W = bf16((u - 8) * scale)
                    per 128-group, f32 accumulation, optional RoPE epilogue;

with the weights as stored by packing/pack4.py (a biased nibble plane,
N-minor). The kernels are the format-neutral ones over the nibble plane:
K10 is ``csrc/w6ax_matmul.cu`` with the format parameter 4 (its two routes,
``int_matmul.w6ax_route`` picks) and K11 is ``csrc/wa16_matmul.cu`` with the
format parameter 4 (see their headers for the design and the bound). The
plain versions follow the kernels' order of operations, as the W6 ones do.
"""

from __future__ import annotations

from typing import Optional

import torch

from flexq_tpu_torch.kernels.common import GROUP_SIZE, check_tensor, count_launch, on_card
from flexq_tpu_torch.kernels.wa16_matmul import (
    ROPE_HEAD,
    acc_plain,
    check_rope,
    dequant_int,
    launch_bf16,
    rope_epilogue_plain,
)
from flexq_tpu_torch.kernels.int_matmul import check_activations, grouped_matmul_plain, launch, plain_weight
from flexq_tpu_torch.packing.pack4 import unpack4


def _check_weight(w_q4, w_scale, k: int, dev) -> None:
    n = w_q4.shape[1]
    check_tensor(w_q4, "w_q4", torch.int8, (k // 2, n), dev)
    check_tensor(w_scale, "w_scale", torch.float32, (k // GROUP_SIZE, n), dev)


def w4_matmul_plain(x_q, x_scale, w_q4, w_scale, out_dtype=torch.float32):
    """Plain PyTorch version of K10 (bit-exact with it)."""
    return grouped_matmul_plain(x_q, x_scale, plain_weight((w_q4,), unpack4), w_scale, out_dtype)


def w4_matmul(
    x_q: torch.Tensor,  # int8 [M, K] quantized activations
    x_scale: torch.Tensor,  # f32 [M, K/128]
    w_q4: torch.Tensor,  # int8 [K/2, N] packed (biased) nibbles
    w_scale: torch.Tensor,  # f32 [K/128, N]
    *,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Exact W4A8 GEMM (every shape: the reference has no stream variant of
    K10)."""
    check_activations(x_q, x_scale)
    m, k = x_q.shape
    _check_weight(w_q4, w_scale, k, x_q.device)
    if not on_card(x_q):
        return w4_matmul_plain(x_q, x_scale, w_q4, w_scale, out_dtype)
    out = launch(4, x_q, x_scale, (w_q4,), w_scale, out_dtype)
    count_launch(w4_matmul, m)
    return out


def w4_matmul_bf16_plain(x, w_q4, w_scale, out_dtype=torch.bfloat16, rope_cos=None, rope_sin2=None):
    """Plain PyTorch version of K11: the same bf16 weight, an f32 product of
    the bf16 operands and the epilogue in f32 on it."""
    acc = acc_plain(x, dequant_int(plain_weight((w_q4,), unpack4), w_scale))
    if rope_cos is not None:
        acc = rope_epilogue_plain(acc, rope_cos.to(torch.float32), rope_sin2.to(torch.float32))
    return acc.to(out_dtype)


def w4_matmul_bf16(
    x: torch.Tensor,  # bf16/f32 [M, K] full-precision activations
    w_q4: torch.Tensor,  # int8 [K/2, N]
    w_scale: torch.Tensor,  # f32 [K/128, N]
    *,
    out_dtype=torch.bfloat16,
    rope_cos: Optional[torch.Tensor] = None,  # f32 [M, 128]: fused RoPE epilogue
    rope_sin2: Optional[torch.Tensor] = None,  # f32 [M, 128] = (-sin_half | sin_half)
) -> torch.Tensor:
    """W4A16 GEMM; with ``rope_cos``/``rope_sin2`` the HF half-rotate RoPE
    is applied to the f32 accumulator of every 128-wide head before the
    cast (build the operands with models.llama.rope_gemm_operands)."""
    m, k = x.shape
    n = w_q4.shape[1]
    if k % GROUP_SIZE:
        raise ValueError(f"K={k} must be a multiple of {GROUP_SIZE}")
    check_rope(rope_cos, rope_sin2, m, n, x.device)
    if not on_card(x):
        return w4_matmul_bf16_plain(x, w_q4, w_scale, out_dtype, rope_cos, rope_sin2)
    _check_weight(w_q4, w_scale, k, x.device)
    if n % ROPE_HEAD:
        raise ValueError(f"N={n} must be a multiple of 128 for the kernel")
    out = launch_bf16(x, (w_q4, None, w_scale), None, 0, n, out_dtype, None, rope_cos, rope_sin2, fmt=4)
    w4_matmul_bf16.launches += 1
    return out


w4_matmul.launches = 0
w4_matmul.launches_by_m = {}  # M -> launches, beside the count (zeroed with it)
w4_matmul_bf16.launches = 0
