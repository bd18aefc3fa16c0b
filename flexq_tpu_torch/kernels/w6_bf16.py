"""W6A16 GEMMs: 6-bit weights dequantized to bf16 in the kernel, bf16
activations, f32 accumulation (port of flexq_tpu/kernels/w6_matmul.py::
w6_matmul_bf16 (K7, with the RoPE epilogue of kernels/common.py::
rope_epilogue), w6_glu_matmul_bf16 and w6_glu_fused_bf16 (K8)).

    w6_matmul_bf16:      out = x @ W                 [+ RoPE on the f32 sum]
    w6_glu_matmul_bf16:  out = act(x @ G) * (x @ U)  (G, U separate planes)
    w6_glu_fused_bf16:   the same, G and U the two column halves of one plane

with W = bf16((u - 32) * scale) per 128-group, x cast to bf16 first. The
kernel is the W*A16 GEMM of ``csrc/wa16_matmul.cu`` with the weight format
6, launched through ``kernels/wa16_matmul.py``; the ``*_plain`` functions
compute the same in PyTorch from that module's plain pieces, so kernel and
plain version differ only in the order of the f32 sums.
"""

from __future__ import annotations

from typing import Optional

import torch

from flexq_tpu_torch.kernels.common import GROUP_SIZE, check_tensor, on_card
from flexq_tpu_torch.kernels.fused_quant import glu_act_plain
from flexq_tpu_torch.kernels.int_matmul import plain_weight
from flexq_tpu_torch.kernels.wa16_matmul import (
    ACTS,
    acc_plain,
    check_rope,
    dequant_int,
    launch_bf16,
    rope_epilogue_plain,
)
from flexq_tpu_torch.packing.pack6 import unpack6


# ---- plain PyTorch versions (the same arithmetic, used on the CPU) -------


def _acc_plain(x, w_hi, w_lo, w_scale) -> torch.Tensor:
    return acc_plain(x, dequant_int(plain_weight((w_hi, w_lo), unpack6), w_scale))


def w6_matmul_bf16_plain(x, w_hi, w_lo, w_scale, out_dtype=torch.bfloat16, rope_cos=None, rope_sin2=None):
    acc = _acc_plain(x, w_hi, w_lo, w_scale)
    if rope_cos is not None:
        acc = rope_epilogue_plain(acc, rope_cos.to(torch.float32), rope_sin2.to(torch.float32))
    return acc.to(out_dtype)


def w6_glu_bf16_plain(x, g_hi, g_lo, g_scale, u_hi, u_lo, u_scale, act="silu", out_dtype=torch.bfloat16):
    g = _acc_plain(x, g_hi, g_lo, g_scale)
    u = _acc_plain(x, u_hi, u_lo, u_scale)
    return glu_act_plain(g, u, act).to(out_dtype)


def _halves(t: torch.Tensor):
    nh = t.shape[1] // 2
    return t[:, :nh], t[:, nh:]


def _check_weight(hi, lo, scale, k: int, n: int, ldw: int, dev, name: str) -> None:
    check_tensor(hi, f"{name} hi", torch.int8, (k // 2, ldw), dev)
    check_tensor(lo, f"{name} lo", torch.int8, (k // 4, ldw), dev)
    check_tensor(scale, f"{name} scale", torch.float32, (k // GROUP_SIZE, ldw), dev)
    if n % 128:
        raise ValueError(f"{name}: N={n} must be a multiple of 128 for the kernel")


# ---- wrappers ------------------------------------------------------------


def w6_matmul_bf16(
    x: torch.Tensor,  # bf16/f32 [M, K] full-precision activations
    w_hi: torch.Tensor,  # int8 [K/2, N]
    w_lo: torch.Tensor,  # int8 [K/4, N]
    w_scale: torch.Tensor,  # f32 [K/128, N]
    *,
    out_dtype=torch.bfloat16,
    rope_cos: Optional[torch.Tensor] = None,  # f32 [M, 128]: fused RoPE epilogue
    rope_sin2: Optional[torch.Tensor] = None,  # f32 [M, 128] = (-sin_half | sin_half)
) -> torch.Tensor:
    """W6A16 GEMM; with ``rope_cos``/``rope_sin2`` the HF half-rotate RoPE
    is applied to the f32 accumulator of every 128-wide head before the
    cast (build the operands with models.llama.rope_gemm_operands)."""
    m, k = x.shape
    n = w_hi.shape[1]
    if k % GROUP_SIZE:
        raise ValueError(f"K={k} must be a multiple of {GROUP_SIZE}")
    check_rope(rope_cos, rope_sin2, m, n, x.device)
    if not on_card(x):
        return w6_matmul_bf16_plain(x, w_hi, w_lo, w_scale, out_dtype, rope_cos, rope_sin2)
    _check_weight(w_hi, w_lo, w_scale, k, n, n, x.device, "w")
    out = launch_bf16(x, (w_hi, w_lo, w_scale), None, 0, n, out_dtype, None, rope_cos, rope_sin2)
    w6_matmul_bf16.launches += 1
    return out


def w6_glu_matmul_bf16(x, g_hi, g_lo, g_scale, u_hi, u_lo, u_scale, *, act="silu", out_dtype=torch.bfloat16):
    """Fused W6A16 GLU: act(x @ gate) * (x @ up) in one kernel (gate and up
    as separate planes of the same width)."""
    if act not in ACTS:
        raise ValueError(f"unsupported activation {act!r}")
    m, k = x.shape
    n = g_hi.shape[1]
    if not on_card(x):
        return w6_glu_bf16_plain(x, g_hi, g_lo, g_scale, u_hi, u_lo, u_scale, act, out_dtype)
    _check_weight(g_hi, g_lo, g_scale, k, n, n, x.device, "gate")
    _check_weight(u_hi, u_lo, u_scale, k, n, n, x.device, "up")
    out = launch_bf16(x, (g_hi, g_lo, g_scale), (u_hi, u_lo, u_scale), 0, n, out_dtype, act, None, None)
    w6_glu_matmul_bf16.launches += 1
    return out


def w6_glu_fused_bf16(x, hi, lo, scale, *, act="silu", out_dtype=torch.bfloat16):
    """Fused-plane variant: one packed [K, 2*Nh] gate|up weight (gate in
    columns [0, Nh), up in [Nh, 2Nh), the ``fuse=True`` layout). The kernel
    reads the up half through the same planes at a column offset: nothing
    is sliced or copied."""
    if act not in ACTS:
        raise ValueError(f"unsupported activation {act!r}")
    m, k = x.shape
    n2 = hi.shape[1]
    if n2 % 2:
        raise ValueError(f"fused gate|up width {n2} must be even")
    nh = n2 // 2
    if not on_card(x):
        (gh, uh), (gl, ul), (gs, us) = _halves(hi), _halves(lo), _halves(scale)
        return w6_glu_bf16_plain(x, gh, gl, gs, uh, ul, us, act, out_dtype)
    _check_weight(hi, lo, scale, k, nh, n2, x.device, "gate_up")
    w = (hi, lo, scale)
    out = launch_bf16(x, w, w, nh, nh, out_dtype, act, None, None)
    w6_glu_fused_bf16.launches += 1
    return out


w6_matmul_bf16.launches = 0
w6_glu_matmul_bf16.launches = 0
w6_glu_fused_bf16.launches = 0
