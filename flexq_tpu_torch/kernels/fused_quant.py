"""Fused producer + per-group activation quant (port of
flexq_tpu/kernels/fused_quant.py: rmsnorm_quant, quant_act, glu_quant,
layernorm_quant, relu_quant).

One Triton kernel, ``_row_quant_kernel``, replaces five TPU kernels: its
constexpr MODE selects the row producer and a shared epilogue quantizes the
row in 128-wide groups (symmetric, scale = absmax / qmax clamped to
[CLIPMIN, CLIPMAX], q = rint(y / scale) clamped to [-qmax-1, qmax]):

  MODE 0  identity                       flexq_tpu quant_act     (K4)
  MODE 1  RMSNorm                        flexq_tpu rmsnorm_quant (K1)
  MODE 2  residual add, then RMSNorm     flexq_tpu rmsnorm_quant (K1, residual)
  MODE 3  act(gate) * up, silu or tanh-gelu  flexq_tpu glu_quant (K5)
  MODE 4  LayerNorm                      flexq_tpu layernorm_quant (K14)
  MODE 5  residual add, then LayerNorm   flexq_tpu layernorm_quant (K14, residual)
  MODE 6  ReLU                           flexq_tpu relu_quant    (K15)

Bound on this card: bytes. Each row is read once and written once as int8
plus one f32 scale per 128 values (a few flops per byte; no tensor cores).
Design: one program per row holds the whole row in registers, so the RMS
reduction (LayerNorm: the mean, then the variance of the centred row, a
second pass over the registers), the 128-wide absmax reductions and the
stores need one pass over memory. The widest row on the serve path is
OPT-6.7B's FFN (16384 values: BLOCK 16384 at 16 warps, 32 f32 a thread per
live array, as glu_quant at LLaMA's 11264); ``_launch.compiled`` keeps each
specialization's registers and spills. The arithmetic mirrors the plain versions below operation by
operation: IEEE division (tl.div_rn) where the compiled reference divides,
a multiply by the f32 reciprocal where it divides by a constant (qmax, K),
half-to-even rounding (libdevice rint), libdevice exp / tanh / rsqrt (the
functions torch's CUDA ops call), RMSNorm's cast to the model dtype before
the gamma multiply (LayerNorm has none: y * gamma + beta in f32), and no FMA
contraction (enable_fp_fusion=False). What can still differ from the plain
version is the order of the RMS and LayerNorm sums.

Triton is imported only when a kernel is launched: ``tl`` and ``libdevice``
below are bound then, and the kernel is jitted from the plain function.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from flexq_tpu_torch.kernels.common import GROUP_SIZE, check_tensor, on_card
from flexq_tpu_torch.quant.quantizer import CLIPMAX, CLIPMIN

_MODE_IDENT, _MODE_RMS, _MODE_RMS_RES, _MODE_GLU, _MODE_LN, _MODE_LN_RES, _MODE_RELU = range(7)
_ACTS = {"silu": 0, "gelu": 1}
_GELU_C = 0.7978845608028654  # sqrt(2 / pi)

# bound at the first launch (triton is not importable without a GPU stack)
tl = None
libdevice = None
_jitted = None


def _row_quant_kernel(
    x_ptr, r_ptr, g_ptr, b_ptr, q_ptr, s_ptr, ro_ptr, K, rk, eps, qmax, rq,
    MODE: "tl.constexpr", ACT: "tl.constexpr", MODEL_BF16: "tl.constexpr",
    BLOCK: "tl.constexpr",
):
    row = tl.program_id(0).to(tl.int64)
    offs = tl.arange(0, BLOCK)
    mask = offs < K
    base = row * K
    x = tl.load(x_ptr + base + offs, mask=mask, other=0.0).to(tl.float32)
    if MODE == 0:
        y = x
    elif MODE == 6:
        y = tl.maximum(x, 0.0)
    elif MODE == 3:
        u = tl.load(r_ptr + base + offs, mask=mask, other=0.0).to(tl.float32)
        if ACT == 0:
            y = x * tl.div_rn(1.0, 1.0 + libdevice.exp(-x)) * u
        else:
            # 0.7978845608028654 == _GELU_C (a kernel reads no float globals)
            cdf = 0.5 * (1.0 + libdevice.tanh(0.7978845608028654 * (x + 0.044715 * (x * x * x))))
            y = x * cdf * u
    else:
        h = x
        if MODE == 2 or MODE == 5:
            h = h + tl.load(r_ptr + base + offs, mask=mask, other=0.0).to(tl.float32)
            tl.store(ro_ptr + base + offs, h.to(ro_ptr.dtype.element_ty), mask=mask)
        g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        if MODE >= 4:
            mu = tl.sum(h, axis=0) * rk
            d = tl.where(mask, h - mu, 0.0)  # lanes past K would read -mu
            var = tl.sum(d * d, axis=0) * rk
            y = d * libdevice.rsqrt(var + eps)
            y = y * g + tl.load(b_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        else:
            var = tl.sum(h * h, axis=0) * rk
            y = h * libdevice.rsqrt(var + eps)
            if MODEL_BF16:
                y = y.to(tl.bfloat16).to(tl.float32)
            y = y * g
    yg = tl.reshape(y, (BLOCK // 128, 128))
    absmax = tl.max(tl.abs(yg), axis=1)
    scale = tl.minimum(tl.maximum(absmax * rq, 1e-5), 1e4)
    qf = libdevice.rint(tl.div_rn(yg, scale[:, None]))
    qf = tl.minimum(tl.maximum(qf, -qmax - 1.0), qmax)
    tl.store(q_ptr + base + offs, tl.reshape(qf, (BLOCK,)).to(tl.int8), mask=mask)
    goffs = tl.arange(0, BLOCK // 128)
    ng = K // 128
    tl.store(s_ptr + row * ng + goffs, scale, mask=goffs < ng)


def _kernel():
    global tl, libdevice, _jitted
    if _jitted is None:
        import triton
        import triton.language as tl_
        from triton.language.extra import libdevice as libdevice_

        tl, libdevice = tl_, libdevice_
        _jitted = triton.jit(_row_quant_kernel)
    return _jitted


def _launch(mode: int, x, other, gamma, bits: int, eps: float, act: str, with_ro: bool, beta=None):
    m, k = x.shape
    q = torch.empty((m, k), dtype=torch.int8, device=x.device)
    s = torch.empty((m, k // GROUP_SIZE), dtype=torch.float32, device=x.device)
    ro = torch.empty_like(x) if with_ro else x
    qmax = 2 ** (bits - 1) - 1
    block = max(128, 1 << (k - 1).bit_length())
    warps = 4 if block <= 1024 else (8 if block <= 4096 else 16)
    with torch.cuda.device(x.device):
        compiled = _kernel()[(m,)](
            x, other if other is not None else x, gamma if gamma is not None else x,
            beta if beta is not None else x,
            q, s, ro, k, f32_reciprocal(k), float(eps), float(qmax), f32_reciprocal(qmax),
            MODE=mode, ACT=_ACTS[act], MODEL_BF16=x.dtype == torch.bfloat16,
            BLOCK=block, num_warps=warps, enable_fp_fusion=False,
        )
    key = (mode, block, x.dtype)
    if key not in _launch.compiled:
        _launch.compiled[key] = (getattr(compiled, "n_regs", None), getattr(compiled, "n_spills", None))
    return q, s, ro


# (MODE, BLOCK, dtype) -> (registers a thread, spilled registers) of each
# specialization launched, as Triton reports them
_launch.compiled = {}


def _check_rows(x: torch.Tensor, name: str) -> None:
    if x.dim() != 2 or x.shape[1] % GROUP_SIZE:
        raise ValueError(f"{name}: expected [M, K] with K % {GROUP_SIZE} == 0, got {tuple(x.shape)}")
    check_tensor(x, name, (torch.bfloat16, torch.float32), x.shape, x.device)


# ---- plain PyTorch versions (the same arithmetic, used on the CPU) -------


def f32_reciprocal(c: int) -> float:
    """1/c rounded once to f32 (exact as a Python float). The reference's
    kernels divide by the constants qmax and K (the mean), and XLA compiles a
    division by a constant into a multiply by this reciprocal; the port
    does the same so its quantized values match bit for bit."""
    return float(np.float32(1.0) / np.float32(c))


def group_quant_plain(y: torch.Tensor, bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-group(128) quant of f32 [M, K] -> (int8, f32 [M, K/128]);
    the reference's ``_group_quant``."""
    m, k = y.shape
    qmax = 2 ** (bits - 1) - 1
    yg = y.reshape(m, k // GROUP_SIZE, GROUP_SIZE)
    scale = (yg.abs().amax(dim=-1) * f32_reciprocal(qmax)).clamp(CLIPMIN, CLIPMAX)
    q = torch.round(yg / scale[:, :, None]).clamp(-(qmax + 1), qmax).to(torch.int8)
    return q.reshape(m, k), scale


def _rms_plain(h: torch.Tensor, gamma: torch.Tensor, eps: float, dtype) -> torch.Tensor:
    var = (h * h).sum(dim=-1, keepdim=True) * f32_reciprocal(h.shape[-1])
    y = h * torch.rsqrt(var + eps)
    return y.to(dtype).to(torch.float32) * gamma.to(torch.float32)


def rmsnorm_quant_plain(x, gamma, bits: int = 6, *, residual=None, eps: float = 1e-5):
    h = x.to(torch.float32)
    if residual is None:
        return group_quant_plain(_rms_plain(h, gamma, eps, x.dtype), bits)
    h = h + residual.to(torch.float32)
    q, s = group_quant_plain(_rms_plain(h, gamma, eps, x.dtype), bits)
    return q, s, h.to(x.dtype)


def quant_act_plain(x, bits: int = 8):
    return group_quant_plain(x.to(torch.float32), bits)


def _ln_plain(h: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm of f32 rows, the kernel's arithmetic: both means multiply
    by the f32 reciprocal of K, the variance is taken of the centred row,
    and y * gamma + beta stays in f32 (no cast to the model dtype)."""
    rk = f32_reciprocal(h.shape[-1])
    d = h - h.sum(dim=-1, keepdim=True) * rk
    var = (d * d).sum(dim=-1, keepdim=True) * rk
    y = d * torch.rsqrt(var + eps)
    return y * gamma.to(torch.float32) + beta.to(torch.float32)


def layernorm_quant_plain(x, gamma, beta, bits: int = 6, *, residual=None, eps: float = 1e-5):
    h = x.to(torch.float32)
    if residual is None:
        return group_quant_plain(_ln_plain(h, gamma, beta, eps), bits)
    h = h + residual.to(torch.float32)
    q, s = group_quant_plain(_ln_plain(h, gamma, beta, eps), bits)
    return q, s, h.to(x.dtype)


def relu_quant_plain(x, bits: int = 6):
    return group_quant_plain(torch.clamp_min(x.to(torch.float32), 0.0), bits)


def glu_act_plain(gate: torch.Tensor, up: torch.Tensor, act: str) -> torch.Tensor:
    """act(gate) * up in f32, in the reference's operation order."""
    g = gate.to(torch.float32)
    u = up.to(torch.float32)
    if act == "silu":
        return g * torch.sigmoid(g) * u
    if act == "gelu":  # tanh approximation, jax.nn.gelu's formula
        cdf = 0.5 * (1.0 + torch.tanh(_GELU_C * (g + 0.044715 * (g * g * g))))
        return g * cdf * u
    raise ValueError(f"unsupported activation {act!r}")


def glu_quant_plain(gate, up, bits: int = 8, *, act: str = "silu"):
    return group_quant_plain(glu_act_plain(gate, up, act), bits)


# ---- wrappers ------------------------------------------------------------


def rmsnorm_quant(
    x: torch.Tensor,
    gamma: torch.Tensor,
    bits: int = 6,
    *,
    residual: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
):
    """Fused [residual-add +] RMSNorm + per-group quant.

    Returns (q int8 [M, K], scales f32 [M, K/128][, residual_out [M, K]]).
    Stats in f32, normed row cast to the model dtype before the gamma
    multiply."""
    _check_rows(x, "x")
    check_tensor(gamma, "gamma", (torch.bfloat16, torch.float32), (x.shape[1],), x.device)
    if residual is not None:
        check_tensor(residual, "residual", x.dtype, x.shape, x.device)
    if not on_card(x):
        return rmsnorm_quant_plain(x, gamma, bits, residual=residual, eps=eps)
    mode = _MODE_RMS if residual is None else _MODE_RMS_RES
    q, s, ro = _launch(mode, x, residual, gamma, bits, eps, "silu", residual is not None)
    rmsnorm_quant.launches += 1
    return (q, s) if residual is None else (q, s, ro)


def quant_act(x: torch.Tensor, bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-group symmetric quant of activations [M, K]."""
    _check_rows(x, "x")
    if not on_card(x):
        return quant_act_plain(x, bits)
    q, s, _ = _launch(_MODE_IDENT, x, None, None, bits, 0.0, "silu", False)
    quant_act.launches += 1
    return q, s


def glu_quant(
    gate: torch.Tensor, up: torch.Tensor, bits: int = 8, *, act: str = "silu"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused act(gate) * up + per-group quant: the down_proj input producer."""
    _check_rows(gate, "gate")
    check_tensor(up, "up", gate.dtype, gate.shape, gate.device)
    if act not in _ACTS:
        raise ValueError(f"unsupported activation {act!r}")
    if not on_card(gate):
        return glu_quant_plain(gate, up, bits, act=act)
    q, s, _ = _launch(_MODE_GLU, gate, up, None, bits, 0.0, act, False)
    glu_quant.launches += 1
    return q, s


def layernorm_quant(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    bits: int = 6,
    *,
    residual: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
):
    """Fused [residual-add +] LayerNorm + per-group quant (OPT's q/k/v and
    fc1 input producer).

    Returns (q int8 [M, K], scales f32 [M, K/128][, residual_out [M, K]]).
    Stats in f32 (mean, then the variance of the centred row), y * gamma +
    beta in f32."""
    _check_rows(x, "x")
    for t, name in ((gamma, "gamma"), (beta, "beta")):
        check_tensor(t, name, (torch.bfloat16, torch.float32), (x.shape[1],), x.device)
    if residual is not None:
        check_tensor(residual, "residual", x.dtype, x.shape, x.device)
    if not on_card(x):
        return layernorm_quant_plain(x, gamma, beta, bits, residual=residual, eps=eps)
    mode = _MODE_LN if residual is None else _MODE_LN_RES
    q, s, ro = _launch(mode, x, residual, gamma, bits, eps, "silu", residual is not None, beta=beta)
    layernorm_quant.launches += 1
    return (q, s) if residual is None else (q, s, ro)


def relu_quant(x: torch.Tensor, bits: int = 6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused ReLU + per-group quant: OPT's fc2 input producer."""
    _check_rows(x, "x")
    if not on_card(x):
        return relu_quant_plain(x, bits)
    q, s, _ = _launch(_MODE_RELU, x, None, None, bits, 0.0, "silu", False)
    relu_quant.launches += 1
    return q, s


rmsnorm_quant.launches = 0
quant_act.launches = 0
glu_quant.launches = 0
layernorm_quant.launches = 0
relu_quant.launches = 0
