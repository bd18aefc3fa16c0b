"""Fused producer + per-group activation quant (port of
flexq_tpu/kernels/fused_quant.py: rmsnorm_quant, quant_act, glu_quant,
layernorm_quant, relu_quant).

One CUDA kernel, ``csrc/row_quant.cu``, replaces five TPU kernels: its MODE
selects the row producer and a shared epilogue quantizes the row in
128-wide groups (symmetric, scale = absmax / qmax clamped to [CLIPMIN,
CLIPMAX], q = rint(y / scale) clamped to [-qmax-1, qmax]):

  MODE 0  identity                       flexq_tpu quant_act     (K4)
  MODE 1  RMSNorm                        flexq_tpu rmsnorm_quant (K1)
  MODE 2  residual add, then RMSNorm     flexq_tpu rmsnorm_quant (K1, residual)
  MODE 3  act(gate) * up, silu or tanh-gelu  flexq_tpu glu_quant (K5)
  MODE 4  LayerNorm                      flexq_tpu layernorm_quant (K14)
  MODE 5  residual add, then LayerNorm   flexq_tpu layernorm_quant (K14, residual)
  MODE 6  ReLU                           flexq_tpu relu_quant    (K15)

Bound on this card: bytes. A warp owns 128-groups (four values a lane);
the modes without a row statistic give every (row, group) its own warp over
the whole grid, the RMS and LayerNorm modes hold a row in registers in one
block between the statistic and the quant (see the source's header). The
arithmetic mirrors the plain versions below operation by operation: IEEE
division where the compiled reference divides, a multiply by the f32
reciprocal where it divides by a constant (qmax, K), half-to-even rounding,
expf / tanhf without fast math (the functions torch's CUDA ops call),
RMSNorm's cast to the model dtype before the gamma multiply (LayerNorm has
none: y * gamma + beta in f32), 1 / sqrt rounded twice (PyTorch's CPU
rsqrt), and no FMA contraction. The plain RMS and LayerNorm statistics
sum each row in the kernel's order (``row_sum``), so card and CPU give a
row the same bits; the reference's compiled sums run in another order, so
a row's statistic may part from it by an ulp. The statistic modes take
rows of up to ``STAT_MAX_K`` values; the others any multiple of 128.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from flexq_tpu_torch.kernels import _build
from flexq_tpu_torch.kernels.common import GROUP_SIZE, check_tensor, count_launch, on_card
from flexq_tpu_torch.quant.quantizer import CLIPMAX, CLIPMIN

_MODE_IDENT, _MODE_RMS, _MODE_RMS_RES, _MODE_GLU, _MODE_LN, _MODE_LN_RES, _MODE_RELU = range(7)
_STAT_MODES = (_MODE_RMS, _MODE_RMS_RES, _MODE_LN, _MODE_LN_RES)
_ACTS = {"silu": 0, "gelu": 1}
_GELU_C = 0.7978845608028654  # sqrt(2 / pi)
# the widest row of the RMS / LayerNorm modes: one block of 16 warps x 8 groups a warp
# (csrc/row_quant.cu's MAX_WARPS, MAXG)
STAT_MAX_K = 16 * 8 * GROUP_SIZE

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_I, _I] + [_P] * 7 + [_I] * 5 + [_F, _I, _F, _F, _P]


def check_width(mode: int, k: int) -> None:
    """Raise for a row width the kernel's MODE does not take."""
    if k % GROUP_SIZE:
        raise ValueError(f"K={k} must be a multiple of {GROUP_SIZE}")
    if mode in _STAT_MODES and k > STAT_MAX_K:
        raise ValueError(f"K={k}: the RMS / LayerNorm producers hold a row of at most {STAT_MAX_K} values")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(mode: int, x, other, gamma, bits: int, eps: float, act: str, with_ro: bool, beta=None):
    """Launch csrc/row_quant.cu in MODE on checked CUDA operands; returns
    (q, scales, residual out or None)."""
    m, k = x.shape
    check_width(mode, k)
    if any(t is not None and t.data_ptr() % 16 for t in (x, other, gamma, beta)):
        raise ValueError("the producer's inputs must be 16-byte aligned")
    q = torch.empty((m, k), dtype=torch.int8, device=x.device)
    s = torch.empty((m, k // GROUP_SIZE), dtype=torch.float32, device=x.device)
    ro = torch.empty_like(x) if with_ro else None
    qmax = 2 ** (bits - 1) - 1
    bf16 = torch.bfloat16
    fn = _build.function("row_quant", "flexq_row_quant", _ARGS)
    rc = fn(
        mode, _ACTS[act], x.data_ptr(), _ptr(other), _ptr(gamma), _ptr(beta), q.data_ptr(), s.data_ptr(), _ptr(ro),
        m, k, int(x.dtype == bf16), int(gamma is not None and gamma.dtype == bf16),
        int(beta is not None and beta.dtype == bf16), float(eps), qmax, f32_reciprocal(qmax), f32_reciprocal(k),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"row_quant kernel launch failed (MODE {mode}, M={m} K={k}): CUDA error {rc}")
    return q, s, ro


def empty_kernel(device) -> None:
    """Launch csrc/row_quant.cu's empty kernel through the same host path
    (the launch floor the producers are held against)."""
    fn = _build.function("row_quant", "flexq_empty_kernel", [_P])
    rc = fn(torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {rc}")


def _check_rows(x: torch.Tensor, name: str) -> None:
    if x.dim() != 2 or x.shape[1] % GROUP_SIZE:
        raise ValueError(f"{name}: expected [M, K] with K % {GROUP_SIZE} == 0, got {tuple(x.shape)}")
    check_tensor(x, name, (torch.bfloat16, torch.float32), x.shape, x.device)


# ---- plain PyTorch versions (the same arithmetic, used on the CPU) -------


@functools.lru_cache(maxsize=None)
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


_LANES = torch.arange(32)


def _butterfly(a: torch.Tensor) -> torch.Tensor:
    """A warp's xor-shuffle butterfly over the last axis (32 lanes): every
    lane ends with the same sum; returns lane 0's."""
    for o in (16, 8, 4, 2, 1):
        a = a + a[..., _LANES ^ o]
    return a[..., 0]


def row_sum(t: torch.Tensor) -> torch.Tensor:
    """f32 [M, K] -> [M, 1]: each row summed in csrc/row_quant.cu's order, so
    the plain RMS / LayerNorm statistic has the kernel's bits. Each 128-group
    is summed by a warp (lane l adds its 4 values in order, then a
    butterfly), then lane l adds groups l, l + 32, ... in order from 0 and a
    butterfly adds the lanes."""
    m, k = t.shape
    g = k // GROUP_SIZE
    v = t.reshape(m, g, 32, 4)
    part = _butterfly(((v[..., 0] + v[..., 1]) + v[..., 2]) + v[..., 3])  # [M, G]
    a = torch.zeros((m, 32), dtype=t.dtype, device=t.device)
    for j in range(0, g, 32):
        chunk = part[:, j : j + 32]
        a[:, : chunk.shape[1]] = a[:, : chunk.shape[1]] + chunk
    return _butterfly(a)[:, None]


def _rms_plain(h: torch.Tensor, gamma: torch.Tensor, eps: float, dtype) -> torch.Tensor:
    var = row_sum(h * h) * f32_reciprocal(h.shape[-1])
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
    d = h - row_sum(h) * rk
    var = row_sum(d * d) * rk
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
    count_launch(rmsnorm_quant, x.shape[0])
    return (q, s) if residual is None else (q, s, ro)


def quant_act(x: torch.Tensor, bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-group symmetric quant of activations [M, K]."""
    _check_rows(x, "x")
    if not on_card(x):
        return quant_act_plain(x, bits)
    q, s, _ = _launch(_MODE_IDENT, x, None, None, bits, 0.0, "silu", False)
    count_launch(quant_act, x.shape[0])
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
    count_launch(glu_quant, gate.shape[0])
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
    count_launch(layernorm_quant, x.shape[0])
    return (q, s) if residual is None else (q, s, ro)


def relu_quant(x: torch.Tensor, bits: int = 6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused ReLU + per-group quant: OPT's fc2 input producer."""
    _check_rows(x, "x")
    if not on_card(x):
        return relu_quant_plain(x, bits)
    q, s, _ = _launch(_MODE_RELU, x, None, None, bits, 0.0, "silu", False)
    count_launch(relu_quant, x.shape[0])
    return q, s


rmsnorm_quant.launches = 0
rmsnorm_quant.launches_by_m = {}  # M -> launches, beside the count (zeroed with it)
quant_act.launches = 0
quant_act.launches_by_m = {}  # M -> launches, beside the count (zeroed with it)
glu_quant.launches = 0
glu_quant.launches_by_m = {}  # M -> launches, beside the count (zeroed with it)
layernorm_quant.launches = 0
layernorm_quant.launches_by_m = {}  # M -> launches, beside the count (zeroed with it)
relu_quant.launches = 0
relu_quant.launches_by_m = {}  # M -> launches, beside the count (zeroed with it)
