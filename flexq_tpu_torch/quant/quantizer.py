"""Uniform affine quantization core (port of flexq_tpu/quant/quantizer.py).

Same semantics, bit for bit on the integer side:
  * symmetric: scale = max(|xmin|, |xmax|) / (2^(b-1) - 1), no zero point,
    q in [-2^(b-1), 2^(b-1) - 1];
  * asymmetric: scale = (xmax - xmin) / (2^b - 1) (for b > 2), zero point
    round(clamp(-xmin / scale, -1e4, 1e4)), q in [0, 2^b - 1];
  * scale clamped to [CLIPMIN, CLIPMAX];
  * per-group: the trailing axis reshaped to (-1, group_size), zero-padded
    when it does not divide.
Rounding is half-to-even (``torch.round``), the division is IEEE (no
reciprocal multiply), as in the reference: the constant divisors are
tensors on x's device (``true_div``), since PyTorch's CUDA division by a
host scalar multiplies by its reciprocal.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

CLIPMIN = 1e-5
CLIPMAX = 1e4


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static description of one tensor's quantization; bits >= 16 keeps
    full precision."""

    bits: int = 8
    symmetric: bool = False
    group_size: Optional[int] = None  # None => per-token / per-channel

    @property
    def enabled(self) -> bool:
        return self.bits < 16

    @property
    def qmin(self) -> int:
        return -(2 ** (self.bits - 1)) if self.symmetric else 0

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1 if self.symmetric else 2**self.bits - 1

    def __post_init__(self):
        if self.group_size is not None and self.group_size <= 0:
            raise ValueError(f"group_size must be positive, got {self.group_size}")


def _grouped_view(x: torch.Tensor, group_size: Optional[int]) -> Tuple[torch.Tensor, int]:
    if group_size is None:
        return x.reshape(-1, x.shape[-1]), 0
    d = x.shape[-1]
    deficiency = (-d) % group_size
    if deficiency:
        x = torch.nn.functional.pad(x, (0, deficiency))
    return x.reshape(-1, group_size), deficiency


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d correctly rounded on any device: CUDA divides by a host scalar as
    a multiply by its f32 reciprocal, which parts from the division by an
    ulp on some values; a divisor on x's device takes the true division. The
    divisor is made once per (value, dtype, device) and kept, so a call
    copies nothing to the card (a CUDA graph capture refuses that copy)."""
    return x / _divisor(d, x.dtype, x.device)


@functools.lru_cache(maxsize=None)
def _divisor(d: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(d, dtype=dtype, device=device)


def compute_scale_zp(
    x: torch.Tensor, spec: QuantSpec
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Dynamic min/max calibration; scale/zp are [rows, 1] over the grouped
    view of x (zp is None when symmetric)."""
    xg, _ = _grouped_view(x, spec.group_size)
    xg = xg.to(torch.float32)
    xmin = xg.amin(dim=-1, keepdim=True)
    xmax = xg.amax(dim=-1, keepdim=True)
    if spec.symmetric:
        abs_max = torch.maximum(xmax.abs(), xmin.abs())
        scale = true_div(abs_max, 2 ** (spec.bits - 1) - 1)
        return scale.clamp(CLIPMIN, CLIPMAX), None
    rng = xmax - xmin
    denom = 2**spec.bits if spec.bits <= 2 else 2**spec.bits - 1
    scale = true_div(rng, denom).clamp(CLIPMIN, CLIPMAX)
    zp = torch.round((-xmin / scale).clamp(-CLIPMAX, CLIPMAX))
    return scale, zp


def quantize(
    x: torch.Tensor, spec: QuantSpec
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Quantize to integers (int8 container, int16 when qmax > 127) + scales
    (+ zero points)."""
    orig_shape = x.shape
    xg, _ = _grouped_view(x, spec.group_size)
    scale, zp = compute_scale_zp(x, spec)
    q = torch.round(xg.to(torch.float32) / scale)
    if zp is not None:
        q = q + zp
    container = torch.int8 if spec.qmax <= 127 else torch.int16
    q = q.clamp(spec.qmin, spec.qmax).to(container)
    if spec.group_size is None:
        q = q.reshape(orig_shape)
    return q, scale, zp


def dequantize(
    q: torch.Tensor,
    scale: torch.Tensor,
    zp: Optional[torch.Tensor],
    spec: QuantSpec,
    orig_shape: Tuple[int, ...],
    out_dtype=torch.float32,
) -> torch.Tensor:
    """Inverse of :func:`quantize`."""
    d = orig_shape[-1]
    deficiency = 0 if spec.group_size is None else (-d) % spec.group_size
    qf = q.to(torch.float32)
    qf = qf.reshape(-1, spec.group_size if spec.group_size is not None else d)
    if zp is not None:
        qf = qf - zp
    dq = qf * scale
    if spec.group_size is not None:
        dq = dq.reshape(tuple(orig_shape[:-1]) + (d + deficiency,))
        if deficiency:
            dq = dq[..., :d]
    else:
        dq = dq.reshape(orig_shape)
    return dq.to(out_dtype)


def fake_quant(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Quantize-dequantize in the input dtype; pass-through when bits >= 16."""
    if not spec.enabled:
        return x
    q, scale, zp = quantize(x, spec)
    return dequantize(q, scale, zp, spec, tuple(x.shape), out_dtype=x.dtype)
