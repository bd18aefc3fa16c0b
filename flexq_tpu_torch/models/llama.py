"""LLaMA building blocks used by the serve path (port of the matching
functions of flexq_tpu/models/llama.py).

HF numeric conventions, as in the reference: RMSNorm stats in f32 and the
normed row cast to the model dtype before the gamma multiply; RoPE cos/sin
from an f32 inv_freq, applied in f32 with rotate_half.
"""

from __future__ import annotations

import functools
import math

import torch

from flexq_tpu_torch.config import ModelConfig


@functools.lru_cache(maxsize=None)
def _inv_freq(head_dim: int, theta: float, scaling, device: torch.device) -> torch.Tensor:
    """f32 [head_dim / 2] RoPE inverse frequencies, computed on the host and
    copied to ``device`` once: the card's f32 ``pow`` rounds some entries an
    ulp apart from the CPU's, which moves a few percent of the cos / sin
    table, and with it q and k."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim))
    if scaling is not None:
        factor, low, high, orig = scaling
        wavelen = 2.0 * math.pi / inv_freq
        smooth = (orig / wavelen - low) / (high - low)
        blended = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
        inv_freq = torch.where(
            wavelen > orig / low,
            inv_freq / factor,
            torch.where(wavelen < orig / high, inv_freq, blended),
        )
    return inv_freq.to(device)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float, scaling=None):
    """positions [B, L] -> (cos, sin) [B, L, head_dim] (half-rotate layout).

    ``scaling`` is the LLaMA-3.1 (factor, low_freq_factor, high_freq_factor,
    original_max_position_embeddings) inv_freq remap."""
    inv_freq = _inv_freq(head_dim, theta, scaling, positions.device)
    freqs = positions[..., None].to(torch.float32) * inv_freq  # [B, L, D/2]
    emb = torch.cat([freqs, freqs], dim=-1).to(torch.float64)
    # cos/sin of the f32 angle, taken in f64 and rounded once: as accurate
    # as the reference's f32 cos/sin; torch's f32 CPU cos loses up to 1.5e-4
    # at angles near 80 rad on some runs
    return torch.cos(emb).to(torch.float32), torch.sin(emb).to(torch.float32)


def rope_for_cfg(positions: torch.Tensor, cfg: ModelConfig):
    return rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q, k, cos, sin):
    """q [B, L, H, D], k [B, L, KVH, D]; cos/sin [B, L, D]."""
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    qf, kf = q.to(torch.float32), k.to(torch.float32)
    q_out = qf * cos + _rotate_half(qf) * sin
    k_out = kf * cos + _rotate_half(kf) * sin
    return q_out.to(q.dtype), k_out.to(k.dtype)


def rope_gemm_operands(cos: torch.Tensor, sin: torch.Tensor):
    """(cos, sin) [B, L, D] -> (cos_f, sin2_f) [B*L, D] f32 operands of the
    in-GEMM RoPE epilogue (kernels.wa16_matmul, K7 and K11): with P the roll
    by D/2 within a head, rotate_half(t) * sin == P(t) * sin2, where
    sin2 = (-sin_half | sin_half)."""
    b, l, d = cos.shape
    half = d // 2
    sin2 = torch.cat([-sin[..., :half], sin[..., half:]], dim=-1)
    return (
        cos.reshape(b * l, d).to(torch.float32).contiguous(),
        sin2.reshape(b * l, d).to(torch.float32).contiguous(),
    )


def act_fn(name: str, x: torch.Tensor) -> torch.Tensor:
    """FFN gate activation by config name (silu, or tanh-approximate gelu)."""
    if name == "silu":
        return torch.nn.functional.silu(x)
    if name == "gelu":
        return torch.nn.functional.gelu(x, approximate="tanh")
    raise ValueError(f"unsupported activation {name!r}")


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    h = x.to(torch.float32)
    var = (h * h).sum(dim=-1, keepdim=True) / h.shape[-1]
    return (h * torch.rsqrt(var + eps)).to(x.dtype) * gamma
