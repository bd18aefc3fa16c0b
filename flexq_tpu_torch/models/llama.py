"""LLaMA building blocks used by the serve path (port of the matching
functions of flexq_tpu/models/llama.py): RoPE, the FFN activation, RMSNorm,
and the attention over fresh keys of the cache-less forward
(``attention_core``, ``causal_mask``).

HF numeric conventions, as in the reference: RMSNorm stats in f32 and the
normed row cast to the model dtype before the gamma multiply; RoPE cos/sin
from an f32 inv_freq, applied in f32 with rotate_half.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from flexq_tpu_torch.config import ModelConfig
from flexq_tpu_torch.quant.quantizer import true_div


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
    var = true_div((h * h).sum(dim=-1, keepdim=True), h.shape[-1])
    return (h * torch.rsqrt(var + eps)).to(x.dtype) * gamma


ATTN_CHUNK = 1024  # key-chunk size for the blockwise path


def causal_mask(lq: int, lk: int, dtype=torch.float32, window: Optional[int] = None, device="cpu") -> torch.Tensor:
    """Additive causal mask [1, 1, lq, lk], the queries at the END of the key
    run; ``window`` adds the sliding-window lower bound (query i attends keys
    in [i - window + 1, i])."""
    qi = torch.arange(lq, device=device)[:, None] + (lk - lq)
    ki = torch.arange(lk, device=device)[None, :]
    ok = ki <= qi
    if window is not None:
        ok &= ki > qi - window
    m = torch.where(ok, 0.0, torch.finfo(dtype).min).to(dtype)
    return m[None, None]


def attention_core(q, k, v, mask: Optional[torch.Tensor], num_kv_groups: int) -> torch.Tensor:
    """Attention over fresh keys: q [B, Lq, H, D], k / v [B, Lk, KVH, D],
    ``mask`` additive [.., Lq, Lk] or None -> [B, Lq, H * D] in v's dtype.

    The reference's jnp core, in plain PyTorch: scores in the inputs' dtype,
    then an f32 softmax over the scaled, masked scores, probabilities cast
    to v's dtype for the P.V product; GQA repeats the kv heads. Key runs
    longer than ATTN_CHUNK (a multiple of it, Lq > 1) take the blockwise
    online softmax, as in the reference."""
    b, lq, h, d = q.shape
    if num_kv_groups > 1:
        k = k.repeat_interleave(num_kv_groups, dim=2)
        v = v.repeat_interleave(num_kv_groups, dim=2)
    lk = k.shape[1]
    if lk > ATTN_CHUNK and lk % ATTN_CHUNK == 0 and lq > 1:
        return _attention_blockwise(q, k, v, mask, ATTN_CHUNK)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    scores = true_div(scores, math.sqrt(d))
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return out.reshape(b, lq, h * d)


def _attention_blockwise(q, k, v, mask, chunk: int) -> torch.Tensor:
    """Online-softmax attention over key chunks: the dots take the inputs'
    values with f32 sums, the running max / sum / accumulator are f32, p is
    cast to the inputs' dtype before P.V."""
    b, lq, h, d = q.shape
    cdt = q.dtype
    qf = q.to(torch.float32)
    scale = 1.0 / math.sqrt(d)
    m = torch.full((b, h, lq, 1), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, lq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, lq, d), dtype=torch.float32, device=q.device)
    for start in range(0, k.shape[1], chunk):
        kb = k[:, start : start + chunk].to(cdt).to(torch.float32)
        vb = v[:, start : start + chunk].to(cdt).to(torch.float32)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb) * scale
        if mask is not None:
            s = s + mask[..., start : start + chunk].to(torch.float32)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhqk,bkhd->bhqd", p.to(cdt).to(torch.float32), vb)
        m = m_new
    out = (acc / l).to(cdt)
    return out.transpose(1, 2).reshape(b, lq, h * d)
