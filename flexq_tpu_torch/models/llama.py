"""LLaMA-family decoder (MHA + GQA) in plain PyTorch (port of
flexq_tpu/models/llama.py): the building blocks the serve path shares (RoPE,
the FFN activation, RMSNorm, the attention over fresh keys and its masks)
and the dense model of the quantize-and-evaluate path.

The dense model (``decoder_layer``, ``forward``) is the accuracy oracle:
plain matmuls over weights that ``fake_quant_weights`` may have
quantize-dequantized, with every linear's input fake-quantized at run time
under the policy (``_linear``), the reference's eval semantics. Weights are
stored [in, out], so a linear is ``x @ w``.

HF numeric conventions, as in the reference: RMSNorm stats in f32 and the
normed row cast to the model dtype before the gamma multiply; RoPE cos/sin
from an f32 inv_freq, applied in f32 with rotate_half; softmax in f32.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch

from flexq_tpu_torch.config import ModelConfig, QuantPolicy
from flexq_tpu_torch.quant.quantizer import fake_quant, true_div


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


def _maybe_quant_act(x: torch.Tensor, name: str, policy: Optional[QuantPolicy]) -> torch.Tensor:
    if policy is None:
        return x
    spec = policy.act_spec(name)
    if not spec.enabled:
        return x
    return fake_quant(x, spec)


def _linear(params: Dict[str, Any], name: str, x: torch.Tensor, policy: Optional[QuantPolicy]) -> torch.Tensor:
    """Dense linear with the input fake-quantized under the policy at run
    time (dynamic activation quant, as the reference evaluates)."""
    x = _maybe_quant_act(x, name, policy)
    y = x @ params[name]["w"].to(x.dtype)
    b = params[name].get("b")
    if b is not None:
        y = y + b.to(y.dtype)
    return y


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


def span_mask(pos_q: torch.Tensor, max_len: int, window: Optional[int] = None, dtype=torch.float32) -> torch.Tensor:
    """Additive causal mask [B, 1, Lq, max_len] for queries at absolute
    positions ``pos_q`` (int [B, Lq]) over a max_len cache: query (b, i)
    sees keys at positions <= pos_q[b, i] (and, with ``window``,
    > pos_q[b, i] - window). On pos_q's device."""
    ki = torch.arange(max_len, device=pos_q.device)[None, None, None, :]
    pq = pos_q[:, None, :, None]
    ok = ki <= pq
    if window is not None:
        ok &= ki > pq - window
    return torch.where(ok, 0.0, torch.finfo(dtype).min).to(dtype)


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


def attention_core_quant(q, k8, ks, v8, vs, mask: Optional[torch.Tensor], num_kv_groups: int) -> torch.Tensor:
    """Attention over an int8 cache with the scales folded into the math:
    q [B, Lq, H, D]; k8 / v8 int8 [B, KVH, Lk, D] (the cache layout); ks / vs
    f32 [B, KVH, Lk] per-(token, head) scales. scores = (q . K8) * ks / sqrt(D)
    (q and K8 in bf16), out = sum_t bf16(p * vs) . V8 (bf16), so no
    dequantized copy of the cache is made. -> [B, Lq, H * D] in q's dtype."""
    b, lq, h, d = q.shape
    if num_kv_groups > 1:
        k8, v8 = k8.repeat_interleave(num_kv_groups, dim=1), v8.repeat_interleave(num_kv_groups, dim=1)
        ks, vs = ks.repeat_interleave(num_kv_groups, dim=1), vs.repeat_interleave(num_kv_groups, dim=1)
    scores = torch.einsum("bqhd,bhkd->bhqk", q.to(torch.bfloat16), k8.to(torch.bfloat16)).to(torch.float32)
    scores = scores * ks[:, :, None, :]
    scores = true_div(scores, math.sqrt(d))
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1)
    pv = (probs * vs[:, :, None, :]).to(torch.bfloat16)
    out = torch.einsum("bhqk,bhkd->bqhd", pv, v8.to(torch.bfloat16))
    return out.to(q.dtype).reshape(b, lq, h * d)


def decoder_layer(
    lp: Dict[str, Any],
    cfg: ModelConfig,
    x: torch.Tensor,  # [B, L, H]
    cos: torch.Tensor,
    sin: torch.Tensor,
    mask: Optional[torch.Tensor],
    policy: Optional[QuantPolicy] = None,
    kv: Optional[Tuple[torch.Tensor, torch.Tensor, int]] = None,  # (cache k, cache v [layers, B, max, KVH, D], layer)
    cache_pos: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """One dense decoder layer. With ``kv`` the step's K/V are written into
    the cache at ``cache_pos`` (in place: the port's tensors are mutable)
    and attention runs over the whole cache under ``mask``."""
    b, l, _ = x.shape
    h = rmsnorm(x, lp["input_norm"], cfg.norm_eps)
    q = _linear(lp, "q_proj", h, policy).reshape(b, l, cfg.num_heads, cfg.head_dim)
    k = _linear(lp, "k_proj", h, policy).reshape(b, l, cfg.num_kv_heads, cfg.head_dim)
    v = _linear(lp, "v_proj", h, policy).reshape(b, l, cfg.num_kv_heads, cfg.head_dim)
    q, k = apply_rope(q, k, cos, sin)

    new_kv = None
    if kv is not None:
        ck, cv, li = kv
        ck[li, :, cache_pos : cache_pos + l] = k.to(ck.dtype)
        cv[li, :, cache_pos : cache_pos + l] = v.to(cv.dtype)
        new_kv = (ck, cv)
        k, v = ck[li], cv[li]

    attn = attention_core(q, k, v, mask, cfg.num_kv_groups)
    x = x + _linear(lp, "o_proj", attn, policy)

    h = rmsnorm(x, lp["post_norm"], cfg.norm_eps)
    gate = _linear(lp, "gate_proj", h, policy)
    up = _linear(lp, "up_proj", h, policy)
    act = act_fn(cfg.act, gate.to(torch.float32)).to(gate.dtype) * up
    x = x + _linear(lp, "down_proj", act, policy)
    return x, new_kv


def forward(
    params: Dict[str, Any],
    cfg: ModelConfig,
    ids,  # int [B, L]
    policy: Optional[QuantPolicy] = None,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full-sequence dense forward -> logits [B, L, V] on the params'
    device (the perplexity-eval path): the ids go to that device; Gemma's
    ``embed_scale``, Mistral's ``sliding_window`` and the Llama-3 RoPE
    scaling are taken from ``cfg``. A tree with an ``lm_head`` fake-quantizes
    the head's input under the policy; a tied head is the embedding."""
    dev = params["embed"].device
    ids = torch.as_tensor(ids, device=dev)
    b, l = ids.shape
    x = params["embed"][ids]
    if cfg.embed_scale is not None:
        x = x * torch.tensor(cfg.embed_scale, dtype=x.dtype)
    if positions is None:
        positions = torch.arange(l, device=dev).expand(b, l)
    cos, sin = rope_for_cfg(torch.as_tensor(positions, device=dev), cfg)
    mask = causal_mask(l, l, window=cfg.sliding_window, device=dev)
    for lp in params["layers"]:
        x, _ = decoder_layer(lp, cfg, x, cos, sin, mask, policy)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    else:
        x = _maybe_quant_act(x, "lm_head", policy)
    return x @ head.to(x.dtype)


def _fake_quant_linear(w: torch.Tensor, spec) -> torch.Tensor:
    """A stored [in, out] weight quantize-dequantized per output channel,
    its groups along ``in`` (the reference quantizes the [out, in] rows)."""
    return fake_quant(w.T, spec).T.contiguous()


def fake_quant_weights(params: Dict[str, Any], policy: QuantPolicy) -> Dict[str, Any]:
    """A new tree with every policy-covered linear weight fake-quantized
    (the lm_head too, where the tree has one and the policy covers it); the
    input tree and its tensors are left as they were."""
    out = dict(params)
    out["layers"] = []
    for lp in params["layers"]:
        lp = dict(lp)
        for name in policy.weight_bits:
            if name not in lp:
                continue
            spec = policy.weight_spec(name)
            if not spec.enabled:
                continue
            lp[name] = {**lp[name], "w": _fake_quant_linear(lp[name]["w"], spec)}
        out["layers"].append(lp)
    if "lm_head" in out and "lm_head" in policy.weight_bits:
        spec = policy.weight_spec("lm_head")
        if spec.enabled:
            out["lm_head"] = _fake_quant_linear(out["lm_head"], spec)
    return out
