"""Quantized long-context serving with the prompt split over a sequence
ring (port of flexq_tpu/parallel/sp_serve.py on torch.distributed).

- ``sp_prefill``: the W*A16 prefill (the W6A16 / W4A16 GEMMs, K7 / K11, a
  projection at a time; RMSNorm, RoPE and act(gate)·up in plain PyTorch, as
  the reference computes them) on this rank's L/sp chunk of the prompt,
  attention through the K/V ring (parallel/cp.py::ring_attention). Each
  rank keeps its chunk of the prompt cache, bf16 or int8 (per token and
  head scales), so a ring of sp ranks holds sp times the prompt one rank
  could.
- ``sp_decode_step``: one token. The linears run on every rank (the exact
  W*Ax layer: K1, K4, K5 with the exact GEMMs K2 / K3; the W*A16 GEMMs
  under a no-act-quant policy); attention over the split prompt cache runs
  as partial flash statistics a rank (max, sum, accumulator in f32),
  merged by an all-reduce MAX and one all-reduce SUM of the rescaled sum
  and accumulator. The generated tokens' K/V go into a small tail cache
  that every rank holds and only the last rank folds in.
- ``generate_sp``: the prefill, then greedy decode steps.

The reference's scope holds: LLaMA-family models, unfused projections, no
sliding window, L % sp == 0; the prompt cache is bf16 or int8, the tail
bf16. Every rank calls each function with the same arguments (the whole
prompt; each takes its own chunk). Where the reference returns a new tail
cache, ``sp_decode_step`` writes the step's K/V into the one it is given,
in place, and returns it.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from flexq_tpu_torch.config import ModelConfig, QuantPolicy, require_servable
from flexq_tpu_torch.kernels import glu_quant, quant_act, rmsnorm_quant
from flexq_tpu_torch.models.llama import act_fn, apply_rope, rmsnorm, rope_for_cfg
from flexq_tpu_torch.models.quantized import _ffn_width, _kv_quant, _qlinear, _qlinear_bf16, apply_lm_head, embed_ids
from flexq_tpu_torch.parallel.cp import NEG, SeqMesh, local_chunk, ring_attention


def _check(cfg: ModelConfig, policy: QuantPolicy, params) -> None:
    """The reference's scope of sequence-parallel serving."""
    require_servable(policy)
    if cfg.arch != "llama":
        raise ValueError(f"sequence-parallel serving takes LLaMA-family models; not {cfg.arch}")
    if "qkv_proj" in params["layers"][0]:
        raise ValueError("sequence-parallel serving takes unfused projections (quantize_params fuse=False)")
    if cfg.sliding_window is not None:
        raise NotImplementedError("sequence-parallel serving does not implement sliding-window masks (a windowed "
                                  "model's live KV fits one card: serve it on the dense or paged paths)")


def _sp_prefill_layer(lp, cfg: ModelConfig, x, cos, sin, mesh: SeqMesh):
    """One W*A16 prefill layer on this rank's chunk, attention through the
    ring. Returns (x, k, v) with k / v [B, KVH, C, D], the cache layout."""
    b, c, hidden = x.shape
    dtype = x.dtype
    x2 = x.reshape(b * c, hidden)
    h = rmsnorm(x2, lp["input_norm"], cfg.norm_eps)
    nq, nkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    q = _qlinear_bf16(lp["q_proj"], h, dtype, nq).reshape(b, c, cfg.num_heads, cfg.head_dim)
    k = _qlinear_bf16(lp["k_proj"], h, dtype, nkv).reshape(b, c, cfg.num_kv_heads, cfg.head_dim)
    v = _qlinear_bf16(lp["v_proj"], h, dtype, nkv).reshape(b, c, cfg.num_kv_heads, cfg.head_dim)
    q, k = apply_rope(q, k, cos, sin)
    attn = ring_attention(q, k, v, mesh, cfg.num_kv_groups)
    x2 = x2 + _qlinear_bf16(lp["o_proj"], attn.reshape(b * c, nq), dtype, hidden)
    h = rmsnorm(x2, lp["post_norm"], cfg.norm_eps)
    ffn_pad = _ffn_width(lp["down_proj"], cfg)
    gate = _qlinear_bf16(lp["gate_proj"], h, dtype, ffn_pad)
    up = _qlinear_bf16(lp["up_proj"], h, dtype, ffn_pad)
    act = (act_fn(cfg.act, gate.to(torch.float32)) * up.to(torch.float32)).to(dtype)
    x2 = x2 + _qlinear_bf16(lp["down_proj"], act, dtype, hidden)
    return x2.reshape(b, c, hidden), k.transpose(1, 2), v.transpose(1, 2)


def sp_prefill(
    params: Dict[str, Any],
    cfg: ModelConfig,
    policy: QuantPolicy,
    ids,  # [B, L], L % sp == 0 (every rank the whole prompt)
    mesh: SeqMesh,
    kv_dtype=torch.bfloat16,
):
    """Sequence-parallel prefill. Returns (the last token's logits [B, V] on
    every rank, this rank's prompt cache): (pk, pv) [layers, B, KVH, L/sp, D]
    bf16, or with ``kv_dtype=torch.int8`` (pk, pv, k_scale, v_scale), the
    int8 values and f32 scales [layers, B, KVH, L/sp]."""
    _check(cfg, policy, params)
    dev = params["embed"].device
    ids = local_chunk(torch.as_tensor(ids, device=dev), mesh)
    b, c = ids.shape
    pos = mesh.rank * c + torch.arange(c, device=dev).expand(b, c)
    cos, sin = rope_for_cfg(pos, cfg)
    x = embed_ids(params, cfg, ids, pos)
    ks, vs = [], []
    for lp in params["layers"]:
        x, k, v = _sp_prefill_layer(lp, cfg, x, cos, sin, mesh)
        ks.append(k)
        vs.append(v)
    pk, pv = torch.stack(ks), torch.stack(vs)
    # the last token is the last rank's: its normed row goes to every rank
    xl = rmsnorm(x[:, -1], params["final_norm"], cfg.norm_eps).contiguous()
    dist.broadcast(xl, mesh.sp - 1, group=mesh.group)
    logits = apply_lm_head(params, cfg, policy, xl[:, None])[:, 0]
    if kv_dtype == torch.int8:
        kq, kscale = _kv_quant(pk)
        vq, vscale = _kv_quant(pv)
        return logits, (kq, vq, kscale, vscale)
    return logits, (pk.to(kv_dtype), pv.to(kv_dtype))


def _sp_attend(q, pk_l, pv_l, tk_l, tv_l, t: int, groups: int, mesh: SeqMesh, ks_l=None, vs_l=None):
    """Decode attention over the split prompt cache: this rank's partial
    statistics over its chunk (and, on the last rank only, the generated
    tail up to step t), merged over the ring by an all-reduce MAX of the
    running max and one all-reduce SUM of the rescaled sum and accumulator
    (the reference's pmax / psum pair). With ``ks_l`` / ``vs_l`` (f32
    [B, KVH, C]) the chunk is int8 and its scales fold into the scores and
    the probabilities. q [B, 1, H, D] -> [B, 1, H*D] (f32)."""
    b, _, hq, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qf = q[:, 0].to(torch.float32)  # [B, H, D]

    def heads(x):
        return x.repeat_interleave(groups, dim=1)

    s = torch.einsum("bhd,bhkd->bhk", qf, heads(pk_l).to(torch.float32)) * scale  # [B, H, C]
    if ks_l is not None:
        s = s * heads(ks_l)
    st = torch.einsum("bhd,bhkd->bhk", qf, heads(tk_l).to(torch.float32)) * scale  # [B, H, T]
    tmask = (torch.arange(st.shape[-1], device=q.device) <= t) & (mesh.rank == mesh.sp - 1)
    st = torch.where(tmask[None, None, :], st, NEG)
    m_r = torch.maximum(s.amax(dim=-1), st.amax(dim=-1))  # [B, H]
    p = torch.exp(s - m_r[..., None])
    pt = torch.exp(st - m_r[..., None])
    l_r = p.sum(-1) + pt.sum(-1)
    pw = p * heads(vs_l) if vs_l is not None else p
    acc_r = (torch.einsum("bhk,bhkd->bhd", pw, heads(pv_l).to(torch.float32))
             + torch.einsum("bhk,bhkd->bhd", pt, heads(tv_l).to(torch.float32)))
    m = m_r.clone()
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=mesh.group)
    coef = torch.exp(m_r - m)
    merged = torch.cat([(l_r * coef)[..., None], acc_r * coef[..., None]], dim=-1)  # [B, H, 1 + D]
    dist.all_reduce(merged, group=mesh.group)
    out = merged[..., 1:] / merged[..., :1].clamp_min(1e-30)
    return out.reshape(b, 1, hq * d)


def _sp_decode_layer(lp, cfg: ModelConfig, policy: QuantPolicy, li: int, x, cos, sin, pcache, tk, tv, t: int,
                     mesh: SeqMesh):
    """One decode layer (the exact W*Ax layer, or the W*A16 one under a
    no-act-quant policy) with the ring-merged attention; the step's K/V
    written into the tail at position t, in place."""
    b, _, hidden = x.shape
    dtype = x.dtype
    x2 = x.reshape(b, hidden)
    nq, nkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    exact = not policy.no_act_quant
    if exact:
        qx, qs = rmsnorm_quant(x2, lp["input_norm"], bits=policy.act_bits.get("q_proj", 6), eps=cfg.norm_eps)
        q, k, v = (_qlinear(lp[n], qx, qs, dtype, w) for n, w in (("q_proj", nq), ("k_proj", nkv), ("v_proj", nkv)))
    else:
        h = rmsnorm(x2, lp["input_norm"], cfg.norm_eps)
        q, k, v = (_qlinear_bf16(lp[n], h, dtype, w) for n, w in (("q_proj", nq), ("k_proj", nkv), ("v_proj", nkv)))
    q = q.reshape(b, 1, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, 1, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, 1, cfg.num_kv_heads, cfg.head_dim)
    q, k = apply_rope(q, k, cos, sin)
    tk[li, :, :, t : t + 1] = k.transpose(1, 2).to(tk.dtype)
    tv[li, :, :, t : t + 1] = v.transpose(1, 2).to(tv.dtype)
    scales = dict(ks_l=pcache[2][li], vs_l=pcache[3][li]) if len(pcache) == 4 else {}
    attn = _sp_attend(q, pcache[0][li], pcache[1][li], tk[li], tv[li], t, cfg.num_kv_groups, mesh, **scales)
    attn = attn.to(dtype).reshape(b, nq)
    ffn_pad = _ffn_width(lp["down_proj"], cfg)
    if exact:
        oq, os_ = quant_act(attn, bits=policy.act_bits.get("o_proj", 6))
        o = _qlinear(lp["o_proj"], oq, os_, dtype, hidden)
        fq, fs, x2 = rmsnorm_quant(o, lp["post_norm"], bits=policy.act_bits.get("gate_proj", 6), residual=x2,
                                   eps=cfg.norm_eps)
        gate = _qlinear(lp["gate_proj"], fq, fs, dtype, ffn_pad)
        up = _qlinear(lp["up_proj"], fq, fs, dtype, ffn_pad)
        dq, ds = glu_quant(gate, up, bits=policy.act_bits.get("down_proj", 8), act=cfg.act)
        x2 = x2 + _qlinear(lp["down_proj"], dq, ds, dtype, hidden)
    else:
        x2 = x2 + _qlinear_bf16(lp["o_proj"], attn, dtype, hidden)
        h = rmsnorm(x2, lp["post_norm"], cfg.norm_eps)
        gate = _qlinear_bf16(lp["gate_proj"], h, dtype, ffn_pad)
        up = _qlinear_bf16(lp["up_proj"], h, dtype, ffn_pad)
        act = (act_fn(cfg.act, gate.to(torch.float32)) * up.to(torch.float32)).to(dtype)
        x2 = x2 + _qlinear_bf16(lp["down_proj"], act, dtype, hidden)
    return x2.reshape(b, 1, hidden)


def sp_decode_step(
    params: Dict[str, Any],
    cfg: ModelConfig,
    policy: QuantPolicy,
    tok,  # [B, 1]
    mesh: SeqMesh,
    prompt_cache: Tuple,  # this rank's (pk, pv[, k_scale, v_scale]) from sp_prefill
    tail_k: torch.Tensor,  # [layers, B, KVH, T, D] bf16, the generated tokens' K/V (every rank)
    tail_v: torch.Tensor,
    t: int,  # the decode step (the tail's write position)
    prompt_len: int,
):
    """One sequence-parallel decode step at position prompt_len + t.
    Returns (logits [B, V] on every rank, tail_k, tail_v), the tail written
    in place."""
    _check(cfg, policy, params)
    dev = params["embed"].device
    tok = torch.as_tensor(tok, device=dev)
    b = tok.shape[0]
    pos = torch.full((b, 1), prompt_len + t, dtype=torch.int64, device=dev)
    cos, sin = rope_for_cfg(pos, cfg)
    x = embed_ids(params, cfg, tok, pos)
    for li, lp in enumerate(params["layers"]):
        x = _sp_decode_layer(lp, cfg, policy, li, x, cos, sin, prompt_cache, tail_k, tail_v, t, mesh)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return apply_lm_head(params, cfg, policy, x)[:, 0], tail_k, tail_v


def generate_sp(
    params: Dict[str, Any],
    cfg: ModelConfig,
    policy: QuantPolicy,
    prompt_ids,  # [B, L], L % sp == 0 (equal lengths)
    mesh: SeqMesh,
    max_new_tokens: int,
    eos_id: int = -1,
    greedy: bool = True,
    return_logits: bool = False,
    kv_dtype=torch.bfloat16,
):
    """Sequence-parallel greedy generation: ``sp_prefill``, then a decode
    step a token (the reference's scope: greedy; ``eos_id`` and ``greedy``
    are taken as the reference takes them and read by neither). Returns the
    tokens [B, max_new_tokens] (numpy) and, with ``return_logits``, each
    step's logits [B, max_new_tokens, V]."""
    dev = params["embed"].device
    ids = torch.as_tensor(np.asarray(prompt_ids), dtype=torch.int64, device=dev)
    b, l = ids.shape
    logits, pcache = sp_prefill(params, cfg, policy, ids, mesh, kv_dtype=kv_dtype)
    tail = (len(params["layers"]), b, cfg.num_kv_heads, max_new_tokens, cfg.head_dim)
    tk = torch.zeros(tail, dtype=torch.bfloat16, device=dev)
    tv = torch.zeros(tail, dtype=torch.bfloat16, device=dev)
    toks, all_logits = [], []
    cur = torch.argmax(logits, dim=-1)[:, None]
    for t in range(max_new_tokens):
        toks.append(cur[:, 0])
        if return_logits:
            all_logits.append(logits)
        if t == max_new_tokens - 1:
            break
        logits, tk, tv = sp_decode_step(params, cfg, policy, cur, mesh, pcache, tk, tv, t, l)
        cur = torch.argmax(logits, dim=-1)[:, None]
    out = torch.stack(toks, dim=1).cpu().numpy()
    if return_logits:
        return out, torch.stack(all_logits, dim=1).float().cpu().numpy()
    return out
