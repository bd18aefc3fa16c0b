"""SmoothQuant-style scale folding between adjacent ops (port of
flexq_tpu/quant/smooth.py). Pure tree -> tree functions: every fold returns
new dicts and new tensors and leaves its inputs as they were.

Math (exact up to float rounding):

  ln -> fcs:  y = LN(x) * g + b feeds fcs. Fold per-channel (s, t):
              g' = g / s, b' = (b - t) / s; w' = s * w (rows), bias' += t @ w.
  fc -> fc:   v_proj -> o_proj: v's output channels / s, o's input channels
              * s (GQA: per-kv-head scales repeat over the query groups).
  q -> k:     q's outputs / s, k's outputs * s: q . k is unchanged per
              channel; under RoPE only if s is constant within each
              (i, i + D/2) rotation pair, which ``rope=True`` enforces.

Scales follow SmoothQuant: s_c = max|x_c|^alpha / max|w_c|^(1 - alpha).
Weights are stored [in, out]; the folds compute in f32 and cast back.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flexq_tpu_torch.config import ModelConfig

CLIP = 1e-5

F32 = torch.float32


def compute_smooth_scales(act_absmax: torch.Tensor, w_absmax: torch.Tensor, alpha: float = 0.5) -> torch.Tensor:
    """act_absmax [C]: per input channel |x| max from calibration; w_absmax
    [C]: the per-input-channel max over the fused consumer weights."""
    a = torch.as_tensor(act_absmax).to(F32).clamp_min(CLIP)
    w = w_absmax.to(device=a.device, dtype=F32).clamp_min(CLIP)
    s = torch.pow(a, alpha) / torch.pow(w, 1.0 - alpha)
    return s.clamp(CLIP, 1e4)


def _as_norm_dict(ln) -> Tuple[Dict[str, torch.Tensor], bool]:
    """A norm's params: a bare gamma (RMSNorm) or {"g", "b"} (LayerNorm)."""
    if isinstance(ln, dict):
        return dict(ln), True
    return {"g": ln}, False


def smooth_ln_fcs(
    ln,
    fcs: Sequence[Dict[str, torch.Tensor]],
    scales: torch.Tensor,  # [C] per norm-output channel
    shifts: Optional[torch.Tensor] = None,
) -> Tuple[Any, List[Dict[str, torch.Tensor]]]:
    """Fold (scales, shifts) out of a norm and into its consumer linears. A
    non-zero shift on an RMSNorm (no bias to absorb it) is refused."""
    nd, was_dict = _as_norm_dict(ln)
    scales = scales.to(F32)
    shifts = torch.zeros_like(scales) if shifts is None else shifts.to(F32)
    shifted = bool((shifts.abs() > 0).any())
    if not was_dict and shifted:
        raise ValueError("rmsnorm (no bias) cannot absorb a non-zero shift")
    nd["g"] = (nd["g"].to(F32) / scales).to(nd["g"].dtype)
    if nd.get("b") is not None:
        nd["b"] = ((nd["b"].to(F32) - shifts) / scales).to(nd["b"].dtype)
    out_fcs = []
    for fc in fcs:
        w = fc["w"].to(F32)
        nfc = dict(fc)
        nfc["w"] = (w * scales[:, None]).to(fc["w"].dtype)
        absorbed = shifts @ w  # [out]
        if fc.get("b") is not None:
            nfc["b"] = (fc["b"].to(F32) + absorbed).to(fc["b"].dtype)
        elif shifted:
            nfc["b"] = absorbed.to(fc["w"].dtype)
        out_fcs.append(nfc)
    return (nd if was_dict else nd["g"]), out_fcs


def _expand_gqa(scales: torch.Tensor, kv_heads: int, groups: int) -> torch.Tensor:
    """[KVH * D] -> [KVH * G * D], each kv head's block repeated G times."""
    d = scales.shape[0] // kv_heads
    return scales.reshape(kv_heads, 1, d).expand(kv_heads, groups, d).reshape(-1)


def smooth_fc_fc(
    fc1: Dict[str, torch.Tensor],
    fc2: Dict[str, torch.Tensor],
    scales: torch.Tensor,  # [fc1_out]
    kv_heads: int = 1,
    num_kv_groups: int = 1,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """v_proj -> o_proj: fc1's outputs / s, fc2's inputs * s (exact through
    the attention mix, which combines V's rows channel by channel)."""
    scales = scales.to(F32)
    nfc1 = dict(fc1)
    nfc1["w"] = (fc1["w"].to(F32) / scales[None, :]).to(fc1["w"].dtype)
    if fc1.get("b") is not None:
        nfc1["b"] = (fc1["b"].to(F32) / scales).to(fc1["b"].dtype)
    s2 = _expand_gqa(scales, kv_heads, num_kv_groups)
    nfc2 = dict(fc2)
    nfc2["w"] = (fc2["w"].to(F32) * s2[:, None]).to(fc2["w"].dtype)
    return nfc1, nfc2


def smooth_q_k(
    q: Dict[str, torch.Tensor],
    k: Dict[str, torch.Tensor],
    scales: torch.Tensor,  # [k_out]
    kv_heads: int = 1,
    num_kv_groups: int = 1,
    rope: bool = False,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """k's outputs * s, q's outputs / s. With RoPE the scales are made equal
    within each rotation pair (their geometric mean) first."""
    scales = scales.to(F32)
    if rope:
        d = scales.shape[0] // kv_heads
        s2 = scales.reshape(kv_heads, 2, d // 2)
        pair = torch.sqrt(s2[:, 0] * s2[:, 1])
        scales = torch.cat([pair, pair], dim=1).reshape(-1)
    nk = dict(k)
    nk["w"] = (k["w"].to(F32) * scales[None, :]).to(k["w"].dtype)
    if k.get("b") is not None:
        nk["b"] = (k["b"].to(F32) * scales).to(k["b"].dtype)
    sq = _expand_gqa(scales, kv_heads, num_kv_groups)
    nq = dict(q)
    nq["w"] = (q["w"].to(F32) / sq[None, :]).to(q["w"].dtype)
    if q.get("b") is not None:
        nq["b"] = (q["b"].to(F32) / sq).to(q["b"].dtype)
    return nq, nk


# ---------------------------------------------------------------------------
# calibration and the whole-model folds


def _absmax(t: torch.Tensor) -> np.ndarray:
    """[.., C] -> [C] f32 numpy: the per-channel |t| max over every other axis."""
    return t.to(F32).abs().reshape(-1, t.shape[-1]).amax(dim=0).cpu().numpy()


def _lin(fc: Dict[str, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    y = h @ fc["w"]
    if fc.get("b") is not None:
        y = y + fc["b"].to(y.dtype)
    return y


def collect_llama_act_stats(params: Dict[str, Any], cfg: ModelConfig, ids) -> List[Dict[str, np.ndarray]]:
    """Per layer, the per-channel absmax of the inputs of each foldable
    linear group (and q / k / v's outputs), from one dense forward over the
    calibration ids [B, L] on the params' device."""
    from flexq_tpu_torch.models.llama import act_fn, apply_rope, attention_core, causal_mask, rmsnorm, rope_for_cfg

    dev = params["embed"].device
    ids = torch.as_tensor(ids, device=dev)
    b, l = ids.shape
    stats = []
    with torch.no_grad():
        x = params["embed"][ids]
        if cfg.embed_scale is not None:
            x = x * torch.tensor(cfg.embed_scale, dtype=x.dtype)
        cos, sin = rope_for_cfg(torch.arange(l, device=dev).expand(b, l), cfg)
        mask = causal_mask(l, l, window=cfg.sliding_window, device=dev)
        for lp in params["layers"]:
            st: Dict[str, np.ndarray] = {}
            h = rmsnorm(x, lp["input_norm"], cfg.norm_eps)
            st["qkv_in"] = _absmax(h)
            q = _lin(lp["q_proj"], h).reshape(b, l, cfg.num_heads, cfg.head_dim)
            k = _lin(lp["k_proj"], h).reshape(b, l, cfg.num_kv_heads, cfg.head_dim)
            v = _lin(lp["v_proj"], h).reshape(b, l, cfg.num_kv_heads, cfg.head_dim)
            st["v_out"] = _absmax(v.reshape(b, l, -1))
            st["q_out"] = _absmax(q.reshape(b, l, -1))  # before RoPE (the fold's site)
            st["k_out"] = _absmax(k.reshape(b, l, -1))
            q, k = apply_rope(q, k, cos, sin)
            attn = attention_core(q, k, v, mask, cfg.num_kv_groups)
            st["o_in"] = _absmax(attn)
            x = x + _lin(lp["o_proj"], attn)
            h = rmsnorm(x, lp["post_norm"], cfg.norm_eps)
            st["ffn_in"] = _absmax(h)
            gate = _lin(lp["gate_proj"], h)
            up = _lin(lp["up_proj"], h)
            act = act_fn(cfg.act, gate.to(F32)).to(gate.dtype) * up
            x = x + _lin(lp["down_proj"], act)
            stats.append(st)
    return stats


def _w_absmax(*fcs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Per input channel, the |w| max over the concatenated outputs."""
    return torch.cat([fc["w"] for fc in fcs], dim=1).to(F32).abs().amax(dim=1)


def _stat(st: Dict[str, np.ndarray], key: str, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(st[key], np.float32), device=dev)


def _per_kv_head(t: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """[H * D] -> [KVH * D]: the max over each kv head's query group."""
    if cfg.num_kv_groups == 1:
        return t
    return t.reshape(cfg.num_kv_heads, cfg.num_kv_groups, cfg.head_dim).amax(dim=1).reshape(-1)


def smooth_llama(
    params: Dict[str, Any],
    cfg: ModelConfig,
    act_stats: List[Dict[str, np.ndarray]],
    alpha: float = 0.5,
    fold_qk: bool = False,
) -> Dict[str, Any]:
    """input norm -> q/k/v, v -> o, post norm -> gate/up (and, with
    ``fold_qk``, q <-> k, pair-constant under RoPE) on a dense LLaMA tree.
    Returns a new tree whose dense output equals the input's up to float
    rounding: run it before fake_quant_weights / quantize_params."""
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = []
    for lp, st in zip(params["layers"], act_stats):
        lp = dict(lp)
        dev = lp["q_proj"]["w"].device
        s = compute_smooth_scales(_stat(st, "qkv_in", dev), _w_absmax(lp["q_proj"], lp["k_proj"], lp["v_proj"]),
                                  alpha)
        ln, (fq, fk, fv) = smooth_ln_fcs(lp["input_norm"], [lp["q_proj"], lp["k_proj"], lp["v_proj"]], s)
        lp["input_norm"], lp["q_proj"], lp["k_proj"], lp["v_proj"] = ln, fq, fk, fv
        # v -> o, per v-output channel (o's stats and weights reduced over the query groups)
        o_in = _per_kv_head(_stat(st, "o_in", dev), cfg)
        w_amax = _per_kv_head(lp["o_proj"]["w"].to(F32).abs().amax(dim=1), cfg)
        s = compute_smooth_scales(o_in, w_amax, alpha)
        lp["v_proj"], lp["o_proj"] = smooth_fc_fc(lp["v_proj"], lp["o_proj"], s, cfg.num_kv_heads, cfg.num_kv_groups)
        s = compute_smooth_scales(_stat(st, "ffn_in", dev), _w_absmax(lp["gate_proj"], lp["up_proj"]), alpha)
        ln, (fg, fu) = smooth_ln_fcs(lp["post_norm"], [lp["gate_proj"], lp["up_proj"]], s)
        lp["post_norm"], lp["gate_proj"], lp["up_proj"] = ln, fg, fu
        if fold_qk:
            # balance |q| against |k| per channel: s = sqrt(max|q| / max|k|)
            q_amax = _per_kv_head(_stat(st, "q_out", dev), cfg)
            k_amax = _stat(st, "k_out", dev)
            s = torch.sqrt(q_amax.clamp_min(CLIP) / k_amax.clamp_min(CLIP)).clamp(CLIP, 1e4)
            lp["q_proj"], lp["k_proj"] = smooth_q_k(lp["q_proj"], lp["k_proj"], s, cfg.num_kv_heads,
                                                    cfg.num_kv_groups, rope=True)
        out["layers"].append(lp)
    return out


def collect_opt_act_stats(params: Dict[str, Any], cfg: ModelConfig, ids) -> List[Dict[str, np.ndarray]]:
    """The pre-LN OPT counterpart of collect_llama_act_stats."""
    from flexq_tpu_torch.models.llama import attention_core, causal_mask
    from flexq_tpu_torch.models.opt import POS_OFFSET, layernorm

    if not cfg.do_layer_norm_before:
        raise ValueError("smoothing folds require pre-LN OPT")
    dev = params["embed"].device
    ids = torch.as_tensor(ids, device=dev)
    b, l = ids.shape
    stats = []
    with torch.no_grad():
        positions = torch.arange(l, device=dev).expand(b, l)
        x = params["embed"][ids] + params["pos_embed"][positions + POS_OFFSET]
        mask = causal_mask(l, l, device=dev)
        for lp in params["layers"]:
            st: Dict[str, np.ndarray] = {}
            h = layernorm(x, lp["input_norm"]["g"], lp["input_norm"]["b"], cfg.norm_eps)
            st["qkv_in"] = _absmax(h)
            q = _lin(lp["q_proj"], h).reshape(b, l, cfg.num_heads, cfg.head_dim)
            k = _lin(lp["k_proj"], h).reshape(b, l, cfg.num_heads, cfg.head_dim)
            v = _lin(lp["v_proj"], h).reshape(b, l, cfg.num_heads, cfg.head_dim)
            st["q_out"] = _absmax(q.reshape(b, l, -1))
            st["k_out"] = _absmax(k.reshape(b, l, -1))
            attn = attention_core(q, k, v, mask, 1)
            st["o_in"] = _absmax(attn)
            x = x + _lin(lp["o_proj"], attn)
            h = layernorm(x, lp["post_norm"]["g"], lp["post_norm"]["b"], cfg.norm_eps)
            st["ffn_in"] = _absmax(h)
            x = x + _lin(lp["fc2"], torch.clamp_min(_lin(lp["fc1"], h), 0))
            stats.append(st)
    return stats


def smooth_opt(
    params: Dict[str, Any],
    cfg: ModelConfig,
    act_stats: List[Dict[str, np.ndarray]],
    alpha: float = 0.5,
    fold_qk: bool = True,
) -> Dict[str, Any]:
    """OPT folds: input LN -> q/k/v, v -> o, post LN -> fc1 and (exact: no
    RoPE) q <-> k. Shifts stay zero (symmetric smoothing)."""
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = []
    for lp, st in zip(params["layers"], act_stats):
        lp = dict(lp)
        dev = lp["q_proj"]["w"].device
        s = compute_smooth_scales(_stat(st, "qkv_in", dev), _w_absmax(lp["q_proj"], lp["k_proj"], lp["v_proj"]),
                                  alpha)
        ln, (fq, fk, fv) = smooth_ln_fcs(lp["input_norm"], [lp["q_proj"], lp["k_proj"], lp["v_proj"]], s)
        lp["input_norm"], lp["q_proj"], lp["k_proj"], lp["v_proj"] = ln, fq, fk, fv
        s = compute_smooth_scales(_stat(st, "o_in", dev), _w_absmax(lp["o_proj"]), alpha)
        lp["v_proj"], lp["o_proj"] = smooth_fc_fc(lp["v_proj"], lp["o_proj"], s)
        s = compute_smooth_scales(_stat(st, "ffn_in", dev), _w_absmax(lp["fc1"]), alpha)
        ln, (f1,) = smooth_ln_fcs(lp["post_norm"], [lp["fc1"]], s)
        lp["post_norm"], lp["fc1"] = ln, f1
        if fold_qk:
            s = torch.sqrt(_stat(st, "q_out", dev).clamp_min(CLIP) / _stat(st, "k_out", dev).clamp_min(CLIP))
            lp["q_proj"], lp["k_proj"] = smooth_q_k(lp["q_proj"], lp["k_proj"], s.clamp(CLIP, 1e4))
        out["layers"].append(lp)
    return out
