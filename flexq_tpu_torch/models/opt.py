"""OPT decoder in plain PyTorch (port of flexq_tpu/models/opt.py): LayerNorm,
and the dense model of the quantize-and-evaluate path.

OPT adds a learned positional embedding read at ``position + POS_OFFSET``
(HF's OPTLearnedPositionalEmbedding), normalises with LayerNorm (stats in
f32, ``y * g + b`` in f32, then a cast to the model dtype), has biased
linears, a ReLU MLP and a tied lm_head. The dense model honours
``do_layer_norm_before=False`` (post-LN, OPT-350m) as the reference's does;
the serve graph (``models/quantized.py::opt_layer_serve``) is pre-LN only.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from flexq_tpu_torch.config import ModelConfig, QuantPolicy
from flexq_tpu_torch.models.llama import _fake_quant_linear, attention_core, causal_mask
from flexq_tpu_torch.quant.quantizer import fake_quant

POS_OFFSET = 2  # HF OPTLearnedPositionalEmbedding offset


def layernorm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    h = x.to(torch.float32)
    mu = h.mean(dim=-1, keepdim=True)
    var = ((h - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (h - mu) * torch.rsqrt(var + eps)
    return (y * g.to(torch.float32) + b.to(torch.float32)).to(x.dtype)


def _maybe_quant_act(x: torch.Tensor, name: str, policy: Optional[QuantPolicy]) -> torch.Tensor:
    if policy is None:
        return x
    spec = policy.act_spec(name)
    return fake_quant(x, spec) if spec.enabled else x


def _linear(lp, name: str, x: torch.Tensor, policy: Optional[QuantPolicy]) -> torch.Tensor:
    x = _maybe_quant_act(x, name, policy)
    y = x @ lp[name]["w"].to(x.dtype)
    b = lp[name].get("b")
    return y + b.to(y.dtype) if b is not None else y


def _norm(x: torch.Tensor, norm: Dict[str, torch.Tensor], cfg: ModelConfig) -> torch.Tensor:
    return layernorm(x, norm["g"], norm["b"], cfg.norm_eps)


def decoder_layer(
    lp: Dict[str, Any],
    cfg: ModelConfig,
    x: torch.Tensor,  # [B, L, H]
    mask: Optional[torch.Tensor],
    policy: Optional[QuantPolicy] = None,
    kv: Optional[Tuple[torch.Tensor, torch.Tensor, int]] = None,  # (cache k, cache v [layers, B, max, H, D], layer)
    cache_pos: Optional[int] = None,
):
    """One dense OPT layer: pre-LN (LayerNorm before attention and MLP) or,
    with ``do_layer_norm_before=False``, post-LN (after each residual add).
    With ``kv`` the step's K/V are written into the cache in place."""
    b, l, _ = x.shape
    pre = cfg.do_layer_norm_before
    res = x
    h = _norm(x, lp["input_norm"], cfg) if pre else x
    q = _linear(lp, "q_proj", h, policy).reshape(b, l, cfg.num_heads, cfg.head_dim)
    k = _linear(lp, "k_proj", h, policy).reshape(b, l, cfg.num_heads, cfg.head_dim)
    v = _linear(lp, "v_proj", h, policy).reshape(b, l, cfg.num_heads, cfg.head_dim)

    new_kv = None
    if kv is not None:
        ck, cv, li = kv
        ck[li, :, cache_pos : cache_pos + l] = k.to(ck.dtype)
        cv[li, :, cache_pos : cache_pos + l] = v.to(cv.dtype)
        new_kv = (ck, cv)
        k, v = ck[li], cv[li]

    attn = attention_core(q, k, v, mask, 1)
    x = res + _linear(lp, "o_proj", attn, policy)
    if not pre:
        x = _norm(x, lp["input_norm"], cfg)

    res = x
    h = _norm(x, lp["post_norm"], cfg) if pre else x
    h = torch.clamp_min(_linear(lp, "fc1", h, policy), 0)
    x = res + _linear(lp, "fc2", h, policy)
    if not pre:
        x = _norm(x, lp["post_norm"], cfg)
    return x, new_kv


def forward(
    params: Dict[str, Any],
    cfg: ModelConfig,
    ids,  # int [B, L]
    policy: Optional[QuantPolicy] = None,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full-sequence dense forward -> logits [B, L, V] on the params'
    device (the ids go there)."""
    dev = params["embed"].device
    ids = torch.as_tensor(ids, device=dev)
    b, l = ids.shape
    x = params["embed"][ids]
    if positions is None:
        positions = torch.arange(l, device=dev).expand(b, l)
    x = x + params["pos_embed"][torch.as_tensor(positions, device=dev) + POS_OFFSET]
    mask = causal_mask(l, l, device=dev)
    for lp in params["layers"]:
        x, _ = decoder_layer(lp, cfg, x, mask, policy)
    if "final_norm" in params:
        x = _norm(x, params["final_norm"], cfg)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return x @ head.to(x.dtype)


def fake_quant_weights(params: Dict[str, Any], policy: QuantPolicy) -> Dict[str, Any]:
    """A new tree with every policy-covered linear weight fake-quantized;
    the input tree is left as it was (OPT's head is tied: not quantized)."""
    out = dict(params)
    out["layers"] = []
    for lp in params["layers"]:
        lp = dict(lp)
        for name in policy.weight_bits:
            if name not in lp:
                continue
            spec = policy.weight_spec(name)
            if spec.enabled:
                lp[name] = {**lp[name], "w": _fake_quant_linear(lp[name]["w"], spec)}
        out["layers"].append(lp)
    return out
