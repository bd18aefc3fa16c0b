"""Quantized serve-path LLaMA (port of flexq_tpu/models/quantized.py, the
W6Ax decode layer over a dense bf16 KV cache).

Every linear runs the W6Ax kernel from 6-bit packed planes, activations are
quantized in the producer's epilogue (fused norm / activation kernels), and
attention reads the cache through the attention kernel. Prompts shorter than
the engine's ``prefill_bf16_threshold`` go through this same layer, so short
prompt serving and decode share one path.

Not in this slice (each raises NotImplementedError naming its slice): the
W6A16 prefill layer (kernels K7/K8), no-act-quant policies, the int8 and
paged KV caches, per-row cache positions, fused qkv/gate_up trees, other
weight formats and the quantized lm_head, OPT, and the cache-less forward.

Cache layout: [L, B, KVH, S, D] (sequence second-minor), updated in place:
the port's tensors are mutable, so writing the step's K/V into the caller's
cache replaces the reference's functional cache update.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from flexq_tpu_torch.config import ModelConfig, QuantPolicy
from flexq_tpu_torch.kernels import (
    GROUP_SIZE,
    flash_decode,
    flash_prefill,
    glu_quant,
    quant_act,
    rmsnorm_quant,
    w6_matmul,
)
from flexq_tpu_torch.kernels.common import resolve_device
from flexq_tpu_torch.models.llama import apply_rope, rmsnorm, rope_for_cfg
from flexq_tpu_torch.packing.pack6 import pack6
from flexq_tpu_torch.quant.quantizer import QuantSpec, quantize


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray) and not x.flags.writeable:  # arrays from JAX are read-only
        x = x.copy()
    return torch.as_tensor(x, device=device)


def _padded_width(n: int) -> int:
    """Plane width: N padded to a multiple of 1024 (N >= 2048) or 128."""
    return n + (-n) % (1024 if n >= 2048 else 128)


def quantize_linear(
    w: torch.Tensor, spec: QuantSpec, k_pad_to: Optional[int] = None
) -> Dict[str, torch.Tensor]:
    """Dense [K, N] -> packed planes + f32 scales (groups along K).

    N is zero-padded to the plane width; ``k_pad_to`` zero-pads K (exact:
    zero rows quantize to 0) so down_proj matches the padded FFN width."""
    if spec.bits in (4, 8):
        raise NotImplementedError(
            f"{spec.bits}-bit weights (W4/W8 formats, kernels K10-K12) are a later slice"
        )
    k, n = w.shape
    if k_pad_to is not None and k_pad_to != k:
        w = F.pad(w, (0, 0, 0, k_pad_to - k))
        k = k_pad_to
    if k % GROUP_SIZE:
        raise ValueError(f"K={k} must be a multiple of {GROUP_SIZE}")
    q, s, _ = quantize(w.T, spec)  # groups along K per output channel
    q = q.reshape(n, k).T
    s = s.reshape(n, k // GROUP_SIZE).T
    n_pad = _padded_width(n) - n
    if n_pad:
        q = F.pad(q, (0, n_pad))
        s = F.pad(s, (0, n_pad))
    hi, lo = pack6(q)
    return {"hi": hi, "lo": lo, "scale": s.to(torch.float32).contiguous()}


def quantize_layer(
    lp: Dict[str, Any], cfg: ModelConfig, policy: QuantPolicy, dtype, device
) -> Dict[str, Any]:
    """One decoder layer's dense params -> its serve params on ``device``."""
    ffn_pad = _padded_width(cfg.intermediate_size)
    out: Dict[str, Any] = {}
    for name, val in lp.items():
        if isinstance(val, dict) and "w" in val:
            w = _as_tensor(val["w"], device)
            spec = policy.weight_spec(name)
            if not spec.enabled:
                raise NotImplementedError(f"16-bit {name} under a mixed policy is a later slice")
            k_pad = ffn_pad if name == "down_proj" else None
            out[name] = quantize_linear(w, spec, k_pad_to=k_pad)
            if val.get("b") is not None:
                # biases ride padded to the plane width (added pre-slice)
                b = _as_tensor(val["b"], device)
                n_plane = out[name]["scale"].shape[1]
                out[name]["b"] = F.pad(b, (0, n_plane - b.shape[0])).to(dtype)
        else:
            out[name] = _as_tensor(val, device).to(dtype)
    return out


def quantize_params(
    params: Dict[str, Any],
    cfg: ModelConfig,
    policy: QuantPolicy,
    dtype=torch.bfloat16,
    fuse: bool = False,
    device="cuda",
) -> Dict[str, Any]:
    """Dense param tree (numpy arrays or tensors) -> serve tree on ``device``
    (packed linears, ``dtype`` for the rest), the same tree the reference's
    ``quantize_params`` builds."""
    if fuse:
        raise NotImplementedError("fuse=True (fused qkv_proj/gate_up trees) is a later slice")
    dev = resolve_device(device)
    out: Dict[str, Any] = {
        "embed": _as_tensor(params["embed"], dev).to(dtype),
        "final_norm": _as_tensor(params["final_norm"], dev).to(dtype),
        "layers": [quantize_layer(lp, cfg, policy, dtype, dev) for lp in params["layers"]],
    }
    if "lm_head" in params:
        if policy.weight_spec("lm_head").enabled:
            raise NotImplementedError("the quantized lm_head (QuantPolicy.with_head) is a later slice")
        out["lm_head"] = _as_tensor(params["lm_head"], dev).to(dtype)
    return out


def _cache_update(ck, cv, k, v, li: int, cache_pos: int) -> None:
    """Write step K/V [B, L, KVH, D] into layer ``li`` of the cache at
    ``cache_pos``, in place (transposed to the [B, KVH, L, D] cache rows)."""
    l = k.shape[1]
    ck[li, :, :, cache_pos : cache_pos + l] = k.transpose(1, 2).to(ck.dtype)
    cv[li, :, :, cache_pos : cache_pos + l] = v.transpose(1, 2).to(cv.dtype)


def _kv_write_read(kv, k, v, cache_pos):
    """kv = (ck, cv, li), the dense cache: write, then view it for attention."""
    if len(kv) != 3 or isinstance(kv[0], str):
        raise NotImplementedError("int8 and paged KV caches are later slices")
    ck, cv, li = kv
    _cache_update(ck, cv, k, v, li, cache_pos)
    return (ck, cv), ("cache", ck, cv, li)


def _attend(q, kv_view, lengths, window=None):
    """The attention kernel over the cache: flash_decode for one query per
    row, flash_prefill otherwise. Causality comes from ``lengths``."""
    _, ck, cv, li = kv_view
    b, l, h, d = q.shape
    if l == 1:
        out = flash_decode(q[:, 0], ck, cv, lengths, layer_idx=li, window=window)
        return out.to(q.dtype).reshape(b, 1, h * d)
    return flash_prefill(q, ck, cv, lengths, layer_idx=li, out_dtype=q.dtype, window=window)


def _qlinear(wq, xq, xs, out_dtype, n_out: Optional[int] = None) -> torch.Tensor:
    if "hi" not in wq:
        raise NotImplementedError("16-bit, W4 and W8 linears are later slices")
    y = w6_matmul(xq, xs, wq["hi"], wq["lo"], wq["scale"], out_dtype=out_dtype)
    if "b" in wq:  # stored at the padded plane width: add before the slice
        y = y + wq["b"].to(y.dtype)
    if n_out is not None and y.shape[-1] != n_out:
        y = y[:, :n_out].contiguous()
    return y


def llama_layer_serve(
    lp: Dict[str, Any],
    cfg: ModelConfig,
    policy: QuantPolicy,
    x: torch.Tensor,  # [B, L, H]
    cos: torch.Tensor,
    sin: torch.Tensor,
    kv,
    cache_pos,
    lengths: torch.Tensor,
    window: Optional[int] = None,
):
    """One quantized decoder layer: fused norm->quant, W6Ax q/k/v, rope,
    cache write + attention, quant + o_proj, fused residual-add + norm ->
    quant, W6Ax gate/up, fused GLU -> quant, W6Ax down, residual add."""
    if "qkv_proj" in lp or "gate_up" in lp:
        raise NotImplementedError("fused qkv_proj/gate_up trees are a later slice")
    b, l, hidden = x.shape
    dtype = x.dtype
    x2 = x.reshape(b * l, hidden)

    qx, qs = rmsnorm_quant(x2, lp["input_norm"], bits=policy.act_bits.get("q_proj", 6), eps=cfg.norm_eps)
    nq = cfg.num_heads * cfg.head_dim
    nkv = cfg.num_kv_heads * cfg.head_dim
    q = _qlinear(lp["q_proj"], qx, qs, dtype, nq).reshape(b, l, cfg.num_heads, cfg.head_dim)
    k = _qlinear(lp["k_proj"], qx, qs, dtype, nkv).reshape(b, l, cfg.num_kv_heads, cfg.head_dim)
    v = _qlinear(lp["v_proj"], qx, qs, dtype, nkv).reshape(b, l, cfg.num_kv_heads, cfg.head_dim)
    q, k = apply_rope(q, k, cos, sin)

    new_kv, kv_view = _kv_write_read(kv, k, v, cache_pos)
    attn = _attend(q, kv_view, lengths, window)
    oq, os_ = quant_act(attn.reshape(b * l, nq), bits=policy.act_bits.get("o_proj", 6))
    o = _qlinear(lp["o_proj"], oq, os_, dtype, hidden)

    fq, fs, x2 = rmsnorm_quant(
        o, lp["post_norm"], bits=policy.act_bits.get("gate_proj", 6), residual=x2, eps=cfg.norm_eps
    )
    ffn_pad = lp["down_proj"]["hi"].shape[0] * 2  # padded FFN width = down_proj's K
    gate = _qlinear(lp["gate_proj"], fq, fs, dtype, ffn_pad)
    up = _qlinear(lp["up_proj"], fq, fs, dtype, ffn_pad)
    dq, ds = glu_quant(gate, up, bits=policy.act_bits.get("down_proj", 8), act=cfg.act)
    down = _qlinear(lp["down_proj"], dq, ds, dtype, hidden)
    x2 = x2 + down
    return x2.reshape(b, l, hidden), new_kv


def apply_lm_head(params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Vocab projection [B, L, H] -> logits [B, L, V] (bf16 or tied head; a
    plain large product, left to torch.matmul as the reference left it to
    XLA)."""
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    if isinstance(head, dict):
        raise NotImplementedError("the quantized lm_head is a later slice")
    return x @ head.to(x.dtype)


def forward_serve(
    params: Dict[str, Any],
    cfg: ModelConfig,
    policy: QuantPolicy,
    ids,  # [B, L]
    positions: Optional[torch.Tensor] = None,
    kv_k: Optional[torch.Tensor] = None,  # [layers, B, KVH, max, D]
    kv_v: Optional[torch.Tensor] = None,
    cache_pos=None,
    prefill_bf16: bool = False,
    kv_k_scale: Optional[torch.Tensor] = None,
    kv_v_scale: Optional[torch.Tensor] = None,
    page_table: Optional[torch.Tensor] = None,
    last_only: bool = False,
    device="cuda",
):
    """Quantized forward over the cache: writes K/V at ``cache_pos`` (in
    place) and attends over the cache. Returns (logits [B, L, V] — [B, 1, V]
    with ``last_only`` — and (kv_k, kv_v))."""
    dev = resolve_device(device)
    if cfg.arch != "llama":
        raise NotImplementedError("OPT serving is a later slice")
    if prefill_bf16 or policy.no_act_quant:
        raise NotImplementedError(
            "the W6A16 prefill layer (kernels K7/K8: w6_matmul_bf16, w6_glu_*_bf16) is the next slice"
        )
    if kv_k_scale is not None or kv_v_scale is not None:
        raise NotImplementedError("the int8 KV cache is a later slice")
    if page_table is not None:
        raise NotImplementedError("the paged KV cache is a later slice")
    if kv_k is None or kv_v is None:
        raise NotImplementedError("the cache-less (eval) forward is a later slice")
    if isinstance(cache_pos, torch.Tensor) and cache_pos.dim() > 0:
        raise NotImplementedError("per-row cache positions (continuous batching) are a later slice")
    if kv_k.shape[3] % 128:
        raise ValueError(f"cache length {kv_k.shape[3]} must be a multiple of 128")
    if params["embed"].device != dev or kv_k.device != dev:
        raise ValueError(f"params and cache must be on {dev}")
    ids = torch.as_tensor(ids, device=dev)
    b, l = ids.shape
    x = params["embed"][ids]
    if cfg.embed_scale is not None:
        x = x * torch.tensor(cfg.embed_scale, dtype=x.dtype)
    if positions is None:
        positions = torch.arange(l, device=dev).expand(b, l)
    cos, sin = rope_for_cfg(torch.as_tensor(positions, device=dev), cfg)
    cache_pos = 0 if cache_pos is None else int(cache_pos)
    lengths = torch.full((b,), cache_pos + l, dtype=torch.int32, device=dev)
    for i, lp in enumerate(params["layers"]):
        x, (kv_k, kv_v) = llama_layer_serve(
            lp, cfg, policy, x, cos, sin, (kv_k, kv_v, i), cache_pos, lengths,
            window=cfg.sliding_window,
        )
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    return apply_lm_head(params, x), (kv_k, kv_v)
