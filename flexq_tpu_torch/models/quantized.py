"""Quantized serve-path LLaMA and OPT (port of flexq_tpu/models/quantized.py:
the W*Ax decode layer, the W*A16 prefill layer, the OPT layers and
forward_serve over a dense bf16 or int8 KV cache or a page pool).

Three weight formats, as the reference packs them (``quantize_linear``):
6-bit planes ("hi"/"lo", the FlexQ format), a 4-bit nibble plane ("q4")
and dense int8 ("q8"); 16-bit linears keep their weight ("w").

Two layers, chosen as the reference chooses them:
  * ``llama_layer_serve`` (W*Ax, exact integer): every linear runs the
    exact integer kernel of its format (W6Ax, W4A8, W8A8), with activations
    quantized in the producer's epilogue (fused norm / activation kernels).
    Decode, and prompts shorter than the engine's ``prefill_bf16_threshold``.
  * ``llama_layer_serve_prefill`` (W*A16): the weights are dequantized to
    bf16 inside the GEMM kernel (W6, W4; W8 is dequantized before a plain
    product, as the reference leaves it to XLA) and the activations stay
    unquantized; packed q and k take the fused RoPE epilogue, W6 gate and
    up the fused GLU kernel. Long prompts (``prefill_bf16``), and every step
    under a no-act-quant policy (``QuantPolicy.weight_only``).
OPT (``cfg.arch == "opt"``, pre-LN only) has its own two layers:
``opt_layer_serve`` (W*Ax: fused LayerNorm and ReLU producers, K14 / K15)
and, under a no-act-quant policy, ``_opt_layer_serve_bf16``. OPT never takes
the W*A16 prefill layer: its prompts run the exact GEMMs at M = B * L, as
in the reference. Attention reads the cache through the attention kernel.
The lm_head may be packed too (``QuantPolicy.with_head``); OPT's is tied.

Without a cache (``kv_k=None``: eval and the torch-facing forward) every
layer attends over its own fresh K/V through ``models/llama.py::
attention_core`` under a causal mask, plain PyTorch as in the reference;
the GEMMs and producers are the same kernels as on the cached path.

Cache layout: [L, B, KVH, S, D] (sequence second-minor), with f32 scales
[L, B, KVH, S] for the int8 cache, or a page pool [L, P, KVH, PS, D] (scales
[L, P, KVH, PS]) read through a page table [B, MAXPAGES] (decode only: the
continuous-batching scheduler fills pages from a dense prefill scratch).
Cache positions are one int or one per row. The cache is updated in place:
the port's tensors are mutable, so writing the step's K/V into the caller's
cache replaces the reference's functional cache update.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from flexq_tpu_torch.config import ModelConfig, QuantPolicy, require_servable
from flexq_tpu_torch.kernels import (
    GROUP_SIZE,
    flash_decode,
    flash_decode_paged,
    flash_prefill,
    glu_quant,
    layernorm_quant,
    quant_act,
    relu_quant,
    rmsnorm_quant,
    w4_matmul,
    w4_matmul_bf16,
    w6_glu_fused_bf16,
    w6_glu_matmul_bf16,
    w6_matmul,
    w6_matmul_bf16,
    w8_matmul,
)
from flexq_tpu_torch.kernels.common import resolve_device
from flexq_tpu_torch.kernels.fused_quant import f32_reciprocal
from flexq_tpu_torch.kernels.wa16_matmul import dequant_int
from flexq_tpu_torch.models.llama import (
    act_fn,
    apply_rope,
    attention_core,
    causal_mask,
    rmsnorm,
    rope_for_cfg,
    rope_gemm_operands,
)
from flexq_tpu_torch.models.opt import POS_OFFSET, layernorm
from flexq_tpu_torch.packing.pack4 import pack4
from flexq_tpu_torch.packing.pack6 import pack6
from flexq_tpu_torch.quant.quantizer import QuantSpec, quantize


def all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The pieces of ``x`` of every rank of ``group``, concatenated along
    ``dim`` in rank order (the reference's tiled all_gather)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray) and not x.flags.writeable:  # arrays from JAX are read-only
        x = x.copy()
    return torch.as_tensor(x, device=device)


def _convert(tree, device, dtype):
    """A norm's leaf (RMSNorm gamma) or dict of leaves (LayerNorm {"g", "b"})
    on ``device`` in ``dtype``."""
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype) for k, v in tree.items()}
    return _as_tensor(tree, device).to(dtype)


def _padded_width(n: int) -> int:
    """Plane width: N padded to a multiple of 1024 (N >= 2048) or 128."""
    return n + (-n) % (1024 if n >= 2048 else 128)


def quantize_linear(
    w: torch.Tensor, spec: QuantSpec, k_pad_to: Optional[int] = None
) -> Dict[str, torch.Tensor]:
    """Dense [K, N] -> packed weight + f32 scales (groups along K):
    {"hi", "lo", "scale"} (6-bit), {"q4", "scale"} (4-bit nibble plane) or
    {"q8", "scale"} (dense int8).

    N is zero-padded to the plane width; ``k_pad_to`` zero-pads K (exact:
    zero rows quantize to 0) so down_proj (fc2) matches the padded FFN width."""
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
    s = s.to(torch.float32).contiguous()
    if spec.bits == 8:
        return {"q8": q.contiguous(), "scale": s}
    if spec.bits == 4:
        return {"q4": pack4(q), "scale": s}
    hi, lo = pack6(q)
    return {"hi": hi, "lo": lo, "scale": s}


def _pad128(n: int) -> int:
    return n + (-n) % 128


# fused matrices take the weight spec of a representative member
_FUSED_SPEC = {"qkv_proj": "q_proj", "gate_up": "gate_proj"}


def _fuse_layer(lp: Dict[str, Any], cfg: ModelConfig, policy: QuantPolicy, device) -> Dict[str, Any]:
    """The reference's ``fuse=True`` layout of one dense layer: q|k|v as one
    "qkv_proj" matrix (each member padded to a multiple of 128 columns, biases
    at the padded offsets) and gate|up as one "gate_up" matrix (each padded to
    the padded FFN width)."""
    ab = policy.act_bits
    if not (ab.get("q_proj") == ab.get("k_proj") == ab.get("v_proj") and ab.get("gate_proj") == ab.get("up_proj")):
        raise ValueError("fuse=True needs one act-bit width for q/k/v and one for gate/up")
    lp = dict(lp)
    ffn_pad = _padded_width(cfg.intermediate_size)

    def w(m):
        return _as_tensor(m["w"], device)

    def pad_cols(t, to):
        return F.pad(t, (0, to - t.shape[1]))

    qp, kp, vp = lp.pop("q_proj"), lp.pop("k_proj"), lp.pop("v_proj")
    nq_p, nkv_p = _pad128(w(qp).shape[1]), _pad128(w(kp).shape[1])
    qkv = {"w": torch.cat([pad_cols(w(qp), nq_p), pad_cols(w(kp), nkv_p), pad_cols(w(vp), nkv_p)], dim=1)}
    if any(m.get("b") is not None for m in (qp, kp, vp)):

        def pad_b(m, to):
            b = m.get("b")
            b = torch.zeros(to, dtype=w(m).dtype, device=device) if b is None else _as_tensor(b, device)
            return F.pad(b, (0, to - b.shape[0]))

        qkv["b"] = torch.cat([pad_b(qp, nq_p), pad_b(kp, nkv_p), pad_b(vp, nkv_p)])
    lp["qkv_proj"] = qkv
    gate, up = w(lp.pop("gate_proj")), w(lp.pop("up_proj"))
    lp["gate_up"] = {"w": torch.cat([pad_cols(gate, ffn_pad), pad_cols(up, ffn_pad)], dim=1)}
    return lp


def quantize_layer(
    lp: Dict[str, Any], cfg: ModelConfig, policy: QuantPolicy, dtype, device, fuse: bool = False
) -> Dict[str, Any]:
    """One decoder layer's dense params -> its serve params on ``device``
    (``fuse=True``: the fused qkv_proj / gate_up layout)."""
    if fuse and "q_proj" in lp and "gate_proj" in lp:
        lp = _fuse_layer(lp, cfg, policy, device)
    ffn_pad = _padded_width(cfg.intermediate_size)
    out: Dict[str, Any] = {}
    for name, val in lp.items():
        if isinstance(val, dict) and "w" in val:
            w = _as_tensor(val["w"], device)
            spec = policy.weight_spec(_FUSED_SPEC.get(name, name))
            if spec.enabled:
                k_pad = ffn_pad if name in ("down_proj", "fc2") else None
                out[name] = quantize_linear(w, spec, k_pad_to=k_pad)
                n_plane = out[name]["scale"].shape[1]
            else:  # a 16-bit linear keeps its dense weight
                out[name] = {"w": w.to(dtype)}
                n_plane = w.shape[1]
            if val.get("b") is not None:
                # biases ride padded to the plane width (added pre-slice)
                b = _as_tensor(val["b"], device)
                out[name]["b"] = F.pad(b, (0, n_plane - b.shape[0])).to(dtype)
        else:
            out[name] = _convert(val, device, dtype)
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
    ``quantize_params`` builds. ``fuse=True`` packs q/k/v into one
    "qkv_proj" matrix and gate/up into one "gate_up" matrix."""
    require_servable(policy)
    dev = resolve_device(device)
    out: Dict[str, Any] = {
        "embed": _as_tensor(params["embed"], dev).to(dtype),
        "final_norm": _convert(params["final_norm"], dev, dtype),
        "layers": [quantize_layer(lp, cfg, policy, dtype, dev, fuse) for lp in params["layers"]],
    }
    if "pos_embed" in params:  # OPT's learned positions
        out["pos_embed"] = _as_tensor(params["pos_embed"], dev).to(dtype)
    if "lm_head" in params:
        head = _as_tensor(params["lm_head"], dev)
        head_spec = policy.weight_spec("lm_head")
        out["lm_head"] = quantize_linear(head, head_spec) if head_spec.enabled else head.to(dtype)
    return out


def _cache_rows(cache_pos, b: int, l: int, device):
    """Index pair (rows [B, 1], positions [B, L]) of the cache entries that
    a step of L tokens per row writes at ``cache_pos`` (int: every row at
    the same start; int tensor [B]: row r at its own start)."""
    if isinstance(cache_pos, torch.Tensor):
        start = cache_pos.to(device=device, dtype=torch.int64).reshape(b, 1)
    else:
        start = torch.full((b, 1), int(cache_pos), dtype=torch.int64, device=device)
    return torch.arange(b, device=device)[:, None], start + torch.arange(l, device=device)


def _write_rows(buf, li: int, x, cache_pos) -> None:
    """Write a step's x [B, L, KVH(, D)] into layer ``li`` of a cache buffer
    [L, B, KVH, S(, D)] at ``cache_pos``, in place. An int is one slice
    write into the transposed rows; a vector [B] (per-row positions:
    continuous batching, L == 1, or an L-token window at each row's own
    start) is one indexed write, where the reference unrolls B slice writes
    (a TPU workaround): with indices on both sides of the KVH slice, the
    indexed view is [B, L, KVH(, D)], the step's own layout."""
    if isinstance(cache_pos, torch.Tensor):
        rows, pos = _cache_rows(cache_pos, x.shape[0], x.shape[1], buf.device)
        buf[li, rows, :, pos] = x.to(buf.dtype)
    else:
        buf[li, :, :, cache_pos : cache_pos + x.shape[1]] = x.transpose(1, 2).to(buf.dtype)


KV_QMAX = 127


def _kv_quant(x: torch.Tensor):
    """Per-(token, head) symmetric int8 quant over head_dim: [B, L, KVH, D]
    -> (int8 values, f32 scales [B, L, KVH]). ``absmax / 127`` is a multiply
    by the f32 reciprocal, as XLA compiles the reference's division by a
    constant inside the jitted engine; ``x / scale`` is a true division."""
    xf = x.to(torch.float32)
    scale = (xf.abs().amax(dim=-1) * f32_reciprocal(KV_QMAX)).clamp(1e-8, 1e4)
    q = torch.round(xf / scale[..., None]).clamp(-KV_QMAX - 1, KV_QMAX)
    return q.to(torch.int8), scale


def _kv_write_read(kv, k, v, cache_pos):
    """Write step K/V into the cache, in place, and return the view the
    attention kernel reads: ``kv`` itself, (ck, cv, cks, cvs, li, table).

    ck, cv: the bf16 (or f32) or int8 cache [L, B, KVH, S, D], or with a
    ``table`` (int32 [B, MAXPAGES]) a page pool [L, P, KVH, PS, D]; cks, cvs:
    the int8 cache's f32 scales ([L, B, KVH, S] or [L, P, KVH, PS]), else
    None; li: the layer. ``cache_pos`` is an int or an int tensor [B]
    (per-row positions). The paged pools are decode-only (L == 1): row b
    writes at page table[b, pos // PS], offset pos % PS, with one indexed
    write per buffer; inactive rows (an all-zero table row, position 0)
    write into page 0, the garbage page, where several rows may land on one
    entry. The int8 views are consumed with the scales folded into the
    math."""
    ck, cv, cks, cvs, li, table = kv
    if cks is not None:
        kq, ks = _kv_quant(k)
        vq, vs = _kv_quant(v)
        writes = ((ck, kq), (cv, vq), (cks, ks), (cvs, vs))
    else:
        writes = ((ck, k), (cv, v))
    if table is None:
        for buf, x in writes:
            _write_rows(buf, li, x, cache_pos)
        return kv
    b, ps = k.shape[0], ck.shape[3]
    rows, pos = _cache_rows(cache_pos, b, 1, ck.device)
    pages = table.to(torch.int64)[rows, pos // ps][:, 0]  # [B]
    offs = (pos % ps)[:, 0]
    for buf, x in writes:
        buf[li, pages, :, offs] = x[:, 0].to(buf.dtype)  # indexed view [B, KVH(, D)]
    return kv


def _attend(q, kv_view, lengths, window=None):
    """The attention kernel over the cache: flash_decode_paged over a page
    pool, flash_decode for one query per row, flash_prefill otherwise.
    Causality comes from ``lengths``."""
    ck, cv, cks, cvs, li, table = kv_view
    b, l, h, d = q.shape
    if table is not None:
        if l != 1:
            raise ValueError("the paged cache is decode-only (L == 1)")
        out = flash_decode_paged(q[:, 0], ck, cv, table, lengths, cks, cvs, layer_idx=li, window=window)
        return out.to(q.dtype).reshape(b, 1, h * d)
    if l == 1:
        out = flash_decode(q[:, 0], ck, cv, lengths, cks, cvs, layer_idx=li, window=window)
        return out.to(q.dtype).reshape(b, 1, h * d)
    return flash_prefill(q, ck, cv, lengths, cks, cvs, layer_idx=li, out_dtype=q.dtype, window=window)


def _self_attention(q, k, v, kv, cache_pos, lengths, mask, window=None):
    """A layer's attention: without a cache (``kv`` None) the dense core
    over the step's own K/V under ``mask``; else write K/V into the cache
    and attend over it."""
    if kv is None:
        return attention_core(q, k, v, mask, q.shape[2] // k.shape[2])
    return _attend(q, _kv_write_read(kv, k, v, cache_pos), lengths, window)


def _finish_linear(wq, y, n_out: Optional[int], group=None) -> torch.Tensor:
    """A linear's bias and its slice to ``n_out`` columns. With a process
    ``group`` (a row-parallel linear under tensor parallelism) the ranks'
    partial sums are all-reduced first, in the model dtype, where the
    reference runs its psum, and the bias is added once, after."""
    if group is None and "b" in wq:  # stored at the padded plane width: add before the slice
        y = y + wq["b"].to(y.dtype)
    if n_out is not None and y.shape[-1] != n_out:
        y = y[:, :n_out].contiguous()
    if group is not None:
        dist.all_reduce(y, group=group)
        if "b" in wq:
            y = y + wq["b"][: y.shape[-1]].to(y.dtype)
    return y


def _qlinear(wq, xq, xs, out_dtype, n_out: Optional[int] = None, group=None) -> torch.Tensor:
    """Exact W*Ax linear of quantized activations: W6Ax (K2/K3), W4A8 (K10)
    or W8A8 (K12). A 16-bit weight under a quantized-activation policy
    dequantizes the input per group and runs a plain product, as the
    reference does."""
    if "hi" in wq:
        y = w6_matmul(xq, xs, wq["hi"], wq["lo"], wq["scale"], out_dtype=out_dtype)
    elif "q4" in wq:
        y = w4_matmul(xq, xs, wq["q4"], wq["scale"], out_dtype=out_dtype)
    elif "q8" in wq:
        y = w8_matmul(xq, xs, wq["q8"], wq["scale"], out_dtype=out_dtype)
    else:
        m, k = xq.shape
        xf = xq.to(torch.float32).reshape(m, k // GROUP_SIZE, GROUP_SIZE) * xs[:, :, None]
        y = xf.reshape(m, k).to(out_dtype) @ wq["w"].to(out_dtype)
    return _finish_linear(wq, y, n_out, group)


def _qlinear_bf16(wq, x, out_dtype, n_out: Optional[int] = None, group=None) -> torch.Tensor:
    """W*A16 linear: W6A16 (K7) or W4A16 (K11). A W8 weight is dequantized
    per group to x's dtype and a 16-bit weight used as it is, each in a
    plain product, left to torch.matmul as the reference left it to XLA."""
    if "hi" in wq:
        y = w6_matmul_bf16(x, wq["hi"], wq["lo"], wq["scale"], out_dtype=out_dtype)
    elif "q4" in wq:
        y = w4_matmul_bf16(x, wq["q4"], wq["scale"], out_dtype=out_dtype)
    elif "q8" in wq:
        y = x @ dequant_int(wq["q8"], wq["scale"], x.dtype)
    else:
        y = x @ wq["w"].to(x.dtype)
    return _finish_linear(wq, y, n_out, group)


def _split_qkv(qkv, cfg: ModelConfig):
    """q, k, v of a fused qkv_proj output: members sit at 128-padded offsets."""
    nq, nkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    nq_p, nkv_p = _pad128(nq), _pad128(nkv)
    return qkv[:, :nq], qkv[:, nq_p : nq_p + nkv], qkv[:, nq_p + nkv_p : nq_p + nkv_p + nkv]


def _ffn_width(wq, cfg: ModelConfig) -> int:
    """Padded FFN width implied by a packed down_proj (fc2) weight's K."""
    if "hi" in wq:
        return wq["hi"].shape[0] * 2
    if "q4" in wq:
        return wq["q4"].shape[0] * 2
    if "q8" in wq:
        return wq["q8"].shape[0]
    return cfg.intermediate_size


def llama_layer_serve(
    lp: Dict[str, Any],
    cfg: ModelConfig,
    policy: QuantPolicy,
    x: torch.Tensor,  # [B, L, H]
    cos: torch.Tensor,
    sin: torch.Tensor,
    kv,
    cache_pos,
    lengths: Optional[torch.Tensor],
    window: Optional[int] = None,
    mask: Optional[torch.Tensor] = None,
    group=None,
):
    """One quantized decoder layer: fused norm->quant, W6Ax q/k/v (or the
    fused qkv_proj), rope, cache write + attention, quant + o_proj, fused
    residual-add + norm -> quant, W6Ax gate/up (or gate_up), fused GLU ->
    quant, W6Ax down, residual add. With a process ``group`` (tensor
    parallelism: ``cfg`` the local head and FFN counts, ``lp`` the local
    shard) o_proj's and down_proj's outputs are all-reduced over it."""
    b, l, hidden = x.shape
    dtype = x.dtype
    x2 = x.reshape(b * l, hidden)

    qx, qs = rmsnorm_quant(x2, lp["input_norm"], bits=policy.act_bits.get("q_proj", 6), eps=cfg.norm_eps)
    nq = cfg.num_heads * cfg.head_dim
    nkv = cfg.num_kv_heads * cfg.head_dim
    if "qkv_proj" in lp:
        q, k, v = _split_qkv(_qlinear(lp["qkv_proj"], qx, qs, dtype), cfg)
    else:
        q = _qlinear(lp["q_proj"], qx, qs, dtype, nq)
        k = _qlinear(lp["k_proj"], qx, qs, dtype, nkv)
        v = _qlinear(lp["v_proj"], qx, qs, dtype, nkv)
    q = q.reshape(b, l, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, l, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, l, cfg.num_kv_heads, cfg.head_dim)
    q, k = apply_rope(q, k, cos, sin)

    attn = _self_attention(q, k, v, kv, cache_pos, lengths, mask, window)
    oq, os_ = quant_act(attn.reshape(b * l, nq), bits=policy.act_bits.get("o_proj", 6))
    o = _qlinear(lp["o_proj"], oq, os_, dtype, hidden, group=group)

    fq, fs, x2 = rmsnorm_quant(
        o, lp["post_norm"], bits=policy.act_bits.get("gate_proj", 6), residual=x2, eps=cfg.norm_eps
    )
    ffn_pad = _ffn_width(lp["down_proj"], cfg)  # gate/up stay at the padded FFN width = down_proj's K
    if "gate_up" in lp:
        gu = _qlinear(lp["gate_up"], fq, fs, dtype)
        gate, up = gu[:, :ffn_pad].contiguous(), gu[:, ffn_pad : 2 * ffn_pad].contiguous()
    else:
        gate = _qlinear(lp["gate_proj"], fq, fs, dtype, ffn_pad)
        up = _qlinear(lp["up_proj"], fq, fs, dtype, ffn_pad)
    dq, ds = glu_quant(gate, up, bits=policy.act_bits.get("down_proj", 8), act=cfg.act)
    down = _qlinear(lp["down_proj"], dq, ds, dtype, hidden, group=group)
    x2 = x2 + down
    return x2.reshape(b, l, hidden)


def llama_layer_serve_prefill(
    lp: Dict[str, Any],
    cfg: ModelConfig,
    x: torch.Tensor,  # [B, L, H]
    cos: torch.Tensor,
    sin: torch.Tensor,
    kv,
    cache_pos,
    lengths: Optional[torch.Tensor],
    window: Optional[int] = None,
    mask: Optional[torch.Tensor] = None,
    group=None,
):
    """The W*A16 layer (large M): weights dequantized to bf16 inside the
    GEMM kernel, activations unquantized. Its branches are the reference's:
    a fused qkv_proj is one GEMM and apply_rope; unbiased W6 or W4 q/k with
    head_dim 128 take the RoPE epilogue on the f32 accumulator (which rounds
    differently from apply_rope on the rounded output); otherwise three
    GEMMs and apply_rope. A W6 gate_up plane or unbiased W6 gate/up take
    the fused GLU kernel; otherwise two GEMMs and act(gate) * up. ``group``:
    as in ``llama_layer_serve``."""
    b, l, hidden = x.shape
    dtype = x.dtype
    x2 = x.reshape(b * l, hidden)

    h = rmsnorm(x2, lp["input_norm"], cfg.norm_eps)
    nq = cfg.num_heads * cfg.head_dim
    nkv = cfg.num_kv_heads * cfg.head_dim

    def rope_ok(wq):
        return ("hi" in wq or "q4" in wq) and "b" not in wq

    fused_rope = (
        cfg.head_dim == 128 and "qkv_proj" not in lp and rope_ok(lp["q_proj"]) and rope_ok(lp["k_proj"])
    )
    if "qkv_proj" in lp:
        q, k, v = _split_qkv(_qlinear_bf16(lp["qkv_proj"], h, dtype), cfg)
    elif fused_rope:
        cos_f, sin2_f = rope_gemm_operands(cos, sin)

        def rope_proj(wq, n_out):
            rope = dict(out_dtype=dtype, rope_cos=cos_f, rope_sin2=sin2_f)
            if "hi" in wq:
                y = w6_matmul_bf16(h, wq["hi"], wq["lo"], wq["scale"], **rope)
            else:
                y = w4_matmul_bf16(h, wq["q4"], wq["scale"], **rope)
            return _finish_linear(wq, y, n_out)

        q = rope_proj(lp["q_proj"], nq)
        k = rope_proj(lp["k_proj"], nkv)
        v = _qlinear_bf16(lp["v_proj"], h, dtype, nkv)
    else:
        q = _qlinear_bf16(lp["q_proj"], h, dtype, nq)
        k = _qlinear_bf16(lp["k_proj"], h, dtype, nkv)
        v = _qlinear_bf16(lp["v_proj"], h, dtype, nkv)
    q = q.reshape(b, l, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, l, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, l, cfg.num_kv_heads, cfg.head_dim)
    if not fused_rope:
        q, k = apply_rope(q, k, cos, sin)

    attn = _self_attention(q, k, v, kv, cache_pos, lengths, mask, window)
    o = _qlinear_bf16(lp["o_proj"], attn.reshape(b * l, nq), dtype, hidden, group=group)
    x2 = x2 + o

    h = rmsnorm(x2, lp["post_norm"], cfg.norm_eps)
    if "gate_up" in lp and "hi" in lp["gate_up"]:
        gu = lp["gate_up"]
        act = w6_glu_fused_bf16(h, gu["hi"], gu["lo"], gu["scale"], act=cfg.act, out_dtype=dtype)
    elif "gate_up" not in lp and all("hi" in lp[n] and "b" not in lp[n] for n in ("gate_proj", "up_proj")):
        gq, uq = lp["gate_proj"], lp["up_proj"]
        act = w6_glu_matmul_bf16(h, gq["hi"], gq["lo"], gq["scale"], uq["hi"], uq["lo"], uq["scale"],
                                 act=cfg.act, out_dtype=dtype)
    else:
        ffn_pad = _ffn_width(lp["down_proj"], cfg)
        if "gate_up" in lp:
            gu = _qlinear_bf16(lp["gate_up"], h, dtype)
            gate, up = gu[:, :ffn_pad], gu[:, ffn_pad : 2 * ffn_pad]
        else:
            gate = _qlinear_bf16(lp["gate_proj"], h, dtype, ffn_pad)
            up = _qlinear_bf16(lp["up_proj"], h, dtype, ffn_pad)
        act = (act_fn(cfg.act, gate.to(torch.float32)) * up.to(torch.float32)).to(dtype)
    down = _qlinear_bf16(lp["down_proj"], act, dtype, hidden, group=group)
    x2 = x2 + down
    return x2.reshape(b, l, hidden)


def opt_layer_serve(
    lp: Dict[str, Any],
    cfg: ModelConfig,
    policy: QuantPolicy,
    x: torch.Tensor,  # [B, L, H]
    kv,
    cache_pos,
    lengths: Optional[torch.Tensor],
    mask: Optional[torch.Tensor] = None,
    group=None,
):
    """One quantized pre-LN OPT decoder layer: fused LayerNorm -> quant
    (K14) at q_proj's bits, biased W*Ax q/k/v, cache write + multi-head
    attention, quant (K4) + biased o_proj, the residual, K14 at fc1's bits,
    biased fc1, fused ReLU -> quant (K15) at fc2's bits, biased fc2, the
    residual. Every bias is added after its GEMM (``_finish_linear``); the
    reference adds o_proj's and fc2's after the slice to ``hidden`` so that,
    under tensor parallelism, they follow the all-reduce: on one device the
    two give the same values. Under a no-act-quant policy the layer is
    ``_opt_layer_serve_bf16``. ``group``: as in ``llama_layer_serve``."""
    if policy.no_act_quant:
        return _opt_layer_serve_bf16(lp, cfg, x, kv, cache_pos, lengths, mask, group)
    b, l, hidden = x.shape
    dtype = x.dtype
    x2 = x.reshape(b * l, hidden)

    norm = lp["input_norm"]
    qx, qs = layernorm_quant(x2, norm["g"], norm["b"], bits=policy.act_bits.get("q_proj", 8), eps=cfg.norm_eps)
    nq = cfg.num_heads * cfg.head_dim
    q, k, v = (_qlinear(lp[n], qx, qs, dtype, nq).reshape(b, l, cfg.num_heads, cfg.head_dim)
               for n in ("q_proj", "k_proj", "v_proj"))

    attn = _self_attention(q, k, v, kv, cache_pos, lengths, mask)
    oq, os_ = quant_act(attn.reshape(b * l, nq), bits=policy.act_bits.get("o_proj", 6))
    x2 = x2 + _qlinear(lp["o_proj"], oq, os_, dtype, hidden, group=group)

    norm = lp["post_norm"]
    fq, fs = layernorm_quant(x2, norm["g"], norm["b"], bits=policy.act_bits.get("fc1", 6), eps=cfg.norm_eps)
    h = _qlinear(lp["fc1"], fq, fs, dtype, _ffn_width(lp["fc2"], cfg))
    hq, hs = relu_quant(h, bits=policy.act_bits.get("fc2", 6))
    x2 = x2 + _qlinear(lp["fc2"], hq, hs, dtype, hidden, group=group)
    return x2.reshape(b, l, hidden)


def _opt_layer_serve_bf16(lp: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor, kv, cache_pos, lengths, mask=None,
                          group=None):
    """The OPT layer with unquantized activations (weight-only and fp16
    policies): plain LayerNorm producers, the W*A16 GEMMs (K7 for W6, K11
    for W4; W8 and 16-bit weights in a plain product), ReLU in f32 cast back
    to the model dtype."""
    b, l, hidden = x.shape
    dtype = x.dtype
    x2 = x.reshape(b * l, hidden)

    h = layernorm(x2, lp["input_norm"]["g"], lp["input_norm"]["b"], cfg.norm_eps)
    nq = cfg.num_heads * cfg.head_dim
    q, k, v = (_qlinear_bf16(lp[n], h, dtype, nq).reshape(b, l, cfg.num_heads, cfg.head_dim)
               for n in ("q_proj", "k_proj", "v_proj"))

    attn = _self_attention(q, k, v, kv, cache_pos, lengths, mask)
    x2 = x2 + _qlinear_bf16(lp["o_proj"], attn.reshape(b * l, nq), dtype, hidden, group=group)

    h = layernorm(x2, lp["post_norm"]["g"], lp["post_norm"]["b"], cfg.norm_eps)
    h = _qlinear_bf16(lp["fc1"], h, dtype, _ffn_width(lp["fc2"], cfg))
    h = torch.relu(h.to(torch.float32)).to(dtype)
    x2 = x2 + _qlinear_bf16(lp["fc2"], h, dtype, hidden, group=group)
    return x2.reshape(b, l, hidden)


def apply_lm_head(params: Dict[str, Any], cfg: ModelConfig, policy: QuantPolicy, x: torch.Tensor,
                  group=None) -> torch.Tensor:
    """Vocab projection [B, L, H] -> logits [B, L, V].

    A packed head (``QuantPolicy.with_head``) with quantized activations
    runs the activation quant (K4) and the exact W*Ax GEMM of its format;
    with 16-bit activations it runs the W*A16 GEMM. Its output is sliced
    back from the padded vocab to ``cfg.vocab_size``: pad logits read 0.0
    and could out-argmax real negative logits. A bf16 or tied head is a
    plain large product, left to torch.matmul as the reference left it to
    XLA. With a process ``group`` the head is vocab-parallel: a bf16 or
    packed head is this rank's column slice, whose logits are all-gathered
    over the group and the vocab padding (the last rank's last columns)
    sliced off after the gather; the tied embedding is replicated."""
    head = params.get("lm_head")
    if head is None:
        return x @ params["embed"].T.to(x.dtype)
    if not isinstance(head, dict):
        logits = x @ head.to(x.dtype)
        return logits if group is None else all_gather_cat(logits, group, -1)[..., : cfg.vocab_size]
    b, l, _ = x.shape
    xm = x.reshape(b * l, -1).contiguous()  # x may be the last_only slice
    abits = policy.act_bits.get("lm_head", 16)
    n_out = cfg.vocab_size if group is None else None
    if abits >= 16:
        logits = _qlinear_bf16(head, xm, x.dtype, n_out=n_out)
    else:
        xq, xs = quant_act(xm, bits=abits)
        logits = _qlinear(head, xq, xs, x.dtype, n_out=n_out)
    if group is not None:
        logits = all_gather_cat(logits, group, -1)[:, : cfg.vocab_size]
    return logits.reshape(b, l, cfg.vocab_size)


def forward_serve(
    params: Dict[str, Any],
    cfg: ModelConfig,
    policy: QuantPolicy,
    ids,  # [B, L]
    positions: Optional[torch.Tensor] = None,
    kv_k: Optional[torch.Tensor] = None,  # [layers, B, KVH, max, D] | pool [layers, P, KVH, PS, D]
    kv_v: Optional[torch.Tensor] = None,  # (bf16 | int8)
    cache_pos=None,  # int, or int tensor [B]: per-row positions
    prefill_bf16: bool = False,
    kv_k_scale: Optional[torch.Tensor] = None,  # [layers, B, KVH, max] | [layers, P, KVH, PS] f32
    kv_v_scale: Optional[torch.Tensor] = None,  # (present => int8 KV cache)
    page_table: Optional[torch.Tensor] = None,  # int32 [B, MAXPAGES] (present => paged pool)
    last_only: bool = False,
    device="cuda",
    tp_group=None,
):
    """Quantized forward. Without a cache (``kv_k`` / ``kv_v`` None): the
    whole sequence under a causal mask (and the sliding window), for eval
    and the torch-facing forward. With a cache: writes K/V at
    ``cache_pos`` (in place) and attends over the cache. ``cache_pos`` is
    one start for every row, or a tensor [B] of per-row starts (continuous batching; pass the
    matching ``positions``, e.g. ``cache_pos[:, None]``). ``prefill_bf16``
    selects the W6A16 layer (always taken under a no-act-quant policy; OPT
    ignores it and runs its own layers, as the reference does);
    passing the scale tensors selects the int8 cache; a ``page_table`` makes
    kv_k / kv_v (and the scales) a page pool, decode only (L == 1). Returns
    (logits [B, L, V] — [B, 1, V] with ``last_only`` — and the cache state
    (kv_k, kv_v) or (kv_k, kv_v, kv_k_scale, kv_v_scale), or None without
    a cache). ``tp_group``: one rank's forward under tensor parallelism
    (``params`` its local shard, ``cfg`` the local head and FFN counts, the
    cache its local kv heads), which parallel/tp.py::forward_serve_tp
    drives."""
    dev = resolve_device(device)
    prefill_bf16 = layer_choice(cfg, policy, prefill_bf16)
    quant_cache = kv_k_scale is not None
    if quant_cache != (kv_v_scale is not None):
        raise ValueError("the int8 cache needs both kv_k_scale and kv_v_scale")
    have_cache = kv_k is not None
    if have_cache != (kv_v is not None):
        raise ValueError("the cache needs both kv_k and kv_v")
    if not have_cache and (quant_cache or page_table is not None):
        raise ValueError("cache scales or a page table without a cache")
    if have_cache and kv_k.shape[3] % 128:
        raise ValueError(f"cache length {kv_k.shape[3]} must be a multiple of 128")
    if params["embed"].device != dev or (have_cache and kv_k.device != dev):
        raise ValueError(f"params and cache must be on {dev}")
    ids = torch.as_tensor(ids, device=dev)
    b, l = ids.shape
    if page_table is not None and l != 1:
        raise ValueError("the paged cache is decode-only (L == 1); prefill fills pages from a dense scratch")
    if positions is None:
        positions = torch.arange(l, device=dev).expand(b, l)
    positions = torch.as_tensor(positions, device=dev)
    x = embed_ids(params, cfg, ids, positions)
    ctx = step_context(cfg, positions, have_cache, cache_pos, dev)
    cache = (kv_k, kv_v, kv_k_scale, kv_v_scale) if have_cache else None
    x = run_layers(params["layers"], cfg, policy, x, ctx, cache, page_table, prefill_bf16, tp_group)
    logits = final_logits(params, cfg, policy, x, last_only, tp_group)
    if not have_cache:
        return logits, None
    return logits, ((kv_k, kv_v, kv_k_scale, kv_v_scale) if quant_cache else (kv_k, kv_v))


def layer_choice(cfg: ModelConfig, policy: QuantPolicy, prefill_bf16: bool) -> bool:
    """Refuse what the serve layers do not serve, and return whether a
    LLaMA step takes the W*A16 layer: when asked (``prefill_bf16``) and
    always under a no-act-quant policy."""
    require_servable(policy)
    is_opt = cfg.arch == "opt"
    if is_opt and not cfg.do_layer_norm_before:
        # the reference's serve layers apply pre-LN whatever the flag says,
        # so they serve OPT-350m unlike its own model; the port refuses it
        raise ValueError("post-LN OPT (do_layer_norm_before=False) is not served: the serve layers are pre-LN")
    # W*A16: activations stay unquantized at decode too (an int8 container
    # cannot hold them), so every step takes the W6A16 layer
    return prefill_bf16 or (policy.no_act_quant and not is_opt)


def embed_ids(params: Dict[str, Any], cfg: ModelConfig, ids: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """The first stage of the serve forward: the token embedding [B, L, H]
    (Gemma's ``embed_scale``; OPT's learned positions, per row where the
    rows are ragged)."""
    x = params["embed"][ids]
    if cfg.embed_scale is not None:
        x = x * torch.tensor(cfg.embed_scale, dtype=x.dtype)
    if cfg.arch == "opt":
        x = x + params["pos_embed"][positions + POS_OFFSET]
    return x


def step_context(cfg: ModelConfig, positions: torch.Tensor, have_cache: bool, cache_pos, dev):
    """What every layer of a step reads besides its input: (cos, sin) of
    RoPE (None for OPT), the causal mask of a cache-less forward, the
    per-row lengths over a cache and ``cache_pos`` as the layers take it
    (an int, or an int64 tensor [B])."""
    b, l = positions.shape
    cos = sin = None
    if cfg.arch != "opt":
        cos, sin = rope_for_cfg(positions, cfg)
    mask = lengths = None
    if not have_cache:
        mask = causal_mask(l, l, window=cfg.sliding_window, device=dev)
    elif isinstance(cache_pos, torch.Tensor) and cache_pos.dim() > 0:
        cache_pos = cache_pos.to(device=dev, dtype=torch.int64).reshape(b)
        lengths = (cache_pos + l).to(torch.int32)
    else:
        cache_pos = 0 if cache_pos is None else int(cache_pos)
        lengths = torch.full((b,), cache_pos + l, dtype=torch.int32, device=dev)
    return cos, sin, mask, lengths, cache_pos


def run_layers(layers, cfg: ModelConfig, policy: QuantPolicy, x: torch.Tensor, ctx, cache, page_table,
               prefill_bf16: bool, group=None) -> torch.Tensor:
    """``layers`` in order over ``x`` [B, L, H]: OPT's, the W*A16 prefill
    layer or the W*Ax layer. ``ctx`` is ``step_context``'s; ``cache`` the
    (k, v, k_scale, v_scale) buffers whose layer i is ``layers[i]``'s (a
    pipeline stage's local cache), or None."""
    cos, sin, mask, lengths, cache_pos = ctx
    for i, lp in enumerate(layers):
        kv = None if cache is None else (*cache, i, page_table)
        if cfg.arch == "opt":
            x = opt_layer_serve(lp, cfg, policy, x, kv, cache_pos, lengths, mask=mask, group=group)
        elif prefill_bf16:
            x = llama_layer_serve_prefill(lp, cfg, x, cos, sin, kv, cache_pos, lengths, window=cfg.sliding_window,
                                          mask=mask, group=group)
        else:
            x = llama_layer_serve(lp, cfg, policy, x, cos, sin, kv, cache_pos, lengths, window=cfg.sliding_window,
                                  mask=mask, group=group)
    return x


def final_logits(params: Dict[str, Any], cfg: ModelConfig, policy: QuantPolicy, x: torch.Tensor, last_only: bool,
                 group=None) -> torch.Tensor:
    """The last stage of the serve forward: the final norm, the last
    position only with ``last_only``, and the lm_head."""
    if cfg.arch != "opt":
        x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    elif "final_norm" in params:
        x = layernorm(x, params["final_norm"]["g"], params["final_norm"]["b"], cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    return apply_lm_head(params, cfg, policy, x, group)
