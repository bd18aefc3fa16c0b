"""Causal attention over the KV cache: the plain PyTorch version shared by
``flash_decode`` (K6, Lq == 1), ``flash_prefill`` (K9, Lq >= 1) and
``flash_decode_paged`` (K13, Lq == 1 over a page pool through a page
table), the argument checks of their kernels, and the launch of K9's
short-prompt kernel.

Kernels: csrc/attend_cache.cu (one warp per query: K9 below 64 queries
only), csrc/flash_prefill.cu (K9's tensor-core tiles) and
csrc/flash_decode.cu (K6 and K13: split-KV over the dense cache or the
pool), CUDA C++ for sm_90a over a bf16 or an int8 cache (see each source's
header for its design and its bound).
``attend_cache_plain`` computes the function the way the TPU kernels do:
keys in blocks of ``pick_bs(S)``, the online-softmax update per block
(``bs``; the paged kernel's block is one page), and q, K, V and p rounded to
``compute_dtype`` before their dots (f32 sums). With an int8 cache the f32
scales fold into the math as in the TPU kernels: the score is
``(q . K8) * (1/sqrt(D)) * ks`` and ``p * vs`` (f32) is rounded before the PV
dot; int8 K and V upcast to bf16 exactly. Processing a block in which
a query has no valid key leaves that query's state unchanged in the TPU
kernels (or is wiped by the first valid block's alpha == 0), so the plain
version updates a query only on the blocks between its window start and its
diagonal. K6 and K13 take their online-softmax steps over other key blocks
than ``bs`` (one 128-key split of the keys per block), so past 128 keys they
round p against another running max (ROADMAP Queue 3).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from flexq_tpu_torch.kernels import _build
from flexq_tpu_torch.kernels.common import check_tensor

NEG = -1e30  # finite -inf stand-in, as in the TPU kernels
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 7 + [_I] * 8 + [ctypes.c_float, _I, _P]


def pick_bs(s: int, cap: int = 512) -> int:
    """Key block: the largest multiple of 128 that divides S, at most cap
    (the TPU kernels' ``_pick_bs``)."""
    for t in range(min(cap, s) // 128, 0, -1):
        if s % (t * 128) == 0:
            return t * 128
    raise ValueError(f"cache length {s} must be a multiple of 128")


def attend_cache_plain(
    q: torch.Tensor,  # [B, Lq, H, D]
    k_cache: torch.Tensor,  # [L, B, KVH, S, D]
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # int [B]
    layer_idx: int,
    window: Optional[int],
    compute_dtype,
    clip_len: bool,
    out_dtype,
    k_scale: Optional[torch.Tensor] = None,  # f32 [L, B, KVH, S] (int8 cache)
    v_scale: Optional[torch.Tensor] = None,
    bs: Optional[int] = None,
) -> torch.Tensor:
    """[B, Lq, H*D]: query i of row b at lengths[b] - Lq + i attends keys in
    (pos - window, pos]; ``clip_len`` clips lengths to [1, S] first. Keys go
    in blocks of ``bs`` (default: ``pick_bs(S)``, the dense kernels' block)."""
    b, lq, h, d = q.shape
    kc, vc = k_cache[layer_idx], v_cache[layer_idx]
    ks = k_scale[layer_idx].to(torch.float32)[:, :, None] if k_scale is not None else None
    vs = v_scale[layer_idx].to(torch.float32)[:, :, None] if v_scale is not None else None
    kvh, s = kc.shape[1], kc.shape[2]
    g = h // kvh
    bs = bs or pick_bs(s)
    dev = q.device
    ln = lengths.to(device=dev, dtype=torch.int64)
    if clip_len:
        ln = ln.clamp(1, s)
    pos = ln[:, None] - lq + torch.arange(lq, device=dev)  # [B, Lq]
    lo = (pos - window + 1).clamp(min=0) if window is not None else torch.zeros_like(pos)
    first = lo // bs
    last = pos.clamp(max=s - 1) // bs
    ok_row = pos >= 0

    def rows(t):  # [B, Lq] -> [B, 1, G*Lq, 1] in the (g, i) row order of qf
        return t[:, None, None, :].expand(b, 1, g, lq).reshape(b, 1, g * lq, 1)

    pos_r, lo_r, first_r, last_r, ok_r = map(rows, (pos, lo, first, last, ok_row))
    qf = q.to(compute_dtype).to(torch.float32)
    qf = qf.reshape(b, lq, kvh, g, d).permute(0, 2, 3, 1, 4).reshape(b, kvh, g * lq, d)
    m = torch.full((b, kvh, g * lq, 1), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kvh, g * lq, d), dtype=torch.float32, device=dev)
    scale = 1.0 / math.sqrt(d)
    if bool(ok_row.any()):
        for blk in range(int(first[ok_row].min()), int(last[ok_row].max()) + 1):
            k0 = blk * bs
            kb = kc[:, :, k0 : k0 + bs].to(compute_dtype).to(torch.float32)
            vb = vc[:, :, k0 : k0 + bs].to(compute_dtype).to(torch.float32)
            sco = torch.matmul(qf, kb.transpose(-1, -2)) * scale  # [B, KVH, R, bs]
            if ks is not None:  # K dequant after the dot: (q . K8) * ks
                sco = sco * ks[..., k0 : k0 + bs]
            pos_k = k0 + torch.arange(bs, device=dev)
            ok = (pos_k <= pos_r) & (pos_k >= lo_r)
            sco = torch.where(ok, sco, torch.full_like(sco, NEG))
            m_new = torch.maximum(m, sco.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sco - m_new)
            l_new = l * alpha + p.sum(dim=-1, keepdim=True)
            if vs is not None:  # V dequant folded into p: (p * vs) . V8
                p = p * vs[..., k0 : k0 + bs]
            pv = torch.matmul(p.to(compute_dtype).to(torch.float32), vb)
            acc_new = acc * alpha + pv
            active = ok_r & (blk >= first_r) & (blk <= last_r)
            m = torch.where(active, m_new, m)
            l = torch.where(active, l_new, l)
            acc = torch.where(active, acc_new, acc)
    out = acc / l.clamp(min=1e-30)
    out = out.reshape(b, kvh, g, lq, d).permute(0, 3, 1, 2, 4).reshape(b, lq, h * d)
    return out.to(out_dtype)


def layer_pointers(q, k_cache, v_cache, lengths, layer_idx: int, k_scale=None, v_scale=None,
                   rows: Optional[int] = None):
    """Check a kernel's q (bf16 [B, Lq, H, D]), cache or pool (bf16, or int8
    with f32 scales) and lengths, and return the data pointers of layer
    ``layer_idx``: [k, v, k_scale, v_scale] (the scales None for bf16). The
    cache is [L, rows, KVH, S, D] (scales [L, rows, KVH, S]); ``rows`` is B
    for a dense cache (the default) or the pool's P."""
    b, lq, h, d = q.shape
    nl, _, kvh, s, _ = k_cache.shape
    rows = b if rows is None else rows
    dev = q.device
    quant = k_scale is not None
    cache_dtype = torch.int8 if quant else torch.bfloat16
    check_tensor(q, "q", torch.bfloat16, (b, lq, h, d), dev)
    check_tensor(k_cache, "k_cache", cache_dtype, (nl, rows, kvh, s, d), dev)
    check_tensor(v_cache, "v_cache", cache_dtype, (nl, rows, kvh, s, d), dev)
    check_tensor(lengths, "lengths", torch.int32, (b,), dev)
    if d not in (64, 128, 256) or h % kvh:
        raise ValueError(f"the attention kernels take D in (64, 128, 256) and H % KVH == 0, got D={d}, H={h}, KVH={kvh}")
    if not 0 <= layer_idx < nl:
        raise IndexError(f"layer_idx {layer_idx} out of range [0, {nl})")
    per_layer = k_cache[0].numel() * k_cache.element_size()
    ptrs = [k_cache.data_ptr() + layer_idx * per_layer, v_cache.data_ptr() + layer_idx * per_layer, None, None]
    if quant:
        for t, name in ((k_scale, "k_scale"), (v_scale, "v_scale")):
            check_tensor(t, name, torch.float32, (nl, rows, kvh, s), dev)
        per_layer_s = rows * kvh * s * 4
        ptrs[2:] = [k_scale.data_ptr() + layer_idx * per_layer_s, v_scale.data_ptr() + layer_idx * per_layer_s]
    return ptrs


def check_rc(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def launch(q, k_cache, v_cache, lengths, layer_idx: int, window: Optional[int], k_scale=None,
           v_scale=None) -> torch.Tensor:
    """Launch csrc/attend_cache.cu (one warp per query; K9's prompts below
    64 queries): q bf16 [B, Lq, H, D] over the bf16 cache, or the int8 cache
    with its f32 scales, [L, B, KVH, S, D] at ``layer_idx``. Returns bf16
    [B, Lq, H*D]."""
    b, lq, h, d = q.shape
    s = k_cache.shape[3]
    ptrs = layer_pointers(q, k_cache, v_cache, lengths, layer_idx, k_scale, v_scale)
    out = torch.empty((b, lq, h * d), dtype=torch.bfloat16, device=q.device)
    fn = _build.function("attend_cache", "flexq_attend_cache", _ARGS)
    rc = fn(q.data_ptr(), *ptrs, lengths.data_ptr(), out.data_ptr(), b, lq, h, k_cache.shape[2], s, d,
            window if window is not None else 0, pick_bs(s), 1.0 / math.sqrt(d), int(k_scale is not None),
            torch.cuda.current_stream(q.device).cuda_stream)
    check_rc(rc, "attend_cache")
    return out
