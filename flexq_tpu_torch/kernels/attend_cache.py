"""Causal attention over the KV cache: the kernel shared by ``flash_decode``
(Lq == 1), ``flash_prefill`` (Lq >= 1) and ``flash_decode_paged`` (Lq == 1
over a page pool through a page table), and its plain PyTorch version.

Kernel: csrc/attend_cache.cu (CUDA C++ for sm_90a, bf16 or int8 cache; see
its header for the design and its bound). ``attend_cache_plain`` computes the
same function the way the TPU kernels do: keys in blocks of ``pick_bs(S)``,
the online-softmax update per block (``bs``; the paged kernel's block is one
page), and q, K, V and p rounded to
``compute_dtype`` before their dots (f32 sums). With an int8 cache the f32
scales fold into the math as in the TPU kernels: the score is
``(q . K8) * (1/sqrt(D)) * ks`` and ``p * vs`` (f32) is rounded before the PV
dot; int8 K and V upcast to bf16 exactly. Processing a block in which
a query has no valid key leaves that query's state unchanged in the TPU
kernels (or is wiped by the first valid block's alpha == 0), so the plain
version updates a query only on the blocks between its window start and its
diagonal.
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
_ARGS = [_P] * 7 + [_I, _P] + [_I] * 8 + [ctypes.c_float, _I, _I, _P]


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


def launch(q, k_cache, v_cache, lengths, layer_idx: int, window: Optional[int],
           clip_len: bool, k_scale=None, v_scale=None, table=None) -> torch.Tensor:
    """Launch csrc/attend_cache.cu: q bf16 [B, Lq, H, D] over the bf16 cache,
    or the int8 cache with its f32 scales, at ``layer_idx``; returns bf16
    [B, Lq, H*D]. The cache is [L, B, KVH, S, D] (scales [L, B, KVH, S]), or
    with ``table`` (int32 [B, MAXPAGES], Lq == 1) a page pool [L, P, KVH, PS,
    D] (scales [L, P, KVH, PS]) whose key block i of row b is page
    table[b, i]. The kernel reads the table's entries as given: each must be
    a page of the pool."""
    b, lq, h, d = q.shape
    nl, rows, kvh, s, cd = k_cache.shape  # rows: B (dense) or P (pool)
    dev = q.device
    quant = k_scale is not None
    cache_dtype = torch.int8 if quant else torch.bfloat16
    check_tensor(q, "q", torch.bfloat16, (b, lq, h, d), dev)
    if table is None:
        rows, max_pages, s_total, bs = b, 0, s, pick_bs(s)
    else:
        if lq != 1 or s % 128:
            raise ValueError(f"the paged kernel takes Lq == 1 and PS % 128 == 0, got Lq={lq}, PS={s}")
        max_pages = table.shape[1]
        check_tensor(table, "page_table", torch.int32, (b, max_pages), dev)
        s_total, bs = max_pages * s, s
    check_tensor(k_cache, "k_cache", cache_dtype, (nl, rows, kvh, s, d), dev)
    check_tensor(v_cache, "v_cache", cache_dtype, (nl, rows, kvh, s, d), dev)
    check_tensor(lengths, "lengths", torch.int32, (b,), dev)
    scale_ptrs = [None, None]
    if quant:
        for t, name in ((k_scale, "k_scale"), (v_scale, "v_scale")):
            check_tensor(t, name, torch.float32, (nl, rows, kvh, s), dev)
        per_layer_s = rows * kvh * s * 4
        scale_ptrs = [k_scale.data_ptr() + layer_idx * per_layer_s,
                      v_scale.data_ptr() + layer_idx * per_layer_s]
    if d not in (64, 128, 256) or h % kvh:
        raise ValueError(f"attend_cache kernel takes D in (64, 128, 256) and H % KVH == 0, got D={d}, H={h}, KVH={kvh}")
    if not 0 <= layer_idx < nl:
        raise IndexError(f"layer_idx {layer_idx} out of range [0, {nl})")
    out = torch.empty((b, lq, h * d), dtype=torch.bfloat16, device=dev)
    per_layer = k_cache[0].numel() * k_cache.element_size()
    fn = _build.function("attend_cache", "flexq_attend_cache", _ARGS)
    rc = fn(
        q.data_ptr(), k_cache.data_ptr() + layer_idx * per_layer,
        v_cache.data_ptr() + layer_idx * per_layer, *scale_ptrs, lengths.data_ptr(),
        None if table is None else table.data_ptr(), max_pages, out.data_ptr(),
        b, lq, h, kvh, s_total, d, window if window is not None else 0, bs,
        1.0 / math.sqrt(d), int(clip_len), int(quant), torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"attend_cache kernel launch failed: CUDA error {rc}")
    return out
