"""Single-query attention over the KV cache (port of
flexq_tpu/kernels/flash_decode.py::flash_decode (K6) over the dense cache and
flash_decode_paged (K13) over a page pool, bf16 or int8).

On the card both launch csrc/flash_decode.cu, one split-KV kernel whose
chunk address is a template parameter (the dense cache, or the pool through
the page table): the keys split over blocks, combined by the last block in
the same launch; see the source's header for the design and its bound. The
reference kernel rounds q, K, V and p to bf16 whatever the cache dtype,
clips lengths to [1, S] and returns ``out_dtype`` (bf16 by default); the
plain versions here do the same. Passing the scales selects the int8 cache
(scales folded into the math).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from flexq_tpu_torch.kernels import _build, attend_cache
from flexq_tpu_torch.kernels.common import arrival_counters, check_tensor

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 7 + [_I, _P, _P, ctypes.c_longlong, _P] + [_I] * 6 + [ctypes.c_float, _I, _P]
_SIZES_ARGS = [_I] * 6 + [ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)]


def flash_decode(
    q: torch.Tensor,  # [B, H, D]
    k: torch.Tensor,  # [L, B, KVH, S, D] full cache keys
    v: torch.Tensor,
    lengths: torch.Tensor,  # int32 [B] valid tokens per sequence
    k_scale: Optional[torch.Tensor] = None,  # f32 [L, B, KVH, S] (int8 cache)
    v_scale: Optional[torch.Tensor] = None,
    *,
    layer_idx: int,
    window: Optional[int] = None,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Attention of one query per (row, head) over cache layer ``layer_idx``;
    keys at positions [max(len - window, 0), len). Returns [B, H*D]."""
    b, h, d = q.shape
    if k.dim() != 5:
        raise ValueError(f"cache must be [L, B, KVH, S, D], got {tuple(k.shape)}")
    if q.device.type == "cpu":
        out = attend_cache.attend_cache_plain(
            q[:, None], k, v, lengths, layer_idx, window, torch.bfloat16, True, out_dtype,
            k_scale, v_scale,
        )
        return out.reshape(b, h * d)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if k.shape[3] % 128:
        raise ValueError(f"cache length {k.shape[3]} must be a multiple of 128")
    out = _launch(q.to(torch.bfloat16).contiguous(), k, v, None, lengths, k_scale, v_scale, layer_idx, window)
    flash_decode.launches += 1
    return out.to(out_dtype)


flash_decode.launches = 0


def flash_decode_paged_plain(q, pool_k, pool_v, page_table, lengths, k_scale=None, v_scale=None, *,
                             layer_idx: int, window: Optional[int] = None, out_dtype=torch.bfloat16):
    """Plain version of K13: the table's pages of layer ``layer_idx``
    gathered into a dense [1, B, KVH, MAXPAGES*PS, D] cache, then K6's
    plain version with the block forced to one page."""
    b, h, d = q.shape
    ps = pool_k.shape[3]
    tbl = page_table.to(device=q.device, dtype=torch.int64)

    def gather(pool):  # [L, P, KVH, PS(, D)] -> [1, B, KVH, MAXPAGES*PS(, D)]
        g = pool[layer_idx][tbl]  # [B, MAXPAGES, KVH, PS(, D)]
        g = g.transpose(1, 2)
        return g.reshape(g.shape[:2] + (-1,) + g.shape[4:])[None]

    scales = [gather(t) for t in (k_scale, v_scale)] if k_scale is not None else [None, None]
    out = attend_cache.attend_cache_plain(
        q[:, None], gather(pool_k), gather(pool_v), lengths, 0, window, torch.bfloat16, True, out_dtype,
        *scales, bs=ps,
    )
    return out.reshape(b, h * d)


def flash_decode_paged(
    q: torch.Tensor,  # [B, H, D]
    pool_k: torch.Tensor,  # [L, P, KVH, PS, D] page pool keys (bf16 or int8)
    pool_v: torch.Tensor,
    page_table: torch.Tensor,  # int32 [B, MAXPAGES]: logical block i -> pool page
    lengths: torch.Tensor,  # int32 [B] valid tokens per sequence
    k_scale: Optional[torch.Tensor] = None,  # f32 [L, P, KVH, PS] (int8 pool)
    v_scale: Optional[torch.Tensor] = None,
    *,
    layer_idx: int,
    window: Optional[int] = None,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """flash_decode over a paged cache: key block i of row b is pool page
    ``page_table[b, i]``, the reference's online-softmax block is one page
    and lengths clip to [1, MAXPAGES * PS]. Returns [B, H*D]."""
    if pool_k.dim() != 5 or pool_k.shape[3] % 128:
        raise ValueError(f"pool must be [L, P, KVH, PS, D] with PS % 128 == 0, got {tuple(pool_k.shape)}")
    if q.device.type == "cpu":
        return flash_decode_paged_plain(q, pool_k, pool_v, page_table, lengths, k_scale, v_scale,
                                        layer_idx=layer_idx, window=window, out_dtype=out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    out = _launch(q.to(torch.bfloat16).contiguous(), pool_k, pool_v, page_table, lengths, k_scale, v_scale,
                  layer_idx, window)
    flash_decode_paged.launches += 1
    return out.to(out_dtype)


flash_decode_paged.launches = 0

@functools.lru_cache(maxsize=64)
def _sizes(b: int, h: int, kvh: int, ps: int, d: int, max_pages: int) -> Tuple[int, int]:
    """(f32 scratch floats, arrival counters) of a launch, as the kernel's
    own geometry gives them (the dense cache: ps = S, max_pages = 1)."""
    part, counters = ctypes.c_longlong(), ctypes.c_int()
    fn = _build.function("flash_decode", "flexq_flash_decode_sizes", _SIZES_ARGS)
    attend_cache.check_rc(fn(b, h, kvh, ps, d, max_pages, ctypes.byref(part), ctypes.byref(counters)),
                          "flash_decode")
    return part.value, counters.value


def _launch(q, k, v, page_table, lengths, k_scale, v_scale, layer_idx: int, window: Optional[int]) -> torch.Tensor:
    """Launch csrc/flash_decode.cu: q bf16 [B, H, D] over layer ``layer_idx``
    of the dense cache [L, B, KVH, S, D] (``page_table`` None) or of the pool
    [L, P, KVH, PS, D] through ``page_table``; returns bf16 [B, H*D]. The
    kernel reads the table's entries as given: each must be a page of the
    pool. Its f32 scratch holds each split's (acc, m, l)."""
    b, h, d = q.shape
    _, rows, kvh, ps, _ = k.shape
    dev = q.device
    if page_table is None:
        max_pages, table = 1, None
        ptrs = attend_cache.layer_pointers(q.view(b, 1, h, d), k, v, lengths, layer_idx, k_scale, v_scale)
    else:
        max_pages = page_table.shape[1]
        check_tensor(page_table, "page_table", torch.int32, (b, max_pages), dev)
        table = page_table.data_ptr()
        ptrs = attend_cache.layer_pointers(q.view(b, 1, h, d), k, v, lengths, layer_idx, k_scale, v_scale, rows=rows)
    part_floats, n_counters = _sizes(b, h, kvh, ps, d, max_pages)
    part = torch.empty(part_floats, dtype=torch.float32, device=dev)
    out = torch.empty((b, h * d), dtype=torch.bfloat16, device=dev)
    fn = _build.function("flash_decode", "flexq_flash_decode", _ARGS)
    rc = fn(q.data_ptr(), *ptrs, lengths.data_ptr(), table, max_pages, out.data_ptr(), part.data_ptr(), part.numel(),
            arrival_counters(dev, n_counters).data_ptr(), b, h, kvh, ps, d, window if window is not None else 0,
            1.0 / math.sqrt(d), int(k_scale is not None), torch.cuda.current_stream(dev).cuda_stream)
    attend_cache.check_rc(rc, "flash_decode")
    return out
