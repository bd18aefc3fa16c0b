"""Single-query attention over the KV cache (port of
flexq_tpu/kernels/flash_decode.py::flash_decode (K6) over the dense cache and
flash_decode_paged (K13) over a page pool, bf16 or int8).

On the card this launches csrc/attend_cache.cu with Lq = 1 (see
kernels/attend_cache.py and the source's header). The reference kernel
rounds q, K, V and p to bf16 whatever the cache dtype, clips lengths to
[1, S] and returns ``out_dtype`` (bf16 by default); the plain version here
does the same. Passing the scales selects the int8 cache (scales folded
into the math).
"""

from __future__ import annotations

from typing import Optional

import torch

from flexq_tpu_torch.kernels import attend_cache


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
    out = attend_cache.launch(
        q.to(torch.bfloat16).reshape(b, 1, h, d).contiguous(), k, v, lengths,
        layer_idx, window, clip_len=True, k_scale=k_scale, v_scale=v_scale,
    )
    flash_decode.launches += 1
    return out.reshape(b, h * d).to(out_dtype)


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
    ``page_table[b, i]``, the online-softmax block is one page and lengths
    clip to [1, MAXPAGES * PS]. Returns [B, H*D]."""
    b, h, d = q.shape
    if pool_k.dim() != 5 or pool_k.shape[3] % 128:
        raise ValueError(f"pool must be [L, P, KVH, PS, D] with PS % 128 == 0, got {tuple(pool_k.shape)}")
    if q.device.type == "cpu":
        return flash_decode_paged_plain(q, pool_k, pool_v, page_table, lengths, k_scale, v_scale,
                                        layer_idx=layer_idx, window=window, out_dtype=out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    out = attend_cache.launch(
        q.to(torch.bfloat16).reshape(b, 1, h, d).contiguous(), pool_k, pool_v, lengths, layer_idx, window,
        clip_len=True, k_scale=k_scale, v_scale=v_scale, table=page_table,
    )
    flash_decode_paged.launches += 1
    return out.reshape(b, h * d).to(out_dtype)


flash_decode_paged.launches = 0
