"""Single-query attention over the KV cache (port of
flexq_tpu/kernels/flash_decode.py::flash_decode, bf16 or int8 cache).

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
