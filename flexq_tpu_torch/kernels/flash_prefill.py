"""Causal multi-query attention over the KV cache (port of
flexq_tpu/kernels/flash_prefill.py::flash_prefill, bf16 or int8 cache).

On the card this launches csrc/attend_cache.cu (see kernels/attend_cache.py
and the source's header). The reference kernel computes its dots in the
cache dtype (bf16 on the serving path; f32 caches stay f32), or in bf16 over
an int8 cache (passing the scales selects it: int8 values upcast, scales
folded into the math), and the plain version rounds q, K, V and p the same.
"""

from __future__ import annotations

from typing import Optional

import torch

from flexq_tpu_torch.kernels import attend_cache


def flash_prefill(
    q: torch.Tensor,  # [B, Lq, H, D]
    k: torch.Tensor,  # [L, B, KVH, S, D] full cache keys
    v: torch.Tensor,
    lengths: torch.Tensor,  # int32 [B]: query-end positions (cache_pos + Lq)
    k_scale: Optional[torch.Tensor] = None,  # f32 [L, B, KVH, S] (int8 cache)
    v_scale: Optional[torch.Tensor] = None,
    *,
    layer_idx: int,
    window: Optional[int] = None,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Query i of row b at lengths[b] - Lq + i attends cache keys at
    positions <= its own (and > pos - window). Returns [B, Lq, H*D]."""
    if k.dim() != 5:
        raise ValueError(f"cache must be [L, B, KVH, S, D], got {tuple(k.shape)}")
    quant = k_scale is not None
    if q.device.type == "cpu":
        return attend_cache.attend_cache_plain(
            q, k, v, lengths, layer_idx, window, torch.bfloat16 if quant else k.dtype, False,
            out_dtype, k_scale, v_scale,
        )
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if k.dtype != (torch.int8 if quant else torch.bfloat16):
        raise TypeError(f"the kernel takes a bf16 cache, or an int8 cache with scales; got {k.dtype}")
    out = attend_cache.launch(
        q.to(torch.bfloat16).contiguous(), k, v, lengths, layer_idx, window, clip_len=False,
        k_scale=k_scale, v_scale=v_scale,
    )
    flash_prefill.launches += 1
    return out.to(out_dtype)


flash_prefill.launches = 0
