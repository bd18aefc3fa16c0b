"""Causal multi-query attention over the KV cache (port of
flexq_tpu/kernels/flash_prefill.py::flash_prefill, bf16 or int8 cache).

On the card a prompt of 64 queries or more launches csrc/flash_prefill.cu:
tiles of 64 (query, head) rows against 64-key tiles on the tensor cores,
rounding p against the reference's block max (see the source's header for
the design and its bound). A shorter prompt (less than one tile) launches
csrc/attend_cache.cu's warp-per-query kernel, whose P.V sums run key by key
as the CPU's plain version does: short W*Ax prompts quantize this output
to 6-bit codes at once, and phase 3 of chip_smoke.py holds LLaMA's at 2e-2
of max |logit|, which the tiles' other summation order misses (PERF.md §6;
ROADMAP Queue 3 names what would retire this split). The reference kernel
computes its dots in the cache dtype (bf16 on the serving path; f32 caches
stay f32), or in bf16 over an int8 cache (passing the scales selects it:
int8 values upcast, scales folded into the math), and the plain version
(``attend_cache.attend_cache_plain``) rounds q, K, V and p the same.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from flexq_tpu_torch.kernels import _build, attend_cache

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 7 + [_I] * 8 + [ctypes.c_float, _I, _P]
TILE_ROWS = 64  # csrc/flash_prefill.cu's query tile; shorter prompts take the warp-per-query kernel


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
    b, lq, h, d = q.shape
    s = k.shape[3]
    if s % 128:
        raise ValueError(f"cache length {s} must be a multiple of 128")
    q = q.to(torch.bfloat16).contiguous()
    if lq < TILE_ROWS:
        out = attend_cache.launch(q, k, v, lengths, layer_idx, window, k_scale=k_scale, v_scale=v_scale)
        flash_prefill.launches += 1
        return out.to(out_dtype)
    ptrs = attend_cache.layer_pointers(q, k, v, lengths, layer_idx, k_scale, v_scale)
    out = torch.empty((b, lq, h * d), dtype=torch.bfloat16, device=q.device)
    fn = _build.function("flash_prefill", "flexq_flash_prefill", _ARGS)
    rc = fn(q.data_ptr(), *ptrs, lengths.data_ptr(), out.data_ptr(), b, lq, h, k.shape[2], s, d,
            window if window is not None else 0, attend_cache.pick_bs(s), 1.0 / math.sqrt(d), int(quant),
            torch.cuda.current_stream(q.device).cuda_stream)
    attend_cache.check_rc(rc, "flash_prefill")
    flash_prefill.launches += 1
    return out.to(out_dtype)


flash_prefill.launches = 0
