"""Single-device serving engine (port of flexq_tpu/serve/engine.py: Engine
with prefill, chunked prefill, decode step and greedy generate, dense bf16
or int8 KV cache).

Prefill fills the cache and emits the first token's logits; decode then
runs one forward per token over the same cache, updated in place. The cache
is [layers, B, kv_heads, max_len, head_dim]; ``kv_dtype=torch.int8`` adds
f32 scales [layers, B, kv_heads, max_len] (per token and head). Prompts of
``prefill_bf16_threshold`` tokens or more prefill through the W6A16 layer;
with ``prefill_chunk`` set, longer prompts prefill in chunks of that many
tokens (each chunk attends over the cache written so far).

Two decode loops, as in the reference, returning the same tokens:
  * ``mode="fused"`` keeps the tokens, the stop test and the bookkeeping on
    the device and reads the device only every ``FUSED_CHECK_EVERY`` steps
    to stop early (the reference runs one on-device while_loop; a CUDA
    graph of the step is later work);
  * ``mode="step"`` reads each token back to the host, as the reference's
    stepwise loop does.

Not in this slice (NotImplementedError): meshes (tensor / pipeline
parallel), speculative decoding, logprobs and non-default sampling.
The model is a LLaMA or a pre-LN OPT: ``forward_serve`` chooses its layers.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flexq_tpu_torch.config import ModelConfig, QuantPolicy
from flexq_tpu_torch.kernels.common import resolve_device
from flexq_tpu_torch.models.quantized import forward_serve
from flexq_tpu_torch.serve.sampling import (
    SamplingParams,
    process_logits,
    require_greedy_default,
    sample,
)
from flexq_tpu_torch.utils.profiling import GenerationStats, StepTimer

FUSED_CHECK_EVERY = 8  # fused loop: decode steps between host reads of `finished`


class Engine:
    """Greedy generation over a quantized model on one device."""

    def __init__(
        self,
        params: Dict[str, Any],
        cfg: ModelConfig,
        policy: QuantPolicy,
        max_seq_len: int = 2048,
        kv_dtype=torch.bfloat16,
        prefill_bf16_threshold: int = 64,
        prefill_chunk: Optional[int] = None,
        mesh=None,
        pp_mesh=None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if mesh is not None or pp_mesh is not None:
            raise NotImplementedError("tensor- and pipeline-parallel serving are a later slice")
        if max_seq_len % 128:
            raise ValueError(f"max_seq_len={max_seq_len} must be a multiple of 128")
        if params["embed"].device != self.device:
            raise ValueError(f"params are on {params['embed'].device}, engine on {self.device}")
        self.params = params
        self.cfg = cfg
        self.policy = policy
        self.max_seq_len = max_seq_len
        self.kv_dtype = kv_dtype
        # prompts longer than this prefill in chunks (None: one pass)
        self.prefill_chunk = prefill_chunk
        # prompts at/above this many tokens take the W6A16 prefill layer
        self.prefill_bf16_threshold = prefill_bf16_threshold

    def _kv_shape(self, batch: int) -> Tuple[int, ...]:
        c = self.cfg
        return (c.num_layers, batch, c.num_kv_heads, self.max_seq_len, c.head_dim)

    @property
    def quantized_cache(self) -> bool:
        return self.kv_dtype == torch.int8

    def new_cache(self, batch: int):
        """(k, v), or (k, v, k_scale, v_scale) for the int8 cache."""
        shape = self._kv_shape(batch)
        cache = tuple(torch.zeros(shape, dtype=self.kv_dtype, device=self.device) for _ in "kv")
        if self.quantized_cache:
            cache += tuple(torch.zeros(shape[:-1], dtype=torch.float32, device=self.device) for _ in "kv")
        return cache

    def _fwd(self, ids, cache, positions, cache_pos, prefill_bf16: bool = False, last_only: bool = False):
        scales = dict(zip(("kv_k_scale", "kv_v_scale"), cache[2:]))
        return forward_serve(
            self.params, self.cfg, self.policy, ids, positions=positions,
            kv_k=cache[0], kv_v=cache[1], cache_pos=cache_pos, prefill_bf16=prefill_bf16,
            last_only=last_only, device=self.device, **scales,
        )

    def _prefill(self, ids, cache, prompt_len: int):
        b, l = ids.shape
        positions = torch.arange(l, device=self.device).expand(b, l)
        last = prompt_len == l
        logits, kv = self._fwd(
            ids, cache, positions, 0, prefill_bf16=l >= self.prefill_bf16_threshold, last_only=last
        )
        return logits[:, -1 if last else prompt_len - 1], kv

    def _prefill_chunk(self, ids, cache, start: int):
        """One chunk of a chunked prefill: queries at positions
        start..start+C-1 attend over cache[0 : start+C]."""
        b, c = ids.shape
        positions = start + torch.arange(c, device=self.device).expand(b, c)
        logits, kv = self._fwd(
            ids, cache, positions, start, prefill_bf16=c >= self.prefill_bf16_threshold, last_only=True
        )
        return logits[:, -1], kv

    def prefill_chunked(self, ids: torch.Tensor, cache, chunk: int = 512):
        """Prefill ``ids`` [B, L] into the cache in chunks of ``chunk``
        tokens (the last may be shorter). Returns (last-token logits, cache)."""
        l = ids.shape[1]
        logits, start = None, 0
        while start < l:
            c = min(chunk, l - start)
            logits, cache = self._prefill_chunk(ids[:, start : start + c], cache, start)
            start += c
        return logits, cache

    def _decode_step(self, ids, cache, pos: int):
        b = ids.shape[0]
        positions = torch.full((b, 1), pos, dtype=torch.int64, device=self.device)
        logits, kv = self._fwd(ids, cache, positions, pos)
        return logits[:, 0], kv

    def generate(
        self,
        prompt_ids: Sequence[Sequence[int]] | np.ndarray,
        max_new_tokens: int = 32,
        sampling: SamplingParams = SamplingParams(),
        eos_id: int = 2,
        stop_ids: Sequence[int] = (),
        seed: int = 0,
        return_stats: bool = False,
        return_logprobs: bool = False,
        mode: str = "fused",
    ):
        """Batched greedy generation of equal-length prompts. Returns the
        generated ids per row (up to and including a stop token)
        [, stats]. The parameters are the reference's, in its order;
        ``seed`` seeds sampling, which greedy decoding does not read."""
        if return_logprobs:
            raise NotImplementedError("the Engine's logprobs are a later slice (the Engine's full surface)")
        if mode == "spec":
            raise NotImplementedError("speculative decoding is a later slice")
        if mode not in ("fused", "step"):
            raise ValueError(f"unknown mode {mode!r}")
        require_greedy_default(sampling)
        prompts = [list(p) for p in prompt_ids]
        lens = {len(p) for p in prompts}
        if len(lens) != 1:
            raise ValueError("the engine requires equal-length prompts")
        l = lens.pop()
        b = len(prompts)
        if l + max_new_tokens > self.max_seq_len:
            raise ValueError(f"prompt {l} + {max_new_tokens} new tokens exceed max_seq_len {self.max_seq_len}")

        stats = GenerationStats(prompt_tokens=b * l)
        timer = StepTimer(self.device)
        ids = torch.as_tensor(np.asarray(prompts, np.int64), device=self.device)
        cache = self.new_cache(b)
        if self.prefill_chunk and l > self.prefill_chunk:
            logits, cache = self.prefill_chunked(ids, cache, self.prefill_chunk)
        else:
            logits, cache = self._prefill(ids, cache, prompt_len=l)
        stop = torch.as_tensor(sorted(set(stop_ids) | {eos_id}), dtype=torch.int32, device=self.device)
        if mode == "fused":
            out = self._fused_loop(logits, cache, l, stop, sampling, max_new_tokens, stats, timer)
        else:
            out = self._step_loop(logits, cache, l, stop, sampling, max_new_tokens, stats, timer)
        return (out, stats) if return_stats else out

    def _fused_loop(self, logits, cache, pos, stop, sampling, max_new, stats, timer):
        """The reference's _loop_body on the device: tokens hold -1 after a
        row finished; the host reads `finished` every FUSED_CHECK_EVERY steps."""
        stats.ttft_s = timer.lap()  # prefill; the first token is sampled in the loop
        b = logits.shape[0]
        tokens = torch.full((b, max_new), -1, dtype=torch.int32, device=self.device)
        finished = torch.zeros(b, dtype=torch.bool, device=self.device)
        for i in range(max_new):
            nxt = sample(process_logits(logits, sampling), sampling)
            record = ~finished
            tokens[:, i] = torch.where(record, nxt, torch.full_like(nxt, -1))
            finished = finished | (record & torch.isin(nxt, stop))
            if i + 1 == max_new:
                break  # the reference's last step forward feeds nothing
            if (i + 1) % FUSED_CHECK_EVERY == 0 and bool(finished.all()):
                break
            logits, cache = self._decode_step(nxt[:, None], cache, pos)
            pos += 1
        tok = tokens.cpu().numpy()
        stats.decode_s = timer.lap()
        out = [[int(t) for t in row if t >= 0] for row in tok]
        stats.generated_tokens = sum(len(r) for r in out)
        return out

    def _step_loop(self, logits, cache, pos, stop, sampling, max_new, stats, timer):
        b = logits.shape[0]
        stop_set = set(stop.tolist())
        out: List[List[int]] = [[] for _ in range(b)]
        finished = np.zeros(b, bool)
        for step in range(max_new):
            next_ids = sample(process_logits(logits, sampling), sampling)
            ids_np = next_ids.cpu().numpy()
            if step == 0:
                stats.ttft_s = timer.lap()
            else:
                stats.step_times_s.append(timer.lap())
            stats.generated_tokens += int((~finished).sum())
            for row in range(b):
                if not finished[row]:
                    out[row].append(int(ids_np[row]))
                    if int(ids_np[row]) in stop_set:
                        finished[row] = True
            if finished.all() or step == max_new - 1:
                break
            logits, cache = self._decode_step(next_ids[:, None], cache, pos)
            pos += 1
        stats.decode_s = sum(stats.step_times_s) or stats.ttft_s
        return out
