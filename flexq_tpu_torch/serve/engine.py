"""Single-device serving engine (port of flexq_tpu/serve/engine.py: Engine
with prefill, chunked prefill, decode step, generate in every decoding mode
the reference serves, dense bf16 or int8 KV cache).

Prefill fills the cache and emits the first token's logits; decode then
runs one forward per token over the same cache, updated in place. The cache
is [layers, B, kv_heads, max_len, head_dim]; ``kv_dtype=torch.int8`` adds
f32 scales [layers, B, kv_heads, max_len] (per token and head). Prompts of
``prefill_bf16_threshold`` tokens or more prefill through the W6A16 layer;
with ``prefill_chunk`` set, longer prompts prefill in chunks of that many
tokens (each chunk attends over the cache written so far).

Three decode loops, as in the reference:
  * ``mode="fused"`` keeps the tokens, logprobs, token counts, the stop test
    and the bookkeeping on the device and reads the device only every
    ``FUSED_CHECK_EVERY`` steps to stop early. Where the reference runs one
    on-device while_loop, the card replays a captured CUDA graph of one step
    (forward, draw, record, stop test: serve/graphs.py); the graph, its
    static buffers and a cache of B rows are kept per (B, sampling, stop
    set, logprobs) across calls (``Engine._fused``), captured on the first
    call's first decode step, whose capture time goes to
    ``GenerationStats.capture_s`` and not into TTFT or the decode time. On
    the CPU the same step runs eagerly;
  * ``mode="step"`` reads each token back to the host, as the reference's
    stepwise loop does, and stays eager. Both draw from one
    ``torch.Generator`` seeded with ``seed`` in the same order, so they give
    the same tokens (greedy or sampled); the draws are not ``jax.random``'s;
  * ``mode="spec"``: speculative decoding with prompt-lookup drafts
    (serve/speculative.py), whose fused loop is ``_spec_decode_loop`` here.
Beam search over the Engine's cache is serve/beam.py. The spec loop and beam
search stay eager.

Under a ``mesh`` (parallel/distributed.py: one process per rank, every rank
calling ``generate`` with the same arguments) the Engine serves through
parallel/tp.py::forward_serve_tp: it shards its parameters (unless they are
a rank's shard already, as ``load_packed_sharded`` gives them), holds a
cache of [L, B/dp, KVH/tp, S, D] on the rank's device, and every rank draws
the same tokens from the gathered logits of all B rows with its seeded
generator, so every rank returns all B rows. B must divide by dp; spec
decoding and beam search take dp = 1. The fused loop's step graph holds
the step's NCCL collectives; a gloo mesh on the card has no capturable
collectives and refuses ``mode="fused"`` (``mode="step"`` serves it). The
model is a LLaMA or a pre-LN OPT: ``forward_serve`` chooses its layers.

Under a ``pp_mesh`` (parallel/pp.py: one process per stage, every rank
calling ``generate`` with the same arguments) prefill, chunked prefill and
decode all run through parallel/pp.py::serve_step_pp over this stage's
layers and its cache of [L/pp, B, KVH, S, D]; ``mode`` becomes "step" and
``mode="spec"`` is refused, as in the reference. Prompts run the W*Ax layer
whatever their length (the reference's pipeline takes no W*A16 prefill),
and every rank draws from the last stage's broadcast logits with its seeded
generator.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flexq_tpu_torch.config import ModelConfig, QuantPolicy, require_servable
from flexq_tpu_torch.kernels.common import resolve_device
from flexq_tpu_torch.parallel.pp import stage_params
from flexq_tpu_torch.parallel.tp import cache_forward, is_sharded, shard_params
from flexq_tpu_torch.serve.graphs import StepGraph
from flexq_tpu_torch.serve.sampling import SamplingParams, process_logits, sample
from flexq_tpu_torch.utils.profiling import GenerationStats, StepTimer

FUSED_CHECK_EVERY = 8  # fused loop: decode steps between host reads of `finished`
FUSED_KEEP = 8  # fused loops (graph + buffers) an Engine keeps; more clears them and their caches


def _uses_counts(sampling: SamplingParams) -> bool:
    """Whether the penalties read token counts (process_logits ignores the
    counts otherwise, so they need not be kept)."""
    return sampling.repetition_penalty != 1.0 or sampling.presence_penalty != 0.0 or sampling.frequency_penalty != 0.0


class Engine:
    """Greedy / sampled / speculative generation over a quantized model on
    one device."""

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
        require_servable(policy)
        if pp_mesh is not None and mesh is not None:
            raise ValueError("pp_mesh and mesh are exclusive (as in the reference)")
        self.mesh = mesh
        self.pp_mesh = pp_mesh
        if pp_mesh is not None:
            self.device = pp_mesh.device
            params = stage_params(params, cfg, pp_mesh)
        elif mesh is not None:
            self.device = mesh.device
            if not is_sharded(params, cfg, mesh.tp):
                params = shard_params(params, mesh)
        else:
            self.device = resolve_device(device)
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
        # the fused loop's state kept across calls: a cache per batch size,
        # and per (B, sampling, eos, stop set, logprobs) its _Decoding and
        # StepGraph
        self._fused_caches: Dict[int, Tuple] = {}
        self._fused: Dict[Any, Tuple["_Decoding", StepGraph]] = {}

    def _kv_shape(self, batch: int) -> Tuple[int, ...]:
        """[L, B, KVH, S, D]; under a mesh this rank's [L, B/dp, KVH/tp, S, D],
        under a pipeline this stage's [L/pp, B, KVH, S, D]."""
        c, m = self.cfg, self.mesh
        if m is None:
            return (len(self.params["layers"]), batch, c.num_kv_heads, self.max_seq_len, c.head_dim)
        rows = m.rows(batch)
        return (c.num_layers, rows.stop - rows.start, c.num_kv_heads // m.tp, self.max_seq_len, c.head_dim)

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
        return cache_forward(self.params, self.cfg, self.policy, self.mesh or self.pp_mesh, self.device, ids, cache,
                             positions, cache_pos, prefill_bf16=prefill_bf16, last_only=last_only)

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

    def prefill_prompts(self, prompts: List[List[int]], cache):
        """Prefill equal-length prompts (whole, or in ``prefill_chunk``
        chunks): (last-token logits [B, V], cache)."""
        l = len(prompts[0])
        ids = torch.as_tensor(np.asarray(prompts, np.int64), device=self.device)
        if self.prefill_chunk and l > self.prefill_chunk:
            return self.prefill_chunked(ids, cache, self.prefill_chunk)
        return self._prefill(ids, cache, prompt_len=l)

    def _spec_forward(self, ids, cache, start):
        """The speculative verify forward: a [B, C] window at positions
        start..start+C-1 (``start`` an int, or a per-row int tensor [B]),
        written into the cache and attending causally over it through the
        lengths ``start + C`` (the W*Ax layer; attention is flash_prefill
        over C > 1 queries, flash_decode over one). Returns (logits
        [B, C, V], cache)."""
        b, c = ids.shape
        if isinstance(start, torch.Tensor):
            sv = start.to(device=self.device, dtype=torch.int64)
        else:
            sv = torch.full((b,), int(start), dtype=torch.int64, device=self.device)
        positions = sv[:, None] + torch.arange(c, device=self.device)[None, :]
        return self._fwd(ids, cache, positions, sv if isinstance(start, torch.Tensor) else int(start))

    def _spec_verify(self, ids, cache, start):
        """The greedy targets [B, C] (int32) of every window position."""
        logits, kv = self._spec_forward(ids, cache, start)
        return torch.argmax(logits, dim=-1).to(torch.int32), kv

    def _decode_step(self, ids, cache, pos: int):
        b = ids.shape[0]
        positions = torch.full((b, 1), pos, dtype=torch.int64, device=self.device)
        logits, kv = self._fwd(ids, cache, positions, pos)
        return logits[:, 0], kv

    def _fused_loop(self, b: int, sampling: SamplingParams, eos_id: int, stop_ids, logprobs: bool):
        """The fused loop's (_Decoding, StepGraph) for this configuration,
        made on first use: its static buffers, the batch size's cache
        (shared by every configuration of that B) and the graph of one
        step: forward at the per-row positions, draw, record, stop test."""
        key = (b, sampling, eos_id, tuple(sorted(set(stop_ids))), logprobs)
        hit = self._fused.get(key)
        if hit is not None:
            return hit
        if len(self._fused) >= FUSED_KEEP:  # bound a long-lived engine's graphs and caches
            self._fused.clear()
            self._fused_caches.clear()
        cache = self._fused_caches.get(b)
        if cache is None:
            cache = self._fused_caches[b] = self.new_cache(b)
        dec = _Decoding(self, b, sampling, eos_id, stop_ids, logprobs, cache=cache)
        params, cfg, policy, mesh, dev = self.params, self.cfg, self.policy, self.mesh, self.device

        def step():  # reads and writes dec's buffers and the cache only (no reference to the Engine)
            # the per-row position tensor: _decode_step's writes and lengths, read from the device
            logits, _ = cache_forward(params, cfg, policy, mesh, dev, dec.fed, cache, dec.pos[:, None], dec.pos)
            dec.pos += 1
            dec.record(*dec.draw(logits[:, 0]))

        hit = self._fused[key] = (dec, StepGraph(step, dev, generator=dec.gen))
        return hit

    # draftability gate of the fused spec loop (the reference's constants):
    # a per-row acceptance EMA; when the worst live row's EMA drops below
    # SPEC_GATE_OFF the loop verifies single tokens (plain-decode cost),
    # re-probes with a full spec step every SPEC_GATE_PROBE steps and drafts
    # again from SPEC_GATE_ON (hysteresis)
    SPEC_GATE_PROBE = 32
    SPEC_GATE_OFF = 0.2
    SPEC_GATE_ON = 0.5
    SPEC_GATE_W = 0.25  # EMA update weight
    # steps between the fused spec loop's host reads of its flags; more than
    # 1 only to measure the read's cost (chip_smoke.py, ungated): a stale
    # flag keeps the last window width and runs finished rows in place
    SPEC_FLAG_READ_EVERY = 1

    def _spec_decode_loop(self, logits0, cache, buf, prompt_len: int, k: int, max_new: int, stop_ids,
                          max_ngram: int, sampling: SamplingParams, generator=None, gate: bool = True):
        """The fused speculative loop (the reference's ``_spec_loop_body``):
        per step an n-gram draft on the device (ngram_draft_device), one
        [B, 1+k] verify forward at each row's own start, the accept rule,
        the stop test and the buffer writes, all on the device. ``buf`` is
        the token history [B, LB] (prompts at [:, :prompt_len]); row r's
        tokens land at buf[r, prompt_len:length[r]]. Finished rows re-verify
        in place (m = 0) until every row finishes. The host reads one pair
        of device flags a step, (draft next step, every row finished), to
        choose the window's width, 1+k or 1, where the reference's
        ``lax.cond`` chooses on the device. Sampled targets draw from
        ``generator``. Returns (buf, length, steps, accepted, drafted)."""
        from flexq_tpu_torch.serve.speculative import ngram_draft_device

        dev = self.device
        b = buf.shape[0]
        rows = torch.arange(b, device=dev)
        stop = torch.as_tensor(sorted(set(stop_ids)), dtype=torch.int64, device=dev)
        j = torch.arange(k + 1, device=dev)[None, :]

        def targets_from(logits_w):
            c = logits_w.shape[1]
            if sampling.greedy:
                return torch.argmax(logits_w, dim=-1)
            # rows = window positions (independent given the draft)
            proc = process_logits(logits_w.reshape(b * c, -1), sampling)
            return sample(proc, sampling, generator).to(torch.int64).reshape(b, c)

        if sampling.greedy:
            first = torch.argmax(logits0, dim=-1)
        else:
            first = sample(process_logits(logits0, sampling), sampling, generator).to(torch.int64)
        buf[rows, prompt_len] = first
        length = torch.full((b,), prompt_len + 1, dtype=torch.int64, device=dev)
        finished = torch.isin(first, stop) | (max_new <= 1)
        acc = torch.zeros((), dtype=torch.int64, device=dev)
        drafted = torch.zeros((), dtype=torch.int64, device=dev)
        ema = torch.ones(b, dtype=torch.float32, device=dev)  # optimistic: start drafting
        spec_on = torch.ones((), dtype=torch.bool, device=dev)
        steps = 0
        spec_next, done = True, bool(finished.all())
        while not done:
            last = buf[rows, length - 1]
            do_spec = spec_next or not gate or (steps + 1) % self.SPEC_GATE_PROBE == 0
            if do_spec:
                draft = ngram_draft_device(buf, length, k, max_ngram)  # [B, k]
                logits_w, cache = self._spec_forward(torch.cat([last[:, None], draft], 1), cache, length - 1)
                t = targets_from(logits_w)  # [B, 1+k]
                n_acc = torch.cumprod((draft == t[:, :k]).to(torch.int64), dim=1).sum(dim=1)
            else:
                logits_1, cache = self._spec_forward(last[:, None], cache, length - 1)
                # pad to the spec shape: slots >= lim are dead (overwritten
                # by later writes, never emitted)
                t = torch.cat([targets_from(logits_1), torch.zeros((b, k), dtype=torch.int64, device=dev)], 1)
                n_acc = torch.zeros(b, dtype=torch.int64, device=dev)
            live = ~finished
            # drafted counts only rows still decoding
            drafted += (k if do_spec else 0) * live.sum()
            lim = n_acc + 1  # accepted drafts + the bonus token
            is_stop = torch.isin(t, stop) & (j < lim[:, None])
            stop_idx = torch.where(is_stop, j, k + 1).amin(dim=1)
            m = torch.minimum(lim, stop_idx + 1)
            m = torch.minimum(m, max_new - (length - prompt_len))
            new_fin = (stop_idx < lim) | (length - prompt_len + m >= max_new)
            acc += torch.where(finished, 0, n_acc).sum()
            m = torch.where(finished, 0, m)  # finished rows hold position
            if gate:
                rate = n_acc.to(torch.float32) / float(max(k, 1))
                upd = live if do_spec else torch.zeros_like(live)
                ema = torch.where(upd, (1 - self.SPEC_GATE_W) * ema + self.SPEC_GATE_W * rate, ema)
                worst = torch.where(finished | new_fin, torch.ones_like(ema), ema).amin()
                spec_on = torch.where(spec_on, worst >= self.SPEC_GATE_OFF, worst >= self.SPEC_GATE_ON)
            finished = finished | new_fin
            # all k+1 targets per row: slots beyond m are overwritten by the
            # next step's window (the same invariant as the KV writes)
            buf[rows[:, None], length[:, None] + j] = t
            length = length + m
            steps += 1
            if steps % self.SPEC_FLAG_READ_EVERY == 0:
                spec_next, done = torch.stack([spec_on, finished.all()]).tolist()  # the one host read a step
        return buf, length, steps, acc, drafted

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
        """Batched generation of equal-length prompts. Returns the generated
        ids per row (up to and including a stop token) [, logprobs]
        [, stats]: ``return_logprobs`` adds, per row, the log probability of
        each generated token under the processed sampling distribution (the
        log-softmax of process_logits' output at the drawn token), except in
        ``mode="spec"``, which refuses it, as the reference does. The token
        counts of the penalties start from the prompt's tokens; counts and
        lengths advance for finished rows too, as in the reference. ``seed``
        seeds the draws of non-greedy sampling."""
        if self.pp_mesh is not None:
            if mode == "spec":
                raise ValueError('mode="spec" is not served under a pipeline (as in the reference)')
            mode = "step"  # a step's latency is the stage hops, not the host's dispatch
        m = self.mesh
        if m is not None:
            if len(prompt_ids) % m.dp:
                raise ValueError(f"batch {len(prompt_ids)} must divide by the data axis {m.dp}")
            if mode == "spec" and m.dp > 1:
                raise ValueError("spec mode under a mesh takes dp = 1 (as in the reference)")
            if mode == "fused" and not m.capturable:
                raise ValueError(f'mode="fused" replays a CUDA graph, which cannot hold {m.backend} collectives '
                                 'on the card: use mode="step" (or an NCCL mesh)')
        if mode == "spec":
            if return_logprobs:
                raise ValueError("logprobs are not served in spec mode (as in the reference)")
            from flexq_tpu_torch.serve.speculative import generate_speculative

            return generate_speculative(self, prompt_ids, max_new_tokens=max_new_tokens, eos_id=eos_id,
                                        stop_ids=stop_ids, return_stats=return_stats, sampling=sampling, seed=seed)
        if mode not in ("fused", "step"):
            raise ValueError(f"unknown mode {mode!r}")
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
        if mode == "fused":
            dec, graph = self._fused_loop(b, sampling, eos_id, stop_ids, return_logprobs)
            for t in dec.cache:  # the kept cache starts each call as a fresh one does
                t.zero_()
            logits, _ = self.prefill_prompts(prompts, dec.cache)
            dec.reset(prompts, seed)
            out, lps = dec.fused(graph, logits, l, max_new_tokens, stats, timer)
        else:
            logits, cache = self.prefill_prompts(prompts, self.new_cache(b))
            dec = _Decoding(self, b, sampling, eos_id, stop_ids, return_logprobs)
            dec.reset(prompts, seed)
            out, lps = dec.stepwise(self, logits, cache, l, max_new_tokens, stats, timer)
        ret = [out]
        if return_logprobs:
            ret.append(lps)
        if return_stats:
            ret.append(stats)
        return ret[0] if len(ret) == 1 else tuple(ret)


class _Decoding:
    """A decode loop's sampling state (the reference's loop carry): the
    generator, the token counts [B, V] (prompt tokens counted; kept only
    when a penalty reads them), the generated length (a device counter [B])
    and the stop set. With ``cache`` (the fused loop's kept cache) also the
    fused loop's static buffers: the fed tokens [B, 1], the positions [B],
    the token and logprob columns [B, max_seq_len], the finished mask and
    the column the next step writes; ``reset`` readies them for a call."""

    def __init__(self, eng: Engine, b: int, sampling: SamplingParams, eos_id: int, stop_ids, logprobs: bool,
                 cache: Optional[Tuple] = None):
        dev = eng.device
        self.sampling, self.eos_id, self.logprobs, self.b = sampling, eos_id, logprobs, b
        self.vocab = eng.cfg.vocab_size
        self.rows = torch.arange(b, device=dev)
        self.stop = torch.as_tensor(sorted(set(stop_ids) | {eos_id}), dtype=torch.int64, device=dev)
        self.gen = None if sampling.greedy else torch.Generator(device=dev)
        self.counts = torch.zeros((b, self.vocab), dtype=torch.int32, device=dev) if _uses_counts(sampling) else None
        self.cur = torch.zeros(b, dtype=torch.int64, device=dev)
        self.cache = cache
        if cache is not None:
            self.fed = torch.zeros((b, 1), dtype=torch.int64, device=dev)
            self.pos = torch.zeros(b, dtype=torch.int64, device=dev)
            self.finished = torch.zeros(b, dtype=torch.bool, device=dev)
            self.col = torch.zeros((1, 1), dtype=torch.int64, device=dev)
            self.tokens = torch.full((b, eng.max_seq_len), -1, dtype=torch.int64, device=dev)
            self.lps = torch.zeros((b, eng.max_seq_len), dtype=torch.float32, device=dev) if logprobs else None

    def reset(self, prompts, seed: int) -> None:
        """Seed the draws, count the prompts' tokens, zero the length."""
        if self.gen is not None:
            self.gen.manual_seed(seed)
        if self.counts is not None:
            c = np.zeros((self.b, self.vocab), np.int32)
            for r, p in enumerate(prompts):
                np.add.at(c[r], np.asarray(p, np.int64), 1)
            self.counts.copy_(torch.from_numpy(c))
        self.cur.zero_()

    def draw(self, logits):
        """(next ids int64 [B], logprobs f32 [B] or None) from the step's
        logits, then the counts and the length advance for every row."""
        s = self.sampling
        proc = process_logits(logits, s, token_counts=self.counts, cur_length=self.cur if s.min_length > 0 else None,
                              eos_id=self.eos_id)
        nxt = sample(proc, s, self.gen).to(torch.int64)
        lp = torch.log_softmax(proc, dim=-1)[self.rows, nxt] if self.logprobs else None
        if self.counts is not None:
            self.counts[self.rows, nxt] += 1
        self.cur += 1
        return nxt, lp

    def record(self, nxt, lp) -> None:
        """The fused loop's bookkeeping on the device: the step's tokens
        (-1, logprobs 0, once a row finished) into the next column, the
        stop test, and the tokens fed to the next step."""
        record = ~self.finished
        col = self.col.expand(self.b, 1)
        self.tokens.scatter_(1, col, torch.where(record, nxt, -1)[:, None])
        if self.lps is not None:
            self.lps.scatter_(1, col, torch.where(record, lp, 0.0)[:, None])
        self.finished |= record & torch.isin(nxt, self.stop)
        self.fed.copy_(nxt[:, None])
        self.col += 1

    def fused(self, graph: StepGraph, logits, pos, max_new, stats, timer):
        """The reference's _loop_body: the first token drawn from the
        prefill's logits, then ``graph``'s step replayed; tokens hold -1
        (and logprobs 0) after a row finished; the host reads `finished`
        every FUSED_CHECK_EVERY steps. A capture made in this call is timed
        apart (``stats.capture_s``) and left out of ``stats.decode_s``."""
        stats.ttft_s = timer.lap()  # prefill; the first token is drawn in the loop
        had_graph = graph.captured
        self.finished.zero_()
        self.col.zero_()
        self.record(*self.draw(logits))
        self.pos.fill_(pos)
        done = 1
        while done < max_new:  # the reference's last step forward feeds nothing
            n = min(FUSED_CHECK_EVERY - done % FUSED_CHECK_EVERY, max_new - done)
            graph.run(n)
            done += n
            if done < max_new and done % FUSED_CHECK_EVERY == 0 and bool(self.finished.all()):
                break
        tok = self.tokens[:, :done].cpu().numpy()
        stats.capture_s = graph.capture_s if graph.captured and not had_graph else 0.0
        stats.decode_s = timer.lap() - stats.capture_s
        out = [[int(t) for t in row if t >= 0] for row in tok]
        stats.generated_tokens = sum(len(r) for r in out)
        lp_rows = None
        if self.lps is not None:
            lp_np = self.lps[:, :done].cpu().numpy()
            lp_rows = [[float(x) for x in lp_np[r, : len(out[r])]] for r in range(self.b)]
        return out, lp_rows

    def stepwise(self, eng: Engine, logits, cache, pos, max_new, stats, timer):
        """The host loop: each step's tokens read back, eng._decode_step
        eager."""
        b = self.b
        stop_set = set(self.stop.tolist())
        out: List[List[int]] = [[] for _ in range(b)]
        out_lps: List[List[float]] = [[] for _ in range(b)]
        finished = np.zeros(b, bool)
        for step in range(max_new):
            next_ids, lp = self.draw(logits)
            if lp is not None:
                ids_np, lp_np = torch.stack([next_ids.to(torch.float64), lp.to(torch.float64)]).tolist()
            else:
                ids_np = next_ids.tolist()
            if step == 0:
                stats.ttft_s = timer.lap()
            else:
                stats.step_times_s.append(timer.lap())
            stats.generated_tokens += int((~finished).sum())
            for row in range(b):
                if not finished[row]:
                    out[row].append(int(ids_np[row]))
                    if lp is not None:
                        out_lps[row].append(float(lp_np[row]))
                    if int(ids_np[row]) in stop_set:
                        finished[row] = True
            if finished.all() or step == max_new - 1:
                break
            logits, cache = eng._decode_step(next_ids[:, None], cache, pos)
            pos += 1
        stats.decode_s = sum(stats.step_times_s) or stats.ttft_s
        return out, (out_lps if self.logprobs else None)
