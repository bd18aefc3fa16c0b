"""Continuous batching scheduler (port of flexq_tpu/serve/scheduler.py::
BatchScheduler, single device, per-token ticks).

A fixed number of KV-cache slots each hold one request; new requests
prefill into a free slot while the other slots keep decoding. Every tick is
one decode forward over all slots with per-slot positions (``cache_pos`` a
vector): inactive slots decode garbage that is never surfaced (position 0;
in paged mode an all-zero table row, so their writes land in page 0, the
garbage page). Prefill runs at B = 1 into a scratch cache sized to the
prompt's page (or 128) bucket and is then inserted into the slot's row of
the dense cache or into freshly allocated pool pages.

Options, as in the reference: a dense or a paged KV cache (``paged``), bf16
or int8 (``kv_dtype``); chunked admission (``prefill_chunk``: one chunk per
tick, so decoding slots keep emitting while a long prompt is admitted);
recompute preemption when the pool runs dry (the youngest request re-queues
with prompt + generated and later re-prefills); prefix-page reuse
(``prefix_cache``); per-request SamplingParams and logprobs; beam search
(``beam_width > 1``: a group of beam_width slots decoding inside the same
batched tick as the other requests, its KV rows reordered by parent over the
dense cache, or its page tables over the pool, where beams share pages and
copy only the block being written when they diverge). A prefill of 64
tokens or more takes the W6A16 layer, the reference's rule here (not the
Engine's threshold).

Fused multi-step ticks (``fused_tick > 0``, the reference's ``_fused_step``):
when every active slot is a plain decode under one SamplingParams, no beam
group is in flight and no prompt is being chunked, a tick runs up to
``fused_tick`` decode steps (at most 4 while requests wait) with EOS and
each slot's budget masked on the device, and reads the [S, K] tokens (and
logprobs) back once. On the card the steps are replays of a captured CUDA
graph of one step over all ``num_slots`` rows (forward, the processed
logits, the draw, the record, the finished mask, the counts:
serve/graphs.py), one graph per (structural sampling key, counts,
logprobs), the float knobs in a static buffer (different temperatures share
a graph); on the CPU the same step runs eagerly. The per-token tick
(``fused_tick=0``) stays eager.

Under a ``mesh`` (parallel/distributed.py: one process per rank, every rank
given the same commands, as serve/replicated.py replicates them) every
forward is parallel/tp.py::forward_serve_tp over this rank's parameter
shard and its local cache: a dense cache [L, S/dp, KVH/tp, max, D] (slot i
on data rank i // (S/dp)) or, at dp = 1, a page pool of KVH/tp heads. Every
rank samples the same tokens from the gathered logits, so the host state
stays in lockstep. Admission prefills run at B = 1 on every data rank and
the slot's owner keeps the scratch. At dp > 1 a paged pool splits into one
partition a data rank (``PagePool(partitions=dp)``, the reference's
per-data-shard pools): slot i allocates from the partition of its data rank
i // (S/dp), the allocator's bookkeeping is the same on every rank, each
rank's device pool holds only its partition, and the page table goes to
the device localized. Beam groups and the prefix cache take dp = 1 (a
reorder or a reused page would cross data ranks). Fused ticks replay a
graph that holds NCCL collectives; a gloo mesh on the card takes
``fused_tick=0``.

Under a ``pp_mesh`` (parallel/pp.py, one process per stage) every forward
is parallel/pp.py::serve_step_pp over this stage's layers and its dense
cache [L/pp, S, KVH, max, D]; as in the reference the cache is dense, no
prefix cache, ``fused_tick=0``, and prompts run the W*Ax layer whatever
their length (the pipeline takes no W*A16 prefill).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flexq_tpu_torch.config import ModelConfig, QuantPolicy, require_servable
from flexq_tpu_torch.kernels.common import resolve_device
from flexq_tpu_torch.parallel.pp import stage_params
from flexq_tpu_torch.parallel.tp import cache_forward, is_sharded, shard_params
from flexq_tpu_torch.serve.beam import NEG as BEAM_NEG, reorder_rows, topk_lower_first
from flexq_tpu_torch.serve.graphs import StepGraph
from flexq_tpu_torch.serve.paged import PagePool, PageTable, PrefixRegistry
from flexq_tpu_torch.serve.sampling import (
    SamplingParams,
    dynamic_params,
    process_logits,
    process_logits_dynamic,
    sample,
    structural_key,
)

BF16_PREFILL_MIN = 64  # a prefill (or chunk) of this many tokens takes the W6A16 layer
FUSED_QUEUE_K = 4  # the most steps a fused tick takes while requests wait (the reference's)


@dataclasses.dataclass
class _Slot:
    req_id: Optional[int] = None
    pos: int = 0  # next cache position to write
    generated: List[int] = dataclasses.field(default_factory=list)
    sampling: SamplingParams = SamplingParams()
    eos_id: int = 2
    max_new: int = 64
    prompt: List[int] = dataclasses.field(default_factory=list)
    # chunked admission: phase "prefill" while the prompt is chunked into
    # the scratch cache (decode ticks skip the slot)
    phase: str = "decode"
    prefill_pos: int = 0
    bucket: int = 0
    scratch: Optional[Tuple] = None
    # tokens generated before a preemption (now inside ``prompt``)
    prior: List[int] = dataclasses.field(default_factory=list)
    want_logprobs: bool = False
    lps: List[float] = dataclasses.field(default_factory=list)
    prior_lps: List[float] = dataclasses.field(default_factory=list)
    # prefix cache (paged): reused pages, the tokens they cover, and the
    # prompt's full-page hash chain
    shared_pages: List[int] = dataclasses.field(default_factory=list)
    prefix_len: int = 0
    page_hashes: List[int] = dataclasses.field(default_factory=list)
    # one lane of a beam group (the group, keyed by req_id, samples for it)
    beam: bool = False


@dataclasses.dataclass
class _Pending:
    req_id: int
    prompt: List[int]
    sampling: SamplingParams
    max_new: int
    eos_id: int
    prior: List[int] = dataclasses.field(default_factory=list)
    want_logprobs: bool = False
    prior_lps: List[float] = dataclasses.field(default_factory=list)
    # beam search (beam_width > 1): the request takes beam_width slots
    beam_width: int = 1
    n_best: int = 1
    length_penalty: float = 1.0


@dataclasses.dataclass
class _BeamGroup:
    """Host state of one beam-search request in flight: cumulative scores,
    finished flags and histories of its k beams, which live in k slots and
    decode in the same batched tick as the other requests; after each tick
    the group reorders its slots' cache rows (or page tables) by parent."""

    req_id: int
    slots: List[int]
    k: int
    n_best: int
    eos_id: int
    max_new: int
    length_penalty: float
    scores: np.ndarray  # [k] f32 cumulative log-probs
    finished: np.ndarray  # [k] bool
    histories: List[List[int]]  # [k] token lists (pads after a finish)
    # per-beam per-token logprobs, threaded through parents like the
    # histories; a frozen beam's pad continuation adds 0.0
    want_logprobs: bool = False
    lps: List[List[float]] = dataclasses.field(default_factory=list)


class BatchScheduler:
    """Slot-based continuous batching over the quantized serve path on one
    device. ``device="cuda"`` by default (``"cpu"``: the plain versions);
    sampling draws from a ``torch.Generator`` seeded with ``seed``.

    Timing, on the host clock after the device's result is read: per
    request ``t_arrival`` / ``t_first`` (seconds, ``time.perf_counter``),
    ``tick_s``, the wall time of each decode tick (a graph capture left
    out), ``tick_steps``, the decode steps in it (1 for a per-token tick),
    and ``tick_fused``, whether it was a fused tick; ``fused_graphs`` holds
    the fused ticks' step graphs (capture seconds, replays)."""

    def __init__(
        self,
        params: Dict[str, Any],
        cfg: ModelConfig,
        policy: QuantPolicy,
        num_slots: int = 4,
        max_seq_len: int = 512,
        kv_dtype=torch.bfloat16,
        seed: int = 0,
        paged: bool = False,
        page_size: int = 128,
        num_pages: Optional[int] = None,
        prefill_chunk: Optional[int] = None,
        mesh=None,
        prefix_cache: bool = False,
        fused_tick: int = 0,
        pp_mesh=None,
        max_prefilling: Optional[int] = None,
        device="cuda",
    ):
        if fused_tick < 0:
            raise ValueError(f"fused_tick={fused_tick} must be >= 0")
        require_servable(policy)
        self.mesh = mesh
        self.pp_mesh = pp_mesh
        self._dp = 1 if mesh is None else mesh.dp
        if pp_mesh is not None:
            if mesh is not None:
                raise ValueError("pp_mesh and mesh are exclusive (as in the reference)")
            if paged or prefix_cache:
                raise ValueError("the pipelined scheduler serves a dense cache (paged=False, no prefix_cache), as the "
                                 "reference's")
            if fused_tick:
                raise ValueError(f"fused_tick={fused_tick}: the pipelined scheduler takes per-token ticks "
                                 "(fused_tick=0), as the reference's")
            self.device = pp_mesh.device
            params = stage_params(params, cfg, pp_mesh)
        elif mesh is not None:
            if num_slots % mesh.dp:
                raise ValueError(f"num_slots {num_slots} must divide by the data axis {mesh.dp}")
            if prefix_cache and mesh.dp > 1:
                raise ValueError("prefix_cache takes dp = 1 (a reused page cannot cross data partitions)")
            if fused_tick and not mesh.capturable:
                raise ValueError(f"fused_tick={fused_tick} replays a CUDA graph, which cannot hold {mesh.backend} "
                                 "collectives on the card: use fused_tick=0 (or an NCCL mesh)")
            self.device = mesh.device
            if not is_sharded(params, cfg, mesh.tp):
                params = shard_params(params, mesh)
        else:
            self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params are on {params['embed'].device}, scheduler on {self.device}")
        if max_seq_len % 128:
            raise ValueError(f"max_seq_len={max_seq_len} must be a multiple of 128")
        self.params = params
        self.cfg = cfg
        self.policy = policy
        self.num_slots = num_slots
        self.max_seq_len = max_seq_len
        self.paged = paged
        self.kv_dtype = kv_dtype
        self.quantized = kv_dtype == torch.int8
        self.prefill_chunk = prefill_chunk
        self.max_prefilling = max_prefilling
        self.registry: Optional[PrefixRegistry] = None
        if prefix_cache:
            if not paged:
                raise ValueError("prefix_cache requires paged=True")
            if self.prefill_chunk is None:
                self.prefill_chunk = page_size
            if self.prefill_chunk % page_size:
                raise ValueError("prefix_cache needs prefill_chunk to be a multiple of the page size")
            self.registry = PrefixRegistry()
        dev = self.device
        c = cfg
        kvh = c.num_kv_heads // (1 if mesh is None else mesh.tp)  # this rank's kv heads
        self._kvh = kvh
        self._layers = len(params["layers"])  # this rank's layers (a pipeline stage's L/pp)
        if paged:
            if max_seq_len % page_size:
                raise ValueError(f"max_seq_len {max_seq_len} must be a multiple of page_size {page_size}")
            if num_pages is None:
                num_pages = num_slots * (max_seq_len // page_size) + self._dp
            num_pages += (-num_pages) % self._dp  # equal partitions, one a data rank
            self.pool = PagePool(self._layers, num_pages, kvh, page_size, c.head_dim, dtype=kv_dtype, device=dev,
                                 partitions=self._dp, partition=None if self._dp == 1 else mesh.data_index)
            self.ptable = PageTable(num_slots, max_seq_len // page_size)
            # local page 0 of every partition is its garbage page: inactive
            # slots (an all-zero table row) decode junk into it without
            # touching live pages
            for d in range(self._dp):
                if self.pool.alloc(1, part=d) != [d * self.pool.pages_per_partition]:
                    raise AssertionError("each partition's first page must be its first allocation")
        else:
            shape = (self._layers, num_slots // self._dp, kvh, max_seq_len, c.head_dim)
            self.kv = tuple(torch.zeros(shape, dtype=kv_dtype, device=dev) for _ in "kv")
            if self.quantized:
                self.kv += tuple(torch.zeros(shape[:-1], dtype=torch.float32, device=dev) for _ in "kv")
        self.slots = [_Slot() for _ in range(num_slots)]
        self.pending: Deque[_Pending] = deque()
        self.done: Dict[int, List[int]] = {}
        self.done_logprobs: Dict[int, List[float]] = {}
        # beam search: req_id -> group in flight; done_nbest: req_id -> the
        # ranked [(tokens, length-penalized score, logprobs or None)]
        self.beam_groups: Dict[int, _BeamGroup] = {}
        self.done_nbest: Dict[int, List[Tuple[List[int], float, Optional[List[float]]]]] = {}
        self.last_tokens = torch.zeros((num_slots, 1), dtype=torch.int64, device=dev)
        self._req_counter = itertools.count()
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self.preemptions = 0
        self.t_arrival: Dict[int, float] = {}
        self.t_first: Dict[int, float] = {}
        self.tick_s: List[float] = []
        self.tick_steps: List[int] = []
        self.tick_fused: List[bool] = []
        # fused multi-step ticks: 0 disables (exact per-token granularity)
        self.fused_tick = int(fused_tick)
        self.fused_graphs: Dict[Any, StepGraph] = {}
        self._fz: Optional[_FusedState] = None

    # ---- forward pieces --------------------------------------------------
    def _forward(self, ids, cache, positions, cache_pos, table=None, prefill_bf16=False, last_only=False):
        return cache_forward(self.params, self.cfg, self.policy, self.mesh or self.pp_mesh, self.device, ids, cache,
                             positions, cache_pos, prefill_bf16=prefill_bf16, page_table=table, last_only=last_only)

    def _step_fn(self, ids, cache, positions):
        """One decode step over all slots, per-slot positions [S] (dense)."""
        logits, _ = self._forward(ids, cache, positions[:, None], positions)
        return logits[:, 0]

    def _step_paged_fn(self, ids, cache, positions, table):
        """The decode step over the page pool, through the page table."""
        logits, _ = self._forward(ids, cache, positions[:, None], positions, table=table)
        return logits[:, 0]

    def _new_scratch(self, bucket: int) -> Tuple:
        """A zeroed B=1 scratch cache tuple sized to the prompt bucket."""
        c = self.cfg
        shape = (self._layers, 1, self._kvh, bucket, c.head_dim)
        cache = tuple(torch.zeros(shape, dtype=self.kv_dtype, device=self.device) for _ in "kv")
        if self.quantized:
            cache += tuple(torch.zeros(shape[:-1], dtype=torch.float32, device=self.device) for _ in "kv")
        return cache

    def _ids(self, tokens: Sequence[int]) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens, np.int64)[None], device=self.device)

    def _prefill_one(self, prompt: List[int]):
        """B=1 prefill -> (last logits [1, V], scratch cache). The scratch is
        the prompt rounded up to a page (or 128), not max_seq_len."""
        l = len(prompt)
        unit = self.pool.page_size if self.paged else 128
        scratch = self._new_scratch(-(-l // unit) * unit)
        logits, kv = self._forward(self._ids(prompt), scratch, None, 0,
                                   prefill_bf16=l >= BF16_PREFILL_MIN, last_only=True)
        return logits[:, -1], kv

    def _prefill_chunk(self, ids: torch.Tensor, cache: Tuple, start: int):
        """One chunk of a chunked admission (the reference's ``_chunk_fn``):
        queries at start..start+C-1 attend over scratch[0 : start+C]."""
        b, c = ids.shape
        positions = start + torch.arange(c, device=self.device).expand(b, c)
        return self._forward(ids, cache, positions, start, prefill_bf16=c >= BF16_PREFILL_MIN)

    def _advance_prefill(self, i: int) -> None:
        """Run ONE chunk of slot i's prompt; on the last, insert the scratch
        into the cache and emit the first token."""
        slot = self.slots[i]
        chunk, start, plen = self.prefill_chunk, slot.prefill_pos, len(slot.prompt)
        padded = slot.prompt + [0] * (slot.bucket - plen)
        logits, slot.scratch = self._prefill_chunk(self._ids(padded[start : start + chunk]), slot.scratch, start)
        slot.prefill_pos = start + chunk
        if slot.prefill_pos >= plen:
            # the padding queries (positions >= plen) produced garbage logits
            # and K/V past plen: neither is read (insert copies whole pages,
            # whose tail past plen decode overwrites before attending to it)
            self._insert_scratch(i, slot.scratch, plen, slot=slot)
            slot.scratch = None
            slot.phase = "decode"
            slot.pos = plen
            self._record(i, slot, self._sample_one(logits[0, plen - 1 - start], slot))

    # ---- pages -----------------------------------------------------------
    def _part_of(self, i: int) -> int:
        """The pool partition (data rank) of slot i: slots split over the
        data ranks contiguously."""
        return i // (self.num_slots // self._dp)

    def _alloc(self, n: int, part: int = 0) -> List[int]:
        """Pool alloc from partition ``part`` that reclaims retained prefix
        pages under pressure."""
        if self.registry is not None and self.pool.free_in(part) < n:
            self.pool.free(self.registry.evict(n - self.pool.free_in(part)))
        return self.pool.alloc(n, part)

    def _release_slot_pages(self, i: int) -> None:
        s = self.slots[i]
        pages = [p for p in self.ptable.release(i) if p != 0]
        if s.phase == "prefill" and s.shared_pages:
            pages += s.shared_pages  # acquired, not yet in the table
        if self.registry is not None:
            pages = self.registry.release(pages)
        self.pool.free(pages)

    def _preempt(self, exclude: Optional[int] = None, part: Optional[int] = None) -> bool:
        """Evict the youngest other request (of partition ``part``'s slots,
        where given: its pool ran dry) back to the head of the queue
        (recompute preemption): its pages free now; on re-admission it
        prefills prompt + generated, and ``prior`` is prepended to its
        output."""
        # beam lanes are never preempted: re-prefilling one lane cannot
        # rebuild the group's diverged KV
        cands = [i for i, s in enumerate(self.slots) if i != exclude and s.req_id is not None and not s.beam
                 and (part is None or self._part_of(i) == part)]
        if not cands:
            return False
        i = max(cands, key=lambda j: self.slots[j].req_id)
        s = self.slots[i]
        self._release_slot_pages(i)
        self.pending.appendleft(_Pending(
            s.req_id, s.prompt + s.generated, s.sampling, s.max_new, s.eos_id, prior=s.prior + s.generated,
            want_logprobs=s.want_logprobs, prior_lps=s.prior_lps + s.lps,
        ))
        self.slots[i] = _Slot()
        self.preemptions += 1
        return True

    def _insert_scratch(self, i: int, kv1: Tuple, plen: int, slot: Optional[_Slot] = None) -> None:
        """Copy a B=1 scratch cache's positions [prefix_len, plen) into slot
        i's pages (prefix pages are mapped without a copy), or its
        positions [0, plen) into row i of the dense cache."""
        if not self.paged:
            per = self.num_slots // self._dp  # slot i is row i % per of data rank i // per
            if self.mesh is None or i // per == self.mesh.data_index:
                for dst, src in zip(self.kv, kv1):
                    dst[:, i % per, :, :plen] = src[:, 0, :, :plen]
            return
        shared = slot.shared_pages if slot is not None else []
        pfx = slot.prefix_len if slot is not None else 0
        part = self._part_of(i)
        while True:
            try:
                new_pages = self._alloc(self.pool.pages_for(plen) - len(shared), part)
                break
            except MemoryError:
                if not self._preempt(exclude=i, part=part):
                    raise
        if self.pool.partition in (None, part):  # the slot's data rank holds its pages
            region = [x[:, :, :, pfx:] for x in kv1]
            self.pool.insert_prefill(new_pages, region[0], region[1], plen - pfx, *region[2:])
        self.ptable.assign(i, shared + new_pages)
        if self.registry is not None and slot is not None:
            # publish the freshly written FULL prompt pages for reuse
            full = plen // self.pool.page_size
            for j, page in enumerate(new_pages):
                if len(shared) + j < full:
                    self.registry.register(slot.page_hashes[len(shared) + j], page)

    # ---- public API ------------------------------------------------------
    def add_request(
        self,
        prompt: Sequence[int],
        sampling: SamplingParams = SamplingParams(),
        max_new_tokens: int = 64,
        eos_id: int = 2,
        logprobs: bool = False,
        beam_width: int = 1,
        n_best: int = 1,
        length_penalty: float = 1.0,
    ) -> int:
        """Queue a request; returns its id. The parameters are the
        reference's. ``beam_width > 1`` runs the request as beam search over
        beam_width slots (its sampling parameters are not read): the best
        hypothesis is its result, and the ranked ``n_best`` land in
        ``done_nbest`` as (tokens, score, logprobs or None)."""
        if len(prompt) + max_new_tokens > self.max_seq_len:
            raise ValueError(f"prompt {len(prompt)} + {max_new_tokens} new tokens exceed max_seq_len {self.max_seq_len}")
        if beam_width > self.num_slots:
            raise ValueError(f"beam_width {beam_width} exceeds the {self.num_slots} slots")
        if beam_width > 1 and self._dp > 1:
            raise ValueError("beam groups under a mesh take dp = 1 (a reorder would cross data ranks)")
        if beam_width > 1 and self.paged:
            need = self._beam_need(len(prompt), max_new_tokens, beam_width)
            if need > self.pool.num_pages - 1:  # page 0 is the garbage page
                # the admission budget could never be met: refuse rather than
                # wait for pages that cannot come
                raise ValueError(f"a {beam_width}-beam request needs up to {need} pages; the pool has "
                                 f"{self.pool.num_pages - 1}")
        req_id = next(self._req_counter)
        self.t_arrival[req_id] = time.perf_counter()
        self.pending.append(_Pending(req_id, list(prompt), sampling, max_new_tokens, eos_id,
                                     want_logprobs=logprobs, beam_width=beam_width, n_best=n_best,
                                     length_penalty=length_penalty))
        return req_id

    @property
    def has_work(self) -> bool:
        return bool(self.pending) or any(s.req_id is not None for s in self.slots)

    def cancel(self, req_id: int) -> Optional[List[int]]:
        """Best-effort early stop: a pending request is dropped and its prior
        tokens returned; an in-flight one (or beam group) has its budget
        clamped so it finishes on its next token (returns None)."""
        for p in list(self.pending):
            if p.req_id == req_id:
                self.pending.remove(p)
                return list(p.prior)
        g = self.beam_groups.get(req_id)
        if g is not None:
            g.max_new = max(1, len(g.histories[0]))
            return None
        for s in self.slots:
            if s.req_id == req_id:
                s.max_new = max(1, len(s.prior) + len(s.generated))
        return None

    def _admit(self) -> None:
        # a beam request at the head of the queue takes beam_width slots at
        # once; FIFO holds: while too few slots are free, the requests
        # behind it wait too
        while self.pending and self.pending[0].beam_width > 1:
            req = self.pending[0]
            free = [i for i, s in enumerate(self.slots) if s.req_id is None]
            if len(free) < req.beam_width:
                return
            if self.paged and self._beam_pages_short(req):
                return
            self._admit_beam(self.pending.popleft(), free)
        for i, slot in enumerate(self.slots):
            if slot.req_id is not None or not self.pending:
                continue
            if self.pending[0].beam_width > 1:
                break  # FIFO: a beam request is next; it admits next tick
            req = self.pending.popleft()
            if self.max_prefilling is not None and self.prefill_chunk and len(req.prompt) > self.prefill_chunk:
                n_pref = sum(1 for s in self.slots if s.req_id is not None and s.phase == "prefill")
                if n_pref >= self.max_prefilling:
                    self.pending.appendleft(req)  # bounded in-flight scratch caches
                    break
            if self.paged:
                avail = self.pool.free_in(self._part_of(i)) + (
                    self.registry.reclaimable if self.registry is not None else 0)
                # charge the REMAINING budget: a preempted request re-queues
                # with prompt + generated and an unchanged max_new
                if avail < self.pool.pages_for(len(req.prompt) + req.max_new - len(req.prior)):
                    self.pending.appendleft(req)
                    break
            plen = len(req.prompt)
            self.slots[i] = slot = _Slot(
                req_id=req.req_id, sampling=req.sampling, eos_id=req.eos_id, max_new=req.max_new,
                prompt=req.prompt, prior=req.prior, want_logprobs=req.want_logprobs, prior_lps=req.prior_lps,
            )
            if self.registry is not None:
                ps = self.pool.page_size
                slot.page_hashes = self.registry.hash_chain(req.prompt, ps)
                matched = self.registry.match(slot.page_hashes)
                # page-granular reuse; leave >= 1 token to compute (its
                # logits give the first token)
                m_tok = min(len(matched) * ps, (plen - 1) // ps * ps)
                if m_tok > 0:
                    slot.shared_pages = matched[: m_tok // ps]
                    slot.prefix_len = m_tok
                    self.registry.acquire(slot.shared_pages)
                self.registry.account_miss(len(slot.page_hashes) - len(slot.shared_pages))
            if self.prefill_chunk and plen - slot.prefix_len > 0 and (plen > self.prefill_chunk or slot.prefix_len):
                # chunked admission: the compute runs in step() ticks, chunks
                # starting at prefix_len (page-, not chunk-aligned); the
                # bucket covers the last chunk's write, 128- or page-aligned
                c = self.prefill_chunk
                pfx = slot.prefix_len
                unit = self.pool.page_size if self.paged else 128
                slot.phase = "prefill"
                slot.prefill_pos = pfx
                slot.bucket = -(-(pfx + -(-(plen - pfx) // c) * c) // unit) * unit
                slot.scratch = self._new_scratch(slot.bucket)
                if slot.shared_pages:
                    slot.scratch = self.pool.gather_prefix(slot.shared_pages, slot.scratch)
                continue
            logits, kv1 = self._prefill_one(req.prompt)
            self._insert_scratch(i, kv1, plen, slot=slot)
            slot.pos = plen
            self._record(i, slot, self._sample_one(logits[0], slot))

    # ---- beam search -----------------------------------------------------
    BEAM_PAD = 0  # a frozen beam's continuation token (serve/beam.py's pad_id)

    def _beam_need(self, plen: int, max_new: int, k: int) -> int:
        """A paged beam group's worst case: the shared prompt pages and each
        beam's private generation span (a straddled partial block
        included)."""
        ps = self.pool.page_size
        return self.pool.pages_for(plen) + k * ((plen + max_new - 1) // ps - plen // ps + 1)

    def _beam_pages_short(self, req: _Pending) -> bool:
        """The paged beam admission's budget: the request's worst case plus
        the pages every group in flight may still take (beams are never
        preempted, so admitting without reserving them can deadlock the
        pool)."""
        ps = self.pool.page_size
        need = self._beam_need(len(req.prompt), req.max_new, req.beam_width)
        for g in self.beam_groups.values():
            for i in g.slots:
                s = self.slots[i]
                need += max(0, -(-(len(s.prompt) + s.max_new) // ps) - int(self.ptable.num_blocks[i]))
        avail = self.pool.free_pages + (self.registry.reclaimable if self.registry is not None else 0)
        return avail < need

    def _admit_beam(self, req: _Pending, free: List[int]) -> None:
        """Prefill once, seed beam_width slots with the prompt's KV and
        expand the first top-k tokens. Paged, the prompt pages are written
        once and mapped into every beam's table (kept out of the prefix
        registry: beams' contents leave the prompt's hash chain); the block
        the first decode write lands in is made private to each beam first."""
        k = req.beam_width
        idx = free[:k]
        plen = len(req.prompt)
        logits, kv1 = self._prefill_one(req.prompt)
        if self.paged:
            while True:
                try:
                    pages = self._alloc(self.pool.pages_for(plen))
                    break
                except MemoryError:
                    if not self._preempt():
                        raise
            self.pool.insert_prefill(pages, kv1[0], kv1[1], plen, *kv1[2:])
            for i in idx:
                self.ptable.assign(i, pages)
        for i in idx:
            if not self.paged:
                self._insert_scratch(i, kv1, plen)
            self.slots[i] = _Slot(req_id=req.req_id, beam=True, pos=plen, prompt=req.prompt, max_new=req.max_new,
                                  eos_id=req.eos_id)
        scores, first = topk_lower_first(torch.log_softmax(logits[0].to(torch.float32), dim=-1), k)
        self.last_tokens[torch.as_tensor(idx, device=self.device), 0] = first
        first_l, scores_l = torch.stack([first.to(torch.float64), scores.to(torch.float64)]).tolist()
        first_np = np.asarray(first_l, np.int64)
        scores_np = np.asarray(scores_l, np.float32)
        g = _BeamGroup(req_id=req.req_id, slots=idx, k=k, n_best=req.n_best, eos_id=req.eos_id,
                       max_new=req.max_new, length_penalty=req.length_penalty, scores=scores_np,
                       finished=first_np == req.eos_id, histories=[[int(t)] for t in first_np],
                       want_logprobs=req.want_logprobs, lps=[[float(x)] for x in scores_np])
        self.beam_groups[req.req_id] = g
        self.t_first.setdefault(req.req_id, time.perf_counter())
        if self.paged:
            self._privatize_beam_blocks(g, plen)  # the first decode write lands at plen
        self._maybe_finish_beam(g)

    def _beam_advance(self, g: _BeamGroup, logits: torch.Tensor) -> None:
        """One beam step off the tick's logits (serve/beam.py's _beam_step):
        top-k over k*V with frozen beams' pad continuations, one host read
        of the winners, histories re-threaded through their parents, and the
        cache rows (dense) or page tables (paged) reordered by parent."""
        rows = torch.as_tensor(g.slots, device=self.device)
        logp = torch.log_softmax(logits[rows].to(torch.float32), dim=-1)
        v = logp.shape[-1]
        frozen = torch.full((v,), BEAM_NEG, dtype=torch.float32, device=self.device)
        frozen[self.BEAM_PAD] = 0.0
        fin = torch.as_tensor(g.finished, device=self.device)
        logp = torch.where(fin[:, None], frozen, logp)
        total = torch.as_tensor(g.scores, device=self.device)[:, None] + logp
        top_scores, top_idx = topk_lower_first(total.reshape(-1), g.k)
        idx_l, sc_l = torch.stack([top_idx.to(torch.float64), top_scores.to(torch.float64)]).tolist()  # one host read
        parent = [int(t) // v for t in idx_l]
        token = [int(t) % v for t in idx_l]
        new_scores = np.asarray(sc_l, np.float32)
        g.histories = [g.histories[p] + [t] for p, t in zip(parent, token)]
        # a token's logprob is the score's step from its parent (0.0 for a pad)
        g.lps = [g.lps[p] + [float(new_scores[j]) - float(g.scores[p])] for j, p in enumerate(parent)]
        g.finished = np.asarray([bool(g.finished[p]) or t == g.eos_id for p, t in zip(parent, token)])
        g.scores = new_scores
        if self.paged:
            self._reorder_beam_paged(g, parent)
        else:
            # the tick wrote position pos: positions [0, pos] are the rows' KV
            reorder_rows(self.kv, [g.slots[p] for p in parent], g.slots, self.slots[g.slots[0]].pos + 1)
        self.last_tokens[rows, 0] = torch.as_tensor(token, device=self.device)
        for i in g.slots:
            self.slots[i].pos += 1
        if self.paged:
            self._privatize_beam_blocks(g, self.slots[g.slots[0]].pos)  # the next write's position
        self._maybe_finish_beam(g)

    def _beam_page_rc(self, g: _BeamGroup) -> Dict[int, int]:
        """How many of the group's slots map each page (page 0, the garbage
        page, left out); the page tables are the authority."""
        rc: Dict[int, int] = {}
        for i in g.slots:
            for p in self.ptable.table[i, : self.ptable.num_blocks[i]]:
                if p:
                    rc[int(p)] = rc.get(int(p), 0) + 1
        return rc

    def _reorder_beam_paged(self, g: _BeamGroup, parent: List[int]) -> None:
        """Beam j adopts its parent's page table, sharing the parent's pages
        (no KV is copied here; `_privatize_beam_blocks` handles divergence).
        Pages no beam maps any more go back to the pool."""
        if parent == list(range(g.k)):
            return
        before = self._beam_page_rc(g)
        olds = {i: (self.ptable.table[i].copy(), int(self.ptable.num_blocks[i])) for i in g.slots}
        for j, p in enumerate(parent):
            src, dst = g.slots[p], g.slots[j]
            self.ptable.table[dst] = olds[src][0]
            self.ptable.num_blocks[dst] = olds[src][1]
        after = self._beam_page_rc(g)
        self.pool.free([p for p in before if p not in after])

    def _privatize_beam_blocks(self, g: _BeamGroup, next_pos: int) -> None:
        """Copy-on-divergence: make the block the next decode write (at
        ``next_pos``) lands in private to every beam that shares it, one
        page copied across all layers (K, V and an int8 pool's scales). At
        a block boundary nothing is needed: the tick's allocator appends a
        fresh page per beam. With no page left for a copy the group
        finishes now with its hypotheses so far: another step would have
        diverged beams write one shared page."""
        if all(g.finished) or len(g.histories[0]) >= g.max_new:
            return  # the group completes before another write
        blk = next_pos // self.pool.page_size
        rc = self._beam_page_rc(g)
        src, dst = [], []
        aborted = False
        try:
            for i in g.slots:
                if blk >= int(self.ptable.num_blocks[i]):
                    continue  # a boundary: the allocator appends a private page
                p = int(self.ptable.table[i, blk])
                if p == 0 or rc.get(p, 0) <= 1:
                    continue
                while True:
                    try:
                        newp = self._alloc(1)[0]
                        break
                    except MemoryError:
                        if not self._preempt():
                            aborted = True
                            break
                if aborted:
                    break
                rc[p] -= 1
                rc[newp] = 1
                self.ptable.table[i, blk] = newp
                src.append(p)
                dst.append(newp)
        finally:
            # copy also when aborting: the tables already map the new pages
            self.pool.copy_pages(src, dst)
        if aborted:
            g.max_new = max(1, len(g.histories[0]))
            self._maybe_finish_beam(g)

    def shed_beam(self) -> bool:
        """Finish the youngest beam group now with its hypotheses so far
        (the pool-exhaustion escape when no preemptible slot is left);
        False when no group is in flight."""
        if not self.beam_groups:
            return False
        g = max(self.beam_groups.values(), key=lambda x: x.req_id)
        g.max_new = max(1, len(g.histories[0]))
        self._maybe_finish_beam(g)
        return True

    def _maybe_finish_beam(self, g: _BeamGroup) -> None:
        """Complete the group when every beam finished or the budget is
        spent: hypotheses cut after eos, ranked by the GNMT length-penalized
        score; its slots and pages (each once) are released."""
        if not (all(g.finished) or len(g.histories[0]) >= g.max_new):
            return
        hyps = []
        for j in range(g.k):
            toks = list(g.histories[j])
            if g.eos_id in toks:
                toks = toks[: toks.index(g.eos_id) + 1]
            norm = ((5.0 + max(len(toks), 1)) / 6.0) ** g.length_penalty
            hyps.append((toks, float(g.scores[j]) / norm, g.lps[j][: len(toks)] if g.want_logprobs else None))
        hyps.sort(key=lambda h: -h[1])
        self.done[g.req_id] = hyps[0][0]
        self.done_nbest[g.req_id] = hyps[: max(g.n_best, 1)]
        if g.want_logprobs:
            self.done_logprobs[g.req_id] = hyps[0][2]
        if self.paged:
            freed = set(self._beam_page_rc(g))
            for i in g.slots:
                self.ptable.release(i)
            self.pool.free(freed)
        for i in g.slots:
            self.slots[i] = _Slot()
        del self.beam_groups[g.req_id]

    # ---- sampling --------------------------------------------------------
    def _counts(self, slots: List[_Slot]) -> torch.Tensor:
        """Token counts [len(slots), V] over each slot's prompt + generated
        (the penalties' input)."""
        c = np.zeros((len(slots), self.cfg.vocab_size), np.int32)
        for j, s in enumerate(slots):
            np.add.at(c[j], np.asarray(s.prompt + s.generated, np.int64), 1)
        return torch.from_numpy(c).to(self.device)

    def _sample_batch(self, idx: List[int], logits: torch.Tensor) -> List[Tuple[int, Optional[float]]]:
        """Sample the given slots' next tokens: one batched computation per
        SamplingParams group, and ONE host read of every group's tokens and
        logprobs together."""
        if not idx:
            return []
        groups: Dict[Any, List[int]] = {}
        for i in idx:
            groups.setdefault(self.slots[i].sampling, []).append(i)
        order, parts = [], []
        for sp, members in groups.items():
            use_counts = sp.repetition_penalty != 1.0 or sp.presence_penalty != 0.0 or sp.frequency_penalty != 0.0
            rows = torch.as_tensor(members, device=self.device)
            eos = torch.as_tensor([self.slots[i].eos_id for i in members], device=self.device)
            gen0 = torch.as_tensor([len(self.slots[i].prior) + len(self.slots[i].generated) for i in members],
                                   device=self.device)
            proc = process_logits_dynamic(
                logits[rows], dynamic_params(sp, self.device), top_k=sp.top_k, use_top_p=sp.top_p < 1.0,
                token_counts=self._counts([self.slots[i] for i in members]) if use_counts else None, cur_length=gen0, eos_ids=eos,
            )
            toks = sample(proc, sp, self.generator).to(torch.int64)
            lp = torch.log_softmax(proc, dim=-1).gather(-1, toks[:, None])[:, 0]
            order += members
            parts.append(torch.stack([toks.to(torch.float64), lp.to(torch.float64)]))
        toks, lps = torch.cat(parts, dim=1).tolist()
        out = {i: (int(t), float(l) if self.slots[i].want_logprobs else None) for i, t, l in zip(order, toks, lps)}
        return [out[i] for i in idx]

    def _sample_one(self, logits_row: torch.Tensor, slot: _Slot) -> int:
        """The first token of a request, from its prefill logits [V]."""
        # after a preemption the earlier tokens sit in slot.prompt, but count
        # as generated for the min-length and eos gates
        cur = len(slot.prior) + len(slot.generated)
        proc = process_logits(
            logits_row[None], slot.sampling, token_counts=self._counts([slot]),
            cur_length=torch.tensor([cur], device=self.device), eos_id=slot.eos_id,
        )
        tok = sample(proc, slot.sampling, self.generator)[0].to(torch.int64)
        if slot.want_logprobs:
            lp = torch.log_softmax(proc, dim=-1)[0, tok]
            t, lp = torch.stack([tok.to(torch.float64), lp.to(torch.float64)]).tolist()  # one host read
            slot.lps.append(lp)
            return int(t)
        return int(tok)

    def _record(self, i: int, slot: _Slot, tok: int) -> None:
        slot.generated.append(tok)
        self.last_tokens[i, 0] = tok
        self._first_token(slot)
        self._finish_check(i, slot, tok)

    def _first_token(self, slot: _Slot) -> None:
        if slot.req_id not in self.t_first:
            self.t_first[slot.req_id] = time.perf_counter()

    def _finish_check(self, i: int, slot: _Slot, tok: int) -> None:
        """Complete slot i if ``tok`` (already appended) ends its request."""
        if tok != slot.eos_id and len(slot.prior) + len(slot.generated) < slot.max_new:
            return
        self.done[slot.req_id] = slot.prior + slot.generated
        if slot.want_logprobs:
            self.done_logprobs[slot.req_id] = slot.prior_lps + slot.lps
        if self.paged:
            if self.registry is not None:
                # publish every full page of prompt + generated (a later
                # prompt that includes this turn's reply reuses them)
                hashes = self.registry.hash_chain(slot.prompt + slot.generated, self.pool.page_size)
                for blk, h in enumerate(hashes[: int(self.ptable.num_blocks[i])]):
                    page = int(self.ptable.table[i, blk])
                    if page and page not in self.registry.page_hash:
                        self.registry.register(h, page)
            self._release_slot_pages(i)
        self.slots[i] = _Slot()

    # ---- the tick --------------------------------------------------------
    def _grow_pages(self, active: List[int]) -> List[int]:
        """Give every decoding slot the page its next write lands in,
        preempting the youngest request when the pool is dry; returns the
        slots still decoding."""
        ps = self.pool.page_size
        for i in active:
            if self.slots[i].req_id is None:
                continue  # preempted by an earlier slot's allocation
            needed = self.slots[i].pos // ps + 1
            part = self._part_of(i)
            while self.ptable.num_blocks[i] < needed:
                try:
                    page = self._alloc(1, part)[0]
                except MemoryError:
                    # the youngest request of the partition yields, possibly this very slot
                    if not self._preempt(part=part):
                        raise
                    if self.slots[i].req_id is None:
                        break
                    continue
                self.ptable.append(i, page)
        return [i for i in active if self.slots[i].req_id is not None and self.slots[i].phase == "decode"]

    def step(self) -> Dict[int, List[int]]:
        """Admit pending requests, run at most one prompt chunk and one decode
        tick, and return the requests that finished."""
        self._admit()
        prefilling = [i for i, s in enumerate(self.slots) if s.req_id is not None and s.phase == "prefill"]
        if prefilling:
            self._advance_prefill(min(prefilling, key=lambda i: self.slots[i].req_id))
        active = [i for i, s in enumerate(self.slots) if s.req_id is not None and s.phase == "decode"]
        if active and not prefilling and self._fusible(active):
            # prefilling slots force the per-token tick, so admission stays
            # one chunk a tick
            self._fused_step(active)
            active = []
        if active and self.paged:
            active = self._grow_pages(active)
        if active:
            t0 = time.perf_counter()
            positions = torch.as_tensor(
                [s.pos if s.req_id is not None and s.phase == "decode" else 0 for s in self.slots],
                dtype=torch.int64, device=self.device,
            )
            if self.paged:
                logits = self._step_paged_fn(self.last_tokens, self.pool.state(), positions,
                                             self.ptable.to_device(self.device, self.pool.localize))
            else:
                logits = self._step_fn(self.last_tokens, self.kv, positions)
            # beam groups take their slots' rows jointly (top-k over k*V and
            # the reorder); the other slots sample in one batch per group
            for g in list(self.beam_groups.values()):
                self._beam_advance(g, logits)
            plain = [i for i in active if not self.slots[i].beam and self.slots[i].req_id is not None]
            results = self._sample_batch(plain, logits)
            for i, (tok, lp) in zip(plain, results):
                slot = self.slots[i]
                slot.pos += 1
                if lp is not None:
                    slot.lps.append(lp)
                slot.generated.append(tok)
                self._finish_check(i, slot, tok)
            if plain:  # one batched last_tokens update
                self.last_tokens[torch.as_tensor(plain, device=self.device), 0] = torch.as_tensor(
                    [tok for tok, _ in results], device=self.device)
            self.tick_s.append(time.perf_counter() - t0)
            self.tick_steps.append(1)
            self.tick_fused.append(False)
        finished, self.done = self.done, {}
        return finished

    # ---- fused multi-step ticks ------------------------------------------
    def _fusible(self, active: List[int]) -> bool:
        """The fused tick applies when every active slot is a plain decode
        with one shared SamplingParams and no beam group is in flight."""
        if self.fused_tick < 1 or self.beam_groups:
            return False
        s0 = self.slots[active[0]].sampling
        return all(self.slots[i].sampling == s0 for i in active[1:])

    def _fused_graph(self, sampling: SamplingParams, use_counts: bool, logprobs: bool) -> StepGraph:
        """The step graph of one (structural sampling key, counts, logprobs):
        made on first use, captured on its first step on the card."""
        key = (structural_key(sampling), use_counts, logprobs)
        g = self.fused_graphs.get(key)
        if g is None:
            if self._fz is None:
                self._fz = _FusedState(self)
            g = StepGraph(self._fz.step_fn(sampling, use_counts, logprobs), self.device,
                          generator=None if sampling.greedy else self.generator, guard=self._fz.live)
            self.fused_graphs[key] = g
        return g

    def _fused_step(self, active: List[int]) -> None:
        """Up to ``fused_tick`` decode steps in one tick (the reference's
        ``_fused_step``): at most FUSED_QUEUE_K while requests wait, so a
        freed slot admits within that many steps; paged, every page the
        steps may write is allocated first (preempting as ``_grow_pages``
        does). The steps stop early only for the slots' budgets, known on
        the host; EOS and the budgets are masked per slot on the device, and
        the tokens (and logprobs) are read back once."""
        k_steps = self.fused_tick
        if self.pending and k_steps > FUSED_QUEUE_K:
            k_steps = FUSED_QUEUE_K
        if self.paged:
            # a slot that finishes early wastes at most the pages of its
            # last K writes, reclaimed when it completes
            ps, max_blocks = self.pool.page_size, self.ptable.table.shape[1]
            for i in active:
                if self.slots[i].req_id is None:
                    continue  # preempted by an earlier slot's allocation
                needed = min((self.slots[i].pos + k_steps - 1) // ps + 1, max_blocks)
                part = self._part_of(i)
                while self.ptable.num_blocks[i] < needed:
                    try:
                        page = self._alloc(1, part)[0]
                    except MemoryError:
                        if not self._preempt(part=part):
                            raise
                        if self.slots[i].req_id is None:
                            break
                        continue
                    self.ptable.append(i, page)
            active = [i for i in active if self.slots[i].req_id is not None and self.slots[i].phase == "decode"]
            if not active:
                return
        sp = self.slots[active[0]].sampling
        use_counts = sp.repetition_penalty != 1.0 or sp.presence_penalty != 0.0 or sp.frequency_penalty != 0.0
        logprobs = any(self.slots[i].want_logprobs for i in active)
        g = self._fused_graph(sp, use_counts, logprobs)
        fz = self._fz
        t0 = time.perf_counter()
        steps = fz.load(self, active, sp, use_counts, k_steps)
        had_graph = g.captured
        g.run(steps)
        tok = fz.tokens[:, :steps]
        if logprobs:  # one host read of the tokens and their logprobs
            tok_l, lp_l = torch.stack([tok.to(torch.float64), fz.lps[:, :steps].to(torch.float64)]).tolist()
        else:
            tok_l, lp_l = tok.tolist(), None
        # a capture made in this tick is the graph's capture_s, not tick time
        self.tick_s.append(time.perf_counter() - t0 - (g.capture_s if g.captured and not had_graph else 0.0))
        self.tick_steps.append(steps)
        self.tick_fused.append(True)
        for i in active:
            slot = self.slots[i]
            for j in range(steps):
                t = int(tok_l[i][j])
                if t < 0 or self.slots[i] is not slot:
                    break  # masked on the device, or _finish_check freed the slot
                slot.pos += 1
                slot.generated.append(t)
                if slot.want_logprobs:
                    slot.lps.append(float(lp_l[i][j]))
                self._finish_check(i, slot, t)

    def run(self) -> Dict[int, List[int]]:
        """Drain all requests; returns {req_id: generated tokens}."""
        out: Dict[int, List[int]] = {}
        while self.has_work:
            out.update(self.step())
        return out


class _FusedState:
    """The fused ticks' static buffers over all S slots (made once a
    scheduler; the graphs read and write only these, the cache, the page
    table's device copy and ``last_tokens``, and hold no reference to the
    scheduler): ``state`` int64 [6, S] (positions, eos ids, budgets left,
    tokens generated before the tick, tokens recorded in it, finished),
    ``dyn`` the float knobs f32 [6], ``counts`` int32 [S, V] (made when a
    penalty first reads them), ``tokens`` / ``lps`` [S, fused_tick] and
    ``col``, the column the next step writes."""

    def __init__(self, sched: "BatchScheduler"):
        dev, s = sched.device, sched.num_slots
        self.params, self.cfg, self.policy, self.device = sched.params, sched.cfg, sched.policy, dev
        self.mesh = sched.mesh
        self.paged = sched.paged
        self.pool, self.kv, self.ptable = (sched.pool, None, sched.ptable) if sched.paged else (None, sched.kv, None)
        self.last_tokens, self.generator = sched.last_tokens, sched.generator
        self.num_slots = s
        self.rows = torch.arange(s, device=dev)
        self.state = torch.zeros((6, s), dtype=torch.int64, device=dev)
        self.dyn = torch.zeros(6, dtype=torch.float32, device=dev)
        self.counts: Optional[torch.Tensor] = None
        self.tokens = torch.full((s, sched.fused_tick), -1, dtype=torch.int64, device=dev)
        self.lps = torch.zeros((s, sched.fused_tick), dtype=torch.float32, device=dev)
        self.col = torch.zeros((1, 1), dtype=torch.int64, device=dev)
        self.table: Optional[torch.Tensor] = None
        self.cache = self.pool.state() if self.paged else self.kv

    def live(self) -> Tuple[torch.Tensor, ...]:
        """The tensors the graphs captured and must find in place: the
        scheduler's cache as it is now (a paged pool's ``set_state`` would
        replace its tensors) and the page table's device copy."""
        cache = self.pool.state() if self.paged else self.kv
        return tuple(cache) + ((self.table,) if self.paged else ())

    def load(self, sched: "BatchScheduler", active: List[int], sp: SamplingParams, use_counts: bool,
             k_steps: int) -> int:
        """Copy the tick's host state into the buffers (inactive rows
        finished from the start, at position 0); returns the steps to run:
        k_steps, or fewer when every active slot's budget ends sooner."""
        host = np.zeros((6, self.num_slots), np.int64)
        host[5] = 1
        for i in active:
            sl = sched.slots[i]
            gen0 = len(sl.prior) + len(sl.generated)
            host[:, i] = (sl.pos, sl.eos_id, max(1, sl.max_new - gen0), gen0, 0, 0)
        self.state.copy_(torch.from_numpy(host))
        self.dyn.copy_(dynamic_params(sp))
        self.col.zero_()
        if use_counts:
            if self.counts is None:
                self.counts = torch.zeros((self.num_slots, self.cfg.vocab_size), dtype=torch.int32, device=self.device)
            c = np.zeros(tuple(self.counts.shape), np.int32)
            for i in active:
                sl = sched.slots[i]
                np.add.at(c[i], np.asarray(sl.prompt + sl.generated, np.int64), 1)
            self.counts.copy_(torch.from_numpy(c))
        if self.paged:
            # the card's table is one tensor refreshed by an asynchronous
            # copy, queued here ahead of the steps (outside the graph)
            self.table = self.ptable.to_device(self.device, self.pool.localize)
        return int(min(k_steps, host[2, active].max()))

    def step_fn(self, sampling: SamplingParams, use_counts: bool, logprobs: bool):
        """One decode step over all slots (the reference's loop body):
        forward(last, pos) -> processed logits -> draw -> record; a row
        records while it is not finished and stops at its EOS or budget;
        a finished row keeps its position (its cache writes stay inside
        its pages, rewriting its last entry) and feeds its last token."""
        pos, eos, remaining, gen0, nrec, finished = self.state.unbind(0)
        rows, s = self.rows, self.num_slots

        def step():
            logits, _ = cache_forward(self.params, self.cfg, self.policy, self.mesh, self.device, self.last_tokens,
                                      self.cache, pos[:, None], pos, page_table=self.table if self.paged else None)
            proc = process_logits_dynamic(
                logits[:, 0], self.dyn, top_k=sampling.top_k, use_top_p=sampling.top_p < 1.0,
                token_counts=self.counts if use_counts else None, cur_length=gen0 + nrec, eos_ids=eos,
            )
            nxt = sample(proc, sampling, self.generator).to(torch.int64)
            record = finished == 0
            col = self.col.expand(s, 1)
            self.tokens.scatter_(1, col, torch.where(record, nxt, -1)[:, None])
            if logprobs:
                lp = torch.log_softmax(proc, dim=-1).gather(-1, nxt[:, None])[:, 0]
                self.lps.scatter_(1, col, torch.where(record, lp, 0.0)[:, None])
            rec = record.to(torch.int64)
            nrec.add_(rec)
            finished.copy_(torch.where(record & ((nxt == eos) | (nrec >= remaining)), 1, finished))
            if use_counts:
                self.counts[rows, nxt] += rec.to(torch.int32)
            self.last_tokens.copy_(torch.where(record[:, None], nxt[:, None], self.last_tokens))
            pos.add_(rec)
            self.col += 1

        return step
