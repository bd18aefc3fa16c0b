"""Speculative decoding with prompt-lookup (n-gram) drafts (port of
flexq_tpu/serve/speculative.py).

A draft proposes the k tokens that followed the most recent earlier
occurrence of the history's longest matching n-gram suffix (no draft
model). One verify forward feeds [last token, d_1..d_k] at positions
pos..pos+k: a [B, 1+k] window written into the cache, attending causally
through the lengths pos+1+k (Engine._spec_forward). The targets t_0..t_k
are the model's own next tokens; the longest prefix with d_j == t_{j-1} is
accepted and t_0..t_n_acc are emitted (the last is the free "bonus" token).
Each step's window starts where the accepted prefix ended, so the cache
entries of rejected drafts are overwritten before any query attends to
them.

Greedy-exactness: the emitted tokens equal plain greedy decoding's for any
draft quality, where the verify window and the decode step compute the
same logits (on the CPU, exactly; on the card the window runs K9's
short-prompt kernel and the exact GEMM's tensor-core route, decode K6's
split-KV kernel and the streaming route, whose attention sums differ in
order, so a near-tie may part them). Sampled mode is exact for the
deterministic drafts: an emitted token is the model's own sample at its
window position, emitted only while every earlier sample matched the draft.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

from flexq_tpu_torch.serve.sampling import SamplingParams


@dataclasses.dataclass
class SpecStats:
    """Per-generation speculative-decoding accounting."""

    steps: int = 0  # verify forwards run
    drafted: int = 0  # draft tokens proposed (live rows only)
    accepted: int = 0  # draft tokens accepted
    generated: int = 0  # tokens emitted (accepted + 1 bonus per step)
    prefill_s: float = 0.0
    decode_s: float = 0.0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / max(self.drafted, 1)

    @property
    def tokens_per_step(self) -> float:
        return self.generated / max(self.steps, 1)


def ngram_draft(history: np.ndarray, k: int, max_ngram: int = 3, min_ngram: int = 1) -> np.ndarray:
    """Propose k tokens by prompt lookup: the k tokens that followed the
    most recent earlier occurrence of the longest matching suffix n-gram
    (n = max_ngram..min_ngram), padded with the last token; the last token
    repeated when nothing matches."""
    h = np.asarray(history, np.int32)
    for n in range(min(max_ngram, len(h) - 1), min_ngram - 1, -1):
        windows = np.lib.stride_tricks.sliding_window_view(h[:-1], n)
        matches = np.nonzero((windows == h[-n:]).all(axis=1))[0]
        if len(matches):
            i = int(matches[-1])
            cont = h[i + n : i + n + k]
            if len(cont) < k:
                cont = np.concatenate([cont, np.full(k - len(cont), h[-1], np.int32)])
            return cont.astype(np.int32)
    return np.full(k, h[-1], np.int32)


def ngram_draft_device(buf: torch.Tensor, length: torch.Tensor, k: int, max_ngram: int = 3) -> torch.Tensor:
    """Prompt lookup on the device for every row at once (the reference
    vmaps its per-row version): buf [B, LB] token histories, length [B]
    their lengths -> drafts [B, k]. For n = max_ngram..1 every window
    buf[r, j:j+n] is compared with row r's suffix, and the most recent match
    of the longest matching n wins; its continuation may run into the
    history's own suffix, and past the history it repeats the last token."""
    b, lb = buf.shape
    dev = buf.device
    rows = torch.arange(b, device=dev)[:, None]
    idx = torch.arange(lb, device=dev)[None, :]
    length = length.to(torch.int64)
    last = buf[rows[:, 0], length - 1]
    best = torch.full((b,), -1, dtype=torch.int64, device=dev)
    for n in range(max_ngram, 0, -1):
        # the reference's dynamic_slice clamps the suffix start into range;
        # a row with length <= n matches nothing below (ok is False)
        start = (length - n).clamp(0, lb - n)
        suffix = buf[rows, start[:, None] + torch.arange(n, device=dev)[None, :]]  # [B, n]
        m = torch.ones((b, lb), dtype=torch.bool, device=dev)
        for t in range(n):
            # roll wraps, but wrapped windows sit at j > lb - n >= length - n
            # and are masked below
            m &= torch.roll(buf, -t, dims=1) == suffix[:, t : t + 1]
        m &= idx < (length - n)[:, None]  # window + its continuation inside the history
        pos_n = torch.where(m, idx, -1).amax(dim=1)
        ok = (pos_n >= 0) & (length > n)
        best = torch.where((best < 0) & ok, pos_n + n, best)
    start = torch.where(best >= 0, best, length - 1)
    tpos = start[:, None] + torch.arange(k, device=dev)[None, :]
    d = buf[rows, tpos.clamp(max=lb - 1)]
    # the continuation may run past the history (self-extension is fine below length)
    return torch.where(tpos < length[:, None], d, last[:, None])


def generate_speculative(
    engine,
    prompt_ids: Sequence[Sequence[int]],
    max_new_tokens: int = 32,
    k: int = 4,
    eos_id: int = 2,
    stop_ids: Sequence[int] = (),
    max_ngram: int = 3,
    return_stats: bool = False,
    fused: bool = True,
    sampling=None,
    seed: int = 0,
    gate: bool = True,
) -> List[List[int]] | Tuple[List[List[int]], SpecStats]:
    """Generation by draft and verify over an Engine's dense cache. The
    fused loop (Engine._spec_decode_loop) batches rows, each drafting and
    verifying at its own position, with the draftability gate when
    ``gate``; the host loop (``fused=False``) takes one row and reads its
    targets back every step. Sampled decoding (non-greedy ``sampling``,
    fused loop only, draws from a torch.Generator seeded with ``seed``)
    refuses the count and length penalties, as the reference does: window
    positions would need evolving counts."""
    if sampling is None:
        sampling = SamplingParams()
    if not sampling.greedy:
        if not fused:
            raise ValueError("sampled speculative decoding requires the fused loop")
        if (sampling.repetition_penalty != 1.0 or sampling.presence_penalty != 0.0
                or sampling.frequency_penalty != 0.0 or sampling.min_length != 0):
            raise ValueError("count/length penalties are not served in sampled speculative mode")
    prompts = [list(p) for p in prompt_ids]
    bsz = len(prompts)
    if not fused and bsz != 1:
        raise ValueError("the host spec loop takes one row (the fused loop batches)")
    lens = {len(p) for p in prompts}
    if len(lens) != 1:
        raise ValueError("spec decoding requires equal-length prompts")
    l = lens.pop()
    if l + max_new_tokens + k > engine.max_seq_len:
        raise ValueError("the speculative window may overshoot: need prompt + max_new + k <= max_seq_len")

    dev = engine.device
    stats = SpecStats()
    t0 = time.perf_counter()
    logits, cache = engine.prefill_prompts(prompts, engine.new_cache(bsz))
    stop_set = set(stop_ids) | {eos_id}

    if fused:
        lb = l + max_new_tokens + k + 1
        buf = torch.zeros((bsz, lb), dtype=torch.int64, device=dev)
        buf[:, :l] = torch.as_tensor(np.asarray(prompts, np.int64), device=dev)
        gen = None if sampling.greedy else torch.Generator(device=dev).manual_seed(seed)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stats.prefill_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        buf, length, steps, acc, drafted = engine._spec_decode_loop(
            logits, cache, buf, l, k, max_new_tokens, tuple(sorted(stop_set)), max_ngram, sampling,
            generator=gen, gate=gate,
        )
        buf_np, length_np = buf.cpu().numpy(), length.cpu().numpy()
        outs = [[int(t) for t in buf_np[r, l : int(length_np[r])]] for r in range(bsz)]
        stats.steps, stats.accepted, stats.drafted = steps, int(acc), int(drafted)
        stats.generated = sum(len(o) for o in outs)
        stats.decode_s = time.perf_counter() - t1
        return (outs, stats) if return_stats else outs

    history = list(prompts[0])
    first = int(torch.argmax(logits[0]))  # one scalar read: syncs the prefill
    stats.prefill_s = time.perf_counter() - t0
    out: List[int] = [first]
    history.append(first)
    pos = l
    t1 = time.perf_counter()
    while len(out) < max_new_tokens and out[-1] not in stop_set:
        draft = ngram_draft(np.asarray(history, np.int32), k, max_ngram=max_ngram)
        step_ids = torch.as_tensor(np.concatenate([[history[-1]], draft]).astype(np.int64)[None], device=dev)
        tgt, cache = engine._spec_verify(step_ids, cache, pos)
        targets = tgt[0].tolist()
        n_acc = 0
        while n_acc < k and draft[n_acc] == targets[n_acc] and targets[n_acc] not in stop_set:
            n_acc += 1
        stats.steps += 1
        stats.drafted += k
        stats.accepted += n_acc
        for t in targets[: n_acc + 1]:
            out.append(int(t))
            history.append(int(t))
            if t in stop_set:
                break
        pos += n_acc + 1
    out = out[:max_new_tokens]  # a stop token stays in, as in the stepwise loop
    stats.generated = len(out)
    stats.decode_s = time.perf_counter() - t1
    return ([out], stats) if return_stats else [out]
