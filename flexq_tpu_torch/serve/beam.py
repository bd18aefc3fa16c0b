"""Beam search over the quantized serve path (port of
flexq_tpu/serve/beam.py): per-step top-K over beam x vocab, cumulative
log-probs, the GNMT length penalty, finished hypotheses frozen, and the KV
cache reordered by parent.

  * Ties: ``jax.lax.top_k`` returns the lower index first among equal
    values; ``torch.topk`` promises no order on ties, and random-weight
    bf16 logits hold exact ties. ``topk_lower_first`` takes the top K of a
    stable descending sort instead, so parents and tokens are the
    reference's.
  * Cache reorder: beams that change parent copy their parent's cache row
    (``reorder_rows``): only those rows, only the positions written so far,
    in place through a temporary of the copied rows (the reference's
    out-of-place ``jnp.take`` would double the cache: 1 GiB a row of K + V
    at LLaMA-2-7B's width and max_seq_len 2048).
  * Finished beams are frozen: their only continuation is ``pad_id`` at zero
    added log-prob, so they compete under the same length-penalized score.

``beam_search_nbest_paged`` routes through the scheduler's beam groups
(serve/scheduler.py): pages shared between beams, copy-on-divergence of the
block being written only.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

NEG = -1e9


@dataclasses.dataclass(frozen=True)
class BeamParams:
    beam_width: int = 4
    length_penalty: float = 1.0  # GNMT-style: score / ((5+len)/6)^alpha
    max_new_tokens: int = 32


def _length_norm(length: int, alpha: float) -> float:
    """((5 + len) / 6) ** alpha, in f32 as the reference computes it."""
    return float(np.power((np.float32(5.0) + np.float32(length)) / np.float32(6.0), np.float32(alpha)))


def topk_lower_first(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries along the last dim, equal
    values in index order (``jax.lax.top_k``'s order)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def reorder_rows(cache, src: Sequence[int], dst: Sequence[int], n: int) -> None:
    """cache[:, dst[i], ..., :n] = cache[:, src[i], ..., :n] for every
    buffer of ``cache`` ([L, B, KVH, S(, D)]), in place. Only the pairs
    with src != dst move; the source rows are read into a temporary before
    any row is written, so a row permutation is safe."""
    pairs = [(s, d) for s, d in zip(src, dst) if s != d]
    if not pairs:
        return
    dev = cache[0].device
    s = torch.as_tensor([p[0] for p in pairs], dtype=torch.int64, device=dev)
    d = torch.as_tensor([p[1] for p in pairs], dtype=torch.int64, device=dev)
    for buf in cache:
        buf[:, d, :, :n] = buf[:, s, :, :n]


def _beam_step(engine, ids, cache, pos: int, scores, finished, b: int, k: int, eos_id: int, pad_id: int):
    """One beam step: the decode forward over B*K rows, log-softmax, frozen
    beams, top-K over K*V per row. Returns (next_ids [B*K, 1], cache,
    scores, finished, parent [B, K], token [B, K], the parents' cache rows
    [B*K]); the caller reorders the cache by the last."""
    logits, cache = engine._decode_step(ids, cache, pos)  # [B*K, V]
    v = logits.shape[-1]
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1).reshape(b, k, v)
    frozen = torch.full((v,), NEG, dtype=torch.float32, device=logp.device)
    frozen[pad_id] = 0.0
    logp = torch.where(finished[:, :, None], frozen, logp)
    top_scores, top_idx = topk_lower_first((scores[:, :, None] + logp).reshape(b, k * v), k)
    parent, token = top_idx // v, top_idx % v
    finished = torch.gather(finished, 1, parent) | (token == eos_id)
    flat_parent = (parent + torch.arange(b, device=parent.device)[:, None] * k).reshape(-1)
    return token.reshape(b * k, 1), cache, top_scores, finished, parent, token, flat_parent


def beam_search(engine, prompt_ids: Sequence[Sequence[int]], beams: BeamParams = BeamParams(), eos_id: int = 2,
                pad_id: int = 0) -> List[List[int]]:
    """The best hypothesis per row (tokens up to and including eos if
    produced). Prompts must be of equal length, as Engine.generate's."""
    nbest = beam_search_nbest(engine, prompt_ids, beams, eos_id, pad_id, n_best=1)
    return [row[0][0] for row in nbest]


def beam_search_nbest(engine, prompt_ids: Sequence[Sequence[int]], beams: BeamParams = BeamParams(),
                      eos_id: int = 2, pad_id: int = 0, n_best: int = 1) -> List[List[Tuple[List[int], float]]]:
    """Beam search over an Engine's dense cache: per row, the ``n_best``
    hypotheses as (tokens, length-penalized score), best first. The prompt
    rows are tiled K times and prefilled together; the host reads the
    step's parents, tokens and finished flags once a step. Under an
    Engine's mesh it takes dp = 1: a beam's parent row may lie on another
    data rank."""
    if engine.mesh is not None and engine.mesh.dp > 1:
        raise ValueError("beam search under a mesh takes dp = 1 (a reorder would cross data ranks)")
    prompts = [list(p) for p in prompt_ids]
    lens = {len(p) for p in prompts}
    if len(lens) != 1:
        raise ValueError("beam search requires equal-length prompts")
    l = lens.pop()
    b, k = len(prompts), beams.beam_width
    if l + beams.max_new_tokens > engine.max_seq_len:
        raise ValueError(f"prompt {l} + {beams.max_new_tokens} new tokens exceed max_seq_len {engine.max_seq_len}")

    tiled = [p for p in prompts for _ in range(k)]  # [B*K, L]: beams share the prompt's KV
    logits, cache = engine.prefill_prompts(tiled, engine.new_cache(b * k))
    # first expansion: top-K distinct tokens from the shared prompt state
    logp0 = torch.log_softmax(logits.to(torch.float32), dim=-1).reshape(b, k, -1)[:, 0]
    scores, first = topk_lower_first(logp0, k)  # [B, K]
    finished = first == eos_id
    next_ids = first.reshape(b * k, 1)
    tokens_np = first.cpu().numpy()[:, :, None]  # [B, K, 1] histories
    done = bool(finished.all())
    pos = l
    for _ in range(beams.max_new_tokens - 1):
        if done:
            break
        next_ids, cache, scores, finished, parent, token, flat_parent = _beam_step(
            engine, next_ids, cache, pos, scores, finished, b, k, eos_id, pad_id)
        step = torch.cat([parent, token, finished.to(parent.dtype), flat_parent.reshape(b, k)], 1).cpu().numpy()
        parent_np, token_np, fin_np, flat_np = np.split(step, 4, axis=1)
        reorder_rows(cache, flat_np.reshape(-1).tolist(), list(range(b * k)), pos + 1)
        # re-thread the histories through the parents (host bookkeeping only)
        tokens_np = np.concatenate([np.take_along_axis(tokens_np, parent_np[:, :, None], axis=1),
                                    token_np[:, :, None]], axis=2)
        done = bool(fin_np.all())
        pos += 1

    scores_np = scores.cpu().numpy()
    out: List[List[Tuple[List[int], float]]] = []
    for row in range(b):
        hyps = []
        for bi in range(k):
            toks = [int(t) for t in tokens_np[row, bi]]
            if eos_id in toks:
                toks = toks[: toks.index(eos_id) + 1]
            norm = _length_norm(max(len(toks), 1), beams.length_penalty)
            hyps.append((toks, float(scores_np[row, bi]) / norm))
        hyps.sort(key=lambda h: -h[1])
        out.append(hyps[: max(n_best, 1)])
    return out


def beam_search_nbest_paged(params, cfg, policy, prompt_ids: Sequence[Sequence[int]],
                            beams: BeamParams = BeamParams(), eos_id: int = 2, n_best: int = 1, *,
                            kv_dtype=torch.bfloat16, page_size: int = 128, num_pages: Optional[int] = None,
                            max_seq_len: Optional[int] = None,
                            device="cuda") -> List[List[Tuple[List[int], float]]]:
    """Paged-KV beam search with ``beam_search_nbest``'s n-best surface,
    through the continuous-batching scheduler's beam groups: reorder is a
    page-table permutation with copy-on-divergence of the current block.
    Rows are queued requests, so prompts may be ragged. The default pool
    holds one group's worst case (the scheduler's admission budget) and the
    garbage page: the scheduler's own default, one page a block of every
    slot, holds one page less than a group's budget when the prompt and
    its generation share one block, and such a request would never admit."""
    from flexq_tpu_torch.serve.scheduler import BatchScheduler

    prompts = [list(p) for p in prompt_ids]
    msl = max_seq_len or max(len(p) for p in prompts) + beams.max_new_tokens
    msl = -(-msl // page_size) * page_size  # the pool wants a page multiple
    if num_pages is None:
        k, n = beams.beam_width, beams.max_new_tokens
        num_pages = 1 + max(-(-len(p) // page_size) + k * ((len(p) + n - 1) // page_size - len(p) // page_size + 1)
                            for p in prompts)
    sched = BatchScheduler(params, cfg, policy, num_slots=beams.beam_width, max_seq_len=msl, kv_dtype=kv_dtype,
                           paged=True, page_size=page_size, num_pages=num_pages, device=device)
    rids = [sched.add_request(p, max_new_tokens=beams.max_new_tokens, eos_id=eos_id, beam_width=beams.beam_width,
                              n_best=max(n_best, 1), length_penalty=beams.length_penalty) for p in prompts]
    sched.run()
    return [[(toks, score) for toks, score, _ in sched.done_nbest[rid]] for rid in rids]
