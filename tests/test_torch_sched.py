"""The port's continuous-batching slice vs flexq_tpu on the CPU.

K13's plain version (``flash_decode_paged``) against the Pallas kernel in
interpret mode; the per-row and paged cache writes of ``_kv_write_read``;
PagePool / PageTable / PrefixRegistry; the sampling transforms; and the
``BatchScheduler`` token streams on a tiny llama_flex LLaMA (2 layers,
hidden 256, head_dim 128, GQA 2:1, FFN 512, vocab 256, f32 weights).

Tolerances: K13's plain version bit-exact (a looser bound over the whole
batch, such as 2e-2 of max |out|, would let a wrong or a dropped page pass
in the long rows, whose outputs are small); the cache writes bit-exact (page 0, the garbage page that
inactive rows share, is not compared); the logits transforms within 1e-6;
the scheduler's token streams equal, on prompts whose greedy paths have no
near-tie under the reference, and their logprobs within 0.15 nats. The
W6A16 prefill's bf16 rounding moves the prefill logits by up to ~0.7 % of
max |logit| and, through the 6-bit requantization of the W6Ax decode steps
after it, the decode logits by a few percent (same history, port vs
reference), so a step whose top-2 margin is below that may go either way.
The preemption case takes seed 8's prompts; with seeds 4-7 the streams part
at a token whose reference top-2 margin is 0.09-0.54 % of max |logit|,
where the two sides' logits differ by 2.0-6.2 %, and a test holds each of
those seeds to parting only at such a near-tie.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexq_tpu.config import ModelConfig as JModelConfig, QuantPolicy as JQuantPolicy
from flexq_tpu.kernels.flash_decode import flash_decode_paged as j_flash_decode_paged
from flexq_tpu.models.quantized import (
    _kv_write_read as j_kv_write_read,
    quantize_params as j_quantize_params,
)
from flexq_tpu.serve import sampling as jsampling
from flexq_tpu.serve.paged import (
    PagePool as JPagePool,
    PageTable as JPageTable,
    PrefixRegistry as JPrefixRegistry,
)
from flexq_tpu.serve.scheduler import BatchScheduler as JBatchScheduler
from flexq_tpu.train.trainer import init_params
from flexq_tpu_torch.config import ModelConfig, QuantPolicy
from flexq_tpu_torch.convert import params_from_numpy
from flexq_tpu_torch.kernels import flash_decode_paged, launch_counts
from flexq_tpu_torch.models.quantized import _kv_write_read
from flexq_tpu_torch.serve import sampling
from flexq_tpu_torch.serve.paged import PagePool, PageTable, PrefixRegistry
from flexq_tpu_torch.serve.scheduler import BatchScheduler

KW = dict(vocab_size=256, hidden_size=256, intermediate_size=512, num_layers=2,
          num_heads=2, num_kv_heads=1, max_seq_len=512)
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def to_np(x):
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def tensor(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t if dtype is None else t.to(dtype)


def pool_arrays(rng, quant, shape):
    """Random pool k, v (bf16-exact f32 values, or int8) and f32 scales."""
    if quant:
        kv = [rng.integers(-128, 128, shape).astype(np.int8) for _ in "kv"]
        return kv, [rng.uniform(0.001, 0.02, shape[:-1]).astype(np.float32) for _ in "kv"]
    kv = [np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16).astype(jnp.float32)) for _ in "kv"]
    return kv, []


@pytest.mark.parametrize("quant,window", [(False, None), (False, 200), (True, None), (True, 200)])
def test_flash_decode_paged_matches_jax(quant, window):
    rng = np.random.default_rng(30 + 2 * quant + (window is not None))
    nl, npages, kvh, ps, d, b, h, maxp = 2, 12, 2, 128, 128, 4, 4, 3
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    (pk, pv), scales = pool_arrays(rng, quant, (nl, npages, kvh, ps, d))
    # a scrambled table over pages 1.., ragged lengths around page edges
    table = np.stack([rng.permutation(np.arange(1, npages))[:maxp] for _ in range(b)]).astype(np.int32)
    lengths = np.array([1, 128, 129, 384], np.int32)
    jdt = jnp.int8 if quant else jnp.bfloat16
    ref = j_flash_decode_paged(jnp.asarray(q), jnp.asarray(pk, jdt), jnp.asarray(pv, jdt), jnp.asarray(table),
                               jnp.asarray(lengths), *map(jnp.asarray, scales), layer_idx=1, window=window,
                               interpret=True)
    tdt = torch.int8 if quant else torch.bfloat16
    got = flash_decode_paged(tensor(q), tensor(pk, tdt), tensor(pv, tdt), tensor(table), tensor(lengths),
                             *map(tensor, scales), layer_idx=1, window=window)
    # bit-exact: the plain version takes the kernel's blocks (one page) and
    # roundings, and every sum here comes out in the same order
    np.testing.assert_array_equal(got.float().numpy(), to_np(ref))
    assert launch_counts()["flash_decode_paged"] == 0  # CPU tensors never launch a kernel


@pytest.mark.parametrize("kind", ["dense", "dense8", "paged", "paged8"])
def test_kv_write_read_matches_jax(kind):
    """One decode step (L = 1) of per-row positions: the dense cache rows or
    the pool pages after the write equal the reference's, bit for bit."""
    rng = np.random.default_rng(40 + len(kind))
    nl, b, kvh, d, li = 2, 4, 2, 128, 1
    k, v = (rng.standard_normal((b, 1, kvh, d)).astype(np.float32) for _ in "kv")
    quant = kind.endswith("8")
    if kind.startswith("paged"):
        npages, ps, maxp = 8, 128, 2
        (pk, pv), scales = pool_arrays(rng, quant, (nl, npages, kvh, ps, d))
        table = np.array([[3, 5], [0, 0], [6, 2], [0, 0]], np.int32)  # rows 1 and 3 inactive
        pos = np.array([130, 0, 77, 0], np.int32)
        jdt, tdt = (jnp.int8, torch.int8) if quant else (jnp.bfloat16, torch.bfloat16)
        jbufs = [jnp.asarray(pk, jdt), jnp.asarray(pv, jdt)] + [jnp.asarray(s) for s in scales]
        tbufs = [tensor(pk, tdt), tensor(pv, tdt)] + [tensor(s) for s in scales]
        jkv = (kind, *jbufs, jnp.asarray(table), li)
        tkv = (*tbufs[:2], *(tbufs[2:] or (None, None)), li, tensor(table))
    else:
        s = 256
        jdt, tdt = (jnp.int8, torch.int8) if quant else (jnp.float32, torch.float32)
        shape = (nl, b, kvh, s, d)
        bufs = [np.zeros(shape, np.int8 if quant else np.float32) for _ in "kv"]
        bufs += [np.zeros(shape[:-1], np.float32) for _ in "kv"] if quant else []
        jbufs = [jnp.asarray(x) for x in bufs]
        tbufs = [tensor(x.copy()) for x in bufs]
        pos = np.array([5, 0, 200, 131], np.int32)
        jkv = (*jbufs, li)
        tkv = (*tbufs[:2], *(tbufs[2:] or (None, None)), li, None)
    new_state, _ = j_kv_write_read(jkv, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), jnp.float32)
    _kv_write_read(tkv, tensor(k), tensor(v), tensor(pos))
    for want, got in zip(new_state, tbufs):
        want, got = to_np(want), got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
        if kind.startswith("paged"):  # page 0 is the garbage page
            want, got = want[:, 1:], got[:, 1:]
        np.testing.assert_array_equal(got, want)


def test_page_pool_defaults_to_the_card():
    """PagePool, like the Engine and the BatchScheduler, puts its pages on
    the card unless the caller asks for the CPU; on a machine without one
    the default raises and names the device, never falling back."""
    if torch.cuda.is_available():
        assert PagePool(1, 2, 1, 128, 128).pool_k.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            PagePool(1, 2, 1, 128, 128)
    assert PagePool(1, 2, 1, 128, 128, device="cpu").pool_k.device.type == "cpu"


def test_page_pool_and_table_match_jax():
    nl, npages, kvh, ps, d = 2, 6, 1, 128, 128
    jpool = JPagePool(nl, npages, kvh, ps, d, dtype=jnp.int8)
    pool = PagePool(nl, npages, kvh, ps, d, dtype=torch.int8, device="cpu")
    for n in (1, 2):
        assert pool.alloc(n) == jpool.alloc(n)
    for p in ([2], [1]):
        pool.free(p)
        jpool.free(p)
    assert pool.alloc(2) == jpool.alloc(2)
    assert pool.free_pages == jpool.free_pages
    assert [pool.pages_for(n) for n in (0, 1, 128, 129)] == [jpool.pages_for(n) for n in (0, 1, 128, 129)]
    with pytest.raises(MemoryError):
        pool.alloc(10)
    # insert a 2-page prefill region from a 3-page scratch, gather it back
    rng = np.random.default_rng(50)
    scratch = [rng.integers(-128, 128, (nl, 1, kvh, 3 * ps, d)).astype(np.int8) for _ in "kv"]
    scratch += [rng.uniform(0.01, 1, (nl, 1, kvh, 3 * ps)).astype(np.float32) for _ in "kv"]
    jpool.insert_prefill([4, 2], *map(jnp.asarray, scratch[:2]), 200, *map(jnp.asarray, scratch[2:]))
    pool.insert_prefill([4, 2], *map(tensor, scratch[:2]), 200, *map(tensor, scratch[2:]))
    pool.copy_pages([4], [5])
    jpool.copy_pages([4], [5])
    for want, got in zip(jpool.state(), pool.state()):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    zeros = [np.zeros_like(x) for x in scratch]
    want = jpool.gather_prefix([5, 2], tuple(map(jnp.asarray, zeros)))
    got = pool.gather_prefix([5, 2], tuple(map(tensor, zeros)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    jt, t = JPageTable(3, 4), PageTable(3, 4)
    for tbl in (jt, t):
        tbl.assign(1, [3, 4])
        tbl.append(1, 5)
        tbl.assign(2, [2])
    assert t.release(1) == [int(p) for p in jt.release(1)]
    np.testing.assert_array_equal(t.table, jt.table)
    np.testing.assert_array_equal(t.to_device(torch.device("cpu")).numpy(), jt.table)


def test_prefix_registry_matches_jax():
    tokens = list(np.random.default_rng(60).integers(0, 256, 300))
    assert PrefixRegistry.hash_chain(tokens, 128) == JPrefixRegistry.hash_chain(tokens, 128)
    regs = (PrefixRegistry(), JPrefixRegistry())
    for r in regs:
        chain = r.hash_chain(tokens, 128)
        assert [r.register(h, p) for h, p in zip(chain, (7, 8))] == [True, True]
        assert not r.register(chain[0], 9)  # already published
        assert r.match(chain + [123]) == [7, 8]
        r.acquire([7])
        r.account_miss(1)
        assert r.release([7, 8, 9]) == [9]  # 9 is not registered
        assert r.release([7]) == []  # 7: rc 2 -> 0, retained after 8
        assert r.reclaimable == 2
        assert r.evict(1) == [8]  # least recently retained first
        assert r.match(chain) == [7]
    assert vars(regs[0]) == vars(regs[1])


SAMPLING_CASES = [
    dict(),
    dict(temperature=0.7, top_k=5),
    dict(top_p=0.8, repetition_penalty=1.3),
    dict(temperature=1.5, presence_penalty=0.5, frequency_penalty=0.25, min_length=4, top_k=40, top_p=0.9),
]


@pytest.mark.parametrize("kw", SAMPLING_CASES)
def test_process_logits_matches_jax(kw):
    rng = np.random.default_rng(70 + len(kw))
    b, v = 4, 256
    logits = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    counts = rng.integers(0, 3, (b, v)).astype(np.int32) * (rng.uniform(size=(b, v)) < 0.1)
    cur = np.array([0, 3, 4, 9], np.int32)
    eos = np.array([2, 2, 5, 7], np.int32)
    bad = rng.uniform(size=v) < 0.02
    jp, tp = jsampling.SamplingParams(**kw), sampling.SamplingParams(**kw)
    ref = jsampling.process_logits(jnp.asarray(logits), jp, jnp.asarray(counts), jnp.asarray(cur), eos_id=2,
                                   bad_words_mask=jnp.asarray(bad))
    got = sampling.process_logits(tensor(logits), tp, tensor(counts), tensor(cur), eos_id=2,
                                  bad_words_mask=tensor(bad))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    ref = jsampling.process_logits_dynamic(
        jnp.asarray(logits), jsampling.dynamic_params(jp), jp.top_k, jp.top_p < 1.0,
        token_counts=jnp.asarray(counts), cur_length=jnp.asarray(cur), eos_ids=jnp.asarray(eos))
    got = sampling.process_logits_dynamic(
        tensor(logits), sampling.dynamic_params(tp), tp.top_k, tp.top_p < 1.0,
        token_counts=tensor(counts), cur_length=tensor(cur), eos_ids=tensor(eos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    assert sampling.structural_key(tp) == jsampling.structural_key(jp)
    greedy = sampling.sample(got, sampling.SamplingParams())
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(jsampling.sample(ref, jsampling.SamplingParams())))
    # a draw lands on a token the processed logits keep
    drawn = sampling.sample(got, dataclasses.replace(tp, greedy=False), torch.Generator().manual_seed(0))
    assert bool((got.gather(-1, drawn[:, None].long()) > sampling.NEG_INF).all())


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = JModelConfig.llama(**KW), ModelConfig.llama(**KW)
    dense = jax.tree_util.tree_map(np.asarray, init_params(jcfg, seed=0))
    # scale the init so the tiny model's greedy choices are not near-ties
    dense = jax.tree_util.tree_map(lambda a: a * 4.0 if a.ndim == 2 else a, dense)
    jq = j_quantize_params(dense, jcfg, JQuantPolicy.llama_flex(), dtype=jnp.float32)
    return jcfg, cfg, jq, params_from_numpy(jax.tree_util.tree_map(np.asarray, jq), device="cpu")


def prompts(seed, lengths, prefix=()):
    rng = np.random.default_rng(seed)
    return [list(prefix) + rng.integers(0, 256, n).tolist() for n in lengths]


# scheduler configuration, kv dtype, prompts, max_new, requests added late
# (after two ticks)
SCHED_CASES = {
    # dense: ragged prompts, one through the W6A16 prefill, one late arrival
    "dense_late": (dict(num_slots=2), "f32", prompts(1, (5, 70, 9)), 6, 1),
    # paged bf16: chunked admission of a 150-token prompt (two 128-token chunks)
    "paged_chunked": (dict(paged=True, prefill_chunk=128, num_slots=2), "bf16", prompts(2, (9, 150)), 6, 0),
    "paged_int8": (dict(paged=True, num_slots=2), "int8", prompts(3, (12, 70)), 6, 0),
    # 1 + 3 pages for 3 slots: the requests cross a page edge and preempt
    "preempt": (dict(paged=True, num_pages=4, num_slots=3), "bf16", prompts(8, (120, 118, 124)), 12, 0),
    # the late request shares the first request's full first page
    "prefix_cache": (dict(paged=True, prefix_cache=True, num_slots=2), "bf16",
                     prompts(6, (10, 20), prefix=prompts(5, (128,))[0]), 6, 1),
}


@pytest.mark.parametrize("case", list(SCHED_CASES))
def test_scheduler_tokens_equal_jax(model, case):
    jcfg, cfg, jq, tq = model
    kw, kv, reqs, max_new, late = SCHED_CASES[case]
    runs = []
    for sched in (JBatchScheduler(jq, jcfg, JQuantPolicy.llama_flex(), max_seq_len=256, kv_dtype=JDT[kv], **kw),
                  BatchScheduler(tq, cfg, QuantPolicy.llama_flex(), max_seq_len=256, kv_dtype=TDT[kv],
                                 device="cpu", **kw)):
        ids = [sched.add_request(p, max_new_tokens=max_new, eos_id=-1, logprobs=True) for p in reqs[: len(reqs) - late]]
        out = {}
        for _ in range(2):
            out.update(sched.step())
        ids += [sched.add_request(p, max_new_tokens=max_new, eos_id=-1, logprobs=True) for p in reqs[len(reqs) - late:]]
        out.update(sched.run())
        runs.append(([out[i] for i in ids], [sched.done_logprobs.get(i) for i in ids], sched))
    (want, want_lp, jsched), (got, got_lp, tsched) = runs
    assert got == want
    assert all(len(t) == max_new for t in got)
    # logprobs of the same tokens: the logits agree to a few percent of max
    # |logit| once a W6A16 prefill fed the 6-bit decode, hence 0.15 nats
    assert all(len(lp) == max_new for lp in got_lp)
    assert max(abs(a - b) for x, y in zip(got_lp, want_lp) for a, b in zip(x, y)) <= 0.15
    if kw.get("paged"):
        reclaim = tsched.registry.reclaimable if tsched.registry is not None else 0
        assert tsched.pool.free_pages + reclaim == tsched.pool.num_pages - 1
        assert tsched.pool.free_pages == jsched.pool.free_pages
    if case == "preempt":
        assert tsched.preemptions > 0
    if case == "prefix_cache":
        assert tsched.registry.hits == jsched.registry.hits > 0


def tap_logits(sched):
    """Keep the logits row each sampled token was drawn from, keyed by
    (request, token index); both schedulers pass their samplers the whole
    [slots, V] logits and the slots to sample."""
    rows = {}
    batch, one = sched._sample_batch, sched._sample_one

    def key(slot):
        return slot.req_id, len(slot.prior) + len(slot.generated)

    def sample_batch(idx, logits):
        for i in idx:
            rows[key(sched.slots[i])] = to_np(logits[i].float() if isinstance(logits, torch.Tensor) else logits[i])
        return batch(idx, logits)

    def sample_one(row, slot):
        rows[key(slot)] = to_np(row.float() if isinstance(row, torch.Tensor) else row).reshape(-1)
        return one(row, slot)

    sched._sample_batch, sched._sample_one = sample_batch, sample_one
    return rows


@pytest.mark.parametrize("seed", [4, 5, 6, 7])
def test_scheduler_streams_part_only_at_near_ties(model, seed):
    """The preemption case with the prompt seeds whose streams part from the
    reference's: wherever a request's stream first parts, the reference's
    top-2 margin there is below 1 % of max |logit|, and below twice the
    port's logit difference from the reference on the same history (the
    W6A16 prefill's rounding, carried into the 6-bit decode steps), the
    least difference that can flip the argmax."""
    jcfg, cfg, jq, tq = model
    kw, kv, _, max_new, _ = SCHED_CASES["preempt"]
    reqs = prompts(seed, (120, 118, 124))
    runs = []
    for sched in (JBatchScheduler(jq, jcfg, JQuantPolicy.llama_flex(), max_seq_len=256, kv_dtype=JDT[kv], **kw),
                  BatchScheduler(tq, cfg, QuantPolicy.llama_flex(), max_seq_len=256, kv_dtype=TDT[kv],
                                 device="cpu", **kw)):
        rows = tap_logits(sched)
        ids = [sched.add_request(p, max_new_tokens=max_new, eos_id=-1) for p in reqs]
        out = sched.run()
        runs.append(([out[i] for i in ids], ids, rows))
    (want, jids, jrows), (got, tids, trows) = runs
    assert all(len(t) == max_new for t in got)
    for r, (a, b) in enumerate(zip(want, got)):
        if a == b:
            continue
        k = next(j for j in range(max_new) if a[j] != b[j])
        ref, mine = jrows[(jids[r], k)], trows[(tids[r], k)]
        top2 = np.sort(ref)[-2:]
        margin = (top2[1] - top2[0]) / np.abs(ref).max()
        diff = np.abs(mine - ref).max() / np.abs(ref).max()
        print(f"seed {seed}, request {r}: parts at token {k}, reference top-2 margin {margin:.3%} of max |logit|, "
              f"logit difference {diff:.3%}")
        assert margin < 1e-2 and margin <= 2 * diff, (r, k, margin, diff)


def test_scheduler_sampling_is_seeded(model):
    """Non-greedy rows (temperature, top-k, a penalty) next to a greedy one:
    every request gets its tokens, logprobs are <= 0, and the same seed
    gives the same streams."""
    _, cfg, _, tq = model
    hot = sampling.SamplingParams(greedy=False, temperature=0.8, top_k=5, repetition_penalty=1.2)
    runs = []
    for _ in range(2):
        sched = BatchScheduler(tq, cfg, QuantPolicy.llama_flex(), num_slots=3, max_seq_len=256, paged=True,
                               seed=7, device="cpu")
        ids = [sched.add_request(p, sampling=sp, max_new_tokens=5, eos_id=-1, logprobs=True)
               for p, sp in zip(prompts(9, (6, 11, 7)), (hot, sampling.SamplingParams(), hot))]
        out = sched.run()
        runs.append(([out[i] for i in ids], [sched.done_logprobs[i] for i in ids]))
    assert runs[0] == runs[1]
    tokens, lps = runs[0]
    assert all(len(t) == 5 for t in tokens)
    assert all(lp <= 0 for row in lps for lp in row)
