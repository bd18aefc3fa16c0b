"""The port's decoding modes vs flexq_tpu on the CPU: sampled and logprob
``Engine.generate`` (fused and step loops), speculative decoding (the
n-gram drafts, the fused and host loops, SpecStats), beam search
(``beam_search_nbest`` over the Engine's cache, the scheduler's beam groups
over dense, paged and int8 caches beside a regular request,
``beam_search_nbest_paged``, ``shed_beam``) and the HTTP ``best_of`` route,
on the reference's own fixture model (tests/test_speculative.py,
tests/test_beam.py: a transformers LlamaForCausalLM, 2 layers, hidden 128,
4 heads over 2 KV heads, FFN 256, vocab 256, seeded 0) under llama_flex,
f32 weights and cache (and bf16, the serving dtype, for speculative
exactness), prompts below the W6A16 threshold.

Tolerances: tokens equal the reference's; logprobs and beam scores within
0.15 nats per token, the bound tests/test_torch_sched.py holds the
scheduler's logprobs to; fused and step loops equal exactly. Speculative
tokens equal plain greedy tokens exactly at the serving dtype; over the f32
fixture they equal the reference's speculative tokens, which part from
plain greedy in one case of its own (test_spec_f32_parts_only_where_the_
reference_parts says why). Sampled draws come from a torch.Generator, not
jax.random, so sampled modes are held by a repeat of the seed and by
fused == step, not by the reference's tokens."""

import dataclasses
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import LlamaConfig, LlamaForCausalLM

from flexq_tpu.config import QuantPolicy as JQuantPolicy
from flexq_tpu.models import config_from_hf, from_hf_llama
from flexq_tpu.models.quantized import quantize_params as j_quantize_params
from flexq_tpu.serve import Engine as JEngine, SamplingParams as JSamplingParams
from flexq_tpu.serve import beam as jbeam, speculative as jspec
from flexq_tpu.serve.scheduler import BatchScheduler as JBatchScheduler
from flexq_tpu_torch.config import ModelConfig, QuantPolicy
from flexq_tpu_torch.convert import params_from_numpy
from flexq_tpu_torch.serve import Engine, SamplingParams, beam, speculative
from flexq_tpu_torch.serve.http import serve_background
from flexq_tpu_torch.serve.scheduler import BatchScheduler

S = 128  # max_seq_len of the engines
NATS = 0.15  # logprob / beam-score bound per token
POL, JPOL = QuantPolicy.llama_flex(), JQuantPolicy.llama_flex()


@pytest.fixture(scope="module")
def hf():
    torch.manual_seed(0)
    return LlamaForCausalLM(LlamaConfig(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                                        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=S,
                                        tie_word_embeddings=False)).eval()


def build(hf, jdt, tdt):
    """(jcfg, cfg, reference params, port params, reference Engine, port
    Engine) of the fixture model with weights, activations and cache in
    ``jdt`` / ``tdt``."""
    jcfg = config_from_hf(hf.config)
    cfg = ModelConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ModelConfig)})
    jq = j_quantize_params(from_hf_llama(hf, dtype=jdt), jcfg, JPOL, dtype=jdt)
    tq = params_from_numpy(jax.tree_util.tree_map(np.asarray, jq), device="cpu")
    jeng = JEngine(jq, jcfg, JPOL, max_seq_len=S, kv_dtype=jdt)
    eng = Engine(tq, cfg, POL, max_seq_len=S, kv_dtype=tdt, device="cpu")
    return jcfg, cfg, jq, tq, jeng, eng


@pytest.fixture(scope="module")
def model(hf):
    return build(hf, jnp.float32, torch.float32)


@pytest.fixture(scope="module")
def model_bf16(hf):
    """The fixture model at the engines' serving dtype, bf16."""
    return build(hf, jnp.bfloat16, torch.bfloat16)


def prompts(seed, b, n):
    return np.random.default_rng(seed).integers(0, 256, (b, n)).tolist()


def test_penalized_greedy_and_logprobs_equal_jax(model):
    """Greedy with repetition / presence / frequency penalties and
    min_length (EOS banned for 4 tokens): tokens equal the reference's in
    both loops, logprobs within NATS of its, fused == step exactly, and the
    return order is out, logprobs, stats."""
    *_, jeng, eng = model
    ps = prompts(11, 3, 12)
    eos = eng.generate(ps, max_new_tokens=3, eos_id=-1)[0][1]  # row 0's second token, banned by min_length
    kw = dict(repetition_penalty=1.3, presence_penalty=0.2, frequency_penalty=0.1, min_length=4)
    want, want_lp = jeng.generate(ps, max_new_tokens=10, sampling=JSamplingParams(**kw), eos_id=eos,
                                  return_logprobs=True)
    runs = [eng.generate(ps, max_new_tokens=10, sampling=SamplingParams(**kw), eos_id=eos, return_logprobs=True,
                         return_stats=True, mode=mode) for mode in ("fused", "step")]
    (out, lps, stats), (out_s, lps_s, _) = runs
    assert out == out_s == want
    assert lps == lps_s
    assert [len(r) for r in lps] == [len(r) for r in out]
    assert max(abs(a - b) for x, y in zip(lps, want_lp) for a, b in zip(x, y)) <= NATS
    assert stats.generated_tokens == sum(map(len, out))
    assert all(eos not in r[:4] for r in out)


def test_sampled_fused_equals_step_and_repeats(model):
    """Temperature / top-p / repetition penalty: fused == step under one
    seed, a repeat of the seed equal, logprobs finite and <= 0."""
    *_, eng = model
    sp = SamplingParams(temperature=0.8, top_p=0.9, repetition_penalty=1.1, greedy=False)
    ps = prompts(12, 3, 10)
    fused, lps = eng.generate(ps, max_new_tokens=12, sampling=sp, eos_id=-1, seed=5, return_logprobs=True)
    step, lps_s = eng.generate(ps, max_new_tokens=12, sampling=sp, eos_id=-1, seed=5, return_logprobs=True,
                               mode="step")
    again = eng.generate(ps, max_new_tokens=12, sampling=sp, eos_id=-1, seed=5)
    other = eng.generate(ps, max_new_tokens=12, sampling=sp, eos_id=-1, seed=6)
    assert fused == step == again
    assert other != fused  # 36 draws at temperature 0.8
    assert lps == lps_s and all(np.isfinite(x) and x <= 0 for r in lps for x in r)


def test_ngram_drafts_equal_jax():
    """ngram_draft (host) and ngram_draft_device (all rows at once) against
    the reference's on random small-vocabulary buffers."""
    rng = np.random.default_rng(3)
    for k in (1, 3, 5):
        b, lb = 6, 48
        lengths = rng.integers(2, 40, b)
        buf = rng.integers(0, 5, (b, lb)).astype(np.int32)
        want = jax.vmap(lambda r, n: jspec.ngram_draft_device(r, n, k))(jnp.asarray(buf), jnp.asarray(lengths))
        got = speculative.ngram_draft_device(torch.from_numpy(buf).long(), torch.from_numpy(lengths), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for r in range(b):
            h = buf[r, : lengths[r]]
            np.testing.assert_array_equal(speculative.ngram_draft(h, k), jspec.ngram_draft(h, k))


# the reference's batched case: a random-looking row, a repeated pair, a cycle
BATCH = [[1, 5, 9, 12, 8, 2], [9, 12, 1, 5, 3, 3], [7, 1, 7, 1, 7, 1]]


SPEC_PROMPTS = [[1, 5, 9, 12], [3, 3, 3, 3, 3, 3], [7, 1, 7, 1, 7, 1]]  # the reference's own cases


def test_spec_tokens_equal_plain_greedy(model_bf16):
    """At the serving dtype (bf16 weights, activations and cache),
    speculative tokens equal plain greedy tokens exactly in every case of
    the reference's test_spec_matches_plain_greedy (host and fused loops at
    B = 1 for k = 1, 3, 5) and in the fused loop at B = 3 with a shared EOS
    that ends rows early (the reference's streams: the tests below)."""
    *_, eng = model_bf16
    for p in SPEC_PROMPTS:
        plain = eng.generate([p], max_new_tokens=12, eos_id=-1, mode="step")[0]
        for k in (1, 3, 5):
            for fused in (False, True):
                got, st = speculative.generate_speculative(eng, [p], max_new_tokens=12, k=k, eos_id=-1, fused=fused,
                                                           return_stats=True)
                assert got[0] == plain, (p, k, fused)
                assert st.generated == 12 and st.steps <= 12 and 0 <= st.accepted <= st.drafted
    eos = eng.generate(BATCH, max_new_tokens=3, eos_id=-1)[1][2]  # row 1's third token
    plain = eng.generate(BATCH, max_new_tokens=12, eos_id=eos, mode="step")
    assert len(plain[1]) < 12
    assert eng.generate(BATCH, max_new_tokens=12, eos_id=eos, mode="spec") == plain


def test_spec_f32_parts_only_where_the_reference_parts(model):
    """Over the f32 fixture the decode step's attention rounds its output to
    bf16 (flash_decode's output dtype) while a verify window's stays f32, in
    both packages alike, so greedy exactness is not structural there. Of the
    reference's cases, at this module's max_seq_len (the port's cache is a
    multiple of 128 keys; the reference's test takes 64), spec == plain in
    every case but the prompt of 3s, at every k and in both loops; there
    the reference's own spec stream parts from its own plain greedy, and
    the port's streams equal the reference's."""
    *_, jeng, eng = model
    parted = []
    for p in SPEC_PROMPTS:
        plain = eng.generate([p], max_new_tokens=12, eos_id=-1, mode="step")[0]
        for k in (1, 3, 5):
            for fused in (False, True):
                got = speculative.generate_speculative(eng, [p], max_new_tokens=12, k=k, eos_id=-1, fused=fused)[0]
                if got != plain:
                    parted.append((p, k, fused))
    threes = SPEC_PROMPTS[1]
    assert parted == [(threes, k, fused) for k in (1, 3, 5) for fused in (False, True)]
    plain = eng.generate([threes], max_new_tokens=12, eos_id=-1, mode="step")[0]
    got = speculative.generate_speculative(eng, [threes], max_new_tokens=12, k=3, eos_id=-1, fused=False)[0]
    jplain = jeng.generate([threes], max_new_tokens=12, eos_id=-1)[0]
    jgot = jspec.generate_speculative(jeng, [threes], max_new_tokens=12, k=3, eos_id=-1, fused=False)[0]
    assert jgot != jplain and (got, plain) == (jgot, jplain)


def test_spec_stats_equal_jax(model):
    """The fused loop's tokens and greedy SpecStats (steps, drafted,
    accepted, generated) equal the reference's with the draftability gate
    on, over the batched case of the test above (k = 3, a shared EOS that
    ends row 1 early); ungated, the tokens are the same and drafted counts
    k a step for every live row."""
    *_, jeng, eng = model
    eos = eng.generate(BATCH, max_new_tokens=3, eos_id=-1)[1][2]
    got, st = speculative.generate_speculative(eng, BATCH, max_new_tokens=12, k=3, eos_id=eos, return_stats=True)
    want, jst = jspec.generate_speculative(jeng, BATCH, max_new_tokens=12, k=3, eos_id=eos, return_stats=True)
    assert got == want and len(got[1]) < 12
    assert (st.steps, st.drafted, st.accepted, st.generated) == (jst.steps, jst.drafted, jst.accepted, jst.generated)
    ungated, su = speculative.generate_speculative(eng, BATCH, max_new_tokens=12, k=3, eos_id=eos, return_stats=True,
                                                   gate=False)
    assert ungated == got and su.drafted <= su.steps * 3 * len(BATCH) and su.drafted >= st.drafted


def test_spec_sampled_and_refusals(model):
    """Sampled spec repeats under one seed; the reference's refusals stay:
    logprobs in spec mode, penalties under sampled spec, sampled host loop,
    a window past max_seq_len."""
    *_, eng = model
    sp = SamplingParams(temperature=0.9, top_p=0.95, greedy=False)
    rep = [[3, 5, 3, 5, 3, 5, 3, 5]] * 2
    a = eng.generate(rep, max_new_tokens=12, eos_id=-1, mode="spec", sampling=sp, seed=7)
    assert a == eng.generate(rep, max_new_tokens=12, eos_id=-1, mode="spec", sampling=sp, seed=7)
    assert all(len(r) == 12 for r in a)
    with pytest.raises(ValueError):
        eng.generate(rep, max_new_tokens=4, mode="spec", return_logprobs=True)
    with pytest.raises(ValueError):
        eng.generate(rep, max_new_tokens=4, mode="spec", sampling=SamplingParams(greedy=False, presence_penalty=0.5))
    with pytest.raises(ValueError):
        speculative.generate_speculative(eng, rep[:1], max_new_tokens=4, sampling=sp, fused=False)
    with pytest.raises(ValueError):
        eng.generate(rep, max_new_tokens=S - 8 - 2, mode="spec")


def raw(hyps, alpha=1.0):
    """(tokens, raw cumulative log-prob) of ranked (tokens, penalized score)."""
    return [(t, s * beam._length_norm(max(len(t), 1), alpha)) for t, s in hyps]


def test_beam_nbest_equal_jax(model):
    """beam_search_nbest, B = 2, K = 3, with EOS: hypotheses equal the
    reference's, raw scores within NATS per token; beam width 1 is greedy;
    the best beam's joint log-prob is at least the greedy stream's."""
    *_, jeng, eng = model
    ps = prompts(15, 2, 8)
    bp = beam.BeamParams(beam_width=3, max_new_tokens=8)
    eos = eng.generate(ps, max_new_tokens=4, eos_id=-1)[0][2]
    got = beam.beam_search_nbest(eng, ps, bp, eos_id=eos, n_best=3)
    want = jbeam.beam_search_nbest(jeng, ps, jbeam.BeamParams(beam_width=3, max_new_tokens=8), eos_id=eos, n_best=3)
    for g, w in zip(got, want):
        assert [t for t, _ in g] == [t for t, _ in w]
        for (t, sg), (_, sw) in zip(raw(g), raw(w)):
            assert abs(sg - sw) <= NATS * len(t)
    greedy = eng.generate(ps, max_new_tokens=8, eos_id=-1)
    assert beam.beam_search(eng, ps, beam.BeamParams(beam_width=1, length_penalty=0.0, max_new_tokens=8),
                            eos_id=-1) == greedy
    wide = beam.beam_search_nbest(eng, ps, beam.BeamParams(beam_width=4, length_penalty=0.0, max_new_tokens=8),
                                  eos_id=-1)
    _, lps = eng.generate(ps, max_new_tokens=8, eos_id=-1, return_logprobs=True)
    assert all(row[0][1] >= sum(lp) - 1e-4 for row, lp in zip(wide, lps))


# scheduler beam cases: (kv dtype, paged); a regular request rides along
SCHED_BEAM = {"dense": ("f32", False), "paged": ("f32", True), "paged_int8": ("int8", True)}
TDT = {"f32": torch.float32, "int8": torch.int8}
JDT = {"f32": jnp.float32, "int8": jnp.int8}


@pytest.mark.parametrize("case", list(SCHED_BEAM))
def test_scheduler_beams_equal_standalone_and_jax(model, case):
    """A beam group (K = 3, n_best = 3, logprobs) beside a regular greedy
    request: the group's n-best equals the standalone beam_search_nbest over
    an Engine of the same cache dtype, the regular stream equals its run
    alone, both equal the reference scheduler's, the winner's logprobs sum
    to its raw score, and a paged pool gets every page back (page 0, the
    garbage page, stays allocated)."""
    jcfg, cfg, jq, tq, _, _ = model
    kv, paged = SCHED_BEAM[case]
    prompt, other = prompts(16, 2, 10)
    kw = dict(num_slots=4, max_seq_len=S, paged=paged)
    eng = Engine(tq, cfg, POL, max_seq_len=S, kv_dtype=TDT[kv], device="cpu")
    alone = eng.generate([other], max_new_tokens=6, eos_id=-1)[0]
    standalone = beam.beam_search_nbest(eng, [prompt], beam.BeamParams(beam_width=3, max_new_tokens=7), eos_id=-1,
                                        n_best=3)[0]
    runs = []
    for sched in (BatchScheduler(tq, cfg, POL, kv_dtype=TDT[kv], device="cpu", **kw),
                  JBatchScheduler(jq, jcfg, JPOL, kv_dtype=JDT[kv], **kw)):
        rb = sched.add_request(prompt, max_new_tokens=7, eos_id=-1, beam_width=3, n_best=3, logprobs=True)
        rg = sched.add_request(other, max_new_tokens=6, eos_id=-1)
        out = sched.run()
        runs.append((out[rb], out[rg], sched.done_nbest[rb], sched.done_logprobs[rb], sched))
    (best, reg, nbest, lps, ts), (jbest, jreg, jnbest, _, _) = runs
    assert reg == alone == jreg
    assert best == jbest == standalone[0][0]
    assert [t for t, _, _ in nbest] == [t for t, _ in standalone] == [t for t, _, _ in jnbest]
    for (t, s, _), (_, sw) in zip(nbest, standalone):
        assert abs(s - sw) <= 1e-4
    assert all(len(lp) == len(t) for t, _, lp in nbest)
    assert abs(sum(lps) - raw([(best, nbest[0][1])])[0][1]) <= 1e-3
    assert not ts.beam_groups and all(s.req_id is None for s in ts.slots)
    if paged:
        assert ts.pool.free_pages == ts.pool.num_pages - 1


def test_shed_beam_and_paged_nbest_ragged(model):
    """shed_beam finishes the youngest group with its hypotheses so far and
    frees its pages; beam_search_nbest_paged over ragged prompts equals the
    dense standalone n-best of each prompt; a beam request wider than the
    free slots waits (FIFO) and then runs."""
    _, cfg, _, tq, _, eng = model
    sched = BatchScheduler(tq, cfg, POL, num_slots=3, max_seq_len=S, paged=True, device="cpu")
    rid = sched.add_request(prompts(18, 1, 6)[0], max_new_tokens=20, eos_id=-1, beam_width=2, n_best=2)
    for _ in range(3):
        sched.step()
    assert rid in sched.beam_groups
    assert sched.shed_beam()
    assert rid in sched.done_nbest and len(sched.done_nbest[rid][0][0]) == 4
    assert not sched.shed_beam() and sched.pool.free_pages == sched.pool.num_pages - 1
    ps = [prompts(19, 1, 5)[0], prompts(20, 1, 11)[0]]
    bp = beam.BeamParams(beam_width=2, max_new_tokens=5)
    got = beam.beam_search_nbest_paged(tq, cfg, POL, ps, bp, eos_id=-1, n_best=2, kv_dtype=torch.float32,
                                       device="cpu")
    for p, row in zip(ps, got):
        want = beam.beam_search_nbest(eng, [p], bp, eos_id=-1, n_best=2)[0]
        assert [t for t, _ in row] == [t for t, _ in want]
        assert all(abs(a[1] - b[1]) <= 1e-4 for a, b in zip(row, want))
    fifo = BatchScheduler(tq, cfg, POL, num_slots=2, max_seq_len=S, device="cpu")
    r1 = fifo.add_request([7, 3], max_new_tokens=3, eos_id=-1)
    rb = fifo.add_request([1, 5, 9], max_new_tokens=4, eos_id=-1, beam_width=2)
    out = fifo.run()
    assert len(out[r1]) == 3 and len(out[rb]) == 4


def post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_http_best_of_beam(model):
    """/v1/completions with best_of > n answers n choices of a best_of-beam
    search, equal to a direct scheduler n-best of the same request;
    /generate's beam_width returns the ranked n-best."""
    _, cfg, _, tq, _, _ = model
    prompt = prompts(21, 1, 9)[0]
    direct = BatchScheduler(tq, cfg, POL, num_slots=4, max_seq_len=S, paged=True, num_pages=16, device="cpu")
    rid = direct.add_request(prompt, max_new_tokens=6, eos_id=-1, beam_width=4, n_best=2)
    direct.run()
    want = direct.done_nbest[rid]
    sched = BatchScheduler(tq, cfg, POL, num_slots=4, max_seq_len=S, paged=True, num_pages=16, device="cpu")
    server, service, port = serve_background(sched)
    try:
        ans = post(port, "/v1/completions", {"prompt": prompt, "max_tokens": 6, "best_of": 4, "n": 2, "eos_id": -1})
        assert [c["token_ids"] for c in ans["choices"]] == [t for t, _, _ in want]
        assert all(abs(c["beam_score"] - s) <= 1e-6 for c, (_, s, _) in zip(ans["choices"], want))
        gen = post(port, "/generate", {"prompt_ids": prompt, "max_new_tokens": 6, "eos_id": -1, "beam_width": 4,
                                       "n_best": 2})
        assert gen["tokens"] == want[0][0] and [h["tokens"] for h in gen["nbest"]] == [t for t, _, _ in want]
        assert service.failed_ticks == 0 and sched.pool.free_pages == sched.pool.num_pages - 1
    finally:
        service.shutdown()
        server.shutdown()
        server.server_close()
