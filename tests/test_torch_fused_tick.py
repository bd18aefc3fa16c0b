"""The port's fused scheduler ticks (``fused_tick > 0``) vs its per-token
ticks and vs flexq_tpu's fused ticks, on the CPU, where the step the card
captures as a CUDA graph runs eagerly (serve/graphs.py).

The model is the reference's fixture of tests/test_fused_tick.py (a
transformers LlamaForCausalLM, vocab 256, hidden 128, 2 layers, 4 heads
over 2 KV heads, seeded 0, llama_flex in f32), built in memory, and a tiny
pre-LN OPT under opt_flex. Tolerances: greedy token streams equal (port
fused == port per-token == the reference's fused ticks); the fused ticks'
logprobs equal the port's per-token ticks' (the same step arithmetic, row
by row) and lie within 0.15 nats of the reference's, the bound of
tests/test_torch_sched.py. Sampled fused ticks draw from the scheduler's
torch.Generator, not jax.random: they are held by a repeat of the seed.
The reference's mesh cases (fused ticks at tp = 2) are in tests/test_torch_parallel.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import LlamaConfig, LlamaForCausalLM

from flexq_tpu.config import ModelConfig as JModelConfig, QuantPolicy as JQuantPolicy
from flexq_tpu.models import config_from_hf, from_hf_llama
from flexq_tpu.models.quantized import quantize_params as j_quantize_params
from flexq_tpu.serve import SamplingParams as JSamplingParams
from flexq_tpu.serve.scheduler import BatchScheduler as JBatchScheduler
from flexq_tpu_torch.config import ModelConfig, QuantPolicy
from flexq_tpu_torch.convert import params_from_numpy
from flexq_tpu_torch.kernels import launch_counts
from flexq_tpu_torch.serve import SamplingParams
from flexq_tpu_torch.serve.scheduler import BatchScheduler

NATS = 0.15
PROMPTS = [[3, 14, 15, 9], [7, 7], [100, 2, 30, 4, 55, 6]]
BUDGETS = [9, 4, 6]
KV = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16), "int8": (jnp.int8, torch.int8)}


@pytest.fixture(scope="module")
def llama():
    torch.manual_seed(0)
    hf = LlamaForCausalLM(LlamaConfig(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                                      num_attention_heads=4, num_key_value_heads=2,
                                      tie_word_embeddings=False)).eval()
    jcfg = config_from_hf(hf.config)
    cfg = ModelConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ModelConfig)})
    jq = j_quantize_params(from_hf_llama(hf, dtype=jnp.float32), jcfg, JQuantPolicy.llama_flex(), dtype=jnp.float32)
    tq = params_from_numpy(jax.tree_util.tree_map(np.asarray, jq), device="cpu")
    return (jq, jcfg, JQuantPolicy.llama_flex()), (tq, cfg, QuantPolicy.llama_flex())


def port(model, kv="f32", **kw):
    """The port's scheduler over ``model`` with the reference test's
    defaults: 2 slots, max_seq_len 256."""
    tq, cfg, pol = model[1]
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_seq_len", 256)
    return BatchScheduler(tq, cfg, pol, kv_dtype=KV[kv][1], device="cpu", **kw)


@pytest.fixture(scope="module")
def ref_fused(llama):
    """The reference's fused-tick schedulers, one per cache, made once and
    drained again by each test (greedy streams do not depend on a slot's
    history, and the compiled programs are the run time here): the dense
    and int8 caches at fused_tick 4, the paged one at 3, as in
    tests/test_fused_tick.py."""
    made = {}

    def get(kv="f32", paged=False):
        if (kv, paged) not in made:
            jq, jcfg, jpol = llama[0]
            kw = dict(paged=True, page_size=128, fused_tick=3) if paged else dict(fused_tick=4)
            made[kv, paged] = JBatchScheduler(jq, jcfg, jpol, num_slots=2, max_seq_len=256, kv_dtype=KV[kv][0], **kw)
        return made[kv, paged]

    return get


def drain(sched, reqs, late=(), **add_kw):
    """Add ``reqs`` [(prompt, max_new)], then ``late`` after the first
    tick; run to the end. Returns (streams, logprobs or None) in request
    order."""
    ids = [sched.add_request(p, max_new_tokens=n, eos_id=-1, **add_kw) for p, n in reqs]
    out = dict(sched.step())
    ids += [sched.add_request(p, max_new_tokens=n, eos_id=-1, **add_kw) for p, n in late]
    out.update(sched.run())
    lps = [sched.done_logprobs.get(i) for i in ids]
    return [out[i] for i in ids], lps


REQS = list(zip(PROMPTS, BUDGETS))
# scheduler options, kv dtype, fused_tick, requests, requests added after the first tick
CASES = {
    "dense": (dict(), "f32", 4, REQS, ()),
    "paged": (dict(paged=True, page_size=128), "f32", 3, REQS, ()),
    "int8": (dict(), "int8", 4, REQS, ()),
    # the third request waits for a slot: the ticks shorten to 4 steps while it does
    "queue_adaptive_k": (dict(), "f32", 16, REQS, ()),
    # a request arriving mid-run
    "late_arrival": (dict(), "f32", 4, [(PROMPTS[0], 8)], [(PROMPTS[1], 5)]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fused_streams_equal_per_token_and_jax(llama, ref_fused, case):
    kw, kv, k, reqs, late = CASES[case]
    want, _ = drain(port(llama, kv, **kw), reqs, late)
    jsched = ref_fused(kv, bool(kw.get("paged")))
    tsched = port(llama, kv, fused_tick=k, **kw)
    got, _ = drain(tsched, reqs, late)
    assert got == want == drain(jsched, reqs, late)[0]
    assert all(len(t) == n for t, (_, n) in zip(got, list(reqs) + list(late)))
    assert max(tsched.tick_steps) > 1  # fused ticks ran
    if case == "queue_adaptive_k":
        # while a request waited, no tick ran more than 4 steps
        assert 4 in tsched.tick_steps and max(tsched.tick_steps) <= 16
    if kw.get("paged"):
        assert tsched.pool.free_pages == tsched.pool.num_pages - 1 == jsched.pool.free_pages
    assert sum(launch_counts().values()) == 0  # the CPU runs the plain versions, no kernel


def test_fused_eos_stops_early(llama, ref_fused):
    """Per-slot EOS masking on the device: the first greedy token as EOS
    ends the request after exactly that token, as in the reference; a
    later token as EOS stops the slot in the middle of a tick."""
    stream = drain(port(llama), [(PROMPTS[0], 9)])[0][0]
    outs = []
    for sched in (ref_fused(), port(llama, fused_tick=4)):
        rid = sched.add_request(PROMPTS[0], max_new_tokens=10, eos_id=stream[0])
        outs.append(sched.run()[rid])
    assert outs[0] == outs[1] == [stream[0]]
    sched = port(llama, fused_tick=8)
    rid = sched.add_request(PROMPTS[0], max_new_tokens=9, eos_id=stream[5])
    assert sched.run()[rid] == stream[: stream.index(stream[5]) + 1]


@pytest.mark.parametrize("paged", [False, True])
def test_fused_logprobs_match_per_token(llama, ref_fused, paged):
    kw = dict(paged=True, page_size=128) if paged else {}
    want, want_lp = drain(port(llama, **kw), REQS, logprobs=True)
    got, got_lp = drain(port(llama, fused_tick=4, **kw), REQS, logprobs=True)
    ref, ref_lp = drain(ref_fused(paged=paged), REQS, logprobs=True)
    assert got == want == ref
    assert [len(x) for x in got_lp] == BUDGETS
    np.testing.assert_allclose(np.concatenate(got_lp), np.concatenate(want_lp), rtol=1e-6, atol=1e-6)
    assert max(abs(a - b) for x, y in zip(got_lp, ref_lp) for a, b in zip(x, y)) <= NATS


def test_fused_mixed_sampling_falls_back(llama):
    """Slots under different SamplingParams are not fusible: those ticks run
    per token, and the greedy request's stream stays the per-token one."""
    want = drain(port(llama), [(PROMPTS[0], 5)])[0][0]
    sched = port(llama, fused_tick=4)
    f1 = sched.add_request(PROMPTS[0], max_new_tokens=5, eos_id=-1)
    f2 = sched.add_request(PROMPTS[1], max_new_tokens=5, eos_id=-1,
                           sampling=SamplingParams(greedy=False, temperature=0.8))
    out = sched.run()
    assert out[f1] == want and len(out[f2]) == 5
    assert not sched.fused_graphs and not any(sched.tick_fused) and set(sched.tick_steps) == {1}


def test_fused_repetition_penalty_matches(llama, ref_fused):
    """The penalties read token counts kept on the device across the fused
    steps; streams equal the per-token ticks' and the reference's."""
    jsp, sp = JSamplingParams(repetition_penalty=1.3), SamplingParams(repetition_penalty=1.3)
    want = drain(port(llama), [(PROMPTS[0], 7)], sampling=sp)[0]
    tsched = port(llama, fused_tick=3)
    assert drain(tsched, [(PROMPTS[0], 7)], sampling=sp)[0] == want == drain(ref_fused(), [(PROMPTS[0], 7)],
                                                                               sampling=jsp)[0]
    (key,) = tsched.fused_graphs  # (structural sampling key, counts, logprobs)
    assert key[1] is True


def test_fused_sampled_repeats_under_one_seed(llama):
    """Sampled fused ticks (temperature / top-p / a penalty, all on the
    device): the same seed gives the same streams, another seed others,
    and the requests share one step graph."""
    runs = []
    for seed in (7, 7, 8):
        sched = port(llama, paged=True, page_size=128, fused_tick=4, seed=seed)
        hot = SamplingParams(greedy=False, temperature=0.8, top_p=0.9, frequency_penalty=0.2)
        runs.append((drain(sched, [(PROMPTS[0], 9), (PROMPTS[2], 6)], sampling=hot, logprobs=True), sched))
    (a, s0), (b, _), (c, _) = runs
    assert a == b and a[0] != c[0]
    assert [len(t) for t in a[0]] == [9, 6] and all(lp <= 0 for row in a[1] for lp in row)
    assert len(s0.fused_graphs) == 1 and max(s0.tick_steps) > 1


KW_OPT = dict(vocab_size=250, hidden_size=256, intermediate_size=512, num_layers=2, num_heads=2, max_seq_len=256)


def test_fused_opt_paged_equals_per_token_and_jax():
    """A tiny pre-LN OPT under opt_flex over a paged bf16 pool: fused ticks
    (K14 / K4 / K15's plain versions inside the step) give the per-token
    ticks' and the reference's fused streams."""
    rng = np.random.default_rng(0)
    h, f, v = KW_OPT["hidden_size"], KW_OPT["intermediate_size"], KW_OPT["vocab_size"]

    def arr(shape, std, mean=0.0):
        return (mean + std * rng.standard_normal(shape)).astype(np.float32)

    def lin(k, n):
        return {"w": arr((k, n), 0.08), "b": arr(n, 0.05)}

    def norm():
        return {"g": arr(h, 0.1, 1.0), "b": arr(h, 0.1)}

    dense = {"embed": arr((v, h), 0.5), "pos_embed": arr((KW_OPT["max_seq_len"] + 2, h), 0.2),
             "final_norm": norm(),
             "layers": [{"input_norm": norm(), "post_norm": norm(), "q_proj": lin(h, h), "k_proj": lin(h, h),
                         "v_proj": lin(h, h), "o_proj": lin(h, h), "fc1": lin(h, f), "fc2": lin(f, h)}
                        for _ in range(KW_OPT["num_layers"])]}
    jcfg, cfg = JModelConfig.opt(**KW_OPT), ModelConfig.opt(**KW_OPT)
    jq = jax.tree_util.tree_map(np.asarray, j_quantize_params(dense, jcfg, JQuantPolicy.opt_flex(), dtype=jnp.float32))
    model = (None, (params_from_numpy(jq, device="cpu"), cfg, QuantPolicy.opt_flex()))
    reqs = [(np.random.default_rng(7).integers(0, v, n).tolist(), m) for n, m in ((9, 7), (30, 5), (12, 6))]
    kw = dict(paged=True, page_size=128)
    want = drain(port(model, "bf16", **kw), reqs)[0]
    tsched = port(model, "bf16", fused_tick=4, **kw)
    jsched = JBatchScheduler(jq, jcfg, JQuantPolicy.opt_flex(), num_slots=2, max_seq_len=256, kv_dtype=jnp.bfloat16,
                             fused_tick=4, **kw)
    assert drain(tsched, reqs)[0] == want == drain(jsched, reqs)[0]
    assert tsched.pool.free_pages == tsched.pool.num_pages - 1
