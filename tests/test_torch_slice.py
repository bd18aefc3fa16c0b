"""The port's serve slice vs flexq_tpu on a tiny llama_flex LLaMA (2 layers,
hidden 256, head_dim 128, GQA 2:1, FFN 512, vocab 256, max_seq_len 128),
run in f32 on the CPU: forward_serve logits within 1e-4 of max |logit| and
greedy Engine.generate tokens equal, with the reference's parameters in its
order and its return order (out, logprobs, stats); what is not served
raises (a pipeline with a mesh, layers that do not split over its stages,
spec decoding, a paged pool or fused ticks under it; a prefix cache at
dp > 1; a negative fused_tick), the reference's refusal of
logprobs in spec mode stays, and half a cache is refused (the cache-less
forward takes neither kv_k nor kv_v)."""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexq_tpu.config import ModelConfig as JModelConfig, QuantPolicy as JQuantPolicy
from flexq_tpu.models.quantized import (
    forward_serve as j_forward_serve,
    quantize_params as j_quantize_params,
)
from flexq_tpu.serve import Engine as JEngine
from flexq_tpu.train.trainer import init_params
from flexq_tpu_torch.config import ModelConfig, QuantPolicy
from flexq_tpu_torch.convert import params_from_numpy
from flexq_tpu_torch.models.quantized import forward_serve
from flexq_tpu_torch.parallel import Mesh, PipeMesh
from flexq_tpu_torch.serve import Engine, SamplingParams
from flexq_tpu_torch.serve.scheduler import BatchScheduler

KW = dict(vocab_size=256, hidden_size=256, intermediate_size=512, num_layers=2,
          num_heads=2, num_kv_heads=1, max_seq_len=128)
S = 128


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = JModelConfig.llama(**KW), ModelConfig.llama(**KW)
    dense = jax.tree_util.tree_map(np.asarray, init_params(jcfg, seed=0))
    # scale the init so the tiny model's greedy choices are not near-ties
    dense = jax.tree_util.tree_map(lambda a: a * 4.0 if a.ndim == 2 else a, dense)
    jq = j_quantize_params(dense, jcfg, JQuantPolicy.llama_flex(), dtype=jnp.float32)
    tq = params_from_numpy(jax.tree_util.tree_map(np.asarray, jq), device="cpu")
    prompts = np.random.default_rng(0).integers(0, 256, (2, 8))
    return jcfg, cfg, jq, tq, prompts


def test_forward_serve_matches_jax(model):
    jcfg, cfg, jq, tq, prompts = model
    jpol, pol = JQuantPolicy.llama_flex(), QuantPolicy.llama_flex()
    shape = (2, 2, 1, S, 128)
    jk, jv = jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    ids, pos = prompts, 0
    for step in range(3):  # one 8-token prefill, then two decode steps
        l = ids.shape[1]
        positions = np.broadcast_to(np.arange(pos, pos + l), (2, l))
        ref, (jk, jv) = j_forward_serve(jq, jcfg, jpol, jnp.asarray(ids), positions=jnp.asarray(positions),
                                        kv_k=jk, kv_v=jv, cache_pos=jnp.int32(pos))
        got, (tk, tv) = forward_serve(tq, cfg, pol, torch.from_numpy(ids), positions=torch.from_numpy(positions.copy()),
                                      kv_k=tk, kv_v=tv, cache_pos=pos, device="cpu")
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() <= 1e-4 * np.abs(ref).max(), step
        pos += l
        ids = ref[:, -1].argmax(-1)[:, None]


def test_generate_tokens_equal_jax(model):
    jcfg, cfg, jq, tq, prompts = model
    ref = JEngine(jq, jcfg, JQuantPolicy.llama_flex(), max_seq_len=S, kv_dtype=jnp.float32).generate(
        prompts.tolist(), max_new_tokens=6, eos_id=-1)
    eng = Engine(tq, cfg, QuantPolicy.llama_flex(), max_seq_len=S, kv_dtype=torch.float32, device="cpu")
    assert eng.generate(prompts, max_new_tokens=6, eos_id=-1, mode="fused") == ref
    assert eng.generate(prompts, max_new_tokens=6, eos_id=-1, mode="step") == ref
    # stop handling: row 0 ends at its first stop token, row 1 runs on
    stop = ref[0][2]
    want = [r[: r.index(stop) + 1] if stop in r else r for r in ref]
    for mode in ("fused", "step"):
        out, stats = eng.generate(prompts, max_new_tokens=6, eos_id=stop, mode=mode, return_stats=True)
        assert out == want
        assert stats.generated_tokens == sum(map(len, want))


def test_generate_takes_the_reference_parameters(model):
    jcfg, cfg, jq, tq, prompts = model
    assert list(inspect.signature(Engine.generate).parameters) == list(inspect.signature(JEngine.generate).parameters)
    eng = Engine(tq, cfg, QuantPolicy.llama_flex(), max_seq_len=S, kv_dtype=torch.float32, device="cpu")
    # positionally, in the reference's order: ..., stop_ids, seed, return_stats
    out, stats = eng.generate(prompts, 4, SamplingParams(), -1, (), 123, True)
    assert out == eng.generate(prompts, max_new_tokens=4, eos_id=-1, seed=7)  # greedy reads no seed
    assert stats.generated_tokens == 8
    got, lps, stats = eng.generate(prompts, max_new_tokens=2, eos_id=-1, return_logprobs=True, return_stats=True)
    assert got == [r[:2] for r in out] and stats.generated_tokens == 4
    assert [len(r) for r in lps] == [2, 2] and all(x <= 0 for r in lps for x in r)


def test_unsupported_paths_raise(model):
    jcfg, cfg, jq, tq, prompts = model
    pol = QuantPolicy.llama_flex()
    eng = Engine(tq, cfg, pol, max_seq_len=S, kv_dtype=torch.float32, device="cpu")
    # the reference's refusals: logprobs in spec mode, penalties under sampled spec
    with pytest.raises(ValueError):
        eng.generate(prompts, max_new_tokens=2, mode="spec", return_logprobs=True)
    with pytest.raises(ValueError):
        eng.generate(prompts, max_new_tokens=2, mode="spec", sampling=SamplingParams(greedy=False,
                                                                                     repetition_penalty=1.2))
    # the pipeline's refusals (a world of 2 stages; none reached: each raises before a collective)
    pp2 = PipeMesh(pp=2, rank=0, device=torch.device("cpu"), backend="gloo", group=None)
    tp2 = Mesh(tp=2, dp=1, rank=0, device=torch.device("cpu"), backend="gloo", model_group=None, data_group=None)
    with pytest.raises(ValueError, match="exclusive"):
        Engine(tq, cfg, pol, max_seq_len=S, pp_mesh=pp2, mesh=tp2, device="cpu")
    with pytest.raises(ValueError, match="split"):
        Engine(tq, cfg, pol, max_seq_len=S, pp_mesh=dataclasses.replace(pp2, pp=3), device="cpu")
    with pytest.raises(ValueError, match="spec"):
        Engine(tq, cfg, pol, max_seq_len=S, pp_mesh=pp2).generate(prompts, max_new_tokens=2, mode="spec")
    with pytest.raises(ValueError):
        Engine(tq, cfg, pol, max_seq_len=100, device="cpu")
    with pytest.raises(ValueError):  # half a cache: the cache-less forward takes neither
        forward_serve(tq, cfg, pol, torch.from_numpy(prompts), kv_k=eng.new_cache(2)[0], kv_v=None, cache_pos=0,
                      device="cpu")
    # what the scheduler does not serve: a paged pool or fused ticks under a pipeline, a prefix cache at dp > 1
    dp2 = Mesh(tp=1, dp=2, rank=0, device=torch.device("cpu"), backend="gloo", model_group=None, data_group=None)
    for kw in (dict(mesh=dp2, paged=True, prefix_cache=True), dict(pp_mesh=pp2, paged=True),
               dict(pp_mesh=pp2, fused_tick=2)):
        with pytest.raises(ValueError):
            BatchScheduler(tq, cfg, pol, num_slots=2, max_seq_len=S, device="cpu", **kw)
    with pytest.raises(ValueError):
        BatchScheduler(tq, cfg, pol, num_slots=2, max_seq_len=S, device="cpu", fused_tick=-1)
    sched = BatchScheduler(tq, cfg, pol, num_slots=2, max_seq_len=S, paged=True, device="cpu")
    with pytest.raises(ValueError):  # wider than the slots
        sched.add_request([1, 2, 3], max_new_tokens=2, beam_width=3)
    with pytest.raises(ValueError):  # the paged pool is decode-only
        forward_serve(tq, cfg, pol, torch.from_numpy(prompts), kv_k=sched.pool.pool_k, kv_v=sched.pool.pool_v,
                      cache_pos=0, page_table=torch.zeros((2, 1), dtype=torch.int32), device="cpu")


def test_engine_defaults_to_the_card(model):
    _, cfg, _, tq, _ = model
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError):
        Engine(tq, cfg, QuantPolicy.llama_flex(), max_seq_len=S)
