"""The port's OPT slice vs flexq_tpu on the CPU.

K14 (``layernorm_quant``, with and without the residual) and K15
(``relu_quant``): the plain versions against the Pallas kernels in interpret
mode, codes equal and scales within rtol 1e-6. Then a tiny pre-LN OPT in the
reference's tree layout, made with numpy from a seed (2 layers, hidden 256,
2 heads of 128, FFN 512, vocab 250 with the head tied to the embedding, 258
learned positions, biased linears, LayerNorm g / b), f32 weights:
the port's quantize_params tree equal to the reference's; forward_serve
logits (a prompt, then two decode steps) within 1e-4 of max |logit| through
the W*Ax layer under opt_flex (bf16 and int8 caches) and W4A8, each
activation producer at most one code off the reference's and the
reference's codes handed on (an f32-ulp difference in a producer's input,
from the plain exact GEMMs agreeing with the Pallas kernels to 1e-6, can
cross a rounding boundary; see tests/test_torch_formats.py), and within
1e-2 through the no-act-quant layer under weight-only W6A16 and fp16 (the
reference rounds every W6A16 GEMM input to bf16, and the decode attention
returns bf16 under both, whose one-ulp differences in the order of its
sums no activation quant absorbs); greedy Engine.generate tokens and a paged BatchScheduler's streams
equal to the reference's on prompts without near-ties; post-LN OPT refused.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from flexq_tpu.config import ModelConfig as JModelConfig, QuantPolicy as JQuantPolicy
from flexq_tpu.kernels.fused_quant import layernorm_quant as j_layernorm_quant, relu_quant as j_relu_quant
from flexq_tpu.models import quantized as j_quantized
from flexq_tpu.models.quantized import forward_serve as j_forward_serve, quantize_params as j_quantize_params
from flexq_tpu.serve import Engine as JEngine
from flexq_tpu.serve.scheduler import BatchScheduler as JBatchScheduler
from flexq_tpu_torch.config import ModelConfig, QuantPolicy
from flexq_tpu_torch.convert import params_from_numpy
from flexq_tpu_torch.kernels import launch_counts, layernorm_quant, relu_quant
from flexq_tpu_torch.models import quantized
from flexq_tpu_torch.models.quantized import forward_serve, quantize_params
from flexq_tpu_torch.serve import Engine
from flexq_tpu_torch.serve.scheduler import BatchScheduler

KW = dict(vocab_size=250, hidden_size=256, intermediate_size=512, num_layers=2, num_heads=2, max_seq_len=256)
S = 256

# policy name -> (the reference's policy, the port's policy)
POLICIES = {
    "opt_flex": (JQuantPolicy.opt_flex(), QuantPolicy.opt_flex()),
    "W4A8": (JQuantPolicy.uniform("opt", 4, 8), QuantPolicy.uniform("opt", 4, 8)),
    "W6A16": (JQuantPolicy.weight_only("opt", 6), QuantPolicy.weight_only("opt", 6)),
    "fp16": (JQuantPolicy.fp16("opt"), QuantPolicy.fp16("opt")),
}
KV = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16), "int8": (jnp.int8, torch.int8)}


def to_t(a: np.ndarray) -> torch.Tensor:
    return params_from_numpy(np.asarray(a), device="cpu")


def bf16(a: np.ndarray) -> np.ndarray:
    return a.astype(np.float32).astype(ml_dtypes.bfloat16)


@pytest.mark.parametrize("bits", [6, 8])
@pytest.mark.parametrize("residual", [False, True])
def test_layernorm_quant_matches_jax(bits, residual):
    rng = np.random.default_rng(bits + 10 * residual)
    x = bf16(rng.standard_normal((12, 512)) + 0.5)  # a mean off zero
    g = bf16(1.0 + 0.1 * rng.standard_normal(512))
    b = bf16(0.1 * rng.standard_normal(512))
    r = bf16(rng.standard_normal((12, 512))) if residual else None
    ref = j_layernorm_quant(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), bits=bits, eps=1e-5,
                            residual=None if r is None else jnp.asarray(r))
    got = layernorm_quant(to_t(x), to_t(g), to_t(b), bits=bits, eps=1e-5, residual=None if r is None else to_t(r))
    assert len(got) == len(ref) == (3 if residual else 2)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-6)
    if residual:
        np.testing.assert_array_equal(got[2].view(torch.int16).numpy(), np.asarray(ref[2]).view(np.int16))
    assert sum(launch_counts().values()) == 0  # CPU tensors never launch a kernel


@pytest.mark.parametrize("bits", [6, 8])
def test_relu_quant_matches_jax(bits):
    x = bf16(np.random.default_rng(bits).standard_normal((9, 1024)) * 2)
    qj, sj = j_relu_quant(jnp.asarray(x), bits=bits)
    qt, st = relu_quant(to_t(x), bits=bits)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6)


def dense_opt(seed: int = 0):
    """A tiny OPT's dense tree in the reference's layout (from_hf_opt's)."""
    rng = np.random.default_rng(seed)
    h, f, v = KW["hidden_size"], KW["intermediate_size"], KW["vocab_size"]

    def arr(shape, std, mean=0.0):
        return (mean + std * rng.standard_normal(shape)).astype(np.float32)

    def lin(k, n):
        return {"w": arr((k, n), 0.08), "b": arr(n, 0.05)}

    def norm():
        return {"g": arr(h, 0.1, 1.0), "b": arr(h, 0.1)}

    layers = [{"input_norm": norm(), "post_norm": norm(), "q_proj": lin(h, h), "k_proj": lin(h, h),
               "v_proj": lin(h, h), "o_proj": lin(h, h), "fc1": lin(h, f), "fc2": lin(f, h)}
              for _ in range(KW["num_layers"])]
    return {"embed": arr((v, h), 0.5), "pos_embed": arr((S + 2, h), 0.2), "layers": layers, "final_norm": norm()}


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = JModelConfig.opt(**KW), ModelConfig.opt(**KW)
    dense = dense_opt()
    trees = {}

    def tree(name):
        """(reference tree, the port's tree carried over by params_from_numpy)."""
        if name not in trees:
            jq = jax.tree_util.tree_map(np.asarray, j_quantize_params(dense, jcfg, POLICIES[name][0],
                                                                      dtype=jnp.float32))
            trees[name] = (jq, params_from_numpy(jq, device="cpu"))
        return trees[name]

    return jcfg, cfg, dense, tree


def assert_tree_equal(port, ref):
    if isinstance(ref, dict):
        assert set(port) == set(ref)
        for k in ref:
            assert_tree_equal(port[k], ref[k])
    elif isinstance(ref, list):
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            assert_tree_equal(p, r)
    else:
        np.testing.assert_array_equal(port.numpy(), ref)


def test_config_and_policies_match_jax():
    assert ModelConfig.opt(**KW) == ModelConfig(**{f: getattr(JModelConfig.opt(**KW), f)
                                                   for f in ModelConfig.__dataclass_fields__})
    for jpol, pol in POLICIES.values():
        assert (pol.weight_bits, pol.act_bits) == (jpol.weight_bits, jpol.act_bits)
        assert (pol.no_act_quant, pol.is_weight_only) == (jpol.no_act_quant, jpol.is_weight_only)


@pytest.mark.parametrize("name", ["opt_flex", "W4A8", "W6A16", "fp16"])
def test_quantize_params_matches_jax(model, name):
    jcfg, cfg, dense, tree = model
    jq, tq = tree(name)
    assert_tree_equal(tq, jq)  # params_from_numpy carries the OPT tree (norm dicts, pos_embed) as it is
    assert_tree_equal(quantize_params(dense, cfg, POLICIES[name][1], dtype=torch.float32, device="cpu"), jq)


PRODUCERS = ("layernorm_quant", "quant_act", "relu_quant")


def on_reference_codes(monkeypatch):
    """The reference's producer calls record their codes and scales; the
    port's, called in the same order, check theirs against them (at most
    one code off) and hand the reference's on. Returns the calls not yet
    consumed."""
    calls = []
    for name in PRODUCERS:
        def record(*a, _ref=getattr(j_quantized, name), **k):
            out = _ref(*a, **k)
            calls.append((np.array(out[0]), np.array(out[1])))
            return out

        def check(*a, _own=getattr(quantized, name), _name=name, **k):
            q, s, *rest = _own(*a, **k)
            ref_q, ref_s = calls.pop(0)
            assert (q.numpy() != ref_q).sum() <= 1, f"{_name}: more than one code off the reference"
            np.testing.assert_allclose(s.numpy(), ref_s, rtol=1e-5)
            return (torch.from_numpy(ref_q), torch.from_numpy(ref_s), *rest)

        monkeypatch.setattr(j_quantized, name, record)
        monkeypatch.setattr(quantized, name, check)
    return calls


def prompts_of(length, seed=0, batch=2):
    return np.random.default_rng(seed).integers(0, KW["vocab_size"], (batch, length))


@pytest.mark.parametrize("name,kv,tol", [("opt_flex", "bf16", 1e-4), ("opt_flex", "int8", 1e-4),
                                         ("W4A8", "f32", 1e-4), ("W6A16", "f32", 1e-2), ("fp16", "f32", 1e-2)])
def test_forward_serve_matches_jax(model, name, kv, tol, monkeypatch):
    jcfg, cfg, _, tree = model
    jq, tq = tree(name)
    jpol, pol = POLICIES[name]
    calls = on_reference_codes(monkeypatch) if not pol.no_act_quant else []
    shape = (2, 2, 2, S, 128)
    jdt, tdt = KV[kv]
    jc = [jnp.zeros(shape, jdt), jnp.zeros(shape, jdt)]
    tc = [torch.zeros(shape, dtype=tdt), torch.zeros(shape, dtype=tdt)]
    if kv == "int8":
        jc += [jnp.zeros(shape[:-1], jnp.float32) for _ in "kv"]
        tc += [torch.zeros(shape[:-1]) for _ in "kv"]
    names = ("kv_k", "kv_v", "kv_k_scale", "kv_v_scale")
    ids, pos = prompts_of(12), 0
    for step in range(3):  # a 12-token prompt, then two decode steps
        l = ids.shape[1]
        positions = np.broadcast_to(np.arange(pos, pos + l), (2, l)).copy()
        # prefill_bf16 is passed and ignored: OPT never takes the W*A16 prefill layer
        ref, jc = j_forward_serve(jq, jcfg, jpol, jnp.asarray(ids), positions=jnp.asarray(positions),
                                  cache_pos=jnp.int32(pos), prefill_bf16=True, **dict(zip(names, jc)))
        got, tc = forward_serve(tq, cfg, pol, torch.from_numpy(ids), positions=torch.from_numpy(positions),
                                cache_pos=pos, prefill_bf16=True, device="cpu", **dict(zip(names, tc)))
        assert not calls  # every producer call of the reference was met by one of the port's
        ref = np.asarray(ref)
        assert got.shape == (2, l, KW["vocab_size"])
        assert np.abs(got.numpy() - ref).max() <= tol * np.abs(ref).max(), step
        pos += l
        ids = ref[:, -1].argmax(-1)[:, None]


@pytest.mark.parametrize("name,kv", [("opt_flex", "f32"), ("opt_flex", "int8"), ("W6A16", "f32")])
def test_generate_tokens_equal_jax(model, name, kv):
    jcfg, cfg, _, tree = model
    jq, tq = tree(name)
    jpol, pol = POLICIES[name]
    prompts = prompts_of(70)  # 70 tokens: the engine's W*A16 threshold, which OPT ignores
    ref = JEngine(jq, jcfg, jpol, max_seq_len=S, kv_dtype=KV[kv][0]).generate(
        prompts.tolist(), max_new_tokens=6, eos_id=-1)
    eng = Engine(tq, cfg, pol, max_seq_len=S, kv_dtype=KV[kv][1], device="cpu")
    assert eng.generate(prompts, max_new_tokens=6, eos_id=-1) == ref
    assert sum(launch_counts().values()) == 0


def test_scheduler_streams_equal_jax(model):
    jcfg, cfg, _, tree = model
    jq, tq = tree("opt_flex")
    jpol, pol = POLICIES["opt_flex"]
    rng = np.random.default_rng(7)
    reqs = [rng.integers(0, KW["vocab_size"], n).tolist() for n in (9, 140, 30)]
    runs = []
    for sched in (JBatchScheduler(jq, jcfg, jpol, num_slots=2, max_seq_len=S, paged=True, prefill_chunk=128,
                                  kv_dtype=jnp.bfloat16),
                  BatchScheduler(tq, cfg, pol, num_slots=2, max_seq_len=S, paged=True, prefill_chunk=128,
                                 kv_dtype=torch.bfloat16, device="cpu")):
        ids = [sched.add_request(p, max_new_tokens=6, eos_id=-1) for p in reqs[:2]]
        out = sched.step()
        ids.append(sched.add_request(reqs[2], max_new_tokens=6, eos_id=-1))  # a late arrival
        out.update(sched.run())
        runs.append(([out[i] for i in ids], sched))
    (want, jsched), (got, tsched) = runs
    assert got == want
    assert all(len(t) == 6 for t in got)
    assert tsched.pool.free_pages == jsched.pool.free_pages == tsched.pool.num_pages - 1


def test_post_ln_opt_refused(model):
    import dataclasses

    _, cfg, _, tree = model
    _, tq = tree("opt_flex")
    post_ln = dataclasses.replace(cfg, do_layer_norm_before=False)
    shape = (2, 1, 2, S, 128)
    with pytest.raises(ValueError, match="post-LN"):
        forward_serve(tq, post_ln, QuantPolicy.opt_flex(), torch.from_numpy(prompts_of(4, batch=1)),
                      kv_k=torch.zeros(shape), kv_v=torch.zeros(shape), cache_pos=0, device="cpu")
    with pytest.raises(ValueError, match="post-LN"):
        Engine(tq, post_ln, QuantPolicy.opt_flex(), max_seq_len=S, kv_dtype=torch.float32,
               device="cpu").generate(prompts_of(4, batch=1), max_new_tokens=2)
