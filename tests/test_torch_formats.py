"""The port's W4A8, W4A16, W8A8 and W8A16 formats and the quantized lm_head
vs flexq_tpu on the CPU.

Packing and quantize_linear byte-identical; the exact W4A8 / W8A8 GEMMs'
plain versions (integer partials, f32 accumulation over the groups in the
kernels' order) within 1e-6 of max |out| of the Pallas kernels in interpret
mode; the W4A16 GEMM within 1e-5 (the order of the f32 sums differs); then a
tiny LLaMA (2 layers, hidden 256, head_dim 128, GQA 2:1, FFN 512, vocab 250,
so the packed head is padded to 256 and sliced back) in f32:
forward_serve logits on four prompt seeds within 1e-4 of max |logit| through
the W*Ax layer (each activation producer at most one code off the
reference's, and the reference's codes handed on; see
``on_reference_codes``) and 1e-2 through the W*A16 prefill (it rounds every
GEMM input to bf16; see tests/test_torch_prefill.py), and greedy
Engine.generate tokens equal on prompts without near-ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexq_tpu.config import ModelConfig as JModelConfig, QuantPolicy as JQuantPolicy
from flexq_tpu.kernels.w4_matmul import w4_matmul as j_w4_matmul, w4_matmul_bf16 as j_w4_matmul_bf16
from flexq_tpu.kernels.w8_matmul import w8_matmul as j_w8_matmul
from flexq_tpu.models import quantized as j_quantized
from flexq_tpu.models.quantized import (
    _qlinear as j_qlinear,
    _qlinear_bf16 as j_qlinear_bf16,
    forward_serve as j_forward_serve,
    quantize_linear as j_quantize_linear,
    quantize_params as j_quantize_params,
)
from flexq_tpu.packing.pack4 import pack4 as j_pack4, unpack4 as j_unpack4
from flexq_tpu.quant.quantizer import QuantSpec as JQuantSpec
from flexq_tpu.serve import Engine as JEngine
from flexq_tpu.train.trainer import init_params
from flexq_tpu_torch.config import ModelConfig, QuantPolicy
from flexq_tpu_torch.convert import params_from_numpy
from flexq_tpu_torch.kernels import launch_counts, w4_matmul, w4_matmul_bf16, w8_matmul
from flexq_tpu_torch.models import quantized
from flexq_tpu_torch.models.quantized import _qlinear, _qlinear_bf16, forward_serve, quantize_linear, quantize_params
from flexq_tpu_torch.packing.pack4 import pack4, unpack4
from flexq_tpu_torch.quant.quantizer import QuantSpec
from flexq_tpu_torch.serve import Engine

KW = dict(vocab_size=250, hidden_size=256, intermediate_size=512, num_layers=2,
          num_heads=2, num_kv_heads=1, max_seq_len=256)
S = 256

# policy name -> (the reference's policy, the port's policy)
POLICIES = {
    "W4A8": (JQuantPolicy.uniform(wbits=4, abits=8), QuantPolicy.uniform(wbits=4, abits=8)),
    "W8A8": (JQuantPolicy.uniform(wbits=8, abits=8), QuantPolicy.uniform(wbits=8, abits=8)),
    "W4A16": (JQuantPolicy.weight_only(wbits=4), QuantPolicy.weight_only(wbits=4)),
    "W8A16": (JQuantPolicy.weight_only(wbits=8), QuantPolicy.weight_only(wbits=8)),
    "W6Ax+head": (JQuantPolicy.llama_flex().with_head(6, 8), QuantPolicy.llama_flex().with_head(6, 8)),
    "W4A16+head": (JQuantPolicy.weight_only(wbits=4).with_head(4, 16),
                   QuantPolicy.weight_only(wbits=4).with_head(4, 16)),
}


def close(got, ref, tol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("name", [*POLICIES, "fp16"])
def test_policy_presets_match_jax(name):
    jpol, pol = POLICIES.get(name, (JQuantPolicy.fp16(), QuantPolicy.fp16()))
    assert (pol.weight_bits, pol.act_bits) == (jpol.weight_bits, jpol.act_bits)
    assert (pol.no_act_quant, pol.is_weight_only) == (jpol.no_act_quant, jpol.is_weight_only)


def test_pack4_unpack4_byte_identical():
    w = np.random.default_rng(0).integers(-8, 8, (384, 200)).astype(np.int8)
    pt = pack4(torch.from_numpy(w))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(j_pack4(jnp.asarray(w))))
    np.testing.assert_array_equal(unpack4(pt).numpy(), np.asarray(j_unpack4(jnp.asarray(pt.numpy()))))
    np.testing.assert_array_equal(unpack4(pt).numpy(), w)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("k,n,k_pad", [(200, 300, 256), (128, 2100, None)])
def test_quantize_linear_byte_identical(bits, k, n, k_pad):
    # ragged K zero-padded to k_pad; N padded to 384 (< 2048) or 3072
    w = np.random.default_rng(bits + n).standard_normal((k, n)).astype(np.float32)
    ref = j_quantize_linear(jnp.asarray(w), JQuantSpec(bits, True, 128), k_pad_to=k_pad)
    got = quantize_linear(torch.from_numpy(w), QuantSpec(bits, True, 128), k_pad_to=k_pad)
    assert set(got) == set(ref) == {"q4" if bits == 4 else "q8", "scale"}
    for leaf in ref:
        assert got[leaf].dtype == (torch.float32 if leaf == "scale" else torch.int8)
        np.testing.assert_array_equal(got[leaf].numpy(), np.asarray(ref[leaf]))


@pytest.mark.parametrize("fmt", ["w4", "w8"])
@pytest.mark.parametrize("m,k,n", [(4, 256, 384), (40, 256, 384), (4, 512, 256)])
def test_int_matmul_matches_jax(fmt, m, k, n):
    # (4, 512, 256) is K-tall: on the card, route B splits K over blocks there
    rng = np.random.default_rng(m + k + (fmt == "w8"))
    xq = rng.integers(-128, 128, (m, k)).astype(np.int8)
    xs = rng.uniform(0.001, 0.1, (m, k // 128)).astype(np.float32)
    ws = rng.uniform(0.001, 0.05, (k // 128, n)).astype(np.float32)
    if fmt == "w4":
        w = pack4(torch.from_numpy(rng.integers(-8, 8, (k, n)).astype(np.int8)))
        j_fn, fn = j_w4_matmul, w4_matmul
    else:
        w = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8))
        j_fn, fn = j_w8_matmul, w8_matmul
    ref = np.asarray(j_fn(jnp.asarray(xq), jnp.asarray(xs), jnp.asarray(w.numpy()), jnp.asarray(ws),
                          out_dtype=jnp.float32))
    got = fn(torch.from_numpy(xq), torch.from_numpy(xs), w, torch.from_numpy(ws), out_dtype=torch.float32)
    close(got.numpy(), ref, 1e-6)
    assert sum(launch_counts().values()) == 0  # CPU tensors never launch a kernel


@pytest.mark.parametrize("rope", [False, True])
def test_w4_matmul_bf16_matches_jax(rope):
    rng = np.random.default_rng(5 + rope)
    m, k, n = 40, 256, 384  # ragged M: the kernel masks it, the reference pads
    x = rng.standard_normal((m, k)).astype(np.float32)
    q4 = pack4(torch.from_numpy(rng.integers(-8, 8, (k, n)).astype(np.int8))).numpy()
    ws = rng.uniform(0.001, 0.05, (k // 128, n)).astype(np.float32)
    kw = {}
    if rope:
        kw = dict(rope_cos=rng.uniform(-1, 1, (m, 128)).astype(np.float32),
                  rope_sin2=rng.uniform(-1, 1, (m, 128)).astype(np.float32))
    ref = j_w4_matmul_bf16(jnp.asarray(x), jnp.asarray(q4), jnp.asarray(ws), out_dtype=jnp.float32,
                           **{a: jnp.asarray(v) for a, v in kw.items()})
    got = w4_matmul_bf16(torch.from_numpy(x), torch.from_numpy(q4), torch.from_numpy(ws), out_dtype=torch.float32,
                         **{a: torch.from_numpy(v) for a, v in kw.items()})
    close(got.numpy(), ref, 1e-5)
    assert sum(launch_counts().values()) == 0


@pytest.mark.parametrize("bits", [6, 4, 8, 16])
def test_qlinear_branches_match_jax(bits):
    # each weight kind through both linears of the serve graph, with a bias
    # at the plane width and the slice back to N: the exact W*Ax linear (16
    # bits: the input dequantized per group, then a plain product) and the
    # W*A16 linear (8 bits: the weight dequantized, then a plain product)
    rng = np.random.default_rng(bits)
    m, k, n = 6, 256, 300
    w = rng.standard_normal((k, n)).astype(np.float32)
    wj = {"w": jnp.asarray(w)} if bits == 16 else dict(j_quantize_linear(jnp.asarray(w), JQuantSpec(bits, True, 128)))
    wj["b"] = jnp.asarray(rng.standard_normal(wj["w" if bits == 16 else "scale"].shape[1]).astype(np.float32))
    wt = params_from_numpy(jax.tree_util.tree_map(np.asarray, wj), device="cpu")
    xq = rng.integers(-128, 128, (m, k)).astype(np.int8)
    xs = rng.uniform(0.001, 0.1, (m, k // 128)).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    ref = j_qlinear(wj, jnp.asarray(xq), jnp.asarray(xs), jnp.float32, n)
    got = _qlinear(wt, torch.from_numpy(xq), torch.from_numpy(xs), torch.float32, n)
    close(got.numpy(), ref, 1e-6 if bits < 16 else 1e-5)
    ref = j_qlinear_bf16(wj, jnp.asarray(x), jnp.float32, n)
    got = _qlinear_bf16(wt, torch.from_numpy(x), torch.float32, n)
    close(got.numpy(), ref, 1e-5)


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = JModelConfig.llama(**KW), ModelConfig.llama(**KW)
    dense = jax.tree_util.tree_map(np.asarray, init_params(jcfg, seed=0))
    # scale the init so the tiny model's greedy choices are not near-ties
    dense = jax.tree_util.tree_map(lambda a: a * 4.0 if a.ndim == 2 else a, dense)
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


def prompts_of(length, seed=29):
    # seed 29: greedy paths with no near-tie under any policy of the token
    # test at 80 tokens (top-2 margin above 1 % of max |logit| for five
    # tokens; seed 3 meets 0.13 % under W4A8)
    return np.random.default_rng(seed).integers(0, 256, (2, length)) % KW["vocab_size"]


PRODUCERS = ("rmsnorm_quant", "quant_act", "glu_quant")


def on_reference_codes(monkeypatch):
    """Record the codes and scales of every activation producer call of the
    reference's forward; the port's producers, called in the same order,
    check their own against them and pass the reference's on. An input one
    f32 ulp off the reference's (the exact GEMMs' plain sums agree with the
    Pallas kernels to 1e-6, not bit for bit) can cross a rounding boundary
    and move one code, which the later layers would carry to ~1 % of the
    logits; handing on the reference's codes keeps each layer's comparison
    to the layer itself. Returns the list of calls not yet consumed."""
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


@pytest.mark.parametrize("length", [8, 80])
@pytest.mark.parametrize("name", ["W4A8", "W8A8", "W6Ax+head"])
def test_forward_serve_formats_match_jax(model, name, length, monkeypatch):
    jcfg, cfg, dense, tree = model
    jq, tq = tree(name)
    jpol, pol = POLICIES[name]
    if length == 8:  # the port builds the same tree (packed head included) from the dense weights
        assert_tree_equal(quantize_params(dense, cfg, pol, dtype=torch.float32, device="cpu"), jq)
    # the prompt: the W*Ax layer below 64 tokens, on the reference's
    # producer codes; the W*A16 prefill from 64 tokens, whose bf16 roundings
    # move the head's input codes of W6Ax+head by far more than one (decode
    # steps: test_generate_formats_match_jax); a few prompt seeds
    calls = on_reference_codes(monkeypatch) if length < 64 else []
    for seed in range(4):
        ids, shape = prompts_of(length, seed), (2, 2, 1, S, 128)
        ref, _ = j_forward_serve(jq, jcfg, jpol, jnp.asarray(ids), kv_k=jnp.zeros(shape), kv_v=jnp.zeros(shape),
                                 cache_pos=jnp.int32(0), prefill_bf16=length >= 64)
        got, _ = forward_serve(tq, cfg, pol, torch.from_numpy(ids), kv_k=torch.zeros(shape),
                               kv_v=torch.zeros(shape), cache_pos=0, prefill_bf16=length >= 64, device="cpu")
        assert not calls  # every producer call of the reference was met by one of the port's
        assert got.shape == (2, length, KW["vocab_size"])
        close(got.numpy(), ref, 1e-2 if length >= 64 else 1e-4)


@pytest.mark.parametrize("name", ["W4A8", "W4A16", "W8A8", "W8A16", "W4A16+head"])
def test_generate_formats_match_jax(model, name):
    jcfg, cfg, dense, tree = model
    jq, tq = tree(name)
    jpol, pol = POLICIES[name]
    assert_tree_equal(tq, jq)  # params_from_numpy carries q4 / q8 trees and packed heads as they are
    prompts = prompts_of(80)  # the W*A16 prefill, then W*Ax (or W*A16) decode
    ref = JEngine(jq, jcfg, jpol, max_seq_len=S, kv_dtype=jnp.float32).generate(
        prompts.tolist(), max_new_tokens=5, eos_id=-1)
    eng = Engine(tq, cfg, pol, max_seq_len=S, kv_dtype=torch.float32, device="cpu")
    assert eng.generate(prompts, max_new_tokens=5, eos_id=-1) == ref
    assert sum(launch_counts().values()) == 0
