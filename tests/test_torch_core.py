"""flexq_tpu_torch core vs flexq_tpu: quantizer, 6-bit packing and the serve
weight tree are byte-identical; the JAX serve tree carries over to torch bit
for bit; the port imports nothing of JAX."""

import ast
import pathlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from flexq_tpu.config import ModelConfig as JModelConfig, QuantPolicy as JQuantPolicy
from flexq_tpu.models import llama as j_llama
from flexq_tpu.models.quantized import quantize_params as j_quantize_params
from flexq_tpu.packing.pack6 import pack6 as j_pack6, unpack6 as j_unpack6
from flexq_tpu.quant.quantizer import (
    QuantSpec as JQuantSpec,
    fake_quant as j_fake_quant,
    quantize as j_quantize,
)
from flexq_tpu.train.trainer import init_params
from flexq_tpu_torch.config import ModelConfig, QuantPolicy
from flexq_tpu_torch.convert import params_from_numpy
from flexq_tpu_torch.models import llama
from flexq_tpu_torch.models.quantized import quantize_params
from flexq_tpu_torch.packing.pack6 import pack6, unpack6
from flexq_tpu_torch.quant.quantizer import QuantSpec, fake_quant, quantize

ROOT = pathlib.Path(__file__).resolve().parents[1]


def same_bits(t: torch.Tensor, a: np.ndarray):
    """Exact equality, floats compared by their bits (bf16 via uint16)."""
    a = np.asarray(a)
    assert tuple(t.shape) == a.shape
    if a.dtype == ml_dtypes.bfloat16:
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
    elif a.dtype == np.float32:
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy().view(np.int32), a.view(np.int32))
    else:
        assert str(t.dtype).split(".")[-1] == a.dtype.name
        np.testing.assert_array_equal(t.numpy(), a)


def assert_tree_equal(port, ref):
    if isinstance(ref, dict):
        assert isinstance(port, dict) and set(port) == set(ref)
        for k in ref:
            assert_tree_equal(port[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            assert_tree_equal(p, r)
    else:
        same_bits(port, ref)


@pytest.mark.parametrize(
    "bits,symmetric,group",
    [(6, True, 128), (8, True, 128), (8, False, 128), (4, False, None)],
)
def test_quantize_byte_identical(bits, symmetric, group):
    # K = 300 pads to 384 per group; N = 200 is ragged
    x = np.random.default_rng(bits).standard_normal((200, 300)).astype(np.float32)
    qj, sj, zj = j_quantize(jnp.asarray(x), JQuantSpec(bits, symmetric, group))
    qt, st, zt = quantize(torch.from_numpy(x), QuantSpec(bits, symmetric, group))
    same_bits(qt, np.asarray(qj))
    same_bits(st, np.asarray(sj))
    if zj is None:
        assert zt is None
    else:
        same_bits(zt, np.asarray(zj))
    spec_j, spec_t = JQuantSpec(bits, symmetric, group), QuantSpec(bits, symmetric, group)
    same_bits(fake_quant(torch.from_numpy(x), spec_t), np.asarray(j_fake_quant(jnp.asarray(x), spec_j)))


def test_pack6_unpack6_byte_identical():
    w = np.random.default_rng(0).integers(-32, 32, (384, 200)).astype(np.int8)
    hj, lj = j_pack6(jnp.asarray(w))
    ht, lt = pack6(torch.from_numpy(w))
    same_bits(ht, np.asarray(hj))
    same_bits(lt, np.asarray(lj))
    same_bits(unpack6(ht, lt), np.asarray(j_unpack6(hj, lj)))
    np.testing.assert_array_equal(unpack6(ht, lt).numpy(), w)


def test_llama_helpers_match_jax():
    rng = np.random.default_rng(4)
    pos = rng.integers(0, 4096, (2, 5))
    scaling = (8.0, 1.0, 4.0, 8192)  # LLaMA-3.1 rope scaling
    for sc in (None, scaling):
        cj, sj = j_llama.rope_cos_sin(jnp.asarray(pos), 128, 500000.0, sc)
        ct, st = llama.rope_cos_sin(torch.from_numpy(pos), 128, 500000.0, sc)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=2e-6)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=2e-6)
    q = rng.standard_normal((2, 5, 4, 128)).astype(np.float32)
    k = rng.standard_normal((2, 5, 2, 128)).astype(np.float32)
    qj, kj = j_llama.apply_rope(jnp.asarray(q), jnp.asarray(k), cj, sj)
    qt, kt = llama.apply_rope(torch.from_numpy(q), torch.from_numpy(k), ct, st)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=1e-5)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=1e-5)
    x = rng.standard_normal((3, 256)).astype(np.float32)
    g = rng.standard_normal(256).astype(np.float32)
    np.testing.assert_allclose(llama.rmsnorm(torch.from_numpy(x), torch.from_numpy(g), 1e-5).numpy(),
                               np.asarray(j_llama.rmsnorm(jnp.asarray(x), jnp.asarray(g), 1e-5)), rtol=1e-6)
    for act in ("silu", "gelu"):
        np.testing.assert_allclose(llama.act_fn(act, torch.from_numpy(x)).numpy(),
                                   np.asarray(j_llama.act_fn(act, jnp.asarray(x))), rtol=1e-5, atol=1e-6)


def _cfgs():
    kw = dict(vocab_size=256, hidden_size=256, intermediate_size=320, num_layers=2,
              num_heads=2, num_kv_heads=1, max_seq_len=128)
    return JModelConfig.llama(**kw), ModelConfig.llama(**kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_params_tree_identical(dtype):
    # FFN 320 exercises the N pad of gate/up and the K pad of down_proj
    jcfg, tcfg = _cfgs()
    dense = jax.tree_util.tree_map(np.asarray, init_params(jcfg, seed=3))
    ref = j_quantize_params(dense, jcfg, JQuantPolicy.llama_flex(), dtype=getattr(jnp, dtype))
    ref = jax.tree_util.tree_map(np.asarray, ref)
    got = quantize_params(dense, tcfg, QuantPolicy.llama_flex(), dtype=getattr(torch, dtype), device="cpu")
    assert_tree_equal(got, ref)
    # and the JAX tree carried over by params_from_numpy is the same tree
    assert_tree_equal(params_from_numpy(ref, device="cpu"), ref)


def test_params_from_numpy_bf16_roundtrip():
    a = np.random.default_rng(1).standard_normal((3, 5)).astype(ml_dtypes.bfloat16)
    tree = {"a": a, "l": [np.arange(4, dtype=np.int8), {"s": a.astype(np.float32)}]}
    got = params_from_numpy(tree, device="cpu")
    assert_tree_equal(got, tree)
    with pytest.raises(TypeError):
        params_from_numpy({"x": 1.0}, device="cpu")


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((ROOT / "flexq_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flexq_tpu"), f"{f} imports {name}"


def test_build_hash_covers_sources_and_headers(tmp_path, monkeypatch):
    from flexq_tpu_torch.kernels import _build

    # every CUDA source is built by build_all()
    assert set(_build.SOURCES) == {p.stem for p in (ROOT / "flexq_tpu_torch" / "csrc").glob("*.cu")}
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    paths = [_build.lib_path("k")]
    (tmp_path / "h.cuh").write_text("// v2\n")  # an edited header names a new library
    paths.append(_build.lib_path("k"))
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    paths.append(_build.lib_path("k"))
    assert len(set(paths)) == 3
