"""The port's plain kernel versions vs flexq_tpu's Pallas kernels (interpret
mode on the CPU), on the same numpy inputs.

Tolerances: the producers are bit-exact where the arithmetic is the same
(quant_act; rmsnorm_quant up to the RMS sum order, scales within rtol
1e-6); the GLU producer's exp/tanh come from different libm builds, so a
quantized value may move by 1 on at most 0.1 % of entries; the W6Ax GEMM's
integer part is exact and its f32 accumulation follows the kernel's order
(rtol 1e-6 of max |out|); attention sums in another order (f32: 1e-5, bf16
output: 2e-2 of max |out|).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from flexq_tpu.kernels.flash_decode import flash_decode as j_flash_decode
from flexq_tpu.kernels.flash_prefill import flash_prefill as j_flash_prefill
from flexq_tpu.kernels.fused_quant import (
    glu_quant as j_glu_quant,
    quant_act as j_quant_act,
    rmsnorm_quant as j_rmsnorm_quant,
)
from flexq_tpu.kernels.w6_matmul import w6_matmul as j_w6_matmul
from flexq_tpu_torch.convert import params_from_numpy
from flexq_tpu_torch.kernels import (
    flash_decode,
    flash_prefill,
    glu_quant,
    launch_counts,
    quant_act,
    rmsnorm_quant,
    w4_matmul,
    w6_matmul,
    w8_matmul,
)
from flexq_tpu_torch.kernels.fused_quant import STAT_MAX_K, check_width
from flexq_tpu_torch.kernels.int_matmul import STREAM_MAX_M, W6AX_MMA, W6AX_STREAM, plain_weight, w6ax_route
from flexq_tpu_torch.packing.pack6 import pack6, unpack6


def to_t(a: np.ndarray) -> torch.Tensor:
    return params_from_numpy(np.asarray(a), device="cpu")


def bf16(a: np.ndarray) -> np.ndarray:
    return a.astype(np.float32).astype(ml_dtypes.bfloat16)


@pytest.mark.parametrize("bits", [6, 8])
@pytest.mark.parametrize("residual", [False, True])
def test_rmsnorm_quant_matches_jax(bits, residual):
    rng = np.random.default_rng(bits + 10 * residual)
    x = bf16(rng.standard_normal((12, 512)))
    g = bf16(1.0 + 0.1 * rng.standard_normal(512))
    r = bf16(rng.standard_normal((12, 512))) if residual else None
    ref = j_rmsnorm_quant(jnp.asarray(x), jnp.asarray(g), bits=bits, eps=1e-5,
                          residual=None if r is None else jnp.asarray(r))
    got = rmsnorm_quant(to_t(x), to_t(g), bits=bits, eps=1e-5,
                        residual=None if r is None else to_t(r))
    assert len(got) == len(ref) == (3 if residual else 2)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-6)
    if residual:
        np.testing.assert_array_equal(got[2].view(torch.int16).numpy(), np.asarray(ref[2]).view(np.int16))


def test_quant_act_bit_exact():
    x = bf16(np.random.default_rng(2).standard_normal((9, 384)) * 3)
    qj, sj = j_quant_act(jnp.asarray(x), bits=6)
    qt, st = quant_act(to_t(x), bits=6)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_glu_quant_matches_jax(act):
    rng = np.random.default_rng(3)
    gate = bf16(rng.standard_normal((16, 512)) * 2)
    up = bf16(rng.standard_normal((16, 512)))
    qj, sj = j_glu_quant(jnp.asarray(gate), jnp.asarray(up), bits=8, act=act)
    qt, st = glu_quant(to_t(gate), to_t(up), bits=8, act=act)
    diff = np.abs(qt.numpy().astype(np.int32) - np.asarray(qj).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5)


@pytest.mark.parametrize("m,k,n", [(4, 256, 384), (40, 256, 384), (4, 512, 256), (72, 384, 256)])
def test_w6_matmul_matches_jax(m, k, n):
    # (4, 512, 256) is K-tall: both packages dispatch it to the stream kernel;
    # (72, 384, 256) holds more rows than a 64-row tile, three groups, and
    # codes at the ends of the 8-bit and 6-bit ranges
    rng = np.random.default_rng(m + k)
    xq = rng.integers(-128, 128, (m, k)).astype(np.int8)
    xs = rng.uniform(0.001, 0.1, (m, k // 128)).astype(np.float32)
    w = rng.integers(-32, 32, (k, n)).astype(np.int8)
    if m > 64:
        xq[:, ::3], xq[:, 1::3] = -128, 127
        w[::2], w[1::4] = -32, 31
    ws = rng.uniform(0.001, 0.05, (k // 128, n)).astype(np.float32)
    hi, lo = pack6(torch.from_numpy(w))
    ref = np.asarray(j_w6_matmul(jnp.asarray(xq), jnp.asarray(xs), jnp.asarray(hi.numpy()),
                                 jnp.asarray(lo.numpy()), jnp.asarray(ws), out_dtype=jnp.float32))
    got = w6_matmul(to_t(xq), to_t(xs), hi, lo, to_t(ws), out_dtype=torch.float32).numpy()
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    assert sum(launch_counts().values()) == 0  # CPU tensors never launch a kernel


def test_plain_weight_unpacks_once_as_int8():
    """The plain GEMMs' CPU weight: unpacked once to int8 and kept while the
    planes live unchanged; a write to a plane unpacks it again."""
    w = torch.from_numpy(np.random.default_rng(5).integers(-32, 32, (256, 128)).astype(np.int8))
    hi, lo = pack6(w)
    got = plain_weight((hi, lo), unpack6)
    assert got.dtype == torch.int8 and torch.equal(got, w)
    assert plain_weight((hi, lo), unpack6) is got
    w[0, 0] = -w[0, 0] - 1
    hi2, lo2 = pack6(w)
    hi.copy_(hi2), lo.copy_(lo2)
    again = plain_weight((hi, lo), unpack6)
    assert again is not got and torch.equal(again, w)


@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 11264), (11264, 4096), (4096, 16384), (4096, 32768)])
def test_w6ax_route_threshold(k, n):
    """The W6Ax GEMM's route at the main path's (K, N): the streaming kernel
    up to the measured threshold, the tensor cores above it."""
    t = STREAM_MAX_M[6]
    assert [w6ax_route(m, k, n) for m in (1, 4, 8, t, t + 1, 128, 2048)] == [W6AX_STREAM] * 4 + [W6AX_MMA] * 3


def test_int_gemm_route_per_format_and_producer_refusals():
    """The host-side logic of the exact GEMM's formats and the producers:
    each format's route threshold (W8's streaming stages hold at most 32
    rows), the widths each producer MODE takes, and the wrappers' refusals,
    all before any launch."""
    for fmt, t in STREAM_MAX_M.items():
        assert [w6ax_route(m, 4096, 11264, fmt) for m in (1, t, t + 1, 128)] == [W6AX_STREAM] * 2 + [W6AX_MMA] * 2
    assert STREAM_MAX_M[8] <= 32
    assert all(w6ax_route(m, 4096, 4096) == w6ax_route(m, 4096, 4096, 6) for m in (1, 8, 9, 64))
    for mode in (1, 2, 4, 5):  # RMS / LayerNorm: a row held in one block
        check_width(mode, STAT_MAX_K)
        with pytest.raises(ValueError, match="at most"):
            check_width(mode, STAT_MAX_K + 128)
    for mode in (0, 3, 6):  # no row statistic: any multiple of 128 (OPT-66B's FFN)
        check_width(mode, 36864)
    with pytest.raises(ValueError, match="multiple of 128"):
        check_width(0, 200)
    x = torch.zeros((2, 256), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported activation"):
        glu_quant(x, x, 8, act="relu")
    with pytest.raises(ValueError, match="K % 128"):
        quant_act(torch.zeros((2, 200), dtype=torch.bfloat16))
    xq, xs = torch.zeros((2, 256), dtype=torch.int8), torch.ones((2, 2))
    with pytest.raises(ValueError, match="w_q4: shape"):
        w4_matmul(xq, xs, torch.zeros((256, 64), dtype=torch.int8), torch.ones((2, 64)))
    with pytest.raises(TypeError, match="w_q: dtype"):
        w8_matmul(xq, xs, torch.zeros((256, 64), dtype=torch.uint8), torch.ones((2, 64)))
    assert sum(launch_counts().values()) == 0


def _attention_inputs(dtype, lq, seed):
    rng = np.random.default_rng(seed)
    b, h, kvh, s, d, nl = 2, 4, 2, 256, 128, 2
    q = rng.standard_normal((b, lq, h, d)).astype(np.float32)
    k = rng.standard_normal((nl, b, kvh, s, d)).astype(np.float32)
    v = rng.standard_normal((nl, b, kvh, s, d)).astype(np.float32)
    if dtype == "bfloat16":
        q, k, v = bf16(q), bf16(k), bf16(v)
    lengths = np.array([37, 200], np.int32)  # ragged, one past the first key block
    return q, k, v, lengths


@pytest.mark.parametrize("window", [None, 50])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_matches_jax(dtype, window):
    q, k, v, lengths = _attention_inputs(dtype, 1, 5)
    out_j = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = np.asarray(j_flash_decode(jnp.asarray(q[:, 0]), jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(lengths), layer_idx=1, window=window,
                                    out_dtype=out_j)).astype(np.float32)
    got = flash_decode(to_t(q[:, 0]), to_t(k), to_t(v), torch.from_numpy(lengths), layer_idx=1,
                       window=window, out_dtype=getattr(torch, dtype)).float().numpy()
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("window", [None, 50])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_prefill_matches_jax(dtype, window):
    q, k, v, lengths = _attention_inputs(dtype, 5, 6)
    out_j = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = np.asarray(j_flash_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(lengths), layer_idx=1, window=window,
                                     out_dtype=out_j)).astype(np.float32)
    got = flash_prefill(to_t(q), to_t(k), to_t(v), torch.from_numpy(lengths), layer_idx=1,
                        window=window, out_dtype=getattr(torch, dtype)).float().numpy()
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()
