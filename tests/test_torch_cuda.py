"""Each Hopper kernel of flexq_tpu_torch against its plain PyTorch version on
the card, at small shapes. Every test needs a CUDA device and skips without
one. This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Tolerances: the W6Ax kernel is bit-exact; the producers may move a quantized
value by 1 on at most 0.1 % of entries (the RMS sum order differs); attention
sums in another order (2e-2 of max |out|, bf16 output).
"""

import numpy as np
import pytest
import torch

from flexq_tpu_torch.kernels import (
    flash_decode,
    flash_prefill,
    glu_quant,
    launch_counts,
    quant_act,
    reset_launch_counts,
    rmsnorm_quant,
    w6_matmul,
)
from flexq_tpu_torch.kernels.attend_cache import attend_cache_plain
from flexq_tpu_torch.kernels.fused_quant import (
    glu_quant_plain,
    quant_act_plain,
    rmsnorm_quant_plain,
)
from flexq_tpu_torch.kernels.w6_matmul import w6_matmul_plain
from flexq_tpu_torch.packing.pack6 import pack6

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    reset_launch_counts()
    return torch.Generator(device="cuda").manual_seed(0)


def randn(gen, *shape, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def assert_quant_close(got, want):
    dq = (got[0].int() - want[0].int()).abs()
    assert dq.max().item() <= 1 and (dq > 0).float().mean().item() <= 1e-3
    rel = ((got[1] - want[1]).abs() / want[1]).max().item()
    assert rel <= 1e-2
    for g, w in zip(got[2:], want[2:]):  # residual out: exact
        assert torch.equal(g, w)


@pytest.mark.parametrize("residual", [False, True])
def test_rmsnorm_quant_kernel(gen, residual):
    x, gamma = randn(gen, 8, 512), 1 + 0.1 * randn(gen, 512)
    res = randn(gen, 8, 512) if residual else None
    got = rmsnorm_quant(x, gamma, 6, residual=res)
    assert_quant_close(got, rmsnorm_quant_plain(x, gamma, 6, residual=res))
    assert launch_counts()["rmsnorm_quant"] == 1


def test_quant_act_kernel(gen):
    x = 3 * randn(gen, 8, 384)
    assert_quant_close(quant_act(x, 6), quant_act_plain(x, 6))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_glu_quant_kernel(gen, act):
    g, u = 2 * randn(gen, 8, 1152), randn(gen, 8, 1152)
    assert_quant_close(glu_quant(g, u, 8, act=act), glu_quant_plain(g, u, 8, act=act))


@pytest.mark.parametrize("m,k,n", [(4, 512, 1024), (40, 512, 1024), (4, 1024, 512)])
def test_w6_matmul_kernel_bit_exact(gen, m, k, n):
    xq = torch.randint(-128, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
    xs = torch.rand((m, k // 128), generator=gen, device="cuda") * 0.05 + 1e-3
    hi, lo = pack6(torch.randint(-32, 32, (k, n), generator=gen, device="cuda", dtype=torch.int8))
    ws = torch.rand((k // 128, n), generator=gen, device="cuda") * 0.01 + 1e-4
    for dt in (torch.float32, torch.bfloat16):
        got = w6_matmul(xq, xs, hi, lo, ws, out_dtype=dt)
        assert torch.equal(got, w6_matmul_plain(xq, xs, hi, lo, ws, dt))
    stream = m <= 32 and k > n
    assert launch_counts()["w6_matmul_stream" if stream else "w6_matmul"] == 2


@pytest.mark.parametrize("lq", [1, 5])
@pytest.mark.parametrize("window", [None, 50])
def test_attend_cache_kernel(gen, lq, window):
    b, h, kvh, s, d = 2, 4, 2, 256, 128
    kc, vc = randn(gen, 2, b, kvh, s, d), randn(gen, 2, b, kvh, s, d)
    q = randn(gen, b, lq, h, d)
    lengths = torch.tensor([37, 200], dtype=torch.int32, device="cuda")
    if lq == 1:
        got = flash_decode(q[:, 0], kc, vc, lengths, layer_idx=1, window=window).reshape(b, 1, h * d)
    else:
        got = flash_prefill(q, kc, vc, lengths, layer_idx=1, window=window)
    want = attend_cache_plain(q, kc, vc, lengths, 1, window, torch.bfloat16, lq == 1, torch.bfloat16)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2e-2 * want.float().abs().max().item()
    assert np.isfinite(err)
