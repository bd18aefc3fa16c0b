"""Each Hopper kernel of flexq_tpu_torch against its plain PyTorch version on
the card, at small shapes. Every test needs a CUDA device and skips without
one. This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Tolerances: the exact integer kernels (W6Ax, W4A8 and W8A8, each on both routes) are bit-exact; the
producers may move a quantized value by 1 on at most 0.1 % of entries (the
RMS and LayerNorm sum orders differ; quant_act, glu_quant and relu_quant
have no sum and are bit-exact, and a residual output equals x + r); the W6A16 and W4A16 kernels (K7, K8, K11) differ from
their plain versions only in the order of f32 sums: f32 output within 1e-4
of max |out|, bf16 output within one bf16 ulp of the plain f32 result (plus
that 1e-4 for sums that cancel); attention
sums in another order (2e-2 of max |out|, bf16 output; per (b, h) row for
the paged kernel, whose rows are ragged and which rounds p against each
split's own max, and for the edge cases of the prefill kernel), over a bf16
or an int8 cache, dense or paged; the prefill kernel's tiles round p
against each key block's max as the plain version does, so at most 1 % of
their bf16 outputs part from the CPU's.
"""

import numpy as np
import pytest
import torch

from flexq_tpu_torch.config import ModelConfig
from flexq_tpu_torch.kernels import (
    flash_decode,
    flash_decode_paged,
    flash_prefill,
    glu_quant,
    launch_counts,
    layernorm_quant,
    quant_act,
    relu_quant,
    reset_launch_counts,
    rmsnorm_quant,
    w4_matmul,
    w4_matmul_bf16,
    w6_glu_fused_bf16,
    w6_glu_matmul_bf16,
    w6_matmul,
    w6_matmul_bf16,
    w8_matmul,
)
from flexq_tpu_torch.kernels.attend_cache import attend_cache_plain
from flexq_tpu_torch.kernels.flash_decode import flash_decode_paged_plain
from flexq_tpu_torch.kernels import fused_quant
from flexq_tpu_torch.kernels.fused_quant import (
    glu_quant_plain,
    layernorm_quant_plain,
    quant_act_plain,
    relu_quant_plain,
    rmsnorm_quant_plain,
)
from flexq_tpu_torch.kernels.w6_bf16 import w6_glu_bf16_plain, w6_matmul_bf16_plain
from flexq_tpu_torch.kernels.w4_matmul import w4_matmul_bf16_plain, w4_matmul_plain
from flexq_tpu_torch.kernels.int_matmul import (
    STREAM_MAX_M,
    W6AX_MMA,
    W6AX_STREAM,
    geometry,
    launch,
    stream_takes,
    w6ax_route,
)
from flexq_tpu_torch.kernels.w6_matmul import w6_matmul_plain
from flexq_tpu_torch.kernels.w8_matmul import w8_matmul_plain
from flexq_tpu_torch.models.llama import rope_for_cfg
from flexq_tpu_torch.packing.pack4 import pack4
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


@pytest.mark.parametrize("bits", [6, 8])
@pytest.mark.parametrize("residual", [False, True])
def test_layernorm_quant_kernel(gen, bits, residual):
    x, gamma, beta = randn(gen, 8, 512) + 0.5, 1 + 0.1 * randn(gen, 512), 0.1 * randn(gen, 512)
    res = randn(gen, 8, 512) if residual else None
    got = layernorm_quant(x, gamma, beta, bits, residual=res)
    assert_quant_close(got, layernorm_quant_plain(x, gamma, beta, bits, residual=res))
    assert launch_counts()["layernorm_quant"] == 1


@pytest.mark.parametrize("k", [1152, 16384])  # 16384: OPT-6.7B's FFN, BLOCK 16384 at 16 warps
def test_relu_quant_kernel(gen, k):
    x = 2 * randn(gen, 4, k)
    got, want = relu_quant(x, 6), relu_quant_plain(x, 6)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert launch_counts()["relu_quant"] == 1


PRODUCERS = ("rms", "rms+res", "quant_act", "glu silu", "glu gelu", "ln", "ln+res", "relu")


def producer_call(gen, what, m, k, dtype, bits=6):
    """(kernel call, plain call) of one producer MODE on rows [m, k]."""
    x = (3 * torch.randn((m, k), generator=gen, device="cuda") + 0.5).to(dtype)
    r = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    g = (1 + 0.1 * torch.randn(k, generator=gen, device="cuda")).to(dtype)
    b = (0.1 * torch.randn(k, generator=gen, device="cuda")).to(torch.float32)  # bf16 rows: another dtype than gamma's
    res = r if what.endswith("+res") else None
    if what.startswith("rms"):
        return (lambda: rmsnorm_quant(x, g, bits, residual=res)), (lambda: rmsnorm_quant_plain(x, g, bits, residual=res))
    if what.startswith("ln"):
        return ((lambda: layernorm_quant(x, g, b, bits, residual=res)),
                (lambda: layernorm_quant_plain(x, g, b, bits, residual=res)))
    if what.startswith("glu"):
        act = what.split()[1]
        return (lambda: glu_quant(x, r, bits, act=act)), (lambda: glu_quant_plain(x, r, bits, act=act))
    if what == "relu":
        return (lambda: relu_quant(x, bits)), (lambda: relu_quant_plain(x, bits))
    return (lambda: quant_act(x, bits)), (lambda: quant_act_plain(x, bits))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 7, 133])
@pytest.mark.parametrize("k", [128, 384, 4096, 11264, 16384])
@pytest.mark.parametrize("what", PRODUCERS)
def test_row_quant_modes(gen, what, k, m, dtype):
    """Every MODE of csrc/row_quant.cu at one group, an odd group count, the
    7B hidden and FFN widths and OPT-6.7B's FFN (the widest row one block of
    the statistic modes holds), ragged M, bf16 and f32 rows: within the
    producers' tolerance, bit-exact where no sum's order can differ (the
    identity, the GLU, ReLU), the residual output equal to x + r, one launch
    counted at M."""
    kern, plain = producer_call(gen, what, m, k, dtype)
    got, want = kern(), plain()
    if what.startswith(("rms", "ln")):
        assert_quant_close(got, want)
    else:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if what.endswith("+res"):
        assert torch.equal(got[2], want[2])
    name = {"rms": "rmsnorm_quant", "ln": "layernorm_quant", "glu": "glu_quant", "relu": "relu_quant"}.get(
        what.split("+")[0].split()[0], "quant_act")
    fn = {f.__name__: f for f in (rmsnorm_quant, layernorm_quant, glu_quant, relu_quant, quant_act)}[name]
    assert launch_counts()[name] == 1 and fn.launches_by_m == {m: 1}


@pytest.mark.parametrize("what", ["rms", "rms+res", "ln", "ln+res"])
def test_row_quant_rows_do_not_depend_on_m(gen, what):
    """The statistic modes take another block shape once the rows fill the
    card (M = 2048) than at decode; a row's codes, scale and residual output
    are the same bits either way (the sums keep one order)."""
    x = (3 * torch.randn((2048, 4096), generator=gen, device="cuda") + 0.5).to(torch.bfloat16)
    r = torch.randn((2048, 4096), generator=gen, device="cuda").to(torch.bfloat16)
    g = (1 + 0.1 * torch.randn(4096, generator=gen, device="cuda")).to(torch.bfloat16)
    b = (0.1 * torch.randn(4096, generator=gen, device="cuda")).to(torch.bfloat16)
    if what.startswith("rms"):
        call = lambda rows: rmsnorm_quant(x[:rows], g, 6, residual=r[:rows] if what.endswith("+res") else None)  # noqa: E731
    else:
        call = lambda rows: layernorm_quant(x[:rows], g, b, 6, residual=r[:rows] if what.endswith("+res") else None)  # noqa: E731
    full, few = call(2048), call(4)
    assert all(torch.equal(f[:4], w) for f, w in zip(full, few))


def test_row_quant_widths(gen):
    """The modes without a row statistic take any multiple of 128 (OPT-66B's
    FFN, 36864, too); the statistic modes refuse rows wider than they hold,
    before any launch."""
    x = (2 * torch.randn((3, 36864), generator=gen, device="cuda")).to(torch.bfloat16)
    for kern, plain in ((relu_quant, relu_quant_plain), (quant_act, quant_act_plain)):
        got, want = kern(x, 6), plain(x, 6)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    wide = torch.zeros((2, fused_quant.STAT_MAX_K + 128), dtype=torch.bfloat16, device="cuda")
    gamma = torch.ones(wide.shape[1], dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="at most"):
        rmsnorm_quant(wide, gamma, 6)
    assert launch_counts()["rmsnorm_quant"] == 0


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


def w6ax_operands(gen, m, k, n, ends):
    """Codes and weights for the W6Ax GEMM; ``ends``: 8-bit codes and 6-bit
    weights at both ends of their ranges (the largest |P|), else random
    6-bit codes."""
    lim = 128 if ends else 32
    xq = torch.randint(-lim, lim, (m, k), generator=gen, device="cuda", dtype=torch.int8)
    w = torch.randint(-32, 32, (k, n), generator=gen, device="cuda", dtype=torch.int8)
    if ends:
        xq[:, ::3], xq[:, 1::3] = -128, 127
        w[::2], w[1::4] = -32, 31
    xs = torch.rand((m, k // 128), generator=gen, device="cuda") * 0.05 + 1e-3
    ws = torch.rand((k // 128, n), generator=gen, device="cuda") * 0.01 + 1e-4
    return (xq, xs, *pack6(w), ws)


@pytest.mark.parametrize("ends", [False, True])
@pytest.mark.parametrize("k", [128, 384, 11264, 16384])  # one group, an odd count, LLaMA's and OPT's FFN
@pytest.mark.parametrize("m", [1, 8, 32, 33, 64, 130, 256, 2048])
def test_w6ax_kernel_bit_exact(gen, m, k, ends):
    """K2 / K3 on csrc/w6ax_matmul.cu, whichever route w6ax_route picks,
    equal to the plain version in f32 and bf16; K > N at M <= 32 is K3's."""
    n = 256
    ops = w6ax_operands(gen, m, k, n, ends)
    for dt in (torch.float32, torch.bfloat16):
        assert torch.equal(w6_matmul(*ops, out_dtype=dt), w6_matmul_plain(*ops, dt))
    assert launch_counts()["w6_matmul_stream" if m <= 32 and k > n else "w6_matmul"] == 2


@pytest.mark.parametrize("k,n", [(4096, 4096), (11264, 4096), (4096, 11264)])
def test_w6ax_routes_meet_at_the_threshold(gen, k, n):
    """Both routes bit-exact on both sides of the route threshold, and the
    wrapper takes the route w6ax_route gives."""
    t = STREAM_MAX_M[6]
    for m in (t, t + 1):
        ops = w6ax_operands(gen, m, k, n, ends=True)
        want = w6_matmul_plain(*ops, torch.bfloat16)
        for route in (W6AX_MMA, W6AX_STREAM):
            assert torch.equal(launch(6, ops[0], ops[1], ops[2:4], ops[4], torch.bfloat16, route=route), want)
        assert w6ax_route(m, k, n) == (W6AX_STREAM if m <= t else W6AX_MMA)


def test_w6ax_kernel_refuses_unaligned_planes(gen):
    """TMA reads the planes: a base that is not 16-byte aligned raises, it
    never falls back or launches, on either route."""
    for m in (8, 256):
        xq, xs, hi, lo, ws = w6ax_operands(gen, m, 256, 128, ends=False)
        shifted = torch.empty(hi.numel() + 1, dtype=torch.int8, device="cuda")[1:].view(hi.shape)
        shifted.copy_(hi)
        with pytest.raises(ValueError, match="16-byte aligned"):
            w6_matmul(xq, xs, shifted, lo, ws)
    assert launch_counts()["w6_matmul"] == 0 and launch_counts()["w6_matmul_stream"] == 0


@pytest.mark.parametrize("fmt", [4, 8])
@pytest.mark.parametrize("m,k,n", [(4, 512, 1024), (40, 512, 1024), (4, 1024, 512)])
def test_w4_w8_matmul_kernel_bit_exact(gen, fmt, m, k, n):
    # (4, 1024, 512) is K-tall: route B splits K over blocks there
    xq = torch.randint(-128, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
    xs = torch.rand((m, k // 128), generator=gen, device="cuda") * 0.05 + 1e-3
    lim = 2 ** (fmt - 1)
    w = torch.randint(-lim, lim, (k, n), generator=gen, device="cuda", dtype=torch.int8)
    ws = torch.rand((k // 128, n), generator=gen, device="cuda") * 0.01 + 1e-4
    fn, plain = (w4_matmul, w4_matmul_plain) if fmt == 4 else (w8_matmul, w8_matmul_plain)
    w = pack4(w) if fmt == 4 else w
    for dt in (torch.float32, torch.bfloat16):
        assert torch.equal(fn(xq, xs, w, ws, out_dtype=dt), plain(xq, xs, w, ws, dt))
    assert launch_counts()[fn.__name__] == 2 and fn.launches_by_m == {m: 2}


def int_operands(gen, fmt, m, k, n):
    """8-bit codes at both ends of their range beside random ones, and a
    weight of format ``fmt`` with its extreme values (the largest |P|):
    (xq, xs, planes, ws, the plain version's bf16 result)."""
    lim = 2 ** (fmt - 1)
    xq = torch.randint(-128, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
    xq[:, ::3], xq[:, 1::5] = -128, 127
    w = torch.randint(-lim, lim, (k, n), generator=gen, device="cuda", dtype=torch.int8)
    w[::2], w[1::4] = -lim, lim - 1
    xs = torch.rand((m, k // 128), generator=gen, device="cuda") * 0.05 + 1e-3
    ws = torch.rand((k // 128, n), generator=gen, device="cuda") * 0.01 + 1e-4
    planes = pack6(w) if fmt == 6 else (pack4(w),) if fmt == 4 else (w,)
    plain = {6: w6_matmul_plain, 4: w4_matmul_plain, 8: w8_matmul_plain}[fmt]
    return xq, xs, planes, ws, plain(xq, xs, *planes, ws, torch.bfloat16)


INT_KN = ((384, 256), (4096, 4096), (11264, 4096), (4096, 11264))  # an odd group count; split K; unsplit
B_ROWS = {6: 64, 4: 64, 8: 32}  # route B's largest M per format (its ring stages; csrc/w6ax_matmul.cu's b_max_m)
INT_ROUTE_CASES = [(fmt, route, m) for fmt in (6, 4, 8) for route, ms in (
    (W6AX_STREAM, (1, 3, 8, 13, B_ROWS[fmt])), (W6AX_MMA, (1, 33, 130)))
    for m in ms]


@pytest.mark.parametrize("k,n", INT_KN)
@pytest.mark.parametrize("fmt,route,m", INT_ROUTE_CASES)
def test_int_gemm_routes_bit_exact(gen, fmt, route, m, k, n):
    """Every weight format on both routes of csrc/w6ax_matmul.cu, M not a
    multiple of 4 beside the route edges (route B's largest M: 64, W8's 32),
    N = 4096 where route B splits K over blocks: bit-exact against the
    plain version, in f32 and bf16."""
    xq, xs, planes, ws, want = int_operands(gen, fmt, m, k, n)
    if route == W6AX_STREAM and m == B_ROWS[fmt]:  # the source's edge: one row more is refused
        assert stream_takes(fmt, m, k, n) and not stream_takes(fmt, m + 1, k, n)
    if route == W6AX_STREAM and n == 4096:
        assert geometry(fmt, m, k, n, route)[0] > 1  # the split-K class
    assert torch.equal(launch(fmt, xq, xs, planes, ws, torch.bfloat16, route=route), want)
    got = launch(fmt, xq, xs, planes, ws, torch.float32, route=route)
    plain = {6: w6_matmul_plain, 4: w4_matmul_plain, 8: w8_matmul_plain}[fmt]
    assert torch.equal(got, plain(xq, xs, *planes, ws, torch.float32))


@pytest.mark.parametrize("fmt", [4, 8])
def test_int_gemm_wrapper_takes_the_route_of_its_format(gen, fmt):
    """w4_matmul / w8_matmul take w6ax_route's route for their format on
    both sides of its threshold (the route threshold per format), and W8's
    route B refuses more rows than its stages hold."""
    t = STREAM_MAX_M[fmt]
    fn = w4_matmul if fmt == 4 else w8_matmul
    for m in (t, t + 1):
        xq, xs, planes, ws, want = int_operands(gen, fmt, m, 4096, 4096)
        assert torch.equal(fn(xq, xs, *planes, ws), want)
        assert w6ax_route(m, 4096, 4096, fmt) == (W6AX_STREAM if m <= t else W6AX_MMA)
    assert fn.launches_by_m == {t: 1, t + 1: 1}
    if fmt == 8:
        with pytest.raises(ValueError, match="no W8 geometry"):
            geometry(8, 33, 4096, 4096, W6AX_STREAM)


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


def w6_planes(gen, k, n):
    hi, lo = pack6(torch.randint(-32, 32, (k, n), generator=gen, device="cuda", dtype=torch.int8))
    return hi, lo, torch.rand((k // 128, n), generator=gen, device="cuda") * 0.01 + 1e-4


def assert_w6a16_close(got, want):
    """want: the plain version's f32 result."""
    err = (got.float() - want).abs()
    tol = 1e-4 * want.abs().max().item()
    if got.dtype == torch.bfloat16:  # one bf16 ulp of the f32 value, 2^(floor(log2|v|) - 7)
        tol = torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8) + tol
    assert bool((err <= tol).all())


@pytest.mark.parametrize("m,k,n,rope", [(40, 256, 384, False), (130, 512, 256, True), (4, 512, 256, True)])
def test_w6_matmul_bf16_kernel(gen, m, k, n, rope):
    x = randn(gen, m, k)
    hi, lo, ws = w6_planes(gen, k, n)
    kw = {}
    if rope:
        kw = dict(rope_cos=torch.rand((m, 128), generator=gen, device="cuda") * 2 - 1,
                  rope_sin2=torch.rand((m, 128), generator=gen, device="cuda") * 2 - 1)
    want = w6_matmul_bf16_plain(x, hi, lo, ws, torch.float32, **kw)
    for dt in (torch.float32, torch.bfloat16):
        assert_w6a16_close(w6_matmul_bf16(x, hi, lo, ws, out_dtype=dt, **kw), want)
    assert launch_counts()["w6_matmul_bf16"] == 2


@pytest.mark.parametrize("m,k,n,rope", [(40, 256, 384, False), (130, 512, 256, True), (4, 512, 256, True)])
def test_w4_matmul_bf16_kernel(gen, m, k, n, rope):
    x = randn(gen, m, k)
    q4 = pack4(torch.randint(-8, 8, (k, n), generator=gen, device="cuda", dtype=torch.int8))
    ws = torch.rand((k // 128, n), generator=gen, device="cuda") * 0.01 + 1e-4
    kw = {}
    if rope:
        kw = dict(rope_cos=torch.rand((m, 128), generator=gen, device="cuda") * 2 - 1,
                  rope_sin2=torch.rand((m, 128), generator=gen, device="cuda") * 2 - 1)
    want = w4_matmul_bf16_plain(x, q4, ws, torch.float32, **kw)
    for dt in (torch.float32, torch.bfloat16):
        assert_w6a16_close(w4_matmul_bf16(x, q4, ws, out_dtype=dt, **kw), want)
    assert launch_counts()["w4_matmul_bf16"] == 2


@pytest.mark.parametrize("fused,act", [(False, "silu"), (True, "gelu")])
def test_w6_glu_bf16_kernel(gen, fused, act):
    m, k, n = 70, 512, 256
    x = randn(gen, m, k)
    g, u = w6_planes(gen, k, n), w6_planes(gen, k, n)
    want = w6_glu_bf16_plain(x, *g, *u, act, torch.float32)
    for dt in (torch.float32, torch.bfloat16):
        if fused:
            w = [torch.cat([a, b], dim=1).contiguous() for a, b in zip(g, u)]
            got = w6_glu_fused_bf16(x, *w, act=act, out_dtype=dt)
        else:
            got = w6_glu_matmul_bf16(x, *g, *u, act=act, out_dtype=dt)
        assert_w6a16_close(got, want)
    assert launch_counts()["w6_glu_fused_bf16" if fused else "w6_glu_matmul_bf16"] == 2


@pytest.mark.parametrize("lq", [1, 5])
def test_attend_cache_int8_kernel(gen, lq):
    b, h, kvh, s, d = 2, 4, 2, 256, 128
    kc, vc = (torch.randint(-128, 128, (2, b, kvh, s, d), generator=gen, device="cuda", dtype=torch.int8)
              for _ in "kv")
    ks, vs = (torch.rand((2, b, kvh, s), generator=gen, device="cuda") * 0.05 + 1e-3 for _ in "kv")
    q = randn(gen, b, lq, h, d)
    lengths = torch.tensor([37, 200], dtype=torch.int32, device="cuda")
    if lq == 1:
        got = flash_decode(q[:, 0], kc, vc, lengths, ks, vs, layer_idx=1).reshape(b, 1, h * d)
    else:
        got = flash_prefill(q, kc, vc, lengths, ks, vs, layer_idx=1)
    want = attend_cache_plain(q, kc, vc, lengths, 1, None, torch.bfloat16, lq == 1, torch.bfloat16, ks, vs)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2e-2 * want.float().abs().max().item()
    assert launch_counts()["flash_decode" if lq == 1 else "flash_prefill"] == 1


@pytest.mark.parametrize("quant,window", [(False, None), (True, None), (False, 300), (True, 300)])
def test_flash_decode_paged_kernel(gen, quant, window):
    """K13 over a scrambled page table, lengths around the page edges."""
    nl, npages, b, h, kvh, ps, d, maxp = 2, 20, 4, 8, 2, 128, 128, 4
    shape = (nl, npages, kvh, ps, d)
    if quant:
        pk, pv = (torch.randint(-128, 128, shape, generator=gen, device="cuda", dtype=torch.int8) for _ in "kv")
        scales = [torch.rand(shape[:-1], generator=gen, device="cuda") * 0.05 + 1e-3 for _ in "kv"]
    else:
        pk, pv = (randn(gen, *shape) for _ in "kv")
        scales = []
    table = torch.stack([torch.randperm(npages - 1, generator=gen, device="cuda")[:maxp] + 1
                         for _ in range(b)]).to(torch.int32)
    lengths = torch.tensor([1, 128, 129, 500], dtype=torch.int32, device="cuda")
    q = randn(gen, b, h, d)
    got = flash_decode_paged(q, pk, pv, table, lengths, *scales, layer_idx=1, window=window)
    want = flash_decode_paged_plain(q, pk, pv, table, lengths, *scales, layer_idx=1, window=window)
    # per (b, h) row: a long row's outputs are small, so a bound at the
    # batch's max |out| (set by the 1-key row, a raw V row) would let a
    # wrong or a dropped page pass there
    got, want = got.float().reshape(b, h, d), want.float().reshape(b, h, d)
    err = (got - want).abs().amax(-1)
    assert bool((err <= 2e-2 * want.abs().amax(-1)).all()), err.max().item()
    assert launch_counts()["flash_decode_paged"] == 1


@pytest.mark.parametrize("lq,kvh,window,quant,d", [
    (101, 4, None, False, 128),  # Lq not a multiple of the 64-row query tile
    (100, 1, 50, False, 128),    # GQA (G = 4: a tile's rows are (query, head) pairs) with a window
    (70, 2, None, True, 128),    # int8 cache, G = 2
    (65, 4, 40, True, 64),       # int8 with a window at D = 64
    (96, 2, 70, False, 256),     # D = 256 (32-key tiles)
])
def test_flash_prefill_kernel_edges(gen, lq, kvh, window, quant, d):
    """K9's tensor-core tiles (Lq >= 64) against the plain version: row 0
    starts with 5 queries at pos < 0 (they attend nothing and read 0), row
    1 is a fresh prompt, row 2 the last chunk of a full cache; 2e-2 of
    max |out| per (query, head) row."""
    b, h, s = 3, 4, 256
    shape = (2, b, kvh, s, d)
    if quant:
        kc, vc = (torch.randint(-128, 128, shape, generator=gen, device="cuda", dtype=torch.int8) for _ in "kv")
        scales = [torch.rand(shape[:-1], generator=gen, device="cuda") * 0.05 + 1e-3 for _ in "kv"]
    else:
        kc, vc = randn(gen, *shape), randn(gen, *shape)
        scales = []
    q = randn(gen, b, lq, h, d)
    lengths = torch.tensor([lq - 5, lq, s], dtype=torch.int32, device="cuda")
    got = flash_prefill(q, kc, vc, lengths, *scales, layer_idx=1, window=window).float().reshape(b, lq, h, d)
    want = attend_cache_plain(q, kc, vc, lengths, 1, window, torch.bfloat16, False, torch.bfloat16,
                              *scales).float().reshape(b, lq, h, d)
    assert torch.count_nonzero(got[0, :5]) == 0  # pos < 0
    err = (got - want).abs().amax(-1)
    assert bool((err <= 2e-2 * want.abs().amax(-1)).all()), err.max().item()
    assert launch_counts()["flash_prefill"] == 1


@pytest.mark.parametrize("s,window,quant", [
    (384, None, False),  # pick_bs(384) = 384: key blocks of six 64-key tiles
    (1024, 300, False),  # blocks of 512 keys, a window that starts inside a block
    (512, None, True),   # int8
])
def test_flash_prefill_kernel_rounds_p_per_key_block(gen, s, window, quant):
    """K9's tiles round p to bf16 against each key block's max, as the
    plain version does: against the plain version run on the CPU (the side
    the parity runs hold the card to), at most 1 % of the bf16 outputs part
    (the order of the f32 sums only); p rounded against a running max
    every 64 keys parts many times more."""
    b, h, kvh, d, lq = 2, 8, 2, 128, 200
    shape = (2, b, kvh, s, d)
    if quant:
        kc, vc = (torch.randint(-128, 128, shape, generator=gen, device="cuda", dtype=torch.int8) for _ in "kv")
        scales = [torch.rand(shape[:-1], generator=gen, device="cuda") * 0.05 + 1e-3 for _ in "kv"]
    else:
        kc, vc = randn(gen, *shape), randn(gen, *shape)
        scales = []
    q = randn(gen, b, lq, h, d)
    lengths = torch.tensor([s - 84, s], dtype=torch.int32, device="cuda")
    got = flash_prefill(q, kc, vc, lengths, *scales, layer_idx=1, window=window).cpu()
    cpu = [t.cpu() for t in (q, kc, vc, lengths, *scales)]
    want = attend_cache_plain(*cpu[:4], 1, window, torch.bfloat16, False, torch.bfloat16, *cpu[4:])
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2e-2 * want.float().abs().max().item(), err
    parted = (got != want).float().mean().item()
    assert parted <= 1e-2, parted


@pytest.mark.parametrize("quant,window,kvh,d,ps,maxp", [
    (False, None, 2, 128, 128, 4),   # GQA, G = 4: one block serves the 4 heads of a kv head
    (True, 100, 2, 128, 128, 4),     # int8 pool with a window
    (False, 300, 8, 64, 256, 4),     # D = 64, 256-key pages (two 128-key chunks a page)
    (True, None, 8, 256, 128, 4),    # D = 256, int8
    (False, 1000, 8, 128, 128, 72),  # 72 chunks: two chunks a split, 36 splits
])
def test_flash_decode_paged_kernel_edges(gen, quant, window, kvh, d, ps, maxp):
    """K13 against its plain version per (b, h) row: a 1-key row, a row at
    exactly MAXPAGES * PS keys, lengths past the end and below 1 (clipped),
    page edges; one launch per call, and a second call (its counters left
    at zero by the first) gives the same bits."""
    nl, b, h = 2, 6, 8
    npages = 1 + b * maxp
    shape = (nl, npages, kvh, ps, d)
    if quant:
        pk, pv = (torch.randint(-128, 128, shape, generator=gen, device="cuda", dtype=torch.int8) for _ in "kv")
        scales = [torch.rand(shape[:-1], generator=gen, device="cuda") * 0.05 + 1e-3 for _ in "kv"]
    else:
        pk, pv = (randn(gen, *shape) for _ in "kv")
        scales = []
    table = (torch.randperm(npages - 1, generator=gen, device="cuda") + 1)[: b * maxp].reshape(b, maxp)
    table = table.to(torch.int32)
    full = maxp * ps
    lengths = torch.tensor([1, full, ps + 1, full - 1, 0, full + 7], dtype=torch.int32, device="cuda")
    q = randn(gen, b, h, d)
    got = flash_decode_paged(q, pk, pv, table, lengths, *scales, layer_idx=1, window=window)
    assert launch_counts()["flash_decode_paged"] == 1
    again = flash_decode_paged(q, pk, pv, table, lengths, *scales, layer_idx=1, window=window)
    assert torch.equal(got, again)
    want = flash_decode_paged_plain(q, pk, pv, table, lengths, *scales, layer_idx=1, window=window)
    got, want = got.float().reshape(b, h, d), want.float().reshape(b, h, d)
    err = (got - want).abs().amax(-1)
    assert bool((err <= 2e-2 * want.abs().amax(-1)).all()), err.max().item()


def test_rope_table_matches_cpu(gen):
    """The card's RoPE cos / sin table equals the CPU's bit for bit (the
    inverse frequencies are computed on the host), so q / k on the card
    equal the CPU's wherever the GEMM in front of them is exact."""
    cfg = ModelConfig.llama()
    pos = torch.arange(cfg.max_seq_len)[None]
    for got, want in zip(rope_for_cfg(pos.cuda(), cfg), rope_for_cfg(pos, cfg)):
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("quant,window,kvh,d", [
    (False, None, 32, 128),  # the main path's shape: one split up to 128 keys, then a split per 128
    (True, None, 32, 128),   # int8
    (False, 300, 8, 128),    # GQA (G = 4) with a window
    (True, 200, 8, 64),      # D = 64, int8, GQA, a window
    (False, None, 8, 256),   # D = 256
    (True, 100, 32, 256),    # D = 256, int8, a window inside a split
])
def test_flash_decode_kernel_edges(gen, quant, window, kvh, d):
    """K6 (split-KV over the dense cache) against its plain version per
    (b, h) row: rows whose keys fit one split (1, 64, 65, 128) beside rows
    that need several (129, S = 512); one launch per call, and a second call
    (its counters left at zero by the first) gives the same bits."""
    b, h, s = 6, 32, 512
    shape = (2, b, kvh, s, d)
    if quant:
        kc, vc = (torch.randint(-128, 128, shape, generator=gen, device="cuda", dtype=torch.int8) for _ in "kv")
        scales = [torch.rand(shape[:-1], generator=gen, device="cuda") * 0.05 + 1e-3 for _ in "kv"]
    else:
        kc, vc = randn(gen, *shape), randn(gen, *shape)
        scales = []
    q = randn(gen, b, h, d)
    lengths = torch.tensor([1, 64, 65, 128, 129, s], dtype=torch.int32, device="cuda")
    got = flash_decode(q, kc, vc, lengths, *scales, layer_idx=1, window=window)
    assert launch_counts()["flash_decode"] == 1
    assert torch.equal(got, flash_decode(q, kc, vc, lengths, *scales, layer_idx=1, window=window))
    want = attend_cache_plain(q[:, None], kc, vc, lengths, 1, window, torch.bfloat16, True, torch.bfloat16, *scales)
    got, want = got.float().reshape(b, h, d), want.float().reshape(b, h, d)
    err = (got - want).abs().amax(-1)
    assert bool((err <= 2e-2 * want.abs().amax(-1)).all()), err.max().item()


WA16_CASES = [  # (fmt, M, K, N, rope): M around the 64- and 128-row tiles, N = one tile and 88 tiles
    (6, 1, 256, 128, False),
    (6, 4, 4096, 4096, True),      # weight-only decode: K split over blocks
    (4, 4, 11264, 4096, False),    # down_proj's K
    (6, 63, 512, 11264, False),
    (4, 64, 1024, 256, True),
    (6, 65, 384, 384, True),       # the first 128-row tile, 63 rows of it past M
    (4, 130, 512, 256, False),
    (6, 256, 4096, 4096, True),    # the scheduler's chunk
    (6, 2048, 11264, 128, False),
    (4, 2048, 4096, 4096, True),   # the 512-token prefill
]


@pytest.mark.parametrize("fmt,m,k,n,rope", WA16_CASES)
def test_wa16_matmul_kernel_edges(gen, fmt, m, k, n, rope):
    """K7 (fmt 6) and K11 (fmt 4) against their plain versions at the
    tolerance above, f32 and bf16 output, one launch a call."""
    x = randn(gen, m, k)
    if fmt == 6:
        w = w6_planes(gen, k, n)
        fn, plain = w6_matmul_bf16, w6_matmul_bf16_plain
    else:
        q4 = pack4(torch.randint(-8, 8, (k, n), generator=gen, device="cuda", dtype=torch.int8))
        w = (q4, torch.rand((k // 128, n), generator=gen, device="cuda") * 0.01 + 1e-4)
        fn, plain = w4_matmul_bf16, w4_matmul_bf16_plain
    kw = {}
    if rope:
        kw = dict(rope_cos=torch.rand((m, 128), generator=gen, device="cuda") * 2 - 1,
                  rope_sin2=torch.rand((m, 128), generator=gen, device="cuda") * 2 - 1)
    want = plain(x, *w, torch.float32, **kw)
    for dt in (torch.float32, torch.bfloat16):
        assert_w6a16_close(fn(x, *w, out_dtype=dt, **kw), want)
    assert launch_counts()[fn.__name__] == 2


@pytest.mark.parametrize("fused,act,m,k,n", [
    (False, "silu", 4, 4096, 11264),   # decode: K split over blocks
    (True, "gelu", 65, 512, 256),      # the up half read at a column offset, ldw = 2 N
    (False, "gelu", 256, 1024, 384),
    (True, "silu", 2048, 4096, 1024),
    (False, "silu", 130, 11264, 128),
])
def test_wa16_glu_kernel_edges(gen, fused, act, m, k, n):
    """K8 (separate and fused gate | up planes) against its plain version,
    f32 and bf16 output, one launch a call."""
    x = randn(gen, m, k)
    g, u = w6_planes(gen, k, n), w6_planes(gen, k, n)
    want = w6_glu_bf16_plain(x, *g, *u, act, torch.float32)
    for dt in (torch.float32, torch.bfloat16):
        if fused:
            w = [torch.cat([a, b], dim=1).contiguous() for a, b in zip(g, u)]
            got = w6_glu_fused_bf16(x, *w, act=act, out_dtype=dt)
        else:
            got = w6_glu_matmul_bf16(x, *g, *u, act=act, out_dtype=dt)
        assert_w6a16_close(got, want)
    assert launch_counts()["w6_glu_fused_bf16" if fused else "w6_glu_matmul_bf16"] == 2


def test_wa16_kernel_refuses_unaligned_planes(gen):
    """TMA reads the planes: a base that is not 16-byte aligned raises, it
    never falls back or launches."""
    m, k, n = 8, 256, 128
    x = randn(gen, m, k)
    hi, lo, ws = w6_planes(gen, k, n)
    shifted = torch.empty(hi.numel() + 1, dtype=torch.int8, device="cuda")[1:].view(hi.shape)
    shifted.copy_(hi)
    with pytest.raises(ValueError, match="16-byte aligned"):
        w6_matmul_bf16(x, shifted, lo, ws)
    assert launch_counts()["w6_matmul_bf16"] == 0


def tiny_hf_dir(gen, d, layers=2, hidden=256, ffn=704, heads=2, vocab=1000):
    """An HF-layout LLaMA directory (config.json, bf16 model.safetensors) of
    random weights from ``gen``, written by the port's safetensors writer;
    returns (cfg, the same weights as a dense tree [in, out] on the card)."""
    import json
    import os

    from flexq_tpu_torch.export.safetensors_io import save_file
    from flexq_tpu_torch.models.hf_loader import config_from_hf

    hf = {"model_type": "llama", "vocab_size": vocab, "hidden_size": hidden, "intermediate_size": ffn,
          "num_hidden_layers": layers, "num_attention_heads": heads, "num_key_value_heads": heads,
          "max_position_embeddings": 512, "tie_word_embeddings": False}
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(hf, f)
    tensors, dense = {}, []
    shapes = {"self_attn.q_proj": (hidden, hidden), "self_attn.k_proj": (hidden, hidden),
              "self_attn.v_proj": (hidden, hidden), "self_attn.o_proj": (hidden, hidden),
              "mlp.gate_proj": (ffn, hidden), "mlp.up_proj": (ffn, hidden), "mlp.down_proj": (hidden, ffn)}
    for i in range(layers):
        lp = {}
        for hf_name, shape in shapes.items():
            w = 0.05 * randn(gen, *shape)
            tensors[f"model.layers.{i}.{hf_name}.weight"] = w
            lp[hf_name.split(".")[1]] = {"w": w.T}
        for name, hf_name in (("input_norm", "input_layernorm"), ("post_norm", "post_attention_layernorm")):
            g = 1 + 0.1 * randn(gen, hidden)
            tensors[f"model.layers.{i}.{hf_name}.weight"] = g
            lp[name] = g
        dense.append(lp)
    embed, head, norm = randn(gen, vocab, hidden), 0.05 * randn(gen, vocab, hidden), 1 + 0.1 * randn(gen, hidden)
    tensors.update({"model.embed_tokens.weight": embed, "lm_head.weight": head, "model.norm.weight": norm})
    save_file(tensors, os.path.join(d, "model.safetensors"))
    return config_from_hf(hf), {"embed": embed, "final_norm": norm, "layers": dense, "lm_head": head.T}


def test_load_packed_on_the_card_equals_quantize_params(gen, tmp_path):
    """The exporter on the card, load_packed onto the card: every leaf equal
    to quantize_params of the same dense weights on the card, but a scale's
    pad columns (CLIPMIN exported, 0 from quantize_params)."""
    from flexq_tpu_torch.config import QuantPolicy
    from flexq_tpu_torch.export.exporter import export_checkpoint, load_packed
    from flexq_tpu_torch.models.quantized import forward_serve, quantize_params
    from flexq_tpu_torch.quant.quantizer import CLIPMIN

    cfg, dense = tiny_hf_dir(gen, str(tmp_path))
    export_checkpoint(str(tmp_path), str(tmp_path / "packed"))
    lcfg, policy, got = load_packed(str(tmp_path / "packed"))
    assert lcfg == cfg and got["embed"].is_cuda
    want = quantize_params(dense, cfg, QuantPolicy.llama_flex())
    padded = 0
    for (k, x), (_, y) in zip(*(sorted(_leaves(t)) for t in (got, want))):
        if k.endswith("scale") and not torch.equal(x, y):
            n = int((x != y).any(0).int().argmax())
            assert torch.equal(x[:, :n], y[:, :n]) and bool((x[:, n:] == CLIPMIN).all()) and bool((y[:, n:] == 0).all())
            padded += 1
        else:
            assert x.dtype == y.dtype and torch.equal(x, y), k
    assert padded == 4  # gate / up of both layers: FFN 704 padded to 768
    ids = torch.randint(0, cfg.vocab_size, (2, 24), device="cuda", generator=gen)
    assert torch.equal(forward_serve(got, cfg, policy, ids)[0], forward_serve(want, cfg, policy, ids)[0])


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def test_http_round_trip_on_the_card_equals_a_direct_run(gen, tmp_path):
    """serve_background over a paged card scheduler: concurrent id-prompt
    completions give the tokens of the same requests run directly."""
    import json
    import threading
    import urllib.request

    from flexq_tpu_torch.config import QuantPolicy
    from flexq_tpu_torch.models.quantized import quantize_params
    from flexq_tpu_torch.serve.http import serve_background
    from flexq_tpu_torch.serve.scheduler import BatchScheduler

    cfg, dense = tiny_hf_dir(gen, str(tmp_path), heads=2)
    policy = QuantPolicy.llama_flex()
    tree = quantize_params(dense, cfg, policy)
    kw = dict(num_slots=4, max_seq_len=512, paged=True, prefill_chunk=128)
    reqs = [(torch.randint(0, cfg.vocab_size, (n,), generator=gen, device="cuda").tolist(), m)
            for n, m in ((10, 8), (70, 6), (200, 9), (33, 7), (150, 5))]
    server, service, port = serve_background(BatchScheduler(tree, cfg, policy, **kw))
    got = [None] * len(reqs)

    def call(r):
        body = json.dumps({"prompt": reqs[r][0], "max_tokens": reqs[r][1], "temperature": 0, "eos_id": -1}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            got[r] = json.loads(resp.read())["choices"][0]["token_ids"]

    try:
        threads = [threading.Thread(target=call, args=(r,)) for r in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        assert service.failed_ticks == 0
    finally:
        service.shutdown()
        server.shutdown()
    direct = BatchScheduler(tree, cfg, policy, **kw)
    ids = [direct.add_request(p, max_new_tokens=m, eos_id=-1) for p, m in reqs]
    out = direct.run()
    assert got == [out[i] for i in ids]
    assert launch_counts()["flash_decode_paged"] > 0 and launch_counts()["w6_matmul_bf16"] > 0


def test_quantizer_divides_on_the_card_as_on_the_cpu(gen):
    """The weight quantizer's scale (absmax / qmax) is a true division on
    the card too: CUDA turns a division by a host scalar into a multiply by
    its reciprocal, an ulp off on some values, so the scales and codes
    would part from the CPU's (and the reference's)."""
    from flexq_tpu_torch.models.quantized import quantize_linear
    from flexq_tpu_torch.quant.quantizer import QuantSpec

    w = 0.02 * torch.randn((4096, 11008), generator=gen, device="cuda")
    for bits in (6, 4, 8):
        got, want = quantize_linear(w, QuantSpec(bits, True, 128)), quantize_linear(w.cpu(), QuantSpec(bits, True, 128))
        for k in want:
            assert torch.equal(got[k].cpu(), want[k]), (bits, k)


@pytest.mark.parametrize("m,k", [(4, 4096), (16, 4096), (2048, 4096), (8, 16384)])
def test_row_statistic_has_the_plain_versions_bits(gen, m, k):
    """The plain RMS / LayerNorm producers sum each row in the kernel's
    order (fused_quant.row_sum), so K1 and K14 give the CPU's codes and
    scales bit for bit, with and without the residual."""
    x, r = randn(gen, m, k), randn(gen, m, k)
    g, b = 1 + 0.1 * randn(gen, k), 0.1 * randn(gen, k)
    cpu = [t.cpu() for t in (x, r, g, b)]
    for res in (None, r):
        got = rmsnorm_quant(x, g, bits=6, residual=res)
        want = rmsnorm_quant_plain(cpu[0], cpu[2], bits=6, residual=None if res is None else cpu[1])
        assert all(torch.equal(a.cpu(), w) for a, w in zip(got, want))
        got = layernorm_quant(x, g, b, bits=8, residual=res)
        want = layernorm_quant_plain(cpu[0], cpu[2], cpu[3], bits=8, residual=None if res is None else cpu[1])
        assert all(torch.equal(a.cpu(), w) for a, w in zip(got, want))


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def test_verify_window_at_per_row_starts_matches_cpu(gen, tmp_path):
    """The speculative verify forward on the card: a [B, 1+k] window at each
    row's own start (K9's short-prompt kernel, the exact GEMM's tensor-core
    route at M = B(1+k)) against the same window on the CPU's plain
    versions, after the same prefill: logits within 2e-2 of max |logit|
    (phase 3's W6Ax bound), and the cache rows it wrote likewise."""
    from flexq_tpu_torch.config import QuantPolicy
    from flexq_tpu_torch.models.quantized import quantize_params
    from flexq_tpu_torch.serve.engine import Engine

    cfg, dense = tiny_hf_dir(gen, str(tmp_path))
    policy = QuantPolicy.llama_flex()
    tree = quantize_params(dense, cfg, policy)
    prompts = torch.randint(0, cfg.vocab_size, (4, 16), generator=gen, device="cuda").tolist()
    window = torch.randint(0, cfg.vocab_size, (4, 5), generator=gen, device="cuda")
    starts = torch.tensor([16, 12, 14, 9])
    out = []
    for dev in ("cuda", "cpu"):
        eng = Engine(_to(tree, dev), cfg, policy, max_seq_len=128, device=dev)
        _, cache = eng.prefill_prompts(prompts, eng.new_cache(4))
        reset_launch_counts()
        logits, cache = eng._spec_forward(window.to(dev), cache, starts.to(dev))
        out.append((logits.float().cpu(), cache[0].float().cpu(), launch_counts(), dict(w6_matmul.launches_by_m)))
    (got, kc, counts, by_m), (want, kc_cpu, _, _) = out
    assert (got - want).abs().max().item() <= 2e-2 * want.abs().max().item()
    rows = torch.arange(4)[:, None], starts[:, None] + torch.arange(5)
    k_got, k_want = kc[:, rows[0], :, rows[1]], kc_cpu[:, rows[0], :, rows[1]]
    assert (k_got - k_want).abs().max().item() <= 2e-2 * k_want.abs().max().item()
    assert counts["flash_prefill"] == cfg.num_layers and by_m.get(20, 0) > 0
    assert w6ax_route(20, cfg.hidden_size, cfg.hidden_size) == W6AX_MMA


@pytest.mark.parametrize("quant", [False, True])
def test_beam_reorder_on_the_card_equals_cpu(gen, quant):
    """The dense beam reorder (serve/beam.py::reorder_rows: a parent
    permutation with a cycle, in place through a temporary) and the paged
    copy-on-divergence (PagePool.copy_pages) on the card: bit-equal to the
    same on the CPU, and to an out-of-place gather."""
    from flexq_tpu_torch.serve.beam import reorder_rows
    from flexq_tpu_torch.serve.paged import PagePool

    shape = (2, 6, 2, 256, 128)
    if quant:
        cache = tuple(torch.randint(-128, 128, shape, generator=gen, device="cuda", dtype=torch.int8) for _ in "kv")
        cache += tuple(torch.rand(shape[:-1], generator=gen, device="cuda") for _ in "kv")
    else:
        cache = (randn(gen, *shape), randn(gen, *shape))
    src, dst, n = [2, 0, 1, 3, 5, 5], [0, 1, 2, 3, 4, 5], 100
    want = tuple(c.cpu().clone() for c in cache)
    gathered = tuple(c.clone() for c in want)
    for g, c in zip(gathered, want):
        g[:, dst, :, :n] = c[:, src, :, :n].clone()
    reorder_rows(cache, src, dst, n)
    reorder_rows(want, src, dst, n)
    assert all(torch.equal(a.cpu(), b) and torch.equal(b, g) for a, b, g in zip(cache, want, gathered))
    pools = [PagePool(2, 8, 2, 128, 128, dtype=torch.int8 if quant else torch.bfloat16, device=d) for d in ("cuda", "cpu")]
    for buf in pools[0]._buffers():
        buf.copy_(torch.randint(-100, 100, buf.shape, generator=gen, device="cuda").to(buf.dtype))
    for a, b in zip(pools[1]._buffers(), pools[0]._buffers()):
        a.copy_(b.cpu())
    for p in pools:
        p.copy_pages([3, 5, 1], [6, 7, 2])
    assert all(torch.equal(a.cpu(), b) for a, b in zip(pools[0]._buffers(), pools[1]._buffers()))


def test_true_div_keeps_its_bits_with_the_cached_divisor(gen):
    """quant/quantizer.py::true_div divides by a divisor kept on the card
    (made once, so a captured graph copies nothing): the bits of a fresh
    divisor's true division and of the CPU's, in a captured graph too."""
    from flexq_tpu_torch.quant.quantizer import true_div

    x = torch.randn(8192, generator=gen, device="cuda")
    for d in (7, 127, 4096, 11008, 3.0):
        want = x / torch.tensor(d, dtype=x.dtype, device="cuda")
        assert torch.equal(true_div(x, d), want) and torch.equal(true_div(x, d), want)
        assert torch.equal(true_div(x, d).cpu(), true_div(x.cpu(), d))
    out = torch.empty_like(x)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out.copy_(true_div(x, 4096))
    graph.replay()
    assert torch.equal(out, x / torch.tensor(4096.0, device="cuda"))


def dense_llama(gen, layers, hidden, ffn, heads, vocab):
    """A dense LLaMA tree [in, out] of random bf16 weights on the card and
    its ModelConfig (no files: the widths may be a 7B layer's)."""
    from flexq_tpu_torch.config import ModelConfig

    cfg = ModelConfig.llama(vocab_size=vocab, hidden_size=hidden, intermediate_size=ffn, num_layers=layers,
                            num_heads=heads, max_seq_len=512)
    shapes = {"q_proj": (hidden, hidden), "k_proj": (hidden, hidden), "v_proj": (hidden, hidden),
              "o_proj": (hidden, hidden), "gate_proj": (hidden, ffn), "up_proj": (hidden, ffn),
              "down_proj": (ffn, hidden)}
    dense = [dict({k: {"w": 0.05 * randn(gen, *s)} for k, s in shapes.items()},
                  input_norm=1 + 0.1 * randn(gen, hidden), post_norm=1 + 0.1 * randn(gen, hidden))
             for _ in range(layers)]
    return cfg, {"embed": randn(gen, vocab, hidden), "final_norm": 1 + 0.1 * randn(gen, hidden), "layers": dense,
                 "lm_head": 0.05 * randn(gen, hidden, vocab)}


def sched_at(gen, kind, cfg, tree, policy, **kw):
    """A card scheduler (4 slots) over the dense, paged or int8 pool cache,
    three requests admitted and two per-token ticks run."""
    from flexq_tpu_torch.serve.scheduler import BatchScheduler

    sched = BatchScheduler(tree, cfg, policy, num_slots=4, max_seq_len=512, paged=kind != "dense",
                           kv_dtype=torch.int8 if kind == "int8" else torch.bfloat16, **kw)
    for n in (10, 70, 33):
        sched.add_request(torch.randint(0, cfg.vocab_size, (n,), generator=gen, device="cuda").tolist(),
                          max_new_tokens=12, eos_id=-1)
    for _ in range(2):
        sched.step()
    return sched


def decode_step_of(sched):
    """The scheduler's eager decode step over every slot at its current
    positions (per-row tensor path), writing its logits into a static
    buffer; K/V rewrites land where the last tick wrote them."""
    positions = torch.tensor([s.pos if s.req_id is not None else 0 for s in sched.slots], device="cuda")
    table = sched.ptable.to_device(sched.device) if sched.paged else None
    box = {}

    def step():
        if sched.paged:
            logits = sched._step_paged_fn(sched.last_tokens, sched.pool.state(), positions, table)
        else:
            logits = sched._step_fn(sched.last_tokens, sched.kv, positions)
        if "out" not in box:
            box["out"] = torch.empty_like(logits)
        box["out"].copy_(logits)

    return step, box


@pytest.mark.parametrize("kind", ["dense", "paged", "int8"])
def test_captured_decode_step_equals_the_eager_step(gen, kind):
    """A StepGraph of the scheduler's decode step replays the eager step's
    logits bit for bit over the dense cache, the page pool and the int8
    pool (every kernel of the step captured), and each replay adds the
    capture's launches to the wrappers' counts (the capture itself none)."""
    from flexq_tpu_torch.config import QuantPolicy
    from flexq_tpu_torch.models.quantized import quantize_params
    from flexq_tpu_torch.serve.graphs import StepGraph

    cfg, dense = dense_llama(gen, 2, 256, 704, 2, 1000)
    policy = QuantPolicy.llama_flex()
    sched = sched_at(gen, kind, cfg, quantize_params(dense, cfg, policy), policy)
    step, box = decode_step_of(sched)
    step()
    want = box["out"].clone()
    graph = StepGraph(step, sched.device)
    graph.run(1)  # the eager warm-up and the capture
    assert graph.captured and torch.equal(box["out"], want)
    box["out"].zero_()
    reset_launch_counts()
    graph.run(3)
    torch.cuda.synchronize()
    assert torch.equal(box["out"], want)
    counts = launch_counts()
    attn = "flash_decode" if kind == "dense" else "flash_decode_paged"
    assert counts[attn] == 3 * cfg.num_layers and counts["rmsnorm_quant"] > 0 and counts["w6_matmul"] > 0
    assert graph.replays == 3 and sum(counts.values()) == 3 * graph.launches_per_replay


def test_shared_buffer_growth_after_a_capture_keeps_the_replay(gen):
    """The split scratch and arrival counters grow by replacement; a graph
    captured over the old tensors holds them, so a growth after the capture
    (the old memory then handed out again and overwritten) leaves its
    replay's logits unchanged. Widths of a 7B layer, so route B splits K
    and flash_decode combines its splits."""
    from flexq_tpu_torch.config import QuantPolicy
    from flexq_tpu_torch.kernels import common
    from flexq_tpu_torch.models.quantized import quantize_params
    from flexq_tpu_torch.serve.graphs import StepGraph

    cfg, dense = dense_llama(gen, 1, 4096, 11008, 32, 1000)
    policy = QuantPolicy.llama_flex()
    sched = sched_at(gen, "dense", cfg, quantize_params(dense, cfg, policy), policy)
    step, box = decode_step_of(sched)
    graph = StepGraph(step, sched.device)
    graph.run(2)
    torch.cuda.synchronize()
    want = box["out"].clone()
    dev = sched.device
    counters, scratch = common._counters.get(dev), common._scratch.get(dev)
    assert counters is not None and scratch is not None
    assert any(t is counters for t in graph._held) and any(t is scratch for t in graph._held)
    common.arrival_counters(dev, 8 * counters.numel())
    common.split_scratch(dev, 8 * scratch.numel())
    assert common._counters[dev] is not counters and common._scratch[dev] is not scratch
    junk = [torch.full_like(counters, -7), torch.full_like(scratch, float("nan"))]  # the old sizes again
    box["out"].zero_()
    graph.run(2)
    torch.cuda.synchronize()
    assert torch.equal(box["out"], want)
    assert int(counters.abs().sum()) == 0  # the held counters are left zero
    del junk


@pytest.mark.parametrize("kind", ["dense", "paged", "int8"])
def test_fused_ticks_on_the_card_equal_per_token_ticks(gen, kind):
    """fused_tick=4 replays one captured step per decode step and gives the
    per-token ticks' greedy streams; the replays' launches are counted."""
    from flexq_tpu_torch.config import QuantPolicy
    from flexq_tpu_torch.models.quantized import quantize_params

    cfg, dense = dense_llama(gen, 2, 256, 704, 2, 1000)
    policy = QuantPolicy.llama_flex()
    tree = quantize_params(dense, cfg, policy)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen, device="cuda").tolist() for n in (10, 70, 33, 5)]
    runs = []
    for fused in (0, 4):
        from flexq_tpu_torch.serve.scheduler import BatchScheduler

        sched = BatchScheduler(tree, cfg, policy, num_slots=3, max_seq_len=512, paged=kind != "dense",
                               kv_dtype=torch.int8 if kind == "int8" else torch.bfloat16, fused_tick=fused)
        ids = [sched.add_request(p, max_new_tokens=m, eos_id=-1) for p, m in zip(prompts, (9, 4, 13, 6))]
        reset_launch_counts()
        out = sched.run()
        runs.append(([out[i] for i in ids], sched, launch_counts()))
    (want, _, _), (got, sched, counts) = runs
    assert got == want
    graphs = list(sched.fused_graphs.values())
    assert len(graphs) == 1 and graphs[0].replays > 0 and max(sched.tick_steps) == 4
    attn = "flash_decode" if kind == "dense" else "flash_decode_paged"
    assert counts[attn] >= cfg.num_layers * graphs[0].replays


def test_sampled_graph_replays_draw_the_step_loops_tokens(gen):
    """The Engine's fused loop on the card (a captured step, the generator
    registered with the graph) draws what the eager step loop draws under
    one seed, in a first call (warm-up, capture, replays) and a second
    (replays only); and sample()'s exponential race is torch.multinomial's
    draw from the same generator state."""
    from flexq_tpu_torch.config import QuantPolicy
    from flexq_tpu_torch.models.quantized import quantize_params
    from flexq_tpu_torch.serve.engine import Engine
    from flexq_tpu_torch.serve.sampling import SamplingParams, sample

    probs_logits = randn(gen, 6, 1000, dtype=torch.float32)
    hot = SamplingParams(greedy=False)
    g1, g2 = (torch.Generator(device="cuda").manual_seed(3) for _ in range(2))
    want = torch.multinomial(torch.softmax(probs_logits, -1), 1, generator=g2)[:, 0]
    assert torch.equal(sample(probs_logits, hot, g1).long(), want)

    cfg, dense = dense_llama(gen, 2, 256, 704, 2, 1000)
    policy = QuantPolicy.llama_flex()
    eng = Engine(quantize_params(dense, cfg, policy), cfg, policy, max_seq_len=256)
    prompts = torch.randint(0, cfg.vocab_size, (3, 12), generator=gen, device="cuda").tolist()
    sp = SamplingParams(greedy=False, temperature=0.8, top_p=0.9, repetition_penalty=1.1, min_length=4)
    first, lp1, st1 = eng.generate(prompts, 16, sp, eos_id=-1, seed=5, return_logprobs=True, return_stats=True)
    step, lp0 = eng.generate(prompts, 16, sp, eos_id=-1, seed=5, return_logprobs=True, mode="step")
    second, lp2, st2 = eng.generate(prompts, 16, sp, eos_id=-1, seed=5, return_logprobs=True, return_stats=True)
    other, _ = eng.generate(prompts, 16, sp, eos_id=-1, seed=6, return_logprobs=True)
    assert first == step == second and lp1 == lp0 == lp2 and other != first
    (_, graph), = eng._fused.values()
    assert st1.capture_s > 0 and st2.capture_s == 0 and graph.replays == 14 + 15 + 15


# ---- the quantize-and-evaluate path ---------------------------------------


def f32_tree(tree):
    """A tree's tensors in f32, on the card."""
    if isinstance(tree, dict):
        return {k: f32_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [f32_tree(v) for v in tree]
    return tree.float()


def test_fake_quant_weights_on_the_card_equal_cpu(gen):
    """The oracle's weights: fake_quant_weights on the card bit-equal to the
    CPU's (128-group symmetric and 64-group asymmetric)."""
    import dataclasses

    from flexq_tpu_torch.config import QuantPolicy
    from flexq_tpu_torch.models.llama import fake_quant_weights

    _, tree = dense_llama(gen, 1, 256, 704, 2, 1000)
    tree = f32_tree(tree)
    cpu = _to(tree, "cpu")
    for policy in (QuantPolicy.llama_flex().with_head(6, 8),
                   dataclasses.replace(QuantPolicy.llama_flex(), w_group_size=64, symmetric=False)):
        got, want = fake_quant_weights(tree, policy), fake_quant_weights(cpu, policy)
        for (k, a), (_, b) in zip(_leaves(got), _leaves(want)):
            assert torch.equal(a.cpu(), b), k


def test_dense_forward_on_the_card_tracks_cpu(gen):
    """The dense f32 forward (policy None and llama_flex's act fake-quant)
    with TF32 off: within 1e-4 of max |logit| of the CPU's (f32 sum order;
    under llama_flex a flipped activation code may move logits further, so
    that run is held at 2e-2 with argmax agreement >= 0.95)."""
    from flexq_tpu_torch.config import QuantPolicy
    from flexq_tpu_torch.models.llama import fake_quant_weights, forward

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, tree = dense_llama(gen, 2, 256, 704, 2, 1000)
    tree = f32_tree(tree)
    ids = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen, device="cuda")
    for policy, tol in ((None, 1e-4), (QuantPolicy.llama_flex(), 2e-2)):
        p = tree if policy is None else fake_quant_weights(tree, policy)
        got = forward(p, cfg, ids, policy=policy).cpu()
        want = forward(_to(p, "cpu"), cfg, ids.cpu(), policy=policy)
        assert torch.isfinite(got).all()
        assert ((got - want).abs().max() / want.abs().max()).item() < tol
        assert (got.argmax(-1) == want.argmax(-1)).float().mean().item() >= 0.95


def test_cacheless_forward_serve_on_the_card_tracks_the_oracle(gen):
    """The packed path without a cache (the eval path: f32, the exact W*Ax
    layer) on the card against the fake-quant oracle, at the reference's
    bounds (8e-2 of max |logit|, argmax agreement >= 0.75), llama_flex and
    W4A8, and the kernels launched."""
    from flexq_tpu_torch.config import QuantPolicy
    from flexq_tpu_torch.models.llama import fake_quant_weights, forward
    from flexq_tpu_torch.models.quantized import forward_serve, quantize_params

    cfg, tree = dense_llama(gen, 2, 256, 704, 2, 1000)
    tree = f32_tree(tree)
    ids = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen, device="cuda")
    for policy in (QuantPolicy.llama_flex(), QuantPolicy.uniform("llama", 4, 8)):
        oracle = forward(fake_quant_weights(tree, policy), cfg, ids, policy=policy)
        reset_launch_counts()
        got, _ = forward_serve(quantize_params(tree, cfg, policy, dtype=torch.float32), cfg, policy, ids)
        counts = launch_counts()
        gemm = "w6_matmul" if policy.weight_bits["q_proj"] == 6 else "w4_matmul"
        assert counts["rmsnorm_quant"] and counts["quant_act"] and counts["glu_quant"] and counts[gemm]
        assert ((got - oracle).abs().max() / oracle.abs().max()).item() < 8e-2
        assert (got.argmax(-1) == oracle.argmax(-1)).float().mean().item() >= 0.75


def test_train_step_on_the_card_tracks_cpu(gen):
    """Three train_steps of a 2-layer model (hidden 128, GQA) on the card and
    on the CPU from the same init_params and batches, TF32 off: the loss
    within 1e-5 relative each step; the parameters as chip_smoke.py phase 9
    (c) holds them: none apart by more than 2 x the summed lr (Adam moves an
    entry by about +-lr whatever its gradient's size, so an entry whose
    gradient is below the f32 sums' rounding may move the other way) and at
    most 1e-4 of the entries apart by more than 1e-3 x the summed lr; Adam's
    moments within 1e-4 of each leaf's max; the first step (lr(0) = 0)
    leaves the parameters bit for bit on both."""
    from flexq_tpu_torch.train import trainer

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = ModelConfig.llama(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2, num_heads=2,
                            num_kv_heads=1, max_seq_len=128)
    tc = trainer.TrainConfig(batch_size=4, seq_len=64, total_steps=30, warmup_steps=2)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, 20000).astype(np.uint16)
    runs = {}
    for dev in ("cuda", "cpu"):
        params = trainer.init_params(cfg, 0, device=dev)
        opt = trainer.make_optimizer(tc, params)
        state, losses, it = opt.init(params), [], trainer.batch_iterator(tokens, tc, seed=1)
        for step in range(3):
            before = params
            params, state, loss = trainer.train_step(params, state, next(it), cfg, opt)
            losses.append(float(loss))
            if step == 0:
                assert all(torch.equal(a, b) for a, b in zip(trainer.tree_leaves(before),
                                                             trainer.tree_leaves(params)))
        runs[dev] = params, state, losses
    (pg, sg, lg), (pc, sc, lc) = runs["cuda"], runs["cpu"]
    assert all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(lg, lc))
    lr_sum = sum(trainer.make_lr_schedule(tc)(c) for c in range(3))
    diffs = torch.cat([(a.cpu() - b).abs().flatten() for a, b in zip(trainer.tree_leaves(pg),
                                                                       trainer.tree_leaves(pc))])
    assert diffs.max().item() <= 2 * lr_sum
    assert (diffs > 1e-3 * lr_sum).float().mean().item() <= 1e-4
    for moment in ("mu", "nu"):
        for a, b in zip(trainer.tree_leaves(sg[moment]), trainer.tree_leaves(sc[moment])):
            assert (a.cpu() - b).abs().max().item() <= 1e-4 * b.abs().max().item()
    assert sg["count"] == sc["count"] == 3


def test_bench_fn_on_the_card_brackets_the_call(gen):
    """bench_fn's CUDA events bracket the device work: a 4096^3 bf16 matmul
    (about 0.14 ms at the card's peak) times within 0.5-2x of the same
    calls timed on the host around synchronize (20 back to back), and the
    result is a positive finite number of seconds."""
    import math
    import time

    from flexq_tpu_torch.utils.benchmark import bench_fn

    a = torch.randn(4096, 4096, generator=gen, device="cuda").to(torch.bfloat16)
    sec = bench_fn(torch.matmul, (a, a), iters=10)
    assert math.isfinite(sec) and sec > 0 and bench_fn.last_fallback is False
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        torch.matmul(a, a)
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) / 20
    assert 0.5 * host <= sec <= 2 * host, (sec, host)


def test_trace_holds_a_cuda_kernel(gen, tmp_path):
    """profiling.trace on the card writes a Chrome trace holding the CUDA
    kernel of the traced matmul, inside a ``scope`` range."""
    import json

    from flexq_tpu_torch.utils.profiling import scope, trace

    a = torch.randn(512, 512, generator=gen, device="cuda")
    with trace(str(tmp_path)):
        with scope("traced_matmul"):
            a @ a
    (path,) = tmp_path.glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)
    assert any(e.get("name") == "traced_matmul" for e in events)


# ---- tensor parallelism (tp = 2): a rank's local shapes; the refusals -------

TP2_INT = [(4096, 2048), (4096, 5632), (2048, 4096), (5632, 4096), (4096, 16384), (8192, 4096)]


@pytest.mark.parametrize("k,n", TP2_INT)
@pytest.mark.parametrize("fmt", [6, 4, 8])
def test_int_gemm_at_tp2_shard_shapes(gen, fmt, k, n):
    """A rank's (K, N) at tp = 2 (LLaMA-2-7B's q/k/v, gate/up, o, down and
    packed head halved; OPT-6.7B's fc2), M = 4 on both routes and M = 128
    on the tensor cores: bit-exact against the plain version."""
    for m, routes in ((4, (W6AX_STREAM, W6AX_MMA)), (128, (W6AX_MMA,))):
        xq, xs, planes, ws, want = int_operands(gen, fmt, m, k, n)
        for route in routes:
            if route == W6AX_STREAM and not stream_takes(fmt, m, k, n):
                continue
            assert torch.equal(launch(fmt, xq, xs, planes, ws, torch.bfloat16, route=route), want), (m, route)


@pytest.mark.parametrize("fmt,k,n,rope", [(6, 4096, 2048, True), (6, 2048, 4096, False), (6, 5632, 4096, False),
                                          (4, 4096, 5632, False), (4, 4096, 2048, True)])
def test_wa16_at_tp2_shard_shapes(gen, fmt, k, n, rope):
    """K7 / K11 at a rank's local shapes, a 4 x 128-token prompt."""
    test_wa16_matmul_kernel_edges(gen, fmt, 512, k, n, rope)


def test_glu_and_producers_at_tp2_shard_shapes(gen):
    """K8 and K5 at the local FFN width 5632 (44 groups), K4 at o_proj's
    local K = 2048, K15 at OPT's local F = 8192."""
    test_wa16_glu_kernel_edges(gen, False, "silu", 512, 4096, 5632)
    gate, up = 2 * randn(gen, 16, 5632), randn(gen, 16, 5632)
    assert_quant_close(glu_quant(gate, up, 8), glu_quant_plain(gate, up, 8))
    x = randn(gen, 16, 2048)
    assert_quant_close(quant_act(x, 6), quant_act_plain(x, 6))
    h = 2 * randn(gen, 16, 8192)
    assert all(torch.equal(a, b) for a, b in zip(relu_quant(h, 6), relu_quant_plain(h, 6)))


@pytest.mark.parametrize("lq", [1, 16, 128])
def test_attention_at_tp2_heads(gen, lq):
    """K6 / K9 at 16 heads (LLaMA-2-7B's 32 halved) over a bf16 cache."""
    b, h, s, d = 2, 16, 256, 128
    kc, vc = randn(gen, 2, b, h, s, d), randn(gen, 2, b, h, s, d)
    q = randn(gen, b, lq, h, d)
    lengths = torch.full((b,), 200, dtype=torch.int32, device="cuda")
    got = (flash_decode(q[:, 0], kc, vc, lengths, layer_idx=1) if lq == 1
           else flash_prefill(q, kc, vc, lengths, layer_idx=1)).float().reshape(b, lq, h, d)
    want = attend_cache_plain(q, kc, vc, lengths, 1, None, torch.bfloat16, lq == 1, torch.bfloat16).float()
    want = want.reshape(b, lq, h, d)
    assert ((got - want).abs().max() <= 2e-2 * want.abs().max()).item()


def test_gloo_mesh_on_the_card_refuses_captured_steps(gen):
    """A gloo mesh on the card cannot put its collectives in a CUDA graph:
    mode="fused" and fused_tick > 0 raise, naming mode="step" and
    fused_tick=0; nothing falls back."""
    from flexq_tpu_torch.config import QuantPolicy
    from flexq_tpu_torch.parallel import Mesh
    from flexq_tpu_torch.serve import Engine
    from flexq_tpu_torch.serve.scheduler import BatchScheduler

    cfg = ModelConfig.llama(vocab_size=256, hidden_size=256, intermediate_size=512, num_layers=1, num_heads=2)
    dense = {"embed": randn(gen, 256, 256), "final_norm": torch.ones(256, device="cuda"),
             "lm_head": randn(gen, 256, 256),
             "layers": [{"input_norm": torch.ones(256, device="cuda"), "post_norm": torch.ones(256, device="cuda"),
                         **{n: {"w": 0.05 * randn(gen, 256, 256)} for n in ("q_proj", "k_proj", "v_proj", "o_proj")},
                         "gate_proj": {"w": 0.05 * randn(gen, 256, 512)}, "up_proj": {"w": 0.05 * randn(gen, 256, 512)},
                         "down_proj": {"w": 0.05 * randn(gen, 512, 256)}}]}
    from flexq_tpu_torch.models.quantized import quantize_params

    pol = QuantPolicy.llama_flex()
    tree = quantize_params(dense, cfg, pol)
    mesh = Mesh(tp=1, dp=1, rank=0, device=torch.device("cuda", 0), backend="gloo", model_group=None, data_group=None)
    eng = Engine(tree, cfg, pol, max_seq_len=256, mesh=mesh)
    with pytest.raises(ValueError, match='mode="step"'):
        eng.generate([[1, 2, 3]], max_new_tokens=2, mode="fused")
    with pytest.raises(ValueError, match="fused_tick=0"):
        BatchScheduler(tree, cfg, pol, num_slots=2, max_seq_len=256, fused_tick=4, mesh=mesh)


def test_nccl_refuses_two_ranks_on_one_card(gen, monkeypatch):
    """More ranks on a node than cards under NCCL (the default on the card)
    raise before any rendezvous, naming backend="gloo"; with
    LOCAL_WORLD_SIZE unset the message also names it (a launch over several
    nodes must set it)."""
    from flexq_tpu_torch.parallel import initialize

    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match='backend="gloo".*LOCAL_WORLD_SIZE'):
        initialize("127.0.0.1:1", torch.cuda.device_count() + 1, 0, device="cuda")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(torch.cuda.device_count() + 1))
    with pytest.raises(ValueError, match='backend="gloo"'):
        initialize("127.0.0.1:1", 2 * (torch.cuda.device_count() + 1), 0, device="cuda")
