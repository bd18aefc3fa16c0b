"""The exact grouped integer GEMM of the W6Ax (K2, K3), W4A8 (K10) and
W8A8 (K12) wrappers:

    out[m, n] = sum_g (sum_{k in g} x_q * w) * x_scale[m, g] * w_scale[g, n]

over a signed integer weight ``w`` (the unpacked 6-bit, 4-bit or int8
plane). One CUDA source serves the three formats (sm_90a; see its header
for the design and its bound): ``csrc/w6ax_matmul.cu``, in two routes, a
streaming kernel up to ``STREAM_MAX_M[fmt]`` rows and int8 tensor cores
above (``w6ax_route`` decides); ``launch`` here calls it.
``grouped_matmul_plain`` is the same function in PyTorch, with the same
rounding: the per-group integer partials are exact, and the f32
accumulation runs over the groups in order, ``acc = acc + part * (x_scale *
w_scale)``, as the TPU kernels (``_w6_matmul_kernel``, ``_w4_matmul_kernel``,
``_w8_kernel``) do (not the einsum order of the reference's ``w*_matmul_ref``
goldens). On the CPU it takes each weight's planes unpacked once
(``plain_weight``), not on every call: unpacking was most of a 7B-width CPU
forward's time. The unpacked weight is kept as int8, one byte a weight
beside the planes' 0.5-0.75 (LLaMA-2-7B's 6.5e9 linear weights served on
the CPU hold about 6.5 GB more while its params live), and cast to f32 on
each call.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Callable, Dict, Optional, Tuple

import torch

from flexq_tpu_torch.kernels import _build
from flexq_tpu_torch.kernels.common import GROUP_SIZE, arrival_counters, check_tensor, split_scratch

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_I] + [_P] * 7 + [ctypes.c_longlong, _P] + [_I] * 5 + [_P]
_GEOMETRY_ARGS = [_I] * 5 + [ctypes.POINTER(ctypes.c_longlong)]


_plain_weights: Dict[int, tuple] = {}  # id(first plane) -> (weakref, planes' (ptr, version), int8 weight)


def plain_weight(planes: Tuple[torch.Tensor, ...], unpack: Callable) -> torch.Tensor:
    """``unpack(*planes)`` as int8 [K, N] (the signed integer weight). For
    CPU planes it is kept while the first plane lives and is unchanged (its
    data pointer and version counter), so a weight unpacks once; card
    planes unpack on every call, so the plain version's time on the card
    stays that of the whole function."""
    if planes[0].device.type != "cpu":
        return unpack(*planes).to(torch.int8)
    key = id(planes[0])
    stamp = tuple((p.data_ptr(), p._version) for p in planes)
    hit = _plain_weights.get(key)
    if hit is not None and hit[0]() is planes[0] and hit[1] == stamp:
        return hit[2]
    w = unpack(*planes).to(torch.int8)
    ref = weakref.ref(planes[0], lambda _, k=key, kept=_plain_weights: kept.pop(k, None))
    _plain_weights[key] = (ref, stamp, w)
    return w


def grouped_matmul_plain(x_q, x_scale, w_int, w_scale, out_dtype=torch.float32):
    """Plain PyTorch version of the kernel over a signed integer weight
    [K, N] (bit-exact with it)."""
    m, k = x_q.shape
    ng = k // GROUP_SIZE
    w = w_int.to(torch.float32)
    n = w.shape[1]
    # |partial| < 2^24, so the f32 products and sums are exact integers
    xg = x_q.to(torch.float32).reshape(m, ng, GROUP_SIZE).transpose(0, 1)
    parts = torch.bmm(xg, w.reshape(ng, GROUP_SIZE, n))  # [G, M, N]
    xs = x_scale.to(torch.float32)
    ws = w_scale.to(torch.float32)
    acc = torch.zeros((m, n), dtype=torch.float32, device=x_q.device)
    for g in range(ng):
        acc = acc + parts[g] * (xs[:, g : g + 1] * ws[g : g + 1, :])
    return acc.to(out_dtype)


def check_activations(x_q, x_scale) -> None:
    m, k = x_q.shape
    if k % GROUP_SIZE:
        raise ValueError(f"K={k} must be a multiple of {GROUP_SIZE}")
    check_tensor(x_q, "x_q", torch.int8, (m, k), x_q.device)
    check_tensor(x_scale, "x_scale", torch.float32, (m, k // GROUP_SIZE), x_q.device)


def split_k_warps(m: int, k: int, n: int) -> int:
    """The reference's dispatch of the W6 format to its stream kernel (K3):
    16 (its K-splitting warps) for K-tall decode shapes (M <= 32, K > N:
    down_proj), else 8; ``w6_matmul`` hands the 16 cases to
    ``w6_matmul_stream``."""
    return 16 if m <= 32 and k > n else 8


W6AX_MMA, W6AX_STREAM = 0, 1  # csrc/w6ax_matmul.cu's routes


# The largest M each weight format streams at (route B), measured with
# scripts/torch_w6ax_parts.py routes on the main path's (K, N) (PERF.md §6):
# up to it the streaming route is the faster at every shape, above it the
# tensor cores.
STREAM_MAX_M = {6: 8, 4: 8, 8: 16}


def w6ax_route(m: int, k: int, n: int, fmt: int = 6) -> int:
    """The exact GEMM's route for an [M, K] x [K, N] call in weight format
    ``fmt``: the streaming kernel (bytes bound: decode) up to
    STREAM_MAX_M[fmt] rows, the int8 tensor cores above."""
    return W6AX_STREAM if m <= STREAM_MAX_M[fmt] else W6AX_MMA


@functools.lru_cache(maxsize=512)
def geometry(fmt: int, m: int, k: int, n: int, route: int) -> Tuple[int, ...]:
    """The launch geometry csrc/w6ax_matmul.cu takes for these sizes (its
    own computation): route A's (column tile,), or route B's (blocks
    splitting K, groups a block, compute warps, term slots, shared-memory
    bytes, scratch floats, arrival counters)."""
    info = (ctypes.c_longlong * 7)()
    fn = _build.function("w6ax_matmul", "flexq_w6ax_geometry", _GEOMETRY_ARGS)
    if fn(fmt, m, n, k, route, info) != 0:
        raise ValueError(f"no W{fmt} geometry for M={m} K={k} N={n} route {route}")
    return (info[0],) if route == 0 else tuple(info)


def stream_takes(fmt: int, m: int, k: int, n: int) -> bool:
    """Whether route B takes these sizes (its ring stages hold M rows of x;
    the source's geometry decides)."""
    try:
        geometry(fmt, m, k, n, W6AX_STREAM)
    except ValueError:
        return False
    return True


def launch(fmt: int, x_q, x_scale, planes, w_scale, out_dtype, route: Optional[int] = None) -> torch.Tensor:
    """Launch csrc/w6ax_matmul.cu on checked CUDA operands of weight format
    ``fmt`` (``planes``: W6 (hi, lo), W4 (nibble plane,), W8 (int8 [K, N],))
    in ``route`` (default: ``w6ax_route(M, K, N, fmt)``). TMA reads the codes,
    planes and scales: a base that is not 16-byte aligned, or N not a
    multiple of 16, raises."""
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype {out_dtype} not supported by the kernel")
    m, k = x_q.shape
    n = w_scale.shape[1]
    if n % 16:
        raise ValueError(f"N={n}: the planes' row stride must be a multiple of 16 bytes")
    if any(t.data_ptr() % 16 for t in (x_q, *planes, w_scale)):
        raise ValueError("x_q, the weight planes and w_scale must be 16-byte aligned")
    route = w6ax_route(m, k, n, fmt) if route is None else route
    dev = x_q.device
    scratch_floats, n_counters = geometry(fmt, m, k, n, route)[5:] if route else (0, 0)
    scratch = split_scratch(dev, scratch_floats).data_ptr() if scratch_floats else None
    counters = arrival_counters(dev, n_counters).data_ptr() if n_counters else None
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    fn = _build.function("w6ax_matmul", "flexq_w6ax_matmul", _ARGS)
    rc = fn(
        fmt, x_q.data_ptr(), x_scale.data_ptr(), planes[0].data_ptr(), planes[1].data_ptr() if fmt == 6 else None,
        w_scale.data_ptr(), out.data_ptr(), scratch, scratch_floats, counters, m, n, k,
        int(out_dtype == torch.bfloat16), route, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"W{fmt} integer matmul kernel launch failed (route {route}): CUDA error {rc}")
    return out
