"""W6Ax quantized matmul (port of flexq_tpu/kernels/w6_matmul.py::w6_matmul).

    out[m, n] = sum_g (sum_{k in g} x_q * w_q) * x_scale[m, g] * w_scale[g, n]

with the weights as stored by packing/pack6.py (biased u6 nibble + crumb
planes, N-minor). The kernel is ``csrc/w6ax_matmul.cu`` in one of two
routes that ``int_matmul.w6ax_route`` picks from (M, K, N): int8 tensor
cores (wgmma) for prompts, a streaming kernel for decode. Both are
bit-exact against ``w6_matmul_plain`` (``int_matmul.grouped_matmul_plain``
over the unpacked weight). Both read the planes, scales and codes with TMA,
so every base must be 16-byte aligned and N a multiple of 16; other
operands raise rather than fall back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from flexq_tpu_torch.kernels import _build
from flexq_tpu_torch.kernels.common import GROUP_SIZE, arrival_counters, check_tensor, split_scratch
from flexq_tpu_torch.kernels.int_matmul import check_activations, grouped_matmul_plain, split_k_warps, w6ax_route
from flexq_tpu_torch.packing.pack6 import unpack6

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 7 + [ctypes.c_longlong, _P] + [_I] * 5 + [_P]
_GEOMETRY_ARGS = [_I] * 4 + [ctypes.POINTER(ctypes.c_longlong)]


def w6_matmul_plain(x_q, x_scale, w_hi, w_lo, w_scale, out_dtype=torch.float32):
    return grouped_matmul_plain(x_q, x_scale, unpack6(w_hi, w_lo), w_scale, out_dtype)


def check_operands(x_q, x_scale, w_hi, w_lo, w_scale) -> None:
    check_activations(x_q, x_scale)
    k, n, dev = x_q.shape[1], w_hi.shape[1], x_q.device
    check_tensor(w_hi, "w_hi", torch.int8, (k // 2, n), dev)
    check_tensor(w_lo, "w_lo", torch.int8, (k // 4, n), dev)
    check_tensor(w_scale, "w_scale", torch.float32, (k // GROUP_SIZE, n), dev)


@functools.lru_cache(maxsize=512)
def geometry(m: int, k: int, n: int, route: int) -> Tuple[int, ...]:
    """The launch geometry csrc/w6ax_matmul.cu takes for these sizes (its
    own computation): route A's (column tile,), or route B's (blocks
    splitting K, groups a block, compute warps, term slots, shared-memory
    bytes, scratch floats, arrival counters)."""
    info = (ctypes.c_longlong * 7)()
    fn = _build.function("w6ax_matmul", "flexq_w6ax_geometry", _GEOMETRY_ARGS)
    if fn(m, n, k, route, info) != 0:
        raise ValueError(f"no W6Ax geometry for M={m} K={k} N={n} route {route}")
    return (info[0],) if route == 0 else tuple(info)


def launch_w6ax(x_q, x_scale, w_hi, w_lo, w_scale, out_dtype, route: Optional[int] = None) -> torch.Tensor:
    """Launch csrc/w6ax_matmul.cu on checked CUDA operands, in ``route``
    (default: ``w6ax_route(M, K, N)``). TMA reads the codes, planes and
    scales: a base that is not 16-byte aligned, or N not a multiple of 16,
    raises."""
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype {out_dtype} not supported by the kernel")
    m, k = x_q.shape
    n = w_hi.shape[1]
    if n % 16:
        raise ValueError(f"N={n}: the planes' row stride must be a multiple of 16 bytes")
    if any(t.data_ptr() % 16 for t in (x_q, w_hi, w_lo, w_scale)):
        raise ValueError("x_q, the weight planes and w_scale must be 16-byte aligned")
    route = w6ax_route(m, k, n) if route is None else route
    dev = x_q.device
    scratch_floats, n_counters = geometry(m, k, n, route)[5:] if route else (0, 0)
    scratch = split_scratch(dev, scratch_floats).data_ptr() if scratch_floats else None
    counters = arrival_counters(dev, n_counters).data_ptr() if n_counters else None
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    fn = _build.function("w6ax_matmul", "flexq_w6ax_matmul", _ARGS)
    rc = fn(
        x_q.data_ptr(), x_scale.data_ptr(), w_hi.data_ptr(), w_lo.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
        scratch, scratch_floats, counters, m, n, k, int(out_dtype == torch.bfloat16), route,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"W6Ax matmul kernel launch failed (route {route}): CUDA error {rc}")
    return out


def w6_matmul(
    x_q: torch.Tensor,  # int8 [M, K] quantized activations (6- or 8-bit values)
    x_scale: torch.Tensor,  # f32 [M, K/128]
    w_hi: torch.Tensor,  # int8 [K/2, N]
    w_lo: torch.Tensor,  # int8 [K/4, N]
    w_scale: torch.Tensor,  # f32 [K/128, N]
    *,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Exact W6Ax GEMM. Like the reference's dispatch, K-tall decode shapes
    (M <= 32, K > N: down_proj) go to ``w6_matmul_stream``."""
    m, k = x_q.shape
    n = w_hi.shape[1]
    if split_k_warps(m, k, n) == 16:
        from flexq_tpu_torch.kernels.w6_stream import w6_matmul_stream

        return w6_matmul_stream(x_q, x_scale, w_hi, w_lo, w_scale, out_dtype=out_dtype)
    check_operands(x_q, x_scale, w_hi, w_lo, w_scale)
    if x_q.device.type == "cpu":
        return w6_matmul_plain(x_q, x_scale, w_hi, w_lo, w_scale, out_dtype)
    if x_q.device.type != "cuda":
        raise ValueError(f"unsupported device {x_q.device}")
    out = launch_w6ax(x_q, x_scale, w_hi, w_lo, w_scale, out_dtype)
    w6_matmul.launches += 1
    w6_matmul.launches_by_m[m] = w6_matmul.launches_by_m.get(m, 0) + 1
    return out


w6_matmul.launches = 0
w6_matmul.launches_by_m = {}  # M -> launches, beside the count (zeroed with it)
