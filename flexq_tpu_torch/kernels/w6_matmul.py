"""W6Ax quantized matmul (port of flexq_tpu/kernels/w6_matmul.py::w6_matmul).

    out[m, n] = sum_g (sum_{k in g} x_q * w_q) * x_scale[m, g] * w_scale[g, n]

with the weights as stored by packing/pack6.py (biased u6 nibble + crumb
planes, N-minor). The kernel is ``csrc/w6_matmul.cu`` (CUDA C++ for sm_90a,
see its header for the design and its bound; the W4A8 and W8A8 GEMMs are
the same kernel over their weight formats); ``grouped_matmul_plain`` is the
same function in PyTorch, with the same rounding: the per-group integer
partials are exact, and the f32 accumulation runs over the groups in order,
``acc = acc + part * (x_scale * w_scale)``, as the TPU kernels
(``_w6_matmul_kernel``, ``_w4_matmul_kernel``, ``_w8_kernel``) do (not the
einsum order of the reference's ``w*_matmul_ref`` goldens).
"""

from __future__ import annotations

import ctypes

import torch

from flexq_tpu_torch.kernels import _build
from flexq_tpu_torch.kernels.common import GROUP_SIZE, check_tensor
from flexq_tpu_torch.packing.pack6 import unpack6

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]


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


def w6_matmul_plain(x_q, x_scale, w_hi, w_lo, w_scale, out_dtype=torch.float32):
    return grouped_matmul_plain(x_q, x_scale, unpack6(w_hi, w_lo), w_scale, out_dtype)


def check_activations(x_q, x_scale) -> None:
    m, k = x_q.shape
    if k % GROUP_SIZE:
        raise ValueError(f"K={k} must be a multiple of {GROUP_SIZE}")
    check_tensor(x_q, "x_q", torch.int8, (m, k), x_q.device)
    check_tensor(x_scale, "x_scale", torch.float32, (m, k // GROUP_SIZE), x_q.device)


def check_operands(x_q, x_scale, w_hi, w_lo, w_scale) -> None:
    check_activations(x_q, x_scale)
    k, n, dev = x_q.shape[1], w_hi.shape[1], x_q.device
    check_tensor(w_hi, "w_hi", torch.int8, (k // 2, n), dev)
    check_tensor(w_lo, "w_lo", torch.int8, (k // 4, n), dev)
    check_tensor(w_scale, "w_scale", torch.float32, (k // GROUP_SIZE, n), dev)


def launch(fmt: int, x_q, x_scale, p0, p1, w_scale, out_dtype, ks: int) -> torch.Tensor:
    """Launch csrc/w6_matmul.cu for weight format ``fmt`` (6: planes p0 = hi,
    p1 = lo; 4: p0 = nibble plane; 8: p0 = int8 [K, N]) with ``ks`` warps
    splitting K per block."""
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype {out_dtype} not supported by the kernel")
    if x_q.data_ptr() % 16:
        raise ValueError("x_q must be 16-byte aligned")
    m, k = x_q.shape
    n = w_scale.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=x_q.device)
    fn = _build.function("w6_matmul", "flexq_int_matmul", _ARGS)
    rc = fn(
        fmt, x_q.data_ptr(), x_scale.data_ptr(), p0.data_ptr(), None if p1 is None else p1.data_ptr(),
        w_scale.data_ptr(), out.data_ptr(), m, n, k, int(out_dtype == torch.bfloat16),
        ks, 4 if m <= 4 else 8, torch.cuda.current_stream(x_q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"W{fmt} integer matmul kernel launch failed: CUDA error {rc}")
    return out


def split_k_warps(m: int, k: int, n: int) -> int:
    """Warps splitting K per block: 16 for K-tall decode shapes (M <= 32,
    K > N: down_proj), where few column blocks cover the card, else 8."""
    return 16 if m <= 32 and k > n else 8


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
    out = launch(6, x_q, x_scale, w_hi, w_lo, w_scale, out_dtype, ks=8)
    w6_matmul.launches += 1
    return out


w6_matmul.launches = 0
