"""The exact grouped integer GEMM of the W6Ax (K2, K3), W4A8 (K10) and
W8A8 (K12) wrappers:

    out[m, n] = sum_g (sum_{k in g} x_q * w) * x_scale[m, g] * w_scale[g, n]

over a signed integer weight ``w`` (the unpacked 6-bit, 4-bit or int8
plane). Two CUDA sources (sm_90a; see each header for the design and its
bound): ``csrc/w6ax_matmul.cu`` serves the 6-bit format (K2, K3: a
streaming kernel up to ``W6AX_STREAM_MAX_M`` rows, int8 tensor cores above;
``w6ax_route`` decides), ``csrc/int_matmul.cu`` the 4- and 8-bit formats
(K10, K12; ``launch`` here). ``grouped_matmul_plain`` is the same function
in PyTorch, with the same rounding: the per-group integer partials are exact, and the f32
accumulation runs over the groups in order, ``acc = acc + part * (x_scale *
w_scale)``, as the TPU kernels (``_w6_matmul_kernel``, ``_w4_matmul_kernel``,
``_w8_kernel``) do (not the einsum order of the reference's ``w*_matmul_ref``
goldens).
"""

from __future__ import annotations

import ctypes

import torch

from flexq_tpu_torch.kernels import _build
from flexq_tpu_torch.kernels.common import GROUP_SIZE, check_tensor

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


def check_activations(x_q, x_scale) -> None:
    m, k = x_q.shape
    if k % GROUP_SIZE:
        raise ValueError(f"K={k} must be a multiple of {GROUP_SIZE}")
    check_tensor(x_q, "x_q", torch.int8, (m, k), x_q.device)
    check_tensor(x_scale, "x_scale", torch.float32, (m, k // GROUP_SIZE), x_q.device)


def launch(fmt: int, x_q, x_scale, p0, p1, w_scale, out_dtype, ks: int) -> torch.Tensor:
    """Launch csrc/int_matmul.cu for weight format ``fmt`` (4: p0 = nibble
    plane; 8: p0 = int8 [K, N]; p1 unused) with ``ks`` warps splitting K per
    block."""
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype {out_dtype} not supported by the kernel")
    if x_q.data_ptr() % 16:
        raise ValueError("x_q must be 16-byte aligned")
    m, k = x_q.shape
    n = w_scale.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=x_q.device)
    fn = _build.function("int_matmul", "flexq_int_matmul", _ARGS)
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
    K > N: down_proj), where few column blocks cover the card, else 8. For
    the W6 format this is also the reference's dispatch to K3."""
    return 16 if m <= 32 and k > n else 8


W6AX_MMA, W6AX_STREAM = 0, 1  # csrc/w6ax_matmul.cu's routes


# The largest M the W6Ax GEMM streams at: measured with
# scripts/torch_w6ax_parts.py routes on the main path's (K, N) (PERF.md, PR 9):
# the streaming route is the faster up to M = 8 at every shape, the tensor
# cores from M = 16 at all but 4096^2 (4 % apart there) and from M = 32 at all.
W6AX_STREAM_MAX_M = 8


def w6ax_route(m: int, k: int, n: int) -> int:
    """The W6Ax GEMM's route for an [M, K] x [K, N] call: the streaming
    kernel (bytes bound: decode) up to W6AX_STREAM_MAX_M rows, the int8
    tensor cores above."""
    return W6AX_STREAM if m <= W6AX_STREAM_MAX_M else W6AX_MMA
