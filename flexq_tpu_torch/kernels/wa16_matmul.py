"""The W*A16 GEMM shared by the W6A16 (K7, K8) and W4A16 (K11) wrappers:
integer weights dequantized to bf16 in the kernel, bf16 activations, f32
accumulation, with an optional RoPE epilogue (the reference's
kernels/common.py::rope_epilogue) and, for two weights, the GLU epilogue
act(x @ G) * (x @ U).

The kernel is ``csrc/wa16_matmul.cu`` (CUDA C++ for sm_90a: TMA rings of the
x tile and of the raw plane tiles, dequantized into shared memory and
multiplied on ``wgmma``; the weight format a template parameter; see its
header for the design and its bound). Its geometry (tiles, K splits,
scratch) is computed in the source, which the wrapper asks for the sizes of
the scratch it allocates.
The plain pieces here compute the same in PyTorch: ``dequant_int`` the bf16
weight bf16((u - bias) * scale), ``acc_plain`` an f32 product of the bf16
operands and ``rope_epilogue_plain`` the epilogue in f32 on that product, so
kernel and plain version differ only in the order of the f32 sums.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from flexq_tpu_torch.kernels import _build
from flexq_tpu_torch.kernels.common import GROUP_SIZE, arrival_counters, check_tensor

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 11 + [ctypes.c_longlong, _P] + [_I] * 8 + [_P]
_SIZES_ARGS = [_I] * 5 + [ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)]
ACTS = {"silu": 0, "gelu": 1}
ROPE_HEAD = 128  # the epilogue rotates 128-wide heads (head_dim == 128)


def dequant_int(w_int, w_scale, dtype=torch.bfloat16) -> torch.Tensor:
    """[K, N] weight in ``dtype`` from a signed integer weight: ``dtype``
    of the f32 product w * scale (per 128-group along K), rounded to
    nearest-even. With bf16 this is the TPU kernels' dequant,
    bf16((u - bias) * scale)."""
    ws = w_scale.to(torch.float32).repeat_interleave(GROUP_SIZE, dim=0)
    return (w_int.to(torch.float32) * ws).to(dtype)


def acc_plain(x, w_bf16) -> torch.Tensor:
    """f32 x @ W of the bf16 operands (the products are exact in f32)."""
    return x.to(torch.bfloat16).to(torch.float32) @ w_bf16.to(torch.float32)


def rope_epilogue_plain(t, cos, sin2) -> torch.Tensor:
    """t * cos + roll(t, 64) * sin2 per 128-wide head, in f32 (the
    reference's ``rope_epilogue``); cos, sin2 f32 [M, 128]."""
    m, n = t.shape
    th = t.reshape(m, n // ROPE_HEAD, ROPE_HEAD)
    rot = torch.roll(th, ROPE_HEAD // 2, dims=2)
    return (th * cos[:, None, :] + rot * sin2[:, None, :]).reshape(m, n)


def check_rope(rope_cos, rope_sin2, m: int, n: int, dev) -> None:
    """Raise unless the RoPE operands are absent or both f32 [M, 128] with
    N a multiple of the 128-wide head."""
    if rope_cos is None:
        return
    if rope_sin2 is None or n % ROPE_HEAD:
        raise ValueError("the RoPE epilogue needs rope_sin2 and N a multiple of 128")
    for t, name in ((rope_cos, "rope_cos"), (rope_sin2, "rope_sin2")):
        check_tensor(t, name, torch.float32, (m, ROPE_HEAD), dev)


@functools.lru_cache(maxsize=256)
def _sizes(m: int, n: int, k: int, glu: bool, fmt: int) -> Tuple[int, int]:
    """(f32 scratch floats, arrival counters) of a launch, as the kernel's
    own geometry gives them."""
    part, counters = ctypes.c_longlong(), ctypes.c_int()
    fn = _build.function("wa16_matmul", "flexq_wa16_matmul_sizes", _SIZES_ARGS)
    rc = fn(m, n, k, int(glu), fmt, ctypes.byref(part), ctypes.byref(counters))
    if rc != 0:
        raise RuntimeError(f"W*A16 matmul sizes: CUDA error {rc}")
    return part.value, counters.value


def launch_bf16(x, w0, w1, col1: int, n: int, out_dtype, act: Optional[str], rope_cos, rope_sin2,
                fmt: int = 6) -> torch.Tensor:
    """csrc/wa16_matmul.cu over weight w0 = (hi, lo, scale) (and, for the GLU,
    w1, whose first column is ``col1`` of its planes); ``n`` output columns.
    ``fmt`` 4: w0 = (nibble plane, None, scale), no GLU. The kernel reads
    the planes with TMA, which takes 16-byte aligned bases and row strides:
    other planes raise."""
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype {out_dtype} not supported by the kernel")
    xb = x.to(torch.bfloat16).contiguous()
    m, k = xb.shape
    if xb.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    dev = xb.device
    ldw = w0[0].shape[1]
    if ldw % 16:
        raise ValueError(f"the weight planes' row stride {ldw} must be a multiple of 16 bytes")
    ptrs = [t.data_ptr() if t is not None else None for t in w0]
    if w1 is not None:
        ptrs += [w1[0].data_ptr() + col1, w1[1].data_ptr() + col1, w1[2].data_ptr() + 4 * col1]
    else:
        ptrs += [None, None, None]
    if any(p is not None and p % 16 for p in ptrs):
        raise ValueError("the weight planes (and the up half's column offset) must be 16-byte aligned")
    rope = [rope_cos.data_ptr(), rope_sin2.data_ptr()] if rope_cos is not None else [None, None]
    glu = w1 is not None
    part_floats, n_counters = _sizes(m, n, k, glu, fmt)
    part = torch.empty(max(part_floats, 1), dtype=torch.float32, device=dev)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    fn = _build.function("wa16_matmul", "flexq_wa16_matmul", _ARGS)
    rc = fn(
        xb.data_ptr(), *ptrs, *rope, out.data_ptr(), part.data_ptr(), part_floats,
        arrival_counters(dev, n_counters).data_ptr(), m, n, k, ldw, int(out_dtype == torch.bfloat16), int(glu),
        ACTS.get(act, 0), fmt, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"W*A16 matmul kernel launch failed: CUDA error {rc}")
    return out
