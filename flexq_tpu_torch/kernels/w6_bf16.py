"""W6A16 GEMMs: 6-bit weights dequantized to bf16 in the kernel, bf16
activations, f32 accumulation (port of flexq_tpu/kernels/w6_matmul.py::
w6_matmul_bf16 (K7, with the RoPE epilogue of kernels/common.py::
rope_epilogue), w6_glu_matmul_bf16 and w6_glu_fused_bf16 (K8)).

    w6_matmul_bf16:      out = x @ W                 [+ RoPE on the f32 sum]
    w6_glu_matmul_bf16:  out = act(x @ G) * (x @ U)  (G, U separate planes)
    w6_glu_fused_bf16:   the same, G and U the two column halves of one plane

with W = bf16((u - 32) * scale) per 128-group, x cast to bf16 first. The
kernel is ``csrc/w6_bf16.cu`` (CUDA C++ for sm_90a; see its header for the
design and its bound); the ``*_plain`` functions compute the same in
PyTorch: the same bf16 weight, an f32 product of the bf16 operands, and
the epilogue in f32 on that product, so kernel and plain version differ only
in the order of the f32 sums.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from flexq_tpu_torch.kernels import _build
from flexq_tpu_torch.kernels.common import GROUP_SIZE, check_tensor, on_card
from flexq_tpu_torch.kernels.fused_quant import glu_act_plain
from flexq_tpu_torch.packing.pack6 import unpack6

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 10 + [_I] * 9 + [_P]
_ACTS = {"silu": 0, "gelu": 1}
ROPE_HEAD = 128  # the epilogue rotates 128-wide heads (head_dim == 128)


# ---- plain PyTorch versions (the same arithmetic, used on the CPU) -------


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


def _acc_plain(x, w_hi, w_lo, w_scale) -> torch.Tensor:
    return acc_plain(x, dequant_int(unpack6(w_hi, w_lo), w_scale))


def rope_epilogue_plain(t, cos, sin2) -> torch.Tensor:
    """t * cos + roll(t, 64) * sin2 per 128-wide head, in f32 (the
    reference's ``rope_epilogue``); cos, sin2 f32 [M, 128]."""
    m, n = t.shape
    th = t.reshape(m, n // ROPE_HEAD, ROPE_HEAD)
    rot = torch.roll(th, ROPE_HEAD // 2, dims=2)
    return (th * cos[:, None, :] + rot * sin2[:, None, :]).reshape(m, n)


def w6_matmul_bf16_plain(x, w_hi, w_lo, w_scale, out_dtype=torch.bfloat16, rope_cos=None, rope_sin2=None):
    acc = _acc_plain(x, w_hi, w_lo, w_scale)
    if rope_cos is not None:
        acc = rope_epilogue_plain(acc, rope_cos.to(torch.float32), rope_sin2.to(torch.float32))
    return acc.to(out_dtype)


def w6_glu_bf16_plain(x, g_hi, g_lo, g_scale, u_hi, u_lo, u_scale, act="silu", out_dtype=torch.bfloat16):
    g = _acc_plain(x, g_hi, g_lo, g_scale)
    u = _acc_plain(x, u_hi, u_lo, u_scale)
    return glu_act_plain(g, u, act).to(out_dtype)


def check_rope(rope_cos, rope_sin2, m: int, n: int, dev) -> None:
    """Raise unless the RoPE operands are absent or both f32 [M, 128] with
    N a multiple of the 128-wide head."""
    if rope_cos is None:
        return
    if rope_sin2 is None or n % ROPE_HEAD:
        raise ValueError("the RoPE epilogue needs rope_sin2 and N a multiple of 128")
    for t, name in ((rope_cos, "rope_cos"), (rope_sin2, "rope_sin2")):
        check_tensor(t, name, torch.float32, (m, ROPE_HEAD), dev)


def _halves(t: torch.Tensor):
    nh = t.shape[1] // 2
    return t[:, :nh], t[:, nh:]


# ---- the kernel ----------------------------------------------------------


def _check_weight(hi, lo, scale, k: int, n: int, ldw: int, dev, name: str) -> None:
    check_tensor(hi, f"{name} hi", torch.int8, (k // 2, ldw), dev)
    check_tensor(lo, f"{name} lo", torch.int8, (k // 4, ldw), dev)
    check_tensor(scale, f"{name} scale", torch.float32, (k // GROUP_SIZE, ldw), dev)
    if n % 128:
        raise ValueError(f"{name}: N={n} must be a multiple of 128 for the kernel")


def launch_bf16(x, w0, w1, col1: int, n: int, out_dtype, act: Optional[str], rope_cos, rope_sin2,
                fmt: int = 6) -> torch.Tensor:
    """csrc/w6_bf16.cu over weight w0 = (hi, lo, scale) (and, for the GLU,
    w1, whose first column is ``col1`` of its planes); ``n`` output columns.
    ``fmt`` 4: w0 = (nibble plane, None, scale), no GLU."""
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype {out_dtype} not supported by the kernel")
    xb = x.to(torch.bfloat16).contiguous()
    m, k = xb.shape
    if xb.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    dev = xb.device
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    ldw = w0[0].shape[1]
    ptrs = [t.data_ptr() if t is not None else None for t in w0]
    if w1 is not None:
        ptrs += [w1[0].data_ptr() + col1, w1[1].data_ptr() + col1, w1[2].data_ptr() + 4 * col1]
    else:
        ptrs += [None, None, None]
    rope = [rope_cos.data_ptr(), rope_sin2.data_ptr()] if rope_cos is not None else [None, None]
    glu = w1 is not None
    bm = 128 if (m > 64 and not glu) else 64
    fn = _build.function("w6_bf16", "flexq_w6_bf16", _ARGS)
    rc = fn(
        xb.data_ptr(), *ptrs, *rope, out.data_ptr(), m, n, k, ldw,
        int(out_dtype == torch.bfloat16), int(glu), _ACTS.get(act, 0), bm, fmt,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"w6_bf16 kernel launch failed: CUDA error {rc}")
    return out


# ---- wrappers ------------------------------------------------------------


def w6_matmul_bf16(
    x: torch.Tensor,  # bf16/f32 [M, K] full-precision activations
    w_hi: torch.Tensor,  # int8 [K/2, N]
    w_lo: torch.Tensor,  # int8 [K/4, N]
    w_scale: torch.Tensor,  # f32 [K/128, N]
    *,
    out_dtype=torch.bfloat16,
    rope_cos: Optional[torch.Tensor] = None,  # f32 [M, 128]: fused RoPE epilogue
    rope_sin2: Optional[torch.Tensor] = None,  # f32 [M, 128] = (-sin_half | sin_half)
) -> torch.Tensor:
    """W6A16 GEMM; with ``rope_cos``/``rope_sin2`` the HF half-rotate RoPE
    is applied to the f32 accumulator of every 128-wide head before the
    cast (build the operands with models.llama.rope_gemm_operands)."""
    m, k = x.shape
    n = w_hi.shape[1]
    if k % GROUP_SIZE:
        raise ValueError(f"K={k} must be a multiple of {GROUP_SIZE}")
    check_rope(rope_cos, rope_sin2, m, n, x.device)
    if not on_card(x):
        return w6_matmul_bf16_plain(x, w_hi, w_lo, w_scale, out_dtype, rope_cos, rope_sin2)
    _check_weight(w_hi, w_lo, w_scale, k, n, n, x.device, "w")
    out = launch_bf16(x, (w_hi, w_lo, w_scale), None, 0, n, out_dtype, None, rope_cos, rope_sin2)
    w6_matmul_bf16.launches += 1
    return out


def w6_glu_matmul_bf16(x, g_hi, g_lo, g_scale, u_hi, u_lo, u_scale, *, act="silu", out_dtype=torch.bfloat16):
    """Fused W6A16 GLU: act(x @ gate) * (x @ up) in one kernel (gate and up
    as separate planes of the same width)."""
    if act not in _ACTS:
        raise ValueError(f"unsupported activation {act!r}")
    m, k = x.shape
    n = g_hi.shape[1]
    if not on_card(x):
        return w6_glu_bf16_plain(x, g_hi, g_lo, g_scale, u_hi, u_lo, u_scale, act, out_dtype)
    _check_weight(g_hi, g_lo, g_scale, k, n, n, x.device, "gate")
    _check_weight(u_hi, u_lo, u_scale, k, n, n, x.device, "up")
    out = launch_bf16(x, (g_hi, g_lo, g_scale), (u_hi, u_lo, u_scale), 0, n, out_dtype, act, None, None)
    w6_glu_matmul_bf16.launches += 1
    return out


def w6_glu_fused_bf16(x, hi, lo, scale, *, act="silu", out_dtype=torch.bfloat16):
    """Fused-plane variant: one packed [K, 2*Nh] gate|up weight (gate in
    columns [0, Nh), up in [Nh, 2Nh), the ``fuse=True`` layout). The kernel
    reads the up half through the same planes at a column offset: nothing
    is sliced or copied."""
    if act not in _ACTS:
        raise ValueError(f"unsupported activation {act!r}")
    m, k = x.shape
    n2 = hi.shape[1]
    if n2 % 2:
        raise ValueError(f"fused gate|up width {n2} must be even")
    nh = n2 // 2
    if not on_card(x):
        (gh, uh), (gl, ul), (gs, us) = _halves(hi), _halves(lo), _halves(scale)
        return w6_glu_bf16_plain(x, gh, gl, gs, uh, ul, us, act, out_dtype)
    _check_weight(hi, lo, scale, k, nh, n2, x.device, "gate_up")
    w = (hi, lo, scale)
    out = launch_bf16(x, w, w, nh, nh, out_dtype, act, None, None)
    w6_glu_fused_bf16.launches += 1
    return out


w6_matmul_bf16.launches = 0
w6_glu_matmul_bf16.launches = 0
w6_glu_fused_bf16.launches = 0
