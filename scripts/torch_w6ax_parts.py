#!/usr/bin/env python3
"""Where the exact integer GEMM's time goes on the card, and which of its two
routes is faster where, for each weight format (csrc/w6ax_matmul.cu: W6Ax,
W4A8, W8A8; needs nvcc and an NVIDIA GPU).

    python3 scripts/torch_w6ax_parts.py routes [FMT ...]   # both routes at M = 4 .. 128
    python3 scripts/torch_w6ax_parts.py parts [FMT ...]    # each route with a part off

FMT: 6, 4 or 8 (default: all three). ``routes`` times route A (int8 tensor
cores) and route B (streaming; up to M = 64, W8 up to 32) on the main
path's (K, N) at M = 4, 8, 16, 32, 64 and 128, with the geometry each
takes; ``w6ax_route`` in kernels/int_matmul.py follows these times
(``STREAM_MAX_M``, one threshold a format).

``parts`` builds the source with one part switched off at a time (a text
substitution, the same nvcc flags as kernels/_build.py, into
flexq_tpu_torch/build/) and times it:

    full          the kernel as it is;
    b_no_compute  route B's compute warps skip the unpack and dp4a (the TMA
                  ring, term slots, fold and hand-on run as they are);
    b_one_block   route B never splits K over blocks (C = 1);
    b_no_compute_one_block  both;
    b_four_warps  route B's split launches run 4 compute warps (2 ring stages
                  each), not 8 (one each);
    a_no_unpack   route A's consumers skip building the weight tile;
    a_no_mma      route A's wgmmas are skipped;
    a_no_epilogue route A's per-group f32 epilogue is skipped.

Each variant runs at the formats asked for. The variants compute wrong
results on purpose: they only take times.
Times are chip_smoke.timer's (utils/benchmark.bench_fn: CUDA events, median of 20, L2 flushed).
"""

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from flexq_tpu_torch.kernels import _build  # noqa: E402
from flexq_tpu_torch.kernels.int_matmul import _ARGS, W6AX_MMA, W6AX_STREAM, geometry, launch, stream_takes  # noqa: E402
from flexq_tpu_torch.packing.pack4 import pack4  # noqa: E402
from flexq_tpu_torch.packing.pack6 import pack6  # noqa: E402

# variant -> the macros it sets to 0 (none: the full kernel)
VARIANTS = {"full": (), "b_no_compute": ("PARTS_B_COMPUTE",), "b_one_block": ("PARTS_B_SPLIT",),
            "b_no_compute_one_block": ("PARTS_B_COMPUTE", "PARTS_B_SPLIT"), "b_four_warps": ("PARTS_B_NW8",),
            "a_no_unpack": ("PARTS_A_UNPACK",), "a_no_mma": ("PARTS_A_MMA",), "a_no_epilogue": ("PARTS_A_EPILOGUE",)}
SUBS = (
    ("      for (int m0 = 0; m0 < p.M; m0 += RP) b_group<FMT, RP>(",
     "      if (PARTS_B_COMPUTE) for (int m0 = 0; m0 < p.M; m0 += RP) b_group<FMT, RP>("),
    ("  if (2 * tiles <= sms || !one_fits) best =", "  if (PARTS_B_SPLIT && (2 * tiles <= sms || !one_fits)) best ="),
    ("  } else {\n    p.nw = NW;\n  }", "  } else {\n    p.nw = PARTS_B_NW8 ? NW : NW / 2;\n  }"),
    ("    up.build(smem + C::OFF_PL", "    if (PARTS_A_UNPACK) up.build(smem + C::OFF_PL"),
    ("      for (int kk = 0; kk < KT / 32; ++kk) {", "      for (int kk = 0; kk < KT / 32 * PARTS_A_MMA; ++kk) {"),
    ("    if (mma) {  // acc += float(P)", "    if (PARTS_A_EPILOGUE && mma) {  // acc += float(P)"),
)
MACROS = ("PARTS_B_COMPUTE", "PARTS_B_SPLIT", "PARTS_B_NW8", "PARTS_A_UNPACK", "PARTS_A_MMA", "PARTS_A_EPILOGUE")
# (M, K, N, route) of the parts
PART_SHAPES = ((4, 4096, 4096, W6AX_STREAM), (4, 4096, 11264, W6AX_STREAM), (4, 11264, 4096, W6AX_STREAM),
               (4, 4096, 32768, W6AX_STREAM), (4, 16384, 4096, W6AX_STREAM), (8, 4096, 4096, W6AX_STREAM),
               (2048, 4096, 4096, W6AX_MMA), (256, 4096, 4096, W6AX_MMA), (128, 4096, 4096, W6AX_MMA))
# the main path's (K, N): LLaMA-2-7B's q/k/v/o, gate/up, down (11264 -> 4096, K2 above M = 32),
# OPT-6.7B's fc1, the packed head
ROUTE_SHAPES = ((4096, 4096), (4096, 11264), (11264, 4096), (4096, 16384), (4096, 32768))
ROUTE_MS = (4, 8, 16, 32, 64, 128)
FORMATS = (6, 4, 8)


def variant_source() -> str:
    with open(os.path.join(_build.CSRC, "w6ax_matmul.cu")) as f:
        src = f.read()
    for old, new in SUBS:
        if src.count(old) != 1:
            raise RuntimeError(f"csrc/w6ax_matmul.cu no longer holds {old!r}: update this script")
        src = src.replace(old, new)
    return src


def build() -> dict:
    os.makedirs(_build.BUILD, exist_ok=True)
    path = os.path.join(_build.BUILD, "w6ax_parts.cu")
    with open(path, "w") as f:
        f.write(variant_source())
    procs = {}
    for name, off in VARIANTS.items():
        out = os.path.join(_build.BUILD, f"libw6ax_parts_{name}.so")
        flags = [f"-D{m}={0 if m in off else 1}" for m in MACROS]
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", *flags, "-o", out, path]
        procs[name] = (out, subprocess.Popen(cmd))
    libs = {}
    for name, (out, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant")
        libs[name] = ctypes.CDLL(out)
    return libs


def operands(fmt, m, k, n, gen, dev):
    """(xq, xs, planes, ws) of weight format ``fmt``, codes at the format's
    activation bits (6 for W6Ax, else 8)."""
    lim = 32 if fmt == 6 else 128
    xq = torch.randint(-lim, lim, (m, k), generator=gen, device=dev, dtype=torch.int8)
    xs = torch.rand((m, k // 128), generator=gen, device=dev) * 0.05 + 1e-3
    w = torch.randint(-(2 ** (fmt - 1)), 2 ** (fmt - 1), (k, n), generator=gen, device=dev, dtype=torch.int8)
    planes = pack6(w) if fmt == 6 else (pack4(w),) if fmt == 4 else (w,)
    ws = torch.rand((k // 128, n), generator=gen, device=dev) * 0.01 + 1e-4
    return xq, xs, planes, ws


def byte_bound_ms(fmt, m, k, n) -> float:
    nbytes = m * k + m * (k // 128) * 4 + k * n * fmt / 8 + (k // 128) * n * 4 + m * n * 2
    return nbytes / chip_smoke.HBM_BPS * 1e3


def routes(dev, gen, timer, formats) -> None:
    for fmt in formats:
        for k, n in ROUTE_SHAPES:
            for m in ROUTE_MS:
                xq, xs, planes, ws = operands(fmt, m, k, n, gen, dev)
                ms = {W6AX_MMA: timer(lambda: launch(fmt, xq, xs, planes, ws, torch.bfloat16, route=W6AX_MMA))}
                b = "B not taken (M too large for its ring)"
                if stream_takes(fmt, m, k, n):
                    ms[W6AX_STREAM] = timer(lambda: launch(fmt, xq, xs, planes, ws, torch.bfloat16, route=W6AX_STREAM))
                    b = f"B {ms[W6AX_STREAM]:.4f} ms {geometry(fmt, m, k, n, W6AX_STREAM)}"
                print(f"w{fmt} routes M={m} K={k} N={n}: A {ms[W6AX_MMA]:.4f} ms {geometry(fmt, m, k, n, W6AX_MMA)} "
                      f"{b} bytes_bound {byte_bound_ms(fmt, m, k, n):.4f} faster {'AB'[min(ms, key=ms.get)]}",
                      flush=True)


def parts(dev, gen, timer, formats) -> None:
    libs = build()
    data = {(fmt, *s): operands(fmt, *s[:3], gen, dev) for fmt in formats for s in PART_SHAPES}
    for name, lib in libs.items():
        fn = lib.flexq_w6ax_matmul
        fn.argtypes, fn.restype = _ARGS, ctypes.c_int
        _build._fns[("w6ax_matmul", "flexq_w6ax_matmul")] = fn  # launch() now launches this variant
        for (fmt, m, k, n, route), (xq, xs, planes, ws) in data.items():
            if name.startswith("a_" if route == W6AX_STREAM else "b_"):
                continue
            ms = timer(lambda: launch(fmt, xq, xs, planes, ws, torch.bfloat16, route=route))
            print(f"w{fmt} parts {name:13s} route {'AB'[route]} M={m} K={k} N={n}: {ms:.4f} ms", flush=True)
    _build._fns.pop(("w6ax_matmul", "flexq_w6ax_matmul"))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_w6ax_parts: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    what = sys.argv[1] if len(sys.argv) > 1 else "routes"
    formats = tuple(int(f) for f in sys.argv[2:]) or FORMATS
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    timer = chip_smoke.timer
    {"routes": routes, "parts": parts}[what](dev, gen, timer, formats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
