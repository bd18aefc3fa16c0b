#!/usr/bin/env python3
"""Where the W*A16 GEMM's time goes on the card: csrc/wa16_matmul.cu built
four ways and timed at the same shapes (needs nvcc and an NVIDIA GPU):

    full        the kernel as it is;
    no_dequant  the consumer warpgroups skip the dequant (the weight tile
                keeps whatever it holds; the TMA rings, barriers, wgmmas
                and epilogue run as they are);
    no_mma      the wgmmas are skipped (accumulators stay zero);
    neither     only the TMA rings, barriers and epilogue run.

The variants compute wrong results on purpose: they only take times. Each
is the source with one condition switched off by a text substitution, built
with the same nvcc flags as kernels/_build.py into flexq_tpu_torch/build/.
Times are chip_smoke.timer's (utils/benchmark.bench_fn: CUDA events, median of 20, L2 flushed).

    python3 scripts/torch_wa16_parts.py
"""

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from flexq_tpu_torch.kernels import _build, w6_matmul_bf16, wa16_matmul  # noqa: E402
from flexq_tpu_torch.packing.pack6 import pack6  # noqa: E402

# variant -> (dequant on, MMA on)
VARIANTS = {"full": (1, 1), "no_dequant": (0, 1), "no_mma": (1, 0), "neither": (0, 0)}
SHAPES = ((2048, 4096, 4096), (2048, 11264, 4096), (256, 4096, 4096), (4, 4096, 4096))  # (M, K, N)


def variant_source() -> str:
    with open(os.path.join(_build.CSRC, "wa16_matmul.cu")) as f:
        src = f.read()
    subs = (("    dequant<NB, FMT>(smem", "    if (PARTS_DQ) dequant<NB, FMT>(smem"),
            ("  const bool mma = m0 + 64 * wg < p.M;", "  const bool mma = PARTS_MMA && m0 + 64 * wg < p.M;"))
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"csrc/wa16_matmul.cu no longer holds {old!r}: update this script")
        src = src.replace(old, new)
    return src


def build() -> dict:
    os.makedirs(_build.BUILD, exist_ok=True)
    path = os.path.join(_build.BUILD, "wa16_parts.cu")
    with open(path, "w") as f:
        f.write(variant_source())
    procs = {}
    for name, (dq, mma) in VARIANTS.items():
        out = os.path.join(_build.BUILD, f"libwa16_parts_{name}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", f"-DPARTS_DQ={dq}", f"-DPARTS_MMA={mma}",
               "-o", out, path]
        procs[name] = (out, subprocess.Popen(cmd))
    libs = {}
    for name, (out, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant")
        libs[name] = ctypes.CDLL(out)
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_wa16_parts: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    libs = build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    timer = chip_smoke.timer
    data = {}
    for m, k, n in SHAPES:
        hi, lo = pack6(torch.randint(-32, 32, (k, n), generator=gen, device=dev, dtype=torch.int8))
        ws = torch.rand((k // 128, n), generator=gen, device=dev) * 0.004 + 1e-4
        data[(m, k, n)] = (torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16), hi, lo, ws)
    for name, lib in libs.items():
        fn = lib.flexq_wa16_matmul
        fn.argtypes, fn.restype = wa16_matmul._ARGS, ctypes.c_int
        _build._fns[("wa16_matmul", "flexq_wa16_matmul")] = fn  # the wrapper now launches this variant
        for (m, k, n), (x, hi, lo, ws) in data.items():
            ms = timer(lambda: w6_matmul_bf16(x, hi, lo, ws))
            print(f"wa16 parts {name:10s} W6 M={m} K={k} N={n}: {ms:.4f} ms", flush=True)
    _build._fns.pop(("wa16_matmul", "flexq_wa16_matmul"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
