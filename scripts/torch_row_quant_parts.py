#!/usr/bin/env python3
"""Where the fused producers' time goes on the card (csrc/row_quant.cu: K1
rmsnorm_quant, K4 quant_act, K5 glu_quant, K14 layernorm_quant, K15
relu_quant; needs nvcc and an NVIDIA GPU).

    python3 scripts/torch_row_quant_parts.py parts     # each producer with a part off
    python3 scripts/torch_row_quant_parts.py geometry  # the statistic modes' warps a row
    python3 scripts/torch_row_quant_parts.py host [--parent DIR]

``parts`` and ``geometry`` build variants of the source (text
substitutions, the same nvcc flags as kernels/_build.py, one nvcc each, all
started together, into flexq_tpu_torch/build/) and time the producers
through the wrappers with each variant loaded. ``parts`` times every
producer at M = 4 and 2048 with

    full       the kernel as it is;
    no_stat    the RMS / LayerNorm row statistic (the sums through the
               shuffles and shared memory) is skipped;
    no_quant   the group absmax and the division and rounding are skipped
               (the codes are the producer's values cast);
    no_stores  the codes, scales and residual output are stored only under
               a condition that never holds (the loads and arithmetic stay).

``geometry`` times the RMS / LayerNorm modes at M = 1, 4, 8, 32, 256 and
2048, K = 4096 and 16384, with the source's DECODE_WARPS (16) and
FILL_WARPS (8) warps a row and with 4, 8 or 16 in their place; the
source's stat_geometry follows these times.

``host`` measures the host's microseconds per wrapper call at M = 4 (the
device kept busy by a long sleep kernel, so the host clock times the
enqueue alone), beside the empty kernel's through the same ctypes path,
and each producer's device time at M = 4 and 2048 beside the empty
kernel's (the launch floor). With ``--parent DIR`` (a checkout of a tree
whose producers are not built from csrc/row_quant.cu, such as the Triton
kernel before it, unpacked with ``git archive`` into a directory that
.gitignore lists; to set two versions of this source side by side, run
``host`` from each tree in turn) it also loads that tree's kernels/fused_quant.py and
measures its producers the same way, in turns with this tree's (parent,
this, this, parent).

The variants of ``parts`` compute wrong results on purpose: they only take
times. Times are chip_smoke.timer's (utils/benchmark.bench_fn: CUDA events, median of 20, L2 flushed).
"""

import ctypes
import importlib.util
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from flexq_tpu_torch.kernels import _build, fused_quant  # noqa: E402

PARTS = {
    "full": (),
    "no_stat": (("row_sum<GPW>(t, p.G, part[0])", "t[0].v[0]"), ("row_sum<GPW>(t, p.G, part[1])", "t[0].v[0]")),
    "no_quant": (
        ("#pragma unroll\n  for (int o = 16; o > 0; o >>= 1) a = fmaxf(a, __shfl_xor_sync(0xFFFFFFFFu, a, o));", ""),
        ("const float c = fminf(fmaxf(rintf(__fdiv_rn(y.v[e], scale)), -p.qmax - 1.f), p.qmax);",
         "const float c = y.v[e];"),
    ),
    "no_stores": (
        ("  *reinterpret_cast<uint32_t*>(p.q + t * GS", "  if (w == 0x12345678u) *reinterpret_cast<uint32_t*>(p.q + t * GS"),
        ("  if (lane == 0) p.s[t] = scale;", "  if (scale == 1234.5f && lane == 0) p.s[t] = scale;"),
        ("          store4<BF16>(p.ro, row", "          if (h[i].v[0] == 1234.5f) store4<BF16>(p.ro, row"),
    ),
}
GEOMETRIES = {
    "decode16 fill8": (),
    **{f"decode{w}": (("constexpr int DECODE_WARPS = 16;", f"constexpr int DECODE_WARPS = {w};"),) for w in (4, 8)},
    **{f"fill{w}": (("constexpr int FILL_WARPS = 8;", f"constexpr int FILL_WARPS = {w};"),) for w in (4, 16)},
}
MS = (4, 2048)


def cases(m, dev, gen, fq=fused_quant):
    """(label, call) of every producer of module ``fq`` at M rows: LLaMA's
    K1 (with and without the residual), K4, K5 at K = 4096 / F = 11264, and
    OPT-6.7B's K14 (with and without the residual) and K15 at K = 4096 /
    F = 16384 (inputs drawn from ``gen``: the same for every module)."""
    k, f, fo = 4096, 11264, 16384
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    r = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    g = (1 + 0.1 * torch.randn(k, generator=gen, device=dev)).to(torch.bfloat16)
    b = (0.1 * torch.randn(k, generator=gen, device=dev)).to(torch.bfloat16)
    gate = (2 * torch.randn((m, f), generator=gen, device=dev)).to(torch.bfloat16)
    up = torch.randn((m, f), generator=gen, device=dev).to(torch.bfloat16)
    h = (2 * torch.randn((m, fo), generator=gen, device=dev)).to(torch.bfloat16)
    return [
        (f"rmsnorm_quant M={m} K={k}", lambda: fq.rmsnorm_quant(x, g, 6)),
        (f"rmsnorm_quant M={m} K={k} +residual", lambda: fq.rmsnorm_quant(x, g, 6, residual=r)),
        (f"quant_act M={m} K={k}", lambda: fq.quant_act(x, 6)),
        (f"glu_quant M={m} F={f}", lambda: fq.glu_quant(gate, up, 8)),
        (f"layernorm_quant M={m} K={k}", lambda: fq.layernorm_quant(x, g, b, 6)),
        (f"layernorm_quant M={m} K={k} +residual", lambda: fq.layernorm_quant(x, g, b, 6, residual=r)),
        (f"relu_quant M={m} F={fo}", lambda: fq.relu_quant(h, 6)),
    ]


def build(variants: dict) -> dict:
    """Each variant of csrc/row_quant.cu (name -> its substitutions) built
    into its own library, every nvcc started together."""
    with open(os.path.join(_build.CSRC, "row_quant.cu")) as f:
        base = f.read()
    os.makedirs(_build.BUILD, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(variants.items()):
        src = base
        for old, new in subs:
            if src.count(old) != 1:
                raise RuntimeError(f"csrc/row_quant.cu no longer holds {old!r} once: update this script")
            src = src.replace(old, new)
        path = os.path.join(_build.BUILD, f"row_quant_variant{i}.cu")
        with open(path, "w") as f:
            f.write(src)
        out = os.path.join(_build.BUILD, f"librow_quant_variant{i}.so")
        procs[name] = (out, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o", out, path]))
    libs = {}
    for name, (out, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant")
        libs[name] = ctypes.CDLL(out)
    return libs


def time_variants(libs: dict, data, timer, tag: str) -> None:
    """Time every (label, call) of ``data`` with each library loaded in
    the wrappers' place."""
    for name, lib in libs.items():
        fn = lib.flexq_row_quant
        fn.argtypes, fn.restype = fused_quant._ARGS, ctypes.c_int
        _build._fns[("row_quant", "flexq_row_quant")] = fn  # the wrappers now launch this variant
        for label, call in data:
            print(f"row_quant {tag} {name:14s} {label}: {timer(call):.4f} ms", flush=True)
    _build._fns.pop(("row_quant", "flexq_row_quant"))


def parts(dev, gen, timer) -> None:
    time_variants(build(PARTS), [c for m in MS for c in cases(m, dev, gen)], timer, "parts")


def geometry(dev, gen, timer) -> None:
    data = []
    for m in (1, 4, 8, 32, 256, 2048):
        for k in (4096, 16384):
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            r = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            g = (1 + 0.1 * torch.randn(k, generator=gen, device=dev)).to(torch.bfloat16)
            b = (0.1 * torch.randn(k, generator=gen, device=dev)).to(torch.bfloat16)
            data += [
                (f"rmsnorm_quant M={m} K={k}", lambda x=x, g=g: fused_quant.rmsnorm_quant(x, g, 6)),
                (f"rmsnorm_quant M={m} K={k} +residual", lambda x=x, g=g, r=r: fused_quant.rmsnorm_quant(x, g, 6, residual=r)),
                (f"layernorm_quant M={m} K={k}", lambda x=x, g=g, b=b: fused_quant.layernorm_quant(x, g, b, 6)),
                (f"layernorm_quant M={m} K={k} +residual",
                 lambda x=x, g=g, b=b, r=r: fused_quant.layernorm_quant(x, g, b, 6, residual=r)),
            ]
    time_variants(build(GEOMETRIES), data, timer, "geometry")


def host_us(call, n: int = 300) -> float:
    """Host microseconds per call while the device sleeps (the enqueue alone)."""
    call()
    torch.cuda.synchronize()
    torch.cuda._sleep(500_000_000)  # about 0.25 s at the card's clocks: longer than the n calls take
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    t = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return t


def load_parent(root: str):
    path = os.path.join(root, "flexq_tpu_torch", "kernels", "fused_quant.py")
    spec = importlib.util.spec_from_file_location("parent_fused_quant", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host(dev, gen, timer, parent) -> None:
    empty = lambda: fused_quant.empty_kernel(dev)  # noqa: E731
    print(f"row_quant host empty kernel: {statistics.median(host_us(empty) for _ in range(3)):.2f} us a call; "
          f"device {timer(empty):.4f} ms (the launch floor)", flush=True)
    mods = {"cuda": fused_quant} if parent is None else {"parent": load_parent(parent), "cuda": fused_quant}
    for m in MS:
        seed = gen.initial_seed() + m
        sets = {}
        for tag, mod in mods.items():  # the same inputs for every module
            sets[tag] = cases(m, dev, torch.Generator(device=dev).manual_seed(seed), mod)
        order = list(mods) + list(mods)[::-1]  # parent, this, this, parent
        for i, (label, _) in enumerate(sets["cuda"]):
            dev_ms = {t: [] for t in mods}
            us = {t: [] for t in mods}
            for tag in order:
                call = sets[tag][i][1]
                dev_ms[tag].append(timer(call))
                if m == 4:
                    us[tag].append(host_us(call))
            text = " ".join(f"{t} {statistics.mean(dev_ms[t]):.4f} ms" + (f" {statistics.mean(us[t]):.2f} us_host"
                                                                            if us[t] else "") for t in mods)
            print(f"row_quant host {label}: {text}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_row_quant_parts: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    what = sys.argv[1] if len(sys.argv) > 1 else "parts"
    parent = sys.argv[sys.argv.index("--parent") + 1] if "--parent" in sys.argv else None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    timer = chip_smoke.timer
    if what == "host":
        host(dev, gen, timer, parent)
    else:
        {"parts": parts, "geometry": geometry}[what](dev, gen, timer)
    return 0


if __name__ == "__main__":
    sys.exit(main())
