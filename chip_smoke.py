#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (flexq_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line per result; any failure raises and the script
exits nonzero without the final line:
  1. device: the card's name and power limit (nvidia-smi), the kernel build
     (one nvcc per CUDA source, all started together);
  2. kernels: every kernel of the serve path against its plain PyTorch
     version at LLaMA-2-7B shapes (W6Ax at M = 4 and 128 for the three 7B
     (K, N); the producers at K = 4096 and F = 11264; attention at Lq = 1
     and 32, H = 32, D = 128, S = 2048, lengths 64), with the tolerance
     stated, and their device times from CUDA events (median, L2 flushed
     before each launch) beside the plain version's, the least time the card could
     take (bytes at 3.35 TB/s or operations at peak, H100 SXM data sheet)
     and, where one PyTorch call computes the same function, that call's;
  3. slice parity: a 2-layer model at full 7B width, forward_serve on the
     card against the same weights on the CPU (plain versions);
  4. end to end: the 32-layer LLaMA-2-7B shape with random weights (seeded
     torch.Generator, generated and quantized layer by layer on the card),
     greedy Engine.generate, B = 4, 32-token prompts, 32 new tokens, bf16
     cache, max_seq_len 2048; the launch counts of every kernel in that run,
     and a torch.profiler breakdown of a short run (device time by kernel,
     device busy share of the wall time).
The line before the last is the kernels' JSON; the last is
{"ok": true, "device": {...}}.
"""

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from flexq_tpu_torch.config import ModelConfig, QuantPolicy
from flexq_tpu_torch.kernels import (
    _build,
    flash_decode,
    flash_prefill,
    glu_quant,
    launch_counts,
    quant_act,
    reset_launch_counts,
    rmsnorm_quant,
    w6_matmul,
)
from flexq_tpu_torch.kernels.attend_cache import attend_cache_plain
from flexq_tpu_torch.kernels.fused_quant import (
    glu_quant_plain,
    quant_act_plain,
    rmsnorm_quant_plain,
)
from flexq_tpu_torch.kernels.w6_matmul import w6_matmul_plain
from flexq_tpu_torch.models.quantized import forward_serve, quantize_layer
from flexq_tpu_torch.packing.pack6 import pack6
from flexq_tpu_torch.serve import Engine

HBM_BPS = 3.35e12  # H100 SXM HBM3
PEAK_INT8 = 1979e12  # dense int8 tensor-core ops/s
PEAK_BF16 = 989e12  # dense bf16 tensor-core flop/s
PEAK_F32 = 67e12  # f32 outside the tensor cores
SEED = 0

# wrapper -> (route, source, the TPU kernel it replaces)
KERNELS = {
    "rmsnorm_quant": ("triton", "flexq_tpu_torch/kernels/fused_quant.py", "flexq_tpu/kernels/fused_quant.py:119"),
    "w6_matmul": ("cuda", "flexq_tpu_torch/csrc/w6_matmul.cu", "flexq_tpu/kernels/w6_matmul.py:190"),
    "w6_matmul_stream": ("cuda", "flexq_tpu_torch/csrc/w6_matmul.cu", "flexq_tpu/kernels/w6_stream.py:108"),
    "quant_act": ("triton", "flexq_tpu_torch/kernels/fused_quant.py", "flexq_tpu/kernels/fused_quant.py:59"),
    "glu_quant": ("triton", "flexq_tpu_torch/kernels/fused_quant.py", "flexq_tpu/kernels/fused_quant.py:287"),
    "flash_decode": ("cuda", "flexq_tpu_torch/csrc/attend_cache.cu", "flexq_tpu/kernels/flash_decode.py:193"),
    "flash_prefill": ("cuda", "flexq_tpu_torch/csrc/attend_cache.cu", "flexq_tpu/kernels/flash_prefill.py:181"),
}
# the shape whose times go into the JSON line (the main path's decode shape)
REPORT_SHAPE = {
    "rmsnorm_quant": "M=4 K=4096",
    "w6_matmul": "M=4 K=4096 N=11264",
    "w6_matmul_stream": "M=4 K=11264 N=4096",
    "quant_act": "M=4 K=4096",
    "glu_quant": "M=4 F=11264",
    "flash_decode": "B=4 Lq=1 H=32 D=128 S=2048 len=64",
    "flash_prefill": "B=4 Lq=32 H=32 D=128 S=2048 len=64",
}


def log(msg: str) -> None:
    print(msg, flush=True)


class Timer:
    """Median CUDA-event time of a call. A 1 GiB buffer is rewritten before
    each launch (~0.3 ms): weights then come from HBM, not from the 50 MB L2,
    and the card is still busy with it while the host enqueues the call, so
    the events time the device work, not the host's launch overhead (which
    varies with the load on the shared host)."""

    def __init__(self, dev):
        self.flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
        for _ in range(1500):  # ~0.5 s of HBM writes: the card leaves its idle clocks first
            self.flush.zero_()
        torch.cuda.synchronize()

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in pairs)


def bound(nbytes: float, ops: float, peak: float):
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def record(results, name, shape, err, ms, plain_ms, nbytes, ops, peak, library_ms, extra=""):
    bms, by = bound(nbytes, ops, peak)
    log(f"kernel {name:17s} {shape:36s} max_abs_err={err:.3g} ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={bms:.4f} ({by}) library_ms={library_ms if library_ms is None else round(library_ms, 4)}{extra}")
    r = results.setdefault(name, {"max_abs_err": 0.0})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    if shape == REPORT_SHAPE[name]:
        r.update(shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms)


def check_w6(results, dev, gen, timer):
    for m in (4, 128):
        for k, n in ((4096, 4096), (4096, 11264), (11264, 4096)):
            bits = 8 if k > n else 6  # down_proj takes the 8-bit activations
            lim = 2 ** (bits - 1)
            xq = torch.randint(-lim, lim, (m, k), generator=gen, device=dev, dtype=torch.int8)
            xs = torch.rand((m, k // 128), generator=gen, device=dev) * 0.05 + 1e-3
            hi, lo = pack6(torch.randint(-32, 32, (k, n), generator=gen, device=dev, dtype=torch.int8))
            ws = torch.rand((k // 128, n), generator=gen, device=dev) * 0.01 + 1e-4
            name = "w6_matmul_stream" if m <= 32 and k > n else "w6_matmul"
            out = w6_matmul(xq, xs, hi, lo, ws, out_dtype=torch.bfloat16)
            ref = w6_matmul_plain(xq, xs, hi, lo, ws, torch.bfloat16)
            err = (out.float() - ref.float()).abs().max().item()
            if not torch.equal(out, ref):  # tolerance: bit-exact
                raise AssertionError(f"{name} M={m} K={k} N={n}: differs from plain (max {err})")
            xb = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            wb = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
            ms = timer(lambda: w6_matmul(xq, xs, hi, lo, ws, out_dtype=torch.bfloat16))
            plain_ms = timer(lambda: w6_matmul_plain(xq, xs, hi, lo, ws, torch.bfloat16), iters=3, warmup=1)
            dense_ms = timer(lambda: xb @ wb)
            nbytes = m * k + m * (k // 128) * 4 + k * n * 3 // 4 + (k // 128) * n * 4 + m * n * 2
            record(results, name, f"M={m} K={k} N={n}", err, ms, plain_ms, nbytes, 2 * m * n * k,
                   PEAK_INT8, None, extra=f" bf16_dense_ms={dense_ms:.4f} (tolerance: bit-exact)")


def _quant_err(name, shape, got, want):
    """Tolerance: |dq| <= 1 on <= 0.1 % of entries; scales within rtol 1e-6
    on >= 99 % of groups and 1e-2 everywhere; residual out exact."""
    dq = (got[0].int() - want[0].int()).abs()
    rel = (got[1] - want[1]).abs() / want[1]
    ok = (dq.max().item() <= 1 and (dq > 0).float().mean().item() <= 1e-3
          and (rel > 1e-6).float().mean().item() <= 1e-2 and rel.max().item() <= 1e-2
          and all(torch.equal(g, w) for g, w in zip(got[2:], want[2:])))
    if not ok:
        raise AssertionError(f"{name} {shape}: max |dq| {dq.max().item()}, scale rel {rel.max().item():.3g}")
    return float(dq.max().item())


def producer_cases(m, dev, gen):
    """(name, shape, kernel call, plain call, bytes, ops) of the producers at
    M rows, K = 4096 and F = 11264 (the 7B hidden and padded FFN widths)."""
    k, f = 4096, 11264
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    res = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    gamma = (1 + 0.1 * torch.randn(k, generator=gen, device=dev)).to(torch.bfloat16)
    gate = (2 * torch.randn((m, f), generator=gen, device=dev)).to(torch.bfloat16)
    up = torch.randn((m, f), generator=gen, device=dev).to(torch.bfloat16)
    qs_bytes = m * k + m * (k // 128) * 4
    return [
        ("rmsnorm_quant", f"M={m} K={k}", lambda: rmsnorm_quant(x, gamma, 6),
         lambda: rmsnorm_quant_plain(x, gamma, 6), m * k * 2 + k * 2 + qs_bytes, 8 * m * k),
        ("rmsnorm_quant", f"M={m} K={k} +residual", lambda: rmsnorm_quant(x, gamma, 6, residual=res),
         lambda: rmsnorm_quant_plain(x, gamma, 6, residual=res), 3 * m * k * 2 + k * 2 + qs_bytes,
         9 * m * k),
        ("quant_act", f"M={m} K={k}", lambda: quant_act(x, 6), lambda: quant_act_plain(x, 6),
         m * k * 2 + qs_bytes, 4 * m * k),
        ("glu_quant", f"M={m} F={f}", lambda: glu_quant(gate, up, 8), lambda: glu_quant_plain(gate, up, 8),
         2 * m * f * 2 + m * f + m * (f // 128) * 4, 10 * m * f),
    ]


def check_producers(results, dev, gen, timer):
    cases = producer_cases(4, dev, gen) + producer_cases(128, dev, gen)
    # every specialization is compiled and launched before any is timed
    errs = [_quant_err(name, shape, kern(), plain()) for name, shape, kern, plain, _, _ in cases]
    for err, (name, shape, kern, plain, nbytes, ops) in zip(errs, cases):
        ms = timer(kern)
        plain_ms = timer(plain, iters=5, warmup=1)
        record(results, name, shape, err, ms, plain_ms, nbytes, ops, PEAK_F32, None,
               extra=" (tolerance: |dq|<=1 on <=0.1% of q)")


def check_attention(results, dev, gen, timer):
    b, h, kvh, s, d, ln = 4, 32, 32, 2048, 128, 64
    kc = torch.randn((2, b, kvh, s, d), generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn((2, b, kvh, s, d), generator=gen, device=dev).to(torch.bfloat16)
    lengths = torch.full((b,), ln, dtype=torch.int32, device=dev)
    k_valid = kc[1, :, :, :ln].contiguous()  # [B, KVH, len, D] for the library yardstick
    v_valid = vc[1, :, :, :ln].contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for lq in (1, 32):
        q = torch.randn((b, lq, h, d), generator=gen, device=dev).to(torch.bfloat16)
        pos = ln - lq + torch.arange(lq, device=dev)
        mask = torch.arange(ln, device=dev)[None, :] <= pos[:, None]  # [Lq, len]
        qt = q.transpose(1, 2).contiguous()
        if lq == 1:
            name = "flash_decode"
            kern = lambda: flash_decode(q[:, 0], kc, vc, lengths, layer_idx=1)
            lib = lambda: sdpa(qt, k_valid, v_valid)
        else:
            name = "flash_prefill"
            kern = lambda: flash_prefill(q, kc, vc, lengths, layer_idx=1)
            lib = lambda: sdpa(qt, k_valid, v_valid, attn_mask=mask)
        plain = lambda: attend_cache_plain(q, kc, vc, lengths, 1, None, torch.bfloat16, lq == 1, torch.bfloat16)
        got, want = kern().reshape(b, lq, h * d).float(), plain().float()
        err = (got - want).abs().max().item()
        if not err <= 2e-2 * want.abs().max().item():  # tolerance: 2e-2 of max |out| (bf16)
            raise AssertionError(f"{name} Lq={lq}: max abs err {err}")
        lib_out = lib().transpose(1, 2).reshape(b, lq, h * d).float()
        lib_err = (lib_out - want).abs().max().item()
        ms, plain_ms, lib_ms = timer(kern), timer(plain, iters=5, warmup=1), timer(lib)
        keys = int((pos + 1).sum().item())  # keys attended over the Lq queries
        nbytes = 2 * b * kvh * ln * d * 2 + 2 * b * lq * h * d * 2
        record(results, name, f"B={b} Lq={lq} H={h} D={d} S={s} len={ln}", err, ms, plain_ms, nbytes,
               4 * b * h * keys * d, PEAK_BF16, lib_ms,
               extra=f" sdpa_vs_plain_err={lib_err:.3g} (tolerance: 2e-2 of max|out|)")


def random_params(cfg: ModelConfig, policy, gen, dev, dtype=torch.bfloat16):
    """Random LLaMA weights (N(0, 0.02), residual outputs scaled by
    1/sqrt(2L)) generated and quantized layer by layer on the card."""
    std = 0.02
    res_std = std / math.sqrt(2 * cfg.num_layers)
    h, f = cfg.hidden_size, cfg.intermediate_size
    nq, nkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim

    def dense(k, n, s):
        return {"w": torch.randn((k, n), generator=gen, device=dev) * s}

    layers = []
    for _ in range(cfg.num_layers):
        lp = {
            "input_norm": torch.ones(h, device=dev), "post_norm": torch.ones(h, device=dev),
            "q_proj": dense(h, nq, std), "k_proj": dense(h, nkv, std), "v_proj": dense(h, nkv, std),
            "o_proj": dense(nq, h, res_std), "gate_proj": dense(h, f, std), "up_proj": dense(h, f, std),
            "down_proj": dense(f, h, res_std),
        }
        layers.append(quantize_layer(lp, cfg, policy, dtype, dev))
    return {
        "embed": (torch.randn((cfg.vocab_size, h), generator=gen, device=dev) * std).to(dtype),
        "final_norm": torch.ones(h, device=dev, dtype=dtype),
        "layers": layers,
        "lm_head": (torch.randn((h, cfg.vocab_size), generator=gen, device=dev) * std).to(dtype),
    }


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev)


def slice_parity(dev, gen):
    """2-layer model at 7B width: the card's kernels vs the CPU's plain
    versions, prefill of 16 tokens then 2 decode steps (B = 2)."""
    cfg = ModelConfig.llama(num_layers=2)
    policy = QuantPolicy.llama_flex()
    params = random_params(cfg, policy, gen, dev)
    cpu = torch.device("cpu")
    params_cpu = to_device(params, cpu)
    b, l, s = 2, 16, 128
    shape = (cfg.num_layers, b, cfg.num_kv_heads, s, cfg.head_dim)
    caches = {d: tuple(torch.zeros(shape, dtype=torch.bfloat16, device=d) for _ in "kv") for d in (dev, cpu)}
    ids = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (b, l))
    pos, worst, agree, total = 0, 0.0, 0, 0
    for step in range(3):
        n = ids.shape[1]
        positions = torch.as_tensor(np.broadcast_to(np.arange(pos, pos + n), (b, n)).copy())
        outs = {}
        for d, p in ((dev, params), (cpu, params_cpu)):
            logits, caches[d] = forward_serve(p, cfg, policy, torch.as_tensor(ids), positions=positions,
                                              kv_k=caches[d][0], kv_v=caches[d][1], cache_pos=pos, device=d)
            outs[d] = logits.float().cpu()
        ref = outs[cpu]
        if not torch.isfinite(outs[dev]).all():
            raise AssertionError("non-finite logits on the card")
        worst = max(worst, ((outs[dev] - ref).abs().max() / ref.abs().max()).item())
        agree += int((outs[dev].argmax(-1) == ref.argmax(-1)).sum())
        total += ref.shape[0] * ref.shape[1]
        pos += n
        ids = ref[:, -1].argmax(-1).numpy()[:, None]
    log(f"slice parity (2 layers, 7B width, card vs CPU plain): max |dlogit|/max|logit| = {worst:.3g} "
        f"(tolerance 2e-2), argmax agreement {agree}/{total} (tolerance >= 95%)")
    if worst > 2e-2 or agree < 0.95 * total:
        raise AssertionError("slice parity failed")


def end_to_end(dev, gen):
    cfg = ModelConfig.llama()  # LLaMA-2-7B shape, 32 layers
    policy = QuantPolicy.llama_flex()
    t0 = time.perf_counter()
    params = random_params(cfg, policy, gen, dev)
    torch.cuda.synchronize()
    log(f"e2e: random 7B weights generated and quantized in {time.perf_counter() - t0:.1f}s")
    eng = Engine(params, cfg, policy, max_seq_len=2048)
    b, l, new = 4, 32, 32
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (b, l))
    eng.generate(prompts, max_new_tokens=4, eos_id=-1)  # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    out, stats = eng.generate(prompts, max_new_tokens=new, eos_id=-1, return_stats=True)
    counts = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    step_out, step_stats = eng.generate(prompts, max_new_tokens=new, eos_id=-1, return_stats=True, mode="step")
    if out != step_out:
        raise AssertionError("fused and step decode loops disagree")
    if [len(r) for r in out] != [new] * b or not all(0 <= t < cfg.vocab_size for r in out for t in r):
        raise AssertionError(f"bad generate output shape/range: {[len(r) for r in out]}")
    decode_ms = stats.decode_s / (new - 1) * 1e3
    log(f"e2e Engine.generate (fused) B={b} prompt={l} new={new}: ttft_ms={stats.ttft_s * 1e3:.2f} "
        f"decode_ms_per_step={decode_ms:.2f} tokens_per_s={b * new / (stats.ttft_s + stats.decode_s):.1f} "
        f"decode_tokens_per_s={b * (new - 1) / stats.decode_s:.1f} peak_mem_gib={peak_gib:.2f}")
    log(f"e2e Engine.generate (step): ttft_ms={step_stats.ttft_s * 1e3:.2f} "
        f"p50_step_ms={step_stats.p50_step_ms:.2f}; tokens equal to fused: True")
    log(f"e2e first row tokens: {out[0][:8]}")
    for name, n in counts.items():
        log(f"launches {name}: {n}")
    profile_decode(eng, prompts)
    missing = [n for n, c in counts.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    return counts


def profile_decode(eng, prompts, new: int = 8) -> None:
    """Device time by kernel over one short generate (prefill + new - 1
    decode steps) from torch.profiler, and the device's busy share: that
    device time over the wall time of the same generate run without the
    profiler (the profiler itself slows the host several-fold)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(prompts, max_new_tokens=new, eos_id=-1)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        eng.generate(prompts, max_new_tokens=new, eos_id=-1)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in rows)
    log(f"profile generate(new={new}): wall_ms={wall_ms:.1f} (no profiler) device_kernel_ms={busy:.2f} "
        f"device_busy_share={busy / wall_ms:.3f}")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:10]:
        log(f"profile   {ms:9.3f} ms  {n:6d} calls  {key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"device: {kind} count={torch.cuda.device_count()} torch={torch.__version__} cuda={torch.version.cuda}")
    log(smi)
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: nvcc of {len(_build.SOURCES)} CUDA sources in parallel {time.perf_counter() - t0:.1f}s")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    timer = Timer(dev)
    results = {}
    t0 = time.perf_counter()
    check_producers(results, dev, gen, timer)  # first: includes the Triton JIT
    check_w6(results, dev, gen, timer)
    check_attention(results, dev, gen, timer)
    log(f"kernels vs plain: all within tolerance ({time.perf_counter() - t0:.1f}s)")
    del timer  # free its 1 GiB buffer before the model phases measure peak memory
    torch.cuda.empty_cache()

    slice_parity(dev, gen)
    counts = end_to_end(dev, gen)

    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        r = results[name]
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": counts[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
