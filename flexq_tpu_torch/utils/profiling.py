"""Observability: profiler traces, scoped annotations, generation metrics
(port of flexq_tpu/utils/profiling.py).

The reference's tracing stack on the card: ``trace`` is ``torch.profiler``
with CUDA activity (the reference's jax.profiler Perfetto traces; nsys
does not run on the card's machine), ``scope`` a ``record_function`` range
plus an NVTX range (the reference's NVTX PUSH_RANGE / POP_RANGE, there
jax.named_scope), ``utils/benchmark.py`` the CudaTimer, and
``GenerationStats`` the per-run latency accounting (TTFT, tokens/s).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import List, Optional

import torch


@contextlib.contextmanager
def trace(out_dir: str):
    """Profile the block (host ops and, with a card, its CUDA kernels) and
    write a Chrome / Perfetto trace ``trace_<pid>_<ms>.json`` into
    ``out_dir``. Yields the profiler (``key_averages()`` for sums by
    kernel)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities, acc_events=True) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()  # the block's kernels end inside the trace
    prof.export_chrome_trace(os.path.join(out_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))


class scope(contextlib.ContextDecorator):
    """A named range in the profiler's trace (``record_function``) and, with
    a card, in NVTX; a context manager or a decorator."""

    def __init__(self, name: str):
        self.name = name

    def _recreate_cm(self):  # a decorated function's every call opens its own range
        return scope(self.name)

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._nvtx = torch.cuda.is_available()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        self._range.__exit__(*exc)
        return False


@dataclasses.dataclass
class GenerationStats:
    """Latency accounting for one generate() call."""

    prompt_tokens: int = 0
    generated_tokens: int = 0
    ttft_s: float = 0.0  # time to first token (prefill + first sample)
    decode_s: float = 0.0  # total decode-loop wall time (a graph capture left out)
    capture_s: float = 0.0  # the fused loop's CUDA graph capture, when this call made it
    step_times_s: List[float] = dataclasses.field(default_factory=list)

    @property
    def tokens_per_s(self) -> float:
        return self.generated_tokens / self.decode_s if self.decode_s else 0.0

    @property
    def p50_step_ms(self) -> float:
        if not self.step_times_s:
            return 0.0
        s = sorted(self.step_times_s)
        return s[len(s) // 2] * 1e3

    def summary(self) -> str:
        return (
            f"prompt={self.prompt_tokens} generated={self.generated_tokens} "
            f"ttft={self.ttft_s*1e3:.1f}ms p50_step={self.p50_step_ms:.2f}ms "
            f"throughput={self.tokens_per_s:.1f} tok/s"
        )


class StepTimer:
    """Host wall-clock laps that first wait for ``device``'s queued work
    (torch.cuda.synchronize), so a lap measures the work, not its enqueue."""

    def __init__(self, device: Optional[torch.device] = None):
        self.device = torch.device(device) if device is not None else None
        self.t0 = time.perf_counter()

    def lap(self) -> float:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        dt = now - self.t0
        self.t0 = now
        return dt
