"""Generation metrics (port of flexq_tpu/utils/profiling.py:
GenerationStats, StepTimer)."""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import torch


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
    def p50_step_ms(self) -> float:
        if not self.step_times_s:
            return 0.0
        s = sorted(self.step_times_s)
        return s[len(s) // 2] * 1e3


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
