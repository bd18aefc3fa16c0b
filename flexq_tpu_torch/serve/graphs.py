"""A captured CUDA graph of one decode step: the port's form of the
reference's on-device decode loops (the Engine's fused ``lax.while_loop``,
flexq_tpu/serve/engine.py, and the scheduler's fused ticks,
flexq_tpu/serve/scheduler.py::_fused_loop_body).

``StepGraph(step, device)`` wraps ``step``, a callable of no arguments that
reads and writes only tensors that outlive it (the cache, the fed tokens,
the positions, the sampling state, the output columns: static buffers). On
the card the first ``run`` runs the step once eagerly on the graph's own
stream, a real step that also does every first-use job (kernel builds,
ctypes geometry caches, the shared scratch's sizes, the RoPE table and the
divisors copied to the card, cuBLAS's workspace for that stream), then
captures it; every later step is a replay. A failed capture or replay
raises: nothing falls back to the eager step on the card. On the CPU
``run`` calls the step eagerly, which is the graph's plain version.

Launch counts: the kernel wrappers count their launches while the step is
captured, though nothing runs then. The capture puts the counts back and
keeps what it counted; each replay adds it once, so
``kernels.launch_counts()`` says what the card ran.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import torch

from flexq_tpu_torch.kernels import add_counts, count_delta, count_state, restore_counts
from flexq_tpu_torch.kernels.common import shared_buffers


class StepGraph:
    """One decode step, captured once and replayed (see the module doc).

    ``generator``: the ``torch.Generator`` the step draws from, registered
    with the graph so that each replay draws anew and in the order the
    eager step would. ``guard``: returns the tensors the step must find
    where the capture found them (the cache); a replay raises if one was
    replaced. ``capture_s`` is the capture's wall time (with the graph's
    instantiation), ``replays`` the replays so far, ``launches_per_replay``
    the kernel launches of one replay."""

    def __init__(self, step: Callable[[], None], device: torch.device,
                 generator: Optional[torch.Generator] = None,
                 guard: Optional[Callable[[], Tuple[torch.Tensor, ...]]] = None):
        self.step = step
        self.device = device
        self.generator = generator
        self.guard = guard
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.capture_s = 0.0
        self.replays = 0
        self.launches_per_replay = 0
        self._delta: dict = {}
        self._guarded: Tuple[torch.Tensor, ...] = ()
        self._held: Tuple[torch.Tensor, ...] = ()

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def run(self, n: int = 1) -> None:
        """Run the step ``n`` times: eagerly on the CPU; on the card the
        first call's first step is the eager warm-up before the capture,
        and every other step a replay."""
        if self.device.type != "cuda":
            for _ in range(n):
                self.step()
            return
        if n <= 0:
            return
        if self.graph is None:
            self._capture()
            n -= 1
        if self.guard is not None and any(a is not b for a, b in zip(self.guard(), self._guarded)):
            raise RuntimeError("a tensor the step graph captured was replaced (the cache must stay in place)")
        for _ in range(n):
            self.graph.replay()
        self.replays += n
        add_counts(self._delta, n)

    def _capture(self) -> None:
        stream = torch.cuda.Stream(self.device)
        cur = torch.cuda.current_stream(self.device)
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            self.step()  # the warm-up: a real step, counted as one
        cur.wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            register = getattr(graph, "register_generator_state", None)
            if register is None:
                raise RuntimeError("sampling inside a CUDA graph needs CUDAGraph.register_generator_state "
                                   f"(PyTorch {torch.__version__} has none)")
            register(self.generator)
        before = count_state()
        t0 = time.perf_counter()
        # capture_begin / capture_end, not torch.cuda.graph: that context
        # also collects garbage and empties the allocator's cache, whose
        # memory every later call would then have to cudaMalloc again.
        # thread_local: a server's other threads keep their own CUDA calls;
        # this thread's unsafe calls (a sync, a pageable copy) raise
        try:
            with torch.cuda.stream(stream):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self.step()
                except BaseException:
                    try:
                        graph.capture_end()  # ends the failed capture; the step's error is the one to see
                    except RuntimeError:
                        pass
                    raise
                graph.capture_end()
        finally:
            after = count_state()
            restore_counts(before)  # the capture ran nothing
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0
        self._delta = count_delta(before, after)
        self.launches_per_replay = sum(n for n, _ in self._delta.values())
        self._guarded = tuple(self.guard()) if self.guard is not None else ()
        self._held = shared_buffers(self.device)
        self.graph = graph
