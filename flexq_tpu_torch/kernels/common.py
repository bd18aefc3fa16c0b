"""Shared kernel utilities (port of flexq_tpu/kernels/common.py).

Also the one place that decides what a device argument means: the port's
entry points run on the card unless the caller asks for the CPU, and asking
for the card on a machine without one is an error, never a silent fallback.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

GROUP_SIZE = 128  # quant group along K; fixed, like the reference


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def resolve_device(device) -> torch.device:
    """torch.device for an entry point's ``device=``; raises when CUDA is
    asked for and no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cuda" and dev.index is None:  # "cuda" means the current card
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (plain version); anything else is refused."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {x.device}")


def check_tensor(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` has the dtype, shape, device and contiguity a kernel
    takes (``dtype`` may be a tuple of allowed dtypes)."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def count_launch(fn, m: int) -> None:
    """Add one launch at M rows to a wrapper's count and to its count by M
    (``fn.launches_by_m``, kept by the exact GEMMs and the producers)."""
    fn.launches += 1
    fn.launches_by_m[m] = fn.launches_by_m.get(m, 0) + 1


_counters: Dict[torch.device, torch.Tensor] = {}


def arrival_counters(dev: torch.device, n: int) -> torch.Tensor:
    """The int32 arrival counters of the kernels that combine their splits
    in the same launch (csrc/flash_decode.cu, csrc/wa16_matmul.cu): zeroed
    once, here, and left zero by every call (the combining block resets its
    counter), so a call needs no memset launch. Calls on one stream run one
    after another and share them."""
    c = _counters.get(dev)
    if c is None or c.numel() < n:
        _refuse_growth_in_capture("arrival_counters", dev)
        c = torch.zeros(max(n, 4096), dtype=torch.int32, device=dev)
        _counters[dev] = c
    return c


_scratch: Dict[torch.device, torch.Tensor] = {}


def split_scratch(dev: torch.device, n: int) -> torch.Tensor:
    """A float32 scratch of at least ``n`` floats for a kernel that splits K
    over blocks and keeps the splits' terms between them
    (csrc/w6ax_matmul.cu's streaming route): kept, not allocated per call.
    Every call writes what it reads back; calls on one stream run one after
    another and share it."""
    buf = _scratch.get(dev)
    if buf is None or buf.numel() < n:
        _refuse_growth_in_capture("split_scratch", dev)
        buf = torch.empty(n, dtype=torch.float32, device=dev)
        _scratch[dev] = buf
    return buf


def _refuse_growth_in_capture(name: str, dev: torch.device) -> None:
    """A shared buffer grows only outside a CUDA graph capture: a tensor
    made while capturing is not filled until the graph replays (the
    counters' zeroing would be a captured kernel), so eager callers would
    read it unset. The eager warm-up before a capture runs the same shapes
    and sizes the buffers first."""
    if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{name} must grow before a CUDA graph capture, not during one")


def shared_buffers(dev: torch.device) -> Tuple[torch.Tensor, ...]:
    """The shared buffers live on ``dev`` now (arrival counters and split
    scratch). A captured graph keeps them: a later, larger request replaces
    the module's tensor, and the graph, which holds the old one's address,
    must not find it freed."""
    return tuple(t for t in (_counters.get(dev), _scratch.get(dev)) if t is not None)
