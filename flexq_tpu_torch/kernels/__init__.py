"""Hand-written Hopper kernels of the port, each beside its plain version.

Every wrapper launches its kernel for a CUDA tensor (or raises) and runs the
plain PyTorch version for a CPU tensor; ``launch_counts()`` reads the
per-wrapper launch counters and ``reset_launch_counts()`` zeroes them (and
the counts by M that the exact GEMMs and the producers keep beside them).
A CUDA graph's replays add the launches its capture counted
(``count_state`` / ``restore_counts`` / ``add_counts``, serve/graphs.py), so
the counts say what the card ran, replayed or launched.
"""

from typing import Dict

from flexq_tpu_torch.kernels.common import GROUP_SIZE
from flexq_tpu_torch.kernels.flash_decode import flash_decode, flash_decode_paged
from flexq_tpu_torch.kernels.flash_prefill import flash_prefill
from flexq_tpu_torch.kernels.fused_quant import glu_quant, layernorm_quant, quant_act, relu_quant, rmsnorm_quant
from flexq_tpu_torch.kernels.w4_matmul import w4_matmul, w4_matmul_bf16
from flexq_tpu_torch.kernels.w6_bf16 import w6_glu_fused_bf16, w6_glu_matmul_bf16, w6_matmul_bf16
from flexq_tpu_torch.kernels.w6_matmul import w6_matmul
from flexq_tpu_torch.kernels.w6_stream import w6_matmul_stream
from flexq_tpu_torch.kernels.w8_matmul import w8_matmul

WRAPPERS = (
    rmsnorm_quant, w6_matmul, w6_matmul_stream, quant_act, glu_quant, flash_decode,
    flash_prefill, w6_matmul_bf16, w6_glu_matmul_bf16, w6_glu_fused_bf16,
    w4_matmul, w4_matmul_bf16, w8_matmul, flash_decode_paged, layernorm_quant, relu_quant,
)


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
        if hasattr(fn, "launches_by_m"):
            fn.launches_by_m.clear()


def count_state() -> Dict[str, tuple]:
    """Every wrapper's (launches, launches by M) as they stand."""
    return {fn.__name__: (fn.launches, dict(getattr(fn, "launches_by_m", {}))) for fn in WRAPPERS}


def restore_counts(state: Dict[str, tuple]) -> None:
    """Set every wrapper's counts back to ``state`` (from ``count_state``)."""
    for fn in WRAPPERS:
        fn.launches = state[fn.__name__][0]
        if hasattr(fn, "launches_by_m"):
            fn.launches_by_m.clear()
            fn.launches_by_m.update(state[fn.__name__][1])


def count_delta(before: Dict[str, tuple], after: Dict[str, tuple]) -> Dict[str, tuple]:
    """The launches (and launches by M) counted between two ``count_state``s."""
    out = {}
    for name, (n, by_m) in after.items():
        n0, by_m0 = before[name]
        d_by_m = {m: v - by_m0.get(m, 0) for m, v in by_m.items() if v != by_m0.get(m, 0)}
        if n != n0 or d_by_m:
            out[name] = (n - n0, d_by_m)
    return out


def add_counts(delta: Dict[str, tuple], times: int) -> None:
    """Add ``times`` x a ``count_delta`` to the wrappers' counts."""
    for fn in WRAPPERS:
        if fn.__name__ not in delta:
            continue
        n, by_m = delta[fn.__name__]
        fn.launches += n * times
        for m, v in by_m.items():
            fn.launches_by_m[m] = fn.launches_by_m.get(m, 0) + v * times
