"""Hand-written Hopper kernels of the port, each beside its plain version.

Every wrapper launches its kernel for a CUDA tensor (or raises) and runs the
plain PyTorch version for a CPU tensor; ``launch_counts()`` reads the
per-wrapper launch counters and ``reset_launch_counts()`` zeroes them (and
the counts by M that the exact GEMMs and the producers keep beside them).
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
