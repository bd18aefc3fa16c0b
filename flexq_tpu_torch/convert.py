"""Carry a serve tree built by the JAX package into the port's tensors.

``params_from_numpy`` takes ``flexq_tpu.models.quantized.quantize_params``'s
output with every leaf converted to numpy (``jax.tree_util.tree_map(
np.asarray, tree)``) and returns the same tree of torch tensors on
``device``. bf16 leaves arrive as ml_dtypes bfloat16 arrays, which torch
cannot read directly: they are viewed as uint16 and reinterpreted as
torch.bfloat16, bit for bit. This module itself imports neither JAX nor the
JAX package.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from flexq_tpu_torch.kernels.common import resolve_device


def _leaf(a: np.ndarray, device: torch.device) -> torch.Tensor:
    if not (a.flags.c_contiguous and a.flags.writeable):  # arrays from JAX are read-only
        a = a.copy(order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """dicts, lists and tuples are rebuilt; numpy arrays become tensors."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        if isinstance(x, np.ndarray):
            return _leaf(x, dev)
        raise TypeError(f"unsupported leaf type {type(x).__name__}; convert leaves to numpy first")

    return conv(tree)
