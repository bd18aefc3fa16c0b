"""OPT building blocks used by the serve path (port of the matching parts of
flexq_tpu/models/opt.py): the learned positions' offset and LayerNorm.

OPT adds a learned positional embedding read at ``position + POS_OFFSET``
(HF's OPTLearnedPositionalEmbedding), normalises with LayerNorm (stats in
f32, ``y * g + b`` in f32, then a cast to the model dtype), has biased
linears, a ReLU MLP and a tied lm_head. The serve graph over these is
``models/quantized.py::opt_layer_serve``.
"""

from __future__ import annotations

import torch

POS_OFFSET = 2  # HF OPTLearnedPositionalEmbedding offset


def layernorm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    h = x.to(torch.float32)
    mu = h.mean(dim=-1, keepdim=True)
    var = ((h - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (h - mu) * torch.rsqrt(var + eps)
    return (y * g.to(torch.float32) + b.to(torch.float32)).to(x.dtype)
