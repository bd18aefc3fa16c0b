"""Token sampling (port of flexq_tpu/serve/sampling.py, greedy slice).

``SamplingParams`` keeps the reference's fields. This slice serves the
default parameters (greedy, no penalties, no min-length, no temperature /
top-k / top-p), where ``process_logits`` is the f32 cast and ``sample`` the
argmax (first index on ties, as jnp.argmax). Anything else raises
NotImplementedError until the sampling slice.
"""

from __future__ import annotations

import dataclasses
import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 1.0
    top_k: int = 0  # 0 = disabled
    top_p: float = 1.0  # 1.0 = disabled
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    min_length: int = 0
    greedy: bool = True


def require_greedy_default(params: SamplingParams) -> None:
    """Raise unless ``params`` are the defaults this slice serves."""
    if params != SamplingParams():
        raise NotImplementedError(
            "only greedy decoding at default SamplingParams is in this slice; "
            "temperature, top-k/top-p, penalties, min_length and stochastic "
            "sampling come with the sampling slice"
        )


def process_logits(
    logits: torch.Tensor,  # [B, V]
    params: SamplingParams,
) -> torch.Tensor:
    """Logits processing; at the default parameters every transform of the
    reference (penalties, min-length, temperature, top-k, top-p) is the
    identity, leaving the f32 cast."""
    require_greedy_default(params)
    return logits.to(torch.float32)


def sample(logits: torch.Tensor, params: SamplingParams) -> torch.Tensor:
    """Greedy token ids int32 [B]."""
    require_greedy_default(params)
    return torch.argmax(logits, dim=-1).to(torch.int32)
