"""Token sampling and logits post-processing (port of
flexq_tpu/serve/sampling.py).

Every transform maps logits [B, V] to logits: temperature, the repetition /
presence / frequency penalties over per-row token counts, min-length (EOS
banned until enough tokens), bad words, top-k and top-p. ``process_logits``
takes the parameters as Python numbers; ``process_logits_dynamic`` takes the
float knobs as one f32[6] tensor (``dynamic_params``) so that one batched
call serves rows of any temperature, and only ``structural_key`` shapes the
computation. ``sample`` draws from a ``torch.Generator`` where the reference
splits a JAX key: the two give different draws from the same seed, and the
greedy argmax is the same. The ``Engine`` (with its speculative mode) and
the ``BatchScheduler`` both serve all of it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

NEG_INF = torch.finfo(torch.float32).min


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode config."""

    temperature: float = 1.0
    top_k: int = 0  # 0 = disabled
    top_p: float = 1.0  # 1.0 = disabled
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    min_length: int = 0
    greedy: bool = True


def apply_temperature(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    if temperature == 1.0:
        return logits
    return logits / max(temperature, 1e-6)


def apply_repetition_penalty(logits: torch.Tensor, token_counts: torch.Tensor, penalty: float) -> torch.Tensor:
    """CTRL-style: seen tokens' positive logits divided, negative ones
    multiplied."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(token_counts > 0, penalized, logits)


def apply_presence_frequency_penalty(
    logits: torch.Tensor, token_counts: torch.Tensor, presence: float, frequency: float
) -> torch.Tensor:
    if presence == 0.0 and frequency == 0.0:
        return logits
    return logits - presence * (token_counts > 0).to(logits.dtype) - frequency * token_counts.to(logits.dtype)


def apply_min_length(logits: torch.Tensor, cur_length: torch.Tensor, min_length: int, eos_id: int) -> torch.Tensor:
    """Ban EOS until ``min_length`` tokens are generated (logits [B, V],
    cur_length int [B])."""
    if min_length <= 0:
        return logits
    ban = cur_length.reshape(-1).to(logits.device) < min_length
    out = logits.clone()
    out[:, eos_id] = torch.where(ban, torch.full_like(ban, NEG_INF, dtype=logits.dtype), logits[:, eos_id])
    return out


def apply_bad_words(logits: torch.Tensor, bad_words_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """bad_words_mask: bool [V] or [B, V], True = banned."""
    if bad_words_mask is None:
        return logits
    return logits.masked_fill(bad_words_mask.to(logits.device), NEG_INF)


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 0:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, NEG_INF)


def _top_p_cut(logits: torch.Tensor, p) -> torch.Tensor:
    """Keep the smallest prefix of the sorted distribution whose cumulative
    probability reaches ``p`` (always the top token)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits.to(torch.float32), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs < p).sum(dim=-1, keepdim=True).clamp(min=1)
    cutoff = torch.gather(sorted_logits, -1, keep - 1)
    return logits.masked_fill(logits < cutoff, NEG_INF)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    if p >= 1.0:
        return logits
    return _top_p_cut(logits, p)


def process_logits(
    logits: torch.Tensor,  # [B, V]
    params: SamplingParams,
    token_counts: Optional[torch.Tensor] = None,  # int [B, V]
    cur_length: Optional[torch.Tensor] = None,  # int [B]
    eos_id: int = 2,
    bad_words_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    logits = logits.to(torch.float32)
    if token_counts is not None:
        logits = apply_repetition_penalty(logits, token_counts, params.repetition_penalty)
        logits = apply_presence_frequency_penalty(
            logits, token_counts, params.presence_penalty, params.frequency_penalty
        )
    if cur_length is not None:
        logits = apply_min_length(logits, cur_length, params.min_length, eos_id)
    logits = apply_bad_words(logits, bad_words_mask)
    logits = apply_temperature(logits, params.temperature)
    logits = apply_top_k(logits, params.top_k)
    return apply_top_p(logits, params.top_p)


def dynamic_params(params: SamplingParams, device=None) -> torch.Tensor:
    """The float knobs as one f32[6] tensor (see process_logits_dynamic)."""
    return torch.tensor(
        [params.temperature, params.top_p, params.repetition_penalty, params.presence_penalty,
         params.frequency_penalty, params.min_length],
        dtype=torch.float32, device=device,
    )


def structural_key(params: SamplingParams):
    """The parts of SamplingParams that shape process_logits_dynamic's
    computation (everything else is a tensor operand)."""
    return (params.greedy, params.top_k, params.top_p < 1.0)


def process_logits_dynamic(
    logits: torch.Tensor,  # [B, V]
    dyn: torch.Tensor,  # f32 [6] from dynamic_params()
    top_k: int,
    use_top_p: bool,
    token_counts: Optional[torch.Tensor] = None,  # int [B, V]
    cur_length: Optional[torch.Tensor] = None,  # int [B]
    eos_ids: Optional[torch.Tensor] = None,  # int [B] (per-row eos)
) -> torch.Tensor:
    """process_logits with the float knobs (temperature, top_p, penalties,
    min_length) as tensor operands; neutral values are exact no-ops
    (x / 1.0, x - 0.0), so for equal parameters the result equals
    process_logits'."""
    temp, top_p, rep, pres, freq, min_len = dyn.to(logits.device).unbind()
    logits = logits.to(torch.float32)
    if token_counts is not None:
        seen = token_counts > 0
        pen = torch.where(logits > 0, logits / rep, logits * rep)
        logits = torch.where(seen, pen, logits)
        logits = logits - pres * seen.to(torch.float32) - freq * token_counts.to(torch.float32)
    if cur_length is not None and eos_ids is not None:
        rows = torch.arange(logits.shape[0], device=logits.device)
        eos = eos_ids.to(device=logits.device, dtype=torch.int64)
        ban = cur_length.to(logits.device).to(torch.float32) < min_len
        cur = logits[rows, eos]
        logits = logits.clone()
        logits[rows, eos] = torch.where(ban, torch.full_like(cur, NEG_INF), cur)
    logits = logits / torch.clamp(temp, min=1e-6)
    if top_k > 0:
        logits = apply_top_k(logits, top_k)
    if use_top_p:
        logits = _top_p_cut(logits, top_p)
    return logits


def sample(
    logits: torch.Tensor,  # [B, V] already processed
    params: SamplingParams,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Token ids int32 [B]: the argmax (first index on ties) when greedy,
    else a draw from softmax(logits) with ``generator``: the exponential race
    argmax(p / E), E ~ Exp(1) drawn from ``generator``, which is what
    ``torch.multinomial(p, 1)`` computes (the same draws from the same
    generator state) without its host-side checks of ``p``, so the draw
    runs inside a captured CUDA graph."""
    if params.greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("stochastic sampling needs a torch.Generator")
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    race = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / race, dim=-1).to(torch.int32)
