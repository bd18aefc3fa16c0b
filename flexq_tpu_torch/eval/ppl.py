"""Perplexity evaluation (port of flexq_tpu/eval/ppl.py).

ppl = exp(sum_i nll_i / (windows * (seqlen - 1))), where nll_i is the summed
causal cross-entropy of window i with shift-by-one labels: the token-level
perplexity over every label position. Plain calls under ``torch.no_grad``:
the forward runs on its params' device, and one float a batch comes back.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def window_nll(logits: torch.Tensor, ids) -> torch.Tensor:
    """Summed next-token NLL over one [B, L] window (f32, on the logits'
    device)."""
    logp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    tgt = torch.as_tensor(ids, device=logits.device)[:, 1:].to(torch.int64)
    return -logp.gather(-1, tgt[..., None]).sum()


def perplexity(
    forward_fn: Callable[..., torch.Tensor],
    windows: np.ndarray,  # [n, seqlen] int
    batch_size: int = 1,
    progress: Optional[Callable[[int, int], None]] = None,
    params=None,
) -> float:
    """``forward_fn``: ids [B, L] (an int64 CPU tensor) -> logits [B, L, V];
    with ``params``, ``forward_fn(params, ids)``. The short tail batch
    (n % batch_size windows) is evaluated too, so every window counts."""
    n, seqlen = windows.shape
    total = 0.0
    tokens = 0
    with torch.no_grad():
        for i in range(0, n, batch_size):
            batch = torch.as_tensor(np.asarray(windows[i : i + batch_size]), dtype=torch.int64)
            logits = forward_fn(batch) if params is None else forward_fn(params, batch)
            total += float(window_nll(logits, batch))
            tokens += batch.shape[0] * (seqlen - 1)
            if progress:
                progress(i + batch.shape[0], n)
    return float(np.exp(total / tokens))
