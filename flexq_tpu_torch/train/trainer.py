"""Minimal from-scratch causal-LM trainer for the accuracy-gate model (port
of flexq_tpu/train/trainer.py).

Trains the dense LLaMA graph the eval and serve paths consume
(``models.llama.forward``) under torch autograd, so a trained checkpoint
drops straight into fake-quant ppl eval, ``quantize_params`` and the
serving engine. f32 parameters; no kernel of the port runs here (the
reference's training path reaches no Pallas kernel either).

The optimizer is optax's ``chain(clip_by_global_norm, adamw(mask=ndim >= 2))``
with ``warmup_cosine_decay_schedule``, written out as plain tensor
operations in optax's order (``torch.optim.AdamW`` and ``clip_grad_norm_``
count steps and round otherwise):
- the gradients are clipped as ``(g / norm) * max_norm`` only when
  ``norm >= max_norm``;
- Adam's moments are bias-corrected with the incremented count, and the
  update is ``m_hat / (sqrt(v_hat) + eps)`` (eps 1e-8, eps_root 0);
- weight decay ``wd * p`` is added to the update of the leaves with
  ``ndim >= 2`` (the embedding, the head and every ``w``; never the norms);
- the schedule is read at the count before the increment, so the first
  step runs at lr(0) = 0 and leaves the parameters unchanged.
The optimizer state is ``{"count": int, "mu": tree, "nu": tree}``, optax's
``(count, mu, nu)``. Checkpoints are the reference's ``.npz`` + ``.json``
files, leaf names included: either package loads the other's.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from flexq_tpu_torch.config import ModelConfig
from flexq_tpu_torch.kernels.common import resolve_device
from flexq_tpu_torch.models.llama import forward


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 64
    seq_len: int = 512
    lr: float = 6e-4
    warmup_steps: int = 500
    total_steps: int = 30000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    clip_norm: float = 1.0
    seed: int = 0


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """GPT-2-style init: N(0, 0.02) with 1/sqrt(2*n_layers) residual-out
    scaling on o_proj/down_proj. The reference's numpy draws in its order
    (every layer, then the embedding, then the head), so the f32 tensors
    are bit-equal to its arrays."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    std = 0.02
    res_std = std / np.sqrt(2 * cfg.num_layers)

    def f32(a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    def lin(k: int, n: int, s: float) -> Dict[str, Any]:
        return {"w": f32(rng.normal(0, s, (k, n)))}

    h, inter = cfg.hidden_size, cfg.intermediate_size
    kvd = cfg.num_kv_heads * cfg.head_dim
    layers = []
    for _ in range(cfg.num_layers):
        layers.append(
            {
                "input_norm": torch.ones((h,), dtype=torch.float32, device=dev),
                "post_norm": torch.ones((h,), dtype=torch.float32, device=dev),
                "q_proj": lin(h, cfg.num_heads * cfg.head_dim, std),
                "k_proj": lin(h, kvd, std),
                "v_proj": lin(h, kvd, std),
                "o_proj": lin(cfg.num_heads * cfg.head_dim, h, res_std),
                "gate_proj": lin(h, inter, std),
                "up_proj": lin(h, inter, std),
                "down_proj": lin(inter, h, res_std),
            }
        )
    return {
        "embed": f32(rng.normal(0, std, (cfg.vocab_size, h))),
        "layers": layers,
        "final_norm": torch.ones((h,), dtype=torch.float32, device=dev),
        "lm_head": f32(rng.normal(0, std, (h, cfg.vocab_size))),
    }


def make_lr_schedule(tc: TrainConfig) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, total_steps,
    0.05 * lr): linear from 0 to the peak over ``warmup = min(warmup_steps,
    max(1, total_steps // 10))`` steps, then a cosine to 0.05 * lr at
    ``total_steps``. Computed in f32 in optax's order (the cosine correctly
    rounded to f32), so each value is optax's to within an f32 ulp."""
    warmup = min(tc.warmup_steps, max(1, tc.total_steps // 10))
    decay = tc.total_steps - warmup
    if decay <= 0:
        raise ValueError(f"the cosine decay needs total_steps > warmup ({tc.total_steps} <= {warmup})")
    f32 = np.float32
    peak = f32(tc.lr)
    alpha = 0.0 if tc.lr == 0.0 else tc.lr * 0.05 / tc.lr

    def schedule(count: int) -> float:
        if count < warmup:
            frac = f32(1) - f32(min(max(count, 0), warmup)) / f32(warmup)
            return float(f32(0.0 - tc.lr) * frac + peak)
        t = min(f32(count - warmup), f32(decay))
        cos = f32(math.cos(float(f32(np.pi) * t / f32(decay))))
        cosine_decay = f32(0.5) * (f32(1) + cos)
        return float(peak * (f32(1 - alpha) * cosine_decay + f32(alpha)))

    return schedule


# ------------------------------------------------------------------ trees


def tree_leaves(tree) -> List[torch.Tensor]:
    """A tree's tensors in JAX's flattening order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the tensors of ``tree`` and the trees of its shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


class Optimizer:
    """optax.chain(clip_by_global_norm(clip_norm), adamw(schedule, b1, b2,
    weight_decay, mask=ndim >= 2)) written out (see the module docstring);
    ``init`` / ``update`` as optax's, ``update`` returning the parameters'
    updates."""

    def __init__(self, tc: TrainConfig):
        self.tc = tc
        self.schedule = make_lr_schedule(tc)

    def init(self, params) -> Dict[str, Any]:
        zeros = lambda p: torch.zeros_like(p)
        return {"count": 0, "mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    def update(self, grads, state, params):
        tc = self.tc
        g_norm = torch.stack([(g * g).sum() for g in tree_leaves(grads)]).sum().sqrt()
        keep = g_norm < tc.clip_norm  # no host read: the clip is a select on the card

        def clip(g):
            return torch.where(keep, g, (g / g_norm) * tc.clip_norm)

        grads = tree_map(clip, grads)
        mu = tree_map(lambda g, m: (1 - tc.b1) * g + tc.b1 * m, grads, state["mu"])
        nu = tree_map(lambda g, v: (1 - tc.b2) * (g * g) + tc.b2 * v, grads, state["nu"])
        count = state["count"] + 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(tc.b1) ** count)
        bc2 = float(f32(1) - f32(tc.b2) ** count)
        # divisors on the card divide truly (a host scalar would be a multiply by its reciprocal)
        bc1, bc2 = (torch.tensor(b, dtype=g_norm.dtype, device=g_norm.device) for b in (bc1, bc2))
        step = -self.schedule(state["count"])  # the count before the increment: lr(0) = 0 at step 1

        def upd(m, v, p):
            u = (m / bc1) / ((v / bc2).sqrt() + 1e-8)
            if p.ndim >= 2:
                u = u + tc.weight_decay * p
            return step * u

        return tree_map(upd, mu, nu, params), {"count": count, "mu": mu, "nu": nu}


def make_optimizer(tc: TrainConfig, params=None) -> Optimizer:
    """The reference's optimizer (``params`` is accepted for its signature:
    the decay mask is each leaf's ndim)."""
    return Optimizer(tc)


def loss_fn(params, cfg: ModelConfig, ids) -> torch.Tensor:
    """Mean next-token cross-entropy of ``logits[:, :-1]`` in f32 against
    ``ids[:, 1:]``."""
    logits = forward(params, cfg, ids)
    tgt = torch.as_tensor(ids, device=logits.device)[:, 1:].to(torch.int64)
    lg = logits[:, :-1].to(torch.float32)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]), tgt.reshape(-1))


def train_step(params, opt_state, ids, cfg: ModelConfig, opt: Optimizer):
    """One step: loss and gradients under autograd, then the optimizer.
    Returns (new params, new optimizer state, loss); the inputs are left as
    they were."""
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        flat = tree_leaves(live)
        loss = loss_fn(live, cfg, ids)
        grad_of = dict(zip(map(id, flat), torch.autograd.grad(loss, flat)))
    grads = tree_map(lambda p: grad_of[id(p)], live)
    with torch.no_grad():
        updates, opt_state = opt.update(grads, opt_state, params)
        params = tree_map(lambda p, u: p + u, params, updates)
    return params, opt_state, loss.detach()


# ---------------------------------------------------------------- checkpoint


def _flatten(params, prefix="") -> Dict[str, np.ndarray]:
    flat = {}
    if isinstance(params, dict):
        for k, v in params.items():
            flat.update(_flatten(v, f"{prefix}{k}."))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            flat.update(_flatten(v, f"{prefix}{i}."))
    else:
        flat[prefix[:-1]] = params.detach().cpu().numpy()
    return flat


def save_checkpoint(path: str, params, cfg: ModelConfig, step: int, extra=None):
    flat = _flatten(params)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)
    meta = {"config": dataclasses.asdict(cfg), "step": step, **(extra or {})}
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=1)


def load_checkpoint(path: str, device="cuda") -> Tuple[Dict[str, Any], ModelConfig, dict]:
    dev = resolve_device(device)
    with open(path + ".json") as f:
        meta = json.load(f)
    cfg = ModelConfig(**meta.pop("config"))
    z = np.load(path)
    layers: list = [dict() for _ in range(cfg.num_layers)]
    params: Dict[str, Any] = {"layers": layers}
    for key in z.files:
        parts = key.split(".")
        arr = torch.from_numpy(z[key]).to(dev)
        if parts[0] == "layers":
            li = int(parts[1])
            if len(parts) == 3:  # norms
                layers[li][parts[2]] = arr
            else:  # layers.i.name.w
                layers[li].setdefault(parts[2], {})[parts[3]] = arr
        else:
            params[parts[0]] = arr
    return params, cfg, meta


def batch_iterator(tokens: np.ndarray, tc: TrainConfig, seed: int = 0):
    """Random contiguous windows from a flat token stream, forever."""
    rng = np.random.default_rng(seed)
    n = tokens.size - tc.seq_len - 1
    while True:
        starts = rng.integers(0, n, tc.batch_size)
        yield np.stack([tokens[s : s + tc.seq_len] for s in starts]).astype(np.int32)


def windows_from_stream(tokens: np.ndarray, seq_len: int) -> np.ndarray:
    """Non-overlapping eval windows [n, seq_len] (contiguous, no stride
    overlap)."""
    n = tokens.size // seq_len
    return tokens[: n * seq_len].reshape(n, seq_len).astype(np.int32)
