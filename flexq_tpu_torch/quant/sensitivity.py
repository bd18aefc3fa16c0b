"""Layer-wise quantization sensitivity -> per-linear bit policy (port of
flexq_tpu/quant/sensitivity.py).

``analyze_act_sensitivity``: for each linear name, the mean KL divergence
of the logits from an all-``high_bits`` run when that linear's activations
drop to ``low_bits`` (every other linear stays high); the most sensitive
``keep_fraction`` keep ``high_bits`` (the paper's result, shipped as the
flex presets: down_proj for LLaMA, q/k/v for OPT).
``analyze_weight_sensitivity``: the same over weight bits (W4 against W6),
which gives a mixed W4 / W6 policy that the packed path serves.

Works on any dense ``forward(params, cfg, ids, policy=...)`` (models/llama.py,
models/opt.py) on the params' device, under ``torch.no_grad``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from flexq_tpu_torch.config import LLAMA_LINEARS, OPT_LINEARS, ModelConfig, QuantPolicy


def _kl_div(p_logits: torch.Tensor, q_logits: torch.Tensor) -> float:
    """Mean KL(p || q) over all positions (f32)."""
    p = torch.log_softmax(p_logits.to(torch.float32), dim=-1)
    q = torch.log_softmax(q_logits.to(torch.float32), dim=-1)
    return float(torch.mean(torch.sum(torch.exp(p) * (p - q), dim=-1)))


@dataclasses.dataclass
class SensitivityReport:
    per_linear_kl: Dict[str, float]
    baseline_kl: float  # all linears at low_bits
    policy: QuantPolicy

    def summary(self) -> str:
        lines = [f"baseline (all-low) KL: {self.baseline_kl:.5f}"]
        for name, kl in sorted(self.per_linear_kl.items(), key=lambda kv: -kv[1]):
            wb = self.policy.weight_bits.get(name)
            ab = self.policy.act_bits.get(name)
            lines.append(f"  {name:<12} KL {kl:.5f} -> W{wb} A{ab}")
        return "\n".join(lines)


def _windows(calib_ids: np.ndarray, batch: int) -> List[torch.Tensor]:
    return [torch.as_tensor(np.asarray(calib_ids[i : i + batch]), dtype=torch.int64)
            for i in range(0, len(calib_ids), batch)]


def analyze_act_sensitivity(
    forward_fn: Callable,  # forward(params, cfg, ids, policy=...) -> logits
    params,
    cfg: ModelConfig,
    calib_ids: np.ndarray,  # [n, L] int calibration windows
    wbits: int = 6,
    low_bits: int = 6,
    high_bits: int = 8,
    keep_fraction: float = 0.15,
    batch: int = 1,
) -> SensitivityReport:
    """Per-linear activation-quant sensitivity and the derived policy: the
    most sensitive ~``keep_fraction`` of the names (at least one) keep
    ``high_bits`` activations."""
    names = LLAMA_LINEARS if cfg.arch == "llama" else OPT_LINEARS
    ref_policy = QuantPolicy(weight_bits={n: wbits for n in names}, act_bits={n: high_bits for n in names})
    windows = _windows(calib_ids, batch)
    with torch.no_grad():
        refs = [forward_fn(params, cfg, w, policy=ref_policy) for w in windows]

        def mean_kl(policy) -> float:
            return sum(_kl_div(ref, forward_fn(params, cfg, w, policy=policy))
                       for w, ref in zip(windows, refs)) / len(windows)

        per_linear: Dict[str, float] = {}
        for name in names:
            probe = QuantPolicy(weight_bits=dict(ref_policy.weight_bits),
                                act_bits={**{n: high_bits for n in names}, name: low_bits})
            per_linear[name] = mean_kl(probe)
        baseline = mean_kl(QuantPolicy(weight_bits=dict(ref_policy.weight_bits),
                                       act_bits={n: low_bits for n in names}))

    n_keep = max(1, int(round(keep_fraction * len(names))))
    ranked = sorted(per_linear, key=per_linear.get, reverse=True)
    keep_high = set(ranked[:n_keep])
    policy = QuantPolicy(
        weight_bits={n: wbits for n in names},
        act_bits={n: (high_bits if n in keep_high else low_bits) for n in names},
    )
    return SensitivityReport(per_linear, baseline, policy)


def analyze_weight_sensitivity(
    forward_fn: Callable,  # forward(params, cfg, ids, policy=...) -> logits
    params,
    cfg: ModelConfig,
    calib_ids: np.ndarray,  # [n, L] int calibration windows
    low_bits: int = 4,
    high_bits: int = 6,
    act_policy: Optional[QuantPolicy] = None,
    kl_budget: Optional[float] = None,
    keep_fraction: float = 0.3,
    batch: int = 1,
) -> SensitivityReport:
    """Per-linear weight-bit sensitivity -> a mixed W4 / W6 policy: the KL
    from an all-``high_bits`` run when one linear's weights drop to
    ``low_bits``; ``high_bits`` stay for every linear over ``kl_budget`` or,
    without a budget, for the most sensitive ``keep_fraction`` of the names.
    Act bits come from ``act_policy`` (default: the architecture's flex
    policy), so the derived policy is serve-ready: the packed path runs
    each linear in its own format."""
    names = LLAMA_LINEARS if cfg.arch == "llama" else OPT_LINEARS
    if act_policy is None:
        act_policy = QuantPolicy.llama_flex() if cfg.arch == "llama" else QuantPolicy.opt_flex()
    if cfg.arch == "llama":
        from flexq_tpu_torch.models.llama import fake_quant_weights
    else:
        from flexq_tpu_torch.models.opt import fake_quant_weights

    ref_policy = QuantPolicy(weight_bits={n: high_bits for n in names}, act_bits=dict(act_policy.act_bits))
    windows = _windows(calib_ids, batch)

    def run(policy) -> List[torch.Tensor]:
        # the weights are fake-quantized per probe (the dense forward
        # quantizes only activations at run time)
        qp = fake_quant_weights(params, policy)
        return [forward_fn(qp, cfg, w, policy=policy) for w in windows]

    def mean_kl(policy, refs) -> float:
        return sum(_kl_div(r, o) for r, o in zip(refs, run(policy))) / len(windows)

    with torch.no_grad():
        refs = run(ref_policy)
        per_linear: Dict[str, float] = {}
        for name in names:
            probe = QuantPolicy(weight_bits={**{n: high_bits for n in names}, name: low_bits},
                                act_bits=dict(ref_policy.act_bits))
            per_linear[name] = mean_kl(probe, refs)
        baseline = mean_kl(QuantPolicy(weight_bits={n: low_bits for n in names},
                                       act_bits=dict(ref_policy.act_bits)), refs)

    if kl_budget is not None:
        keep_high = {n for n, kl in per_linear.items() if kl > kl_budget}
    else:
        n_keep = max(1, int(round(keep_fraction * len(names))))
        ranked = sorted(per_linear, key=per_linear.get, reverse=True)
        keep_high = set(ranked[:n_keep])
    policy = QuantPolicy(
        weight_bits={n: (high_bits if n in keep_high else low_bits) for n in names},
        act_bits=dict(ref_policy.act_bits),
    )
    return SensitivityReport(per_linear, baseline, policy)
