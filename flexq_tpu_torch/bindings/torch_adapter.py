"""A torch-facing causal LM over the quantized serve path (port of
flexq_tpu/bindings/torch_adapter.py::FlexQCausalLM).

The port is torch-native, so nothing crosses a framework boundary: token
ids in, logits or token ids out, as torch tensors. The reference's
``to_jax`` / ``to_torch`` converters have no counterpart here.

Typical use::

    from flexq_tpu_torch.bindings import FlexQCausalLM

    m = FlexQCausalLM.from_packed("packed/")           # an exporter directory
    logits = m(input_ids)                               # [B, L, V] float32
    out_ids = m.generate(input_ids, max_new_tokens=64)  # prompt + generation

Everything runs on the card unless the constructor is given
``device="cpu"`` (the plain versions of the kernels).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from flexq_tpu_torch.config import ModelConfig, QuantPolicy
from flexq_tpu_torch.kernels.common import resolve_device
from flexq_tpu_torch.models.quantized import forward_serve, quantize_params
from flexq_tpu_torch.serve.engine import Engine
from flexq_tpu_torch.serve.sampling import SamplingParams


class FlexQCausalLM:
    """Quantized causal LM with a torch-tensor API. Build it with
    ``from_hf`` (an in-memory transformers model), ``from_pretrained`` (an
    HF safetensors directory) or ``from_packed`` (an exporter directory).
    ``forward`` / ``__call__`` return teacher-forced logits, ``generate``
    prompt + generated ids."""

    def __init__(
        self,
        qparams: Dict[str, Any],
        cfg: ModelConfig,
        policy: QuantPolicy,
        max_seq_len: int = 2048,
        kv_dtype=torch.bfloat16,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.policy = policy
        self.engine = Engine(qparams, cfg, policy, max_seq_len=max_seq_len, kv_dtype=kv_dtype, device=self.device)

    # ---- constructors ------------------------------------------------
    @classmethod
    def from_hf(cls, model, policy: QuantPolicy, max_seq_len: int = 2048, kv_dtype=torch.bfloat16,
                dtype=torch.bfloat16, fuse: bool = False, device="cuda") -> "FlexQCausalLM":
        """Quantize and pack a transformers LLaMA-family or OPT model."""
        from flexq_tpu_torch.models.hf_loader import config_from_hf, from_hf_llama, from_hf_opt

        cfg = config_from_hf(model.config)
        loader = from_hf_llama if cfg.arch == "llama" else from_hf_opt
        params = loader(model, dtype=torch.float32, device=device)
        qparams = quantize_params(params, cfg, policy, dtype=dtype, fuse=fuse, device=device)
        return cls(qparams, cfg, policy, max_seq_len=max_seq_len, kv_dtype=kv_dtype, device=device)

    @classmethod
    def from_pretrained(cls, model_dir: str, policy: QuantPolicy, max_seq_len: int = 2048, kv_dtype=torch.bfloat16,
                        dtype=torch.bfloat16, device="cuda") -> "FlexQCausalLM":
        """Quantize and pack an HF checkpoint directory (safetensors)."""
        from flexq_tpu_torch.models.hf_loader import load_checkpoint

        cfg, params = load_checkpoint(model_dir, dtype=torch.float32, device=device)
        qparams = quantize_params(params, cfg, policy, dtype=dtype, device=device)
        return cls(qparams, cfg, policy, max_seq_len=max_seq_len, kv_dtype=kv_dtype, device=device)

    @classmethod
    def from_packed(cls, packed_dir: str, max_seq_len: int = 2048, kv_dtype=torch.bfloat16,
                    device="cuda") -> "FlexQCausalLM":
        """Load an exporter directory (``export/exporter.py``)."""
        from flexq_tpu_torch.export.exporter import load_packed

        cfg, policy, qparams = load_packed(packed_dir, device=device)
        return cls(qparams, cfg, policy, max_seq_len=max_seq_len, kv_dtype=kv_dtype, device=device)

    # ---- torch API ---------------------------------------------------
    def forward(self, input_ids) -> torch.Tensor:
        """Teacher-forced logits of the cache-less serve path (the W*A16
        layer, as the reference's adapter runs it): input_ids [B, L] ->
        float32 [B, L, V] on the model's device."""
        ids = torch.as_tensor(input_ids).to(device=self.device, dtype=torch.int64)
        logits, _ = forward_serve(self.engine.params, self.cfg, self.policy, ids, prefill_bf16=True,
                                  device=self.device)
        return logits.to(torch.float32)

    __call__ = forward

    def generate(
        self,
        input_ids,
        max_new_tokens: int = 32,
        do_sample: bool = False,
        temperature: float = 1.0,
        top_k: int = 0,
        top_p: float = 1.0,
        eos_token_id: Optional[int] = 2,
        stop_ids: Sequence[int] = (),
        seed: int = 0,
        mode: str = "fused",
    ) -> torch.Tensor:
        """HF-generate-shaped API over ``Engine.generate`` (equal-length
        prompts): input_ids [B, L] -> int64 [B, L + n] on input_ids' device,
        the prompt and then the generation. A row that stopped early is
        padded with its stop token. ``do_sample=True`` samples with
        ``temperature`` / ``top_k`` / ``top_p``, seeded by ``seed``."""
        if do_sample:
            sampling = SamplingParams(temperature=temperature, top_k=top_k, top_p=top_p, greedy=False)
        else:
            sampling = SamplingParams()
        ids = torch.as_tensor(input_ids)
        out = self.engine.generate(
            np.asarray(ids.detach().cpu().numpy(), np.int64),
            max_new_tokens=max_new_tokens,
            sampling=sampling,
            eos_id=-1 if eos_token_id is None else int(eos_token_id),
            stop_ids=tuple(stop_ids),
            seed=seed,
            mode=mode,
        )
        n = max(len(r) for r in out)
        gen = torch.tensor([r + r[-1:] * (n - len(r)) for r in out], dtype=torch.int64)
        return torch.cat([ids.detach().to(torch.int64), gen.to(ids.device)], dim=1)
