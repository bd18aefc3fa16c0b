"""Model and quantization-policy configuration (port of flexq_tpu/config.py).

Plain dataclasses with no framework dependency; the fields and presets the
serve slice needs are kept identical to the reference so a config built for
one package means the same model in the other.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from flexq_tpu_torch.quant.quantizer import QuantSpec

GROUP_SIZE = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description: the fields of the reference's ModelConfig
    that the LLaMA-family and OPT serve paths read."""

    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    arch: str = "llama"  # "llama" | "opt"
    act: str = "silu"  # llama: silu-glu; gemma: gelu (tanh) glu; opt: relu
    tie_word_embeddings: bool = False
    # OPT specifics
    do_layer_norm_before: bool = True  # OPT-350m is post-LN (False): not served
    attn_bias: bool = False  # OPT linears carry biases
    ffn_bias: bool = False
    # Qwen2: the checkpoint's q/k/v carry biases (informational: the serve
    # layers read the "b" keys of the tree)
    qkv_bias: bool = False
    sliding_window: Optional[int] = None  # Mistral: local attention window
    # LLaMA-3.1 rope scaling: (factor, low_freq_factor, high_freq_factor,
    # original_max_position_embeddings)
    rope_scaling: Optional[Tuple[float, float, float, int]] = None
    # Gemma: loaders store gamma + norm_offset ((1 + w) RMSNorm folded in)
    norm_offset: float = 0.0
    embed_scale: Optional[float] = None  # Gemma: embedding output scale

    def __post_init__(self):
        # meta.json carries rope_scaling as a JSON list
        if isinstance(self.rope_scaling, list):
            object.__setattr__(self, "rope_scaling", tuple(self.rope_scaling))
        if self.sliding_window is not None and self.sliding_window < 1:
            raise ValueError(f"sliding_window must be >= 1, got {self.sliding_window}")

    @property
    def num_kv_groups(self) -> int:
        return self.num_heads // self.num_kv_heads

    @staticmethod
    def llama(
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=11008,
        num_layers=32,
        num_heads=32,
        num_kv_heads=None,
        max_seq_len=2048,
        rope_theta=10000.0,
        norm_eps=1e-5,
        head_dim=None,
        act="silu",
        **kw,
    ) -> "ModelConfig":
        return ModelConfig(
            vocab_size=vocab_size,
            hidden_size=hidden_size,
            intermediate_size=intermediate_size,
            num_layers=num_layers,
            num_heads=num_heads,
            num_kv_heads=num_kv_heads or num_heads,
            head_dim=head_dim or hidden_size // num_heads,
            max_seq_len=max_seq_len,
            rope_theta=rope_theta,
            norm_eps=norm_eps,
            arch="llama",
            act=act,
            **kw,
        )

    @staticmethod
    def opt(
        vocab_size=50272,
        hidden_size=768,
        intermediate_size=3072,
        num_layers=12,
        num_heads=12,
        max_seq_len=2048,
        norm_eps=1e-5,
        **kw,
    ) -> "ModelConfig":
        return ModelConfig(
            vocab_size=vocab_size,
            hidden_size=hidden_size,
            intermediate_size=intermediate_size,
            num_layers=num_layers,
            num_heads=num_heads,
            num_kv_heads=num_heads,
            head_dim=hidden_size // num_heads,
            max_seq_len=max_seq_len,
            norm_eps=norm_eps,
            arch="opt",
            act="relu",
            attn_bias=True,
            ffn_bias=True,
            **kw,
        )


# linear-layer names per architecture (policies and loaders)
LLAMA_LINEARS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
OPT_LINEARS = ("q_proj", "k_proj", "v_proj", "o_proj", "fc1", "fc2")


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Per-linear (weight_bits, act_bits) policy + group sizes. The dense
    fake-quant models take any group size (None: per channel / per token)
    and asymmetric ranges, as the reference's do; the packed formats hold
    symmetric codes in 128-groups only, so every serving entry point refuses
    any other policy (``require_servable``)."""

    weight_bits: Dict[str, int]
    act_bits: Dict[str, int]
    w_group_size: Optional[int] = GROUP_SIZE
    a_group_size: Optional[int] = GROUP_SIZE
    symmetric: bool = True

    def weight_spec(self, name: str) -> QuantSpec:
        return QuantSpec(
            bits=self.weight_bits.get(name, 16),
            symmetric=self.symmetric,
            group_size=self.w_group_size,
        )

    def act_spec(self, name: str) -> QuantSpec:
        return QuantSpec(
            bits=self.act_bits.get(name, 16),
            symmetric=self.symmetric,
            group_size=self.a_group_size,
        )

    @staticmethod
    def llama_flex(wbits: int = 6, abits: int = 6, down_abits: int = 8) -> "QuantPolicy":
        """All weights 6-bit; activations 6-bit except down_proj's 8-bit."""
        return QuantPolicy(
            weight_bits={n: wbits for n in LLAMA_LINEARS},
            act_bits={
                **{n: abits for n in LLAMA_LINEARS},
                "down_proj": down_abits,
            },
        )

    @staticmethod
    def opt_flex(wbits: int = 6, abits: int = 6, qkv_abits: int = 8) -> "QuantPolicy":
        """All weights 6-bit; activations 6-bit except q/k/v's 8-bit."""
        return QuantPolicy(
            weight_bits={n: wbits for n in OPT_LINEARS},
            act_bits={
                **{n: abits for n in OPT_LINEARS},
                "q_proj": qkv_abits,
                "k_proj": qkv_abits,
                "v_proj": qkv_abits,
            },
        )

    @staticmethod
    def uniform(arch: str = "llama", wbits: int = 6, abits: int = 6) -> "QuantPolicy":
        """Every linear at ``wbits`` weights and ``abits`` activations
        (W4A8, W8A8: the reference's SmoothQuant baseline)."""
        return QuantPolicy(
            weight_bits={n: wbits for n in _linears(arch)},
            act_bits={n: abits for n in _linears(arch)},
        )

    def with_head(self, wbits: int = 6, abits: int = 8) -> "QuantPolicy":
        """This policy with a quantized lm_head: packed ``wbits`` weights;
        ``abits`` < 16 quantizes the final-norm output (the W*Ax head),
        16 keeps it (the W*A16 head)."""
        return dataclasses.replace(
            self,
            weight_bits={**self.weight_bits, "lm_head": wbits},
            act_bits={**self.act_bits, "lm_head": abits},
        )

    @staticmethod
    def weight_only(arch: str = "llama", wbits: int = 4) -> "QuantPolicy":
        """W*A16 weight-only policy: every linear's weights at ``wbits``,
        activations unquantized (served by the W*A16 layer at decode too)."""
        return QuantPolicy(
            weight_bits={n: wbits for n in _linears(arch)},
            act_bits={n: 16 for n in _linears(arch)},
        )

    @staticmethod
    def fp16(arch: str = "llama") -> "QuantPolicy":
        """No quantization: every linear keeps its 16-bit weight."""
        return QuantPolicy(
            weight_bits={n: 16 for n in _linears(arch)},
            act_bits={n: 16 for n in _linears(arch)},
        )

    @property
    def no_act_quant(self) -> bool:
        """True when no linear quantizes its activations (W*A16 or fp16)."""
        return all(b >= 16 for b in self.act_bits.values())

    @property
    def is_weight_only(self) -> bool:
        """True for W*A16 policies: quantized weights, full-precision
        activations."""
        return self.no_act_quant and any(b < 16 for b in self.weight_bits.values())


def _linears(arch: str):
    return LLAMA_LINEARS if arch == "llama" else OPT_LINEARS


def require_servable(policy: QuantPolicy) -> None:
    """Refuse a policy the packed path cannot serve: the producers and the
    GEMMs take symmetric codes in groups of 128 only. Called where serving
    starts (quantize_params, forward_serve, load_packed, Engine,
    BatchScheduler, ``main.py --export``), before any weight is packed."""
    for field in ("w_group_size", "a_group_size"):
        if getattr(policy, field) != GROUP_SIZE:
            raise ValueError(f"{field}={getattr(policy, field)}: the port's producers and GEMMs take groups of "
                             f"{GROUP_SIZE} only (the dense fake-quant models take any group size)")
    if not policy.symmetric:
        raise ValueError("symmetric=False: the packed formats hold symmetric codes only (the dense fake-quant "
                         "models take asymmetric ranges)")
