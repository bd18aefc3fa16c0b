"""HuggingFace checkpoint -> the port's dense param tree (port of
flexq_tpu/models/hf_loader.py).

Weights are transposed to [in, out] (the forward is x @ w), as in the
reference. Two entry points:
  * ``from_hf_llama`` / ``from_hf_opt``: an in-memory ``transformers`` model
    (tests, small models); ``transformers`` itself is never imported here;
  * ``load_checkpoint``: config.json and the safetensors shards of a
    LLaMA-family or OPT directory, read by the port's own safetensors
    reader, without torch modules (large models; the quantize-and-evaluate
    CLI, ``flexq_tpu_torch/main.py``).
The trees go to ``quantize_params``. Every entry point puts its tensors on
the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import torch

from flexq_tpu_torch.config import ModelConfig
from flexq_tpu_torch.export.safetensors_io import load_file
from flexq_tpu_torch.kernels.common import resolve_device

# the LLaMA family's linears: the serve tree's name -> the HF module under
# model.layers.{i}
HF_LLAMA_LINEARS = {
    "q_proj": "self_attn.q_proj",
    "k_proj": "self_attn.k_proj",
    "v_proj": "self_attn.v_proj",
    "o_proj": "self_attn.o_proj",
    "gate_proj": "mlp.gate_proj",
    "up_proj": "mlp.up_proj",
    "down_proj": "mlp.down_proj",
}
HF_LLAMA_NORMS = {"input_norm": "input_layernorm", "post_norm": "post_attention_layernorm"}


def config_from_hf(hf_cfg) -> ModelConfig:
    """ModelConfig from a transformers config object or a config.json dict
    (llama, mistral, qwen2, gemma, opt), as the reference builds it. A
    Gemma config whose ``hidden_activation`` and ``hidden_act`` disagree is
    refused: the reference reads the first, transformers the second."""
    if isinstance(hf_cfg, dict):
        def get(k, d=None):
            return hf_cfg.get(k, d)
    else:
        def get(k, d=None):
            return getattr(hf_cfg, k, d)
    model_type = get("model_type", "llama")
    if model_type == "gemma":
        # Gemma-1: GeGLU MLP, (1 + w) RMSNorm folded into the stored gamma
        # (norm_offset), embeddings scaled by sqrt(hidden), head_dim 256,
        # tied vocab
        named = {k: get(k) for k in ("hidden_activation", "hidden_act") if get(k) is not None}
        if len(set(named.values())) > 1:
            raise ValueError(f"gemma config names two activations {named}; transformers runs hidden_act, "
                             "the reference read hidden_activation: set them equal")
        act = next(iter(named.values()), "gelu_pytorch_tanh")
        if act != "gelu_pytorch_tanh":
            # bare "gelu" is exact erf-GELU in transformers, which no kernel
            # implements; Gemma's own activation is the tanh approximation
            raise ValueError(f"unsupported gemma activation {act!r}; set it to 'gelu_pytorch_tanh' "
                             "(the official Gemma semantics)")
        return ModelConfig.llama(
            vocab_size=get("vocab_size"),
            hidden_size=get("hidden_size"),
            intermediate_size=get("intermediate_size"),
            num_layers=get("num_hidden_layers"),
            num_heads=get("num_attention_heads"),
            num_kv_heads=get("num_key_value_heads") or get("num_attention_heads"),
            max_seq_len=get("max_position_embeddings", 8192),
            rope_theta=get("rope_theta", 10000.0),
            norm_eps=get("rms_norm_eps", 1e-6),
            tie_word_embeddings=bool(get("tie_word_embeddings", True)),
            head_dim=get("head_dim") or 256,
            act="gelu",
            norm_offset=1.0,
            embed_scale=float(get("hidden_size")) ** 0.5,
        )
    if model_type in ("llama", "mistral", "qwen2"):
        # one graph: Mistral adds the sliding window (and may override
        # head_dim), Qwen2 biased q/k/v
        rs = get("rope_scaling")
        scaling = None
        if rs:
            rtype = rs.get("rope_type", rs.get("type"))
            if rtype == "llama3":
                scaling = (
                    float(rs["factor"]),
                    float(rs["low_freq_factor"]),
                    float(rs["high_freq_factor"]),
                    int(rs["original_max_position_embeddings"]),
                )
            elif rtype not in (None, "default"):
                raise ValueError(f"unsupported rope_scaling type {rtype!r} (only 'llama3')")
        window = None
        if model_type == "mistral":
            window = get("sliding_window")
        elif model_type == "qwen2" and get("use_sliding_window", False):
            # the window is global here: only the all-layers case is served
            mwl = get("max_window_layers", 0) or 0
            if mwl > 0:
                raise ValueError(f"qwen2 max_window_layers={mwl} (hybrid full/windowed layers) is not supported; "
                                 "only max_window_layers=0 (all layers windowed) or use_sliding_window=false")
            window = get("sliding_window")
        return ModelConfig.llama(
            vocab_size=get("vocab_size"),
            hidden_size=get("hidden_size"),
            intermediate_size=get("intermediate_size"),
            num_layers=get("num_hidden_layers"),
            num_heads=get("num_attention_heads"),
            num_kv_heads=get("num_key_value_heads") or get("num_attention_heads"),
            max_seq_len=get("max_position_embeddings", 2048),
            rope_theta=get("rope_theta", 10000.0),
            norm_eps=get("rms_norm_eps", 1e-5),
            tie_word_embeddings=bool(get("tie_word_embeddings", False)),
            head_dim=get("head_dim"),
            qkv_bias=model_type == "qwen2",
            sliding_window=window,
            rope_scaling=scaling,
        )
    if model_type == "opt":
        return ModelConfig.opt(
            vocab_size=get("vocab_size"),
            hidden_size=get("hidden_size"),
            intermediate_size=get("ffn_dim"),
            num_layers=get("num_hidden_layers"),
            num_heads=get("num_attention_heads"),
            max_seq_len=get("max_position_embeddings", 2048),
            do_layer_norm_before=bool(get("do_layer_norm_before", True)),
            tie_word_embeddings=bool(get("tie_word_embeddings", True)),
        )
    raise ValueError(f"unsupported model_type {model_type}")


def _t(x: torch.Tensor, dtype, dev: torch.device) -> torch.Tensor:
    return x.detach().to(dev).float().to(dtype).contiguous()


def from_hf_llama(model, dtype=torch.float32, device="cuda") -> Dict[str, Any]:
    """transformers {Llama,Mistral,Qwen2,Gemma}ForCausalLM -> dense tree."""
    dev = resolve_device(device)
    sd = model.state_dict()
    # GemmaRMSNorm computes x * (1 + w): the +1 is folded into the gamma
    noff = 1.0 if getattr(model.config, "model_type", "llama") == "gemma" else 0.0

    def norm(key):
        g = _t(sd[key], dtype, dev)
        return g + noff if noff else g

    layers = []
    for i in range(model.config.num_hidden_layers):
        p = f"model.layers.{i}."

        def lin(name):
            d = {"w": _t(sd[p + name + ".weight"].T, dtype, dev)}
            if p + name + ".bias" in sd:  # Qwen2 q/k/v biases
                d["b"] = _t(sd[p + name + ".bias"], dtype, dev)
            return d

        layers.append({**{k: norm(p + hf + ".weight") for k, hf in HF_LLAMA_NORMS.items()},
                       **{k: lin(hf) for k, hf in HF_LLAMA_LINEARS.items()}})
    params = {"embed": _t(sd["model.embed_tokens.weight"], dtype, dev), "final_norm": norm("model.norm.weight"),
              "layers": layers}
    if "lm_head.weight" in sd and not model.config.tie_word_embeddings:
        params["lm_head"] = _t(sd["lm_head.weight"].T, dtype, dev)
    return params


def from_hf_opt(model, dtype=torch.float32, device="cuda") -> Dict[str, Any]:
    """transformers OPTForCausalLM -> dense tree."""
    dev = resolve_device(device)
    sd = model.state_dict()
    layers = []
    for i in range(model.config.num_hidden_layers):
        p = f"model.decoder.layers.{i}."

        def lin(name):
            return {"w": _t(sd[p + name + ".weight"].T, dtype, dev), "b": _t(sd[p + name + ".bias"], dtype, dev)}

        def ln(name):
            return {"g": _t(sd[p + name + ".weight"], dtype, dev), "b": _t(sd[p + name + ".bias"], dtype, dev)}

        layers.append({
            "input_norm": ln("self_attn_layer_norm"),
            "post_norm": ln("final_layer_norm"),
            "q_proj": lin("self_attn.q_proj"),
            "k_proj": lin("self_attn.k_proj"),
            "v_proj": lin("self_attn.v_proj"),
            "o_proj": lin("self_attn.out_proj"),
            "fc1": lin("fc1"),
            "fc2": lin("fc2"),
        })
    params = {
        "embed": _t(sd["model.decoder.embed_tokens.weight"], dtype, dev),
        "pos_embed": _t(sd["model.decoder.embed_positions.weight"], dtype, dev),
        "layers": layers,
    }
    if "model.decoder.final_layer_norm.weight" in sd:
        params["final_norm"] = {"g": _t(sd["model.decoder.final_layer_norm.weight"], dtype, dev),
                                "b": _t(sd["model.decoder.final_layer_norm.bias"], dtype, dev)}
    return params


def read_shards(model_dir: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the directory's *.safetensors shards, on the host."""
    shards = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))
    if not shards:
        raise FileNotFoundError(f"no safetensors shards in {model_dir}")
    tensors: Dict[str, torch.Tensor] = {}
    for shard in shards:
        tensors.update(load_file(os.path.join(model_dir, shard)))
    return tensors


def load_checkpoint(model_dir: str, dtype=torch.bfloat16, device="cuda") -> Tuple[ModelConfig, Dict[str, Any]]:
    """config.json + *.safetensors shards of a LLaMA-family or OPT
    directory -> (cfg, dense tree in ``dtype`` on ``device``). OPT's keys
    are read under ``model.decoder.`` (or ``decoder.``), its head tied."""
    dev = resolve_device(device)
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = config_from_hf(json.load(f))
    tensors = read_shards(model_dir)

    def t(key, transpose=False):
        out = tensors[key].to(dev).to(dtype)
        return out.T.contiguous() if transpose else out

    if cfg.arch == "opt":
        return cfg, _opt_tree(cfg, tensors, t)

    def norm(key):
        g = t(key)
        return g + cfg.norm_offset if cfg.norm_offset else g

    layers = []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."

        def lin(name):
            d = {"w": t(p + name + ".weight", True)}
            if p + name + ".bias" in tensors:  # Qwen2 q/k/v biases
                d["b"] = t(p + name + ".bias")
            return d

        layers.append({**{k: norm(p + hf + ".weight") for k, hf in HF_LLAMA_NORMS.items()},
                       **{k: lin(hf) for k, hf in HF_LLAMA_LINEARS.items()}})
    params = {"embed": t("model.embed_tokens.weight"), "final_norm": norm("model.norm.weight"), "layers": layers}
    if "lm_head.weight" in tensors and not cfg.tie_word_embeddings:
        params["lm_head"] = t("lm_head.weight", True)
    return cfg, params


def _opt_tree(cfg: ModelConfig, tensors: Dict[str, torch.Tensor], t) -> Dict[str, Any]:
    """OPT's dense tree from its shards' tensors, as from_hf_opt builds it."""
    root = "model.decoder." if "model.decoder.embed_tokens.weight" in tensors else "decoder."
    layers = []
    for i in range(cfg.num_layers):
        p = f"{root}layers.{i}."

        def lin(name):
            return {"w": t(p + name + ".weight", True), "b": t(p + name + ".bias")}

        def ln(name):
            return {"g": t(p + name + ".weight"), "b": t(p + name + ".bias")}

        layers.append({"input_norm": ln("self_attn_layer_norm"), "post_norm": ln("final_layer_norm"),
                       "q_proj": lin("self_attn.q_proj"), "k_proj": lin("self_attn.k_proj"),
                       "v_proj": lin("self_attn.v_proj"), "o_proj": lin("self_attn.out_proj"),
                       "fc1": lin("fc1"), "fc2": lin("fc2")})
    params = {"embed": t(root + "embed_tokens.weight"), "pos_embed": t(root + "embed_positions.weight"),
              "layers": layers}
    if root + "final_layer_norm.weight" in tensors:
        params["final_norm"] = {"g": t(root + "final_layer_norm.weight"), "b": t(root + "final_layer_norm.bias")}
    return params
