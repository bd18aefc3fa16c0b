"""Offline exporter (HF checkpoint -> packed format v2) and its loaders
(port of flexq_tpu/export/exporter.py).

CLI:
    python -m flexq_tpu_torch.export.exporter --model-dir <hf_dir> --out <dir> \\
        [--policy llama_flex|opt_flex|uniform|weight_only] [--wbits 6] [--abits 6] \\
        [--head-bits 0] [--tp 1] [--device cuda|cpu]

Layout, the reference's (a directory either package writes, both load):
    out/meta.json               format version, tensor_parallel, the
                                ModelConfig's fields, the policy
    out/embed.safetensors       embed, final_norm, lm_head (bf16, or the
                                packed lm_head.hi/.lo/.scale with --head-bits)
    out/layer_{i}.safetensors   per linear {name}.hi/.lo/.scale (W6),
                                .q4/.scale (W4), .q8/.scale (W8) or .w
                                (16-bit), and .b; the norms, bf16
With ``--tp N`` each layer file is written as N rank files
``layer_{i}.rank{r}.safetensors`` and the head as ``head.rank{r}.safetensors``
(a bf16 head under the key lm_head.w), each tensor cut by the split rules
of parallel/tp.py (``split_dim``): the reference's per-rank files, byte for
byte. ``load_packed(dir, rank=r)`` reads rank r's files only,
``rank=None`` reassembles the whole tree, and ``load_packed_sharded(dir,
mesh)`` reads this rank's files for a mesh of the export's tp.

Weights are quantized symmetric per 128-group along K by the port's own
quantizer and packers (``models/quantized.py::quantize_linear``, on the card
unless ``device="cpu"``): the codes, the planes and the f32 scales' bits are
those of the reference's NumPy and native paths. The reference's rules are
kept: down_proj's K padded to the padded FFN width, every packed N padded to
a multiple of 1024 (N >= 2048) or 128, biases padded to the plane's N, the
Gemma norm offset folded into the stored gamma, no packed head for a tied
model.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import warnings
from typing import Any, Dict, Optional

import torch

from flexq_tpu_torch.config import ModelConfig, QuantPolicy, require_servable
from flexq_tpu_torch.export.safetensors_io import load_file, save_file
from flexq_tpu_torch.kernels.common import GROUP_SIZE, resolve_device
from flexq_tpu_torch.models.hf_loader import HF_LLAMA_LINEARS, HF_LLAMA_NORMS, config_from_hf, read_shards
from flexq_tpu_torch.models.quantized import _padded_width, quantize_linear
from flexq_tpu_torch.parallel.tp import rank_slice, split_dim
from flexq_tpu_torch.quant.quantizer import QuantSpec

FORMAT_VERSION = 2  # biased nibble+crumb planes (packing/pack6.py)


def _key_dim(key: str) -> Optional[int]:
    """The split dimension of a dotted key ({name}.{part}; a plain key,
    a norm or the embedding, is replicated)."""
    if "." not in key:
        return None
    name, part = key.split(".", 1)
    return split_dim(name, part)


def _rank_slice(key: str, a: torch.Tensor, tp: int, r: int) -> torch.Tensor:
    """One exported tensor cut to rank r."""
    return rank_slice(a, _key_dim(key), tp, r).contiguous()


def _rank_concat(key: str, shards) -> torch.Tensor:
    """The inverse of ``_rank_slice``: the whole tensor from its rank shards."""
    dim = _key_dim(key)
    return shards[0] if dim is None else torch.cat(shards, dim)


def _save_ranks(out: Dict[str, torch.Tensor], out_dir: str, stem: str, tp: int) -> None:
    """``stem``.safetensors, or its tp rank files."""
    if tp == 1:
        save_file(out, os.path.join(out_dir, f"{stem}.safetensors"))
        return
    for r in range(tp):
        save_file({k: _rank_slice(k, v, tp, r) for k, v in out.items()},
                  os.path.join(out_dir, f"{stem}.rank{r}.safetensors"))


def _emit_packed(out: Dict[str, torch.Tensor], name: str, w: torch.Tensor, bits: int) -> None:
    """Quantize and pack one [K, N] f32 matrix into ``out`` under dotted keys
    ({name}.hi/.lo/.scale, .q4/.scale, .q8/.scale; 16 bits: {name}.w, bf16)."""
    if bits >= 16:
        out[f"{name}.w"] = w.to(torch.bfloat16)
        return
    for part, val in quantize_linear(w, QuantSpec(bits, True, GROUP_SIZE)).items():
        out[f"{name}.{part}"] = val


def _make_policy(policy_name: str, arch: str, wbits: int, abits: int) -> QuantPolicy:
    if policy_name == "llama_flex":
        return QuantPolicy.llama_flex(wbits=wbits, abits=abits)
    if policy_name == "opt_flex":
        return QuantPolicy.opt_flex(wbits=wbits, abits=abits)
    if policy_name == "uniform":
        return QuantPolicy.uniform(arch, wbits=wbits, abits=abits)
    if policy_name == "weight_only":
        return QuantPolicy.weight_only(arch, wbits=wbits)
    raise ValueError(policy_name)


def export_checkpoint(
    model_dir: str,
    out_dir: str,
    policy_name: str = "llama_flex",
    wbits: int = 6,
    abits: int = 6,
    head_bits: int = 0,
    tp: int = 1,
    device="cuda",
) -> None:
    """Quantize and pack the HF checkpoint in ``model_dir`` (config.json and
    *.safetensors of a LLaMA-family model) into ``out_dir``; ``tp > 1``
    writes the layers and the head as rank files."""
    if tp < 1:
        raise ValueError(f"tp={tp} must be >= 1")
    dev = resolve_device(device)
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = config_from_hf(json.load(f))
    if cfg.arch != "llama":
        raise NotImplementedError(f"the exporter writes LLaMA-family checkpoints (model.layers.*), not {cfg.arch}")
    policy = _make_policy(policy_name, cfg.arch, wbits, abits)
    if head_bits:
        if cfg.tie_word_embeddings:
            # no lm_head tensor exists; meta.json must not claim a packed head
            warnings.warn("--head-bits ignored: model ties word embeddings, so there is no separate lm_head "
                          "tensor to quantize/export")
        else:
            policy = policy.with_head(head_bits, abits=16 if policy.no_act_quant else 8)

    tensors = read_shards(model_dir)
    os.makedirs(out_dir, exist_ok=True)

    def t(key: str, transpose=False) -> torch.Tensor:
        arr = tensors[key].to(dev).to(torch.float32)
        return arr.T.contiguous() if transpose else arr

    def bf16(x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.bfloat16)

    ffn_pad = _padded_width(cfg.intermediate_size)
    for i in range(cfg.num_layers):
        prefix = f"model.layers.{i}."
        # bf16 storage rounds (1 + w) near 1.0 to ~2^-9 relative
        out = {name: bf16(t(prefix + hf + ".weight") + cfg.norm_offset) for name, hf in HF_LLAMA_NORMS.items()}
        for name, hf in HF_LLAMA_LINEARS.items():
            w = t(prefix + hf + ".weight", transpose=True)  # [K, N]
            bits = policy.weight_bits.get(name, 16)
            if bits < 16:
                if name == "down_proj" and w.shape[0] != ffn_pad:
                    w = torch.nn.functional.pad(w, (0, 0, 0, ffn_pad - w.shape[0]))
                w = torch.nn.functional.pad(w, (0, _padded_width(w.shape[1]) - w.shape[1]))
            _emit_packed(out, name, w, bits)
            if prefix + hf + ".bias" in tensors:  # Qwen2 q/k/v biases
                b = t(prefix + hf + ".bias")
                if bits < 16:  # biases ride padded to the packed plane's N
                    b = torch.nn.functional.pad(b, (0, w.shape[1] - b.shape[0]))
                out[f"{name}.b"] = bf16(b)
        _save_ranks(out, out_dir, f"layer_{i}", tp)
        print(f"layer {i + 1}/{cfg.num_layers} exported", flush=True)

    top = {
        "embed": bf16(t("model.embed_tokens.weight")),
        "final_norm": bf16(t("model.norm.weight") + cfg.norm_offset),
    }
    if "lm_head.weight" in tensors and not cfg.tie_word_embeddings:
        hw = t("lm_head.weight", transpose=True)  # [H, V]
        head_bits = policy.weight_bits.get("lm_head", 16)
        head: Dict[str, torch.Tensor] = {}
        if head_bits < 16:
            hw = torch.nn.functional.pad(hw, (0, _padded_width(hw.shape[1]) - hw.shape[1]))
            _emit_packed(head, "lm_head", hw, head_bits)
        else:
            head["lm_head" if tp == 1 else "lm_head.w"] = bf16(hw)
        if tp == 1:
            top.update(head)
        else:  # the vocab-parallel head's rank files
            _save_ranks(head, out_dir, "head", tp)
    save_file(top, os.path.join(out_dir, "embed.safetensors"))

    meta = {
        "format_version": FORMAT_VERSION,
        "tensor_parallel": tp,
        "config": dataclasses.asdict(cfg),
        "policy": {
            "weight_bits": policy.weight_bits,
            "act_bits": policy.act_bits,
            "w_group_size": policy.w_group_size,
            "a_group_size": policy.a_group_size,
            "symmetric": policy.symmetric,
        },
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)


def read_meta(out_dir: str) -> Dict[str, Any]:
    with open(os.path.join(out_dir, "meta.json")) as f:
        meta = json.load(f)
    if meta["format_version"] != FORMAT_VERSION:
        raise ValueError(f"packed format v{meta['format_version']} != v{FORMAT_VERSION}")
    return meta


def load_packed(out_dir: str, rank: Optional[int] = None, device="cuda"):
    """An exported directory -> (cfg, policy, serve tree on ``device``), the
    tree ``quantize_params`` builds. Of a tensor-parallel export (``--tp
    N``), ``rank=r`` reads only rank r's files (the tree ``shard_params``
    gives rank r) and ``rank=None`` reassembles the whole tree."""
    dev = resolve_device(device)
    meta = read_meta(out_dir)
    tp = meta.get("tensor_parallel", 1)
    if rank is not None and not 0 <= rank < tp:
        raise ValueError(f"rank={rank} of a tp={tp} export")
    cfg = ModelConfig(**meta["config"])
    pol = meta["policy"]
    policy = QuantPolicy(
        weight_bits=pol["weight_bits"],
        act_bits=pol["act_bits"],
        w_group_size=pol["w_group_size"],
        a_group_size=pol["a_group_size"],
        symmetric=pol["symmetric"],
    )
    require_servable(policy)

    def load_flat(stem: str) -> Dict[str, torch.Tensor]:
        """One logical file: whole (tp = 1), rank ``rank``'s, or the rank
        files concatenated (rank None)."""
        if tp == 1:
            path = os.path.join(out_dir, f"{stem}.safetensors")
            return load_file(path, dev) if os.path.exists(path) else {}
        paths = [os.path.join(out_dir, f"{stem}.rank{r}.safetensors") for r in range(tp)]
        if not os.path.exists(paths[0]):
            return {}
        if rank is not None:
            return load_file(paths[rank], dev)
        shards = [load_file(p, dev) for p in paths]
        return {key: _rank_concat(key, [s[key] for s in shards]) for key in shards[0]}

    top = load_file(os.path.join(out_dir, "embed.safetensors"), dev)
    top.update(load_flat("head"))
    params: Dict[str, Any] = {"embed": top["embed"], "final_norm": top["final_norm"], "layers": []}
    if "lm_head" in top:
        params["lm_head"] = top["lm_head"]
    else:  # a packed head under dotted keys (lm_head.hi/.lo/.scale)
        head = {key.split(".", 1)[1]: val for key, val in top.items() if key.startswith("lm_head.")}
        if head:  # a bf16 head of rank files comes back as {"w": ...}
            params["lm_head"] = head["w"] if set(head) == {"w"} else head
    for i in range(cfg.num_layers):
        lp: Dict[str, Any] = {}
        for key, val in load_flat(f"layer_{i}").items():
            if "." in key:
                name, part = key.split(".", 1)
                lp.setdefault(name, {})[part] = val
            else:
                lp[key] = val
        params["layers"].append(lp)
    return cfg, policy, params


def load_packed_sharded(out_dir: str, mesh):
    """This rank's tree of a ``--tp N`` export (N the mesh's tp), read from
    its rank files only, on the mesh's device: the tree ``shard_params``
    gives this rank, ready for ``forward_serve_tp``, ``Engine(mesh=)`` and
    ``BatchScheduler(mesh=)``. A tp = 1 export is read whole on a tp = 1
    mesh."""
    tp = read_meta(out_dir).get("tensor_parallel", 1)
    if mesh.tp != tp:
        raise ValueError(f"the mesh's model axis is {mesh.tp}, the export's tp {tp}: serve it with --tp {tp}")
    return load_packed(out_dir, rank=mesh.model_index if tp > 1 else None, device=mesh.device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model-dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--policy", default="llama_flex")
    ap.add_argument("--wbits", type=int, default=6)
    ap.add_argument("--abits", type=int, default=6)
    ap.add_argument("--head-bits", type=int, default=0,
                    help="quantize the lm_head at this width (0 = keep bf16)")
    ap.add_argument("--tp", type=int, default=1,
                    help="write per-rank tensor-parallel files (layer_{i}.rank{r}, head.rank{r}); load with "
                         "load_packed(rank=r) or load_packed_sharded(dir, mesh)")
    ap.add_argument("--device", default="cuda", help="where the weights are quantized (cuda, or cpu)")
    args = ap.parse_args(argv)
    export_checkpoint(args.model_dir, args.out, args.policy, args.wbits, args.abits, head_bits=args.head_bits,
                      tp=args.tp, device=args.device)


if __name__ == "__main__":
    main()
