"""Tensor and data parallelism for the quantized serving path (port of
flexq_tpu/parallel/tp.py on torch.distributed).

Megatron's split, as the reference lays it out: q/k/v/gate/up/fc1 split
their output columns over the ``model`` ranks (column parallel), o/down/fc2
their input rows (row parallel), and each row-parallel output is summed over
the model group by one all-reduce, in the model dtype, before its residual
add: two a layer, where the reference's shard_map body runs its ``psum``.
A row-parallel bias is added once, after the all-reduce. The lm_head is
vocab-parallel: each rank runs the head GEMM on its [H, V/tp] columns and
the logits are all-gathered over the model group (the tied embedding stays
replicated, as do the norms and the embeddings). The ``data`` ranks split
the batch rows and the dense cache's rows; their logits are all-gathered
over the data group, so every rank holds the logits of every row and
samples them alike.

Each rank runs its kernels on its local shard at the local shapes: there is
no compiler to partition a global program, so ``shard_params`` cuts the
tree, ``_local_cfg`` gives the layer its local head and FFN counts, and the
callers hold local caches ([L, B/dp, KVH/tp, S, D]). A packed plane splits
on 128-row K-tiles (64 hi rows, 32 lo rows, 64 q4 rows), which the
K-tile-local layouts of packing/pack6.py and pack4.py keep valid planes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from flexq_tpu_torch.config import ModelConfig, QuantPolicy
from flexq_tpu_torch.models.quantized import _padded_width, all_gather_cat, forward_serve
from flexq_tpu_torch.parallel.distributed import Mesh, process_mesh
from flexq_tpu_torch.parallel.pp import PipeMesh, serve_step_pp

COL_LINEARS = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj", "fc1")
ROW_LINEARS = ("o_proj", "down_proj", "fc2")
ROW_PARTS = ("hi", "lo", "q4", "q8", "scale", "w")  # row-parallel leaves split on K; the bias stays whole
FUSED = ("qkv_proj", "gate_up")


def make_mesh(tp: int, dp: int = 1, device=None) -> Mesh:
    """The (data, model) grid over the initialized world (every rank calls
    it): ``process_mesh``, as the reference's make_mesh is its one-process
    case."""
    return process_mesh(tp, dp, device)


def split_dim(name: str, part: Optional[str]) -> Optional[int]:
    """The dimension a leaf splits on over the model ranks, or None where it
    is replicated: ``name`` a layer's linear or "lm_head", ``part`` its leaf
    ("hi", "b", ...; None for a dense head or a norm)."""
    if name in COL_LINEARS:
        return 0 if part == "b" else 1
    if name in ROW_LINEARS:
        return 0 if part in ROW_PARTS else None
    if name == "lm_head":
        return 1
    return None


def param_specs(params: Dict[str, Any]) -> Dict[str, Any]:
    """The tree of split dimensions (``split_dim``) of a serve tree: the
    reference's PartitionSpecs, as the dimension that carries ``model``."""

    def layer(lp):
        return {n: ({p: split_dim(n, p) for p in v} if isinstance(v, dict) else None) for n, v in lp.items()}

    out: Dict[str, Any] = {}
    for key, val in params.items():
        if key == "layers":
            out[key] = [layer(lp) for lp in val]
        elif key == "lm_head":
            out[key] = {p: 1 for p in val} if isinstance(val, dict) else 1
        elif isinstance(val, dict):
            out[key] = {p: None for p in val}
        else:
            out[key] = None
    return out


def rank_slice(x: torch.Tensor, dim: Optional[int], tp: int, r: int) -> torch.Tensor:
    """Rank r's contiguous 1/tp of ``x`` along ``dim`` (None: all of it)."""
    if dim is None:
        return x
    if x.shape[dim] % tp:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split over {tp} ranks")
    c = x.shape[dim] // tp
    return x.narrow(dim, r * c, c)


def refuse_fused(params: Dict[str, Any]) -> None:
    """The reference's split rules leave a fused qkv_proj / gate_up plane
    replicated, and its layer then cuts q, k, v (gate, up) out of the full
    product at the local offsets: columns of the wrong heads. The port
    refuses such a tree under a mesh."""
    for lp in params["layers"]:
        fused = [n for n in FUSED if n in lp]
        if fused:
            raise ValueError(f"a fuse=True tree ({', '.join(fused)}) is not served under a mesh: quantize it "
                             "with fuse=False (its planes split per rank)")


def shard_params(params: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's local tree on ``mesh.device``: column slices of
    q/k/v/gate/up/fc1 and of their biases, K slices of o/down/fc2, the
    head's vocab slice, everything else whole. Each slice is the shard the
    reference's ``shard_params`` places on the device at this model index."""
    refuse_fused(params)
    tp, r, dev = mesh.tp, mesh.model_index, mesh.device

    def cut(x, dim):
        return rank_slice(x, dim, tp, r).to(dev).contiguous()

    def walk(x, spec):
        if isinstance(x, dict):
            return {k: walk(v, spec[k] if isinstance(spec, dict) else spec) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v, s) for v, s in zip(x, spec)]
        return cut(x, spec)

    return walk(params, param_specs(params))


def is_sharded(params: Dict[str, Any], cfg: ModelConfig, tp: int) -> bool:
    """Whether ``params`` is already a rank's local tree (``shard_params``
    or ``load_packed_sharded``) rather than the whole one, read from the
    width of the first layer's first column-parallel linear."""
    if tp == 1:
        return False
    lp = params["layers"][0]
    name = next(n for n in COL_LINEARS if n in lp)
    full = (cfg.num_heads * cfg.head_dim if name == "q_proj"
            else cfg.num_kv_heads * cfg.head_dim if name in ("k_proj", "v_proj")
            else cfg.intermediate_size)
    leaf = lp[name]
    width = leaf["w"].shape[1] if "w" in leaf else leaf["scale"].shape[1]
    plane = full if "w" in leaf else _padded_width(full)
    if width == plane:
        return False
    if width * tp == plane:
        return True
    raise ValueError(f"{name} is {width} columns wide: neither the whole {plane} nor its 1/{tp}")


def _local_cfg(cfg: ModelConfig, tp: int) -> ModelConfig:
    if cfg.num_heads % tp:
        raise ValueError(f"num_heads {cfg.num_heads} does not split over tp={tp}")
    if cfg.num_kv_heads % tp:
        raise ValueError(f"num_kv_heads {cfg.num_kv_heads} does not split over tp={tp}: "
                         "replicate_kv_heads the dense tree first")
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // tp, num_kv_heads=cfg.num_kv_heads // tp,
                               intermediate_size=cfg.intermediate_size // tp)


def tp_forward_local(params, cfg: ModelConfig, policy: QuantPolicy, ids, mesh: Mesh, **kw):
    """One rank's forward on its local tree and its local rows: the layers
    at the local head and FFN counts (``_local_cfg``), each row-parallel
    output all-reduced over the model group, the vocab-parallel head
    gathered. Returns (logits of the rows given, full vocab; the cache
    state)."""
    return forward_serve(params, _local_cfg(cfg, mesh.tp), policy, ids, device=mesh.device,
                         tp_group=mesh.model_group, **kw)


def forward_serve_tp(
    params: Dict[str, Any],
    cfg: ModelConfig,
    policy: QuantPolicy,
    ids,  # [B, L]
    mesh: Mesh,
    kv_k: Optional[torch.Tensor] = None,  # local: dense [L, B/dp, KVH/tp, S, D] | pool [L, P, KVH/tp, PS, D]
    kv_v: Optional[torch.Tensor] = None,
    cache_pos=None,
    positions: Optional[torch.Tensor] = None,
    page_table: Optional[torch.Tensor] = None,
    kv_k_scale: Optional[torch.Tensor] = None,
    kv_v_scale: Optional[torch.Tensor] = None,
    prefill_bf16: bool = False,
    last_only: bool = False,
):
    """The tensor- and data-parallel forward: ``forward_serve``'s arguments
    and results, with ``params`` this rank's local tree and the cache this
    rank's local one. Batch-major operands (ids, per-row positions and
    cache positions, the page table) are given whole: where B divides by dp
    each data rank runs its B/dp rows against its B/dp cache rows and the
    logits are gathered over the data group; otherwise (a B = 1 admission
    prefill) every data rank runs all B rows over a cache of B rows, as the
    reference runs such a batch data-replicated. A page table at dp > 1 is
    the localized one (``PagePool.localize``) over this rank's partition
    of the pool: each data rank reads its rows of it. Returns (logits
    [B, L, V] on every rank, the local cache state or None)."""
    refuse_fused(params)
    ids = torch.as_tensor(ids, device=mesh.device)
    b = ids.shape[0]
    rows = mesh.rows(b)
    split = rows != slice(0, b)
    if split and page_table is not None:
        page_table = torch.as_tensor(page_table, device=mesh.device)

    def local(x, batch_major):
        return x[rows] if split and batch_major and isinstance(x, torch.Tensor) and x.dim() > 0 else x

    if positions is not None:
        positions = torch.as_tensor(positions, device=mesh.device)
    logits, cache = tp_forward_local(
        params, cfg, policy, local(ids, True), mesh,
        positions=None if positions is None else local(positions, positions.dim() == 2 and positions.shape[0] == b),
        kv_k=kv_k, kv_v=kv_v, cache_pos=local(cache_pos, True), prefill_bf16=prefill_bf16,
        kv_k_scale=kv_k_scale, kv_v_scale=kv_v_scale, page_table=local(page_table, True), last_only=last_only,
    )
    if split:
        logits = all_gather_cat(logits, mesh.data_group, 0)
    return logits, cache


def cache_forward(params, cfg: ModelConfig, policy: QuantPolicy, mesh, device, ids, cache, positions, cache_pos,
                  **kw):
    """The serving loops' forward over a cache tuple (k, v[, k_scale,
    v_scale]): ``forward_serve`` on one device, ``forward_serve_tp`` under a
    (data, model) mesh, ``serve_step_pp`` under a pipeline (a dense cache;
    it takes no ``prefill_bf16``: pipelined prompts run the W*Ax layer, as
    in the reference)."""
    if isinstance(mesh, PipeMesh):
        if kw.get("page_table") is not None:
            raise ValueError("the pipeline serves a dense cache")
        return serve_step_pp(params, cfg, policy, ids, mesh, cache, cache_pos, last_only=kw.get("last_only", False),
                             positions=positions)
    scales = dict(zip(("kv_k_scale", "kv_v_scale"), cache[2:]))
    if mesh is not None:
        return forward_serve_tp(params, cfg, policy, ids, mesh, positions=positions, kv_k=cache[0], kv_v=cache[1],
                                cache_pos=cache_pos, **scales, **kw)
    return forward_serve(params, cfg, policy, ids, positions=positions, kv_k=cache[0], kv_v=cache[1],
                         cache_pos=cache_pos, device=device, **scales, **kw)


def replicate_kv_heads(params: Dict[str, Any], cfg: ModelConfig, tp: int):
    """Repeat each kv head of a dense tree (before quantization) so that
    num_kv_heads >= tp: each head's D-column block of k_proj / v_proj (and
    its bias) repeated tp / num_kv_heads times in place, which keeps GQA's
    query-to-kv-head grouping. Returns (new params, new cfg)."""
    if cfg.num_kv_heads >= tp:
        return params, cfg
    if tp % cfg.num_kv_heads:
        raise ValueError(f"tp={tp} is not a multiple of num_kv_heads={cfg.num_kv_heads}")
    f, kvh, d = tp // cfg.num_kv_heads, cfg.num_kv_heads, cfg.head_dim

    def expand(w):  # [in, KVH*D] -> [in, KVH*f*D]
        w = torch.as_tensor(w)
        return w.reshape(w.shape[0], kvh, 1, d).expand(w.shape[0], kvh, f, d).reshape(w.shape[0], kvh * f * d)

    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = []
    for lp in params["layers"]:
        lp = dict(lp)
        for name in ("k_proj", "v_proj"):
            fc = dict(lp[name])
            fc["w"] = expand(fc["w"])
            if fc.get("b") is not None:
                fc["b"] = expand(torch.as_tensor(fc["b"])[None])[0]
            lp[name] = fc
        out["layers"].append(lp)
    return out, dataclasses.replace(cfg, num_kv_heads=kvh * f)
