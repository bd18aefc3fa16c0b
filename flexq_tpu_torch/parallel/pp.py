"""Pipeline parallelism for the quantized serving path (port of
flexq_tpu/parallel/pp.py on torch.distributed).

Each rank of a world of ``pp`` processes is one stage: it holds a
contiguous range of ``L / pp`` layers, and the embedding, norms,
positions and head whole. A step runs stage by stage: stage 0 embeds, each
stage runs its layers over its local cache ([L/pp, B, KVH, S, D]) through
the single-device layers (models/quantized.py's ``run_layers``, the same
kernels at the same shapes), hands the hidden state to the next rank, and
the last stage normalizes, applies the head and broadcasts the logits, so
every rank samples from the same values. Where the reference runs every
stage's program on every device and masks, here a stage runs only its own
layers; the broadcast takes the place of the reference's masked ``psum``.

Differences from the reference, by design:
  * the layers of a stage are a list, not a stacked pytree (no scan to
    feed); ``shard_params_pp`` keeps this rank's range only;
  * under a no-act-quant (weight-only) policy every LLaMA step takes the
    W*A16 layer, as ``forward_serve`` does; the reference's pp step runs
    the W*Ax layer whatever the policy. Otherwise prompts never take the
    W*A16 prefill (``serve_step_pp`` has no ``prefill_bf16``), as in the
    reference: they run the exact W*Ax layer at M = the prompt's rows.

Launch, one process per stage:

    python -m flexq_tpu_torch.serve.http --checkpoint ckpt --pp 2 \\
        --coordinator localhost:29500 --num-processes 2 --process-id 0 &
    python -m flexq_tpu_torch.serve.http --checkpoint ckpt --pp 2 \\
        --coordinator localhost:29500 --num-processes 2 --process-id 1
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from flexq_tpu_torch.config import ModelConfig, QuantPolicy
from flexq_tpu_torch.models.quantized import embed_ids, final_logits, layer_choice, run_layers, step_context
from flexq_tpu_torch.parallel import distributed
from flexq_tpu_torch.parallel.distributed import host_staged


@dataclasses.dataclass(frozen=True)
class PipeMesh:
    """This rank's place in the pipeline: ``stage`` (its rank), ``pp`` the
    stages, ``group`` the world's process group, ``device`` its device."""

    pp: int
    rank: int
    device: torch.device
    backend: str
    group: Any

    @property
    def shape(self) -> dict:
        return {"pipe": self.pp}

    @property
    def stage(self) -> int:
        return self.rank

    @property
    def first(self) -> bool:
        return self.rank == 0

    @property
    def last(self) -> bool:
        return self.rank == self.pp - 1


def make_pipe_mesh(pp: int, device=None) -> PipeMesh:
    """The pipeline over the initialized world of ``pp`` ranks: rank r is
    stage r. Every rank calls it."""
    if not dist.is_initialized():
        raise RuntimeError("make_pipe_mesh needs initialize() first (one process per stage)")
    if dist.get_world_size() != pp:
        raise ValueError(f"pp = {pp} != world size {dist.get_world_size()}")
    dev = distributed.resolve_rank_device(device)
    return PipeMesh(pp=pp, rank=dist.get_rank(), device=dev, backend=dist.get_backend(), group=dist.group.WORLD)


def _stage_range(num_layers: int, mesh: PipeMesh) -> slice:
    if num_layers % mesh.pp:
        raise ValueError(f"{num_layers} layers do not split over pp={mesh.pp} stages")
    n = num_layers // mesh.pp
    return slice(mesh.stage * n, (mesh.stage + 1) * n)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def shard_params_pp(params: Dict[str, Any], mesh: PipeMesh) -> Dict[str, Any]:
    """This stage's tree on ``mesh.device``: its contiguous layer range
    [s·L/pp, (s+1)·L/pp), every other entry (embed, norms, OPT's
    pos_embed, a bf16 or packed lm_head) whole."""
    out = {k: _to(v, mesh.device) for k, v in params.items() if k != "layers"}
    out["layers"] = _to(params["layers"][_stage_range(len(params["layers"]), mesh)], mesh.device)
    return out


def stage_params(params: Dict[str, Any], cfg: ModelConfig, mesh: PipeMesh) -> Dict[str, Any]:
    """``shard_params_pp`` of a whole tree; a tree of L/pp layers is taken
    as this stage's already (the Engine's and the scheduler's input)."""
    n = len(params["layers"])
    _stage_range(cfg.num_layers, mesh)
    if n == cfg.num_layers:
        return shard_params_pp(params, mesh)
    if n * mesh.pp == cfg.num_layers:
        return _to(params, mesh.device)
    raise ValueError(f"a tree of {n} layers is neither the model's {cfg.num_layers} nor a stage's "
                     f"{cfg.num_layers // mesh.pp}")


def shard_cache_pp(mesh: PipeMesh, *arrays):
    """This stage's layers of KV-cache buffers [L, B, ...] (values and int8
    scales), on its device."""
    return tuple(a[_stage_range(a.shape[0], mesh)].to(mesh.device).contiguous() for a in arrays)


def _check_stage(params: Dict[str, Any], cfg: ModelConfig, mesh: PipeMesh) -> None:
    if len(params["layers"]) * mesh.pp != cfg.num_layers:
        raise ValueError(f"a stage of {len(params['layers'])} layers: pass this stage's tree (shard_params_pp)")


def _send(x: torch.Tensor, dst: int, mesh: PipeMesh) -> None:
    """The stage hop: ``x`` to rank ``dst``. Gloo's point-to-point takes CPU
    tensors only, so under gloo a card's tensor goes through a host copy
    (its collectives already move CUDA tensors through the host); NCCL
    sends it from the card."""
    dist.send(x.cpu() if host_staged(mesh) else x.contiguous(), dst, group=mesh.group)


def _recv(shape, dtype, src: int, mesh: PipeMesh) -> torch.Tensor:
    """The other half of ``_send``: a tensor of ``shape`` from rank ``src``."""
    buf = torch.empty(shape, dtype=dtype, device="cpu" if host_staged(mesh) else mesh.device)
    dist.recv(buf, src, group=mesh.group)
    return buf.to(mesh.device)


def _stage(params, cfg: ModelConfig, policy: QuantPolicy, ids: torch.Tensor, positions: torch.Tensor, mesh,
           cache, ctx) -> torch.Tensor:
    """One stage's part of a step: the embedding on stage 0, else the
    previous stage's hidden state; this stage's layers; the hidden state
    handed on (all but the last stage). Returns the stage's output."""
    b, l = ids.shape
    if mesh.first:
        x = embed_ids(params, cfg, ids, positions)
    else:
        x = _recv((b, l, cfg.hidden_size), params["embed"].dtype, mesh.stage - 1, mesh)
    x = run_layers(params["layers"], cfg, policy, x, ctx, cache, None, layer_choice(cfg, policy, False))
    if not mesh.last:
        _send(x, mesh.stage + 1, mesh)
    return x


def _broadcast_logits(logits: Optional[torch.Tensor], shape, dtype, mesh: PipeMesh) -> torch.Tensor:
    """The last stage's logits on every rank (the reference's masked psum)."""
    if logits is None:
        logits = torch.empty(shape, dtype=dtype, device=mesh.device)
    dist.broadcast(logits, mesh.pp - 1, group=mesh.group)
    return logits


def serve_step_pp(
    params: Dict[str, Any],  # this stage's tree (shard_params_pp)
    cfg: ModelConfig,
    policy: QuantPolicy,
    ids,  # [B, L] (prefill) or [B, 1] (decode)
    mesh: PipeMesh,
    kv,  # this stage's (k, v) or (k, v, k_scale, v_scale): [L/pp, B, KVH, S, D] (scales [L/pp, B, KVH, S])
    cache_pos,  # int first write position, or int tensor [B] per slot
    last_only: bool = False,
    positions: Optional[torch.Tensor] = None,
):
    """One pipelined serving forward (prefill or decode) over this stage's
    local cache, written in place: LLaMA or pre-LN OPT, a bf16 or int8
    cache, one start or a start per slot. ``positions`` defaults to
    ``cache_pos + arange(L)`` a row, as the reference derives them. Every
    rank calls it with the same arguments. Returns (logits [B, L, V] —
    [B, 1, V] with ``last_only`` — on every rank, ``kv``)."""
    dev = mesh.device
    ids = torch.as_tensor(ids, device=dev)
    b, l = ids.shape
    _check_stage(params, cfg, mesh)
    if len(kv) not in (2, 4) or kv[0].shape[0] != len(params["layers"]):
        raise ValueError("kv: this stage's (k, v[, k_scale, v_scale]) over its L/pp layers (shard_cache_pp)")
    if positions is None:
        if isinstance(cache_pos, torch.Tensor) and cache_pos.dim() > 0:
            start = cache_pos.to(device=dev, dtype=torch.int64).reshape(b, 1)
        else:
            start = torch.full((b, 1), int(cache_pos), dtype=torch.int64, device=dev)
        positions = start + torch.arange(l, device=dev)
    positions = torch.as_tensor(positions, device=dev)
    cache = tuple(kv) + (None, None) if len(kv) == 2 else tuple(kv)
    x = _stage(params, cfg, policy, ids, positions, mesh, cache, step_context(cfg, positions, True, cache_pos, dev))
    logits = final_logits(params, cfg, policy, x, last_only) if mesh.last else None
    shape = (b, 1 if last_only else l, cfg.vocab_size)
    return _broadcast_logits(logits, shape, params["embed"].dtype, mesh), kv


def decode_step_pp(params, cfg: ModelConfig, policy: QuantPolicy, ids, mesh: PipeMesh, kv_k, kv_v, cache_pos):
    """One pipelined decode step over a bf16 dense cache (serve_step_pp)."""
    return serve_step_pp(params, cfg, policy, ids, mesh, (kv_k, kv_v), cache_pos)


def forward_serve_pp(
    params: Dict[str, Any],  # this stage's tree (shard_params_pp)
    cfg: ModelConfig,
    policy: QuantPolicy,
    ids,  # [B, L], B a multiple of num_microbatches
    mesh: PipeMesh,
    num_microbatches: Optional[int] = None,
) -> torch.Tensor:
    """The GPipe full-sequence forward without a cache (eval, prefill):
    the batch in ``num_microbatches`` microbatches (default min(B, pp)),
    each through every stage in turn, so stage s runs microbatch j while
    stage s+1 runs j-1; the last stage normalizes and projects the whole
    batch. LLaMA only, as in the reference. Returns logits [B, L, V] on
    every rank."""
    if cfg.arch != "llama":
        raise ValueError(f"forward_serve_pp runs LLaMA-family models (the reference's); {cfg.arch} is served "
                         "through serve_step_pp")
    dev = mesh.device
    ids = torch.as_tensor(ids, device=dev)
    b, l = ids.shape
    m = num_microbatches or min(b, mesh.pp)
    if b % m:
        raise ValueError(f"batch {b} must divide into {m} microbatches")
    _check_stage(params, cfg, mesh)
    mb = b // m
    positions = torch.arange(l, device=dev).expand(mb, l)
    ctx = step_context(cfg, positions, False, None, dev)
    outs = [_stage(params, cfg, policy, ids[j * mb : (j + 1) * mb], positions, mesh, None, ctx) for j in range(m)]
    logits = final_logits(params, cfg, policy, torch.cat(outs), False) if mesh.last else None
    return _broadcast_logits(logits, (b, l, cfg.vocab_size), params["embed"].dtype, mesh)
