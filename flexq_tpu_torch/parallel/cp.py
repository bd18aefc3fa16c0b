"""Ring attention: sequence (context) parallelism on torch.distributed (port
of flexq_tpu/parallel/cp.py).

The sequence is split over a world of ``sp`` processes: each rank holds an
L/sp chunk of the queries, keys and values; the K/V chunks go around the
ring, each rank passing its current chunk to the previous rank and taking
the next rank's, while every rank folds each visiting chunk into its
queries' online softmax (f32 running max, sum and accumulator). At step t
rank ``my`` holds the chunk that started on rank (my + t) % sp, its own
first, so the sums fold in the reference's order. Attention memory is
O((L/sp)^2) a rank.

As in the reference the ring is plain tensor math (f32 einsums), not a
kernel. ``forward_sp`` runs the dense evaluation forward (models/llama.py)
with the sequence split: every per-token op on the local chunk, attention
through the ring, the logits gathered.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List

import torch
import torch.distributed as dist

from flexq_tpu_torch.config import ModelConfig
from flexq_tpu_torch.models.llama import _linear, act_fn, apply_rope, rmsnorm, rope_for_cfg
from flexq_tpu_torch.models.quantized import all_gather_cat, embed_ids
from flexq_tpu_torch.parallel import distributed
from flexq_tpu_torch.parallel.distributed import host_staged

NEG = -1e30


@dataclasses.dataclass(frozen=True)
class SeqMesh:
    """This rank's place on the sequence ring: rank r holds the r-th L/sp
    chunk; ``group`` the world's process group."""

    sp: int
    rank: int
    device: torch.device
    backend: str
    group: Any

    @property
    def shape(self) -> dict:
        return {"seq": self.sp}


def make_sp_mesh(sp: int, device=None) -> SeqMesh:
    """The ring over the initialized world of ``sp`` ranks. Every rank
    calls it."""
    if not dist.is_initialized():
        raise RuntimeError("make_sp_mesh needs initialize() first (one process per sequence chunk)")
    if dist.get_world_size() != sp:
        raise ValueError(f"sp = {sp} != world size {dist.get_world_size()}")
    return SeqMesh(sp=sp, rank=dist.get_rank(), device=distributed.resolve_rank_device(device),
                   backend=dist.get_backend(), group=dist.group.WORLD)


def ring_pass(xs: List[torch.Tensor], mesh: SeqMesh) -> List[torch.Tensor]:
    """One turn of the ring: each of ``xs`` to the previous rank, and the
    next rank's in its place. Every send and receive is posted together
    (batch_isend_irecv), in one order on every rank, so no rank blocks on a
    send before its receive. Gloo's point-to-point takes CPU tensors only:
    under gloo a card's tensors go through a host copy."""
    prev, nxt = (mesh.rank - 1) % mesh.sp, (mesh.rank + 1) % mesh.sp
    host = host_staged(mesh)
    out = [x.cpu() if host else x.contiguous() for x in xs]
    bufs = [torch.empty_like(x) for x in out]
    ops = []
    for tag, (x, buf) in enumerate(zip(out, bufs)):
        ops.append(dist.P2POp(dist.isend, x, prev, group=mesh.group, tag=tag))
        ops.append(dist.P2POp(dist.irecv, buf, nxt, group=mesh.group, tag=tag))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [b.to(mesh.device) for b in bufs]


def ring_attention(
    q: torch.Tensor,  # this rank's [B, C, H, D] query chunk (C = L / sp)
    k: torch.Tensor,  # [B, C, KVH, D]
    v: torch.Tensor,
    mesh: SeqMesh,
    num_kv_groups: int = 1,
    causal: bool = True,
) -> torch.Tensor:
    """Causal attention over the whole sequence, split over the ring:
    returns this rank's output chunk [B, C, H*D] in q's dtype. Every rank
    calls it with its own chunks."""
    b, c, h, d = q.shape
    sp, my = mesh.sp, mesh.rank
    qf = q.to(torch.float32)
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    q_pos = my * c + torch.arange(c, device=dev)
    m = torch.full((b, h, c, 1), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, c, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, c, d), dtype=torch.float32, device=dev)
    kc, vc = k, v
    for t in range(sp):
        src = (my + t) % sp  # the rank the visiting chunk started on
        kr, vr = kc, vc
        if num_kv_groups > 1:
            kr, vr = kr.repeat_interleave(num_kv_groups, dim=2), vr.repeat_interleave(num_kv_groups, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kr.to(torch.float32)) * scale
        if causal:
            k_pos = src * c + torch.arange(c, device=dev)
            s = torch.where((q_pos[:, None] >= k_pos[None, :])[None, None], s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhqk,bkhd->bhqd", p, vr.to(torch.float32))
        m = m_new
        if t < sp - 1:  # the reference's last permute carries nothing that is read
            kc, vc = ring_pass([kc, vc], mesh)
    out = (acc / l.clamp_min(1e-30)).to(q.dtype)
    return out.transpose(1, 2).reshape(b, c, h * d)


def local_chunk(ids: torch.Tensor, mesh: SeqMesh) -> torch.Tensor:
    """This rank's L/sp columns of ``ids`` [B, L]."""
    l = ids.shape[1]
    if l % mesh.sp:
        raise ValueError(f"L={l} must divide over sp={mesh.sp}")
    c = l // mesh.sp
    return ids[:, mesh.rank * c : (mesh.rank + 1) * c]


def forward_sp(params: Dict[str, Any], cfg: ModelConfig, ids, mesh: SeqMesh) -> torch.Tensor:
    """The dense full-sequence forward with the sequence split over the
    ring (long-context evaluation): each rank embeds, normalizes and
    projects its own chunk, attention runs the K/V ring, and the logits
    [B, L, V] are gathered on every rank. Every rank calls it with the
    whole ``ids``."""
    if cfg.sliding_window is not None:
        raise NotImplementedError("the ring-attention path does not implement sliding-window masks")
    dev = params["embed"].device
    ids = local_chunk(torch.as_tensor(ids, device=dev), mesh)
    b, c = ids.shape
    positions = mesh.rank * c + torch.arange(c, device=dev).expand(b, c)
    cos, sin = rope_for_cfg(positions, cfg)
    x = embed_ids(params, cfg, ids, positions)
    for lp in params["layers"]:
        h = rmsnorm(x, lp["input_norm"], cfg.norm_eps)
        q = _linear(lp, "q_proj", h, None).reshape(b, c, cfg.num_heads, cfg.head_dim)
        k = _linear(lp, "k_proj", h, None).reshape(b, c, cfg.num_kv_heads, cfg.head_dim)
        v = _linear(lp, "v_proj", h, None).reshape(b, c, cfg.num_kv_heads, cfg.head_dim)
        q, k = apply_rope(q, k, cos, sin)
        x = x + _linear(lp, "o_proj", ring_attention(q, k, v, mesh, cfg.num_kv_groups), None)
        h = rmsnorm(x, lp["post_norm"], cfg.norm_eps)
        gate = _linear(lp, "gate_proj", h, None)
        act = act_fn(cfg.act, gate.to(torch.float32)).to(gate.dtype) * _linear(lp, "up_proj", h, None)
        x = x + _linear(lp, "down_proj", act, None)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return all_gather_cat(x @ head.to(x.dtype), mesh.group, 1)
