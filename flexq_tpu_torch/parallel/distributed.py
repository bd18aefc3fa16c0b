"""Process bootstrap and the (data, model) rank grid (port of
flexq_tpu/parallel/distributed.py).

Where one JAX process drives every device of its mesh, here every rank is a
process of its own: ``initialize`` joins this process to the world through
``torch.distributed.init_process_group``, and ``process_mesh`` lays the ranks
out as the reference's hybrid mesh does: the ``model`` (tensor) axis over
consecutive ranks, which a launcher places on one node first (its two
all-reduces a layer want the fast links), the ``data`` axis across them.

Launch, one process per rank (``--coordinator`` is ``host:port`` of rank 0,
or a ``file://`` store on a shared disk; over several nodes, set
``LOCAL_WORLD_SIZE`` to the number of ranks on each node):

    python -m flexq_tpu_torch.serve.http --checkpoint ckpt --tp 2 \\
        --coordinator localhost:29500 --num-processes 2 --process-id 0 &
    python -m flexq_tpu_torch.serve.http --checkpoint ckpt --tp 2 \\
        --coordinator localhost:29500 --num-processes 2 --process-id 1

Backends: NCCL where each rank has a card of its own (the default on the
card); gloo on the CPU, and on the card only when asked for by name
(``backend="gloo"``), which lets ranks share one card: gloo moves CUDA
tensors through the host. The backend is never switched quietly: two ranks
on one card under NCCL raise.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

from flexq_tpu_torch.kernels.common import resolve_device

_DEVICE: Optional[torch.device] = None  # this rank's device, set by initialize


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    backend: Optional[str] = None,
    device="cuda",
    timeout_s: float = 300.0,
) -> torch.device:
    """Join this process to a world of ``num_processes`` ranks as rank
    ``process_id`` and return its device. The ranks on this node are
    ``LOCAL_WORLD_SIZE`` (as torchrun sets it; a launch over several nodes
    must set it), else all of them; rank r takes card ``r % local`` of its
    node under NCCL, and card ``(r % local) % device_count`` under gloo.
    ``backend=None`` is NCCL on the card and gloo on the CPU."""
    global _DEVICE
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    local_env = os.environ.get("LOCAL_WORLD_SIZE")
    local_size = int(local_env or num_processes)
    local_rank = process_id % local_size
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if backend == "nccl" and local_size > cards:
            several_nodes = "" if local_env else (
                "; over several nodes, set LOCAL_WORLD_SIZE to the ranks of this node (unset, every rank is "
                "taken to be on this one)")
            raise ValueError(
                f"{local_size} ranks on {cards} card(s): NCCL needs a card for each rank; pass "
                f'backend="gloo" to let ranks share a card (collectives through the host){several_nodes}')
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError("the NCCL backend needs the card; the CPU takes backend=\"gloo\"")
    dist.init_process_group(backend, init_method=_init_method(coordinator_address), world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    _DEVICE = dev
    return dev


def shutdown() -> None:
    """Leave the world (every rank calls it)."""
    global _DEVICE
    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data, model) grid: ``shape`` is the
    reference Mesh's ``{"data": dp, "model": tp}``, ``model_index`` and
    ``data_index`` this rank's coordinates, ``model_group`` the tp ranks
    that share its batch rows (the all-reduces and the vocab gather),
    ``data_group`` the dp ranks that hold its weight shard (the batch
    gather)."""

    tp: int
    dp: int
    rank: int
    device: torch.device
    backend: str
    model_group: Any
    data_group: Any

    @property
    def shape(self) -> dict:
        return {"data": self.dp, "model": self.tp}

    @property
    def model_index(self) -> int:
        return self.rank % self.tp

    @property
    def data_index(self) -> int:
        return self.rank // self.tp

    @property
    def capturable(self) -> bool:
        """Whether a decode step with this mesh's collectives can be captured
        in a CUDA graph: NCCL's can, gloo's (through the host) cannot. On the
        CPU no step is captured."""
        return self.backend == "nccl" or self.device.type == "cpu"

    def rows(self, b: int) -> slice:
        """This rank's share of ``b`` batch rows (all of them unless ``b``
        divides by dp: the reference runs such a batch data-replicated)."""
        if self.dp == 1 or b % self.dp:
            return slice(0, b)
        n = b // self.dp
        return slice(self.data_index * n, (self.data_index + 1) * n)


def resolve_rank_device(device=None) -> torch.device:
    """``device``, or the device ``initialize`` gave this rank."""
    dev = resolve_device(device) if device is not None else _DEVICE
    if dev is None:
        raise ValueError("no device: pass device= or call initialize()")
    return dev


def host_staged(mesh) -> bool:
    """Whether a mesh's point-to-point transfers go through a host copy:
    gloo's send / recv take CPU tensors only (its collectives take CUDA
    tensors, moving them through the host themselves)."""
    return mesh.backend == "gloo" and mesh.device.type == "cuda"


def process_mesh(tp: int, dp: int = 1, device=None) -> Mesh:
    """The (data, model) grid over the initialized world of tp * dp ranks:
    rank r at model index r % tp, data index r // tp. Every rank calls it
    (it creates the groups, a collective)."""
    if not dist.is_initialized():
        raise RuntimeError("process_mesh needs initialize() first (one process per rank)")
    world = dist.get_world_size()
    if tp * dp != world:
        raise ValueError(f"tp * dp = {tp * dp} != world size {world}")
    rank = dist.get_rank()
    dev = resolve_rank_device(device)
    if world == 1:
        model_group = data_group = dist.group.WORLD
    else:
        model_group = data_group = None
        for d in range(dp):  # every rank creates every group, in one order
            g = dist.new_group([d * tp + m for m in range(tp)])
            if rank // tp == d:
                model_group = g
        for m in range(tp):
            g = dist.new_group([d * tp + m for d in range(dp)])
            if rank % tp == m:
                data_group = g
    return Mesh(tp=tp, dp=dp, rank=rank, device=dev, backend=dist.get_backend(), model_group=model_group,
                data_group=data_group)
