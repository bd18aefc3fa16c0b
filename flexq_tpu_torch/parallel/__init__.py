"""Tensor and data parallelism on torch.distributed (port of flexq_tpu/parallel/:
distributed.py and tp.py; pipeline, context and sequence parallelism are later slices)."""

from flexq_tpu_torch.parallel.distributed import Mesh, initialize, process_mesh, shutdown
from flexq_tpu_torch.parallel.tp import forward_serve_tp, make_mesh, param_specs, replicate_kv_heads, shard_params

__all__ = ["Mesh", "forward_serve_tp", "initialize", "make_mesh", "param_specs", "process_mesh", "replicate_kv_heads",
           "shard_params", "shutdown"]
