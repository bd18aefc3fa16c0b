"""Parallel serving on torch.distributed, one process a rank (port of
flexq_tpu/parallel/): tensor and data parallelism (distributed.py, tp.py),
pipeline parallelism (pp.py), ring attention (cp.py) and sequence-parallel
serving (sp_serve.py)."""

from flexq_tpu_torch.parallel.cp import SeqMesh, forward_sp, make_sp_mesh, ring_attention
from flexq_tpu_torch.parallel.distributed import Mesh, initialize, process_mesh, shutdown
from flexq_tpu_torch.parallel.pp import (
    PipeMesh,
    decode_step_pp,
    forward_serve_pp,
    make_pipe_mesh,
    serve_step_pp,
    shard_cache_pp,
    shard_params_pp,
)
from flexq_tpu_torch.parallel.sp_serve import generate_sp, sp_decode_step, sp_prefill
from flexq_tpu_torch.parallel.tp import forward_serve_tp, make_mesh, param_specs, replicate_kv_heads, shard_params

__all__ = ["Mesh", "PipeMesh", "SeqMesh", "decode_step_pp", "forward_serve_pp", "forward_serve_tp", "forward_sp",
           "generate_sp", "initialize", "make_mesh", "make_pipe_mesh", "make_sp_mesh", "param_specs", "process_mesh",
           "replicate_kv_heads", "ring_attention", "serve_step_pp", "shard_cache_pp", "shard_params",
           "shard_params_pp", "shutdown", "sp_decode_step", "sp_prefill"]
