"""One rank of a tests/test_torch_parallel.py or tests/test_torch_pp_sp.py
world: a process of a gloo world on the CPU that imports only
flexq_tpu_torch.

    python tests/torch_tp_ranks.py <workdir> <rank>

reads ``<workdir>/job.pt`` (tp and dp, or the world size of a pipeline /
sequence world, and the cases: trees, configs, inputs), joins the world
through a ``file://`` store in ``<workdir>`` (no TCP port, so parallel test
workers cannot collide), runs every case on the (data, model) mesh, or on
the pipeline or ring its case makes, and writes its results to
``<workdir>/out<rank>.pt``.
"""

import os
import sys

import torch
import torch.distributed as dist

from flexq_tpu_torch.export.exporter import load_packed, load_packed_sharded
from flexq_tpu_torch.parallel import (forward_serve_pp, forward_serve_tp, forward_sp, generate_sp, initialize,
                                     make_pipe_mesh, make_sp_mesh, process_mesh, ring_attention, serve_step_pp,
                                     shard_cache_pp, shard_params, shard_params_pp, shutdown, sp_decode_step,
                                     sp_prefill)
from flexq_tpu_torch.parallel.cp import local_chunk
from flexq_tpu_torch.parallel.tp import _local_cfg
from flexq_tpu_torch.serve.engine import Engine
from flexq_tpu_torch.serve.replicated import ReplicatedScheduler
from flexq_tpu_torch.serve.scheduler import BatchScheduler

WORKDIR = []  # the world's directory (argv[1])
HTTP_REQS = [([3, 14, 15, 9], 5), ([7, 7], 4), ([5, 5, 5], 3)]  # tests/test_torch_parallel.py's HTTP requests
DT = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def local_cache(cfg, mesh, kind, b, maxlen, dtype, npages=0, page_size=128):
    """A zeroed local cache tuple: dense [L, B/dp, KVH/tp, S, D] or a page
    pool [L, P, KVH/tp, PS, D]; int8 adds the f32 scales."""
    kvh = _local_cfg(cfg, mesh.tp).num_kv_heads
    if kind == "paged":
        shape = (cfg.num_layers, npages, kvh, page_size, cfg.head_dim)
    else:
        rows = mesh.rows(b)
        shape = (cfg.num_layers, rows.stop - rows.start, kvh, maxlen, cfg.head_dim)
    cache = tuple(torch.zeros(shape, dtype=DT[dtype]) for _ in "kv")
    if dtype == "int8":
        cache += tuple(torch.zeros(shape[:-1], dtype=torch.float32) for _ in "kv")
    return cache


def case_shard(mesh, tree):
    return shard_params(tree, mesh)


def case_forward(mesh, tree, cfg, policy, calls, cache=None):
    """Each call of ``calls`` through forward_serve_tp over one local cache
    (``cache``: kind, batch, maxlen, dtype[, npages, table]); the logits of
    every call."""
    local = shard_params(tree, mesh)
    kv = None if cache is None else local_cache(cfg, mesh, cache["kind"], cache["batch"], cache["maxlen"],
                                                 cache["dtype"], cache.get("npages", 0))
    out = []
    for call in calls:
        call = dict(call)
        if kv is not None:
            call.update(kv_k=kv[0], kv_v=kv[1])
            if len(kv) == 4:
                call.update(kv_k_scale=kv[2], kv_v_scale=kv[3])
            if cache["kind"] == "paged":
                call["page_table"] = cache["table"]
        ids = call.pop("ids")
        logits, _ = forward_serve_tp(local, cfg, policy, ids, mesh, **call)
        out.append(logits)
    return out


def case_engine(mesh, tree, cfg, policy, runs):
    """Engine(mesh=) greedy runs: (kv dtype, mode, prompts, new) each."""
    out = []
    for kv_dtype, mode, prompts, new in runs:
        eng = Engine(tree, cfg, policy, max_seq_len=256, kv_dtype=DT[kv_dtype], mesh=mesh)
        out.append(eng.generate(prompts, max_new_tokens=new, eos_id=-1, mode=mode))
    return out


def case_beam(mesh, tree, cfg, policy, prompts, width, new):
    """Beam search at this mesh: the Engine's (dense cache) and a beam group
    in the paged scheduler; each the n-best (tokens, score) lists."""
    from flexq_tpu_torch.serve import beam

    eng = Engine(tree, cfg, policy, max_seq_len=256, kv_dtype=torch.float32, mesh=mesh)
    params = beam.BeamParams(beam_width=width, max_new_tokens=new)
    engine = beam.beam_search_nbest(eng, prompts, params, n_best=2)
    sched = BatchScheduler(tree, cfg, policy, mesh=mesh, num_slots=width, max_seq_len=256, paged=True,
                           kv_dtype=torch.float32)
    rids = [sched.add_request(p, max_new_tokens=new, eos_id=-1, beam_width=width, n_best=2) for p in prompts]
    sched.run()
    return engine, [[(t, sc) for t, sc, _ in sched.done_nbest[r]] for r in rids]


def run_sched(sched, requests):
    rids = [sched.add_request(p, max_new_tokens=n, eos_id=-1) for p, n in requests]
    got = sched.run()
    return [got[r] for r in rids]


def case_sched(mesh, tree, cfg, policy, runs):
    """BatchScheduler(mesh=) runs: (constructor keywords, [(prompt, new)]);
    the streams in request order, and the pool's free pages after."""
    out = []
    for kw, requests in runs:
        kw = dict(kw)
        kw["kv_dtype"] = DT[kw.get("kv_dtype", "f32")]
        sched = BatchScheduler(tree, cfg, policy, mesh=mesh, **kw)
        streams = run_sched(sched, requests)
        hits = sched.registry.hits if sched.registry is not None else 0
        free = None
        if sched.paged:  # a partitioned pool: each partition's free pages
            pool = sched.pool
            free = pool.free_pages if pool.partitions == 1 else [pool.free_in(d) for d in range(pool.partitions)]
        out.append((streams, free, hits))
    return out


def mesh_store() -> str:
    return os.path.join(WORKDIR[0], "store")


def case_replicated(mesh, tree, cfg, policy, kw, requests):
    """A ReplicatedScheduler over BatchScheduler(mesh=): rank 0 leads (its
    port through the world's store), the others follow; the leader's
    streams."""
    sched = BatchScheduler(tree, cfg, policy, mesh=mesh, kv_dtype=DT[kw.pop("kv_dtype", "f32")], **kw)
    store = dist.FileStore(os.path.join(os.path.dirname(mesh_store()), "replication"), mesh.tp * mesh.dp)
    if mesh.rank == 0:
        lead = ReplicatedScheduler(sched, leader=True, port=0, num_followers=mesh.tp * mesh.dp - 1,
                                   host="127.0.0.1", announce=lambda port: store.set("replication_port", str(port)))
        streams = run_sched(lead, requests)
        lead.shutdown()
        return streams
    port = int(store.get("replication_port"))
    ReplicatedScheduler(sched, leader=False, leader_addr=("127.0.0.1", port)).serve_forever()
    return None


def case_export(mesh, path, ids):
    """load_packed_sharded's local tree, and the forward on ``ids`` over it
    and over shard_params of the reassembled whole tree."""
    cfg, policy, local = load_packed_sharded(path, mesh)
    logits, _ = forward_serve_tp(local, cfg, policy, ids, mesh)
    whole = shard_params(load_packed(path, device="cpu")[2], mesh)
    sched = BatchScheduler(local, cfg, policy, mesh=mesh, num_slots=2, max_seq_len=256, paged=True)
    return local, logits, forward_serve_tp(whole, cfg, policy, ids, mesh)[0], run_sched(sched, HTTP_REQS)


# ---- pipeline and sequence parallelism: a world of pp (sp) ranks, each case
# making its own mesh over the whole world --------------------------------


def pipe():
    return make_pipe_mesh(dist.get_world_size())


def ring():
    return make_sp_mesh(dist.get_world_size())


def case_pp_forward(mesh, tree, cfg, policy, ids, microbatches):
    """forward_serve_pp's logits."""
    pm = pipe()
    return forward_serve_pp(shard_params_pp(tree, pm), cfg, policy, ids, pm, num_microbatches=microbatches)


def case_pp_cache(mesh, tree, cfg, policy, calls, dtype, batch, maxlen=128):
    """serve_step_pp through ``calls`` (each ids, cache_pos, last_only) over
    this stage's share of a zeroed cache; the logits of every call."""
    pm = pipe()
    local = shard_params_pp(tree, pm)
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, maxlen, cfg.head_dim)
    cache = [torch.zeros(shape, dtype=DT[dtype]) for _ in "kv"]
    if dtype == "int8":
        cache += [torch.zeros(shape[:-1]) for _ in "kv"]
    cache = shard_cache_pp(pm, *cache)
    return [serve_step_pp(local, cfg, policy, c["ids"], pm, cache, c["cache_pos"], last_only=c.get("last_only", False))[0]
            for c in calls]


def case_pp_engine(mesh, tree, cfg, policy, runs):
    """Engine(pp_mesh=) runs: (Engine keywords, generate keywords) each; a
    run's generate result."""
    pm = pipe()
    out = []
    for ekw, gkw in runs:
        ekw = dict(ekw, kv_dtype=DT[ekw.get("kv_dtype", "f32")])
        out.append(Engine(tree, cfg, policy, pp_mesh=pm, **ekw).generate(**gkw))
    return out


def case_pp_sched(mesh, tree, cfg, policy, runs):
    """BatchScheduler(pp_mesh=) runs: (keywords, [(prompt, new)]); the
    streams and logprobs in request order."""
    pm = pipe()
    out = []
    for kw, requests in runs:
        sched = BatchScheduler(tree, cfg, policy, pp_mesh=pm, **dict(kw, kv_dtype=DT[kw.get("kv_dtype", "f32")]))
        rids = [sched.add_request(p, max_new_tokens=n, eos_id=-1, logprobs=True) for p, n in requests]
        got = sched.run()
        out.append(([got[r] for r in rids], [sched.done_logprobs[r] for r in rids]))
    return out


def case_ring(mesh, q, k, v, groups):
    """ring_attention on this rank's chunk of the whole q / k / v."""
    sm = ring()
    return ring_attention(*(local_chunk(x, sm) for x in (q, k, v)), sm, groups)


def case_sp_forward(mesh, tree, cfg, ids):
    return forward_sp(tree, cfg, ids, ring())


def case_sp_prefill(mesh, tree, cfg, policy, ids, dtype="bf16"):
    """sp_prefill's logits and the shapes of this rank's cache."""
    logits, cache = sp_prefill(tree, cfg, policy, ids, ring(), kv_dtype=DT[dtype])
    return logits, [tuple(c.shape) for c in cache]


def case_sp_generate(mesh, tree, cfg, policy, ids, new, dtype="bf16"):
    return generate_sp(tree, cfg, policy, ids, ring(), max_new_tokens=new, return_logits=True, kv_dtype=DT[dtype])


def case_sp_tail(mesh, tree, cfg, policy, ids):
    """tests/test_sp_serve.py::test_sp_decode_step_tail_attention's steps:
    token A or B at step 0 from one tail, then token 3 at step 1 after
    each (each call given its own tail: the port writes the tail in place)."""
    sm = ring()
    _, pc = sp_prefill(tree, cfg, policy, ids, sm)
    shape = (cfg.num_layers, 1, cfg.num_kv_heads, 4, cfg.head_dim)
    tail = (torch.zeros(shape, dtype=torch.bfloat16), torch.zeros(shape, dtype=torch.bfloat16))
    l = ids.shape[1]

    def step(tok, tk, tv, t):
        return sp_decode_step(tree, cfg, policy, torch.tensor([[tok]]), sm, pc, tk.clone(), tv.clone(), t, l)

    la, tka, tva = step(7, *tail, 0)
    lb, tkb, tvb = step(91, *tail, 0)
    return la, lb, step(3, tka, tva, 1)[0], step(3, tkb, tvb, 1)[0]


CASES = {"shard": case_shard, "forward": case_forward, "engine": case_engine, "sched": case_sched, "beam": case_beam,
         "replicated": case_replicated, "export": case_export, "pp_forward": case_pp_forward,
         "pp_cache": case_pp_cache, "pp_engine": case_pp_engine, "pp_sched": case_pp_sched, "ring": case_ring,
         "sp_forward": case_sp_forward, "sp_prefill": case_sp_prefill, "sp_generate": case_sp_generate,
         "sp_tail": case_sp_tail}


def main():
    workdir, rank = sys.argv[1], int(sys.argv[2])
    WORKDIR.append(workdir)
    torch.set_num_threads(1)
    job = torch.load(os.path.join(workdir, "job.pt"), weights_only=False)
    tp, dp = job.get("tp", 1), job.get("dp", 1)
    world = job.get("world", tp * dp)  # a pp / sp world: its cases make their meshes
    initialize(f"file://{mesh_store()}", world, rank, backend="gloo", device="cpu",
               timeout_s=job.get("timeout_s", 240))
    mesh = process_mesh(tp, dp) if "tp" in job else None
    out = {}
    for name, (kind, args) in job["cases"].items():
        out[name] = CASES[kind](mesh, **args)
    torch.save(out, os.path.join(workdir, f"out{rank}.pt"))
    shutdown()


if __name__ == "__main__":
    main()
