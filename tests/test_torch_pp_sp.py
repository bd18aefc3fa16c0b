"""Pipeline, context and sequence parallelism of the port vs flexq_tpu on the
CPU.

The reference's tiny GQA model (tests/test_pp_serving.py and
tests/test_sp_serve.py: hidden 512, FFN 1024, 4 heads of 128 over 2 kv
heads, 2 layers, vocab 256, f32), its weights drawn by
``flexq_tpu.train.trainer.init_params`` and quantized by the reference. The
port's ranks are processes of two gloo worlds (tests/torch_tp_ranks.py,
which imports only flexq_tpu_torch), one of two ranks (pp = 2, sp = 2) and
one of four (pp = 4, sp = 4), started together when the module's fixture
is set up and read when a test needs them; the JAX side runs in this
process meanwhile on the 8-device CPU mesh of conftest.py. The reference's
own pp / sp programs compile for minutes on the CPU, so the port is held
where the reference's tests hold theirs: against the reference's
single-device functions, at those tests' bounds. Then the ``--pp 2`` HTTP
pair.

Held: ``forward_serve_pp`` at pp = 2 and 4 within 2e-4 of the reference's
``forward_serve`` and equal to the port's one-rank forward;
``serve_step_pp`` (prefill and decode steps over a stage's cache, f32 and
int8, a scalar and a per-slot start) equal to the port's one-rank
``forward_serve``, its prefill within 1e-5 of the reference's and its
argmax equal; the pp Engine (LLaMA, int8, chunked, pp = 4, OPT, sampled
with logprobs) and the pp scheduler (dense; int8 chunked with logprobs)
giving the single-device tokens; ``ring_attention`` within 2e-5 of the
reference's ``attention_core``; ``forward_sp`` within 3e-4 of its dense
forward; ``sp_prefill`` within rtol 2e-3 / atol 2e-2 of its W6A16 prefill
(argmax >= 0.95); ``generate_sp`` within the reference test's trajectory
bounds of its single-device generation; the tail cache attended; the int8
prompt cache against the bf16 one; ``serve.http --pp 2`` giving a direct
pp = 2 run's tokens; and the refusals.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexq_tpu.config import ModelConfig as JModelConfig, QuantPolicy as JQuantPolicy
from flexq_tpu.models.llama import attention_core as j_attention_core, causal_mask as j_causal_mask
from flexq_tpu.models.llama import forward as j_dense_forward
from flexq_tpu.models.quantized import forward_serve as j_forward_serve, quantize_params as j_quantize_params
from flexq_tpu.serve.engine import Engine as JEngine, decode_mask, prefill_mask
from flexq_tpu.train.trainer import init_params
from flexq_tpu_torch.config import ModelConfig, QuantPolicy
from flexq_tpu_torch.convert import params_from_numpy
from flexq_tpu_torch.export.exporter import export_checkpoint
from flexq_tpu_torch.models.quantized import forward_serve, quantize_params
from flexq_tpu_torch.parallel import Mesh, PipeMesh, SeqMesh, sp_prefill
from flexq_tpu_torch.serve.engine import Engine
from flexq_tpu_torch.serve.sampling import SamplingParams
from flexq_tpu_torch.serve.scheduler import BatchScheduler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_tp_ranks.py")
WORLD_TIMEOUT_S = 240
KW = dict(vocab_size=256, hidden_size=512, intermediate_size=1024, num_layers=2, num_heads=4, num_kv_heads=2,
          max_seq_len=512)
OPT_KW = dict(vocab_size=256, hidden_size=256, intermediate_size=512, num_layers=2, num_heads=4, max_seq_len=64)
DENSE_KW = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
                max_seq_len=64)  # tests/test_ring_attention.py's forward_sp model
PP_IDS = np.random.default_rng(3).integers(0, 256, (4, 6))
PP4_IDS = np.random.default_rng(4).integers(0, 256, (4, 5))
SP_IDS = np.random.default_rng(0).integers(0, 256, (2, 8))
GEN_IDS = np.random.default_rng(1).integers(0, 256, (2, 8))
INT8_IDS = np.random.default_rng(3).integers(0, 256, (1, 8))
TAIL_IDS = np.random.default_rng(2).integers(0, 256, (1, 4))
CHUNK_PROMPT = [int(x) for x in np.random.default_rng(0).integers(0, 256, 12)]
SCHED_REQS = [([3, 14, 15, 9], 6), ([7, 7], 4), ([100, 2, 30, 4], 5)]
INT8_CHUNK_PROMPT = [int(x) for x in np.random.default_rng(1).integers(0, 256, 10)]
SAMPLED = SamplingParams(greedy=False, temperature=0.9, top_k=20)
HTTP_REQS = [([3, 14, 15, 9], 5), ([7, 7], 4), ([5, 5, 5], 3)]
# serve_step_pp's calls: a 4-token prefill of PP_IDS[:2], then decode steps,
# the second at a start per slot
CACHE_CALLS = [dict(ids=torch.as_tensor(PP_IDS[:2, :4]), cache_pos=0),
               dict(ids=torch.tensor([[11], [40]]), cache_pos=4),
               dict(ids=torch.tensor([[97], [3]]), cache_pos=torch.tensor([5, 5]))]


def port_tree(jtree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree), device="cpu")


def opt_dense(seed):
    """A tiny pre-LN OPT in the reference's layout (biased linears, learned
    positions, LayerNorms, tied head), as tests/test_torch_parallel.py's."""
    rng = np.random.default_rng(seed)
    h, f, v = 256, 512, 256

    def lin(k, n):
        return {"w": rng.normal(0, 0.05, (k, n)).astype(np.float32), "b": rng.normal(0, 0.02, n).astype(np.float32)}

    def ln():
        return {"g": (1 + rng.normal(0, 0.02, h)).astype(np.float32), "b": rng.normal(0, 0.02, h).astype(np.float32)}

    layers = [{"input_norm": ln(), "post_norm": ln(), "q_proj": lin(h, h), "k_proj": lin(h, h), "v_proj": lin(h, h),
               "o_proj": lin(h, h), "fc1": lin(h, f), "fc2": lin(f, h)} for _ in range(2)]
    return {"embed": rng.normal(0, 0.05, (v, h)).astype(np.float32),
            "pos_embed": rng.normal(0, 0.02, (64 + 2, h)).astype(np.float32), "final_norm": ln(), "layers": layers}


@pytest.fixture(scope="module")
def trees():
    """name -> (reference cfg, port cfg, (reference policy, port policy),
    reference tree, port tree): the GQA llama_flex model, its layers twice
    (4 layers, as tests/test_parallel.py::test_pipeline_four_stages), a
    tiny OPT under opt_flex(8, 8) and the dense f32 model of forward_sp."""
    out = {}
    flex = (JQuantPolicy.llama_flex(), QuantPolicy.llama_flex())
    jcfg, cfg = JModelConfig.llama(**KW), ModelConfig.llama(**KW)
    jq = j_quantize_params(init_params(jcfg, seed=0), jcfg, flex[0], dtype=jnp.float32)
    out["llama"] = (jcfg, cfg, flex, jq, port_tree(jq))
    jq4 = dict(jq, layers=jq["layers"] * 2)
    out["llama4"] = (dataclasses.replace(jcfg, num_layers=4), dataclasses.replace(cfg, num_layers=4), flex, jq4,
                     port_tree(jq4))
    opt = (JQuantPolicy.opt_flex(8, 8), QuantPolicy.opt_flex(8, 8))
    jcfg_o = JModelConfig.opt(**OPT_KW)
    jq = j_quantize_params(opt_dense(6), jcfg_o, opt[0], dtype=jnp.float32)
    out["opt"] = (jcfg_o, ModelConfig.opt(**OPT_KW), opt, jq, port_tree(jq))
    jcfg_d = JModelConfig.llama(**DENSE_KW)
    dense = jax.tree_util.tree_map(np.asarray, init_params(jcfg_d, seed=0))
    out["dense"] = (jcfg_d, ModelConfig.llama(**DENSE_KW), None, dense, params_from_numpy(dense, device="cpu"))
    return out


class World:
    """A gloo world of ``n`` tests/torch_tp_ranks.py ranks started in the
    background; ``results()`` waits for it (a rank that fails or outlives
    the timeout fails it, and every rank still running is killed)."""

    def __init__(self, wd, n, cases):
        os.makedirs(wd)
        self.wd, self.n = wd, n
        torch.save({"world": n, "cases": cases, "timeout_s": WORLD_TIMEOUT_S}, os.path.join(wd, "job.pt"))
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1",
                   JAX_PLATFORMS="cpu")
        self.logs = [open(os.path.join(wd, f"log{r}"), "w") for r in range(n)]
        self.procs = [subprocess.Popen([sys.executable, WORKER, wd, str(r)], cwd=ROOT, env=env, stdout=self.logs[r],
                                       stderr=subprocess.STDOUT) for r in range(n)]
        self.deadline = time.monotonic() + WORLD_TIMEOUT_S
        self.out = None

    def results(self):
        if self.out is not None:
            return self.out
        try:
            while any(p.poll() is None for p in self.procs) and time.monotonic() < self.deadline:
                if any(p.poll() not in (None, 0) for p in self.procs):
                    break  # one rank failed: the others would wait on it
                time.sleep(0.2)
        finally:
            self.stop()
        rcs = [p.returncode for p in self.procs]
        if rcs != [0] * self.n:
            tails = []
            for r in range(self.n):
                with open(os.path.join(self.wd, f"log{r}")) as f:
                    tails.append(f"rank {r} (exit {rcs[r]}):\n" + f.read()[-3000:])
            pytest.fail(f"world of {self.n} failed:\n" + "\n".join(tails))
        self.out = [torch.load(os.path.join(self.wd, f"out{r}.pt"), weights_only=False) for r in range(self.n)]
        return self.out

    def stop(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in self.logs:
            f.close()


def model(trees, name):
    _, cfg, (_, pol), _, tq = trees[name]
    return dict(tree=tq, cfg=cfg, policy=pol)


def one_engine(trees, name, **kw):
    _, cfg, (_, pol), _, tq = trees[name]
    return Engine(tq, cfg, pol, device="cpu", **kw)


def greedy(prompts, new, **kw):
    return dict(prompt_ids=prompts, max_new_tokens=new, eos_id=-1, **kw)


ENGINE_RUNS = [  # (Engine keywords, generate keywords) of the pp = 2 world, after tests/test_pp_serving.py
    (dict(max_seq_len=128, kv_dtype="f32"), greedy([[1, 5, 9, 2]], 6)),
    (dict(max_seq_len=128, kv_dtype="int8"), greedy([[1, 5, 9, 2], [7, 7, 3, 1]], 5)),
    (dict(max_seq_len=128, kv_dtype="f32", prefill_chunk=4), greedy([CHUNK_PROMPT], 4)),
    (dict(max_seq_len=128, kv_dtype="f32"), greedy([[1, 5, 9]], 5, sampling=SAMPLED, seed=7, return_logprobs=True)),
]
SCHED_RUNS = [(dict(num_slots=2, max_seq_len=128, kv_dtype="f32"), SCHED_REQS),
              (dict(num_slots=2, max_seq_len=128, kv_dtype="int8", prefill_chunk=4), [(INT8_CHUNK_PROMPT, 5)])]


@pytest.fixture(scope="module")
def worlds(trees, tmp_path_factory):
    """The two worlds, started together: "two" (pp = 2 and sp = 2), "four"
    (pp = 4 and sp = 4)."""
    root = tmp_path_factory.mktemp("pp_sp")
    llama, opt = model(trees, "llama"), model(trees, "opt")
    rng = np.random.default_rng(0)
    q = torch.as_tensor(rng.standard_normal((2, 32, 4, 16)), dtype=torch.float32)
    kv = [torch.as_tensor(rng.standard_normal((2, 32, 4 // g, 16)), dtype=torch.float32) for g in (1, 2) for _ in "kv"]
    two = {"pp_forward": ("pp_forward", dict(llama, ids=torch.as_tensor(PP_IDS), microbatches=2)),
           "pp_engine": ("pp_engine", dict(llama, runs=ENGINE_RUNS)),
           "pp_opt": ("pp_engine", dict(opt, runs=[(dict(max_seq_len=128, kv_dtype="f32"), greedy([[1, 5, 9, 2]], 5))])),
           "pp_sched": ("pp_sched", dict(llama, runs=SCHED_RUNS)),
           "sp_prefill": ("sp_prefill", dict(llama, ids=torch.as_tensor(SP_IDS))),
           "sp_tail": ("sp_tail", dict(llama, ids=torch.as_tensor(TAIL_IDS)))}
    for dtype in ("f32", "int8"):
        two[f"pp_cache_{dtype}"] = ("pp_cache", dict(llama, calls=CACHE_CALLS, dtype=dtype, batch=2))
    four = {"pp_forward": ("pp_forward", dict(model(trees, "llama4"), ids=torch.as_tensor(PP4_IDS), microbatches=4)),
            "pp_engine": ("pp_engine", dict(model(trees, "llama4"),
                                            runs=[(dict(max_seq_len=128, kv_dtype="f32"), greedy([[1, 5, 9]], 4))])),
            "ring1": ("ring", dict(q=q, k=kv[0], v=kv[1], groups=1)),
            "ring2": ("ring", dict(q=q, k=kv[2], v=kv[3], groups=2)),
            "sp_forward": ("sp_forward", dict(tree=trees["dense"][4], cfg=trees["dense"][1],
                                              ids=torch.as_tensor(SP_IDS.repeat(2, axis=1)))),
            "sp_prefill": ("sp_prefill", dict(llama, ids=torch.as_tensor(SP_IDS))),
            "sp_generate": ("sp_generate", dict(llama, ids=torch.as_tensor(GEN_IDS), new=5)),
            "sp_gen16": ("sp_generate", dict(llama, ids=torch.as_tensor(INT8_IDS), new=4)),
            "sp_gen8": ("sp_generate", dict(llama, ids=torch.as_tensor(INT8_IDS), new=4, dtype="int8"))}
    out = {"two": World(str(root / "two"), 2, two), "four": World(str(root / "four"), 4, four)}
    yield out
    for w in out.values():
        w.stop()


@pytest.fixture(scope="module")
def one_rank(trees):
    """The port's single-device runs the pp Engine and scheduler are held
    to (the port's single-device Engine and scheduler are held to the
    reference's by tests/test_torch_slice.py, test_torch_sched.py and
    test_torch_opt.py)."""
    _, cfg, (_, pol), _, tq = trees["llama"]
    out = {"engine": []}
    for ekw, gkw in ENGINE_RUNS:
        ekw = dict(ekw, kv_dtype=torch.int8 if ekw["kv_dtype"] == "int8" else torch.float32)
        out["engine"].append(one_engine(trees, "llama", **ekw).generate(mode="step", **gkw))
    out["opt"] = one_engine(trees, "opt", max_seq_len=128, kv_dtype=torch.float32).generate(
        mode="step", **greedy([[1, 5, 9, 2]], 5))
    out["engine4"] = one_engine(trees, "llama4", max_seq_len=128, kv_dtype=torch.float32).generate(
        mode="step", **greedy([[1, 5, 9]], 4))
    out["sched"] = []
    for kw, reqs in SCHED_RUNS:
        sched = BatchScheduler(tq, cfg, pol, device="cpu",
                               **dict(kw, kv_dtype=torch.int8 if kw["kv_dtype"] == "int8" else torch.float32))
        rids = [sched.add_request(p, max_new_tokens=n, eos_id=-1, logprobs=True) for p, n in reqs]
        got = sched.run()
        out["sched"].append(([got[r] for r in rids], [sched.done_logprobs[r] for r in rids]))
    return out


# ---- pipeline parallelism -------------------------------------------------------------


@pytest.mark.parametrize("world,name,ids,m", [("two", "llama", PP_IDS, 2), ("four", "llama4", PP4_IDS, 4)])
def test_forward_serve_pp_matches_the_reference(trees, worlds, world, name, ids, m):
    """tests/test_parallel.py::test_pipeline_parallel_matches_single_device
    and test_pipeline_four_stages: the GPipe forward (2 and 4 microbatches)
    within 2e-4 of the reference's single-device forward_serve, on every
    rank, and equal to the port's one-rank forward of each microbatch (the
    CPU's products may round a row differently at another batch size)."""
    jcfg, cfg, (jpol, pol), jq, tq = trees[name]
    want = np.asarray(j_forward_serve(jq, jcfg, jpol, jnp.asarray(ids))[0])
    one = torch.cat([forward_serve(tq, cfg, pol, torch.as_tensor(part), device="cpu")[0]
                     for part in np.split(ids, m)])
    for out in worlds[world].results():
        np.testing.assert_allclose(out["pp_forward"].numpy(), want, rtol=2e-4, atol=2e-4)
        assert torch.equal(out["pp_forward"], one)


def one_rank_cache(tq, cfg, pol, dtype):
    shape = (cfg.num_layers, 2, cfg.num_kv_heads, 128, cfg.head_dim)
    kv = [torch.zeros(shape, dtype=torch.int8 if dtype == "int8" else torch.float32) for _ in "kv"]
    scales = dict(zip(("kv_k_scale", "kv_v_scale"), [torch.zeros(shape[:-1]) for _ in "kv"])) if dtype == "int8" else {}
    out = []
    for c in CACHE_CALLS:
        ids, pos = c["ids"], c["cache_pos"]
        start = pos[:, None] if isinstance(pos, torch.Tensor) else torch.full((2, 1), pos)
        out.append(forward_serve(tq, cfg, pol, ids, positions=start + torch.arange(ids.shape[1]), kv_k=kv[0],
                                 kv_v=kv[1], cache_pos=pos, device="cpu", **scales)[0])
    return out


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_pp_cached_steps_equal_one_rank(trees, worlds, dtype):
    """tests/test_parallel.py::test_pp_decode_with_cache: serve_step_pp's
    prefill and decode steps over each stage's share of the cache (a
    scalar start, then a start per slot) equal the port's one-rank
    forward_serve over the whole cache on every rank (so within the
    reference test's 1e-5, argmax equal); the f32 prefill within 1e-5 of
    the reference's single-device prefill, argmax equal."""
    jcfg, cfg, (jpol, pol), jq, tq = trees["llama"]
    want = one_rank_cache(tq, cfg, pol, dtype)
    for out in worlds["two"].results():
        got = out[f"pp_cache_{dtype}"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    if dtype == "f32":
        shape = (2, 2, 2, 128, 128)
        ref = np.asarray(j_forward_serve(jq, jcfg, jpol, jnp.asarray(PP_IDS[:2, :4]), kv_k=jnp.zeros(shape),
                                         kv_v=jnp.zeros(shape), cache_pos=jnp.int32(0),
                                         mask=prefill_mask(4, 128))[0])
        got = want[0].numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        assert (got.argmax(-1) == ref.argmax(-1)).all()


def test_pp_engine_gives_the_reference_tokens(trees, worlds, one_rank):
    """tests/test_pp_serving.py's Engine cases at pp = 2: greedy f32 (equal
    to the reference's single-device Engine too), int8 cache, chunked
    prefill, and sampled with logprobs under one seed (tokens equal,
    logprobs within 1e-5); every rank returns the same."""
    jcfg, _, (jpol, _), jq, _ = trees["llama"]
    ref = JEngine(jq, jcfg, jpol, max_seq_len=128, kv_dtype=jnp.float32).generate(
        [[1, 5, 9, 2]], max_new_tokens=6, eos_id=-1, mode="step")
    for out in worlds["two"].results():
        got = out["pp_engine"]
        assert got[0] == ref == one_rank["engine"][0]
        assert got[1] == one_rank["engine"][1] and got[2] == one_rank["engine"][2]
        (toks, lps), (want, wlps) = got[3], one_rank["engine"][3]
        assert toks == want
        np.testing.assert_allclose(lps, wlps, rtol=1e-4, atol=1e-5)


def test_pp_engine_opt_and_four_stages(worlds, one_rank):
    """test_engine_generate_pp_opt (pp = 2) and test_engine_generate_pp4
    (one layer a stage)."""
    for out in worlds["two"].results():
        assert out["pp_opt"][0] == one_rank["opt"]
    for out in worlds["four"].results():
        assert out["pp_engine"][0] == one_rank["engine4"]


@pytest.mark.parametrize("run", [0, 1])
def test_pp_scheduler_equals_one_device(worlds, one_rank, run):
    """test_scheduler_pp_matches_single_device (dense f32, three requests
    over two slots) and test_scheduler_pp_int8_chunked (int8, chunks of 4,
    logprobs within 1e-5)."""
    want, wlps = one_rank["sched"][run]
    for out in worlds["two"].results():
        got, glps = out["pp_sched"][run]
        assert got == want
        np.testing.assert_allclose(np.concatenate(glps), np.concatenate(wlps), rtol=1e-4, atol=1e-5)


def pp_mesh(pp=2):
    return PipeMesh(pp=pp, rank=0, device=torch.device("cpu"), backend="gloo", group=None)


def test_pp_refusals(trees):
    """OPT in forward_serve_pp, layers that do not split over the stages,
    a pp_mesh with a mesh, spec decoding under pp, and a paged pool, a
    prefix cache or fused ticks in the pipelined scheduler."""
    from flexq_tpu_torch.parallel import forward_serve_pp

    _, cfg, (_, pol), _, tq = trees["llama"]
    _, ocfg, (_, opol), _, otq = trees["opt"]
    with pytest.raises(ValueError, match="LLaMA"):
        forward_serve_pp(otq, ocfg, opol, torch.as_tensor(PP_IDS), pp_mesh())
    with pytest.raises(ValueError, match="split"):
        Engine(tq, cfg, pol, max_seq_len=128, pp_mesh=pp_mesh(3))
    mesh = Mesh(tp=2, dp=1, rank=0, device=torch.device("cpu"), backend="gloo", model_group=None, data_group=None)
    with pytest.raises(ValueError, match="exclusive"):
        Engine(tq, cfg, pol, max_seq_len=128, pp_mesh=pp_mesh(), mesh=mesh)
    eng = Engine(tq, cfg, pol, max_seq_len=128, pp_mesh=pp_mesh())
    assert len(eng.params["layers"]) == 1 and eng.new_cache(2)[0].shape[0] == 1
    with pytest.raises(ValueError, match="spec"):
        eng.generate([[1, 5, 9, 2]], max_new_tokens=2, mode="spec")
    for kw in (dict(paged=True), dict(paged=True, prefix_cache=True), dict(fused_tick=4), dict(mesh=mesh)):
        with pytest.raises(ValueError):
            BatchScheduler(tq, cfg, pol, num_slots=2, max_seq_len=128, pp_mesh=pp_mesh(), **kw)


# ---- ring attention and sequence-parallel serving -------------------------------------------


@pytest.mark.parametrize("groups", [1, 2])
def test_ring_attention_matches_the_reference(worlds, groups):
    """tests/test_ring_attention.py::test_ring_attention_matches_core at
    sp = 4: the ranks' chunks within 2e-5 of the reference's
    attention_core under its causal mask."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
    kv = [rng.standard_normal((2, 32, 4 // g, 16)).astype(np.float32) for g in (1, 2) for _ in "kv"]
    k, v = kv[2 * (groups - 1)], kv[2 * (groups - 1) + 1]
    want = np.asarray(j_attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), j_causal_mask(32, 32), groups))
    got = torch.cat([out[f"ring{groups}"] for out in worlds["four"].results()], dim=1).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_forward_sp_matches_the_reference(trees, worlds):
    """test_forward_sp_matches_dense at sp = 4: within 3e-4 of the
    reference's dense forward, on every rank."""
    jcfg, _, _, dense, _ = trees["dense"]
    ids = SP_IDS.repeat(2, axis=1)
    want = np.asarray(j_dense_forward(dense, jcfg, jnp.asarray(ids)))
    for out in worlds["four"].results():
        np.testing.assert_allclose(out["sp_forward"].numpy(), want, rtol=3e-4, atol=3e-4)


@pytest.fixture(scope="module")
def reference_sp(trees):
    """The reference's single-device W6A16 prefill logits of SP_IDS and its
    greedy generation of GEN_IDS (tests/test_sp_serve.py's
    _reference_generate: the W6A16 prefill, then W6Ax decode steps over a
    bf16 cache)."""
    jcfg, _, (jpol, _), jq, _ = trees["llama"]
    prefill = np.asarray(j_forward_serve(jq, jcfg, jpol, jnp.asarray(SP_IDS), prefill_bf16=True)[0][:, -1])
    ids = jnp.asarray(GEN_IDS, jnp.int32)
    b, l, maxlen = 2, 8, 32
    shape = (jcfg.num_layers, b, jcfg.num_kv_heads, maxlen, jcfg.head_dim)
    kv_k, kv_v = jnp.zeros(shape, jnp.bfloat16), jnp.zeros(shape, jnp.bfloat16)
    logits, (kv_k, kv_v) = j_forward_serve(jq, jcfg, jpol, ids, kv_k=kv_k, kv_v=kv_v, cache_pos=jnp.int32(0),
                                           mask=prefill_mask(l, maxlen), prefill_bf16=True)
    toks, logs = [], [np.asarray(logits[:, -1])]
    cur = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    for t in range(5):
        toks.append(np.asarray(cur)[:, 0])
        if t == 4:
            break
        pos = l + t
        logits, (kv_k, kv_v) = j_forward_serve(jq, jcfg, jpol, cur, kv_k=kv_k, kv_v=kv_v, cache_pos=jnp.int32(pos),
                                               mask=decode_mask(jnp.int32(pos), maxlen),
                                               positions=jnp.full((b, 1), pos, jnp.int32))
        logs.append(np.asarray(logits[:, -1]))
        cur = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    return prefill, np.stack(toks, axis=1), np.stack(logs, axis=1)


@pytest.mark.parametrize("world", ["two", "four"])
def test_sp_prefill_matches_the_reference(trees, worlds, reference_sp, world):
    """test_sp_prefill_logits_match_single_device at sp = 2 and 4: rtol
    2e-3 / atol 2e-2 of the reference's W6A16 prefill, argmax >= 0.95, the
    same logits on every rank; each rank's cache chunk is L/sp long."""
    _, cfg, _, _, _ = trees["llama"]
    want = reference_sp[0]
    outs = worlds[world].results()
    for out in outs:
        got, shapes = out["sp_prefill"]
        assert torch.equal(got, outs[0]["sp_prefill"][0])
        got = got.numpy()
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-2)
        assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.95
        assert shapes == [(cfg.num_layers, 2, cfg.num_kv_heads, 8 // len(outs), cfg.head_dim)] * 2


def test_generate_sp_matches_the_reference(worlds, reference_sp):
    """test_sp_generate_matches_single_device at sp = 4, at its bounds: the
    step-0 logits rtol 2e-3 / atol 3e-2 (> 95 % within 2e-2), the whole
    trajectory rtol 5e-3 / atol 1.2e-1 (> 75 % within 2e-2), tokens equal
    on >= 80 % of the steps."""
    _, want_toks, want_logs = reference_sp
    for out in worlds["four"].results():
        got_toks, got_logs = out["sp_generate"]
        np.testing.assert_allclose(got_logs[:, 0], want_logs[:, 0], rtol=2e-3, atol=3e-2)
        np.testing.assert_allclose(got_logs, want_logs, rtol=5e-3, atol=1.2e-1)
        assert np.isclose(got_logs[:, 0], want_logs[:, 0], rtol=2e-3, atol=2e-2).mean() > 0.95
        assert np.isclose(got_logs, want_logs, rtol=2e-3, atol=2e-2).mean() > 0.75
        assert (got_toks == want_toks).mean() >= 0.8, (got_toks, want_toks)


def test_sp_tail_is_attended(worlds):
    """test_sp_decode_step_tail_attention at sp = 2: different tokens at
    step 0 give different logits, and step 1's logits depend on step 0's
    token (the replicated tail is folded in)."""
    for out in worlds["two"].results():
        la, lb, l2a, l2b = out["sp_tail"]
        assert not torch.allclose(la, lb)
        assert not torch.allclose(l2a, l2b)


def test_sp_int8_prompt_cache_tracks_bf16(worlds):
    """test_sp_int8_prompt_cache_matches_bf16 at sp = 4: the prefill's logits
    within 1e-4 (the cache's precision enters only at decode), the decode
    steps within rtol 5e-2 / atol 2e-1, tokens equal on >= 75 %."""
    for out in worlds["four"].results():
        t16, l16 = out["sp_gen16"]
        t8, l8 = out["sp_gen8"]
        np.testing.assert_allclose(l8[:, 0], l16[:, 0], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(l8, l16, rtol=5e-2, atol=2e-1)
        assert (t8 == t16).mean() >= 0.75


def test_sp_refusals(trees):
    """sp serving's _check: OPT, a fuse=True tree, a sliding window; and a
    prompt that does not split over the ring."""
    _, cfg, (_, pol), _, tq = trees["llama"]
    _, ocfg, (_, opol), _, otq = trees["opt"]
    mesh = SeqMesh(sp=2, rank=0, device=torch.device("cpu"), backend="gloo", group=None)
    ids = torch.as_tensor(SP_IDS)
    with pytest.raises(ValueError, match="LLaMA"):
        sp_prefill(otq, ocfg, opol, ids, mesh)
    fused = dict(tq, layers=[dict(lp, qkv_proj=lp["q_proj"]) for lp in tq["layers"]])
    with pytest.raises(ValueError, match="unfused"):
        sp_prefill(fused, cfg, pol, ids, mesh)
    with pytest.raises(NotImplementedError):
        sp_prefill(tq, dataclasses.replace(cfg, sliding_window=4), pol, ids, mesh)
    with pytest.raises(ValueError, match="divide"):
        sp_prefill(tq, cfg, pol, ids[:, :7], mesh)


# ---- serve.http --pp 2 ---------------------------------------------------------------


def test_http_pp2_leader_and_follower(trees, worlds, tmp_path):
    """``serve.http --pp 2`` over a packed checkpoint (the port's exporter on
    an HF directory of the GQA model's dense weights), one process a stage
    (gloo, a file:// rendezvous, --replication-port 0): rank 0 serves HTTP
    over a leader ReplicatedScheduler, rank 1 follows; the completions equal
    a direct run over the same checkpoint, and that run's tokens are the
    pp = 2 scheduler's (the pipeline equals one device, above). SIGINT to
    rank 0 stops both."""
    from test_torch_parallel import write_hf

    from flexq_tpu_torch.export.exporter import load_packed

    jcfg, cfg, _, _, _ = trees["llama"]
    write_hf(str(tmp_path / "hf"), cfg, jax.tree_util.tree_map(np.asarray, init_params(jcfg, seed=0)))
    export_checkpoint(str(tmp_path / "hf"), str(tmp_path / "packed"), device="cpu")
    pcfg, ppol, tree = load_packed(str(tmp_path / "packed"), device="cpu")
    sched = BatchScheduler(tree, pcfg, ppol, num_slots=2, max_seq_len=256, device="cpu")
    rids = [sched.add_request(p, max_new_tokens=n, eos_id=-1) for p, n in HTTP_REQS]
    done = sched.run()
    want = [done[r] for r in rids]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "flexq_tpu_torch.serve.http", "--checkpoint", str(tmp_path / "packed"), "--pp", "2",
           "--device", "cpu", "--coordinator", f"file://{tmp_path / 'store'}", "--num-processes", "2",
           "--replication-port", "0", "--slots", "2", "--max-seq-len", "256", "--host", "127.0.0.1", "--port", "0"]
    logs = [tmp_path / f"log{r}" for r in range(2)]
    procs = [subprocess.Popen(cmd + ["--process-id", str(r)], cwd=ROOT, env=env, stdout=open(logs[r], "w"),
                              stderr=subprocess.STDOUT) for r in range(2)]
    try:
        port, deadline = None, time.monotonic() + WORLD_TIMEOUT_S
        while port is None and time.monotonic() < deadline and all(p.poll() is None for p in procs):
            time.sleep(0.2)
            port = next((int(line.split(":")[1].split()[0]) for line in logs[0].read_text().splitlines()
                         if line.startswith("serving on")), None)
        assert port is not None, logs[0].read_text()[-2000:] + logs[1].read_text()[-2000:]
        got = []
        for prompt, n in HTTP_REQS:
            body = json.dumps({"prompt_ids": prompt, "max_new_tokens": n, "eos_id": -1}).encode()
            req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=body,
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                got.append(json.loads(r.read())["tokens"])
        procs[0].send_signal(signal.SIGINT)
        assert [p.wait(60) for p in procs] == [0, 0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert got == want
