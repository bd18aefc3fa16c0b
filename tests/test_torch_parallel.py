"""Tensor- and data-parallel serving of the port vs flexq_tpu on the CPU.

The reference's tiny config (tests/test_parallel.py: hidden 512, FFN 1024,
4 heads of 128, 2 layers, vocab 256, f32), its weights drawn by
``flexq_tpu.train.trainer.init_params`` and quantized by the reference. The
JAX side runs in this process on the 8-device CPU mesh of conftest.py; the
port's ranks are processes of a gloo world (tests/torch_tp_ranks.py, which
imports only flexq_tpu_torch) joined through a ``file://`` store under
tmp_path, each world started once a module with a timeout that kills every
rank of it, running many cases.

Held: ``shard_params`` per rank bit-equal to the shard the reference's
places on the device at that model index (llama_flex, a packed head, W4,
W8, OPT with biases); ``forward_serve_tp`` at (tp, dp) = (2, 1) and (2, 2)
against ``flexq_tpu.parallel.forward_serve_tp`` at the reference test's
tolerance (95 % within 2e-4; all within rtol 2e-3 / atol 2e-2; argmax
>= 0.95) and against the port's single-rank forward within 1e-5 (the only
difference: the two halves of each row-parallel K sum in f32 before their
all-reduce); GQA, replicate_kv_heads, the int8 and paged caches, a packed
head, OPT and W4A16 against the single-rank forward; the Engine's fused
and step loops and the scheduler (dense, paged, int8, prefix cache, dense
at dp = 2) giving the reference's single-device tokens, as the reference's
TP tests require; the paged scheduler at tp = 2 x dp = 2 (a pool partition
a data rank) equal to the dense one, every partition drained, and its int8
fused ticks equal to its per-token ticks (the reference's
test_paged_scheduler_dp2*), PagePool's partitions against the reference's;
a biased LLaMA at tp = 2 equal to the single-rank forward, where the reference's TP forward adds its row-parallel biases
once a rank; the ``--tp 2`` export byte-identical to the reference's and
``load_packed_sharded``; a two-process ReplicatedScheduler equal to one
scheduler.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexq_tpu.config import ModelConfig as JModelConfig, QuantPolicy as JQuantPolicy
from flexq_tpu.export.exporter import export_checkpoint as j_export_checkpoint
from flexq_tpu.models.quantized import forward_serve as j_forward_serve, quantize_params as j_quantize_params
from flexq_tpu.parallel import forward_serve_tp as j_forward_serve_tp, make_mesh as j_make_mesh
from flexq_tpu.parallel import shard_params as j_shard_params
from flexq_tpu.parallel.tp import replicate_kv_heads as j_replicate_kv_heads
from flexq_tpu.serve.engine import Engine as JEngine
from flexq_tpu.serve.sampling import SamplingParams as JSamplingParams
from flexq_tpu.serve.scheduler import BatchScheduler as JBatchScheduler
from flexq_tpu.train.trainer import init_params
from flexq_tpu_torch.config import ModelConfig, QuantPolicy
from flexq_tpu_torch.convert import params_from_numpy
from flexq_tpu_torch.export import safetensors_io
from flexq_tpu_torch.export.exporter import export_checkpoint, load_packed, load_packed_sharded
from flexq_tpu_torch.models.quantized import forward_serve, quantize_params
from flexq_tpu_torch.parallel import Mesh
from flexq_tpu_torch.parallel.tp import replicate_kv_heads, shard_params
from flexq_tpu_torch.serve.engine import Engine
from flexq_tpu_torch.serve.scheduler import BatchScheduler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_tp_ranks.py")
WORLD_TIMEOUT_S = 240
KW = dict(vocab_size=256, hidden_size=512, intermediate_size=1024, num_layers=2, num_heads=4, max_seq_len=512)
IDS = np.random.default_rng(0).integers(0, 256, (2, 6))
PROMPTS = [[3, 14, 15, 9, 2, 6], [7, 7, 7, 7, 7, 7]]
DP_PROMPTS = [[3, 14, 15, 9], [7, 7, 7, 7], [1, 2, 3, 4], [9, 9, 1, 1]]
REQS = [([3, 14, 15, 9], 5), ([7, 7], 4)]
DP_REQS = [([3, 14, 15, 9], 6), ([7, 7], 4), ([100, 2, 30, 4], 5), ([5, 5, 5], 3)]  # test_paged_scheduler_dp2's
DP_INT8_REQS = [([3, 14, 15, 9], 5), ([7, 7], 5)]
PREFIX = np.random.default_rng(4).integers(0, 256, 256).tolist()
PREFIX_REQS = [(PREFIX + [1, 2], 3), (PREFIX + [8], 3)]
SPEC_PROMPT = [[3, 14, 15, 9, 2, 6, 5, 3]]
BEAM_PROMPTS = [[3, 14, 15, 9], [7, 7, 1, 2]]
DECODE = [[11], [40], [97]]  # the tokens fed to the decode steps after a 4-token prefill


def to_np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_tree(jtree):
    return params_from_numpy(to_np_tree(jtree), device="cpu")


def leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def as_np(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def models():
    """name -> (reference cfg, port cfg, reference dense tree, policies)."""
    out = {}
    for name, kvh in (("mha", 4), ("gqa", 2), ("kv1", 1)):
        jcfg = JModelConfig.llama(num_kv_heads=kvh, **KW)
        out[name] = (jcfg, ModelConfig.llama(num_kv_heads=kvh, **KW), init_params(jcfg, seed=0))
    jcfg = JModelConfig.llama(num_kv_heads=4, **dict(KW, vocab_size=250))
    out["v250"] = (jcfg, ModelConfig.llama(num_kv_heads=4, **dict(KW, vocab_size=250)), init_params(jcfg, seed=1))
    return out


def biased(dense, seed):
    """The dense tree with a bias on every linear (LLaMA's attention_bias
    and mlp_bias)."""
    rng = np.random.default_rng(seed)
    out = dict(dense, layers=[])
    for lp in dense["layers"]:
        lp = dict(lp)
        for n in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"):
            w = lp[n]["w"]
            lp[n] = {"w": w, "b": jnp.asarray(rng.normal(0, 0.05, (w.shape[1],)), jnp.float32)}
        out["layers"].append(lp)
    return out


def opt_dense(seed):
    """A tiny pre-LN OPT in the reference's layout (biased linears, learned
    positions, LayerNorms, tied head)."""
    rng = np.random.default_rng(seed)
    h, f, v = 256, 512, 256

    def lin(k, n):
        return {"w": rng.normal(0, 0.02, (k, n)).astype(np.float32), "b": rng.normal(0, 0.02, n).astype(np.float32)}

    def ln():
        return {"g": (1 + rng.normal(0, 0.02, h)).astype(np.float32), "b": rng.normal(0, 0.02, h).astype(np.float32)}

    layers = [{"input_norm": ln(), "post_norm": ln(), "q_proj": lin(h, h), "k_proj": lin(h, h), "v_proj": lin(h, h),
               "o_proj": lin(h, h), "fc1": lin(h, f), "fc2": lin(f, h)} for _ in range(2)]
    return {"embed": rng.normal(0, 0.02, (v, h)).astype(np.float32),
            "pos_embed": rng.normal(0, 0.02, (64 + 2, h)).astype(np.float32), "final_norm": ln(), "layers": layers}


OPT_KW = dict(vocab_size=256, hidden_size=256, intermediate_size=512, num_layers=2, num_heads=4, max_seq_len=64)


def write_hf(d, cfg, dense):
    """An HF-layout LLaMA directory of the dense tree's weights."""
    import json

    from flexq_tpu_torch.models.hf_loader import HF_LLAMA_LINEARS, HF_LLAMA_NORMS

    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"model_type": "llama", "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
                   "intermediate_size": cfg.intermediate_size, "num_hidden_layers": cfg.num_layers,
                   "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_kv_heads,
                   "max_position_embeddings": cfg.max_seq_len, "rms_norm_eps": cfg.norm_eps,
                   "rope_theta": cfg.rope_theta, "tie_word_embeddings": False}, f)
    t = {}
    for i, lp in enumerate(dense["layers"]):
        for n, hf in HF_LLAMA_LINEARS.items():
            t[f"model.layers.{i}.{hf}.weight"] = torch.from_numpy(np.asarray(lp[n]["w"]).T.copy())
        for n, hf in HF_LLAMA_NORMS.items():
            t[f"model.layers.{i}.{hf}.weight"] = torch.from_numpy(np.asarray(lp[n]).copy())
    t["model.embed_tokens.weight"] = torch.from_numpy(np.asarray(dense["embed"]).copy())
    t["model.norm.weight"] = torch.from_numpy(np.asarray(dense["final_norm"]).copy())
    t["lm_head.weight"] = torch.from_numpy(np.asarray(dense["lm_head"]).T.copy())
    safetensors_io.save_file(t, os.path.join(d, "model.safetensors"), metadata={"format": "pt"})


def run_world(wd, tp, dp, cases):
    """Run ``cases`` on a world of tp * dp ranks (tests/torch_tp_ranks.py);
    every rank's results. A rank that fails or outlives the timeout fails
    the world, and every rank still running is killed."""
    os.makedirs(wd)
    torch.save({"tp": tp, "dp": dp, "cases": cases, "timeout_s": WORLD_TIMEOUT_S}, os.path.join(wd, "job.pt"))
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    logs = [open(os.path.join(wd, f"log{r}"), "w") for r in range(tp * dp)]
    procs = [subprocess.Popen([sys.executable, WORKER, wd, str(r)], cwd=ROOT, env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(tp * dp)]
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.poll() not in (None, 0) for p in procs):
                break  # one rank failed: the others would wait on it
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    rcs = [p.returncode for p in procs]
    if rcs != [0] * len(procs):
        tails = []
        for r in range(tp * dp):
            with open(os.path.join(wd, f"log{r}")) as f:
                tails.append(f"rank {r} (exit {rcs[r]}):\n" + f.read()[-3000:])
        pytest.fail(f"world tp={tp} dp={dp} failed:\n" + "\n".join(tails))
    return [torch.load(os.path.join(wd, f"out{r}.pt"), weights_only=False) for r in range(tp * dp)]


@pytest.fixture(scope="module")
def trees():
    """name -> (reference cfg, port cfg, policy pair, reference quantized tree,
    port tree (the same values))."""
    out = {}
    ms = models()
    flex = (JQuantPolicy.llama_flex(), QuantPolicy.llama_flex())
    for name, (jcfg, cfg, dense) in ms.items():
        if name == "v250":
            pols = (JQuantPolicy.llama_flex().with_head(6, 8), QuantPolicy.llama_flex().with_head(6, 8))
            name = "head"
        else:
            pols = flex
        jq = j_quantize_params(dense, jcfg, pols[0], dtype=jnp.float32)
        out[name] = (jcfg, cfg, pols, jq, port_tree(jq))
    jcfg, cfg, dense = ms["mha"]
    for name, pols in (("w4", (JQuantPolicy.weight_only("llama", 4), QuantPolicy.weight_only("llama", 4))),
                       ("w8", (JQuantPolicy.uniform("llama", 8, 8), QuantPolicy.uniform("llama", 8, 8)))):
        jq = j_quantize_params(dense, jcfg, pols[0], dtype=jnp.float32)
        out[name] = (jcfg, cfg, pols, jq, port_tree(jq))
    jq = j_quantize_params(biased(dense, 5), jcfg, flex[0], dtype=jnp.float32)
    out["bias"] = (jcfg, cfg, flex, jq, port_tree(jq))
    jcfg_o, cfg_o = JModelConfig.opt(**OPT_KW), ModelConfig.opt(**OPT_KW)
    for name, pols in (("opt", (JQuantPolicy.opt_flex(8, 8), QuantPolicy.opt_flex(8, 8))),
                       ("opt_w4", (JQuantPolicy.weight_only("opt", 4), QuantPolicy.weight_only("opt", 4)))):
        jq = j_quantize_params(opt_dense(6), jcfg_o, pols[0], dtype=jnp.float32)
        out[name] = (jcfg_o, cfg_o, pols, jq, port_tree(jq))
    # replicate_kv_heads on the 1-kv-head model: the port's and the reference's dense trees
    jcfg1, cfg1, dense1 = ms["kv1"]
    jx, jxcfg = j_replicate_kv_heads(dense1, jcfg1, 2)
    tx, txcfg = replicate_kv_heads(params_from_numpy(to_np_tree(dense1), device="cpu"), cfg1, 2)
    jq = j_quantize_params(jx, jxcfg, flex[0], dtype=jnp.float32)
    out["kvrep"] = (jxcfg, txcfg, flex, jq, quantize_params(tx, txcfg, flex[1], dtype=torch.float32, device="cpu"))
    out["kvrep_dense"] = (jx, tx)
    return out


def single(trees, name, ids, **kw):
    """The port's single-rank forward_serve logits."""
    _, cfg, (_, pol), _, tq = trees[name]
    return forward_serve(tq, cfg, pol, torch.as_tensor(ids), device="cpu", **kw)[0]


def cache_calls(b, kind, dtype, table=None):
    """The calls and the cache spec of a cached ``forward`` case: over a
    dense cache a 4-token prefill of IDS[:b, :4], then the DECODE steps; a
    page pool is decode-only (the scheduler fills it from a dense scratch),
    so over it the DECODE steps from position 0, each row at its own
    position tensor."""
    start = 0 if kind == "paged" else 4
    calls = [] if kind == "paged" else [dict(ids=torch.as_tensor(IDS[:b, :4]), cache_pos=0)]
    for t, tok in enumerate(DECODE):
        pos = torch.full((b,), start + t, dtype=torch.int64)
        calls.append(dict(ids=torch.tensor([tok] * b), cache_pos=pos if kind == "paged" else start + t,
                          positions=pos[:, None]))
    spec = dict(kind=kind, batch=b, maxlen=128, dtype=dtype)
    if kind == "paged":
        spec.update(npages=2 * b + 1, table=table)
    return calls, spec


def forward_case(trees, name, ids=None, calls=None, cache=None):
    _, cfg, (_, pol), _, tq = trees[name]
    if calls is None:
        calls = [dict(ids=torch.as_tensor(IDS[:1] if ids is None else ids))]
    return ("forward", dict(tree=tq, cfg=cfg, policy=pol, calls=calls, cache=cache))


@pytest.fixture(scope="module")
def export_dirs(trees, tmp_path_factory):
    """The reference's and the port's ``--tp 2`` exports (and the port's
    tp = 1 export) of an HF directory of the mha model's dense weights."""
    d = tmp_path_factory.mktemp("export")
    jcfg, cfg, dense = models()["mha"]
    write_hf(str(d / "hf"), cfg, dense)
    # the reference's NumPy quantizer (w / scale, as its quantize_params and
    # the port's): its optional native library multiplies by 1 / scale,
    # which rounds an exact .5 tie of these weights the other way
    with mock.patch("flexq_tpu.export.native.get_lib", return_value=None):
        j_export_checkpoint(str(d / "hf"), str(d / "jax_tp2"), tp=2)
    export_checkpoint(str(d / "hf"), str(d / "port_tp2"), tp=2, device="cpu")
    export_checkpoint(str(d / "hf"), str(d / "port_tp1"), device="cpu")
    return d


@pytest.fixture(scope="module")
def world_a(trees, export_dirs, tmp_path_factory):
    """Every tp = 2, dp = 1 case, one world of two ranks."""
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    cases = {f"shard_{n}": ("shard", dict(tree=trees[n][4])) for n in ("mha", "head", "w4", "w8", "opt", "bias")}
    cases.update({n: forward_case(trees, n) for n in ("mha", "gqa", "kvrep", "head", "w4", "opt", "opt_w4", "bias")})
    cases["mha2"] = forward_case(trees, "mha", ids=IDS)
    for kind, dtype in (("dense", "f32"), ("dense", "int8"), ("paged", "f32"), ("paged", "int8")):
        calls, spec = cache_calls(2, kind, dtype, table)
        cases[f"cache_{kind}_{dtype}"] = forward_case(trees, "mha", calls=calls, cache=spec)
    calls, spec = cache_calls(2, "dense", "f32")
    cases["cache_opt"] = forward_case(trees, "opt", calls=calls, cache=spec)
    _, cfg, (_, pol), _, tq = trees["mha"]
    model = dict(tree=tq, cfg=cfg, policy=pol)
    cases["engine"] = ("engine", dict(model, runs=[("f32", "fused", PROMPTS, 6), ("int8", "fused", PROMPTS, 6),
                                                   ("f32", "step", PROMPTS, 6), ("f32", "spec", SPEC_PROMPT, 8)]))
    base = dict(num_slots=2, max_seq_len=256)
    cases["sched"] = ("sched", dict(model, runs=[
        (base, REQS), (dict(base, paged=True), REQS), (dict(base, kv_dtype="int8"), REQS),
        (dict(base, paged=True, kv_dtype="int8"), REQS),
        (dict(num_slots=1, max_seq_len=512, paged=True), PREFIX_REQS),
        (dict(num_slots=1, max_seq_len=512, paged=True, prefix_cache=True), PREFIX_REQS),
        (dict(base, paged=True, kv_dtype="int8", fused_tick=3), REQS)]))
    cases["beam"] = ("beam", dict(model, prompts=BEAM_PROMPTS, width=3, new=6))
    cases["replicated"] = ("replicated", dict(model, kw=dict(num_slots=2, max_seq_len=256, paged=True),
                                              requests=REQS + [([5, 5, 5], 3)]))
    cases["export"] = ("export", dict(path=str(export_dirs / "port_tp2"), ids=torch.as_tensor(IDS[:1])))
    return run_world(str(tmp_path_factory.mktemp("worlds") / "a"), 2, 1, cases)


@pytest.fixture(scope="module")
def world_b(trees, tmp_path_factory):
    """The tp = 2, dp = 2 cases, one world of four ranks."""
    _, cfg, (_, pol), _, tq = trees["mha"]
    model = dict(tree=tq, cfg=cfg, policy=pol)
    cases = {"mha": forward_case(trees, "mha", ids=IDS),
             "mha1": forward_case(trees, "mha", ids=IDS[:1]),
             "engine": ("engine", dict(model, runs=[("f32", "fused", DP_PROMPTS, 4), ("f32", "step", DP_PROMPTS, 4)])),
             "sched": ("sched", dict(model, runs=[(dict(num_slots=2, max_seq_len=256), REQS)])),
             "sched_dp": ("sched", dict(model, runs=[
                 (dict(num_slots=4, max_seq_len=256), DP_REQS), (dict(num_slots=4, max_seq_len=256, paged=True), DP_REQS),
                 (dict(num_slots=2, max_seq_len=256, paged=True, kv_dtype="int8", fused_tick=3), DP_INT8_REQS),
                 (dict(num_slots=2, max_seq_len=256, paged=True, kv_dtype="int8"), DP_INT8_REQS)]))}
    calls, spec = cache_calls(2, "dense", "f32")
    cases["cache"] = forward_case(trees, "mha", calls=calls, cache=spec)
    return run_world(str(tmp_path_factory.mktemp("worlds") / "b"), 2, 2, cases)


@pytest.fixture(scope="module")
def reference_tokens(trees):
    """The greedy tokens the TP runs are held to: the reference's
    single-device Engine (fused loop, f32 cache) and scheduler (f32); over
    the int8 cache and for the dp prompts, the port's single-rank runs (the
    JAX programs' compiles would double this file's time; the port's
    single-rank Engine and scheduler are held to the reference's by
    tests/test_torch_slice.py, test_torch_prefill.py and test_torch_sched.py)."""
    jcfg, cfg, (jpol, pol), jq, tq = trees["mha"]
    eng = JEngine(jq, jcfg, jpol, max_seq_len=256, kv_dtype=jnp.float32)
    out = {("engine", "f32"): eng.generate(PROMPTS, max_new_tokens=6, eos_id=-1, mode="fused",
                                           sampling=JSamplingParams())}
    sched = JBatchScheduler(jq, jcfg, jpol, num_slots=2, max_seq_len=256, kv_dtype=jnp.float32)
    rids = [sched.add_request(p, max_new_tokens=n, eos_id=-1) for p, n in REQS]
    got = sched.run()
    out[("sched", "f32")] = [got[r] for r in rids]
    one = Engine(tq, cfg, pol, max_seq_len=256, kv_dtype=torch.int8, device="cpu")
    out[("engine", "int8")] = one.generate(PROMPTS, max_new_tokens=6, eos_id=-1)
    one = Engine(tq, cfg, pol, max_seq_len=256, kv_dtype=torch.float32, device="cpu")
    out["engine_dp"] = one.generate(DP_PROMPTS, max_new_tokens=4, eos_id=-1)
    sched = BatchScheduler(tq, cfg, pol, num_slots=2, max_seq_len=256, kv_dtype=torch.int8, device="cpu")
    rids = [sched.add_request(p, max_new_tokens=n, eos_id=-1) for p, n in REQS]
    got = sched.run()
    out[("sched", "int8")] = [got[r] for r in rids]
    return out


# ---- the split ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["mha", "head", "w4", "w8", "opt", "bias"])
def test_shard_params_equal_the_reference_shards(trees, world_a, name):
    jcfg, _, _, jq, _ = trees[name]
    mesh = j_make_mesh(tp=2, dp=1)
    jshard = j_shard_params(jq, mesh)
    for r in range(2):
        dev = mesh.devices[0, r]
        got, want = leaves(world_a[r][f"shard_{name}"]), leaves(jshard)
        assert [k for k, _ in got] == [k for k, _ in want]
        for (k, g), (_, w) in zip(got, want):
            w = next(np.asarray(s.data) for s in w.addressable_shards if s.device == dev)
            g = as_np(g)
            assert g.shape == w.shape and g.dtype.itemsize == w.dtype.itemsize, jax.tree_util.keystr(k)
            assert g.tobytes() == w.tobytes(), (r, jax.tree_util.keystr(k))


def test_replicate_kv_heads_matches_the_reference(trees):
    jx, tx = trees["kvrep_dense"]
    got, want = leaves(tx), leaves(to_np_tree(jx))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        assert np.array_equal(g.numpy(), w), jax.tree_util.keystr(k)


def test_fused_trees_are_refused_under_a_mesh(trees):
    jcfg, cfg, (_, pol), _, _ = trees["mha"]
    dense = params_from_numpy(to_np_tree(models()["mha"][2]), device="cpu")
    fused = quantize_params(dense, cfg, pol, dtype=torch.float32, fuse=True, device="cpu")
    mesh = Mesh(tp=2, dp=1, rank=0, device=torch.device("cpu"), backend="gloo", model_group=None, data_group=None)
    with pytest.raises(ValueError, match="fuse=True"):
        shard_params(fused, mesh)


# ---- forward_serve_tp ---------------------------------------------------------


def hold_reference_tolerance(got, want):
    """tests/test_parallel.py::test_tp_matches_single_device's tolerance."""
    close = np.isclose(got, want, rtol=2e-4, atol=2e-4)
    assert close.mean() > 0.95, f"only {close.mean():.3f} within 2e-4"
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-2)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.95


@pytest.mark.parametrize("tp,dp", [(2, 1), (2, 2)])
def test_forward_serve_tp_matches_the_reference(trees, world_a, world_b, tp, dp):
    """B = dp rows (tests/test_parallel.py::test_tp_matches_single_device)
    against flexq_tpu.parallel.forward_serve_tp at that test's tolerance."""
    jcfg, _, (jpol, _), jq, _ = trees["mha"]
    mesh = j_make_mesh(tp=tp, dp=dp)
    want = np.asarray(j_forward_serve_tp(j_shard_params(jq, mesh), jcfg, jpol, jnp.asarray(IDS[:dp]), mesh)[0])
    got = world_a[0]["mha"][0] if dp == 1 else world_b[0]["mha"][0]
    hold_reference_tolerance(got.numpy(), want)


@pytest.mark.parametrize("world,case,rows", [("a", "mha", 1), ("a", "mha2", 2), ("b", "mha", 2), ("b", "mha1", 1)])
def test_forward_serve_tp_equals_one_rank(trees, world_a, world_b, world, case, rows):
    """Every rank returns all rows' logits, within 1e-5 of the single-rank
    forward (at dp = 2 with B = 1 the batch runs data-replicated)."""
    want = single(trees, "mha", IDS[:rows])
    for out in world_a if world == "a" else world_b:
        torch.testing.assert_close(out[case][0], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["gqa", "head", "w4", "opt", "opt_w4", "bias"])
def test_forward_serve_tp_variants_equal_one_rank(trees, world_a, name):
    want = single(trees, name, IDS[:1])
    assert world_a[0][name][0].shape == want.shape
    for out in world_a:
        torch.testing.assert_close(out[name][0], want, rtol=1e-5, atol=1e-5)


def test_replicated_kv_heads_serve_the_unreplicated_model(trees, world_a):
    """tp = 2 over a 1-kv-head model through replicate_kv_heads: the
    reference test's 3e-3 against the unreplicated single-rank forward."""
    want = single(trees, "kv1", IDS[:1])
    torch.testing.assert_close(world_a[0]["kvrep"][0], want, rtol=3e-3, atol=3e-3)


def test_biased_llama_adds_row_biases_once(trees, world_a):
    """The port adds o_proj's and down_proj's biases after the all-reduce,
    so tp = 2 equals one rank (above) and the reference's single-device
    forward. The reference adds them inside each rank's linear, before its
    psum: its TP forward parts from its own single-device one."""
    jcfg, _, (jpol, _), jq, _ = trees["bias"]
    ids = jnp.asarray(IDS[:1])
    mesh = j_make_mesh(tp=2, dp=1)
    ref_tp = np.asarray(j_forward_serve_tp(j_shard_params(jq, mesh), jcfg, jpol, ids, mesh)[0])
    ref_one = np.asarray(j_forward_serve(jq, jcfg, jpol, ids)[0])
    fault = np.abs(ref_tp - ref_one).max()
    assert fault > 1e-2 * np.abs(ref_one).max()
    got = world_a[0]["bias"][0].numpy()
    hold_reference_tolerance(got, ref_one)
    assert np.abs(got - ref_one).max() < fault / 10


def cached_one_rank(trees, name, calls, b, dtype):
    """The single-rank forward over a dense cache through ``calls``."""
    _, cfg, (_, pol), _, tq = trees[name]
    shape = (cfg.num_layers, b, cfg.num_kv_heads, 128, cfg.head_dim)
    kv = [torch.zeros(shape, dtype=torch.int8 if dtype == "int8" else torch.float32) for _ in "kv"]
    if dtype == "int8":
        kv += [torch.zeros(shape[:-1]) for _ in "kv"]
    scales = dict(zip(("kv_k_scale", "kv_v_scale"), kv[2:]))
    out = []
    for c in calls:
        c = dict(c)
        out.append(forward_serve(tq, cfg, pol, c.pop("ids"), kv_k=kv[0], kv_v=kv[1], device="cpu", **scales, **c)[0])
    return out


@pytest.mark.parametrize("kind,dtype", [("dense", "f32"), ("dense", "int8"), ("paged", "f32"), ("paged", "int8")])
def test_cached_forward_equals_one_rank(trees, world_a, kind, dtype):
    """Over a tp = 2 cache of KVH/2 heads a rank (dense: a 4-token prefill
    and three decode steps; paged: three decode steps through the page
    table), every step within 1e-5 of the single-rank dense cache's over an
    f32 cache, and within the reference's cached-TP tolerance (2e-4,
    tests/test_parallel.py::test_tp_with_kv_cache) over an int8 one: the
    f32 difference of the split K sums can move a K/V value across an int8
    rounding boundary."""
    calls, _ = cache_calls(2, kind, dtype)
    want = cached_one_rank(trees, "mha", calls, 2, dtype)
    tol = 1e-5 if dtype == "f32" else 2e-4
    for out in world_a:
        got = out[f"cache_{kind}_{dtype}"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=tol, atol=tol)


def test_cached_opt_and_dp2_equal_one_rank(trees, world_a, world_b):
    """OPT's cached prefill and decode at tp = 2; the LLaMA's at tp = 2 x
    dp = 2, each data rank over its row of the cache."""
    calls, _ = cache_calls(2, "dense", "f32")
    for world, case, name in ((world_a, "cache_opt", "opt"), (world_b, "cache", "mha")):
        want = cached_one_rank(trees, name, calls, 2, "f32")
        for out in world:
            for g, w in zip(out[case], want):
                torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


# ---- the Engine and the scheduler ---------------------------------------------


def test_engine_loops_give_the_reference_tokens(world_a, reference_tokens):
    """tests/test_parallel.py::test_engine_fused_loop_tp_matches_single_device:
    the fused loop at tp = 2 gives the reference's single-device fused
    tokens (f32 cache; int8: the single-rank port's), and so does the step
    loop."""
    for out in world_a:
        fused32, fused8, step32, _ = out["engine"]
        assert fused32 == reference_tokens[("engine", "f32")]
        assert fused8 == reference_tokens[("engine", "int8")]
        assert step32 == reference_tokens[("engine", "f32")]


def test_engine_spec_tp_equals_one_rank(trees, world_a):
    """test_engine_spec_decode_tp_matches_single_device: speculative
    decoding at tp = 2 gives the single-rank spec tokens."""
    _, cfg, (_, pol), _, tq = trees["mha"]
    want = Engine(tq, cfg, pol, max_seq_len=256, kv_dtype=torch.float32, device="cpu").generate(
        SPEC_PROMPT, max_new_tokens=8, eos_id=-1, mode="spec")
    for out in world_a:
        assert out["engine"][3] == want


def test_engine_tp_dp_gives_the_reference_tokens(world_b, reference_tokens):
    """test_engine_fused_loop_tp_dp: B = 4 over tp = 2 x dp = 2, fused and
    step; every rank returns all four rows."""
    for out in world_b:
        fused, step = out["engine"]
        assert fused == step == reference_tokens["engine_dp"]


@pytest.mark.parametrize("run,kv", [(0, "f32"), (1, "f32"), (2, "int8"), (3, "int8")])
def test_scheduler_tp_gives_the_reference_streams(world_a, reference_tokens, run, kv):
    """test_scheduler_tp_dense_and_paged and test_scheduler_tp_int8_kv: the
    dense and paged schedulers at tp = 2, f32 and int8, give the
    reference's single-device streams; every paged pool drains back to its
    garbage page."""
    for out in world_a:
        streams, free, _ = out["sched"][run]
        assert streams == reference_tokens[("sched", kv)]
        if free is not None:
            assert free == 2 * 2 + 1 - 1


def test_scheduler_tp_fused_ticks(world_a):
    """test_paged_scheduler_dp2_int8_fused_tick at dp = 1: fused ticks over
    the tp = 2 int8 pool give the per-token ticks' streams."""
    for out in world_a:
        assert out["sched"][6][0] == out["sched"][3][0]


def test_scheduler_tp_prefix_cache(world_a):
    """test_scheduler_tp_prefix_cache: prefix reuse over the tp = 2 pool
    gives the no-reuse streams, with hits."""
    for out in world_a:
        (plain, _, _), (reuse, _, hits) = out["sched"][4:6]
        assert reuse == plain and hits >= 2


def test_scheduler_tp_dp2(world_b, reference_tokens):
    """test_scheduler_tp_dp2: the dense scheduler at tp = 2 x dp = 2 (a slot
    a data rank; B = 1 admissions run data-replicated)."""
    for out in world_b:
        assert out["sched"][0][0] == reference_tokens[("sched", "f32")]


def test_paged_scheduler_dp2(world_b):
    """tests/test_parallel.py::test_paged_scheduler_dp2: the paged scheduler
    at tp = 2 x dp = 2 (a pool partition a data rank, each rank's device
    pool holding its own, the tables localized) gives the same mesh's dense
    streams, and every partition drains back to its garbage page."""
    for out in world_b:
        (dense, _, _), (paged, free, _) = out["sched_dp"][:2]
        assert paged == dense
        assert free == [4, 4]  # (4 slots x 2 pages + 2) / 2 partitions, less each one's garbage page


def test_page_pool_partitions_match_the_reference():
    """PagePool(partitions=2): the reference's global ids from each
    partition's free list, frees back to the owning partition, the
    localized table; a pool holding one partition (one process a data
    rank) has its P/2 pages, takes that partition's global ids and refuses
    the other's."""
    from flexq_tpu.serve.paged import PagePool as JPagePool
    from flexq_tpu_torch.serve.paged import PagePool

    ref = JPagePool(2, 8, 1, 128, 8, dtype=jnp.float32, partitions=2)
    whole = PagePool(2, 8, 1, 128, 8, dtype=torch.float32, partitions=2, device="cpu")
    mine = PagePool(2, 8, 1, 128, 8, dtype=torch.float32, partitions=2, partition=1, device="cpu")
    for pool in (ref, whole, mine):
        got = [pool.alloc(1, part=0), pool.alloc(2, part=1), pool.alloc(1, part=1)]
        pool.free(got[1])
        got.append(pool.alloc(1, part=1))
        assert got == [[0], [4, 5], [6], [5]]
        assert (pool.free_pages, pool.free_in(0), pool.free_in(1)) == (5, 3, 2)
        assert pool.localize(np.array([[0, 5, 6]])).tolist() == [[0, 1, 2]]
    assert tuple(whole.pool_k.shape) == (2, 8, 1, 128, 8) and tuple(mine.pool_k.shape) == (2, 4, 1, 128, 8)
    x = torch.arange(2 * 256 * 8, dtype=torch.float32).reshape(2, 1, 1, 256, 8)
    for pool in (whole, mine):
        pool.insert_prefill([5, 6], x, x + 1, 256)
    torch.testing.assert_close(mine.pool_v[:, 1:3], whole.pool_v[:, 5:7], rtol=0, atol=0)
    with pytest.raises(ValueError, match="partition 1"):
        mine.insert_prefill([1], x, x, 128)


def test_paged_scheduler_dp2_int8_fused_tick(world_b):
    """test_paged_scheduler_dp2_int8_fused_tick: over the int8 partitioned
    pool, fused ticks (3 steps) give the per-token ticks' streams."""
    for out in world_b:
        assert out["sched_dp"][2][0] == out["sched_dp"][3][0]
        assert out["sched_dp"][2][1] == out["sched_dp"][3][1] == [2, 2]


def test_replicated_scheduler_equals_one_scheduler(trees, world_a):
    """Rank 0 leads a ReplicatedScheduler over the tp = 2 paged scheduler,
    rank 1 follows its command log: the streams of one single-rank
    scheduler."""
    _, cfg, (_, pol), _, tq = trees["mha"]
    sched = BatchScheduler(tq, cfg, pol, num_slots=2, max_seq_len=256, paged=True, kv_dtype=torch.float32,
                           device="cpu")
    reqs = REQS + [([5, 5, 5], 3)]
    rids = [sched.add_request(p, max_new_tokens=n, eos_id=-1) for p, n in reqs]
    want = sched.run()
    assert world_a[0]["replicated"] == [want[r] for r in rids]
    assert world_a[1]["replicated"] is None


def test_beam_search_tp_equals_one_rank(trees, world_a):
    """Beam search at tp = 2, the Engine's over its dense cache and a beam
    group in the paged scheduler (page tables reordered, diverging blocks
    copied in each rank's pool): the single-rank n-best, tokens equal and
    scores within 1e-5."""
    from flexq_tpu_torch.serve import beam

    _, cfg, (_, pol), _, tq = trees["mha"]
    eng = Engine(tq, cfg, pol, max_seq_len=256, kv_dtype=torch.float32, device="cpu")
    want_eng = beam.beam_search_nbest(eng, BEAM_PROMPTS, beam.BeamParams(beam_width=3, max_new_tokens=6), n_best=2)
    sched = BatchScheduler(tq, cfg, pol, num_slots=3, max_seq_len=256, paged=True, kv_dtype=torch.float32,
                           device="cpu")
    rids = [sched.add_request(p, max_new_tokens=6, eos_id=-1, beam_width=3, n_best=2) for p in BEAM_PROMPTS]
    sched.run()
    want_sched = [[(t, sc) for t, sc, _ in sched.done_nbest[r]] for r in rids]
    for out in world_a:
        for got, want in zip(out["beam"], (want_eng, want_sched)):
            assert [[t for t, _ in row] for row in got] == [[t for t, _ in row] for row in want]
            np.testing.assert_allclose([[sc for _, sc in row] for row in got],
                                       [[sc for _, sc in row] for row in want], rtol=1e-5, atol=1e-5)


def test_scheduler_refusals_under_a_mesh(trees):
    """What the mesh does not serve yet, or cannot on the card, raises."""
    _, cfg, (_, pol), _, tq = trees["mha"]
    dp2 = Mesh(tp=1, dp=2, rank=0, device=torch.device("cpu"), backend="gloo", model_group=None, data_group=None)
    with pytest.raises(ValueError, match="prefix_cache"):  # a reused page would cross data partitions
        BatchScheduler(tq, cfg, pol, num_slots=2, max_seq_len=256, paged=True, prefix_cache=True, mesh=dp2)
    with pytest.raises(ValueError, match="divide"):
        BatchScheduler(tq, cfg, pol, num_slots=3, max_seq_len=256, mesh=dp2)
    card = dataclasses.replace(dp2, dp=1, device=torch.device("cuda", 0))
    with pytest.raises(ValueError, match="fused_tick=0"):
        BatchScheduler(tq, cfg, pol, num_slots=2, max_seq_len=256, fused_tick=4, mesh=card)


# ---- the exporter's rank files ----------------------------------------------------


def test_tp2_export_is_byte_identical_to_the_reference(export_dirs):
    d = export_dirs
    names = sorted(os.listdir(d / "jax_tp2"))
    assert names == sorted(os.listdir(d / "port_tp2"))
    assert {"layer_0.rank0.safetensors", "layer_1.rank1.safetensors", "head.rank1.safetensors"} <= set(names)
    for name in names:
        a, b = (d / "jax_tp2" / name).read_bytes(), (d / "port_tp2" / name).read_bytes()
        if name == "meta.json":
            import json

            assert json.loads(a) == json.loads(b)
        else:
            assert a == b, name


def test_load_packed_ranks_and_sharded(export_dirs, world_a):
    """load_packed(rank=r) is rank r's shard of the whole tree, rank=None
    reassembles the tp = 1 export's tree; load_packed_sharded on each rank
    of the world gives its rank's tree, and the forward over it equals the
    forward over shard_params of the whole tree bit for bit (the export's
    tree is bf16: how bf16 TP logits part from one rank's is chip_smoke.py
    phase 10's to hold at 7B width; the f32 trees above hold the rest)."""
    d = export_dirs
    cfg, pol, whole = load_packed(str(d / "port_tp1"), device="cpu")
    _, _, joined = load_packed(str(d / "port_tp2"), device="cpu")
    for (k, a), (_, b) in zip(leaves(joined), leaves(whole)):
        assert a.dtype == b.dtype and torch.equal(a, b), jax.tree_util.keystr(k)
    for r in range(2):
        mesh = Mesh(tp=2, dp=1, rank=r, device=torch.device("cpu"), backend="gloo", model_group=None,
                    data_group=None)
        mine = load_packed(str(d / "port_tp2"), rank=r, device="cpu")[2]
        for tree in (world_a[r]["export"][0], load_packed_sharded(str(d / "port_tp2"), mesh)[2]):
            for (k, a), (_, b) in zip(leaves(tree), leaves(shard_params(whole, mesh))):
                assert torch.equal(a, b), (r, jax.tree_util.keystr(k))
        for (k, a), (_, b) in zip(leaves(mine), leaves(shard_params(whole, mesh))):
            assert torch.equal(a, b), (r, jax.tree_util.keystr(k))
        _, from_files, from_whole, _ = world_a[r]["export"]
        assert from_files.shape == (1, 6, cfg.vocab_size) and torch.equal(from_files, from_whole)
    with pytest.raises(ValueError, match="--tp 2"):
        load_packed_sharded(str(d / "port_tp2"), dataclasses.replace(mesh, tp=1, rank=0))
    with pytest.raises(ValueError, match="rank"):
        load_packed(str(d / "port_tp1"), rank=1, device="cpu")


def test_http_tp2_leader_and_follower(export_dirs, world_a, tmp_path):
    """``serve.http --tp 2`` over the --tp 2 export, one process a rank
    (gloo, a file:// rendezvous, --replication-port 0): rank 0 serves HTTP
    over a leader ReplicatedScheduler, rank 1 follows; the completions
    equal a direct tp = 2 scheduler run over load_packed_sharded's trees.
    SIGINT to rank 0 stops both."""
    from torch_tp_ranks import HTTP_REQS

    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "flexq_tpu_torch.serve.http", "--checkpoint", str(export_dirs / "port_tp2"),
           "--tp", "2", "--device", "cpu", "--coordinator", f"file://{tmp_path / 'store'}", "--num-processes", "2",
           "--replication-port", "0", "--paged", "--slots", "2", "--max-seq-len", "256", "--fused-tick", "0",
           "--host", "127.0.0.1", "--port", "0"]
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
    assert got == world_a[0]["export"][3] == world_a[1]["export"][3]
