"""The port's quantize-and-evaluate path vs flexq_tpu on the CPU.

The same numpy inputs (trees made with numpy from a seed, carried into each
package: ``params_from_numpy`` for the port, ``jnp.asarray`` for the
reference) go through both packages:

  * the policy: any group size and ``symmetric=False`` taken, refused by
    every serving entry point before a weight is packed;
  * ``fake_quant_weights`` bit for bit (LLaMA, OPT; 128-group symmetric and
    64-group asymmetric), the input tree untouched;
  * the dense ``forward`` logits (LLaMA with GQA, OPT pre-LN and post-LN):
    policy None within 1e-5 of max |logit| (f32 sum order), llama_flex /
    opt_flex, W4A8 and W8A8 within 2e-2 of max |logit| with argmax
    agreement >= 0.95 (an f32-ulp difference in a fake-quant input can flip
    one code, which moves a tiny model's logits by ~1 %, as in
    tests/test_torch_formats.py);
  * ``attention_core_quant`` (4e-3 of max |out|: bf16 products) and
    ``span_mask`` (equal);
  * ``window_nll`` / ``perplexity`` (1e-5 relative, the short tail batch
    counted), and a tiny model's fake-quant perplexity over windows of
    data_tiny/test.npy (1e-4 relative);
  * eval/data.py's window functions with a toy tokenizer (equal), its arrow
    loaders on the directories scripts/make_eval_datasets.py builds;
  * smoothing: the act stats (1e-5 relative), the smoothed trees (1e-5
    relative) and the dense output invariance (1e-4 of max |logit|);
  * both sensitivity analyzers (one batch of two windows): the same ranking
    and policy, KLs within 3e-2 relative (the reference run op by op); the
    mixed W4 / W6 policy through the port's forward_serve against the
    reference's, compiled (2e-2 of max |logit|);
  * the scorers on a tiny model (1e-4), every adapter of the three tables
    on the rows that tests/test_zeroshot*.py feed them (equal);
  * the dense layer over a cache (1e-5), written in place;
  * the CLI, ``main.main([...])`` against the reference's on tiny LLaMA and
    OPT HF directories (ppl 1e-4 relative, exports byte-identical), the
    refused combinations;
  * mistral (sliding window), qwen2 (q/k/v biases) and gemma (embed_scale,
    the norm offset folded at load): dense forward within 1e-5, and the
    port's forward_serve against the reference's fake-quant oracle at the
    reference's bounds (0.06 of max |logit|, argmax agreement >= 0.75).
"""

import dataclasses
import importlib
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexq_tpu.config import ModelConfig as JModelConfig, QuantPolicy as JQuantPolicy
from flexq_tpu.eval import data as j_data, ppl as j_ppl, zeroshot as j_zs
from flexq_tpu.models import llama as j_llama, opt as j_opt
from flexq_tpu.models import hf_loader as j_hf_loader
from flexq_tpu.models.quantized import forward_serve as j_forward_serve, quantize_params as j_quantize_params
from flexq_tpu.quant import sensitivity as j_sens, smooth as j_smooth
from flexq_tpu_torch.config import ModelConfig, QuantPolicy
from flexq_tpu_torch.convert import params_from_numpy
from flexq_tpu_torch.eval import data as t_data, ppl as t_ppl, zeroshot as t_zs
from flexq_tpu_torch.models import hf_loader as t_hf_loader
from flexq_tpu_torch.models import llama as t_llama, opt as t_opt
from flexq_tpu_torch.models.quantized import forward_serve, quantize_params
from flexq_tpu_torch.quant import sensitivity as t_sens, smooth as t_smooth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LLAMA_KW = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_layers=2, num_heads=4, num_kv_heads=2)
OPT_KW = dict(vocab_size=250, hidden_size=128, intermediate_size=256, num_layers=2, num_heads=2, max_seq_len=64)
# the ids of every dense forward of the tiny models: the reference runs op by op, and XLA compiles each op once
# per shape, so one shape lets the tests share those compiles
IDS_SHAPE = (2, 24)


def jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def torch_tree(tree):
    return params_from_numpy(tree, device="cpu")


def to_np(tree):
    """A port tree's tensors as numpy arrays (the reference's inputs)."""
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_np(v) for v in tree]
    return tree.detach().cpu().numpy()


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def llama_tree(cfg, seed=0, head=True):
    rng = np.random.default_rng(seed)
    h, f = cfg.hidden_size, cfg.intermediate_size
    nq, nkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim

    def w(k, n, s=0.05):
        return (rng.standard_normal((k, n)) * s).astype(np.float32)

    def g():
        return (1 + 0.1 * rng.standard_normal(h)).astype(np.float32)

    layers = [dict(input_norm=g(), post_norm=g(), q_proj={"w": w(h, nq)}, k_proj={"w": w(h, nkv)},
                   v_proj={"w": w(h, nkv)}, o_proj={"w": w(nq, h)}, gate_proj={"w": w(h, f)},
                   up_proj={"w": w(h, f)}, down_proj={"w": w(f, h)}) for _ in range(cfg.num_layers)]
    tree = dict(embed=w(cfg.vocab_size, h, 1.0), final_norm=g(), layers=layers)
    if head:
        tree["lm_head"] = w(h, cfg.vocab_size)
    return tree


def opt_tree(cfg, seed=0):
    rng = np.random.default_rng(seed)
    h, f = cfg.hidden_size, cfg.intermediate_size

    def lin(k, n):
        return {"w": (rng.standard_normal((k, n)) * 0.05).astype(np.float32),
                "b": (rng.standard_normal(n) * 0.02).astype(np.float32)}

    def ln():
        return {"g": (1 + 0.1 * rng.standard_normal(h)).astype(np.float32),
                "b": (0.05 * rng.standard_normal(h)).astype(np.float32)}

    layers = [dict(input_norm=ln(), post_norm=ln(), q_proj=lin(h, h), k_proj=lin(h, h), v_proj=lin(h, h),
                   o_proj=lin(h, h), fc1=lin(h, f), fc2=lin(f, h)) for _ in range(cfg.num_layers)]
    return dict(embed=rng.standard_normal((cfg.vocab_size, h)).astype(np.float32),
                pos_embed=(0.1 * rng.standard_normal((cfg.max_seq_len + 2, h))).astype(np.float32),
                final_norm=ln(), layers=layers)


def policies(arch):
    """name -> (the reference's policy, the port's)."""
    flex = "llama_flex" if arch == "llama" else "opt_flex"
    jflex, tflex = getattr(JQuantPolicy, flex)(), getattr(QuantPolicy, flex)()
    return {
        "flex": (jflex, tflex),
        "W4A8": (JQuantPolicy.uniform(arch, 4, 8), QuantPolicy.uniform(arch, 4, 8)),
        "W8A8": (JQuantPolicy.uniform(arch, 8, 8), QuantPolicy.uniform(arch, 8, 8)),
        "g64-asym": (dataclasses.replace(jflex, w_group_size=64, a_group_size=64, symmetric=False),
                     dataclasses.replace(tflex, w_group_size=64, a_group_size=64, symmetric=False)),
    }


MODELS = {
    "llama-gqa": (j_llama, t_llama, JModelConfig.llama(**LLAMA_KW), ModelConfig.llama(**LLAMA_KW), llama_tree),
    "opt-preLN": (j_opt, t_opt, JModelConfig.opt(**OPT_KW), ModelConfig.opt(**OPT_KW), opt_tree),
    "opt-postLN": (j_opt, t_opt, JModelConfig.opt(do_layer_norm_before=False, **OPT_KW),
                   ModelConfig.opt(do_layer_norm_before=False, **OPT_KW), opt_tree),
}


# ---- the policy ---------------------------------------------------------------


def test_policy_takes_any_group_and_asymmetric_and_serving_refuses_it(tmp_path):
    from flexq_tpu_torch.export.exporter import export_checkpoint, load_packed
    from flexq_tpu_torch.serve import Engine
    from flexq_tpu_torch.serve.scheduler import BatchScheduler

    jp, tp = policies("llama")["g64-asym"]
    for name in ("q_proj", "down_proj", "lm_head"):
        assert dataclasses.asdict(tp.act_spec(name)) == dataclasses.asdict(jp.act_spec(name))
        assert dataclasses.asdict(tp.weight_spec(name)) == dataclasses.asdict(jp.weight_spec(name))
    cfg = ModelConfig.llama(**LLAMA_KW)
    dense = torch_tree(llama_tree(cfg))
    served = quantize_params(dense, cfg, QuantPolicy.llama_flex(), device="cpu")
    for bad in (dataclasses.replace(QuantPolicy.llama_flex(), w_group_size=64),
                dataclasses.replace(QuantPolicy.llama_flex(), a_group_size=None),
                dataclasses.replace(QuantPolicy.llama_flex(), symmetric=False)):
        with pytest.raises(ValueError, match="group|symmetric"):
            quantize_params(dense, cfg, bad, device="cpu")
        with pytest.raises(ValueError, match="group|symmetric"):
            forward_serve(served, cfg, bad, torch.zeros((1, 4), dtype=torch.int64), device="cpu")
        with pytest.raises(ValueError, match="group|symmetric"):
            Engine(served, cfg, bad, max_seq_len=128, device="cpu")
        with pytest.raises(ValueError, match="group|symmetric"):
            BatchScheduler(served, cfg, bad, num_slots=2, max_seq_len=128, device="cpu")
    # the exporter's directory: a meta.json that claims 64-groups is refused on load
    hf = hf_llama_dir(tmp_path / "hf")
    out = str(tmp_path / "packed")
    export_checkpoint(hf, out, device="cpu")
    with open(os.path.join(out, "meta.json")) as f:
        meta = json.load(f)
    meta["policy"]["w_group_size"] = 64
    with open(os.path.join(out, "meta.json"), "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="w_group_size=64"):
        load_packed(out, device="cpu")


# ---- the dense models -----------------------------------------------------------


@pytest.mark.parametrize("model", ["llama-gqa", "opt-preLN"])
@pytest.mark.parametrize("pol", ["flex", "g64-asym"])
def test_fake_quant_weights_bit_exact(model, pol):
    jmod, tmod, jcfg, cfg, make = MODELS[model]
    tree = make(cfg)
    jp, tp = policies(jcfg.arch)[pol]
    tt = torch_tree(tree)
    before = {k: v.clone() for k, v in tt["layers"][0]["q_proj"].items()}
    want = jax.tree_util.tree_map(np.asarray, jmod.fake_quant_weights(jax_tree(tree), jp))
    got = to_np(tmod.fake_quant_weights(tt, tp))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    # a new tree: the input's tensors are left as they were
    assert torch.equal(tt["layers"][0]["q_proj"]["w"], before["w"])
    assert not np.array_equal(got["layers"][0]["q_proj"]["w"], tree["layers"][0]["q_proj"]["w"])


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("pol", [None, "flex", "W4A8", "W8A8"])
def test_dense_forward_matches(model, pol):
    jmod, tmod, jcfg, cfg, make = MODELS[model]
    tree = make(cfg, seed=1)
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size, IDS_SHAPE)
    jp, tp = (None, None) if pol is None else policies(jcfg.arch)[pol]
    jt, tt = jax_tree(tree), torch_tree(tree)
    if pol is not None:
        jt, tt = jmod.fake_quant_weights(jt, jp), tmod.fake_quant_weights(tt, tp)
    want = np.asarray(jmod.forward(jt, jcfg, jnp.asarray(ids), policy=jp))
    got = tmod.forward(tt, cfg, torch.as_tensor(ids), policy=tp).numpy()
    assert got.shape == want.shape
    if pol is None:
        assert rel(got, want) < 1e-5
    else:
        assert rel(got, want) < 2e-2
        assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.95


def test_quantized_lm_head_input_and_positions():
    """A tree with an lm_head under a with_head policy fake-quantizes the
    head and its input; explicit positions are honoured."""
    cfg, jcfg = ModelConfig.llama(**LLAMA_KW), JModelConfig.llama(**LLAMA_KW)
    tree = llama_tree(cfg, seed=3)
    jp, tp = JQuantPolicy.llama_flex().with_head(6, 8), QuantPolicy.llama_flex().with_head(6, 8)
    jt, tt = j_llama.fake_quant_weights(jax_tree(tree), jp), t_llama.fake_quant_weights(torch_tree(tree), tp)
    np.testing.assert_array_equal(tt["lm_head"].numpy(), np.asarray(jt["lm_head"]))
    ids = np.random.default_rng(4).integers(0, 256, (2, 24))
    pos = np.tile(np.arange(5, 29), (2, 1))
    want = np.asarray(j_llama.forward(jt, jcfg, jnp.asarray(ids), policy=jp, positions=jnp.asarray(pos)))
    got = t_llama.forward(tt, cfg, torch.as_tensor(ids), policy=tp, positions=torch.as_tensor(pos)).numpy()
    assert rel(got, want) < 2e-2 and (got.argmax(-1) == want.argmax(-1)).mean() >= 0.95


def test_attention_core_quant_and_span_mask():
    rng = np.random.default_rng(5)
    b, lq, h, kvh, lk, d = 2, 6, 4, 2, 32, 32
    q = rng.standard_normal((b, lq, h, d)).astype(np.float32)
    k8 = rng.integers(-127, 128, (b, kvh, lk, d)).astype(np.int8)
    v8 = rng.integers(-127, 128, (b, kvh, lk, d)).astype(np.int8)
    ks = (rng.random((b, kvh, lk)) * 0.02 + 1e-3).astype(np.float32)
    vs = (rng.random((b, kvh, lk)) * 0.02 + 1e-3).astype(np.float32)
    pos = np.asarray([[10, 11, 12, 13, 14, 15], [20, 21, 22, 23, 24, 25]])
    for window in (None, 8):
        jm = np.asarray(j_llama.span_mask(jnp.asarray(pos), lk, window))
        tm = t_llama.span_mask(torch.as_tensor(pos), lk, window)
        np.testing.assert_array_equal(tm.numpy(), jm)
        want = np.asarray(j_llama.attention_core_quant(*map(jnp.asarray, (q, k8, ks, v8, vs)), jnp.asarray(jm), 2))
        got = t_llama.attention_core_quant(*map(torch.as_tensor, (q, k8, ks, v8, vs)), tm, 2).numpy()
        assert got.shape == want.shape == (b, lq, h * d)
        assert rel(got, want) < 4e-3


# ---- perplexity ----------------------------------------------------------------


def test_window_nll_and_perplexity_tail_batch():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((3, 9, 11)).astype(np.float32)
    ids = rng.integers(0, 11, (3, 9)).astype(np.int32)
    want = float(j_ppl.window_nll(jnp.asarray(logits), jnp.asarray(ids)))
    got = float(t_ppl.window_nll(torch.as_tensor(logits), torch.as_tensor(ids)))
    assert abs(got - want) <= 1e-5 * abs(want)

    table = rng.standard_normal((11, 11)).astype(np.float32)
    windows = rng.integers(0, 11, (5, 16)).astype(np.int32)

    def j_fwd(x):
        return jnp.asarray(table)[x]

    def t_fwd(x):
        return torch.as_tensor(table)[x]

    for bs in (1, 2, 4):  # 2 + 2 + 1 and 4 + 1: the short tail batch counts
        want = j_ppl.perplexity(j_fwd, windows, batch_size=bs)
        got = t_ppl.perplexity(t_fwd, windows, batch_size=bs)
        assert abs(got - want) <= 1e-5 * want
    seen = []
    got = t_ppl.perplexity(lambda p, x: p[x], windows, batch_size=2, params=torch.as_tensor(table),
                           progress=lambda i, n: seen.append((i, n)))
    assert abs(got - j_ppl.perplexity(j_fwd, windows)) <= 1e-5 * got and seen == [(2, 5), (4, 5), (5, 5)]


def test_tiny_model_ppl_on_test_windows():
    """A tiny LLaMA (vocab 8192: every data_tiny id is valid) fake-quantized
    under llama_flex, perplexity over two 128-token windows of
    data_tiny/test.npy through both packages."""
    kw = dict(LLAMA_KW, vocab_size=8192)
    cfg, jcfg = ModelConfig.llama(**kw), JModelConfig.llama(**kw)
    tree = llama_tree(cfg, seed=7)
    windows = np.load(os.path.join(REPO, "data_tiny", "test.npy"))[: 2 * 128].astype(np.int32).reshape(2, 128)
    jp, tp = policies("llama")["flex"]
    jq = j_llama.fake_quant_weights(jax_tree(tree), jp)
    tq = t_llama.fake_quant_weights(torch_tree(tree), tp)
    want = j_ppl.perplexity(lambda p, x: j_llama.forward(p, jcfg, x, policy=jp), windows, params=jq)
    got = t_ppl.perplexity(lambda x: t_llama.forward(tq, cfg, x, policy=tp), windows)
    assert math.isfinite(got) and abs(got - want) <= 1e-4 * want


# ---- data -----------------------------------------------------------------------


class ToyTok:
    """The reference test's toy tokenizer: a character a token."""

    def __call__(self, text, return_tensors=None):
        ids = np.asarray([[ord(c) % 97 for c in text]], np.int64)

        class R:
            input_ids = ids

        return R()


def test_eval_windows_equal():
    tok = ToyTok()
    text = "".join(chr(97 + i % 26) for i in range(1000))
    np.testing.assert_array_equal(t_data.tokenize_eval_ids(text, tok, 64), j_data.tokenize_eval_ids(text, tok, 64))
    for seed in (0, 3):
        np.testing.assert_array_equal(t_data.calib_samples(text, tok, 5, 32, seed),
                                      j_data.calib_samples(text, tok, 5, 32, seed))
    docs = ["a" * 10, "b" * 300, "c" * 40, "d" * 500]
    np.testing.assert_array_equal(t_data.c4_eval_ids(docs, tok, 128, 8, 0), j_data.c4_eval_ids(docs, tok, 128, 8, 0))
    np.testing.assert_array_equal(t_data.doc_calib_samples(docs, tok, 4, 128, 1),
                                  j_data.doc_calib_samples(docs, tok, 4, 128, 1))
    assert t_data.dataset_available() is j_data.dataset_available() is False


@pytest.fixture(scope="module")
def eval_arrow(tmp_path_factory):
    """Arrow datasets built by scripts/make_eval_datasets.py from a slice of
    data_tiny's held-out text."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    build = importlib.import_module("make_eval_datasets").build
    root = tmp_path_factory.mktemp("eval_arrow")
    corpus = root / "corpus"
    corpus.mkdir()
    for split in ("val", "test"):
        with open(os.path.join(REPO, "data_tiny", f"{split}.txt")) as f:
            (corpus / f"{split}.txt").write_text(f.read()[:12000])
    build(str(root / "arrow"), str(corpus))
    return str(root / "arrow")


def test_arrow_loaders_equal(eval_arrow, monkeypatch):
    wt = os.path.join(eval_arrow, "wikitext2-env")
    assert t_data.dataset_available(wt) and t_data.load_wikitext2_text(wt) == j_data.load_wikitext2_text(wt)
    for name in ("ptb", "c4", "pile"):
        path = os.path.join(eval_arrow, f"{name}-env")
        assert t_data.load_eval_text(name, path) == j_data.load_eval_text(name, path)
        assert t_data.load_eval_docs(name, path) == j_data.load_eval_docs(name, path)
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(ImportError, match="datasets"):
        t_data.load_wikitext2_text(wt)


# ---- smoothing --------------------------------------------------------------------


def assert_trees_close(got, want, rtol):
    gl, wl = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(gl, wl):
        np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=rtol * np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("model,fold_qk", [("llama-gqa", False), ("llama-gqa", True), ("opt-preLN", True)])
def test_smoothing_matches_and_keeps_outputs(model, fold_qk):
    jmod, tmod, jcfg, cfg, make = MODELS[model]
    tree = make(cfg, seed=8)
    if cfg.arch == "llama":  # Qwen2-style q/k/v biases ride through the folds
        rng = np.random.default_rng(9)
        for lp in tree["layers"]:
            for n in ("q_proj", "k_proj", "v_proj"):
                lp[n]["b"] = (0.02 * rng.standard_normal(lp[n]["w"].shape[1])).astype(np.float32)
    calib = np.random.default_rng(10).integers(0, cfg.vocab_size, IDS_SHAPE)
    jt, tt = jax_tree(tree), torch_tree(tree)
    jcol, tcol = ((j_smooth.collect_llama_act_stats, t_smooth.collect_llama_act_stats) if cfg.arch == "llama"
                  else (j_smooth.collect_opt_act_stats, t_smooth.collect_opt_act_stats))
    jfold, tfold = (j_smooth.smooth_llama, t_smooth.smooth_llama) if cfg.arch == "llama" else (j_smooth.smooth_opt,
                                                                                                 t_smooth.smooth_opt)
    jst, tst = jcol(jt, jcfg, jnp.asarray(calib)), tcol(tt, cfg, calib)
    assert [sorted(s) for s in tst] == [sorted(s) for s in jst]
    for a, b in zip(tst, jst):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-6 * np.abs(b[k]).max())
    jsm = jfold(jt, jcfg, jst, alpha=0.5, fold_qk=fold_qk)
    tsm = tfold(tt, cfg, tst, alpha=0.5, fold_qk=fold_qk)
    assert_trees_close(to_np(tsm), jax.tree_util.tree_map(np.asarray, jsm), 1e-5)
    # the folds are an identity on the dense output; the input tree is untouched
    ids = np.random.default_rng(11).integers(0, cfg.vocab_size, IDS_SHAPE)
    before = tmod.forward(tt, cfg, torch.as_tensor(ids)).numpy()
    after = tmod.forward(tsm, cfg, torch.as_tensor(ids)).numpy()
    assert rel(after, before) < 1e-4
    np.testing.assert_array_equal(tt["layers"][0]["q_proj"]["w"].numpy(), tree["layers"][0]["q_proj"]["w"])


def test_smooth_ln_fcs_shift_into_bias():
    rng = np.random.default_rng(12)
    ln = {"g": rng.random(8).astype(np.float32) + 0.5, "b": rng.standard_normal(8).astype(np.float32)}
    fcs = [{"w": rng.standard_normal((8, 4)).astype(np.float32)},
           {"w": rng.standard_normal((8, 6)).astype(np.float32), "b": rng.standard_normal(6).astype(np.float32)}]
    s = rng.random(8).astype(np.float32) + 0.5
    t = rng.standard_normal(8).astype(np.float32)
    want = j_smooth.smooth_ln_fcs(jax_tree(ln), jax_tree(fcs), jnp.asarray(s), jnp.asarray(t))
    got = t_smooth.smooth_ln_fcs(torch_tree(ln), torch_tree(fcs), torch.as_tensor(s), torch.as_tensor(t))
    assert_trees_close(to_np(list(got)), jax.tree_util.tree_map(np.asarray, list(want)), 1e-6)
    with pytest.raises(ValueError, match="shift"):
        t_smooth.smooth_ln_fcs(torch.ones(8), [], torch.ones(8), torch.ones(8))


# ---- sensitivity --------------------------------------------------------------------


def outlier_tree(cfg, seed, linear, scale):
    tree = llama_tree(cfg, seed=seed)
    for lp in tree["layers"]:
        w = lp[linear]["w"]
        if linear == "up_proj":  # outliers into down_proj's inputs
            w[:, 0] *= scale
        else:  # one outlier per 128-group of the weight: W4 loses the rest
            w[np.arange(w.shape[0]) % 128 == 0] *= scale
    return tree


SENS_KW = dict(LLAMA_KW, num_layers=1)


def eager_reference(monkeypatch):
    """Run the reference analyzers op by op: they jit a new closure for
    every probe, and compiling nine of them is most of a test's time. Eager
    and jitted runs of the reference part by up to ~2 % in these tiny KLs
    (XLA's fusions round differently), so the KLs are held at 3e-2."""
    monkeypatch.setattr(j_sens.jax, "jit", lambda f, **kw: f)


def test_act_sensitivity_same_ranking(monkeypatch):
    eager_reference(monkeypatch)
    cfg, jcfg = ModelConfig.llama(**SENS_KW), JModelConfig.llama(**SENS_KW)
    tree = outlier_tree(cfg, 13, "up_proj", 40.0)
    calib = np.random.default_rng(0).integers(0, 256, IDS_SHAPE).astype(np.int32)
    want = j_sens.analyze_act_sensitivity(j_llama.forward, jax_tree(tree), jcfg, calib, batch=2)
    got = t_sens.analyze_act_sensitivity(t_llama.forward, torch_tree(tree), cfg, calib, batch=2)
    assert sorted(got.per_linear_kl, key=got.per_linear_kl.get) == sorted(want.per_linear_kl,
                                                                        key=want.per_linear_kl.get)
    for n, kl in want.per_linear_kl.items():
        assert abs(got.per_linear_kl[n] - kl) <= 3e-2 * kl + 1e-7
    assert abs(got.baseline_kl - want.baseline_kl) <= 3e-2 * want.baseline_kl
    assert got.policy.act_bits == want.policy.act_bits and got.policy.act_bits["down_proj"] == 8
    assert got.summary().splitlines()[1].split()[0] == "down_proj"


def test_weight_sensitivity_mixed_policy_serves(monkeypatch):
    eager_reference(monkeypatch)
    cfg, jcfg = ModelConfig.llama(**SENS_KW), JModelConfig.llama(**SENS_KW)
    tree = outlier_tree(cfg, 14, "o_proj", 60.0)
    calib = np.random.default_rng(1).integers(0, 256, IDS_SHAPE).astype(np.int32)
    jt, tt = jax_tree(tree), torch_tree(tree)
    want = j_sens.analyze_weight_sensitivity(j_llama.forward, jt, jcfg, calib, keep_fraction=0.15, batch=2)
    got = t_sens.analyze_weight_sensitivity(t_llama.forward, tt, cfg, calib, keep_fraction=0.15, batch=2)
    assert max(got.per_linear_kl, key=got.per_linear_kl.get) == "o_proj"
    for n, kl in want.per_linear_kl.items():
        assert abs(got.per_linear_kl[n] - kl) <= 3e-2 * kl + 1e-7
    assert got.policy.weight_bits == want.policy.weight_bits and got.policy.act_bits == want.policy.act_bits
    assert got.policy.weight_bits["o_proj"] == 6 and got.policy.weight_bits["q_proj"] == 4
    # the mixed W4 / W6 tree through the port's packed path against the reference's
    qp = quantize_params(tt, cfg, got.policy, dtype=torch.float32, device="cpu")
    assert "hi" in qp["layers"][0]["o_proj"] and "q4" in qp["layers"][0]["q_proj"]
    ids = np.random.default_rng(2).integers(0, 256, (1, 8))
    # the reference's packing and packed forward compiled whole (op by op, XLA compiles each op apart: most of the
    # test's time); compiled, its scales may part from the eager ones by an ulp, far inside the bound
    ref, _ = jax.jit(lambda t, x: j_forward_serve(j_quantize_params(t, jcfg, want.policy, dtype=jnp.float32), jcfg,
                                                  want.policy, x))(jt, jnp.asarray(ids))
    out, _ = forward_serve(qp, cfg, got.policy, torch.as_tensor(ids), device="cpu")
    assert torch.isfinite(out).all() and rel(out.numpy(), np.asarray(ref)) < 2e-2
    budget = t_sens.analyze_weight_sensitivity(t_llama.forward, tt, cfg, calib,
                                               kl_budget=max(got.per_linear_kl.values()) * 10)
    assert all(b == 4 for b in budget.policy.weight_bits.values())


# ---- zero-shot ------------------------------------------------------------------------


class CharTok:
    """Characters as tokens (ord % 97), with the HF call and encode / decode."""

    eos_token_id = 0
    bos_token_id = None

    def encode(self, s):
        return [ord(c) % 97 for c in s]

    def decode(self, ids):
        return "".join(chr(97 + int(t) % 26) for t in ids)

    def __call__(self, text, return_tensors=None):
        ids = np.asarray([self.encode(text)], np.int64)

        class R:
            input_ids = ids

        return R()


@pytest.fixture(scope="module")
def scorer_model():
    kw = dict(LLAMA_KW, vocab_size=97)
    cfg, jcfg = ModelConfig.llama(**kw), JModelConfig.llama(**kw)
    tree = llama_tree(cfg, seed=15)
    jt, tt = jax_tree(tree), torch_tree(tree)
    jf = jax.jit(lambda x: j_llama.forward(jt, jcfg, x))
    return jf, (lambda x: t_llama.forward(tt, cfg, x))


def test_scorers_match(scorer_model):
    jf, tf = scorer_model
    tok = CharTok()
    ctxs, conts = [[1, 2, 3], [4, 5], [6, 7, 8, 9, 10], [3] * 40], [[11, 12], [13], [14, 15, 16], [5] * 30]
    np.testing.assert_allclose(t_zs.loglikelihood_batch(tf, ctxs, conts, max_len=48),
                               j_zs.loglikelihood_batch(jf, ctxs, conts, max_len=48), rtol=1e-4)
    items = [t_zs.MCItem(context="abc", choices=["def", "zqx"], gold=0),
             t_zs.MCItem(context="", contexts=["lm", "no"], choices=[" pq", " pq"], gold=1),
             t_zs.MCItem(context="hello", choices=[" a", " bb", " c"], gold=2, gold_all=[1, 2])]
    j_items = [j_zs.MCItem(**dataclasses.asdict(i)) for i in items]
    got, want = (t_zs.evaluate_multiple_choice(tf, tok, items, batch_size=2),
                 j_zs.evaluate_multiple_choice(jf, tok, j_items, batch_size=2))
    assert got.keys() == want.keys() and all(abs(got[k] - want[k]) <= 1e-6 for k in got)
    pairs = [("abc", "de"), ("xy", "zzz")]
    for a, b in ((t_zs.evaluate_greedy_completion(tf, tok, pairs), j_zs.evaluate_greedy_completion(jf, tok, pairs)),
                 (t_zs.evaluate_lambada(tf, tok, ["aa bb", "cd ef g"]),
                  j_zs.evaluate_lambada(jf, tok, ["aa bb", "cd ef g"]))):
        assert a.keys() == b.keys() and all(abs(a[k] - b[k]) <= 1e-4 * max(1, abs(b[k])) for k in a)
    docs = ["ab cd ef " * 5, "ghi jk"]
    a, b = (t_zs.evaluate_perplexity_docs(tf, tok, docs, max_len=16, batch_size=3),
            j_zs.evaluate_perplexity_docs(jf, tok, docs, max_len=16, batch_size=3))
    assert all(abs(a[k] - b[k]) <= 1e-4 * abs(b[k]) for k in a)
    rows = [{"question": "Q?", "mc2_targets": {"choices": ["a", "bc", "d"], "labels": [1, 0, 0]}}]
    assert abs(t_zs.evaluate_truthfulqa_mc2(tf, tok, rows, max_len=512)["mc2"]
               - j_zs.evaluate_truthfulqa_mc2(jf, tok, rows, max_len=512)["mc2"]) <= 1e-4

    def gen(ids, n):  # a fixed "generation": the prompt's last tokens
        return list(ids[-n:])

    gi = [t_zs.GenItem(context="the cat sat", answers=["sat", "cat"])]
    assert (t_zs.evaluate_generation(gen, tok, gi, max_new_tokens=3)
            == j_zs.evaluate_generation(gen, tok, [j_zs.GenItem(**dataclasses.asdict(gi[0]))], max_new_tokens=3))
    assert (t_zs.evaluate_translation(gen, tok, gi, max_new_tokens=3)
            == j_zs.evaluate_translation(gen, tok, [j_zs.GenItem(**dataclasses.asdict(gi[0]))], max_new_tokens=3))
    hyp, refs = ["the cat sat on the mat", "a b c"], [["the cat is on the mat"], ["a b d", "a b c"]]
    assert t_zs.corpus_bleu(hyp, refs) == j_zs.corpus_bleu(hyp, refs)


def test_every_adapter_matches(monkeypatch):
    """Every adapter of TASK_ADAPTERS, GEN_TASK_ADAPTERS and
    GREEDY_PAIR_ADAPTERS (and collate_race, translation_item,
    lambada_cloze_pairs) on the rows the reference's own zero-shot tests
    feed it: the rows are recorded while those tests run, then fed to the
    port's adapter."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    seen = []
    tables = ("TASK_ADAPTERS", "GEN_TASK_ADAPTERS", "GREEDY_PAIR_ADAPTERS")
    original = {table: dict(getattr(j_zs, table)) for table in tables}
    for table in tables:
        for name, fn in getattr(j_zs, table).items():
            def rec(row, table=table, name=name, fn=fn):
                seen.append((table, name, row))
                return fn(row)

            monkeypatch.setitem(getattr(j_zs, table), name, rec)
    calls = []
    for mod_name in ("test_zeroshot", "test_zeroshot_golden"):
        mod = importlib.import_module(mod_name)
        for fn_name in ("collate_race", "translation_item", "lambada_cloze_pairs", "_winogrande"):
            if hasattr(mod, fn_name):
                def rec_fn(*a, fn_name=fn_name, orig=getattr(j_zs, fn_name)):
                    calls.append((fn_name, a))
                    return orig(*a)

                monkeypatch.setattr(mod, fn_name, rec_fn)
        for test in sorted(n for n in dir(mod) if n.startswith("test_")):
            getattr(mod, test)()

    def plain(x):
        if dataclasses.is_dataclass(x):
            return dataclasses.asdict(x)
        return [plain(v) for v in x] if isinstance(x, (list, tuple)) else x

    for table in tables:
        # a name shares the rows of every name of its adapter (hendrycks_test is mmlu's)
        assert set(getattr(t_zs, table)) == set(original[table])
        for name, fn in original[table].items():
            rows = [row for t, n, row in seen if t == table and original[table][n] is fn]
            assert rows, (table, name)
            for row in rows:
                assert plain(getattr(t_zs, table)[name](row)) == plain(fn(row)), (table, name)
    assert {c for c, _ in calls} >= {"collate_race", "translation_item", "lambada_cloze_pairs", "_winogrande"}
    for fn_name, a in calls:
        assert plain(getattr(t_zs, fn_name)(*a)) == plain(getattr(j_zs, fn_name)(*a)), fn_name
    assert t_zs.PILE_SUBSETS == j_zs.PILE_SUBSETS and t_zs.TRUTHFULQA_QA_PROMPT == j_zs.TRUTHFULQA_QA_PROMPT
    assert t_zs.rolling_token_windows(list(range(10)), -1, 4) == j_zs.rolling_token_windows(list(range(10)), -1, 4)


# ---- the CLI ---------------------------------------------------------------------------


def hf_llama_dir(d, vocab=256, tokenizer=False) -> str:
    from transformers import LlamaConfig, LlamaForCausalLM, PreTrainedTokenizerFast

    torch.manual_seed(0)
    m = LlamaForCausalLM(LlamaConfig(vocab_size=vocab, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                                     num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
                                     tie_word_embeddings=False)).eval()
    m.save_pretrained(d, safe_serialization=True)
    if tokenizer:
        tok = PreTrainedTokenizerFast(tokenizer_file=os.path.join(REPO, "data_tiny", "tokenizer.json"))
        tok.save_pretrained(d)
    return str(d)


@pytest.fixture(scope="module")
def cli_dir(tmp_path_factory):
    return hf_llama_dir(tmp_path_factory.mktemp("cli_hf"), vocab=8192, tokenizer=True)


def test_cli_matches_reference(cli_dir, eval_arrow, tmp_path, capsys):
    import flexq_tpu.main as j_main
    import flexq_tpu_torch.main as t_main
    from flexq_tpu.export.exporter import load_packed as j_load_packed
    from flexq_tpu_torch.export.exporter import load_packed

    ppl_data = os.path.join(eval_arrow, "wikitext2-env")
    base = ["--model", cli_dir, "--cpu", "--seqlen", "128"]
    runs = [["--flex_linear_quant", "--smooth", "--eval_ppl", "--ppl-data", ppl_data],
            ["--w_group_size", "64", "--asymmetric", "--eval_ppl", "--ppl-data", ppl_data]]
    for extra in runs:
        want = j_main.main(base + extra)
        got = t_main.main(base + extra)
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
        assert got.keys() == want.keys() and got["wbits"] == want["wbits"]
        if "wikitext2_ppl" in want:
            assert abs(got["wikitext2_ppl"] - want["wikitext2_ppl"]) <= 1e-4 * want["wikitext2_ppl"]
    jout, tout = str(tmp_path / "j"), str(tmp_path / "t")
    j_main.main(["--model", cli_dir, "--flex_linear_quant", "--cpu", "--export", jout])
    res = t_main.main(["--model", cli_dir, "--flex_linear_quant", "--cpu", "--export", tout])
    assert res["exported"] == tout
    for f in sorted(os.listdir(jout)):
        with open(os.path.join(jout, f), "rb") as a, open(os.path.join(tout, f), "rb") as b:
            assert a.read() == b.read(), f
    cfg, policy, tree = load_packed(tout, device="cpu")
    assert len(tree["layers"]) == 2 and policy.weight_bits == j_load_packed(jout)[1].weight_bits
    for refused in (["--smooth", "--export", str(tmp_path / "s")], ["--w_group_size", "64", "--export",
                                                                    str(tmp_path / "g")]):
        with pytest.raises(SystemExit):
            t_main.main(["--model", cli_dir, "--cpu", *refused])
        assert not os.path.exists(refused[-1])
    assert "would not be smoothed" in capsys.readouterr().err


def test_cli_tasks(cli_dir, tmp_path):
    """--tasks over a piqa-schema arrow directory, against the reference."""
    from datasets import Dataset, DatasetDict

    import flexq_tpu.main as j_main
    import flexq_tpu_torch.main as t_main

    rows = {"goal": ["fix a flat tire", "open a jar", "boil water"], "sol1": ["Use glue.", "Twist.", "Heat it."],
            "sol2": ["Use a patch.", "Shake.", "Freeze it."], "label": [1, 0, 0]}
    DatasetDict({"validation": Dataset.from_dict(rows)}).save_to_disk(str(tmp_path / "piqa"))
    args = ["--model", cli_dir, "--cpu", "--flex_linear_quant", "--tasks", "piqa", "--task-data-root", str(tmp_path)]
    want, got = j_main.main(args)["tasks"]["piqa"], t_main.main(args)["tasks"]["piqa"]
    assert got.keys() == want.keys() and all(abs(got[k] - want[k]) <= 1e-6 for k in got)


# ---- model families -----------------------------------------------------------------------


def family(kind):
    from transformers import (GemmaConfig, GemmaForCausalLM, MistralConfig, MistralForCausalLM, Qwen2Config,
                              Qwen2ForCausalLM)

    torch.manual_seed(0)
    common = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=256)
    if kind == "mistral":
        return MistralForCausalLM(MistralConfig(sliding_window=6, tie_word_embeddings=False, **common)).eval()
    if kind == "qwen2":
        return Qwen2ForCausalLM(Qwen2Config(tie_word_embeddings=False, **common)).eval()
    return GemmaForCausalLM(GemmaConfig(head_dim=32, rms_norm_eps=1e-6, hidden_act="gelu_pytorch_tanh",
                                        hidden_activation="gelu_pytorch_tanh", **common)).eval()


@pytest.mark.parametrize("kind", ["mistral", "qwen2", "gemma"])
def test_family_dense_and_serve_track_oracle(kind):
    m = family(kind)
    jcfg, cfg = j_hf_loader.config_from_hf(m.config), t_hf_loader.config_from_hf(m.config)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jt = j_hf_loader.from_hf_llama(m, dtype=jnp.float32)
    tt = torch_tree(jax.tree_util.tree_map(np.asarray, jt))
    ids = np.random.default_rng(1).integers(0, 256, IDS_SHAPE)
    want = np.asarray(j_llama.forward(jt, jcfg, jnp.asarray(ids)))
    assert rel(t_llama.forward(tt, cfg, torch.as_tensor(ids)).numpy(), want) < 1e-5
    jp, tp = JQuantPolicy.llama_flex(), QuantPolicy.llama_flex()
    oracle = np.asarray(j_llama.forward(j_llama.fake_quant_weights(jt, jp), jcfg, jnp.asarray(ids), policy=jp))
    own = t_llama.forward(t_llama.fake_quant_weights(tt, tp), cfg, torch.as_tensor(ids), policy=tp).numpy()
    assert rel(own, oracle) < 2e-2
    got, _ = forward_serve(quantize_params(tt, cfg, tp, dtype=torch.float32, device="cpu"), cfg, tp,
                           torch.as_tensor(ids), device="cpu")
    got = got.numpy()
    assert rel(got, oracle) < 0.06 and (got.argmax(-1) == oracle.argmax(-1)).mean() >= 0.75


def test_decoder_layer_over_a_cache():
    """The dense layer with a cache (the reference's [layers, B, max, KVH, D]
    layout): the step's K/V written at cache_pos, attention over the cache;
    the port writes in place and returns the same buffers."""
    cfg, jcfg = ModelConfig.llama(**LLAMA_KW), JModelConfig.llama(**LLAMA_KW)
    lp = llama_tree(cfg, seed=16)["layers"][0]
    rng = np.random.default_rng(17)
    x = rng.standard_normal((2, 5, cfg.hidden_size)).astype(np.float32)
    shape = (cfg.num_layers, 2, 16, cfg.num_kv_heads, cfg.head_dim)
    ck, cv = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    pos = np.tile(np.arange(3, 8), (2, 1))
    jcos, jsin = j_llama.rope_for_cfg(jnp.asarray(pos), jcfg)
    tcos, tsin = t_llama.rope_for_cfg(torch.as_tensor(pos), cfg)
    jm, tm = j_llama.span_mask(jnp.asarray(pos), 16), t_llama.span_mask(torch.as_tensor(pos), 16)
    jp, tp = policies("llama")["flex"]
    want, (wk, wv) = j_llama.decoder_layer(jax_tree(lp), jcfg, jnp.asarray(x), jcos, jsin, jm, jp,
                                            kv=(jnp.asarray(ck), jnp.asarray(cv), 1), cache_pos=3)
    tk, tv = torch.as_tensor(ck.copy()), torch.as_tensor(cv.copy())
    got, (gk, gv) = t_llama.decoder_layer(torch_tree(lp), cfg, torch.as_tensor(x), tcos, tsin, tm, tp,
                                           kv=(tk, tv, 1), cache_pos=3)
    assert gk is tk and gv is tv
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5, atol=1e-5)
    assert rel(got.numpy(), np.asarray(want)) < 1e-5


def test_cli_opt_matches_reference(tmp_path):
    """--arch opt: the port's loader reads the OPT directory (the reference's
    CLI goes through transformers), the eval equal to the reference's; an
    --arch that is not the directory's is refused."""
    from transformers import OPTConfig, OPTForCausalLM, PreTrainedTokenizerFast

    import flexq_tpu.main as j_main
    import flexq_tpu_torch.main as t_main

    torch.manual_seed(2)
    m = OPTForCausalLM(OPTConfig(vocab_size=8192, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
                                 num_attention_heads=4, max_position_embeddings=256, do_layer_norm_before=True,
                                 tie_word_embeddings=True)).eval()
    d = str(tmp_path / "opt")
    m.save_pretrained(d, safe_serialization=True)
    PreTrainedTokenizerFast(tokenizer_file=os.path.join(REPO, "data_tiny", "tokenizer.json")).save_pretrained(d)
    cfg, tree = t_hf_loader.load_checkpoint(d, dtype=torch.float32, device="cpu")
    want_tree = t_hf_loader.from_hf_opt(m, device="cpu")
    assert jax.tree_util.tree_structure(to_np(tree)) == jax.tree_util.tree_structure(to_np(want_tree))
    for a, b in zip(jax.tree_util.tree_leaves(to_np(tree)), jax.tree_util.tree_leaves(to_np(want_tree))):
        np.testing.assert_array_equal(a, b)
    wiki = tmp_path / "wiki"
    from datasets import Dataset, DatasetDict

    with open(os.path.join(REPO, "data_tiny", "test.txt")) as f:
        text = f.read()[:6000]
    DatasetDict({"test": Dataset.from_dict({"text": text.split("\n\n")})}).save_to_disk(str(wiki))
    args = ["--model", d, "--cpu", "--arch", "opt", "--flex_linear_quant", "--smooth", "--eval_ppl", "--ppl-data",
            str(wiki), "--seqlen", "128"]
    want, got = j_main.main(args), t_main.main(args)
    assert abs(got["wikitext2_ppl"] - want["wikitext2_ppl"]) <= 1e-4 * want["wikitext2_ppl"]
    with pytest.raises(SystemExit):
        t_main.main(["--model", d, "--cpu"])
