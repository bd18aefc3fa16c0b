"""The port's training path, corpus, timing and profiling utilities vs
flexq_tpu on the CPU.

The same numpy inputs go through both packages, with these tolerances:

  * ``init_params``: bit-equal (the same numpy draws in the same order);
  * ``make_lr_schedule`` against optax's warmup_cosine_decay_schedule at
    every step of a short run: 1e-7 relative (both in f32; the port rounds
    the cosine correctly, XLA's agrees on these steps);
  * ``loss_fn``: 1e-6 relative; the gradients: within 1e-5 of each leaf's
    max |g| (f32 sums in another order);
  * five ``train_step``s (optax's chain(clip_by_global_norm, adamw) written
    out): the loss each step 1e-6 relative; the parameters within 1e-6
    absolute (each step moves a parameter by about lr = 6e-4 at most; the
    two packages' gradients part by f32 sum order, which Adam's
    normalisation carries into the update), Adam's mu and nu within 1e-4 of
    each leaf's max; the step counts equal; once without clipping at these
    sizes' gradient norm and once with clip_norm far below it, so the clip
    triggers; the first step (lr(0) = 0) leaves the parameters bit for bit;
  * checkpoints written by either package read by the other: leaf-equal;
  * ``batch_iterator`` / ``windows_from_stream``: equal;
  * ``build_corpus`` on a small temporary tree: byte-identical files;
  * ``encode_file``: equal to data_tiny/val.npy on val.txt's first 1 Mi
    characters (the reference's chunk), and ``ByteLevelBPE`` equal to
    ``tokenizers`` on strings with non-ASCII letters and numerals,
    \\x1c-\\x1f, runs of whitespace and the three added tokens;
  * ``bandwidth_gbs`` / ``tflops`` and ``GenerationStats.summary()``: equal;
    ``bench_fn`` returns seconds a call (the reference's unit) and
    ``last_fallback`` False; the two frameworks' times are not compared.
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexq_tpu.config import ModelConfig as JModelConfig
from flexq_tpu.train import corpus as j_corpus, trainer as j_trainer
from flexq_tpu.utils import benchmark as j_benchmark, profiling as j_profiling

from flexq_tpu_torch.config import ModelConfig
from flexq_tpu_torch.train import corpus, trainer
from flexq_tpu_torch.utils import benchmark, profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data_tiny")
CFG_KW = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
              max_seq_len=64)
CFG, JCFG = ModelConfig.llama(**CFG_KW), JModelConfig.llama(**CFG_KW)
TC_KW = dict(batch_size=4, seq_len=32, total_steps=20, warmup_steps=2)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pairs(jtree, ttree):
    jl, tl = jax.tree_util.tree_leaves(jtree), trainer.tree_leaves(ttree)
    assert len(jl) == len(tl)
    return [(_np(a), _np(b)) for a, b in zip(jl, tl)]


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, CFG.vocab_size, 5000).astype(np.uint16)


def test_init_params_bit_equal():
    for seed in (0, 3):
        pairs = _pairs(j_trainer.init_params(JCFG, seed), trainer.init_params(CFG, seed, device="cpu"))
        assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in pairs)


@pytest.mark.parametrize("total,warmup", [(40, 500), (24, 3)])
def test_lr_schedule_matches_optax(total, warmup):
    tc = trainer.TrainConfig(total_steps=total, warmup_steps=warmup)
    want = np.asarray(jax.vmap(j_trainer.make_lr_schedule(j_trainer.TrainConfig(total_steps=total,
                                                                                 warmup_steps=warmup)))(
        jnp.arange(total + 3, dtype=jnp.int32)), np.float64)
    got = np.asarray([trainer.make_lr_schedule(tc)(c) for c in range(total + 3)])
    assert got[0] == 0.0 == want[0]
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)


def test_loss_and_grads_match(tokens):
    ids = next(j_trainer.batch_iterator(tokens, j_trainer.TrainConfig(**TC_KW), seed=1))
    jp = j_trainer.init_params(JCFG, 1)
    jl, jg = jax.value_and_grad(j_trainer.loss_fn)(jp, JCFG, jnp.asarray(ids))
    tp = trainer.tree_map(lambda p: p.requires_grad_(True), trainer.init_params(CFG, 1, device="cpu"))
    tl = trainer.loss_fn(tp, CFG, ids)
    tg = torch.autograd.grad(tl, trainer.tree_leaves(tp))
    assert abs(float(tl.detach()) - float(jl)) <= 1e-6 * abs(float(jl))
    for a, b in _pairs(jg, list(tg)):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max()


@pytest.mark.parametrize("clip_norm", [1.0, 1e-3])
def test_train_steps_match_optax(tokens, clip_norm):
    jtc = j_trainer.TrainConfig(clip_norm=clip_norm, **TC_KW)
    ttc = trainer.TrainConfig(clip_norm=clip_norm, **TC_KW)
    jp, tp = j_trainer.init_params(JCFG, 2), trainer.init_params(CFG, 2, device="cpu")
    opt, topt = j_trainer.make_optimizer(jtc, jp), trainer.make_optimizer(ttc, tp)
    jst, tst = opt.init(jp), topt.init(tp)
    it = j_trainer.batch_iterator(tokens, jtc, seed=1)
    for step in range(5):
        ids = next(it)
        if step == 0 and clip_norm < 1.0:  # the clip triggers
            g = jax.grad(j_trainer.loss_fn)(jp, JCFG, jnp.asarray(ids))
            assert sum(float(jnp.sum(x * x)) for x in jax.tree_util.tree_leaves(g)) ** 0.5 > 10 * clip_norm
        jp, jst, jl = j_trainer.train_step(jp, jst, jnp.asarray(ids), JCFG, opt)
        before = tp
        tp, tst, tl = trainer.train_step(tp, tst, ids, CFG, topt)
        if step == 0:  # lr(0) = 0: the first step moves nothing
            assert all(torch.equal(a, b) for a, b in zip(trainer.tree_leaves(before), trainer.tree_leaves(tp)))
        assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
        assert tst["count"] == int(jst[1][0].count) == step + 1
    for a, b in _pairs(jp, tp):
        assert np.abs(a - b).max() <= 1e-6
    for moment in ("mu", "nu"):
        for a, b in _pairs(getattr(jst[1][0], moment), tst[moment]):
            assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max()


def test_checkpoints_cross_load(tmp_path):
    tp = trainer.init_params(CFG, 4, device="cpu")
    jp = j_trainer.init_params(JCFG, 5)
    trainer.save_checkpoint(str(tmp_path / "port.npz"), tp, CFG, 7, extra={"val_loss": 1.5})
    j_trainer.save_checkpoint(str(tmp_path / "ref.npz"), jp, JCFG, 9)
    jgot, jcfg, jmeta = j_trainer.load_checkpoint(str(tmp_path / "port.npz"))
    tgot, tcfg, tmeta = trainer.load_checkpoint(str(tmp_path / "ref.npz"), device="cpu")
    assert jcfg == JCFG and tcfg == CFG and jmeta == {"step": 7, "val_loss": 1.5} and tmeta == {"step": 9}
    assert all(np.array_equal(a, b) for a, b in _pairs(jgot, tp))
    assert all(np.array_equal(a, b) for a, b in _pairs(jp, tgot))
    assert sorted(np.load(tmp_path / "port.npz").files) == sorted(np.load(tmp_path / "ref.npz").files)


def test_batches_and_windows_equal(tokens):
    for seed in (0, 1):
        jit = j_trainer.batch_iterator(tokens, j_trainer.TrainConfig(**TC_KW), seed=seed)
        tit = trainer.batch_iterator(tokens, trainer.TrainConfig(**TC_KW), seed=seed)
        for _ in range(3):
            a, b = next(jit), next(tit)
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for seq in (32, 333):
        a, b = j_trainer.windows_from_stream(tokens, seq), trainer.windows_from_stream(tokens, seq)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _write_tree(root):
    """Three source units of ~40 KB (documents of 2-6 KB, one duplicated,
    one too short, one binary-looking) and a skipped tests/ directory."""
    rng = np.random.default_rng(0)
    words = ["alpha", "beta", "gamma", "delta", "naïve", "ǅemal", "x²", "Ⅻ", "½", "def", "return", "\t", "\r\n"]
    for unit in ("pkg_a", "pkg_b", "pkg_c"):
        for i in range(12):
            d = root / unit / ("docs" if i % 2 else "src")
            d.mkdir(parents=True, exist_ok=True)
            text = " ".join(rng.choice(words, int(rng.integers(400, 1200))))
            (d / f"f{i}.{'md' if i % 3 else 'py'}").write_text(text, encoding="utf-8")
        (root / unit / "src" / "copy.py").write_text((root / unit / "src" / "f0.py").read_text(encoding="utf-8"),
                                                     encoding="utf-8")
        (root / unit / "short.txt").write_text("too short", encoding="utf-8")
        (root / unit / "bin.txt").write_bytes(b"\x01\x02" * 600)
        (root / unit / "tests").mkdir()
        (root / unit / "tests" / "t.py").write_text("x" * 2000, encoding="utf-8")


def test_build_corpus_byte_identical(tmp_path):
    root = tmp_path / "site"
    _write_tree(root)
    kw = dict(roots=[str(root)], max_mb=1, heldout_mb=0.03, seed=1)
    mj = j_corpus.build_corpus(str(tmp_path / "ref"), **kw)
    mt = corpus.build_corpus(str(tmp_path / "port"), **kw)
    assert mj == mt and mj["val_units"] and mj["test_units"]
    for name in ("train.txt", "val.txt", "test.txt", "MANIFEST.txt"):
        assert (tmp_path / "ref" / name).read_bytes() == (tmp_path / "port" / name).read_bytes()
    held = mj["val_units"] + mj["test_units"]
    assert sorted(corpus.read_manifest_units(str(tmp_path / "port" / "MANIFEST.txt"))) == sorted(held)
    # excluded units reach no split
    mx = corpus.build_corpus(str(tmp_path / "excl"), exclude_units=held, **kw)
    assert mx["excluded_units"] == sorted(held) and not set(held) & set(mx["val_units"] + mx["test_units"])
    kept = (tmp_path / "excl" / "train.txt").read_text(encoding="utf-8")
    gone = (tmp_path / "ref" / "val.txt").read_text(encoding="utf-8").split(corpus.DOC_SEP)[0]
    assert gone not in kept


@pytest.fixture(scope="module")
def bpe():
    return corpus.ByteLevelBPE(os.path.join(DATA, "tokenizer.json"))


def test_encode_file_matches_val_npy_first_chunk(tmp_path):
    with open(os.path.join(DATA, "val.txt"), encoding="utf-8") as f:
        chunk = f.read()[: 1 << 20]
    src = tmp_path / "chunk.txt"
    with open(src, "w", encoding="utf-8", newline="") as f:
        f.write(chunk)
    n = corpus.encode_file(os.path.join(DATA, "tokenizer.json"), str(src), str(tmp_path / "chunk.npy"))
    got = np.load(tmp_path / "chunk.npy")
    want = np.load(os.path.join(DATA, "val.npy"))
    assert got.dtype == np.uint16 and n == got.size > 100_000
    assert np.array_equal(got, want[:n])


STRINGS = [
    "naïve façade — Ğğ ǅ ß ﬁ déjà-vu, Σίσυφος, Москва, 東京タワー, 한국어",
    "x² + y³ = ½ · Ⅻ ⅷ ① ٣٤ ६ 𝟙𝟚 ¾",
    "sep\x1cfile\x1dgroup\x1erecord\x1funit \x1c \x1f\x1c",
    "tabs\t\tand  two   three    spaces\n\n\nnewlines \r\n crlf nbsp ls ps　ideo\u0085nel\x0b\x0c",
    "<s>hello</s><pad>  <s> spaced </s>\n<pad><pad></s><s>",
    "it's we're they've I'm you'll he'd 'S 't ''s  's",
    "def f(x):\n    return x  # comment\n\n\n    \n" + "    " * 5 + "end",
    "emoji 🙂🙃 👩‍👩‍👧 zwj‍zwnj‌ bidi‮",
    "   leading and trailing   ",
    "\n",
    "",
]


def test_bpe_matches_tokenizers(bpe):
    tokenizers = pytest.importorskip("tokenizers")
    ref = tokenizers.Tokenizer.from_file(os.path.join(DATA, "tokenizer.json"))
    for s in STRINGS:
        assert bpe.encode(s) == ref.encode(s).ids, repr(s)
    mixed = "".join(STRINGS)
    assert bpe.encode(mixed) == ref.encode(mixed).ids


def test_bench_and_rates_match_reference(tmp_path):
    for n, s in ((10**9, 0.5), (123456789, 3e-4)):
        assert benchmark.bandwidth_gbs(n, s) == j_benchmark.bandwidth_gbs(n, s)
        assert benchmark.tflops(n, s) == j_benchmark.tflops(n, s)
    sec = benchmark.bench_fn(time.sleep, (0.002,), iters=5, reps=2, warmup=1)  # no card here: the host clock
    assert 0.002 <= sec < 0.05 and benchmark.bench_fn.last_fallback is False
    kw = dict(prompt_tokens=12, generated_tokens=40, ttft_s=0.0123, decode_s=0.8, step_times_s=[0.02, 0.018, 0.03])
    got, want = profiling.GenerationStats(**kw), j_profiling.GenerationStats(**kw)
    assert got.summary() == want.summary() and got.tokens_per_s == want.tokens_per_s
    assert profiling.GenerationStats().summary() == j_profiling.GenerationStats().summary()


def test_trace_and_scope_write_a_trace(tmp_path):
    @profiling.scope("decorated_scope")
    def work(x):
        return x @ x

    with profiling.trace(str(tmp_path)):
        with profiling.scope("block_scope"):
            work(torch.ones(16, 16))
        work(torch.ones(8, 8))
    (path,) = tmp_path.glob("trace_*.json")
    names = [e.get("name") for e in json.loads(path.read_text())["traceEvents"]]
    assert "block_scope" in names and names.count("decorated_scope") == 2
