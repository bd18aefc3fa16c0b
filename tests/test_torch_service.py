"""The port's checkpoints, HTTP service and torch API vs flexq_tpu on the CPU.

A tiny transformers LLaMA (2 layers, hidden 128, 2 heads of 64 over one kv
head, FFN 320 padded to 384, vocab 320, 128 positions; its matrices scaled
by 4 so greedy choices are not near-ties) and a tiny OPT, made in memory
from a seed. Held against the reference:
  * the safetensors reader and writer against the ``safetensors`` package,
    both directions, byte for byte;
  * ``quantize_linear`` (the exporter's quantizer) against
    ``flexq_tpu.export.native`` at 6, 4 and 8 bits: codes, planes and the
    f32 scales' bits equal;
  * ``config_from_hf`` for llama, mistral, qwen2, gemma and opt
    (``dataclasses.asdict`` equal), and a Gemma config whose two activation
    keys disagree refused; ``load_checkpoint`` / ``from_hf_*`` trees equal;
  * the export round trip under llama_flex, weight-only W4, uniform W8A8
    and llama_flex with a W6 head: each package loads the other's
    directory into the same tree, bit for bit, the files and meta.json are
    equal, and tensor-parallel checkpoints are refused;
  * ``attention_core`` (the dense and the blockwise path) and
    ``causal_mask`` against the reference's;
  * the cache-less ``forward_serve``: W6Ax within 1e-4 of max |logit| and
    OPT opt_flex within 1e-4 (the producers' codes at most one off and the
    reference's handed on, as tests/test_torch_opt.py does), the W6A16
    layer within 1e-2 (it rounds every GEMM input to bf16);
  * the tokenizers' ids (``ByteTokenizer``, ``HFTokenizer`` over
    data_tiny's tokenizer.json);
  * the HTTP service over a paged CPU scheduler: completions' tokens equal
    to a direct BatchScheduler run, streaming equal to non-streaming, chat,
    stop truncation, /metrics, a 429 under max_pending, beam requests
    served (a streamed one's 400), and the stream helpers equal to the
    reference's on a fixed table;
  * ``FlexQCausalLM``: forward within 1e-2 of max |logit| of the
    reference adapter's, greedy generate tokens equal, sampling seeded.
"""

import dataclasses
import json
import os
import shutil
import threading
import urllib.error
import urllib.request
from http.client import HTTPConnection

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import load_file as st_load_file, save_file as st_save_file
from transformers import (
    GemmaConfig,
    LlamaConfig,
    LlamaForCausalLM,
    MistralConfig,
    OPTConfig,
    OPTForCausalLM,
    Qwen2Config,
)

from flexq_tpu.bindings import FlexQCausalLM as JFlexQCausalLM
from flexq_tpu.config import QuantPolicy as JQuantPolicy
from flexq_tpu.export import export_checkpoint as j_export_checkpoint, load_packed as j_load_packed
from flexq_tpu.export.native import group_quant_np, quant_pack4, quant_pack6
from flexq_tpu.models import hf_loader as j_hf_loader
from flexq_tpu.models import quantized as j_quantized
from flexq_tpu.serve import http as j_http
from flexq_tpu.serve import tokenizer as j_tokenizer
from flexq_tpu_torch.bindings import FlexQCausalLM
from flexq_tpu_torch.config import QuantPolicy
from flexq_tpu_torch.convert import params_from_numpy
from flexq_tpu_torch.export import safetensors_io
from flexq_tpu_torch.export.exporter import export_checkpoint, load_packed, load_packed_sharded, main as export_main
from flexq_tpu_torch.parallel import Mesh
from flexq_tpu_torch.models import hf_loader, quantized
from flexq_tpu_torch.models.quantized import forward_serve, quantize_linear, quantize_params
from flexq_tpu_torch.quant.quantizer import CLIPMIN, QuantSpec
from flexq_tpu_torch.serve import http as t_http, tokenizer
from flexq_tpu_torch.serve.sampling import SamplingParams
from flexq_tpu_torch.serve.scheduler import BatchScheduler

LLAMA = dict(vocab_size=320, hidden_size=128, intermediate_size=320, num_hidden_layers=2, num_attention_heads=2,
             num_key_value_heads=1, max_position_embeddings=128, tie_word_embeddings=False)
OPT = dict(vocab_size=320, hidden_size=128, ffn_dim=256, num_hidden_layers=2, num_attention_heads=2,
           max_position_embeddings=128, word_embed_proj_dim=128)
SCALE = 4.0  # the init's matrices scaled so the tiny models' greedy choices are not near-ties


def hf_model(cls, config, seed):
    torch.manual_seed(seed)
    model = cls(config).eval()
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim == 2:
                p.mul_(SCALE)
    return model


@pytest.fixture(scope="module")
def llama(tmp_path_factory):
    """(transformers model, its HF directory, the port's llama_flex tree on
    the CPU in f32)."""
    model = hf_model(LlamaForCausalLM, LlamaConfig(**LLAMA), 0)
    d = str(tmp_path_factory.mktemp("hf_llama"))
    model.save_pretrained(d, safe_serialization=True)
    cfg = hf_loader.config_from_hf(model.config)
    tree = quantize_params(hf_loader.from_hf_llama(model, device="cpu"), cfg, QuantPolicy.llama_flex(),
                           dtype=torch.float32, device="cpu")
    return model, d, cfg, tree


def flat(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def assert_torch_tree_equal(got, want):
    """Same keys, dtypes and bits (torch trees)."""
    a, b = flat(got), flat(want)
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), jax.tree_util.keystr(k)


def assert_np_tree_equal(got, want):
    """Same keys, dtypes and bits (reference trees, as numpy)."""
    a, b = flat(jax.tree_util.tree_map(np.asarray, got)), flat(jax.tree_util.tree_map(np.asarray, want))
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, jax.tree_util.keystr(k)
        assert x.tobytes() == y.tobytes(), jax.tree_util.keystr(k)


# ---- safetensors ----------------------------------------------------------


def test_safetensors_reads_and_writes_the_packages_files(tmp_path):
    g = torch.Generator().manual_seed(0)
    tensors = {
        "w.hi": torch.randint(-128, 128, (64, 384), dtype=torch.int8, generator=g),
        "w.scale": torch.rand((2, 384), generator=g),
        "embed": torch.randn((320, 128), generator=g).to(torch.bfloat16),
        "ids": torch.randint(0, 1 << 30, (7, 3), dtype=torch.int32, generator=g),
        "scalar": torch.tensor(1.5),
    }
    ours, theirs = str(tmp_path / "ours.safetensors"), str(tmp_path / "theirs.safetensors")
    safetensors_io.save_file(tensors, ours, metadata={"format": "pt"})
    st_save_file(tensors, theirs, metadata={"format": "pt"})
    for got in (st_load_file(ours), safetensors_io.load_file(theirs)):
        assert set(got) == set(tensors)
        for k, t in tensors.items():
            assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
    with safe_open(ours, framework="pt") as f:
        assert f.metadata() == {"format": "pt"}
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


# ---- the exporter's quantizer ---------------------------------------------


@pytest.mark.parametrize("bits", [6, 4, 8])
def test_quantize_linear_matches_native(bits):
    rng = np.random.default_rng(bits)
    w = (rng.standard_normal((512, 384)) * 0.1).astype(np.float32)
    w[128:256, :7] = 0.0  # all-zero groups: the scale clamps to CLIPMIN
    got = quantize_linear(torch.from_numpy(w), QuantSpec(bits, True, 128))
    if bits == 6:
        want = dict(zip(("hi", "lo", "scale"), quant_pack6(w)))
    elif bits == 4:
        want = dict(zip(("q4", "scale"), quant_pack4(w)))
    else:
        want = dict(zip(("q8", "scale"), group_quant_np(w, 8)))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].numpy().dtype == v.dtype and got[k].numpy().tobytes() == np.ascontiguousarray(v).tobytes(), k
    # the numpy path gives the same scale bits as the native one
    np.testing.assert_array_equal(group_quant_np(w, bits)[1].view(np.uint32), got["scale"].numpy().view(np.uint32))


# ---- HF loading -----------------------------------------------------------

HF_CONFIGS = {
    "llama": LlamaConfig(**LLAMA, rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                                                "high_freq_factor": 4.0, "original_max_position_embeddings": 64}),
    "mistral": MistralConfig(vocab_size=320, hidden_size=128, intermediate_size=320, num_hidden_layers=2,
                             num_attention_heads=2, num_key_value_heads=1, sliding_window=48, head_dim=64),
    "qwen2": Qwen2Config(vocab_size=320, hidden_size=128, intermediate_size=320, num_hidden_layers=2,
                         num_attention_heads=2, num_key_value_heads=1, tie_word_embeddings=False),
    "gemma": GemmaConfig(vocab_size=320, hidden_size=128, intermediate_size=320, num_hidden_layers=2,
                         num_attention_heads=2, num_key_value_heads=1, head_dim=64,
                         hidden_activation="gelu_pytorch_tanh"),
    "opt": OPTConfig(**OPT),
}


@pytest.mark.parametrize("family", list(HF_CONFIGS))
def test_config_from_hf_matches_jax(family):
    hf = HF_CONFIGS[family]
    for src in (hf, json.loads(hf.to_json_string())):  # the object and its config.json
        assert dataclasses.asdict(hf_loader.config_from_hf(src)) == dataclasses.asdict(j_hf_loader.config_from_hf(src))


def test_gemma_activation_conflict_is_refused():
    hf = GemmaConfig(vocab_size=320, hidden_size=128, intermediate_size=320, num_hidden_layers=2,
                     num_attention_heads=2, num_key_value_heads=1, head_dim=64,
                     hidden_act="gelu", hidden_activation="gelu_pytorch_tanh")
    assert j_hf_loader.config_from_hf(hf).act == "gelu"  # the reference takes hidden_activation
    with pytest.raises(ValueError, match="hidden_act"):
        hf_loader.config_from_hf(hf)


def test_loaders_match_jax(llama):
    model, d, _, _ = llama
    _, jtree = j_hf_loader.load_checkpoint(d, dtype=jnp.float32)
    cfg, tree = hf_loader.load_checkpoint(d, dtype=torch.float32, device="cpu")
    assert_torch_tree_equal(tree, params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree), device="cpu"))
    assert_torch_tree_equal(hf_loader.from_hf_llama(model, device="cpu"), tree)
    opt = hf_model(OPTForCausalLM, OPTConfig(**OPT), 1)
    jopt = jax.tree_util.tree_map(np.asarray, j_hf_loader.from_hf_opt(opt))
    assert_torch_tree_equal(hf_loader.from_hf_opt(opt, device="cpu"), params_from_numpy(jopt, device="cpu"))


# ---- the packed checkpoint ------------------------------------------------

EXPORTS = {
    "llama_flex": dict(policy_name="llama_flex"),
    "weight_only_w4": dict(policy_name="weight_only", wbits=4),
    "uniform_w8a8": dict(policy_name="uniform", wbits=8, abits=8),
    "head_bits_6": dict(policy_name="llama_flex", head_bits=6),
}


@pytest.mark.parametrize("case", list(EXPORTS))
def test_export_round_trip_matches_jax(llama, tmp_path, case):
    model, d, cfg, tree = llama
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    j_export_checkpoint(d, jdir, **EXPORTS[case])
    export_checkpoint(d, tdir, device="cpu", **EXPORTS[case])
    with open(os.path.join(jdir, "meta.json")) as a, open(os.path.join(tdir, "meta.json")) as b:
        assert json.load(a) == json.load(b)
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    for name in names:
        with open(os.path.join(jdir, name), "rb") as a, open(os.path.join(tdir, name), "rb") as b:
            assert name == "meta.json" or a.read() == b.read(), name
    # the JAX directory loaded by the port: the reference's tree, leaf for leaf
    jcfg, jpol, jtree = j_load_packed(jdir)
    tcfg, tpol, ttree = load_packed(jdir, device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tpol.weight_bits, tpol.act_bits) == (jpol.weight_bits, jpol.act_bits)
    assert_torch_tree_equal(ttree, params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree), device="cpu"))
    # the port's directory loaded by the reference: the JAX directory's tree
    assert_np_tree_equal(j_load_packed(tdir)[2], jtree)
    if case == "llama_flex":
        # against quantize_params of the same dense weights: equal but in the
        # padded scale columns, which the exporter quantizes (zero columns:
        # CLIPMIN) and quantize_params pads with 0; the reference's two paths
        # differ there the same way (planes equal, pad columns never read)
        want = quantize_params(hf_loader.from_hf_llama(model, device="cpu"), cfg, tpol, device="cpu")
        for (k, x), (_, y) in zip(flat(ttree), flat(want)):
            if jax.tree_util.keystr(k).endswith("['scale']") and not torch.equal(x, y):
                n = int((x != y).any(0).int().argmax())  # the first pad column
                assert torch.equal(x[:, :n], y[:, :n]) and bool((x[:, n:] == CLIPMIN).all()), k
                assert bool((y[:, n:] == 0).all()) and n % 64 == 0
            else:
                assert x.dtype == y.dtype and torch.equal(x, y), jax.tree_util.keystr(k)


def test_tensor_parallel_checkpoints_are_refused(tmp_path):
    """A tp = 2 export (the CLI's --tp 2) is served only on a mesh of its
    tp: load_packed reads its ranks (rank=r, or the whole tree), a rank
    past tp is refused, and load_packed_sharded refuses a mesh of another
    tp (the HTTP server's refusal); a tp = 1 export has only rank 0."""
    # hidden 256, FFN 512: every row-parallel K splits into 128-row groups at tp = 2
    d = str(tmp_path / "hf")
    hf_model(LlamaForCausalLM, LlamaConfig(**dict(LLAMA, hidden_size=256, intermediate_size=512)), 0).save_pretrained(
        d, safe_serialization=True)
    out, out1 = str(tmp_path / "tp2"), str(tmp_path / "tp1")
    export_main(["--model-dir", d, "--out", out, "--tp", "2", "--device", "cpu"])
    export_main(["--model-dir", d, "--out", out1, "--device", "cpu"])
    assert_torch_tree_equal(load_packed(out, device="cpu")[2], load_packed(out1, device="cpu")[2])
    with pytest.raises(ValueError, match="rank"):
        load_packed(out, rank=2, device="cpu")
    with pytest.raises(ValueError, match="rank"):
        load_packed(out1, rank=1, device="cpu")
    one = Mesh(tp=1, dp=1, rank=0, device=torch.device("cpu"), backend="gloo", model_group=None, data_group=None)
    with pytest.raises(ValueError, match="--tp 2"):
        load_packed_sharded(out, one)
    with pytest.raises(ValueError, match="--tp 1"):
        load_packed_sharded(out1, dataclasses.replace(one, tp=2))


# ---- the cache-less forward -----------------------------------------------


def on_reference_codes(monkeypatch, names):
    """The reference's producers record their codes; the port's, called in
    the same order, check theirs (at most one code off, scales to 1e-5) and
    hand the reference's on. Returns the calls not yet consumed."""
    calls = []
    for name in names:
        def record(*a, _ref=getattr(j_quantized, name), **k):
            out = _ref(*a, **k)
            calls.append((np.array(out[0]), np.array(out[1])))
            return out

        def check(*a, _own=getattr(quantized, name), _name=name, **k):
            q, s, *rest = _own(*a, **k)
            ref_q, ref_s = calls.pop(0)
            assert (q.numpy() != ref_q).sum() <= 1, f"{_name}: more than one code off the reference"
            np.testing.assert_allclose(s.numpy(), ref_s, rtol=1e-5)
            return (torch.from_numpy(ref_q), torch.from_numpy(ref_s), *rest)

        monkeypatch.setattr(j_quantized, name, record)
        monkeypatch.setattr(quantized, name, check)
    return calls


@pytest.mark.parametrize("case,tol", [("W6Ax", 1e-4), ("W6A16", 1e-2), ("OPT", 1e-4)])
def test_cacheless_forward_matches_jax(llama, monkeypatch, case, tol):
    if case == "OPT":
        model = hf_model(OPTForCausalLM, OPTConfig(**OPT), 1)
        dense, jdense = hf_loader.from_hf_opt(model, device="cpu"), j_hf_loader.from_hf_opt(model)
        jpol, pol, producers = JQuantPolicy.opt_flex(), QuantPolicy.opt_flex(), ("layernorm_quant", "quant_act",
                                                                               "relu_quant")
    else:
        model = llama[0]
        dense, jdense = hf_loader.from_hf_llama(model, device="cpu"), j_hf_loader.from_hf_llama(model)
        jpol, pol, producers = JQuantPolicy.llama_flex(), QuantPolicy.llama_flex(), ("rmsnorm_quant", "quant_act",
                                                                                   "glu_quant")
    cfg, jcfg = hf_loader.config_from_hf(model.config), j_hf_loader.config_from_hf(model.config)
    jq = j_quantized.quantize_params(jdense, jcfg, jpol, dtype=jnp.float32)
    tq = quantize_params(dense, cfg, pol, dtype=torch.float32, device="cpu")
    bf16 = case == "W6A16"
    calls = [] if bf16 else on_reference_codes(monkeypatch, producers)
    ids = np.random.default_rng(5).integers(0, 320, (2, 20))
    ref, jstate = j_quantized.forward_serve(jq, jcfg, jpol, jnp.asarray(ids), prefill_bf16=bf16)
    got, state = forward_serve(tq, cfg, pol, torch.from_numpy(ids), prefill_bf16=bf16, device="cpu")
    assert jstate is None and state is None and not calls
    ref = np.asarray(ref)
    assert got.shape == ref.shape == (2, 20, 320)
    assert np.abs(got.numpy() - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("l,window", [(20, None), (2048, None), (2048, 300)])
def test_attention_core_and_causal_mask_match_jax(l, window):
    """The cache-less attention: the causal (and windowed) mask equal, and the
    f32 core within 1e-5 of max |out| (past 1024 keys both take the
    blockwise online softmax) with GQA 2:1."""
    from flexq_tpu.models import llama as j_llama

    from flexq_tpu_torch.models import llama

    rng = np.random.default_rng(l)
    q = rng.standard_normal((1, l, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((1, l, 2, 16)).astype(np.float32) for _ in "kv")
    jm, tm = j_llama.causal_mask(l, l, window=window), llama.causal_mask(l, l, window=window)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    ref = np.asarray(j_llama.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm, 2))
    got = llama.attention_core(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tm, 2).numpy()
    assert got.shape == ref.shape == (1, l, 64)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


# ---- tokenizers -----------------------------------------------------------

TEXTS = ["hello world", "héllo, wörld — ✓", "", "a\nb\tc  d", "<|user|>\nhi\n"]
CHAT = [{"role": "system", "content": "be brief"}, {"role": "user", "content": "hi ✓"}]


def test_tokenizers_match_jax(tmp_path):
    shutil.copy(os.path.join(os.path.dirname(__file__), "..", "data_tiny", "tokenizer.json"), tmp_path)
    with open(tmp_path / "tokenizer_config.json", "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", "bos_token": "<s>", "eos_token": "</s>"}, f)
    pairs = [(tokenizer.ByteTokenizer(), j_tokenizer.ByteTokenizer()),
             (tokenizer.load_tokenizer("byte"), j_tokenizer.load_tokenizer(None)),
             (tokenizer.load_tokenizer(str(tmp_path)), j_tokenizer.HFTokenizer(str(tmp_path)))]
    assert isinstance(pairs[2][0], tokenizer.HFTokenizer)
    for ours, ref in pairs:
        assert (ours.eos_id, ours.bos_id) == (ref.eos_id, ref.bos_id)
        for text in TEXTS:
            for bos in (True, False):
                ids = ours.encode(text, add_bos=bos)
                assert ids == ref.encode(text, add_bos=bos)
                assert ours.decode(ids) == ref.decode(ids)
        assert ours.apply_chat_template(CHAT) == ref.apply_chat_template(CHAT)
    assert pairs[0][0].decode(pairs[0][0].encode(TEXTS[1])) == TEXTS[1]


# ---- the HTTP service -----------------------------------------------------

SCHED = dict(num_slots=3, max_seq_len=128, paged=True, page_size=128, prefill_chunk=32)
REQS = [(np.random.default_rng(10 + n).integers(3, 320, n).tolist(), m) for n, m in ((5, 8), (40, 6), (70, 7), (12, 9))]


def post(port, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return json.loads(r.read())


def post_error(port, path, payload):
    with pytest.raises(urllib.error.HTTPError) as e:
        post(port, path, payload)
    return e.value.code, dict(e.value.headers), json.loads(e.value.read())


def direct_run(tree, cfg, reqs):
    sched = BatchScheduler(tree, cfg, QuantPolicy.llama_flex(), device="cpu", **SCHED)
    ids = [sched.add_request(p, max_new_tokens=m, eos_id=-1) for p, m in reqs]
    out = sched.run()
    return [out[i] for i in ids]


@pytest.fixture(scope="module")
def served(llama):
    _, _, cfg, tree = llama
    sched = BatchScheduler(tree, cfg, QuantPolicy.llama_flex(), device="cpu", **SCHED)
    server, service, port = t_http.serve_background(sched, model_name="tiny-w6")
    yield port, service, sched
    service.shutdown()
    server.shutdown()


def test_http_tokens_equal_a_direct_scheduler_run(llama, served):
    """Concurrent id-prompt completions (one prompt above the 64-token W6A16
    threshold, two chunked) give the tokens of the same requests run
    directly through a BatchScheduler."""
    _, _, cfg, tree = llama
    port, service, sched = served
    got = [None] * len(REQS)

    def call(r):
        p, m = REQS[r]
        body = post(port, "/v1/completions", {"prompt": p, "max_tokens": m, "temperature": 0, "eos_id": -1})
        got[r] = body["choices"][0]["token_ids"]

    threads = [threading.Thread(target=call, args=(r,)) for r in range(len(REQS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert got == direct_run(tree, cfg, REQS)
    met = get(port, "/metrics")
    assert met["pages_free"] == met["pages_total"] - 1  # every page back (page 0 is the garbage page)
    assert met["worker_failed_ticks"] == 0
    assert get(port, "/health")["ok"] and get(port, "/v1/models")["data"][0]["id"] == "tiny-w6"


def stream(port, path, body):
    conn = HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, json.dumps({**body, "stream": True}), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    text, ids, finish = "", [], None
    for raw in resp.fp:
        line = raw.decode().strip()
        if line == "data: [DONE]":
            break
        if line.startswith("data: "):
            ch = json.loads(line[6:])["choices"][0]
            text += ch.get("text") or ch.get("delta", {}).get("content", "")
            ids += ch.get("token_ids", [])
            finish = ch["finish_reason"] or finish
    conn.close()
    return text, ids, finish


def test_http_streaming_chat_and_stop(served):
    port, _, _ = served
    body = {"prompt": REQS[2][0], "max_tokens": 8, "temperature": 0, "eos_id": -1, "logprobs": 1}
    full = post(port, "/v1/completions", body)["choices"][0]
    body.pop("logprobs")
    text, ids, finish = stream(port, "/v1/completions", body)
    assert (text, ids, finish) == (full["text"], full["token_ids"], "length")
    assert len(full["logprobs"]["token_logprobs"]) == 8
    # a stop string cuts the text, its ids and its logprobs
    assert len(full["text"]) >= 3
    stop = full["text"][1:3]
    cut = full["text"].find(stop)
    got = post(port, "/v1/completions", {**body, "stop": stop, "logprobs": 1})["choices"][0]
    assert got["text"] == full["text"][:cut] and got["finish_reason"] == "stop"
    assert got["token_ids"] == j_http._cut_token_ids(j_tokenizer.ByteTokenizer(), full["token_ids"], cut)
    assert len(got["logprobs"]["token_logprobs"]) == len(got["token_ids"])
    # chat over the byte tokenizer: the answer of the templated prompt
    chat = {"messages": CHAT, "max_tokens": 6, "temperature": 0, "eos_id": -1}
    ans = post(port, "/v1/chat/completions", chat)
    tok = tokenizer.ByteTokenizer()
    prompt = tok.encode(tok.apply_chat_template(CHAT))
    assert ans["usage"] == {"prompt_tokens": len(prompt), "completion_tokens": 6, "total_tokens": len(prompt) + 6}
    want = post(port, "/v1/completions", {"prompt": prompt, "max_tokens": 6, "temperature": 0, "eos_id": -1})
    assert ans["choices"][0]["message"]["content"] == want["choices"][0]["text"]
    text, _, finish = stream(port, "/v1/chat/completions", chat)
    assert (text, finish) == (want["choices"][0]["text"], "length")


def test_http_beam_requests_get_400(served):
    """Beam requests are served (best_of > n, use_beam_search, /generate's
    beam_width); the ones the reference refuses get a 400: a streamed beam
    request, and one wider than the scheduler's slots."""
    port, service, _ = served
    ans = post(port, "/v1/completions", {"prompt": [5, 6, 7], "max_tokens": 4, "best_of": 2, "eos_id": -1})
    assert len(ans["choices"]) == 1 and len(ans["choices"][0]["token_ids"]) == 4
    assert "beam_score" in ans["choices"][0]
    ans = post(port, "/v1/completions", {"prompt": [5, 6, 7], "max_tokens": 4, "use_beam_search": True, "n": 2,
                                         "eos_id": -1})
    assert len(ans["choices"]) == 2
    gen = post(port, "/generate", {"prompt_ids": [5, 6, 7], "max_new_tokens": 4, "beam_width": 2, "n_best": 2,
                                   "eos_id": -1})
    assert gen["tokens"] == gen["nbest"][0]["tokens"] and len(gen["nbest"]) == 2
    for path, body in (("/v1/completions", {"prompt": [5, 6, 7], "max_tokens": 4, "best_of": 2, "stream": True}),
                       ("/generate", {"prompt_ids": [5, 6, 7], "max_new_tokens": 4, "beam_width": 64})):
        code, _, err = post_error(port, path, body)
        assert code == 400, (path, err)
    # the service still answers, and no tick failed
    assert len(post(port, "/generate", {"prompt_ids": [5, 6, 7], "max_new_tokens": 3, "eos_id": -1})["tokens"]) == 3
    assert service.failed_ticks == 0


def test_http_queue_full_gets_429(llama):
    _, _, cfg, tree = llama
    sched = BatchScheduler(tree, cfg, QuantPolicy.llama_flex(), device="cpu", **SCHED)
    server, service, port = t_http.serve_background(sched, max_pending=1)
    try:
        service._stop = True  # no ticks: a submitted request stays pending
        service._worker.join(10)
        assert not service._worker.is_alive()
        service.submit([1, 2, 3], SamplingParams(), 4, -1)
        code, headers, err = post_error(port, "/generate", {"prompt_ids": [1, 2, 3], "max_new_tokens": 4})
        assert code == 429 and headers.get("Retry-After") == "1" and err["error"]["type"] == "rate_limit_error"
        met = get(port, "/metrics")
        assert (met["admission_rejected_total"], met["queue_depth"], met["max_pending"]) == (1, 1, 1)
    finally:
        server.shutdown()


STOP_CASES = [("ab�", []), ("ab��", []), ("helloEN", ["END"]), ("helloE", ["END"]),
              ("helloEND", ["END"]), ("helloX", ["END"]), ("abcSTO", ["STOP", "XY"]), ("", ["a"]),
              ("xyzxy", ["XY", "xyz"]), ("aaa", ["aa", "a"]), ("tést", ["és"])]


def test_stream_helpers_match_jax():
    for text, stops in STOP_CASES:
        assert t_http._stream_safe_len(text, stops) == j_http._stream_safe_len(text, stops)
        assert t_http._first_stop_hit(text, stops) == j_http._first_stop_hit(text, stops)
    tok = tokenizer.ByteTokenizer()
    ids = tok.encode("hello wörld", add_bos=False)
    for n in range(-1, 16):
        assert t_http._cut_token_ids(tok, ids, n) == j_http._cut_token_ids(j_tokenizer.ByteTokenizer(), ids, n)


# ---- FlexQCausalLM --------------------------------------------------------


def test_causal_lm_matches_jax_adapter(llama):
    model = llama[0]
    ref = JFlexQCausalLM.from_hf(model, JQuantPolicy.llama_flex(), max_seq_len=128, dtype=jnp.float32,
                                 kv_dtype=jnp.float32)
    ours = FlexQCausalLM.from_hf(model, QuantPolicy.llama_flex(), max_seq_len=128, dtype=torch.float32,
                                 kv_dtype=torch.float32, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(7).integers(0, 320, (2, 24)))
    want, got = ref(ids).numpy(), ours(ids)
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 24, 320)
    assert np.abs(got.numpy() - want).max() <= 1e-2 * np.abs(want).max()
    # seed 10's prompts: the reference's greedy choices are clear, top-2
    # margins of 2.4 % of max |logit| or more in its own forward over the
    # generated ids (seeds 7-9 and 11-14 each have a step below 1 %)
    prompt = torch.from_numpy(np.random.default_rng(10).integers(0, 320, (2, 8)))
    want_ids = ref.generate(prompt, max_new_tokens=6, eos_token_id=None)
    lg = ref(want_ids[:, :-1]).numpy()[:, 7:]
    top2 = np.sort(lg, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() >= 0.02 * np.abs(lg).max()
    assert torch.equal(ours.generate(prompt, max_new_tokens=6, eos_token_id=None), want_ids)
    # sampling is served: seeded, reproducible, the prompt echoed
    a = ours.generate(prompt, max_new_tokens=4, do_sample=True, temperature=0.8, top_k=20, seed=7, eos_token_id=None)
    b = ours.generate(prompt, max_new_tokens=4, do_sample=True, temperature=0.8, top_k=20, seed=7, eos_token_id=None)
    assert torch.equal(a, b) and a.shape == (2, 12) and torch.equal(a[:, :8], prompt)
