"""Train the tiny accuracy-gate model from scratch with the PyTorch port
(flexq_tpu_torch), on the card unless ``--device cpu``.

  python scripts/torch_train_tiny.py --corpus-dir <dir> --out-dir <dir> [--steps N] [--device cpu]

``--corpus-dir`` holds (or receives) the corpus splits, ``tokenizer.json``
and the token streams ``{train,val,test}.npy``; whatever is missing is made
there: the splits by ``build_corpus`` over the machine's own files, the
tokenizer by ``train_tokenizer`` (needs the ``tokenizers`` package), the
streams by the port's ``encode_file``. Copy ``data_tiny/tokenizer.json``
(and its ``val.npy`` / ``test.npy``) into the directory to train and
evaluate against the repo's tokens. The directory may not be
``data_tiny/``, which stays as it is.

Produces, in ``--out-dir``:
  best.npz       best-val checkpoint (+ .json meta)
  final.npz      last-step checkpoint
  history.jsonl  step/loss/val curves
and, as its last stdout line, a JSON summary (steps, seconds a step and
tokens/s over the timed steps, evals and checkpoints left out, the median
50-step block beside them, best val ppl).

The step runs eagerly in true f32 (TF32 off). The model is shaped for the
packed kernels: every linear K/N is a multiple of 128, vocab 8192 works
with the quantized head, GQA (8 heads / 4 kv) exercises the grouped paths.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def prepare_data(corpus_dir: str, vocab_size: int):
    from flexq_tpu_torch.train.corpus import build_corpus, encode_file, train_tokenizer

    if os.path.realpath(corpus_dir) == os.path.realpath(os.path.join(REPO, "data_tiny")):
        raise SystemExit("--corpus-dir may not be data_tiny/: copy what it needs into a directory of its own")
    if not os.path.exists(os.path.join(corpus_dir, "train.txt")):
        m = build_corpus(corpus_dir)
        print(f"corpus: {m['n_docs']} docs, {m['bytes']/1e6:.1f} MB", flush=True)
    tok_path = os.path.join(corpus_dir, "tokenizer.json")
    if not os.path.exists(tok_path):
        train_tokenizer(corpus_dir, vocab_size=vocab_size)
        print("tokenizer trained", flush=True)
    for split in ("train", "val", "test"):
        npy = os.path.join(corpus_dir, f"{split}.npy")
        if not os.path.exists(npy):
            n = encode_file(tok_path, os.path.join(corpus_dir, f"{split}.txt"), npy)
            print(f"{split}: {n} tokens", flush=True)
    return {
        s: np.load(os.path.join(corpus_dir, f"{s}.npy")) for s in ("train", "val", "test")
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus-dir", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--steps", type=int, default=24000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--inter", type=int, default=1408)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--kv-heads", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--eval-every", type=int, default=500)
    ap.add_argument("--max-minutes", type=float, default=70.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch

    from flexq_tpu_torch.config import ModelConfig
    from flexq_tpu_torch.kernels.common import resolve_device
    from flexq_tpu_torch.train.trainer import (
        TrainConfig,
        batch_iterator,
        init_params,
        loss_fn,
        make_optimizer,
        save_checkpoint,
        train_step,
        tree_leaves,
        windows_from_stream,
    )

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # true f32, as the reference trains
    torch.backends.cudnn.allow_tf32 = False

    data = prepare_data(args.corpus_dir, args.vocab)
    print({k: v.size for k, v in data.items()}, flush=True)

    cfg = ModelConfig.llama(
        vocab_size=args.vocab,
        hidden_size=args.hidden,
        intermediate_size=args.inter,
        num_layers=args.layers,
        num_heads=args.heads,
        num_kv_heads=args.kv_heads,
        max_seq_len=max(2048, args.seq),
        rope_theta=10000.0,
    )
    tc = TrainConfig(
        batch_size=args.batch, seq_len=args.seq, lr=args.lr, total_steps=args.steps
    )
    params = init_params(cfg, seed=0, device=dev)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"model: {n_params/1e6:.1f}M params on {dev}", flush=True)

    opt = make_optimizer(tc, params)
    opt_state = opt.init(params)

    val_windows = windows_from_stream(data["val"], args.seq)[:32]
    vb = 8
    val_batches = [
        torch.as_tensor(val_windows[i : i + vb], device=dev)
        for i in range(0, len(val_windows) - len(val_windows) % vb, vb)
    ]

    def eval_val(params):
        with torch.no_grad():
            return float(np.mean([float(loss_fn(params, cfg, b)) for b in val_batches]))

    os.makedirs(args.out_dir, exist_ok=True)
    hist = open(os.path.join(args.out_dir, "history.jsonl"), "a")
    it = batch_iterator(data["train"], tc, seed=1)
    best_val = float("inf")
    t0 = time.time()
    deadline = t0 + args.max_minutes * 60
    ema = None
    blocks = []  # seconds of each 50-step block between loss reads (evals and checkpoints left out)
    t_mark = time.perf_counter()
    for step in range(1, args.steps + 1):
        ids = torch.as_tensor(next(it), device=dev)
        params, opt_state, loss = train_step(params, opt_state, ids, cfg, opt)
        if step % 50 == 0:
            l = float(loss)  # sync
            blocks.append(time.perf_counter() - t_mark)
            ema = l if ema is None else 0.9 * ema + 0.1 * l
            if step % args.eval_every == 0 or step == args.steps:
                vl = eval_val(params)
                rec = {
                    "step": step,
                    "loss": round(l, 4),
                    "ema": round(ema, 4),
                    "val_loss": round(vl, 4),
                    "val_ppl": round(float(np.exp(vl)), 3),
                    "elapsed_s": round(time.time() - t0, 1),
                }
                print(json.dumps(rec), flush=True)
                hist.write(json.dumps(rec) + "\n")
                hist.flush()
                if vl < best_val:
                    best_val = vl
                    save_checkpoint(
                        os.path.join(args.out_dir, "best.npz"),
                        params,
                        cfg,
                        step,
                        extra={"val_loss": vl, "val_ppl": float(np.exp(vl))},
                    )
                if time.time() > deadline:
                    print("time budget reached", flush=True)
                    break
            t_mark = time.perf_counter()

    save_checkpoint(
        os.path.join(args.out_dir, "final.npz"), params, cfg, step,
        extra={"val_loss": eval_val(params)},
    )
    hist.close()
    print(f"done: best val ppl {np.exp(best_val):.3f}", flush=True)
    # seconds a step and tokens/s over every timed block; the first block holds the first use of every kernel
    # and allocation, so the median block is given beside them as the steady step
    timed, train_s = 50 * len(blocks), sum(blocks)
    print(json.dumps({
        "steps": step, "timed_steps": timed, "train_s": round(train_s, 3),
        "s_per_step": round(train_s / timed, 5) if blocks else None,
        "tokens_per_s": round(timed * tc.batch_size * tc.seq_len / train_s, 1) if blocks else None,
        "first_block_s": round(blocks[0], 3) if blocks else None,
        "s_per_step_median_block": round(float(np.median(blocks)) / 50, 5) if blocks else None,
        "best_val_ppl": round(float(np.exp(best_val)), 4),
        "peak_gib": round(torch.cuda.max_memory_allocated(dev) / 2**30, 2) if dev.type == "cuda" else None,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }), flush=True)

if __name__ == "__main__":
    main()
