"""Quantize-and-evaluate CLI (port of flexq_tpu/main.py, the reference's
algorithm/main.py surface): fake-quantize a model under a policy, then
measure its perplexity and zero-shot accuracy.

    python -m flexq_tpu_torch.main --model <hf-dir> --wbits 6 --abits 6 \\
        --flex_linear_quant --eval_ppl --ppl-data <wikitext2-dir> \\
        --tasks piqa --task-data-root <dir> [--smooth] [--export <out>] [--cpu]

The model directory (config.json + *.safetensors, LLaMA family or OPT) is
read by the port's own loader in f32, on the card unless ``--cpu``. The
policy comes from the preset system (``--flex_linear_quant``: the
per-architecture sensitivity result), with the group sizes and
``--asymmetric`` applied to the fake-quant eval; ``--smooth`` folds
SmoothQuant-style scales into the weights first; ``--export`` writes the
packed serving checkpoint (symmetric 128-groups only). Prints one JSON
line of results.

The tokenizer (the directory's, through ``transformers``) is loaded only
on the paths that tokenize: ``--eval_ppl``, ``--tasks``, and ``--smooth``
with ``--ppl-data``; the datasets are ``datasets.save_to_disk``
directories, read through ``datasets``. ``--smooth`` with ``--export`` is
refused: the exporter re-reads the model directory, so the checkpoint
would not be smoothed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os

log = logging.getLogger("flexq_tpu_torch")


def build_policy(args):
    from flexq_tpu_torch.config import QuantPolicy

    if args.wbits >= 16:
        return QuantPolicy.fp16(args.arch)
    if args.flex_linear_quant:
        if args.arch == "opt":
            return QuantPolicy.opt_flex(args.wbits, args.abits)
        return QuantPolicy.llama_flex(args.wbits, args.abits)
    return QuantPolicy.uniform(args.arch, args.wbits, args.abits)


def _load_tokenizer(model_dir: str):
    """The model directory's tokenizer (``transformers``, local files only)."""
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError("tokenizing (--eval_ppl, --tasks, --smooth with --ppl-data) needs the `transformers` "
                          "package") from e
    return AutoTokenizer.from_pretrained(model_dir, use_fast=True, local_files_only=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", required=True, help="HF model directory")
    ap.add_argument("--arch", default="llama", choices=["llama", "opt"])
    ap.add_argument("--wbits", type=int, default=6)
    ap.add_argument("--abits", type=int, default=6)
    ap.add_argument("--flex_linear_quant", action="store_true",
                    help="per-architecture sensitivity policy (reference default)")
    ap.add_argument("--w_group_size", type=int, default=128)
    ap.add_argument("--a_group_size", type=int, default=128)
    ap.add_argument("--asymmetric", action="store_true",
                    help="asymmetric quantization (symmetric by default)")
    ap.add_argument("--smooth", action="store_true",
                    help="SmoothQuant-style folds before quantization")
    ap.add_argument("--smooth-alpha", type=float, default=0.5)
    ap.add_argument("--calib-samples", type=int, default=8)
    ap.add_argument("--seqlen", type=int, default=2048)
    ap.add_argument("--eval_ppl", action="store_true")
    ap.add_argument("--ppl-data", default=None,
                    help="datasets.save_to_disk dir for wikitext2")
    ap.add_argument("--tasks", default="",
                    help="comma list: piqa,arc_easy,arc_challenge,boolq,...")
    ap.add_argument("--task-data-root", default=None,
                    help="root dir holding <task>/ dataset dirs")
    ap.add_argument("--export", default=None, help="write packed checkpoint dir")
    ap.add_argument("--seed", type=int, default=2, help="(reference main.py:205)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    import numpy as np
    import torch

    from flexq_tpu_torch.config import require_servable
    from flexq_tpu_torch.models.hf_loader import load_checkpoint

    policy = dataclasses.replace(
        build_policy(args),
        w_group_size=args.w_group_size,
        a_group_size=args.a_group_size,
        symmetric=not args.asymmetric,
    )
    if args.eval_ppl and not args.ppl_data:
        ap.error("--eval_ppl needs --ppl-data")
    if args.tasks and not args.task_data_root:
        ap.error("--tasks needs --task-data-root")
    if args.export:
        if args.smooth:
            ap.error("--smooth with --export: the exporter re-reads the model directory, so the exported "
                     "checkpoint would not be smoothed")
        try:
            require_servable(policy)
        except ValueError as e:
            ap.error(f"--export: {e}")
    device = "cpu" if args.cpu else "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 oracle stays f32
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False  # a bf16 one reduces in f32
    np.random.seed(args.seed)

    log.info("loading %s", args.model)
    cfg, params = load_checkpoint(args.model, dtype=torch.float32, device=device)
    if cfg.arch != args.arch:
        ap.error(f"--arch {args.arch}, but {args.model} holds a {cfg.arch} model")
    tokenizer = None
    if args.eval_ppl or args.tasks or (args.smooth and args.ppl_data):
        tokenizer = _load_tokenizer(args.model)
    results = {"model": args.model, "wbits": args.wbits, "abits": args.abits}

    if args.smooth:
        from flexq_tpu_torch.quant.smooth import collect_llama_act_stats, collect_opt_act_stats, smooth_llama, smooth_opt

        calib = np.random.randint(0, cfg.vocab_size, (1, min(args.seqlen, 512)), dtype=np.int64)
        if args.ppl_data:
            from flexq_tpu_torch.eval.data import calib_samples, load_wikitext2_text

            text = load_wikitext2_text(args.ppl_data, split="test")
            calib = calib_samples(text, tokenizer, nsamples=args.calib_samples, seqlen=min(args.seqlen, 512),
                                  seed=args.seed)[:1]
        log.info("smoothing (alpha=%.2f)", args.smooth_alpha)
        if args.arch == "opt":
            stats = collect_opt_act_stats(params, cfg, calib)
            params = smooth_opt(params, cfg, stats, alpha=args.smooth_alpha)
        else:
            stats = collect_llama_act_stats(params, cfg, calib)
            params = smooth_llama(params, cfg, stats, alpha=args.smooth_alpha)

    if args.arch == "opt":
        from flexq_tpu_torch.models.opt import fake_quant_weights, forward
    else:
        from flexq_tpu_torch.models.llama import fake_quant_weights, forward
    # the weights fake-quantized once (the activations at run time, per call)
    qparams = fake_quant_weights(params, policy) if args.wbits < 16 else params
    del params

    def fwd(ids):
        return forward(qparams, cfg, ids, policy=policy)

    if args.eval_ppl:
        from flexq_tpu_torch.eval.data import load_wikitext2_text, tokenize_eval_ids
        from flexq_tpu_torch.eval.ppl import perplexity

        text = load_wikitext2_text(args.ppl_data, split="test")
        windows = tokenize_eval_ids(text, tokenizer, seqlen=args.seqlen)
        ppl = perplexity(fwd, windows)
        results["wikitext2_ppl"] = ppl
        log.info("wikitext2 ppl: %.4f", ppl)

    if args.tasks:
        from flexq_tpu_torch.eval.zeroshot import evaluate_multiple_choice, load_task_items

        task_results = {}
        for task in args.tasks.split(","):
            items = load_task_items(task, os.path.join(args.task_data_root, task))
            task_results[task] = evaluate_multiple_choice(fwd, tokenizer, items)
            log.info("%s: %s", task, task_results[task])
        results["tasks"] = task_results

    if args.export:
        from flexq_tpu_torch.export.exporter import export_checkpoint

        del qparams
        log.info("exporting packed checkpoint -> %s", args.export)
        pol = ("opt_flex" if args.arch == "opt" else "llama_flex") if args.flex_linear_quant else "uniform"
        export_checkpoint(args.model, args.export, policy_name=pol, wbits=args.wbits, abits=args.abits,
                          device=device)
        results["exported"] = args.export

    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
