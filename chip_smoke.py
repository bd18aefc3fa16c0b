#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (flexq_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line per result; any failure raises and the script
exits nonzero without the final line:
  1. device: the card's name and power limit (nvidia-smi), the kernel build
     (one nvcc per CUDA source, all started together);
  2. kernels: every kernel of the serve path against its plain PyTorch
     version at LLaMA-2-7B and OPT-6.7B shapes (the exact W6Ax GEMM at M = 4
     and 128, and the W4A8 and W8A8 GEMMs at M = 4, 8, 16, 32, 128 and 256,
     for the three 7B (K, N), and each at M = 4 for the packed head's 4096 x
     32768, each case also through the route its wrapper does not take
     where that route takes M; W6Ax at OPT's fc1 / fc2 at M = 4 and at its
     three (K, N) at M = 2048, and at the 7B (K, N) at M = 8, 32, 64 and 256,
     across its two routes (streaming, tensor cores); the producers at
     K = 4096 and F = 11264, and OPT's LayerNorm (K14) and ReLU (K15)
     producers at K = 4096 and F = 16384, each at M = 4, 8, 128, 256 and
     2048, beside an empty kernel's time (the launch floor); the registers
     and local-memory bytes of every instance of the exact GEMM's and the
     producers' kernels; attention
     at Lq = 1, 32 and 512 over a bf16 cache and at Lq = 1 and 512 over an
     int8 cache, H = 32, D = 128, S = 2048 (K6 and K9 also with the share of
     their bf16 outputs that part from the CPU's); the W6A16 and W4A16 GEMMs
     (K7, K11) at M = 2048 with and without the RoPE epilogue, at the
     scheduler's chunk M = 256 and at M = 4 (weight-only decode; K11 also at
     the head), K7 at M = 1024 for the three 7B (K, N) (a sequence-parallel
     rank's chunk of a 2048-token prompt, phase 11), the fused GLU (K8) at
     M = 2048 with separate and fused planes and at M = 256; the paged attention (K13) over a
     scrambled page table, B = 8 ragged rows up to 2048 keys, bf16 and int8
     pools, with and without a window; off the main path, K9 at Lq = 256
     over 768 keys, with a 512-key window and with GQA (H = 32, KVH = 8),
     K13 with GQA, K6 with GQA and with a 512-key window, timed, and all
     three at D = 64 and 256, correctness only), with the tolerance stated,
     and their device times from CUDA events (utils/benchmark.bench_fn:
     median, L2 flushed before each launch) beside the plain version's, the least time the card could
     take (bytes at 3.35 TB/s or operations at peak, H100 SXM data sheet)
     and, where one PyTorch call computes the same function, that call's
     (for the GEMMs, a dense bf16 matmul of the same shape as a yardstick);
  3. slice parity: a 2-layer model at full 7B width, forward_serve on the
     card against the same weights on the CPU (plain versions): a 16-token
     prompt through the W*Ax layer, and a 128-token prompt through the W*A16
     layer, each followed by two decode steps (max |dlogit| / max |logit|
     per step, argmax agreement per run): llama_flex (unfused, fuse=True,
     int8 cache, 16 tokens with a W6A8 head), weight-only W6A16, W4A8 and
     W8A8 (16 and 128 tokens), weight-only W4A16; OPT at OPT-6.7B width
     (16 tokens): opt_flex over a bf16 and an int8 cache, and from a 100-token
     prompt (K9's tiles into K4's codes), with a cache witness at 16, 40 and
     100 tokens, weight-only W4A16 and W8A8; the paged cache (bf16 and
     int8 pools): a ragged B = 4 batch prefilled through the scheduler's
     scratch-and-insert path, then two paged decode steps with per-row
     positions; and a cache witness: the W6Ax prompts of that batch over a
     bf16 and an int8 scratch, the activation and int8 K/V codes and the
     cache layers the CPU computes off the card's, and the logit gap with
     the card's codes handed on;
  4. end to end: the 32-layer LLaMA-2-7B shape with random weights (seeded
     torch.Generator, generated and quantized layer by layer on the card),
     greedy Engine.generate, max_seq_len 2048, B = 4, 32 new tokens:
     llama_flex with 32-token prompts (bf16 cache; with a torch.profiler
     breakdown: device time by kernel, device busy share of the wall time;
     and with a W6A8 lm_head), with 512-token prompts (the W6A16 prefill)
     over a bf16 cache, an int8 cache, a fuse=True tree, and
     prefill_chunk=256 (whose tokens must equal the whole-prompt run's);
     W4A8 with a W4A8 head (32- and 512-token prompts), the same tree
     weight-only (W4A16 with a W4A16 head, 512-token prompts), and W8A8
     (32-token prompts); the continuous-batching BatchScheduler (8 slots,
     16 ragged requests, 8 of them arriving after the 4th tick, 6 sharing a
     256-token prefix, prefill_chunk 256): paged bf16, dense bf16 (first
     tokens equal the paged run's), paged bf16 with prefix_cache (hits > 0),
     paged int8 and paged bf16 in a 24-page pool (preempts); every request
     must get exactly its max_new tokens and every paged pool its pages
     back; one torch.profiler breakdown of a paged run. Then OPT-6.7B (32
     layers, full width, random weights, tied head): opt_flex with 32-token
     prompts over a bf16 cache and 512-token prompts over an int8 cache
     (OPT never takes the W*A16 layer: the exact GEMMs run at M = 2048;
     profiled), the paged BatchScheduler over the same 16-request mix, and
     weight-only W4A16 with 32-token prompts. Each run's launch counts are
     zeroed just before it and read just after; every kernel of its path
     must launch. The launches of K2, K10, K12 and the producers are also
     logged by M (decode, prompts, scheduler chunks, OPT's 2048-row prompt);
  5. checkpoint and HTTP: an HF-layout LLaMA directory at LLaMA-2-7B widths
     (depth cut to 4 layers), random bf16 weights from a seed written through
     the port's safetensors writer; exported under llama_flex by
     `python -m flexq_tpu_torch.export.exporter` (a subprocess, on the card);
     load_packed on the card, every leaf torch.equal to quantize_params of
     the same dense weights (but the scales' pad columns) and the 32-token
     logits of the two trees equal; serve_background over a paged bf16
     BatchScheduler (8 slots, prefill_chunk 256): 12 concurrent
     /v1/completions requests with id prompts of 16-300 tokens (launch
     counts zeroed before and read after; every kernel of the scheduler's
     path must launch), each stream equal to the same requests run directly
     through a BatchScheduler, a streamed twin, a chat answer, a beam
     request (best_of 4, n 2) equal to a direct scheduler n-best, /metrics
     with every page free and no failed worker tick,
     HTTP latency p50 / max and tokens/s beside the direct run's tokens/s;
     `python -m flexq_tpu_torch.serve.http --checkpoint <dir> --port 0
     --paged` as a subprocess (one completion, /health, stopped); and
     FlexQCausalLM.from_packed(...).forward on the card against its plain CPU
     run (2e-2 of max |logit|);
  6. decoding modes, on phase 4's 32-layer LLaMA-2-7B model before it is
     freed (B = 4, 32-token prompts unless named): sampled Engine runs
     (temperature 0.8, top_p 0.9, repetition penalty 1.1; fused == step
     under one seed, and a repeat), greedy with logprobs (phase 4's tokens);
     speculative decoding on 64-token prompts that repeat a 16-token
     pattern, k = 4, 64 new tokens (the fused loop held to plain greedy
     over the decisive steps with n-gram drafts, and with oracle drafts,
     an ungated run's own streams, that run the accept path and must give
     its tokens; the B = 1 host loop likewise on two rows, held to plain
     greedy at B = 1; a hold needs a decisive step; a sampled run repeated;
     K9's short-prompt kernel on the verify windows, the exact GEMM at
     M = 20 on route A; the cost of the loop's host read of its flags: read
     every step against every 8th, ungated, and the host's time blocked in
     it); Engine beam search (B = 1, K = 4, 32 new); the scheduler's beam
     groups beside 4 regular requests over the dense, paged bf16 and paged
     int8 caches, each equal to the standalone n-best, every page free
     after.
  7. the captured decode step against the eager one, all in this call: on
     phase 4's 32-layer LLaMA-2-7B model, Engine.generate mode="fused" (a
     CUDA graph of the step, captured once and replayed) against
     mode="step" (eager), B = 4, 32 new, 32- and 512-token prompts, in turns
     fused, step, step, fused, tokens equal, the capture's ms apart, both
     loops profiled over 8 tokens; the scheduler's 16-request mix at
     fused_tick=8 against phase 4's fused_tick=0 runs (paged bf16, dense
     bf16, paged int8), streams equal, tokens/s, ms per decode tick and
     step, TTFT p50 / max, capture ms and replays per tick, one fused run
     profiled; then on OPT-6.7B the Engine at 32-token prompts and the
     paged bf16 scheduler likewise. A graph's replays add its capture's
     launches to the counts, so the kernels' line says what the card ran.
     (Since phase 7, every fused Engine run and every fused_tick > 0 run
     of the earlier phases, the HTTP server's CLI at its default
     --fused-tick 8 among them, replays its captured step.)
  8. the quantize-and-evaluate path, after the earlier models are freed
     (run inside phase 5's directory's lifetime), in true f32 (TF32 off):
     (a) the 32-layer LLaMA-2-7B shape with random f32 weights: the dense,
     fake-quant (fake_quant_weights + the dense forward) and packed
     (quantize_params + the cache-less forward_serve, f32) perplexities over
     the first four 2048-token windows of data_tiny/test.npy (B = 1, M =
     2048) under llama_flex, llama_flex(6, 8), llama_flex(4, 8) and W8A8,
     with the packed-vs-oracle and oracle-vs-dense logit gaps; each packed
     path held against its oracle at the reference's bounds (8e-2 of max
     |logit|, argmax agreement >= 0.75) on the first 2 layers of the same
     model (the depth of the reference's test), and at 32 layers, where
     flipped activation codes cascade, by a code witness: the oracle with
     the packed path's activation codes handed on agrees with the packed
     path within 1e-3 of max |logit| (its own codes off the handed ones by
     one code, on at most 1e-3 of the entries), beside the per-layer share
     of codes the oracle computes off the packed path's and the oracle
     against itself with its embedding one ulp off; (b) OPT-6.7B widths at
     8 layers under opt_flex likewise, held over the decisive rows (K14,
     K15); (c) 256 greedy tokens through Engine.generate (bf16 weights, W*Ax
     prompt, llama_flex and W4A8) teacher-forced through the bf16 fake-quant
     oracle: RMSE / std and greedy agreement, as it is and with the Engine's
     codes handed on (held there at 1e-2 and 0.95), and the oracle against
     the dense model; (d)
     analyze_act_sensitivity and smooth_llama at full width on a 512-token
     window of data_tiny/val.npy, the fold's identity held at 1e-3, the
     fake-quant ppl with and without it; (e) `python -m flexq_tpu_torch.main`
     with --smooth and with --export on phase 5's directory, the export
     equal to phase 5's leaf for leaf.
  9. train, then gate, after phase 8 has freed its models, in true f32:
     (a) a training corpus from this machine's own files (the port's
     build_corpus over numpy's site-packages and the system's docs; the
     units data_tiny/MANIFEST.txt holds out are excluded under every root
     before a file is read), encoded by the port's own BPE encoder with
     data_tiny/tokenizer.json, the encoder held to data_tiny/val.npy on the
     whole of val.txt (MB, tokens, seconds); (b) scripts/torch_train_tiny.py
     as a subprocess on the card at the reference's accuracy-gate shape
     (hidden 512, FFN 1408, 8 layers, 8 heads / 4 kv, head_dim 64, vocab
     8192, batch 64 x 512), evaluated on data_tiny/val.npy: seconds a step,
     tokens/s, the val curve; the val loss must fall and the final val ppl
     stay under 500; (c) the first 3 train_steps of a 2-layer model at the
     same widths on the card against the CPU (loss 1e-5 relative, the first
     step's parameters unchanged, the parameters after within the bounds
     card_vs_cpu states); (d) the trained best.npz over
     windows_from_stream(data_tiny/test.npy, 512): the dense f32 ppl, the
     fake-quant and packed (cache-less forward_serve, K1 / K4 / K5 with K2,
     K10 or K12 on route A) ppl under llama_flex, llama_flex(6, 8),
     llama_flex(4, 8) and W8A8, dppl against f32 (the reference's
     "dppl <= 0.1", reported), packed vs fake-quant within 1e-4 relative
     and within 0.3 of fake-quant's step from f32, and phase 8's code
     witness on the first 16 windows; (e) oracle parity over 256 greedy
     Engine.generate tokens on the trained weights (llama_flex, W4A8, held
     as in phase 8), and speculative decoding (mode="spec",
     k = 4) on four 128-token prompts from data_tiny/test.npy: acceptance,
     ms a token against greedy on the graph, tokens held to greedy over
     the decisive steps. Every kernel of the phase's path (K1-K6, K9, K10,
     K12) must launch; nothing is written into the repo.
 10. tensor and data parallelism, after phase 9 (phase 2 holds every kernel
     at a tp = 2 rank's local shapes): (b) a one-rank NCCL world in this
     process, the Engine's fused loop over forward_serve_tp on phase 4's
     32-layer model, its all-reduces and all-gathers captured in the step
     graph: the tokens of phase 4's 32-token run, decode ms a step beside
     the single-device graph's; (a) two child ranks (``chip_smoke.py
     --tp-rank r <dir>``) sharing the card over gloo: 2-layer forward parity
     at 7B and OPT-6.7B widths against one rank (logged; held by the code
     witness: the one rank with the TP run's activation codes and W*A16
     layer inputs handed on, 2e-2 of max |logit|), the Engine at tp = 2
     (mode="step"; held by the witness) and at tp = 1 x dp = 2 (held over
     the decisive steps), phase 4's mix through the paged scheduler at
     tp = 2 (held over the decisive steps) and at tp = 1 x dp = 2 (a pool
     partition a data rank, held over the decisive steps against the dense
     scheduler of the same world, every partition drained), all at 8 of
     LLaMA-2-7B's 32 layers (TP_ENGINE_LAYERS: depth cut for the time
     limit; the one-rank NCCL world keeps 32), and phase 5's directory
     exported with --tp 2 and served over HTTP by a leader
     ReplicatedScheduler with rank 1 following (equal to a direct tp = 2
     run). A rank that fails or outlives its timeout fails the phase; the
     ranks' launches join the kernels' counts.
 11. pipeline and sequence parallelism, after phase 10: two child ranks
     (``chip_smoke.py --pp-rank r <dir>``) sharing the card over gloo in
     one world. (a) pp = 2 on phase 4's 32-layer LLaMA-2-7B model, 16 layers
     a rank (each rank draws only its layers, the embedding and the head:
     the other stage's draws are skipped by moving the generator's offset):
     Engine.generate at B = 4 over phase 4's 32-token prompts (the W*Ax
     prefill, as under pp), 32 new tokens, the tokens equal to phase 4's and
     the prompts' last logits bit-equal to phase 4's single-device prefill
     (the hop passes the hidden state unchanged), over an int8 cache (phase
     4's int8 tokens) and sampled (phase 6's parameters and seed: phase 6's
     step-mode tokens); phase 4's 16-request mix through
     BatchScheduler(pp_mesh=) (dense, fused_tick=0) held over the decisive
     steps against phase 4's dense run (whose prompts of 64 tokens and more
     took the W*A16 prefill); OPT-6.7B's widths at 2 layers under pp = 2
     against one device (logits equal); phase 10's 4-layer directory
     exported (tp = 1) and served by ``python -m flexq_tpu_torch.serve.http
     --pp 2``, leader and follower, one completion equal to a direct pp = 2
     run. (b) sp = 2 at LLaMA-2-7B width: sp_prefill and two sp_decode_steps
     on 2 layers against the single-device forward (the W6A16 prefill;
     phase 3's bounds), generate_sp at SP_GEN_LAYERS = 8 layers, B = 1, a
     2000-token prompt, 16 new tokens, over a bf16 and an int8 prompt cache,
     each held against rank 0's single-device run of generate_sp (a ring of
     one: the prompt's logits, then a code witness, its decode steps fed
     the sp = 2 run's tokens and activation codes) and logged against its
     single-device Engine over that cache, and forward_sp on 2 dense f32
     layers against
     the dense forward (1e-3 of max |logit|). Each part's seconds and ms a
     step are printed; the ranks' launches join the kernels' counts.
Each phase prints its seconds. The line before the last is the kernels' JSON; the last is
{"ok": true, "device": {...}}.
"""

import contextlib
import ctypes
import dataclasses
import http.client
import itertools
import json
import math
import os
import queue
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

from flexq_tpu_torch.bindings import FlexQCausalLM
from flexq_tpu_torch.config import ModelConfig, QuantPolicy
from flexq_tpu_torch.export import safetensors_io
from flexq_tpu_torch.eval.ppl import perplexity
from flexq_tpu_torch.export.exporter import load_packed, load_packed_sharded
from flexq_tpu_torch.kernels import (
    _build,
    flash_decode,
    flash_decode_paged,
    flash_prefill,
    glu_quant,
    launch_counts,
    layernorm_quant,
    quant_act,
    relu_quant,
    reset_launch_counts,
    rmsnorm_quant,
    w4_matmul,
    w4_matmul_bf16,
    w6_glu_fused_bf16,
    w6_glu_matmul_bf16,
    w6_matmul,
    w6_matmul_bf16,
    w8_matmul,
)
from flexq_tpu_torch.kernels.attend_cache import attend_cache_plain
from flexq_tpu_torch.kernels.flash_decode import flash_decode_paged_plain
from flexq_tpu_torch.kernels import fused_quant
from flexq_tpu_torch.kernels.fused_quant import (
    glu_quant_plain,
    layernorm_quant_plain,
    quant_act_plain,
    relu_quant_plain,
    rmsnorm_quant_plain,
)
from flexq_tpu_torch.kernels.w4_matmul import w4_matmul_bf16_plain, w4_matmul_plain
from flexq_tpu_torch.kernels.w6_bf16 import w6_glu_bf16_plain, w6_matmul_bf16_plain
from flexq_tpu_torch.kernels.w6_matmul import w6_matmul_plain
from flexq_tpu_torch.kernels.w8_matmul import w8_matmul_plain
from flexq_tpu_torch.kernels.int_matmul import STREAM_MAX_M, W6AX_MMA, W6AX_STREAM, launch as int_launch, stream_takes, w6ax_route
from flexq_tpu_torch.models.llama import fake_quant_weights, forward as dense_forward, rope_cos_sin, rope_gemm_operands
from flexq_tpu_torch.models.opt import fake_quant_weights as opt_fake_quant_weights, forward as opt_dense_forward
from flexq_tpu_torch.models import hf_loader, llama, quantized
from flexq_tpu_torch.parallel import sp_serve
from flexq_tpu_torch.models.quantized import (all_gather_cat, forward_serve, quantize_layer, quantize_linear,
                                              quantize_params)
from flexq_tpu_torch.packing.pack4 import pack4
from flexq_tpu_torch.packing.pack6 import pack6
from flexq_tpu_torch.quant.quantizer import CLIPMIN, dequantize, quantize
from flexq_tpu_torch.quant.sensitivity import analyze_act_sensitivity
from flexq_tpu_torch.quant.smooth import collect_llama_act_stats, smooth_llama
from flexq_tpu_torch.serve import Engine, SamplingParams, beam, speculative
from flexq_tpu_torch.serve import http as serve_http
from flexq_tpu_torch.parallel import (SeqMesh, forward_sp, generate_sp, make_pipe_mesh, make_sp_mesh, serve_step_pp,
                                     shard_cache_pp, sp_decode_step, sp_prefill)
from flexq_tpu_torch.parallel.distributed import initialize, process_mesh, shutdown
from flexq_tpu_torch.parallel.tp import forward_serve_tp, shard_params
from flexq_tpu_torch.serve.replicated import ReplicatedScheduler
from flexq_tpu_torch.serve.scheduler import BatchScheduler
from flexq_tpu_torch.train import corpus, trainer
from flexq_tpu_torch.utils.benchmark import bench_fn

HBM_BPS = 3.35e12  # H100 SXM HBM3
PEAK_INT8 = 1979e12  # dense int8 tensor-core ops/s
PEAK_BF16 = 989e12  # dense bf16 tensor-core flop/s
PEAK_F32 = 67e12  # f32 outside the tensor cores
SEED = 0

# wrapper -> (route, source, the TPU kernel it replaces)
KERNELS = {
    "rmsnorm_quant": ("cuda", "flexq_tpu_torch/csrc/row_quant.cu", "flexq_tpu/kernels/fused_quant.py:119"),
    "w6_matmul": ("cuda", "flexq_tpu_torch/csrc/w6ax_matmul.cu", "flexq_tpu/kernels/w6_matmul.py:190"),
    "w6_matmul_stream": ("cuda", "flexq_tpu_torch/csrc/w6ax_matmul.cu", "flexq_tpu/kernels/w6_stream.py:108"),
    "quant_act": ("cuda", "flexq_tpu_torch/csrc/row_quant.cu", "flexq_tpu/kernels/fused_quant.py:59"),
    "glu_quant": ("cuda", "flexq_tpu_torch/csrc/row_quant.cu", "flexq_tpu/kernels/fused_quant.py:287"),
    "flash_decode": ("cuda", "flexq_tpu_torch/csrc/flash_decode.cu", "flexq_tpu/kernels/flash_decode.py:193"),
    "flash_prefill": ("cuda", "flexq_tpu_torch/csrc/flash_prefill.cu", "flexq_tpu/kernels/flash_prefill.py:181"),
    "w6_matmul_bf16": ("cuda", "flexq_tpu_torch/csrc/wa16_matmul.cu", "flexq_tpu/kernels/w6_matmul.py:612"),
    "w6_glu_matmul_bf16": ("cuda", "flexq_tpu_torch/csrc/wa16_matmul.cu", "flexq_tpu/kernels/w6_matmul.py:433"),
    "w6_glu_fused_bf16": ("cuda", "flexq_tpu_torch/csrc/wa16_matmul.cu", "flexq_tpu/kernels/w6_matmul.py:524"),
    "w4_matmul": ("cuda", "flexq_tpu_torch/csrc/w6ax_matmul.cu", "flexq_tpu/kernels/w4_matmul.py:103"),
    "w4_matmul_bf16": ("cuda", "flexq_tpu_torch/csrc/wa16_matmul.cu", "flexq_tpu/kernels/w4_matmul.py:220"),
    "w8_matmul": ("cuda", "flexq_tpu_torch/csrc/w6ax_matmul.cu", "flexq_tpu/kernels/w8_matmul.py:61"),
    "flash_decode_paged": ("cuda", "flexq_tpu_torch/csrc/flash_decode.cu", "flexq_tpu/kernels/flash_decode.py:354"),
    "layernorm_quant": ("cuda", "flexq_tpu_torch/csrc/row_quant.cu", "flexq_tpu/kernels/fused_quant.py:205"),
    "relu_quant": ("cuda", "flexq_tpu_torch/csrc/row_quant.cu", "flexq_tpu/kernels/fused_quant.py:334"),
}
# the shape whose times go into the JSON line (the main path's decode shape)
REPORT_SHAPE = {
    "rmsnorm_quant": "M=4 K=4096",
    "w6_matmul": "M=4 K=4096 N=11264",
    "w6_matmul_stream": "M=4 K=11264 N=4096",
    "quant_act": "M=4 K=4096",
    "glu_quant": "M=4 F=11264",
    "flash_decode": "B=4 Lq=1 H=32 D=128 S=2048 len=64",
    # the 32-token prompt (attend_cache.cu's warp-per-query kernel; the
    # 512-token prefill's tensor-core tiles are under ALSO_REPORT)
    "flash_prefill": "B=4 Lq=32 H=32 D=128 S=2048 len=64",
    # the 512-token prefill (M = 4 x 512): q / k projections with the RoPE epilogue, the FFN GLU
    "w6_matmul_bf16": "M=2048 K=4096 N=4096 rope",
    "w6_glu_matmul_bf16": "M=2048 K=4096 N=11264",
    "w6_glu_fused_bf16": "M=2048 K=4096 N=11264 fused",
    # W4A8 / W8A8 decode; the W4A16 prefill's q / k projections
    "w4_matmul": "M=4 K=4096 N=11264",
    "w8_matmul": "M=4 K=4096 N=11264",
    "w4_matmul_bf16": "M=2048 K=4096 N=4096 rope",
    # the scheduler's paged decode tick: 8 slots, ragged lengths up to 2048
    "flash_decode_paged": "B=8 H=32 D=128 PS=128 MAXPAGES=16 ragged",
    # OPT-6.7B's decode: the q/k/v and fc1 producer, the fc2 producer
    "layernorm_quant": "M=4 K=4096",
    "relu_quant": "M=4 F=16384",
}
SP_CHUNK_M = 1024  # a rank's rows of the sequence-parallel prefill: B = 1, 2048 tokens over sp = 2
VERIFY_LENGTHS = (69, 75, 85, 96)  # phase 6's verify windows: 5 queries a row, each row at its own start
VERIFY_SHAPE = f"B=4 Lq=5 H=32 D=128 S=2048 per-row len={'/'.join(map(str, VERIFY_LENGTHS))}"
# further shapes whose times go into a kernel's JSON entry, under "also"
ALSO_REPORT = {
    # the 512-token prefill over a bf16 and an int8 cache: flash_prefill.cu's tensor-core tiles;
    # phase 6's speculative verify windows (attend_cache.cu at Lq = 1 + k, each row at its own start)
    "flash_prefill": ("B=4 Lq=512 H=32 D=128 S=2048 len=512", "B=4 Lq=512 H=32 D=128 S=2048 len=512 int8",
                      VERIFY_SHAPE),
    # the exact GEMM on the tensor cores: phase 6's 4 x 5-token verify windows, a 4 x 32-token W6Ax
    # prompt, OPT's 4 x 512-token prompt
    "w6_matmul": ("M=20 K=4096 N=4096", "M=128 K=4096 N=4096", "M=2048 K=4096 N=4096"),
    # K7 at a sequence-parallel rank's chunk (phase 11): q / k / v / o, gate / up, down
    "w6_matmul_bf16": ("M=1024 K=4096 N=4096", "M=1024 K=4096 N=11264", "M=1024 K=11264 N=4096"),
    # W4A8 / W8A8 on the tensor cores: the 4 x 32-token prompt's gate / up
    "w4_matmul": ("M=128 K=4096 N=11264",),
    "w8_matmul": ("M=128 K=4096 N=11264",),
    # the producers at a 4 x 512-token prompt (OPT's; LLaMA's 512-token prefill takes the W*A16 layer)
    "rmsnorm_quant": ("M=2048 K=4096",),
    "quant_act": ("M=2048 K=4096",),
    "glu_quant": ("M=2048 F=11264",),
    "layernorm_quant": ("M=2048 K=4096",),
    "relu_quant": ("M=2048 F=16384",),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def timer(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device ms of a call of ``fn``: utils/benchmark.bench_fn (a
    1 GiB buffer rewritten before each launch, so weights come from HBM, not
    from the 50 MB L2, and the events time the device work, not the host's
    launch overhead)."""
    return bench_fn(fn, iters=iters, reps=1, warmup=warmup) * 1e3


def bound(nbytes: float, ops: float, peak: float):
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def record(results, name, shape, err, ms, plain_ms, nbytes, ops, peak, library_ms, dense_ms=None, extra="",
           yardstick=None):
    """Log one kernel check. ``dense_ms``: for a GEMM, which no single
    PyTorch call computes (per-group scales), a dense bf16 torch.matmul of
    the same shape as the yardstick; ``yardstick``: (call, ms) of a PyTorch
    call that computes part of a producer's function (the norm or the
    activation without the quant)."""
    bms, by = bound(nbytes, ops, peak)
    dense = "" if dense_ms is None else f" bf16_dense_ms={dense_ms:.4f}"
    if yardstick is not None:
        dense += f" yardstick_ms={yardstick[1]:.4f} ({yardstick[0]})"
    log(f"kernel {name:17s} {shape:36s} max_abs_err={err:.3g} ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={bms:.4f} ({by}) library_ms={library_ms if library_ms is None else round(library_ms, 4)}"
        f"{dense}{extra}")
    r = results.setdefault(name, {"max_abs_err": 0.0, "also": []})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    if shape == REPORT_SHAPE[name]:
        r.update(shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms,
                 bf16_dense_ms=dense_ms, yardstick_ms=None if yardstick is None else yardstick[1])
    if shape in ALSO_REPORT.get(name, ()):
        r["also"].append(dict(shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                              library_ms=library_ms))


def int_weight(fmt, k, n, gen, dev):
    """Random packed weight planes of format ``fmt`` (6, 4 or 8 bits)."""
    lim = 2 ** (fmt - 1)
    w = torch.randint(-lim, lim, (k, n), generator=gen, device=dev, dtype=torch.int8)
    return pack6(w) if fmt == 6 else (pack4(w),) if fmt == 4 else (w,)


# format -> (wrapper, plain version); K-tall decode shapes of W6 go to K3
INT_GEMMS = {6: (w6_matmul, w6_matmul_plain), 4: (w4_matmul, w4_matmul_plain), 8: (w8_matmul, w8_matmul_plain)}
SHAPES_7B = ((4096, 4096), (4096, 11264), (11264, 4096))  # (K, N) of q/k/v/o, gate/up, down
HEAD_7B = (4096, 32768)  # the packed lm_head: vocab 32000 padded to 32768
SHAPES_OPT = ((4096, 4096), (4096, 16384), (16384, 4096))  # OPT-6.7B's q/k/v/o, fc1, fc2


def int_gemm_case(results, fmt, m, k, n, bits, dev, gen):
    """One exact integer GEMM of format ``fmt`` over ``bits``-bit activation
    codes, bit-exact against its plain version, and its times."""
    fn, plain = INT_GEMMS[fmt]
    lim = 2 ** (bits - 1)
    xq = torch.randint(-lim, lim, (m, k), generator=gen, device=dev, dtype=torch.int8)
    xs = torch.rand((m, k // 128), generator=gen, device=dev) * 0.05 + 1e-3
    w = int_weight(fmt, k, n, gen, dev)
    ws = torch.rand((k // 128, n), generator=gen, device=dev) * 0.01 + 1e-4
    name = "w6_matmul_stream" if fmt == 6 and m <= 32 and k > n else fn.__name__
    out = fn(xq, xs, *w, ws, out_dtype=torch.bfloat16)
    ref = plain(xq, xs, *w, ws, torch.bfloat16)
    err = (out.float() - ref.float()).abs().max().item()
    if not torch.equal(out, ref):  # tolerance: bit-exact
        raise AssertionError(f"{name} M={m} K={k} N={n}: differs from plain (max {err})")
    # the route the wrapper does not take, where it takes M: bit-exact too
    other = W6AX_MMA if m <= STREAM_MAX_M[fmt] else W6AX_STREAM
    checked = "both routes" if other == W6AX_MMA or stream_takes(fmt, m, k, n) else "its route"
    if checked == "both routes" and not torch.equal(int_launch(fmt, xq, xs, w, ws, torch.bfloat16, route=other), ref):
        raise AssertionError(f"{name} M={m} K={k} N={n}: route {'AB'[other]} differs from plain")
    del ref
    xb = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    wb = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
    ms = timer(lambda: fn(xq, xs, *w, ws, out_dtype=torch.bfloat16))
    plain_ms = timer(lambda: plain(xq, xs, *w, ws, torch.bfloat16), iters=3, warmup=1)
    dense_ms = timer(lambda: xb @ wb)
    nbytes = m * k + m * (k // 128) * 4 + k * n * fmt // 8 + (k // 128) * n * 4 + m * n * 2
    route = "AB"[W6AX_STREAM if m <= STREAM_MAX_M[fmt] else W6AX_MMA]
    record(results, name, f"M={m} K={k} N={n}", err, ms, plain_ms, nbytes, 2 * m * n * k,
           PEAK_INT8, None, dense_ms=dense_ms, extra=f" route={route} (tolerance: bit-exact, {checked})")


# W6 at M = 20: phase 6's speculative verify windows, B = 4 x (1 + k) rows on route A
INT_MS = {6: (4, 20, 128), 4: (4, 8, 16, 32, 128, 256), 8: (4, 8, 16, 32, 128, 256)}


def check_int_gemms(results, dev, gen):
    """The exact integer GEMMs: W6Ax (K2/K3) at M = 4, 20 and 128, W4A8 (K10)
    and W8A8 (K12) at M = 4, 8, 16, 32, 128 and 256 (both sides of each
    format's route threshold) for the three 7B (K, N), and each at the
    packed head's shape at M = 4; each bit-exact against its plain version,
    on the route its wrapper takes and on the other. Then K2 / K3 at
    OPT-6.7B's shapes that LLaMA's do not reach: fc1 (4096 -> 16384) and
    fc2 (16384 -> 4096, K3) at M = 4, and q/k/v/o, fc1 and fc2 at M = 2048
    (OPT never takes the W*A16 layer: a 4 x 512-token prompt runs the exact
    GEMMs), at opt_flex's activation bits. Last, K2 / K3 at the 7B shapes on
    both sides of w6ax_route's threshold: M = 8 (the scheduler's decode
    ticks), 32, 64 and 256 (its prefill chunks)."""
    for fmt in INT_GEMMS:
        for m, k, n in [(m, k, n) for m in INT_MS[fmt] for k, n in SHAPES_7B] + [(4, *HEAD_7B)]:
            int_gemm_case(results, fmt, m, k, n, gemm_bits(fmt, k, n), dev, gen)
    (kq, nq), (k1, n1), (k2, n2) = SHAPES_OPT
    for m, k, n, bits in ((4, k1, n1, 6), (4, k2, n2, 6), (2048, kq, nq, 8), (2048, k1, n1, 6), (2048, k2, n2, 6)):
        int_gemm_case(results, 6, m, k, n, bits, dev, gen)
    for m, k, n in [(m, k, n) for m in (8, 32, 64, 256) for k, n in SHAPES_7B]:
        int_gemm_case(results, 6, m, k, n, gemm_bits(6, k, n), dev, gen)


def gemm_bits(fmt, k, n) -> int:
    """The activation bits at a 7B (K, N): llama_flex's 6 for W6Ax but at
    down_proj and the head (8); 8 for the other formats."""
    return 6 if fmt == 6 and (k, n) in SHAPES_7B[:2] else 8


def _quant_err(name, shape, got, want):
    """Tolerance: |dq| <= 1 on <= 0.1 % of entries; scales within rtol 1e-6
    on >= 99 % of groups and 1e-2 everywhere; residual out exact."""
    dq = (got[0].int() - want[0].int()).abs()
    rel = (got[1] - want[1]).abs() / want[1]
    ok = (dq.max().item() <= 1 and (dq > 0).float().mean().item() <= 1e-3
          and (rel > 1e-6).float().mean().item() <= 1e-2 and rel.max().item() <= 1e-2
          and all(torch.equal(g, w) for g, w in zip(got[2:], want[2:])))
    if not ok:
        raise AssertionError(f"{name} {shape}: max |dq| {dq.max().item()}, scale rel {rel.max().item():.3g}")
    return float(dq.max().item())


def producer_cases(m, dev, gen, k=4096, f=11264):
    """(name, shape, kernel call, plain call, bytes, ops) of the producers at
    M rows, K = 4096 and F = 11264 (the 7B hidden and padded FFN widths)."""
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    res = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    gamma = (1 + 0.1 * torch.randn(k, generator=gen, device=dev)).to(torch.bfloat16)
    gate = (2 * torch.randn((m, f), generator=gen, device=dev)).to(torch.bfloat16)
    up = torch.randn((m, f), generator=gen, device=dev).to(torch.bfloat16)
    qs_bytes = m * k + m * (k // 128) * 4
    return [
        ("rmsnorm_quant", f"M={m} K={k}", lambda: rmsnorm_quant(x, gamma, 6),
         lambda: rmsnorm_quant_plain(x, gamma, 6), m * k * 2 + k * 2 + qs_bytes, 8 * m * k),
        ("rmsnorm_quant", f"M={m} K={k} +residual", lambda: rmsnorm_quant(x, gamma, 6, residual=res),
         lambda: rmsnorm_quant_plain(x, gamma, 6, residual=res), 3 * m * k * 2 + k * 2 + qs_bytes,
         9 * m * k),
        ("quant_act", f"M={m} K={k}", lambda: quant_act(x, 6), lambda: quant_act_plain(x, 6),
         m * k * 2 + qs_bytes, 4 * m * k),
        ("glu_quant", f"M={m} F={f}", lambda: glu_quant(gate, up, 8), lambda: glu_quant_plain(gate, up, 8),
         2 * m * f * 2 + m * f + m * (f // 128) * 4, 10 * m * f),
    ]


def opt_producer_cases(m, dev, gen, k=4096, f=16384):
    """(name, shape, kernel call, plain call, bytes, ops, yardstick) of OPT's
    producers at M rows: K14 at K = 4096 (6 and 8 bits, with and without
    the residual), K15 at F = 16384 (OPT-6.7B's hidden and FFN widths);
    the yardsticks F.layer_norm and torch.relu compute the producer without
    its quant."""
    x = (torch.randn((m, k), generator=gen, device=dev) + 0.5).to(torch.bfloat16)
    res = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    gamma = (1 + 0.1 * torch.randn(k, generator=gen, device=dev)).to(torch.bfloat16)
    beta = (0.1 * torch.randn(k, generator=gen, device=dev)).to(torch.bfloat16)
    h = (2 * torch.randn((m, f), generator=gen, device=dev)).to(torch.bfloat16)
    qs_bytes = m * k + m * (k // 128) * 4
    ln = ("F.layer_norm", lambda: torch.nn.functional.layer_norm(x, (k,), gamma, beta))
    cases = []
    for bits in (6, 8):
        tag = "" if bits == 6 else " 8-bit"
        cases += [
            ("layernorm_quant", f"M={m} K={k}{tag}", lambda bits=bits: layernorm_quant(x, gamma, beta, bits),
             lambda bits=bits: layernorm_quant_plain(x, gamma, beta, bits), m * k * 2 + 2 * k * 2 + qs_bytes,
             12 * m * k, ln),
            ("layernorm_quant", f"M={m} K={k} +residual{tag}",
             lambda bits=bits: layernorm_quant(x, gamma, beta, bits, residual=res),
             lambda bits=bits: layernorm_quant_plain(x, gamma, beta, bits, residual=res),
             3 * m * k * 2 + 2 * k * 2 + qs_bytes, 13 * m * k, ln),
        ]
    cases.append(("relu_quant", f"M={m} F={f}", lambda: relu_quant(h, 6), lambda: relu_quant_plain(h, 6),
                  m * f * 2 + m * f + m * (f // 128) * 4, 5 * m * f, ("torch.relu", lambda: torch.relu(h))))
    return cases


PRODUCER_MS = (4, 8, 128, 256, 2048)
LAUNCH_FLOOR = {}  # "ms": an empty kernel's time under the same timer


def check_producers(results, dev, gen):
    """The producers (csrc/row_quant.cu) at PRODUCER_MS rows, LLaMA's and
    OPT-6.7B's widths, each within its tolerance and timed beside an empty
    kernel's time under the same timer (the launch floor)."""
    floor = timer(lambda: fused_quant.empty_kernel(dev))
    LAUNCH_FLOOR["ms"] = floor
    log(f"launch floor: an empty kernel through the producers' host path ms={floor:.4f}")
    cases = []
    for m in PRODUCER_MS:
        cases += [c + (None,) for c in producer_cases(m, dev, gen)] + opt_producer_cases(m, dev, gen)
    run_producer_cases(results, cases)


def run_producer_cases(results, cases):
    """Each producer case within its tolerance against its plain version,
    then timed beside the launch floor."""
    floor = LAUNCH_FLOOR["ms"]
    errs = []
    for name, shape, kern, plain, _, _, _ in cases:
        got, want = kern(), plain()
        # relu_quant has no sum whose order could differ: bit-exact
        if name == "relu_quant" and not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{name} {shape}: differs from plain")
        errs.append(_quant_err(name, shape, got, want))
    for err, (name, shape, kern, plain, nbytes, ops, yard) in zip(errs, cases):
        ms = timer(kern)
        plain_ms = timer(plain, iters=5, warmup=1)
        yardstick = None if yard is None else (yard[0], timer(yard[1]))
        tol = "bit-exact" if name == "relu_quant" else "|dq|<=1 on <=0.1% of q"
        record(results, name, shape, err, ms, plain_ms, nbytes, ops, PEAK_F32, None,
               extra=f" floor_x={ms / floor:.2f} (tolerance: {tol})", yardstick=yardstick)


# the kernel instances whose registers are logged: (library, C function)
ATTRIBUTES = (("w6ax_matmul", "flexq_w6ax_kernel_attributes"), ("row_quant", "flexq_row_quant_kernel_attributes"))


def log_kernel_attributes() -> None:
    """Registers a thread and local-memory bytes a thread (spills) of every
    instance of the exact GEMM's and the producers' kernels
    (cudaFuncGetAttributes)."""
    ci = ctypes.c_int
    for lib, sym in ATTRIBUTES:
        fn = _build.function(lib, sym, [ci, ctypes.c_char_p, ci, ctypes.POINTER(ci), ctypes.POINTER(ci)])
        name, regs, local = ctypes.create_string_buffer(64), ci(), ci()
        rows, i = [], 0
        while (rc := fn(i, name, 64, ctypes.byref(regs), ctypes.byref(local))) == 0:
            rows.append(f"{name.value.decode()} {regs.value}/{local.value}")
            i += 1
        if rc != 1:
            raise RuntimeError(f"{sym}({i}): CUDA error {rc}")
        log(f"kernel attributes {lib} (registers / local bytes a thread): " + "; ".join(rows))


def check_attention(results, dev, gen):
    """bf16 cache: Lq = 1 and 32 over 64 cached tokens (the 32-token path),
    Lq = 1 and 512 over 512 (the 512-token path), and Lq = 5 at each row's
    own start (phase 6's verify windows); int8 cache with f32 scales: Lq = 1
    and 512 over 512. For K6 and K9 also the share of their
    bf16 outputs that part from the plain version's on the CPU, the side
    that phase 3's parity runs hold the card to."""
    b, h, kvh, s, d = 4, 32, 32, 2048, 128
    shape = (2, b, kvh, s, d)
    kc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    k8, v8 = (torch.randint(-128, 128, shape, generator=gen, device=dev, dtype=torch.int8) for _ in "kv")
    ks, vs = (torch.rand(shape[:-1], generator=gen, device=dev) * 0.02 + 1e-3 for _ in "kv")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = ((1, 64, False), (32, 64, False), (1, 512, False), (512, 512, False), (1, 512, True), (512, 512, True))
    for lq, ln, quant in cases:
        lengths = torch.full((b,), ln, dtype=torch.int32, device=dev)
        ck, cv, scales = (k8, v8, (ks, vs)) if quant else (kc, vc, ())
        # [B, KVH, len, D] bf16 (dequantized for int8) for the library yardstick
        if quant:
            k_valid = (k8[1, :, :, :ln].float() * ks[1, :, :, :ln, None]).to(torch.bfloat16)
            v_valid = (v8[1, :, :, :ln].float() * vs[1, :, :, :ln, None]).to(torch.bfloat16)
        else:
            k_valid, v_valid = kc[1, :, :, :ln].contiguous(), vc[1, :, :, :ln].contiguous()
        q = torch.randn((b, lq, h, d), generator=gen, device=dev).to(torch.bfloat16)
        pos = ln - lq + torch.arange(lq, device=dev)
        mask = torch.arange(ln, device=dev)[None, :] <= pos[:, None]  # [Lq, len]
        qt = q.transpose(1, 2).contiguous()
        if lq == 1:
            name = "flash_decode"
            kern = lambda: flash_decode(q[:, 0], ck, cv, lengths, *scales, layer_idx=1)
            lib = lambda: sdpa(qt, k_valid, v_valid)
        else:
            name = "flash_prefill"
            kern = lambda: flash_prefill(q, ck, cv, lengths, *scales, layer_idx=1)
            lib = lambda: sdpa(qt, k_valid, v_valid, attn_mask=mask)
        plain = lambda: attend_cache_plain(q, ck, cv, lengths, 1, None, torch.bfloat16, lq == 1, torch.bfloat16,
                                           *scales)
        got, want = kern().reshape(b, lq, h * d).float(), plain().float()
        err = (got - want).abs().max().item()
        if not err <= 2e-2 * want.abs().max().item():  # tolerance: 2e-2 of max |out| (bf16)
            raise AssertionError(f"{name} Lq={lq} int8={quant}: max abs err {err}")
        lib_out = lib().transpose(1, 2).reshape(b, lq, h * d).float()
        lib_err = (lib_out - want).abs().max().item()
        # the share of bf16 outputs that part from the CPU's plain version
        cpu = [t.cpu() for t in (q, ck[1:], cv[1:], lengths, *(sc[1:] for sc in scales))]
        want_cpu = attend_cache_plain(*cpu[:4], 0, None, torch.bfloat16, lq == 1, torch.bfloat16, *cpu[4:])
        parted = f" parted_from_cpu={(got.to(torch.bfloat16).cpu() != want_cpu).float().mean().item():.3e}"
        ms, plain_ms, lib_ms = timer(kern), timer(plain, iters=5, warmup=1), timer(lib)
        keys = int((pos + 1).sum().item())  # keys attended over the Lq queries
        kv_bytes = 2 * b * kvh * ln * (d + 4) if quant else 2 * b * kvh * ln * d * 2
        nbytes = kv_bytes + 2 * b * lq * h * d * 2
        record(results, name, f"B={b} Lq={lq} H={h} D={d} S={s} len={ln}" + (" int8" if quant else ""), err, ms,
               plain_ms, nbytes, 4 * b * h * keys * d, PEAK_BF16, lib_ms,
               extra=f" sdpa_vs_plain_err={lib_err:.3g}{parted} (tolerance: 2e-2 of max|out|)")
    # a speculative verify window: Lq = 5, each row at its own start (phase 6)
    lq = 5
    lengths = torch.tensor(VERIFY_LENGTHS, dtype=torch.int32, device=dev)
    q = torch.randn((b, lq, h, d), generator=gen, device=dev).to(torch.bfloat16)
    kern = lambda: flash_prefill(q, kc, vc, lengths, layer_idx=1)
    plain = lambda: attend_cache_plain(q, kc, vc, lengths, 1, None, torch.bfloat16, False, torch.bfloat16)
    got, want = kern().float(), plain().float()
    err = (got - want).abs().max().item()
    if not err <= 2e-2 * want.abs().max().item():
        raise AssertionError(f"flash_prefill verify window: max abs err {err}")
    top = max(VERIFY_LENGTHS)
    pos = lengths[:, None].long() - lq + torch.arange(lq, device=dev)  # [B, Lq]
    mask = torch.arange(top, device=dev)[None, None, None, :] <= pos[:, None, :, None]  # [B, 1, Lq, top]
    qt = q.transpose(1, 2).contiguous()
    kv_top = kc[1, :, :, :top].contiguous(), vc[1, :, :, :top].contiguous()
    lib = lambda: sdpa(qt, *kv_top, attn_mask=mask)
    ms, plain_ms, lib_ms = timer(kern), timer(plain, iters=5, warmup=1), timer(lib)
    keys = int((pos + 1).sum().item())
    nbytes = 2 * kvh * sum(VERIFY_LENGTHS) * d * 2 + 2 * b * lq * h * d * 2
    record(results, "flash_prefill", VERIFY_SHAPE, err, ms, plain_ms, nbytes, 4 * h * keys * d, PEAK_BF16, lib_ms,
           extra=" (tolerance: 2e-2 of max|out|)")


def attention_case(results, b, lq, h, kvh, d, s, ln, quant, dev, gen):
    """K6 (lq = 1) or K9 over a dense bf16 or int8 cache [2, B, KVH, S, D],
    every row at ``ln`` keys, against its plain version (2e-2 of max |out|;
    K6 per (b, h) row), timed beside SDPA over the same keys (dequantized to
    bf16, repeated to H heads for GQA, causal for lq > 1)."""
    ck, cv, scales = random_cache((2, b, kvh, s, d), quant, gen, dev)
    q = torch.randn((b, lq, h, d), generator=gen, device=dev).to(torch.bfloat16)
    lengths = torch.full((b,), ln, dtype=torch.int32, device=dev)
    if lq == 1:
        name = "flash_decode"
        kern = lambda: flash_decode(q[:, 0], ck, cv, lengths, *scales, layer_idx=1)
    else:
        name = "flash_prefill"
        kern = lambda: flash_prefill(q, ck, cv, lengths, *scales, layer_idx=1)
    plain = lambda: attend_cache_plain(q, ck, cv, lengths, 1, None, torch.bfloat16, lq == 1, torch.bfloat16, *scales)
    got, want = kern().float().reshape(b, lq, h, d), plain().float().reshape(b, lq, h, d)
    err = (got - want).abs().max().item()
    worst = ((got - want).abs().amax(-1) / want.abs().amax(-1)).max().item() if lq == 1 else \
        err / want.abs().max().item()
    shape = f"B={b} Lq={lq} H={h} KVH={kvh} D={d} S={s} len={ln}" + (" int8" if quant else "")
    if not worst <= 2e-2:
        raise AssertionError(f"{name} {shape}: max abs err {err}")

    def valid(c, sc):
        x = c[1, :, :, :ln].float() * (sc[1, :, :, :ln, None] if quant else 1.0)
        return x.to(torch.bfloat16).repeat_interleave(h // kvh, dim=1)

    k_valid, v_valid = valid(ck, scales[0] if quant else None), valid(cv, scales[1] if quant else None)
    qt = q.transpose(1, 2).contiguous()
    pos = ln - lq + torch.arange(lq, device=dev)
    mask = torch.arange(ln, device=dev)[None, :] <= pos[:, None]
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(qt, k_valid, v_valid,
                                                                  attn_mask=None if lq == 1 else mask)
    ms, plain_ms, lib_ms = timer(kern), timer(plain, iters=5, warmup=1), timer(lib)
    keys = int((pos + 1).sum().item())
    kv_bytes = 2 * b * kvh * ln * (d + 4) if quant else 2 * b * kvh * ln * d * 2
    record(results, name, shape, err, ms, plain_ms, kv_bytes + 2 * b * lq * h * d * 2, 4 * b * h * keys * d,
           PEAK_BF16, lib_ms, extra=" (tolerance: 2e-2 of max|out|" + (" per (b, h) row)" if lq == 1 else ")"))


# tensor parallelism at tp = 2 (phase 10): each rank's local (K, N)
TP2_7B = dict(qkv=(4096, 2048), gate_up=(4096, 5632), o=(2048, 4096), down=(5632, 4096), head=(4096, 16384))
TP2_OPT = dict(fc1=(4096, 8192), fc2=(8192, 4096))
# the accuracy-gate model of phase 9: hidden 512, FFN 1408, 8 heads / 4 kv heads of 64
GATE_KN = dict(q=(512, 512), gate_up=(512, 1408), down=(1408, 512))


def check_parallel_shapes(results, dev, gen):
    """Every kernel of phase 10's tp = 2 path at a rank's local shapes
    (LLaMA-2-7B's and OPT-6.7B's heads, FFN and vocab halved: q/k/v
    4096 -> 2048, gate/up 4096 -> 5632, o 2048 -> 4096, down 5632 -> 4096,
    the packed head 4096 -> 16384, OPT's fc1 4096 -> 8192 and fc2
    8192 -> 4096, 16 heads), each against its plain version at its
    tolerance and timed: the exact GEMMs (K2 / K3 at M = 4 and 128, K10 and
    K12 at M = 4), the W*A16 GEMMs at a 4 x 512-token prefill (K7 with and
    without RoPE, K8, K11), the producers at M = 4 and 2048 (K4 at K = 2048,
    K5 at F = 5632, K15 at F = 8192; K1 and K14 keep K = 4096), attention
    (K6, K9 on both kernels, K13) at H = KVH = 16. Then the accuracy-gate
    model's shapes (phase 9) that PERF.md's table had no time for: K1-K5,
    K10 and K12 at M = 4 and 16 x 512, K6 and K9 at 8 heads over 4 kv heads
    of 64."""
    t = TP2_7B
    for m in (4, 128):
        for (k, n), bits in ((t["qkv"], 6), (t["gate_up"], 6), (t["o"], 6), (t["down"], 8), (TP2_OPT["fc1"], 6),
                             (TP2_OPT["fc2"], 6)):
            int_gemm_case(results, 6, m, k, n, bits, dev, gen)
    int_gemm_case(results, 6, 4, *t["head"], 8, dev, gen)
    for fmt in (4, 8):
        for k, n in (t["qkv"], t["gate_up"], t["o"], t["down"], t["head"]):
            int_gemm_case(results, fmt, 4, k, n, 8, dev, gen)
    cases = []
    for fmt in BF16_GEMMS:
        for (k, n), rope in ((t["qkv"], True), (t["qkv"], False), (t["o"], False), (t["down"], False)):
            cases.append(wa16_case(fmt, 2048, k, n, rope, dev, gen))
    cases.append(wa16_case(4, 2048, *t["gate_up"], False, dev, gen))  # W4 runs gate and up as two GEMMs
    k, n = t["gate_up"]
    cases += glu_cases(wa16_planes(6, k, n, dev, gen), wa16_planes(6, k, n, dev, gen), 2048, dev, gen)
    run_wa16_cases(results, cases, dev, gen)
    prod = []
    for m in (4, 2048):
        prod += [c + (None,) for c in producer_cases(m, dev, gen, k=2048, f=5632) if c[0] != "rmsnorm_quant"]
        prod += [c for c in opt_producer_cases(m, dev, gen, f=8192) if c[0] == "relu_quant"]
    run_producer_cases(results, prod)
    for lq, ln in ((1, 64), (1, 512), (32, 64), (512, 512)):
        attention_case(results, 4, lq, 16, 16, 128, 2048, ln, False, dev, gen)
    attention_case(results, 4, 1, 16, 16, 128, 2048, 512, True, dev, gen)
    check_paged_attention(results, dev, gen, h=16, kvh=16)
    # the accuracy-gate model
    for m in (4, 16 * 512):
        for (k, n) in GATE_KN.values():
            for fmt in (6, 4, 8):
                int_gemm_case(results, fmt, m, k, n, 8 if fmt != 6 or k == 1408 else 6, dev, gen)
        gate_prod = [c + (None,) for c in producer_cases(m, dev, gen, k=512, f=1408)]
        run_producer_cases(results, gate_prod)
    attention_case(results, 4, 1, 8, 4, 64, 2048, 512, False, dev, gen)
    attention_case(results, 16, 512, 8, 4, 64, 512, 512, False, dev, gen)


def log_check(results, name, shape, err, tol):
    """Log a kernel check that is not timed (a shape off the main path)."""
    log(f"kernel {name:17s} {shape:36s} max_abs_err={err:.3g} (correctness only; tolerance: {tol})")
    r = results.setdefault(name, {"max_abs_err": 0.0, "also": []})
    r["max_abs_err"] = max(r["max_abs_err"], err)


def random_cache(shape, quant, gen, dev):
    """(k, v, scales) of a random bf16 cache, or an int8 cache with its f32
    scales, of ``shape`` [L, rows, KVH, S, D]."""
    if quant:
        k, v = (torch.randint(-128, 128, shape, generator=gen, device=dev, dtype=torch.int8) for _ in "kv")
        return k, v, [torch.rand(shape[:-1], generator=gen, device=dev) * 0.02 + 1e-3 for _ in "kv"]
    k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16) for _ in "kv")
    return k, v, []


def check_prefill_cases(results, dev, gen):
    """K9 off the main path's two shapes, against its plain version at the
    same tolerance (2e-2 of max |out|): Lq = 256 over 768 keys (a chunked
    prefill's later chunk: its queries sit at 512..767), Lq = 512 over 1024
    keys with a 512-key window, and GQA (H = 32 over KVH = 8) at Lq = 512
    over 512 keys, each timed beside SDPA over the same keys (masked; K/V
    repeated to H heads for GQA); then D = 64 and D = 256 over bf16 and
    int8 caches (GQA, a window, rows with queries at pos < 0), correctness
    only."""
    b, h, s, d = 4, 32, 2048, 128
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for lq, ln, window, kvh in ((256, 768, None, 32), (512, 1024, 512, 32), (512, 512, None, 8)):
        ck, cv, _ = random_cache((2, b, kvh, s, d), False, gen, dev)
        q = torch.randn((b, lq, h, d), generator=gen, device=dev).to(torch.bfloat16)
        lengths = torch.full((b,), ln, dtype=torch.int32, device=dev)
        kern = lambda: flash_prefill(q, ck, cv, lengths, layer_idx=1, window=window)
        plain = lambda: attend_cache_plain(q, ck, cv, lengths, 1, window, torch.bfloat16, False, torch.bfloat16)
        got, want = kern().float(), plain().float()
        err = (got - want).abs().max().item()
        if not err <= 2e-2 * want.abs().max().item():  # tolerance: 2e-2 of max |out| (bf16)
            raise AssertionError(f"flash_prefill Lq={lq} len={ln} window={window} KVH={kvh}: max abs err {err}")
        pos = ln - lq + torch.arange(lq, device=dev)
        keys = torch.arange(ln, device=dev)[None, :]
        mask = keys <= pos[:, None]
        if window is not None:
            mask &= keys > pos[:, None] - window
        k_valid = ck[1, :, :, :ln].repeat_interleave(h // kvh, dim=1)
        v_valid = cv[1, :, :, :ln].repeat_interleave(h // kvh, dim=1)
        qt = q.transpose(1, 2).contiguous()
        lib = lambda: sdpa(qt, k_valid, v_valid, attn_mask=mask)
        lib_err = (lib().transpose(1, 2).reshape(b, lq, h * d).float() - want).abs().max().item()
        ms, plain_ms, lib_ms = timer(kern), timer(plain, iters=5, warmup=1), timer(lib)
        attended = int(mask.sum().item())  # (query, key) pairs of one (row, head)
        first = ln - lq - window + 1 if window is not None else 0
        kv_bytes = 2 * b * kvh * (ln - max(first, 0)) * d * 2
        shape = f"B={b} Lq={lq} H={h} KVH={kvh} D={d} S={s} len={ln}" + (f" window={window}" if window else "")
        record(results, "flash_prefill", shape, err, ms, plain_ms, kv_bytes + 2 * b * lq * h * d * 2,
               4 * b * h * attended * d, PEAK_BF16, lib_ms,
               extra=f" sdpa_vs_plain_err={lib_err:.3g} (tolerance: 2e-2 of max|out|; SDPA masked"
                     + (", K/V repeated to H heads)" if kvh < h else ")"))
        del ck, cv, k_valid, v_valid
    b, h, kvh, s, lq = 3, 8, 2, 512, 100
    lengths = torch.tensor([lq - 7, 300, s], dtype=torch.int32, device=dev)
    for d in (64, 256):
        for quant in (False, True):
            ck, cv, scales = random_cache((2, b, kvh, s, d), quant, gen, dev)
            q = torch.randn((b, lq, h, d), generator=gen, device=dev).to(torch.bfloat16)
            window = 64 if quant else None
            got = flash_prefill(q, ck, cv, lengths, *scales, layer_idx=1, window=window).float()
            want = attend_cache_plain(q, ck, cv, lengths, 1, window, torch.bfloat16, False, torch.bfloat16,
                                      *scales).float()
            err = (got - want).abs().max().item()
            if not err <= 2e-2 * want.abs().max().item():
                raise AssertionError(f"flash_prefill D={d} int8={quant}: max abs err {err}")
            log_check(results, "flash_prefill", f"B={b} Lq={lq} H={h} KVH={kvh} D={d} S={s}"
                      + (" int8" if quant else "") + (f" window={window}" if window else ""), err,
                      "2e-2 of max|out|")


def check_decode_cases(results, dev, gen):
    """K6 off the main path's shapes, against its plain version at the same
    tolerance (2e-2 of each (b, h) row's max |out|): GQA (H = 32 over
    KVH = 8) over 512 keys, and a 512-key window over 1024 keys, each timed
    beside SDPA over the same keys (K/V repeated to H heads for GQA; masked
    to the window); then D = 64 and D = 256 over bf16 and int8 caches (GQA,
    a window, a 1-key row, a row at S keys), correctness only."""
    b, h, s, d = 4, 32, 2048, 128
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for ln, window, kvh in ((512, None, 8), (1024, 512, 32)):
        ck, cv, _ = random_cache((2, b, kvh, s, d), False, gen, dev)
        q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
        lengths = torch.full((b,), ln, dtype=torch.int32, device=dev)
        kern = lambda: flash_decode(q, ck, cv, lengths, layer_idx=1, window=window)
        plain = lambda: attend_cache_plain(q[:, None], ck, cv, lengths, 1, window, torch.bfloat16, True,
                                           torch.bfloat16)
        got, want = kern().float().reshape(b, h, d), plain().float().reshape(b, h, d)
        err = (got - want).abs().max().item()
        row_err = ((got - want).abs().amax(-1) / want.abs().amax(-1)).max().item()
        if not row_err <= 2e-2:
            raise AssertionError(f"flash_decode len={ln} window={window} KVH={kvh}: worst row err {row_err}")
        first = max(ln - window, 0) if window is not None else 0
        k_valid = ck[1, :, :, first:ln].repeat_interleave(h // kvh, dim=1)
        v_valid = cv[1, :, :, first:ln].repeat_interleave(h // kvh, dim=1)
        lib = lambda: sdpa(q[:, :, None], k_valid, v_valid)
        lib_err = (lib().reshape(b, h, d).float() - want).abs().max().item()
        ms, plain_ms, lib_ms = timer(kern), timer(plain, iters=5, warmup=1), timer(lib)
        keys = ln - first
        nbytes = 2 * b * kvh * keys * d * 2 + 2 * b * h * d * 2
        shape = f"B={b} Lq=1 H={h} KVH={kvh} D={d} S={s} len={ln}" + (f" window={window}" if window else "")
        record(results, "flash_decode", shape, err, ms, plain_ms, nbytes, 4 * b * h * keys * d, PEAK_BF16, lib_ms,
               extra=f" worst_row_rel_err={row_err:.3g} sdpa_vs_plain_err={lib_err:.3g} (tolerance: 2e-2 of each "
                     "(b, h) row's max|out|; SDPA over the keys attended"
                     + (", K/V repeated to H heads)" if kvh < h else ")"))
        del ck, cv, k_valid, v_valid
    b, h, kvh, s = 3, 8, 2, 512
    lengths = torch.tensor([1, 129, s], dtype=torch.int32, device=dev)
    for d in (64, 256):
        for quant in (False, True):
            ck, cv, scales = random_cache((2, b, kvh, s, d), quant, gen, dev)
            q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
            window = 100 if quant else None
            got = flash_decode(q, ck, cv, lengths, *scales, layer_idx=1, window=window).float().reshape(b, h, d)
            want = attend_cache_plain(q[:, None], ck, cv, lengths, 1, window, torch.bfloat16, True, torch.bfloat16,
                                      *scales).float().reshape(b, h, d)
            err = (got - want).abs().max().item()
            row_err = ((got - want).abs().amax(-1) / want.abs().amax(-1)).max().item()
            if not row_err <= 2e-2:
                raise AssertionError(f"flash_decode D={d} int8={quant}: worst row err {row_err}")
            log_check(results, "flash_decode", f"B={b} Lq=1 H={h} KVH={kvh} D={d} S={s}"
                      + (" int8" if quant else "") + (f" window={window}" if window else ""), err,
                      f"2e-2 of each (b, h) row's max|out|; worst row {row_err:.3g}")


PAGED_LENGTHS = (1, 127, 128, 129, 700, 1500, 2047, 2048)


def check_paged_attention(results, dev, gen, h=32, kvh=32):
    """K13 over a page pool through a scrambled page table: B = 8 rows at
    the ragged lengths above, H = KVH = 32, D = 128, PS = 128, MAXPAGES = 16
    (the scheduler's decode tick at max_seq_len 2048), bf16 and int8 pools,
    with and without a 512-key window; against its plain version (the
    table's pages gathered, K6's plain version with one page per block) at
    K6's tolerance, taken per (b, h) row. Yardstick: SDPA over the same
    keys laid out contiguously (dequantized to bf16 for the int8 pool),
    masked to each row's keys."""
    b, ps, d, maxp = 8, 128, 128, 16
    npages = 1 + b * maxp
    shape = (2, npages, kvh, ps, d)
    table = (torch.randperm(npages - 1, generator=gen, device=dev) + 1).reshape(b, maxp).to(torch.int32)
    lengths = torch.tensor(PAGED_LENGTHS, dtype=torch.int32, device=dev)
    q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for quant in (False, True):
        pk, pv, scales = random_cache(shape, quant, gen, dev)

        def contiguous(pool, sc):  # [B, KVH, MAXPAGES*PS, D] bf16, the table's pages in order
            g = pool[1][table.long()].float()  # [B, MAXPAGES, KVH, PS, D]
            if sc is not None:
                g = g * sc[1][table.long()][..., None]
            return g.transpose(1, 2).reshape(b, kvh, maxp * ps, d).to(torch.bfloat16)

        k_lin = contiguous(pk, scales[0] if quant else None)
        v_lin = contiguous(pv, scales[1] if quant else None)
        for window in (None, 512):
            kern, plain, err, row_err = paged_case(q, pk, pv, table, lengths, scales, window)
            keys = torch.arange(maxp * ps, device=dev)
            lo = (lengths - window).clamp(min=0) if window is not None else torch.zeros_like(lengths)
            mask = (keys[None, :] < lengths[:, None]) & (keys[None, :] >= lo[:, None])  # [B, keys]
            lib = lambda: sdpa(q[:, :, None], k_lin, v_lin, attn_mask=mask[:, None, None, :])
            ms, plain_ms, lib_ms = timer(kern), timer(plain, iters=5, warmup=1), timer(lib)
            attended = int((lengths - lo).sum().item())  # keys each row's (b, head) attends
            per_key = kvh * (d + 4) if quant else kvh * d * 2
            nbytes = 2 * attended * per_key + b * maxp * 4 + 2 * b * h * d * 2  # K/V rows (+scales), table, q, out
            shape_s = (f"B={b} H={h} D={d} PS={ps} MAXPAGES={maxp} ragged" + (" int8" if quant else "")
                       + (f" window={window}" if window else ""))
            record(results, "flash_decode_paged", shape_s, err, ms, plain_ms, nbytes, 4 * h * attended * d,
                   PEAK_BF16, lib_ms, extra=f" worst_row_rel_err={row_err:.3g} "
                                            "(tolerance: 2e-2 of each (b, h) row's max|out|)")
        del pk, pv, scales, k_lin, v_lin


def paged_case(q, pk, pv, table, lengths, scales, window):
    """K13 and its plain version on one input, and the worst (b, h) row's
    error over that row's max |out| (K6's tolerance, 2e-2 of max |out|,
    taken per (b, h) row: the 1-key row's output is a raw V row, the long
    rows' are small)."""
    b, h, d = q.shape
    kern = lambda: flash_decode_paged(q, pk, pv, table, lengths, *scales, layer_idx=1, window=window)
    plain = lambda: flash_decode_paged_plain(q, pk, pv, table, lengths, *scales, layer_idx=1, window=window)
    got, want = kern().float().reshape(b, h, d), plain().float().reshape(b, h, d)
    err = (got - want).abs().max().item()
    row_err = ((got - want).abs().amax(-1) / want.abs().amax(-1)).max().item()
    if not row_err <= 2e-2:
        raise AssertionError(f"flash_decode_paged D={d} H={h} int8={bool(scales)} window={window}: max abs err "
                             f"{err}, worst row err / row max|out| {row_err}")
    return kern, plain, err, row_err


def check_paged_cases(results, dev, gen):
    """K13 off the main path: GQA (H = 32 over KVH = 8) at phase 2's paged
    shape (B = 8 ragged rows up to 2048 keys, bf16), timed beside SDPA over
    the same keys laid out contiguously (K/V repeated to H heads); then
    D = 64 and D = 256 over bf16 and int8 pools (a window on the int8 pool,
    GQA, a 1-key row, a row at MAXPAGES * PS keys), correctness only."""
    b, h, kvh, ps, d, maxp = 8, 32, 8, 128, 128, 16
    npages = 1 + b * maxp
    table = (torch.randperm(npages - 1, generator=gen, device=dev) + 1).reshape(b, maxp).to(torch.int32)
    lengths = torch.tensor(PAGED_LENGTHS, dtype=torch.int32, device=dev)
    q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
    pk, pv, _ = random_cache((2, npages, kvh, ps, d), False, gen, dev)
    kern, plain, err, row_err = paged_case(q, pk, pv, table, lengths, [], None)

    def contiguous(pool):  # [B, H, MAXPAGES*PS, D]: the table's pages in order, each kv head repeated G times
        g = pool[1][table.long()].transpose(1, 2).reshape(b, kvh, maxp * ps, d)
        return g.repeat_interleave(h // kvh, dim=1).contiguous()

    k_lin, v_lin = contiguous(pk), contiguous(pv)
    mask = torch.arange(maxp * ps, device=dev)[None, :] < lengths[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = lambda: sdpa(q[:, :, None], k_lin, v_lin, attn_mask=mask[:, None, None, :])
    lib_err = (lib().reshape(b, h, d).float() - plain().float().reshape(b, h, d)).abs().max().item()
    ms, plain_ms, lib_ms = timer(kern), timer(plain, iters=5, warmup=1), timer(lib)
    attended = int(lengths.sum().item())
    nbytes = 2 * attended * kvh * d * 2 + b * maxp * 4 + 2 * b * h * d * 2
    record(results, "flash_decode_paged", f"B={b} H={h} KVH={kvh} D={d} PS={ps} MAXPAGES={maxp} ragged", err, ms,
           plain_ms, nbytes, 4 * h * attended * d, PEAK_BF16, lib_ms,
           extra=f" worst_row_rel_err={row_err:.3g} sdpa_vs_plain_err={lib_err:.3g} (tolerance: 2e-2 of each (b, h) "
                 "row's max|out|; SDPA with K/V repeated to H heads)")
    del pk, pv, k_lin, v_lin
    b, h, kvh, maxp = 4, 8, 2, 4
    npages = 1 + b * maxp
    table = (torch.randperm(npages - 1, generator=gen, device=dev) + 1).reshape(b, maxp).to(torch.int32)
    lengths = torch.tensor([1, maxp * ps, 129, 300], dtype=torch.int32, device=dev)
    for d in (64, 256):
        for quant in (False, True):
            pk, pv, scales = random_cache((2, npages, kvh, ps, d), quant, gen, dev)
            q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
            window = 200 if quant else None
            _, _, err, row_err = paged_case(q, pk, pv, table, lengths, scales, window)
            log_check(results, "flash_decode_paged", f"B={b} H={h} KVH={kvh} D={d} PS={ps} MAXPAGES={maxp}"
                      + (" int8" if quant else "") + (f" window={window}" if window else ""), err,
                      f"2e-2 of each (b, h) row's max|out|; worst row {row_err:.3g}")


def _wa16_err(name, shape, got, want) -> float:
    """Tolerance: kernel and plain version differ only in the order of the
    f32 sums; f32 output within 1e-4 of max |out|, bf16 output within one
    bf16 ulp of the plain f32 result, 2^(floor(log2|v|) - 7), plus that 1e-4
    for sums that cancel."""
    err = (got.float() - want).abs()
    tol = 1e-4 * want.abs().max().item()
    if got.dtype == torch.bfloat16:
        tol = torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8) + tol
    if not bool((err <= tol).all()):
        raise AssertionError(f"{name} {shape} {got.dtype}: max abs err {err.max().item()}")
    return err.max().item()


# format -> (wrapper, plain version) of the W*A16 GEMM
BF16_GEMMS = {6: (w6_matmul_bf16, w6_matmul_bf16_plain), 4: (w4_matmul_bf16, w4_matmul_bf16_plain)}


def check_wa16(results, dev, gen):
    """K7 (W6A16) and K11 (W4A16) at the 512-token prefill (M = 4 x 512)
    for q / k (RoPE epilogue), v / o (none) and down (K = 11264), at the
    scheduler's 256-token chunk (q / k, down), and at M = 4 (weight-only
    decode; K11 also at gate / up, which W4 runs as two GEMMs, and at the
    packed head's shape); K8 at M = 2048 with separate and fused gate / up
    planes and at M = 256. Each against its plain version in f32 and in bf16
    output; times of the bf16 output."""
    cases = []
    (kq, nq), (kg, ng), (kd, nd) = SHAPES_7B
    shapes = ((2048, kq, nq, True), (2048, kq, nq, False), (2048, kd, nd, False), (256, kq, nq, True),
              (256, kd, nd, False), (4, kq, nq, True), (4, kd, nd, False))
    # W4 has no fused GLU: K11 also runs gate / up (K = 4096, N = 11264) and the head
    w4_only = ((2048, kg, ng, False), (256, kg, ng, False), (4, kg, ng, False), (4, *HEAD_7B, False))
    for fmt in BF16_GEMMS:
        for m, k, n, rope in shapes + (w4_only if fmt == 4 else ()):
            cases.append(wa16_case(fmt, m, k, n, rope, dev, gen))
    g, u = wa16_planes(6, kg, ng, dev, gen), wa16_planes(6, kg, ng, dev, gen)
    cases += glu_cases(g, u, 2048, dev, gen, fused=True) + glu_cases(g, u, 256, dev, gen)  # 512-token prefill; chunk
    run_wa16_cases(results, cases, dev, gen)
    # phase 11's sequence-parallel prefill: K7 a projection at a time (no RoPE
    # epilogue, gate and up apart) on a rank's 1024-row chunk of a 2048-token
    # prompt; inputs from a generator of their own, so the cases above keep theirs
    gen_sp = torch.Generator(device=dev).manual_seed(SEED + 8)
    run_wa16_cases(results, [wa16_case(6, SP_CHUNK_M, k, n, False, dev, gen_sp) for k, n in SHAPES_7B], dev, gen_sp)


def wa16_planes(fmt, k, n, dev, gen):
    return (*int_weight(fmt, k, n, gen, dev), torch.rand((k // 128, n), generator=gen, device=dev) * 0.004 + 1e-4)


def wa16_case(fmt, m, k, n, rope, dev, gen, head_dim=128):
    """(name, shape, x, kernel call, plain call, bytes, ops, (K, N)) of K7
    (fmt 6) or K11 (fmt 4) at [M, K] x [K, N], with the RoPE epilogue over
    B x 512-token positions."""
    fn, plain = BF16_GEMMS[fmt]
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    w = wa16_planes(fmt, k, n, dev, gen)
    kw = {}
    if rope:
        pos = torch.arange(m, device=dev).reshape(1, m) % 512  # B x 512-token prompts
        cos, sin = rope_cos_sin(pos, head_dim, 10000.0)
        kw = dict(zip(("rope_cos", "rope_sin2"), rope_gemm_operands(cos, sin)))
    nbytes = m * k * 2 + k * n * fmt // 8 + (k // 128) * n * 4 + m * n * 2 + (2 * m * head_dim * 4 if rope else 0)
    return (fn.__name__, f"M={m} K={k} N={n}" + (" rope" if rope else ""), x,
            lambda dt=None: fn(x, *w, out_dtype=dt, **kw), lambda: plain(x, *w, torch.float32, **kw),
            nbytes, 2 * m * n * k, (k, n))


def glu_cases(g, u, m, dev, gen, fused=False):
    """K8 over separate gate / up planes (and, with ``fused``, over one
    gate | up plane) at M rows."""
    k, n = g[0].shape[0] * 2, g[0].shape[1]
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    nbytes = m * k * 2 + 2 * (k * n * 3 // 4 + (k // 128) * n * 4) + m * n * 2
    plain = lambda: w6_glu_bf16_plain(x, *g, *u, "silu", torch.float32)
    cases = [("w6_glu_matmul_bf16", f"M={m} K={k} N={n}", x,
              lambda dt=None: w6_glu_matmul_bf16(x, *g, *u, out_dtype=dt), plain, nbytes, 4 * m * n * k, (k, 2 * n))]
    if fused:
        gu = [torch.cat([a, b], dim=1).contiguous() for a, b in zip(g, u)]
        cases.append(("w6_glu_fused_bf16", f"M={m} K={k} N={n} fused", x,
                      lambda dt=None: w6_glu_fused_bf16(x, *gu, out_dtype=dt), plain, nbytes, 4 * m * n * k,
                      (k, 2 * n)))
    return cases


def run_wa16_cases(results, cases, dev, gen):
    """Each W*A16 case against its plain version in f32 and bf16 output,
    then timed (bf16 output) beside a dense bf16 matmul of the same shape."""
    for name, shape, x, kern, plain, nbytes, ops, (k, n) in cases:
        want = plain()
        err = max(_wa16_err(name, shape, kern(dt=dt), want) for dt in (torch.float32, torch.bfloat16))
        del want
        xb = x[:, :k]
        wb = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
        ms = timer(lambda: kern(dt=torch.bfloat16))
        plain_ms = timer(plain, iters=3, warmup=1)
        dense_ms = timer(lambda: xb @ wb)
        record(results, name, shape, err, ms, plain_ms, nbytes, ops, PEAK_BF16, None, dense_ms=dense_ms,
               extra=f" (K x {n} dense bf16 matmul; tolerance: f32 1e-4 of max|out|, bf16 1 ulp)")


def random_weights(cfg: ModelConfig, gen, dev, pack=None, res_std=None, keep=None):
    """Random f32 dense weights in the reference's tree, on the card, each
    layer handed to ``pack`` (e.g. quantize_layer) as soon as it is drawn:
    LLaMA (N(0, 0.02), residual outputs N(0, ``res_std``), by default 0.02
    scaled by 1/sqrt(2L), norms 1, an untied head) or pre-LN OPT (weights
    and biases N(0, 0.02), residual outputs as LLaMA's, LayerNorm g = 1 and
    b N(0, 0.02), max_seq_len + 2 learned positions, the head tied to the
    embedding). ``keep``: the indices of the layers to keep (a pipeline
    stage's); the others' draws are skipped, so the kept layers and the
    embedding and head are the whole model's (skip_draws)."""
    std = 0.02
    res_std = std / math.sqrt(2 * cfg.num_layers) if res_std is None else res_std
    h, f = cfg.hidden_size, cfg.intermediate_size
    nq, nkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    pack = pack or (lambda lp: lp)

    def randn(*shape, s=std):
        return torch.randn(shape, generator=gen, device=dev) * s

    if cfg.arch == "opt":
        def lin(k, n, s=std):
            return {"w": randn(k, n, s=s), "b": randn(n)}

        def norm():
            return {"g": torch.ones(h, device=dev), "b": randn(h)}

        def layer():
            return {"input_norm": norm(), "post_norm": norm(), "q_proj": lin(h, h), "k_proj": lin(h, h),
                    "v_proj": lin(h, h), "o_proj": lin(h, h, res_std), "fc1": lin(h, f), "fc2": lin(f, h, res_std)}

        layers = draw_layers(cfg.num_layers, layer, pack, gen, keep)
        return {"embed": randn(cfg.vocab_size, h), "pos_embed": randn(cfg.max_seq_len + 2, h), "final_norm": norm(),
                "layers": layers}

    def layer():
        return {"input_norm": torch.ones(h, device=dev), "post_norm": torch.ones(h, device=dev),
                "q_proj": {"w": randn(h, nq)}, "k_proj": {"w": randn(h, nkv)}, "v_proj": {"w": randn(h, nkv)},
                "o_proj": {"w": randn(nq, h, s=res_std)}, "gate_proj": {"w": randn(h, f)},
                "up_proj": {"w": randn(h, f)}, "down_proj": {"w": randn(f, h, s=res_std)}}

    layers = draw_layers(cfg.num_layers, layer, pack, gen, keep)
    return {"embed": randn(cfg.vocab_size, h), "final_norm": torch.ones(h, device=dev), "layers": layers,
            "lm_head": randn(h, cfg.vocab_size)}


def draw_layers(n: int, layer, pack, gen, keep=None):
    """``n`` layers drawn in order by ``layer()``, those in ``keep`` (all
    by default) handed to ``pack`` and kept. A run of skipped layers draws
    one (every layer draws the same shapes, so the same count of random
    numbers) and, on the card, moves the generator's offset past the rest
    (skip_draws); the CPU's generator has no offset, so there it draws them."""
    out, i = [], 0
    while i < n:
        if keep is None or i in keep:
            out.append(pack(layer()))
            i += 1
            continue
        run = next((j for j in range(i, n) if j in keep), n) - i
        skip_draws(gen, run, layer)
        i += run
    return out


def skip_draws(gen, n: int, draw) -> None:
    """Advance ``gen`` past ``n`` calls of ``draw`` that draw the same
    shapes: one call, then the CUDA generator's Philox offset moved by
    n - 1 times that call's advance."""
    if gen.device.type != "cuda":
        for _ in range(n):
            draw()
        return
    start = gen.get_offset()
    draw()
    gen.set_offset(start + (gen.get_offset() - start) * n)


def random_params(cfg: ModelConfig, policy, gen, dev, dtype=torch.bfloat16, fuse=False, keep=None):
    """random_weights' LLaMA quantized layer by layer on the card
    (``fuse=True``: the fused qkv_proj / gate_up tree; a policy with a
    quantized head packs the lm_head too; ``keep``: only those layers)."""
    t = random_weights(cfg, gen, dev, lambda lp: quantize_layer(lp, cfg, policy, dtype, dev, fuse=fuse), keep=keep)
    return {"embed": t["embed"].to(dtype), "final_norm": t["final_norm"].to(dtype), "layers": t["layers"],
            "lm_head": quantize_head(t["lm_head"].to(dtype), policy)}


OPT_67B = dict(vocab_size=50272, hidden_size=4096, intermediate_size=16384, num_layers=32, num_heads=32)


def random_opt_params(cfg: ModelConfig, policy, gen, dev, dtype=torch.bfloat16, keep=None):
    """random_weights' pre-LN OPT quantized layer by layer on the card."""
    t = random_weights(cfg, gen, dev, lambda lp: quantize_layer(lp, cfg, policy, dtype, dev), keep=keep)
    return {"embed": t["embed"].to(dtype), "pos_embed": t["pos_embed"].to(dtype),
            "final_norm": {k: v.to(dtype) for k, v in t["final_norm"].items()}, "layers": t["layers"]}


def quantize_head(head, policy):
    """The dense lm_head [H, V] as ``policy`` serves it: packed (vocab padded
    to the plane width) under a policy with a quantized head."""
    spec = policy.weight_spec("lm_head")
    return quantize_linear(head.float(), spec) if spec.enabled else head


def to_device(tree, dev):
    """The tree's tensors moved to ``dev`` (a device, or a dtype)."""
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev)


def dense_cache(cfg, b: int, s: int, kv_dtype, dev, kv_heads=None):
    """A zeroed dense serve cache (k, v[, k_scale, v_scale]) of b rows and s
    positions, over ``kv_heads`` kv heads (default the model's)."""
    shape = (cfg.num_layers, b, kv_heads or cfg.num_kv_heads, s, cfg.head_dim)
    c = tuple(torch.zeros(shape, dtype=kv_dtype, device=dev) for _ in "kv")
    if kv_dtype == torch.int8:
        c += tuple(torch.zeros(shape[:-1], dtype=torch.float32, device=dev) for _ in "kv")
    return c


def cache_kw(c) -> dict:
    return dict(kv_k=c[0], kv_v=c[1], **dict(zip(("kv_k_scale", "kv_v_scale"), c[2:])))


def parity(label, params, params_cpu, cfg, policy, l, dev, kv_dtype=torch.bfloat16, tol=None,
           decisive_argmax=False, min_decisive=0.5, forward=forward_serve, ref_dev=None, kv_heads=None,
           held_steps=None, hold_argmax=True, prefix="slice parity", what="2 layers, 7B width, card vs CPU plain"
           ) -> bool:
    """forward_serve on the card vs the CPU plain versions (same weights):
    an l-token prompt (the W6A16 layer from 64 tokens), then 2 decode
    steps, B = 2. ``tol`` replaces the per-step logit bounds below;
    ``decisive_argmax`` holds the argmax agreement over the rows whose CPU
    top-2 margin exceeds the step's max |dlogit| (elsewhere the two sides'
    measured gap, or a tie of the bf16 logits, can part the argmax), and
    asks that at least ``min_decisive`` of all rows be decisive.
    ``forward`` (forward_serve's arguments; its cache of ``kv_heads`` kv
    heads) replaces the card's side, ``ref_dev`` the CPU as the reference's
    device; only the steps in ``held_steps`` (None: all) are held to their
    bound, the others logged, and without ``hold_argmax`` the argmax is
    logged only."""
    ref_dev = ref_dev or torch.device("cpu")
    b, s = 2, 256
    runs = {"got": [forward, params, dev, dense_cache(cfg, b, s, kv_dtype, dev, kv_heads)],
            "ref": [forward_serve, params_cpu, ref_dev, dense_cache(cfg, b, s, kv_dtype, ref_dev)]}
    ids = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (b, l))
    pos, ok, agree, total = 0, True, 0, 0
    decisive_agree = decisive_total = 0
    for step in range(3):
        n = ids.shape[1]
        positions = torch.as_tensor(np.broadcast_to(np.arange(pos, pos + n), (b, n)).copy())
        outs = {}
        for role, run in runs.items():
            fn, p, d, c = run
            logits, run[3] = fn(p, cfg, policy, torch.as_tensor(ids), positions=positions, cache_pos=pos,
                                prefill_bf16=n >= 64, device=d, **cache_kw(c))
            outs[role] = logits.float().cpu()
        ref, got = outs["ref"], outs["got"]
        if not torch.isfinite(got).all():
            raise AssertionError(f"{label}: non-finite logits on the card")
        worst = ((got - ref).abs().max() / ref.abs().max()).item()
        parted = got.argmax(-1) != ref.argmax(-1)
        agree += int((~parted).sum())
        top2 = ref.topk(2, dim=-1).values
        margin = top2[..., 0] - top2[..., 1]
        decisive = margin > (got - ref).abs().max()
        decisive_agree += int((decisive & ~parted).sum())
        decisive_total += int(decisive.sum())
        if parted.any():  # the reference's top-2 margin where the argmax parts, over max |logit|
            log(f"{prefix} {label}: argmax parts where the reference's top-2 margin / max|logit| is "
                f"{[round(v, 5) for v in (margin[parted] / ref.abs().max()).tolist()]}")
        total += ref.shape[0] * ref.shape[1]
        # W6Ax decode steps over a cache that the W6A16 prefill wrote: K/V
        # there differ by bf16 ulps between card and CPU, which flips some
        # 6-bit activation codes downstream (a code is 1/32 of its group's
        # range), so these logits get a wider bound
        # (paged_parity's rule, for OPT's 16-token prompt over the int8
        # cache: there cache_witness finds 6-bit activation codes, not the
        # cache, parting card from CPU)
        loose = step > 0 and l >= 64 and not policy.no_act_quant
        step_tol = tol if tol is not None else 1e-1 if loose else 2e-2
        held = held_steps is None or step in held_steps
        step_name = f"{n}-token prompt" if step == 0 else f"decode step {step}"
        log(f"{prefix} {label} ({what}), {step_name}: max |dlogit|/max|logit| = {worst:.3g} "
            f"({f'tolerance {step_tol:g}' if held else 'logged'})")
        ok = ok and (worst <= step_tol or not held)
        pos += n
        ids = ref[:, -1].argmax(-1).numpy()[:, None]
    if not hold_argmax:
        log(f"{prefix} {label}: argmax agreement {agree}/{total} over the prompt and decode steps, "
            f"{decisive_agree}/{decisive_total} over the decisive rows (logged)")
        return ok
    if decisive_argmax:
        log(f"{prefix} {label}: argmax agreement {agree}/{total} over the prompt and decode steps, "
            f"{decisive_agree}/{decisive_total} over the rows whose CPU top-2 margin exceeds the step's max |dlogit| "
            f"(tolerance >= 95% of those, and at least {min_decisive:.0%} of the rows decisive)")
        return ok and decisive_total >= min_decisive * total and decisive_agree >= 0.95 * decisive_total
    log(f"{prefix} {label}: argmax agreement {agree}/{total} over the prompt and decode steps "
        f"(tolerance >= 95%)")
    return ok and agree >= 0.95 * total


PARITY_LENGTHS = (16, 40, 100, 200)  # ragged B = 4: W6Ax and W6A16 prefills, one past a page edge


def paged_parity(label, params, params_cpu, cfg, policy, dev, kv_dtype) -> bool:
    """forward_serve over a page pool with per-row positions, on the card vs
    the CPU plain versions (same weights): a ragged B = 4 batch prefilled
    through the scheduler's scratch-and-insert path (a B = 1 prefill into a
    page-sized scratch, then BatchScheduler._insert_scratch; every prompt
    position's logits are kept, as the dense parity runs keep them), then
    two decode steps of its paged tick (page_table + vector cache_pos),
    both fed the CPU's argmax."""
    cpu = torch.device("cpu")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in PARITY_LENGTHS]
    scheds = {d: BatchScheduler(p, cfg, policy, num_slots=4, max_seq_len=512, kv_dtype=kv_dtype, paged=True,
                                device=d) for d, p in ((dev, params), (cpu, params_cpu))}
    outs = {}
    for d, s in scheds.items():
        rows = []
        for i, prompt in enumerate(prompts):
            n = len(prompt)
            scratch = s._new_scratch(s.pool.pages_for(n) * s.pool.page_size)
            logits, kv1 = s._forward(s._ids(prompt), scratch, None, 0, prefill_bf16=n >= 64)
            s._insert_scratch(i, kv1, n)
            rows.append(logits[0].float().cpu())
        outs[d] = [torch.cat(rows)]  # [sum of prompt lengths, V]
    pos = np.array(PARITY_LENGTHS)
    last = np.cumsum(pos) - 1  # each prompt's last position in the prefill rows
    ok, agree, total = True, 0, 0
    for step in range(3):
        ref, got = outs[cpu][step], outs[dev][step]
        if not torch.isfinite(got).all():
            raise AssertionError(f"{label}: non-finite logits on the card")
        agree += int((got.argmax(-1) == ref.argmax(-1)).sum())
        total += ref.shape[0]
        rel = (got - ref).abs().amax(-1) / ref.abs().max()  # per logits row
        bounds = np.cumsum((0,) + PARITY_LENGTHS) if step == 0 else np.arange(5)
        errs, tols = [], []
        for r, n in enumerate(PARITY_LENGTHS):
            errs.append(rel[bounds[r] : bounds[r + 1]].max().item())
            # the dense parity runs' tolerances: 2e-2, and 1e-1 where 6-bit
            # activation codes part card from CPU: decode after a W6A16
            # prefill (its cache differs by bf16 ulps), and a W6Ax prompt over
            # the int8 pool, where cache_witness finds the int8 codes equal
            # wherever their inputs are and holds the same prompts at 2e-2
            # once the card's activation codes are handed on
            loose = (kv_dtype == torch.int8 and n < 64) or (step > 0 and n >= 64)
            tols.append(1e-1 if loose else 2e-2)
        what = "prefill (every prompt position)" if step == 0 else f"decode step {step}"
        log(f"slice parity {label} (2 layers, 7B width, card vs CPU plain), {what}: max |dlogit|/max|logit| "
            f"per prompt {dict(zip(PARITY_LENGTHS, (round(e, 5) for e in errs)))} (tolerance {tols})")
        ok = ok and all(e <= t for e, t in zip(errs, tols))
        if step == 2:
            break
        ids = (ref[last] if step == 0 else ref).argmax(-1)[:, None]
        for d, s in scheds.items():
            for i in range(4):  # the page the write at pos lands in
                while s.ptable.num_blocks[i] < pos[i] // s.pool.page_size + 1:
                    s.ptable.append(i, s._alloc(1)[0])
            positions = torch.as_tensor(pos, device=d)
            logits = s._step_paged_fn(ids.to(d), s.pool.state(), positions, s.ptable.to_device(d))
            outs[d].append(logits.float().cpu())
        pos = pos + 1
    log(f"slice parity {label}: argmax agreement {agree}/{total} over the prompt and decode steps "
        f"(tolerance >= 95%)")
    return ok and agree >= 0.95 * total


class Patch:
    """While the context is open, each function of models.quantized named in
    ``names`` is replaced by ``self._wrap(name, fn)``."""

    names = ()

    def __enter__(self):
        self.saved = {n: getattr(quantized, n) for n in self.names}
        for n, fn in self.saved.items():
            setattr(quantized, n, self._wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(quantized, n, fn)


# the functions of models.quantized that a Tap wraps: the int8 cache's
# quantizer and the activation producers (K1, K4, K5; OPT's K14, K15)
TAPPED = ("_kv_quant", "rmsnorm_quant", "quant_act", "glu_quant", "layernorm_quant", "relu_quant")


class Tap(Patch):
    """Wraps the functions in TAPPED where models.quantized calls them. Each
    call's tensor inputs and outputs are kept on the CPU; given the Tap of
    an earlier run of the same forward, each call's codes are compared with
    that run's (entries off, entries, most off; apart for calls whose
    inputs equal that run's, where only the function itself can part), and
    for the names in ``hand_on`` that run's outputs are handed on in place
    of this call's."""

    names = TAPPED

    def __init__(self, given=None, hand_on=()):
        self.given, self.hand_on = given, hand_on
        self.calls = {n: [] for n in TAPPED}
        # name -> [codes off, codes, most off], over the calls with equal / unequal inputs
        self.off = {n: {True: [0, 0, 0], False: [0, 0, 0]} for n in TAPPED}

    def _wrap(self, name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            ins = [t.cpu() for t in (*args, *kw.values()) if isinstance(t, torch.Tensor)]
            i = len(self.calls[name])
            self.calls[name].append((ins, tuple(t.cpu() for t in out)))
            if self.given is not None:
                ins_want, want = self.given.calls[name][i]
                dq = (out[0].cpu().int() - want[0].int()).abs()
                off = self.off[name][all(map(torch.equal, ins, ins_want))]
                off[0] += int((dq > 0).sum())
                off[1] += dq.numel()
                off[2] = max(off[2], int(dq.max()))
                if name in self.hand_on:
                    out = tuple(t.to(o.device) for t, o in zip(want, out))
            return out

        return call


def cache_witness(params, params_cpu, cfg, policy, dev, what="W6Ax", lengths=None) -> bool:
    """Where the card and the CPU part on a W6Ax prompt over an int8 cache:
    prompts of ``lengths`` tokens (by default those of paged_parity below
    64 tokens, LLaMA's W6Ax prompts), each prefilled into a 128-position
    B = 1 scratch as the scheduler does, over a bf16 and an int8 cache. The
    CPU runs three times: as it is; with the card's int8 K/V codes and
    scales handed on (the int8 cache then equals the card's); and with the
    producers' codes handed on too. Logged: the logit gap of each run, the
    codes of each tapped function that the CPU computed off the card's, and
    the layers whose cache the CPU wrote equal to the card's. Where a call's
    inputs equal the card's, holds the producers to their kernel check's
    tolerance (one code off on at most 0.1 % of entries) and the int8
    quant to the card's codes; holds the gap with every code handed on to
    2e-2 of max |logit|."""
    cpu = torch.device("cpu")
    rng = np.random.default_rng(SEED)
    lengths = lengths or [n for n in PARITY_LENGTHS if n < 64]
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]
    ok = True
    for kv_dtype in (torch.bfloat16, torch.int8):
        for prompt in prompts:
            n = len(prompt)

            def run(d, p, tap):
                c = dense_cache(cfg, 1, 128, kv_dtype, d)
                with tap:
                    logits, _ = forward_serve(p, cfg, policy, torch.as_tensor([prompt]), cache_pos=0, device=d,
                                              **cache_kw(c))
                return logits[0].float().cpu(), [t.cpu() for t in c]

            card_tap = Tap()
            card, card_cache = run(dev, params, card_tap)
            runs = [("as is", ())]
            if kv_dtype == torch.int8:
                runs.append(("card's int8 K/V handed on", ("_kv_quant",)))
            runs.append(("every code handed on", TAPPED))
            gaps = []
            for label, hand_on in runs:
                tap = Tap(card_tap, hand_on)
                got, cache = run(cpu, params_cpu, tap)
                gap = ((got - card).abs().max() / card.abs().max()).item()
                gaps.append(f"{label} {gap:.3g}")
                if label == "as is":
                    equal = [li for li in range(cfg.num_layers)
                             if all(torch.equal(a[li], b[li]) for a, b in zip(cache, card_cache))]

                    def fmt(same):
                        return {k: "{}/{} (most {})".format(*v[same]) for k, v in tap.off.items() if v[same][1]}

                    # equal inputs: the producers within their kernel check's
                    # tolerance, the int8 quant bit-exact
                    for k, v in tap.off.items():
                        off, total, most = v[True]
                        ok = ok and (most == 0 if k == "_kv_quant" else most <= 1 and off <= 1e-3 * total)
                    log(f"cache witness {n}-token {what} prompt, {str(kv_dtype)[6:]} cache (2 layers, 7B width, "
                        f"card vs CPU plain): codes off the card's, calls with equal inputs {fmt(True)}, "
                        f"calls with unequal inputs {fmt(False)}; layers whose cache the CPU wrote equal to "
                        f"the card's: {equal} of {cfg.num_layers}")
                if label == "every code handed on":
                    ok = ok and gap <= 2e-2
            log(f"cache witness {n}-token {what} prompt, {str(kv_dtype)[6:]} cache: max |dlogit|/max|logit| "
                f"{'; '.join(gaps)} (tolerances: the producers one code off on <= 0.1% of entries; "
                f"2e-2 with every code handed on)")
    return ok


def slice_parity(dev, gen):
    """2-layer models at 7B width: the W6Ax path (16-token prompt), then the
    W6A16 prefill (128-token prompt) over an unfused and a fuse=True tree,
    with an int8 cache, and under the weight-only W6A16 policy; then the
    other formats: W4A8 (16- and 128-token prompts: the W4A8 layer, the W4A16
    prefill), weight-only W4A16, W8A8 (16 and 128 tokens: the W8A8 layer,
    the dequantized W8A16 prefill), and llama_flex with a W6A8 lm_head;
    then the paged cache (bf16 and int8 pools, per-row positions)."""
    cfg = ModelConfig.llama(num_layers=2)
    flex = QuantPolicy.llama_flex()
    cpu = torch.device("cpu")
    params = random_params(cfg, flex, gen, dev)
    params_cpu = to_device(params, cpu)
    fused = random_params(cfg, flex, gen, dev, fuse=True)
    fused_cpu = to_device(fused, cpu)
    ok = [
        parity("W6Ax", params, params_cpu, cfg, flex, 16, dev),
        parity("W6A16 unfused", params, params_cpu, cfg, flex, 128, dev),
        parity("W6A16 fuse=True", fused, fused_cpu, cfg, flex, 128, dev),
        parity("W6A16 int8 cache", params, params_cpu, cfg, flex, 128, dev, kv_dtype=torch.int8),
        # the weight-only tree is the same planes (weights quantize alike under both policies)
        parity("weight-only W6A16", params, params_cpu, cfg, QuantPolicy.weight_only(wbits=6), 128, dev),
    ]
    flex_head = QuantPolicy.llama_flex().with_head(6, 8)
    head = quantize_head(params["lm_head"], flex_head)
    ok.append(parity("W6Ax + W6A8 head", dict(params, lm_head=head), dict(params_cpu, lm_head=to_device(head, cpu)),
                     cfg, flex_head, 16, dev))
    ok += [paged_parity(f"paged {name} pool", params, params_cpu, cfg, flex, dev, dt)
           for name, dt in (("bf16", torch.bfloat16), ("int8", torch.int8))]
    ok.append(cache_witness(params, params_cpu, cfg, flex, dev))
    del params, params_cpu, fused, fused_cpu
    for bits, lengths in ((4, (16, 128)), (8, (16, 128))):
        policy = QuantPolicy.uniform(wbits=bits, abits=8)
        params = random_params(cfg, policy, gen, dev)
        params_cpu = to_device(params, cpu)
        ok += [parity(f"W{bits}A8", params, params_cpu, cfg, policy, l, dev) for l in lengths]
        if bits == 4:  # the same planes: weights quantize alike under both policies
            ok.append(parity("weight-only W4A16", params, params_cpu, cfg, QuantPolicy.weight_only(wbits=4), 128, dev))
    del params, params_cpu
    ok += opt_slice_parity(dev, gen)
    return all(ok)


def opt_slice_parity(dev, gen):
    """2-layer OPT at OPT-6.7B width, a 16-token prompt (OPT always runs the
    W*Ax layer, or the W*A16 one under a weight-only policy) and two decode
    steps: opt_flex over a bf16 and an int8 cache, and over a bf16 cache
    from a 100-token prompt (attention's output on K9's tensor-core tiles
    goes straight into K4's 6-bit codes), with the cache witness of its 16-,
    40- and 100-token prompts; weight-only W4A16 and W8A8. The
    tied head's 50272 random bf16 logits hold exact ties and near-ties, so
    the argmax is held over the decisive rows. opt_flex's logits get 1e-1:
    every activation producer feeding a 6-bit GEMM (o_proj, fc1, fc2) can
    part card from CPU by a code once attention's sums differ in order,
    and the witness holds the same prompts at 2e-2 with the card's codes
    handed on."""
    cfg = ModelConfig.opt(**dict(OPT_67B, num_layers=2))
    cpu = torch.device("cpu")
    flex = QuantPolicy.opt_flex()
    params = random_opt_params(cfg, flex, gen, dev)
    params_cpu = to_device(params, cpu)
    ok = [parity("OPT opt_flex", params, params_cpu, cfg, flex, 16, dev, tol=1e-1, decisive_argmax=True),
          parity("OPT opt_flex int8 cache", params, params_cpu, cfg, flex, 16, dev, kv_dtype=torch.int8, tol=1e-1,
                 decisive_argmax=True),
          # a 100-token prompt's random-weight logits hold more near-ties than
          # a 16-token one's: a third of its rows or so are decisive with
          # either K9 kernel (PERF.md §6), so a quarter, not half
          parity("OPT opt_flex 100-token", params, params_cpu, cfg, flex, 100, dev, tol=1e-1, decisive_argmax=True,
                 min_decisive=0.25),
          cache_witness(params, params_cpu, cfg, flex, dev, what="OPT opt_flex", lengths=(16, 40, 100))]
    for label, policy in (("OPT weight-only W4A16", QuantPolicy.weight_only("opt", 4)),
                          ("OPT W8A8", QuantPolicy.uniform("opt", 8, 8))):
        del params, params_cpu
        params = random_opt_params(cfg, policy, gen, dev)
        params_cpu = to_device(params, cpu)
        ok.append(parity(label, params, params_cpu, cfg, policy, 16, dev, decisive_argmax=True))
    return ok


# the kernels each end-to-end run must launch
PRODUCERS = ("rmsnorm_quant", "quant_act", "glu_quant")
W6AX = PRODUCERS + ("w6_matmul", "w6_matmul_stream", "flash_decode", "flash_prefill")
OPT_PRODUCERS = ("layernorm_quant", "quant_act", "relu_quant")
OPT_W6AX = OPT_PRODUCERS + ("w6_matmul", "w6_matmul_stream", "flash_decode", "flash_prefill")
PATH_KERNELS = {
    "32-token": W6AX,
    "512-token": ("w6_matmul_bf16", "w6_glu_matmul_bf16", "flash_prefill", "flash_decode", "w6_matmul"),
    "512-token fuse=True": ("w6_matmul_bf16", "w6_glu_fused_bf16", "flash_prefill", "flash_decode", "w6_matmul"),
    # the W4A8 layer at every linear and the packed head (K4 + K10)
    "W4A8 32-token": PRODUCERS + ("w4_matmul", "flash_decode", "flash_prefill"),
    # the W4A16 prefill (K11 with the RoPE epilogue), then W4A8 decode
    "W4A8 512-token": PRODUCERS + ("w4_matmul_bf16", "w4_matmul", "flash_prefill", "flash_decode"),
    # K11 at every step, the head too (no activation quant: no producer)
    "W4A16 512-token": ("w4_matmul_bf16", "flash_prefill", "flash_decode"),
    "W8A8 32-token": PRODUCERS + ("w8_matmul", "flash_decode", "flash_prefill"),
    # llama_flex with a W6A8 head: K4 + K2 at the head
    "W6Ax+head 32-token": W6AX,
    # the continuous-batching scheduler: W6Ax and W6A16 prefills (whole and
    # chunked) into a scratch, then W6Ax decode ticks over the dense cache or
    # the page pool (K13)
    "scheduler dense": W6AX + ("w6_matmul_bf16", "w6_glu_matmul_bf16"),
    "scheduler paged": PRODUCERS + ("w6_matmul", "w6_matmul_stream", "flash_decode_paged", "flash_prefill",
                                    "w6_matmul_bf16", "w6_glu_matmul_bf16"),
    # OPT under opt_flex: K14 / K4 / K15 producers and the exact W6Ax GEMMs at
    # every step (the 512-token prompt at M = 2048: OPT never takes W*A16)
    "OPT 32-token": OPT_W6AX,
    "OPT 512-token": OPT_W6AX,
    # weight-only W4A16: K11 at every linear (the head is tied, a bf16 matmul)
    "OPT W4A16 32-token": ("w4_matmul_bf16", "flash_prefill", "flash_decode"),
    "OPT scheduler paged": OPT_PRODUCERS + ("w6_matmul", "w6_matmul_stream", "flash_decode_paged", "flash_prefill"),
    # phase 6: speculative decoding on 64-token prompts: the W6A16 prefill,
    # then [B, 1 + k] verify windows through the W6Ax layer (K9's
    # short-prompt kernel, the exact GEMM at M = B(1 + k) on route A)
    "spec": PRODUCERS + ("w6_matmul", "flash_prefill", "w6_matmul_bf16", "w6_glu_matmul_bf16"),
    # the scheduler's beam groups beside regular requests
    "beam scheduler dense": W6AX,
    "beam scheduler paged": PRODUCERS + ("w6_matmul", "w6_matmul_stream", "flash_decode_paged", "flash_prefill"),
    # phase 11: the pipelined Engine and scheduler on each stage (every prompt
    # through the W*Ax layer: no W*A16 prefill under pp)
    "pp 32-token": W6AX,
    "pp scheduler": W6AX,
    # the sequence-parallel prefill's W6A16 GEMMs (K7) on a rank's chunk, then
    # the W6Ax decode layer (its attention plain tensor math, merged over the ring)
    "sp": PRODUCERS + ("w6_matmul_bf16", "w6_matmul", "w6_matmul_stream"),
}


# the wrappers that count their launches by M: K2, K10, K12 and the producers
BY_M_WRAPPERS = (w6_matmul, w4_matmul, w8_matmul, rmsnorm_quant, quant_act, glu_quant, layernorm_quant, relu_quant)
BY_M = {fn.__name__: {} for fn in BY_M_WRAPPERS}  # name -> {M: launches} over phase 4's main-path runs


def add_by_m() -> None:
    """Add the last run's launches by M (read just after the run, as the
    counts are) to BY_M."""
    for fn in BY_M_WRAPPERS:
        for m, v in fn.launches_by_m.items():
            BY_M[fn.__name__][m] = BY_M[fn.__name__].get(m, 0) + v


def by_m_bins(name: str) -> dict:
    """A wrapper's launches over phase 4 by M: decode (M <= 8), the 4 x
    32-token prompts (128), the scheduler's other chunks (<= 256), OPT's
    4 x 512-token prompt (2048), the rest."""
    bins = {"M<=8": 0, "M=128": 0, "M<=256": 0, "M=2048": 0, "other": 0}
    for m, v in BY_M[name].items():
        key = "M<=8" if m <= 8 else "M=128" if m == 128 else "M<=256" if m <= 256 else "M=2048" if m == 2048 else "other"
        bins[key] += v
    return bins


def log_by_m() -> None:
    for name in BY_M:
        log(f"e2e {name} launches by M: " + " ".join(f"{k}={v}" for k, v in by_m_bins(name).items()))


def generate_run(label, path, eng, prompts, new, dev, mode="fused", counted=True):
    """One greedy generate (after a short warm-up), its launch counts zeroed
    just before and read just after; returns (tokens, counts, stats).
    ``counted``: the caller adds the counts to the phase's (the launches by
    M go to BY_M then)."""
    eng.generate(prompts, max_new_tokens=2, eos_id=-1, mode=mode)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    out, stats = eng.generate(prompts, max_new_tokens=new, eos_id=-1, return_stats=True, mode=mode)
    counts = launch_counts()
    if counted:
        add_by_m()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    b, l = prompts.shape
    if [len(r) for r in out] != [new] * b or not all(0 <= t < eng.cfg.vocab_size for r in out for t in r):
        raise AssertionError(f"{label}: bad generate output shape/range: {[len(r) for r in out]}")
    decode_s = stats.decode_s if mode == "fused" else sum(stats.step_times_s)
    log(f"e2e {label} ({mode}) B={b} prompt={l} new={new}: ttft_ms={stats.ttft_s * 1e3:.2f} "
        f"decode_ms_per_step={decode_s / (new - 1) * 1e3:.2f} "
        f"tokens_per_s={b * new / (stats.ttft_s + stats.decode_s):.1f} "
        f"decode_tokens_per_s={b * (new - 1) / decode_s:.1f} peak_mem_gib={peak_gib:.2f}")
    log(f"e2e {label} launches: " + " ".join(f"{k}={v}" for k, v in counts.items()))
    missing = [k for k in PATH_KERNELS[path] if counts[k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels of the path never launched: {missing}")
    return out, counts, stats


SCHED = dict(num_slots=8, max_seq_len=2048, page_size=128, prefill_chunk=256)
SHARED = (0, 1, 8, 9, 10, 11)  # requests whose prompts start with one 256-token prefix


def sched_requests(vocab: int):
    """16 seeded requests: (prompt, max_new); prompts of 16-700 tokens (both
    prefill layers, whole and chunked), max_new 16-64; SHARED start with a
    common 256-token prefix. The first 8 are added up front, the rest after
    the 4th tick."""
    rng = np.random.default_rng(SEED + 3)
    prefix = rng.integers(0, vocab, 256).tolist()
    reqs = []
    for r in range(16):
        if r in SHARED:
            prompt = prefix + rng.integers(0, vocab, int(rng.integers(16, 445))).tolist()
        else:
            prompt = rng.integers(0, vocab, int(rng.integers(16, 701))).tolist()
        reqs.append((prompt, int(rng.integers(16, 65))))
    return reqs


SCHED_RUNS = {}  # label -> streams and metrics of each sched_run in this call (phase 7 compares fused with per-token)


def sched_run(label, path, params, cfg, policy, dev, reqs, keep_logits=False, **kw):
    """One BatchScheduler run over ``reqs`` (launch counts zeroed just before,
    read just after); checks that every request got exactly its max_new
    tokens and, paged, that the pool got every non-garbage page back.
    ``keep_logits``: SCHED_RUNS[label]["logits"] holds, per request, the
    logits each token was drawn from (bf16 [n, V] on the host). Returns
    (token lists, counts, scheduler)."""
    sched = BatchScheduler(params, cfg, policy, **SCHED, device=dev, **kw)
    tap = SchedTap(sched) if keep_logits else None
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    ids = [sched.add_request(p, max_new_tokens=n, eos_id=-1) for p, n in reqs[:8]]
    out = {}
    for _ in range(4):
        out.update(sched.step())
    ids += [sched.add_request(p, max_new_tokens=n, eos_id=-1) for p, n in reqs[8:]]
    out.update(sched.run())
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    add_by_m()
    tokens = [out[i] for i in ids]
    bad = [r for r, (t, (_, n)) in enumerate(zip(tokens, reqs)) if len(t) != n or not all(0 <= x < cfg.vocab_size for x in t)]
    if bad:
        raise AssertionError(f"{label}: requests {bad} did not get exactly max_new valid tokens")
    ttft = sorted((sched.t_first[i] - sched.t_arrival[i]) * 1e3 for i in ids)
    gen_tokens = sum(len(t) for t in tokens)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else float("nan")
    extra = ""
    if sched.paged:
        reclaim = sched.registry.reclaimable if sched.registry is not None else 0
        if sched.pool.free_pages + reclaim != sched.pool.num_pages - 1:
            raise AssertionError(f"{label}: pool free {sched.pool.free_pages} + retained {reclaim} != "
                                 f"{sched.pool.num_pages - 1} pages")
        extra = (f" num_pages={sched.pool.num_pages} free_after={sched.pool.free_pages} retained_after={reclaim}"
                 f" preemptions={sched.preemptions}")
        if sched.registry is not None:
            extra += f" prefix_hits={sched.registry.hits} prefix_misses={sched.registry.misses}"
    ms_step = sum(sched.tick_s) / sum(sched.tick_steps) * 1e3
    SCHED_RUNS[label] = dict(tokens=tokens, tokens_per_s=gen_tokens / wall, ticks=len(sched.tick_s),
                             ms_tick=statistics.mean(sched.tick_s) * 1e3, ms_step=ms_step,
                             ttft_p50=statistics.median(ttft), ttft_max=ttft[-1])
    if tap is not None:
        SCHED_RUNS[label]["logits"] = [torch.stack(tap.rows[i]).to(torch.bfloat16).cpu() for i in ids]
    if sched.fused_graphs:
        graphs = list(sched.fused_graphs.values())
        fused = [(s, n) for s, n, f in zip(sched.tick_s, sched.tick_steps, sched.tick_fused) if f]
        n_fused, steps_fused = len(fused), sum(n for _, n in fused)
        extra += (f" fused_ticks={n_fused} steps_per_fused_tick={steps_fused / max(n_fused, 1):.2f} "
                  f"ms_per_step_in_fused_ticks={sum(s for s, _ in fused) / max(steps_fused, 1) * 1e3:.2f} graphs="
                  f"{len(graphs)} capture_ms={[round(g.capture_s * 1e3, 1) for g in graphs]} replays="
                  f"{sum(g.replays for g in graphs)} launches_per_replay={[g.launches_per_replay for g in graphs]}")
    log(f"sched {label}: 16 requests, {gen_tokens} tokens in {wall:.2f}s: tokens_per_s={gen_tokens / wall:.1f} "
        f"decode_ticks={len(sched.tick_s)} mean_ms_per_decode_tick={statistics.mean(sched.tick_s) * 1e3:.2f} "
        f"mean_ms_per_decode_step={ms_step:.2f} "
        f"ttft_ms_p50={statistics.median(ttft):.1f} ttft_ms_max={ttft[-1]:.1f} peak_mem_gib={peak:.2f}{extra}")
    log(f"sched {label} launches: " + " ".join(f"{k}={v}" for k, v in counts.items()))
    missing = [k for k in PATH_KERNELS[path] if counts[k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels of the path never launched: {missing}")
    return tokens, counts, sched


def warm_scheduler(params, cfg, policy, dev, reqs):
    """First-use set-up of a scheduler (not timed): two short requests."""
    warm = BatchScheduler(params, cfg, policy, **SCHED, paged=True, device=dev)
    for p, _ in reqs[:2]:
        warm.add_request(p, max_new_tokens=2, eos_id=-1)
    warm.run()


def scheduler_runs(params, cfg, policy, dev):
    """The continuous-batching scheduler at 7B width, 8 slots, max_seq_len
    2048, 128-token pages, prefill_chunk 256, 16 requests (sched_requests):
    paged bf16; dense bf16 (first tokens equal the paged run's); paged bf16
    with prefix_cache (hits > 0); paged int8; paged bf16 in a 24-page pool
    (the first 8 requests need 28 pages: it preempts). Returns the summed
    launch counts."""
    reqs = sched_requests(cfg.vocab_size)
    log(f"sched: prompt lengths {[len(p) for p, _ in reqs]}, max_new {[n for _, n in reqs]}")
    warm_scheduler(params, cfg, policy, dev, reqs)
    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    paged, counts, sched = sched_run("paged bf16", "scheduler paged", params, cfg, policy, dev, reqs, paged=True)
    add(counts)
    del sched
    dense, counts, sched = sched_run("dense bf16", "scheduler dense", params, cfg, policy, dev, reqs,
                                     keep_logits=True)
    add(counts)
    PHASE4["sched_dense"] = (dense, SCHED_RUNS["dense bf16"]["logits"])  # phase 11's pipelined scheduler's hold
    del sched
    first = [a[0] == b[0] for a, b in zip(paged, dense)]
    same = [a == b for a, b in zip(paged, dense)]
    div = [(r, next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)) for r, (a, b) in enumerate(zip(paged, dense))
           if a != b]
    log(f"sched dense vs paged: first tokens equal {sum(first)}/16, whole streams equal {sum(same)}/16, "
        f"first divergence (request, token) {div[:4]} (decode attention blocks: 128 keys paged, 512 dense)")
    if not all(first):
        raise AssertionError("dense and paged runs disagree on a first token (identical prefill path)")
    _, counts, sched = sched_run("paged bf16 prefix_cache", "scheduler paged", params, cfg, policy, dev, reqs,
                                 paged=True, prefix_cache=True)
    add(counts)
    if sched.registry.hits == 0:
        raise AssertionError("prefix_cache run: no prefix page was reused")
    del sched
    _, counts, sched = sched_run("paged int8", "scheduler paged", params, cfg, policy, dev, reqs, paged=True,
                                 kv_dtype=torch.int8)
    add(counts)
    del sched
    _, counts, sched = sched_run("paged bf16 24-page pool", "scheduler paged", params, cfg, policy, dev, reqs,
                                 paged=True, num_pages=24)
    add(counts)
    if sched.preemptions == 0:
        raise AssertionError("24-page pool: no request was preempted")
    del sched
    if dev.type == "cuda":
        short = [(p[:32], 16) for p, _ in reqs[:8]]

        def profiled():
            s = BatchScheduler(params, cfg, policy, **SCHED, paged=True, device=dev)
            for p, n in short:
                s.add_request(p, max_new_tokens=n, eos_id=-1)
            s.run()

        profile_call("scheduler paged bf16, 8 requests x 32-token prompts, 16 new", profiled)
    return totals


SPEC_K = 4  # phase 6's draft length: verify windows of 1 + SPEC_K tokens
SAMPLED = SamplingParams(temperature=0.8, top_p=0.9, repetition_penalty=1.1, greedy=False)  # phase 6's, seed 1


def run_counted(label, path, fn):
    """Call ``fn`` with the launch counts zeroed just before and read just
    after (the launches by M go to BY_M); every kernel of ``path`` must have
    launched (on the card: on the CPU every wrapper takes its plain
    version). Returns (fn's result, counts)."""
    on_card = torch.cuda.is_available()
    if on_card:
        torch.cuda.synchronize()
    reset_launch_counts()
    out = fn()
    counts = launch_counts()
    add_by_m()
    missing = [k for k in PATH_KERNELS[path] if counts[k] == 0]
    if on_card and missing:
        raise AssertionError(f"{label}: kernels of the path never launched: {missing}")
    log(f"modes {label} launches: " + " ".join(f"{k}={v}" for k, v in counts.items() if v))
    return out, counts


def spec_prompts(vocab: int, b: int = 4, n: int = 64, period: int = 16):
    """B prompts of n tokens, each repeating its own seeded period-token
    pattern (random weights need not continue it: the drafts then fail, and
    the run measures the loop's overhead with the gate engaged)."""
    rng = np.random.default_rng(SEED + 11)
    return [np.tile(rng.integers(0, vocab, period), n // period).tolist() for _ in range(b)]


class LogitTap:
    """Keeps the logits of an Engine's prompts (``prompts``: [B, V] a
    prompt), decode steps (``steps``: [B, V] a step) and verify windows
    (``windows``: (starts [B], [B, C, V]) a step), and counts
    flash_prefill's launches inside windows of ``width`` tokens. The
    tensors stay on the device until read."""

    def __init__(self, eng, width: int = 0):
        self.eng, self.width = eng, width
        self.prompts, self.steps, self.windows, self.window_launches = [], [], [], 0

    def __enter__(self):
        eng, prefill, step, spec = self.eng, self.eng._prefill, self.eng._decode_step, self.eng._spec_forward

        def prompt(ids, cache, prompt_len):
            logits, cache = prefill(ids, cache, prompt_len)
            self.prompts.append(logits)
            return logits, cache

        def decode_step(ids, cache, pos):
            logits, cache = step(ids, cache, pos)
            self.steps.append(logits)
            return logits, cache

        def spec_forward(ids, cache, start):
            before = flash_prefill.launches
            logits, cache = spec(ids, cache, start)
            if ids.shape[1] == self.width:
                self.window_launches += flash_prefill.launches - before
            starts = start if isinstance(start, torch.Tensor) else torch.full((ids.shape[0],), int(start))
            self.windows.append((starts.cpu(), logits))
            return logits, cache

        eng._prefill, eng._decode_step, eng._spec_forward = prompt, decode_step, spec_forward
        return self

    def __exit__(self, *exc):
        del self.eng._prefill, self.eng._decode_step, self.eng._spec_forward

    def at(self, row: int, i: int):
        """Row ``row``'s logits for its token i: the prompt's for token 0,
        else decode step i - 1's."""
        return self.prompts[0][row] if i == 0 else self.steps[i - 1][row]

    def spec_at(self, prompt_len: int):
        """decisive_hold's logits of a speculative run: token i (from 1) of
        row r is drawn at query position prompt_len + i - 1."""
        return lambda row, i: self.spec_logits(row, prompt_len + i - 1)

    def spec_logits(self, row: int, q: int):
        """Row ``row``'s logits for the token after query position q: from
        the last window that started at or before q (each step's window
        starts where the accepted prefix ended)."""
        for starts, logits in reversed(self.windows):
            s = int(starts[row])
            if s <= q:
                return logits[row, q - s]
        raise KeyError((row, q))


class ReadWait:
    """The host's seconds inside ``Tensor.tolist`` and its calls while the
    context is open: the fused spec loop's one flag read a step (it reads
    nothing else through tolist)."""

    def __enter__(self):
        self.s, self.calls, self.orig = 0.0, 0, torch.Tensor.tolist

        def timed(t):
            t0 = time.perf_counter()
            out = self.orig(t)
            self.s += time.perf_counter() - t0
            self.calls += 1
            return out

        torch.Tensor.tolist = timed
        return self

    def __exit__(self, *exc):
        torch.Tensor.tolist = self.orig


class OracleDrafts:
    """Drafts that propose a given continuation of each row (its prompt
    followed by ``streams``), patched over speculative.py's n-gram drafts
    (the fused loop's device version and the host loop's). Given the stream
    the verify windows themselves produce (an ungated run's), the windows
    accept the drafts, so the accept rule, the multi-token advance and the
    overwrite of rejected drafts' KV run on the card, which random weights
    never reach with n-gram drafts."""

    def __init__(self, prompts, streams, k: int, dev):
        rows = [list(p) + list(s) for p, s in zip(prompts, streams)]
        width = max(map(len, rows)) + k + 1
        self.full = torch.tensor([r + [r[-1]] * (width - len(r)) for r in rows], dtype=torch.int64, device=dev)

    def device(self, buf, length, k, max_ngram=3):
        pos = length.to(torch.int64)[:, None] + torch.arange(k, device=buf.device)[None, :]
        rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
        return self.full[rows, pos.clamp(max=self.full.shape[1] - 1)]

    def host(self, history, k, max_ngram=3, min_ngram=1):
        n = len(history)
        return self.full[0, n : n + k].cpu().numpy().astype(np.int32)

    def __enter__(self):
        self.saved = speculative.ngram_draft_device, speculative.ngram_draft
        speculative.ngram_draft_device, speculative.ngram_draft = self.device, self.host
        return self

    def __exit__(self, *exc):
        speculative.ngram_draft_device, speculative.ngram_draft = self.saved


def decisive_hold(label, plain, got, plain_at, got_at, rows, first=1):
    """The token streams of two runs, per (plain row, other row) of
    ``rows`` from token ``first`` up to its first parting token: a step is
    decisive where the plain run's top-2 margin exceeds the gap between the
    two runs' logits there (``plain_at(r, i)`` / ``got_at(r, i)``: the
    logits token i of row r was drawn from). Logs every parted step's
    margin; returns (decisive steps held, decisive steps, steps compared).
    A hold passes only over at least one decisive step (``hold_passes``)."""
    held = decisive = compared = 0
    for r, rs in rows:
        for i in range(first, min(len(plain[r]), len(got[rs]))):
            compared += 1
            a, b = plain_at(r, i).float(), got_at(rs, i).float()
            top2 = a.topk(2).values
            margin = (top2[0] - top2[1]).item()
            gap = (a - b).abs().max().item()
            same = plain[r][i] == got[rs][i]
            if margin > gap:
                decisive += 1
                held += same
            if not same:
                log(f"{label}: row {r} parts at token {i}: top-2 margin {margin / a.abs().max().item():.4%} of max "
                    f"|logit|, gap between the runs' logits {gap / a.abs().max().item():.4%} "
                    f"({'decisive' if margin > gap else 'a near-tie'})")
                break
    return held, decisive, compared


def hold_passes(held: int, decisive: int) -> bool:
    return decisive > 0 and held >= 0.95 * decisive


def decoding_modes(params, cfg, policy, dev, p32, greedy32):
    """Phase 6, on phase 4's LLaMA-2-7B model: sampled Engine runs (fused ==
    step under one seed, and a repeat), a greedy run with logprobs (phase
    4's tokens); speculative decoding on 64-token prompts that repeat a
    16-token pattern (k = SPEC_K, 64 new tokens: the fused loop at B = 4 held
    to plain greedy over the decisive steps with n-gram and with oracle
    drafts, the B = 1 host loop likewise on two rows, the cost of the
    flags' host read, a sampled run repeated); Engine beam search (B = 1, K = 4, 32 new
    tokens: width 1 equals greedy, the best score at least greedy's); the
    scheduler's beam groups beside 4 regular requests over the dense, paged
    bf16 and paged int8 caches, each equal to the standalone n-best. Returns
    the summed launch counts and the phase's seconds."""
    t_phase = t_part = time.perf_counter()
    b, new = len(p32), 32

    def part(what):
        nonlocal t_part
        log(f"modes {what}: {time.perf_counter() - t_part:.1f}s")
        t_part = time.perf_counter()

    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    eng = Engine(params, cfg, policy, max_seq_len=2048, device=dev)
    # sampled: fused == step under one seed, a repeat equal
    sp = SAMPLED
    eng.generate(p32, max_new_tokens=2, sampling=sp, eos_id=-1)  # warm-up
    t0 = time.perf_counter()
    (fused, stats), counts = run_counted("sampled fused", "32-token", lambda: eng.generate(
        p32, max_new_tokens=new, sampling=sp, eos_id=-1, seed=1, return_stats=True))
    add(counts)
    step = eng.generate(p32, max_new_tokens=new, sampling=sp, eos_id=-1, seed=1, mode="step")
    again = eng.generate(p32, max_new_tokens=new, sampling=sp, eos_id=-1, seed=1)
    log(f"modes sampled (temperature 0.8, top_p 0.9, repetition_penalty 1.1) B={b} prompt=32 new={new}: "
        f"decode_ms_per_step={stats.decode_s / (new - 1) * 1e3:.2f}; fused == step: {fused == step}; repeat "
        f"equal: {fused == again}; first row {fused[0][:8]} ({time.perf_counter() - t0:.1f}s)")
    if fused != step or fused != again or any(len(r) != new for r in fused):
        raise AssertionError("sampled Engine runs: fused and step, or a repeat of the seed, disagree")
    PHASE4["sampled32"] = step  # phase 11's pipelined sampled run is held to it
    out, lps = eng.generate(p32, max_new_tokens=new, eos_id=-1, return_logprobs=True)
    finite = all(math.isfinite(x) and x <= 0 for r in lps for x in r)
    log(f"modes greedy with logprobs: tokens equal to phase 4's: {out == greedy32}; logprobs finite and <= 0: "
        f"{finite}; first row's mean logprob {statistics.mean(lps[0]):.4f}")
    if out != greedy32 or not finite:
        raise AssertionError("greedy logprob run: tokens part from phase 4's, or a logprob is not finite")
    part("sampled and logprob runs")

    # speculative decoding on repetitive prompts
    ps = spec_prompts(cfg.vocab_size)
    n_spec = 64
    eng.generate(ps, max_new_tokens=2, eos_id=-1)  # warm-up (the W6A16 prefill at 64 tokens)
    speculative.generate_speculative(eng, ps, max_new_tokens=4, k=SPEC_K, eos_id=-1)
    # plain greedy's logits are tapped in the step loop (the fused loop replays a captured graph of its step,
    # with no Python call a step to tap); its tokens equal the fused loop's, whose time is the yardstick
    with LogitTap(eng, 1 + SPEC_K) as plain_tap:
        plain = eng.generate(ps, max_new_tokens=n_spec, eos_id=-1, mode="step")
    fused_plain, pstats = eng.generate(ps, max_new_tokens=n_spec, eos_id=-1, return_stats=True)
    if fused_plain != plain:
        raise AssertionError("plain greedy on the spec prompts: the fused and step loops disagree")
    with LogitTap(eng, 1 + SPEC_K) as spec_tap:
        (got, st), counts = run_counted("spec fused", "spec", lambda: speculative.generate_speculative(
            eng, ps, max_new_tokens=n_spec, k=SPEC_K, eos_id=-1, return_stats=True))
    add(counts)
    held, decisive, compared = decisive_hold("modes spec fused B=4", plain, got, plain_tap.at,
                                             spec_tap.spec_at(len(ps[0])), [(r, r) for r in range(b)])
    m20 = w6_matmul.launches_by_m.get(b * (1 + SPEC_K), 0)  # the spec run's, read before the next reset
    route_a = w6ax_route(b * (1 + SPEC_K), cfg.hidden_size, cfg.hidden_size) == W6AX_MMA
    plain_ms = pstats.decode_s / (n_spec - 1) * 1e3
    spec_ms = st.decode_s / (n_spec - 1) * 1e3
    log(f"modes spec fused B={b} prompt=64 (a 16-token pattern x 4) k={SPEC_K} new={n_spec}: "
        f"acceptance_rate={st.acceptance_rate:.3f} tokens_per_verify_step={st.tokens_per_step:.2f} ({st.generated} "
        f"tokens over {b} rows / {st.steps} steps: {st.tokens_per_step / b:.2f} a row) decode_ms_per_token={spec_ms:.2f} against plain greedy's "
        f"{plain_ms:.2f} ({plain_ms / spec_ms:.2f}x); spec == plain greedy rows {sum(a == c for a, c in zip(got, plain))}"
        f"/{b}; decisive steps held {held}/{decisive} (tolerance >= 95%), {decisive}/{compared} of the steps "
        f"compared decisive; flash_prefill launches in "
        f"{1 + SPEC_K}-token windows {spec_tap.window_launches}; w6_matmul launches at M = {b * (1 + SPEC_K)} "
        f"{m20} (route {'A' if route_a else 'B'})")
    launched = dev.type != "cuda" or (spec_tap.window_launches > 0 and m20 > 0 and route_a)  # the CPU launches none
    if not hold_passes(held, decisive) or not launched:
        raise AssertionError("spec fused: decisive steps part from plain greedy (or none is decisive), or the window "
                             "kernels did not run")
    # the gate's host read a step: the ungated fused loop with its flags read every step and every 8th, alternated;
    # the host's time blocked in the read (the loop's one Tensor.tolist a step) is timed directly
    per_step, blocked = {1: [], 8: []}, {1: [], 8: []}
    streams = {}
    for _ in range(3):
        for every in per_step:
            eng.SPEC_FLAG_READ_EVERY = every
            try:
                with ReadWait() as wait:
                    streams[every], rs = speculative.generate_speculative(eng, ps, max_new_tokens=n_spec, k=SPEC_K,
                                                                          eos_id=-1, return_stats=True, gate=False)
            finally:
                del eng.SPEC_FLAG_READ_EVERY
            per_step[every].append(rs.decode_s / rs.steps * 1e3)
            blocked[every].append((wait.s * 1e3 / max(wait.calls, 1), wait.calls))
    r1, r8 = statistics.median(per_step[1]), statistics.median(per_step[8])
    w1 = statistics.median(ms for ms, _ in blocked[1])
    log(f"modes spec flag read (ungated fused loop B={b} k={SPEC_K} new={n_spec}, 3 runs each, alternated): ms a step "
        f"read every step {[round(x, 3) for x in per_step[1]]} (median {r1:.3f}), read every 8th "
        f"{[round(x, 3) for x in per_step[8]]} (median {r8:.3f}): difference {(r1 - r8) / (1 - 1 / 8):.3f} ms a step; "
        f"the host blocked in the read {[round(ms, 3) for ms, _ in blocked[1]]} ms a read over "
        f"{[n for _, n in blocked[1]]} reads (median {w1:.3f}: {w1 / r1:.1%} of a step); tokens equal: "
        f"{streams[1] == streams[8]}")
    if streams[1] != streams[8]:
        raise AssertionError("spec fused loop: a stale flag changed the greedy tokens")
    part("flag read cost")
    # oracle drafts: the ungated run's own stream (every token a window's), so the verify windows accept them and
    # the accept rule, the multi-token advance and the overwrite of rejected drafts' KV run at full width
    ungated = streams[1]
    with OracleDrafts(ps, ungated, SPEC_K, dev), LogitTap(eng, 1 + SPEC_K) as oracle_tap:
        (ogot, ost), counts = run_counted("spec fused oracle drafts", "spec", lambda: speculative.generate_speculative(
            eng, ps, max_new_tokens=n_spec, k=SPEC_K, eos_id=-1, return_stats=True))
    add(counts)
    oheld, odecisive, ocompared = decisive_hold("modes spec fused oracle drafts", plain, ogot, plain_tap.at,
                                                oracle_tap.spec_at(len(ps[0])), [(r, r) for r in range(b)])
    log(f"modes spec fused B={b} k={SPEC_K} new={n_spec}, oracle drafts: acceptance_rate={ost.acceptance_rate:.3f} "
        f"tokens_per_verify_step={ost.tokens_per_step:.2f} ({ost.tokens_per_step / b:.2f} a row, {ost.steps} steps) "
        f"decode_ms_per_token={ost.decode_s / (n_spec - 1) * 1e3:.2f}; equal to the ungated run's stream "
        f"{sum(a == c for a, c in zip(ogot, ungated))}/{b} rows; spec == plain greedy rows "
        f"{sum(a == c for a, c in zip(ogot, plain))}/{b}; decisive steps held {oheld}/{odecisive}, {odecisive}/"
        f"{ocompared} of the steps compared decisive; flash_prefill launches in {1 + SPEC_K}-token windows "
        f"{oracle_tap.window_launches}")
    if not hold_passes(oheld, odecisive) or ost.accepted == 0 or ogot != ungated:
        raise AssertionError("spec fused, oracle drafts: no draft accepted, the stream parts from the ungated run's "
                             "(the multi-token advance), or decisive steps part from plain greedy")
    # the host loop (B = 1) on rows 0 and 1: n-gram drafts, then oracle drafts from that run's own stream, each held
    # to plain greedy at B = 1 (a prompt's bits depend on B: the W6A16 prefill's GEMMs split K by the tile count)
    hheld = hdecisive = hcompared = 0
    for r in range(2):
        with LogitTap(eng, 1 + SPEC_K) as plain1_tap:  # the step loop: its steps can be tapped
            plain1 = eng.generate(ps[r : r + 1], max_new_tokens=n_spec, eos_id=-1, mode="step")
        host_streams = {}
        for what in ("n-gram drafts", "oracle drafts"):
            oracle = (OracleDrafts(ps[r : r + 1], host_streams["n-gram drafts"], SPEC_K, dev) if what == "oracle drafts"
                      else contextlib.nullcontext())
            with oracle, LogitTap(eng, 1 + SPEC_K) as host_tap:
                (host, hst), counts = run_counted(f"spec host B=1 {what} row {r}", "spec",
                                                  lambda: speculative.generate_speculative(
                                                      eng, ps[r : r + 1], max_new_tokens=n_spec, k=SPEC_K, eos_id=-1,
                                                      return_stats=True, fused=False))
            add(counts)
            host_streams[what] = host
            h1, d1, c1 = decisive_hold(f"modes spec host B=1 {what} row {r}", plain1, host, plain1_tap.at,
                                       host_tap.spec_at(len(ps[0])), [(0, 0)])
            hheld, hdecisive, hcompared = hheld + h1, hdecisive + d1, hcompared + c1
            log(f"modes spec host loop B=1 {what} row {r}: acceptance_rate={hst.acceptance_rate:.3f} "
                f"tokens_per_verify_step={hst.tokens_per_step:.2f} decode_ms_per_token="
                f"{hst.decode_s / (n_spec - 1) * 1e3:.2f}; equal to plain greedy at B=1: {host == plain1}; decisive "
                f"steps held {h1}/{d1} ({c1} compared)")
        if host_streams["oracle drafts"] != host_streams["n-gram drafts"] or hst.accepted == 0:
            raise AssertionError(f"spec host loop, oracle drafts, row {r}: no draft accepted, or the stream parts from "
                                 "the n-gram run's")
    log(f"modes spec host loop: decisive steps held {hheld}/{hdecisive} over 4 runs ({hcompared} compared)")
    if not hold_passes(hheld, hdecisive):
        raise AssertionError("spec host loop: decisive steps part from plain greedy, or none is decisive")
    part("speculative runs")
    sps = SamplingParams(temperature=0.8, top_p=0.9, greedy=False)
    s1 = eng.generate(ps, max_new_tokens=n_spec, eos_id=-1, mode="spec", sampling=sps, seed=3)
    s2 = eng.generate(ps, max_new_tokens=n_spec, eos_id=-1, mode="spec", sampling=sps, seed=3)
    log(f"modes spec sampled (temperature 0.8, top_p 0.9): repeat equal {s1 == s2}; lengths {[len(r) for r in s1]}")
    if s1 != s2 or any(len(r) != n_spec or not all(0 <= t < cfg.vocab_size for t in r) for r in s1):
        raise AssertionError("sampled spec: a repeat of the seed disagrees, or a row is malformed")

    # Engine beam search: B = 1, K = 4
    p1 = [p32[0]]
    bp = beam.BeamParams(beam_width=4, max_new_tokens=new)
    (nbest, counts) = run_counted("beam engine K=4", "32-token", lambda: beam.beam_search_nbest(
        eng, p1, bp, eos_id=-1, n_best=4))
    add(counts)
    g1, glp = eng.generate(p1, max_new_tokens=new, eos_id=-1, return_logprobs=True)
    w1 = beam.beam_search(eng, p1, beam.BeamParams(beam_width=1, length_penalty=0.0, max_new_tokens=new), eos_id=-1)
    best_raw = nbest[0][0][1] * beam._length_norm(new, bp.length_penalty)
    log(f"modes beam engine B=1 K=4 new={new}: best score (raw) {best_raw:.4f} against the greedy stream's "
        f"{sum(glp[0]):.4f}; width 1 equals greedy: {w1 == g1}; hypotheses {len(nbest[0])}")
    if w1 != g1 or best_raw < sum(glp[0]) - 1e-3:
        raise AssertionError("Engine beam: width 1 parts from greedy, or the best beam scores below greedy")
    part("Engine beam runs")

    # the scheduler's beam groups beside 4 regular requests
    regular = [(p, n) for p, n in zip(p32, (16, 24, 32, 20))]
    sched_kw = dict(num_slots=8, max_seq_len=2048, page_size=128)
    for label, kw, path in (("dense bf16", dict(), "beam scheduler dense"),
                            ("paged bf16", dict(paged=True), "beam scheduler paged"),
                            ("paged int8", dict(paged=True, kv_dtype=torch.int8), "beam scheduler paged")):
        if kw.get("paged"):
            want = beam.beam_search_nbest_paged(params, cfg, policy, p1, bp, eos_id=-1, n_best=4, max_seq_len=2048,
                                                kv_dtype=kw.get("kv_dtype", torch.bfloat16), device=dev)[0]
        else:
            want = nbest[0]

        def run():
            s = BatchScheduler(params, cfg, policy, **sched_kw, device=dev, **kw)
            rb = s.add_request(p1[0], max_new_tokens=new, eos_id=-1, beam_width=4, n_best=4)
            ids = [s.add_request(p, max_new_tokens=n, eos_id=-1) for p, n in regular]
            out = s.run()
            return s, s.done_nbest[rb], [out[i] for i in ids]

        (s, got_nb, reg), counts = run_counted(f"beam scheduler {label}", path, run)
        add(counts)
        free = s.pool.free_pages == s.pool.num_pages - 1 if s.paged else True
        same = [t for t, _, _ in got_nb] == [t for t, _ in want]
        worst = max(abs(x[1] - y[1]) for x, y in zip(got_nb, want))
        log(f"modes beam scheduler {label} (K=4 beside 4 regular requests): n-best equal to the standalone "
            f"{'beam_search_nbest_paged' if s.paged else 'beam_search_nbest'}: {same} (scores within {worst:.2e}); "
            f"regular requests' lengths {[len(r) for r in reg]}; pages all free after: {free}")
        if not same or worst > 1e-3 or not free or [len(r) for r in reg] != [n for _, n in regular]:
            raise AssertionError(f"beam scheduler {label}: parts from the standalone n-best, or pages leak")
        del s
        part(f"beam scheduler {label}")
    modes_s = time.perf_counter() - t_phase
    log(f"phase 6 decoding modes: {modes_s:.1f}s")
    return totals, modes_s


def greedy_graph(eng, b: int):
    """The Engine's step graph of its greedy fused loop at batch ``b`` (eos -1)."""
    return eng._fused[(b, SamplingParams(), -1, (), False)][1]


def engine_graph_vs_eager(label, path, eng, prompts, new, dev):
    """Phase 7, Engine: mode="fused" (the captured decode step, replayed)
    against mode="step" (eager) on the same prompts, after a warm-up of
    each (the engine's first fused call captures the graph: its capture ms
    is logged apart), then in turns fused, step, step, fused; the tokens of
    every run must be equal. The four runs' launch counts are zeroed before
    and read after; every kernel of ``path`` must launch. Returns them."""
    _, wst = eng.generate(prompts, max_new_tokens=new, eos_id=-1, return_stats=True)
    eng.generate(prompts, max_new_tokens=new, eos_id=-1, mode="step")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    reset_launch_counts()
    runs = {"fused": [], "step": []}
    for mode in ("fused", "step", "step", "fused"):
        out, st = eng.generate(prompts, max_new_tokens=new, eos_id=-1, return_stats=True, mode=mode)
        decode_s = st.decode_s if mode == "fused" else sum(st.step_times_s)
        runs[mode].append((out, decode_s / (new - 1) * 1e3, st.ttft_s * 1e3, st.capture_s))
    counts = launch_counts()
    add_by_m()
    b, l = prompts.shape
    graph = greedy_graph(eng, b)
    outs = [r[0] for rs in runs.values() for r in rs]
    equal = all(o == outs[0] for o in outs) and all(len(r) == new for r in outs[0])
    f_ms, s_ms = ([round(r[1], 3) for r in runs[m]] for m in ("fused", "step"))
    f_tt, s_tt = ([round(r[2], 2) for r in runs[m]] for m in ("fused", "step"))
    log(f"graph {label} B={b} prompt={l} new={new}: decode_ms_per_step fused (graph) {f_ms} vs step (eager) {s_ms}: "
        f"{statistics.mean(s_ms) / statistics.mean(f_ms):.2f}x; ttft_ms fused {f_tt} vs step {s_tt}; capture_ms="
        f"{wst.capture_s * 1e3:.1f} (this engine's first fused call; 0 in the measured runs: "
        f"{all(r[3] == 0 for r in runs['fused'])}); replays={graph.replays} launches_per_replay="
        f"{graph.launches_per_replay}; tokens equal over the 4 runs: {equal}")
    log(f"graph {label} launches: " + " ".join(f"{k}={v}" for k, v in counts.items() if v))
    if not equal:
        raise AssertionError(f"{label}: the graph's tokens part from the eager step loop's")
    missing = [k for k in PATH_KERNELS[path] if counts[k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels of the path never launched: {missing}")
    return counts


def sched_graph_vs_eager(label, path, params, cfg, policy, dev, reqs, **kw):
    """Phase 7, scheduler: phase 4's 16-request mix at fused_tick=8 against
    phase 4's fused_tick=0 run of ``label`` in this call: the streams must
    be equal; tokens/s (also without the graphs' captures, made in the
    run's first fused tick), ms per decode tick and per decode step, TTFT
    p50 / max side by side. Returns the fused run's counts."""
    _, counts, sched = sched_run(f"{label} fused_tick=8", path, params, cfg, policy, dev, reqs, fused_tick=8, **kw)
    e, f = SCHED_RUNS[label], SCHED_RUNS[f"{label} fused_tick=8"]
    same = sum(a == b for a, b in zip(f["tokens"], e["tokens"]))
    capture_s = sum(g.capture_s for g in sched.fused_graphs.values())
    gen_tokens = sum(len(t) for t in f["tokens"])
    no_capture = gen_tokens / (gen_tokens / f["tokens_per_s"] - capture_s)
    log(f"graph sched {label}: fused_tick=8 (graph) vs 0 (eager, phase 4): tokens_per_s {f['tokens_per_s']:.1f} "
        f"({no_capture:.1f} without the {capture_s * 1e3:.1f} ms of capture) vs {e['tokens_per_s']:.1f}; "
        f"ms_per_decode_tick {f['ms_tick']:.2f} ({f['ticks']} ticks) vs {e['ms_tick']:.2f} ({e['ticks']}); "
        f"ms_per_decode_step {f['ms_step']:.3f} vs {e['ms_step']:.3f} ({e['ms_step'] / f['ms_step']:.2f}x); "
        f"ttft_ms p50 {f['ttft_p50']:.1f} vs {e['ttft_p50']:.1f}, max {f['ttft_max']:.1f} vs {e['ttft_max']:.1f}; "
        f"streams equal {same}/16; replays per fused tick "
        f"{sum(g.replays for g in sched.fused_graphs.values()) / max(sum(sched.tick_fused), 1):.2f}")
    if same != len(reqs):
        raise AssertionError(f"{label}: fused_tick=8's streams part from fused_tick=0's")
    return counts


def graph_vs_eager(params, cfg, policy, dev):
    """Phase 7 on phase 4's LLaMA-2-7B model: the Engine's fused loop on the
    captured step against its eager step loop (B = 4, 32 new, 32- and
    512-token prompts; both profiled over 8 tokens at 32), and the
    scheduler's 16-request mix at fused_tick=8 against phase 4's
    fused_tick=0 runs (paged bf16, dense bf16, paged int8), with a profile
    of one fused paged run. Returns the summed counts and the seconds."""
    t0 = time.perf_counter()
    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    rng = np.random.default_rng(SEED + 20)
    b, new = 4, 32
    eng = Engine(params, cfg, policy, max_seq_len=2048, device=dev)
    short = rng.integers(0, cfg.vocab_size, (b, 32))
    add(engine_graph_vs_eager("llama_flex 32-token", "32-token", eng, short, new, dev))
    if dev.type == "cuda":
        profile_decode(eng, short)
        profile_call(f"generate B={b} prompt=32 new=8 mode=step (eager)",
                     lambda: eng.generate(short, max_new_tokens=8, eos_id=-1, mode="step"))
        # the decode steps alone: the host's replays against the card's work (the last generate left
        # the loop's columns and positions room for 2 x 16 more steps)
        graph = greedy_graph(eng, b)
        profile_call("the captured decode step alone, 16 replays (B=4, 40-71 keys over the two runs)",
                     lambda: graph.run(16))
        del graph  # it holds the engine's kept cache: freed with the engine below
    add(engine_graph_vs_eager("llama_flex 512-token", "512-token", eng, rng.integers(0, cfg.vocab_size, (b, 512)),
                              new, dev))
    del eng
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    reqs = sched_requests(cfg.vocab_size)
    for label, path, kw in (("paged bf16", "scheduler paged", dict(paged=True)),
                            ("dense bf16", "scheduler dense", {}),
                            ("paged int8", "scheduler paged", dict(paged=True, kv_dtype=torch.int8))):
        add(sched_graph_vs_eager(label, path, params, cfg, policy, dev, reqs, **kw))
    fz = BatchScheduler(params, cfg, policy, **SCHED, paged=True, fused_tick=8, device=dev)
    short_reqs = [(p[:32], 16) for p, _ in reqs[:8]]

    def fused_run():
        for p, n in short_reqs:
            fz.add_request(p, max_new_tokens=n, eos_id=-1)
        fz.run()

    fused_run()  # captures the scheduler's graph; the profile sees replays
    if dev.type == "cuda":
        profile_call("scheduler paged bf16 fused_tick=8, 8 requests x 32-token prompts, 16 new", fused_run)
        del fz
        torch.cuda.empty_cache()
    graph_s = time.perf_counter() - t0
    log(f"phase 7 graph vs eager, LLaMA-2-7B: {graph_s:.1f}s")
    return totals, graph_s


def end_to_end(dev, gen):
    cfg = ModelConfig.llama()  # LLaMA-2-7B shape, 32 layers
    policy = QuantPolicy.llama_flex()
    t0 = time.perf_counter()
    params = random_params(cfg, policy, gen, dev)
    torch.cuda.synchronize()
    log(f"e2e: random 7B weights generated and quantized in {time.perf_counter() - t0:.1f}s")
    b, new = 4, 32
    rng = np.random.default_rng(SEED)
    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    # the 32-token path: prefill and decode through the W6Ax layer
    eng = Engine(params, cfg, policy, max_seq_len=2048)
    prompts = rng.integers(0, cfg.vocab_size, (b, 32))
    p32 = prompts.tolist()
    out, counts, _ = generate_run("bf16 cache", "32-token", eng, prompts, new, dev)
    add(counts)
    # phase 11's pipeline is held to these: the prompts' last logits, the
    # tokens over a bf16 and an int8 cache (and phase 6's sampled tokens)
    logits32 = eng.prefill_prompts(p32, eng.new_cache(b))[0]
    out8 = Engine(params, cfg, policy, max_seq_len=2048, kv_dtype=torch.int8).generate(
        prompts, max_new_tokens=new, eos_id=-1, mode="step")
    PHASE4.update(p32=prompts, out32=out, logits32=logits32.cpu(), out32_int8=out8)
    step_out, _, _ = generate_run("bf16 cache", "32-token", eng, prompts, new, dev, mode="step", counted=False)
    if out != step_out:
        raise AssertionError("fused and step decode loops disagree")
    log(f"e2e 32-token first row tokens: {out[0][:8]}; fused and step loops equal: True")
    profile_decode(eng, prompts)
    # (e) the same tree with its lm_head packed W6 and served W6A8 (K4 + K2)
    flex_head = policy.with_head(6, 8)
    engh = Engine(dict(params, lm_head=quantize_head(params["lm_head"], flex_head)), cfg, flex_head,
                  max_seq_len=2048)
    _, counts, _ = generate_run("bf16 cache, W6A8 lm_head", "W6Ax+head 32-token", engh, prompts, new, dev)
    add(counts)
    del engh

    # 512-token prompts: the W6A16 prefill, then W6Ax decode
    prompts = rng.integers(0, cfg.vocab_size, (b, 512))
    whole, counts, _ = generate_run("bf16 cache", "512-token", eng, prompts, new, dev)
    add(counts)
    profile_decode(eng, prompts, new=2)
    eng8 = Engine(params, cfg, policy, max_seq_len=2048, kv_dtype=torch.int8)
    out8, counts, _ = generate_run("int8 cache", "512-token", eng8, prompts, new, dev)
    add(counts)
    log(f"e2e 512-token int8 vs bf16 cache: first row {out8[0][:8]} vs {whole[0][:8]}")
    del eng8
    engc = Engine(params, cfg, policy, max_seq_len=2048, prefill_chunk=256)
    chunked, counts, _ = generate_run("bf16 cache, prefill_chunk=256", "512-token", engc, prompts, new, dev)
    add(counts)
    if chunked != whole:
        raise AssertionError("prefill_chunk=256 tokens differ from the whole-prompt prefill's")
    log("e2e 512-token prefill_chunk=256 tokens equal to the whole-prompt run: True")
    del engc, eng
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    add(scheduler_runs(params, cfg, policy, dev))
    log(f"e2e scheduler runs: {time.perf_counter() - t0:.1f}s")
    counts, modes_s = decoding_modes(params, cfg, policy, dev, p32, out)  # phase 6, before the model is freed
    add(counts)
    counts, graph_s = graph_vs_eager(params, cfg, policy, dev)  # phase 7's LLaMA part
    add(counts)
    torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    fused = random_params(cfg, policy, gen, dev, fuse=True)
    engf = Engine(fused, cfg, policy, max_seq_len=2048)
    _, counts, _ = generate_run("bf16 cache, fuse=True tree", "512-token fuse=True", engf, prompts, new, dev)
    add(counts)
    del engf, fused
    torch.cuda.empty_cache()

    # the other formats. (a) W4A8 with a W4A8 head, 32-token prompts: K10 at
    # every linear and at the head; (b) the same engine, 512-token prompts:
    # K11 with RoPE at prefill, then K10; (c) the same W4 tree served
    # weight-only (W4A16): K11 at every step and at the head
    w4a8 = QuantPolicy.uniform(wbits=4, abits=8).with_head(4, 8)
    w4 = random_params(cfg, w4a8, gen, dev)
    eng4 = Engine(w4, cfg, w4a8, max_seq_len=2048)
    short = rng.integers(0, cfg.vocab_size, (b, 32))
    _, counts, _ = generate_run("W4A8 + W4A8 head", "W4A8 32-token", eng4, short, new, dev)
    add(counts)
    profile_decode(eng4, short)
    _, counts, _ = generate_run("W4A8 + W4A8 head", "W4A8 512-token", eng4, prompts, new, dev)
    add(counts)
    w4a16 = QuantPolicy.weight_only(wbits=4).with_head(4, 16)
    eng4w = Engine(w4, cfg, w4a16, max_seq_len=2048)
    _, counts, _ = generate_run("weight-only W4A16 + W4A16 head", "W4A16 512-token", eng4w, prompts, new, dev)
    add(counts)
    profile_decode(eng4w, prompts)
    del eng4, eng4w, w4
    torch.cuda.empty_cache()
    # (d) W8A8 (the SmoothQuant baseline), 32-token prompts: K12
    w8a8 = QuantPolicy.uniform(wbits=8, abits=8)
    w8 = random_params(cfg, w8a8, gen, dev)
    _, counts, _ = generate_run("W8A8", "W8A8 32-token", Engine(w8, cfg, w8a8, max_seq_len=2048), short, new, dev)
    add(counts)
    del w8
    torch.cuda.empty_cache()
    return totals, modes_s, graph_s


def opt_end_to_end(dev, gen):
    """OPT-6.7B (32 layers, full width, random weights from ``gen``), greedy
    Engine.generate, max_seq_len 2048, B = 4, 32 new tokens: opt_flex with
    32-token prompts over a bf16 cache; 512-token prompts over an int8 cache
    (the exact W6Ax GEMMs at M = 2048, with a profile of the prefill);
    the paged BatchScheduler under opt_flex over sched_requests' 16-request
    mix; and a weight-only W4A16 tree, 32-token prompts. Returns the summed
    launch counts."""
    cfg = ModelConfig.opt(**OPT_67B)
    flex = QuantPolicy.opt_flex()
    t0 = time.perf_counter()
    params = random_opt_params(cfg, flex, gen, dev)
    torch.cuda.synchronize()
    log(f"e2e OPT: random OPT-6.7B weights generated and quantized in {time.perf_counter() - t0:.1f}s")
    b, new = 4, 32
    rng = np.random.default_rng(SEED + 5)
    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    short = rng.integers(0, cfg.vocab_size, (b, 32))
    eng = Engine(params, cfg, flex, max_seq_len=2048, device=dev)
    _, counts, _ = generate_run("OPT-6.7B opt_flex, bf16 cache", "OPT 32-token", eng, short, new, dev)
    add(counts)
    profile_decode(eng, short)
    del eng
    long = rng.integers(0, cfg.vocab_size, (b, 512))
    eng8 = Engine(params, cfg, flex, max_seq_len=2048, kv_dtype=torch.int8, device=dev)
    _, counts, _ = generate_run("OPT-6.7B opt_flex, int8 cache", "OPT 512-token", eng8, long, new, dev)
    add(counts)
    profile_decode(eng8, long, new=2)
    del eng8
    torch.cuda.empty_cache()
    reqs = sched_requests(cfg.vocab_size)
    warm_scheduler(params, cfg, flex, dev, reqs)
    _, counts, sched = sched_run("OPT-6.7B opt_flex paged bf16", "OPT scheduler paged", params, cfg, flex, dev, reqs,
                                 paged=True)
    add(counts)
    del sched
    # phase 7's OPT part: the captured step against the eager one, Engine and scheduler
    t7 = time.perf_counter()
    eng = Engine(params, cfg, flex, max_seq_len=2048, device=dev)
    add(engine_graph_vs_eager("OPT-6.7B opt_flex 32-token", "OPT 32-token", eng, short, new, dev))
    del eng
    torch.cuda.empty_cache()
    add(sched_graph_vs_eager("OPT-6.7B opt_flex paged bf16", "OPT scheduler paged", params, cfg, flex, dev, reqs,
                             paged=True))
    graph_s = time.perf_counter() - t7
    log(f"phase 7 graph vs eager, OPT-6.7B: {graph_s:.1f}s")
    del params
    torch.cuda.empty_cache()
    wo4 = QuantPolicy.weight_only("opt", 4)
    w4 = random_opt_params(cfg, wo4, gen, dev)
    eng4 = Engine(w4, cfg, wo4, max_seq_len=2048, device=dev)
    _, counts, _ = generate_run("OPT-6.7B weight-only W4A16", "OPT W4A16 32-token", eng4, short, new, dev)
    add(counts)
    del eng4, w4
    torch.cuda.empty_cache()
    return totals, graph_s


CKPT_LAYERS = 4  # phase 5's depth: LLaMA-2-7B's widths, its 32 layers cut to keep the phase near a minute
HTTP_REQS = 12


def write_hf_checkpoint(d: str, cfg: ModelConfig, gen, dev):
    """An HF-layout LLaMA directory from ``gen``: config.json and a bf16
    model.safetensors ([out, in] weights N(0, 0.02), residual outputs scaled
    by 1/sqrt(2L), norms 1 + N(0, 0.02)) written through the port's
    safetensors writer. Returns the same weights as the dense serve tree
    ([in, out], bf16, on the card)."""
    hf_cfg = {"model_type": "llama", "architectures": ["LlamaForCausalLM"], "vocab_size": cfg.vocab_size,
              "hidden_size": cfg.hidden_size, "intermediate_size": cfg.intermediate_size,
              "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
              "num_key_value_heads": cfg.num_kv_heads, "max_position_embeddings": cfg.max_seq_len,
              "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.norm_eps, "tie_word_embeddings": False,
              "torch_dtype": "bfloat16"}
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(hf_cfg, f)
    std = 0.02
    res_std = std / math.sqrt(2 * cfg.num_layers)
    h, f_, nq, nkv = cfg.hidden_size, cfg.intermediate_size, cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim

    def randn(*shape, s=std):
        return (torch.randn(shape, generator=gen, device=dev) * s).to(torch.bfloat16)

    shapes = {"q_proj": (nq, h, std), "k_proj": (nkv, h, std), "v_proj": (nkv, h, std), "o_proj": (h, nq, res_std),
              "gate_proj": (f_, h, std), "up_proj": (f_, h, std), "down_proj": (h, f_, res_std)}  # HF [out, in]
    tensors, layers = {}, []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        lp = {}
        for name, hf in hf_loader.HF_LLAMA_LINEARS.items():
            n, k, s = shapes[name]
            w = randn(n, k, s=s)
            tensors[p + hf + ".weight"] = w
            lp[name] = {"w": w.T}
        for name, hf in hf_loader.HF_LLAMA_NORMS.items():
            g = (1.0 + randn(h).float()).to(torch.bfloat16)
            tensors[p + hf + ".weight"] = g
            lp[name] = g
        layers.append(lp)
    embed, head = randn(cfg.vocab_size, h), randn(cfg.vocab_size, h)
    norm = (1.0 + randn(h).float()).to(torch.bfloat16)
    tensors.update({"model.embed_tokens.weight": embed, "model.norm.weight": norm, "lm_head.weight": head})
    safetensors_io.save_file(tensors, os.path.join(d, "model.safetensors"), metadata={"format": "pt"})
    return {"embed": embed, "final_norm": norm, "layers": layers, "lm_head": head.T}


def trees_equal(label, got, want) -> None:
    """Every leaf of ``got`` torch.equal to ``want``'s, but the pad columns
    of a scale: the exporter quantizes N padded with zero columns (scale
    CLIPMIN there), quantize_params pads the scales with 0 (the reference's
    two paths differ the same way; pad columns multiply zero codes and are
    sliced off)."""
    def leaves(t, path=""):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from leaves(t[k], f"{path}/{k}")
        elif isinstance(t, list):
            for i, v in enumerate(t):
                yield from leaves(v, f"{path}/{i}")
        else:
            yield path, t

    a, b = list(leaves(got)), list(leaves(want))
    if [k for k, _ in a] != [k for k, _ in b]:
        raise AssertionError(f"{label}: trees have other leaves")
    padded = 0
    for (k, x), (_, y) in zip(a, b):
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError(f"{label}: {k} {x.dtype}{tuple(x.shape)} vs {y.dtype}{tuple(y.shape)}")
        if torch.equal(x, y):
            continue
        n = int((x != y).any(0).int().argmax()) if k.endswith("/scale") else -1
        if n < 0 or not (torch.equal(x[:, :n], y[:, :n]) and bool((x[:, n:] == CLIPMIN).all())
                         and bool((y[:, n:] == 0).all())):
            raise AssertionError(f"{label}: leaf {k} differs")
        padded += 1
    log(f"ckpt {label}: {len(a)} leaves torch.equal ({padded} scales differ only in their pad columns: "
        f"CLIPMIN exported, 0 from quantize_params)")


def http_requests(vocab: int):
    """HTTP_REQS seeded (id prompt, max_new): prompts of 16-300 tokens (the
    W6Ax and W6A16 prefills, whole and chunked), max_new 16-48."""
    rng = np.random.default_rng(SEED + 7)
    lengths = [16, 40, 63, 64, 300] + rng.integers(16, 301, HTTP_REQS - 5).tolist()
    return [(rng.integers(0, vocab, n).tolist(), int(rng.integers(16, 49))) for n in lengths]


def http_post(port, path, body, timeout=600):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def http_get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return json.loads(r.read())


def http_stream(port, body):
    """A streamed /v1/completions: (token ids of every chunk, finish reason)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", "/v1/completions", json.dumps({**body, "stream": True}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        ids, finish = [], None
        for raw in resp.fp:
            line = raw.decode().strip()
            if line == "data: [DONE]":
                break
            if line.startswith("data: "):
                ch = json.loads(line[6:])["choices"][0]
                ids += ch.get("token_ids", [])
                finish = ch["finish_reason"] or finish
        return ids, finish
    finally:
        conn.close()


def serve_and_compare(params, cfg, policy, dev, reqs):
    """serve_background over a paged bf16 BatchScheduler (8 slots,
    prefill_chunk 256): every request through /v1/completions at once (id
    prompts, greedy), its launch counts zeroed just before and read just
    after; then the same requests directly through a BatchScheduler. Streams
    equal token for token, a streamed twin, a chat answer, a beam request
    (best_of 4, n 2) whose choices equal the direct scheduler's n-best,
    /metrics with every page free and no failed tick. Returns the HTTP run's
    counts."""
    warm_scheduler(params, cfg, policy, dev, reqs)
    sched = BatchScheduler(params, cfg, policy, **SCHED, paged=True, device=dev)
    server, service, port = serve_http.serve_background(sched, model_name="flexq-llama-7b-width")
    try:
        got, lat = [None] * len(reqs), [0.0] * len(reqs)

        def call(r):
            p, n = reqs[r]
            t = time.perf_counter()
            body = http_post(port, "/v1/completions", {"prompt": p, "max_tokens": n, "temperature": 0, "eos_id": -1})
            lat[r] = time.perf_counter() - t
            got[r] = body["choices"][0]["token_ids"]

        if dev.type == "cuda":
            torch.cuda.synchronize()
        reset_launch_counts()
        threads = [threading.Thread(target=call, args=(r,)) for r in range(len(reqs))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
        counts = launch_counts()
        if any(t.is_alive() for t in threads) or None in got:
            raise AssertionError("http: a request did not come back")
        n_tok = sum(len(t) for t in got)
        lat_ms = sorted(x * 1e3 for x in lat)
        log(f"http /v1/completions, {len(reqs)} concurrent requests (prompts {[len(p) for p, _ in reqs]}), {n_tok} "
            f"tokens in {wall:.2f}s: tokens_per_s={n_tok / wall:.1f} latency_ms_p50={statistics.median(lat_ms):.1f} "
            f"latency_ms_max={lat_ms[-1]:.1f}")
        log("http launches: " + " ".join(f"{k}={v}" for k, v in counts.items()))
        missing = [k for k in PATH_KERNELS["scheduler paged"] if counts[k] == 0]
        if missing:
            raise AssertionError(f"http: kernels of the path never launched: {missing}")

        # a streamed request gives its non-streamed twin's tokens
        p, n = reqs[3]
        ids, finish = http_stream(port, {"prompt": p, "max_tokens": n, "temperature": 0, "eos_id": -1})
        if ids != got[3] or finish != "length":
            raise AssertionError(f"http: the streamed request's tokens part from its twin's ({finish})")
        # chat over the byte tokenizer; a beam request (best_of = 4, n = 2)
        chat = http_post(port, "/v1/chat/completions", {"messages": [{"role": "user", "content": "Hello, H100!"}],
                                                        "max_tokens": 8, "temperature": 0, "eos_id": -1})
        if chat["usage"]["completion_tokens"] != 8 or not isinstance(chat["choices"][0]["message"]["content"], str):
            raise AssertionError(f"http: bad chat answer {chat}")
        beam_prompt = p[:32]
        beam_ans = http_post(port, "/v1/completions", {"prompt": beam_prompt, "max_tokens": 16, "best_of": 4, "n": 2,
                                                       "eos_id": -1})
        met = http_get(port, "/metrics")
        log(f"http stream equal to its twin: True; chat answered {chat['usage']}; beam request: "
            f"{len(beam_ans['choices'])} choices; metrics "
            f"requests_completed={met['requests_completed']} pages_free={met['pages_free']}/{met['pages_total']} "
            f"worker_failed_ticks={met['worker_failed_ticks']}")
        if met["pages_free"] != met["pages_total"] - 1 or met["worker_failed_ticks"] or service.failed_ticks:
            raise AssertionError("http: pages not all free, or a worker tick failed")
    finally:
        service.shutdown()
        server.shutdown()
        server.server_close()
    del sched

    # the same requests, directly through a BatchScheduler
    direct = BatchScheduler(params, cfg, policy, **SCHED, paged=True, device=dev)
    t0 = time.perf_counter()
    ids = [direct.add_request(p, max_new_tokens=n, eos_id=-1) for p, n in reqs]
    out = direct.run()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    want = [out[i] for i in ids]
    log(f"http direct BatchScheduler run of the same requests: tokens_per_s={sum(map(len, want)) / wall:.1f}")
    parted = [(r, next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)) for r, (a, b) in enumerate(zip(got, want))
              if a != b]
    log(f"http streams equal to the direct run: {len(reqs) - len(parted)}/{len(reqs)}; parted (request, token): "
        f"{parted}")
    if parted:
        raise AssertionError("http: a stream parts from the direct BatchScheduler run")
    # the beam request's choices against a direct scheduler n-best of it
    rb = direct.add_request(beam_prompt, max_new_tokens=16, eos_id=-1, beam_width=4, n_best=2)
    direct.run()
    want = direct.done_nbest[rb]
    same = [c["token_ids"] for c in beam_ans["choices"]] == [t for t, _, _ in want]
    close = all(abs(c["beam_score"] - s) <= 1e-6 for c, (_, s, _) in zip(beam_ans["choices"], want))
    log(f"http beam request (best_of 4, n 2, 32-token prompt, 16 new): choices equal to a direct scheduler n-best: "
        f"{same}; scores {[round(c['beam_score'], 5) for c in beam_ans['choices']]}")
    if not same or not close or direct.pool.free_pages != direct.pool.num_pages - 1:
        raise AssertionError("http: the beam choices part from a direct scheduler n-best")
    return counts


class Proc:
    """A subprocess whose output lines a thread collects (so a wait has a
    deadline); killed on exit."""

    def __init__(self, args):
        self.p = subprocess.Popen([sys.executable, *args], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                  cwd=os.path.dirname(os.path.abspath(__file__)))
        self.lines = queue.Queue()
        self.seen = []
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.p.stdout:
            self.lines.put(line.rstrip())
        self.lines.put(None)

    def wait_for(self, prefix: str, timeout: float) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                line = self.lines.get(timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                break
            if line is None:
                break
            self.seen.append(line)
            if line.startswith(prefix):
                return line
        raise AssertionError(f"no {prefix!r} line; the process said: {self.seen[-20:]}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.p.poll() is None:
            self.p.terminate()
            try:
                self.p.wait(30)
            except subprocess.TimeoutExpired:
                self.p.kill()
                self.p.wait()


def checkpoint_and_http(dev, gen, cfg=None, reqs=None, adapter_tol=2e-2, workdir=None):
    """Phase 5: an HF-layout LLaMA directory (LLaMA-2-7B widths, CKPT_LAYERS
    layers) exported under llama_flex by the exporter's CLI, loaded with
    load_packed on the card and held leaf for leaf against quantize_params
    of the same dense weights (and the 32-token logits of both trees equal);
    served through serve_background (serve_and_compare); the HTTP CLI started
    as a subprocess and asked for a completion and /health; and
    FlexQCausalLM.from_packed's forward on the card held against its plain
    CPU run. Returns the HTTP run's launch counts. With ``workdir`` the HF
    directory ("hf") and the export ("packed") are written there and kept
    (phase 8 runs the quantize-and-evaluate CLI on them), else in a
    temporary directory."""
    cfg = cfg or ModelConfig.llama(num_layers=CKPT_LAYERS)
    policy = QuantPolicy.llama_flex()
    log(f"ckpt: LLaMA-2-7B widths (hidden {cfg.hidden_size}, FFN {cfg.intermediate_size}, {cfg.num_heads} heads, "
        f"vocab {cfg.vocab_size}), depth cut to {cfg.num_layers} layers to keep the phase near a minute")
    with contextlib.ExitStack() as stack:
        tmp = workdir or stack.enter_context(tempfile.TemporaryDirectory(prefix="flexq_ckpt_"))
        hf_dir, packed = os.path.join(tmp, "hf"), os.path.join(tmp, "packed")
        os.makedirs(hf_dir)
        t0 = time.perf_counter()
        dense = write_hf_checkpoint(hf_dir, cfg, gen, dev)
        log(f"ckpt: HF directory written in {time.perf_counter() - t0:.1f}s "
            f"({os.path.getsize(os.path.join(hf_dir, 'model.safetensors')) / 2**30:.2f} GiB)")
        with open(os.path.join(hf_dir, "config.json")) as f:
            hf_cfg = json.load(f)
        if hf_loader.config_from_hf(hf_cfg) != cfg:
            raise AssertionError("ckpt: config_from_hf of the written config.json is not the model's config")
        t0 = time.perf_counter()
        exp = subprocess.run([sys.executable, "-m", "flexq_tpu_torch.export.exporter", "--model-dir", hf_dir,
                              "--out", packed, "--device", dev.type], capture_output=True, text=True,
                             cwd=os.path.dirname(os.path.abspath(__file__)), timeout=600)
        export_s = time.perf_counter() - t0
        if exp.returncode != 0:
            raise AssertionError(f"ckpt: the exporter CLI failed ({exp.returncode}):\n{exp.stdout}\n{exp.stderr}")
        t0 = time.perf_counter()
        lcfg, lpol, params = load_packed(packed, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        log(f"ckpt: export (CLI subprocess, {dev.type}) {export_s:.1f}s, load_packed {load_s:.1f}s "
            f"({sum(os.path.getsize(os.path.join(packed, f)) for f in os.listdir(packed)) / 2**30:.2f} GiB packed)")
        if lcfg != cfg or (lpol.weight_bits, lpol.act_bits) != (policy.weight_bits, policy.act_bits):
            raise AssertionError("ckpt: load_packed's config or policy is not the exported model's")
        # the exporter's quantizer on the card is bit-exact with the CPU's (the
        # CPU's with the reference's numpy and native paths: tests/test_torch_service.py)
        w = dense["layers"][0]["gate_proj"]["w"].float()
        spec = policy.weight_spec("gate_proj")
        on_card, on_cpu = quantize_linear(w, spec), quantize_linear(w.cpu(), spec)
        if not all(torch.equal(on_card[k].cpu(), on_cpu[k]) for k in on_cpu):
            raise AssertionError("ckpt: quantize_linear on the card parts from the CPU's")
        log(f"ckpt: quantize_linear of layer 0's gate_proj {tuple(w.shape)}, card vs CPU: planes and scale bits equal")
        want = quantize_params(dense, cfg, policy, device=dev)
        del dense, w, on_card, on_cpu
        trees_equal("load_packed vs quantize_params (same dense weights, on the card)", params, want)
        ids = torch.as_tensor(np.random.default_rng(SEED + 8).integers(0, cfg.vocab_size, (1, 32)), device=dev)
        a, _ = forward_serve(params, cfg, policy, ids, device=dev)
        b, _ = forward_serve(want, cfg, policy, ids, device=dev)
        if not torch.equal(a, b) or not torch.isfinite(a).all():
            raise AssertionError("ckpt: the 32-token logits of the loaded and the quantized trees differ")
        log("ckpt: 32-token prompt logits of the two trees torch.equal: True")
        del want, a, b

        counts = serve_and_compare(params, cfg, policy, dev, reqs or http_requests(cfg.vocab_size))
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # the server's CLI, as a user starts it
        t0 = time.perf_counter()
        with Proc(["-m", "flexq_tpu_torch.serve.http", "--checkpoint", packed, "--port", "0", "--paged",
                   "--host", "127.0.0.1", "--device", dev.type]) as proc:
            line = proc.wait_for("serving on", timeout=300)
            port = int(line.split()[2].rsplit(":", 1)[1])
            up_s = time.perf_counter() - t0
            one = http_post(port, "/v1/completions", {"prompt": list(range(5, 45)), "max_tokens": 8,
                                                      "temperature": 0, "eos_id": -1})
            health = http_get(port, "/health")
            if len(one["choices"][0]["token_ids"]) != 8 or not health["ok"]:
                raise AssertionError(f"cli server: bad answers {one} {health}")
        if proc.p.returncode is None:
            raise AssertionError("cli server: still running after terminate")
        log(f"cli server: `python -m flexq_tpu_torch.serve.http --checkpoint <dir> --port 0 --paged` up in "
            f"{up_s:.1f}s, one completion (8 tokens) and /health ok, stopped (rc {proc.p.returncode})")

        # the torch-facing adapter on the card vs its plain CPU run
        cpu = torch.device("cpu")
        card = FlexQCausalLM.from_packed(packed, device=dev)
        ids = torch.as_tensor(np.random.default_rng(SEED + 9).integers(0, cfg.vocab_size, (2, 32)))
        got = card(ids).cpu()
        del card
        ref = FlexQCausalLM.from_packed(packed, device=cpu)(ids)
        err = ((got - ref).abs().max() / ref.abs().max()).item()
        log(f"adapter FlexQCausalLM.from_packed(...).forward, B=2 x 32 tokens, card vs CPU plain: max |dlogit|/max|logit| "
            f"= {err:.3g} (tolerance {adapter_tol:g}); argmax agreement "
            f"{int((got.argmax(-1) == ref.argmax(-1)).sum())}/{ids.numel()}")
        if not torch.isfinite(got).all() or err > adapter_tol:
            raise AssertionError("adapter: the card's logits part from the CPU plain run")
    return counts


def profile_decode(eng, prompts, new: int = 8) -> None:
    """profile_call over one short generate (prefill + new - 1 decode steps)."""
    profile_call(f"generate B={prompts.shape[0]} prompt={prompts.shape[1]} new={new}",
                 lambda: eng.generate(prompts, max_new_tokens=new, eos_id=-1))


ATTENTION_KERNELS = ("attend_cache_kernel", "flash_prefill_kernel", "flash_decode_kernel")


def profile_call(label, fn) -> None:
    """Device time by kernel over one call of ``fn`` from torch.profiler
    (the top 10, and the attention kernels wherever they rank), and the
    device's busy share: that device time over the wall time of the same
    call run without the profiler (the profiler itself slows the host
    several-fold)."""
    log(f"profile: {label}")
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in rows)
    log(f"profile {label}: wall_ms={wall_ms:.1f} (no profiler) device_kernel_ms={busy:.2f} "
        f"device_busy_share={busy / wall_ms:.3f}")
    ranked = sorted(rows, key=lambda r: -r[1])
    for key, ms, n in ranked[:10]:
        log(f"profile   {ms:9.3f} ms  {n:6d} calls  {key[:90]}")
    for key, ms, n in ranked[10:]:  # the attention kernels (K6, K9, K13) also when they are not in the top 10
        if any(k in key for k in ATTENTION_KERNELS):
            log(f"profile   {ms:9.3f} ms  {n:6d} calls  {key[:90]}")


# ---- phase 8: the quantize-and-evaluate path --------------------------------

EVAL_WINDOWS, EVAL_SEQLEN = 4, 2048  # the first 4 windows of data_tiny/test.npy at the CLI's --seqlen default
OPT_EVAL_LAYERS = 8  # OPT-6.7B's widths, its 32 layers cut to 8 for the time limit
ORACLE_PROMPT, ORACLE_NEW, ORACLE_MAX = 128, 256, 512  # scripts/oracle_parity.py's lengths
SMOOTH_TOKENS = 512
EVAL_BOUND, EVAL_AGREE = 8e-2, 0.75  # packed vs fake-quant oracle: the reference's bounds (tests/test_opt_model.py)
EVAL_HOLD_LAYERS = 2  # ... at the depth its tests set them
# at full depth, the oracle with the packed path's activation codes handed on
# against the packed path: max |dlogit| / max |logit|, argmax agreement, and
# the share of entries where the oracle's own codes part from the handed ones
HANDON_TOL, HANDON_AGREE, HANDON_OFF = 1e-3, 0.99, 1e-3
# oracle parity (bf16), the Engine's codes handed on: rmse / std, greedy agreement
ORACLE_HANDON_RMSE, ORACLE_HANDON_AGREE = 1e-2, 0.95
SMOOTH_TOL = 1e-3  # the smoothing fold's identity on the dense f32 logits, of max |logit|
# the kernels phase 8 must launch (K1-K6, K9, K10, K12, K14, K15)
EVAL_KERNELS = ("rmsnorm_quant", "w6_matmul", "w6_matmul_stream", "quant_act", "glu_quant", "flash_decode",
                "flash_prefill", "w4_matmul", "w8_matmul", "layernorm_quant", "relu_quant")
EVAL_PATHS = {
    "eval W6": PRODUCERS + ("w6_matmul",),  # M = 2048: route A, the tensor cores
    "eval W4": PRODUCERS + ("w4_matmul",),
    "eval W8": PRODUCERS + ("w8_matmul",),
    "eval OPT": OPT_PRODUCERS + ("w6_matmul",),
    "oracle W6": W6AX,
    "oracle W4": PRODUCERS + ("w4_matmul", "flash_decode", "flash_prefill"),
}
# the policies phases 8 and 9 evaluate: (label, policy, its EVAL_PATHS key)
EVAL_POLICIES = (("llama_flex W6A6 (down A8)", QuantPolicy.llama_flex(), "eval W6"),
                 ("llama_flex(6, 8) W6A8", QuantPolicy.llama_flex(6, 8), "eval W6"),
                 ("llama_flex(4, 8) W4A8", QuantPolicy.llama_flex(4, 8), "eval W4"),
                 ("uniform W8A8", QuantPolicy.uniform("llama", 8, 8), "eval W8"))


def data_file(name: str) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "data_tiny", name)


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def require_launched(label, counts, path, dev) -> None:
    """The kernels of EVAL_PATHS[path] launched in ``counts`` (on the card:
    on the CPU every wrapper takes its plain version)."""
    missing = [k for k in EVAL_PATHS[path] if counts[k] == 0]
    if dev.type == "cuda" and missing:
        raise AssertionError(f"{label}: kernels of the path never launched: {missing}")


def kept_ppl(fn, windows, batch_size=1, keep=None):
    """The port's perplexity over ``windows`` through ``fn`` (ids -> logits),
    ``batch_size`` windows a forward, the logits of the first ``keep``
    forwards (None: every one) kept on the card: (ppl, [logits], seconds)."""
    kept = []

    def fwd(ids):
        logits = fn(ids)
        if keep is None or len(kept) < keep:
            kept.append(logits)
        return logits

    sync()
    t0 = time.perf_counter()
    ppl = perplexity(fwd, windows, batch_size=batch_size)
    sync()
    return ppl, kept, time.perf_counter() - t0


def logit_match(got, want):
    """``got`` against ``want`` ([..., V]): max |dlogit| / max |logit|, and
    over the rows the argmax agreements, the rows, the agreements over the
    decisive rows (want's top-2 margin above the max |dlogit|) and the
    decisive rows."""
    got, want = got.float().reshape(-1, got.shape[-1]), want.float().reshape(-1, want.shape[-1])
    d = (got - want).abs().max()
    top2 = want.topk(2, dim=-1).values
    decisive = (top2[:, 0] - top2[:, 1]) > d
    same = got.argmax(-1) == want.argmax(-1)
    return ((d / want.abs().max()).item(), int(same.sum()), same.numel(), int((same & decisive).sum()),
            int(decisive.sum()))


def logit_gaps(got, want):
    """Per window: max |dlogit| / max |logit|, argmax agreement over all rows
    and over the decisive rows (the oracle's top-2 margin above the
    window's max |dlogit|); and the decisive rows' share."""
    rows = []
    for g, w in zip(got, want):
        gap, agree, n, dec_agree, dec = logit_match(g, w)
        rows.append((gap, agree / n, dec_agree / max(dec, 1), dec / n))
    return rows


# a packed LLaMA layer's producer calls, in order (K1 before q/k/v, K4 before
# o_proj, K1 with the residual before gate/up, K5 before down_proj), and the
# oracle's quant points that quantize the same inputs
LAYER_PRODUCERS = ("rmsnorm_quant", "quant_act", "rmsnorm_quant", "glu_quant")
ORACLE_SLOT = {"q_proj": 0, "k_proj": 0, "v_proj": 0, "o_proj": 1, "gate_proj": 2, "up_proj": 2, "down_proj": 3}
SLOT_NAMES = ("q_proj", "o_proj", "gate_proj", "down_proj")  # the one quant point a slot is counted at


class PackedCodes(Patch):
    """Keeps, on the device, the activation codes and scales that a packed
    LLaMA run's producers give (as models.quantized calls them): per layer
    and producer call, the rows of the first ``forwards`` forwards (None:
    every forward, e.g. an Engine's prompt, then its steps), joined."""

    names = tuple(dict.fromkeys(LAYER_PRODUCERS))

    def __init__(self, num_layers: int, forwards=None):
        self.num_layers, self.forwards, self.calls = num_layers, forwards, 0
        self.rows = [[[] for _ in LAYER_PRODUCERS] for _ in range(num_layers)]

    def _wrap(self, name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            forward, i = divmod(self.calls, len(LAYER_PRODUCERS) * self.num_layers)
            layer, slot = divmod(i, len(LAYER_PRODUCERS))
            if name != LAYER_PRODUCERS[slot]:
                raise AssertionError(f"packed codes: call {self.calls} is {name}, not {LAYER_PRODUCERS[slot]}")
            self.calls += 1
            if self.forwards is None or forward < self.forwards:
                self.rows[layer][slot].append(out[:2])
            return out

        return call

    def codes(self, layer: int, slot: int):
        rows = self.rows[layer][slot]
        return torch.cat([q for q, _ in rows]), torch.cat([s for _, s in rows])


class OracleCodes:
    """Holds the fake-quant oracle's activation codes (models.llama's
    _maybe_quant_act over its first forward) against a PackedCodes of the
    packed path on the same ids: per layer, the entries whose codes part
    and the most they part by. With ``hand_on`` the oracle takes the packed
    path's codes and scales in place of its own, so the two can then part
    only where their arithmetic does, not by a flipped code."""

    def __init__(self, packed: PackedCodes, hand_on: bool):
        self.packed, self.hand_on = packed, hand_on
        self.seen = dict.fromkeys(ORACLE_SLOT, 0)
        self.off = [[0, 0, 0] for _ in range(packed.num_layers)]  # per layer: codes off, codes, most off

    def __enter__(self):
        self.saved = llama._maybe_quant_act
        llama._maybe_quant_act = self._quant
        return self

    def __exit__(self, *exc):
        llama._maybe_quant_act = self.saved

    def _quant(self, x, name, policy):
        spec = policy.act_spec(name) if policy is not None and name in ORACLE_SLOT else None
        if spec is None or not spec.enabled or self.seen[name] >= self.packed.num_layers:
            return self.saved(x, name, policy)
        layer, slot = self.seen[name], ORACLE_SLOT[name]
        self.seen[name] += 1
        q, s, _ = quantize(x, spec)
        pq, ps = self.packed.codes(layer, slot)
        g = -(-x.shape[-1] // spec.group_size)  # the oracle's groups (the packed FFN may be padded past them)
        pq, ps = pq[:, : g * spec.group_size].reshape(q.shape), ps[:, :g].reshape(s.shape)
        if name == SLOT_NAMES[slot]:
            d = (q.int() - pq.int()).abs()
            off = self.off[layer]
            off[0] += int((d > 0).sum())
            off[1] += d.numel()
            off[2] = max(off[2], int(d.max()))
        if self.hand_on:
            q, s = pq, ps
        return dequantize(q, s, None, spec, tuple(x.shape), x.dtype)

    def shares(self):
        return [off / max(total, 1) for off, total, _ in self.off]

    def totals(self):
        return sum(o[0] for o in self.off), sum(o[1] for o in self.off), max(o[2] for o in self.off)


def fmt_shares(shares) -> str:
    return "[" + ", ".join(f"{v:.2g}" for v in shares) + "]"


def code_witness(label, fq, cfg, policy, window, codes, as_is, packed_logits, oracle_logits) -> bool:
    """At full depth on the first forward's windows: the oracle again with
    the packed path's activation codes handed on at every quant point, held against
    the packed path (HANDON_TOL of max |logit|, HANDON_AGREE argmax
    agreement; its own codes off the handed ones by at most one code on at
    most HANDON_OFF of the entries): if they part only by flipped codes,
    the handed-on run closes the gap. Logged beside it: the share of codes
    the oracle computes off the packed path's, layer by layer, as it is
    (``as_is``: where the cascade starts and how it grows) and handed on;
    and the oracle against itself with its embedding rows one f32 ulp off
    (how far this model carries an ulp)."""
    with OracleCodes(codes, hand_on=True) as handed:
        got = dense_forward(fq, cfg, window, policy=policy)
    gap, agree = logit_gaps([got], [packed_logits])[0][:2]
    del got
    embed = fq["embed"]
    nudged = {**fq, "embed": torch.nextafter(embed, torch.full_like(embed, math.inf))}
    ulp_gap, ulp_agree = logit_gaps([dense_forward(nudged, cfg, window, policy=policy)], [oracle_logits])[0][:2]
    del nudged
    off, total, most = handed.totals()
    as_off, as_total, as_most = as_is.totals()
    ok = gap <= HANDON_TOL and agree >= HANDON_AGREE and most <= 1 and off <= HANDON_OFF * total
    log(f"eval code witness {label}, {cfg.num_layers} layers, first forward ({window.shape[0]} x {window.shape[1]} "
        f"tokens): the oracle with the packed path's activation codes handed on vs the packed path: max "
        f"|dlogit|/max|logit| {gap:.3g}, argmax agreement {agree:.4f} (bounds {HANDON_TOL:g}, {HANDON_AGREE:g}); the "
        f"oracle's own codes off the handed ones: {off}/{total} (most {most}; bounds {HANDON_OFF:g} of the entries, "
        f"one code): {'held' if ok else 'FAILED'}")
    log(f"eval code witness {label}: the oracle's codes off the packed path's, layer by layer, as it is "
        f"{fmt_shares(as_is.shares())} ({as_off}/{as_total}, most {as_most}); handed on {fmt_shares(handed.shares())}")
    log(f"eval code witness {label}: the oracle against itself with its embedding rows one f32 ulp off: "
        f"max |dlogit|/max|logit| {ulp_gap:.3g}, argmax agreement {ulp_agree:.4f}")
    return ok


def cut_layers(tree, n: int):
    """The tree with its first ``n`` layers (embedding, norms and head kept)."""
    return {**{k: v for k, v in tree.items() if k != "layers"}, "layers": tree["layers"][:n]}


def fake_and_packed(label, dense, cfg, policy, windows, dev, add, path, witness=False, batch_size=1, keep=None):
    """One policy over the windows (``batch_size`` a forward, the logits of
    the first ``keep`` forwards kept), the packed path first (its first
    forward's activation codes kept), then the fake-quant oracle (its first
    forward's codes held against them): (packed ppl, its logits, fake-quant
    ppl, its logits, seconds of each, the packed run's launch counts,
    whether the code witness held (``witness``; else None))."""
    packed = quantize_params(dense, cfg, policy, dtype=torch.float32, device=dev)
    reset_launch_counts()
    with PackedCodes(cfg.num_layers, forwards=1) as codes:
        packed_ppl, got, s_packed = kept_ppl(lambda x: forward_serve(packed, cfg, policy, x, device=dev)[0], windows,
                                             batch_size, keep)
    counts = launch_counts()
    add(counts)
    del packed
    torch.cuda.empty_cache()
    require_launched(f"eval {cfg.num_layers} layers", counts, path, dev)
    fq = fake_quant_weights(dense, policy)
    with OracleCodes(codes, hand_on=False) as as_is:
        fake_ppl, oracle, s_fake = kept_ppl(lambda x: dense_forward(fq, cfg, x, policy=policy), windows, batch_size,
                                            keep)
    held = code_witness(label, fq, cfg, policy, windows[:batch_size], codes, as_is, got[0], oracle[0]) if witness \
        else None
    del fq, codes
    torch.cuda.empty_cache()
    return packed_ppl, got, fake_ppl, oracle, s_packed, s_fake, counts, held


def fmt_gaps(gaps) -> str:
    return (f"per window max |dlogit|/max|logit| {[round(g[0], 4) for g in gaps]}, argmax agreement "
            f"{[round(g[1], 4) for g in gaps]}, over the decisive rows {[round(g[2], 4) for g in gaps]} "
            f"({[round(g[3], 3) for g in gaps]} of the rows decisive)")


def eval_table(dense, cfg, windows, dev, add):
    """(a): the dense, fake-quant and packed perplexities of the 32-layer
    LLaMA-2-7B over the windows, with the packed-vs-oracle and oracle-vs-dense
    logit gaps. Held: each packed path against its oracle at the reference's
    bounds at the depth its test sets them (EVAL_HOLD_LAYERS: the first
    layers of the same model, full width, the same windows), and at full
    depth, where flipped activation codes cascade (PERF.md §6), by the code
    witness: with the packed path's codes handed on, the oracle computes the
    packed path's logits."""
    ok = True
    dense_ppl, dense_logits, s = kept_ppl(lambda x: dense_forward(dense, cfg, x), windows)
    log(f"eval ppl dense f32 (LLaMA-2-7B widths, {cfg.num_layers} layers, random weights, {windows.shape[0]} x "
        f"{windows.shape[1]}-token windows of data_tiny/test.npy): {dense_ppl:.4f} ({s:.1f}s)")
    cut = cut_layers(dense, EVAL_HOLD_LAYERS)
    ccfg = dataclasses.replace(cfg, num_layers=EVAL_HOLD_LAYERS)
    fake = {}
    for label, policy, path in EVAL_POLICIES:
        packed_ppl, got, fake_ppl, oracle, s_packed, s_fake, counts, witnessed = fake_and_packed(
            label, dense, cfg, policy, windows, dev, add, path, witness=True)
        fake[label] = fake_ppl
        gaps = logit_gaps(got, oracle)
        noise = logit_gaps(oracle, dense_logits)
        del got, oracle
        torch.cuda.empty_cache()
        log(f"eval ppl {label}: fake-quant {fake_ppl:.4f} (dppl vs dense {fake_ppl - dense_ppl:+.4f}, {s_fake:.1f}s), "
            f"packed {packed_ppl:.4f} (dppl vs dense {packed_ppl - dense_ppl:+.4f}, {s_packed:.1f}s); packed vs fake, "
            f"{cfg.num_layers} layers (the code witness holds them): ppl gap {abs(packed_ppl - fake_ppl) / fake_ppl:.3g} "
            f"relative, {fmt_gaps(gaps)}; fake vs dense: {fmt_gaps(noise)}")
        log(f"eval launches {label} packed, {cfg.num_layers} layers: "
            + " ".join(f"{k}={v}" for k, v in counts.items() if v))
        _, got, _, oracle, _, _, _, _ = fake_and_packed(label, cut, ccfg, policy, windows, dev, add, path)
        held = logit_gaps(got, oracle)
        del got, oracle
        torch.cuda.empty_cache()
        worst, agree = max(g[0] for g in held), min(g[1] for g in held)
        passed = worst <= EVAL_BOUND and agree >= EVAL_AGREE
        log(f"eval hold {label}, the first {EVAL_HOLD_LAYERS} layers (the reference test's depth), packed vs fake-quant "
            f"oracle: {fmt_gaps(held)} (bounds: max |dlogit|/max|logit| <= {EVAL_BOUND:g}, argmax agreement >= "
            f"{EVAL_AGREE:g}): {'held' if passed else 'FAILED'}")
        ok = ok and passed and witnessed and math.isfinite(packed_ppl)
    del dense_logits
    torch.cuda.empty_cache()
    return ok, dense_ppl, fake


def oracle_parity(cfg, dev, gen, add):
    """(c): the port's scripts/oracle_parity.py, on its weights (every linear,
    the embedding and the head N(0, 0.02) with no residual scaling, norms 1,
    bf16). 256 greedy tokens through Engine.generate (B = 1, bf16 packed tree
    and cache, the W6A16 prefill off, so the prompt is act-quantized like
    the oracle), then the same sequence teacher-forced through the bf16
    fake-quant oracle: logit RMSE over the oracle's std, max |dlogit|,
    greedy agreement; the same with the Engine's activation codes handed to
    the oracle, the share of codes the oracle computes off the Engine's
    layer by layer, and the oracle against the dense bf16 model. Returns
    whether the handed-on parity held."""
    prompt = np.random.default_rng(7).integers(100, 31000, ORACLE_PROMPT).tolist()
    dense = random_weights(cfg, gen, dev, lambda lp: to_device(lp, torch.bfloat16), res_std=0.02)
    return oracle_parity_on(to_device(dense, torch.bfloat16), cfg, dev, add, prompt,
                     "N(0, 0.02) as scripts/oracle_parity.py makes them")


def oracle_parity_on(dense, cfg, dev, add, prompt, weights: str) -> bool:
    """Oracle parity (phase 8 (c), phase 9 (e)) on the bf16 tree ``dense``
    (``weights`` says what it holds) from ``prompt``: llama_flex and W4A8,
    ORACLE_NEW greedy tokens each. Held, for each: with the Engine's
    activation codes handed on, the oracle within ORACLE_HANDON_RMSE rmse /
    std of the Engine's logits and greedy agreement ORACLE_HANDON_AGREE;
    as it is, the oracle is only logged (flipped codes cascade)."""
    ok = True

    def parity(rows, want):
        rmse = (rows - want).pow(2).mean().sqrt().item() / want.std().item()
        agree = (rows.argmax(-1) == want.argmax(-1)).float().mean().item()
        return rmse, agree, (f"rmse_over_std={rmse:.4g} max_abs={(rows - want).abs().max().item():.4g} "
                             f"greedy_agreement={agree:.4f}")

    for label, policy, path in (("llama_flex", QuantPolicy.llama_flex(), "oracle W6"),
                                ("W4A8", QuantPolicy.uniform("llama", 4, 8), "oracle W4")):
        t0 = time.perf_counter()
        eng = Engine(quantize_params(dense, cfg, policy, device=dev), cfg, policy, max_seq_len=ORACLE_MAX,
                     prefill_bf16_threshold=ORACLE_MAX + 1, device=dev)
        sync()
        reset_launch_counts()
        with PackedCodes(cfg.num_layers) as codes, LogitTap(eng) as tap:
            out = eng.generate([prompt], max_new_tokens=ORACLE_NEW, eos_id=-1, mode="step")[0]
        sync()
        counts = launch_counts()
        add(counts)
        serve = torch.cat([*tap.prompts, *tap.steps]).float()  # [256, V]: the logits that chose each token
        del eng, tap
        torch.cuda.empty_cache()
        gen_s = time.perf_counter() - t0
        require_launched(f"oracle parity {label}", counts, path, dev)
        if len(out) != ORACLE_NEW or not torch.isfinite(serve).all():
            raise AssertionError(f"oracle parity {label}: a bad run")
        seq = torch.as_tensor([prompt + out[:-1]])
        fq = fake_quant_weights(dense, policy)
        with OracleCodes(codes, hand_on=False) as as_is:
            oracle = dense_forward(fq, cfg, seq, policy=policy)[0, len(prompt) - 1:].float()
        with OracleCodes(codes, hand_on=True) as handed:
            handed_rows = dense_forward(fq, cfg, seq, policy=policy)[0, len(prompt) - 1:].float()
        del fq, codes
        plain = dense_forward(dense, cfg, seq)[0, len(prompt) - 1:].float()
        torch.cuda.empty_cache()
        handed_rmse, handed_agree, handed_line = parity(serve, handed_rows)
        held = handed_rmse <= ORACLE_HANDON_RMSE and handed_agree >= ORACLE_HANDON_AGREE
        ok = ok and held
        log(f"oracle parity {label} ({cfg.num_layers} layers, hidden {cfg.hidden_size}, head_dim {cfg.head_dim}, "
            f"bf16 weights, packed tree and cache, {weights}, {len(prompt)}-token prompt through the W*Ax layer, "
            f"{len(out)} greedy tokens via Engine.generate, teacher-forced through the bf16 fake-quant oracle): "
            f"{parity(serve, oracle)[2]} oracle_std={oracle.std().item():.4g} ({gen_s:.1f}s)")
        log(f"oracle parity {label}, the Engine's activation codes handed to the oracle: {handed_line} (bounds "
            f"{ORACLE_HANDON_RMSE:g}, {ORACLE_HANDON_AGREE:g}): {'held' if held else 'FAILED'}; the oracle's codes off "
            f"the Engine's, layer by layer, as it is {fmt_shares(as_is.shares())} (most {as_is.totals()[2]}), handed on "
            f"{fmt_shares(handed.shares())} (most {handed.totals()[2]}); the oracle "
            f"vs the dense bf16 model: {parity(oracle, plain)[2]}")
        log(f"oracle launches {label}: " + " ".join(f"{k}={v}" for k, v in counts.items() if v))
        del serve, oracle, handed_rows, plain
    return ok


def smoothing_and_sensitivity(dense, cfg, windows, dev, fake_flex_ppl) -> bool:
    """(d): collect_llama_act_stats + smooth_llama on one 512-token window of
    data_tiny/val.npy (the dense logits before and after the fold within
    SMOOTH_TOL of max |logit|), the fake-quant llama_flex ppl over the eval
    windows with and without smoothing; analyze_act_sensitivity on the same
    window, its per-linear KL ranking and derived policy. Frees ``dense``'s
    layers (the caller's tree is emptied)."""
    val = np.load(data_file("val.npy"))[:SMOOTH_TOKENS].astype(np.int64)[None]
    t0 = time.perf_counter()
    report = analyze_act_sensitivity(dense_forward, dense, cfg, val)
    log(f"sensitivity analyze_act_sensitivity (LLaMA-2-7B, one {SMOOTH_TOKENS}-token window of data_tiny/val.npy, "
        f"{time.perf_counter() - t0:.1f}s): per-linear KL ranking, the derived policy:")
    for line in report.summary().splitlines():
        log(f"sensitivity   {line}")
    log("sensitivity per-linear KL: " + " ".join(f"{n}={kl:.4g}" for n, kl in report.per_linear_kl.items())
        + f" baseline={report.baseline_kl:.4g}")
    t0 = time.perf_counter()
    stats = collect_llama_act_stats(dense, cfg, val)
    smoothed = smooth_llama(dense, cfg, stats)
    with torch.no_grad():
        before = dense_forward(dense, cfg, val)
        after = dense_forward(smoothed, cfg, val)
    gap = ((after - before).abs().max() / before.abs().max()).item()
    agree = (after.argmax(-1) == before.argmax(-1)).float().mean().item()
    del before, after
    dense["layers"] = []  # the smoothed tree keeps what it shares with the dense one
    torch.cuda.empty_cache()
    log(f"smooth collect_llama_act_stats + smooth_llama (alpha 0.5) on the {SMOOTH_TOKENS}-token window "
        f"({time.perf_counter() - t0:.1f}s): dense f32 logits before vs after the fold max |dlogit|/max|logit| = "
        f"{gap:.3g} (tolerance {SMOOTH_TOL:g}), argmax agreement {agree:.4f}")
    policy = QuantPolicy.llama_flex()
    fq = fake_quant_weights(smoothed, policy)
    del smoothed
    torch.cuda.empty_cache()
    ppl, kept, s = kept_ppl(lambda x: dense_forward(fq, cfg, x, policy=policy), windows)
    del kept, fq
    torch.cuda.empty_cache()
    log(f"smooth fake-quant llama_flex ppl over the eval windows: without smoothing {fake_flex_ppl:.4f}, with "
        f"{ppl:.4f} ({s:.1f}s)")
    return gap <= SMOOTH_TOL and math.isfinite(ppl)


def opt_eval(dev, gen, windows, add, cfg=None) -> bool:
    """(b): OPT-6.7B's widths (depth cut to OPT_EVAL_LAYERS), random f32
    weights: the fake-quant and packed opt_flex perplexities over the
    windows, the packed path held against its oracle, the argmax over the
    decisive rows."""
    cfg = cfg or ModelConfig.opt(**{**OPT_67B, "num_layers": OPT_EVAL_LAYERS})
    dense = random_weights(cfg, gen, dev)
    policy = QuantPolicy.opt_flex()
    dense_ppl, _, s = kept_ppl(lambda x: opt_dense_forward(dense, cfg, x), windows)
    fq = opt_fake_quant_weights(dense, policy)
    fake_ppl, oracle, s_fake = kept_ppl(lambda x: opt_dense_forward(fq, cfg, x, policy=policy), windows)
    del fq
    packed = quantize_params(dense, cfg, policy, dtype=torch.float32, device=dev)
    del dense
    torch.cuda.empty_cache()
    reset_launch_counts()
    packed_ppl, got, s_packed = kept_ppl(lambda x: forward_serve(packed, cfg, policy, x, device=dev)[0], windows)
    counts = launch_counts()
    add(counts)
    del packed
    gaps = logit_gaps(got, oracle)
    del got, oracle
    torch.cuda.empty_cache()
    worst, agree = max(g[0] for g in gaps), min(g[2] for g in gaps)
    log(f"eval ppl OPT opt_flex (OPT-6.7B widths, depth cut to {cfg.num_layers} layers, random f32 weights, tied "
        f"head; hidden {cfg.hidden_size}): dense {dense_ppl:.4f} ({s:.1f}s), fake-quant {fake_ppl:.4f} (dppl {fake_ppl - dense_ppl:+.4f}, "
        f"{s_fake:.1f}s), packed {packed_ppl:.4f} (dppl {packed_ppl - dense_ppl:+.4f}, {s_packed:.1f}s); packed vs "
        f"fake: ppl gap {abs(packed_ppl - fake_ppl) / fake_ppl:.3g} relative, per window max |dlogit|/max|logit| "
        f"{[round(g[0], 4) for g in gaps]} (bound {EVAL_BOUND:g}), argmax agreement over all rows "
        f"{[round(g[1], 4) for g in gaps]}, over the decisive rows {[round(g[2], 4) for g in gaps]} (bound "
        f"{EVAL_AGREE:g}; {[round(g[3], 3) for g in gaps]} of the rows decisive)")
    log("eval launches OPT opt_flex packed: " + " ".join(f"{k}={v}" for k, v in counts.items() if v))
    require_launched("eval OPT", counts, "eval OPT", dev)
    return worst <= EVAL_BOUND and agree >= EVAL_AGREE and math.isfinite(packed_ppl)


def cli_json(args, label):
    """``python -m flexq_tpu_torch.main ARGS`` on the card: its JSON line."""
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "flexq_tpu_torch.main", *args], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.abspath(__file__)), timeout=600)
    if run.returncode != 0:
        raise AssertionError(f"cli {label} failed ({run.returncode}):\n{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
    line = run.stdout.strip().splitlines()[-1]
    log(f"cli `python -m flexq_tpu_torch.main {' '.join(a if not a.startswith('/') else '<dir>' for a in args)}` "
        f"({time.perf_counter() - t0:.1f}s): {line}")
    return json.loads(line)


def eval_cli(workdir, dev) -> None:
    """(e): the quantize-and-evaluate CLI on phase 5's HF directory, on the
    card: --flex_linear_quant --smooth, then --flex_linear_quant --export,
    whose load_packed tree equals phase 5's exporter CLI's leaf for leaf."""
    hf_dir, packed = os.path.join(workdir, "hf"), os.path.join(workdir, "packed")
    on = ["--cpu"] if dev.type == "cpu" else []  # the card unless a CPU rehearsal
    res = cli_json(["--model", hf_dir, "--flex_linear_quant", "--smooth", *on], "smooth")
    out = os.path.join(workdir, "packed_main")
    res_e = cli_json(["--model", hf_dir, "--flex_linear_quant", "--export", out, *on], "export")
    if res["wbits"] != 6 or res_e.get("exported") != out:
        raise AssertionError("cli: bad result lines")
    got, want = load_packed(out, device=dev)[2], load_packed(packed, device=dev)[2]
    trees_equal("main --export vs phase 5's exporter CLI (load_packed on the card)", got, want)
    log("cli --eval_ppl and --tasks (datasets.save_to_disk directories read through `datasets`, a tokenizer through "
        "`transformers`) are not run in this phase: they are held against flexq_tpu on the CPU only, by "
        "tests/test_torch_eval.py")


def quantize_and_evaluate(dev, workdir, cfg=None, opt_cfg=None, n_windows=EVAL_WINDOWS):
    """Phase 8 (see the module docstring); returns its launch counts.
    ``cfg`` / ``opt_cfg`` replace the LLaMA-2-7B and OPT-6.7B models, and
    ``n_windows`` the eval windows (a CPU rehearsal at a tiny size)."""
    t_phase = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    matmul = torch.backends.cuda.matmul
    if matmul.allow_tf32 or matmul.allow_bf16_reduced_precision_reduction or \
            torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("phase 8 needs true f32 matmuls (TF32 off) and bf16 GEMMs reduced in f32")
    log(f"eval: the dense models in true f32 (torch.backends.cuda.matmul.allow_tf32={matmul.allow_tf32}, float32 "
        f"matmul precision {torch.get_float32_matmul_precision()!r}): a TF32 oracle parts from the CPU's by more "
        f"than the 6-bit codes tolerate; the bf16 oracle's GEMMs reduce in f32 "
        f"(allow_bf16_reduced_precision_reduction={matmul.allow_bf16_reduced_precision_reduction})")
    totals = {k: 0 for k in launch_counts()}

    def add(counts):
        for k, v in counts.items():
            totals[k] += v

    windows = np.load(data_file("test.npy"))[: n_windows * EVAL_SEQLEN].astype(np.int64)
    windows = windows.reshape(n_windows, EVAL_SEQLEN)
    cfg = cfg or ModelConfig.llama()
    t0 = time.perf_counter()
    dense = random_weights(cfg, torch.Generator(device=dev).manual_seed(SEED + 20), dev)
    sync()
    log(f"eval: LLaMA-2-7B ({cfg.num_layers} layers, hidden {cfg.hidden_size}, FFN {cfg.intermediate_size}, vocab "
        f"{cfg.vocab_size}) random f32 weights generated on the card in {time.perf_counter() - t0:.1f}s")
    ok, dense_ppl, fake = eval_table(dense, cfg, windows, dev, add)
    ok = smoothing_and_sensitivity(dense, cfg, windows, dev, fake["llama_flex W6A6 (down A8)"]) and ok
    del dense
    torch.cuda.empty_cache()
    ok = oracle_parity(cfg, dev, torch.Generator(device=dev).manual_seed(SEED + 22), add) and ok
    torch.cuda.empty_cache()
    ok = opt_eval(dev, torch.Generator(device=dev).manual_seed(SEED + 21), windows, add, opt_cfg) and ok
    torch.cuda.empty_cache()
    eval_cli(workdir, dev)
    log(f"eval launches in all: " + " ".join(f"{k}={v}" for k, v in totals.items() if v))
    missing = [k for k in EVAL_KERNELS if totals[k] == 0]
    if dev.type == "cuda" and missing:
        raise AssertionError(f"phase 8: kernels never launched: {missing}")
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")
    log(f"phase 8 quantize and evaluate: {time.perf_counter() - t_phase:.1f}s, peak device memory {peak:.1f} GiB")
    if not ok:
        raise AssertionError("phase 8: a packed path parts from its oracle, or the smoothing fold is not an "
                             "identity (see the eval and oracle parity lines)")
    return totals


# ---- phase 9: train the accuracy-gate model, then gate its weights ---------

TRAIN_STEPS, TRAIN_EVAL_EVERY = 600, 100  # the trainer's steps and evals: about 130 s of steps on an H100 (PERF.md)
TRAIN_MAX_MINUTES = 3.5  # the trainer stops at its first eval past this
CORPUS_MB = 16  # the training corpus cut from the machine's own files
VAL_PPL_BOUND = 500.0  # the trained model's final val ppl, well under the vocabulary's 8192
CARD_CPU_LAYERS, CARD_CPU_BATCH, CARD_CPU_STEPS = 2, 8, 3  # (c): 2 layers at the trained widths, 8 x 512 tokens
GATE_SEQ, GATE_BATCH = 512, 16  # (d): windows_from_stream(test, 512), 16 windows a forward
# (d), every served format: packed vs fake-quant ppl, relative; and that gap
# as a share of the fake-quant ppl's own step from the dense model's (a path
# that skipped quantization would part from fake-quant by the whole step)
PACKED_FAKE_BOUND, PACKED_SHARE_BOUND = 1e-4, 0.3
SPEC_PROMPT, SPEC_NEW, SPEC_ROWS = 128, 64, 4  # (e): spec decoding on prompts from test.npy
# (e)'s speculative decoding: the W*Ax prompt (K9's tiles at 128 queries), the
# [B, 1 + k] verify windows (K9's short-prompt kernel, the exact GEMM on route
# A), plain greedy's decode steps (K6, K3)
PATH_KERNELS["spec W*Ax prompt"] = PRODUCERS + ("w6_matmul", "flash_prefill")
# the kernels phase 9 must launch (K1-K6, K9, K10, K12)
GATE_KERNELS = PRODUCERS + ("w6_matmul", "w6_matmul_stream", "flash_decode", "flash_prefill", "w4_matmul",
                            "w8_matmul")


def corpus_and_tokens(cdir: str) -> np.ndarray:
    """(a): a training corpus from this machine's own files (the port's
    build_corpus over numpy's site-packages and the system's docs and
    licenses), the units data_tiny/MANIFEST.txt holds out excluded under
    every root before a file of theirs is read (so no document of theirs
    reaches the train split), no unit held out of it (all train);
    encoded with the port's encode_file and data_tiny/tokenizer.json, the
    encoder held against data_tiny/val.npy on the whole of val.txt; the
    repo's tokenizer and val / test streams copied beside it. Returns the
    train stream."""
    t0 = time.perf_counter()
    held = corpus.read_manifest_units(data_file("MANIFEST.txt"))
    roots = corpus.default_roots()
    names = sorted({u.split("/", 1)[1] for u in held})  # "site-packages/filelock" -> "filelock"
    exclude = [f"{os.path.basename(r)}/{n}" for r in roots for n in names]
    present = [f"{os.path.basename(r)}/{n}" for r in roots for n in names if os.path.exists(os.path.join(r, n))]
    m = corpus.build_corpus(cdir, roots=roots, max_mb=CORPUS_MB, heldout_mb=0, exclude_units=exclude)
    build_s = time.perf_counter() - t0
    if m["val_units"] or m["test_units"] or m["train_docs"] != m["n_docs"]:
        raise AssertionError("corpus: every document belongs in the train split")
    log(f"train corpus: build_corpus over {roots} ({build_s:.1f}s): {m['n_docs']} documents, "
        f"{m['train_bytes'] / 1e6:.2f} MB; data_tiny's held-out units {held} excluded under every root "
        f"({exclude}; present on this machine: {present or 'none'})")
    for name in ("tokenizer.json", "val.npy", "test.npy"):
        shutil.copy(data_file(name), os.path.join(cdir, name))
    tok = os.path.join(cdir, "tokenizer.json")
    t0 = time.perf_counter()
    n = corpus.encode_file(tok, os.path.join(cdir, "train.txt"), os.path.join(cdir, "train.npy"))
    enc_s = time.perf_counter() - t0
    log(f"train corpus encoded by the port's encode_file: {m['train_bytes'] / 1e6:.2f} MB -> {n} tokens in "
        f"{enc_s:.1f}s ({m['train_bytes'] / 1e6 / enc_s:.2f} MB/s)")
    t0 = time.perf_counter()
    corpus.encode_file(tok, data_file("val.txt"), os.path.join(cdir, "val_port.npy"))
    got, want = np.load(os.path.join(cdir, "val_port.npy")), np.load(data_file("val.npy"))
    same = got.shape == want.shape and bool(np.array_equal(got, want))
    log(f"encoder check: encode_file(data_tiny/val.txt) against data_tiny/val.npy (the tokenizers library's ids, "
        f"{-(-os.path.getsize(data_file('val.txt')) // (1 << 20))} chunks of 1 Mi characters): {got.size} vs "
        f"{want.size} tokens, {'equal' if same else 'DIFFERENT'} ({time.perf_counter() - t0:.1f}s)")
    if not same:
        raise AssertionError("encoder check: the port's encode_file parts from data_tiny/val.npy")
    return np.load(os.path.join(cdir, "train.npy"))


def train_tiny(cdir: str, odir: str, dev) -> bool:
    """(b): scripts/torch_train_tiny.py as a subprocess on ``dev`` at the
    reference's accuracy-gate shape (its defaults), TRAIN_STEPS steps; the
    val curve read from its history.jsonl, its summary from its last line. Held:
    the val loss falls from the first eval to the last, and the final val
    ppl is at most VAL_PPL_BOUND."""
    cmd = [sys.executable, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", "torch_train_tiny.py"),
           "--corpus-dir", cdir, "--out-dir", odir, "--steps", str(TRAIN_STEPS), "--eval-every", str(TRAIN_EVAL_EVERY),
           "--max-minutes", str(TRAIN_MAX_MINUTES), "--device", dev.type]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"trainer failed ({run.returncode}):\n{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
    for line in run.stdout.strip().splitlines():
        log(f"train | {line}")
    summary = json.loads(run.stdout.strip().splitlines()[-1])
    with open(os.path.join(odir, "history.jsonl")) as f:
        hist = [json.loads(line) for line in f]
    falls = len(hist) >= 2 and hist[-1]["val_loss"] < hist[0]["val_loss"]
    final_ppl = hist[-1]["val_ppl"]
    ok = falls and final_ppl <= VAL_PPL_BOUND
    log(f"train: {summary['steps']} steps in {wall:.1f}s of wall (the process, its start and evals included): "
        f"{summary['s_per_step']} s a step and {summary['tokens_per_s']} tokens/s over its {summary['timed_steps']} "
        f"timed steps ({summary['train_s']} s, evals and checkpoints left out; the first 50-step block "
        f"{summary['first_block_s']} s, the median one {summary['s_per_step_median_block']} s a step), peak "
        f"{summary['peak_gib']} GiB; val curve "
        f"{[(h['step'], h['val_loss'], h['val_ppl']) for h in hist]}: val loss falls {hist[0]['val_loss']} -> "
        f"{hist[-1]['val_loss']}, final val ppl {final_ppl} (bound {VAL_PPL_BOUND:g}, under the vocabulary's "
        f"8192): {'held' if ok else 'FAILED'}")
    return ok


def card_vs_cpu(cfg, tokens, dev) -> bool:
    """(c): the first CARD_CPU_STEPS train_steps of a CARD_CPU_LAYERS-layer
    model at the trained widths, on ``dev`` and on the CPU from the same
    init_params and batches, TF32 off. Held: the first step (lr(0) = 0)
    leaves the parameters bit for bit on both; the loss each step within
    1e-5 relative (f32 sums in another order); the parameters: none apart
    by more than 2 x the summed lr (an update's sign flips where a gradient
    entry is below the sums' rounding: Adam moves it by +-lr either way) and
    at most 1e-4 of the entries apart by more than 1e-3 x the summed lr."""
    ccfg = dataclasses.replace(cfg, num_layers=CARD_CPU_LAYERS)
    tc = trainer.TrainConfig(batch_size=CARD_CPU_BATCH, seq_len=GATE_SEQ, total_steps=TRAIN_STEPS)
    batches = list(itertools.islice(trainer.batch_iterator(tokens, tc, seed=1), CARD_CPU_STEPS))
    runs = {}
    for d in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        params = trainer.init_params(ccfg, 0, device=d)
        opt = trainer.make_optimizer(tc, params)
        state, losses, first_kept = opt.init(params), [], None
        for ids in batches:
            before = params
            params, state, loss = trainer.train_step(params, state, ids, ccfg, opt)
            losses.append(float(loss))
            if first_kept is None:
                first_kept = all(torch.equal(a, b) for a, b in zip(trainer.tree_leaves(before),
                                                                  trainer.tree_leaves(params)))
        runs[d.type] = params, losses, first_kept, time.perf_counter() - t0
    (pg, lg, kg, sg), (pc, lc, kc, sc) = runs[dev.type], runs["cpu"]
    lr_sum = sum(opt.schedule(c) for c in range(CARD_CPU_STEPS))
    diffs = torch.cat([(a.cpu() - b).abs().flatten() for a, b in zip(trainer.tree_leaves(pg),
                                                                       trainer.tree_leaves(pc))])
    worst, far = diffs.max().item(), (diffs > 1e-3 * lr_sum).float().mean().item()
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    ok = kg and kc and loss_gap <= 1e-5 and worst <= 2 * lr_sum and far <= 1e-4
    log(f"train card vs cpu ({CARD_CPU_LAYERS} layers at the trained widths, {CARD_CPU_STEPS} steps of "
        f"{CARD_CPU_BATCH} x {GATE_SEQ} tokens, lr summed {lr_sum:.3g}): losses {dev.type} {lg} cpu {lc} (largest "
        f"relative gap {loss_gap:.3g}, bound 1e-5); first step leaves the parameters unchanged: {dev.type} {kg}, cpu "
        f"{kc}; parameters after: max |dp| {worst:.3g} (bound {2 * lr_sum:.3g}), share of entries apart by more than "
        f"{1e-3 * lr_sum:.3g} {far:.3g} (bound 1e-4); {sg:.1f}s on {dev.type}, {sc:.1f}s on the cpu: "
        f"{'held' if ok else 'FAILED'}")
    return ok


def gate(params, cfg, dev, add) -> bool:
    """(d): the trained weights over windows_from_stream(test.npy, 512),
    GATE_BATCH windows a forward: the dense f32 ppl, and per policy of
    EVAL_POLICIES phase 8's fake_and_packed: the fake-quant ppl
    (fake_quant_weights + the dense forward) and the packed ppl
    (quantize_params + the cache-less forward_serve, f32), with the code
    witness on the first forward. Held: the witness, and the packed ppl
    within PACKED_FAKE_BOUND relative of the fake-quant ppl and within
    PACKED_SHARE_BOUND of the fake-quant ppl's step from the dense ppl.
    "dppl <= 0.1" is the reference's acceptance metric: reported, not held
    (minutes of training)."""
    windows = trainer.windows_from_stream(np.load(data_file("test.npy")), GATE_SEQ)
    dense_ppl, _, s = kept_ppl(lambda x: dense_forward(params, cfg, x), windows, GATE_BATCH, keep=0)
    log(f"gate ppl dense f32 (the trained {cfg.num_layers}-layer model, hidden {cfg.hidden_size}, head_dim "
        f"{cfg.head_dim}, over {windows.shape[0]} x {GATE_SEQ}-token windows of data_tiny/test.npy): {dense_ppl:.4f} "
        f"({s:.1f}s)")
    ok = math.isfinite(dense_ppl)
    for label, policy, path in EVAL_POLICIES:
        packed_ppl, got, fake_ppl, oracle, s_packed, s_fake, counts, witnessed = fake_and_packed(
            label, params, cfg, policy, windows, dev, add, path, witness=True, batch_size=GATE_BATCH, keep=1)
        rel = abs(packed_ppl - fake_ppl) / fake_ppl
        share = abs(packed_ppl - fake_ppl) / max(abs(fake_ppl - dense_ppl), 1e-30)
        held = rel <= PACKED_FAKE_BOUND and share <= PACKED_SHARE_BOUND and math.isfinite(packed_ppl)
        log(f"gate ppl {label}: fake-quant {fake_ppl:.4f} (dppl vs f32 {fake_ppl - dense_ppl:+.4f}, {s_fake:.1f}s), "
            f"packed {packed_ppl:.4f} (dppl vs f32 {packed_ppl - dense_ppl:+.4f}, {s_packed:.1f}s); packed vs "
            f"fake-quant ppl {rel:.3g} relative (bound {PACKED_FAKE_BOUND:g}), {share:.3g} of fake-quant's step from "
            f"f32 (bound {PACKED_SHARE_BOUND:g}): {'held' if held else 'FAILED'}; first forward "
            f"{fmt_gaps(logit_gaps(got, oracle))}")
        log(f"gate launches {label} packed: " + " ".join(f"{k}={v}" for k, v in counts.items() if v))
        ok = ok and held and witnessed
        del got, oracle
        torch.cuda.empty_cache()
    return ok


def spec_on_trained(params, cfg, dev, add):
    """(e): speculative decoding (Engine.generate mode="spec", k = SPEC_K,
    n-gram drafts) on SPEC_ROWS prompts from test.npy (the W*Ax prompt),
    SPEC_NEW new tokens: acceptance and decode ms a token against plain
    greedy on the captured step graph (mode="fused"), its tokens held to
    plain greedy over the decisive steps as phase 6 holds them."""
    policy = QuantPolicy.llama_flex()
    test = np.load(data_file("test.npy"))
    starts = np.linspace(0, test.size - SPEC_PROMPT - 1, SPEC_ROWS).astype(np.int64)
    ps = [test[s : s + SPEC_PROMPT].astype(np.int64).tolist() for s in starts]
    eng = Engine(quantize_params(params, cfg, policy, device=dev), cfg, policy, max_seq_len=ORACLE_MAX,
                 prefill_bf16_threshold=ORACLE_MAX + 1, device=dev)
    eng.generate(ps, max_new_tokens=2, eos_id=-1)  # warm-up: the first use of every kernel, the graph's capture
    eng.generate(ps, max_new_tokens=4, eos_id=-1, mode="spec")
    with LogitTap(eng, 1 + SPEC_K) as plain_tap:
        plain = eng.generate(ps, max_new_tokens=SPEC_NEW, eos_id=-1, mode="step")
    fused, pstats = eng.generate(ps, max_new_tokens=SPEC_NEW, eos_id=-1, return_stats=True)
    if fused != plain:
        raise AssertionError("spec on trained weights: plain greedy's fused and step loops disagree")
    with LogitTap(eng, 1 + SPEC_K) as spec_tap:
        (got, st), counts = run_counted("spec trained", "spec W*Ax prompt", lambda: eng.generate(
            ps, max_new_tokens=SPEC_NEW, eos_id=-1, mode="spec", return_stats=True))
    add(counts)
    held, decisive, compared = decisive_hold("modes spec trained", plain, got, plain_tap.at,
                                             spec_tap.spec_at(SPEC_PROMPT), [(r, r) for r in range(SPEC_ROWS)])
    plain_ms = pstats.decode_s / (SPEC_NEW - 1) * 1e3
    spec_ms = st.decode_s / (SPEC_NEW - 1) * 1e3
    ok = hold_passes(held, decisive)
    log(f"spec trained B={SPEC_ROWS} prompt={SPEC_PROMPT} (test.npy) k={SPEC_K} new={SPEC_NEW}: "
        f"acceptance_rate={st.acceptance_rate:.3f} ({st.accepted} of {st.drafted} drafted) "
        f"tokens_per_verify_step={st.tokens_per_step:.2f} ({st.tokens_per_step / SPEC_ROWS:.2f} a row) "
        f"decode_ms_per_token={spec_ms:.2f} against plain greedy's on the graph {plain_ms:.2f} "
        f"({plain_ms / spec_ms:.2f}x); spec == plain greedy rows {sum(a == b for a, b in zip(got, plain))}/{SPEC_ROWS}; "
        f"decisive steps held {held}/{decisive} (tolerance >= 95%), {decisive}/{compared} of the steps compared "
        f"decisive: {'held' if ok else 'FAILED'}")
    del eng, plain_tap, spec_tap
    torch.cuda.empty_cache()
    return ok


def train_and_gate(dev):
    """Phase 9 (see the module docstring); returns its launch counts."""
    t_phase = time.perf_counter()
    matmul = torch.backends.cuda.matmul
    if matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("phase 9 needs true f32 matmuls (TF32 off)")
    totals = {k: 0 for k in launch_counts()}

    def add(counts):
        for k, v in counts.items():
            totals[k] += v

    if dev.type == "cuda":
        torch.cuda.empty_cache()  # the trainer is another process: leave it the card
        log(f"train: this process holds {torch.cuda.memory_reserved() / 2**30:.2f} GiB of the card")
    with tempfile.TemporaryDirectory(prefix="flexq_train_") as work:
        cdir, odir = os.path.join(work, "corpus"), os.path.join(work, "ckpt")
        t0 = time.perf_counter()
        tokens = corpus_and_tokens(cdir)
        log(f"phase 9 (a) corpus and tokens: {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        ok = train_tiny(cdir, odir, dev)
        log(f"phase 9 (b) train: {time.perf_counter() - t0:.1f}s")
        params, cfg, meta = trainer.load_checkpoint(os.path.join(odir, "best.npz"), device=dev)
        log(f"gate checkpoint: best.npz of step {meta['step']}, val ppl {meta['val_ppl']:.3f}; "
            f"{cfg.num_layers} layers, hidden {cfg.hidden_size}, FFN {cfg.intermediate_size}, heads {cfg.num_heads} / "
            f"{cfg.num_kv_heads} kv, head_dim {cfg.head_dim}, vocab {cfg.vocab_size}")
        t0 = time.perf_counter()
        ok = card_vs_cpu(cfg, tokens, dev) and ok
        log(f"phase 9 (c) card vs cpu: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    ok = gate(params, cfg, dev, add) and ok
    log(f"phase 9 (d) gate: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    bf16 = to_device(params, torch.bfloat16)
    del params
    test = np.load(data_file("test.npy"))
    ok = oracle_parity_on(bf16, cfg, dev, add, test[:ORACLE_PROMPT].astype(np.int64).tolist(),
                          f"trained (best.npz of step {meta['step']})") and ok
    ok = spec_on_trained(bf16, cfg, dev, add) and ok
    log(f"phase 9 (e) oracle parity and spec decoding: {time.perf_counter() - t0:.1f}s")
    del bf16
    torch.cuda.empty_cache()
    log(f"phase 9 launches in all: " + " ".join(f"{k}={v}" for k, v in totals.items() if v))
    missing = [k for k in GATE_KERNELS if totals[k] == 0]
    if dev.type == "cuda" and missing:
        raise AssertionError(f"phase 9: kernels never launched: {missing}")
    log(f"phase 9 train and gate: {time.perf_counter() - t_phase:.1f}s (budget 300 s)")
    if not ok:
        raise AssertionError("phase 9: a hold failed (see the train, gate, oracle parity and spec lines)")
    return totals


# ---- phase 10: tensor and data parallelism ---------------------------------

TP_RANKS = 2  # two ranks share the one card over gloo
TP_TIMEOUT_S = 420  # the ranks' wall clock, the model draws and every part included
TP_ENGINE_LAYERS = 8  # the gloo ranks' Engine and scheduler depth: LLaMA-2-7B's 32 cut to 8 for the time limit
PHASE4 = {}  # phase 4's prompts, tokens and logits, which phase 10 (b) and phase 11 are held to


def stream_hold(label, want, got, want_at, got_at) -> bool:
    """Two runs' token streams, row by row from the first token, over the
    decisive steps (decisive_hold's rule)."""
    held, decisive, compared = decisive_hold(label, want, got, want_at, got_at, [(r, r) for r in range(len(want))],
                                             first=0)
    equal = sum(a == b for a, b in zip(want, got))
    log(f"{label}: streams equal {equal}/{len(want)}; decisive steps held {held}/{decisive} of {compared} "
        f"compared (tolerance: >= 95% of at least one decisive step)")
    return hold_passes(held, decisive)


class SchedTap:
    """Keeps, per request, the logits each of its tokens was drawn from (a
    BatchScheduler's first token and its decode ticks). Where ``force``
    holds a request's stream, its tokens are taken in place of the sampled
    ones (a replay of another run)."""

    def __init__(self, sched):
        self.rows, self.force = {}, {}
        batch, one = sched._sample_batch, sched._sample_one

        def forced(slot, tok):
            stream = self.force.get(slot.req_id)
            return tok if stream is None else stream[len(slot.prior) + len(slot.generated)]

        def sample_batch(idx, logits):
            for i in idx:
                self.rows.setdefault(sched.slots[i].req_id, []).append(logits[i].float().clone())
            return [(forced(sched.slots[i], t), lp) for i, (t, lp) in zip(idx, batch(idx, logits))]

        def sample_one(row, slot):
            self.rows.setdefault(slot.req_id, []).append(row.float().clone())
            return forced(slot, one(row, slot))

        sched._sample_batch, sched._sample_one = sample_batch, sample_one

    def at(self, ids):
        """decisive_hold's logits, rows in the order of ``ids``."""
        return lambda r, i: self.rows[ids[r]][i]


def run_mix(sched, reqs, force=None):
    """sched_run's arrival pattern (8 requests, 4 ticks, then 8): the streams
    in request order and the SchedTap. ``force``: per request, the stream
    to take in place of the sampled tokens."""
    tap = SchedTap(sched)
    ids = []

    def add(part):
        ids.extend(sched.add_request(p, max_new_tokens=n, eos_id=-1) for p, n in part)
        if force is not None:
            tap.force.update(zip(ids, force))

    add(reqs[:8])
    out = {}
    for _ in range(4):
        out.update(sched.step())
    add(reqs[8:])
    out.update(sched.run())
    tap.ids = ids
    return [out[i] for i in ids], tap


RELAY_PRODUCERS = ("rmsnorm_quant", "quant_act", "glu_quant", "layernorm_quant", "relu_quant")
ROW_INPUTS = ("quant_act", "glu_quant", "relu_quant")  # the producers of a row-parallel linear's input
RELAY_LAYERS = ("llama_layer_serve_prefill",)  # the W*A16 layer: no activation codes, its input handed on
# the code witness's departure bounds: how far the one rank's own values may
# part from the TP run's it is handed. A row-parallel linear's input (o_proj's,
# down_proj's, fc2's) is computed on the one rank from handed codes through
# the column-parallel linears, attention and the cache, which the TP ranks
# run on their local shards: at most one code apart, on at most TP_ROW_OFF of
# the entries (the producers' own kernel tolerance). The residual stream
# drifts from the TP run's, as each rank rounds its half of a row-parallel
# sum to bf16, and its codes part by a code or two at depth: its scales
# within TP_SCALE_OFF of the handed max, each W*A16 layer's input within
# TP_INPUT_OFF, and the logits (witness_hold's tol) hold that drift. A
# planted fault (one rank's q_proj or gate shard zeroed) must fail them
# (PERF.md §6)
TP_ROW_OFF, TP_SCALE_OFF, TP_INPUT_OFF = 1e-3, 0.05, 2e-2


def rel_gap(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


class Departure:
    """How far the one rank's own activation codes, scales and W*A16 layer
    inputs part from those a CodeRelay hands it, over the calls: per kind
    of producer ("row": a row-parallel linear's input; "residual": the
    residual stream's) the entries off, the entries, the most codes apart
    and the scales' gap."""

    def __init__(self):
        self.kinds = {k: dict(off=0, total=0, apart=0, scale=0.0) for k in ("row", "residual")}
        self.input = 0.0

    def codes(self, name, own, handed, rows=None):
        if rows is not None:  # the rows that count (a decode tick's slots in decode)
            own, handed = [t[rows] for t in own[:2]], [t[rows] for t in handed]
        k = self.kinds["row" if name in ROW_INPUTS else "residual"]
        d = (own[0].int() - handed[0].int()).abs()
        apart = int(d.max())
        k["off"] += int((d > 0).sum())
        k["total"] += d.numel()
        k["apart"] = max(k["apart"], apart)
        k["scale"] = max(k["scale"], rel_gap(own[1], handed[1]))

    def layer_input(self, own, handed):
        self.input = max(self.input, rel_gap(own, handed))

    def held(self) -> bool:
        row, res = self.kinds["row"], self.kinds["residual"]
        return (row["apart"] <= 1 and row["off"] <= TP_ROW_OFF * row["total"] and res["scale"] <= TP_SCALE_OFF
                and self.input <= TP_INPUT_OFF)

    def __str__(self):
        row, res = self.kinds["row"], self.kinds["residual"]
        return (f"the one rank's own values off the handed ones: a row-parallel input's codes {row['off']}/"
                f"{row['total']} = {row['off'] / max(row['total'], 1):.3g}, most {row['apart']} apart (bounds: "
                f"{TP_ROW_OFF:g} of the entries, one code), scales {row['scale']:.3g}; the residual's codes "
                f"{res['off']}/{res['total']} = {res['off'] / max(res['total'], 1):.3g}, most {res['apart']} apart "
                f"(logged), scales {res['scale']:.3g} (bound {TP_SCALE_OFF:g}); W*A16 layer inputs {self.input:.3g} "
                f"of the handed max (bound {TP_INPUT_OFF:g})")


class CodeRelay(Patch):
    """Phase 10's code witness. On a tensor-parallel rank (``mesh``): keeps
    every producer call's codes and scales, in call order, those of a
    row-parallel linear's input (o_proj's, down_proj's, fc2's: each rank
    quantizes its K slice, group by group) gathered over the model group
    into the whole row, the others as they are (every rank quantizes the
    all-reduced activations alike), and the input of each W*A16 layer,
    which quantizes no activation (the all-reduced residual, alike on every
    rank). With ``feed`` (such a relay) on one rank: hands those codes and
    scales, and those layer inputs, on in place of each call's own, in the
    same order, and measures in ``departure`` how far its own part from
    them (over the rows of ``rows``, a mask, where it is set): a fault in
    what the handed values replace (a column-parallel GEMM, local
    attention, a local cache) shows there. A packed head's producer is not
    relayed (phase 10's heads are bf16)."""

    names = RELAY_PRODUCERS + RELAY_LAYERS

    def __init__(self, mesh=None, feed=None, o_width=None, departure=None):
        self.mesh, self.feed, self.o_width = mesh, feed, o_width
        self.departure = departure or Departure()
        self.calls, self.rows = [], None

    def _handed(self, name):
        want, *handed = self.feed.calls[len(self.calls)]
        if want != name:
            raise AssertionError(f"code relay: call {len(self.calls)} is {name}, the relay's {want}")
        self.calls.append(name)
        return handed

    def _wrap(self, name, fn):
        if name in RELAY_LAYERS:
            def layer(lp, cfg, x, *args, **kw):
                if self.feed is None:
                    self.calls.append((name, x.clone()))
                    return fn(lp, cfg, x, *args, **kw)
                (given,) = self._handed(name)
                self.departure.layer_input(x, given)
                return fn(lp, cfg, given, *args, **kw)

            return layer

        def producer(*args, **kw):
            out = fn(*args, **kw)
            if self.feed is None:
                q, sc = out[0], out[1]
                if name == "quant_act" and q.shape[-1] != self.o_width:
                    raise AssertionError(f"code relay: quant_act of width {q.shape[-1]} (a packed head?)")
                if name in ROW_INPUTS and self.mesh.tp > 1:
                    q, sc = (all_gather_cat(t, self.mesh.model_group, -1) for t in (q, sc))
                self.calls.append((name, q, sc))
                return out
            q, sc = self._handed(name)
            self.departure.codes(name, out, (q, sc), self.rows)
            return (q, sc) + tuple(out[2:])

        return producer


def witness_hold(label, tp_steps, w_steps, departure, tol=2e-2) -> bool:
    """The tensor-parallel logits against the one rank's with the TP run's
    codes (and W*A16 layer inputs) handed on, step by step ([rows, V]
    each): max |dlogit| / max |logit| within ``tol`` (phase 3's bound), the
    argmax held over the decisive rows (the witness's top-2 margin above
    the step's max |dlogit|), and the one rank's own codes, scales and
    layer inputs within the departure bounds of what it was handed."""
    per_step = [logit_match(b, a) for a, b in zip(w_steps, tp_steps)]
    worst = [m[0] for m in per_step]
    agree, total, dec_agree, dec_total = (sum(m[i] for m in per_step) for i in range(1, 5))
    ok = max(worst) <= tol and hold_passes(dec_agree, dec_total) and departure.held()
    log(f"tp witness {label}: the one rank with the TP run's activation codes and W*A16 layer inputs handed on: "
        f"max |dlogit|/max|logit| {worst[0]:.3g} at the first of {len(worst)} steps, {max(worst):.3g} over all "
        f"(tolerance {tol:g}); argmax agreement {agree}/{total}, {dec_agree}/{dec_total} over the decisive rows "
        f"(tolerance >= 95% of at least one); {departure}")
    return ok


def tp_parity(label, mesh, local, full, cfg, policy, l, dev, kv_dtype=torch.bfloat16, tol=None,
              planted=False) -> bool:
    """forward_serve_tp on this rank's shard against the one-rank
    forward_serve over the whole tree, both on the card (parity()'s run: an
    l-token prompt, the W*A16 layer from 64 tokens, then 2 decode steps,
    B = 2). Held: a W*A16 prompt's logits at phase 3's 2e-2; elsewhere each
    rank rounds its half of a row-parallel sum to bf16 before the
    all-reduce, which flips 6-bit codes downstream, so those are logged and
    held by the code witness (witness_hold): the one rank with the TP run's
    codes and W*A16 layer inputs handed on. ``planted``: ``local`` carries
    a planted fault, and the witness's departure bounds must refuse it."""
    steps = []  # per TP forward: its ids, its other arguments, its logits, the codes it kept
    o_width = cfg.num_heads * cfg.head_dim // mesh.tp

    def forward(p, cfg, policy, ids, device, **kw):
        reset_launch_counts()
        with CodeRelay(mesh, o_width=o_width) as relay:
            logits, cache = forward_serve_tp(p, cfg, policy, ids, mesh, **kw)
        if not planted:
            TP_COUNTS.append(launch_counts())
        steps.append((ids, {k: v for k, v in kw.items() if not k.startswith("kv_")}, logits, relay))
        return logits, cache

    raw = parity(label, local, full, cfg, policy, l, dev, kv_dtype, tol=tol, forward=forward, ref_dev=dev,
                 kv_heads=cfg.num_kv_heads // mesh.tp, held_steps=(0,) if l >= 64 else (), hold_argmax=False,
                 prefix="tp parity", what="2 layers, tp = 2 over gloo vs one rank, both on the card")
    wc, w_steps, departure = dense_cache(cfg, 2, 256, kv_dtype, dev), [], Departure()
    for ids, kw, _, relay in steps:
        with CodeRelay(feed=relay, departure=departure):
            logits, wc = forward_serve(full, cfg, policy, ids, device=dev, **kw, **cache_kw(wc))
        w_steps.append(logits)
    held = witness_hold(f"parity {label}", [st[2] for st in steps], w_steps, departure, tol or 2e-2)
    if planted:
        refused = not departure.held()
        log(f"tp planted fault {label}: the witness's departure bounds {'refuse it' if refused else 'MISS it'}")
        return refused
    return raw and held


TP_COUNTS = []  # the launch counts of each phase 10 main-path run in this process


def plant_fault(local, mesh, name):
    """``local`` with, on model rank 1, every layer's ``name`` shard zeroed
    (its scales): a fault in a column-parallel GEMM that the code witness
    hands on past and only its departure bounds can see."""
    if mesh.model_index != 1:
        return local
    return dict(local, layers=[dict(lp, **{name: dict(lp[name], scale=torch.zeros_like(lp[name]["scale"]))})
                               for lp in local["layers"]])


def tp_slice_parity(mesh, dev, gen) -> bool:
    """(a) forward parity at 7B width, 2 layers: llama_flex (16-token W6Ax
    and 128-token W6A16 prompts over bf16 and int8 caches), W4A8 and W8A8
    (16 and 128 tokens), weight-only W4A16 (128 tokens); OPT-6.7B's widths
    under opt_flex (16 tokens, bf16 and int8 caches; phase 3's 1e-1 for
    OPT's logits). Every rank draws the same layers and keeps its shard.
    Then the planted faults: rank 1's q_proj shard zeroed under the W6Ax
    prompt, its gate_proj shard under the W6A16 one, each of which the
    witness's departure bounds must refuse."""
    cfg = ModelConfig.llama(num_layers=2)
    ok = []
    flex = QuantPolicy.llama_flex()
    full = random_params(cfg, flex, gen, dev)
    local = shard_params(full, mesh)
    for l, kvd in ((16, torch.bfloat16), (16, torch.int8), (128, torch.bfloat16), (128, torch.int8)):
        name = ("W6Ax" if l < 64 else "W6A16") + (" int8 cache" if kvd == torch.int8 else "")
        ok.append(tp_parity(name, mesh, local, full, cfg, flex, l, dev, kvd))
    for l, name in ((16, "q_proj"), (128, "gate_proj")):
        ok.append(tp_parity(f"{'W6Ax' if l < 64 else 'W6A16'}, rank 1's {name} zeroed (planted)", mesh,
                            plant_fault(local, mesh, name), full, cfg, flex, l, dev, planted=True))
    for bits in (4, 8):
        policy = QuantPolicy.uniform(wbits=bits, abits=8)
        full = random_params(cfg, policy, gen, dev)
        local = shard_params(full, mesh)
        ok += [tp_parity(f"W{bits}A8", mesh, local, full, cfg, policy, l, dev) for l in (16, 128)]
        if bits == 4:
            ok.append(tp_parity("weight-only W4A16", mesh, local, full, cfg, QuantPolicy.weight_only(wbits=4), 128,
                                dev))
    ocfg = ModelConfig.opt(**dict(OPT_67B, num_layers=2))
    opt = QuantPolicy.opt_flex()
    full = random_opt_params(ocfg, opt, gen, dev)
    local = shard_params(full, mesh)
    ok += [tp_parity(f"OPT opt_flex{' int8 cache' if kvd == torch.int8 else ''}", mesh, local, full, ocfg, opt, 16,
                     dev, kvd, tol=1e-1) for kvd in (torch.bfloat16, torch.int8)]
    del full, local
    torch.cuda.empty_cache()
    return all(ok)


def tp_engine_runs(mesh, dev, full, cfg, policy, lead) -> bool:
    """(a) the Engine at tp = 2 (mode="step": gloo's collectives cannot be
    captured) on LLaMA-2-7B's shape, B = 4, 32 new tokens, over 32- and
    512-token prompts. Its tokens against the one-rank Engine's are logged
    over the decisive steps: at 32 random layers the two runs' logits part
    by a quarter of max |logit| (one rounding a layer, cascaded through
    flipped codes: §7 of PERF.md), which leaves few decisive steps. Held:
    the code witness, the one rank replaying the TP run's tokens with its
    codes and W*A16 layer inputs handed on (witness_hold). Then tp = 1,
    dp = 2 (each rank two of the four rows, the whole tree) against the
    one-rank run over the decisive steps."""
    rng = np.random.default_rng(SEED)
    p32, p512 = rng.integers(0, cfg.vocab_size, (4, 32)), rng.integers(0, cfg.vocab_size, (4, 512))
    ok = True
    refs = {}
    if lead:  # the one-rank references (rank 1 waits at its next collective)
        one = Engine(full, cfg, policy, max_seq_len=2048)
        for name, p in (("32", p32), ("512", p512)):
            with LogitTap(one) as tap:
                out = one.generate(p, max_new_tokens=32, eos_id=-1, mode="step")
            refs[name] = (out, tap)
        del one
    local = shard_params(full, mesh)
    eng = Engine(local, cfg, policy, max_seq_len=2048, mesh=mesh)
    eng.generate(p32, max_new_tokens=2, eos_id=-1, mode="step")  # warm-up
    o_width = cfg.num_heads * cfg.head_dim // mesh.tp
    for name, p in (("32", p32), ("512", p512)):
        torch.cuda.synchronize()
        reset_launch_counts()
        with LogitTap(eng) as tap:
            out, stats = eng.generate(p, max_new_tokens=32, eos_id=-1, mode="step", return_stats=True)
        TP_COUNTS.append(launch_counts())
        with CodeRelay(mesh, o_width=o_width) as relay:  # the same run again, its codes kept
            again = eng.generate(p, max_new_tokens=32, eos_id=-1, mode="step")
        ms = sum(stats.step_times_s) / len(stats.step_times_s) * 1e3
        if lead:
            log(f"tp engine tp=2 dp=1 {name}-token prompts ({cfg.num_layers} layers, B=4, 32 new, mode=step): ttft_ms="
                f"{stats.ttft_s * 1e3:.1f} decode_ms_per_step={ms:.2f} (two ranks time-sharing one card over gloo: a "
                f"smoke figure, not a multi-GPU speed); the run again with its codes kept gives its tokens: "
                f"{again == out}")
            want, want_tap = refs[name]
            stream_hold(f"tp engine tp=2 {name}-token vs one rank (logged)", want, out, want_tap.at, tap.at)
            w_steps, departure = engine_replay(full, cfg, policy, p, out, relay)
            ok = witness_hold(f"engine tp=2 {name}-token ({cfg.num_layers} layers)", [tap.prompts[0]] + tap.steps, w_steps,
                              departure) and ok and again == out
        del relay
    del eng, local
    torch.cuda.empty_cache()
    dmesh = process_mesh(1, 2)
    eng = Engine(full, cfg, policy, max_seq_len=2048, mesh=dmesh)
    reset_launch_counts()
    with LogitTap(eng) as tap:
        out, stats = eng.generate(p32, max_new_tokens=32, eos_id=-1, mode="step", return_stats=True)
    TP_COUNTS.append(launch_counts())
    if lead:
        ms = sum(stats.step_times_s) / len(stats.step_times_s) * 1e3
        log(f"tp engine tp=1 dp=2 32-token prompts (each rank 2 of the 4 rows): decode_ms_per_step={ms:.2f}")
        want, want_tap = refs["32"]
        ok = stream_hold("tp engine dp=2 32-token vs one rank", want, out, want_tap.at, tap.at) and ok
    del eng
    return ok


def engine_replay(full, cfg, policy, prompts, tokens, relay):
    """The one-rank Engine fed ``tokens`` (a run's, row by row) with
    ``relay``'s codes handed on: the prompt's last logits, then each decode
    step's ([B, V] each), and the departure of its own codes."""
    one = Engine(full, cfg, policy, max_seq_len=2048)
    b, l = prompts.shape
    with CodeRelay(feed=relay) as fed:
        logits, cache = one.prefill_prompts(prompts.tolist(), one.new_cache(b))
        steps = [logits]
        for i in range(len(tokens[0]) - 1):
            ids = torch.tensor([row[i] for row in tokens], device=logits.device)[:, None]
            logits, cache = one._decode_step(ids, cache, l + i)
            steps.append(logits)
    return steps, fed.departure


def tp_scheduler_run(mesh, dev, full, cfg, policy, lead) -> bool:
    """(a) the paged BatchScheduler at tp = 2, fused_tick=0, over phase 4's
    16-request mix (its codes kept for the witness): its streams against
    the one-rank scheduler's over the decisive steps, and the code witness,
    the one-rank scheduler replaying the TP run's streams (its tokens
    forced) with the TP run's codes and W*A16 layer inputs handed on, held
    request by request (witness_hold)."""
    reqs = sched_requests(cfg.vocab_size)
    ok = True
    if lead:
        ref = run_mix(BatchScheduler(full, cfg, policy, **SCHED, paged=True, device=dev), reqs)
    local = shard_params(full, mesh)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    sched = BatchScheduler(local, cfg, policy, **SCHED, paged=True, mesh=mesh)
    with CodeRelay(mesh, o_width=cfg.num_heads * cfg.head_dim // mesh.tp) as relay:
        got = run_mix(sched, reqs)
    TP_COUNTS.append(launch_counts())
    if lead:
        n = sum(map(len, got[0]))
        log(f"tp sched paged tp=2 ({cfg.num_layers} layers, 16 requests, fused_tick=0): {n} tokens in "
            f"{time.perf_counter() - t0:.1f}s, "
            f"mean_ms_per_decode_tick={statistics.mean(sched.tick_s) * 1e3:.1f} (two ranks on one card over gloo, "
            f"the code relay's gathers included); pool free after {sched.pool.free_pages}/{sched.pool.num_pages - 1}")
        ok = stream_hold("tp sched paged tp=2 vs one rank", ref[0], got[0], ref[1].at(ref[1].ids),
                         got[1].at(got[1].ids))
        ok = ok and sched.pool.free_pages == sched.pool.num_pages - 1
        one = BatchScheduler(full, cfg, policy, **SCHED, paged=True, device=dev)
        tick = one._step_paged_fn

        def decode_tick(*args):  # its departure over the slots in decode: the idle rows read garbage pages
            fed.rows = torch.tensor([sl.req_id is not None and sl.phase == "decode" for sl in one.slots], device=dev)
            try:
                return tick(*args)
            finally:
                fed.rows = None

        one._step_paged_fn = decode_tick
        with CodeRelay(feed=relay) as fed:
            replay = run_mix(one, reqs, force=got[0])
        per_request = [[torch.stack(tap.rows[i]) for i in tap.ids] for tap in (got[1], replay[1])]
        ok = witness_hold(f"sched paged tp=2 ({cfg.num_layers} layers, request by request)", *per_request, fed.departure) and ok
        ok = ok and replay[0] == got[0]
        del one
    del sched, local, relay
    return ok


def dp_paged_scheduler_run(dev, full, cfg, policy, lead) -> bool:
    """(a) phase 4's 16-request mix at tp = 1 x dp = 2 (fused_tick=0): the
    paged scheduler, a pool partition a data rank (each rank's device pool
    its own partition, the tables localized), against the dense scheduler
    of the same world over the decisive steps; every partition drained to
    its garbage page."""
    dmesh = process_mesh(1, 2)
    reqs = sched_requests(cfg.vocab_size)
    dense = run_mix(BatchScheduler(full, cfg, policy, **SCHED, mesh=dmesh), reqs)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    sched = BatchScheduler(full, cfg, policy, **SCHED, paged=True, mesh=dmesh)
    got = run_mix(sched, reqs)
    TP_COUNTS.append(launch_counts())
    pool = sched.pool
    free = [pool.free_in(d) for d in range(pool.partitions)]
    drained = free == [pool.pages_per_partition - 1] * pool.partitions
    if not lead:
        return drained
    n = sum(map(len, got[0]))
    log(f"tp sched paged tp=1 dp=2 ({cfg.num_layers} layers, 16 requests, fused_tick=0): {n} tokens in "
        f"{time.perf_counter() - t0:.1f}s, mean_ms_per_decode_tick={statistics.mean(sched.tick_s) * 1e3:.1f} (two "
        f"ranks on one card over gloo); pool {pool.num_pages} pages in {pool.partitions} partitions, free after "
        f"{free} of {pool.pages_per_partition - 1} each")
    held = stream_hold("tp sched paged dp=2 vs dense dp=2", dense[0], got[0], dense[1].at(dense[1].ids),
                       got[1].at(got[1].ids))
    return held and drained


def tp_http(mesh, dev, ckpt, lead) -> bool:
    """(a) the --tp 2 export (phase 5's 4-layer HF directory through the
    exporter CLI with --tp 2), read by each rank from its rank files
    (load_packed_sharded); a direct tp = 2 scheduler run over 4 requests;
    then rank 0 serves the same 4 requests, concurrent, over HTTP through a
    leader ReplicatedScheduler while rank 1 follows its command log. The
    completions must equal the direct run's."""
    cfg, policy, local = load_packed_sharded(ckpt, mesh)
    reqs = http_requests(cfg.vocab_size)[:4]
    kw = dict(SCHED, paged=True, mesh=mesh)
    direct = BatchScheduler(local, cfg, policy, **kw)
    ids = [direct.add_request(p, max_new_tokens=n, eos_id=-1) for p, n in reqs]
    out = direct.run()
    want = [out[i] for i in ids]
    del direct
    sched = BatchScheduler(local, cfg, policy, **kw)
    store = torch.distributed.FileStore(os.path.join(os.path.dirname(ckpt), "replication"), mesh.tp * mesh.dp)
    if not lead:
        port = int(store.get("port"))
        ReplicatedScheduler(sched, leader=False, leader_addr=("127.0.0.1", port)).serve_forever()
        return True
    leader = ReplicatedScheduler(sched, leader=True, port=0, num_followers=1, host="127.0.0.1",
                                 announce=lambda port: store.set("port", str(port)))
    server, service, port = serve_http.serve_background(leader, model_name="flexq-llama-7b-width-tp2")
    got = [None] * len(reqs)
    try:
        def call(r):
            p, n = reqs[r]
            got[r] = http_post(port, "/v1/completions", {"prompt": p, "max_tokens": n, "temperature": 0,
                                                         "eos_id": -1})["choices"][0]["token_ids"]

        reset_launch_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=call, args=(r,)) for r in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        TP_COUNTS.append(launch_counts())
        log(f"tp http --tp 2 (4-layer 7B-width export, rank files): 4 concurrent completions in "
            f"{time.perf_counter() - t0:.1f}s through the leader, rank 1 following; equal to the direct tp = 2 run: "
            f"{got == want}")
    finally:
        service.shutdown()
        server.shutdown()
        leader.shutdown()
    return got == want


def tp_rank(rank: int, workdir: str) -> None:
    """One rank of phase 10 (a) (``chip_smoke.py --tp-rank r workdir``): a
    gloo world of TP_RANKS processes on the one card. Writes its holds,
    seconds, peak memory and main-path launch counts to workdir/rank{r}.json."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = initialize(f"file://{os.path.join(workdir, 'store')}", TP_RANKS, rank, backend="gloo", device="cuda",
                     timeout_s=TP_TIMEOUT_S)
    mesh = process_mesh(TP_RANKS, 1)
    lead = rank == 0
    res = {"holds": {}, "seconds": {}}
    t0 = time.perf_counter()
    res["holds"]["forward parity"] = tp_slice_parity(mesh, dev, torch.Generator(device=dev).manual_seed(SEED + 1))
    res["seconds"]["forward parity"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg = ModelConfig.llama(num_layers=TP_ENGINE_LAYERS)
    flex = QuantPolicy.llama_flex()
    full = random_params(cfg, flex, torch.Generator(device=dev).manual_seed(SEED + 2), dev)  # phase 4's first layers
    res["holds"]["engine"] = tp_engine_runs(mesh, dev, full, cfg, flex, lead)
    res["seconds"]["engine"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["holds"]["scheduler"] = tp_scheduler_run(mesh, dev, full, cfg, flex, lead)
    res["seconds"]["scheduler"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["holds"]["paged dp=2"] = dp_paged_scheduler_run(dev, full, cfg, flex, lead)
    res["seconds"]["paged dp=2"] = time.perf_counter() - t0
    del full
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res["holds"]["http"] = tp_http(mesh, dev, os.path.join(workdir, "ckpt_tp2"), lead)
    res["seconds"]["http"] = time.perf_counter() - t0
    totals = {k: 0 for k in KERNELS}
    for c in TP_COUNTS:
        for k, v in c.items():
            totals[k] += v
    res["counts"] = totals
    res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    shutdown()


def tp_children(dev, gen, workdir):
    """(a): the 4-layer HF directory exported with --tp 2, then TP_RANKS
    child processes (tp_rank) on the one card; every child must exit 0
    within TP_TIMEOUT_S (else all are killed and the phase fails). Returns
    the ranks' results."""
    hf, ckpt = os.path.join(workdir, "hf"), os.path.join(workdir, "ckpt_tp2")
    os.makedirs(hf)
    write_hf_checkpoint(hf, ModelConfig.llama(num_layers=CKPT_LAYERS), gen, dev)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "flexq_tpu_torch.export.exporter", "--model-dir", hf, "--out", ckpt,
                    "--tp", str(TP_RANKS)], check=True, capture_output=True, text=True, timeout=300,
                   cwd=os.path.dirname(os.path.abspath(__file__)))
    log(f"tp exporter --tp {TP_RANKS}: {time.perf_counter() - t0:.1f}s, files {sorted(os.listdir(ckpt))[:4]}...")
    torch.cuda.empty_cache()
    return run_ranks("--tp-rank", TP_RANKS, workdir, TP_TIMEOUT_S, "phase 10")


def run_ranks(flag: str, n: int, workdir: str, timeout_s: float, phase: str):
    """``n`` child processes ``chip_smoke.py <flag> r <workdir>`` on the one
    card; every child must exit 0 within ``timeout_s`` (else all are killed
    and the phase fails). Logs their output; returns the ranks' results
    (workdir/rank{r}.json)."""
    logs = [open(os.path.join(workdir, f"rank{r}.log"), "w") for r in range(n)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), flag, str(r), workdir],
                              stdout=logs[r], stderr=subprocess.STDOUT, cwd=os.path.dirname(os.path.abspath(__file__)))
             for r in range(n)]
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    for r in range(n):
        with open(os.path.join(workdir, f"rank{r}.log")) as f:
            for line in f.read().splitlines():
                log(f"[rank {r}] {line}")
    rcs = [p.returncode for p in procs]
    if rcs != [0] * n:
        raise AssertionError(f"{phase}: a rank failed or outlived {timeout_s}s: exit codes {rcs}")
    out = []
    for r in range(n):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def nccl_one_rank(dev):
    """(b): a one-rank NCCL world in this process: the Engine's fused loop
    over forward_serve_tp on phase 4's 32-layer model, its all-reduces and
    all-gathers captured in the step graph, against phase 4's 32-token
    tokens; decode ms a step beside the single-device graph's."""
    cfg, policy = ModelConfig.llama(), QuantPolicy.llama_flex()
    params = random_params(cfg, policy, torch.Generator(device=dev).manual_seed(SEED + 2), dev)
    p32, want = PHASE4["p32"], PHASE4["out32"]
    one = Engine(params, cfg, policy, max_seq_len=2048)
    one.generate(p32, max_new_tokens=2, eos_id=-1)
    _, st1 = one.generate(p32, max_new_tokens=32, eos_id=-1, return_stats=True)
    del one
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    initialize(f"127.0.0.1:{port}", 1, 0, backend="nccl", device=dev)
    try:
        mesh = process_mesh(1, 1)
        eng = Engine(params, cfg, policy, max_seq_len=2048, mesh=mesh)
        eng.generate(p32, max_new_tokens=2, eos_id=-1)  # warm-up: the eager step, the capture
        torch.cuda.synchronize()
        reset_launch_counts()
        out, st = eng.generate(p32, max_new_tokens=32, eos_id=-1, return_stats=True)
        counts = launch_counts()
        graph = next(iter(eng._fused.values()))[1]
        log(f"tp (b) one-rank NCCL world, 32 layers, B=4, 32-token prompts, mode=fused (collectives captured in the "
            f"step graph): tokens equal phase 4's {out == want}; decode_ms_per_step={st.decode_s / 31 * 1e3:.3f} vs "
            f"the single-device graph's {st1.decode_s / 31 * 1e3:.3f} in this call; launches_per_replay="
            f"{graph.launches_per_replay}, replays={graph.replays}")
        missing = [k for k in PATH_KERNELS["32-token"] if counts[k] == 0]
        if missing:
            raise AssertionError(f"phase 10 (b): kernels of the path never launched: {missing}")
    finally:
        shutdown()
    del eng, params
    torch.cuda.empty_cache()
    return out == want, counts


def tensor_parallel(dev, gen, workdir):
    """Phase 10: (b) the one-rank NCCL world in this process, then (a) the
    two gloo ranks on the one card (their files, the HF directory among
    them, under ``workdir``). Returns the main-path launch counts of both
    (the ranks' summed)."""
    t_phase = t0 = time.perf_counter()
    ok_b, counts = nccl_one_rank(dev)
    totals = dict(counts)
    log(f"phase 10 (b) one-rank NCCL world: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    ranks = tp_children(dev, gen, workdir)
    for r, res in enumerate(ranks):
        for k, v in res["counts"].items():
            totals[k] = totals.get(k, 0) + v
        log(f"phase 10 (a) rank {r}: seconds " + " ".join(f"{k}={v:.1f}" for k, v in res["seconds"].items())
            + f"; peak_gib={res['peak_gib']:.2f}; holds {res['holds']}")
    log(f"phase 10 (a) two gloo ranks on one card: {time.perf_counter() - t0:.1f}s")
    log(f"phase 10 launches: " + " ".join(f"{k}={v}" for k, v in totals.items() if v))
    log(f"phase 10 tensor parallelism: {time.perf_counter() - t_phase:.1f}s")
    if not ok_b or not all(all(res["holds"].values()) for res in ranks):
        raise AssertionError("phase 10: a hold failed (see the tp lines)")
    return totals


# ---- phase 11: pipeline and sequence parallelism --------------------------

PP_RANKS = 2  # two ranks share the one card over gloo: pp = 2, then sp = 2
PP_TIMEOUT_S = 360  # the ranks' wall clock, the model draws and every part included
SP_GEN_LAYERS = 8  # generate_sp's depth at LLaMA-2-7B width: 32 cut to 8 for the time limit
SP_PROMPT = 2000  # generate_sp's prompt: near 2048, a multiple of the ranks
SP_NEW = 16
# generate_sp's witness: the share of K4's codes (the merged attention output) rank 0's ring of one may compute off the
# handed ones, and how far apart. Set from the card (H100 80GB HBM3, 700 W): a sound run 0.055 / 0.073 of them, 1 / 2 apart (bf16 / int8
# prompt cache); a merge whose MAX all-reduce is skipped 0.69, 35 apart.
SP_K4_OFF = 0.2
SP_K4_APART = 4
PP_COUNTS = []  # the launch counts of each phase 11 main-path run in this process
PP_HTTP_REQ = 0  # the index of the http_requests request served over HTTP by the --pp 2 pair


def stage_layers(cfg: ModelConfig, mesh) -> range:
    n = cfg.num_layers // mesh.pp
    return range(mesh.stage * n, (mesh.stage + 1) * n)


def counted(label, path, fn):
    """``fn()`` with the launch counts zeroed just before and read just after
    (kept in PP_COUNTS); every kernel of ``path`` must have launched (on
    the card). Returns (fn's result, seconds)."""
    sync()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    sync()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    PP_COUNTS.append(counts)
    missing = [k for k in PATH_KERNELS[path] if counts[k] == 0]
    if torch.cuda.is_available() and missing:
        raise AssertionError(f"{label}: kernels of the path never launched: {missing}")
    return out, secs


def pp_engine_runs(pm, dev, ph4, lead) -> bool:
    """(a) pp = 2 on phase 4's 32-layer LLaMA-2-7B model, each rank drawing
    only its 16 layers (the others' draws skipped) and the embedding and
    head: Engine.generate at B = 4 over phase 4's 32-token prompts (W*Ax
    prefill), 32 new tokens, over a bf16 cache (tokens equal to phase 4's,
    the prompts' last logits bit-equal to phase 4's single-device prefill),
    over an int8 cache (phase 4's int8 tokens) and sampled under phase 6's
    parameters and seed (phase 6's step-mode tokens)."""
    cfg, flex = ModelConfig.llama(), QuantPolicy.llama_flex()
    t0 = time.perf_counter()
    local = random_params(cfg, flex, torch.Generator(device=dev).manual_seed(SEED + 2), dev,
                          keep=stage_layers(cfg, pm))
    sync()
    if lead:
        log(f"pp: stage {pm.stage}'s {len(local['layers'])} of phase 4's {cfg.num_layers} layers drawn and quantized "
            f"in {time.perf_counter() - t0:.1f}s")
    p32 = ph4["p32"]
    eng = Engine(local, cfg, flex, max_seq_len=2048, pp_mesh=pm)
    eng.generate(p32, max_new_tokens=2, eos_id=-1)  # warm-up
    logits = eng.prefill_prompts(p32.tolist(), eng.new_cache(len(p32)))[0].cpu()
    (out, stats), secs = counted("pp engine bf16", "pp 32-token", lambda: eng.generate(
        p32, max_new_tokens=32, eos_id=-1, return_stats=True))
    eng8 = Engine(local, cfg, flex, max_seq_len=2048, kv_dtype=torch.int8, pp_mesh=pm)
    out8, secs8 = counted("pp engine int8", "pp 32-token", lambda: eng8.generate(p32, max_new_tokens=32, eos_id=-1))
    sampled, secs_s = counted("pp engine sampled", "pp 32-token", lambda: eng.generate(
        p32, max_new_tokens=32, sampling=SAMPLED, eos_id=-1, seed=1))
    del eng, eng8, local
    torch.cuda.empty_cache()
    bit_equal = torch.equal(logits, ph4["logits32"])
    ok = bit_equal and out == ph4["out32"] and out8 == ph4["out32_int8"] and sampled == ph4["sampled32"]
    if lead:
        ms = sum(stats.step_times_s) / len(stats.step_times_s) * 1e3
        gap = (logits.float() - ph4["logits32"].float()).abs().max().item()
        log(f"pp engine pp=2 ({cfg.num_layers} layers, {cfg.num_layers // pm.pp} a rank, B=4, 32-token prompts, 32 "
            f"new, mode=step, two ranks sharing one card over gloo): ttft_ms={stats.ttft_s * 1e3:.1f} decode_ms_per_step={ms:.2f} ({secs:.1f}s); prompts' "
            f"last logits bit-equal to phase 4's: {bit_equal} (max |d| {gap:.3g}); tokens equal to phase 4's: "
            f"{out == ph4['out32']}; int8 cache equal to phase 4's int8 run: {out8 == ph4['out32_int8']} "
            f"({secs8:.1f}s); sampled (phase 6's parameters, seed 1) equal to phase 6's step run: "
            f"{sampled == ph4['sampled32']} ({secs_s:.1f}s)")
    return ok


def pp_scheduler_run(pm, dev, ph4, lead) -> bool:
    """(a) phase 4's 16-request mix through BatchScheduler(pp_mesh=) on the
    32-layer model (dense bf16 cache, fused_tick=0; every prompt through the
    W*Ax layer, as the reference's pipeline runs it), held over the decisive
    steps against phase 4's dense run, whose prompts of 64 tokens and more
    took the W*A16 prefill."""
    cfg, flex = ModelConfig.llama(), QuantPolicy.llama_flex()
    local = random_params(cfg, flex, torch.Generator(device=dev).manual_seed(SEED + 2), dev,
                          keep=stage_layers(cfg, pm))
    reqs = sched_requests(cfg.vocab_size)
    sched = BatchScheduler(local, cfg, flex, **SCHED, pp_mesh=pm)
    (got, tap), secs = counted("pp scheduler", "pp scheduler", lambda: run_mix(sched, reqs))
    ok = all(len(t) == n for t, (_, n) in zip(got, reqs))
    if lead:
        want, want_logits = ph4["sched_dense"]
        n = sum(map(len, got))
        log(f"pp sched pp=2 dense ({cfg.num_layers} layers, 16 requests, fused_tick=0, W*Ax prompts): {n} tokens in {secs:.1f}s, "
            f"mean_ms_per_decode_tick={statistics.mean(sched.tick_s) * 1e3:.1f} (two ranks on one card over gloo)")
        ok = stream_hold("pp sched pp=2 vs phase 4's dense run", want, got, lambda r, i: want_logits[r][i],
                         lambda r, i: tap.rows[tap.ids[r]][i].cpu()) and ok
    del sched, local
    torch.cuda.empty_cache()
    return ok


def pp_opt_parity(pm, dev, lead) -> bool:
    """(a) OPT-6.7B's widths, 2 layers, opt_flex, pp = 2 (a layer a rank)
    against one device, both on the card: a 16-token W*Ax prompt, then 2
    decode steps, B = 2; rank 0 also runs the whole model. The hop passes
    the hidden state unchanged, so the logits are held equal."""
    ocfg, opt = ModelConfig.opt(**dict(OPT_67B, num_layers=2)), QuantPolicy.opt_flex()
    local = random_opt_params(ocfg, opt, torch.Generator(device=dev).manual_seed(SEED + 11), dev,
                              keep=stage_layers(ocfg, pm))
    full = random_opt_params(ocfg, opt, torch.Generator(device=dev).manual_seed(SEED + 11), dev) if lead else None
    b, s = 2, 256
    cache = shard_cache_pp(pm, *dense_cache(ocfg, b, s, torch.bfloat16, dev))
    whole = dense_cache(ocfg, b, s, torch.bfloat16, dev) if lead else None
    ids = torch.as_tensor(np.random.default_rng(SEED).integers(0, ocfg.vocab_size, (b, 16)), device=dev)
    pos, equal, worst = 0, True, 0.0
    for step in range(3):
        logits, _ = serve_step_pp(local, ocfg, opt, ids, pm, cache, pos)
        if lead:
            want, _ = forward_serve(full, ocfg, opt, ids, kv_k=whole[0], kv_v=whole[1], cache_pos=pos, device=dev,
                                    positions=pos + torch.arange(ids.shape[1], device=dev).expand(b, -1))
            equal = equal and torch.equal(logits, want)
            worst = max(worst, ((logits.float() - want.float()).abs().max() / want.float().abs().max()).item())
        pos += ids.shape[1]
        ids = logits[:, -1].argmax(-1)[:, None]
    if lead:
        log(f"pp parity OPT opt_flex (2 layers at OPT-6.7B width, pp=2 vs one device, both on the card): 16-token "
            f"prompt and 2 decode steps, logits equal {equal} (max |dlogit|/max|logit| {worst:.3g})")
    del local, full
    return equal


def pp_direct_http_run(pm, ckpt):
    """The direct pp = 2 run the --pp 2 HTTP pair is held to: the packed
    4-layer checkpoint, each stage its 2 layers, the HTTP CLI's scheduler
    (8 slots, max_seq_len 2048, dense bf16, fused_tick=0), one request."""
    cfg, policy, tree = load_packed(ckpt, device="cpu")
    sched = BatchScheduler(tree, cfg, policy, num_slots=8, max_seq_len=2048, pp_mesh=pm)
    p, n = http_requests(cfg.vocab_size)[PP_HTTP_REQ]
    rid = sched.add_request(p, max_new_tokens=n, eos_id=-1)
    return sched.run()[rid]


def sp_slice_parity(sm, dev, lead) -> bool:
    """(b) sp = 2 at LLaMA-2-7B width, 2 layers, llama_flex: sp_prefill of a
    128-token prompt (B = 2; the W6A16 GEMMs a projection at a time, ring
    attention) and 2 sp_decode_steps (the W6Ax layer, the attention merged
    over the ring) against the single-device forward_serve (the W6A16
    prefill, then the W6Ax decode over a bf16 cache), both on the card, at
    phase 3's bounds of max |logit|: the prompt's logits 2e-2, the decode
    steps after a W6A16 prefill 1e-1 (the prefills' K / V part by bf16
    ulps: the single-device q / k take K7's RoPE epilogue on the f32
    accumulator, the sp prefill RoPE on the rounded output, as the
    reference's sp prefill does; a ulp flips 6-bit codes downstream). Every
    rank holds the whole model."""
    cfg, flex = ModelConfig.llama(num_layers=2), QuantPolicy.llama_flex()
    params = random_params(cfg, flex, torch.Generator(device=dev).manual_seed(SEED + 12), dev)
    b, l = 2, 128
    ids = torch.as_tensor(np.random.default_rng(SEED).integers(0, cfg.vocab_size, (b, l)), device=dev)
    logits, pc = sp_prefill(params, cfg, flex, ids, sm)
    tail = (cfg.num_layers, b, cfg.num_kv_heads, 2, cfg.head_dim)
    tk, tv = (torch.zeros(tail, dtype=torch.bfloat16, device=dev) for _ in "kv")
    got = [logits]
    for t in range(2):
        tok = got[-1].argmax(-1)[:, None]
        logits, tk, tv = sp_decode_step(params, cfg, flex, tok, sm, pc, tk, tv, t, l)
        got.append(logits)
    if not lead:
        return True
    c = dense_cache(cfg, b, 256, torch.bfloat16, dev)
    want = [forward_serve(params, cfg, flex, ids, kv_k=c[0], kv_v=c[1], cache_pos=0, prefill_bf16=True,
                          last_only=True, device=dev)[0][:, -1]]
    for t in range(2):
        tok = got[t].argmax(-1)[:, None]  # the sp run's tokens, fed to both
        want.append(forward_serve(params, cfg, flex, tok, kv_k=c[0], kv_v=c[1], cache_pos=l + t, device=dev,
                                  positions=torch.full((b, 1), l + t, device=dev))[0][:, 0])
    ok = True
    for step, (g, w) in enumerate(zip(got, want)):
        worst = ((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
        agree = int((g.argmax(-1) == w.argmax(-1)).sum())
        tol = 2e-2 if step == 0 else 1e-1
        log(f"sp parity llama_flex (2 layers, 7B width, sp=2 vs one device, both on the card), "
            f"{'128-token prompt' if step == 0 else f'decode step {step}'}: max |dlogit|/max|logit| = {worst:.3g} "
            f"(tolerance {tol:g}), argmax equal {agree}/{b}")
        ok = ok and worst <= tol
    return ok


class SpRelay:
    """generate_sp's code witness: while open, each activation producer that
    parallel/sp_serve.py calls (the decode layer's K1, K4, K5) keeps its
    codes and scales in call order; with ``feed`` (such a relay) it hands
    those on in place of its own, in order, and counts per producer how
    far its own codes part from them (entries off, entries, most apart).
    K4's input is the attention output, the one input of a decode layer
    that the ring's merge computes."""

    NAMES = ("rmsnorm_quant", "quant_act", "glu_quant")

    def __init__(self, feed=None):
        self.feed, self.calls = feed, []
        self.off = {n: [0, 0, 0] for n in self.NAMES}

    def __enter__(self):
        self.saved = {n: getattr(sp_serve, n) for n in self.NAMES}
        for n, fn in self.saved.items():
            setattr(sp_serve, n, self._wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(sp_serve, n, fn)

    def _wrap(self, name, fn):
        def producer(*args, **kw):
            out = fn(*args, **kw)
            if self.feed is None:
                self.calls.append((name, out[0], out[1]))
                return out
            want, q, sc = self.feed.calls[len(self.calls)]
            if want != name:
                raise AssertionError(f"sp relay: call {len(self.calls)} is {name}, the relay's {want}")
            self.calls.append((name, q, sc))
            d = (out[0].int() - q.int()).abs()
            off = self.off[name]
            off[0] += int((d > 0).sum())
            off[1] += d.numel()
            off[2] = max(off[2], int(d.max()))
            return (q, sc) + tuple(out[2:])

        return producer

    def __str__(self):
        return "; ".join(f"{n} codes {o[0]}/{o[1]} = {o[0] / max(o[1], 1):.3g} off, most {o[2]} apart"
                         for n, o in self.off.items())


def sp_generate_runs(sm, dev, lead) -> bool:
    """(b) generate_sp at SP_GEN_LAYERS layers of LLaMA-2-7B width, B = 1,
    a SP_PROMPT-token prompt (SP_PROMPT / 2 rows a rank at the prefill),
    SP_NEW new tokens, over a bf16 and an int8 prompt cache, held against
    rank 0's own single-device run of the same path (a ring of one): the
    prompt's logits within phase 3's 2e-2 of max |logit| (the W*A16
    prefill: the split, the ring and the f32 sums' order part the two),
    then its decode steps fed the sp = 2 run's tokens with its activation
    codes handed on (SpRelay), each step within 2e-2 and its argmax equal,
    and the one rank's own codes off the handed ones: K1's and K5's none
    (their inputs follow from handed codes), K4's (the merged attention
    output over the prompt cache the two prefills wrote, which part by
    bf16 ulps) within SP_K4_OFF of the entries and SP_K4_APART codes. At 8
    random layers the two runs' own streams part within a few tokens at
    near-ties (one bf16 ulp cascades through flipped 6-bit codes, as at
    tp = 2), which leaves too few decisive steps to hold the streams; those
    are logged, and so is the single-device Engine over a cache of that
    dtype (the W6A16 prefill with K7's RoPE epilogue, W6Ax decode)."""
    cfg, flex = ModelConfig.llama(num_layers=SP_GEN_LAYERS), QuantPolicy.llama_flex()
    params = random_params(cfg, flex, torch.Generator(device=dev).manual_seed(SEED + 13), dev)
    prompt = np.random.default_rng(SEED + 13).integers(0, cfg.vocab_size, (1, SP_PROMPT))
    solo = torch.distributed.new_group([0])  # every rank makes it: rank 0's ring of one
    ok = True
    for kvd, name in ((torch.bfloat16, "bf16"), (torch.int8, "int8")):
        with SpRelay() as relay:
            (toks, logs), secs = counted(f"sp generate {name}", "sp", lambda: generate_sp(
                params, cfg, flex, prompt, sm, SP_NEW, return_logits=True, kv_dtype=kvd))
        if not lead:
            continue
        t0 = time.perf_counter()
        mine = SeqMesh(sp=1, rank=0, device=dev, backend=sm.backend, group=solo)
        own, own_logs = generate_sp(params, cfg, flex, prompt, mine, SP_NEW, return_logits=True, kv_dtype=kvd)
        logits, pc = sp_prefill(params, cfg, flex, prompt, mine, kv_dtype=kvd)
        tail = (cfg.num_layers, 1, cfg.num_kv_heads, SP_NEW, cfg.head_dim)
        tk, tv = (torch.zeros(tail, dtype=torch.bfloat16, device=dev) for _ in "kv")
        steps = [logits]
        with SpRelay(feed=relay) as fed:
            for t in range(SP_NEW - 1):
                tok = torch.as_tensor(toks[:, t : t + 1], device=dev)
                logits, tk, tv = sp_decode_step(params, cfg, flex, tok, mine, pc, tk, tv, t, SP_PROMPT)
                steps.append(logits)
        secs1 = time.perf_counter() - t0
        gaps = [rel_gap(torch.from_numpy(logs[:, i]), st.float().cpu()) for i, st in enumerate(steps)]
        agree = sum(int(st.argmax(-1).cpu() == torch.from_numpy(logs[:, i]).argmax(-1)) for i, st in enumerate(steps))
        held = gaps[0] <= 2e-2 and max(gaps[1:]) <= 2e-2 and agree == len(steps)
        k4 = fed.off["quant_act"]
        held = (held and all(fed.off[n][0] == 0 for n in ("rmsnorm_quant", "glu_quant"))
                and k4[0] <= SP_K4_OFF * k4[1] and k4[2] <= SP_K4_APART)
        one = Engine(params, cfg, flex, max_seq_len=2048, kv_dtype=kvd)
        with LogitTap(one) as tap:
            want, stats = one.generate(prompt, max_new_tokens=SP_NEW, eos_id=-1, mode="step", return_stats=True)
        del one
        log(f"sp generate_sp sp=2 ({cfg.num_layers} layers, 7B width, B=1, {SP_PROMPT}-token prompt, {SP_NEW} new, "
            f"{name} prompt cache, two ranks sharing one card over gloo): {secs:.1f}s, "
            f"{secs / SP_NEW * 1e3:.1f} ms a token with the prefill; rank 0's ring of one {secs1:.1f}s for its run and "
            f"the witness; the single-device Engine's ttft_ms={stats.ttft_s * 1e3:.1f} decode_ms_per_step="
            f"{sum(stats.step_times_s) / len(stats.step_times_s) * 1e3:.2f}")
        log(f"sp witness generate {name} (sp=2 vs rank 0's ring of one): the prompt's logits {gaps[0]:.3g} of max "
            f"|logit| (tolerance 2e-2); the decode steps with sp=2's tokens and codes handed on: most "
            f"{max(gaps[1:]):.3g} (tolerance 2e-2), argmax equal {agree}/{len(steps)}; the one rank's own codes off "
            f"the handed ones (K1, K5 held at none; K4 at most {SP_K4_OFF:g} of the entries, {SP_K4_APART} codes "
            f"apart): {fed}")
        got_at = lambda r, i: torch.from_numpy(logs[r, i])  # noqa: E731
        stream_hold(f"sp generate {name} sp=2 vs rank 0's ring of one, free-running (logged)", own.tolist(),
                    toks.tolist(), lambda r, i: torch.from_numpy(own_logs[r, i]), got_at)
        stream_hold(f"sp generate {name} sp=2 vs the single-device Engine (logged)", want, toks.tolist(),
                    lambda r, i: tap.at(r, i).float().cpu(), got_at)
        ok = ok and held
    return ok


def sp_forward_parity(sm, dev, lead) -> bool:
    """(b) forward_sp, the dense f32 forward with the sequence split over
    the ring, on the 2-layer model at 7B width (512 tokens, B = 1) against
    the dense forward, both on the card, within 1e-3 of max |logit|."""
    cfg = ModelConfig.llama(num_layers=2)
    dense = random_weights(cfg, torch.Generator(device=dev).manual_seed(SEED + 14), dev)
    ids = torch.as_tensor(np.random.default_rng(SEED).integers(0, cfg.vocab_size, (1, 512)), device=dev)
    got = forward_sp(dense, cfg, ids, sm)
    if not lead:
        return True
    want = dense_forward(dense, cfg, ids)
    worst = ((got - want).abs().max() / want.abs().max()).item()
    log(f"sp forward_sp (2 dense f32 layers at 7B width, 512 tokens, sp=2 vs the dense forward, TF32 off): "
        f"max |dlogit|/max|logit| = {worst:.3g} (tolerance 1e-3), argmax equal "
        f"{int((got.argmax(-1) == want.argmax(-1)).sum())}/512")
    return worst <= 1e-3


def pp_rank(rank: int, workdir: str) -> None:
    """One rank of phase 11 (``chip_smoke.py --pp-rank r workdir``): a gloo
    world of PP_RANKS processes on the one card, first a pipeline (pp = 2),
    then a sequence ring (sp = 2) over the same world. Writes its holds,
    seconds, peak memory and main-path launch counts to
    workdir/rank{r}.json, and rank 0 the direct run of the HTTP request."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = initialize(f"file://{os.path.join(workdir, 'store')}", PP_RANKS, rank, backend="gloo", device="cuda",
                     timeout_s=PP_TIMEOUT_S)
    lead = rank == 0
    ph4 = torch.load(os.path.join(workdir, "phase4.pt"), weights_only=False)
    res = {"holds": {}, "seconds": {}}
    pm = make_pipe_mesh(PP_RANKS)
    sm = make_sp_mesh(PP_RANKS)
    parts = (("pp engine", lambda: pp_engine_runs(pm, dev, ph4, lead)),
             ("pp scheduler", lambda: pp_scheduler_run(pm, dev, ph4, lead)),
             ("pp OPT parity", lambda: pp_opt_parity(pm, dev, lead)),
             ("sp parity", lambda: sp_slice_parity(sm, dev, lead)),
             ("sp generate", lambda: sp_generate_runs(sm, dev, lead)),
             ("sp forward", lambda: sp_forward_parity(sm, dev, lead)))
    for name, fn in parts:
        t0 = time.perf_counter()
        res["holds"][name] = fn()
        res["seconds"][name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    res["http_direct"] = pp_direct_http_run(pm, os.path.join(workdir, "ckpt"))
    totals = {k: 0 for k in KERNELS}
    for c in PP_COUNTS:
        for k, v in c.items():
            totals[k] += v
    res["counts"] = totals
    res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    shutdown()


def pp_http(workdir, want) -> bool:
    """(a) ``python -m flexq_tpu_torch.serve.http --pp 2`` over the packed
    4-layer checkpoint, a leader and a follower process on the one card
    (gloo, a file:// rendezvous): one completion, equal to the ranks'
    direct pp = 2 run; SIGINT to the leader stops both."""
    ckpt = os.path.join(workdir, "ckpt")
    p, n = http_requests(ModelConfig.llama().vocab_size)[PP_HTTP_REQ]  # the HF directory's vocabulary
    args = ["-m", "flexq_tpu_torch.serve.http", "--checkpoint", ckpt, "--pp", str(PP_RANKS), "--backend", "gloo",
            "--coordinator", f"file://{os.path.join(workdir, 'http_store')}", "--num-processes", str(PP_RANKS),
            "--replication-port", "0", "--slots", "8", "--max-seq-len", "2048", "--host", "127.0.0.1", "--port", "0"]
    t0 = time.perf_counter()
    with Proc(args + ["--process-id", "0"]) as lead, Proc(args + ["--process-id", "1"]) as follower:
        line = lead.wait_for("serving on", 300)
        port = int(line.split(":")[1].split()[0])
        t1 = time.perf_counter()
        got = http_post(port, "/v1/completions", {"prompt": p, "max_tokens": n, "temperature": 0,
                                                  "eos_id": -1})["choices"][0]["token_ids"]
        t_req = time.perf_counter() - t1
        lead.p.send_signal(signal.SIGINT)
        rcs = [lead.p.wait(120), follower.p.wait(120)]
    log(f"pp http --pp 2 (4-layer 7B-width packed checkpoint, leader and follower on one card over gloo): started "
        f"in {t1 - t0:.1f}s, one {len(p)}-token completion of {n} tokens in {t_req:.2f}s, equal to the direct pp = 2 "
        f"run: {got == want}; exit codes after SIGINT {rcs}")
    return got == want and rcs == [0, 0]


def pipeline_and_sequence(dev, workdir):
    """Phase 11: phase 10's 4-layer HF directory exported (tp = 1) by the
    exporter's CLI, phase 4's prompts, tokens and logits written for the
    ranks, PP_RANKS child processes (pp_rank) on the one card, then the
    --pp 2 HTTP pair. Returns the ranks' main-path launch counts, summed."""
    t_phase = time.perf_counter()
    pdir = os.path.join(workdir, "pp")
    os.makedirs(pdir)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "flexq_tpu_torch.export.exporter", "--model-dir",
                    os.path.join(workdir, "hf"), "--out", os.path.join(pdir, "ckpt")], check=True,
                   capture_output=True, text=True, timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)))
    log(f"pp exporter (tp = 1): {time.perf_counter() - t0:.1f}s")
    torch.save(PHASE4, os.path.join(pdir, "phase4.pt"))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks("--pp-rank", PP_RANKS, pdir, PP_TIMEOUT_S, "phase 11")
    totals = {}
    for r, res in enumerate(ranks):
        for k, v in res["counts"].items():
            totals[k] = totals.get(k, 0) + v
        log(f"phase 11 rank {r}: seconds " + " ".join(f"{k}={v:.1f}" for k, v in res["seconds"].items())
            + f"; peak_gib={res['peak_gib']:.2f}; holds {res['holds']}")
    log(f"phase 11 two gloo ranks on one card: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    http_ok = pp_http(pdir, ranks[0]["http_direct"])
    log(f"phase 11 --pp 2 HTTP pair: {time.perf_counter() - t0:.1f}s")
    log(f"phase 11 launches: " + " ".join(f"{k}={v}" for k, v in totals.items() if v))
    log(f"phase 11 pipeline and sequence parallelism: {time.perf_counter() - t_phase:.1f}s")
    if not http_ok or not all(all(res["holds"].values()) for res in ranks):
        raise AssertionError("phase 11: a hold failed (see the pp and sp lines)")
    return totals


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--tp-rank":  # one rank of phase 10 (a), started by tp_children
        tp_rank(int(sys.argv[2]), sys.argv[3])
        return 0
    if len(sys.argv) == 4 and sys.argv[1] == "--pp-rank":  # one rank of phase 11, started by pipeline_and_sequence
        pp_rank(int(sys.argv[2]), sys.argv[3])
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"device: {kind} count={torch.cuda.device_count()} torch={torch.__version__} cuda={torch.version.cuda}")
    log(smi)
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: nvcc of {len(_build.SOURCES)} CUDA sources in parallel {time.perf_counter() - t0:.1f}s")
    log_kernel_attributes()

    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {}
    t_start = t0 = time.perf_counter()
    check_producers(results, dev, gen)
    check_int_gemms(results, dev, gen)
    check_wa16(results, dev, gen)
    check_attention(results, dev, gen)
    check_paged_attention(results, dev, gen)
    # the attention cases off the main path draw from their own generators,
    # so the cases above keep their inputs
    gen_attn = torch.Generator(device=dev).manual_seed(SEED + 5)
    check_prefill_cases(results, dev, gen_attn)
    check_paged_cases(results, dev, gen_attn)
    check_decode_cases(results, dev, torch.Generator(device=dev).manual_seed(SEED + 6))
    t1 = time.perf_counter()
    check_parallel_shapes(results, dev, torch.Generator(device=dev).manual_seed(SEED + 7))
    log(f"kernels at the tp = 2 shard shapes and the gate model's: {time.perf_counter() - t1:.1f}s")
    log(f"kernels vs plain: all within tolerance ({time.perf_counter() - t0:.1f}s)")
    torch.cuda.empty_cache()  # free bench_fn's 1 GiB flush buffer before the model phases measure peak memory

    # each model phase draws its weights from its own seeded generator, so
    # adding a kernel check above never changes the models below
    t0 = time.perf_counter()
    parity_ok = slice_parity(dev, torch.Generator(device=dev).manual_seed(SEED + 1))
    log(f"phase 3 slice parity: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    counts, modes_s, graph_s = end_to_end(dev, torch.Generator(device=dev).manual_seed(SEED + 2))
    log(f"phase 4 end to end, LLaMA-2-7B: {time.perf_counter() - t0 - modes_s - graph_s:.1f}s (phase 6's "
        f"{modes_s:.1f}s and phase 7's {graph_s:.1f}s apart)")
    t0 = time.perf_counter()
    opt_counts, opt_graph_s = opt_end_to_end(dev, torch.Generator(device=dev).manual_seed(SEED + 4))
    for k, v in opt_counts.items():
        counts[k] += v
    log(f"phase 4 end to end, OPT-6.7B: {time.perf_counter() - t0 - opt_graph_s:.1f}s (phase 7's {opt_graph_s:.1f}s "
        f"apart); phase 7 in all {graph_s + opt_graph_s:.1f}s")
    log_by_m()
    with tempfile.TemporaryDirectory(prefix="flexq_ckpt_") as workdir:
        t0 = time.perf_counter()
        for k, v in checkpoint_and_http(dev, torch.Generator(device=dev).manual_seed(SEED + 10),
                                        workdir=workdir).items():
            counts[k] += v
        log(f"phase 5 checkpoint and HTTP: {time.perf_counter() - t0:.1f}s")
        for k, v in quantize_and_evaluate(dev, workdir).items():  # phase 8, after the earlier models are freed
            counts[k] += v
    for k, v in train_and_gate(dev).items():  # phase 9, after phase 8 has freed its models
        counts[k] += v
    with tempfile.TemporaryDirectory(prefix="flexq_par_") as workdir:
        for k, v in tensor_parallel(dev, torch.Generator(device=dev).manual_seed(SEED + 10), workdir).items():
            counts[k] += v  # phase 10
        for k, v in pipeline_and_sequence(dev, workdir).items():  # phase 11, on phase 10's HF directory
            counts[k] += v
    log(f"whole script after the build {time.perf_counter() - t_start:.1f}s")
    missing = [n for n, c in counts.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    if not parity_ok:
        raise AssertionError("slice parity failed (see the slice parity lines)")

    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        r = results[name]
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": counts[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "bf16_dense_ms": r["bf16_dense_ms"],
            "yardstick_ms": r["yardstick_ms"], "shape": r["shape"], "also": r["also"],
        })
        if name in BY_M:
            kernels[-1]["launches_by_m"] = by_m_bins(name)
        if name in PRODUCERS + OPT_PRODUCERS:
            kernels[-1]["launch_floor_ms"] = LAUNCH_FLOOR["ms"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
