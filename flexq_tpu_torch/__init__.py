"""flexq_tpu_torch: the PyTorch / CUDA port of flexq_tpu for one NVIDIA H100.

The JAX package ``flexq_tpu`` is the reference; every module here has a
counterpart of the same name there and is held against it by the tests in
``tests/test_torch_*.py``. This package imports ``torch`` and never ``jax``
or ``flexq_tpu``. Kernels are hand-written for Hopper (``csrc/*.cu``, built
with nvcc) and are built the first time they are
launched, so importing the package needs neither a GPU nor a compiler.

It serves a LLaMA or a pre-LN OPT through greedy ``Engine.generate`` with a
dense bf16 or int8 KV cache, or through the continuous-batching
``BatchScheduler`` with a dense cache or a paged pool (bf16 or int8, chunked
admission, preemption, prefix reuse, sampling and logprobs), under
``QuantPolicy.llama_flex()`` (W6 weights, A6 activations, A8 into
down_proj), ``QuantPolicy.opt_flex()`` (W6 weights, A8 into q/k/v, A6
elsewhere), ``QuantPolicy.uniform`` (W4A8, W8A8) or
``QuantPolicy.weight_only`` (W4/W6/W8 A16), optionally with a packed
lm_head (``with_head``). Checkpoints in the exporter's packed format load
with ``export.exporter.load_packed`` (and are written by its CLI); the
OpenAI-compatible HTTP server is ``python -m flexq_tpu_torch.serve.http``,
and ``bindings.FlexQCausalLM`` gives a torch-tensor forward / generate.

The quantize-and-evaluate path (the reference's PTQ harness) is
``python -m flexq_tpu_torch.main``: the dense fake-quant models
(``models.llama`` / ``models.opt``: ``forward``, ``fake_quant_weights``),
perplexity and zero-shot scoring (``eval``), SmoothQuant folds
(``quant.smooth``) and the sensitivity analysis (``quant.sensitivity``).
"""
