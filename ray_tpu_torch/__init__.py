"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's device paths.

The package mirrors ``ray_tpu``'s module paths (``ray_tpu_torch/ops/attention.py``
is the port of ``ray_tpu/ops/attention.py``) and is held against it in the
``tests/test_torch_*.py`` suite. It imports ``torch`` only: never ``jax`` and
nothing of ``ray_tpu``.

What it covers so far: GPT-2 and Llama serving through
:class:`ray_tpu_torch.llm.engine.LLMEngine` (dense and paged KV caches,
speculative decoding, the reference's serving telemetry) and
:func:`ray_tpu_torch.llm.build_llm_processor`, and one-GPU training through
:mod:`ray_tpu_torch.train.spmd`, with the causal flash-attention forward and
backward as hand-written CUDA kernels for Hopper (``ops/csrc/``).

Importing the package builds nothing; a kernel is compiled with ``nvcc`` the
first time a CUDA tensor reaches it (:mod:`ray_tpu_torch.ops._build`).
"""
