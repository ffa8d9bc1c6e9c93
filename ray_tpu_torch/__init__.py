"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's device paths.

The package mirrors ``ray_tpu``'s module paths (``ray_tpu_torch/ops/attention.py``
is the port of ``ray_tpu/ops/attention.py``) and is held against it in the
``tests/test_torch_*.py`` suite. It imports ``torch`` only: never ``jax`` and
nothing of ``ray_tpu``.

What it covers so far: dense-KV GPT-2 serving through
:class:`ray_tpu_torch.llm.engine.LLMEngine`, with the causal flash-attention
forward as a hand-written CUDA kernel for Hopper (``ops/csrc/flash_fwd.cu``).

Importing the package builds nothing; a kernel is compiled with ``nvcc`` the
first time a CUDA tensor reaches it (:mod:`ray_tpu_torch.ops._build`).
"""
