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

It also carries the reference's core runtime (:mod:`ray_tpu_torch.core`:
tasks, actors, owned objects, the GCS, the node manager and its worker
processes), so ``import ray_tpu_torch; ray_tpu_torch.init()`` and
``@ray_tpu_torch.remote(num_gpus=1)`` run work on the card in a worker
process. A node advertises its visible CUDA cards as the ``GPU`` resource;
a CUDA tensor put into the object store, or returned by a task, arrives as
a host tensor with its dtype, shape and bits, unless its process turned on
device objects (:mod:`ray_tpu_torch.experimental`), which keep it on its
card and hand it over the transfer fabric. On that runtime sit the train
tier (:mod:`ray_tpu_torch.train`), the serve tier
(:mod:`ray_tpu_torch.serve`) and the data tier
(:mod:`ray_tpu_torch.data`), which feeds both.

Importing the package builds nothing and starts nothing: the runtime's
symbols load on first use, and a kernel is compiled with ``nvcc`` the first
time a CUDA tensor reaches it (:mod:`ray_tpu_torch.ops._build`).
"""

_CORE_API = (
    "init",
    "shutdown",
    "is_initialized",
    "remote",
    "get",
    "put",
    "wait",
    "kill",
    "cancel",
    "get_actor",
    "method",
    "nodes",
    "drain_node",
    "cluster_resources",
    "available_resources",
    "get_runtime_context",
    "transport_stats",
    "ObjectRef",
    "ObjectRefGenerator",
    "ActorHandle",
)

__all__ = list(_CORE_API)


def __getattr__(name):
    if name in _CORE_API:
        from ray_tpu_torch.core import api as _api

        return getattr(_api, name)
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_CORE_API))
