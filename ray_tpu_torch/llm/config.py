"""LLM tier configuration. Port of ``ray_tpu/llm/config.py``.

The config holds only the fields the port's engine reads: the model (a
``GPT2Config`` or a ``LlamaConfig``), the serving shape, the KV cache (the
paged pool by default, as in the reference: ``kv_block_size=16`` and
``num_kv_blocks``; 0 selects the dense per-slot cache), weights, prefix
caching, chunked prefill and speculative decoding (``spec_decode_tokens``
with a draft model), and the model id that the batch entry point's engine
cache keys on, and the tensor-parallel degree (``tensor_parallelism``: the
engine is then one rank of an SPMD group; see
:class:`~ray_tpu_torch.llm.engine.LLMEngine`), and ``placement``, the
resources each serve replica actor demands (``build_openai_app`` passes
it as the deployment's ``ray_actor_options``; ``{"num_gpus": 1}`` puts a
replica on a card of the port's runtime).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass
class SamplingParams:
    max_tokens: int = 32
    temperature: float = 0.0  # 0 -> greedy
    stop_token: Optional[int] = None
    seed: int = 0


@dataclasses.dataclass
class LLMConfig:
    model_id: str = "gpt2-125m"
    # None -> GPT2Config.gpt2_125m(); or a LlamaConfig; tests pass tiny ones.
    model_config: Any = None
    # Serving shape
    max_slots: int = 16  # concurrent sequences (continuous-batching slots)
    max_seq: int = 2048  # cache length (prompt + generation)
    prefill_buckets: tuple = (32, 64, 128, 256, 512, 1024, 2048)
    # Paged KV cache: kv_block_size > 0 -> requests hold block tables over
    # a shared device pool of num_kv_blocks blocks; admission reserves
    # ceil(min(prompt+max_tokens, max_seq)/block) blocks. 0 -> the dense
    # per-slot cache. num_kv_blocks None -> half the dense-equivalent,
    # floored at one max-length request, plus the scratch block.
    kv_block_size: int = 16
    num_kv_blocks: Optional[int] = None
    # Tensor-parallel degree: > 1 splits the heads, the MLP and the
    # vocabulary over that many ranks of the caller's process group.
    tensor_parallelism: int = 1
    # Placement: resources each serve replica actor demands.
    placement: dict = dataclasses.field(default_factory=lambda: {"num_cpus": 1})
    # Initial weights: a path to a pickled params pytree of numpy arrays,
    # or None for random init from ``seed``.
    weights_path: Optional[str] = None
    seed: int = 0
    # Prefix caching: chunk-aligned prompt prefixes keep their KV in a
    # pool; a shared system prompt prefills once.
    enable_prefix_caching: bool = True
    prefix_chunk: int = 32  # alignment granularity (tokens)
    max_prefix_cache_tokens: int = 4096  # pool budget, LRU-evicted
    # Chunked prefill: prompts whose un-cached suffix exceeds this many
    # tokens prefill in chunks of this size, one chunk per engine step.
    # 0 = disabled.
    prefill_chunk_tokens: int = 0
    # Speculative decoding: a draft model proposes up to this many greedy
    # tokens per engine step and the target verifies them in one
    # multi-token forward; greedy outputs equal vanilla decode's. 0 = off.
    spec_decode_tokens: int = 0
    # The draft: a model config (GPT2Config or LlamaConfig) whose vocab
    # equals the target's; required when spec_decode_tokens > 0. In paged
    # mode its KV is a pool parallel to the target's, on the same block ids.
    draft_model_config: Any = None
    # Draft weights: a path to a pickled params pytree of numpy arrays (as
    # weights_path), or None for random init from ``seed``.
    draft_weights_path: Optional[str] = None

    def build_model_config(self):
        """The model config the engine serves. Raises ``ValueError``
        naming the field when ``tensor_parallelism`` does not split it
        (:func:`check_tensor_parallelism`)."""
        from ray_tpu_torch.models.gpt2 import GPT2Config

        if self.model_config is not None:
            cfg = self.model_config
        else:
            cfg = GPT2Config.gpt2_125m()
            cfg = dataclasses.replace(cfg, max_seq=max(cfg.max_seq, self.max_seq))
        check_tensor_parallelism(cfg, self.tensor_parallelism)
        return cfg


def check_tensor_parallelism(cfg, tp: int) -> None:
    """Raise ``ValueError`` naming the field unless ``tp`` can serve
    ``cfg``: the vocabulary and the MLP's hidden width each divide over
    ``tp`` (the reference's placement refuses them otherwise). The heads
    need not divide: ranks take contiguous blocks as even as they go
    (:func:`~ray_tpu_torch.models.convert.tp_shard`), and past the head
    count a rank holds none, as the reference serves such degrees
    (``tests/test_torch_llm_tp.py`` holds them)."""
    if tp < 1:
        raise ValueError(f"tensor_parallelism must be >= 1, got {tp}")
    for field in ("vocab_size", "d_ff"):
        if getattr(cfg, field) % tp:
            raise ValueError(
                f"tensor_parallelism={tp} does not divide {field}={getattr(cfg, field)}"
            )
