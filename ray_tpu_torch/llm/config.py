"""LLM tier configuration. Port of ``ray_tpu/llm/config.py``.

The port's engine serves the dense KV cache only so far, so this config
holds only the fields it reads. Three of them name later work and make the
engine raise ``NotImplementedError`` when set: ``kv_block_size > 0`` (the
paged cache), ``spec_decode_tokens > 0`` and ``tensor_parallelism > 1``.
The reference's model id, paged pool size, replica placement and draft
model fields arrive with the code that reads them.
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
    # None -> GPT2Config.gpt2_125m(); tests pass a tiny config.
    model_config: Any = None
    # Serving shape
    max_slots: int = 16  # concurrent sequences (continuous-batching slots)
    max_seq: int = 2048  # cache length (prompt + generation)
    prefill_buckets: tuple = (32, 64, 128, 256, 512, 1024, 2048)
    # 0 is the dense per-slot cache. > 0 selects the reference's paged
    # cache (its default there is 16), which is not ported yet.
    kv_block_size: int = 0
    # Tensor-parallel degree (only 1 is ported).
    tensor_parallelism: int = 1
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
    # Speculative decoding: draft tokens per step (0 = off; not ported yet).
    spec_decode_tokens: int = 0

    def build_model_config(self):
        from ray_tpu_torch.models.gpt2 import GPT2Config

        if self.model_config is not None:
            return self.model_config
        cfg = GPT2Config.gpt2_125m()
        return dataclasses.replace(cfg, max_seq=max(cfg.max_seq, self.max_seq))
