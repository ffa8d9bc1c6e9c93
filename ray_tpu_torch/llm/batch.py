"""Batch inference: an LLM processor over dict batches. Port of
``ray_tpu/llm/batch.py``.

``build_llm_processor`` returns a callable over a column batch (a dict of
columns) for :meth:`ray_tpu_torch.data.Dataset.map_batches`, which
generates one text per prompt. The engine is built on the first call and
cached per worker process, so later batches reuse it (the reference uses
actor pools; worker reuse across leases gives the same amortization). It
runs on ``device``, the card unless the caller asks for the CPU: a stage
that holds the card claims it with ``map_batches(proc, resources={"GPU":
1})``, so its task runs where a card is free and keeps it while it
generates. The processor can also be called directly on a batch in the
caller's process. With ``tensor_parallelism > 1`` the engine is one rank
of an SPMD group (:class:`~ray_tpu_torch.llm.engine.LLMEngine`): every rank
builds the processor and calls it on the same batches, and each returns
the same texts.
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tpu_torch.llm.config import LLMConfig, SamplingParams

_ENGINE_CACHE: dict = {}


def _engine_for(config: LLMConfig, device: "str | torch.device"):
    key = (
        config.model_id,
        config.max_slots,
        config.max_seq,
        config.seed,
        config.weights_path,
        config.tensor_parallelism,
        repr(config.model_config),  # dataclass -> stable repr
        str(torch.device(device)),
    )
    eng = _ENGINE_CACHE.get(key)
    if eng is None:
        from ray_tpu_torch.llm.engine import LLMEngine

        eng = LLMEngine(config, device=device)
        _ENGINE_CACHE[key] = eng
    return eng


def build_llm_processor(
    config: LLMConfig,
    *,
    input_column: str = "prompt",
    output_column: str = "generated_text",
    sampling: Optional[SamplingParams] = None,
    device: "str | torch.device" = "cuda",
):
    """Returns fn(batch: dict) -> dict: the batch with ``output_column``
    added. The engine runs on ``device``: the card unless the caller asks
    for the CPU."""

    def process(batch: dict) -> dict:
        prompts = [str(p) for p in batch[input_column]]
        if not prompts:
            return {**batch, output_column: []}
        engine = _engine_for(config, device)
        results = engine.generate(prompts, sampling)
        return {**batch, output_column: [r["text"] for r in results]}

    return process
