"""ray_tpu_torch.llm: the LLM tier of the port. Port of ``ray_tpu/llm``.

The engine (:class:`LLMEngine`, continuous batching over the dense or
paged KV cache, with speculative decoding and the serving telemetry), the
OpenAI-style serving deployment on the serve tier (:class:`LLMServer`,
:func:`build_openai_app`, unified or disaggregated prefill -> decode) and
the batch-inference entry point (:func:`build_llm_processor`).
"""

from ray_tpu_torch.llm.batch import build_llm_processor
from ray_tpu_torch.llm.config import LLMConfig, SamplingParams
from ray_tpu_torch.llm.engine import LLMEngine
from ray_tpu_torch.llm.serve_llm import LLMServer, build_openai_app
from ray_tpu_torch.llm.tokenizer import ByteTokenizer

__all__ = [
    "ByteTokenizer",
    "LLMConfig",
    "LLMEngine",
    "LLMServer",
    "SamplingParams",
    "build_llm_processor",
    "build_openai_app",
]
