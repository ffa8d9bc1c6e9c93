"""The port's OpenAI-style deployment on the card: a tiny GPT-2 (head_dim
64, the dense cache, so each fresh prefill runs the flash kernel) served
by ``build_openai_app`` from a replica that holds the ``GPU`` unit answers
a completion over the proxy; and ``LLMServer`` asked for the card on a
machine without one raises.

The tests carry the ``cuda`` marker. This file imports neither jax nor the
JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_serve_cuda.py -m cuda --noconftest -q
"""

import json
import urllib.request

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.llm import LLMConfig, LLMServer, build_openai_app
from ray_tpu_torch.models.gpt2 import GPT2Config
from ray_tpu_torch.serve import api as serve_api

pytestmark = pytest.mark.cuda


def _config(**kw):
    model = GPT2Config.tiny(n_layer=2, d_model=128, n_head=2, max_seq=256)
    return LLMConfig(model_config=model, max_slots=2, max_seq=256, prefill_buckets=(32, 64),
                     kv_block_size=0, **kw)


def test_completion_from_a_replica_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ray_tpu_torch.init(num_cpus=2)
    try:
        cards = ray_tpu_torch.cluster_resources()["GPU"]
        serve.run(build_openai_app(_config(placement={"num_cpus": 1, "num_gpus": 1}), name="cudallm"),
                  wait_timeout_s=300)
        assert ray_tpu_torch.available_resources().get("GPU", 0.0) == cards - 1  # the replica holds it
        req = urllib.request.Request(
            f"http://127.0.0.1:{serve_api.proxy_port()}/cudallm/v1/completions",
            data=json.dumps({"prompt": "hello from the card", "max_tokens": 4}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            out = json.loads(r.read())
        assert out["object"] == "text_completion" and out["usage"]["completion_tokens"] >= 1
    finally:
        try:
            serve.shutdown()
        finally:
            ray_tpu_torch.shutdown()


def test_llm_server_asked_for_the_card_without_one_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the card-less refusal")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMServer(_config())
