"""The port's dense-KV LLMEngine against the JAX package's, on the CPU.

Both engines load the SAME pickled numpy params through ``weights_path``
(tiny GPT-2, f32, ``kv_block_size=0``) and serve the same token-id prompts:
a shared 32-token prefix (the second request hits the prefix pool and takes
``prefill_continue``), a prompt long enough for a larger bucket, more
requests than slots, and a chunked-prefill run. Greedy token streams must be
bit-equal, and so must the prefix and prefill counters.
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm.config import LLMConfig as JLLMConfig
from ray_tpu.llm.config import SamplingParams as JSampling
from ray_tpu.llm.engine import LLMEngine as JEngine
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu_torch.llm.config import LLMConfig as PLLMConfig
from ray_tpu_torch.llm.config import SamplingParams as PSampling
from ray_tpu_torch.llm.engine import LLMEngine as PEngine
from ray_tpu_torch.models import gpt2 as pgpt2

SHAPE = dict(n_layer=2, d_model=64, n_head=2, vocab_size=512, max_seq=256)
SERVE = dict(
    max_slots=3,
    max_seq=256,
    prefill_buckets=(32, 64, 128),
    kv_block_size=0,
    prefix_chunk=32,
    max_prefix_cache_tokens=1024,
    seed=5,
)
COUNTERS = (
    "prefill_tokens", "prefill_chunks", "prefix_hits", "prefix_lookups",
    "prefix_tokens_reused", "tokens_generated",
)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    jcfg = dataclasses.replace(
        jgpt2.GPT2Config.tiny(**SHAPE), dtype=jnp.float32, attn_impl="reference"
    )
    tree = jax.tree.map(np.asarray, jgpt2.init_params(jax.random.key(11), jcfg))
    path = tmp_path_factory.mktemp("weights") / "gpt2_tiny.pkl"
    with open(path, "wb") as f:
        pickle.dump(tree, f)
    return jcfg, str(path)


def _engines(weights, **kw):
    jcfg, path = weights
    pcfg = dataclasses.replace(pgpt2.GPT2Config.tiny(**SHAPE), dtype=torch.float32)
    j = JEngine(JLLMConfig(model_config=jcfg, weights_path=path, **SERVE, **kw))
    p = PEngine(
        PLLMConfig(model_config=pcfg, weights_path=path, **SERVE, **kw), device="cpu"
    )
    return j, p


def _prompts():
    rng = np.random.default_rng(3)
    ids = lambda n: rng.integers(0, 256, n).tolist()  # noqa: E731
    prefix = ids(32)
    return [
        ids(10),
        prefix + ids(8),  # pools its 32-token prefix
        prefix + ids(20),  # prefix hit: prefill_continue of the suffix
        ids(100),  # bucket 128
        ids(45),  # waits for a free slot (max_slots=3)
    ]


def _serve_both(j, p, prompts, max_tokens=8):
    jout = j.generate(prompts, JSampling(max_tokens=max_tokens))
    pout = p.generate(prompts, PSampling(max_tokens=max_tokens))
    return jout, pout


def test_greedy_streams_bit_equal_with_prefix_hit(weights):
    j, p = _engines(weights)
    jout, pout = _serve_both(j, p, _prompts())
    assert [o["token_ids"] for o in pout] == [o["token_ids"] for o in jout]
    assert all(o["error"] is None and o["num_generated"] >= 1 for o in pout)
    assert {k: p.stats[k] for k in COUNTERS} == {k: j.stats[k] for k in COUNTERS}
    assert p.stats["prefix_hits"] >= 1
    assert all(p.slot_free)
    assert p.prefix_digest()["digests"] and p.rolling_ttft_ms() > 0.0


def test_chunked_prefill_bit_equal(weights):
    j, p = _engines(weights, prefill_chunk_tokens=32)
    prompts = _prompts()
    jout, pout = _serve_both(j, p, [prompts[3], prompts[0], prompts[1]])
    assert [o["token_ids"] for o in pout] == [o["token_ids"] for o in jout]
    assert {k: p.stats[k] for k in COUNTERS} == {k: j.stats[k] for k in COUNTERS}
    # 100 tokens in 4 chunks of <= 32, 40 tokens in 2; 10 tokens unchunked.
    assert p.stats["prefill_chunks"] == 6


def test_sampled_request_finishes_in_vocab(weights):
    """Temperature > 0 with a fixed seed: checked for finishing with
    in-vocab tokens only (a draw near a probability boundary may differ
    from the JAX engine at f32 rounding)."""
    _, p = _engines(weights)
    out = p.generate([_prompts()[0]], PSampling(max_tokens=6, temperature=0.8))[0]
    assert out["error"] is None and 1 <= out["num_generated"] <= 6
    assert all(0 <= t < SHAPE["vocab_size"] for t in out["token_ids"])


def test_unported_paths_raise(weights):
    jcfg, path = weights
    pcfg = dataclasses.replace(pgpt2.GPT2Config.tiny(**SHAPE), dtype=torch.float32)
    for kw in ({"kv_block_size": 16}, {"spec_decode_tokens": 2}, {"tensor_parallelism": 2}):
        cfg = PLLMConfig(model_config=pcfg, **{**SERVE, **kw})
        with pytest.raises(NotImplementedError):
            PEngine(cfg, device="cpu")
    eng = PEngine(PLLMConfig(model_config=pcfg, **SERVE), device="cpu")
    with pytest.raises(NotImplementedError):
        eng.add_request("r", [1, 2, 3], prefill_only=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PEngine(PLLMConfig(model_config=pcfg, **SERVE))
