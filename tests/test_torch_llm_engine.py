"""The port's LLMEngine against the JAX package's, on the CPU.

Both engines load the SAME pickled numpy params through ``weights_path``
(tiny GPT-2 and tiny Llama with ``n_kv_head < n_head``, f32) and serve the
same token-id prompts: a shared 32-token prefix (the second request hits
the prefix pool: ``prefill_continue`` on the dense cache, shared blocks on
the paged one), a prompt long enough for a larger bucket, more requests
than slots, and chunked prefill. Greedy token streams must be bit-equal,
and so must the prefix and prefill counters. Then the port's versions of
the reference's paged-engine tests (``tests/test_llm_paged_kv.py``): block
sharing without a copy, pool pressure, block reuse, an oversized request,
eviction under pressure.
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
from ray_tpu.models import llama as jllama
from ray_tpu_torch.llm.config import LLMConfig as PLLMConfig
from ray_tpu_torch.llm.config import SamplingParams as PSampling
from ray_tpu_torch.llm.engine import LLMEngine as PEngine
from ray_tpu_torch.models import gpt2 as pgpt2
from ray_tpu_torch.models import llama as pllama

SHAPE = dict(n_layer=2, d_model=64, n_head=2, vocab_size=512, max_seq=256)
LLAMA_SHAPE = dict(n_layer=2, d_model=64, n_head=4, n_kv_head=2, vocab_size=512, max_seq=128)
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


def _pickled(tmp_path_factory, name, tree):
    path = tmp_path_factory.mktemp("weights") / f"{name}.pkl"
    with open(path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, tree), f)
    return str(path)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(jax config, port config, pickled params) of a tiny f32 GPT-2."""
    jcfg = dataclasses.replace(
        jgpt2.GPT2Config.tiny(**SHAPE), dtype=jnp.float32, attn_impl="reference"
    )
    pcfg = dataclasses.replace(pgpt2.GPT2Config.tiny(**SHAPE), dtype=torch.float32)
    path = _pickled(tmp_path_factory, "gpt2_tiny", jgpt2.init_params(jax.random.key(11), jcfg))
    return jcfg, pcfg, path


@pytest.fixture(scope="module")
def llama_weights(tmp_path_factory):
    """The same for a tiny f32 Llama, 4 query heads over 2 KV heads."""
    jcfg = dataclasses.replace(
        jllama.LlamaConfig.tiny(**LLAMA_SHAPE), dtype=jnp.float32, attn_impl="reference"
    )
    pcfg = dataclasses.replace(pllama.LlamaConfig.tiny(**LLAMA_SHAPE), dtype=torch.float32)
    path = _pickled(tmp_path_factory, "llama_tiny", jllama.init_params(jax.random.key(12), jcfg))
    return jcfg, pcfg, path


def _engines(weights, **kw):
    jcfg, pcfg, path = weights
    serve = {**SERVE, **kw}
    j = JEngine(JLLMConfig(model_config=jcfg, weights_path=path, **serve))
    p = PEngine(PLLMConfig(model_config=pcfg, weights_path=path, **serve), device="cpu")
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


@pytest.mark.parametrize("kv_block_size", [0, 16], ids=["dense", "paged"])
def test_sampled_streams_equal_jax(weights, kv_block_size):
    """Temperature 0.8 with the engines' shared seed: both sample from the
    same f32 logits with the same numpy rng draws, so the streams are
    equal token for token (a prefix hit and more requests than slots
    included)."""
    j, p = _engines(weights, kv_block_size=kv_block_size)
    prompts = _prompts()
    jout = j.generate(prompts, JSampling(max_tokens=8, temperature=0.8))
    pout = p.generate(prompts, PSampling(max_tokens=8, temperature=0.8))
    assert [o["token_ids"] for o in pout] == [o["token_ids"] for o in jout]
    assert {k: p.stats[k] for k in COUNTERS} == {k: j.stats[k] for k in COUNTERS}
    assert p.stats["prefix_hits"] >= 1
    greedy = p.generate(prompts, PSampling(max_tokens=8))
    assert [o["token_ids"] for o in greedy] != [o["token_ids"] for o in pout]  # it did sample


def test_unported_paths_raise(weights):
    """A tensor-parallel degree that does not split the vocabulary raises
    ``ValueError`` naming the field (a degree above the head count is
    served: tests/test_torch_llm_tp.py), and one that does raises without a
    process group; prefill_only on the dense cache raises ``ValueError``
    (handoffs ship pool blocks: tests/test_torch_disagg.py), and so does
    the card's absence; the paged cache (the default, ``kv_block_size=16``)
    builds, and takes a prefill-only request."""
    _, pcfg, _ = weights
    with pytest.raises(ValueError, match="does not divide vocab_size=512"):
        PEngine(PLLMConfig(model_config=pcfg, **{**SERVE, "tensor_parallelism": 3}), device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        PEngine(PLLMConfig(model_config=pcfg, **{**SERVE, "tensor_parallelism": 2}), device="cpu")
    assert PLLMConfig().kv_block_size == 16 and PLLMConfig().num_kv_blocks is None
    eng = PEngine(PLLMConfig(model_config=pcfg, **{**SERVE, "kv_block_size": 16}), device="cpu")
    # 3 slots x 16 blocks of a 256-row table, halved, plus the scratch block.
    assert eng.paged and eng.kv_stats() == {
        "paged": True, "block_size": 16, "blocks_total": 24, "blocks_free": 24, "blocks_used": 0,
    }
    assert eng.pool["k"].shape == (2, 25, 2, 16, 32)
    eng.add_request("r", [1, 2, 3], prefill_only=True)
    eng.step()
    (req,) = eng.pop_finished()
    assert req.handoff_out["nblocks"] == 1 and eng.stats["handoffs_out"] == 1
    with pytest.raises(ValueError, match="paged KV cache"):
        PEngine(PLLMConfig(model_config=pcfg, **SERVE), device="cpu").add_request(
            "r", [1, 2, 3], prefill_only=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PEngine(PLLMConfig(model_config=pcfg, **SERVE))


def test_position_table_check_is_gpt2_only(weights, llama_weights):
    """GPT-2's learned table bounds the cache length; Llama's RoPE tables
    are computed for any length, so a Llama built for 128 positions serves
    a 256-row cache, as the reference's does."""
    _, pcfg, _ = weights
    small = dataclasses.replace(pcfg, max_seq=128)
    with pytest.raises(ValueError, match="position table"):
        PEngine(PLLMConfig(model_config=small, **SERVE), device="cpu")
    _, lcfg, _ = llama_weights
    for block in (0, 16):
        eng = PEngine(
            PLLMConfig(model_config=lcfg, **{**SERVE, "kv_block_size": block}), device="cpu"
        )
        assert lcfg.max_seq < eng.config.max_seq == 256
        out = eng.generate([list(range(3, 40))], PSampling(max_tokens=3))[0]
        assert out["error"] is None and out["num_generated"] == 3
    with pytest.raises(ValueError, match="multiple of kv_block_size"):
        PEngine(PLLMConfig(model_config=lcfg, **{**SERVE, "kv_block_size": 48}), device="cpu")
    with pytest.raises(ValueError, match="prefix_chunk"):
        PEngine(
            PLLMConfig(model_config=lcfg, **{**SERVE, "kv_block_size": 64, "prefix_chunk": 32}),
            device="cpu",
        )


# -- paged GPT-2 and both Llama caches against the JAX engine -----------------


def test_paged_greedy_streams_bit_equal_with_prefix_hit_and_chunks(weights):
    """The paged GPT-2 engine with chunked prefill: first a 40-token prompt
    (two chunks) pools its 32-token prefix; then the prefix hit (its
    suffix unchunked), a 100-token prompt in 4 chunks and more requests
    than slots."""
    j, p = _engines(weights, kv_block_size=16, prefill_chunk_tokens=32)
    prompts = _prompts()
    for wave in ([prompts[1]], [prompts[2], prompts[3], prompts[0], prompts[4]]):
        jout, pout = _serve_both(j, p, wave)
        assert [o["token_ids"] for o in pout] == [o["token_ids"] for o in jout]
        assert all(o["error"] is None for o in pout)
    assert {k: p.stats[k] for k in COUNTERS} == {k: j.stats[k] for k in COUNTERS}
    assert p.stats["prefix_hits"] == 1 and p.stats["prefill_chunks"] == 8
    assert p.kv_stats() == j.kv_stats()
    assert p.prefix_digest()["kv_util"] == j.prefix_digest()["kv_util"] > 0.0
    assert all(p.slot_free) and not p.block_tables.any()


@pytest.mark.parametrize("kv_block_size", [0, 16], ids=["dense", "paged"])
def test_llama_greedy_streams_bit_equal(llama_weights, kv_block_size):
    j, p = _engines(llama_weights, kv_block_size=kv_block_size)
    jout, pout = _serve_both(j, p, _prompts())
    assert [o["token_ids"] for o in pout] == [o["token_ids"] for o in jout]
    assert all(o["error"] is None and o["num_generated"] >= 1 for o in pout)
    assert {k: p.stats[k] for k in COUNTERS} == {k: j.stats[k] for k in COUNTERS}
    assert p.stats["prefix_hits"] >= 1
    assert p.kv_stats() == j.kv_stats()


# -- the port of the reference's paged-engine tests ---------------------------


def _tiny_engine(**kw) -> PEngine:
    """The reference tests' engine: tiny GPT-2 (128 positions), random f32
    weights from a seed."""
    model = dataclasses.replace(
        pgpt2.GPT2Config.tiny(vocab_size=512, max_seq=128), dtype=torch.float32
    )
    serve = dict(max_slots=2, max_seq=64, prefill_buckets=(16,), kv_block_size=16, seed=0)
    return PEngine(PLLMConfig(model_config=model, **{**serve, **kw}), device="cpu")


def test_paged_prefix_shares_blocks_without_copy():
    """A pooled-prefix hit points the new request at the SAME physical
    blocks (refcount > 1): no device copy, where dense mode copies."""
    eng = _tiny_engine(max_slots=4, prefill_buckets=(16, 32), prefix_chunk=16)
    shared = list(range(3, 19))  # one aligned 16-token chunk = 1 block
    eng.generate([shared + [40]], PSampling(max_tokens=2))
    entry = next(iter(eng._prefix_pool.values()))
    pb = entry["blocks"]
    assert len(pb) == 1 and eng.block_mgr.refcount(pb[0]) == 1
    before = eng.pool["k"][:, pb[0]].clone()

    eng.add_request("r2", shared + [41], PSampling(max_tokens=8))
    eng.step()
    req = eng.requests["r2"]
    assert req.blocks[0] == pb[0]  # the same physical block, not a copy
    assert eng.block_mgr.refcount(pb[0]) == 2  # pool ref + request ref
    assert torch.equal(eng.pool["k"][:, pb[0]], before)  # never rewritten
    while eng.has_unfinished():
        eng.step()
    eng.pop_finished()
    assert eng.block_mgr.refcount(pb[0]) == 1
    assert eng.stats["prefix_hits"] == 1


def test_paged_admits_4x_concurrency_at_equal_memory():
    """Equal KV memory, short requests: the paged engine admits >= 4x the
    dense engine's concurrency, and every request still completes."""
    model = dataclasses.replace(
        pgpt2.GPT2Config.tiny(vocab_size=512, max_seq=256), dtype=torch.float32
    )
    common = dict(model_config=model, max_seq=256, prefill_buckets=(16,), seed=0,
                  enable_prefix_caching=False)
    dense = PEngine(PLLMConfig(max_slots=2, kv_block_size=0, **common), device="cpu")
    # The same 512 cache rows: 32 blocks of 16, over 16 slots.
    pag = PEngine(PLLMConfig(max_slots=16, kv_block_size=16, num_kv_blocks=33, **common),
                  device="cpu")
    for eng in (dense, pag):
        for r in range(16):
            eng.add_request(f"q{r}", [10 + r] * 8, PSampling(max_tokens=8))
        eng.step()
    dense_active = sum(r is not None for r in dense._slot_req)
    paged_active = sum(r is not None for r in pag._slot_req)
    assert dense_active == 2 and paged_active >= 4 * dense_active
    assert pag.kv_stats()["blocks_used"] == paged_active
    while pag.has_unfinished():
        pag.step()
    assert len(pag.pop_finished()) == 16
    assert pag.kv_stats()["blocks_free"] == 32


def test_paged_pool_pressure_serializes_fifo_and_stays_correct():
    """A pool far smaller than demand: requests wait FIFO for blocks, and
    every result matches an unconstrained engine's."""
    prompts = [[20 + i] * 6 for i in range(6)]
    sampling = PSampling(max_tokens=6)
    tight = _tiny_engine(max_slots=6, num_kv_blocks=3, enable_prefix_caching=False)
    roomy = _tiny_engine(max_slots=6, enable_prefix_caching=False)
    for r, prompt in enumerate(prompts):
        tight.add_request(f"q{r}", prompt, sampling)
    tight.step()
    # 2 usable blocks, 1 each: two in flight, the rest waiting in order.
    assert [r.request_id for r in tight._slot_req if r is not None] == ["q0", "q1"]
    while tight.has_unfinished():
        tight.step()
    a = {r.request_id: r.generated for r in tight.pop_finished()}
    b = roomy.generate(prompts, sampling)
    assert [a[f"q{r}"] for r in range(6)] == [o["token_ids"] for o in b]
    assert tight.kv_stats()["blocks_free"] == 2


def test_paged_block_reuse_no_cross_request_contamination():
    """Freed blocks are recycled (LIFO) by later requests; greedy outputs
    match a fresh engine's, which stale KV in a recycled block would break."""
    sampling = PSampling(max_tokens=5)
    eng = _tiny_engine(num_kv_blocks=5, enable_prefix_caching=False)
    eng.generate([[5] * 10, [6] * 10], sampling)  # dirty the blocks
    again = eng.generate([[7, 8, 9, 10], [11, 12] * 3], sampling)
    fresh = _tiny_engine(num_kv_blocks=5, enable_prefix_caching=False)
    ref = fresh.generate([[7, 8, 9, 10], [11, 12] * 3], sampling)
    assert [o["token_ids"] for o in again] == [o["token_ids"] for o in ref]


def test_paged_oversized_request_finishes_with_error_not_wedge():
    """A reservation larger than the whole pool fails THAT request with an
    error surfaced through pop_finished; the engine keeps serving."""
    eng = _tiny_engine(num_kv_blocks=3, enable_prefix_caching=False)
    eng.add_request("big", [1] * 10, PSampling(max_tokens=50))
    eng.add_request("next", [2] * 6, PSampling(max_tokens=4))
    done = eng.step()
    assert [r.request_id for r in done] == ["big"]
    assert "KV blocks" in done[0].error
    assert eng.requests["next"].slot >= 0  # the wave went on past it
    while eng.has_unfinished():
        eng.step()
    popped = {r.request_id: r for r in eng.pop_finished()}
    assert popped["big"].error is not None and popped["big"].generated == []
    ok = popped["next"]
    assert ok.error is None and len(ok.generated) == 4
    out = eng.generate([[3] * 5], PSampling(max_tokens=60))[0]
    assert out["error"] is not None and out["num_generated"] == 0


def test_paged_prefix_pool_evicted_under_allocation_pressure():
    """Pinned prefix-pool blocks are LRU-evicted when an admission cannot
    reserve; without that a max-length request would wait forever."""
    eng = _tiny_engine(prefill_buckets=(16, 32), num_kv_blocks=5, prefix_chunk=16)
    sampling = PSampling(max_tokens=2)
    eng.generate([[3] * 17], sampling)
    eng.generate([[4] * 17], sampling)
    assert len(eng._prefix_pool) == 2 and eng.kv_stats()["blocks_free"] == 2
    # 64 rows = 4 blocks: admittable only once the pool gives its blocks back.
    eng.add_request("big", [9] * 10, PSampling(max_tokens=54))
    steps = 0
    while eng.has_unfinished():
        eng.step()
        steps += 1
        assert steps < 200, "engine wedged: the prefix pool never gave way"
    done = eng.pop_finished()
    assert len(done) == 1 and done[0].error is None
    assert len(eng._prefix_pool) < 2


def test_paged_eviction_keeps_the_entry_about_to_be_shared():
    """Under pressure the entry the admitted request shares is kept; the
    others go first, and the hit still counts."""
    eng = _tiny_engine(prefill_buckets=(16, 32), num_kv_blocks=5, prefix_chunk=16)
    sampling = PSampling(max_tokens=2)
    shared = [3] * 16
    eng.generate([shared + [1]], sampling)  # pools `shared` (1 block)
    eng.generate([[4] * 17], sampling)  # pools another, most recently used
    keep = next(e for e in eng._prefix_pool.values() if e["tokens"] == tuple(shared))
    # 4 blocks: 1 shared + 3 new, with 2 free: one entry must go, not `keep`.
    eng.add_request("hit", shared + [5] * 10, PSampling(max_tokens=38))
    eng.step()
    assert list(eng._prefix_pool.values()) == [keep]
    assert eng.requests["hit"].blocks[0] == keep["blocks"][0]
    assert eng.stats["prefix_hits"] == 1
