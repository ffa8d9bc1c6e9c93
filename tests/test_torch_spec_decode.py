"""The port's speculative decoding against the JAX package's, on the CPU in f32.

- ``paged_verify`` and ``dense_verify`` against ``ray_tpu``'s on the same
  numpy params, pool or cache and tokens, for GPT-2 and Llama
  (``n_kv_head < n_head``): T = k+1 tokens starting mid-block, a free
  slot on the scratch block. Logits and the written pool or cache agree at
  rtol=atol=1e-5; ``paged_verify`` at T=1 equals ``paged_decode``.
- The engines: both load the same pickled target and draft weights
  through ``weights_path`` and ``draft_weights_path``. Greedy spec streams
  are bit-equal to the JAX spec engine's and to the port's vanilla
  engine's, dense and paged, both families, with a prefix hit and chunked
  prefill; the ``spec_*`` counters equal the JAX engine's.
- The engine's rules: a sampled request or a slot near ``max_seq`` forces
  the vanilla step; a chunked-prefill request joins spec steps after its
  last chunk; a spec burst that ends at ``max_seq`` gives the reference's
  stream, one token longer than vanilla's; the configuration errors.
"""

import dataclasses
import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm.config import LLMConfig as JLLMConfig
from ray_tpu.llm.config import SamplingParams as JSampling
from ray_tpu.llm.engine import LLMEngine as JEngine
from ray_tpu.llm.spec_decode import dense_verify as jdense_verify
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu.models import paged as jpaged
from ray_tpu_torch.llm.config import LLMConfig as PLLMConfig
from ray_tpu_torch.llm.config import SamplingParams as PSampling
from ray_tpu_torch.llm.engine import LLMEngine as PEngine
from ray_tpu_torch.llm.spec_decode import SpecDecoder, dense_verify
from ray_tpu_torch.models import gpt2 as pgpt2
from ray_tpu_torch.models import llama as pllama
from ray_tpu_torch.models import paged as ppaged
from ray_tpu_torch.models.convert import gpt2_params_from_numpy, llama_params_from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)
K = 3  # draft tokens per spec step: the verify scores T = K + 1
BLOCK, W, N_BLOCKS = 8, 4, 12  # a 32-row table
SHAPES = {
    "gpt2": dict(n_layer=2, d_model=64, n_head=2, vocab_size=512, max_seq=256),
    "llama": dict(n_layer=2, d_model=64, n_head=4, n_kv_head=2, vocab_size=512, max_seq=128),
}
SERVE = dict(
    max_slots=3,
    max_seq=256,
    prefill_buckets=(32, 128),
    prefix_chunk=32,
    max_prefix_cache_tokens=1024,
    prefill_chunk_tokens=32,
    seed=5,
)


def _configs(name, **over):
    """(jax model module, jax cfg, port cfg): tiny, f32."""
    if name == "gpt2":
        jmod, jcls, pcls = jgpt2, jgpt2.GPT2Config, pgpt2.GPT2Config
    else:
        jmod, jcls, pcls = jllama, jllama.LlamaConfig, pllama.LlamaConfig
    shape = {**SHAPES[name], **over}
    jcfg = dataclasses.replace(jcls.tiny(**shape), dtype=jnp.float32, attn_impl="reference")
    pcfg = dataclasses.replace(pcls.tiny(**shape), dtype=torch.float32)
    return jmod, jcfg, pcfg


def _tree(jmod, jcfg, seed):
    """One numpy params tree for both sides, every leaf moved off its init
    value so norm scales and biases show."""
    tree = jax.tree.map(np.asarray, jmod.init_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(a.shape, dtype=np.float32), tree)


def _convert(name, tree, pcfg):
    convert = gpt2_params_from_numpy if name == "gpt2" else llama_params_from_numpy
    return convert(tree, pcfg, "cpu")


# -- the verify passes against JAX --------------------------------------------


@pytest.fixture(scope="module", params=["gpt2", "llama"])
def family(request):
    name = request.param
    jmod, jcfg, pcfg = _configs(name, max_seq=64)
    tree = _tree(jmod, jcfg, 0)
    return name, jcfg, pcfg, jax.tree.map(jnp.asarray, tree), _convert(name, tree, pcfg)


def _kv(shape, seed):
    """Random k and v of ``shape`` (stale KV everywhere, as a used pool has)."""
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal(shape, dtype=np.float32) for n in ("k", "v")}


def _verify_tokens(cfg, B, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, K + 1)).astype(np.int32)


def test_paged_verify_matches_jax(family):
    """Slot 0 writes rows 13..16 across its second and third blocks, slot 1
    rows 5..8 across its first and second; slot 2 is free (its table all
    scratch)."""
    _, jcfg, pcfg, jparams, pparams = family
    kh = getattr(pcfg, "n_kv_head", pcfg.n_head)
    kv = _kv((pcfg.n_layer, N_BLOCKS, kh, BLOCK, pcfg.head_dim), 1)
    tables = np.array([[7, 3, 10, 0], [2, 9, 5, 0], [0, 0, 0, 0]], np.int32)
    positions = np.array([13, 5, 0], np.int32)
    toks = _verify_tokens(pcfg, 3)
    jpool, jlog = jax.jit(functools.partial(jpaged.paged_verify, cfg=jcfg, block_size=BLOCK))(
        jparams, jnp.asarray(toks), jnp.asarray(positions), jnp.asarray(tables),
        {n: jnp.asarray(a) for n, a in kv.items()},
    )
    pool = {n: torch.from_numpy(a.copy()) for n, a in kv.items()}
    out, plog = ppaged.paged_verify(
        pparams, torch.from_numpy(toks).long(), torch.from_numpy(positions),
        torch.from_numpy(tables).long(), pool, pcfg, block_size=BLOCK,
    )
    assert out is pool and plog.shape == (3, K + 1, pcfg.vocab_size) and plog.dtype == torch.float32
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(pool[n].numpy(), np.asarray(jpool[n]), **TOL)
        assert not np.array_equal(pool[n].numpy(), kv[n])  # the rows were written


def test_dense_verify_matches_jax(family):
    """The slot cache, slot 2 writing its cache's last K + 1 rows."""
    _, jcfg, pcfg, jparams, pparams = family
    kh = getattr(pcfg, "n_kv_head", pcfg.n_head)
    S = W * BLOCK
    kv = _kv((pcfg.n_layer, 3, kh, S, pcfg.head_dim), 3)
    positions = np.array([13, 5, S - K - 1], np.int32)
    toks = _verify_tokens(pcfg, 3, seed=4)
    jcache, jlog = jax.jit(functools.partial(jdense_verify, cfg=jcfg))(
        jparams, jnp.asarray(toks), jnp.asarray(positions),
        {n: jnp.asarray(a) for n, a in kv.items()},
    )
    cache = {n: torch.from_numpy(a.copy()) for n, a in kv.items()}
    out, plog = dense_verify(
        pparams, torch.from_numpy(toks).long(), torch.from_numpy(positions), cache, pcfg
    )
    assert out is cache and plog.shape == (3, K + 1, pcfg.vocab_size)
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(cache[n].numpy(), np.asarray(jcache[n]), **TOL)


def test_paged_verify_one_token_is_paged_decode(family):
    _, _, pcfg, _, pparams = family
    kh = getattr(pcfg, "n_kv_head", pcfg.n_head)
    kv = _kv((pcfg.n_layer, N_BLOCKS, kh, BLOCK, pcfg.head_dim), 5)
    tables = torch.tensor([[7, 3, 10, 0], [2, 9, 5, 0]])
    positions = torch.tensor([15, 8])
    toks = torch.from_numpy(_verify_tokens(pcfg, 2)[:, :1]).long()
    pools = [{n: torch.from_numpy(a.copy()) for n, a in kv.items()} for _ in range(2)]
    _, want = ppaged.paged_decode(pparams, toks[:, 0], positions, tables, pools[0], pcfg,
                                  block_size=BLOCK)
    _, got = ppaged.paged_verify(pparams, toks, positions, tables, pools[1], pcfg,
                                 block_size=BLOCK)
    assert torch.equal(got[:, 0], want)
    assert all(torch.equal(pools[0][n], pools[1][n]) for n in ("k", "v"))


def test_verify_past_the_table_raises(family):
    """positions + T past the table: the reference's scatter would clamp
    into the slot's last block; the port raises before writing."""
    _, _, pcfg, _, pparams = family
    kh = getattr(pcfg, "n_kv_head", pcfg.n_head)
    pool = {n: torch.zeros(pcfg.n_layer, N_BLOCKS, kh, BLOCK, pcfg.head_dim) for n in "kv"}
    cache = {n: torch.zeros(pcfg.n_layer, 1, kh, W * BLOCK, pcfg.head_dim) for n in "kv"}
    toks = torch.zeros((1, K + 1), dtype=torch.long)
    last = torch.tensor([W * BLOCK - K])  # the last row would be W * BLOCK
    with pytest.raises(ValueError, match="does not fit"):
        ppaged.paged_verify(pparams, toks, last, torch.tensor([[7, 3, 10, 1]]), pool, pcfg,
                            block_size=BLOCK)
    with pytest.raises(ValueError, match="does not fit"):
        dense_verify(pparams, toks, last, cache, pcfg)
    assert not any(t.any() for t in (*pool.values(), *cache.values()))
    dense_verify(pparams, toks, last - 1, cache, pcfg)  # the last row fits
    assert cache["k"][:, 0, :, -1].any()


# -- the engines against JAX -------------------------------------------------


def _pickled(tmp_path_factory, name, tree):
    path = tmp_path_factory.mktemp("weights") / f"{name}.pkl"
    with open(path, "wb") as f:
        pickle.dump(tree, f)
    return str(path)


def _served(name, tmp_path_factory):
    """(name, jax cfg, port cfg, jax draft cfg, port draft cfg, target pickle,
    draft pickle). GPT-2's draft is the target's first layer (a model of
    another shape); Llama's is the target perturbed. Either agrees with the
    target on some proposals and not on others."""
    jmod, jcfg, pcfg = _configs(name)
    tree = _tree(jmod, jcfg, 11)
    if name == "gpt2":
        jdraft, pdraft = (dataclasses.replace(c, n_layer=1) for c in (jcfg, pcfg))
        draft = dict(tree, blocks={k: v[:1] for k, v in tree["blocks"].items()})
    else:
        jdraft, pdraft = jcfg, pcfg
        rng = np.random.default_rng(7)
        draft = jax.tree.map(lambda a: a + 0.01 * rng.standard_normal(a.shape, dtype=np.float32), tree)
    return (name, jcfg, pcfg, jdraft, pdraft, _pickled(tmp_path_factory, f"{name}_t", tree),
            _pickled(tmp_path_factory, f"{name}_d", draft))


@pytest.fixture(scope="module", params=["gpt2", "llama"])
def served(request, tmp_path_factory):
    return _served(request.param, tmp_path_factory)


def _port(served, spec=True, **kw):
    _, _, pcfg, _, pdraft, path, dpath = served
    draft = dict(spec_decode_tokens=K, draft_model_config=pdraft, draft_weights_path=dpath)
    return PEngine(
        PLLMConfig(model_config=pcfg, weights_path=path, **(draft if spec else {}), **{**SERVE, **kw}),
        device="cpu",
    )


def _prompts():
    rng = np.random.default_rng(3)
    ids = lambda n: rng.integers(0, 256, n).tolist()  # noqa: E731
    prefix = ids(32)
    return [
        ids(10),
        prefix + ids(8),  # pools its 32-token prefix
        prefix + ids(20),  # prefix hit
        ids(100),  # chunked: 4 chunks of <= 32
        ids(45),  # chunked, and waits for a free slot (max_slots=3)
    ]


SPEC_COUNTERS = ("spec_steps", "spec_drafted", "spec_accepted", "tokens_generated",
                 "prefill_chunks", "prefix_hits")


@pytest.mark.parametrize("kv_block_size", [0, 16], ids=["dense", "paged"])
def test_spec_streams_bit_equal_to_jax_and_vanilla(served, kv_block_size):
    _, jcfg, _, jdraft, _, path, dpath = served
    j = JEngine(JLLMConfig(model_config=jcfg, weights_path=path, spec_decode_tokens=K,
                           draft_model_config=jdraft, draft_weights_path=dpath,
                           kv_block_size=kv_block_size, **SERVE))
    p = _port(served, kv_block_size=kv_block_size)
    v = _port(served, spec=False, kv_block_size=kv_block_size)
    prompts = _prompts()
    # The first wave pools the shared prefix (its prompt prefills in two
    # chunks); the second hits it.
    for wave in ([prompts[1]], [prompts[2], prompts[3], prompts[0], prompts[4]]):
        jout = j.generate(wave, JSampling(max_tokens=12))
        pout = p.generate(wave, PSampling(max_tokens=12))
        vout = v.generate(wave, PSampling(max_tokens=12))
        streams = [o["token_ids"] for o in pout]
        assert streams == [o["token_ids"] for o in jout] == [o["token_ids"] for o in vout]
        assert all(o["error"] is None for o in pout)
    assert {k: p.stats[k] for k in SPEC_COUNTERS} == {k: j.stats[k] for k in SPEC_COUNTERS}
    assert p.stats["spec_steps"] > 0 and p.stats["prefix_hits"] == 1
    assert 0 < p.stats["spec_accepted"] < p.stats["spec_drafted"]
    assert p._spec.accept_rate() == j._spec.accept_rate()
    assert p.stats["tokens_generated"] == v.stats["tokens_generated"]
    assert all(p.slot_free) and not (p.paged and p.block_tables.any())


def test_sampled_request_forces_the_vanilla_step(served):
    """While a temperature > 0 request is active every step is vanilla; the
    greedy request speculates once it is gone. Both streams (the sampled
    one draws the same rng numbers) equal a vanilla engine's."""
    p, v = _port(served), _port(served, spec=False)
    greedy, sampled = _prompts()[0], _prompts()[3][:20]
    for eng in (p, v):
        eng.add_request("g", greedy, PSampling(max_tokens=16))
        eng.add_request("s", sampled, PSampling(max_tokens=4, temperature=0.8))
    spec_while_sampled = []
    while p.has_unfinished():
        p.step()
        if not p.requests["s"].finished:
            spec_while_sampled.append(p.stats["spec_steps"])
    while v.has_unfinished():
        v.step()
    assert spec_while_sampled and set(spec_while_sampled) == {0}
    assert p.stats["spec_steps"] > 0
    got = {r.request_id: r.generated for r in p.pop_finished()}
    assert got == {r.request_id: r.generated for r in v.pop_finished()}


def test_slot_near_max_seq_forces_the_vanilla_step(served):
    """positions + k past max_seq - 1: no spec step, the vanilla stream."""
    p, v = (_port(served, spec=s, max_seq=64, prefill_buckets=(64,), prefill_chunk_tokens=0)
            for s in (True, False))
    prompt = _prompts()[3][: 64 - K]  # positions + K = 64 > 63 from the first step
    sampling = PSampling(max_tokens=30, stop_token=-1)
    out = p.generate([prompt], sampling)[0]["token_ids"]
    assert p.stats["spec_steps"] == 0
    assert out == v.generate([prompt], sampling)[0]["token_ids"]


def test_burst_ending_at_max_seq_matches_the_reference(tmp_path_factory):
    """A slot exactly k rows clear of max_seq - 1 is eligible, and a fully
    accepted burst then ends at position max_seq, one token past where the
    vanilla engine stops: the reference's behaviour, kept for parity (the
    vanilla stream is a prefix of it). GPT-2 with itself as the draft, so
    the first burst is accepted whole."""
    _, jcfg, pcfg, _, _, path, _ = _served("gpt2", tmp_path_factory)
    serve = {**SERVE, "max_seq": 64, "prefill_buckets": (64,), "prefill_chunk_tokens": 0}
    self_draft = dict(spec_decode_tokens=K, draft_weights_path=path)  # the target itself
    j = JEngine(JLLMConfig(model_config=jcfg, weights_path=path, draft_model_config=jcfg,
                           **self_draft, **serve))
    p = PEngine(PLLMConfig(model_config=pcfg, weights_path=path, draft_model_config=pcfg,
                           **self_draft, **serve), device="cpu")
    v = PEngine(PLLMConfig(model_config=pcfg, weights_path=path, **serve), device="cpu")
    prompt = _prompts()[3][: 63 - K]  # eligible: positions + K == max_seq - 1
    jout = j.generate([prompt], JSampling(max_tokens=30, stop_token=-1))[0]["token_ids"]
    pout = p.generate([prompt], PSampling(max_tokens=30, stop_token=-1))[0]["token_ids"]
    vout = v.generate([prompt], PSampling(max_tokens=30, stop_token=-1))[0]["token_ids"]
    assert pout == jout and p.stats["spec_steps"] == j.stats["spec_steps"] == 1
    assert len(pout) == len(vout) + 1 and pout[: len(vout)] == vout


def test_chunked_prefill_joins_spec_steps_after_its_last_chunk(served):
    p = _port(served)
    p.add_request("c", _prompts()[3], PSampling(max_tokens=12))
    req = p.requests["c"]
    p.step()  # admission: the slot is taken, no chunk yet
    while req.prefilling:
        assert not req.spec_ready and p.stats["spec_steps"] == 0
        p.step()
    # The step of the last chunk samples the first token, prefills the
    # draft and runs a spec step with the request in it.
    assert p.stats["prefill_chunks"] == 4 and req.spec_ready
    assert p.stats["spec_steps"] == 1 and len(req.generated) >= 2


def test_configuration_errors(served):
    _, _, pcfg, _, pdraft, path, _ = served
    with pytest.raises(ValueError, match="draft_model_config"):
        PEngine(PLLMConfig(model_config=pcfg, spec_decode_tokens=K, **SERVE), device="cpu")
    other = dataclasses.replace(pdraft, vocab_size=pdraft.vocab_size * 2)
    with pytest.raises(ValueError, match="vocab"):
        PEngine(PLLMConfig(model_config=pcfg, spec_decode_tokens=K, draft_model_config=other,
                           **SERVE), device="cpu")
    engine = _port(served, spec=False)
    with pytest.raises(ValueError, match=">= 1"):
        SpecDecoder(engine, pdraft, 0)
    assert engine._spec is None and engine.stats["spec_steps"] == 0
    if not torch.cuda.is_available():  # the card is the default device
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PEngine(PLLMConfig(model_config=pcfg, spec_decode_tokens=K, draft_model_config=pdraft,
                               **SERVE))
