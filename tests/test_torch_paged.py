"""The port's paged KV cache against the JAX package's, on the CPU in f32.

- ``BlockManager``: the port's copy keeps the reference's accounting.
- ``paged_prefill`` then ``paged_decode``, for tiny GPT-2 and tiny Llama
  (``n_kv_head < n_head``), against ``ray_tpu.models.paged`` on the same
  numpy inputs: shuffled, non-contiguous block tables whose unused entries
  point at the scratch block 0, a prefix-continue prefill, and a decode
  batch with a free slot writing into the scratch block. Logits and every
  pool block but the scratch one agree at rtol=atol=1e-4.
- Paged against the port's own dense ``prefill`` / ``decode_step``.
- A prefill whose rows reach past the table raises, where the reference's
  scatter would clamp them into the table's last block.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm.block_manager import BlockManager as JBlockManager
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu.models import paged as jpaged
from ray_tpu_torch.llm.block_manager import BlockManager
from ray_tpu_torch.models import gpt2 as pgpt2
from ray_tpu_torch.models import gpt2_decode as pgpt2_decode
from ray_tpu_torch.models import llama as pllama
from ray_tpu_torch.models import llama_decode as pllama_decode
from ray_tpu_torch.models import paged as ppaged
from ray_tpu_torch.models.convert import gpt2_params_from_numpy, llama_params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
BLOCK = 8
W = 4  # table width: S = 32 rows
N_BLOCKS = 12


# -- BlockManager -------------------------------------------------------------


def test_block_manager_alloc_refcount_free():
    """The port of tests/test_llm_paged_kv.py::test_block_manager_alloc_refcount_free,
    run against the reference's class step by step."""
    m, ref = BlockManager(8), JBlockManager(8)  # 7 allocatable; block 0 scratch
    assert m.free_blocks == 7
    a = m.alloc(3)
    assert a == ref.alloc(3)  # the same LIFO order
    assert 0 not in a and len(set(a)) == 3
    assert m.used_blocks == 3
    m.incref(a[:1])
    assert m.refcount(a[0]) == 2
    freed = m.decref(a)
    assert freed == a[1:]  # a[0] still referenced
    assert m.decref(a[:1]) == a[:1]
    assert m.free_blocks == 7
    assert m.alloc(2) == [a[0], a[2]]  # freed blocks are reused first
    assert not m.can_alloc(6)
    with pytest.raises(RuntimeError, match="exhausted"):
        m.alloc(6)
    with pytest.raises(ValueError):
        BlockManager(1)


# -- the paged ops against JAX ------------------------------------------------


def _family(name):
    """(jax cfg, port cfg, jax params, port params, port dense module)."""
    rng = np.random.default_rng(1)
    if name == "gpt2":
        shape = dict(n_layer=2, d_model=64, n_head=2, vocab_size=512, max_seq=64)
        jcfg = dataclasses.replace(
            jgpt2.GPT2Config.tiny(**shape), dtype=jnp.float32, attn_impl="reference"
        )
        pcfg = dataclasses.replace(pgpt2.GPT2Config.tiny(**shape), dtype=torch.float32)
        init, convert, dense = pgpt2.init_params, gpt2_params_from_numpy, pgpt2_decode
    else:
        shape = dict(n_layer=2, d_model=64, n_head=4, n_kv_head=2, vocab_size=512, max_seq=64)
        jcfg = dataclasses.replace(
            jllama.LlamaConfig.tiny(**shape), dtype=jnp.float32, attn_impl="reference"
        )
        pcfg = dataclasses.replace(pllama.LlamaConfig.tiny(**shape), dtype=torch.float32)
        init, convert, dense = pllama.init_params, llama_params_from_numpy, pllama_decode
    # One numpy tree for both sides, with the norm scales and biases moved
    # off their init values so every leaf shows.
    tree = jax.tree.map(lambda t: t.numpy(), init(torch.Generator().manual_seed(0), pcfg, "cpu"))
    tree = jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(a.shape, dtype=np.float32), tree)
    return jcfg, pcfg, jax.tree.map(jnp.asarray, tree), convert(tree, pcfg, "cpu"), dense


@pytest.fixture(scope="module", params=["gpt2", "llama"])
def family(request):
    return _family(request.param)


def _tables():
    """Two requests on shuffled, non-contiguous blocks, unused entries on
    the scratch block; the third slot is free (all scratch)."""
    return np.array([[7, 3, 10, 0], [2, 9, 5, 0], [0, 0, 0, 0]], np.int64)


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def test_paged_prefill_and_decode_match_jax(family):
    jcfg, pcfg, jparams, pparams, _ = family
    jpf = jax.jit(functools.partial(jpaged.paged_prefill, cfg=jcfg, block_size=BLOCK))
    jdc = jax.jit(functools.partial(jpaged.paged_decode, cfg=jcfg, block_size=BLOCK))
    jpool = jpaged.init_block_pool(jcfg, N_BLOCKS, BLOCK)
    ppool = ppaged.init_block_pool(pcfg, N_BLOCKS, BLOCK, device="cpu")
    assert ppool["k"].shape == jpool["k"].shape
    tables = _tables()
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)

    def prefill(row, tokens, length, start):
        nonlocal jpool
        jpool, jlog = jpf(
            jparams, jnp.asarray(tokens), jnp.asarray(length, jnp.int32),
            jnp.asarray(start, jnp.int32), jnp.asarray(tables[row].astype(np.int32)), jpool,
        )
        _, plog = ppaged.paged_prefill(
            pparams, _t(tokens), length, start, _t(tables[row]), ppool, pcfg, block_size=BLOCK
        )
        np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), **TOL)

    # Request 0: a fresh 13-token prompt in a 16-row bucket (its padded rows
    # land in its own second block). Request 1: 8 rows, then a continue at
    # start=8 with a 5-token suffix in an 8-row bucket.
    padded = np.zeros((1, 16), np.int32)
    padded[0, :13] = toks[0, :13]
    prefill(0, padded, 13, 0)
    prefill(1, toks[1:, :8], 8, 0)
    suffix = np.zeros((1, 8), np.int32)
    suffix[0, :5] = toks[1, 8:13]
    prefill(1, suffix, 5, 8)

    positions = np.array([13, 13, 0], np.int64)
    for _ in range(6):  # teacher-forced, across request 0's block boundary
        last = np.array([toks[0, positions[0]], toks[1, positions[1]], 0], np.int32)
        jpool, jlog = jdc(
            jparams, jnp.asarray(last), jnp.asarray(positions.astype(np.int32)),
            jnp.asarray(tables.astype(np.int32)), jpool,
        )
        _, plog = ppaged.paged_decode(
            pparams, _t(last), _t(positions), _t(tables), ppool, pcfg, block_size=BLOCK
        )
        np.testing.assert_allclose(plog.numpy()[:2], np.asarray(jlog)[:2], **TOL)
        positions[:2] += 1
    for name in ("k", "v"):  # every block but the scratch one
        np.testing.assert_allclose(ppool[name][:, 1:].numpy(), np.asarray(jpool[name])[:, 1:], **TOL)


def test_paged_matches_dense(family):
    """Paged prefill + decode give the port's dense path's logits: the block
    layout may not change an output."""
    _, pcfg, _, pparams, dense = family
    toks = _t(np.random.default_rng(3).integers(0, pcfg.vocab_size, (1, 14)))
    T0, S = 6, W * BLOCK
    table = _t(_tables()[0])
    pool = ppaged.init_block_pool(pcfg, N_BLOCKS, BLOCK, device="cpu")
    cache = dense.init_kv_cache(pcfg, 1, S, device="cpu")
    _, want = dense.prefill(pparams, toks[:, :T0], torch.tensor([T0]), cache, pcfg)
    _, got = ppaged.paged_prefill(pparams, toks[:, :T0], T0, 0, table, pool, pcfg, block_size=BLOCK)
    np.testing.assert_allclose(got.numpy(), want[0].numpy(), **TOL)
    hooks = ppaged._family(pcfg, S, "cpu")  # as the engine builds them, once
    for t in range(T0, toks.shape[1]):
        pos = torch.tensor([t])
        _, want = dense.decode_step(pparams, toks[:, t], pos, cache, pcfg)
        _, got = ppaged.paged_decode(
            pparams, toks[:, t], pos, table[None], pool, pcfg, block_size=BLOCK, hooks=hooks
        )
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_paged_prefill_past_the_table_raises():
    """start + T > W * block: the reference's ``table[pos // block]`` would
    clamp into the table's last entry (the request's own last block) and
    overwrite its KV; the port raises before writing anything."""
    _, pcfg, _, pparams, _ = _family("gpt2")
    pool = ppaged.init_block_pool(pcfg, N_BLOCKS, BLOCK, device="cpu")
    table = _t(_tables()[0])
    toks = torch.zeros((1, 16), dtype=torch.long)
    with pytest.raises(ValueError, match="does not fit"):
        ppaged.paged_prefill(pparams, toks, 4, 24, table, pool, pcfg, block_size=BLOCK)
    with pytest.raises(ValueError, match="does not fit"):
        ppaged.paged_prefill(pparams, toks.expand(2, -1), 4, 0, table, pool, pcfg, block_size=BLOCK)
    assert not pool["k"].any() and not pool["v"].any()
    # The same call inside the table goes through.
    ppaged.paged_prefill(pparams, toks, 4, 16, table, pool, pcfg, block_size=BLOCK)
    assert pool["k"][:, 10].any() and not pool["k"][:, 7].any()
