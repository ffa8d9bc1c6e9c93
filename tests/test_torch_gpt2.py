"""The port's dense GPT-2 (forward, prefill, decode, prefill_continue)
against the JAX package's, on the CPU in f32.

Parameters come from ``ray_tpu.models.gpt2.init_params`` and are converted
key for key by ``ray_tpu_torch.models.convert``; token ids come from numpy.
Tolerance rtol=atol=1e-4, as ``tests/test_llm.py`` holds the JAX decode path
against the JAX forward.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import gpt2_decode as jdec
from ray_tpu_torch.models import gpt2 as pgpt2
from ray_tpu_torch.models import gpt2_decode as pdec
from ray_tpu_torch.models.convert import gpt2_params_from_numpy
from ray_tpu_torch.parallel import Mesh, MeshSpec

TOL = dict(rtol=1e-4, atol=1e-4)
SHAPE = dict(n_layer=2, d_model=64, n_head=2, vocab_size=512, max_seq=64)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(
        jgpt2.GPT2Config.tiny(**SHAPE), dtype=jnp.float32, attn_impl="reference"
    )
    pcfg = dataclasses.replace(pgpt2.GPT2Config.tiny(**SHAPE), dtype=torch.float32)
    jparams = jgpt2.init_params(jax.random.key(0), jcfg)
    # Non-trivial LN and bias leaves, so the conversion of every key shows.
    rng = np.random.default_rng(1)
    tree = jax.tree.map(np.asarray, jparams)
    tree = jax.tree.map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape, dtype=np.float32), tree
    )
    jparams = jax.tree.map(jnp.asarray, tree)
    return jcfg, jparams, pcfg, gpt2_params_from_numpy(tree, pcfg, "cpu")


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def test_forward_matches_jax(models):
    jcfg, jparams, pcfg, pparams = models
    toks = _tokens(2, (2, 24), jcfg.vocab_size)
    want = np.asarray(jgpt2.forward(jparams, jnp.asarray(toks), jcfg))
    got = pgpt2.forward(pparams, torch.from_numpy(toks).long(), pcfg)
    assert got.shape == (2, 24, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert pgpt2.num_params(pcfg) == jgpt2.num_params(jcfg)


def test_prefill_and_teacher_forced_decode_match_jax(models):
    """The port of tests/test_llm.py::test_decode_matches_full_forward, held
    against the JAX decode path step by step, with ragged prompt lengths."""
    jcfg, jparams, pcfg, pparams = models
    toks = _tokens(3, (2, 12), jcfg.vocab_size)
    T0, S = 8, 32
    lengths = np.array([T0, T0 - 3], np.int32)

    jdecode = jax.jit(functools.partial(jdec.decode_step, cfg=jcfg))  # one compile
    jcache = jdec.init_kv_cache(jcfg, 2, S)
    jcache, jlog = jdec.prefill(
        jparams, jnp.asarray(toks[:, :T0]), jnp.asarray(lengths), jcache, jcfg
    )
    pcache = pdec.init_kv_cache(pcfg, 2, S, device="cpu")
    pcache, plog = pdec.prefill(
        pparams, torch.from_numpy(toks[:, :T0]).long(), torch.from_numpy(lengths),
        pcache, pcfg,
    )
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), **TOL)
    np.testing.assert_allclose(pcache["k"].numpy(), np.asarray(jcache["k"]), **TOL)

    positions = lengths.copy()
    for t in range(T0, toks.shape[1]):
        step_toks = toks[np.arange(2), np.minimum(positions, toks.shape[1] - 1)]
        jcache, jlog = jdecode(
            jparams, jnp.asarray(step_toks), jnp.asarray(positions), jcache
        )
        pcache, plog = pdec.decode_step(
            pparams, torch.from_numpy(step_toks).long(), torch.from_numpy(positions),
            pcache, pcfg,
        )
        np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), **TOL)
        positions += 1
    np.testing.assert_allclose(pcache["v"].numpy(), np.asarray(jcache["v"]), **TOL)


def test_prefill_continue_matches_jax(models):
    jcfg, jparams, pcfg, pparams = models
    prompt = _tokens(4, (1, 45), jcfg.vocab_size)
    P, T, S = 32, 16, 64  # cached prefix, padded suffix bucket, cache rows
    rem = prompt.shape[1] - P
    suffix = np.zeros((1, T), np.int32)
    suffix[0, :rem] = prompt[0, P:]

    jcache, _ = jdec.prefill(
        jparams, jnp.asarray(prompt[:, :P]), jnp.asarray([P], jnp.int32),
        jdec.init_kv_cache(jcfg, 1, S), jcfg,
    )
    jcache, jlog = jdec.prefill_continue(
        jparams, jnp.asarray(suffix), jnp.asarray([rem], jnp.int32),
        jnp.asarray(P, jnp.int32), jcache, jcfg,
    )
    pcache, _ = pdec.prefill(
        pparams, torch.from_numpy(prompt[:, :P]).long(), torch.tensor([P]),
        pdec.init_kv_cache(pcfg, 1, S, device="cpu"), pcfg,
    )
    pcache, plog = pdec.prefill_continue(
        pparams, torch.from_numpy(suffix).long(), torch.tensor([rem]), P, pcache, pcfg
    )
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), **TOL)
    np.testing.assert_allclose(pcache["k"].numpy(), np.asarray(jcache["k"]), **TOL)
    # A padded write past the cache raises instead of being start-clamped.
    with pytest.raises(ValueError, match="do not fit"):
        pdec.prefill_continue(
            pparams, torch.from_numpy(suffix).long(), torch.tensor([rem]), S - 8,
            pcache, pcfg,
        )


def test_convert_bf16_tree_bit_exact_and_compute_params(models):
    jcfg, jparams, pcfg, pparams = models
    bf16 = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)), jparams)
    conv = gpt2_params_from_numpy(bf16, pcfg, "cpu")
    want = bf16["blocks"]["qkv_w"].view(np.uint16)
    got = conv["blocks"]["qkv_w"].view(torch.int16).numpy().view(np.uint16)
    assert conv["blocks"]["qkv_w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got, want)

    # compute_params: matmul leaves cast once, LN leaves untouched.
    bcfg = dataclasses.replace(pcfg, dtype=torch.bfloat16)
    cp = pgpt2.compute_params(pparams, bcfg)
    assert cp["blocks"]["fc_w"].dtype == torch.bfloat16
    assert cp["blocks"]["ln1_scale"].dtype == torch.float32
    assert torch.equal(cp["blocks"]["fc_w"], pparams["blocks"]["fc_w"].to(torch.bfloat16))

    bad = jax.tree.map(np.asarray, jparams)
    bad["wpe"] = bad["wpe"][:-1]
    with pytest.raises(ValueError, match="wpe"):
        gpt2_params_from_numpy(bad, pcfg, "cpu")


def test_unported_variants_raise(models):
    """Every variant of the reference runs now (the GPipe pipeline's
    ``pipeline_microbatches``, meshes over sp and pp), so what raises is
    what the port cannot compute on: leaves that are not the mesh's local
    shards raise ``ValueError`` naming the mesh (whole leaves under fsdp,
    tp or pp, shards given with no mesh), a mesh that names a shape only
    raises where a rank's place on an axis is needed (sp), and a mesh of
    another kind raises ``TypeError``. Off a mesh the microbatches change
    nothing, nor do the dp and ep axes of a dense model."""
    _, _, pcfg, pparams = models
    toks = torch.zeros((1, 4), dtype=torch.long)
    want = pgpt2.forward(pparams, toks, pcfg)
    cfg = dataclasses.replace(pcfg, pipeline_microbatches=2)
    assert pgpt2.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert torch.equal(pgpt2.forward(pparams, toks, cfg), want)
    with pytest.raises(ValueError, match="axis 'sp' has size 2 but this mesh has no DeviceMesh"):
        pgpt2.forward(pparams, toks, pcfg, mesh=Mesh(MeshSpec(sp=2)))
    with pytest.raises(ValueError, match="blocks hold 2 layers, not 1.*'pp': 2.*mesh="):
        pgpt2.forward(pparams, toks, pcfg, mesh=Mesh(MeshSpec(pp=2)))
    for axis in ("fsdp", "tp"):
        with pytest.raises(ValueError, match=f"'{axis}': 2.*mesh="):
            pgpt2.forward(pparams, toks, pcfg, mesh=Mesh(MeshSpec(**{axis: 2})))
    shard = dict(pparams, wte=pparams["wte"][:, : pcfg.d_model // 2])
    with pytest.raises(ValueError, match="no mesh was given.*mesh="):
        pgpt2.forward(shard, toks, pcfg)
    with pytest.raises(TypeError, match="expected a ray_tpu_torch.parallel.Mesh"):
        pgpt2.forward(pparams, toks, pcfg, mesh=object())
    assert torch.equal(pgpt2.forward(pparams, toks, pcfg, mesh=Mesh(MeshSpec(dp=2, ep=2))), want)


def test_entry_points_default_to_the_card(models):
    """init_params and the conversion run on the card unless the caller asks
    for the CPU; with no GPU they raise instead of carrying on there. The
    cache names its device every time."""
    _, jparams, pcfg, _ = models
    tree = jax.tree.map(np.asarray, jparams)
    gen = torch.Generator().manual_seed(0)
    on_cpu = pgpt2.init_params(gen, pcfg, device="cpu")
    assert on_cpu["blocks"]["qkv_w"].device.type == "cpu"
    assert on_cpu["blocks"]["qkv_w"].dtype == pcfg.param_dtype
    if torch.cuda.is_available():
        assert pgpt2.init_params(gen, pcfg)["wte"].is_cuda
        assert gpt2_params_from_numpy(tree, pcfg)["wte"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pgpt2.init_params(gen, pcfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            gpt2_params_from_numpy(tree, pcfg)
    with pytest.raises(TypeError):
        pdec.init_kv_cache(pcfg, 1, 8)  # device is required
