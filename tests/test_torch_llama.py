"""The port's Llama (forward, prefill, decode, prefill_continue, the
conversion of parameters) against the JAX package's, on the CPU in f32.

Parameters are one numpy tree (the port's ``init_params`` on the CPU,
perturbed so the norm scales are not all ones): the JAX side takes it as
it is, the port through ``ray_tpu_torch.models.convert.llama_params_from_numpy``,
key for key. Token ids come from numpy. ``n_kv_head < n_head`` throughout, so grouped-query attention
and its head order are in every comparison. Tolerance rtol=atol=1e-4, as
``tests/test_llm.py`` holds the JAX decode path against the JAX forward.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.models import llama_decode as jdec
from ray_tpu_torch.models import llama as pllama
from ray_tpu_torch.models import llama_decode as pdec
from ray_tpu_torch.models.convert import llama_params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
SHAPE = dict(n_layer=2, d_model=64, n_head=4, n_kv_head=2, vocab_size=512, max_seq=64)


def _configs(**shape):
    jcfg = dataclasses.replace(
        jllama.LlamaConfig.tiny(**shape), dtype=jnp.float32, attn_impl="reference"
    )
    pcfg = dataclasses.replace(pllama.LlamaConfig.tiny(**shape), dtype=torch.float32)
    return jcfg, pcfg


def _params(jcfg, pcfg, seed=0):
    init = pllama.init_params(torch.Generator().manual_seed(seed), pcfg, device="cpu")
    tree = jax.tree.map(lambda t: t.numpy(), init)
    rng = np.random.default_rng(seed + 1)
    tree = jax.tree.map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape, dtype=np.float32), tree
    )
    return jax.tree.map(jnp.asarray, tree), llama_params_from_numpy(tree, pcfg, "cpu")


@pytest.fixture(scope="module")
def models():
    jcfg, pcfg = _configs(**SHAPE)
    return (jcfg, pcfg, *_params(jcfg, pcfg))


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@pytest.mark.parametrize("n_kv_head", [1, 2, 4])
def test_forward_matches_jax(n_kv_head):
    jcfg, pcfg = _configs(**{**SHAPE, "n_kv_head": n_kv_head})
    jparams, pparams = _params(jcfg, pcfg)
    toks = _tokens(2, (2, 24), jcfg.vocab_size)
    want = np.asarray(jllama.forward(jparams, jnp.asarray(toks), jcfg))
    got = pllama.forward(pparams, torch.from_numpy(toks).long(), pcfg)
    assert got.shape == (2, 24, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert pllama.num_params(pcfg) == jllama.num_params(jcfg)


def test_gqa_head_order_is_repeat_interleave(models, monkeypatch):
    """Each KV head serves its own group of query heads in a row, as
    ``jnp.repeat(t, group, axis=1)`` has it; tiling the heads
    (``Tensor.repeat``) would pair query head 1 with KV head 1, not 0."""
    jcfg, pcfg, jparams, pparams = models
    t = np.random.default_rng(0).standard_normal((1, 2, 3, 4)).astype(np.float32)
    got = pllama.expand_kv(torch.from_numpy(t), 2).numpy()
    np.testing.assert_array_equal(got, np.asarray(jdec._expand_kv(jnp.asarray(t), 2)))
    assert not np.array_equal(got, np.tile(t, (1, 2, 1, 1)))

    # A forward with tiled heads disagrees with the reference at once.
    toks = _tokens(5, (1, 16), jcfg.vocab_size)
    want = np.asarray(jllama.forward(jparams, jnp.asarray(toks), jcfg))
    got = pllama.forward(pparams, torch.from_numpy(toks).long(), pcfg).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    monkeypatch.setattr(pllama, "expand_kv", lambda t, group: t.repeat(1, group, 1, 1))
    wrong = pllama.forward(pparams, torch.from_numpy(toks).long(), pcfg).numpy()
    assert np.abs(wrong - want).max() > 1e-2


def test_prefill_and_teacher_forced_decode_match_jax(models):
    """The port of tests/test_llm.py::test_decode_matches_full_forward for
    Llama, held against the JAX decode path step by step, with ragged
    prompt lengths."""
    jcfg, pcfg, jparams, pparams = models
    toks = _tokens(3, (2, 12), jcfg.vocab_size)
    T0, S = 8, 32
    lengths = np.array([T0, T0 - 3], np.int32)

    jdecode = jax.jit(functools.partial(jdec.decode_step, cfg=jcfg))  # one compile
    jcache, jlog = jdec.prefill(
        jparams, jnp.asarray(toks[:, :T0]), jnp.asarray(lengths),
        jdec.init_kv_cache(jcfg, 2, S), jcfg,
    )
    pcache, plog = pdec.prefill(
        pparams, torch.from_numpy(toks[:, :T0]).long(), torch.from_numpy(lengths),
        pdec.init_kv_cache(pcfg, 2, S, device="cpu"), pcfg,
    )
    assert pcache["k"].shape == (2, 2, 2, S, 16)  # [L, B, KH, S, Dh]: unexpanded
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), **TOL)
    np.testing.assert_allclose(pcache["k"].numpy(), np.asarray(jcache["k"]), **TOL)

    positions = lengths.copy()
    for _ in range(T0, toks.shape[1]):
        step_toks = toks[np.arange(2), np.minimum(positions, toks.shape[1] - 1)]
        jcache, jlog = jdecode(jparams, jnp.asarray(step_toks), jnp.asarray(positions), jcache)
        pcache, plog = pdec.decode_step(
            pparams, torch.from_numpy(step_toks).long(), torch.from_numpy(positions),
            pcache, pcfg,
        )
        np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), **TOL)
        positions += 1
    np.testing.assert_allclose(pcache["v"].numpy(), np.asarray(jcache["v"]), **TOL)
    np.testing.assert_allclose(pcache["k"].numpy(), np.asarray(jcache["k"]), **TOL)


def test_prefill_continue_matches_jax(models):
    jcfg, pcfg, jparams, pparams = models
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
    jcfg, pcfg, jparams, pparams = models
    bf16 = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)), jparams)
    conv = llama_params_from_numpy(bf16, pcfg, "cpu")
    for key in ("wk", "w_down"):
        want = bf16["blocks"][key].view(np.uint16)
        got = conv["blocks"][key].view(torch.int16).numpy().view(np.uint16)
        assert conv["blocks"][key].dtype == torch.bfloat16
        np.testing.assert_array_equal(got, want)

    # compute_params: matmul leaves and the head cast once, norms untouched.
    bcfg = dataclasses.replace(pcfg, dtype=torch.bfloat16)
    cp = pllama.compute_params(pparams, bcfg)
    assert cp["blocks"]["w_gate"].dtype == torch.bfloat16
    assert cp["lm_head"].dtype == torch.bfloat16
    assert cp["blocks"]["attn_norm"].dtype == torch.float32
    assert cp["final_norm"].dtype == torch.float32
    assert torch.equal(cp["blocks"]["wq"], pparams["blocks"]["wq"].to(torch.bfloat16))

    bad = jax.tree.map(np.asarray, jparams)
    bad["blocks"]["wk"] = bad["blocks"]["wk"][..., :-1]
    with pytest.raises(ValueError, match="wk"):
        llama_params_from_numpy(bad, pcfg, "cpu")
    del bad["lm_head"]
    with pytest.raises(ValueError, match="keys"):
        llama_params_from_numpy(bad, pcfg, "cpu")


def test_entry_points_default_to_the_card(models):
    """init_params and the conversion run on the card unless the caller asks
    for the CPU; with no GPU they raise. A mesh (sp/pp) raises: not ported."""
    _, pcfg, jparams, pparams = models
    tree = jax.tree.map(np.asarray, jparams)
    gen = torch.Generator().manual_seed(0)
    on_cpu = pllama.init_params(gen, pcfg, device="cpu")
    assert on_cpu["blocks"]["wk"].shape == (2, 64, 32)
    assert on_cpu["blocks"]["wk"].dtype == pcfg.param_dtype
    if torch.cuda.is_available():
        assert pllama.init_params(gen, pcfg)["wte"].is_cuda
        assert llama_params_from_numpy(tree, pcfg)["wte"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pllama.init_params(gen, pcfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            llama_params_from_numpy(tree, pcfg)
    with pytest.raises(TypeError):
        pdec.init_kv_cache(pcfg, 1, 8)  # device is required
    with pytest.raises(TypeError, match="expected a ray_tpu_torch.parallel.Mesh"):
        pllama.forward(pparams, torch.zeros((1, 4), dtype=torch.long), pcfg, mesh=object())
    assert pllama.LlamaConfig.llama_125m().head_dim == 64
