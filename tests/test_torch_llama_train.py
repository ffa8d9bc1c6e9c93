"""The port's Llama training against the JAX package's, on the CPU in f32.

``loss_fn`` and its gradients (unchunked, and chunked with a ragged last
chunk; with and without ``targets``), the remat policies, and five steps of
``make_train_step`` go through ``ray_tpu`` and ``ray_tpu_torch`` on the same
numpy inputs. Parameters come from ``ray_tpu.models.llama.init_params``,
perturbed so the norm scales are not all ones, and are converted by
``ray_tpu_torch.models.convert.llama_params_from_numpy``. Grouped-query
attention (4 query heads over 2 KV heads) is in every comparison, so the
gradients of the repeated K/V are summed over each group. Tolerances: 1e-5
for the loss and its gradients, 1e-4 for a five-step trajectory.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.train import spmd as jspmd
from ray_tpu_torch.models import common as pcommon
from ray_tpu_torch.models import llama as pllama
from ray_tpu_torch.models.convert import llama_params_from_numpy
from ray_tpu_torch.train import spmd as pspmd

SHAPE = dict(n_layer=2, d_model=64, n_head=4, n_kv_head=2, vocab_size=256, max_seq=32)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(
        jllama.LlamaConfig.tiny(**SHAPE), dtype=jnp.float32, attn_impl="reference"
    )
    pcfg = dataclasses.replace(pllama.LlamaConfig.tiny(**SHAPE), dtype=torch.float32)
    tree = jax.tree.map(np.asarray, jllama.init_params(jax.random.key(0), jcfg))
    rng = np.random.default_rng(1)
    tree = jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(a.shape, dtype=np.float32), tree)
    return jcfg, tree, pcfg


def _tokens(seed, shape, vocab=SHAPE["vocab_size"]):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _torch_params(tree, pcfg, requires_grad=False):
    params = llama_params_from_numpy(tree, pcfg, "cpu")
    return pspmd._tree_map(lambda t: t.requires_grad_(requires_grad), params)


def test_config_defaults_match_the_reference_and_train_on_the_card(models):
    """remat and loss_chunk default as the reference's; the train state goes
    to the card unless the caller asks for the CPU (with no GPU, it raises)."""
    cfg, ref = pllama.LlamaConfig.llama_125m(), jllama.LlamaConfig.llama_125m()
    assert (cfg.remat, cfg.loss_chunk) == (ref.remat, ref.loss_chunk) == ("mlp", 128)
    _, tree, pcfg = models
    init = lambda _: llama_params_from_numpy(tree, pcfg, "cpu")  # noqa: E731
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pspmd.make_train_state(init, pspmd.default_optimizer(), torch.Generator())


@pytest.mark.parametrize(
    "loss_chunk,with_targets",
    [(0, False), (0, True), (7, False), (7, True)],
    ids=["unchunked", "unchunked-targets", "chunked-ragged", "chunked-ragged-targets"],
)
def test_loss_fn_matches_jax(models, loss_chunk, with_targets):
    """S = 20 positions: chunks of 7, 7 and a ragged 6."""
    jcfg, tree, pcfg = models
    jcfg = dataclasses.replace(jcfg, loss_chunk=loss_chunk)
    pcfg = dataclasses.replace(pcfg, loss_chunk=loss_chunk)
    toks = _tokens(loss_chunk + with_targets, (2, 21))
    if with_targets:
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    else:
        batch = {"tokens": toks}
    (want, jmetrics), jgrads = jax.jit(
        jax.value_and_grad(functools.partial(jllama.loss_fn, cfg=jcfg), has_aux=True)
    )(tree, batch)
    params = _torch_params(tree, pcfg, requires_grad=True)
    got, metrics = pllama.loss_fn(params, {k: torch.from_numpy(v) for k, v in batch.items()}, pcfg)
    grads = torch.autograd.grad(got, pspmd.tree_leaves(params))
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    assert metrics["loss"].item() == got.item() and not metrics["loss"].requires_grad
    assert metrics["tokens"].item() == int(jmetrics["tokens"]) == 2 * 20
    assert len(grads) == len(jax.tree.leaves(jgrads))
    for g, jg in zip(grads, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)


def test_remat_policies_give_identical_gradients(models):
    _, tree, pcfg = models
    toks = torch.from_numpy(_tokens(5, (2, 17)))
    grads = {}
    for remat in ("full", "dots", "mlp", "none"):
        cfg = dataclasses.replace(pcfg, remat=remat, loss_chunk=8)
        params = _torch_params(tree, cfg, requires_grad=True)
        loss, _ = pllama.loss_fn(params, {"tokens": toks}, cfg)
        grads[remat] = torch.autograd.grad(loss, pspmd.tree_leaves(params))
    for remat, gs in grads.items():
        for g, g0 in zip(gs, grads["none"]):
            assert torch.equal(g, g0), remat


def test_remat_policy_resolution(models):
    """"mlp" keeps attention outside the checkpoint only where the flash
    kernel saves its residuals, never for a CPU tensor; an unknown policy
    raises, with grad or without."""
    _, tree, pcfg = models
    x = torch.zeros(1, 4, SHAPE["d_model"])
    for remat in ("full", "dots", "none"):
        assert pcommon.remat_policy(dataclasses.replace(pcfg, remat=remat), x) == remat
    assert pcommon.remat_policy(pcfg, x) == "dots" and pcfg.remat == "mlp"
    bad = dataclasses.replace(pcfg, remat="some")
    params = _torch_params(tree, bad)
    toks = torch.from_numpy(_tokens(6, (1, 9)))
    with pytest.raises(ValueError, match="remat"):
        pllama.loss_fn(params, {"tokens": toks}, bad)
    with torch.no_grad(), pytest.raises(ValueError, match="remat"):
        pllama.forward(params, toks, bad)


def test_train_steps_match_jax(models):
    """Five steps of the port's make_train_step against JAX's
    make_train_step(donate_state=False), from the same params and batch, at
    the default loss_chunk past S (one unchunked product)."""
    jcfg, tree, pcfg = models
    toks = _tokens(9, (2, 17))
    opt_kw = dict(lr=1e-3, warmup_steps=2, total_steps=5)

    jopt = jspmd.default_optimizer(**opt_kw)
    jstate = jspmd.make_train_state(
        lambda _: jax.tree.map(jnp.asarray, tree), jopt, jax.random.key(0)
    )
    jstep = jspmd.make_train_step(
        functools.partial(jllama.loss_fn, cfg=jcfg), jopt, donate_state=False
    )
    popt = pspmd.default_optimizer(**opt_kw)
    state = pspmd.make_train_state(
        lambda _: llama_params_from_numpy(tree, pcfg, "cpu"), popt, torch.Generator(), "cpu"
    )
    step = pspmd.make_train_step(functools.partial(pllama.loss_fn, cfg=pcfg), popt)
    jbatch, batch = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    want, got = [], []
    for _ in range(5):
        jstate, jm = jstep(jstate, jbatch)
        state, m = step(state, batch)
        want.append(float(jm["loss"]))
        got.append(m["loss"].item())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert got[-1] < got[0]
    assert state["step"] == int(jstate["step"]) == 5
    for p, jp in zip(pspmd.tree_leaves(state["params"]), jax.tree.leaves(jstate["params"])):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-4, atol=1e-4)
