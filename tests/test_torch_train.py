"""The port's training slice against the JAX package's, on the CPU in f32.

The chunked LM loss, ``loss_fn`` with and without chunks, the remat
policies, ``default_optimizer`` and five steps of ``make_train_step`` go
through ``ray_tpu`` and ``ray_tpu_torch`` on the same numpy inputs.
Parameters come from ``ray_tpu.models.gpt2.init_params`` and are converted
by ``ray_tpu_torch.models.convert``. Tolerances: 1e-5 for the loss (one
f32 reduction over a few hundred logits), 1e-6 for the optimizer (the same
f32 arithmetic), 1e-4 for a trajectory (as the rest of the port's tests).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import common as jcommon
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.train import spmd as jspmd
from ray_tpu_torch.models import common as pcommon
from ray_tpu_torch.models import gpt2 as pgpt2
from ray_tpu_torch.models.convert import gpt2_params_from_numpy
from ray_tpu_torch.train import spmd as pspmd

SHAPE = dict(n_layer=2, d_model=64, n_head=2, vocab_size=256, max_seq=32)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(
        jgpt2.GPT2Config.tiny(**SHAPE), dtype=jnp.float32, attn_impl="reference"
    )
    pcfg = dataclasses.replace(pgpt2.GPT2Config.tiny(**SHAPE), dtype=torch.float32)
    tree = jax.tree.map(np.asarray, jgpt2.init_params(jax.random.key(0), jcfg))
    # Non-trivial LN and bias leaves, so every gradient path shows.
    rng = np.random.default_rng(1)
    tree = jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(a.shape, dtype=np.float32), tree)
    return jcfg, tree, pcfg


def _tokens(seed, shape, vocab=SHAPE["vocab_size"]):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _torch_params(tree, pcfg, requires_grad=False):
    params = gpt2_params_from_numpy(tree, pcfg, "cpu")
    return pspmd._tree_map(lambda t: t.requires_grad_(requires_grad), params)


@pytest.mark.parametrize("S,chunk", [(24, 8), (20, 8)], ids=["whole-chunks", "ragged-last-chunk"])
def test_chunked_lm_loss_matches_jax(S, chunk):
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 16), dtype=np.float32)
    wte = 0.3 * rng.standard_normal((40, 16), dtype=np.float32)
    targets = rng.integers(0, 40, (2, S)).astype(np.int32)
    targets[0, 3] = -1  # a masked target adds zero, as padding does

    def jloss(x, wte):
        return jcommon.chunked_lm_loss(x, wte, jnp.asarray(targets), chunk)

    want, (jdx, jdw) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(x, wte)
    tx, tw = (torch.tensor(a, requires_grad=True) for a in (x, wte))
    got = pcommon.chunked_lm_loss(tx, tw, torch.from_numpy(targets), chunk)
    dx, dw = torch.autograd.grad(got, (tx, tw))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **LOSS_TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), **LOSS_TOL)


@pytest.mark.parametrize(
    "loss_chunk,with_targets",
    [(0, False), (8, False), (7, True), (32, True)],
    ids=["unchunked", "chunked", "chunked-ragged-targets", "chunk-past-S"],
)
def test_loss_fn_matches_jax(models, loss_chunk, with_targets):
    jcfg, tree, pcfg = models
    jcfg = dataclasses.replace(jcfg, loss_chunk=loss_chunk)
    pcfg = dataclasses.replace(pcfg, loss_chunk=loss_chunk)
    toks = _tokens(loss_chunk, (2, 21))
    if with_targets:
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    else:
        batch = {"tokens": toks}
    (want, jmetrics), jgrads = jax.jit(
        jax.value_and_grad(functools.partial(jgpt2.loss_fn, cfg=jcfg), has_aux=True)
    )(tree, batch)
    params = _torch_params(tree, pcfg, requires_grad=True)
    got, metrics = pgpt2.loss_fn(params, {k: torch.from_numpy(v) for k, v in batch.items()}, pcfg)
    grads = torch.autograd.grad(got, pspmd.tree_leaves(params))
    np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)
    assert metrics["loss"].item() == got.item() and not metrics["loss"].requires_grad
    assert metrics["tokens"].item() == int(jmetrics["tokens"]) == 2 * 20
    for g, jg in zip(grads, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-5)


def test_remat_policies_give_identical_gradients(models):
    _, tree, pcfg = models
    toks = torch.from_numpy(_tokens(5, (2, 17)))
    grads = {}
    for remat in ("full", "dots", "mlp", "none", True, False):
        cfg = dataclasses.replace(pcfg, remat=remat, loss_chunk=8)
        params = _torch_params(tree, cfg, requires_grad=True)
        loss, _ = pgpt2.loss_fn(params, {"tokens": toks}, cfg)
        grads[remat] = torch.autograd.grad(loss, pspmd.tree_leaves(params))
    for remat, gs in grads.items():
        for g, g0 in zip(gs, grads["none"]):
            assert torch.equal(g, g0), remat


def test_remat_policy_resolution(models):
    _, _, pcfg = models
    x = torch.zeros(1, 4, SHAPE["d_model"])
    want = {"full": "full", "dots": "dots", True: "full", False: "none", "none": "none"}
    for remat, policy in want.items():
        assert pgpt2.remat_policy(dataclasses.replace(pcfg, remat=remat), x) == policy
    # "mlp" keeps attention outside the checkpoint only where the flash
    # kernel saves its residuals: never for a CPU tensor.
    assert pgpt2.remat_policy(dataclasses.replace(pcfg, remat="mlp"), x) == "dots"
    with pytest.raises(ValueError, match="remat"):
        pgpt2.remat_policy(dataclasses.replace(pcfg, remat="some"), x)


def test_default_optimizer_matches_optax():
    """Five updates on a fixed gradient sequence: norms above the clip
    (scaled down) and below it (kept), through warmup and cosine decay."""
    rng = np.random.default_rng(0)
    tree = {
        "w": rng.standard_normal((6, 5), dtype=np.float32),
        "blocks": {"b": rng.standard_normal(7, dtype=np.float32)},
    }
    jopt = jspmd.default_optimizer(warmup_steps=2, total_steps=5)
    popt = pspmd.default_optimizer(warmup_steps=2, total_steps=5)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    jupdate = jax.jit(jopt.update)
    params = pspmd._tree_map(torch.tensor, tree)
    pstate = popt.init(params)
    norms = []
    for scale in (3.0, 0.01, 1.0, 0.05, 4.0):
        g = jax.tree.map(lambda a: scale * rng.standard_normal(a.shape, dtype=np.float32), tree)
        norms.append(float(optax.global_norm(g)))
        updates, jstate = jupdate(g, jstate, jparams)
        jparams = jax.tree.map(jnp.add, jparams, updates)
        popt.update_([torch.tensor(a) for a in jax.tree.leaves(g)], pstate, pspmd.tree_leaves(params))
        for got, want in zip(pspmd.tree_leaves(params), jax.tree.leaves(jparams)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert min(norms) < 1.0 < max(norms)
    assert pstate["count"] == int(jstate[1][0].count) == 5


def test_schedule_matches_optax():
    for warmup, total in ((3, 10), (2, 2), (0, 4)):
        ours = pspmd.default_optimizer(warmup_steps=warmup, total_steps=total)
        sched = optax.warmup_cosine_decay_schedule(
            0.0, 3e-4, warmup, max(total, warmup + 1), 3e-5
        )
        for t in range(total + 3):
            np.testing.assert_allclose(ours.schedule(t), float(sched(t)), rtol=1e-6, atol=1e-12)
    assert pspmd.default_optimizer().schedule(0) == 0.0


def test_train_steps_match_jax(models):
    """Five steps of the port's make_train_step against JAX's
    make_train_step(donate_state=False), from the same params and batch."""
    jcfg, tree, pcfg = models
    toks = _tokens(9, (2, 17))
    opt_kw = dict(lr=1e-3, warmup_steps=2, total_steps=5)

    jopt = jspmd.default_optimizer(**opt_kw)
    jstate = jspmd.make_train_state(
        lambda _: jax.tree.map(jnp.asarray, tree), jopt, jax.random.key(0)
    )
    jstep = jspmd.make_train_step(
        functools.partial(jgpt2.loss_fn, cfg=jcfg), jopt, donate_state=False
    )
    popt = pspmd.default_optimizer(**opt_kw)
    state = pspmd.make_train_state(
        lambda _: gpt2_params_from_numpy(tree, pcfg, "cpu"), popt, torch.Generator(), "cpu"
    )
    step = pspmd.make_train_step(functools.partial(pgpt2.loss_fn, cfg=pcfg), popt)
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
