"""The port's mixture-of-experts GPT-2 against the JAX package's, on the CPU
in f32, on one device.

The switch layer alone, the loss with its load-balancing term and every
gradient, the remat rule, the conversion of an MoE tree and five training
steps go through ``ray_tpu`` and ``ray_tpu_torch`` on the same numpy inputs,
at capacity 1.5 with 4 experts and at capacity 0.25 with 2 experts (tokens
dropped). Tolerances are the JAX suite's (``tests/test_parallel_pp_ep.py``):
loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-6; a trajectory 1e-4.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.train import spmd as jspmd
from ray_tpu_torch.models import common as pcommon
from ray_tpu_torch.models import gpt2 as pgpt2
from ray_tpu_torch.models.convert import gpt2_params_from_numpy
from ray_tpu_torch.parallel import local_mesh
from ray_tpu_torch.train import spmd as pspmd

SHAPE = dict(n_layer=2, d_model=64, n_head=2, vocab_size=256, max_seq=32)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
MOE = {"e4-cap1.5": dict(n_experts=4), "e2-cap0.25": dict(n_experts=2, expert_capacity_factor=0.25)}


def _configs(**moe):
    jcfg = dataclasses.replace(
        jgpt2.GPT2Config.tiny(**SHAPE), dtype=jnp.float32, attn_impl="reference", **moe
    )
    pcfg = dataclasses.replace(pgpt2.GPT2Config.tiny(**SHAPE), dtype=torch.float32, **moe)
    return jcfg, pcfg


@functools.lru_cache(maxsize=None)
def _tree(name):
    """The reference's MoE params as numpy, with every LN and bias leaf
    moved off its init so each gradient path shows."""
    jcfg, _ = _configs(**MOE[name])
    init = jax.jit(functools.partial(jgpt2.init_params, cfg=jcfg))
    tree = jax.tree.map(np.asarray, init(jax.random.key(0)))
    rng = np.random.default_rng(1)
    return jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(a.shape, dtype=np.float32), tree)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, SHAPE["vocab_size"], shape).astype(np.int32)


def _params(tree, pcfg):
    params = gpt2_params_from_numpy(tree, pcfg, "cpu")
    return pspmd._tree_map(lambda t: t.requires_grad_(True), params)


@pytest.mark.parametrize("name", list(MOE))
def test_switch_layer_matches_jax(name):
    """One switch sublayer on random activations: output and aux equal the
    reference's dense one-hot dispatch; at capacity 0.25 some expert is
    over capacity, so tokens are dropped."""
    jcfg, pcfg = _configs(**MOE[name])
    layer = {k: v[0] for k, v in _tree(name)["blocks"].items()}
    x = np.random.default_rng(3).standard_normal((2, 16, SHAPE["d_model"]), dtype=np.float32)
    want, want_aux = jax.jit(functools.partial(jgpt2._moe_sublayer, cfg=jcfg))(x, layer)
    got, aux = pgpt2._moe_sublayer(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in layer.items()}, pcfg, local_mesh()
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-5)
    # Routing as the layer saw it: per-expert counts against the capacity.
    h = pgpt2._layer_norm(torch.from_numpy(x), torch.from_numpy(layer["ln2_scale"]),
                          torch.from_numpy(layer["ln2_bias"]))
    expert = (h.reshape(-1, SHAPE["d_model"]) @ torch.from_numpy(layer["gate_w"])).argmax(-1)
    counts = np.bincount(expert.numpy(), minlength=pcfg.n_experts)
    cap = max(int(pcfg.expert_capacity_factor * x.shape[0] * x.shape[1] / pcfg.n_experts), 1)
    assert (counts.max() > cap) == (pcfg.expert_capacity_factor < 1), (counts, cap)


@pytest.mark.parametrize("name", list(MOE))
def test_moe_loss_and_grads_match_jax(name):
    jcfg, pcfg = _configs(**MOE[name])
    tree = _tree(name)
    toks = _tokens(5, (2, 17))
    (want, jm), jgrads = jax.jit(
        jax.value_and_grad(functools.partial(jgpt2.loss_fn, cfg=jcfg), has_aux=True)
    )(tree, {"tokens": toks})
    params = _params(tree, pcfg)
    got, metrics = pgpt2.loss_fn(params, {"tokens": torch.from_numpy(toks)}, pcfg)
    grads = torch.autograd.grad(got, pspmd.tree_leaves(params))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(metrics["loss"].item(), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(metrics["moe_aux"].item(), float(jm["moe_aux"]), rtol=1e-5)
    np.testing.assert_allclose(
        got.item(), metrics["loss"].item() + pcfg.moe_aux_weight * metrics["moe_aux"].item(),
        rtol=1e-6,
    )
    assert not metrics["moe_aux"].requires_grad
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(jgrads)]
    for path, g, jg in zip(paths, grads, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), err_msg=path, **GRAD_TOL)
    # Every expert column of the gate receives gradient (the aux term's
    # anti-collapse pull reaches experts no token picked).
    leaves = pspmd.tree_leaves(params)
    g_gate = grads[next(i for i, t in enumerate(leaves) if t is params["blocks"]["gate_w"])]
    assert (g_gate.abs().sum(dim=(0, 1)) > 0).all()


def test_moe_remat_rule_and_policies(monkeypatch):
    """Under MoE, "mlp" resolves to "dots" even where the flash kernel runs
    (it checkpoints the dense sublayer); every policy gives the same
    gradients bit for bit."""
    _, pcfg = _configs(**MOE["e4-cap1.5"])
    x = torch.zeros(1, 4, SHAPE["d_model"])
    monkeypatch.setattr(pcommon, "uses_flash_kernel", lambda x, impl: True)
    assert pcommon.remat_policy(pcfg, x) == "dots" and pcfg.remat == "mlp"
    assert pcommon.remat_policy(dataclasses.replace(pcfg, n_experts=0), x) == "mlp"
    monkeypatch.undo()
    toks = torch.from_numpy(_tokens(6, (2, 17)))
    grads = {}
    for remat in ("full", "dots", "mlp", "none"):
        cfg = dataclasses.replace(pcfg, remat=remat)
        params = _params(_tree("e4-cap1.5"), cfg)
        loss, _ = pgpt2.loss_fn(params, {"tokens": toks}, cfg)
        grads[remat] = torch.autograd.grad(loss, pspmd.tree_leaves(params))
    for remat, gs in grads.items():
        assert all(torch.equal(g, g0) for g, g0 in zip(gs, grads["none"])), remat


def test_moe_tree_converts_and_initialises():
    _, pcfg = _configs(**MOE["e4-cap1.5"])
    tree = _tree("e4-cap1.5")
    params = gpt2_params_from_numpy(tree, pcfg, "cpu")
    for p, a in zip(pspmd.tree_leaves(params), jax.tree.leaves(tree)):
        assert p.dtype == torch.float32 and np.array_equal(p.numpy(), a)
    assert params["blocks"]["exp_w1"].shape == (2, 4, 64, 256)
    assert "fc_w" not in params["blocks"]
    bad = dict(tree, blocks=dict(tree["blocks"], exp_b1=tree["blocks"]["exp_b1"][:, :-1]))
    with pytest.raises(ValueError, match="exp_b1"):
        gpt2_params_from_numpy(bad, pcfg, "cpu")
    with pytest.raises(ValueError, match="keys"):
        gpt2_params_from_numpy(tree, dataclasses.replace(pcfg, n_experts=0), "cpu")
    init = pgpt2.init_params(torch.Generator().manual_seed(0), pcfg, device="cpu")
    shapes = jax.tree.map(lambda a: a.shape, tree)
    assert pspmd._tree_map(lambda t: tuple(t.shape), init) == shapes
    assert set(init["blocks"]) == set(pgpt2.param_logical_specs(pcfg)["blocks"])
    cp = pgpt2.compute_params(init, dataclasses.replace(pcfg, dtype=torch.bfloat16))
    assert all(cp["blocks"][k].dtype == torch.bfloat16
               for k in ("gate_w", "exp_w1", "exp_b1", "exp_w2", "exp_b2"))


def test_moe_train_steps_match_jax():
    """Five steps of the port's make_train_step against JAX's, at capacity
    0.25 (tokens dropped in every step)."""
    jcfg, pcfg = _configs(**MOE["e2-cap0.25"])
    tree = _tree("e2-cap0.25")
    toks = _tokens(9, (2, 17))
    opt_kw = dict(lr=1e-3, warmup_steps=2, total_steps=5)
    jopt = jspmd.default_optimizer(**opt_kw)
    jstate = jspmd.make_train_state(lambda _: jax.tree.map(jnp.asarray, tree), jopt, jax.random.key(0))
    jstep = jspmd.make_train_step(functools.partial(jgpt2.loss_fn, cfg=jcfg), jopt, donate_state=False)
    popt = pspmd.default_optimizer(**opt_kw)
    state = pspmd.make_train_state(
        lambda _: gpt2_params_from_numpy(tree, pcfg, "cpu"), popt, torch.Generator(), "cpu"
    )
    step = pspmd.make_train_step(functools.partial(pgpt2.loss_fn, cfg=pcfg), popt)
    want, got = [], []
    for _ in range(5):
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
        state, m = step(state, {"tokens": torch.from_numpy(toks)})
        want.append((float(jm["loss"]), float(jm["moe_aux"])))
        got.append((m["loss"].item(), m["moe_aux"].item()))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert got[-1][0] < got[0][0]
    for p, jp in zip(pspmd.tree_leaves(state["params"]), jax.tree.leaves(jstate["params"])):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-4, atol=1e-4)
