"""The port's parallel layer against the JAX package's, on the CPU in f32.

Rule logic in this process: ``MeshSpec``, ``auto_spec`` and
``logical_to_mesh_spec`` equal the JAX functions for every leaf of dense
GPT-2's, MoE GPT-2's and Llama's ``param_logical_specs`` on several meshes
(the JAX meshes come from the 8 virtual CPU devices of ``conftest.py``).

Each rank's local shard of every leaf (``NamedSharding.shard``, given a
rank's coordinates) equals the addressable shard JAX places on the device
at those coordinates, on the same meshes.

Sharded training across spawned gloo processes
(``tests/torch_parallel_worker.py``, one spawn per world size, every case of
that world in it), against JAX's *unsharded* results on the same numpy
inputs: world 2 runs dense GPT-2 under ``dp=2`` (two steps), MoE GPT-2
under ``ep=2`` (loss and gradients), MoE at capacity 0.25 under ``dp=2``
(global capacity, positions and aux), Llama under ``dp=2`` (one step),
GPT-2 under ``sp=2`` (ring attention) and under ``pp=2`` (the GPipe
schedule; loss, gradients and two steps against JAX's unsharded ones), and
a mesh for 4 devices (which must raise); world 4 runs
MoE under ``dp=2 x ep=2`` (one step). The ``fsdp`` and ``tp`` cases hold
the loss, gradients and global norm of one gradient pass and the params
after two steps: world 2 runs GPT-2 under ``fsdp=2`` (nothing
rematerialized, so every weight is gathered again in backward) and ``tp=2`` (the
vocab-parallel loss unchunked and chunked), Llama under ``tp=2`` with one
KV head read by both ranks and with one each (a missing or averaged
``wk``/``wv`` sum fails one of them), Llama under ``fsdp=2`` (as GPT-2's) and MoE under
``tp=2`` and ``fsdp=2`` with dropped tokens; world 4 runs Llama under
``fsdp=2 x tp=2``, GPT-2 under ``dp=2 x fsdp=2`` and ``auto_spec(4)``
(``tp=4``), and MoE under ``ep=2 x tp=2`` and ``dp=2 x fsdp=2`` (dropped
tokens: a token's position counts the lower batch shards, dp major).
Where no batch axis splits the rows, ``forward``'s logits (gathered over
``tp``) equal JAX's too. The children import no jax; inputs and results go through
pickles under ``tmp_path``, the process group starts from a ``file://``
store there, and every child is joined under a time limit.

Tolerances are the JAX suite's: loss and aux rtol 1e-5, gradients rtol
1e-4 / atol 1e-6, params after steps 1e-4 (as ``test_torch_train.py``).
Replicated leaves must be bit-identical on every rank.
"""

import dataclasses
import functools
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu import parallel as jpar
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu.train import spmd as jspmd
from ray_tpu_torch import parallel as ppar
from ray_tpu_torch.models import gpt2 as pgpt2
from ray_tpu_torch.models import llama as pllama
from ray_tpu_torch.train import spmd as pspmd

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_parallel_worker.py"
JOIN_S = 120

GPT2 = dict(n_layer=2, d_model=64, n_head=2, d_ff=256, vocab_size=256, max_seq=32)
LLAMA = dict(n_layer=2, d_model=64, n_head=4, n_kv_head=2, d_ff=128, vocab_size=256, max_seq=32)
MOE4 = dict(GPT2, n_experts=4)
MOE2_DROP = dict(GPT2, n_experts=2, expert_capacity_factor=0.25)
# Capacity 24 of 64 tokens an expert: it fills in the third of four batch
# shards, so the shards' order (dp major) decides which tokens drop.
MOE2_DROP_LATE = dict(GPT2, n_experts=2, expert_capacity_factor=0.75)
GPT2_4H = dict(GPT2, n_head=4)  # four heads over tp=4
LLAMA_KV1 = dict(LLAMA, n_head=2, n_kv_head=1)  # both tp=2 ranks read the one KV head
MESHES = {
    "dp2": dict(dp=2),
    "ep2": dict(ep=2),
    "dp2xep2": dict(dp=2, ep=2),
    "dp8": dict(dp=8),
    "fsdp2xtp2xsp2": dict(fsdp=2, tp=2, sp=2),
    "fsdp2": dict(fsdp=2),
    "tp2": dict(tp=2),
    "dp2xfsdp2": dict(dp=2, fsdp=2),
    "fsdp2xtp2": dict(fsdp=2, tp=2),
    "tp4": dict(tp=4),
    "ep2xtp2": dict(ep=2, tp=2),
}
# The sequence and pipeline axes, each run at size 2 here
# (test_torch_seq_pipe.py holds the rest of their cases).
SEQ_PIPE_AXES = {"sp": dict(sp=2), "pp": dict(pp=2)}
OPT_ONE = dict(lr=1e-3, warmup_steps=0, total_steps=4)  # the first step moves
OPT_TWO = dict(lr=1e-3, warmup_steps=1, total_steps=4)


# ---------------------------------------------------------------------------
# Rule logic


def test_mesh_spec_and_auto_spec_match_jax():
    assert ppar.AXIS_NAMES == jpar.AXIS_NAMES
    assert ppar.DEFAULT_RULES == jpar.DEFAULT_RULES
    for fields in MESHES.values():
        want, got = jpar.MeshSpec(**fields), ppar.MeshSpec(**fields)
        assert (got.num_devices, got.sizes(), got.asdict(), got.batch_axes) == (
            want.num_devices, want.sizes(), want.asdict(), want.batch_axes)
    for n in range(1, 33):
        for kw in ({}, dict(want_fsdp=False), dict(max_tp=2, max_sp=1)):
            assert ppar.auto_spec(n, **kw).asdict() == jpar.auto_spec(n, **kw).asdict(), (n, kw)
    with pytest.raises(ValueError):
        ppar.auto_spec(0)


def _specs(family):
    if family == "llama":
        return (jllama.param_logical_specs(jllama.LlamaConfig.tiny()),
                pllama.param_logical_specs(pllama.LlamaConfig.tiny()))
    moe = dict(n_experts=4) if family == "gpt2_moe" else {}
    return (jgpt2.param_logical_specs(dataclasses.replace(jgpt2.GPT2Config.tiny(), **moe)),
            pgpt2.param_logical_specs(dataclasses.replace(pgpt2.GPT2Config.tiny(), **moe)))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_logical_to_mesh_spec_matches_jax(mesh_name):
    fields = MESHES[mesh_name]
    jmesh = jpar.make_mesh(jpar.MeshSpec(**fields), jax.devices()[: jpar.MeshSpec(**fields).num_devices])
    mesh = ppar.Mesh(ppar.MeshSpec(**fields))  # the shape only: no process group
    assert mesh.shape == dict(jmesh.shape)
    for family in ("gpt2", "gpt2_moe", "llama"):
        jspecs, specs = _specs(family)
        assert specs == jspecs, family
        is_leaf = lambda x: isinstance(x, tuple)  # noqa: E731
        want = [tuple(jpar.logical_to_mesh_spec(lg, jpar.DEFAULT_RULES, jmesh))
                for lg in jax.tree.leaves(jspecs, is_leaf=is_leaf)]
        got = [tuple(s.spec) for s in jax.tree.leaves(
            ppar.shardings_from_logical(specs, ppar.DEFAULT_RULES, mesh),
            is_leaf=lambda x: isinstance(x, ppar.NamedSharding))]
        assert got == want, (family, mesh_name)
    if "ep" in fields:
        s = ppar.shardings_from_logical(_specs("gpt2_moe")[1], ppar.DEFAULT_RULES, mesh)
        split = {"ep", "tp"} & set(fields)  # the experts over ep, their hidden dim over tp
        assert s["blocks"]["exp_w1"].spec[1] == "ep" and s["blocks"]["exp_w1"].axes == split
        assert s["blocks"]["gate_w"].axes == frozenset()


class _Coordinates:
    """A rank's place on a mesh, standing in for a ``DeviceMesh``."""

    def __init__(self, coords):
        self.coords = coords

    def get_local_rank(self, axis):
        return self.coords[axis]


@pytest.mark.parametrize("mesh_name", [m for m in MESHES if "sp" not in MESHES[m]])
def test_local_shards_match_jax_addressable_shards(mesh_name):
    """For every leaf of the three models, the block ``shard_tree`` keeps on
    the rank at each mesh position is the block JAX places on the device
    at that position: the port's layout is the reference's."""
    fields = MESHES[mesh_name]
    jspec = jpar.MeshSpec(**fields)
    jmesh = jpar.make_mesh(jspec, jax.devices()[: jspec.num_devices])
    rng = np.random.default_rng(0)
    for family in ("gpt2", "gpt2_moe", "llama"):
        config, model = ((pllama.LlamaConfig, pllama) if family == "llama"
                         else (pgpt2.GPT2Config, pgpt2))
        cfg = config(**(LLAMA if family == "llama" else MOE4 if family == "gpt2_moe" else GPT2_4H))
        tree = jax.tree.map(lambda t: rng.standard_normal(t.shape, dtype=np.float32),
                            model.init_params(torch.Generator(), cfg, "cpu"))
        logical = model.param_logical_specs(cfg)
        is_leaf = lambda x: isinstance(x, tuple)  # noqa: E731
        leaves = jax.tree.leaves(tree)
        for lg, a in zip(jax.tree.leaves(logical, is_leaf=is_leaf), leaves):
            placed = jax.device_put(a, jax.sharding.NamedSharding(
                jmesh, jpar.logical_to_mesh_spec(lg, jpar.DEFAULT_RULES, jmesh)))
            for shard in placed.addressable_shards:
                where = np.argwhere(jmesh.devices == shard.device)[0]
                mesh = ppar.Mesh(ppar.MeshSpec(**fields), _Coordinates(
                    dict(zip(ppar.AXIS_NAMES, (int(i) for i in where)))))
                sharding = ppar.NamedSharding(
                    mesh, ppar.logical_to_mesh_spec(lg, ppar.DEFAULT_RULES, mesh))
                got = sharding.shard(torch.from_numpy(a)).numpy()
                np.testing.assert_array_equal(got, np.asarray(shard.data), err_msg=f"{family} {lg}")


def test_sharded_leaves_without_a_mesh_raise():
    """A model given local shards and no mesh raises ``ValueError`` naming
    the mesh, and so does one given whole leaves under a mesh that splits
    them: neither computes on the leaves as if they were the other."""
    toks = torch.zeros((1, 4), dtype=torch.long)
    for model, config, fields in ((pgpt2, pgpt2.GPT2Config, GPT2), (pgpt2, pgpt2.GPT2Config, MOE4),
                                  (pllama, pllama.LlamaConfig, LLAMA)):
        cfg = dataclasses.replace(config(**fields), dtype=torch.float32)
        whole = model.init_params(torch.Generator(), cfg, "cpu")
        for spec in (dict(fsdp=2), dict(tp=2)):
            mesh = ppar.Mesh(ppar.MeshSpec(**spec), _Coordinates(dict.fromkeys(ppar.AXIS_NAMES, 0)))
            shards = ppar.shard_tree(whole, ppar.shardings_from_logical(
                model.param_logical_specs(cfg), ppar.DEFAULT_RULES, mesh))
            for params, m, match in ((shards, None, "no mesh was given"), (whole, mesh, "local shard")):
                with pytest.raises(ValueError, match=f"{match}.*mesh="):
                    model.hidden(params, toks, cfg, m)
                with pytest.raises(ValueError, match=f"{match}.*mesh="):
                    model.loss_fn(params, {"tokens": toks}, cfg, m)


def test_local_mesh_and_shapes_without_a_process_group():
    mesh = ppar.local_mesh()
    assert mesh.shape == dict.fromkeys(ppar.AXIS_NAMES, 1) and mesh.device_mesh is None
    assert all(mesh.coordinate(a) == 0 for a in ppar.AXIS_NAMES)
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4)}}
    shardings = ppar.shardings_from_logical(
        {"a": ("experts", "embed"), "b": {"c": ("batch",)}}, ppar.DEFAULT_RULES, mesh)
    placed = ppar.shard_tree(tree, shardings)
    assert placed["a"] is tree["a"] and placed["b"]["c"] is tree["b"]["c"]
    assert ppar.named_sharding(mesh, ("dp", "fsdp")).spec == ppar.P(("dp", "fsdp"))
    x = torch.ones(3)
    assert ppar.all_reduce(x, mesh, "dp", grad="sum") is x
    assert ppar.grad_all_reduce(x, mesh, "ep") is x
    assert ppar.all_gather(x, mesh, "dp").shape == (1, 3)
    shape_only = ppar.Mesh(ppar.MeshSpec(ep=2))
    with pytest.raises(ValueError, match="no DeviceMesh"):
        shape_only.coordinate("ep")
    with pytest.raises(RuntimeError, match="process group"):
        ppar.make_mesh(ppar.MeshSpec(), "cpu")
    for axis in SEQ_PIPE_AXES:  # every axis runs: a mesh over sp or pp is a mesh like any
        ppar.check_mesh(ppar.Mesh(ppar.MeshSpec(**{axis: 2})))
    ppar.check_mesh(ppar.Mesh(ppar.MeshSpec(dp=2, fsdp=2, ep=4, tp=2)))
    with pytest.raises(TypeError, match="expected a ray_tpu_torch.parallel.Mesh"):
        ppar.check_mesh(jpar.make_mesh(jpar.MeshSpec(sp=2), jax.devices()[:2]))
    assert ppar.all_gather_dim(x, mesh, "fsdp", 0) is x
    assert ppar.reduce_scatter_dim(x, mesh, "tp", 0) is x
    assert ppar.all_reduce_(x, mesh, ("dp", "fsdp")) is x


def test_train_state_on_a_local_mesh_equals_the_unsharded_one():
    """make_train_state(param_shardings=) on one rank keeps every leaf
    whole; state_shardings gives each param and both its moments that
    sharding, the counters none; compile_train_step returns the step with
    no flop count."""
    cfg = dataclasses.replace(pgpt2.GPT2Config(**MOE4), dtype=torch.float32)
    mesh = ppar.local_mesh()
    shardings = ppar.shardings_from_logical(pgpt2.param_logical_specs(cfg), ppar.DEFAULT_RULES, mesh)
    init = functools.partial(pgpt2.init_params, cfg=cfg, device="cpu")
    opt = pspmd.default_optimizer()
    state = pspmd.make_train_state(init, opt, torch.Generator().manual_seed(0), "cpu",
                                   param_shardings=shardings)
    plain = pspmd.make_train_state(init, opt, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(pspmd.tree_leaves(state["params"]),
                                                 pspmd.tree_leaves(plain["params"])))
    got = pspmd.state_shardings(state)
    assert got["params"] is shardings and got["opt_state"]["mu"] is shardings
    assert got["opt_state"]["nu"] is shardings and got["step"] is got["opt_state"]["count"] is None
    unsharded = pspmd.state_shardings(plain)
    assert all(s is None for s in pspmd.tree_leaves(unsharded["params"]))
    step = pspmd.make_train_step(functools.partial(pgpt2.loss_fn, cfg=cfg, mesh=mesh), opt,
                                 mesh=mesh, batch_spec=ppar.P(("dp", "fsdp")))
    assert pspmd.compile_train_step(step, state, None) == (step, None)


# ---------------------------------------------------------------------------
# Sharded training across gloo processes


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(a.shape, dtype=np.float32), tree)


def _jcfg(family, fields):
    if family == "llama":
        cfg = jllama.LlamaConfig(**fields)
    else:
        cfg = jgpt2.GPT2Config(**fields)
    return dataclasses.replace(cfg, dtype=jnp.float32, attn_impl="reference")


def _case(name, kind, family, fields, mesh, seed, **kw):
    """A case for the worker. Params are drawn by the port's ``init_params``
    (eager JAX draws take seconds) and go to both sides as numpy."""
    model, config = (pllama, pllama.LlamaConfig) if family == "llama" else (pgpt2, pgpt2.GPT2Config)
    init = model.init_params(torch.Generator().manual_seed(seed), config(**fields), "cpu")
    tree = _perturbed(jax.tree.map(lambda t: t.numpy(), init), seed)
    toks = np.random.default_rng(seed).integers(0, fields["vocab_size"], (4, 17)).astype(np.int32)
    return dict(name=name, kind=kind, family=family, cfg=fields, mesh=mesh, tree=tree,
                batch={"tokens": toks}, **kw)


def _spawn(world, cases, tmp_path):
    """Run the worker on ``world`` gloo ranks; each rank's results."""
    cases_path, store = tmp_path / "cases.pkl", tmp_path / "store"
    with open(cases_path, "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(r), str(world), str(store), str(cases_path),
             str(tmp_path)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for r in range(world)
    ]
    errors = []
    try:
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(timeout=JOIN_S)
            except subprocess.TimeoutExpired:
                errors.append(f"rank {r} still running after {JOIN_S} s")
                break
            if p.returncode != 0:
                errors.append(f"rank {r} exited {p.returncode}:\n{err}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not errors, "\n".join(errors)
    out = []
    for r in range(world):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _full(name, family, fields, mesh, seed):
    """A case of the fsdp and tp axes: one gradient pass, then two steps."""
    return _case(name, "full", family, fields, mesh, seed, steps=2, opt=OPT_TWO)


# The fsdp and tp cases of each world: name -> (family, config, mesh).
FULL_CASES = {
    2: {
        "gpt2_fsdp": ("gpt2", dict(GPT2, remat="none"), dict(fsdp=2)),
        "gpt2_tp": ("gpt2", dict(GPT2, loss_chunk=0), dict(tp=2)),
        "gpt2_tp_chunked": ("gpt2", dict(GPT2, loss_chunk=6), dict(tp=2)),  # 3 chunks, 2 pad
        "llama_tp_kv1": ("llama", LLAMA_KV1, dict(tp=2)),
        "llama_tp_kv2": ("llama", LLAMA, dict(tp=2)),
        "llama_fsdp": ("llama", dict(LLAMA, remat="none"), dict(fsdp=2)),
        "moe_tp_drop": ("gpt2", MOE2_DROP, dict(tp=2)),
        "moe_fsdp_drop": ("gpt2", MOE2_DROP, dict(fsdp=2)),
    },
    4: {
        "llama_fsdp_tp": ("llama", dict(LLAMA, loss_chunk=8), dict(fsdp=2, tp=2)),
        "gpt2_dp_fsdp": ("gpt2", GPT2, dict(dp=2, fsdp=2)),
        "gpt2_auto4": ("gpt2", GPT2_4H, ppar.auto_spec(4).asdict()),
        "moe_ep_tp": ("gpt2", MOE4, dict(ep=2, tp=2)),
        "moe_dp_fsdp_drop": ("gpt2", MOE2_DROP_LATE, dict(dp=2, fsdp=2)),
    },
}


def _full_cases(world):
    return [_full(name, family, fields, {k: v for k, v in mesh.items() if v > 1}, 10 * world + i)
            for i, (name, (family, fields, mesh)) in enumerate(FULL_CASES[world].items())]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    cases = [
        _case("gpt2_dp", "steps", "gpt2", GPT2, dict(dp=2), 1, steps=2, opt=OPT_TWO),
        _case("moe_ep", "grads", "gpt2", MOE4, dict(ep=2), 2, opt=OPT_ONE),
        _case("moe_dp_drop", "grads", "gpt2", MOE2_DROP, dict(dp=2), 3, opt=OPT_ONE),
        _case("llama_dp", "steps", "llama", LLAMA, dict(dp=2), 4, steps=1, opt=OPT_ONE),
        dict(name="mismatch", kind="mismatch", mesh=dict(dp=2, ep=2)),
    ] + [_full(f"axis_{a}", "gpt2", dict(GPT2, pipeline_microbatches=2), mesh, 6 + i)
         for i, (a, mesh) in enumerate(SEQ_PIPE_AXES.items())] + _full_cases(2)
    return {c["name"]: c for c in cases}, _spawn(2, cases, tmp_path_factory.mktemp("world2"))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    cases = [_case("moe_dp_ep", "steps", "gpt2", MOE4, dict(dp=2, ep=2), 5, steps=1, opt=OPT_ONE)]
    cases += _full_cases(4)
    return {c["name"]: c for c in cases}, _spawn(4, cases, tmp_path_factory.mktemp("world4"))


def _local(a, spec, coords, mesh):
    """Rank ``coords``'s block of the whole numpy array ``a`` under ``spec``."""
    for dim, entry in enumerate(spec):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
        n, idx = 1, 0
        for ax in axes:
            idx, n = idx * mesh[ax] + coords[ax], n * mesh[ax]
        size = a.shape[dim] // n
        a = np.take(a, np.arange(idx * size, (idx + 1) * size), axis=dim)
    return a


def _mesh_sizes(case):
    return dict(dict.fromkeys(ppar.AXIS_NAMES, 1), **case["mesh"])


def _check_leaves(case, ranks, key, want, tol):
    """Each rank's leaves equal its block of JAX's whole ones, and every two
    ranks holding the same block hold it bit for bit."""
    mesh = _mesh_sizes(case)
    for rank in ranks:
        for spec, got, w in zip(rank["specs"], rank[key], want):
            np.testing.assert_allclose(got, _local(np.asarray(w), spec, rank["coords"], mesh), **tol)
    for i, spec in enumerate(ranks[0]["specs"]):
        axes = {a for e in spec if e is not None for a in ((e,) if isinstance(e, str) else e)}
        blocks = {}
        for rank in ranks:
            where = tuple(rank["coords"][a] for a in sorted(axes))
            blocks.setdefault(where, []).append(rank[key][i])
        for same in blocks.values():
            assert all(np.array_equal(same[0], b) for b in same[1:]), (key, i, spec)


def _jax_steps(case):
    jcfg = _jcfg(case["family"], case["cfg"])
    model = jllama if case["family"] == "llama" else jgpt2
    jopt = jspmd.default_optimizer(**case["opt"])
    state = jspmd.make_train_state(lambda _: jax.tree.map(jnp.asarray, case["tree"]), jopt,
                                   jax.random.key(0))
    step = jspmd.make_train_step(functools.partial(model.loss_fn, cfg=jcfg), jopt,
                                 donate_state=False)
    metrics = []
    for _ in range(case["steps"]):
        state, m = step(state, {"tokens": jnp.asarray(case["batch"]["tokens"])})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.tree.leaves(state["params"])


def _check_steps(case, ranks):
    want_metrics, want_params = _jax_steps(case)
    for rank in ranks:
        for got, want in zip(rank["metrics"], want_metrics):
            assert got["tokens"] == want["tokens"] == 4 * 16
            for k in ("loss", "moe_aux"):
                if k in want:
                    np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4)
    _check_leaves(case, ranks, "params", want_params, dict(rtol=1e-4, atol=1e-4))


def _check_grads(case, ranks):
    """Loss, aux and gradients of one gradient pass against JAX's
    unsharded ones, and (where the rank gives it) the global norm."""
    jcfg = _jcfg(case["family"], case["cfg"])
    model = jllama if case["family"] == "llama" else jgpt2
    (_, jm), jgrads = jax.jit(
        jax.value_and_grad(functools.partial(model.loss_fn, cfg=jcfg), has_aux=True)
    )(case["tree"], case["batch"])
    for rank in ranks:
        got = rank["grad_metrics"]
        assert got["tokens"] == int(jm["tokens"])
        for k in ("loss", "moe_aux"):
            if k in jm:
                np.testing.assert_allclose(got[k], float(jm[k]), rtol=1e-5)
        if case["kind"] == "full":
            np.testing.assert_allclose(rank["gnorm"], float(optax.global_norm(jgrads)), rtol=1e-5)
        if "logits" in rank:  # forward's logits, gathered over tp
            want = model.forward(case["tree"], jnp.asarray(case["batch"]["tokens"]), jcfg)
            np.testing.assert_allclose(rank["logits"], np.asarray(want), rtol=1e-4, atol=1e-5)
    _check_leaves(case, ranks, "grads", jax.tree.leaves(jgrads), dict(rtol=1e-4, atol=1e-6))


def test_dense_gpt2_dp2_two_steps_match_jax(world2):
    cases, ranks = world2
    _check_steps(cases["gpt2_dp"], [r["gpt2_dp"] for r in ranks])
    assert [r["gpt2_dp"]["coords"]["dp"] for r in ranks] == [0, 1]


def test_moe_ep2_loss_and_grads_match_jax(world2):
    cases, ranks = world2
    got = [r["moe_ep"] for r in ranks]
    _check_grads(cases["moe_ep"], got)
    # Each rank holds 2 of the 4 experts.
    i = [s for s in got[0]["specs"]].index((None, "ep"))
    assert got[0]["grads"][i].shape[1] == 2 and [g["coords"]["ep"] for g in got] == [0, 1]


def test_moe_dp2_with_dropped_tokens_matches_jax(world2):
    """Capacity 0.25 over dp=2: the capacity counts the global batch, a
    token's position counts the other rank's tokens, and the aux is a
    product of global means, so per-rank routing would not match."""
    cases, ranks = world2
    _check_grads(cases["moe_dp_drop"], [r["moe_dp_drop"] for r in ranks])


def test_llama_dp2_step_matches_jax(world2):
    cases, ranks = world2
    _check_steps(cases["llama_dp"], [r["llama_dp"] for r in ranks])


@pytest.mark.parametrize("name", list(FULL_CASES[2]))
def test_fsdp_and_tp_world2_match_jax(world2, name):
    """Loss, gradients and global norm of one pass, and the params after
    two steps, of each world-2 fsdp or tp case against JAX's unsharded
    step; each rank holds its own block of every leaf."""
    cases, ranks = world2
    got = [r[name] for r in ranks]
    _check_grads(cases[name], got)
    _check_steps(cases[name], got)


@pytest.mark.parametrize("name", list(FULL_CASES[4]))
def test_fsdp_and_tp_world4_match_jax(world4, name):
    cases, ranks = world4
    got = [r[name] for r in ranks]
    _check_grads(cases[name], got)
    _check_steps(cases[name], got)


def test_fsdp_gathers_weights_again_in_backward(world2, world4):
    """Under fsdp no layer's gathered weights are kept for backward: with
    nothing rematerialized (remat="none") autograd keeps each matmul
    weight as its recipe and gathers it again (GPT-2: qkv_w, proj_w, fc_w,
    fc2_w; Llama: wq, wk, wv, wo and SwiGLU's three, per layer); inside a
    checkpoint (remat="dots", as on the CPU) the recompute gathers, and
    autograd keeps none."""
    for (_, ranks), name, want in ((world2, "gpt2_fsdp", 4 * 2), (world2, "llama_fsdp", 7 * 2),
                                   (world4, "llama_fsdp_tp", 0), (world2, "gpt2_tp", 0)):
        assert [r[name]["regathered"] for r in ranks] == [want] * len(ranks), name


def test_sharded_leaves_are_the_rules_blocks(world2, world4):
    """Under fsdp and tp each rank holds a block of the rule's shape, not
    the whole leaf: qkv_w [D/fsdp, 3D/tp], Llama's wk [D/fsdp, KD] whole
    over tp, lm_head [D/fsdp, V/tp]."""
    for (cases, ranks), name, leaf, shape in (
        (world2, "gpt2_tp", ("blocks", "qkv_w"), (2, 64, 96)),
        (world2, "gpt2_fsdp", ("blocks", "qkv_w"), (2, 32, 192)),
        (world4, "llama_fsdp_tp", ("blocks", "wk"), (2, 32, 32)),
        (world4, "llama_fsdp_tp", ("lm_head",), (32, 128)),
        (world4, "gpt2_auto4", ("wte",), (64, 64)),
    ):
        is_leaf = lambda x: isinstance(x, tuple)  # noqa: E731
        names = [p for p, _ in jax.tree_util.tree_flatten_with_path(
            cases[name]["tree"], is_leaf=is_leaf)[0]]
        i = [tuple(k.key for k in path) for path in names].index(leaf)
        assert all(r[name]["params"][i].shape == shape for r in ranks), (name, leaf)


@pytest.mark.parametrize("axis", list(SEQ_PIPE_AXES))
def test_sp_and_pp_axes_run_across_ranks(world2, axis):
    """GPT-2 under sp=2 (each rank its half of the sequence, attention over
    the ring) and under pp=2 (each rank one layer, two microbatches): loss,
    gradients and global norm of one pass and the params after two steps
    equal JAX's unsharded ones."""
    cases, ranks = world2
    got = [r[f"axis_{axis}"] for r in ranks]
    assert [g["coords"][axis] for g in got] == [0, 1]
    _check_grads(cases[f"axis_{axis}"], got)
    _check_steps(cases[f"axis_{axis}"], got)


def test_make_mesh_raises_on_a_device_count_mismatch(world2):
    _, ranks = world2
    for rank in ranks:
        assert "wants 4 devices, got 2" in rank["mismatch"]["message"]


def test_moe_dp2xep2_step_matches_jax(world4):
    cases, ranks = world4
    got = [r["moe_dp_ep"] for r in ranks]
    assert [(g["coords"]["dp"], g["coords"]["ep"]) for g in got] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    _check_steps(cases["moe_dp_ep"], got)
