"""The port's ``sp`` axis (ring attention) and ``pp`` axis (the GPipe
schedule) against the JAX package's, on the CPU in f32.

The port's ranks are gloo processes (``tests/torch_seq_pipe_worker.py``, no
jax; one spawn per world of 2, 4 and 8 ranks, every case of a world in its
spawn, each child joined under a time limit and killed after; the three
worlds run together). The JAX side runs in this process on the 8 virtual
CPU devices of ``conftest.py``, in each test, once for the cases that share
a reference. Inputs are numpy arrays made from a seed, the same on both
sides.

- The ring alone at ``sp=2`` and ``sp=4``: each rank's block of the output
  and of dq, dk, dv against JAX's ``ring_attention`` on a mesh of the
  virtual devices and against the plain attention (four blocks catch a
  ring turned the wrong way; two cannot).
- GPT-2 and Llama at ``sp=2`` with the default batch spec, with the
  reference gate's ``P(("dp", "fsdp"), "sp")`` and with a sequence ``sp``
  does not divide; MoE GPT-2 with dropped tokens at ``sp=2`` and at
  ``dp=2 x sp=2`` (a token's position counts the blocks of lower ``sp``
  ranks in its row); Llama at ``fsdp=2 x sp=2``; dense GPT-2 at ``pp=2``
  with 4 microbatches, Llama at ``pp=2``, and GPT-2 at ``pp=2 x sp=2``:
  the loss, gradients and global norm of one pass against JAX's unsharded
  step (the global-view function these meshes compute), and for the dense
  cases whose sequence ``sp`` divides, the params after two steps.
- MoE GPT-2 at ``pp=2 x dp=2`` with 4 microbatches, whose experts route
  each global microbatch together: against JAX's pipelined gradients on
  the same mesh of virtual devices.
- The reference gate's three meshes exactly (``__graft_entry__.py``) at
  ``GPT2Config.tiny()``: ``{fsdp: 2, sp: 2, tp: 2}``, ``{dp: 2, sp: 2,
  tp: 2}`` and ``{pp: 2, ep: 2, tp: 2}`` with ``n_experts=2,
  pipeline_microbatches=2``, batch ``{"tokens", "targets"}`` under
  ``P(("dp", "fsdp"), "sp")``: loss, gradients and global norm against
  JAX's on the same mesh, params after one step against JAX's
  ``make_train_step`` there. And ``auto_spec(8)`` (``sp=2 x tp=4``) trains.

Tolerances are the JAX suite's: loss and aux rtol 1e-5, gradients rtol
1e-4 / atol 1e-6, params after steps 1e-4; the ring's output atol 1e-5.
Replicated leaves are bit-identical on every rank.
"""

import dataclasses
import functools
import math
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
from jax.sharding import PartitionSpec as JP

from ray_tpu import parallel as jpar
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu.ops.attention import _reference_causal_attention
from ray_tpu.ops.ring_attention import ring_attention as jring
from ray_tpu.train import spmd as jspmd
from ray_tpu_torch import parallel as ppar
from ray_tpu_torch.models import common as pcommon
from ray_tpu_torch.models import gpt2 as pgpt2
from ray_tpu_torch.train import spmd as pspmd
from test_torch_llm_tp import _join
from test_torch_parallel import GPT2, LLAMA, OPT_TWO, _case, _check_leaves, _jax_steps, _jcfg

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_seq_pipe_worker.py"
SP_SPEC = (("dp", "fsdp"), "sp")  # the reference gate's batch spec
OPT_ONE = dict(lr=1e-3, warmup_steps=0, total_steps=4)
TINY = dict(vocab_size=512, n_layer=2, d_model=128, n_head=4, d_ff=512, max_seq=256)

GPT2_4H = dict(GPT2, n_head=4)  # four heads, for tp=4 under auto_spec(8)
MOE_DROP = dict(GPT2, n_experts=4, expert_capacity_factor=0.5)

# name -> (world, family, config, mesh, extra case fields, reference): the
# reference is "unsharded" (JAX's global-view step, computed once for the
# cases that share a config, seed and batch) or "mesh" (JAX's gradients on
# the same mesh of virtual devices).
CASES = {
    "gpt2_sp": (2, "gpt2", GPT2_4H, dict(sp=2), {}, "unsharded"),
    "gpt2_sp_gate_spec": (2, "gpt2", GPT2_4H, dict(sp=2), dict(batch_spec=SP_SPEC), "unsharded"),
    "gpt2_sp_ragged": (2, "gpt2", GPT2_4H, dict(sp=2), dict(seq=18), "unsharded"),
    "llama_sp": (2, "llama", LLAMA, dict(sp=2), {}, "unsharded"),
    "llama_sp_gate_spec": (2, "llama", LLAMA, dict(sp=2), dict(batch_spec=SP_SPEC), "unsharded"),
    "llama_sp_ragged": (2, "llama", LLAMA, dict(sp=2), dict(seq=18), "unsharded"),
    "moe_sp_drop": (2, "gpt2", MOE_DROP, dict(sp=2), {}, "unsharded"),
    "gpt2_pp": (2, "gpt2", dict(GPT2_4H, pipeline_microbatches=4), dict(pp=2), {}, "unsharded"),
    "llama_pp": (2, "llama", dict(LLAMA, pipeline_microbatches=2), dict(pp=2), {}, "unsharded"),
    "moe_dp_sp_drop": (4, "gpt2", MOE_DROP, dict(dp=2, sp=2), dict(batch_spec=SP_SPEC),
                       "unsharded"),
    "llama_fsdp_sp": (4, "llama", LLAMA, dict(fsdp=2, sp=2), dict(batch_spec=SP_SPEC),
                      "unsharded"),
    "gpt2_pp_sp": (4, "gpt2", dict(GPT2_4H, pipeline_microbatches=2), dict(pp=2, sp=2), {},
                   "unsharded"),
    "moe_pp_dp": (4, "gpt2", dict(MOE_DROP, pipeline_microbatches=4), dict(pp=2, dp=2), {},
                  "mesh"),
    "auto8": (8, "gpt2", GPT2_4H, ppar.auto_spec(8).asdict(), {}, "unsharded"),
}
# The reference gate's meshes (__graft_entry__.py:141-197), at GPT2Config.tiny().
GATES = {
    "gate_fsdp_sp_tp": (TINY, dict(fsdp=2, sp=2, tp=2)),
    "gate_dp_sp_tp": (TINY, dict(dp=2, sp=2, tp=2)),
    "gate_pp_ep_tp": (dict(TINY, n_experts=2, pipeline_microbatches=2), dict(pp=2, ep=2, tp=2)),
}
RING = {2: (2, 3, 16, 8), 4: (2, 2, 32, 8)}  # sp -> B, H, S, D


def _reference_key(name) -> tuple:
    """What JAX's reference for a case depends on: the family, the config
    but for its microbatches (no mesh, no pipeline), and the sequence."""
    if name in GATES:
        fields, mesh = GATES[name]
        return ("gate", repr(sorted(fields.items())), "pp" in mesh)
    _, family, fields, _, extra, ref = CASES[name]
    fields = {k: v for k, v in fields.items() if k != "pipeline_microbatches"}
    return (family, repr(sorted(fields.items())), extra.get("seq"), ref == "mesh" and name)


def _seed(name) -> int:
    """One seed for the cases that share a reference: the same tree and
    batch, so JAX computes it once."""
    keys = sorted({_reference_key(n) for n in [*CASES, *GATES]}, key=repr)
    return 100 + keys.index(_reference_key(name))


def _model_case(name):
    seed = _seed(name)
    world, family, fields, mesh, extra, _ = CASES[name]
    mesh = {k: v for k, v in mesh.items() if v > 1}
    case = _case(name, "full", family, fields, mesh, seed, steps=2, opt=OPT_TWO,
                 **{k: v for k, v in extra.items() if k != "seq"})
    if "seq" in extra:  # next-token targets of seq - 1 positions: sp=2 does not divide them
        toks = np.random.default_rng(seed).integers(0, fields["vocab_size"], (4, extra["seq"]))
        case["batch"] = {"tokens": toks.astype(np.int32)}
    return case


def _gate_case(name):
    """A gate mesh's case: the gate's batch form, one step."""
    seed = _seed(name)
    fields, mesh = GATES[name]
    case = _case(name, "full", "gpt2", fields, mesh, seed, steps=1, opt=OPT_ONE,
                 batch_spec=SP_SPEC)
    toks = np.random.default_rng(seed).integers(0, fields["vocab_size"], (4, 16)).astype(np.int32)
    case["batch"] = {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}
    return case


def _ring_case(sp):
    rng = np.random.default_rng(sp)
    q, k, v, do = (rng.standard_normal(RING[sp], dtype=np.float32) for _ in range(4))
    return dict(name=f"ring_sp{sp}", kind="ring", mesh=dict(sp=sp), q=q, k=k, v=v, do=do)


def _start(world, cases, tmp):
    cases_path, store = tmp / "cases.pkl", tmp / "store"
    with open(cases_path, "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(r), str(world), str(store), str(cases_path),
             str(tmp)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for r in range(world)
    ]


def _jax_ring(case):
    """JAX's ring on a mesh of ``sp`` virtual devices and the plain
    attention: (o, dq, dk, dv) of each, whole."""
    sp = case["mesh"]["sp"]
    mesh = jpar.make_mesh(jpar.MeshSpec(sp=sp), jax.devices()[:sp])
    q, k, v, do = (jnp.asarray(case[x]) for x in ("q", "k", "v", "do"))
    scale = 1.0 / np.sqrt(q.shape[-1])
    out = {}
    for name, fn in (("ring", lambda q, k, v: jring(q, k, v, mesh=mesh)),
                     ("plain", lambda q, k, v: _reference_causal_attention(q, k, v, scale))):
        o, vjp = jax.vjp(jax.jit(fn), q, k, v)
        out[name] = [np.asarray(t) for t in (o, *vjp(do))]
    return out


def _model(family):
    return jllama if family == "llama" else jgpt2


def _unpipelined(case):
    """The case with no microbatches: without a mesh JAX never pipelines,
    and the config it is jitted with is one compile for every case."""
    return dict(case, cfg={k: v for k, v in case["cfg"].items() if k != "pipeline_microbatches"})


def _jax_unsharded(case, steps=True):
    """JAX's global-view loss, aux, gradients and norm, and its steps."""
    case = _unpipelined(case)
    jcfg = _jcfg(case["family"], case["cfg"])
    (_, m), grads = jax.jit(jax.value_and_grad(
        functools.partial(_model(case["family"]).loss_fn, cfg=jcfg), has_aux=True
    ))(case["tree"], case["batch"])
    out = dict(metrics={k: float(v) for k, v in m.items()}, grads=jax.tree.leaves(grads),
               gnorm=float(optax.global_norm(grads)))
    if steps:
        out["steps"], out["params"] = _jax_steps(case)
    return out


def _jax_on_mesh(case):
    """(loss_fn, params, batch, shardings, mesh) of JAX on the case's mesh
    of virtual devices."""
    jcfg = _jcfg(case["family"], case["cfg"])
    spec = jpar.MeshSpec(**case["mesh"])
    mesh = jpar.make_mesh(spec, jax.devices()[: spec.num_devices])
    model = _model(case["family"])
    shardings = jpar.shardings_from_logical(model.param_logical_specs(jcfg), jpar.DEFAULT_RULES,
                                            mesh)
    params = jax.device_put(jax.tree.map(jnp.asarray, case["tree"]), shardings)
    batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
    return functools.partial(model.loss_fn, cfg=jcfg, mesh=mesh), params, batch, shardings, mesh


def _jax_mesh_step(case):
    """The metrics and params after ``make_train_step``'s steps on the
    case's mesh, under its batch spec (the reference gate's call)."""
    loss_fn, params, batch, shardings, mesh = _jax_on_mesh(case)
    jopt = jspmd.default_optimizer(**case["opt"])
    state = jspmd.make_train_state(lambda _: params, jopt, jax.random.key(0),
                                   param_shardings=shardings)
    step = jspmd.make_train_step(loss_fn, jopt, mesh=mesh,
                                 batch_spec=JP(*case.get("batch_spec", (("dp", "fsdp"),))),
                                 param_shardings=shardings, donate_state=False)
    metrics = []
    for _ in range(case["steps"]):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(steps=metrics, params=jax.tree.leaves(state["params"]))


def _jax_mesh(case, step: bool):
    """JAX on the case's mesh: the loss, aux, gradients and norm of one
    pass, and with ``step`` :func:`_jax_mesh_step`'s results."""
    loss_fn, params, batch, _, _ = _jax_on_mesh(case)
    (_, m), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, batch)
    out = dict(metrics={k: float(v) for k, v in m.items()}, grads=jax.tree.leaves(grads),
               gnorm=float(optax.global_norm(grads)))
    return dict(out, **_jax_mesh_step(case)) if step else out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(ranks by world, case by name): every world's ranks start together
    and are joined. JAX's references are computed by the tests
    (:func:`_want`), each in its own call."""
    cases = {c["name"]: c for c in [_ring_case(2), _ring_case(4)]}
    cases.update({name: _model_case(name) for name in CASES})
    cases.update({name: _gate_case(name) for name in GATES})
    started = {}
    try:
        for w in (2, 4, 8):
            tmp = tmp_path_factory.mktemp(f"world{w}")
            started[w] = (_start(w, [c for c in cases.values() if _world(c) == w], tmp), tmp)
        ranks = {w: _join(*started.pop(w)) for w in (2, 4, 8)}
    finally:
        for procs, _ in started.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return ranks, cases


def _world(case) -> int:
    return case["mesh"]["sp"] if case["kind"] == "ring" else math.prod(case["mesh"].values())


_SHARED: dict = {}  # reference key -> JAX's results, for the cases that share them


def _want(name, case):
    """JAX's results for a case, computed once for the cases that share a
    reference (:func:`_reference_key`)."""

    def once(fn):
        key = _reference_key(name)
        if key not in _SHARED:
            _SHARED[key] = fn()
        return _SHARED[key]

    if case["kind"] == "ring":
        return _jax_ring(case)
    if name in GATES and "pp" in case["mesh"]:  # the pipeline routes per microbatch
        return _jax_mesh(case, step=True)
    if name in GATES:  # the unsharded pass, and JAX's step on the gate's mesh
        return dict(once(lambda: _jax_unsharded(case, steps=False)), **_jax_mesh_step(case))
    if CASES[name][5] == "mesh":
        return _jax_mesh(case, step=False)
    # params after steps where the case's config is a dense one's
    steps = "seq" not in CASES[name][4] and not case["cfg"].get("n_experts")
    return once(lambda: _jax_unsharded(case, steps))


def _ranks(runs, name):
    ranks, cases = runs
    case = cases[name]
    return case, [r[name] for r in ranks[_world(case)]], _want(name, case)


def _check_pass(case, got, want):
    """One gradient pass: loss, aux and token count, the global norm, and
    each rank's block of every gradient (replicated blocks bit-identical)."""
    for rank in got:
        m = rank["grad_metrics"]
        assert m["tokens"] == want["metrics"]["tokens"]
        for k in ("loss", "moe_aux"):
            assert (k in m) == (k in want["metrics"]), k
            if k in m:
                np.testing.assert_allclose(m[k], want["metrics"][k], rtol=1e-5)
        np.testing.assert_allclose(rank["gnorm"], want["gnorm"], rtol=1e-5)
    _check_leaves(case, got, "grads", want["grads"], dict(rtol=1e-4, atol=1e-6))


def _check_after_steps(case, got, want):
    for rank in got:
        for g, w in zip(rank["metrics"], want["steps"]):
            assert g["tokens"] == w["tokens"]
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4, atol=1e-4)
    _check_leaves(case, got, "params", want["params"], dict(rtol=1e-4, atol=1e-4))


@pytest.mark.parametrize("sp", sorted(RING))
def test_ring_attention_matches_jax_forward_and_backward(runs, sp):
    case, got, want = _ranks(runs, f"ring_sp{sp}")
    n = case["q"].shape[2] // sp
    assert sorted(r["coord"] for r in got) == list(range(sp))
    for rank in got:
        assert rank["transport"] == "gloo"
        rows = slice(rank["coord"] * n, (rank["coord"] + 1) * n)
        for i, key in enumerate(("o", "dq", "dk", "dv")):
            tol = dict(rtol=1e-5, atol=1e-5) if key == "o" else dict(rtol=1e-4, atol=1e-6)
            for ref in ("ring", "plain"):
                np.testing.assert_allclose(rank[key], want[ref][i][:, :, rows], **tol,
                                           err_msg=f"{key} vs {ref}")


@pytest.mark.parametrize("name", list(CASES))
def test_sp_and_pp_meshes_match_jax(runs, name):
    case, got, want = _ranks(runs, name)
    _check_pass(case, got, want)
    if "params" in want:
        _check_after_steps(case, got, want)


@pytest.mark.parametrize("name", list(GATES))
def test_reference_gate_meshes_match_jax_on_the_same_mesh(runs, name):
    case, got, want = _ranks(runs, name)
    assert len(got) == 8
    _check_pass(case, got, want)
    _check_after_steps(case, got, want)


def test_pipeline_and_sequence_sizes_raise():
    """The reference's refusals: a batch that ``pipeline_microbatches``
    does not divide, layers that the stages do not split, and a batch
    spec that splits a sequence ``sp`` does not divide."""
    mesh = ppar.Mesh(ppar.MeshSpec(pp=2, dp=2))
    with pytest.raises(ValueError, match="batch 6 not divisible by pipeline_microbatches 4"):
        pcommon.pipeline_microbatches(3, 4, mesh)
    with pytest.raises(ValueError, match="one must divide the other"):
        pcommon.pipeline_microbatches(3, 3, ppar.Mesh(ppar.MeshSpec(dp=2)))
    assert pcommon.pipeline_microbatches(4, 4, mesh) == (2, 1)
    assert pcommon.pipeline_microbatches(4, 1, mesh) == (1, 2)
    cfg = dataclasses.replace(pgpt2.GPT2Config(**dict(GPT2, n_layer=3)), dtype=torch.float32)
    params = pgpt2.init_params(torch.Generator(), cfg, "cpu")
    with pytest.raises(ValueError, match="n_layer 3 not divisible by the 2 pipeline stages"):
        pgpt2.loss_fn(params, {"tokens": torch.zeros((2, 5), dtype=torch.long)}, cfg,
                      ppar.Mesh(ppar.MeshSpec(pp=2)))
    grad_fn = pspmd.make_grad_fn(lambda p, b: None, mesh=ppar.Mesh(ppar.MeshSpec(sp=2)),
                                 batch_spec=ppar.P(*SP_SPEC))
    for batch, form in (({"tokens": torch.zeros((2, 8), dtype=torch.long)}, "S=7"),
                        ({"tokens": torch.zeros((2, 7)), "targets": torch.zeros((2, 7))}, "S=7")):
        with pytest.raises(ValueError, match=f"over sp=2, and the .* batch has {form}"):
            grad_fn({}, batch, None)
