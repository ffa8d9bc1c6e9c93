"""The port's sharded checkpoints (``ray_tpu_torch/train/sharded_checkpoint.py``)
across mesh layouts, held as ``tests/test_sharded_checkpoint.py`` holds the
reference's (its bitwise reshape restore at ``:36`` and its deterministic
resume at ``:152``), on the CPU over gloo.

The port's ranks are processes (``tests/torch_ckpt_worker.py``, no jax):
one spawn of 4 ranks for the module, every case in it, each child joined
under a time limit and killed after. Each case builds a tiny f32 GPT-2
state from the same perturbed numpy weights, takes one step, saves it and
restores it onto other layouts:

- dense GPT-2 saved under ``fsdp=2 x tp=2``, restored onto ``dp=2 x tp=2``
  (then one more step) and onto ``fsdp=2 x tp=2`` itself (then two steps
  beside two steps of the live state: a resume);
- MoE GPT-2 (4 experts, 2 pipeline microbatches) saved under
  ``pp=2 x ep=2``, restored onto ``ep=2 x tp=2`` and ``pp=2 x dp=2``.

This process restores each checkpoint onto one unsharded process, through
a ``Checkpoint`` and ``load_sharded_state`` for the dense one. Held: every
rank's saved leaves and every rank's restored leaves are bit for bit their
blocks of the unsharded restore (so every state-sharding axis, fsdp, tp,
ep and pp, restores onto a layout without it and onto one with it); the
resumed run equals the uninterrupted one bit for bit; and the losses of
the step before the save and of the step after each restore equal the JAX
package's unsharded steps on the same weights, within
``tests/test_torch_parallel.py``'s tolerance.
"""

import dataclasses
import functools
import os
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import gpt2 as pgpt2
from ray_tpu_torch.models.convert import gpt2_params_from_numpy
from ray_tpu_torch.parallel import NamedSharding, P
from ray_tpu_torch.parallel.mesh import AXIS_NAMES, Mesh, MeshSpec
from ray_tpu_torch.train import sharded_checkpoint as pckpt
from ray_tpu_torch.train import spmd as pspmd
from ray_tpu_torch.train.checkpoint import Checkpoint
from test_torch_parallel import GPT2, MOE4, OPT_ONE, _case, _Coordinates, _jax_steps, _local

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_ckpt_worker.py"
JOIN_S = 120
WORLD = 4
MOE_PP = dict(MOE4, pipeline_microbatches=2)

# name -> (config, save layout, restore targets, targets that take a step, resume)
CASES = {
    "gpt2_fsdp2_tp2": (GPT2, dict(fsdp=2, tp=2), {"dp2_tp2": dict(dp=2, tp=2)}, ("dp2_tp2",), True),
    "moe_pp2_ep2": (MOE_PP, dict(pp=2, ep=2),
                    {"ep2_tp2": dict(ep=2, tp=2), "pp2_dp2": dict(pp=2, dp=2)}, (), False),
}


def _cases(tmp: Path) -> list:
    out = []
    for i, (name, (fields, mesh, targets, step_on, resume)) in enumerate(CASES.items()):
        case = _case(name, "ckpt", "gpt2", fields, mesh, 40 + i, opt=OPT_ONE, steps=2)
        case.update(path=str(tmp / name / pckpt.SHARDED_SUBDIR), targets=targets,
                    step_on=step_on, resume=resume)
        out.append(case)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(cases by name, each rank's results): one spawn of WORLD ranks."""
    tmp = tmp_path_factory.mktemp("ckpt")
    cases = _cases(tmp)
    cases_path, store = tmp / "cases.pkl", tmp / "store"
    with open(cases_path, "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(r), str(WORLD), str(store), str(cases_path), str(tmp)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for r in range(WORLD)
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
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return {c["name"]: c for c in cases}, ranks


def _cfg(case):
    return dataclasses.replace(pgpt2.GPT2Config(**case["cfg"]), dtype=torch.float32)


def _unsharded_template(case):
    """An unsharded state of the case's model on this process, and its
    template (the values are overwritten by the restore)."""
    cfg = _cfg(case)
    opt = pspmd.default_optimizer(**case["opt"])
    state = pspmd.make_train_state(lambda _: gpt2_params_from_numpy(case["tree"], cfg, "cpu"), opt,
                                   torch.Generator(), "cpu")
    return cfg, opt, pckpt.restore_template(state)


def _restore_whole(case):
    """The checkpoint restored onto this one process (a dense case through
    a Checkpoint and load_sharded_state)."""
    cfg, opt, template = _unsharded_template(case)
    if case["name"].startswith("gpt2"):
        ckpt = Checkpoint.from_directory(str(Path(case["path"]).parent))
        return cfg, opt, pckpt.load_sharded_state(ckpt, template)
    return cfg, opt, pckpt.restore_sharded(case["path"], template)


def _whole(state) -> dict:
    return {k: (v.detach().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v, _ in pckpt._flatten(pckpt._tree_of(state), None)}


def _blocks_equal(whole: dict, local: dict, specs: dict, coords: dict, mesh: dict):
    """Each tensor leaf of ``local`` is bit for bit its block of
    ``whole`` under ``specs``; each host int equal."""
    assert whole.keys() == local.keys()
    for key, want in whole.items():
        if not isinstance(want, np.ndarray):
            assert local[key] == want, key
            continue
        block = _local(want, specs[key] or (), coords, mesh)
        assert block.shape == local[key].shape, key
        assert np.array_equal(block, local[key]), key


def _mesh_sizes(fields):
    return dict(dict.fromkeys(("pp", "dp", "fsdp", "ep", "sp", "tp"), 1), **fields)


def _save_specs(case):
    """Each leaf's PartitionSpec under the case's save layout (the rule
    logic needs only the mesh's shape)."""
    from ray_tpu_torch.parallel import DEFAULT_RULES, shardings_from_logical

    cfg = _cfg(case)
    mesh = Mesh(MeshSpec(**case["mesh"]))
    sh = shardings_from_logical(pgpt2.param_logical_specs(cfg), DEFAULT_RULES, mesh)
    state = {"params": sh, "opt_state": {"count": None, "mu": sh, "nu": sh}, "step": None}
    return {k: (tuple(s.spec) if isinstance(s, NamedSharding) else None)
            for k, s, _ in pckpt._flatten(state, None)}


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_saved_its_block_of_the_restored_state(run, name):
    cases, ranks = run
    case = cases[name]
    whole = _whole(_restore_whole(case)[2])
    specs = _save_specs(case)
    for r in ranks:
        _blocks_equal(whole, r[name]["saved"], specs, r[name]["coords"], _mesh_sizes(case["mesh"]))
    assert whole["step"] == 1 and whole["opt_state/count"] == 1


@pytest.mark.parametrize("name, target", [(n, t) for n, c in CASES.items() for t in c[2]])
def test_restore_onto_another_layout_is_bitwise(run, name, target):
    cases, ranks = run
    case = cases[name]
    whole = _whole(_restore_whole(case)[2])
    for r in ranks:
        got = r[name]
        _blocks_equal(whole, got["restored"][target], got["specs"][target], got[f"coords_{target}"],
                      _mesh_sizes(CASES[name][2][target]))


def test_each_rank_writes_only_the_blocks_it_owns(run):
    """fsdp x tp: every rank owns a block of every split leaf and rank 0
    alone writes the replicated ones (the biases and norms); the bytes
    written over the ranks are the state's once."""
    cases, ranks = run
    case = cases["gpt2_fsdp2_tp2"]
    whole = _whole(_restore_whole(case)[2])
    total = sum(v.nbytes for v in whole.values() if isinstance(v, np.ndarray))
    written = [r["gpt2_fsdp2_tp2"]["bytes"] for r in ranks]
    assert sum(written) == total
    assert written[0] > max(written[1:]) > 0


def test_resume_equals_the_uninterrupted_run(run):
    """Restored after step 1 on the same layout, two more steps equal two
    more steps of the live state, bit for bit: losses, params, moments."""
    _, ranks = run
    for r in ranks:
        got = r["gpt2_fsdp2_tp2"]["resume"]
        assert got["equal"] and got["live"] == got["resumed"]


def test_restored_steps_equal_the_jax_unsharded_steps(run):
    """The step before the save, the step after the restore onto dp=2 x tp=2
    and the step after the restore onto one process: the JAX package's
    first and second unsharded steps on the same weights."""
    cases, ranks = run
    case = cases["gpt2_fsdp2_tp2"]
    want, _ = _jax_steps(case)
    cfg, opt, state = _restore_whole(case)
    step = pspmd.make_train_step(functools.partial(pgpt2.loss_fn, cfg=cfg), opt)
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    whole_loss = step(state, batch)[1]["loss"].item()
    for r in ranks:
        got = r["gpt2_fsdp2_tp2"]
        np.testing.assert_allclose(got["first_loss"], want[0]["loss"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got["losses"]["dp2_tp2"], want[1]["loss"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(whole_loss, want[1]["loss"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dp, tp", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_box_is_the_block_shard_takes(dp, tp):
    """NamedSharding.box gives the index box NamedSharding.shard narrows
    to, the first axis major, at every position of a dp=2 x tp=2 mesh."""
    x = torch.arange(8 * 6 * 4).reshape(8, 6, 4)
    mesh = Mesh(MeshSpec(dp=2, tp=2), _Coordinates(dict.fromkeys(AXIS_NAMES, 0) | {"dp": dp, "tp": tp}))
    sh = NamedSharding(mesh, P(("dp", "tp"), None, "tp"))
    i = 2 * dp + tp
    assert sh.box(x.shape) == ((2 * i, 2 * i + 2), (0, 6), (2 * tp, 2 * tp + 2))
    assert torch.equal(sh.shard(x), x[2 * i: 2 * i + 2, :, 2 * tp: 2 * tp + 2])
    with pytest.raises(ValueError, match="does not split"):
        sh.box((6, 6, 4))


def test_checkpoint_directory_handle(tmp_path):
    """The port's Checkpoint: from_directory, to_directory, as_directory and
    the metadata sidecar, as the reference's."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "f.txt").write_text("x")
    ck = Checkpoint.from_directory(str(src))
    ck.set_metadata({"a": 1})
    ck.update_metadata({"b": 2})
    assert ck.get_metadata() == {"a": 1, "b": 2}
    with ck.as_directory() as d:
        assert d == str(src)
    dst = ck.to_directory(str(tmp_path / "dst"))
    assert (Path(dst) / "f.txt").read_text() == "x" and Checkpoint(dst).get_metadata() == {"a": 1, "b": 2}
    with pytest.raises(ValueError):
        Checkpoint.from_directory(str(tmp_path / "missing"))
    shutil.rmtree(dst)
