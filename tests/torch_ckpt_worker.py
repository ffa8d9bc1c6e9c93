"""One rank of ``tests/test_torch_sharded_checkpoint.py``'s gloo run (not a
test file).

    python tests/torch_ckpt_worker.py RANK WORLD STORE CASES OUT

Starts a gloo process group of WORLD ranks from the ``file://`` STORE (a
collective that waits longer than ``COLLECTIVE_S`` on a rank that died
raises instead of hanging), runs every case of the pickle CASES through
the port (imports no jax) and pickles this rank's results to
``OUT/rank{RANK}.pkl``. A case is a dict with ``name``, ``family``,
``cfg`` (config fields; f32 activations), ``tree`` and ``batch`` (numpy),
``opt`` (``default_optimizer`` arguments), ``mesh`` (the save layout),
``path`` (the checkpoint directory), ``targets`` (name -> the ``MeshSpec``
fields of a layout to restore onto) and ``step_on`` (the targets that take
one step after the restore). The rank builds the state under ``mesh``,
takes one step, saves it, then:

- restores onto each target and returns its local leaves there (and, for
  a ``step_on`` target, one step's loss);
- where ``resume`` is set, restores onto ``mesh`` itself and takes two
  steps, and takes the same two steps on the live state: both runs'
  losses, and whether their params and moments are bit for bit equal.
"""

import datetime
import functools
import pickle
import sys
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from ray_tpu_torch.models import gpt2
from ray_tpu_torch.models.convert import gpt2_params_from_numpy
from ray_tpu_torch.parallel import DEFAULT_RULES, MeshSpec, make_mesh, shardings_from_logical
from ray_tpu_torch.train import sharded_checkpoint as ckpt
from ray_tpu_torch.train import spmd

COLLECTIVE_S = 60


def _numpy(tree: dict) -> dict:
    """Every tensor leaf (by its path) as numpy; host ints as they are."""
    return {k: (v.detach().numpy().copy() if isinstance(v, torch.Tensor) else v)
            for k, v, _ in ckpt._flatten(ckpt._tree_of(tree), None)}


def _setup(case: dict, spec: dict):
    """(mesh, param shardings, step) of ``case``'s model on ``spec``."""
    cfg = gpt2.GPT2Config(**case["cfg"], dtype=torch.float32)
    mesh = make_mesh(MeshSpec(**spec), "cpu")
    shardings = shardings_from_logical(gpt2.param_logical_specs(cfg), DEFAULT_RULES, mesh)
    opt = spmd.default_optimizer(**case["opt"])
    step = spmd.make_train_step(functools.partial(gpt2.loss_fn, cfg=cfg, mesh=mesh), opt,
                                mesh=mesh, param_shardings=shardings)
    return cfg, mesh, shardings, opt, step


def run_case(case: dict) -> dict:
    cfg, mesh, shardings, opt, step = _setup(case, case["mesh"])
    state = spmd.make_train_state(
        lambda _: gpt2_params_from_numpy(case["tree"], cfg, "cpu"), opt, torch.Generator(), "cpu",
        param_shardings=shardings,
    )
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    state, m = step(state, batch)
    out = dict(coords={a: mesh.coordinate(a) for a in mesh.axis_names},
               first_loss=m["loss"].item(), saved=_numpy(state),
               bytes=ckpt.save_sharded(state, case["path"]))
    out["restored"], out["specs"], out["losses"] = {}, {}, {}
    for name, spec in case["targets"].items():
        _, tmesh, tshard, _, tstep = _setup(case, spec)
        got = ckpt.restore_sharded(case["path"], ckpt.restore_template(state, tshard))
        assert got["shardings"] is tshard and got["step"] == 1 and got["opt_state"]["count"] == 1
        out["restored"][name] = _numpy(got)
        out["specs"][name] = {k: (tuple(s.spec) if s is not None else None)
                              for k, _, s in ckpt._flatten(ckpt._tree_of(got),
                                                           spmd.state_shardings(got))}
        out[f"coords_{name}"] = {a: tmesh.coordinate(a) for a in tmesh.axis_names}
        if name in case["step_on"]:
            got, m = tstep(got, batch)
            out["losses"][name] = m["loss"].item()
    if case.get("resume"):
        resumed = ckpt.restore_sharded(case["path"], ckpt.restore_template(state))
        live = [step(state, batch)[1]["loss"].item() for _ in range(2)]
        again = [step(resumed, batch)[1]["loss"].item() for _ in range(2)]
        a, b = _numpy(state), _numpy(resumed)
        out["resume"] = dict(live=live, resumed=again,
                             equal=a.keys() == b.keys() and all(
                                 (a[k] == b[k]).all() if hasattr(a[k], "shape") else a[k] == b[k]
                                 for k in a))
    return out


def main(rank: int, world: int, store: str, cases_path: str, out_dir: str) -> None:
    torch.manual_seed(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_S))
    try:
        with open(cases_path, "rb") as f:
            cases = pickle.load(f)
        results = {c["name"]: run_case(c) for c in cases}
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    try:
        rank, world, store, cases_path, out_dir = sys.argv[1:]
        main(int(rank), int(world), store, cases_path, out_dir)
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
