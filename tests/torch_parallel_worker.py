"""One rank of ``tests/test_torch_parallel.py``'s gloo runs (not a test file).

    python tests/torch_parallel_worker.py RANK WORLD STORE CASES OUT

Starts a gloo process group of WORLD ranks from the ``file://`` STORE, runs
every case of the pickle CASES through the port (imports no jax: the JAX
side runs in the test's own process), and pickles this rank's results to
``OUT/rank{RANK}.pkl``. A case is a dict:

- ``name``, ``mesh`` (``MeshSpec`` fields) and ``kind``:
  ``"steps"`` (``make_train_step`` for ``steps`` steps; the losses, aux and
  params after), ``"grads"`` (``make_grad_fn`` once; metrics and grads),
  ``"full"`` (both: ``make_grad_fn`` and ``global_norm`` once, with the
  count of weights its backward gathered again over fsdp, the logits of
  ``forward`` where no batch axis splits the rows, then ``steps``
  steps) or ``"mismatch"`` (a mesh for another number of devices must
  raise);
- for the first three, ``family`` (``"gpt2"`` or ``"llama"``), ``cfg``
  (config fields; f32 activations), ``tree`` and ``batch`` (numpy), ``opt``
  (``default_optimizer`` arguments) and optionally ``batch_spec`` (the
  ``PartitionSpec`` entries of the step's batch; ``P(("dp", "fsdp"))`` by
  default).
"""

import functools
import pickle
import sys
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from ray_tpu_torch.models import common, gpt2, llama
from ray_tpu_torch.models.convert import gpt2_params_from_numpy, llama_params_from_numpy
from ray_tpu_torch.parallel import (
    DEFAULT_RULES,
    MeshSpec,
    P,
    make_mesh,
    shardings_from_logical,
)
from ray_tpu_torch.train import spmd

# Saved weights that backward gathered again over fsdp (reshard_after_forward).
REGATHERED = [0]
_unpack = common._unpack


def _counting_unpack(saved):
    REGATHERED[0] += isinstance(saved, common._Regather)
    return _unpack(saved)


FAMILIES = {
    "gpt2": (gpt2, gpt2.GPT2Config, gpt2_params_from_numpy),
    "llama": (llama, llama.LlamaConfig, llama_params_from_numpy),
}


def _numpy(tensors):
    return [t.detach().numpy().copy() for t in tensors]


def run_case(case: dict) -> dict:
    if case["kind"] == "mismatch":  # a MeshSpec for another number of devices
        try:
            make_mesh(MeshSpec(**case["mesh"]), "cpu")
        except ValueError as e:
            return dict(message=str(e))
        return dict(message=None)
    mesh = make_mesh(MeshSpec(**case["mesh"]), "cpu")
    coords = {a: mesh.coordinate(a) for a in mesh.axis_names}
    batch_spec = P(*case.get("batch_spec", (("dp", "fsdp"),)))
    model, config, convert = FAMILIES[case["family"]]
    cfg = config(**case["cfg"], dtype=torch.float32)
    # bench.py's call sequence, on the port.
    shardings = shardings_from_logical(model.param_logical_specs(cfg), DEFAULT_RULES, mesh)
    opt = spmd.default_optimizer(**case["opt"])
    state = spmd.make_train_state(
        lambda _: convert(case["tree"], cfg, "cpu"), opt, torch.Generator(), "cpu",
        param_shardings=shardings,
    )
    loss_fn = functools.partial(model.loss_fn, cfg=cfg, mesh=mesh)
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    out = dict(coords=coords, specs=[tuple(s.spec) for s in spmd.tree_leaves(shardings)])
    if case["kind"] in ("grads", "full"):
        REGATHERED[0] = 0
        metrics, grads = spmd.make_grad_fn(loss_fn, mesh=mesh, batch_spec=batch_spec)(
            state["params"], batch, shardings
        )
        out.update(grad_metrics={k: v.item() for k, v in metrics.items()}, grads=_numpy(grads),
                   gnorm=spmd.global_norm(grads, shardings, mesh).item(),
                   regathered=REGATHERED[0])
        if case["kind"] == "grads":
            return out
        if all(mesh.size(a) == 1 for a in mesh.spec.batch_axes):  # every rank has every row
            with torch.no_grad():
                out["logits"] = model.forward(state["params"], batch["tokens"], cfg, mesh).numpy()
    step = spmd.make_train_step(
        loss_fn, opt, mesh=mesh, batch_spec=batch_spec, param_shardings=shardings
    )
    step, flops = spmd.compile_train_step(step, state, batch)
    assert flops is None
    metrics = []
    for _ in range(case["steps"]):
        state, m = step(state, batch)
        metrics.append({k: v.item() for k, v in m.items()})
    assert state["step"] == case["steps"]
    out.update(metrics=metrics, params=_numpy(spmd.tree_leaves(state["params"])))
    return out


def main(rank: int, world: int, store: str, cases_path: str, out_dir: str) -> None:
    torch.manual_seed(0)
    common._unpack = _counting_unpack
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
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
