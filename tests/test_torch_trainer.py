"""The train tier on both runtimes: ``ray_tpu``'s ``JaxTrainer`` and the
port's ``TorchTrainer`` (``TorchConfig(backend="gloo", device="cpu")``).

One module fixture starts each package's runtime in turn
(``init(num_cpus=8)``), fits every scenario below against it and shuts it
down; each test then compares one scenario's result between the two, and
holds it to the value it must have, so the two cannot agree on a wrong
answer. The scenarios are those of ``tests/test_train.py:34-240`` (the
end-to-end reports and checkpoints, a failure then a resume, exhausted
failures, retention; the merge and finalize protocol of ``StorageContext``
is compared in ``test_torch_train_units.py``) and of
``tests/test_train_async.py`` (device metrics through the ring, a crash
that keeps them), and ``datasets=`` (``tests/test_train.py:311``: each of
two workers reads its 20 rows through ``get_dataset_shard``). The slice as
a whole: a tiny GPT-2 trained three steps in one worker under each
trainer, losses within 1e-4, once fed its rows directly and once from a
``Dataset`` through ``datasets=`` (the port's run bit-equal to its
direct one). Then the port alone: ``report(sharded_state=...)`` over two
gloo ranks restored in the test process (the values of
``tests/test_sharded_checkpoint.py::test_report_sharded_state_e2e``), the
tiny GPT-2 at ``dp=2`` against JAX's unsharded step, one elastic shrink
through ``drain_node`` (the step stream equals the analytic replay with
no checkpoint read and no failure burnt, as
``tests/test_train_elastic.py:304``), a shrink then a grow at a step
boundary (``tests/test_train_elastic.py:383``'s assertions), and
``TorchConfig()`` on a worker without a card (it raises).

A train fn is a closure (pickled by value) that imports its package from
``config["pkg"]``; nothing it runs reaches this module. Every ``get`` of
the runtime has a timeout (the controller's own), and the fixture is cut
at the module's timeout.
"""

import dataclasses
import functools
import importlib
import os
import threading
import time

import numpy as np
import pytest

PACKAGES = ("ray_tpu", "ray_tpu_torch")
SHAPE = dict(n_layer=2, d_model=64, n_head=2, vocab_size=256, max_seq=32)
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=5)
GPT_STEPS = 3
ELASTIC_STEPS = 40
GROW_STEPS = 110
SESSION_S = 240

pytestmark = pytest.mark.timeout(300)


def _trainer(pkg, train_fn, storage, name, workers=1, config=None, max_failures=0,
             num_to_keep=None, resources=None, backend=None, datasets=None):
    train = importlib.import_module(f"{pkg}.train")
    kw = dict(
        datasets=datasets,
        train_loop_config=dict(config or {}, pkg=pkg),
        scaling_config=train.ScalingConfig(num_workers=workers, resources_per_worker=resources),
        run_config=train.RunConfig(
            name=name, storage_path=storage,
            failure_config=train.FailureConfig(max_failures=max_failures),
            checkpoint_config=train.CheckpointConfig(num_to_keep=num_to_keep),
        ),
    )
    if pkg == "ray_tpu":
        from ray_tpu.train.jax_backend import JaxConfig

        return train.JaxTrainer(train_fn, jax_config=JaxConfig(distributed=False, platform="cpu"),
                                **kw)
    config = backend or train.TorchConfig(backend="gloo", device="cpu")
    return train.TorchTrainer(train_fn, torch_config=config, **kw)


def _fit(trainer):
    try:
        res = trainer.fit()
    except Exception as e:  # noqa: BLE001 - the failure is the result
        return {"raised": type(e).__name__, "message": str(e)}
    return {"metrics": res.metrics, "history": res.metrics_history,
            "checkpoint": None if res.checkpoint is None else os.path.basename(res.checkpoint.path),
            "path": res.path,
            "dirs": sorted(d for d in os.listdir(res.path) if d.startswith("checkpoint_"))}


def _read(path, *names):
    with open(os.path.join(path, *names)) as f:
        return f.read()


# -- scenarios: each takes the package name and a storage root ---------------------


def e2e_reports_and_checkpoint(pkg, storage):
    def train_fn(config):
        import importlib
        import os
        import tempfile

        train = importlib.import_module(config["pkg"] + ".train")
        ctx = train.get_context()
        assert ctx.get_world_size() == 2
        for step in range(config["steps"]):
            metrics = {"step": step, "loss": 1.0 / (step + 1)}
            if ctx.get_world_rank() == 0:
                with tempfile.TemporaryDirectory() as d:
                    with open(os.path.join(d, "state.txt"), "w") as f:
                        f.write(str(step))
                    train.report(metrics, checkpoint=train.Checkpoint(d))
            else:
                train.report(metrics)

    out = _fit(_trainer(pkg, train_fn, storage, "e2e", workers=2, config={"steps": 3}))
    out["state"] = _read(out["path"], out["checkpoint"], "state.txt")
    return out


def failure_then_resume(pkg, storage):
    def train_fn(config):
        import importlib
        import os
        import tempfile

        train = importlib.import_module(config["pkg"] + ".train")
        ctx = train.get_context()
        ckpt = train.get_checkpoint()
        start = 0
        if ckpt is not None:
            with ckpt.as_directory() as d:
                with open(os.path.join(d, "step.txt")) as f:
                    start = int(f.read()) + 1
        for step in range(start, 4):
            if ctx.get_world_rank() == 0:
                with tempfile.TemporaryDirectory() as d:
                    with open(os.path.join(d, "step.txt"), "w") as f:
                        f.write(str(step))
                    train.report({"step": step, "resumed": start > 0}, checkpoint=train.Checkpoint(d))
            else:
                train.report({"step": step})
            if step == 1 and ckpt is None and ctx.get_world_rank() == 0:
                raise RuntimeError("injected worker failure")

    out = _fit(_trainer(pkg, train_fn, storage, "resume", workers=2, max_failures=1))
    out["state"] = _read(out["path"], out["checkpoint"], "step.txt")
    return out


def exhausted_failures(pkg, storage):
    def train_fn(config):
        raise ValueError("always broken")

    out = _fit(_trainer(pkg, train_fn, storage, "fails", max_failures=1))
    return {"raised": out["raised"], "always_broken": "always broken" in out["message"],
            "failures": "after 2 failure(s)" in out["message"]}


def retention(pkg, storage):
    def train_fn(config):
        import importlib
        import os
        import tempfile

        train = importlib.import_module(config["pkg"] + ".train")
        for step in range(4):
            with tempfile.TemporaryDirectory() as d:
                with open(os.path.join(d, "s"), "w") as f:
                    f.write(str(step))
                train.report({"step": step}, checkpoint=train.Checkpoint(d))

    return _fit(_trainer(pkg, train_fn, storage, "keep2", num_to_keep=2))


def device_metrics_through_the_ring(pkg, storage):
    def train_fn(config):
        import importlib

        train = importlib.import_module(config["pkg"] + ".train")
        if config["pkg"] == "ray_tpu":
            import jax.numpy as jnp

            value = lambda step: jnp.float32(step) * 0.5  # noqa: E731
        else:
            import torch

            value = lambda step: torch.tensor(float(step)) * 0.5  # noqa: E731
        for step in range(6):
            train.report({"loss": value(step)})

    return _fit(_trainer(pkg, train_fn, storage, "devmetrics"))


def crash_keeps_ringed_reports(pkg, storage):
    def train_fn(config):
        import importlib

        train = importlib.import_module(config["pkg"] + ".train")
        if config["pkg"] == "ray_tpu":
            import jax.numpy as jnp

            value = jnp.float32
        else:
            import torch

            value = lambda v: torch.tensor(float(v))  # noqa: E731
        for step in range(3):
            train.report({"loss": value(step)})
        raise RuntimeError("nan guard tripped")

    train = importlib.import_module(f"{pkg}.train")
    from_ = importlib.import_module(f"{pkg}.train.controller")
    backend = importlib.import_module(f"{pkg}.train.backend")
    controller = from_.TrainController(
        train_fn, {"pkg": pkg}, train.ScalingConfig(num_workers=1),
        train.RunConfig(name="crash", storage_path=storage,
                        failure_config=train.FailureConfig(max_failures=0)),
        backend.BackendConfig(),
    )
    res = controller.run()
    return {"error": type(res.error).__name__, "nan_guard": "nan guard" in str(res.error),
            "history": res.metrics_history}


def gpt2_three_steps(pkg, storage, tree, batches):
    """The slice as a whole: a tiny GPT-2 from the same numpy weights,
    three steps in one worker, each step's loss reported as a device
    value through the ring."""

    def jax_fn(config):
        import dataclasses
        import functools

        import jax
        import jax.numpy as jnp

        import ray_tpu.train as train
        from ray_tpu.models import gpt2
        from ray_tpu.train import spmd

        cfg = dataclasses.replace(gpt2.GPT2Config.tiny(**config["shape"]), dtype=jnp.float32,
                                  attn_impl="reference")
        opt = spmd.default_optimizer(**config["opt"])
        state = spmd.make_train_state(lambda _: jax.tree.map(jnp.asarray, config["tree"]), opt,
                                      jax.random.key(0))
        step = spmd.make_train_step(functools.partial(gpt2.loss_fn, cfg=cfg), opt,
                                    donate_state=False)
        for i, toks in enumerate(config["batches"]):
            state, m = step(state, {"tokens": jnp.asarray(toks)})
            train.report({"step": i, "loss": m["loss"]})

    def port_fn(config):
        import dataclasses
        import functools

        import torch

        import ray_tpu_torch.train as train
        from ray_tpu_torch.models import gpt2
        from ray_tpu_torch.models.convert import gpt2_params_from_numpy
        from ray_tpu_torch.train import spmd

        cfg = dataclasses.replace(gpt2.GPT2Config.tiny(**config["shape"]), dtype=torch.float32)
        opt = spmd.default_optimizer(**config["opt"])
        state = spmd.make_train_state(
            lambda _: gpt2_params_from_numpy(config["tree"], cfg, "cpu"), opt, torch.Generator(),
            "cpu")
        step = spmd.make_train_step(functools.partial(gpt2.loss_fn, cfg=cfg), opt)
        batches = train.DevicePrefetchIterator(
            ({"tokens": toks} for toks in config["batches"]), depth=2, device="cpu")
        for i, batch in enumerate(batches):
            state, m = step(state, batch)
            train.report({"step": i, "loss": m["loss"]})

    fn = jax_fn if pkg == "ray_tpu" else port_fn
    config = dict(shape=SHAPE, opt=OPT, tree=tree, batches=batches)
    return _fit(_trainer(pkg, fn, storage, "gpt2", config=config))


def gpt2_from_dataset(pkg, storage, tree, batches):
    """The same tiny GPT-2 and the same rows, fed from a ``Dataset``
    (``from_numpy`` of the token rows) through ``datasets=`` and
    ``get_dataset_shard``: the JAX worker reads host batches, the port's
    stages them with ``iter_device_batches`` (on the CPU, as asked)."""

    def jax_fn(config):
        import dataclasses
        import functools

        import jax
        import jax.numpy as jnp

        import ray_tpu.train as train
        from ray_tpu.models import gpt2
        from ray_tpu.train import spmd

        cfg = dataclasses.replace(gpt2.GPT2Config.tiny(**config["shape"]), dtype=jnp.float32,
                                  attn_impl="reference")
        opt = spmd.default_optimizer(**config["opt"])
        state = spmd.make_train_state(lambda _: jax.tree.map(jnp.asarray, config["tree"]), opt,
                                      jax.random.key(0))
        step = spmd.make_train_step(functools.partial(gpt2.loss_fn, cfg=cfg), opt,
                                    donate_state=False)
        shard = train.get_dataset_shard("train")
        for i, batch in enumerate(shard.iter_batches(batch_size=config["rows"])):
            state, m = step(state, {"tokens": jnp.asarray(batch["tokens"])})
            train.report({"step": i, "loss": m["loss"]})

    def port_fn(config):
        import dataclasses
        import functools

        import torch

        import ray_tpu_torch.train as train
        from ray_tpu_torch.models import gpt2
        from ray_tpu_torch.models.convert import gpt2_params_from_numpy
        from ray_tpu_torch.train import spmd

        cfg = dataclasses.replace(gpt2.GPT2Config.tiny(**config["shape"]), dtype=torch.float32)
        opt = spmd.default_optimizer(**config["opt"])
        state = spmd.make_train_state(
            lambda _: gpt2_params_from_numpy(config["tree"], cfg, "cpu"), opt, torch.Generator(),
            "cpu")
        step = spmd.make_train_step(functools.partial(gpt2.loss_fn, cfg=cfg), opt)
        shard = train.get_dataset_shard("train")
        batches = shard.iter_device_batches(batch_size=config["rows"], device="cpu")
        for i, batch in enumerate(batches):
            state, m = step(state, batch)
            train.report({"step": i, "loss": m["loss"]})

    rd = importlib.import_module(f"{pkg}.data")
    rows = np.concatenate(batches)
    ds = rd.from_numpy(rows, column="tokens")
    fn = jax_fn if pkg == "ray_tpu" else port_fn
    config = dict(shape=SHAPE, opt=OPT, tree=tree, rows=len(batches[0]))
    return _fit(_trainer(pkg, fn, storage, "gpt2_data", config=config, datasets={"train": ds}))


def dataset_shards(pkg, storage):
    """``datasets=`` feeds each worker its shard through
    ``get_dataset_shard`` (``tests/test_train.py:311``: 40 rows, 20 to each
    of 2 workers)."""
    rd = importlib.import_module(f"{pkg}.data")

    def train_fn(config):
        import importlib

        train = importlib.import_module(config["pkg"] + ".train")
        shard = train.get_dataset_shard("train")
        ids = [int(i) for b in shard.iter_batches(batch_size=8) for i in b["id"]]
        train.report({"rows": len(ids), "ids": ids,
                      "rank": train.get_context().get_world_rank()})

    ds = rd.range(40, parallelism=4)
    return _fit(_trainer(pkg, train_fn, storage, "data", workers=2, datasets={"train": ds}))


SCENARIOS = {
    "dataset_shards": dataset_shards,
    "e2e_reports_and_checkpoint": e2e_reports_and_checkpoint,
    "failure_then_resume": failure_then_resume,
    "exhausted_failures": exhausted_failures,
    "retention": retention,
    "device_metrics_through_the_ring": device_metrics_through_the_ring,
    "crash_keeps_ringed_reports": crash_keeps_ringed_reports,
}


# -- the port alone -------------------------------------------------------------


def port_sharded_state(storage):
    """Two gloo ranks collectively persist a dp-sharded state through
    ``report(sharded_state=...)``; the test process restores it whole. The state
    is a ``TrainState``-shaped dict, which carries the shardings that the
    save writes each rank's block under."""

    def state_fn(config):
        import torch
        import torch.distributed as dist

        import ray_tpu_torch.train as train
        from ray_tpu_torch.parallel import MeshSpec, NamedSharding, P, make_mesh

        n = dist.get_world_size()
        mesh = make_mesh(MeshSpec(dp=n), "cpu")
        sharding = NamedSharding(mesh, P("dp", None))
        w = sharding.shard(torch.arange(float(n * 8)).reshape(n, 8)).clone()
        state = {"params": {"w": w}, "opt_state": {"count": 0, "mu": {"w": torch.zeros_like(w)},
                                                  "nu": {"w": torch.zeros_like(w)}},
                 "step": 0, "shardings": {"w": sharding}}
        train.report({"n": n, "rows": list(w.shape)}, sharded_state=state)

    out = _fit(_trainer("ray_tpu_torch", state_fn, storage, "sharded", workers=2))
    import torch

    from ray_tpu_torch.train import Checkpoint, load_sharded_state
    from ray_tpu_torch.train.sharded_checkpoint import LeafSpec

    n = out["metrics"]["n"]
    spec = LeafSpec((n, 8), torch.float32)
    template = {"params": {"w": spec}, "opt_state": {"count": 0, "mu": {"w": spec},
                                                     "nu": {"w": spec}},
                "step": 0, "shardings": None}
    restored = load_sharded_state(Checkpoint(os.path.join(out["path"], out["checkpoint"])),
                                  template)
    out["restored_w"] = restored["params"]["w"].numpy().tolist()
    out["files"] = sorted(os.listdir(os.path.join(out["path"], out["checkpoint"], "sharded_state")))
    return out


def port_gpt2_dp2(storage, tree, batches):
    """The tiny GPT-2 at dp=2 over gloo: each rank takes its rows of the
    global batch; the trained state is saved sharded and restored in the
    test process."""

    def train_fn(config):
        import dataclasses
        import functools

        import torch

        import ray_tpu_torch.train as train
        from ray_tpu_torch.models import gpt2
        from ray_tpu_torch.models.convert import gpt2_params_from_numpy
        from ray_tpu_torch.parallel import (DEFAULT_RULES, MeshSpec, P, make_mesh,
                                            shardings_from_logical)
        from ray_tpu_torch.train import spmd

        cfg = dataclasses.replace(gpt2.GPT2Config.tiny(**config["shape"]), dtype=torch.float32)
        mesh = make_mesh(MeshSpec(dp=2), "cpu")
        sh = shardings_from_logical(gpt2.param_logical_specs(cfg), DEFAULT_RULES, mesh)
        opt = spmd.default_optimizer(**config["opt"])
        state = spmd.make_train_state(
            lambda _: gpt2_params_from_numpy(config["tree"], cfg, "cpu"), opt, torch.Generator(),
            "cpu", param_shardings=sh)
        step = spmd.make_train_step(functools.partial(gpt2.loss_fn, cfg=cfg, mesh=mesh), opt,
                                    mesh=mesh, batch_spec=P(("dp", "fsdp")), param_shardings=sh)
        for i, toks in enumerate(config["batches"]):
            state, m = step(state, {"tokens": torch.from_numpy(toks)})
            last = i == len(config["batches"]) - 1
            train.report({"step": i, "loss": m["loss"]}, sharded_state=state if last else None)

    config = dict(shape=SHAPE, opt=OPT, tree=tree, batches=batches)
    out = _fit(_trainer("ray_tpu_torch", train_fn, storage, "dp2", workers=2, config=config))
    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.models.convert import gpt2_params_from_numpy
    from ray_tpu_torch.train import Checkpoint, load_sharded_state, restore_template, spmd

    cfg = dataclasses.replace(gpt2.GPT2Config.tiny(**SHAPE), dtype=torch.float32)
    like = spmd.make_train_state(lambda _: gpt2_params_from_numpy(tree, cfg, "cpu"),
                                 spmd.default_optimizer(**OPT), torch.Generator(), "cpu")
    restored = load_sharded_state(Checkpoint(os.path.join(out["path"], out["checkpoint"])),
                                  restore_template(like))
    out["params"] = [t.detach().numpy() for t in spmd.tree_leaves(restored["params"])]
    out["step"] = restored["step"]
    return out


def port_elastic(rt, runtime, storage, steps=ELASTIC_STEPS, grow_check_s=0.0):
    """A two-node gang (SPREAD), every step reporting its state as
    ``elastic_state``; the second node drains mid-run. With
    ``grow_check_s`` > 0 the controller then recruits a replacement at a
    step boundary (``tests/test_train_elastic.py:383``)."""
    from ray_tpu_torch.core.config import GLOBAL_CONFIG
    from ray_tpu_torch.train import FailureConfig, RunConfig, ScalingConfig, TorchConfig
    from ray_tpu_torch.train import elastic
    from ray_tpu_torch.train.controller import TrainController
    from ray_tpu_torch.util.metrics import registry

    def train_fn(config):
        import os
        import tempfile
        import time

        import torch

        import ray_tpu_torch.train as train

        ctx = train.get_context()
        el = train.get_elastic_state()
        if el is not None:
            state, start = el["state"].clone(), int(el["index"]) + 1
        else:
            ckpt = train.get_checkpoint()
            if ckpt is not None:
                with ckpt.as_directory() as d:
                    state = torch.load(os.path.join(d, "state.pt"))
                start = int(state[1].item()) + 1
                with open(os.path.join(config["marker_dir"], f"r{ctx.get_world_rank()}"), "w"):
                    pass
            else:
                state, start = torch.zeros(2, dtype=torch.float32), 0
        for step in range(start, config["steps"]):
            state = state.clone()
            state[0] = state[0] * 0.75 + torch.tensor(float(step)) * 0.125
            state[1] = float(step)
            rep = {"step": step, "v": float(state[0]), "world": ctx.get_world_size()}
            if step % 5 == 0 and ctx.get_world_rank() == 0:
                with tempfile.TemporaryDirectory() as d:
                    torch.save(state, os.path.join(d, "state.pt"))
                    train.report(rep, checkpoint=train.Checkpoint(d), elastic_state=state)
            else:
                train.report(rep, elastic_state=state)
            time.sleep(0.05)

    def reshapes():
        out = {}
        for name, tags, value in registry().snapshot()["points"]:
            if name == "raytpu_train_reshapes_total":
                out[tags["kind"]] = out.get(tags["kind"], 0.0) + value
        return out

    def world_gauge():
        for name, _tags, value in registry().snapshot()["points"]:
            if name == "raytpu_train_world_size":
                return float(value)
        return None

    saved = GLOBAL_CONFIG.elastic_grow_check_s
    GLOBAL_CONFIG.elastic_grow_check_s = grow_check_s
    try:
        node2 = runtime.add_node({"CPU": 1.0})
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            view = runtime.head.cluster_view.get(node2.node_id)
            if view is not None and view.alive:
                break
            time.sleep(0.05)
        marker = os.path.join(storage, "ckpt_reads")
        os.makedirs(marker)
        before = reshapes()
        controller = TrainController(
            train_fn, {"steps": steps, "marker_dir": marker},
            ScalingConfig(num_workers=2, resources_per_worker={"CPU": 1},
                          placement_strategy="SPREAD"),
            RunConfig(name="elastic", storage_path=storage,
                      failure_config=FailureConfig(max_failures=0)),
            TorchConfig(backend="gloo", device="cpu"),
        )
        box = {}
        th = threading.Thread(target=lambda: box.setdefault("result", controller.run()),
                              daemon=True)
        th.start()
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            group = controller._active_group
            if controller.state == "RUNNING" and group is not None and any(
                    w.metadata["node_id"] == node2.node_id for w in group.workers):
                break
            time.sleep(0.05)
        time.sleep(0.4)  # a few steps at world size 2
        rt.drain_node(node2.node_id, grace_s=30.0, reason="preempted")
        th.join(180)
        result = box["result"]
        after = reshapes()
        return {"error": result.error, "history": result.metrics_history,
                "marker": os.listdir(marker),
                "shrinks": after.get("shrink", 0.0) - before.get("shrink", 0.0),
                "grows": after.get("grow", 0.0) - before.get("grow", 0.0),
                "fallbacks": after.get("fallback", 0.0) - before.get("fallback", 0.0),
                "recovery_ms": elastic.last_recovery_ms(), "world": world_gauge()}
    finally:
        GLOBAL_CONFIG.elastic_grow_check_s = saved


def port_cuda_without_a_card(storage):
    import ray_tpu_torch.train as train

    def train_fn(config):
        pass

    return _fit(_trainer("ray_tpu_torch", train_fn, storage, "cuda", backend=train.TorchConfig()))


# -- the fixture -----------------------------------------------------------------


@pytest.fixture(scope="module")
def gpt2_inputs():
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as jgpt2

    jcfg = dataclasses.replace(jgpt2.GPT2Config.tiny(**SHAPE), dtype=jnp.float32,
                               attn_impl="reference")
    tree = jax.tree.map(np.asarray, jgpt2.init_params(jax.random.key(0), jcfg))
    rng = np.random.default_rng(1)
    tree = jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(a.shape, dtype=np.float32), tree)
    toks = np.random.default_rng(9).integers(0, SHAPE["vocab_size"], (GPT_STEPS, 4, 17))
    return jcfg, tree, [t.astype(np.int32) for t in toks]


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _run(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - the exception is the result
        return {"scenario_raised": f"{type(e).__name__}: {e}"}


def _session(pkg, tree, batches, root) -> dict:
    """Start ``pkg``'s runtime, fit every scenario, shut it down."""
    rt = importlib.import_module(pkg)
    runtime = rt.init(num_cpus=8)
    storage = lambda name: str(root / name)  # noqa: E731
    try:
        res = {name: _run(lambda: fn(pkg, storage(name))) for name, fn in SCENARIOS.items()}
        # Two-row halves of each global batch for the single worker.
        res["gpt2"] = _run(lambda: gpt2_three_steps(pkg, storage("gpt2"), tree,
                                                   [b[:2] for b in batches]))
        res["gpt2_data"] = _run(lambda: gpt2_from_dataset(pkg, storage("gpt2_data"), tree,
                                                          [b[:2] for b in batches]))
        if pkg == "ray_tpu_torch":
            res["sharded_state"] = _run(lambda: port_sharded_state(storage("sharded")))
            res["gpt2_dp2"] = _run(lambda: port_gpt2_dp2(storage("dp2"), tree, batches))
            res["cuda_without_a_card"] = _run(lambda: port_cuda_without_a_card(storage("cuda")))
            res["elastic"] = _run(lambda: port_elastic(rt, runtime, storage("elastic")))
            res["elastic_grow"] = _run(lambda: port_elastic(
                rt, runtime, storage("elastic_grow"), steps=GROW_STEPS, grow_check_s=0.4))
    finally:
        rt.shutdown()
    return res


@pytest.fixture(scope="module")
def results(monkeypatch_module, gpt2_inputs, tmp_path_factory):
    """Both sessions at once, one thread each: the two packages keep their
    own runtime state, and a session's time is mostly its workers'
    start-up (a process, then torch or jax imported), which overlaps."""
    # The reference's local_ip() would otherwise look for an egress
    # interface; every process of these clusters lives on this host.
    monkeypatch_module.setenv("RAY_TPU_HOST_IP", "127.0.0.1")
    _, tree, batches = gpt2_inputs
    out, seconds, threads = {}, {}, []
    for pkg in PACKAGES:
        root = tmp_path_factory.mktemp(pkg)

        def run(pkg=pkg, root=root):
            t0 = time.perf_counter()
            out[pkg] = _run(lambda: _session(pkg, tree, batches, root))
            seconds[pkg] = time.perf_counter() - t0

        threads.append(threading.Thread(target=run, name=f"session-{pkg}", daemon=True))
    for th in threads:
        th.start()
    for th in threads:
        th.join(SESSION_S)
    assert not any(th.is_alive() for th in threads), "a trainer session did not finish"
    out["seconds"] = seconds
    return out


# -- the tests ---------------------------------------------------------------------

EXPECTED = {
    "dataset_shards": lambda r: (
        r["metrics"]["rows"] == 20 and r["metrics"]["rank"] == 0
        and len(set(r["metrics"]["ids"])) == 20),
    "e2e_reports_and_checkpoint": lambda r: (
        r["metrics"]["step"] == 2 and len(r["history"]) == 3 and r["state"] == "2"
        and r["dirs"] == ["checkpoint_000000", "checkpoint_000001", "checkpoint_000002"]),
    "failure_then_resume": lambda r: (
        r["metrics"] == {"step": 3, "resumed": True} and r["state"] == "3"),
    "exhausted_failures": lambda r: r == {"raised": "TrainingFailedError",
                                          "always_broken": True, "failures": True},
    "retention": lambda r: r["dirs"] == ["checkpoint_000002", "checkpoint_000003"],
    "device_metrics_through_the_ring": lambda r: (
        [m["loss"] for m in r["history"]] == [0.0, 0.5, 1.0, 1.5, 2.0, 2.5]),
    "crash_keeps_ringed_reports": lambda r: r == {
        "error": "TrainingFailedError", "nan_guard": True,
        "history": [{"loss": 0.0}, {"loss": 1.0}, {"loss": 2.0}]},
}


def _comparable(r):
    return {k: v for k, v in r.items() if k != "path"}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_same_result_from_both_trainers(results, name):
    ref, port = results["ray_tpu"][name], results["ray_tpu_torch"][name]
    assert EXPECTED[name](ref), ref
    assert _comparable(port) == _comparable(ref)


def test_reported_device_values_arrive_as_python_floats(results):
    for name in ("device_metrics_through_the_ring", "gpt2"):
        for m in results["ray_tpu_torch"][name]["history"]:
            assert type(m["loss"]) is float, (name, m)


def test_tiny_gpt2_trained_through_torch_trainer_matches_jax(results):
    """Three steps of the same tiny GPT-2 (same numpy weights, same
    batches) in one worker under each trainer: losses within 1e-4."""
    ref, port = results["ray_tpu"]["gpt2"], results["ray_tpu_torch"]["gpt2"]
    assert [m["step"] for m in port["history"]] == [m["step"] for m in ref["history"]] == [0, 1, 2]
    want = [m["loss"] for m in ref["history"]]
    got = [m["loss"] for m in port["history"]]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_gpt2_dp2_over_gloo_matches_jax_unsharded(results, gpt2_inputs):
    """The tiny GPT-2 at dp=2 (two gloo ranks, each half of the global
    batch) against JAX's unsharded step on the whole batch, at
    ``test_torch_parallel.py``'s tolerances: loss 1e-5, params 1e-4 (the
    params restored in the test process from the sharded checkpoint)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as jgpt2
    from ray_tpu.train import spmd as jspmd

    jcfg, tree, batches = gpt2_inputs
    port = results["ray_tpu_torch"]["gpt2_dp2"]
    assert "scenario_raised" not in port, port
    opt = jspmd.default_optimizer(**OPT)
    state = jspmd.make_train_state(lambda _: jax.tree.map(jnp.asarray, tree), opt,
                                   jax.random.key(0))
    step = jspmd.make_train_step(functools.partial(jgpt2.loss_fn, cfg=jcfg), opt,
                                 donate_state=False)
    want = []
    for toks in batches:
        state, m = step(state, {"tokens": jnp.asarray(toks)})
        want.append(float(m["loss"]))
    np.testing.assert_allclose([m["loss"] for m in port["history"]], want, rtol=1e-5, atol=1e-5)
    assert port["step"] == GPT_STEPS
    jleaves = jax.tree.leaves(state["params"])
    assert len(port["params"]) == len(jleaves)
    for got, ref in zip(port["params"], jleaves):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_report_sharded_state_restores_whole_in_the_test_process(results):
    """The reference's e2e values (``w = arange(n * 8).reshape(n, 8)`` over
    n = the dp size), written by two gloo ranks, each its own rows."""
    out = results["ray_tpu_torch"]["sharded_state"]
    assert out["metrics"] == {"n": 2, "rows": [1, 8]}, out
    assert out["restored_w"] == np.arange(16.0).reshape(2, 8).tolist()
    assert out["files"] == ["manifest.json", "rank0.pt", "rank1.pt"]


def test_elastic_shrink_replays_exactly_with_no_read_and_no_burn(results):
    """One drain: the gang re-forms at world size 1 in the same
    generation (max_failures=0, no error), with no checkpoint read, one
    shrink and no fallback; every step's value equals the analytic replay
    bit for bit."""
    out = results["ray_tpu_torch"]["elastic"]
    assert "scenario_raised" not in out, out
    assert out["error"] is None
    assert (out["shrinks"], out["fallbacks"], out["marker"]) == (1.0, 0.0, [])
    assert out["recovery_ms"] is not None and out["recovery_ms"] > 0
    state, replay = np.zeros(2, dtype=np.float32), {}
    for step in range(ELASTIC_STEPS):
        state = state.copy()
        state[0] = state[0] * np.float32(0.75) + np.float32(step) * np.float32(0.125)
        replay[step] = float(state[0])
    seen = [m for m in out["history"] if "step" in m]
    assert all(m["v"] == replay[m["step"]] for m in seen)
    assert max(m["step"] for m in seen) == ELASTIC_STEPS - 1
    assert {m["world"] for m in seen} == {1, 2}


def test_elastic_grow_at_step_boundary_after_a_shrink(results):
    """The reference's ``test_elastic_grow_at_step_boundary`` assertions on
    the port: one shrink, at least one grow, no fallback, no checkpoint
    read (the joiner hydrates from peers), the world size back at 2, and
    every step's value the analytic replay's."""
    out = results["ray_tpu_torch"]["elastic_grow"]
    assert "scenario_raised" not in out, out
    assert out["error"] is None
    assert out["shrinks"] == 1.0
    assert out["grows"] >= 1.0
    assert (out["fallbacks"], out["marker"]) == (0.0, [])
    assert out["world"] == 2.0
    state, replay = np.zeros(2, dtype=np.float32), {}
    for step in range(GROW_STEPS):
        state = state.copy()
        state[0] = state[0] * np.float32(0.75) + np.float32(step) * np.float32(0.125)
        replay[step] = float(state[0])
    seen = [m for m in out["history"] if "step" in m]
    assert all(m["v"] == replay[m["step"]] for m in seen)
    assert max(m["step"] for m in seen) == GROW_STEPS - 1


def test_tiny_gpt2_fed_from_a_dataset_matches_jax(results):
    """The tiny GPT-2 trained from a ``Dataset`` of the same rows through
    ``datasets=``: losses within 1e-4 of ``JaxTrainer``'s on the same
    dataset, and bit-equal to the port's own run fed the rows directly."""
    ref, port = results["ray_tpu"]["gpt2_data"], results["ray_tpu_torch"]["gpt2_data"]
    assert "scenario_raised" not in port and "raised" not in port, port
    assert [m["step"] for m in port["history"]] == [m["step"] for m in ref["history"]] == [0, 1, 2]
    got = [m["loss"] for m in port["history"]]
    np.testing.assert_allclose(got, [m["loss"] for m in ref["history"]], rtol=1e-4, atol=1e-4)
    assert got == [m["loss"] for m in results["ray_tpu_torch"]["gpt2"]["history"]]


def test_torch_config_cuda_on_a_worker_without_a_card_raises(results):
    out = results["ray_tpu_torch"]["cuda_without_a_card"]
    assert out["raised"] == "TrainingFailedError", out
    assert "sees no CUDA device" in out["message"]


def test_both_trainers_ran_within_their_budget(results):
    # Each package's whole session (init, every fit, shutdown); printed
    # for the record, bounded far under the module's timeout.
    print("trainer sessions (s):", results["seconds"])
    assert all(s < 200 for s in results["seconds"].values()), results["seconds"]
