"""The train tier's pure parts, the port (``ray_tpu_torch.train``) against
the JAX package's (``ray_tpu.train``), on the same inputs in one process.

The elastic reshard plan, ``StorageContext``'s persist, merge, retention,
finalize and ``latest_checkpoint`` (the same directory trees and results),
the two-level topology, the config validations (the port refuses the TPU
slice fields by name), the async report ring (the reference's
``TestAsyncDispatchRing`` with torch tensors where it uses jax arrays), the
``DevicePrefetchIterator`` (its ``TestDevicePrefetchIterator`` on the
CPU), and the ``raytpu_train_*`` series and ``train.*`` phases.
"""

import os
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.core.config import GLOBAL_CONFIG as JCONFIG
from ray_tpu.train import checkpoint as jcheckpoint
from ray_tpu.train import config as jconfig
from ray_tpu.train import context as jcontext
from ray_tpu.train import elastic as jelastic
from ray_tpu.train import input as jinput
from ray_tpu.train import storage as jstorage
from ray_tpu.util import flightrec as jflightrec
from ray_tpu.util import metrics as jmetrics
from ray_tpu.util.collective import topology as jtopology
from ray_tpu_torch.core.config import GLOBAL_CONFIG as PCONFIG
from ray_tpu_torch.core.errors import NotPortedError
from ray_tpu_torch.train import checkpoint as pcheckpoint
from ray_tpu_torch.train import config as pconfig
from ray_tpu_torch.train import context as pcontext
from ray_tpu_torch.train import elastic as pelastic
from ray_tpu_torch.train import input as pinput
from ray_tpu_torch.train import storage as pstorage
from ray_tpu_torch.util import flightrec as pflightrec
from ray_tpu_torch.util import metrics as pmetrics
from ray_tpu_torch.util.collective import topology as ptopology

pytestmark = pytest.mark.timeout(60)

KNOBS = ("train_async_dispatch", "train_async_dispatch_depth", "train_prefetch_depth")


@pytest.fixture
def knobs():
    """Both packages' overlap knobs, set alike by a test and restored."""
    saved = [(cfg, {k: getattr(cfg, k) for k in KNOBS}) for cfg in (JCONFIG, PCONFIG)]

    def set_(**kw):
        for cfg, _ in saved:
            for k, v in kw.items():
                setattr(cfg, k, v)

    yield set_
    for cfg, vals in saved:
        for k, v in vals.items():
            setattr(cfg, k, v)


# -- the reshard plan ----------------------------------------------------------


@pytest.mark.parametrize("n_rows,old,new", [
    (10, 4, 3), (6, 3, 2), (2, 4, 1), (0, 2, 3), (7, 1, 5), (16, 4, 4), (33, 3, 5), (1, 2, 1),
])
def test_plan_reshard_equals_reference(n_rows, old, new):
    assert pelastic.shard_rows(n_rows, old) == jelastic.shard_rows(n_rows, old)
    assert pelastic.shard_rows(n_rows, new) == jelastic.shard_rows(n_rows, new)
    assert pelastic.plan_reshard(n_rows, old, new) == jelastic.plan_reshard(n_rows, old, new)


def test_shard_rows_rejects_an_empty_world_as_the_reference():
    for mod in (pelastic, jelastic):
        with pytest.raises(ValueError, match="world must be >= 1"):
            mod.shard_rows(4, 0)


def test_flatten_state_round_trips_with_host_scalars_in_the_spec():
    state = {"w": torch.arange(6.0).reshape(3, 2), "n": np.ones(4, np.float32),
             "step": 7, "opt": [torch.tensor(2.5), (1, None)]}
    leaves, spec = pelastic.flatten_state(state)
    assert [tuple(x.shape) for x in leaves] == [(4,), (), (3, 2)]  # sorted keys: n, opt, w
    assert pelastic.leaf_rows(leaves) == [4, None, 3]
    back = pelastic._tree.unflatten(spec, leaves)
    assert back["step"] == 7 and back["opt"][1] == (1, None)
    assert torch.equal(back["w"], state["w"]) and back["opt"][0].item() == 2.5


def test_hydrate_reassembles_sharded_leaves_over_the_fabric():
    """Three old ranks' dim0 shards, hydrated onto two new ranks: each new
    rank's leaf is its rows of the whole, and the replicated leaf any
    donor's copy (the fabric's group arm and pull on this host)."""
    whole = torch.arange(20.0).reshape(10, 2)
    old = pelastic.shard_rows(10, 3)
    totals = [None, 10]  # sorted keys: scale, w
    for new_rank, (a, b) in enumerate(pelastic.shard_rows(10, 2)):
        need = sorted({r for r, _, _ in pelastic.plan_reshard(10, 3, 2)[new_rank]})
        snaps = {  # one arm serves one pull
            r: pelastic.snapshot_state({"w": whole[slice(*old[r])].clone(), "scale": torch.tensor(3.0)})
            for r in need
        }
        state = pelastic.hydrate_state(snaps, pelastic.SHARDED, new_rank, 2, 3, totals)
        assert torch.equal(state["w"], whole[a:b]) and state["scale"].item() == 3.0


# -- StorageContext --------------------------------------------------------------


def _tree_of(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _storage_scenario(mod, ckpt_cls, root: str) -> dict:
    """Markerless persists with retention, a multi-rank merge, the
    finalize protocol and prune_incomplete; every result relative to
    ``root``."""
    rel = lambda c: None if c is None else os.path.relpath(c.path, root)  # noqa: E731
    out = {}
    keep = mod.StorageContext(root, experiment_name="keep", num_to_keep=2)
    for step in range(4):
        with tempfile.TemporaryDirectory() as d:
            with open(os.path.join(d, "s"), "w") as f:
                f.write(str(step))
            keep.persist_checkpoint(ckpt_cls(d), index=step)
    out["retained"] = sorted(os.listdir(keep.experiment_dir))
    out["latest_markerless"] = rel(keep.latest_checkpoint())
    merge = mod.StorageContext(root, experiment_name="merge")
    for rank in range(3):
        with tempfile.TemporaryDirectory() as d:
            with open(os.path.join(d, f"shard_{rank}.bin"), "w") as f:
                f.write(f"rank{rank}")
            with open(os.path.join(d, "meta.json"), "w") as f:
                f.write("{}")
            merge.persist_checkpoint(ckpt_cls(d), index=0, world_rank=rank, world_size=3)
    out["before_finalize"] = rel(merge.latest_checkpoint())
    merge.finalize_checkpoint(0)
    out["after_finalize"] = rel(merge.latest_checkpoint())
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "shard_0.bin"), "w") as f:
            f.write("x")
        merge.persist_checkpoint(ckpt_cls(d), index=1, world_rank=0, world_size=3)
    out["partial_ignored"] = rel(merge.latest_checkpoint())
    merge.prune_incomplete()
    out["after_prune"] = sorted(os.listdir(merge.experiment_dir))
    out["dir_names"] = [os.path.basename(merge.checkpoint_dir(i)) for i in (0, 12, 123456)]
    return out


def test_storage_context_equals_reference(tmp_path):
    results, trees = {}, {}
    for name, mod, ckpt in (("jax", jstorage, jcheckpoint.Checkpoint),
                            ("port", pstorage, pcheckpoint.Checkpoint)):
        root = str(tmp_path / name)
        results[name] = _storage_scenario(mod, ckpt, root)
        trees[name] = _tree_of(root)
    assert results["port"] == results["jax"]
    assert results["port"]["retained"] == ["checkpoint_000002", "checkpoint_000003"]
    assert results["port"]["after_finalize"] == os.path.join("merge", "checkpoint_000000")
    assert trees["port"] == trees["jax"]
    assert pstorage.SHARDED_SUBDIR == jstorage.SHARDED_SUBDIR


# -- topology ------------------------------------------------------------------


@pytest.mark.parametrize("names", [
    ["", "", ""], [None], ["a", "a", "b", "b"], ["a", "b", "b", "c"], ["x", "", "", "y"],
])
def test_topology_derive_equals_reference(names):
    p, j = ptopology.derive(names), jtopology.derive(names)
    assert (p.slices, p.slice_of) == (j.slices, j.slice_of)
    for r in range(len(names)):
        assert (p.slice_index(r), p.local_rank(r), p.is_leader(r)) == (
            j.slice_index(r), j.local_rank(r), j.is_leader(r))
    assert (p.num_slices, p.spans_dcn, p.uniform, p.leaders()) == (
        j.num_slices, j.spans_dcn, j.uniform, j.leaders())


@pytest.mark.parametrize("names", [["a", "b", "a"], []])
def test_topology_derive_raises_as_the_reference(names):
    for mod in (ptopology, jtopology):
        with pytest.raises(ValueError):
            mod.derive(names)


# -- configs ----------------------------------------------------------------------


def _outcome(fn):
    try:
        fn()
        return "ok"
    except Exception as e:  # noqa: BLE001 - the class is the result
        return type(e).__name__


@pytest.mark.parametrize("kwargs,port_differs", [
    (dict(), False),
    (dict(num_workers=2), False),
    (dict(num_workers=2, resources_per_worker={"GPU": 1}), False),
    (dict(num_workers=1, placement_strategy="SPREAD"), False),
    (dict(use_tpu=True), True),
    (dict(use_tpu=True, topology="2x2x2"), True),
    (dict(use_tpu=True, num_workers=2), True),
    (dict(num_workers=2, topology="v4-16"), True),
    (dict(num_workers=2, accelerator_version="v5e"), True),
    (dict(num_workers=2, num_slices=2), True),
])
def test_scaling_config_validates_as_the_reference(kwargs, port_differs):
    """The port raises where the reference raises; where the reference
    takes a TPU slice field, the port refuses it by name."""
    ref = _outcome(lambda: jconfig.ScalingConfig(**kwargs))
    port = _outcome(lambda: pconfig.ScalingConfig(**kwargs))
    if not port_differs:
        assert port == ref
        return
    assert port == "NotPortedError", (kwargs, port)
    with pytest.raises(NotPortedError, match="|".join(kwargs)):
        pconfig.ScalingConfig(**kwargs)


def test_run_config_defaults_equal_reference(tmp_path):
    for field in ("storage_path",):
        assert getattr(PCONFIG, field) == getattr(JCONFIG, field) == ""
    p, j = pconfig.RunConfig(), jconfig.RunConfig()
    assert (p.storage_path, p.failure_config.max_failures, p.checkpoint_config.num_to_keep) == (
        j.storage_path, j.failure_config.max_failures, j.checkpoint_config.num_to_keep)
    assert pconfig.DataConfig().prefetch_depth is jconfig.DataConfig().prefetch_depth is None
    fields = ("storage_path", "train_async_dispatch", "train_async_dispatch_depth",
              "train_prefetch_depth", "elastic_train", "elastic_min_world_size",
              "elastic_pause_timeout_s", "elastic_reshard_timeout_s", "elastic_grow_check_s")
    assert {f: getattr(type(PCONFIG)(), f) for f in fields} == {
        f: getattr(type(JCONFIG)(), f) for f in fields}


def test_env_overrides_parse_as_the_reference(monkeypatch):
    from ray_tpu.core import config as jcfg_mod
    from ray_tpu_torch.core import config as pcfg_mod

    env = {"RAY_TPU_TRAIN_ASYNC_DISPATCH": "0", "RAY_TPU_TRAIN_ASYNC_DISPATCH_DEPTH": "7",
           "RAY_TPU_ELASTIC_PAUSE_TIMEOUT_S": "2.5", "RAY_TPU_STORAGE_PATH": "/results"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    p, j = pcfg_mod.load_config(), jcfg_mod.load_config()
    for f in ("train_async_dispatch", "train_async_dispatch_depth", "elastic_pause_timeout_s",
              "storage_path"):
        assert getattr(p, f) == getattr(j, f)
    assert (p.train_async_dispatch, p.train_async_dispatch_depth) == (False, 7)


# -- the async report ring ---------------------------------------------------------


def _ctx(mod, **kw):
    defaults = dict(experiment_name="t", world_size=1, world_rank=0, local_rank=0,
                    local_world_size=1, node_rank=0)
    defaults.update(kw)
    return mod.TrainContext(**defaults)


PKGS = {"jax": (jcontext, lambda v: jnp.float32(v), jcheckpoint.Checkpoint),
        "port": (pcontext, lambda v: torch.tensor(v, dtype=torch.float32), pcheckpoint.Checkpoint)}


def _both(fn):
    """fn(context module, device value maker, Checkpoint class) in each
    package; returns {"jax": ..., "port": ...}."""
    return {name: fn(*args) for name, args in PKGS.items()}


def test_ring_delays_at_most_depth_and_flushes_in_order(knobs):
    knobs(train_async_dispatch=True, train_async_dispatch_depth=3)

    def run(mod, dev, _):
        ctx = _ctx(mod)
        for i in range(5):
            ctx.report({"v": dev(i)})
        first = ctx.drain_reports()  # depth 3: exactly the two oldest evicted
        ctx.flush()
        return first, ctx.drain_reports()

    got = _both(run)
    assert got["port"] == got["jax"]
    first, rest = got["port"]
    assert [r["index"] for r in first] == [0, 1] and [r["metrics"]["v"] for r in first] == [0.0, 1.0]
    assert [r["index"] for r in rest] == [2, 3, 4]


def test_checkpoint_report_flushes_the_ring_first(knobs, tmp_path):
    knobs(train_async_dispatch=True, train_async_dispatch_depth=4)

    def run(mod, dev, ckpt_cls):
        ctx = _ctx(mod)
        for i in range(3):
            ctx.report({"v": dev(i)})
        held = ctx.drain_reports()
        d = tempfile.mkdtemp(dir=tmp_path)
        ctx.report({"v": 3.0}, checkpoint=ckpt_cls(d))
        return held, [(r["index"], r["metrics"]) for r in ctx.drain_reports()]

    got = _both(run)
    assert got["port"] == got["jax"]
    assert got["port"] == ([], [(i, {"v": float(i)}) for i in range(4)])


@pytest.mark.parametrize("async_on", [False, True], ids=["kill-switch", "ring"])
def test_device_metrics_unwrap_to_python_scalars(knobs, async_on):
    knobs(train_async_dispatch=async_on, train_async_dispatch_depth=4)

    def run(mod, dev, _):
        ctx = _ctx(mod)
        ctx.report({"loss": dev(1.5), "step": 3})
        ctx.flush()
        return [r["metrics"] for r in ctx.drain_reports()]

    got = _both(run)
    assert got["port"] == got["jax"] == [{"loss": 1.5, "step": 3}]
    assert type(got["port"][0]["loss"]) is float


def test_host_metrics_bypass_the_ring_and_mixed_loops_keep_order(knobs):
    knobs(train_async_dispatch=True, train_async_dispatch_depth=4)

    def run(mod, dev, _):
        ctx = _ctx(mod)
        ctx.report({"loss": 0.25, "step": 1})
        alone = [r["metrics"] for r in ctx.drain_reports()]
        ctx.report({"v": dev(0)})
        ctx.report({"v": 1.0})  # a host report behind a device one flushes it first
        return alone, [(r["index"], r["metrics"]) for r in ctx.drain_reports()]

    got = _both(run)
    assert got["port"] == got["jax"]
    assert got["port"][1] == [(1, {"v": 0.0}), (2, {"v": 1.0})]


def test_failure_path_flush_keeps_ringed_reports(knobs):
    knobs(train_async_dispatch=True, train_async_dispatch_depth=4)

    def run(mod, dev, _):
        ctx = _ctx(mod)
        for i in range(3):
            ctx.report({"loss": dev(i)})
        held = ctx.drain_reports()
        ctx.flush()
        return held, [r["metrics"]["loss"] for r in ctx.drain_reports()]

    got = _both(run)
    assert got["port"] == got["jax"] == ([], [0.0, 1.0, 2.0])


def _regression_batches(n, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((8, 4)).astype(np.float32),
             rng.standard_normal((8, 2)).astype(np.float32)) for _ in range(n)]


def _port_loop(async_on, depth, w0):
    """The reference test's linear-regression loop (SGD, lr 1e-2) on the
    port: each step's metrics are tensors, reported as they are."""
    PCONFIG.train_async_dispatch, PCONFIG.train_async_dispatch_depth = async_on, depth
    w = torch.tensor(w0, requires_grad=True)
    ctx = _ctx(pcontext)
    for x, y in _regression_batches(10):
        err = ((torch.from_numpy(x) @ w - torch.from_numpy(y)) ** 2).mean()
        (g,) = torch.autograd.grad(err, [w])
        with torch.no_grad():
            w -= 1e-2 * g
        ctx.report({"loss": err.detach(), "examples": torch.tensor(x.shape[0])})
    ctx.flush()
    return ctx.drain_reports(), w.detach().numpy()


def _jax_loop(w0):
    w = jnp.asarray(w0)
    out = []

    @jax.jit
    def step(w, x, y):
        err, g = jax.value_and_grad(lambda w: jnp.mean((x @ w - y) ** 2))(w)
        return w - 1e-2 * g, err

    for x, y in _regression_batches(10):
        w, err = step(w, x, y)
        out.append(float(err))
    return out, np.asarray(w)


def test_ring_metrics_bit_identical_to_the_synchronous_loop(knobs):
    """The reference's TestAsyncDispatchRing::test_metric_identical_to_sync_loop
    on the port: the ringed reports equal the synchronous loop's bit for
    bit, in order; and the losses follow the JAX loop's within 1e-6."""
    w0 = np.random.default_rng(0).standard_normal((4, 2)).astype(np.float32)
    sync_reports, sync_w = _port_loop(False, 0, w0)
    ring_reports, ring_w = _port_loop(True, 4, w0)
    assert len(sync_reports) == len(ring_reports) == 10
    for s, a in zip(sync_reports, ring_reports):
        assert s["index"] == a["index"]
        assert s["metrics"]["loss"] == a["metrics"]["loss"]
        assert s["metrics"]["examples"] == a["metrics"]["examples"] == 8
    assert sync_w.tobytes() == ring_w.tobytes()
    want, want_w = _jax_loop(w0)
    np.testing.assert_allclose([r["metrics"]["loss"] for r in ring_reports], want, rtol=1e-6)
    np.testing.assert_allclose(ring_w, want_w, rtol=1e-6, atol=1e-7)


# -- DevicePrefetchIterator --------------------------------------------------------


def _prefetch(mod, batches, **kw):
    if mod is pinput:
        kw.setdefault("device", "cpu")
    return mod.DevicePrefetchIterator(batches, **kw)


def test_prefetch_order_and_values_equal_reference(knobs):
    batches = [{"x": np.full((4,), i, np.float32), "y": np.arange(3) + i} for i in range(6)]
    p = list(_prefetch(pinput, iter(batches), depth=2))
    j = list(_prefetch(jinput, iter(batches), depth=2))
    assert len(p) == len(j) == 6
    for pb, jb in zip(p, j):
        assert isinstance(pb["x"], torch.Tensor) and isinstance(jb["x"], jax.Array)
        for k in ("x", "y"):
            np.testing.assert_array_equal(pb[k].numpy(), np.asarray(jb[k]))


def test_prefetch_takes_this_ranks_block_under_a_sharding(knobs):
    """``sharding=`` keeps the rank's rows of a global batch: rank 1 of
    dp=2 (a stand-in for a DeviceMesh) gets the second half."""
    from ray_tpu_torch.parallel import Mesh, MeshSpec, NamedSharding, P

    class _Rank1:
        def get_local_rank(self, axis):
            return 1

    sh = NamedSharding(Mesh(MeshSpec(dp=2), _Rank1()), P("dp"))
    batches = [{"x": np.arange(16, dtype=np.float32).reshape(8, 2) + i} for i in range(3)]
    out = list(_prefetch(pinput, iter(batches), sharding=sh, depth=2))
    for i, b in enumerate(out):
        np.testing.assert_array_equal(b["x"].numpy(), batches[i]["x"][4:])


def test_prefetch_depth_zero_and_kill_switch_pass_through(knobs):
    batches = [{"x": np.zeros(2, np.float32)} for _ in range(2)]
    for mod in (pinput, jinput):
        out = list(_prefetch(mod, iter(batches), depth=0))
        assert out[0] is batches[0] and out[1] is batches[1]
    knobs(train_async_dispatch=False)
    for mod in (pinput, jinput):
        assert list(_prefetch(mod, iter(batches[:1])))[0] is batches[0]
        staged = list(_prefetch(mod, iter(batches[:1]), depth=1))[0]  # explicit depth wins
        assert staged is not batches[0]


def test_prefetch_exhaustion_and_source_error_as_reference(knobs):
    def gen():
        yield {"x": np.zeros(2, np.float32)}
        raise RuntimeError("loader broke")

    for mod in (pinput, jinput):
        it = _prefetch(mod, iter([{"x": np.zeros(2)}]), depth=3)
        next(it)
        for _ in range(2):  # stays exhausted
            with pytest.raises(StopIteration):
                next(it)
        it = _prefetch(mod, gen(), depth=2)
        next(it)
        with pytest.raises(RuntimeError, match="loader broke"):
            next(it)


def test_prefetch_close_releases_the_staging_thread(knobs):
    for mod in (pinput, jinput):
        it = _prefetch(mod, ({"x": np.zeros(2, np.float32)} for _ in range(100)), depth=1)
        next(it)
        it.close()
        assert not it._thread.is_alive()
        with pytest.raises(StopIteration):
            next(it)
        it.close()  # idempotent


def _misses(metrics_mod):
    return sum(v for n, _t, v in metrics_mod.registry().snapshot()["points"]
               if n == "raytpu_train_prefetch_misses_total")


def test_prefetch_underrun_counts_misses(knobs):
    def slow_gen():
        for i in range(2):
            time.sleep(0.1)
            yield {"x": np.full((2,), i, np.float32)}

    for mod, metrics_mod in ((pinput, pmetrics), (jinput, jmetrics)):
        before = _misses(metrics_mod)
        assert len(list(_prefetch(mod, slow_gen(), depth=1))) == 2
        assert _misses(metrics_mod) - before >= 1


# -- series and phases -------------------------------------------------------------


def test_train_series_equal_reference_in_name_kind_and_meta():
    import ray_tpu.train.worker_group  # noqa: F401 - declares the worker gauge
    import ray_tpu_torch.train.worker_group  # noqa: F401

    pmeta = pmetrics.registry().snapshot()["meta"]
    jmeta = jmetrics.registry().snapshot()["meta"]
    pnames = sorted(n for n in pmeta if n.startswith("raytpu_train_"))
    jnames = sorted(n for n in jmeta if n.startswith("raytpu_train_"))
    assert pnames == jnames and len(pnames) == 9, (pnames, jnames)
    assert {n: pmeta[n] for n in pnames} == {n: jmeta[n] for n in jnames}
    pcat, jcat = pmetrics.runtime_catalog(), jmetrics.runtime_catalog()
    assert {n: pcat[n] for n in pnames} == {n: jcat[n] for n in jnames}


def test_train_phases_equal_reference(knobs):
    """The same loop (3 ringed reports at depth 2, a flush, 3 prefetched
    batches) records the same ``train.*`` phases, as many of each."""
    knobs(train_async_dispatch=True, train_async_dispatch_depth=2)
    counts = {}
    for name, (mod, dev, _), inp, fr in (("jax", PKGS["jax"], jinput, jflightrec),
                                         ("port", PKGS["port"], pinput, pflightrec)):
        fr.reset()
        ctx = _ctx(mod)
        for i in range(3):
            ctx.report({"v": dev(i)})
        ctx.flush()
        list(_prefetch(inp, iter([{"x": np.zeros(2, np.float32)}] * 3), depth=2))
        events = fr.snapshot(planes=["train"])["rings"]["train"]["events"]
        counts[name] = sorted((e["phase"], sum(x["phase"] == e["phase"] for x in events))
                              for e in {e["phase"]: e for e in events}.values())
    assert counts["port"] == counts["jax"]
    assert counts["port"] == [("train.d2h_report", 3), ("train.data_wait", 4), ("train.step", 2)]
