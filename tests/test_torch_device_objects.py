"""Device objects on both runtimes: ``ray_tpu.experimental`` and the
port's ``ray_tpu_torch.experimental`` (CPU tensors here; CUDA tensors on
the card in ``tests/test_torch_data_cuda.py`` and chip_smoke).

One module fixture runs each package's runtime (``init(num_cpus=8)``) in
a thread of its own, at once, and plays the four scenarios of
``tests/test_device_objects.py`` (``:61`` a ref round trip and an explicit
free, ``:78`` a fetch budget of 1, ``:90`` transparent interception of an
actor's return, ``:109`` a fetch from the driver) against it. Each test
then holds the port's values bit for bit (bytes and dtype), its
producer's store counts and both ends' ``transfer_stats()`` (arms, pulls,
fallbacks) equal to the reference's, and to the values they must have.

Then the port alone: a pull that fails after a good arm (the consumer's
fabric raises once) refunds the owner's budget through ``rdt_unarm`` and
takes the host fetch, counted as one fallback; and an ``rdt_free`` that
lands while ``rdt_arm`` stages the object answers the arm with
``{"gone": True}`` and leaves nothing armed or stored; and a fetch that
names a ``NamedSharding`` returns the rank's block.

Actors are defined inside the scenarios (pickled by value) and import
their package from an argument; nothing they run reaches this module.
"""

import importlib
import threading
import time

import numpy as np
import pytest

PACKAGES = ("ray_tpu", "ray_tpu_torch")
STATS = ("arms", "pulls", "fallbacks")

pytestmark = pytest.mark.timeout(300)


def _actors(pkg):
    rt = importlib.import_module(pkg)

    @rt.remote
    class Producer:
        def __init__(self, pkg):
            import importlib

            self.pkg = pkg
            self.exp = importlib.import_module(pkg + ".experimental")
            if pkg == "ray_tpu":
                import jax.numpy as jnp

                self.arange = lambda n: jnp.arange(n) * 2
                self.ones = jnp.ones
                self.full = lambda n, v: jnp.full((n,), v)
            else:
                import torch

                self.arange = lambda n: torch.arange(n, dtype=torch.int32) * 2
                self.ones = torch.ones
                self.full = lambda n, v: torch.full((n,), v)

        def make_ref(self, n):
            return self.exp.device_put(self.arange(n))

        def make_budgeted_ref(self, n):
            return self.exp.device_put(self.ones(n), fetches_before_free=1)

        def stats(self):
            return self.exp.device_store_stats()

        def xstats(self):
            return self.exp.transfer_stats()

        def intercepted_return(self, n):
            self.exp.enable_device_objects(fetches_before_free=1)
            return {"w": self.full(n, 3.0), "tag": "ok"}

        def slow_arms(self, seconds):
            """Make every arm of this process take ``seconds`` first."""
            import time

            from ray_tpu_torch.experimental import device_objects

            fab = device_objects._fabric()
            arm = fab.arm

            def slow(*args, **kwargs):
                time.sleep(seconds)
                return arm(*args, **kwargs)

            fab.arm = slow
            return True

    @rt.remote
    class Consumer:
        def __init__(self, pkg):
            import importlib

            self.pkg = pkg
            self.exp = importlib.import_module(pkg + ".experimental")

        def _get(self, ref):
            if self.pkg == "ray_tpu":
                return self.exp.device_get(ref)
            return self.exp.device_get(ref, device="cpu")

        def consume(self, ref):
            import numpy as np

            arr = np.asarray(self._get(ref))
            return float(arr.sum()), arr.tobytes(), str(arr.dtype)

        def consume_value(self, value):
            import numpy as np

            w = np.asarray(value["w"])
            return float(w.sum()), value["tag"], w.tobytes(), str(w.dtype)

        def consume_with_a_failed_pull(self, ref):
            """The first pull of this process raises after its arm."""
            import numpy as np

            from ray_tpu_torch.experimental import transfer

            fab = transfer.fabric()
            pull = fab.pull
            calls = []

            def failing(desc, device=None):
                calls.append(desc["uuid"])
                if len(calls) == 1:
                    raise ConnectionError("injected: the pull failed")
                return pull(desc, device)

            fab.pull = failing
            try:
                arr = np.asarray(self._get(ref))
            finally:
                fab.pull = pull
            return arr.tobytes(), len(calls)

        def xstats(self):
            return self.exp.transfer_stats()

    return rt, Producer, Consumer


def _stats(d):
    return {k: d[k] for k in STATS}


def ref_roundtrip(pkg):
    rt, Producer, Consumer = _actors(pkg)
    exp = importlib.import_module(pkg + ".experimental")
    p = Producer.options(num_cpus=0).remote(pkg)
    c = Consumer.options(num_cpus=0).remote(pkg)
    ref = rt.get(p.make_ref.remote(10))
    out = {"shape": tuple(ref.shape), "held": rt.get(p.stats.remote())["num_objects"]}
    out["consumed"] = rt.get(c.consume.remote(ref))
    out["held_after"] = rt.get(p.stats.remote())["num_objects"]
    out["freed"] = exp.device_free(ref)
    out["held_after_free"] = rt.get(p.stats.remote())["num_objects"]
    out["producer"] = _stats(rt.get(p.xstats.remote()))
    out["consumer"] = _stats(rt.get(c.xstats.remote()))
    for h in (p, c):
        rt.kill(h)
    return out


def budget_frees_after_handoff(pkg):
    rt, Producer, Consumer = _actors(pkg)
    p = Producer.options(num_cpus=0).remote(pkg)
    c = Consumer.options(num_cpus=0).remote(pkg)
    ref = rt.get(p.make_budgeted_ref.remote(5))
    out = {"consumed": rt.get(c.consume.remote(ref)),
           "held": rt.get(p.stats.remote())["num_objects"]}
    try:
        rt.get(c.consume.remote(ref))
        out["second"] = "no error"
    except Exception as e:  # noqa: BLE001 - the error is the result
        out["second"] = "gone" in str(e)
    out["producer"] = _stats(rt.get(p.xstats.remote()))
    out["consumer"] = _stats(rt.get(c.xstats.remote()))
    for h in (p, c):
        rt.kill(h)
    return out


def interception(pkg):
    rt, Producer, Consumer = _actors(pkg)
    p = Producer.options(num_cpus=0).remote(pkg)
    c = Consumer.options(num_cpus=0).remote(pkg)
    value_ref = p.intercepted_return.remote(7)
    rt.wait([value_ref])
    out = {"held": rt.get(p.stats.remote())["num_objects"],
           "consumed": rt.get(c.consume_value.remote(value_ref)),
           "held_after": rt.get(p.stats.remote())["num_objects"],
           "producer": _stats(rt.get(p.xstats.remote())),
           "consumer": _stats(rt.get(c.xstats.remote()))}
    for h in (p, c):
        rt.kill(h)
    return out


def driver_side_fetch(pkg):
    rt, Producer, _ = _actors(pkg)
    exp = importlib.import_module(pkg + ".experimental")
    p = Producer.options(num_cpus=0).remote(pkg)
    before = _stats(exp.transfer_stats())
    ref = rt.get(p.make_ref.remote(4))
    arr = np.asarray(exp.device_get(ref) if pkg == "ray_tpu" else exp.device_get(ref, device="cpu"))
    after = _stats(exp.transfer_stats())
    out = {"values": arr.tolist(), "bytes": arr.tobytes(), "dtype": str(arr.dtype),
           "driver": {k: after[k] - before[k] for k in STATS},
           "producer": _stats(rt.get(p.xstats.remote()))}
    rt.kill(p)
    return out


SCENARIOS = {
    "ref_roundtrip": ref_roundtrip,
    "budget_frees_after_handoff": budget_frees_after_handoff,
    "interception": interception,
    "driver_side_fetch": driver_side_fetch,
}

EXPECTED = {
    "ref_roundtrip": lambda r: (
        r["shape"] == (10,) and r["held"] == r["held_after"] == 1 and r["freed"]
        and r["held_after_free"] == 0 and r["consumed"][0] == float(sum(range(10)) * 2)
        and r["consumer"] == {"arms": 0, "pulls": 1, "fallbacks": 0}
        and r["producer"] == {"arms": 1, "pulls": 0, "fallbacks": 0}),
    "budget_frees_after_handoff": lambda r: (
        r["consumed"][0] == 5.0 and r["held"] == 0 and r["second"] is True
        and r["consumer"]["fallbacks"] == 0),
    "interception": lambda r: (
        r["held"] == 1 and r["consumed"][:2] == (21.0, "ok") and r["held_after"] == 0
        and r["consumer"] == {"arms": 0, "pulls": 1, "fallbacks": 0}),
    "driver_side_fetch": lambda r: (
        r["values"] == [0, 2, 4, 6] and r["driver"] == {"arms": 0, "pulls": 1, "fallbacks": 0}),
}


# -- the port alone -------------------------------------------------------------


def port_failed_pull_refunds_into_a_fallback():
    rt, Producer, Consumer = _actors("ray_tpu_torch")
    p = Producer.options(num_cpus=0).remote("ray_tpu_torch")
    c = Consumer.options(num_cpus=0).remote("ray_tpu_torch")
    ref = rt.get(p.make_budgeted_ref.remote(6))
    data, pulls_tried = rt.get(c.consume_with_a_failed_pull.remote(ref))
    out = {"bytes": data, "pulls_tried": pulls_tried,
           "held": rt.get(p.stats.remote())["num_objects"],
           "producer": rt.get(p.xstats.remote()), "consumer": rt.get(c.xstats.remote())}
    for h in (p, c):
        rt.kill(h)
    return out


def port_free_lands_mid_arm():
    import ray_tpu_torch as rt
    from ray_tpu_torch.core import api

    _, Producer, _ = _actors("ray_tpu_torch")
    p = Producer.options(num_cpus=0).remote("ray_tpu_torch")
    ref = rt.get(p.make_ref.remote(8))
    rt.get(p.slow_arms.remote(1.0))
    endpoint = api._require_worker(auto_init=False).endpoint
    box = {}

    def arm():
        box["arm"] = endpoint.call(tuple(ref.owner_addr), "worker.rdt_arm",
                                   {"oid": ref.oid, "partitions": (1,)}, timeout=60)

    th = threading.Thread(target=arm)
    th.start()
    time.sleep(0.3)  # the arm is staging in the owner's executor thread
    freed = endpoint.call(tuple(ref.owner_addr), "worker.rdt_free", {"oid": ref.oid}, timeout=30)
    th.join(60)
    out = {"arm": box.get("arm"), "freed": freed,
           "held": rt.get(p.stats.remote())["num_objects"],
           "armed": rt.get(p.xstats.remote())["armed"]}
    rt.kill(p)
    return out


def port_fetch_into_a_sharding():
    """``device_get(ref, sharding=...)``: the consumer names a port
    ``NamedSharding`` and gets its rank's block of the whole tensor."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.experimental import device_get

    _, Producer, _ = _actors("ray_tpu_torch")
    p = Producer.options(num_cpus=0).remote("ray_tpu_torch")
    ref = rt.get(p.make_ref.remote(8))
    out = {r: device_get(ref, device="cpu", sharding=_rows_sharding(r)).tolist() for r in (0, 1)}
    rt.kill(p)
    return out


def _rows_sharding(rank):
    from ray_tpu_torch.parallel import Mesh, MeshSpec, NamedSharding, P

    class Coordinates:
        def get_local_rank(self, axis):
            return rank

    return NamedSharding(Mesh(MeshSpec(dp=2), Coordinates()), P("dp"))


# -- the fixture -----------------------------------------------------------------


def _run(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - the exception is the result
        return {"scenario_raised": f"{type(e).__name__}: {e}"}


def _session(pkg) -> dict:
    rt = importlib.import_module(pkg)
    rt.init(num_cpus=8)
    try:
        res = {name: _run(lambda: fn(pkg)) for name, fn in SCENARIOS.items()}
        if pkg == "ray_tpu_torch":
            res["failed_pull"] = _run(port_failed_pull_refunds_into_a_fallback)
            res["free_mid_arm"] = _run(port_free_lands_mid_arm)
            res["sharded_fetch"] = _run(port_fetch_into_a_sharding)
    finally:
        rt.shutdown()
    return res


@pytest.fixture(scope="module")
def results():
    mp = pytest.MonkeyPatch()
    # The reference's local_ip() would otherwise look for an egress
    # interface; every process of these clusters lives on this host.
    mp.setenv("RAY_TPU_HOST_IP", "127.0.0.1")
    out, threads = {}, []
    try:
        for pkg in PACKAGES:
            th = threading.Thread(target=lambda pkg=pkg: out.__setitem__(pkg, _run(
                lambda: _session(pkg))), name=f"session-{pkg}", daemon=True)
            threads.append(th)
            th.start()
        for th in threads:
            th.join(240)
        assert not any(th.is_alive() for th in threads), "a session did not finish"
        yield out
    finally:
        mp.undo()


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_same_values_and_transfer_stats_as_the_reference(results, name):
    ref, port = results["ray_tpu"][name], results["ray_tpu_torch"][name]
    assert EXPECTED[name](ref), ref
    assert EXPECTED[name](port), port
    assert port == ref


def test_a_failed_pull_refunds_its_budget_into_a_counted_fallback(results):
    out = results["ray_tpu_torch"]["failed_pull"]
    assert "scenario_raised" not in out, out
    assert out["bytes"] == np.ones(6, dtype=np.float32).tobytes()
    assert out["pulls_tried"] == 1  # the fallback went over the host path
    assert out["held"] == 0  # the refunded budget was spent by the host fetch
    assert (out["consumer"]["pulls"], out["consumer"]["fallbacks"]) == (0, 1)
    assert (out["producer"]["arms"], out["producer"]["armed"]) == (1, 0)


def test_a_free_that_lands_mid_arm_leaves_nothing_armed_or_stored(results):
    out = results["ray_tpu_torch"]["free_mid_arm"]
    assert "scenario_raised" not in out, out
    assert out["arm"] == {"gone": True}
    assert out["freed"] is True
    assert (out["held"], out["armed"]) == (0, 0)


def test_a_fetch_into_a_sharding_returns_the_ranks_block(results):
    out = results["ray_tpu_torch"]["sharded_fetch"]
    assert out == {0: [0, 2, 4, 6], 1: [8, 10, 12, 14]}, out
