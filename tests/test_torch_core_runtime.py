"""The same programs on both runtimes: ``ray_tpu``'s core and its port in
``ray_tpu_torch``.

One module fixture starts each package's runtime in turn
(``init(num_cpus=8)``), runs every scenario below against it and shuts it
down, then each test compares one scenario's result between the two:
values, order, exception class names and user-error messages. Each result
is also held against the value the scenario must give, so the two cannot
agree on a wrong answer. The scenarios are those of
``tests/test_core_runtime.py`` and ``tests/test_core_cluster.py``.

A scenario receives the package module and closes over it, so the remote
functions it defines (pickled by value) import only that package in the
worker; nothing here reaches a module-level helper, which cloudpickle would
ship by reference. Every ``get`` and ``wait`` has a timeout.

The port alone then runs the tensor cases (CPU tensors through ``put`` /
``get`` and through task arguments and returns, dtype and bits kept), the
bf16 bits against the reference's ml_dtypes array through the JAX runtime,
a ``num_gpus=1`` demand on this card-less box (infeasible, the reference's
error class), the features it refuses by name, and a worker's module list
(no jax, nothing of ``ray_tpu``).
"""

import hashlib
import importlib
import time

import numpy as np
import pytest

PACKAGES = ("ray_tpu", "ray_tpu_torch")
TIMEOUT = 30


def _error(e: BaseException) -> dict:
    """What a scenario compares of an exception: class names and the user's
    message (the cause's, for a task error), with the package name
    normalised."""
    cause = getattr(e, "cause", None)
    out = {"class": type(e).__name__}
    if cause is not None:
        out["cause"] = type(cause).__name__
        out["message"] = str(cause)
    elif type(e).__module__ == "builtins":  # a user error, not a runtime one
        out["message"] = str(e).replace("ray_tpu_torch", "ray_tpu")
    return out


def _run(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - the exception is the result
        return {"raised": _error(e)}


# -- scenarios: each takes the package module and returns a plain value --------


def task_roundtrip(rt):
    @rt.remote
    def add(a, b):
        return a + b

    return rt.get(add.remote(1, 2), timeout=TIMEOUT)


def ref_args(rt):
    @rt.remote
    def mul(a, b):
        return a * b

    refs = [mul.remote(i, 10) for i in range(8)]
    chained = mul.remote(mul.remote(2, 3), 4)
    return rt.get(refs, timeout=TIMEOUT), rt.get(chained, timeout=TIMEOUT)


def put_get(rt):
    small = {"a": 1, "b": [1, 2, 3]}
    big = np.arange(1_000_000, dtype=np.int64)  # 8 MB: the shm path
    out = rt.get(rt.put(big), timeout=TIMEOUT)
    return (
        rt.get(rt.put(small), timeout=TIMEOUT),
        str(out.dtype),
        out.shape,
        bool(np.array_equal(out, big)),
    )


def large_return(rt):
    @rt.remote
    def make_big():
        import numpy as np

        return np.ones((512, 1024), dtype=np.float64)  # 4 MB

    out = rt.get(make_big.remote(), timeout=TIMEOUT)
    return out.shape, float(out.sum())


def task_error(rt):
    @rt.remote
    def boom():
        raise ValueError("kaboom")

    return _run(lambda: rt.get(boom.remote(), timeout=TIMEOUT))


def num_returns_2(rt):
    @rt.remote(num_returns=2)
    def two():
        return "a", [2]

    a, b = two.remote()
    return rt.get([a, b], timeout=TIMEOUT)


def streaming(rt):
    @rt.remote(num_returns="streaming")
    def gen(n):
        for i in range(n):
            yield i * i

    g = gen.remote(5)
    rt.get(g.completed(), timeout=TIMEOUT)  # every item exists: no wait below
    return [rt.get(r, timeout=TIMEOUT) for r in g]


def wait_split(rt):
    @rt.remote
    def fast():
        return "fast"

    @rt.remote
    def slow():
        import time

        time.sleep(1.5)
        return "slow"

    s, f = slow.remote(), fast.remote()
    ready, not_ready = rt.wait([s, f], num_returns=1, timeout=TIMEOUT)
    first = (ready == [f], not_ready == [s])
    ready, not_ready = rt.wait([s, f], num_returns=2, timeout=TIMEOUT)
    return first, (set(ready) == {s, f}, not_ready), rt.get([s, f], timeout=TIMEOUT)


def nested(rt):
    @rt.remote
    def inner(x):
        return x * 2

    @rt.remote
    def outer(x):
        return rt.get(inner.remote(x), timeout=30) + 1

    return rt.get(outer.remote(10), timeout=TIMEOUT)


def actor_state(rt):
    @rt.remote
    class Counter:
        def __init__(self, start=0):
            self.x = start

        def incr(self, n=1):
            self.x += n
            return self.x

        def value(self):
            return self.x

    c = Counter.remote(100)
    out = rt.get([c.incr.remote() for _ in range(10)], timeout=TIMEOUT)
    out = (out, rt.get(c.value.remote(), timeout=TIMEOUT))
    rt.kill(c)
    return out


def actor_error(rt):
    @rt.remote
    class Bad:
        def fail(self):
            raise RuntimeError("actor method failed")

        def ok(self):
            return 42

    b = Bad.remote()
    out = (
        _run(lambda: rt.get(b.fail.remote(), timeout=TIMEOUT)),
        rt.get(b.ok.remote(), timeout=TIMEOUT),  # the actor survives
    )
    rt.kill(b)
    return out


def named_actor(rt):
    @rt.remote
    class Store:
        def __init__(self):
            self.d = {}

        def set(self, k, v):
            self.d[k] = v
            return True

        def get(self, k):
            return self.d.get(k)

    s = Store.options(name="kv-store").remote()
    rt.get(s.set.remote("k", "v"), timeout=TIMEOUT)
    out = rt.get(rt.get_actor("kv-store").get.remote("k"), timeout=TIMEOUT)
    missing = _run(lambda: rt.get_actor("no-such-actor"))
    rt.kill(s)
    return out, missing


def async_actor(rt):
    @rt.remote
    class AsyncActor:
        async def work(self, x):
            import asyncio

            await asyncio.sleep(0.05)
            return x + 1

    a = AsyncActor.remote()
    out = rt.get([a.work.remote(i) for i in range(4)], timeout=TIMEOUT)
    rt.kill(a)
    return out


def kill_actor(rt):
    @rt.remote
    class Victim:
        def ping(self):
            return "pong"

    v = Victim.remote()
    first = rt.get(v.ping.remote(), timeout=TIMEOUT)
    rt.kill(v)
    return first, _run(lambda: rt.get(v.ping.remote(), timeout=TIMEOUT))["raised"]["class"]


def max_restarts(rt):
    @rt.remote(max_restarts=1)
    class Phoenix:
        def __init__(self):
            self.calls = 0

        def ping(self):
            self.calls += 1
            return self.calls

        def die(self):
            import os

            os._exit(1)

    p = Phoenix.remote()
    first = rt.get(p.ping.remote(), timeout=TIMEOUT)
    _run(lambda: rt.get(p.die.remote(), timeout=10))
    deadline = time.monotonic() + TIMEOUT
    while True:  # restarted with fresh state
        try:
            after = rt.get(p.ping.remote(), timeout=TIMEOUT)
            break
        except Exception:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.2)
    rt.kill(p)
    return first, after


def cancel_queued(rt):
    @rt.remote
    def hog():
        import time

        time.sleep(8)
        return "done"

    @rt.remote
    def victim():
        return "ran"

    blocker = hog.options(num_cpus=8).remote()  # saturates the node
    ref = victim.options(num_cpus=8).remote()
    time.sleep(0.3)
    t0 = time.monotonic()
    rt.cancel(ref)
    out = _run(lambda: rt.get(ref, timeout=TIMEOUT))["raised"]["class"]
    prompt = time.monotonic() - t0 < 5  # does not wait for the blocker
    rt.cancel(blocker, force=True)
    return out, prompt, _run(lambda: rt.get(blocker, timeout=TIMEOUT))["raised"]["class"]


def placement_groups(rt):
    util = importlib.import_module(rt.__name__ + ".util")
    out = []
    for strategy in ("STRICT_PACK", "SPREAD"):
        pg = util.placement_group([{"CPU": 1}, {"CPU": 1}], strategy=strategy)
        ready = pg.wait(TIMEOUT)
        info = util.placement_group_table(pg)

        @rt.remote
        def inside():
            current = importlib.import_module(rt.__name__ + ".util").get_current_placement_group()
            return current.id if current is not None else None

        strat = util.PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=1
        )
        ran_in = rt.get(inside.options(scheduling_strategy=strat, num_cpus=1).remote(), timeout=TIMEOUT)
        out.append((strategy, ready, info["state"], len(set(info["bundle_nodes"])), ran_in == pg.id))
        util.remove_placement_group(pg)
    return out


def infeasible(rt):
    @rt.remote(resources={"no_such_resource": 1.0})
    def never():
        return 1

    return _run(lambda: rt.get(never.remote(), timeout=60))["raised"]["class"]


SCENARIOS = {
    "task_roundtrip": (task_roundtrip, 3),
    "ref_args": (ref_args, ([i * 10 for i in range(8)], 24)),
    "put_get": (put_get, ({"a": 1, "b": [1, 2, 3]}, "int64", (1_000_000,), True)),
    "large_return": (large_return, ((512, 1024), 512.0 * 1024)),
    "task_error": (task_error, {"raised": {"class": "TaskError", "cause": "ValueError", "message": "kaboom"}}),
    "num_returns_2": (num_returns_2, ["a", [2]]),
    "streaming": (streaming, [0, 1, 4, 9, 16]),
    "wait_split": (wait_split, ((True, True), (True, []), ["slow", "fast"])),
    "nested": (nested, 21),
    "actor_state": (actor_state, (list(range(101, 111)), 110)),
    "actor_error": (
        actor_error,
        ({"raised": {"class": "TaskError", "cause": "RuntimeError", "message": "actor method failed"}}, 42),
    ),
    "named_actor": (
        named_actor,
        ("v", {"raised": {"class": "ValueError", "message": "no actor named 'no-such-actor'"}}),
    ),
    "async_actor": (async_actor, [1, 2, 3, 4]),
    "kill_actor": (kill_actor, ("pong", "ActorDiedError")),
    "max_restarts": (max_restarts, (1, 1)),
    "cancel_queued": (cancel_queued, ("TaskCancelledError", True, "TaskCancelledError")),
    "placement_groups": (
        placement_groups,
        [("STRICT_PACK", True, "CREATED", 1, True), ("SPREAD", True, "CREATED", 1, True)],
    ),
    "infeasible": (infeasible, "SchedulingError"),
}


# -- the port alone -------------------------------------------------------------

BF16_SEED = 7
BF16_N = 8 * 1024 * 1024  # 16 MB of bf16


def _bf16_values():
    return np.random.default_rng(BF16_SEED).standard_normal(BF16_N, dtype=np.float32)


def bf16_through_reference(rt):
    import ml_dtypes

    a = _bf16_values().astype(ml_dtypes.bfloat16)
    out = rt.get(rt.put(a), timeout=TIMEOUT)
    return str(out.dtype), hashlib.sha256(out.tobytes()).hexdigest()


def _tensor_cases():
    import torch

    g = torch.Generator().manual_seed(0)
    base = torch.randn(64, 48, generator=g)
    return {
        "f32": base.clone(),
        "bf16": base.to(torch.bfloat16),
        "int64": torch.randint(-(2**40), 2**40, (33, 5), generator=g),
        "view": base.t()[3:40:2],  # a non-contiguous view
        "0d": torch.tensor(3.25, dtype=torch.bfloat16),
        "16MB": torch.randn(4 * 1024 * 1024, generator=g),
    }


def _bits(t):
    import torch

    return t.contiguous().reshape(-1).view(torch.uint8)


def port_tensors(rt):
    import torch

    @rt.remote
    def echo(t):
        return t

    @rt.remote
    def describe(t):
        return str(t.dtype), tuple(t.shape), t.is_contiguous()

    out = {}
    for name, t in _tensor_cases().items():
        via_put = rt.get(rt.put(t), timeout=TIMEOUT)
        via_task = rt.get(echo.remote(t), timeout=TIMEOUT)
        out[name] = [
            (
                isinstance(got, torch.Tensor),
                got.dtype == t.dtype,
                tuple(got.shape) == tuple(t.shape),
                torch.equal(_bits(got), _bits(t)),
            )
            for got in (via_put, via_task)
        ] + [rt.get(describe.remote(t), timeout=TIMEOUT) == (str(t.dtype), tuple(t.shape), True)]
    return out


def port_bf16(rt):
    import torch

    t = torch.from_numpy(_bf16_values()).to(torch.bfloat16)
    out = rt.get(rt.put(t), timeout=TIMEOUT)
    raw = out.reshape(-1).view(torch.int16).numpy().tobytes()
    return str(out.dtype), hashlib.sha256(raw).hexdigest()


def port_num_gpus(rt):
    @rt.remote(num_gpus=1)
    def on_card():
        return "ran"

    return (
        "GPU" in rt.cluster_resources(),
        _run(lambda: rt.get(on_card.remote(), timeout=60))["raised"]["class"],
    )


def port_not_ported(rt):
    @rt.remote
    def f():
        return 1

    @rt.remote
    class A:
        def m(self):
            return 1

    a = A.remote()
    out = [
        _run(lambda: f.options(runtime_env={"env_vars": {"X": "1"}}).remote()),
        _run(lambda: a.m.bind()),
    ]
    rt.kill(a)
    return out


def port_worker_modules(rt):
    @rt.remote
    def loaded():
        import sys

        return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu"))

    @rt.remote
    def entry():
        import sys

        return sys.modules["__main__"].__spec__.name

    return rt.get(loaded.remote(), timeout=TIMEOUT), rt.get(entry.remote(), timeout=TIMEOUT)


PORT_ONLY = {
    "port_tensors": port_tensors,
    "port_bf16": port_bf16,
    "port_num_gpus": port_num_gpus,
    "port_not_ported": port_not_ported,
    "port_worker_modules": port_worker_modules,
}


@pytest.fixture(scope="module")
def results(monkeypatch_module):
    # The reference's local_ip() would otherwise look for an egress
    # interface; every process of these clusters lives on this host.
    monkeypatch_module.setenv("RAY_TPU_HOST_IP", "127.0.0.1")
    out = {}
    for pkg in PACKAGES:
        rt = importlib.import_module(pkg)
        rt.init(num_cpus=8)
        try:
            res = {name: _run(lambda: fn(rt)) for name, (fn, _) in SCENARIOS.items()}
            if pkg == "ray_tpu":
                res["bf16"] = _run(lambda: bf16_through_reference(rt))
            else:
                res.update({name: _run(lambda: fn(rt)) for name, fn in PORT_ONLY.items()})
        finally:
            rt.shutdown()
        out[pkg] = res
    return out


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_same_result_on_both_runtimes(results, name):
    ref, port = results["ray_tpu"][name], results["ray_tpu_torch"][name]
    assert ref == SCENARIOS[name][1], ref
    assert port == ref


def test_cpu_tensors_round_trip_with_dtype_and_bits(results):
    got = results["ray_tpu_torch"]["port_tensors"]
    assert set(got) == {"f32", "bf16", "int64", "view", "0d", "16MB"}, got
    for name, checks in got.items():
        assert checks == [(True, True, True, True)] * 2 + [True], (name, checks)


def test_bf16_bits_equal_reference_ml_dtypes(results):
    ref, port = results["ray_tpu"]["bf16"], results["ray_tpu_torch"]["port_bf16"]
    assert ref[0] == "bfloat16" and port[0] == "torch.bfloat16", (ref, port)
    assert port[1] == ref[1]


def test_num_gpus_without_a_card_is_infeasible(results):
    has_gpu, raised = results["ray_tpu_torch"]["port_num_gpus"]
    assert not has_gpu
    assert raised == results["ray_tpu"]["infeasible"] == "SchedulingError"


def test_unported_features_raise_and_name_themselves(results):
    got = results["ray_tpu_torch"]["port_not_ported"]
    assert [r["raised"]["class"] for r in got] == ["NotPortedError"] * 2, got


def test_port_workers_load_no_jax_and_nothing_of_ray_tpu(results):
    mods, entry = results["ray_tpu_torch"]["port_worker_modules"]
    assert mods == []
    assert entry == "ray_tpu_torch.core.worker_main"


def test_client_mode_raises_not_ported():
    import ray_tpu_torch
    from ray_tpu_torch.core.errors import NotPortedError

    with pytest.raises(NotPortedError, match="client mode"):
        ray_tpu_torch.init(address="127.0.0.1:1", mode="client")
    assert not ray_tpu_torch.is_initialized()
