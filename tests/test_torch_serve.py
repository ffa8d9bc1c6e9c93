"""The core serve scenarios on the port's serve tier (``ray_tpu_torch.serve``).

Each test is the port of a reference test and asserts what it asserts:
``tests/test_serve.py`` (handle routing over two replicas, the HTTP proxy
and its 404, a replica killed under 100 concurrent requests, composition
through a handle passed at bind time, scale-down and delete, autoscaling
up and back down, a handle surviving the controller's restart),
``tests/test_serve_streaming.py`` (a streamed response over the proxy's
SSE and through a driver handle), ``tests/test_serve_batching.py``
(``@serve.batch`` beating unbatched calls, ``@serve.multiplexed`` routing)
and ``tests/test_serve_longpoll.py`` (routing-table pushes, replica
metrics). One module runtime (``init(num_cpus=16)``) serves them all.

Deployments are classes defined inside the tests, so they travel by value
to the replicas: nothing a replica runs reaches this module, whose imports
a worker could not load.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.serve import api as serve_api

pytestmark = pytest.mark.timeout(170)
TIMEOUT = 60


@pytest.fixture(scope="module")
def cluster():
    runtime = ray_tpu_torch.init(num_cpus=16)
    yield runtime
    try:
        serve.shutdown()
    finally:
        ray_tpu_torch.shutdown()


def _doubler(num_replicas=2):
    @serve.deployment(num_replicas=num_replicas)
    class Doubler:
        def __init__(self, bias: int = 0):
            self.bias = bias

        def __call__(self, request):
            x = request["body"]["x"] if isinstance(request, dict) else request
            return {"y": 2 * x + self.bias}

        def whoami(self):
            import os

            return os.getpid()

    return Doubler


def _wait(pred, timeout=60.0, interval=0.3):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def test_deploy_and_handle_routing(cluster):
    handle = serve.run(_doubler().bind(10))
    assert handle.remote({"body": {"x": 5}}).result(timeout=TIMEOUT) == {"y": 20}
    assert serve.status()["Doubler"]["live_replicas"] == 2
    pids = {handle.method("whoami").remote().result(timeout=TIMEOUT) for _ in range(20)}
    assert len(pids) == 2  # p2c spreads over both replicas


def test_http_proxy(cluster):
    serve.run(_doubler().bind(0))
    port = serve_api.proxy_port()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/Doubler", data=json.dumps({"x": 21}).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    assert json.loads(urllib.request.urlopen(req, timeout=30).read()) == {"y": 42}
    bad = urllib.request.Request(f"http://127.0.0.1:{port}/NoSuchThing", method="GET")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(bad, timeout=30)
    assert e.value.code == 404


def test_replica_death_midtraffic_recovers(cluster):
    """Kill a replica while 100 concurrent requests run: all succeed (the
    router retries on dead replicas) and the controller restores the
    target count."""
    handle = serve.run(_doubler().options(name="Sturdy", num_replicas=2).bind())
    results, errors = [], []

    def fire(i):
        try:
            results.append(handle.remote({"body": {"x": i}}).result(timeout=120)["y"])
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=fire, args=(i,)) for i in range(100)]
    for i, t in enumerate(threads):
        t.start()
        if i == 30:  # mid-traffic: kill one replica
            rid = serve.status()["Sturdy"]["replica_ids"][0]
            ray_tpu_torch.kill(ray_tpu_torch.ActorHandle(rid, "Replica"))
    for t in threads:
        t.join(timeout=150)
    assert not errors, errors[:3]
    assert sorted(results) == sorted(2 * i for i in range(100))
    assert _wait(lambda: serve.status()["Sturdy"]["live_replicas"] == 2)
    serve.delete("Sturdy")


def test_composition_handle_passing(cluster):
    @serve.deployment
    class Summer:
        def __call__(self, request):
            return {"s": sum(request["body"]["xs"])}

    @serve.deployment
    class Pipeline:
        def __init__(self, downstream):
            self.downstream = downstream

        async def __call__(self, request):
            inner = await self.downstream.remote_async({"body": {"xs": request["body"]["xs"]}})
            return {"final": inner["s"] * 10}

    serve.run(Summer.bind())
    handle = serve.run(Pipeline.bind(serve.get_handle("Summer")))
    assert handle.remote({"body": {"xs": [1, 2, 3]}}).result(timeout=TIMEOUT) == {"final": 60}


def test_scale_down_and_delete(cluster):
    handle = serve.run(_doubler().options(name="Shrink", num_replicas=3).bind())
    assert serve.status()["Shrink"]["live_replicas"] == 3
    serve.run(_doubler().options(name="Shrink", num_replicas=1).bind())
    assert _wait(lambda: serve.status()["Shrink"]["live_replicas"] == 1)
    assert handle.remote({"body": {"x": 1}}).result(timeout=TIMEOUT) == {"y": 2}
    serve.delete("Shrink")
    assert "Shrink" not in serve.status()


def test_autoscaling_up_and_down(cluster):
    """Concurrent slow requests scale the deployment up; sustained
    idleness scales it back to min after the downscale delay."""

    class Slow:
        async def __call__(self, request):
            import asyncio

            await asyncio.sleep(4.0)
            return {"ok": True}

    serve.run(serve.deployment(Slow, name="autoscaled", autoscaling_config={
        "min_replicas": 1, "max_replicas": 3, "target_ongoing_requests": 1,
        "downscale_delay_s": 3.0}).bind())
    try:
        count = lambda: serve.status()["autoscaled"]["live_replicas"]  # noqa: E731
        handle = serve.get_handle("autoscaled")
        futs = [handle.remote({}) for _ in range(12)]
        peak = [1]

        def scaled_up():
            peak[0] = max(peak[0], count())
            return peak[0] >= 2

        _wait(scaled_up, timeout=45)
        for f in futs:
            assert f.result(timeout=TIMEOUT)["ok"]
        assert peak[0] >= 2, f"never scaled up (peak={peak[0]})"
        assert _wait(lambda: count() == 1, interval=0.5)
    finally:
        serve.delete("autoscaled")


# -- streaming -------------------------------------------------------------------


def _sse(port: int, path: str, body: dict) -> list:
    payload = json.dumps(body).encode()
    with socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT) as sock:
        sock.sendall(f"POST {path} HTTP/1.1\r\nHost: 127.0.0.1\r\nContent-Type: application/json\r\n"
                     f"Accept: text/event-stream\r\nContent-Length: {len(payload)}\r\n"
                     f"Connection: close\r\n\r\n".encode() + payload)
        buf = b""
        while data := sock.recv(65536):
            buf += data
    head, _, rest = buf.partition(b"\r\n\r\n")
    assert b"200 OK" in head.splitlines()[0] and b"text/event-stream" in head, head
    events = [e.decode().strip() for e in rest.split(b"\n\n") if e.strip()]
    assert events[-1] == "data: [DONE]", events
    return [json.loads(e[len("data: "):]) for e in events[:-1]]


@pytest.mark.parametrize("via", ["proxy_sse", "driver_handle"])
def test_streaming_response(cluster, via):
    @serve.deployment(num_replicas=1)
    class WordStream:
        async def __call__(self, request: dict):
            text = (request.get("body") or {}).get("text", "")

            async def words():
                import asyncio

                for w in text.split():
                    await asyncio.sleep(0.01)
                    yield {"word": w}

            return words()

    serve.run(WordStream.bind())
    if via == "proxy_sse":
        chunks = _sse(serve_api.proxy_port(), "/WordStream", {"text": "alpha beta gamma", "stream": True})
        assert [c["word"] for c in chunks] == ["alpha", "beta", "gamma"]
    else:
        handle = serve.get_handle("WordStream")
        got = [c["word"] for c in handle.options(stream=True).remote({"body": {"text": "x y z"}})]
        assert got == ["x", "y", "z"]


# -- batching and multiplexing -------------------------------------------------------


def test_batching_beats_unbatched_throughput(cluster):
    @serve.deployment(num_replicas=1)
    class BatchedSleeper:
        """One fixed-latency forward per CALL on an exclusive device."""

        def __init__(self):
            import threading

            self._device = threading.Lock()

        @serve.batch(max_batch_size=16, batch_wait_timeout_s=0.02)
        async def infer(self, xs):
            import time

            with self._device:
                time.sleep(0.15)  # one forward for the whole batch
            return [x + 1 for x in xs]

        async def __call__(self, request):
            return await self.infer((request.get("body") or {})["x"])

    @serve.deployment(num_replicas=1)
    class UnbatchedSleeper:
        def __init__(self):
            import threading

            self._device = threading.Lock()

        def __call__(self, request):
            import time

            with self._device:
                time.sleep(0.15)
            return (request.get("body") or {})["x"] + 1

    serve.run(BatchedSleeper.bind())
    serve.run(UnbatchedSleeper.bind())

    def burst(handle, n=16):
        t0 = time.monotonic()
        futs = [handle.remote({"body": {"x": i}}) for i in range(n)]
        return [f.result(timeout=120) for f in futs], time.monotonic() - t0

    batched_out, batched_t = burst(serve.get_handle("BatchedSleeper"))
    unbatched_out, unbatched_t = burst(serve.get_handle("UnbatchedSleeper"))
    assert batched_out == unbatched_out == [i + 1 for i in range(16)]
    assert unbatched_t > 2 * batched_t, f"batched {batched_t:.2f}s vs unbatched {unbatched_t:.2f}s"


def test_multiplexed_routing_e2e(cluster):
    @serve.deployment(num_replicas=2)
    class MultiModel:
        def __init__(self):
            self.loads = []

        @serve.multiplexed(max_num_models_per_replica=2)
        async def get_model(self, model_id):
            self.loads.append(model_id)
            return f"weights[{model_id}]"

        async def __call__(self, request):
            import os

            model = await self.get_model(serve.get_multiplexed_model_id())
            return {"model": model, "pid": os.getpid(), "loads": len(self.loads)}

    serve.run(MultiModel.bind())
    handle = serve.get_handle("MultiModel")
    outs = [handle.options(multiplexed_model_id="m1").remote({"body": {}}).result(timeout=TIMEOUT)
            for _ in range(6)]
    assert all(o["model"] == "weights[m1]" for o in outs)
    assert len({o["pid"] for o in outs}) == 1  # affinity: one replica
    assert outs[-1]["loads"] == 1  # loaded once despite 6 requests
    port = serve_api.proxy_port()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/MultiModel", data=b"{}", method="POST",
                                 headers={"Content-Type": "application/json",
                                          "serve_multiplexed_model_id": "m2"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        assert json.loads(r.read())["model"] == "weights[m2]"
    with pytest.raises(Exception, match="no model id"):
        handle.remote({"body": {}}).result(timeout=TIMEOUT)


# -- long-poll pushes ------------------------------------------------------------------


def _echo():
    @serve.deployment
    class Echo:
        def __call__(self, x):
            return f"echo:{x}"

    return Echo


@pytest.mark.parametrize("case", ["scale_up_pushed", "push_latency"])
def test_routing_table_pushed_to_router(cluster, case):
    """A scale-up reaches a primed router through the long-poll listener,
    with no further route() call, within a bound that only a push meets."""
    from ray_tpu_torch.serve.handle import _routers

    name, target = ("lp_echo", 3) if case == "scale_up_pushed" else ("lp_fast", 2)
    echo = _echo()
    h = serve.run(echo.options(name=name, num_replicas=1).bind())
    assert h.remote("a").result(timeout=30) == "echo:a"
    router = _routers[name]
    v0 = router._version
    assert len(router._replicas) == 1
    time.sleep(0.5)  # the listener settles on an open long-poll
    t0 = time.monotonic()
    serve.run(echo.options(name=name, num_replicas=target).bind())
    assert _wait(lambda: len(router._replicas) == target and router._version > v0,
                 timeout=15, interval=0.05), (len(router._replicas), router._version, v0)
    if case == "push_latency":
        assert time.monotonic() - t0 < 5.0
    assert h.remote("b").result(timeout=30) == "echo:b"
    serve.delete(name)


def test_replica_pushes_autoscaling_metrics(cluster):
    h = serve.run(_echo().options(name="lp_metrics", num_replicas=1).bind())
    h.remote("x").result(timeout=30)
    controller = ray_tpu_torch.get_actor("serve::controller")
    got = {}

    def pushed():
        got.update(ray_tpu_torch.get(controller.get_replica_metrics.remote(), timeout=30))
        return bool(got)

    assert _wait(pushed, timeout=10, interval=0.5), "no replica pushed metrics within 10s"
    serve.delete("lp_metrics")


def test_handle_survives_controller_restart(cluster):
    """The controller dying and being re-created WITHOUT serve.shutdown()
    must not strand cached routers: _refresh re-resolves it by name. Last
    in the module: the dead controller's proxy actor keeps its name, so a
    new controller cannot start a proxy of its own (as in the reference)."""
    from ray_tpu_torch.serve.controller import CONTROLLER_NAME
    from ray_tpu_torch.serve.handle import _routers

    doubler = _doubler()
    handle = serve.run(doubler.bind(1))
    assert handle.remote({"body": {"x": 1}}).result(timeout=TIMEOUT) == {"y": 3}
    router = _routers["Doubler"]
    ray_tpu_torch.kill(ray_tpu_torch.get_actor(CONTROLLER_NAME))
    deadline = time.time() + 30
    while True:
        try:
            handle2 = serve.run(doubler.bind(1))
            break
        except Exception:
            if time.time() > deadline:
                raise
            time.sleep(0.3)
    assert handle2.remote({"body": {"x": 5}}).result(timeout=TIMEOUT) == {"y": 11}
    router._version = -2  # the CACHED router (old controller handle) refreshes
    router._replicas = []
    assert handle.remote({"body": {"x": 2}}).result(timeout=TIMEOUT) == {"y": 5}
