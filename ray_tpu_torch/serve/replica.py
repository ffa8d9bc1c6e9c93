"""Replica actor: wraps the user's deployment callable.

Reference parity: python/ray/serve/_private/replica.py:1139 (UserCallableWrapper
+ queue-length reporting, minus ASGI). The callable may be a class (optionally
with async methods) or a plain function; inference callables hold cards
through the deployment's ray_actor_options (``num_gpus``). Port of
``ray_tpu/serve/replica.py``.
"""

from __future__ import annotations

import asyncio
import contextvars
import inspect
import time as _time

import cloudpickle

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.core.errors import OverloadedError
from ray_tpu_torch.util import flightrec as _flightrec
from ray_tpu_torch.util import metrics as _metrics

# Flight-recorder request id of the request THIS task is executing (the
# router's fr-<pid>-<n>, carried in as an optional trailing RPC arg).
# Contextvar so it survives the run_in_executor hop (the copied context
# carries it into the executor thread) — the LLM server reads it via
# current_frid() to stitch the router's id to its engine request id.
_active_frid: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_frid", default=None
)


def current_frid():
    """The flight-recorder id of the serve request being executed on this
    task/thread, or None (recorder off, or not inside a serve request)."""
    return _active_frid.get()

# Replica-side half of the serve request breakdown (router wait is
# recorded by the routing process): user-callable execution time and the
# queue-length gauge the autoscaler's table is fed from — exported here
# too so an operator sees per-replica load in the same scrape.
_EXEC_SECONDS = _metrics.Histogram(
    "raytpu_serve_replica_exec_seconds",
    "user-callable execution time on the replica",
    boundaries=_metrics.LATENCY_BOUNDARIES_S,
    tag_keys=("deployment", "replica"),
)
_QUEUE_LEN = _metrics.Gauge(
    "raytpu_serve_replica_queue_len",
    "requests in flight on this replica (autoscaling signal)",
    tag_keys=("deployment", "replica"),
)


class ReplicaActor:
    def __init__(
        self,
        deployment_name: str,
        payload: bytes,
        init_payload: bytes,
        user_config,
        queue_cap: int = 0,
        max_concurrent: int = 0,
    ):
        self._deployment = deployment_name
        # Bounded queue (overload plane): with a positive cap the replica
        # fails a request FAST once its in-flight count reaches the cap,
        # instead of queuing without limit — the router retries once on a
        # different replica, then sheds. In-flight work below the cap but
        # beyond ``max_concurrent`` WAITS on an execution semaphore sized
        # to the pre-plane width (max_concurrent + 2), so opting into
        # admission bounds the queue without widening concurrent
        # execution. 0 = unbounded (pre-admission behavior; also what the
        # RAY_TPU_ADMISSION=0 kill switch yields, because the controller
        # then passes 0).
        self._queue_cap = int(queue_cap)
        self._max_concurrent = int(max_concurrent)
        self._exec_sem: asyncio.Semaphore | None = None
        target = cloudpickle.loads(payload)
        args, kwargs = serialization.loads(init_payload)[0]
        if inspect.isclass(target):
            self._callable = target(*args, **kwargs)
        else:
            if args or kwargs:
                raise TypeError(
                    "function deployments take no bind() arguments"
                )
            self._callable = target
        if user_config is not None and hasattr(
            self._callable, "reconfigure"
        ):
            self._callable.reconfigure(user_config)
        self._inflight = 0
        self._reporter = None
        self._metric_tags: dict | None = None

    def _ensure_reporter(self) -> None:
        """Start the queue-length push loop (autoscaling metric) on the
        first async entry point — __init__ may run off-loop, so the task
        starts lazily from ping/handle."""
        if self._reporter is None:
            self._reporter = asyncio.ensure_future(self._report_loop())

    async def _report_loop(self) -> None:
        """Push queue_len to the controller when it changes (5 s heartbeat
        otherwise) so autoscaling reads a table instead of fanning out
        per-tick RPCs (reference: replicas push autoscaling metrics).

        Callables exposing ``router_state()`` (LLM replicas: prefix-pool
        digests + hit-rate/KV-util) ride the same push; a state-version
        change forces a push within one loop tick so routers see a newly
        pooled prefix inside their staleness window."""
        from ray_tpu_torch.core import api as core_api
        from ray_tpu_torch.serve.controller import CONTROLLER_NAME

        import time

        try:
            rid = core_api.get_runtime_context().actor_id
        except Exception:  # raylint: disable=RL006 -- not running as an actor (unit tests): no report loop to run
            return  # not running as an actor (unit tests)
        state_fn = getattr(self._callable, "router_state", None)
        controller = None
        last, last_t, last_sv = None, 0.0, None
        while True:
            try:
                now = time.monotonic()
                cur = self._inflight  # capture: it can move during the push
                state, sv = None, None
                if state_fn is not None:
                    try:
                        state = state_fn()
                        if isinstance(state, dict):
                            sv = state.get("version")
                        else:
                            state = None
                    except Exception:  # raylint: disable=RL006 -- advertisement is best-effort
                        state = None  # advertisement is best-effort
                if cur != last or sv != last_sv or now - last_t >= 5.0:
                    if controller is None:
                        controller = await core_api.get_actor_async(
                            CONTROLLER_NAME
                        )
                    await core_api.get_async(
                        controller.push_metrics.remote(rid, cur, state),
                        timeout=5,
                    )
                    last, last_t, last_sv = cur, now, sv
            except Exception:  # raylint: disable=RL006 -- controller lost; re-resolve next round (assignment below)
                controller = None  # re-resolve next round
            await asyncio.sleep(1.0)

    def _tags(self) -> dict:
        """Replica-identity metric tags (truncated id: bounded by live
        replica membership, not a per-request value)."""
        if self._metric_tags is None:
            try:
                from ray_tpu_torch.core import api as core_api

                rid = core_api.get_runtime_context().actor_id or ""
            except Exception:  # raylint: disable=RL006 -- runtime-context probe outside an actor; metric tags fall back
                rid = ""
            self._metric_tags = {
                "deployment": self._deployment,
                "replica": rid[:12],
            }
        return self._metric_tags

    def _check_queue_cap(self) -> None:
        """Bounded-queue fail-fast, BEFORE the payload is even unpickled:
        rejecting must stay cheap exactly when the replica is drowning."""
        if (
            self._queue_cap > 0
            and self._inflight >= self._queue_cap
            and GLOBAL_CONFIG.admission
        ):
            raise OverloadedError(
                f"{self._deployment}: replica queue full "
                f"({self._inflight}/{self._queue_cap})",
                retry_after_s=0.5,
                reason="queue_full",
            )

    def _execution_gate(self) -> asyncio.Semaphore | None:
        """The execution-width bound for admission-enabled replicas:
        ``max_concurrent + 2`` — exactly the actor max_concurrency a
        replica ran at before the overload plane, so opting in changes
        what happens to EXCESS work (bounded wait, then fail-fast), not
        how wide admitted work executes. None = ungated (no cap, or the
        kill switch is thrown)."""
        if (
            self._queue_cap <= 0
            or self._max_concurrent <= 0
            or not GLOBAL_CONFIG.admission
        ):
            return None
        if self._exec_sem is None:  # lazily: __init__ may run off-loop
            self._exec_sem = asyncio.Semaphore(self._max_concurrent + 2)
        return self._exec_sem

    async def ping(self) -> bool:
        self._ensure_reporter()
        return True

    async def queue_len(self) -> int:
        return self._inflight

    def _resolve(self, method: str):
        if method == "__call__" and inspect.isroutine(self._callable):
            return self._callable  # function deployment
        # Bound method — also for instances' __call__, so coroutine
        # detection sees the method, not the (non-coroutine) instance.
        return getattr(self._callable, method)

    async def handle(
        self, method: str, payload: bytes, model_id: str = "", frid=None
    ):
        """Execute one request. Requests are (method, pickled (args, kwargs));
        sync user code runs in the worker's executor thread so the replica
        keeps answering pings while busy. ``model_id`` (multiplexing) binds
        serve.get_multiplexed_model_id() for the duration of the call.
        ``frid`` is the router's flight-recorder request id — only ever
        passed when RAY_TPU_FLIGHTREC is on (the wire call is otherwise
        byte-identical to the pre-recorder tree)."""
        from ray_tpu_torch.serve.multiplex import _set_model_id

        self._ensure_reporter()
        self._check_queue_cap()
        args, kwargs = serialization.loads(payload)[0]
        fn = self._resolve(method)
        _set_model_id(model_id)
        fr = frid is not None and _flightrec.on()
        frid_token = _active_frid.set(frid) if fr else None
        instrument = _metrics.metrics_enabled()
        t0 = _time.perf_counter() if instrument else 0.0
        self._inflight += 1
        if instrument:
            _QUEUE_LEN.set(float(self._inflight), self._tags())
        async def run():
            if inspect.iscoroutinefunction(fn):
                result = await fn(*args, **kwargs)
            else:
                loop = asyncio.get_running_loop()
                ctx = contextvars.copy_context()
                result = await loop.run_in_executor(
                    None, lambda: ctx.run(fn, *args, **kwargs)
                )
            if inspect.isasyncgen(result):
                # Streaming callable invoked non-streaming: drain to a list
                # (buffer-everything is the only non-streaming semantics).
                return [item async for item in result]
            if inspect.isgenerator(result):
                return list(result)
            return result

        async def run_recorded():
            t_x = _time.monotonic()
            try:
                return await run()
            finally:
                _flightrec.record(
                    "serve", "serve.replica_exec", t=t_x,
                    dur_s=_time.monotonic() - t_x, rid=frid,
                )

        try:
            gate = self._execution_gate()
            if gate is None:
                return await (run_recorded() if fr else run())
            if fr:
                t_q = _time.monotonic()
                async with gate:  # in-cap surplus WAITS here (the queue)
                    _flightrec.record(
                        "serve", "serve.replica_queue_wait", t=t_q,
                        dur_s=_time.monotonic() - t_q, rid=frid,
                    )
                    return await run_recorded()
            async with gate:  # in-cap surplus WAITS here (the queue)
                return await run()
        finally:
            if frid_token is not None:
                _active_frid.reset(frid_token)
            self._inflight -= 1
            if instrument:
                tags = self._tags()
                _EXEC_SECONDS.observe(_time.perf_counter() - t0, tags)
                _QUEUE_LEN.set(float(self._inflight), tags)

    async def handle_streaming(
        self, method: str, payload: bytes, model_id: str = "", frid=None
    ):
        """Streaming twin of ``handle``: an async generator the router
        invokes with num_returns="streaming", so each yielded chunk flows
        to the caller as its own stream item (reference:
        serve/_private/proxy.py:710 streaming responses). Works for async/
        sync generator methods, methods RETURNING a generator, and plain
        methods (single-chunk stream)."""
        from ray_tpu_torch.serve.multiplex import _set_model_id

        self._ensure_reporter()
        # Streams share the bounded-queue fail-fast but NOT the execution
        # semaphore: a continuous-batching replica multiplexes its streams
        # (consumer pacing included), so gating a stream's whole lifetime
        # at handle() width would serialize them for no protection the
        # in-flight cap doesn't already give.
        self._check_queue_cap()
        args, kwargs = serialization.loads(payload)[0]
        fn = self._resolve(method)
        _set_model_id(model_id)
        fr = frid is not None and _flightrec.on()
        frid_token = _active_frid.set(frid) if fr else None
        t_x = _time.monotonic() if fr else 0.0
        instrument = _metrics.metrics_enabled()
        t0 = _time.perf_counter() if instrument else 0.0
        self._inflight += 1
        if instrument:
            _QUEUE_LEN.set(float(self._inflight), self._tags())
        try:
            if inspect.isasyncgenfunction(fn):
                async for item in fn(*args, **kwargs):
                    yield item
                return
            if inspect.isgeneratorfunction(fn):
                for item in fn(*args, **kwargs):
                    yield item
                return
            if inspect.iscoroutinefunction(fn):
                result = await fn(*args, **kwargs)
            else:
                loop = asyncio.get_running_loop()
                ctx = contextvars.copy_context()
                result = await loop.run_in_executor(
                    None, lambda: ctx.run(fn, *args, **kwargs)
                )
            if inspect.isasyncgen(result):
                async for item in result:
                    yield item
            elif inspect.isgenerator(result):
                for item in result:
                    yield item
            else:
                yield result
        finally:
            if fr:
                # First-byte to last-byte, consumer pacing included —
                # the same occupancy view _EXEC_SECONDS records.
                _flightrec.record(
                    "serve", "serve.replica_exec", t=t_x,
                    dur_s=_time.monotonic() - t_x, rid=frid,
                )
            if frid_token is not None:
                _active_frid.reset(frid_token)
            self._inflight -= 1
            if instrument:
                tags = self._tags()
                # For a stream this is first-byte to last-byte, consumer
                # pacing included — the replica-occupancy view.
                _EXEC_SECONDS.observe(_time.perf_counter() - t0, tags)
                _QUEUE_LEN.set(float(self._inflight), tags)
