"""Public API: init/remote/get/put/wait/kill/cancel + actor machinery.

Reference parity: python/ray/_private/worker.py (init:1407, get:2837,
put:3020, wait:3091, kill:3271), python/ray/remote_function.py:314,
python/ray/actor.py:1192. Port of ``ray_tpu/core/api.py``: a node
advertises its visible CUDA cards as the ``GPU`` resource
(:func:`ray_tpu_torch.accelerators.gpu.detect_resources`) and
``num_gpus=`` demands it, as the reference's ``num_tpus=`` demands ``TPU``.
Like the reference, the runtime pins no card per worker (it sets no
``CUDA_VISIBLE_DEVICES``): a worker that holds a ``GPU`` unit uses the
cards its process sees.

Not ported yet, each raising :class:`NotPortedError` that names it when
asked for: client mode (``init(mode="client")``), ``runtime_env``, and
compiled DAGs (``ActorMethod.bind``).
"""

from __future__ import annotations

import asyncio
import atexit
import logging
import functools
import os
import threading
import uuid
from typing import Any, Optional, Sequence

import cloudpickle

from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.core.core_worker import CoreWorker
from ray_tpu_torch.core.errors import NotPortedError, RayTpuError
from ray_tpu_torch.core.gcs import GcsServer
from ray_tpu_torch.core.node import NodeManager
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.streaming import ObjectRefGenerator

__all__ = [
    "init",
    "shutdown",
    "is_initialized",
    "remote",
    "get",
    "put",
    "wait",
    "kill",
    "cancel",
    "get_actor",
    "method",
    "nodes",
    "drain_node",
    "cluster_resources",
    "available_resources",
    "get_runtime_context",
    "ObjectRef",
    "ObjectRefGenerator",
    "ActorHandle",
]

_lock = threading.RLock()
_runtime: Optional["Runtime"] = None
_worker: Optional[CoreWorker] = None


class Runtime:
    """A local cluster: GCS + head node (+ extra nodes via Cluster fixture)."""

    def __init__(
        self,
        resources: dict,
        labels: dict | None = None,
        session_id: str | None = None,
    ):
        self.session_id = session_id or uuid.uuid4().hex[:12]
        self.gcs = GcsServer(self.session_id)
        self.gcs_addr = self.gcs.start()
        self.head = NodeManager(
            self.gcs_addr,
            resources,
            labels=labels,
            session_id=self.session_id,
            name="head",
        )
        self.head_addr = self.head.start()
        self.nodes: list[NodeManager] = [self.head]

    def add_node(
        self,
        resources: dict,
        labels: dict | None = None,
        name: str | None = None,
        env: dict | None = None,
    ) -> NodeManager:
        node = NodeManager(
            self.gcs_addr,
            resources,
            labels=labels,
            session_id=self.session_id,
            name=name or f"node{len(self.nodes)}",
            env=env,
        )
        node.start()
        self.nodes.append(node)
        return node

    def stop(self) -> None:
        for node in self.nodes:
            try:
                node.stop()
            except Exception:  # raylint: disable=RL006 -- shutdown teardown; node already stopping or gone
                pass
        self.gcs.stop()


def _default_resources(num_cpus: float | None) -> dict:
    resources = {"CPU": float(num_cpus if num_cpus is not None else (os.cpu_count() or 1))}
    try:
        # Schedulable memory (reference: nodes advertise memory so
        # ray_remote_args memory= demands have something to fit against).
        page = os.sysconf("SC_PAGE_SIZE")
        phys = os.sysconf("SC_PHYS_PAGES")
        if page > 0 and phys > 0:
            resources["memory"] = float(page * phys)
    except (ValueError, OSError, AttributeError):
        pass
    from ray_tpu_torch.accelerators import gpu as gpu_accel

    resources.update(gpu_accel.detect_resources())
    return resources


class _AttachedRuntime:
    """Driver's view of a cluster it joined via ``init(address=...)``:
    shutdown() disconnects this driver but never tears the cluster down
    (its daemons own it)."""

    def __init__(self, gcs_addr: tuple, head_addr: tuple):
        self.gcs_addr = tuple(gcs_addr)
        self.head_addr = tuple(head_addr)
        self.nodes: list = []

    def stop(self) -> None:
        pass


def _parse_address(address: str) -> tuple:
    host, _, port = address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(
            f"address must look like 'host:port', got {address!r}"
        )
    return (host, int(port))


def _find_local_node(gcs_addr: tuple) -> tuple:
    """The address of an alive node daemon on THIS machine (the driver
    attaches to it for leases and shared-memory object access)."""
    import socket

    from ray_tpu_torch.core.protocol import Endpoint

    probe = Endpoint("driver-probe")
    probe.start()
    try:
        view = probe.call(gcs_addr, "gcs.get_cluster_view", {}, timeout=30)
    finally:
        probe.stop()
    me = socket.gethostname()
    for info in view.values():
        if info.get("alive") and info.get("hostname") == me:
            return tuple(info["addr"])
    raise RayTpuError(
        f"no alive node on this host ({me}) in the cluster at "
        f"{gcs_addr[0]}:{gcs_addr[1]} — start a node on this host that "
        f"joins it first"
    )


def init(
    *,
    address: str | None = None,
    num_cpus: float | None = None,
    resources: dict | None = None,
    labels: dict | None = None,
    ignore_reinit_error: bool = True,
    mode: str | None = None,
    token: str | None = None,
    _system_config: dict | None = None,
) -> "Runtime":
    """Start a local cluster (GCS + head node) and connect this process as
    the driver — or, with ``address="host:port"``, join an existing cluster
    whose GCS listens there (reference: worker.py:1407 init(address=...)).

    ``mode="client"`` (a remote driver, reference: python/ray/util/client)
    is not ported yet and raises :class:`NotPortedError`."""
    global _runtime, _worker
    with _lock:
        if _runtime is not None:
            if ignore_reinit_error:
                return _runtime
            raise RayTpuError("ray_tpu_torch already initialized")
        if mode is not None and mode != "client":
            raise ValueError(f'mode must be "client" or None, got {mode!r}')
        if mode == "client":
            raise NotPortedError('client mode (init(mode="client"))')
        if address is None:
            # Submitted jobs' drivers join the submitting cluster
            # (reference: RAY_ADDRESS env honored by ray.init).
            address = os.environ.get("RAY_TPU_ADDRESS") or None
        if address is not None:
            if (
                num_cpus is not None
                or resources is not None
                or labels is not None
            ):
                raise ValueError(
                    "num_cpus/resources/labels cannot be combined with "
                    "address=: a joining driver contributes no resources — "
                    "set them on the node daemon (`raytpu start`) instead"
                )
            gcs_addr = _parse_address(address)
            # Remote workers dial THIS driver back (owner protocol), so the
            # driver endpoint must not bind loopback when the cluster spans
            # hosts: default the bind host to the interface that reaches
            # the GCS (overridable via RAY_TPU_BIND_HOST).
            if "RAY_TPU_BIND_HOST" not in os.environ and gcs_addr[0] not in (
                "127.0.0.1",
                "localhost",
                "::1",
            ):
                import socket as _socket

                probe_sock = _socket.socket(
                    _socket.AF_INET, _socket.SOCK_DGRAM
                )
                try:
                    probe_sock.connect((gcs_addr[0], gcs_addr[1]))
                    os.environ["RAY_TPU_BIND_HOST"] = (
                        probe_sock.getsockname()[0]
                    )
                finally:
                    probe_sock.close()
            node_addr = _find_local_node(gcs_addr)
            runtime: Any = _AttachedRuntime(gcs_addr, node_addr)
        else:
            total = _default_resources(num_cpus)
            total.update(resources or {})
            runtime = Runtime(total, labels=dict(labels or {}))
        worker = CoreWorker(
            runtime.gcs_addr, runtime.head_addr, kind="driver"
        )
        worker.start()
        if GLOBAL_CONFIG.log_to_driver:
            try:
                worker.enable_log_subscription()
            except Exception as e:
                logging.getLogger("ray_tpu_torch").warning(
                    "log-to-driver subscription failed (worker logs stay "
                    "on their nodes): %s",
                    e,
                )
        _runtime = runtime
        _worker = worker
        atexit.register(shutdown)
        return runtime


def _attach_existing_worker(worker: CoreWorker) -> None:
    """Install a CoreWorker created elsewhere (worker processes)."""
    global _worker
    with _lock:
        _worker = worker


def attach_cluster(runtime: "Runtime") -> CoreWorker:
    """Connect the current process as driver to a Runtime built manually
    (test Cluster fixture)."""
    global _runtime, _worker
    with _lock:
        if _worker is not None:
            raise RayTpuError("already connected")
        worker = CoreWorker(runtime.gcs_addr, runtime.head_addr, kind="driver")
        worker.start()
        _runtime = runtime
        _worker = worker
        return worker


def shutdown() -> None:
    global _runtime, _worker
    with _lock:
        if _worker is not None:
            _worker.stop()
            _worker = None
        if _runtime is not None:
            _runtime.stop()
            _runtime = None
        try:
            atexit.unregister(shutdown)
        except Exception:  # raylint: disable=RL006 -- atexit.unregister after interpreter-shutdown races is best-effort
            pass


def is_initialized() -> bool:
    return _worker is not None


def transport_stats() -> dict:
    """Cumulative RPC transport counters of this driver process (frames
    sent, socket writes, frames-per-write, drains skipped...) — the
    strace-free view of the frame-coalescing tier (PERF.md round-6)."""
    return _require_worker(auto_init=False).endpoint.transport_stats()


_was_initialized = False


def _require_worker(auto_init: bool = True) -> CoreWorker:
    global _was_initialized
    if _worker is None:
        if os.environ.get("RAY_TPU_WORKER_ID"):
            # Managed worker process: auto-init would silently nest a whole
            # private cluster inside this worker. The attach must win.
            raise RayTpuError(
                "no attached CoreWorker in this managed worker process "
                "(task ran before worker bootstrap completed?)"
            )
        if not auto_init or _was_initialized:
            # After an explicit shutdown, refs/handles from the old cluster
            # are dead — auto-reinit would dangle them on a fresh cluster.
            raise RayTpuError(
                "ray_tpu_torch is not initialized"
                + (" (it was shut down)" if _was_initialized else "")
                + "; call ray_tpu_torch.init()"
            )
        init()
    _was_initialized = True
    assert _worker is not None
    return _worker


# ---------------------------------------------------------------------------
# Tasks
# ---------------------------------------------------------------------------


class RemoteFunction:
    def __init__(self, fn, opts: dict):
        self._fn = fn
        self._opts = opts
        self._payload: bytes | None = None
        functools.update_wrapper(self, fn)

    def options(self, **opts) -> "RemoteFunction":
        merged = {**self._opts, **opts}
        rf = RemoteFunction(self._fn, merged)
        rf._payload = self._payload
        return rf

    def remote(self, *args, **kwargs):
        worker = _require_worker()
        opts = self._opts
        if self._payload is None:
            self._payload = cloudpickle.dumps(self._fn)
        resources, label_selector, soft_sel, policy, pg = (
            _scheduling_from_opts(opts)
        )
        refs = worker.submit_task(
            self._fn,
            args,
            kwargs,
            name=self._fn.__name__,
            num_returns=opts.get("num_returns", 1),
            resources=resources,
            max_retries=opts.get("max_retries"),
            label_selector=label_selector,
            soft_label_selector=soft_sel,
            policy=policy,
            func_payload=self._payload,
            pg=pg,
            runtime_env=_runtime_env_from_opts(opts, worker),
        )
        num_returns = opts.get("num_returns", 1)
        # 1 -> the ref; "streaming" -> the ObjectRefGenerator; n -> ref list
        return refs[0] if num_returns in (1, "streaming") else refs

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{self._fn.__name__}' cannot be called directly; "
            f"use .remote()."
        )


def _resources_from_opts(opts: dict) -> dict:
    resources = dict(opts.get("resources", {}))
    num_cpus = opts.get("num_cpus")
    resources.setdefault("CPU", float(1 if num_cpus is None else num_cpus))
    if opts.get("num_tpus"):
        resources["TPU"] = float(opts["num_tpus"])
    if opts.get("num_gpus"):
        resources["GPU"] = float(opts["num_gpus"])
    if resources.get("CPU") == 0:
        del resources["CPU"]
    return resources


_renv_cache: dict = {}


def _runtime_env_from_opts(opts: dict, worker: CoreWorker) -> dict:
    """The reference normalizes and uploads a ``runtime_env`` here; the port
    has none yet and refuses one rather than run without it."""
    if opts.get("runtime_env"):
        raise NotPortedError("runtime_env")
    return {}


def _scheduling_from_opts(
    opts: dict,
) -> tuple[dict, dict, dict, str, tuple | None]:
    """(resources, label_selector, soft_label_selector, policy, pg_info)
    after strategy
    translation — placement-group demands are rewritten onto formatted pg
    resources; pg_info rides along so executing tasks know their group."""
    from ray_tpu_torch.util.scheduling_strategies import resolve_strategy

    return resolve_strategy(
        opts, _resources_from_opts(opts), opts.get("label_selector")
    )


# ---------------------------------------------------------------------------
# Actors
# ---------------------------------------------------------------------------


class ActorMethod:
    def bind(self, *args, **kwargs):
        """Static DAGs (reference: python/ray/dag — actor.method.bind) are
        not ported yet."""
        raise NotPortedError("compiled DAGs (ActorMethod.bind)")

    def __init__(self, handle: "ActorHandle", name: str):
        self._handle = handle
        self._name = name

    def remote(self, *args, **kwargs):
        return self._handle._invoke(self._name, args, kwargs)

    def options(self, **opts):
        return _BoundActorMethod(self._handle, self._name, opts)


class _BoundActorMethod:
    def __init__(self, handle, name, opts):
        self._handle = handle
        self._name = name
        self._opts = opts

    def remote(self, *args, **kwargs):
        return self._handle._invoke(
            self._name, args, kwargs,
            num_returns=self._opts.get("num_returns", 1),
        )


class ActorHandle:
    def __init__(
        self,
        actor_id: str,
        class_name: str = "Actor",
        max_task_retries: int = 0,
    ):
        self._actor_id = actor_id
        self._class_name = class_name
        self._max_task_retries = max_task_retries

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name)

    def _invoke(self, method: str, args, kwargs, num_returns=1):
        worker = _require_worker()
        refs = worker.submit_actor_task(
            self._actor_id,
            method,
            args,
            kwargs,
            num_returns=num_returns,
            name=f"{self._class_name}.{method}",
            max_task_retries=self._max_task_retries,
        )
        return refs[0] if num_returns in (1, "streaming") else refs

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id[:12]}…)"

    def __reduce__(self):
        return (
            ActorHandle,
            (self._actor_id, self._class_name, self._max_task_retries),
        )


class ActorClass:
    def __init__(self, cls: type, opts: dict):
        self._cls = cls
        self._opts = opts

    def options(self, **opts) -> "ActorClass":
        return ActorClass(self._cls, {**self._opts, **opts})

    def remote(self, *args, **kwargs) -> ActorHandle:
        worker = _require_worker()
        opts = self._opts
        resources, label_selector, soft_sel, policy, pg = (
            _scheduling_from_opts(opts)
        )
        info = worker.create_actor(
            self._cls,
            args,
            kwargs,
            name=opts.get("name"),
            resources=resources,
            max_restarts=opts.get("max_restarts", 0),
            # 0 = auto: sync methods serialize; async methods cap at 1000
            # (the reference's async-actor default).
            max_concurrency=opts.get("max_concurrency", 0),
            concurrency_groups=opts.get("concurrency_groups"),
            label_selector=label_selector,
            soft_label_selector=soft_sel,
            policy=policy,
            pg=pg,
            runtime_env=_runtime_env_from_opts(opts, worker),
        )
        return ActorHandle(
            info["actor_id"],
            self._cls.__name__,
            max_task_retries=opts.get("max_task_retries", 0),
        )

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class '{self._cls.__name__}' cannot be instantiated "
            f"directly; use .remote()."
        )


def remote(*args, **opts):
    """@remote decorator for functions (tasks) and classes (actors)."""

    def wrap(target):
        if isinstance(target, type):
            return ActorClass(target, opts)
        return RemoteFunction(target, opts)

    if len(args) == 1 and callable(args[0]) and not opts:
        return wrap(args[0])
    if args:
        raise TypeError("use @remote or @remote(**options)")
    return wrap


def method(**opts):
    """Decorator for actor methods to set per-method defaults (num_returns)."""

    def wrap(fn):
        fn._ray_tpu_method_opts = opts
        return fn

    return wrap


# ---------------------------------------------------------------------------
# Object API
# ---------------------------------------------------------------------------


def get(refs, timeout: float | None = None):
    worker = _require_worker()
    single = isinstance(refs, ObjectRef)
    lst = [refs] if single else list(refs)
    for r in lst:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"get() expects ObjectRef(s), got {type(r)}")
    values = worker.get(lst, timeout=timeout)
    return values[0] if single else values


async def get_async(refs, timeout: float | None = None):
    """Await object values from an async actor method (which runs on the
    worker's endpoint loop, where the blocking get() would deadlock)."""
    worker = _require_worker()
    single = isinstance(refs, ObjectRef)
    lst = [refs] if single else list(refs)
    for r in lst:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"get_async() expects ObjectRef(s), got {type(r)}")
    values = await worker._get_async(lst, timeout)
    return values[0] if single else values


def put(value) -> ObjectRef:
    return _require_worker().put(value)


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: float | None = None,
):
    return _require_worker().wait(
        list(refs), num_returns=num_returns, timeout=timeout
    )


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    worker = _require_worker()
    payload = {"actor_id": actor._actor_id, "allow_restart": not no_restart}
    if worker.on_endpoint_loop():
        # From an async actor method (endpoint loop): blocking would
        # deadlock the loop; kill is fire-and-forget there.
        from ray_tpu_torch.util.tasks import spawn

        spawn(worker.gcs.acall("kill_actor", payload), name="kill_actor")
    else:
        worker.gcs.call("kill_actor", payload)


def cancel(ref, *, force: bool = False) -> None:
    """Cancel the task producing ``ref`` (reference: worker.py:3302).

    Queued tasks are removed from the submission queue; running tasks get a
    best-effort interrupt (TaskCancelledError raised in the executing
    thread). ``force=True`` kills the executing worker process instead.
    ``get()`` on the ref then raises TaskCancelledError. Cancelling an
    already-finished task is a no-op; actor tasks are not cancellable (kill
    the actor instead). An ``ObjectRefGenerator`` may be passed to cancel
    its streaming task mid-stream."""
    if isinstance(ref, ObjectRefGenerator):
        ref = ref.completed()
    elif not isinstance(ref, ObjectRef):
        raise TypeError(
            "cancel() expects an ObjectRef or a streaming generator, "
            f"got {type(ref).__name__}"
        )
    _require_worker().cancel(ref, force=force)


def get_actor(name: str) -> ActorHandle:
    worker = _require_worker()
    info = worker.gcs.call("get_actor", {"name": name})
    if info is None:
        raise ValueError(f"no actor named {name!r}")
    return ActorHandle(info["actor_id"], "Actor")


async def get_actor_async(name: str) -> ActorHandle:
    """get_actor usable from async actor methods (endpoint loop)."""
    worker = _require_worker()
    info = await worker.gcs.acall("get_actor", {"name": name})
    if info is None:
        raise ValueError(f"no actor named {name!r}")
    return ActorHandle(info["actor_id"], "Actor")


# ---------------------------------------------------------------------------
# Introspection
# ---------------------------------------------------------------------------


def nodes() -> list[dict]:
    worker = _require_worker()
    view = worker.gcs.call("get_cluster_view")
    return [
        {"NodeID": nid, "Alive": v["alive"], "Resources": v["total"],
         "Available": v["available"], "Labels": v["labels"],
         "Address": tuple(v["addr"]),
         "Draining": v.get("draining", False),
         "StoreStats": v.get("store"),
         "DeathReason": v.get("death_reason")}
        for nid, v in view.items()
    ]


def drain_node(
    node_id: str,
    grace_s: float | None = None,
    *,
    force: bool = False,
    reason: str = "drained",
) -> dict:
    """Gracefully drain a node (reference: gcs_service.proto DrainNode).

    The node stops taking new leases, migrates its sole-copy objects to
    healthy peers, has its restartable actors restarted elsewhere, and
    lets running tasks finish — all inside ``grace_s`` (default: the
    ``drain_grace_s`` config knob). On expiry the GCS falls back to the
    immediate mark-dead path. ``force=True`` (or zero grace) skips the
    grace window entirely: the node is killed on the spot and its objects
    come back via lineage reconstruction, exactly the pre-drain behavior.

    Returns the GCS verdict, e.g. ``{"accepted": True, "state":
    "DRAINING"}``; draining an unknown or already-dead node returns
    ``{"accepted": False, "state": "DEAD"}``."""
    worker = _require_worker()
    payload: dict = {"node_id": node_id, "reason": reason, "force": force}
    if grace_s is not None:
        payload["grace_s"] = float(grace_s)
    return worker.gcs.call("drain_node", payload)


def cluster_resources() -> dict:
    out: dict = {}
    for n in nodes():
        if n["Alive"]:
            for k, v in n["Resources"].items():
                out[k] = out.get(k, 0.0) + v
    return out


def available_resources() -> dict:
    out: dict = {}
    for n in nodes():
        if n["Alive"]:
            for k, v in n["Available"].items():
                out[k] = out.get(k, 0.0) + v
    return out


class RuntimeContext:
    def __init__(self, worker: CoreWorker):
        self._worker = worker

    @property
    def node_id(self) -> str:
        return self._worker.node_id

    @property
    def worker_id(self) -> str:
        return self._worker.worker_id

    @property
    def actor_id(self) -> str | None:
        return self._worker._actor_id

    def get(self) -> dict:
        return {
            "node_id": self.node_id,
            "worker_id": self.worker_id,
            "actor_id": self.actor_id,
            "session_id": self._worker.session_id,
        }


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext(_require_worker())
