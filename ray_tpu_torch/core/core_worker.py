"""CoreWorker — the library embedded in every driver and worker process.

Reference parity: src/ray/core_worker/core_worker.h:167 (SubmitTask, Put, Get,
Wait, CreateActor, SubmitActorTask), the lease-based NormalTaskSubmitter
(task_submission/normal_task_submitter.h:86), the TaskReceiver execution side,
and the ownership protocol (reference_counter.h:44) in simplified form: the
submitting process owns task outputs; owners serve value/location lookups and
track borrows; producing task specs are retained for retry.

One asyncio endpoint carries all roles: owner RPCs ("owner.*"), task execution
("worker.*"), and the sync user API bridges onto the loop. Execution happens
on a dedicated executor thread pool so user code (a CUDA kernel's host-side
wait included) never blocks the control plane.

Port of ``ray_tpu/core/core_worker.py``, with the device-object handlers
(``worker.rdt_fetch``, ``rdt_free``, ``rdt_done``, ``rdt_unarm`` and
``rdt_arm``) that serve :mod:`ray_tpu_torch.experimental.device_objects`.
Not ported yet: compiled-DAG loops and channels, and the live profiling
handlers (``worker.profile``, ``worker.dump_stacks``, ``worker.jax_trace``).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import inspect
import os
import random
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Optional

import cloudpickle

from ray_tpu_torch.core import object_ref as object_ref_mod
from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.core.errors import (
    ActorDiedError,
    DeadlineExceededError,
    GetTimeoutError,
    ObjectLostError,
    PeerUnavailableError,
    RayTpuError,
    TaskCancelledError,
    TaskError,
    WorkerCrashedError,
)
from ray_tpu_torch.core.gcs import GcsClient
from ray_tpu_torch.core.ids import ActorID, ObjectID, TaskID, WorkerID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.object_store import (
    FAILED,
    PENDING,
    READY,
    OwnerStore,
    ShmReader,
    ShmWriter,
)
from ray_tpu_torch.util.tasks import spawn
from ray_tpu_torch.core.protocol import (
    ConnectionLost,
    Endpoint,
    method_deadline_s,
)


@dataclass
class TaskSpec:
    task_id: str
    name: str
    func_payload: bytes  # cloudpickled callable (or None for actor methods)
    args: list  # list of ("v", bytes) | ("r", ObjectRef)
    kwargs: dict  # name -> same encoding
    return_ids: list
    resources: dict
    retries_left: int = 0
    label_selector: dict = field(default_factory=dict)
    soft_label_selector: dict = field(default_factory=dict)
    policy: str = "hybrid"
    pg: tuple | None = None  # (pg_id, capture_child_tasks)
    runtime_env: dict = field(default_factory=dict)  # normalized (prepare())
    trace_ctx: tuple | None = None  # (trace_id, span_id) when tracing
    cancelled: bool = False  # set by cancel(); suppresses push and retries
    completed: bool = False  # finished at least once (spec kept for lineage)
    lineage_attempts: int = 0  # reconstruction resubmissions so far
    streaming: bool = False  # num_returns="streaming": yields stream items
    # Every object id the args/kwargs reference, INCLUDING refs nested in
    # containers (collected at encode time; the batch builder cuts batches
    # at producer->consumer edges using this).
    arg_ref_ids: frozenset = frozenset()
    # actor fields
    actor_id: str | None = None
    method: str | None = None


@dataclass
class _SchedKey:
    resources: tuple
    selector: tuple
    policy: str

    def __hash__(self):
        return hash((self.resources, self.selector, self.policy))


class _QueueState:
    def __init__(self):
        self.queue: list[TaskSpec] = []
        self.leases: dict[str, dict] = {}  # lease_id -> grant info
        self.inflight = 0  # lease requests in flight


class CoreWorker:
    def __init__(
        self,
        gcs_addr: tuple,
        node_addr: tuple,
        kind: str = "worker",
        worker_id: str | None = None,
        max_pending_leases: int = 16,
    ):
        self.kind = kind
        self.worker_id = worker_id or WorkerID.random().hex()
        self.endpoint = Endpoint(f"{kind}-{self.worker_id[:6]}")
        self.gcs_addr = tuple(gcs_addr)
        self.node_addr = tuple(node_addr)
        self.gcs = GcsClient(self.endpoint, gcs_addr)
        self.max_pending_leases = max_pending_leases

        self.owner_store: OwnerStore | None = None  # created on loop start
        self.node_id: str | None = None
        self.shm_root: str | None = None
        self.shm_writer: ShmWriter | None = None
        self.shm_reader: ShmReader | None = None
        self.session_id: str | None = None

        self._queues: dict[Any, _QueueState] = {}
        self._task_specs: dict[str, TaskSpec] = {}  # task_id -> spec (lineage)
        # node addr -> lease ids awaiting a batched return (one flush per
        # loop tick per node; see _return_lease)
        self._lease_returns: dict[tuple, list] = {}
        # submissions from non-loop threads awaiting the drain callback;
        # the pending flag dedups the self-pipe wakeup (see _run_on_loop)
        self._submit_lock = threading.Lock()
        self._submit_buf: list = []
        self._submit_wake_pending = False
        # owner side: task_id -> worker addr while a push RPC is in flight
        self._inflight_push: dict[str, tuple] = {}
        # owner side: task_id -> future, in-flight lineage resubmissions
        self._reconstructing: dict[str, asyncio.Future] = {}
        # Lineage resubmissions actually performed (the number a graceful
        # drain is supposed to keep at zero — migrated copies resolve
        # instead; see _migrated_location).
        self.reconstructions = 0
        # oid -> node_id of the last location dropped as unreachable:
        # lets ObjectLostError name WHY the holding node went away
        # ("preempted" vs "heartbeat_timeout"). Bounded (see note).
        self._lost_locations: dict[str, str] = {}
        # executor side (all guarded by _cancel_lock):
        self._cancel_lock = threading.Lock()
        self._running_tasks: dict[str, int] = {}  # task_id -> thread ident
        self._cancelled_tasks: set[str] = set()  # cancel arrived (any time)
        self._interrupt_sent: str | None = None  # async exc in flight for id
        # task_id -> Event set when the interrupted task's run() actually
        # exits: lets cancel_task ACK delivery instead of replying blind
        self._interrupt_done: dict[str, threading.Event] = {}
        # executor side: task_id -> asyncio.Task for coroutine task fns
        self._running_async: dict[str, asyncio.Future] = {}
        # One normal task executes at a time in this worker, even with
        # pipelined pushes keeping more queued here: sync fns serialize on
        # the 1-thread executor anyway; this lock extends the guarantee to
        # coroutine fns and async generators (the lease is 1 slot).
        self._normal_task_serial = asyncio.Lock()

        # executor side
        self._executor: concurrent.futures.ThreadPoolExecutor | None = None
        self._actor_instance: Any = None
        self._actor_id: str | None = None
        self._actor_pg: tuple | None = None
        self._actor_ready = asyncio.Event()
        self._actor_init_error: Exception | None = None
        self._actor_lock: threading.Lock = threading.Lock()
        self._actor_semaphore: asyncio.Semaphore | None = None
        self._concurrency_groups: dict[str, dict] = {}  # name -> exec/sem
        self._actor_seq: dict[str, int] = {}  # caller -> next expected seq
        self._actor_buffer: dict[tuple, Any] = {}  # (caller, seq) -> pending

        # owner side: streaming tasks (task_id -> StreamState)
        self._streams: dict[str, Any] = {}

        # actor-client side: per-actor ordered submitters
        self._actor_submitters: dict[str, _ActorSubmitter] = {}

        self._stopped = False
        self._view_cache: dict | None = None
        self._view_time = 0.0
        # Device-object arm/free race markers (see _h_worker_rdt_arm);
        # counted so concurrent arms of one oid all observe a mid-arm free.
        self._rdt_arming: dict[str, int] = {}
        self._rdt_freed_while_arming: set[str] = set()

        # Observability: buffered task lifecycle events, flushed to the GCS
        # on an interval (reference: task_event_buffer.h -> GcsTaskManager).
        self._task_events_buf: list[dict] = []
        self._task_flush_task = None
        self._metrics_push_task = None

        for n in [n for n in dir(self) if n.startswith("_h_")]:
            topic, _, meth = n[3:].partition("_")
            self.endpoint.register(f"{topic}.{meth}", getattr(self, n))

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> tuple:
        addr = self.endpoint.start()
        self.owner_store = OwnerStore(self.endpoint.loop)
        reply = self.endpoint.call(
            self.node_addr,
            "node.register_worker",
            {"worker_id": self.worker_id, "addr": addr, "kind": self.kind},
        )
        self.node_id = reply["node_id"]
        self.shm_root = reply["shm_root"]
        self.session_id = reply["session_id"]
        self.shm_writer = ShmWriter(self.shm_root)
        self.shm_reader = ShmReader(self.shm_root)
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="task-exec"
        )
        object_ref_mod.install_hooks(
            self._on_ref_deserialized, self._on_ref_deleted
        )
        self._task_flush_task = self.endpoint.submit(
            self._task_event_flush_loop()
        )
        self._metrics_push_task = self.endpoint.submit(
            self._metrics_push_loop()
        )
        from ray_tpu_torch import _native

        _native.warm_build()  # compile the copy helper off the hot path
        return addr

    def stop(self) -> None:
        self._stopped = True
        # Close buffered submissions the drain callback will never run
        # (their refs are dead with this worker anyway; closing avoids
        # "coroutine never awaited" noise at interpreter exit).
        with self._submit_lock:
            stranded, self._submit_buf = self._submit_buf, []
        for coro in stranded:
            coro.close()
        object_ref_mod.clear_hooks()
        if self._task_flush_task is not None:
            self._task_flush_task.cancel()
        if self._metrics_push_task is not None:
            self._metrics_push_task.cancel()
        if self.kind == "driver":
            # Leave the node's registry (long-lived `raytpu start` daemons
            # would otherwise keep one dead driver entry per session).
            try:
                self.endpoint.call(
                    self.node_addr,
                    "node.unregister_worker",
                    {"worker_id": self.worker_id},
                    timeout=5,
                )
            except Exception:  # raylint: disable=RL006 -- shutdown unregister; node already gone means nothing to unregister
                pass
        if self._executor is not None:
            self._executor.shutdown(wait=False, cancel_futures=True)
        for grp in self._concurrency_groups.values():
            grp["executor"].shutdown(wait=False, cancel_futures=True)
        self.endpoint.stop()

    # -- task events ---------------------------------------------------------

    def _task_event(self, task_id: str, state: str, **fields) -> None:
        """Record one lifecycle transition; flushed to the GCS in batches."""
        if not GLOBAL_CONFIG.task_events_enabled:
            return
        ev = {
            "task_id": task_id,
            "state": state,
            "states": {state: time.time()},
            **fields,
        }
        buf = self._task_events_buf
        buf.append(ev)
        cap = 4 * GLOBAL_CONFIG.task_events_max
        if len(buf) > cap:  # GCS unreachable for a long time: shed oldest
            del buf[: cap // 2]

    async def _task_event_flush_loop(self) -> None:
        # Bounded flushes: serializing one giant batch on the endpoint loop
        # would stall every in-flight RPC this process serves (measured 5x
        # on sync actor-call throughput during task storms). Excess events
        # shed oldest-first via the _task_event cap — observability is
        # deliberately lossy under saturation (reference: bounded
        # TaskEventBuffer with dropped-event counters).
        max_batch = 2000
        while not self._stopped:
            await asyncio.sleep(GLOBAL_CONFIG.task_event_flush_interval_s)
            if not self._task_events_buf:
                continue
            batch = self._task_events_buf[:max_batch]
            del self._task_events_buf[:max_batch]
            try:
                await self.gcs.acall(
                    "report_task_events", {"events": batch}
                )
            except Exception:  # raylint: disable=RL006 -- failure requeues the batch for the next flush tick (assignment below)
                self._task_events_buf = batch + self._task_events_buf

    async def _metrics_push_loop(self) -> None:
        """Ship this process's user-metric registry to the node manager,
        which aggregates per node and reports to the GCS (reference:
        metrics_agent.py OpenCensusProxyCollector)."""
        from ray_tpu_torch.util.metrics import registry

        while not self._stopped:
            await asyncio.sleep(GLOBAL_CONFIG.metrics_report_interval_s)
            snap = registry().snapshot()
            tags = {"worker_id": self.worker_id[:12]}
            # This process's endpoint telemetry (transport coalescing +
            # per-method service stats like push_task handler latency):
            # the worker-side half of the task hot path. A process that
            # never sent a frame has nothing worth shipping.
            if self.endpoint.transport_stats()["frames_sent"]:
                emeta, epoints = self.endpoint.service_metric_snapshot(tags)
                snap["meta"].update(emeta)
                snap["points"].extend(epoints)
            if not snap["points"]:
                continue
            try:
                await self.endpoint.anotify(
                    self.node_addr,
                    "node.report_metrics",
                    {"worker_id": self.worker_id, "snapshot": snap},
                )
            except Exception:  # raylint: disable=RL006 -- best-effort telemetry push; next interval retries with a fresh snapshot
                pass

    def enable_log_subscription(self) -> None:
        """Driver-side: stream worker stdout/stderr lines from every node
        to this process's stderr (reference: log_monitor.py -> driver
        printing with the (pid=..., ip=...) prefix)."""
        import sys as _sys

        async def on_pub(conn, p):
            if p.get("channel") != "logs":
                return None
            data = p.get("data") or {}
            node = str(data.get("node_id", ""))[:8]
            for batch in data.get("batches", []):
                src = batch.get("source", "?")
                for line in batch.get("lines", []):
                    print(
                        f"({src}, node={node}) {line}",
                        file=_sys.stderr,
                        flush=True,
                    )
            return None

        self.endpoint.register("pub", on_pub)

        async def subscribe():
            await self.gcs.acall("subscribe", {"channels": ["logs"]})

        self.endpoint.submit(subscribe()).result(timeout=10)

    # -- ref hooks -----------------------------------------------------------

    def _is_owner(self, ref: ObjectRef) -> bool:
        return ref.owner_addr == tuple(self.endpoint.address or ())

    def _on_ref_deserialized(self, ref: ObjectRef) -> None:
        if self._stopped or ref.owner_addr is None:
            return
        try:
            if self._is_owner(ref):
                # A second in-owner handle to an owned object: must count it,
                # since its deletion will decrement local_refs symmetrically.
                oid = ref.hex()

                async def bump():
                    self.owner_store.ensure(oid).local_refs += 1

                self.endpoint.submit(bump())
            else:
                self.endpoint.submit(
                    self.endpoint.anotify(
                        ref.owner_addr, "owner.add_borrow", {"oid": ref.hex()}
                    )
                )
        except Exception:  # raylint: disable=RL006 -- ref-count notify on a closing owner connection; owner GC reconciles
            pass

    def _on_ref_deleted(self, ref: ObjectRef) -> None:
        if self._stopped or ref.owner_addr is None:
            return
        try:
            if self._is_owner(ref):
                self.endpoint.submit(self._release_local_ref(ref.hex()))
            else:
                self.endpoint.submit(
                    self.endpoint.anotify(
                        ref.owner_addr, "owner.remove_borrow", {"oid": ref.hex()}
                    )
                )
        except Exception:  # raylint: disable=RL006 -- ref-count notify on a closing owner connection; owner GC reconciles
            pass

    async def _release_local_ref(self, oid: str) -> None:
        obj = self.owner_store.objects.get(oid)
        if obj is None:
            return
        obj.local_refs -= 1
        await self._maybe_free(oid)

    async def _maybe_free(self, oid: str) -> None:
        obj = self.owner_store.objects.get(oid)
        if obj is None:
            return
        if obj.local_refs <= 0 and obj.borrowers <= 0 and obj.state != PENDING:
            self.owner_store.delete(oid)
            # Lineage GC: drop the producing spec once NONE of its return
            # refs remain live (it can never be needed for reconstruction).
            task_id = obj.producing_task
            spec = self._task_specs.get(task_id) if task_id else None
            if spec is not None and spec.completed and not any(
                rid in self.owner_store.objects for rid in spec.return_ids
            ):
                self._task_specs.pop(task_id, None)
            for node_id in obj.locations:
                addr = await self._node_addr_for(node_id)
                if addr is not None:
                    try:
                        await self.endpoint.anotify(
                            addr, "node.free_object", {"oid": oid}
                        )
                    except Exception:  # raylint: disable=RL006 -- best-effort remote free; node death frees the blob with the node
                        pass

    # -- owner RPCs ----------------------------------------------------------

    async def _h_owner_get_object(self, conn, p):
        oid = p["oid"]
        timeout = p.get("timeout")
        if oid not in self.owner_store.objects:
            # Every owned object is registered before its ref can escape this
            # process, so unknown here means the owner already freed it (all
            # known refs were dropped). Waiting would hang forever.
            return {
                "error": ObjectLostError(
                    f"object {oid} was freed by its owner (all references "
                    f"dropped before this fetch)"
                )
            }
        exclude = set(p.get("exclude_nodes") or [])
        reconstructed = False
        migration_tried = False
        while True:
            obj = await self.owner_store.wait_ready(oid, timeout)
            if obj.state == FAILED:
                return {"error": obj.error}
            if obj.inline is not None:
                return {"inline": obj.inline}
            # The borrower's excludes initially only FILTER our view (a
            # failed pull may be transient). Once the filter exhausts every
            # copy, the exclusion is corroborated: prune those locations
            # for real and reconstruct. The filter is lifted afterwards —
            # the rerun's copy is a fresh blob even if it landed on an
            # excluded node.
            avail = obj.locations if reconstructed else obj.locations - exclude
            # Random copy: concurrent borrowers spread over all replicas
            # instead of stampeding whichever location iterates first.
            node_id = random.choice(tuple(avail)) if avail else None
            if node_id is None:
                for nid in exclude & obj.locations:
                    self._note_lost_location(oid, nid)
                obj.locations -= exclude
                # Pre-death migration first (the drain protocol): a
                # draining node may have pushed the sole copy to a peer
                # before dying — resolving it costs one GCS lookup instead
                # of a full lineage re-execution.
                if not migration_tried:
                    migration_tried = True
                    moved = await self._migrated_location(oid)
                    if moved is not None:
                        obj.locations.add(moved)
                        continue
                try:
                    await self._reconstruct(oid)
                    reconstructed = True
                except Exception as e:  # noqa: BLE001 # raylint: disable=RL006 -- reconstruction failure is propagated to the caller in the reply envelope
                    return {"error": e}
                continue
            info = await self._node_info_for(node_id) or {}
            return {
                "location": {
                    "node_id": node_id,
                    "addr": tuple(info["addr"]) if info.get("addr") else None,
                    "shm_root": info.get("shm_root"),
                    "size": obj.size,
                }
            }

    async def _h_owner_wait_ready(self, conn, p):
        if p["oid"] not in self.owner_store.objects:
            return {"ready": True, "failed": True}  # freed (see get_object)
        try:
            obj = await self.owner_store.wait_ready(p["oid"], p.get("timeout"))
        except asyncio.TimeoutError:
            return {"ready": False}
        return {"ready": obj.state != PENDING, "failed": obj.state == FAILED}

    async def _h_owner_add_borrow(self, conn, p):
        obj = self.owner_store.objects.get(p["oid"])
        if obj is not None:
            obj.borrowers += 1
        return True

    async def _h_owner_remove_borrow(self, conn, p):
        obj = self.owner_store.objects.get(p["oid"])
        if obj is not None:
            obj.borrowers -= 1
            await self._maybe_free(p["oid"])
        return True

    async def _h_owner_add_location(self, conn, p):
        """A borrower's node finished pulling a copy: record it so later
        fetchers spread across copies (BitTorrent-style broadcast scaling —
        the role the reference's push manager plays for hot objects).
        Freed entries must NOT be resurrected."""
        if p["oid"] in self.owner_store.objects:
            self.owner_store.put_location(p["oid"], p["node_id"], p["size"])
        return True

    # -- cluster view helpers ------------------------------------------------

    async def _cluster_view(self) -> dict:
        """GCS cluster view with a short-lived cache (node addresses change
        only on membership events; don't serialize the view per lookup)."""
        now = time.monotonic()
        if self._view_cache is not None and now - self._view_time < 1.0:
            return self._view_cache
        view = await self.gcs.acall("get_cluster_view")
        self._view_cache = view
        self._view_time = now
        return view

    async def _node_info_for(self, node_id: str) -> Optional[dict]:
        info = (await self._cluster_view()).get(node_id)
        if info is None:
            # Could be stale — refresh once before giving up.
            self._view_cache = None
            info = (await self._cluster_view()).get(node_id)
        return info

    async def _node_addr_for(self, node_id: str) -> Optional[tuple]:
        info = await self._node_info_for(node_id)
        return tuple(info["addr"]) if info else None

    # -- put/get/wait --------------------------------------------------------

    def put(self, value: Any) -> ObjectRef:
        # Out-of-band serialization: array buffers frame straight into shm
        # with ONE native memcpy instead of pickle-copy + write-copy.
        payload, _ = serialization.dumps_oob(value)
        oid = ObjectID.random().hex()
        ref = ObjectRef(ObjectID.from_hex(oid), self.endpoint.address)
        fut = self.endpoint.submit(self._store_owned(oid, payload))
        fut.result(timeout=60)
        return ref

    async def _store_owned(self, oid: str, payload) -> None:
        obj = self.owner_store.ensure(oid)
        obj.local_refs += 1
        framed = isinstance(payload, serialization.FramedPayload)
        size = payload.nbytes if framed else len(payload)
        if size <= GLOBAL_CONFIG.max_inline_object_bytes:
            # Framed payloads stay SEGMENTED in the owner store: snapshot()
            # copies the buffers once into private storage (put semantics —
            # a later mutation of the caller's array must not rewrite the
            # object) but never flattens, so serving the object over RPC
            # rides the scatter-gather frame path with zero further copies.
            # Kill switch: the round-7 flatten.
            if not framed:
                self.owner_store.put_inline(oid, payload)
            elif GLOBAL_CONFIG.rpc_scatter_gather_enabled:
                self.owner_store.put_inline(oid, payload.snapshot())
            else:
                self.owner_store.put_inline(oid, payload.to_bytes())
        else:
            if framed:
                self.shm_writer.write_framed(oid, payload)
            else:
                self.shm_writer.write(oid, payload)
            await self.endpoint.acall(
                self.node_addr,
                "node.object_created",
                {"oid": oid, "size": size},
            )
            self.owner_store.put_location(oid, self.node_id, size)

    def get(self, refs: list[ObjectRef], timeout: float | None = None):
        if self.on_endpoint_loop():
            raise RuntimeError(
                "blocking get() called from an async actor method would "
                "deadlock the event loop; use "
                "`await ray_tpu_torch.core.api.get_async(refs)` instead"
            )
        fut = self.endpoint.submit(self._get_async(refs, timeout))
        try:
            return fut.result(
                timeout=None if timeout is None else timeout + 5
            )
        except concurrent.futures.TimeoutError:
            raise GetTimeoutError(f"get timed out after {timeout}s")

    async def _get_async(self, refs: list[ObjectRef], timeout: float | None):
        payloads = await asyncio.gather(
            *(self._fetch_payload(r, timeout) for r in refs)
        )
        out = []
        for data in payloads:
            value, _ = serialization.loads(data)
            out.append(value)
        return out

    async def _fetch_payload(
        self, ref: ObjectRef, timeout: float | None
    ) -> bytes:
        oid = ref.hex()
        if self._is_owner(ref):
            migration_tried = False
            while True:
                try:
                    obj = await self.owner_store.wait_ready(oid, timeout)
                except asyncio.TimeoutError:
                    raise GetTimeoutError(
                        f"object {oid[:12]} not ready in time"
                    )
                if obj.state == FAILED:
                    raise obj.error
                if obj.inline is not None:
                    return obj.inline
                locs = tuple(obj.locations)
                # A local copy wins outright (no node RPC); otherwise a
                # random replica spreads concurrent fetch load.
                if self.node_id in obj.locations:
                    node_id = self.node_id
                else:
                    node_id = random.choice(locs) if locs else None
                if node_id is not None:
                    try:
                        data = await self._fetch_from_location(
                            oid,
                            {
                                "node_id": node_id,
                                "size": obj.size,
                                "addr": None,
                                "shm_root": None,
                            },
                        )
                        if node_id != self.node_id:
                            # The pull left a copy on OUR node: record it so
                            # other fetchers can ride it (broadcast spread).
                            obj.locations.add(self.node_id)
                        return data
                    except (GetTimeoutError, TaskCancelledError):
                        raise
                    except Exception:
                        # Copy unreachable (node died, blob gone). Drop the
                        # location; try another copy or reconstruct.
                        self._note_lost_location(oid, node_id)
                        obj.locations.discard(node_id)
                        continue
                # Pre-death migration first (drain protocol): one GCS
                # lookup beats a lineage re-execution when a draining node
                # pushed its sole copy to a peer before dying.
                if not migration_tried:
                    migration_tried = True
                    moved = await self._migrated_location(oid)
                    if moved is not None:
                        obj.locations.add(moved)
                        continue
                await self._reconstruct(oid)
        # Borrower path: the owner resolves (and if needed reconstructs) the
        # object; we retry with failed nodes excluded.
        exclude: list = []
        while True:
            try:
                reply = await self.endpoint.acall(
                    ref.owner_addr,
                    "owner.get_object",
                    {"oid": oid, "timeout": timeout, "exclude_nodes": exclude},
                )
            except (ConnectionLost, ConnectionError, OSError):
                # The owner process is gone; its objects die with it
                # (reference: OwnerDiedError).
                raise ObjectLostError(
                    f"owner of object {oid[:12]} is unreachable (owner "
                    f"process died?)"
                )
            if "error" in reply:
                err = reply["error"]
                raise err if isinstance(err, Exception) else ObjectLostError(
                    str(err)
                )
            if "inline" in reply:
                return reply["inline"]
            loc = reply["location"]
            try:
                data = await self._fetch_from_location(oid, loc)
            except (GetTimeoutError, TaskCancelledError):
                raise
            except Exception:
                if loc["node_id"] in exclude:
                    raise
                exclude.append(loc["node_id"])
                continue
            if loc["node_id"] != self.node_id:
                # Tell the owner our node now holds a copy: later borrowers
                # spread across replicas instead of stampeding the source.
                try:
                    await self.endpoint.anotify(
                        ref.owner_addr,
                        "owner.add_location",
                        {
                            "oid": oid,
                            "node_id": self.node_id,
                            "size": loc["size"],
                        },
                    )
                except Exception:  # raylint: disable=RL006 -- best-effort borrower registration; owner death surfaces on get()
                    pass
            return data

    def _note_lost_location(self, oid: str, node_id: str) -> None:
        """Remember which node's disappearance lost a copy of ``oid`` so
        the eventual ObjectLostError can say WHY it went away (drained /
        preempted / heartbeat_timeout vs crash). Bounded FIFO: this is
        error-message garnish, not tracking state."""
        self._lost_locations[oid] = node_id
        if len(self._lost_locations) > 1024:
            self._lost_locations.pop(next(iter(self._lost_locations)))

    async def _lost_reason_suffix(self, oid: str) -> str:
        node_id = self._lost_locations.get(oid)
        if not node_id:
            return ""
        try:
            info = await self._node_info_for(node_id)
        except Exception:  # raylint: disable=RL006 -- death-reason lookup is advisory; generic ObjectLostError still raised
            info = None
        reason = (info or {}).get("death_reason")
        if reason:
            return f" (node {node_id[:8]} {reason})"
        return f" (node {node_id[:8]} unreachable)"

    async def _migrated_location(self, oid: str) -> Optional[str]:
        """Resolve a pre-death drain migration: the node_id now holding a
        copy a draining node pushed out before dying, or None. Only an
        ALIVE holder counts — a migrated copy that died too falls through
        to lineage reconstruction like before."""
        try:
            node_id = await self.gcs.acall("migrated_location", {"oid": oid})
        except Exception:  # raylint: disable=RL006 -- migrated-location probe; miss falls through to lineage reconstruction
            return None
        if not node_id:
            return None
        info = await self._node_info_for(node_id)
        if info is None or not info.get("alive"):
            return None
        return node_id

    async def _reconstruct(self, oid: str) -> None:
        """Resubmit the producing task of a lost owned object (lineage
        reconstruction; reference: object_recovery_manager.h:41,
        task_manager.h:229 ResubmitTask). Concurrent losses of sibling
        return values coalesce onto one resubmission."""
        obj = self.owner_store.objects.get(oid)
        task_id = obj.producing_task if obj else None
        spec = self._task_specs.get(task_id) if task_id else None
        if spec is None or spec.actor_id is not None:
            raise ObjectLostError(
                f"object {oid[:12]} was lost"
                f"{await self._lost_reason_suffix(oid)} and has no "
                f"lineage to reconstruct it"
            )
        if spec.cancelled:
            raise TaskCancelledError(f"task {spec.name} was cancelled")
        fut = self._reconstructing.get(task_id)
        if fut is not None:
            await asyncio.shield(fut)
            return
        fut = asyncio.get_running_loop().create_future()
        self._reconstructing[task_id] = fut
        try:
            if spec.lineage_attempts >= GLOBAL_CONFIG.max_lineage_attempts:
                raise ObjectLostError(
                    f"object {oid[:12]} lost"
                    f"{await self._lost_reason_suffix(oid)}; reconstruction "
                    f"gave up after {spec.lineage_attempts} attempts"
                )
            spec.lineage_attempts += 1
            self.reconstructions += 1
            spec.completed = False
            for rid in spec.return_ids:
                # Reset ONLY return values that are tracked and actually
                # lost (READY with no remaining copy). Freed siblings must
                # NOT be resurrected (nothing would ever release them), and
                # siblings with healthy copies keep their entries — the
                # rerun just adds a fresh location.
                o = self.owner_store.objects.get(rid)
                if o is None:
                    continue
                if o.state == READY and o.inline is None and not o.locations:
                    o.state = PENDING
                    o.error = None
            await self._enqueue_task_respec(spec)
            fut.set_result(None)
        except BaseException as e:
            fut.set_exception(e)
            fut.exception()  # consumed; waiters that never arrive are fine
            raise
        finally:
            del self._reconstructing[task_id]

    async def _read_local_shm(self, oid: str) -> bytes:
        try:
            return bytes(self.shm_reader.get(oid))
        except (FileNotFoundError, OSError):
            # Not at the shm path — possibly spilled to disk by the node.
            ok = await self.endpoint.acall(
                self.node_addr, "node.restore_object", {"oid": oid}
            )
            if not ok:
                raise ObjectLostError(
                    f"object {oid[:12]} not in the local store"
                )
            return bytes(self.shm_reader.get(oid))

    async def _fetch_from_location(self, oid: str, loc: dict) -> bytes:
        node_id = loc["node_id"]
        if node_id == self.node_id:
            return await self._read_local_shm(oid)
        # Remote: ask our node to pull it over, then read locally.
        addr = loc.get("addr") or await self._node_addr_for(node_id)
        if addr is None:
            raise ObjectLostError(f"no address for node {node_id[:8]}")
        await self.endpoint.acall(
            self.node_addr,
            "node.pull_object",
            {"oid": oid, "from_addr": tuple(addr), "size": loc["size"]},
        )
        return await self._read_local_shm(oid)

    def wait(
        self,
        refs: list[ObjectRef],
        num_returns: int = 1,
        timeout: float | None = None,
    ):
        if self.on_endpoint_loop():
            raise RuntimeError(
                "blocking wait() called from an async actor method would "
                "deadlock the event loop; await the refs with get_async "
                "or asyncio primitives instead"
            )
        fut = self.endpoint.submit(self._wait_async(refs, num_returns, timeout))
        return fut.result()

    async def _wait_async(self, refs, num_returns, timeout):
        loop = asyncio.get_running_loop()
        tasks = {
            loop.create_task(self._wait_one(r)): r for r in refs
        }
        ready: list = []
        deadline = None if timeout is None else time.monotonic() + timeout
        pending = set(tasks)
        try:
            while pending and len(ready) < num_returns:
                t = None if deadline is None else max(
                    0.0, deadline - time.monotonic()
                )
                done, pending = await asyncio.wait(
                    pending,
                    timeout=t,
                    return_when=asyncio.FIRST_COMPLETED,
                )
                if not done:
                    break
                for d in done:
                    ready.append(tasks[d])
        finally:
            for p in pending:
                p.cancel()
        ready_set = set(ready)
        not_ready = [r for r in refs if r not in ready_set]
        ready_ordered = [r for r in refs if r in ready_set]
        return ready_ordered[:num_returns], not_ready + ready_ordered[
            num_returns:
        ]

    async def _wait_one(self, ref: ObjectRef):
        oid = ref.hex()
        if self._is_owner(ref):
            await self.owner_store.wait_ready(oid, None)
            return ref
        await self.endpoint.acall(
            ref.owner_addr, "owner.wait_ready", {"oid": oid, "timeout": None}
        )
        return ref

    # -- task submission -----------------------------------------------------

    def submit_task(
        self,
        func: Any,
        args: tuple,
        kwargs: dict,
        *,
        name: str,
        num_returns: "int | str" = 1,
        resources: dict | None = None,
        max_retries: int | None = None,
        label_selector: dict | None = None,
        soft_label_selector: dict | None = None,
        policy: str = "hybrid",
        func_payload: bytes | None = None,
        pg: tuple | None = None,
        runtime_env: dict | None = None,
    ) -> list:
        # NB: an explicitly empty dict means "no resource demand" (e.g.
        # num_cpus=0 probes) — only None gets the 1-CPU default.
        resources = dict(resources) if resources is not None else {"CPU": 1.0}
        if max_retries is None:
            max_retries = GLOBAL_CONFIG.default_max_retries
        streaming = num_returns == "streaming"
        task_id = TaskID.random().hex()
        # A streaming task has ONE fixed return: the completion sentinel
        # (stream items get dynamic, deterministic ids as they arrive).
        n_returns = 1 if streaming else num_returns
        return_ids = [ObjectID.random().hex() for _ in range(n_returns)]
        if func_payload is None:
            func_payload = cloudpickle.dumps(func)
        ref_bag: set = set()
        spec = TaskSpec(
            task_id=task_id,
            name=name,
            func_payload=func_payload,
            args=[self._encode_arg(a, ref_bag) for a in args],
            kwargs={
                k: self._encode_arg(v, ref_bag) for k, v in kwargs.items()
            },
            arg_ref_ids=frozenset(ref_bag),
            return_ids=return_ids,
            resources=resources,
            retries_left=max_retries,
            label_selector=dict(label_selector or {}),
            soft_label_selector=dict(soft_label_selector or {}),
            policy=policy,
            pg=pg,
            runtime_env=dict(runtime_env or {}),
            streaming=streaming,
        )
        refs = [
            ObjectRef(ObjectID.from_hex(oid), self.endpoint.address, name)
            for oid in return_ids
        ]
        from ray_tpu_torch.util import tracing

        tfields = tracing.submission_fields()
        if tfields:
            spec.trace_ctx = (tfields["trace_id"], tfields["span_id"])
        self._task_event(
            task_id, "PENDING_SCHEDULING", name=name, kind="task", **tfields
        )
        if streaming:
            refs = [self._make_stream(task_id, refs[0])]
        self._run_on_loop(self._guarded_enqueue(self._enqueue_task, spec))
        return refs

    async def _guarded_enqueue(self, make_coro, spec: TaskSpec) -> None:
        """An enqueue that raises must FAIL the task's refs: the buffered
        submission path has no caller to propagate to, and a silently
        dropped enqueue would leave every return ref pending forever.
        Takes the coroutine FUNCTION, not a coroutine object: a stranded
        wrapper closed at stop() must not leave an eagerly-created inner
        coroutine to die un-awaited (interpreter-exit RuntimeWarning)."""
        try:
            await make_coro(spec)
        except Exception as e:  # noqa: BLE001
            await self._fail_task(spec, e)

    def on_endpoint_loop(self) -> bool:
        """True when the caller is running ON this worker's endpoint loop
        (async actor methods) — where any blocking wait would deadlock."""
        return self.endpoint.on_loop()

    def _run_on_loop(self, coro) -> None:
        """Run an enqueue coroutine on the endpoint loop. From the loop
        itself (async actor methods submitting work), schedule it without
        blocking; scheduling order is FIFO, so submission order (and thus
        actor-task seq order) is preserved.

        From other threads the coroutine is BUFFERED and drained by one
        loop callback: one self-pipe wakeup per submission burst instead of
        a blocking round-trip per task (the round-5 ceiling probe's
        dominant cost was exactly these per-task wakeups). Correct because
        enqueue coroutines are await-free — every later loop submission
        (get/wait/cancel) runs after the drain callback, so it observes the
        owner-store entries already registered."""
        if self.on_endpoint_loop():
            spawn(coro, name="task enqueue")
            return
        if not GLOBAL_CONFIG.rpc_coalesce_enabled:
            self.endpoint.submit(coro).result(timeout=30)
            return
        # Wakeup coalescing: the pending flag (not buffer emptiness) gates
        # the call_soon_threadsafe self-pipe write, and it stays set until
        # the drain callback confirms the buffer empty under the lock — so
        # a submit wave landing WHILE the drain is processing rides the
        # running callback's next sweep instead of paying another ~0.3 ms
        # wakeup. Only the empty->nonempty transition writes the pipe.
        with self._submit_lock:
            self._submit_buf.append(coro)
            wake = not self._submit_wake_pending
            if wake:
                self._submit_wake_pending = True
        if wake:
            self.endpoint.loop.call_soon_threadsafe(self._drain_submissions)

    def _drain_submissions(self) -> None:
        while True:
            with self._submit_lock:
                coros, self._submit_buf = self._submit_buf, []
                if not coros:
                    # Empty confirmed under the lock: clear the flag so the
                    # next submit pays the one wakeup. (Clearing earlier
                    # would lose wakeups; clearing later would leak coros.)
                    self._submit_wake_pending = False
                    return
            for coro in coros:
                spawn(coro, name="task enqueue")

    def _encode_arg(self, value: Any, ref_bag: "set | None" = None):
        if isinstance(value, ObjectRef):
            if ref_bag is not None:
                ref_bag.add(value.hex())
            return ("r", value)
        # Out-of-band arg encoding: a large numpy arg becomes a
        # FramedPayload whose buffers ride the push frame as scatter-gather
        # segments — pickle never copies the array into the payload and
        # the transport never joins it into an intermediate bytes.
        # CONTRACT (the zero-copy tradeoff, documented in README
        # "Transport"): the frame views the caller's buffer, so mutating
        # an array argument after .remote() returns races the flush and
        # the bytes a retry resends. Callers needing copy-at-call-time
        # semantics copy the array themselves or disable the tier
        # (rpc_scatter_gather_enabled=0, which restores the round-7
        # flat-bytes encode).
        if GLOBAL_CONFIG.rpc_scatter_gather_enabled:
            payload, refs = serialization.dumps_oob(value)
        else:
            payload, refs = serialization.dumps(value)
        if ref_bag is not None:
            # Refs NESTED in containers count too: a batch member that
            # consumes such a ref from an earlier member would deadlock
            # the combined reply (see _drain_lease's batch cut).
            for r in refs:
                ref_bag.add(r.hex() if hasattr(r, "hex") else str(r))
        return ("v", payload)

    @staticmethod
    def _sched_key_of(spec: TaskSpec) -> _SchedKey:
        return _SchedKey(
            tuple(sorted(spec.resources.items())),
            tuple(sorted(map(str, spec.label_selector.items())))
            + tuple(sorted(map(str, spec.soft_label_selector.items())))
            # runtime-env identity: leases bind workers to one env, so
            # different envs must never share a scheduling class.
            + (spec.runtime_env.get("hash", ""),),
            spec.policy,
        )

    async def _enqueue_task(self, spec: TaskSpec) -> None:
        for oid in spec.return_ids:
            obj = self.owner_store.ensure(oid)
            obj.local_refs += 1
            obj.producing_task = spec.task_id
        self._task_specs[spec.task_id] = spec
        key = self._sched_key_of(spec)
        qs = self._queues.setdefault(key, _QueueState())
        qs.queue.append(spec)
        self._pump_queue(key, qs)

    def _pump_queue(self, key, qs: _QueueState) -> None:
        # Active leases are always busy executing (they pop the queue when
        # they free up), so concurrency demand counts only in-flight lease
        # requests — never subtract granted leases or sequential submissions
        # serialize behind one busy lease.
        want = min(len(qs.queue), self.max_pending_leases) - qs.inflight
        if want <= 0:
            return
        if want > 1 and GLOBAL_CONFIG.rpc_coalesce_enabled:
            # A deep queue's whole lease wave rides ONE RPC (PERF.md
            # round-5: the driver->node leg was still one frame per lease).
            qs.inflight += want
            spawn(
                self._acquire_batch_and_run(key, qs, want),
                name="lease batch acquire",
            )
            return
        for _ in range(want):
            qs.inflight += 1
            spawn(self._acquire_and_run(key, qs), name="lease acquire")

    async def _acquire_batch_and_run(
        self, key, qs: _QueueState, want: int
    ) -> None:
        sample = qs.queue[0] if qs.queue else None
        if sample is None:
            qs.inflight -= want
            return
        payload = self._lease_payload(sample)
        payload["count"] = want
        # Same idempotency key contract as _request_lease: if the batch
        # deadlines while a merely-slow node is still mid-grant, the
        # abandon below makes it return the whole wave's leases instead
        # of leaking them (node._h_request_lease_batch reply cache).
        payload["req_id"] = req_id = TaskID.random().hex()
        try:
            replies = await self.endpoint.acall(
                self.node_addr, "node.request_lease_batch", payload
            )
        except Exception as e:
            if not getattr(e, "_raytpu_remote", False):
                self._abandon_lease_request(self.node_addr, req_id)
            qs.inflight -= want
            while qs.queue:
                spec = qs.queue.pop(0)
                await self._fail_task(spec, e)
            return
        # Each entry continues on its own acquire path (a grant drains a
        # lease; a fallback/spill/retry re-enters the individual loop);
        # the inflight slots hand off 1:1.
        for reply in replies:
            first = None if reply.get("fallback") else reply
            spawn(
                self._acquire_and_run(key, qs, first_reply=first),
                name="lease acquire",
            )

    async def _acquire_and_run(
        self, key, qs: _QueueState, first_reply: dict | None = None
    ) -> None:
        sample = qs.queue[0] if qs.queue else None
        if sample is None:
            qs.inflight -= 1
            if first_reply is not None and "lease_id" in first_reply:
                # Batch over-acquired (the queue emptied meanwhile): give
                # the unused lease straight back.
                try:
                    await self.endpoint.acall(
                        self.node_addr,
                        "node.return_lease",
                        {"lease_id": first_reply["lease_id"]},
                    )
                except Exception:  # raylint: disable=RL006 -- lease return on an unreachable node; lease dies with the node
                    pass
            return
        try:
            grant = await self._request_lease(sample, first_reply=first_reply)
        except Exception as e:
            qs.inflight -= 1
            # Fail every queued task in this class with the scheduling error.
            while qs.queue:
                spec = qs.queue.pop(0)
                await self._fail_task(spec, e)
            return
        qs.inflight -= 1
        if grant is None:
            # raced: no more tasks
            return
        lease_id = grant["lease_id"]
        qs.leases[lease_id] = grant
        try:
            await self._drain_lease(qs, grant)
        finally:
            qs.leases.pop(lease_id, None)
            await self._return_lease(grant["node_addr"], lease_id)
            if qs.queue:
                self._pump_queue(key, qs)

    async def _return_lease(self, node_addr, lease_id: str) -> None:
        """Return a drained lease. Coalescing on: returns to one node are
        microbatched within a loop tick and ride one
        ``node.return_lease_batch`` frame (a drain wave's returns all land
        together); off: the old one-RPC-per-return path."""
        if not GLOBAL_CONFIG.rpc_coalesce_enabled:
            try:
                await self.endpoint.acall(
                    node_addr, "node.return_lease", {"lease_id": lease_id}
                )
            except Exception:  # raylint: disable=RL006 -- lease return on an unreachable node; lease dies with the node
                pass
            return
        addr = tuple(node_addr)
        buf = self._lease_returns.setdefault(addr, [])
        buf.append(lease_id)
        if len(buf) > 1:
            return  # a flush for this node is already scheduled

        async def flush():
            ids = self._lease_returns.pop(addr, [])
            if not ids:
                return
            try:
                await self.endpoint.acall(
                    addr, "node.return_lease_batch", {"lease_ids": ids}
                )
            except Exception:  # raylint: disable=RL006 -- batch lease return on an unreachable node; leases die with the node
                pass

        asyncio.get_running_loop().call_soon(
            lambda: spawn(flush(), name="lease batch return")
        )

    async def _drain_lease(self, qs: "_QueueState", grant: dict) -> None:
        """Feed the leased worker until the class queue empties or the
        worker dies. Two latency levers over the old one-at-a-time loop
        (PERF.md round-3 list):

        - PIPELINING: up to ``push_pipeline_depth`` pushes stay in flight,
          so the next task is already at the worker when the current one
          finishes (the worker's single executor thread still serializes
          execution — the lease's one resource slot is never
          oversubscribed).
        - BATCHING: with a deep queue, up to ``push_batch_size`` tasks
          ride one worker.push_batch RPC, amortizing per-message framing.

        Completion is awaited oldest-first; a worker death stops new
        pushes and lets each in-flight push run its own retry path."""
        cfg = GLOBAL_CONFIG
        depth = max(1, cfg.push_pipeline_depth)
        # [(future-of-ok, has_nonretryable)] in submission order.
        pending: list = []
        alive = True
        while True:
            while alive and qs.queue and len(pending) < depth:
                head = qs.queue[0]
                if pending and (
                    head.retries_left <= 0
                    or any(nr for _, nr in pending)
                ):
                    # A max_retries=0 task must never SHARE the pipeline
                    # with any other task, in either direction: worker
                    # death while two tasks are in flight can permanently
                    # fail the one that never started (execution order at
                    # the worker is not submission order — arg resolution
                    # happens before the serial lock). It rides alone.
                    break
                if pending and len(qs.queue) <= qs.inflight:
                    # Pipelining must not STARVE parallelism: other lease
                    # requests are in flight for this class, and each
                    # queued task left here becomes a parallel execution
                    # there. Only pipeline the surplus beyond them.
                    break
                if (
                    cfg.push_batch_size > 1
                    and len(qs.queue) >= cfg.push_batch_min_queue
                    # Only retryable tasks ride batches: a worker death
                    # mid-batch charges a retry to EVERY member (one RPC
                    # cannot tell who executed), and a max_retries=0 task
                    # must never be permanently failed without having
                    # started — those go one-per-push like before.
                    and head.retries_left > 0
                ):
                    # A batch member must not CONSUME an earlier member's
                    # output: the producer's result only ships on the
                    # combined reply, so the consumer's arg fetch would
                    # deadlock the whole batch.
                    batch_returns: set = set()
                    n = 0
                    while n < min(cfg.push_batch_size, len(qs.queue)):
                        cand = qs.queue[n]
                        if cand.retries_left <= 0 or (
                            batch_returns
                            and batch_returns
                            & self._spec_arg_ref_ids(cand)
                        ):
                            break
                        batch_returns.update(cand.return_ids)
                        n += 1
                    specs = [qs.queue.pop(0) for _ in range(max(n, 1))]
                    pending.append(
                        (
                            asyncio.ensure_future(
                                self._push_batch_to_worker(specs, grant)
                            ),
                            any(s.retries_left <= 0 for s in specs),
                        )
                    )
                else:
                    spec = qs.queue.pop(0)
                    pending.append(
                        (
                            asyncio.ensure_future(
                                self._push_to_worker(spec, grant)
                            ),
                            spec.retries_left <= 0,
                        )
                    )
            if not pending:
                return
            fut, _nr = pending.pop(0)
            ok = await fut
            if not ok:
                alive = False  # drain remaining in-flight, push no more

    @staticmethod
    def _spec_arg_ref_ids(spec: TaskSpec) -> set:
        """Object ids this task's args/kwargs reference (top-level AND
        nested; nested ids were bagged at encode time)."""
        out = set(spec.arg_ref_ids)
        for kind, v in list(spec.args) + list(spec.kwargs.values()):
            if kind == "r":
                out.add(v.hex() if hasattr(v, "hex") else str(v))
        return out

    async def _push_batch_to_worker(
        self, specs: list, grant: dict
    ) -> bool:
        """Push several tasks as ONE RPC; the worker executes them in
        order and replies with one result list. Connection loss routes
        every spec through the per-task retry/fail path."""
        live: list = []
        for spec in specs:
            if spec.cancelled:
                await self._fail_task(
                    spec,
                    TaskCancelledError(f"task {spec.name} was cancelled"),
                )
            else:
                live.append(spec)
        if not live:
            return True
        payloads = [self._push_payload(spec) for spec in live]
        for spec in live:
            self._inflight_push[spec.task_id] = tuple(grant["worker_addr"])
            self._task_event(
                spec.task_id,
                "RUNNING",
                node_id=grant.get("node_id"),
                worker_id=grant.get("worker_id"),
            )
        try:
            replies = await self.endpoint.acall(
                tuple(grant["worker_addr"]),
                "worker.push_batch",
                {"tasks": payloads},
            )
        except (ConnectionLost, ConnectionError, OSError):
            # ONE reap for the one dead worker, then per-spec retry/fail.
            await self._reap_worker(grant)
            for spec in live:
                await self._retry_or_fail_after_conn_loss(spec)
            return False
        except Exception as e:  # noqa: BLE001
            # Whole-RPC failure with the connection alive (reply encoding
            # etc.): like the single-push path, the owner cannot know who
            # ran — fail every member so their refs resolve.
            for spec in live:
                await self._fail_task(spec, e)
            return True
        finally:
            for spec in live:
                self._inflight_push.pop(spec.task_id, None)
        for spec, reply in zip(live, replies):
            self._apply_task_reply(spec, reply)
        return True

    def _push_payload(self, spec: TaskSpec) -> dict:
        return {
            "task_id": spec.task_id,
            "name": spec.name,
            "func": spec.func_payload,
            "args": spec.args,
            "kwargs": spec.kwargs,
            "return_ids": spec.return_ids,
            "owner_addr": tuple(self.endpoint.address),
            "pg": spec.pg,
            "trace_ctx": spec.trace_ctx,
            "streaming": spec.streaming,
        }

    @staticmethod
    def _lease_payload(spec: TaskSpec) -> dict:
        return {
            "resources": spec.resources,
            "label_selector": spec.label_selector,
            "soft_label_selector": spec.soft_label_selector,
            "policy": spec.policy,
            "runtime_env": spec.runtime_env,
        }

    def _abandon_lease_request(self, node_addr, req_id: str) -> None:
        """Best-effort, bounded, fire-and-forget node.cancel_lease_request:
        the target may be wedged (that is why we are abandoning), so the
        notify runs as its own task under the connect timeout instead of
        stalling the lease loop."""

        async def _fire():
            try:
                await asyncio.wait_for(
                    self.endpoint.anotify(
                        tuple(node_addr),
                        "node.cancel_lease_request",
                        {"req_id": req_id},
                    ),
                    GLOBAL_CONFIG.rpc_connect_timeout_s,
                )
            except Exception:  # raylint: disable=RL006 -- peer truly gone: nothing granted, nothing to leak
                pass  # peer truly gone: nothing granted, nothing to leak

        spawn(_fire(), name="lease cancel notify")

    async def _request_lease(
        self, spec: TaskSpec, first_reply: dict | None = None
    ) -> dict | None:
        payload = self._lease_payload(spec)
        node_addr = self.node_addr
        deadline = time.monotonic() + GLOBAL_CONFIG.lease_request_timeout_s
        while True:
            if first_reply is not None:
                # An entry of a request_lease_batch reply (always from our
                # own node): consume it as this iteration's answer.
                reply, first_reply = first_reply, None
            else:
                # Fresh idempotency key per LOGICAL attempt; transport
                # retries inside acall reuse it, so a retry attaches to
                # the server's in-flight grant instead of double-
                # granting (node._h_request_lease dedup).
                req_id = TaskID.random().hex()
                if tuple(node_addr) != tuple(self.node_addr):
                    # Spill target: a wedged peer must fail with lease
                    # budget left for the home-failover below, but the
                    # default transport schedule (rpc_max_retries x
                    # rpc_slow_deadline_s) is several times
                    # lease_request_timeout_s. The failover IS this
                    # call's retry — one attempt, bounded to half the
                    # remaining budget so home still gets a real turn.
                    kw = {"retries": 0}
                    per = method_deadline_s("node.request_lease")
                    if per > 0:
                        remaining = max(deadline - time.monotonic(), 1.0)
                        kw["deadline_s"] = min(per, remaining * 0.5)
                else:
                    kw = {}
                try:
                    reply = await self.endpoint.acall(
                        node_addr,
                        "node.request_lease",
                        {**payload, "req_id": req_id},
                        **kw,
                    )
                except (
                    DeadlineExceededError,
                    PeerUnavailableError,
                    ConnectionLost,
                    ConnectionError,
                    OSError,
                ) as e:
                    if getattr(e, "_raytpu_remote", False) or tuple(
                        node_addr
                    ) == tuple(self.node_addr):
                        if not getattr(e, "_raytpu_remote", False):
                            # Own node deadlined/unreachable — fatal for
                            # the class, but a merely-STALLED node may
                            # still finish the grant nobody will consume:
                            # tell it to return that lease, same as the
                            # spill-target path below.
                            self._abandon_lease_request(node_addr, req_id)
                        raise  # our OWN node is gone — fatal for the class
                    # Abandoning req_id for a fresh attempt from home: a
                    # merely-SLOW target may still complete the grant
                    # nobody will consume — tell it to return that lease
                    # rather than leak it (fire-and-forget: the notify
                    # must not stall this loop on the wedged peer).
                    self._abandon_lease_request(node_addr, req_id)
                    # A spill target that hangs or breaker-fails: report it
                    # suspect to our home node (its scheduler stops
                    # spilling there for one breaker window) and retry
                    # from home instead of failing every queued task.
                    try:
                        await self.endpoint.anotify(
                            self.node_addr,
                            "node.peer_suspect",
                            {"addr": tuple(node_addr)},
                        )
                    except Exception:  # raylint: disable=RL006 -- suspect-report notify; scheduler breaker state converges on its own
                        pass
                    if time.monotonic() > deadline:
                        raise asyncio.TimeoutError(
                            "lease request timed out (spill target "
                            "unreachable)"
                        )
                    await asyncio.sleep(0.2)
                    node_addr = self.node_addr
                    continue
            if "error" in reply:
                raise reply["error"]
            if "lease_id" in reply:
                reply["node_addr"] = node_addr
                return reply
            if "spill" in reply:
                if time.monotonic() > deadline:
                    raise asyncio.TimeoutError(
                        "lease request timed out while spilling"
                    )
                node_addr = tuple(reply["spill"])
                continue
            if "retry_after" in reply:
                if time.monotonic() > deadline:
                    raise asyncio.TimeoutError("lease request timed out")
                await asyncio.sleep(reply["retry_after"])
                node_addr = self.node_addr
                continue
            raise RuntimeError(f"bad lease reply: {reply}")

    async def _push_to_worker(self, spec: TaskSpec, grant: dict) -> bool:
        """Push one task; on worker death retry or fail. Returns False if
        the lease's worker is gone. A batch of one: the batch path already
        implements the full push bracket (cancel check, inflight/event
        bookkeeping, conn-loss reap+retry, whole-RPC failure, reply
        apply) — one copy of that state machine, not two."""
        return await self._push_batch_to_worker([spec], grant)

    async def _reap_worker(self, grant: dict) -> None:
        """Let the node reap the dead worker NOW so a retry doesn't get
        handed the same corpse from the idle pool."""
        try:
            await self.endpoint.acall(
                tuple(grant["node_addr"]),
                "node.worker_unreachable",
                {"worker_id": grant["worker_id"]},
            )
        except Exception:  # raylint: disable=RL006 -- kill of a worker on an unreachable node; node death reaps it
            pass

    async def _retry_or_fail_after_conn_loss(self, spec: TaskSpec) -> None:
        if spec.cancelled:
            # force-cancel kills the worker; report cancellation, not a
            # crash, and never retry a cancelled task.
            await self._fail_task(
                spec,
                TaskCancelledError(f"task {spec.name} was cancelled"),
            )
        elif spec.retries_left > 0:
            spec.retries_left -= 1
            await self._enqueue_task_respec(spec)
        else:
            await self._fail_task(
                spec,
                WorkerCrashedError(
                    f"worker died executing {spec.name} "
                    f"(task {spec.task_id[:8]})"
                ),
            )

    async def _enqueue_task_respec(self, spec: TaskSpec) -> None:
        key = self._sched_key_of(spec)
        qs = self._queues.setdefault(key, _QueueState())
        qs.queue.append(spec)
        self._pump_queue(key, qs)

    def _apply_task_reply(self, spec: TaskSpec, reply: dict) -> None:
        results = reply["results"]
        for oid, res in zip(spec.return_ids, results):
            kind = res[0]
            if spec.lineage_attempts and oid not in self.owner_store.objects:
                # A reconstruction rerun recomputed a sibling whose ref was
                # already dropped: don't resurrect the owner entry, and free
                # the orphan blob the rerun just sealed on its node.
                if kind == "location":
                    spawn(
                        self._free_remote_blob(res[1], oid),
                        name="orphan blob free",
                    )
                continue
            if kind == "inline":
                self.owner_store.put_inline(oid, res[1])
            elif kind == "location":
                self.owner_store.put_location(oid, res[1], res[2])
            elif kind == "error":
                self.owner_store.put_error(oid, res[1])
        # Spec RETAINED while any return ref is live: it is the lineage used
        # to reconstruct outputs whose only copy dies with a node
        # (reference: task_manager.h:229 ResubmitTask; GC in _maybe_free).
        spec.completed = True
        failed = any(r[0] == "error" for r in results)
        if spec.streaming:
            err = next((r[1] for r in results if r[0] == "error"), None)
            self._finish_stream(spec.task_id, err)
        self._task_event(
            spec.task_id,
            "FAILED" if failed else "FINISHED",
            name=spec.name,
            **(reply.get("exec") or {}),
        )
        # Fire-and-forget pattern: refs dropped while the task was PENDING
        # couldn't free then — re-check now that results exist.
        spawn(self._free_completed_outputs(spec), name="output free")

    async def _free_completed_outputs(self, spec: TaskSpec) -> None:
        for oid in spec.return_ids:
            await self._maybe_free(oid)

    async def _free_remote_blob(self, node_id: str, oid: str) -> None:
        addr = await self._node_addr_for(node_id)
        if addr is not None:
            try:
                await self.endpoint.anotify(
                    addr, "node.free_object", {"oid": oid}
                )
            except Exception:  # raylint: disable=RL006 -- best-effort orphan blob free; node death frees it
                pass

    async def _fail_task(self, spec: TaskSpec, error: Exception) -> None:
        for oid in spec.return_ids:
            self.owner_store.put_error(oid, error)
        self._task_specs.pop(spec.task_id, None)
        if spec.streaming:
            self._finish_stream(spec.task_id, error)
        self._task_event(
            spec.task_id, "FAILED", name=spec.name, error=str(error)[:500]
        )

    # -- streaming (owner side) ----------------------------------------------
    # Reference: python/ray/_private/object_ref_generator.py:32 + the
    # streaming-generator item-report protocol in src/ray/core_worker.

    def _make_stream(self, task_id: str, sentinel_ref: ObjectRef):
        from ray_tpu_torch.core.streaming import ObjectRefGenerator, StreamState

        self._streams[task_id] = StreamState()
        return ObjectRefGenerator(task_id, self, sentinel_ref)

    def _finish_stream(
        self, task_id: str, error: Exception | None
    ) -> None:
        stream = self._streams.get(task_id)
        if stream is None or stream.done:
            return
        stream.error = error
        stream.done = True
        stream.wake()

    async def _h_owner_stream_item(self, conn, p):
        """One yielded item from an executing streaming task. The reply is
        the producer's permission to continue (backpressure: at most one
        unacked item in flight per task).

        Re-reports are IDEMPOTENT by design (deterministic item oids): a
        lineage-reconstruction rerun re-reports indexes the stream already
        delivered, and those must refresh the object's location (the old
        copy died with its node) rather than be discarded — and the rerun
        must not be stopped early, or the lost item never gets re-created."""
        from ray_tpu_torch.core.streaming import stream_item_oid

        task_id, index = p["task_id"], p["index"]
        stream = self._streams.get(task_id)
        spec = self._task_specs.get(task_id)
        reconstructing = bool(spec is not None and spec.lineage_attempts)
        oid = stream_item_oid(task_id, index)
        is_new = (
            stream is not None
            and not stream.done
            and index == len(stream.item_refs)
        )
        existing = self.owner_store.objects.get(oid)
        if not is_new and existing is None:
            # Duplicate report of an item nobody holds anymore: skip it, and
            # stop the producer outright when no reconstruction is running
            # and no live stream wants future items.
            ended = stream is None or stream.done
            return {"accepted": False, "stop": ended and not reconstructing}
        obj = self.owner_store.ensure(oid)
        if is_new:
            obj.local_refs += 1
            obj.producing_task = task_id
            obj.actor_task = True  # items are not individually cancellable
        res = p["result"]
        if res[0] == "inline":
            self.owner_store.put_inline(oid, res[1])
        else:  # ("location", node_id, size, oid)
            self.owner_store.put_location(oid, res[1], res[2])
        if is_new:
            stream.item_refs.append(
                ObjectRef(
                    ObjectID.from_hex(oid),
                    self.endpoint.address,
                    spec.name if spec else "stream_item",
                )
            )
            stream.wake()
        return {"accepted": True, "stop": False}

    async def _stream_next_async(self, task_id: str, cursor: int):
        """The cursor-th item ref, waiting for it to arrive; None at a clean
        end of stream; raises the task's error at a failed one."""
        stream = self._streams.get(task_id)
        if stream is None:
            raise RayTpuError(
                f"stream for task {task_id[:8]} is gone (generator dropped "
                "or owner restarted)"
            )
        while True:
            if cursor < len(stream.item_refs):
                return stream.item_refs[cursor]
            if stream.done:
                if stream.error is not None:
                    raise stream.error
                return None
            ev = asyncio.Event()
            stream.waiters.append(ev)
            await ev.wait()

    async def stream_next_async(self, task_id: str, cursor: int):
        return await self._stream_next_async(task_id, cursor)

    def stream_next(self, task_id: str, cursor: int):
        if self.on_endpoint_loop():
            raise RuntimeError(
                "blocking stream iteration on the endpoint loop would "
                "deadlock; use `async for` here"
            )
        return self.endpoint.submit(
            self._stream_next_async(task_id, cursor)
        ).result()

    def drop_stream(self, task_id: str) -> None:
        """Generator GC: forget the stream. Item refs the user still holds
        stay valid (their own ref counts keep the objects alive)."""
        if self._stopped:
            return
        try:
            self.endpoint.submit(self._drop_stream_async(task_id))
        except Exception:  # raylint: disable=RL006 -- stream drop riding a stopping endpoint loop; server ttl reaps it
            pass

    async def _drop_stream_async(self, task_id: str) -> None:
        stream = self._streams.pop(task_id, None)
        if stream is None:
            return
        stream.done = True
        stream.wake()
        # Just drop the list: each item ObjectRef's own __del__ (the
        # ref-deleted hook) releases its count once the user also lets go —
        # an explicit release here would double-decrement refs the user
        # still holds.
        stream.item_refs.clear()

    # -- cancellation --------------------------------------------------------

    def cancel(self, ref: ObjectRef, force: bool = False) -> None:
        """Cancel the task producing ``ref`` (reference: worker.py:3302).

        Queued tasks are removed and fail with TaskCancelledError; running
        tasks get a best-effort interrupt raised in their executing thread
        (``force`` kills the worker process instead). Cancelling a finished
        task is a no-op. Only the owner can cancel."""
        self.endpoint.submit(self._cancel_async(ref, force)).result(
            timeout=30
        )

    async def _cancel_async(self, ref: ObjectRef, force: bool) -> None:
        if not self._is_owner(ref):
            raise ValueError(
                "cancel() must be called by the owner of the ObjectRef"
            )
        obj = self.owner_store.objects.get(ref.hex())
        if obj is not None and obj.actor_task:
            raise ValueError("cancel() does not support actor tasks; use "
                             "kill() on the actor instead")
        task_id = obj.producing_task if obj else None
        if task_id is None:
            return  # put() object or unknown — nothing to cancel
        spec = self._task_specs.get(task_id)
        if spec is None:
            return  # already finished (or already cancelled/failed)
        spec.cancelled = True
        # Queued and not yet pushed: remove + fail here (identity scan in
        # this spec's own scheduling-class queue; dataclass equality would
        # compare pickled payloads against every queued task).
        qs = self._queues.get(self._sched_key_of(spec))
        if qs is not None:
            for i, s in enumerate(qs.queue):
                if s is spec:
                    del qs.queue[i]
                    await self._fail_task(
                        spec,
                        TaskCancelledError(
                            f"task {spec.name} was cancelled"
                        ),
                    )
                    return
        # In flight on a worker: best-effort interrupt (or force-kill).
        addr = self._inflight_push.get(task_id)
        if addr is not None:
            try:
                await self.endpoint.acall(
                    addr,
                    "worker.cancel_task",
                    {"task_id": task_id, "force": force},
                )
            except (ConnectionLost, ConnectionError, OSError):
                pass  # worker already gone; push path will fail the task
        # Not queued and not in flight: between queue-pop and push — the
        # spec.cancelled flag makes _push_to_worker fail it before pushing.

    # -- actor client --------------------------------------------------------

    def create_actor(
        self,
        cls: type,
        args: tuple,
        kwargs: dict,
        *,
        name: str | None = None,
        resources: dict | None = None,
        max_restarts: int = 0,
        max_concurrency: int = 0,  # 0 = auto (sync serial, async 1000)
        concurrency_groups: dict | None = None,
        label_selector: dict | None = None,
        soft_label_selector: dict | None = None,
        policy: str = "hybrid",
        pg: tuple | None = None,
        runtime_env: dict | None = None,
    ) -> dict:
        actor_id = ActorID.random().hex()
        spec = {
            "runtime_env": dict(runtime_env or {}),
            "actor_id": actor_id,
            "name": name,
            "class_payload": cloudpickle.dumps(cls),
            "args_payload": serialization.dumps((args, kwargs))[0],
            "resources": dict(resources) if resources is not None else {"CPU": 1.0},
            "max_restarts": max_restarts,
            "max_concurrency": max_concurrency,
            "concurrency_groups": dict(concurrency_groups or {}),
            "label_selector": dict(label_selector or {}),
            "soft_label_selector": dict(soft_label_selector or {}),
            "policy": policy,
            "class_name": getattr(cls, "__name__", "Actor"),
            "pg": pg,
        }
        if self.on_endpoint_loop():
            # Async actor method creating an actor: the actor id is chosen
            # client-side, so registration can proceed without blocking the
            # loop (the submitter retries name resolution until the GCS
            # finishes scheduling it; a registration error is logged here
            # and surfaces to callers as the actor never becoming alive).
            spawn(
                self.gcs.acall("create_actor", {"spec": spec}),
                name=f"actor registration ({spec['class_name']})",
            )
            return {"actor_id": actor_id}
        info = self.gcs.call("create_actor", {"spec": spec}, timeout=120)
        return info

    def submit_actor_task(
        self,
        actor_id: str,
        method: str,
        args: tuple,
        kwargs: dict,
        *,
        num_returns: "int | str" = 1,
        name: str = "",
        max_task_retries: int = 0,
    ) -> list:
        streaming = num_returns == "streaming"
        task_id = TaskID.random().hex()
        n_returns = 1 if streaming else num_returns
        return_ids = [ObjectID.random().hex() for _ in range(n_returns)]
        spec = TaskSpec(
            task_id=task_id,
            name=name or method,
            func_payload=None,
            args=[self._encode_arg(a) for a in args],
            kwargs={k: self._encode_arg(v) for k, v in kwargs.items()},
            return_ids=return_ids,
            resources={},
            retries_left=max_task_retries,
            actor_id=actor_id,
            method=method,
            streaming=streaming,
        )
        refs = [
            ObjectRef(ObjectID.from_hex(oid), self.endpoint.address, spec.name)
            for oid in return_ids
        ]
        if streaming:
            refs = [self._make_stream(task_id, refs[0])]
        from ray_tpu_torch.util import tracing

        tfields = tracing.submission_fields()
        if tfields:
            spec.trace_ctx = (tfields["trace_id"], tfields["span_id"])
        self._task_event(
            task_id,
            "SUBMITTED_TO_ACTOR",
            name=spec.name,
            kind="actor_task",
            actor_id=actor_id,
            **tfields,
        )
        self._run_on_loop(
            self._guarded_enqueue(self._submit_actor_async, spec)
        )
        return refs

    async def _submit_actor_async(self, spec: TaskSpec) -> None:
        for oid in spec.return_ids:
            obj = self.owner_store.ensure(oid)
            obj.local_refs += 1
            obj.actor_task = True  # cancel() rejects actor-task refs
        sub = self._actor_submitters.get(spec.actor_id)
        if sub is None:
            sub = self._actor_submitters[spec.actor_id] = _ActorSubmitter(
                self, spec.actor_id
            )
        sub.enqueue(spec)

    # -- execution side (worker role) ---------------------------------------

    async def _h_worker_start_actor(self, conn, p):
        """Begin actor construction and reply immediately (async creation, as
        the reference's CreateActor: the creation task runs on the worker and
        method calls queue behind it). Required for actors whose __init__
        blocks on peers — e.g. collective rendezvous: rank 0's __init__ waits
        for rank 1, which only gets created after rank 0's RPC returns."""
        spec = p["spec"]
        cls = cloudpickle.loads(spec["class_payload"])
        (args, kwargs), _ = serialization.loads(spec["args_payload"])
        # max_concurrency 0 = "auto" (user never set it): sync methods stay
        # serialized on one thread, async methods get the reference's
        # async-actor default of 1000 — a cap of 1 would deadlock reentrant
        # calls (A awaits B which calls back into A).
        max_conc = spec.get("max_concurrency", 0)
        if max_conc > 1:
            self._executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=max_conc, thread_name_prefix="actor-exec"
            )
        # Async methods interleave after their ordered start — this is what
        # actually caps them at max_concurrency (the executor above only
        # bounds sync methods).
        self._actor_semaphore = asyncio.Semaphore(
            max_conc if max_conc > 0 else 1000
        )
        # Named concurrency groups (reference: core_worker fiber.h /
        # concurrency_groups): each group gets its OWN sync thread pool and
        # async semaphore, so e.g. long "compute" calls can't starve "io"
        # health checks. Methods opt in via @ray_tpu_torch.method(
        # concurrency_group="io"); resolution happens here (executor side)
        # from the method attribute — no protocol change.
        self._concurrency_groups = {}
        for gname, limit in (spec.get("concurrency_groups") or {}).items():
            limit = int(limit)
            if limit < 1:
                raise ValueError(
                    f"concurrency group {gname!r} limit must be >= 1, "
                    f"got {limit}"
                )
            self._concurrency_groups[gname] = {
                "executor": concurrent.futures.ThreadPoolExecutor(
                    max_workers=limit,
                    thread_name_prefix=f"actor-{gname}",
                ),
                "semaphore": asyncio.Semaphore(limit),
            }
        loop = asyncio.get_running_loop()
        self._actor_id = p["actor_id"]
        self._actor_pg = tuple(spec["pg"]) if spec.get("pg") else None
        self._actor_ready = asyncio.Event()
        self._actor_init_error = None

        def make():
            return cls(*args, **kwargs)

        async def construct():
            try:
                self._actor_instance = await loop.run_in_executor(
                    self._executor, make
                )
            except Exception as e:  # noqa: BLE001
                self._actor_init_error = TaskError(
                    f"actor {spec.get('class_name', 'Actor')}.__init__ "
                    f"failed: {e!r}",
                    traceback.format_exc(),
                )
                # Tell our node so the GCS can restart or mark the actor dead
                # with the real error; the node then retires this process.
                try:
                    await self.endpoint.acall(
                        self.node_addr,
                        "node.actor_init_failed",
                        {
                            "worker_id": self.worker_id,
                            "actor_id": self._actor_id,
                            "reason": str(self._actor_init_error),
                        },
                    )
                except Exception:  # raylint: disable=RL006 -- actor-death report on a dying GCS link; heartbeat loss reports it too
                    pass
            finally:
                self._actor_ready.set()

        self.endpoint.submit(construct())
        return True

    async def _h_worker_push_task(self, conn, p):
        if p.get("actor_id") is not None:
            return await self._execute_actor_task(p)
        return await self._execute_task(p)

    async def _h_worker_push_batch(self, conn, p):
        """Batched push: execute the tasks in order, reply with one result
        list (see _push_batch_to_worker; reference: the submitter-side
        batching lever in PERF.md)."""
        return [
            await self._h_worker_push_task(conn, task)
            for task in p["tasks"]
        ]

    # -- device objects (reference: gpu_object_manager __ray_send__) ---------

    async def _h_worker_rdt_fetch(self, conn, p):
        """Serve a device object as a host tensor (the device->host copy
        runs in the executor thread: it must not block the endpoint
        loop)."""
        from ray_tpu_torch.experimental.device_objects import store

        return await asyncio.get_running_loop().run_in_executor(
            None, store().fetch_host, p["oid"]
        )

    async def _h_worker_rdt_free(self, conn, p):
        from ray_tpu_torch.experimental import transfer as _xfer
        from ray_tpu_torch.experimental.device_objects import store

        if p["oid"] in self._rdt_arming:
            # An arm is staging this object in the executor thread right
            # now: mark it so the arm completion discards its descriptor.
            self._rdt_freed_while_arming.add(p["oid"])
        freed = store().free(p["oid"])
        # Release armed fabric copies unconditionally: a budget-exhausted
        # object is already gone from the store (freed=False) but its
        # staged copy may still sit armed.
        if _xfer._fabric is not None:
            _xfer.fabric().release_armed(p["oid"])
        return freed

    async def _h_worker_rdt_done(self, conn, p):
        """Consumer ack: the pull for this uuid completed; drop the staged
        copy so the producer does not keep it."""
        from ray_tpu_torch.experimental import transfer as _xfer

        if _xfer._fabric is not None:
            _xfer.fabric().release_uuid(p["uuid"])
        return True

    async def _h_worker_rdt_unarm(self, conn, p):
        """Consumer's pull failed after a successful arm: drop the staged
        copy AND refund the fetch budget by restoring the entry to the
        store (the source tensor the arm kept)."""
        from ray_tpu_torch.experimental import transfer as _xfer
        from ray_tpu_torch.experimental.device_objects import store

        if _xfer._fabric is None:
            return False
        entry = _xfer.fabric().release_uuid(p["uuid"])
        if entry is None:
            return False
        oid, staged = entry[0], entry[1]
        store().restore_arm(oid, staged)
        return True

    async def _h_worker_rdt_arm(self, conn, p):
        """Stage a device object on the transfer fabric for one pull
        (consumer-chosen shard decomposition). Returns the pull descriptor,
        or {"gone": True} / {"unsupported": reason} so the caller can fall
        back to the host path.

        The staging itself (a device->host copy) runs in the executor
        thread; a concurrent rdt_free landing on the loop mid-arm is
        detected via the arming/freed marker sets (both handlers touch
        them loop-side only) so a freed object can neither hand out a
        live descriptor nor be resurrected into the store by a later
        unarm."""
        oid = p["oid"]

        def _arm():
            from ray_tpu_torch.experimental import device_objects

            entry = device_objects.store().take_for_arm(oid)
            if entry is None:
                return {"gone": True}
            try:
                return device_objects._fabric().arm(oid, entry, p["partitions"])
            except Exception as e:  # noqa: BLE001 - not servable over the fabric
                device_objects.store().restore_arm(oid, entry)
                return {"unsupported": f"{type(e).__name__}: {e}"}

        self._rdt_arming[oid] = self._rdt_arming.get(oid, 0) + 1
        try:
            res = await asyncio.get_running_loop().run_in_executor(None, _arm)
            if oid in self._rdt_freed_while_arming:
                from ray_tpu_torch.experimental import transfer as _xfer
                from ray_tpu_torch.experimental.device_objects import store

                if "uuid" in res:
                    _xfer.fabric().release_uuid(res["uuid"])
                store().free(oid)  # drop any restore the arm path made
                return {"gone": True}
            return res
        finally:
            n = self._rdt_arming.get(oid, 1) - 1
            if n <= 0:
                self._rdt_arming.pop(oid, None)
                self._rdt_freed_while_arming.discard(oid)
            else:
                self._rdt_arming[oid] = n

    def _exec_span(self, t0: float) -> dict:
        """Executor-side timing attached to task replies; the owner merges
        it into the task event (timeline 'execution' span)."""
        return {
            "exec_start_ts": t0,
            "exec_end_ts": time.time(),
            "exec_pid": os.getpid(),
            "exec_worker_id": self.worker_id,
            "exec_node_id": self.node_id,
        }

    async def _execute_task(self, p) -> dict:
        from ray_tpu_torch.util.placement_group import _bind_ambient_pg

        t_exec0 = time.time()
        try:
            func = cloudpickle.loads(p["func"])
            args, kwargs = await self._resolve_args(p)
        except Exception as e:  # noqa: BLE001
            # Deserialization / arg-fetch failures (e.g. an upstream task's
            # error) must become error RESULTS: raising here surfaces as an
            # RPC-level error the submitter can't attribute, leaving the
            # task's return refs pending forever.
            return {
                "results": self._error_results(p, e),
                "exec": self._exec_span(t_exec0),
            }
        loop = asyncio.get_running_loop()
        pginfo = p.get("pg")
        task_id = p.get("task_id")

        def run():
            with self._sync_task_slot(task_id, p["name"]):
                from ray_tpu_torch.util import tracing

                with tracing.execution_scope(p.get("trace_ctx")):
                    with _bind_ambient_pg(pginfo):
                        return func(*args, **kwargs)

        try:
            if p.get("streaming"):
                async with self._normal_task_serial:
                    results = await self._execute_streaming(
                        p, func, args, kwargs, pginfo, self._executor
                    )
                return {"results": results, "exec": self._exec_span(t_exec0)}
            if asyncio.iscoroutinefunction(func):
                async with self._normal_task_serial:
                    with self._cancel_lock:
                        if task_id in self._cancelled_tasks:
                            raise TaskCancelledError(
                                f"task {p['name']} cancelled"
                            )
                        with _bind_ambient_pg(pginfo):
                            coro_task = asyncio.ensure_future(
                                func(*args, **kwargs)
                            )
                        self._running_async[task_id] = coro_task
                    try:
                        result = await coro_task
                    except asyncio.CancelledError:
                        raise TaskCancelledError(
                            f"task {p['name']} cancelled"
                        ) from None
                    finally:
                        self._running_async.pop(task_id, None)
            else:
                async with self._normal_task_serial:
                    result = await loop.run_in_executor(self._executor, run)
            results = self._encode_results(p, result)
            await self._flush_created(results)
            return {"results": results, "exec": self._exec_span(t_exec0)}
        except Exception as e:  # noqa: BLE001
            return {
                "results": self._error_results(p, e),
                "exec": self._exec_span(t_exec0),
            }
        finally:
            with self._cancel_lock:
                self._cancelled_tasks.discard(task_id)

    @contextlib.contextmanager
    def _sync_task_slot(self, task_id, name, register: bool = True):
        """Executor-thread bracket for one sync task: cancel-flag check +
        interrupt registration on entry; async-exception absorption and the
        cancel-handler ACK on exit (see _h_worker_cancel_task)."""
        if not register:
            yield
            return
        with self._cancel_lock:
            if task_id in self._cancelled_tasks:
                # cancel arrived before execution started (e.g. during
                # the arg-resolve window) — never run the fn.
                raise TaskCancelledError(f"task {name} cancelled")
            self._running_tasks[task_id] = threading.get_ident()
        try:
            yield
        finally:
            with self._cancel_lock:
                self._running_tasks.pop(task_id, None)
                absorb = self._interrupt_sent == task_id
                if absorb:
                    self._interrupt_sent = None
            if absorb:
                # An async exception was sent for THIS task but may not
                # have fired inside the fn (it races completion). Absorb
                # it here — if it escaped, it would kill the executor
                # pool thread or poison the next task.
                try:
                    for _ in range(200_000):
                        pass
                except TaskCancelledError:
                    pass
            done = self._interrupt_done.pop(task_id, None)
            if done is not None:
                # ACK to the waiting cancel_task handler: the interrupt
                # resolved (fired inside the fn, or was absorbed above).
                done.set()

    # -- streaming (executor side) -------------------------------------------

    async def _report_stream_item(self, p, index: int, value) -> bool:
        """Encode + report one yielded item to the owner; the ack is the
        license to produce the next one (backpressure). False = owner says
        stop (generator dropped or stream already ended)."""
        from ray_tpu_torch.core.streaming import stream_item_oid

        oid = stream_item_oid(p["task_id"], index)
        res = self._encode_one(oid, value)
        if res[0] == "location":
            await self.endpoint.acall(
                self.node_addr,
                "node.object_created",
                {"oid": oid, "size": res[2]},
            )
        reply = await self.endpoint.acall(
            tuple(p["owner_addr"]),
            "owner.stream_item",
            {"task_id": p["task_id"], "index": index, "result": res},
        )
        return not reply.get("stop")

    async def _execute_streaming(
        self, p, func, args, kwargs, pginfo, executor, semaphore=None
    ) -> list:
        """Drive a streaming task: iterate the user generator, report each
        item, and return the sentinel results (item count on success).

        Supports sync/async generator *functions*, plus plain/coroutine
        functions that RETURN a (sync or async) generator — the shape Serve
        replicas produce — falling back to a single-item stream for a plain
        value."""
        from ray_tpu_torch.util.placement_group import _bind_ambient_pg

        loop = asyncio.get_running_loop()
        task_id = p.get("task_id")
        register = p.get("actor_id") is None  # actor tasks aren't cancellable

        def drive_sync_gen(gen_factory):
            def run_gen():
                with self._sync_task_slot(task_id, p["name"], register):
                    from ray_tpu_torch.util import tracing

                    with tracing.execution_scope(p.get("trace_ctx")):
                        with _bind_ambient_pg(pginfo):
                            gen = gen_factory()
                            count = 0
                            for value in gen:
                                keep_going = asyncio.run_coroutine_threadsafe(
                                    self._report_stream_item(p, count, value),
                                    loop,
                                ).result()
                                count += 1
                                if not keep_going:
                                    gen.close()
                                    break
                            return count

            return loop.run_in_executor(executor, run_gen)

        async def drive_async_gen(agen) -> int:
            count = 0
            with _bind_ambient_pg(pginfo):
                try:
                    async for value in agen:
                        if not await self._report_stream_item(
                            p, count, value
                        ):
                            count += 1
                            await agen.aclose()
                            break
                        count += 1
                except asyncio.CancelledError:
                    raise TaskCancelledError(
                        f"task {p['name']} cancelled"
                    ) from None
            return count

        async def tracked(coro) -> int:
            """Register the driving coroutine so cancel() can interrupt an
            async streaming task mid-stream."""
            coro_task = asyncio.ensure_future(coro)
            if register:
                with self._cancel_lock:
                    if task_id in self._cancelled_tasks:
                        coro_task.cancel()
                    self._running_async[task_id] = coro_task
            try:
                return await coro_task
            except asyncio.CancelledError:
                raise TaskCancelledError(
                    f"task {p['name']} cancelled"
                ) from None
            finally:
                if register:
                    self._running_async.pop(task_id, None)

        async def stream_result_value(result) -> int:
            """Stream whatever a non-generator fn produced: an async
            generator object, a sync generator/iterator, or a single
            value (single-chunk stream)."""
            if inspect.isasyncgen(result):
                return await tracked(drive_async_gen(result))
            if inspect.isgenerator(result):
                # Same bracketed driver as a generator fn: the body runs
                # lazily here, so it needs the task slot (cancellability),
                # trace scope, and ambient pg just the same.
                return await drive_sync_gen(lambda: result)
            await self._report_stream_item(p, 0, result)
            return 1

        gate = semaphore if semaphore is not None else contextlib.nullcontext()
        if inspect.isasyncgenfunction(func):
            async with gate:
                count = await tracked(drive_async_gen(func(*args, **kwargs)))
        elif inspect.isgeneratorfunction(func):
            count = await drive_sync_gen(lambda: func(*args, **kwargs))
        elif asyncio.iscoroutinefunction(func):
            # e.g. an async handler that returns an async generator object
            async with gate:
                result = await tracked(func(*args, **kwargs))
                count = await stream_result_value(result)
        else:
            def run_plain():
                with self._sync_task_slot(task_id, p["name"], register):
                    with _bind_ambient_pg(pginfo):
                        return func(*args, **kwargs)

            result = await loop.run_in_executor(executor, run_plain)
            count = await stream_result_value(result)
        # Sentinel: the item count (kept internal; consumers see the
        # generator, not this object).
        return self._encode_results(
            {"return_ids": p["return_ids"], "name": p["name"]}, count
        )

    async def _execute_actor_task(self, p) -> dict:
        # Per-caller ordering: calls START in sequence-number order (the
        # reference guarantee). Once a call's args are resolved and the user
        # method is about to run, the next call may proceed — that is what
        # lets async actor methods interleave up to max_concurrency instead
        # of serializing on completion.
        caller, seq = p["caller"], p["seq"]
        expected = self._actor_seq.get(caller, 0)
        if seq != expected:
            ev = asyncio.Event()
            self._actor_buffer[(caller, seq)] = ev
            await ev.wait()
        advanced = False

        def advance():
            nonlocal advanced
            if not advanced:
                advanced = True
                self._actor_seq[caller] = seq + 1
                nxt = self._actor_buffer.pop((caller, seq + 1), None)
                if nxt is not None:
                    nxt.set()

        try:
            from ray_tpu_torch.util.placement_group import _bind_ambient_pg

            await self._actor_ready.wait()
            if self._actor_init_error is not None:
                return {
                    "results": self._error_results(
                        p, self._actor_init_error
                    )
                }
            instance = self._actor_instance
            method = getattr(instance, p["method"])
            args, kwargs = await self._resolve_args(p)
            loop = asyncio.get_running_loop()
            pginfo = self._actor_pg
            t_exec0 = time.time()
            # Named concurrency group (set by @ray_tpu_torch.method): its own
            # thread pool + semaphore instead of the actor-wide defaults.
            group = getattr(method, "_ray_tpu_method_opts", {}).get(
                "concurrency_group"
            )
            grp = self._concurrency_groups.get(group) if group else None
            if group and grp is None:
                # A typo here would silently void the isolation the user
                # configured (the reference raises too).
                raise ValueError(
                    f"method {p['method']!r} names unknown concurrency "
                    f"group {group!r} (declared: "
                    f"{sorted(self._concurrency_groups) or 'none'})"
                )
            executor = grp["executor"] if grp else self._executor
            semaphore = grp["semaphore"] if grp else self._actor_semaphore

            def run_method():
                from ray_tpu_torch.util import tracing

                with tracing.execution_scope(p.get("trace_ctx")):
                    with _bind_ambient_pg(pginfo):
                        return method(*args, **kwargs)

            try:
                if p.get("streaming"):
                    advance()
                    results = await self._execute_streaming(
                        p,
                        method,
                        args,
                        kwargs,
                        pginfo,
                        executor,
                        semaphore=(
                            semaphore
                            if asyncio.iscoroutinefunction(method)
                            or inspect.isasyncgenfunction(method)
                            else None
                        ),
                    )
                    return {
                        "results": results,
                        "exec": self._exec_span(t_exec0),
                    }
                if asyncio.iscoroutinefunction(method):
                    advance()  # start-order satisfied; allow interleaving
                    async with semaphore:
                        with _bind_ambient_pg(pginfo):
                            result = await method(*args, **kwargs)
                else:
                    advance()  # executor thread serializes sync methods
                    result = await loop.run_in_executor(
                        executor, run_method
                    )
                results = self._encode_results(p, result)
                await self._flush_created(results)
                return {"results": results, "exec": self._exec_span(t_exec0)}
            except Exception as e:  # noqa: BLE001
                return {
                    "results": self._error_results(p, e),
                    "exec": self._exec_span(t_exec0),
                }
        finally:
            advance()

    async def _resolve_args(self, p) -> tuple[tuple, dict]:
        # Deserialization runs OFF the endpoint loop: reconstructors may
        # block (DeviceRef fetches issue their own RPCs through this very
        # loop), and big unpickles would stall every RPC this process
        # serves either way.
        loop = asyncio.get_running_loop()

        def loads_off_loop(data):
            return serialization.loads(data)[0]

        async def decode(item):
            kind, payload = item[0], item[1]
            if kind == "v":
                return await loop.run_in_executor(
                    None, loads_off_loop, payload
                )
            ref: ObjectRef = payload
            data = await self._fetch_payload(ref, None)
            return await loop.run_in_executor(None, loads_off_loop, data)

        args = await asyncio.gather(*(decode(a) for a in p["args"]))
        kw_items = list(p["kwargs"].items())
        kw_values = await asyncio.gather(*(decode(v) for _, v in kw_items))
        return tuple(args), {k: v for (k, _), v in zip(kw_items, kw_values)}

    def _encode_results(self, p, result) -> list:
        return_ids = p["return_ids"]
        if len(return_ids) == 1:
            values = [result]
        else:
            values = list(result)
            if len(values) != len(return_ids):
                raise ValueError(
                    f"task {p['name']} returned {len(values)} values, "
                    f"expected {len(return_ids)}"
                )
        return [
            self._encode_one(oid, value)
            for oid, value in zip(return_ids, values)
        ]

    def _encode_one(self, oid: str, value) -> tuple:
        """("inline", bytes | FramedPayload) or ("location", node_id,
        size, oid) — small values ride the reply; big ones are sealed into
        this node's shm. An inline FramedPayload travels the reply frame
        as out-of-band segments: the result's array data goes from the
        executor's buffers to the socket without ever being flattened."""
        payload, _ = serialization.dumps_oob(value)
        framed = isinstance(payload, serialization.FramedPayload)
        size = payload.nbytes if framed else len(payload)
        if size <= GLOBAL_CONFIG.max_inline_object_bytes:
            if framed and not GLOBAL_CONFIG.rpc_scatter_gather_enabled:
                return ("inline", payload.to_bytes())  # round-7 flatten
            if framed:
                # snapshot(): the raw payload views the executor's LIVE
                # value; an actor returning a view of its own state could
                # mutate it from the next pipelined call before the reply
                # frame flushes. One bounded (<= inline cap) copy detaches
                # the reply; it stays segmented, so the send is still
                # flatten-free.
                return ("inline", payload.snapshot())
            return ("inline", payload)
        if framed:
            self.shm_writer.write_framed(oid, payload)
        else:
            self.shm_writer.write(oid, payload)
        return ("location", self.node_id, size, oid)

    async def _flush_created(self, results: list) -> None:
        """Tell our node about sealed shm objects BEFORE the reply releases
        the owner to hand out the location (avoids a pull/adopt race). A
        multi-return task's notifications ride one completions_batch
        frame instead of one RPC per sealed object."""
        created = [
            {"oid": res[3], "size": res[2]}
            for res in results
            if res[0] == "location"
        ]
        if not created:
            return
        if len(created) == 1 or not GLOBAL_CONFIG.rpc_coalesce_enabled:
            # Kill switch honors config.py's promise: the "off" arm is
            # fully unbatched (one object_created RPC per sealed object).
            for c in created:
                await self.endpoint.acall(
                    self.node_addr, "node.object_created", c
                )
            return
        await self.endpoint.acall(
            self.node_addr, "node.completions_batch", {"created": created}
        )

    def _error_results(self, p, exc: Exception) -> list:
        if isinstance(exc, TaskCancelledError):
            # Surface cancellation as-is (get() raises TaskCancelledError,
            # not a generic task failure).
            err: Exception = TaskCancelledError(
                f"task {p['name']} was cancelled"
            )
        else:
            tb = traceback.format_exc()
            err = TaskError(p["name"], tb, cause=_safe_exc(exc))
        return [("error", err) for _ in p["return_ids"]]

    async def _h_worker_cancel_task(self, conn, p):
        """Best-effort interrupt of a running task (reference:
        core_worker.proto CancelTask). The task id is always recorded as
        cancelled, so a task still in its arg-resolve window aborts at
        execution start. A sync fn already running gets TaskCancelledError
        raised in its executing thread via the CPython async-exception
        mechanism (fires at the next bytecode boundary — a task blocked in
        native code is interrupted only when it returns to Python); a
        coroutine fn gets its asyncio task cancelled. Force exits the worker
        process — but only if the target task is actually still here (a
        cancel racing completion must not kill a healthy worker that may
        already run someone else's task).

        Delivery is ACKNOWLEDGED, not fire-and-forget: for a sync fn the
        reply is held until the interrupted task's run() actually exits
        (or a short deadline passes — the fn may be wedged in native code),
        so the owner's cancel() returning means the interrupt RESOLVED
        rather than "was sent". This is what makes cancellation testable
        without sleep races (round-2 verdict weak #5)."""
        task_id = p["task_id"]
        coro_task = self._running_async.get(task_id)
        ack: threading.Event | None = None
        with self._cancel_lock:
            self._cancelled_tasks.add(task_id)
            tid = self._running_tasks.get(task_id)
            if tid is not None and not p.get("force"):
                import ctypes

                ack = self._interrupt_done.setdefault(
                    task_id, threading.Event()
                )
                ctypes.pythonapi.PyThreadState_SetAsyncExc(
                    ctypes.c_ulong(tid), ctypes.py_object(TaskCancelledError)
                )
                self._interrupt_sent = task_id
        if p.get("force"):
            if tid is None and coro_task is None:
                return {"cancelled": False}  # not here (anymore)
            asyncio.get_running_loop().call_later(0.05, os._exit, 1)
            return {"cancelled": True, "forced": True}
        if coro_task is not None:
            coro_task.cancel()
            return {"cancelled": True}
        if ack is not None:
            # Wait (off-loop) for the interrupt to land; a task blocked in
            # native code can't be interrupted — report delivered=False so
            # the owner knows only force can stop it.
            delivered = await asyncio.get_running_loop().run_in_executor(
                None, ack.wait, 5.0
            )
            self._interrupt_done.pop(task_id, None)
            return {"cancelled": True, "delivered": bool(delivered)}
        return {"cancelled": tid is not None}

    async def _h_worker_flightrec(self, conn, p):
        """This process's flight-recorder rings (tools/trace_export.py
        collects one snapshot per process and merges them on the wall
        anchor each snapshot carries)."""
        from ray_tpu_torch.util import flightrec

        return flightrec.snapshot(planes=p.get("planes"))

    async def _h_worker_shutdown(self, conn, p):
        asyncio.get_running_loop().call_later(0.05, os._exit, 0)
        return True

    async def _h_worker_ping(self, conn, p):
        return {"worker_id": self.worker_id, "actor_id": self._actor_id}


class _ActorSubmitter:
    """Per-actor ordered, pipelined task submission with restart-aware resend.

    Reference parity: the ActorTaskSubmitter's per-actor queues + sequence
    numbers (src/ray/core_worker/task_submission/actor_task_submitter.h).
    Design: sequence numbers are an (epoch, seq) pair where epoch bumps on
    every actor restart. Tasks are sent pipelined (no await between sends) on
    one connection, so arrival order matches submission order; the executing
    side buffers by seq. On connection loss, unacked + queued tasks are
    resent in original order with fresh seqs under the new epoch.
    """

    def __init__(self, worker: "CoreWorker", actor_id: str):
        self.worker = worker
        self.actor_id = actor_id
        self.queue: list[TaskSpec] = []
        self.unacked: dict[str, TaskSpec] = {}  # task_id -> spec (send order)
        self.addr: tuple | None = None
        # incarnation bumps on every (re)connect; it namespaces the seq
        # counter so the executing side always sees a fresh, 0-based ordered
        # stream after any reconnect/restart (server buffers by caller key).
        self.incarnation = 0
        self.seq = 0
        self._sender_active = False
        self._reconnecting = False

    def enqueue(self, spec: TaskSpec) -> None:
        self.queue.append(spec)
        self._pump()

    def _pump(self) -> None:
        if self._sender_active or self._reconnecting:
            return
        self._sender_active = True
        spawn(self._send_loop(), name="actor send loop")

    async def _send_loop(self) -> None:
        try:
            while self.queue and not self._reconnecting:
                if self.addr is None:
                    if not await self._resolve():
                        return
                    continue  # re-check state after the await
                addr = self.addr
                spec = self.queue.pop(0)
                seq = self.seq
                self.seq += 1
                self.unacked[spec.task_id] = spec
                payload = self._payload(spec, seq)
                try:
                    conn = await self.worker.endpoint.connect(addr)
                    fut = asyncio.ensure_future(
                        conn.request("worker.push_task", payload)
                    )
                except (ConnectionLost, ConnectionError, OSError):
                    await self._on_disconnect()
                    continue
                fut.add_done_callback(
                    lambda f, s=spec: spawn(
                        self._on_reply(s, f), name="actor reply apply"
                    )
                )
        finally:
            self._sender_active = False

    def _payload(self, spec: TaskSpec, seq: int) -> dict:
        return {
            "task_id": spec.task_id,
            "name": spec.name,
            "actor_id": spec.actor_id,
            "method": spec.method,
            "seq": seq,
            # Key the executing side's ordering buffer by (submitter, actor,
            # incarnation) so distinct handles/actors never share a counter.
            "caller": (
                f"{self.worker.worker_id}:{self.actor_id}:{self.incarnation}"
            ),
            "args": spec.args,
            "kwargs": spec.kwargs,
            "return_ids": spec.return_ids,
            "owner_addr": tuple(self.worker.endpoint.address),
            "trace_ctx": spec.trace_ctx,
            "streaming": spec.streaming,
        }

    async def _on_reply(self, spec: TaskSpec, fut: asyncio.Future) -> None:
        exc = fut.exception() if not fut.cancelled() else ConnectionLost()
        if exc is None:
            if spec.task_id in self.unacked:
                del self.unacked[spec.task_id]
                # raylint: disable=RL001 -- done-callback context: fut completed (exception() above returned None), so result() cannot block
                self.worker._apply_task_reply(spec, fut.result())
            return
        if isinstance(exc, (ConnectionLost, ConnectionError, OSError)):
            await self._on_disconnect()
        else:
            # Application-level error from the RPC layer: fail just this task.
            if spec.task_id in self.unacked:
                del self.unacked[spec.task_id]
                await self.worker._fail_task(spec, exc)

    async def _on_disconnect(self) -> None:
        if self._reconnecting:
            return
        self._reconnecting = True
        self.addr = None
        # In-flight tasks: reference semantics — actor tasks are NOT retried
        # unless max_task_retries was set (they may have side effects and may
        # already have executed). Queued-but-unsent tasks are safe to send to
        # the restarted actor.
        pending = list(self.unacked.values())
        self.unacked.clear()
        retry = []
        for spec in pending:
            if spec.retries_left > 0:
                spec.retries_left -= 1
                retry.append(spec)
            else:
                await self.worker._fail_task(
                    spec,
                    ActorDiedError(
                        f"actor task {spec.name} failed: actor "
                        f"{self.actor_id[:8]} died while the call was in "
                        f"flight (set max_task_retries to retry)"
                    ),
                )
        self.queue = retry + self.queue
        try:
            ok = await self._resolve()
        finally:
            self._reconnecting = False
        if ok:
            self._pump()

    async def _resolve(self) -> bool:
        """Find the actor's current address (waiting out restarts). On DEAD,
        fail everything. Returns True if the actor is reachable."""
        try:
            deadline = time.monotonic() + 10.0
            while True:
                try:
                    info = await self.worker.gcs.acall(
                        "wait_actor_alive",
                        {"actor_id": self.actor_id, "timeout": 120.0},
                    )
                    break
                except ValueError:
                    # Creation was registered asynchronously (async-context
                    # create_actor) and hasn't reached the GCS yet.
                    if time.monotonic() > deadline:
                        raise
                    await asyncio.sleep(0.05)
        except Exception as e:
            err = e if isinstance(e, ActorDiedError) else ActorDiedError(
                f"actor {self.actor_id[:8]}: {e}"
            )
            for spec in list(self.unacked.values()) + self.queue:
                await self.worker._fail_task(spec, err)
            self.unacked.clear()
            self.queue.clear()
            return False
        self.addr = tuple(info["addr"])
        self.incarnation += 1
        self.seq = 0
        return True


def _safe_exc(exc: Exception) -> Exception:
    """Return an exception safe to pickle (fall back to repr)."""
    try:
        cloudpickle.loads(cloudpickle.dumps(exc))
        return exc
    except Exception:
        return RuntimeError(repr(exc))
