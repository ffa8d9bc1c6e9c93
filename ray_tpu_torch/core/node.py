"""NodeManager — per-node daemon: worker pool, leases, object plane, health.
Port of ``ray_tpu/core/node.py``: workers are ``ray_tpu_torch.core.worker_main``
processes; opt-in worker cgroups are not ported yet.

Reference parity: the raylet (src/ray/raylet/node_manager.h:140) with its
WorkerPool (worker_pool.h:280), lease-based scheduling
(cluster_lease_manager.h:41 — grant local or spill back to the caller with a
better node), node-to-node object transfer (src/ray/object_manager/
object_manager.h:128), and worker-death detection. Redesigned: one asyncio
service, shm-file object plane (no fd passing), resource gossip by heartbeat
through the GCS instead of a dedicated syncer stream.
"""

from __future__ import annotations

import asyncio
import os
import socket
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Optional

from ray_tpu_torch.core import faults
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.core.errors import (
    FaultInjectedError,
    NotPortedError,
    SchedulingError,
)
from ray_tpu_torch.core.ids import NodeID, WorkerID
from ray_tpu_torch.core.object_store import ShmObjectStore, default_shm_root
from ray_tpu_torch.core.protocol import Endpoint
from ray_tpu_torch.core.sched_index import FeasibilityIndex
from ray_tpu_torch.core.scheduler import (
    NodeView,
    SchedulerMetrics,
    SchedulingRequest,
    SuspectStamper,
    add,
    any_feasible,
    fits,
    labels_match,
    pick_node,
    subtract,
)
from ray_tpu_torch.util.metrics import declare_runtime_metric
from ray_tpu_torch.util.tasks import spawn

# The directory that holds the ray_tpu_torch package (put on workers'
# PYTHONPATH).
_PACKAGE_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

# Node-level series (beyond the worker/cpu gauges of earlier rounds):
# object-plane occupancy and churn, plus the heartbeat-piggyback saving.
_NODE_METRIC_META = {
    "raytpu_node_workers": declare_runtime_metric(
        "raytpu_node_workers", "gauge",
        "worker processes on this node", layer="core",
    ),
    "raytpu_node_object_store_bytes": declare_runtime_metric(
        "raytpu_node_object_store_bytes", "gauge",
        "bytes resident in the shm object store", layer="core",
    ),
    "raytpu_node_cpu_available": declare_runtime_metric(
        "raytpu_node_cpu_available", "gauge",
        "unleased CPU resource", layer="core",
    ),
    "raytpu_object_store_objects": declare_runtime_metric(
        "raytpu_object_store_objects", "gauge",
        "objects tracked by the shm store (resident + spilled)",
        layer="core",
    ),
    "raytpu_object_store_capacity_bytes": declare_runtime_metric(
        "raytpu_object_store_capacity_bytes", "gauge",
        "configured shm store capacity", layer="core",
    ),
    "raytpu_object_store_spills_total": declare_runtime_metric(
        "raytpu_object_store_spills_total", "counter",
        "blobs evicted from shm to the disk spill tier", layer="core",
    ),
    "raytpu_object_store_spilled_bytes_total": declare_runtime_metric(
        "raytpu_object_store_spilled_bytes_total", "counter",
        "bytes evicted from shm to the disk spill tier", layer="core",
    ),
    "raytpu_object_store_restores_total": declare_runtime_metric(
        "raytpu_object_store_restores_total", "counter",
        "spilled blobs restored into shm on access", layer="core",
    ),
    "raytpu_object_store_deletes_total": declare_runtime_metric(
        "raytpu_object_store_deletes_total", "counter",
        "objects freed from the shm store", layer="core",
    ),
    "raytpu_gcs_piggyback_frames_saved_total": declare_runtime_metric(
        "raytpu_gcs_piggyback_frames_saved_total", "counter",
        "metric/log RPCs folded into heartbeat envelopes instead of "
        "riding their own frames",
        layer="core",
    ),
    "raytpu_drain_objects_migrated_total": declare_runtime_metric(
        "raytpu_drain_objects_migrated_total", "counter",
        "sole-copy (primary) objects pushed to healthy peers during a "
        "graceful drain — each one is a lineage reconstruction the "
        "cluster did NOT have to pay after the node died",
        layer="core",
    ),
}

IDLE = "idle"
LEASED = "leased"
ACTOR = "actor"
STARTING = "starting"


def _pg_of_demand(resources: dict) -> str | None:
    """If the demand targets placement-group formatted resources, the pg id
    (the last ``_``-separated token of a ``bundle_group*`` key)."""
    for k in resources:
        if k.startswith("bundle_group_"):
            return k.rsplit("_", 1)[-1]
    return None


@dataclass
class WorkerInfo:
    worker_id: str
    proc: Optional[subprocess.Popen] = None
    addr: tuple | None = None
    state: str = STARTING
    actor_ids: list = field(default_factory=list)
    ready: asyncio.Event = field(default_factory=asyncio.Event)
    idle_since: float = 0.0  # monotonic time it last entered the idle pool
    env_hash: str = ""  # runtime-env identity; pool reuse must match


@dataclass
class Lease:
    lease_id: str
    worker_id: str
    resources: dict
    pg_id: str | None = None
    granted_at: float = field(default_factory=time.monotonic)


class NodeManager:
    def __init__(
        self,
        gcs_addr: tuple,
        resources: dict,
        labels: dict | None = None,
        session_id: str | None = "session",
        name: str = "node",
        env: dict | None = None,
    ):
        self.node_id = NodeID.random().hex()
        self.gcs_addr = tuple(gcs_addr)
        # session_id=None means "join an existing cluster": the session is
        # fetched from the GCS in start() (reference: ray start --address,
        # scripts.py:682) and the shm store is created then.
        self.session_id = session_id
        self.total = dict(resources)
        self.available = dict(resources)
        self.labels = dict(labels or {})
        self.name = name
        self.extra_env = dict(env or {})
        self.endpoint = Endpoint(f"node-{name}")
        self.shm_root: str | None = None
        self.store: ShmObjectStore | None = None
        if session_id is not None:
            self._make_store()
        self.workers: dict[str, WorkerInfo] = {}
        self.idle_workers: list[str] = []
        self.leases: dict[str, Lease] = {}
        # placement-group bundles: (pg_id, index) -> original resources
        self.bundle_reservations: dict[tuple, dict] = {}
        self.committed_bundles: dict[tuple, dict] = {}
        self._pg_state_cache: dict[str, tuple] = {}  # pg_id -> (ts, pending)
        self.cluster_view: dict[str, NodeView] = {}
        self.view_meta: dict[str, dict] = {}
        # Feasibility index over the gossiped view (round 19): spill /
        # spread decisions sample a bounded candidate set instead of
        # scanning every peer. Maintained incrementally by the delta
        # application below (shape/label transitions only); the
        # GLOBAL_CONFIG.sched_index kill switch gates the read path.
        self._view_index = FeasibilityIndex(self.cluster_view)
        # Peers reported suspect by drivers whose direct RPCs to them
        # tripped a breaker (node.peer_suspect), with a TTL matching the
        # breaker's half-open window; merged with this endpoint's OWN
        # breaker verdicts when stamping views before placement decisions.
        self._suspect_until: dict[tuple, float] = {}
        self._suspect_stamper = SuspectStamper(
            lambda: bool(self._suspect_until or self.endpoint._breakers),
            self._addr_suspect,
        )
        # request_lease idempotency dedup: req_id -> (ts, reply future).
        # A transport retry of an in-flight lease request attaches to the
        # original grant instead of double-granting (see _h_request_lease).
        self._lease_reply_cache: dict[str, tuple] = {}
        # req_ids the client abandoned (cancel_lease_request): a chaos-
        # delayed retry of a cancelled attempt that lands AFTER the cancel
        # must not re-grant — nobody will ever consume or cancel it again.
        self._lease_cancel_tombstones: dict[str, float] = {}
        self._pending_leases: list = []  # (req, future, deadline)
        self._idle_waiters: list = []  # futures waiting for an idle worker
        self._terminated_procs: list = []  # reaped, awaiting exit collection
        self._inflight_pulls: dict[str, asyncio.Future] = {}
        # Transfer admission control (reference: push_manager.h /
        # pull_manager.h): bound concurrent chunk SERVES (a broadcast of one
        # hot object to N nodes queues here instead of stampeding this
        # node's store + loop) and concurrent distinct-object PULLS.
        self._serve_slots = asyncio.Semaphore(
            GLOBAL_CONFIG.object_serve_concurrency
        )
        self._pull_slots = asyncio.Semaphore(
            GLOBAL_CONFIG.object_pull_concurrency
        )
        # Opt-in cgroup isolation for worker processes (reference:
        # src/ray/common/cgroup2/cgroup_manager.h) is not ported yet.
        if GLOBAL_CONFIG.enable_worker_cgroups:
            raise NotPortedError("worker cgroups (enable_worker_cgroups)")
        self._spread_rr = 0
        self._last_view_refresh = 0.0
        self._view_since = -1  # versioned-delta cursor (-1: nothing seen)
        self._tasks: list = []
        self._stopping = False
        self._resources_freed = False
        # Graceful drain (SIGTERM / injected preemption / gcs.drain_node):
        # while draining, no new leases are granted locally (demand spills
        # or queues) and the self-drain task migrates primary objects +
        # restartable actors off this node before it dies.
        self._draining = False
        self._drain_task: asyncio.Future | None = None
        self._drain_migrated = 0  # primary objects pushed to peers
        # Observability: worker-pushed metric snapshots + worker log tails
        # (reference: metrics_agent.py per-node aggregation; log_monitor.py)
        self._worker_metric_snaps: dict[str, dict] = {}
        self._log_offsets: dict[str, int] = {}
        self.log_dir: str | None = None
        self.sched_metrics = SchedulerMetrics()
        # Heartbeat piggybacking (ROADMAP): metric snapshots and log
        # batches ride the periodic heartbeat envelope instead of their own
        # node->GCS streams. The log monitor stages batches here; the
        # heartbeat flushes them and attaches metrics when the report
        # interval elapses.
        self._pending_log_batches: list = []
        # Monotonic id stamped on every staged log batch: the heartbeat
        # restage path makes log delivery at-least-once, and the GCS drops
        # batches whose id it has already processed (see _h_node_heartbeat)
        # so subscribers never see duplicates.
        self._log_batch_seq = 0
        self._last_metrics_report = 0.0
        self._piggyback_saved = 0
        # Injectable for tests (simulate pressure without consuming RAM).
        self._memory_usage_fn = self._memory_usage_fraction
        for n in [n for n in dir(self) if n.startswith("_h_")]:
            self.endpoint.register("node." + n[3:], getattr(self, n))

    # -- lifecycle -----------------------------------------------------------

    def _make_store(self) -> None:
        self.shm_root = default_shm_root(self.session_id, self.node_id)
        self.store = ShmObjectStore(
            self.shm_root, GLOBAL_CONFIG.object_store_bytes
        )

    def start(self) -> tuple:
        addr = self.endpoint.start()
        if self.session_id is None:
            info = self.endpoint.call(self.gcs_addr, "gcs.get_session", {})
            self.session_id = info["session_id"]
            # The head's config is cluster-authoritative (config.py promises
            # consistency): apply BEFORE creating the store, whose capacity
            # is config-driven.
            GLOBAL_CONFIG.apply_json(info["config"])
            self._make_store()
        reply = self.endpoint.call(
            self.gcs_addr,
            "gcs.register_node",
            {
                "node_id": self.node_id,
                "addr": addr,
                "resources": self.total,
                "labels": self.labels,
                "shm_root": self.shm_root,
                "hostname": socket.gethostname(),
                "session_id": self.session_id,
                # Initial store gauges, so the memory governor sees this
                # node's capacity from registration (not first heartbeat).
                "store": self._store_gauges(),
            },
        )
        if reply["session_id"] != self.session_id:
            raise RuntimeError(
                f"node joined GCS from a different session "
                f"({reply['session_id']} != {self.session_id}) — stale "
                f"address reused after a head restart? Restart this node "
                f"without an explicit session."
            )
        # NB: not named "ray_tpu_torch" — a directory with the package's name
        # under /tmp becomes an importable namespace package that shadows
        # the real one for any script executed from /tmp.
        self.log_dir = os.path.join(
            tempfile.gettempdir(), "raytpu-sessions", self.session_id, "logs"
        )
        os.makedirs(self.log_dir, exist_ok=True)
        # Metric snapshots and log batches piggyback on the heartbeat loop
        # (one node->GCS stream), so there is no dedicated metrics RPC loop.
        self._tasks.append(self.endpoint.submit(self._heartbeat_loop()))
        self._tasks.append(self.endpoint.submit(self._worker_monitor_loop()))
        self._tasks.append(self.endpoint.submit(self._log_monitor_loop()))
        self._tasks.append(self.endpoint.submit(self._memory_monitor_loop()))
        return addr

    def stop(self, kill_workers: bool = True) -> None:
        self._stopping = True
        for t in self._tasks:
            t.cancel()
        if kill_workers:
            for w in self.workers.values():
                if w.proc is not None and w.proc.poll() is None:
                    w.proc.kill()
            for w in self.workers.values():
                if w.proc is not None:
                    try:
                        w.proc.wait(timeout=5)
                    except Exception:  # raylint: disable=RL006 -- worker proc wait during stop; SIGKILL path already ran
                        pass
        self.endpoint.stop()
        if self.store is not None:  # join-mode node that never started
            self.store.close()

    def die_silently(self) -> None:
        """Simulate abrupt node death (for FT tests): stop everything without
        telling the GCS; death is detected via heartbeat timeout."""
        self._stopping = True
        for t in self._tasks:
            t.cancel()
        for w in self.workers.values():
            if w.proc is not None and w.proc.poll() is None:
                w.proc.kill()
        self.endpoint.stop()

    # -- graceful drain -------------------------------------------------------
    # Preemption-aware shutdown (reference: gcs_service.proto DrainNode +
    # the raylet's graceful-drain deadline). A preemptible TPU VM gets a
    # SIGTERM + grace window before it dies; instead of wasting the notice
    # (post-mortem lineage reconstruction, cold actor restarts), the node
    # self-drains: no new leases, sole-copy primary objects pushed to
    # healthy peers over the ordinary transfer-chunk path (spilled
    # primaries restore transparently on the way out — their disk tier
    # dies with the node too), restartable actors restarted elsewhere
    # while the submitters' restart-aware resend keeps callers whole, and
    # running tasks given the remainder of the window to finish.

    def drain(
        self,
        grace_s: float | None = None,
        reason: str = "drained",
        wait: bool = True,
    ) -> bool:
        """Sync entry point (SIGTERM handlers, tests): start a self-
        initiated drain and optionally block until it retires the node
        (bounded by the grace window plus margin)."""
        grace = (
            GLOBAL_CONFIG.drain_grace_s if grace_s is None else float(grace_s)
        )
        started = self.endpoint.submit(
            self._begin_drain(grace, reason)
        ).result(timeout=30)
        if started and wait:
            deadline = time.monotonic() + grace + 10.0
            while not self._stopping and time.monotonic() < deadline:
                time.sleep(0.05)
        return started

    async def _begin_drain(self, grace_s: float, reason: str) -> bool:
        """Self-initiated drain (SIGTERM, injected preemption): tell the
        GCS to mark us DRAINING (it arms the deadline enforcer but does
        not call back — we are already draining), then run the self-drain.
        Zero grace means graceful drain is disabled: ask for the immediate
        force kill, exactly the pre-drain behavior."""
        if self._draining or self._stopping:
            return False
        self._draining = True
        if grace_s <= 0:
            try:
                await self.endpoint.acall(
                    self.gcs_addr,
                    "gcs.drain_node",
                    {"node_id": self.node_id, "reason": reason,
                     "force": True, "self_initiated": True},
                )
            except Exception:  # raylint: disable=RL006 -- heartbeat-timeout death is the fallback
                pass  # heartbeat-timeout death is the fallback
            self._retire()
            return True
        try:
            await self.endpoint.acall(
                self.gcs_addr,
                "gcs.drain_node",
                {"node_id": self.node_id, "reason": reason,
                 "grace_s": grace_s, "self_initiated": True},
            )
        except Exception:  # raylint: disable=RL006 -- still drain best-effort; heartbeat death is the fallback
            pass  # still drain best-effort; heartbeat death is the fallback
        self._drain_task = spawn(
            self._self_drain(grace_s, reason), name="self drain"
        )
        return True

    async def _h_drain(self, conn, p):
        """GCS-initiated drain (gcs.drain_node forwards here), or the
        zero-grace death notice of the force path."""
        grace = p.get("grace_s")
        if grace is None:
            grace = GLOBAL_CONFIG.drain_grace_s
        reason = p.get("reason") or "drained"
        if grace <= 0:
            self._draining = True
            self._retire()
            return {"draining": False, "retired": True}
        if not self._draining:
            self._draining = True
            self._drain_task = spawn(
                self._self_drain(float(grace), reason), name="self drain"
            )
        return {"draining": True}

    async def _chaos_preempt(self) -> None:
        """Fault-injection hook (node.preempt): a seeded, replayable
        preemption notice. ``ms`` overrides the grace window; otherwise
        ``drain_grace_s`` applies (0 = graceful drain disabled, i.e. the
        instant-kill fallback the acceptance criteria compare against)."""
        if self._draining or self._stopping:
            return
        rule = faults._ACTIVE.decide(
            "node", self.name, actions=frozenset({"preempt"})
        )
        if rule is None:
            return
        grace = (
            rule.delay_s
            if rule.delay_s > 0
            else GLOBAL_CONFIG.drain_grace_s
        )
        await self._begin_drain(grace, "preempted")

    async def _self_drain(self, grace_s: float, reason: str) -> None:
        """The node side of the drain protocol, bounded by the grace
        deadline: migrate primary objects, move restartable actors, let
        running tasks finish, then report drain_complete and retire. A
        drain that cannot finish inside the window retires WITHOUT the
        completion report — the GCS deadline enforcer then fires the
        mark-dead force fallback (counted in
        raytpu_drain_deadline_forced_total)."""
        deadline = time.monotonic() + grace_s
        clean = False
        try:
            await self._migrate_primary_objects(deadline)
            try:
                moved = await self.endpoint.acall(
                    self.gcs_addr,
                    "gcs.restart_node_actors",
                    {"node_id": self.node_id, "reason": reason},
                )
            except Exception:  # raylint: disable=RL006 -- GCS unreachable mid-drain: actors restart post-mortem instead
                moved = []
            self._retire_actor_workers(moved)
            # Running tasks AND live non-restartable actors get whatever
            # remains of the grace window. The actor wait is the
            # preemption-handoff seam: a non-restartable actor's owner
            # (e.g. the elastic train controller resharding a paused
            # gang's state off this node) needs the DRAINING view to stay
            # up until it releases the actor — retiring the moment our own
            # bookkeeping is done would turn every preemption notice into
            # an instant kill. The drain completes the moment the last
            # such actor is released; an unclaimed actor rides to the
            # deadline and the GCS force fallback closes the drain.
            while time.monotonic() < deadline:
                pending = False
                for lease in self.leases.values():
                    w = self.workers.get(lease.worker_id)
                    if w is None:
                        continue
                    if not w.actor_ids:
                        pending = True  # running task finishing out
                        break
                    if w.proc is None or w.proc.poll() is None:
                        pending = True  # live actor awaiting owner handoff
                        break
                if not pending:
                    clean = True
                    break
                await asyncio.sleep(0.05)
        except Exception:  # raylint: disable=RL006 -- retire below either way; the GCS deadline is the backstop
            pass  # retire below either way; the GCS deadline is the backstop
        if clean:
            try:
                await self.endpoint.acall(
                    self.gcs_addr,
                    "gcs.drain_complete",
                    {"node_id": self.node_id, "reason": reason},
                )
            except Exception:  # raylint: disable=RL006 -- drain_complete notify best-effort; the GCS deadline closes the drain
                pass
        self._retire()

    async def _migrate_primary_objects(self, deadline: float) -> None:
        """Push every sealed primary blob to a healthy peer via the
        existing transfer-chunk path (the peer pulls from us), then report
        the moves so owners resolve the migrated copy instead of paying a
        lineage reconstruction. No healthy peer = nothing to do: the
        objects fall back to post-mortem reconstruction like before."""
        if self.store is None:
            return
        await self._refresh_cluster_view(force=True)
        self._stamp_suspects()
        targets = [
            v
            for nid, v in self.cluster_view.items()
            if nid != self.node_id
            and v.alive
            and not v.draining
            and not v.suspect
        ]
        if not targets:
            return

        def adopt_stragglers():
            # Sealed files are ground truth: a worker may have sealed a
            # blob whose object_created/completions notification has not
            # reached us yet (a drain can start in that window). Local
            # seals are primaries by definition — sweep them in before
            # enumerating, or the freshest objects are exactly the ones
            # the drain misses.
            try:
                names = os.listdir(self.shm_root)
            except OSError:
                return
            for name in names:
                if name.endswith((".tmp", ".restore")):
                    continue
                if not self.store.contains(name):
                    try:
                        self.store.adopt(
                            name,
                            os.path.getsize(
                                os.path.join(self.shm_root, name)
                            ),
                        )
                    except OSError:
                        continue

        await self._store_call(adopt_stragglers)
        primaries = await self._store_call(self.store.primary_objects)
        moves: list = []
        rr = 0

        async def push_one(oid: str, size: int, target) -> None:
            nonlocal moves
            try:
                await self.endpoint.acall(
                    target.addr,
                    "node.pull_object",
                    {
                        "oid": oid,
                        "from_addr": tuple(self.endpoint.address),
                        "size": size,
                    },
                )
            except Exception:  # raylint: disable=RL006 -- this object reconstructs post-mortem
                return  # this object reconstructs post-mortem
            moves.append((oid, target.node_id))
            self._drain_migrated += 1

        # Waves of 4 concurrent pushes: parallel enough to beat the grace
        # window on real object counts, bounded enough not to stampede one
        # peer's pull admission control.
        wave: list = []
        for oid, size in primaries:
            if time.monotonic() >= deadline:
                break
            wave.append(push_one(oid, size, targets[rr % len(targets)]))
            rr += 1
            if len(wave) >= 4:
                await asyncio.gather(*wave)
                wave = []
        if wave:
            await asyncio.gather(*wave)
        if moves:
            try:
                await self.endpoint.acall(
                    self.gcs_addr, "gcs.report_migrations", {"moves": moves}
                )
            except Exception:  # raylint: disable=RL006 -- migration report lost with the link; owners fall back to reconstruction
                pass

    def _retire_actor_workers(self, moved) -> None:
        """Kill the stale local incarnations of actors the GCS just
        restarted elsewhere, WITHOUT a worker-death report: the record
        already points at the new worker, and a report would ask the GCS
        to fail the fresh restart a second time. Submitters reconnect via
        wait_actor_alive on the broken connection."""
        moved = set(moved or [])
        if not moved:
            return
        for wid, w in list(self.workers.items()):
            if not moved.intersection(w.actor_ids):
                continue
            self.workers.pop(wid, None)
            self._worker_metric_snaps.pop(wid, None)
            if w.proc is not None and w.proc.poll() is None:
                w.proc.kill()
                self._terminated_procs.append(w.proc)
            for lid, lease in list(self.leases.items()):
                if lease.worker_id == wid:
                    add(self.available, lease.resources)
                    del self.leases[lid]

    def _retire(self) -> None:
        """Post-drain: stop participating in the cluster. Loops stop (no
        more heartbeats — re-registering would resurrect a zombie the
        drain just retired) and workers die, but the endpoint keeps
        serving: peers may still be reading the last migrated chunks, and
        in-process harnesses stop() the manager properly later."""
        if self._stopping:
            return
        self._stopping = True
        for t in self._tasks:
            t.cancel()
        for w in self.workers.values():
            if w.proc is not None and w.proc.poll() is None:
                w.proc.kill()

    # -- loops ---------------------------------------------------------------

    def _piggyback_payload(self) -> dict:
        """Metric snapshots + staged log batches for the next heartbeat
        envelope. Each attached section replaces one RPC frame the old
        dedicated streams would have sent — counted in
        raytpu_gcs_piggyback_frames_saved_total."""
        extra: dict = {}
        now = time.monotonic()
        if (
            now - self._last_metrics_report
            >= GLOBAL_CONFIG.metrics_report_interval_s
        ):
            self._last_metrics_report = now
            # Only hand-built node series + worker-pushed snapshots travel.
            # The process REGISTRY is deliberately absent: every process
            # with a registry (driver included) pushes it through its own
            # CoreWorker, and in-process clusters share this process
            # between node manager and driver — attaching registry()
            # here double-counted every driver-side counter.
            snaps = [self._own_metric_snapshot()]
            snaps.extend(self._worker_metric_snaps.values())
            extra["metrics"] = snaps
            self._piggyback_saved += 1
        if self._pending_log_batches:
            extra["logs"], self._pending_log_batches = (
                self._pending_log_batches,
                [],
            )
            self._piggyback_saved += 1
        return extra

    def _store_gauges(self) -> dict | None:
        """Object-store occupancy for registration + every heartbeat (one
        stats() lock hold): the memory governor's arbitration signal."""
        if self.store is None:
            return None
        st = self.store.stats()
        return {
            "used_bytes": st["used_bytes"],
            "capacity_bytes": st["capacity_bytes"],
            "spills": st["spills"],
        }

    async def _heartbeat_loop(self):
        while not self._stopping:
            # Stage the beat's one-shot cargo OUTSIDE the try: a dropped
            # beat (5s deadline makes that routine under GCS stalls) must
            # re-stage it for the next interval, not lose it — heartbeat
            # piggybacking is the ONLY transport for log batches, and the
            # freed-resources edge triggers pending-lease re-scheduling.
            freed, self._resources_freed = self._resources_freed, False
            prev_metrics_report = self._last_metrics_report
            extra = self._piggyback_payload()
            restaged = False

            def _restage_cargo():
                # Once per beat: the ok-False path restages and then
                # re-registers, and if THAT raises, the outer except calls
                # here again — a second run would extend the pending-log
                # list with itself, duplicating every staged batch.
                nonlocal restaged
                if restaged:
                    return
                restaged = True
                # The beat's cargo never landed: put it back. Logs prepend
                # ahead of anything staged meanwhile (order preserved);
                # metric sections re-cut fresh next beat (worker snaps
                # live in _worker_metric_snaps and are read, not drained);
                # a freed edge survives unless a new one already fired.
                self._resources_freed = freed or self._resources_freed
                if "logs" in extra:
                    extra["logs"].extend(self._pending_log_batches)
                    self._pending_log_batches = extra["logs"]
                if "metrics" in extra:
                    self._last_metrics_report = prev_metrics_report

            # Object-store occupancy rides every beat: the data-plane
            # memory governor (data/governor.py) arbitrates task
            # submission on these gauges, so they must be as fresh as the
            # resource view (one stats() lock hold per interval).
            store_stats = self._store_gauges()
            try:
                # retries=0: a retried heartbeat carries STALE state —
                # the loop's next interval sends a fresh one, which both
                # arrives sooner than a third deadline-burning resend and
                # reports current availability. (The method stays on the
                # idempotency allowlist for any out-of-band caller.)
                ok = await self.endpoint.acall(
                    self.gcs_addr,
                    "gcs.node_heartbeat",
                    retries=0,
                    payload={
                        "node_id": self.node_id,
                        "available": self.available,
                        "total": self.total,
                        "store": store_stats,
                        "resources_freed": freed,
                        # Queued lease demand this node cannot serve right
                        # now — the autoscaler's scale-up signal (reference:
                        # ResourceDemandScheduler reads cluster load).
                        "pending_demand": [
                            dict(req.resources)
                            for req, _, _ in self._pending_leases[:100]
                        ],
                        "idle": not self.leases
                        and not self._pending_leases
                        and self._task_worker_count() == 0,
                        **extra,
                    },
                )
                if ok is False:
                    if self._draining:
                        # The GCS declared us dead because we are DRAINING
                        # toward death (drain complete / deadline expired).
                        # Re-registering would resurrect a zombie the drain
                        # protocol just retired — stop heartbeating for
                        # good instead.
                        return
                    # The GCS does not know us (it restarted, or declared
                    # us dead across a partition) and dropped the beat's
                    # piggybacked sections unprocessed — re-stage them for
                    # the first post-re-register beat.
                    _restage_cargo()
                    # The GCS does not know us: it restarted from durable
                    # storage (reference: NotifyGCSRestart,
                    # node_manager.proto:454) — re-register and resume.
                    # session_id travels so a DIFFERENT cluster that reused
                    # the address rejects us (we then stop heartbeating:
                    # this node is an orphan of a dead session).
                    self._view_since = -1  # new version epoch: full resync
                    try:
                        await self.endpoint.acall(
                            self.gcs_addr,
                            "gcs.register_node",
                            {
                                "node_id": self.node_id,
                                "addr": self.endpoint.address,
                                "resources": self.total,
                                "labels": self.labels,
                                "shm_root": self.shm_root,
                                "hostname": socket.gethostname(),
                                "session_id": self.session_id,
                            },
                        )
                    except Exception as e:
                        if "session mismatch" in str(e):
                            return  # orphaned: stop heartbeating for good
                        raise
            except Exception:
                _restage_cargo()
            await self._refresh_cluster_view(force=True)
            await asyncio.sleep(GLOBAL_CONFIG.resource_report_interval_s)

    async def _refresh_cluster_view(self, force: bool = False):
        # Throttled: a gang of pending lease retries must not turn into a
        # full-cluster-view RPC per retry against the GCS.
        now = time.monotonic()
        if not force and now - self._last_view_refresh < 1.0:
            return
        self._last_view_refresh = now
        try:
            # Versioned delta sync: only nodes whose state changed since
            # our last seen version travel (VERDICT weak #5: full-view
            # polling was O(nodes^2) cluster-wide per interval).
            reply = await self.endpoint.acall(
                self.gcs_addr,
                "gcs.get_cluster_view",
                {"since": self._view_since},
            )
            self._view_since = reply["version"]
            if reply.get("full"):
                # Full resync replaces the view: a merge would keep nodes
                # that vanished across a GCS restart alive=True forever.
                self.cluster_view = {}
                self.view_meta = {}
            for nid, v in reply["changed"].items():
                cur = self.cluster_view.get(nid)
                if cur is None:
                    cur = NodeView(
                        node_id=nid,
                        addr=tuple(v["addr"]),
                        total=v["total"],
                        available=v["available"],
                        labels=v["labels"],
                        alive=v["alive"],
                        draining=v.get("draining", False),
                    )
                    self.cluster_view[nid] = cur
                else:
                    # In-place application (round 19): mutate the existing
                    # view instead of allocating a fresh one per changed
                    # node per refresh. suspect resets to False exactly as
                    # a fresh NodeView's default would — the stamper
                    # re-derives it before any placement decision.
                    cur.addr = tuple(v["addr"])
                    cur.total = v["total"]
                    cur.available = v["available"]
                    cur.labels = v["labels"]
                    cur.alive = v["alive"]
                    cur.draining = v.get("draining", False)
                    cur.suspect = False
                self.view_meta[nid] = {"shm_root": v.get("shm_root")}
                if not reply.get("full"):
                    if cur.alive:
                        self._view_index.upsert(cur)
                    else:
                        self._view_index.remove(nid)
            if reply.get("full"):
                # cluster_view was REPLACED above — rebind the index to
                # the new dict (it indexes by reference).
                self._view_index.reset(self.cluster_view)
            if reply["changed"] and self._pending_leases:
                # A changed cluster (e.g. a NEW node) can unblock queued
                # requests that were infeasible everywhere — re-evaluate
                # now instead of letting them sit out their deadline.
                await self._drain_pending()
        except Exception:  # raylint: disable=RL006 -- lease-queue drain after worker death; next scheduling tick re-drains
            pass

    async def _worker_monitor_loop(self):
        while not self._stopping:
            await asyncio.sleep(GLOBAL_CONFIG.worker_poll_interval_s)
            if faults._ACTIVE is not None:
                self._chaos_kill_worker()
                await self._chaos_preempt()
            for wid, w in list(self.workers.items()):
                if w.proc is not None and w.proc.poll() is not None:
                    await self._on_worker_death(wid, f"exit {w.proc.returncode}")
            self._reap_idle_workers()
            self._collect_terminated()

    def _chaos_kill_worker(self) -> None:
        """Fault-injection hook (node.kill_worker): kill one LEASED task
        worker, chosen deterministically from the rule's own stream. The
        death flows through the ordinary reap-and-retry path — that path
        surviving randomized kill schedules is what the chaos suite
        asserts. Actor workers are exempt here (actor restart policy has
        its own chaos coverage via die_silently/kill)."""
        rule = faults._ACTIVE.decide(
            "node", self.name, actions=frozenset({"kill_worker"})
        )
        if rule is None:
            return
        victims = sorted(
            {
                lease.worker_id
                for lease in self.leases.values()
                if lease.worker_id in self.workers
                and self.workers[lease.worker_id].proc is not None
                and not self.workers[lease.worker_id].actor_ids
            }
        )
        if not victims:
            return
        info = self.workers[rule.choice(victims)]
        try:
            info.proc.kill()
        except OSError:
            pass
        # The monitor loop's poll sweep (this very tick) reaps the corpse.

    def _reap_idle_workers(self) -> None:
        """Kill workers idle past their TTL, keeping a warm floor so the
        next burst doesn't pay a cold start (reference: worker_pool
        idle-worker killing)."""
        ttl = GLOBAL_CONFIG.idle_worker_ttl_s
        now = time.monotonic()
        # Oldest-idle first; stop at the warm floor.
        reapable = sorted(
            (wid for wid in self.idle_workers),
            key=lambda wid: self.workers[wid].idle_since,
        )
        for wid in reapable:
            if len(self.idle_workers) <= GLOBAL_CONFIG.min_idle_workers:
                return
            w = self.workers[wid]
            if now - w.idle_since < ttl:
                return  # the rest are younger
            self.idle_workers.remove(wid)
            del self.workers[wid]
            if w.proc is not None and w.proc.poll() is None:
                w.proc.terminate()
                # Collect the exit status later (no zombie accumulation in
                # long-lived daemons); monitor loop polls this list.
                self._terminated_procs.append(w.proc)

    def _collect_terminated(self) -> None:
        self._terminated_procs = [
            p for p in self._terminated_procs if p.poll() is None
        ]

    async def _on_worker_death(self, worker_id: str, reason: str):
        w = self.workers.pop(worker_id, None)
        if w is None:
            return
        self._worker_metric_snaps.pop(worker_id, None)
        if worker_id in self.idle_workers:
            self.idle_workers.remove(worker_id)
        # A death frees cap headroom: wake cap waiters so they re-check and
        # spawn instead of sleeping out the full start timeout.
        while self._idle_waiters:
            fut = self._idle_waiters.pop(0)
            if not fut.done():
                fut.set_result(None)
        for lid, lease in list(self.leases.items()):
            if lease.worker_id == worker_id:
                add(self.available, lease.resources)
                del self.leases[lid]
                self._resources_freed = True
        if w.actor_ids:
            try:
                await self.endpoint.acall(
                    self.gcs_addr,
                    "gcs.report_worker_death",
                    {
                        "node_id": self.node_id,
                        "worker_id": worker_id,
                        "actor_ids": w.actor_ids,
                        "reason": reason,
                    },
                )
            except Exception:  # raylint: disable=RL006 -- worker-death report on a dying GCS link; heartbeat divergence covers it
                pass
        await self._drain_pending()

    # -- worker pool ---------------------------------------------------------

    def _spawn_worker(self, runtime_env: dict | None = None) -> WorkerInfo:
        worker_id = WorkerID.random().hex()
        env = dict(os.environ)
        env.update(self.extra_env)
        env["RAY_TPU_WORKER_ID"] = worker_id
        # Cluster-authoritative config (this node already synced with the
        # head's) — workers must not fall back to their own env defaults.
        env["RAY_TPU_INTERNAL_CONFIG"] = GLOBAL_CONFIG.to_json()
        # The worker imports the same ray_tpu_torch as this node, wherever
        # the driver was started from.
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_PACKAGE_ROOT, env.get("PYTHONPATH")) if p
        )
        proc = subprocess.Popen(
            [
                sys.executable,
                "-m",
                "ray_tpu_torch.core.worker_main",
                "--node-addr",
                f"{self.endpoint.address[0]}:{self.endpoint.address[1]}",
                "--gcs-addr",
                f"{self.gcs_addr[0]}:{self.gcs_addr[1]}",
                "--node-id",
                self.node_id,
                "--shm-root",
                self.shm_root,
                "--session-id",
                self.session_id,
            ],
            env=env,
            stdout=(out_f := self._worker_log_file(worker_id, "out")),
            stderr=(err_f := self._worker_log_file(worker_id, "err")),
        )
        # Popen dup'd the fds into the child; drop the parent's copies.
        for f in (out_f, err_f):
            if hasattr(f, "close"):
                f.close()
        info = WorkerInfo(
            worker_id=worker_id,
            proc=proc,
            env_hash=(runtime_env or {}).get("hash", ""),
        )
        self.workers[worker_id] = info
        return info

    def _worker_log_file(self, worker_id: str, stream: str):
        """Per-worker log files tailed by the log monitor and published to
        the driver (reference: worker log redirection + log_monitor.py).
        Set RAY_TPU_WORKER_LOG_INHERIT=1 to keep logs on the node's tty."""
        if os.environ.get("RAY_TPU_WORKER_LOG_INHERIT"):
            return subprocess.DEVNULL if stream == "out" and os.environ.get(
                "RAY_TPU_SILENCE_WORKERS"
            ) else None
        path = self._worker_log_path(worker_id, stream)
        if path is None:
            return None
        return open(path, "ab", buffering=0)

    def _worker_log_path(self, worker_id: str, stream: str) -> "str | None":
        """THE naming convention for captured worker streams — shared by
        the write side (_worker_log_file) and the dashboard read RPC."""
        if self.log_dir is None:
            return None
        return os.path.join(
            self.log_dir, f"worker-{worker_id[:12]}.{stream}"
        )

    def _worker_cap(self) -> int:
        cap = GLOBAL_CONFIG.max_worker_processes
        if cap <= 0:
            cap = max(4, 2 * (os.cpu_count() or 1))
        return cap

    def _task_worker_count(self) -> int:
        """Spawned processes currently serving (or about to serve) TASKS.
        Actor workers left the pool for good and don't count against the
        cap, nor do driver registrations (proc is None)."""
        return sum(
            1
            for w in self.workers.values()
            if w.proc is not None and w.state in (STARTING, IDLE, LEASED)
        )

    def _notify_idle(self) -> None:
        while self._idle_waiters and self.idle_workers:
            fut = self._idle_waiters.pop(0)
            if not fut.done():
                fut.set_result(None)

    def _pop_idle_matching(self, env_hash: str) -> Optional[WorkerInfo]:
        """Claim an idle worker whose runtime-env identity matches."""
        for i in range(len(self.idle_workers) - 1, -1, -1):
            wid = self.idle_workers[i]
            info = self.workers.get(wid)
            if info is None:
                self.idle_workers.pop(i)
                continue
            if info.env_hash == env_hash:
                self.idle_workers.pop(i)
                return info
        return None

    async def _get_idle_worker(
        self, for_actor: bool = False, runtime_env: dict | None = None
    ) -> WorkerInfo:
        """Claim an idle worker, spawning one if the pool is below its cap.
        At the cap, wait for a lease to return a worker instead — an
        unbounded pool fork-bombs the host on task bursts, and extra
        processes beyond ~2x cores only add GIL/context-switch overhead.
        Actors bypass the cap: they keep their worker for life, so making
        them wait for task workers to free would deadlock."""
        deadline = (
            asyncio.get_running_loop().time()
            + GLOBAL_CONFIG.worker_start_timeout_s
        )
        env_hash = (runtime_env or {}).get("hash", "")
        while True:
            match = self._pop_idle_matching(env_hash)
            if match is not None:
                return match
            at_cap = self._task_worker_count() >= self._worker_cap()
            if at_cap and self.idle_workers and not for_actor:
                # (actors bypass the cap entirely — evicting a warm task
                # worker for them would be pure waste)
                # Pool full of OTHER-env idle workers: evict one to make
                # room (reference: idle workers with mismatched runtime
                # envs are killed rather than starving the new env).
                victim = self.workers.get(self.idle_workers.pop(0))
                if victim is not None:
                    self.workers.pop(victim.worker_id, None)
                    if victim.proc is not None and victim.proc.poll() is None:
                        victim.proc.kill()
                        self._terminated_procs.append(victim.proc)
                at_cap = False
            if for_actor or not at_cap:
                info = self._spawn_worker(runtime_env)
                try:
                    await asyncio.wait_for(
                        info.ready.wait(),
                        GLOBAL_CONFIG.worker_start_timeout_s,
                    )
                except asyncio.TimeoutError:
                    if info.proc is not None:
                        info.proc.kill()
                    self.workers.pop(info.worker_id, None)
                    raise SchedulingError("worker failed to start in time")
                # Registration put the new worker in the idle pool; we are
                # claiming it, so take it back out (else the next lease
                # steals it).
                if info.worker_id in self.idle_workers:
                    self.idle_workers.remove(info.worker_id)
                return info
            fut = asyncio.get_running_loop().create_future()
            self._idle_waiters.append(fut)
            remaining = deadline - asyncio.get_running_loop().time()
            if remaining <= 0:
                raise SchedulingError(
                    "no worker became available within the start timeout "
                    f"(pool at cap {self._worker_cap()})"
                )
            try:
                await asyncio.wait_for(fut, timeout=remaining)
            except asyncio.TimeoutError:
                raise SchedulingError(
                    "no worker became available within the start timeout "
                    f"(pool at cap {self._worker_cap()})"
                )

    async def _h_register_worker(self, conn, p):
        info = self.workers.get(p["worker_id"])
        if info is None:
            # Worker we did not spawn (e.g. driver registering) — track it.
            info = WorkerInfo(worker_id=p["worker_id"])
            self.workers[p["worker_id"]] = info
        info.addr = tuple(p["addr"])
        if p.get("kind") == "driver":
            info.state = "driver"
        else:
            info.state = IDLE
            info.idle_since = time.monotonic()
            self.idle_workers.append(info.worker_id)
            self._notify_idle()
        info.ready.set()
        return {
            "node_id": self.node_id,
            "shm_root": self.shm_root,
            "session_id": self.session_id,
        }

    async def _h_unregister_worker(self, conn, p):
        """Remove a registration we did not spawn (drivers connecting via
        init(address=...)). Long-lived daemons would otherwise accumulate a
        dead WorkerInfo per driver session forever; spawned workers are NOT
        removable this way — their lifecycle belongs to the pool."""
        info = self.workers.get(p["worker_id"])
        if info is not None and info.proc is None and info.state == "driver":
            del self.workers[p["worker_id"]]
            return True
        return False

    async def _h_worker_unreachable(self, conn, p):
        """An owner's push RPC to this node's worker failed (connection
        lost). If the process is really dead, reap it immediately instead of
        waiting for the monitor poll — otherwise the idle pool keeps handing
        the dead worker to retries."""
        info = self.workers.get(p["worker_id"])
        if info is not None and info.proc is not None:
            if info.proc.poll() is not None:
                await self._on_worker_death(
                    p["worker_id"], f"exit {info.proc.returncode}"
                )
                return True
        return False

    async def _h_kill_worker(self, conn, p):
        info = self.workers.get(p["worker_id"])
        if info is None or info.proc is None:
            return False
        info.proc.kill()
        await self._on_worker_death(p["worker_id"], "killed")
        return True

    # -- leases --------------------------------------------------------------

    @staticmethod
    def _req_of_payload(p) -> SchedulingRequest:
        return SchedulingRequest(
            resources=p.get("resources", {}),
            label_selector=p.get("label_selector", {}),
            soft_label_selector=p.get("soft_label_selector", {}),
            policy=p.get("policy", "hybrid"),
            runtime_env=p.get("runtime_env") or {},
        )

    async def _h_request_lease(self, conn, p):
        if faults._ACTIVE is not None:
            rule = faults._ACTIVE.decide(
                "node", self.name, actions=frozenset({"lease_delay"})
            )
            if rule is not None and rule.delay_s > 0:
                await asyncio.sleep(rule.delay_s)
        # Idempotency dedup: request_lease is on the transport retry
        # allowlist, and a retry whose original attempt is still mid-grant
        # (worker spawn, queueing) must ATTACH to that attempt — a second
        # independent grant would leak a lease + its resources every time
        # a reply is lost or a deadline fires mid-spawn. The client sends
        # one req_id per logical attempt, reused across transport retries.
        return await self._lease_dedup(
            p, self._request_lease_impl, lambda: {"cancelled": True}
        )

    async def _lease_dedup(self, p, impl, tombstone_reply):
        """The req_id dedup bracket shared by request_lease and
        request_lease_batch: tombstone check, reply-cache attach (shielded
        — a cancelled duplicate must not kill the original grant), future
        creation + sweep, and the set_result/set_exception bookkeeping.
        One implementation on purpose: the tombstone-before-cache ordering
        and consumed-exception dance are the double-grant guard, and a fix
        applied to only one lease path would silently re-open the window
        on the other."""
        req_id = p.get("req_id")
        if not req_id:
            return await impl(p)
        if req_id in self._lease_cancel_tombstones:
            # The client already abandoned this logical attempt (its
            # cancel overtook this delayed/retried frame); granting now
            # would leak the lease — no consumer, no second cancel.
            return tombstone_reply()
        ent = self._lease_reply_cache.get(req_id)
        if ent is not None:
            return await asyncio.shield(ent[1])
        fut = asyncio.get_running_loop().create_future()
        self._lease_reply_cache[req_id] = (time.monotonic(), fut)
        if len(self._lease_reply_cache) > 256:
            self._sweep_lease_cache()
        try:
            reply = await impl(p)
        except BaseException as e:
            if not fut.done():
                fut.set_exception(e)
                fut.exception()  # consumed: a retry may never arrive
            raise
        if not fut.done():
            fut.set_result(reply)
        return reply

    @staticmethod
    def _lease_cache_ttl() -> float:
        # Entries must outlive the WORST-CASE transport-retried schedule —
        # attempts * (dial + deadline) + backoff, measured from the first
        # attempt's ARRIVAL — or a late retry misses the cache and
        # double-grants the lease the dedup exists to stop.
        cfg = GLOBAL_CONFIG
        return (
            (cfg.rpc_max_retries + 1)
            * (cfg.rpc_slow_deadline_s + cfg.rpc_connect_timeout_s)
            + cfg.rpc_max_retries * cfg.rpc_retry_backoff_max_s
        )

    def _sweep_lease_cache(self) -> None:
        cut = time.monotonic() - self._lease_cache_ttl()
        stale = []
        for rid, (ts, fut) in self._lease_reply_cache.items():
            if ts >= cut:
                break  # insertion-ordered by ts: everything later is fresh
            if fut.done():
                stale.append(rid)
        for rid in stale:
            del self._lease_reply_cache[rid]
        # Hard memory bound: a busy node grants leases far faster than the
        # TTL retires them (hundreds/s against a multi-minute window), and
        # every entry pins its reply dict. Past the cap, evict the oldest
        # SETTLED entries early; that re-opens the double-grant window only
        # for a transport retry of an attempt >4096 grants old that is
        # somehow still in flight — and only if its reply frame was also
        # lost, since a delivered reply means no retry ever comes.
        over = len(self._lease_reply_cache) - 4096
        if over > 0:
            for rid, (_, fut) in list(self._lease_reply_cache.items()):
                if over <= 0:
                    break
                if fut.done():
                    del self._lease_reply_cache[rid]
                    over -= 1

    async def _h_cancel_lease_request(self, conn, p):
        """The client abandoned this logical lease attempt (every
        transport retry deadlined; it re-requests from home under a FRESH
        req_id), so no caller will ever consume this req_id's reply. If
        the in-flight grant completes anyway — the classic case is a
        target whose event loop stalled past the deadline but is otherwise
        healthy — return the lease on the spot instead of leaking its
        worker and resources until node death."""
        req_id = p.get("req_id", "")
        if req_id:
            # Tombstone first, unconditionally: a chaos-delayed transport
            # retry of this req_id may still be in flight and land after
            # the pop below — without the tombstone it would miss the
            # cache and grant a lease nobody consumes or cancels.
            self._lease_cancel_tombstones[req_id] = time.monotonic()
            if len(self._lease_cancel_tombstones) > 256:
                cut = time.monotonic() - self._lease_cache_ttl()
                for rid, ts in list(self._lease_cancel_tombstones.items()):
                    if ts >= cut:
                        break  # insertion-ordered: everything later is fresh
                    del self._lease_cancel_tombstones[rid]
        ent = self._lease_reply_cache.pop(req_id, None)
        if ent is None:
            return False
        fut = ent[1]

        def _return_orphan(f):
            if f.cancelled() or f.exception() is not None:
                return
            reply = f.result()
            # request_lease caches a single grant dict; request_lease_batch
            # caches the whole wave's list — return every granted entry.
            entries = reply if isinstance(reply, list) else [reply]
            freed = False
            for r in entries:
                if isinstance(r, dict) and "lease_id" in r:
                    freed |= self._return_one_lease(r["lease_id"])
            if freed:
                spawn(self._drain_pending(), name="orphan lease drain")

        fut.add_done_callback(_return_orphan)  # fires now if already done
        return True

    async def _request_lease_impl(self, p):
        req = self._req_of_payload(p)
        t0 = time.monotonic()
        deadline = t0 + GLOBAL_CONFIG.lease_request_timeout_s
        if not GLOBAL_CONFIG.metrics_enabled:
            return await self._lease_or_spill(req, deadline)
        sm = self.sched_metrics
        try:
            reply = await self._lease_or_spill(req, deadline)
        except Exception:
            sm.errors += 1
            raise
        # Wait = arrival to grant, queueing included (the SLO number an
        # operator reads to see scheduling pressure); spills/retries are
        # counted, not timed — the granting node times them.
        if "lease_id" in reply:
            sm.granted += 1
            sm.lease_wait.observe(time.monotonic() - t0)
        elif "spill" in reply:
            sm.spilled += 1
        return reply

    async def _h_request_lease_batch(self, conn, p):
        """N identical lease requests in ONE frame (the driver->node leg of
        the coalescing tier: a deep queue's lease wave rides one RPC).

        Only plain, immediately-grantable entries resolve here — the rest
        return ``{"fallback": True}`` and the caller re-issues them as
        individual (server-side queueing) request_lease calls. Entries must
        never queue inside the batch: the combined reply would make an
        early grant wait on a contended sibling, which deadlocks when the
        sibling's resources are freed by the early grant's own task.

        Rides the same req_id reply-cache as _h_request_lease so a
        deadline-abandoned batch (cancel_lease_request) returns every
        granted lease instead of leaking the whole wave's resources."""
        return await self._lease_dedup(
            p,
            self._request_lease_batch_impl,
            lambda: [{"fallback": True}] * max(1, int(p.get("count", 1))),
        )

    async def _request_lease_batch_impl(self, p):
        req = self._req_of_payload(p)
        n = max(1, int(p.get("count", 1)))
        plain = (
            req.policy == "hybrid"
            and not req.soft_label_selector
            and not self._draining  # draining: no new grants; entries
            # fall back to individual request_lease, which spills/queues
            and labels_match(self.labels, req.label_selector)
        )
        coros = []
        for _ in range(n):
            if plain and fits(self.available, req.resources):
                # Reserve synchronously so each fits() sees the prior
                # entries' demand; the grants then spawn workers
                # concurrently.
                subtract(self.available, req.resources)
                coros.append(self._grant(req, pre_reserved=True))
            else:
                coros.append(None)
        t0 = time.monotonic()
        granted = await asyncio.gather(
            *(c for c in coros if c is not None), return_exceptions=True
        )
        it = iter(granted)
        out = []
        for c in coros:
            if c is None:
                out.append({"fallback": True})
                continue
            r = next(it)
            out.append({"error": r} if isinstance(r, BaseException) else r)
        if GLOBAL_CONFIG.metrics_enabled:
            sm = self.sched_metrics
            wait = time.monotonic() - t0
            for r in out:
                if isinstance(r, dict) and "lease_id" in r:
                    sm.granted += 1
                    sm.lease_wait.observe(wait)
                elif isinstance(r, dict) and "error" in r:
                    sm.errors += 1
        return out

    def _addr_suspect(self, addr) -> bool:
        """A peer is suspect while this endpoint's OWN breaker to it is
        tripped, or while a driver-reported suspicion (node.peer_suspect)
        is inside its TTL. Both self-heal: the breaker half-opens and the
        TTL expires, so a recovered node starts taking leases again
        without any explicit un-suspect signal."""
        addr = tuple(addr)
        if self.endpoint.peer_suspect(addr):
            return True
        until = self._suspect_until.get(addr)
        if until is None:
            return False
        if time.monotonic() >= until:
            del self._suspect_until[addr]
            return False
        return True

    def _stamp_suspects(self) -> None:
        """Refresh the cluster view's suspect flags from this endpoint's
        breakers merged with driver-reported suspects (_suspect_until)
        before a placement decision (see scheduler.SuspectStamper)."""
        self._suspect_stamper.stamp(self.cluster_view.values())

    async def _h_peer_suspect(self, conn, p):
        """A driver's direct RPCs to the given peer tripped its breaker
        (e.g. a spill target that accepts connections but never replies).
        Remember it for one breaker window so THIS node's scheduler stops
        spilling leases there — the degradation the breaker buys is 'stop
        placing work on the suspect', not an exception storm."""
        self._suspect_until[tuple(p["addr"])] = (
            time.monotonic() + GLOBAL_CONFIG.rpc_breaker_reset_s
        )
        return True

    async def _lease_or_spill(self, req: SchedulingRequest, deadline: float):
        self._stamp_suspects()
        if self._draining:
            # A draining node takes no NEW leases (running work keeps its
            # grace window): hand the demand to a healthy peer, or have
            # the caller queue/retry — by the time it gives up, either a
            # replacement registered or the cluster is really out of
            # capacity.
            spill = self._try_spill(req)
            if spill is not None:
                return spill
            return {"retry_after": 0.2}
        local_ok = labels_match(self.labels, req.label_selector)
        soft_target_is_self = False
        if req.policy.startswith(("node_affinity:", "strict_node_affinity:")):
            target = req.policy.split(":", 1)[1]
            strict = req.policy.startswith("strict")
            soft_target_is_self = not strict and target == self.node_id
            if target != self.node_id:
                view = self.cluster_view.get(target)
                if view is None:
                    await self._refresh_cluster_view(force=True)
                    view = self.cluster_view.get(target)
                alive = view is not None and view.alive
                if strict:
                    # A just-registered target can lag our delta-synced view
                    # by a heartbeat; wait out the lag (up to the lease
                    # deadline) ONLY while the view has never seen the node
                    # (view None). A present-but-dead view is the GCS saying
                    # the node died — fail fast. Unforced refreshes share
                    # the 1s throttle, so K waiters cost one GCS RPC/s
                    # total, not 5K/s.
                    while view is None and time.monotonic() < deadline:
                        await asyncio.sleep(0.2)
                        await self._refresh_cluster_view()
                        view = self.cluster_view.get(target)
                    alive = view is not None and view.alive
                    if not alive:
                        raise SchedulingError(
                            f"node {target} for strict affinity is gone"
                        )
                    return {"spill": tuple(view.addr)}
                # Soft affinity: forward only if the target could ever take
                # the demand — otherwise fall through to hybrid here, so the
                # request doesn't ping-pong between us and a full target.
                if (
                    alive
                    and fits(view.total, req.resources)
                    and labels_match(view.labels, req.label_selector)
                ):
                    return {"spill": tuple(view.addr)}
                # target gone or infeasible — fall through to hybrid
        if req.policy == "spread":
            # Round-robin over all feasible nodes (including us). The
            # index path is bit-identical for spread (bucket filtering
            # only drops nodes the scan rejects anyway, and the candidate
            # order is the same sorted-by-node-id list).
            self._spread_rr += 1
            if GLOBAL_CONFIG.sched_index:
                choice = self._view_index.pick(
                    req, self.node_id, self._spread_rr
                )
            else:
                choice = pick_node(req, self.node_id, self.cluster_view,
                                   self._spread_rr)
            if choice is not None and choice != self.node_id:
                return {"spill": tuple(self.cluster_view[choice].addr)}
            # fall through: grant locally (or queue) below
        if local_ok and fits(self.available, req.resources):
            # Soft label preference: if we don't match the preferred labels
            # but a peer that does can take the work now, send it there.
            if req.soft_label_selector and not labels_match(
                self.labels, req.soft_label_selector
            ):
                preferred = self._try_spill(req, require_soft=True)
                if preferred is not None:
                    return preferred
            return await self._grant(req)
        # Not local: consult cluster view for a node that fits now. When we
        # ARE a soft-affinity target that will eventually fit, prefer
        # queueing here over spilling away (the point of the affinity).
        if not (
            soft_target_is_self
            and local_ok
            and fits(self.total, req.resources)
        ):
            spill = self._try_spill(req)
            if spill is not None:
                return spill
        # Feasible here eventually? queue. Feasible anywhere? tell caller to
        # retry later; else hard error.
        if local_ok and fits(self.total, req.resources):
            fut = asyncio.get_running_loop().create_future()
            self._pending_leases.append((req, fut, deadline))
            try:
                return await asyncio.wait_for(
                    fut, max(0.0, deadline - time.monotonic())
                )
            except asyncio.TimeoutError:
                raise SchedulingError(
                    f"lease timed out waiting for {req.resources}"
                )
        # Strict affinity never falls back: if the target node can never fit
        # the demand, fail fast instead of spinning on retry_after.
        if req.policy.startswith("strict_node_affinity:"):
            target = req.policy.split(":", 1)[1]
            view = self.cluster_view.get(target)
            if target == self.node_id:
                view = NodeView(self.node_id, (), self.total, {}, self.labels)
            if (
                view is None
                or not view.alive
                or not fits(view.total, req.resources)
                or not labels_match(view.labels, req.label_selector)
            ):
                raise SchedulingError(
                    f"strict affinity node {target} cannot ever fit "
                    f"{req.resources}"
                )
            return {"retry_after": 0.2}
        if any_feasible(req, self.cluster_view):
            return {"retry_after": 0.2}
        # The gossiped view may be stale (e.g. a placement-group bundle was
        # committed on a peer, or a brand-new node registered, since our
        # last heartbeat) — force one refresh from the GCS before declaring
        # the request infeasible. This is the last chance before a hard
        # error, so the throttle must not apply.
        await self._refresh_cluster_view(force=True)
        spill = self._try_spill(req)
        if spill is not None:
            return spill
        if any_feasible(req, self.cluster_view):
            return {"retry_after": 0.2}
        # A demand targeting a placement group that exists but is not yet
        # CREATED stays pending (the reference queues such leases until the
        # bundles commit) rather than failing hard. The verdict is cached
        # briefly so a gang of pending tasks doesn't hammer the GCS.
        pg_id = _pg_of_demand(req.resources)
        if pg_id is not None and await self._pg_is_pending(pg_id):
            return {"retry_after": 0.2}
        raise SchedulingError(
            f"no feasible node: resources={req.resources} "
            f"selector={req.label_selector}"
        )

    async def _pg_is_pending(self, pg_id: str) -> bool:
        """True if the placement group exists and is not REMOVED (cached for
        one report interval)."""
        now = time.monotonic()
        cached = self._pg_state_cache.get(pg_id)
        if cached is not None and now - cached[0] < 1.0:
            return cached[1]
        try:
            info = await self.endpoint.acall(
                self.gcs_addr, "gcs.get_placement_group", {"pg_id": pg_id}
            )
        except Exception:  # raylint: disable=RL006 -- pg liveness probe; cache keeps the last verdict until the GCS answers
            info = None
        verdict = info is not None and info["state"] != "REMOVED"
        self._pg_state_cache[pg_id] = (now, verdict)
        return verdict

    def _try_spill(
        self, req: SchedulingRequest, require_soft: bool = False
    ) -> dict | None:
        """Pick a peer that fits the request now, or None. With
        ``require_soft``, only peers matching the soft label selector
        qualify (used to honor the preference over a local grant)."""
        self._stamp_suspects()
        self._spread_rr += 1
        if GLOBAL_CONFIG.sched_index and not require_soft:
            # Indexed path: exclude ourselves in place of the dict copy
            # (the copy alone is O(peers) per spill at fleet scale).
            choice = self._view_index.pick(
                req, "", self._spread_rr, exclude=self.node_id
            )
        else:
            # require_soft hard-filters candidates by the soft selector —
            # a rare local-preference branch; the scan stays its engine.
            views = dict(self.cluster_view)
            views.pop(self.node_id, None)
            if require_soft:
                views = {
                    nid: v
                    for nid, v in views.items()
                    if labels_match(v.labels, req.soft_label_selector)
                }
            choice = pick_node(req, "", views, self._spread_rr)
        if choice is not None:
            return {"spill": tuple(self.cluster_view[choice].addr)}
        return None

    async def _grant(
        self,
        req: SchedulingRequest,
        for_actor: bool = False,
        pre_reserved: bool = False,
    ):
        if not pre_reserved:
            subtract(self.available, req.resources)
        try:
            info = await self._get_idle_worker(
                for_actor=for_actor, runtime_env=req.runtime_env
            )
        except Exception:
            add(self.available, req.resources)
            raise
        info.state = LEASED
        lease = Lease(
            WorkerID.random().hex(),
            info.worker_id,
            req.resources,
            pg_id=_pg_of_demand(req.resources),
        )
        self.leases[lease.lease_id] = lease
        return {
            "lease_id": lease.lease_id,
            "worker_addr": info.addr,
            "worker_id": info.worker_id,
        }

    def _return_one_lease(self, lease_id: str) -> bool:
        lease = self.leases.pop(lease_id, None)
        if lease is None:
            return False
        add(self.available, lease.resources)
        self._resources_freed = True
        info = self.workers.get(lease.worker_id)
        if info is not None and info.state == LEASED:
            info.state = IDLE
            info.idle_since = time.monotonic()
            self.idle_workers.append(info.worker_id)
            self._notify_idle()
        return True

    async def _h_return_lease(self, conn, p):
        ok = self._return_one_lease(p["lease_id"])
        if ok:
            await self._drain_pending()
        return ok

    async def _h_return_lease_batch(self, conn, p):
        """A whole drain wave's lease returns in one frame; pending leases
        re-evaluate once, against all the freed resources at once."""
        out = [self._return_one_lease(lid) for lid in p["lease_ids"]]
        if any(out):
            await self._drain_pending()
        return out

    async def _drain_pending(self):
        # Snapshot-and-clear FIRST: drains can run concurrently (lease
        # returns, worker deaths, view changes), and two drains holding the
        # same entry would double-grant it across the _grant await (leaking
        # a LEASED worker + its resources). Each entry belongs to exactly
        # one drain; requests that stay unserved are appended back, which
        # preserves entries queued meanwhile.
        todo, self._pending_leases = self._pending_leases, []
        still = []
        for req, fut, deadline in todo:
            if fut.done():
                continue
            if time.monotonic() > deadline:
                fut.set_exception(
                    SchedulingError(f"lease timed out for {req.resources}")
                )
            elif labels_match(self.labels, req.label_selector) and fits(
                self.available, req.resources
            ):
                try:
                    fut.set_result(await self._grant(req))
                except Exception as e:
                    if not fut.done():
                        fut.set_exception(e)
            else:
                still.append((req, fut, deadline))
        self._pending_leases.extend(still)

    # -- placement-group bundles ---------------------------------------------
    # Node side of the GCS 2PC (reference:
    # src/ray/raylet/placement_group_resource_manager.h): prepare reserves
    # the original resources; commit converts the reservation into formatted
    # pg resources added to this node's total/available.

    async def _h_prepare_bundles(self, conn, p):
        pg_id = p["pg_id"]
        taken = []
        for b in p["bundles"]:
            if fits(self.available, b["resources"]):
                subtract(self.available, b["resources"])
                taken.append(b)
            else:
                for t in taken:
                    add(self.available, t["resources"])
                return False
        for b in taken:
            self.bundle_reservations[(pg_id, b["index"])] = dict(
                b["resources"]
            )
        return True

    def _release_reservations(self, pg_id: str) -> None:
        """Return all uncommitted 2PC reservations of a group to the pool."""
        for key in [k for k in self.bundle_reservations if k[0] == pg_id]:
            add(self.available, self.bundle_reservations.pop(key))

    async def _h_cancel_bundles(self, conn, p):
        self._release_reservations(p["pg_id"])
        self._resources_freed = True
        await self._drain_pending()
        return True

    async def _h_commit_bundles(self, conn, p):
        from ray_tpu_torch.util.placement_group import formatted_bundle_resources

        pg_id = p["pg_id"]
        for idx in p["indexes"]:
            res = self.bundle_reservations.pop((pg_id, idx), None)
            if res is None:
                continue
            self.committed_bundles[(pg_id, idx)] = res
            fmt = formatted_bundle_resources(res, pg_id, idx)
            for k, v in fmt.items():
                self.total[k] = self.total.get(k, 0.0) + v
                self.available[k] = self.available.get(k, 0.0) + v
        self._resources_freed = True
        await self._drain_pending()
        return True

    async def _h_return_pg(self, conn, p):
        """Release every bundle of a placement group hosted here."""
        from ray_tpu_torch.util.placement_group import formatted_bundle_resources

        pg_id = p["pg_id"]
        self._release_reservations(pg_id)
        # Kill workers leased against this group's formatted resources
        # (reference semantics: removing a PG kills its tasks/actors).
        for lid, lease in list(self.leases.items()):
            if lease.pg_id == pg_id:
                del self.leases[lid]
                info = self.workers.get(lease.worker_id)
                if info is not None and info.proc is not None:
                    if info.proc.poll() is None:
                        info.proc.kill()
        for key in [k for k in self.committed_bundles if k[0] == pg_id]:
            res = self.committed_bundles.pop(key)
            fmt = formatted_bundle_resources(res, pg_id, key[1])
            for k in fmt:
                self.total.pop(k, None)
                self.available.pop(k, None)
            add(self.available, res)
        self._resources_freed = True
        await self._drain_pending()
        return True

    # -- actors --------------------------------------------------------------

    async def _h_start_actor(self, conn, p):
        record = p["record"]
        spec = record["spec"]
        req = SchedulingRequest(
            resources=spec.get("resources", {}),
            runtime_env=spec.get("runtime_env") or {},
        )
        if self._draining:
            # Capacity-style rejection: the GCS requeues the actor and its
            # next placement pass skips this DRAINING view.
            raise SchedulingError(
                f"node {self.node_id[:8]} is draining; actor must place "
                f"elsewhere"
            )
        if not fits(self.available, req.resources):
            raise SchedulingError(
                f"node {self.node_id[:8]} cannot fit actor {req.resources}"
            )
        grant = await self._grant(req, for_actor=True)
        info = self.workers[grant["worker_id"]]
        info.state = ACTOR
        info.actor_ids.append(record["actor_id"])
        try:
            await self.endpoint.acall(
                info.addr,
                "worker.start_actor",
                {
                    "actor_id": record["actor_id"],
                    "spec": spec,
                    "restart_count": record.get("restart_count", 0),
                },
            )
        except Exception:
            # Return resources; worker may be broken — kill it.
            lease = self.leases.pop(grant["lease_id"], None)
            if lease is not None:
                add(self.available, lease.resources)
                self._resources_freed = True
            if info.proc is not None and info.proc.poll() is None:
                info.proc.kill()
            raise
        return {
            "worker_addr": info.addr,
            "worker_id": info.worker_id,
            "lease_id": grant["lease_id"],
        }

    async def _h_actor_init_failed(self, conn, p):
        """The worker's actor __init__ raised (async creation). Retire the
        process; _on_worker_death reports the actors to the GCS with the real
        error so restart/DEAD handling sees the creation failure."""
        info = self.workers.get(p["worker_id"])
        if info is not None and info.proc is not None and info.proc.poll() is None:
            info.proc.kill()
        await self._on_worker_death(p["worker_id"], p.get("reason", "init failed"))
        return True

    # -- object plane --------------------------------------------------------

    async def _store_call(self, fn, *args):
        """Run a store operation in an executor thread: spill/restore may
        copy multi-GB blobs between shm and disk, which must not stall the
        event loop (heartbeats would miss and the node be declared dead).
        The store is internally locked."""
        return await asyncio.get_running_loop().run_in_executor(
            None, fn, *args
        )

    async def _h_object_created(self, conn, p):
        """A local worker sealed an object file in our shm root."""
        await self._store_call(self.store.adopt, p["oid"], p["size"])
        return True

    async def _h_completions_batch(self, conn, p):
        """Task-completion notifications batched into one frame (mirrors
        worker.push_batch on the push side): adopt every object the
        completing task sealed in our shm root."""
        for c in p["created"]:
            await self._store_call(self.store.adopt, c["oid"], c["size"])
        return True

    async def _h_free_object(self, conn, p):
        # Offloaded: delete blocks on the store lock, which a multi-GB
        # spill copy may hold for seconds.
        await self._store_call(self.store.delete, p["oid"])
        return True

    async def _h_restore_object(self, conn, p):
        """A local worker's direct shm-path read missed — the blob was
        spilled to disk. Restore it into shm so the worker can map it."""
        if self.store.contains(p["oid"]):
            await self._store_call(self.store.get, p["oid"])  # restores
            return True
        return False

    async def _h_fetch_object(self, conn, p):
        """Peer node requests a chunk of a sealed object. Admission: at most
        object_serve_concurrency chunk reads in flight — excess requesters
        queue on the semaphore (their RPC just completes later)."""
        async with self._serve_slots:
            if not await self._store_call(self.store.contains, p["oid"]):
                # The sealed file is ground truth; a local worker may have
                # sealed it before its object_created notification reached
                # us.
                path = os.path.join(self.shm_root, p["oid"])
                if os.path.exists(path):
                    await self._store_call(
                        self.store.adopt, p["oid"], os.path.getsize(path)
                    )
            # read_range copies under the store lock — a concurrent spill
            # can't invalidate the view mid-slice. The OobBytes wrapper
            # ships that copy to the socket as its own scatter-gather
            # segment: no pickle copy, no transport join, for every 8 MiB
            # transfer chunk this node serves (kill switch: round-7 plain
            # bytes reply).
            from ray_tpu_torch.core.serialization import OobBytes

            chunk = await self._store_call(
                self.store.read_range, p["oid"], p["offset"], p["length"]
            )
            if faults._ACTIVE is not None:
                rule = faults._ACTIVE.decide(
                    "store", p["oid"],
                    actions=frozenset({"pull_corrupt", "pull_lose"}),
                )
                if rule is not None:
                    if rule.action == "pull_lose":
                        raise FaultInjectedError(
                            f"chunk of {p['oid'][:12]} lost in transfer "
                            f"(fault-injected)"
                        )
                    # pull_corrupt: flip the first served byte — caught by
                    # the verify_transfers fingerprint, surfacing as a
                    # failed pull the owner recovers from.
                    chunk = bytearray(chunk)
                    chunk[0] ^= 0xFF
                    chunk = bytes(chunk)
            if not GLOBAL_CONFIG.rpc_scatter_gather_enabled:
                return chunk
            return OobBytes(chunk)

    async def _h_pull_object(self, conn, p):
        """A local worker asks us to fetch an object from a remote node.
        Concurrent pulls of the same object coalesce onto one transfer."""
        oid = p["oid"]
        size = await self._store_call(self.store.size_of, oid)
        if size is not None:
            return {"size": size}
        inflight = self._inflight_pulls.get(oid)
        if inflight is not None:
            return await asyncio.shield(inflight)
        fut = asyncio.get_running_loop().create_future()
        self._inflight_pulls[oid] = fut
        try:
            async with self._pull_slots:  # pull admission control
                result = await self._do_pull(
                    oid, tuple(p["from_addr"]), p["size"]
                )
            fut.set_result(result)
            return result
        except Exception as e:
            fut.set_exception(e)
            # Consume the exception for waiters that never showed up.
            fut.exception()
            raise
        finally:
            del self._inflight_pulls[oid]

    async def _do_pull(self, oid: str, src_addr: tuple, size: int) -> dict:
        buf = await self._store_call(self.store.create, oid, size)
        try:
            chunk = GLOBAL_CONFIG.object_transfer_chunk_bytes
            off = 0
            while off < size:
                ln = min(chunk, size - off)
                # Per-chunk bound, SINGLE attempt (retries=0): a wedged
                # source must fail the pull and release its admission slot
                # in ~object_chunk_timeout_s — transport retries against
                # the same dead source would multiply that bound and starve
                # every queued pull behind the slot. Layering: the inner
                # deadline_s fires FIRST on a wedged request (instant dial,
                # the common case) so the failure feeds the breaker and
                # deadline metrics; a wedged DIAL fails at
                # rpc_connect_timeout_s inside acall (also counted); the
                # outer wait_for — chunk timeout plus a grace so it never
                # races the inner timer — is only the backstop for slow
                # dial + wedged request, keeping the slot bounded either
                # way. Pull-level recovery (drop the location, use another
                # replica, reconstruct) lives with the owner.
                data = await asyncio.wait_for(
                    self.endpoint.acall(
                        src_addr,
                        "node.fetch_object",
                        {"oid": oid, "offset": off, "length": ln},
                        deadline_s=GLOBAL_CONFIG.object_chunk_timeout_s,
                        retries=0,
                    ),
                    GLOBAL_CONFIG.object_chunk_timeout_s + 5.0,
                )
                # data is bytes or a decoded-frame memoryview (OobBytes);
                # the native multi-threaded memcpy lands it in the shm map.
                from ray_tpu_torch import _native

                _native.copy_into(buf[off : off + ln], data)
                off += ln
            if GLOBAL_CONFIG.verify_transfers:
                # End-to-end integrity: compare the assembled bytes' native
                # FNV-1a against the source's (opt-in: costs ~1 GB/s of
                # fingerprinting on each side).
                from ray_tpu_torch import _native

                expect = await self.endpoint.acall(
                    src_addr, "node.object_fingerprint", {"oid": oid}
                )
                got = await self._store_call(_native.fingerprint, buf)
                if (
                    expect is not None
                    and got is not None
                    and expect != got
                ):
                    raise IOError(
                        f"transfer of {oid[:12]} corrupted: fingerprint "
                        f"{got:#x} != source {expect:#x}"
                    )
        except Exception:
            await self._store_call(self.store.delete, oid)
            raise
        await self._store_call(self.store.seal, oid)
        return {"size": size}

    async def _h_object_fingerprint(self, conn, p):
        """Native FNV-1a of a sealed blob (transfer verification)."""
        from ray_tpu_torch import _native

        def compute():
            # Owner-side pin: the store holds its own lock around the view
            # + fingerprint so a concurrent spill can't unmap mid-hash
            # (reaching into store._lock from here was an RL105 finding).
            return self.store.apply(p["oid"], _native.fingerprint)

        return await self._store_call(compute)

    # -- memory monitor ------------------------------------------------------

    @staticmethod
    def _memory_usage_fraction() -> float:
        """Node memory pressure from /proc/meminfo (reference:
        memory_monitor.h reads cgroup/system usage)."""
        try:
            fields = {}
            with open("/proc/meminfo") as f:
                for line in f:
                    k, _, rest = line.partition(":")
                    fields[k] = int(rest.split()[0])
            total = fields.get("MemTotal", 0)
            avail = fields.get("MemAvailable", 0)
            if total <= 0:
                return 0.0
            return 1.0 - avail / total
        except OSError:
            return 0.0

    def _pick_memory_victim(self) -> Optional[str]:
        """Newest-leased task worker first (retriable-FIFO flavor: the
        youngest task lost the least work and will retry); actor workers
        are never chosen (reference kills leases, actors restart via their
        own policy)."""
        candidates = [
            lease
            for lease in self.leases.values()
            if lease.worker_id in self.workers
            and not self.workers[lease.worker_id].actor_ids
        ]
        if not candidates:
            return None
        return max(candidates, key=lambda lease: lease.granted_at).worker_id

    async def _memory_monitor_loop(self):
        while not self._stopping:
            await asyncio.sleep(GLOBAL_CONFIG.memory_monitor_interval_s)
            threshold = GLOBAL_CONFIG.memory_usage_threshold
            if threshold <= 0:
                continue
            usage = self._memory_usage_fn()
            if usage <= threshold:
                continue
            victim = self._pick_memory_victim()
            if victim is None:
                continue
            info = self.workers.get(victim)
            if info is None or info.proc is None:
                continue
            try:
                info.proc.kill()
            except OSError:
                pass
            await self._on_worker_death(
                victim,
                f"killed by the memory monitor: node usage "
                f"{usage:.0%} > threshold {threshold:.0%}",
            )

    # -- observability -------------------------------------------------------

    def _own_metric_snapshot(self) -> dict:
        """Node-level series, merged with user metrics at the GCS: worker
        pool + resource gauges, object-plane occupancy and churn, scheduler
        queue/wait, per-RPC-method service histograms, and the transport
        coalescing counters."""
        tags = {"node_id": self.node_id[:12]}
        meta = dict(_NODE_METRIC_META)
        points = [
            ["raytpu_node_workers", tags, float(len(self.workers))],
            [
                "raytpu_node_cpu_available",
                tags,
                float(self.available.get("CPU", 0.0)),
            ],
            [
                "raytpu_gcs_piggyback_frames_saved_total",
                tags,
                float(self._piggyback_saved),
            ],
            [
                "raytpu_drain_objects_migrated_total",
                tags,
                float(self._drain_migrated),
            ],
        ]
        if self.store is not None:
            st = self.store.stats()
            points.extend(
                [
                    [
                        "raytpu_node_object_store_bytes",
                        tags,
                        float(st["used_bytes"]),
                    ],
                    [
                        "raytpu_object_store_objects",
                        tags,
                        float(st["objects"]),
                    ],
                    [
                        "raytpu_object_store_capacity_bytes",
                        tags,
                        float(st["capacity_bytes"]),
                    ],
                    [
                        "raytpu_object_store_spills_total",
                        tags,
                        float(st["spills"]),
                    ],
                    [
                        "raytpu_object_store_spilled_bytes_total",
                        tags,
                        float(st["bytes_spilled"]),
                    ],
                    [
                        "raytpu_object_store_restores_total",
                        tags,
                        float(st["restores"]),
                    ],
                    [
                        "raytpu_object_store_deletes_total",
                        tags,
                        float(st["deletes"]),
                    ],
                ]
            )
        else:
            points.append(["raytpu_node_object_store_bytes", tags, 0.0])
        smeta, spoints = self.sched_metrics.snapshot(
            tags, len(self._pending_leases)
        )
        meta.update(smeta)
        points.extend(spoints)
        # Per-method service stats + transport coalescing counters
        # (PERF.md round-6) for this node's endpoint.
        emeta, epoints = self.endpoint.service_metric_snapshot(tags)
        meta.update(emeta)
        points.extend(epoints)
        return {"meta": meta, "points": points}

    async def _h_report_metrics(self, conn, p):
        self._worker_metric_snaps[p["worker_id"]] = p["snapshot"]
        return True

    async def _log_monitor_loop(self):
        """Tail worker log files; stage new lines for the next heartbeat
        envelope, which publishes them to the GCS "logs" channel
        (reference: python/ray/_private/log_monitor.py, minus the
        dedicated publish stream — ROADMAP heartbeat piggybacking)."""
        while not self._stopping:
            await asyncio.sleep(GLOBAL_CONFIG.log_monitor_interval_s)
            if self.log_dir is None:
                continue
            batches = []
            try:
                names = os.listdir(self.log_dir)
            except OSError:
                continue
            for fname in names:
                path = os.path.join(self.log_dir, fname)
                try:
                    size = os.path.getsize(path)
                except OSError:
                    continue
                off = self._log_offsets.get(fname, 0)
                if size <= off:
                    continue
                try:
                    # raylint: disable=RL001 -- local log tail on tmpfs/disk page cache, bounded 1 MiB read per poll tick; an executor hop per tick would cost more than the read
                    with open(path, "rb") as f:
                        f.seek(off)
                        chunk = f.read(min(size - off, 1 << 20))
                except OSError:
                    continue
                # Only ship complete lines; carry the tail to the next poll.
                cut = chunk.rfind(b"\n")
                if cut < 0:
                    continue
                self._log_offsets[fname] = off + cut + 1
                lines = chunk[: cut].decode("utf-8", "replace").splitlines()
                worker, _, stream = fname.rpartition(".")
                batches.append(
                    {"source": worker, "stream": stream, "lines": lines}
                )
            if not batches:
                continue
            for b in batches:
                self._log_batch_seq += 1
                b["bid"] = self._log_batch_seq
            self._pending_log_batches.extend(batches)
            # Bounded staging: a long GCS outage must not grow the buffer
            # without limit (observability is deliberately lossy under
            # failure, like the task-event buffer).
            if len(self._pending_log_batches) > 200:
                del self._pending_log_batches[:100]

    async def _h_list_objects(self, conn, p):
        """Objects resident in this node's store (reference: list_objects
        asks owners; here the shm store is node-scoped and authoritative
        for sealed blobs)."""
        if self.store is None:
            return []
        return [
            {
                "object_id": oid,
                "size": size,
                "sealed": sealed,
                "location": loc,
                "primary": primary,
                "node_id": self.node_id,
            }
            for oid, size, sealed, loc, primary in self.store.list_entries()
        ]

    async def _h_read_worker_log(self, conn, p):
        """Tail of one worker's captured stdout/stderr file (dashboard log
        viewing; reference: dashboard log module serving session-dir
        files). Returns None when logs are inherited or the worker never
        wrote."""
        stream = p.get("stream", "out")
        if stream not in ("out", "err"):
            raise ValueError(f"stream must be 'out' or 'err', got {stream!r}")
        path = self._worker_log_path(p["worker_id"], stream)
        if path is None or not os.path.exists(path):
            return None
        tail = min(int(p.get("tail_bytes", 65536)), 4 * 1024 * 1024)

        def read():
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - tail))
                return f.read().decode("utf-8", errors="replace")

        return await asyncio.get_running_loop().run_in_executor(None, read)

    async def _h_get_info(self, conn, p):
        return {
            "node_id": self.node_id,
            "addr": self.endpoint.address,
            "total": self.total,
            "available": self.available,
            "labels": self.labels,
            "shm_root": self.shm_root,
            "draining": self._draining,
            "num_workers": len(self.workers),
            "workers": [
                {
                    "worker_id": w.worker_id,
                    "state": w.state,
                    "pid": w.proc.pid if w.proc is not None else None,
                    "actor_ids": list(w.actor_ids),
                    # None until the worker registers (profiling targets
                    # must skip STARTING workers)
                    "addr": tuple(w.addr) if w.addr else None,
                }
                for w in self.workers.values()
            ],
        }
