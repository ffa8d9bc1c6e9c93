"""GCS — the cluster control plane.
Port of ``ray_tpu/core/gcs.py``.

Reference parity: the GCS server and its managers (src/ray/gcs/gcs_server.h:100
— node/actor/job/KV/pubsub managers, actor scheduler). One asyncio service
instead of 11 gRPC services: node registry + heartbeats → cluster view, actor
table with scheduling and restart-on-death, namespaced KV (function/config
store), long-lived pubsub over the same connections, and (M3+) placement
groups.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Optional

from ray_tpu_torch.core import faults
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.core.errors import (
    ActorDiedError,
    FaultInjectedError,
    SchedulingError,
)
from ray_tpu_torch.core.protocol import Connection, Endpoint
from ray_tpu_torch.core.scheduler import (
    NodeView,
    SchedulingRequest,
    SuspectStamper,
    any_feasible,
    pick_node,
)
from ray_tpu_torch.core.sched_index import _INDEX_METRIC_META, FeasibilityIndex
from ray_tpu_torch.util import flightrec as _flightrec
from ray_tpu_torch.util.metrics import (
    LocalHistogram,
    declare_runtime_metric,
    metrics_enabled,
)
from ray_tpu_torch.util.tasks import spawn

ALIVE = "ALIVE"
PENDING = "PENDING"
RESTARTING = "RESTARTING"
DEAD = "DEAD"
# Node drain sub-state: the view stays alive (running work finishes) but
# takes no new placements; on drain completion or deadline expiry the node
# transitions to DEAD (reference: gcs_service.proto DrainNode + the
# raylet's graceful-drain deadline).
DRAINING = "DRAINING"

# Placement decisions: sub-0.01 ms index picks through multi-ms full
# scans at 1,000 nodes.
PLACEMENT_BOUNDARIES_MS = [
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
    50.0,
]
# Changed nodes per delta reply: idle clusters gossip ~nothing; a full
# resync at fleet scale lands in the top buckets.
DELTA_NODES_BOUNDARIES = [
    0.0, 1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0,
]

# How many delta generations the GCS remembers for O(changed) delta
# computation; a consumer whose cursor predates the log falls back to the
# O(nodes) node_versions scan (correct, just slower). 512 generations at
# one flush per read covers minutes of history for any live consumer.
_DELTA_LOG_LEN = 512

# Drain telemetry (registered in the runtime catalog; tools/metrics_lint.py
# imports this module). The objects-migrated counter lives node-side
# (node._own_metric_snapshot) — the GCS counts drain lifecycle events.
_GCS_METRIC_META = {
    "raytpu_node_drains_total": declare_runtime_metric(
        "raytpu_node_drains_total", "counter",
        "graceful node drains started (API/CLI/SIGTERM/injected preemption)",
        layer="core",
    ),
    "raytpu_drain_deadline_forced_total": declare_runtime_metric(
        "raytpu_drain_deadline_forced_total", "counter",
        "drains that ended in the force mark-dead fallback (grace deadline "
        "expired, or force=true / zero grace requested)",
        layer="core",
    ),
    # Fleet-scale control-plane series (round 19): the placement hot
    # path, the coalesced heartbeat ingest, and the delta fan-out —
    # exactly what tools/fleet_emu.py profiles at 100->1,000 nodes.
    "raytpu_gcs_placement_latency_ms": declare_runtime_metric(
        "raytpu_gcs_placement_latency_ms", "histogram",
        "scheduler pick time per actor placement decision (the index vs "
        "full-scan A/B surface; excludes the start_actor RPC)",
        boundaries=PLACEMENT_BOUNDARIES_MS,
        layer="core",
    ),
    "raytpu_gcs_view_delta_nodes": declare_runtime_metric(
        "raytpu_gcs_view_delta_nodes", "histogram",
        "changed-node count per versioned cluster-view delta reply "
        "(coalesced heartbeat ingest keeps this near the real change "
        "rate, not the heartbeat rate)",
        boundaries=DELTA_NODES_BOUNDARIES,
        layer="core",
    ),
    "raytpu_gcs_heartbeat_ingest_total": declare_runtime_metric(
        "raytpu_gcs_heartbeat_ingest_total", "counter",
        "node heartbeats ingested by this GCS (accepted beats only: "
        "unknown/dead-node beats that force re-registration don't count)",
        layer="core",
    ),
}

# placement group states
PG_PENDING = "PENDING"
PG_CREATED = "CREATED"
PG_RESCHEDULING = "RESCHEDULING"
PG_REMOVED = "REMOVED"


@dataclass
class PgRecord:
    """One placement group (reference: gcs_placement_group_manager.h)."""

    pg_id: str
    name: str | None
    bundles: list  # list of resource dicts
    strategy: str  # PACK | SPREAD | STRICT_PACK | STRICT_SPREAD
    label_selectors: list  # per-bundle label selectors ([] = none)
    state: str = PG_PENDING
    bundle_nodes: list = field(default_factory=list)  # node_id | None per bundle
    error: str | None = None
    waiters: list = field(default_factory=list)
    scheduling: bool = False  # a _schedule_pg pass is in flight


@dataclass
class ActorRecord:
    actor_id: str
    name: str | None
    spec: dict  # class_payload, args_payload, resources, label_selector, opts
    state: str = PENDING
    addr: tuple | None = None
    worker_id: str | None = None
    node_id: str | None = None
    restarts: int = 0
    killed: bool = False
    error: str | None = None
    waiters: list = field(default_factory=list)


class GcsServer:
    def __init__(self, session_id: str, storage_path: str | None = None):
        from ray_tpu_torch.core.gcs_store import make_store
        from ray_tpu_torch.util.events import EventRecorder

        # Structured definition/lifecycle events (reference:
        # ray_event_recorder.h + dashboard aggregator); export path via
        # RAY_TPU_EVENT_EXPORT_PATH.
        self.events = EventRecorder(source="gcs")

        # Durable metadata storage (reference: gcs_table_storage.h over
        # store_client/; RedisStoreClient:126 is the FT path). With a
        # storage path, a restarted GCS reloads every table and nodes
        # re-register on their next heartbeat.
        self.store = make_store(
            storage_path
            if storage_path is not None
            else (GLOBAL_CONFIG.gcs_storage_path or None)
        )
        stored_session = self.store.get("meta", "session_id")
        if stored_session is not None:
            session_id = stored_session.decode()
        else:
            self.store.put("meta", "session_id", session_id.encode())
        self.session_id = session_id
        self.endpoint = Endpoint("gcs")
        self.kv: dict[str, dict[str, bytes]] = {}
        self.nodes: dict[str, NodeView] = {}
        self.node_meta: dict[str, dict] = {}
        self.node_last_seen: dict[str, float] = {}
        self.actors: dict[str, ActorRecord] = {}
        self.named_actors: dict[str, str] = {}
        self.pending_actors: list[str] = []
        self.pgs: dict[str, PgRecord] = {}
        self.named_pgs: dict[str, str] = {}
        self.pending_pgs: list[str] = []
        self.pg_release_retries: list[tuple] = []  # (node_id, pg_id)
        self._suspect_stamper = SuspectStamper(
            lambda: bool(self.endpoint._breakers),
            lambda addr: self.endpoint.peer_suspect(addr),
        )
        self.subs: dict[str, list[Connection]] = {}
        # Graceful drain (reference: DrainNode): node_id -> {reason,
        # grace_s, deadline (monotonic), task (deadline enforcer)}. A
        # draining node keeps heartbeating but takes no new placements;
        # drain_complete or the deadline moves it to DEAD.
        self.draining_nodes: dict[str, dict] = {}
        self.drain_stats = {"drains": 0, "deadline_forced": 0}
        # Pre-death object migrations reported by draining nodes:
        # oid -> node_id now holding a copy. Owners consult this on a
        # location miss BEFORE falling back to lineage reconstruction.
        # Bounded: drain is a rare event; entries age out FIFO.
        self.migrated_objects: "OrderedDict[str, str]" = OrderedDict()
        # Observability: bounded task-event store (reference:
        # GcsTaskManager, gcs_task_manager.h) keyed by task_id — each
        # report merges state timestamps into one record; per-node metric
        # snapshots arrive with heartbeats.
        self.task_events: "OrderedDict[str, dict]" = OrderedDict()
        self.node_metrics: dict[str, list] = {}
        # Metric time-series: bounded per-series rings sampled from the
        # merged cluster snapshot as reports arrive (reference: the
        # dashboard metrics module's Grafana time-series role).
        self.metric_history: dict[str, "deque"] = {}
        self._history_last_sample = 0.0
        # Versioned view sync: bumped only on REAL state changes so idle
        # clusters gossip ~nothing (reference: delta-streaming RaySyncer).
        # Bumps are COALESCED (round 19): a state change marks the node
        # dirty; _flush_view_dirty() turns all dirt accumulated since the
        # last flush into ONE version generation, so N heartbeats between
        # two reads cost one delta generation, not N. The delta log keeps
        # the last _DELTA_LOG_LEN generations for O(changed) delta
        # replies; node_versions stays as the out-of-log fallback.
        self.view_version = 0
        self.node_versions: dict[str, int] = {}
        self._dirty_nodes: set[str] = set()
        self._delta_log: "deque[tuple]" = deque(maxlen=_DELTA_LOG_LEN)
        # Feasibility index over the authoritative views (round 19): the
        # actor-placement hot path samples a bounded candidate set from it
        # instead of scanning self.nodes. Maintained unconditionally (the
        # transitions are rare); GLOBAL_CONFIG.sched_index gates the READ
        # path, so the kill switch can flip at runtime.
        self.sched_index = FeasibilityIndex(self.nodes)
        # Exact per-decision pick latency (ms), readable in-process by
        # tools/fleet_emu.py — the A/B witness the >=2x acceptance bar is
        # judged on (client RTTs would bury the pick under RPC overhead).
        self.place_latency_ms: "deque[float]" = deque(maxlen=65536)
        self._place_hist = LocalHistogram(PLACEMENT_BOUNDARIES_MS)
        self._delta_nodes_hist = LocalHistogram(DELTA_NODES_BOUNDARIES)
        self.hb_ingest_total = 0
        self.internal_config: str = GLOBAL_CONFIG.to_json()
        self._health_task = None
        self._restored_live: list[str] = []
        self._load_from_store()
        for name in [n for n in dir(self) if n.startswith("_h_")]:
            self.endpoint.register("gcs." + name[3:], getattr(self, name))

    # -- durability ----------------------------------------------------------

    def _load_from_store(self) -> None:
        import pickle

        for key, value in self.store.scan("kv"):
            ns, _, k = key.partition("\x00")
            self.kv.setdefault(ns, {})[k] = value
        for _, value in self.store.scan("actors"):
            rec: ActorRecord = pickle.loads(value)
            rec.waiters = []
            self.actors[rec.actor_id] = rec
            if rec.name and rec.state != DEAD:
                self.named_actors[rec.name] = rec.actor_id
            if rec.state in (PENDING, RESTARTING):
                self.pending_actors.append(rec.actor_id)
            elif rec.state == ALIVE:
                # Verified after restart: if the hosting node never
                # re-registers, the actor is failed over (or declared
                # dead) instead of staying ALIVE-but-unreachable forever.
                self._restored_live.append(rec.actor_id)
        for _, value in self.store.scan("pgs"):
            pg: PgRecord = pickle.loads(value)
            pg.waiters = []
            pg.scheduling = False
            self.pgs[pg.pg_id] = pg
            if pg.name and pg.state != PG_REMOVED:
                self.named_pgs[pg.name] = pg.pg_id
            if pg.state in (PG_PENDING, PG_RESCHEDULING):
                self.pending_pgs.append(pg.pg_id)

    def _save_actor(self, rec: ActorRecord) -> None:
        import dataclasses as _dc
        import pickle

        clean = _dc.replace(rec, waiters=[])
        self.store.put("actors", rec.actor_id, pickle.dumps(clean))

    def _save_pg(self, rec: PgRecord) -> None:
        import dataclasses as _dc
        import pickle

        clean = _dc.replace(rec, waiters=[], scheduling=False)
        self.store.put("pgs", rec.pg_id, pickle.dumps(clean))

    def start(self, host: str = "127.0.0.1", port: int = 0) -> tuple:
        addr = self.endpoint.start(host=host, port=port)
        self._health_task = self.endpoint.submit(self._health_loop())
        if self._restored_live:
            self.endpoint.submit(self._reconcile_restored_actors())
        return addr

    async def _reconcile_restored_actors(self) -> None:
        """Post-restart sweep: ALIVE actors restored from storage whose
        node did not re-register within the grace window are failed over
        (reference: GCS FT replays node state via NotifyGCSRestart; here
        nodes re-register on their next heartbeat)."""
        await asyncio.sleep(5 * GLOBAL_CONFIG.node_heartbeat_interval_s)
        actor_ids, self._restored_live = self._restored_live, []
        for actor_id in actor_ids:
            rec = self.actors.get(actor_id)
            if rec is None or rec.state != ALIVE:
                continue
            if rec.node_id not in self.nodes:
                await self._on_actor_failure(
                    rec, "hosting node lost across GCS restart"
                )

    def stop(self) -> None:
        if self._health_task is not None:
            self._health_task.cancel()
        self.endpoint.stop()
        self.store.close()

    # -- pubsub --------------------------------------------------------------

    async def _publish(self, channel: str, data: Any) -> None:
        # Every actor/PG state transition publishes — one persistence hook
        # covers the whole lifecycle.
        if channel == "actors":
            rec = self.actors.get(data.get("actor_id"))
            if rec is not None:
                self._save_actor(rec)
        elif channel == "placement_groups":
            pg = self.pgs.get(data.get("pg_id"))
            if pg is not None:
                self._save_pg(pg)
        for conn in list(self.subs.get(channel, [])):
            if conn.closed:
                self.subs[channel].remove(conn)
                continue
            try:
                await conn.notify("pub", {"channel": channel, "data": data})
            except Exception as e:
                # Subscriber misses one event; its next poll/resync catches
                # up. Logged so a flapping subscriber link is visible.
                logging.getLogger("ray_tpu_torch.gcs").debug(
                    "pub to subscriber dropped (channel %s): %s", channel, e
                )

    async def _h_subscribe(self, conn: Connection, p: dict):
        for ch in p["channels"]:
            lst = self.subs.setdefault(ch, [])
            if conn not in lst:
                lst.append(conn)
        return True

    # -- kv ------------------------------------------------------------------

    async def _h_kv_put(self, conn, p):
        ns = self.kv.setdefault(p.get("ns", ""), {})
        if not p.get("overwrite", True) and p["key"] in ns:
            return False
        ns[p["key"]] = p["value"]
        self.store.put(
            "kv", f"{p.get('ns', '')}\x00{p['key']}", p["value"]
        )
        return True

    async def _h_kv_get(self, conn, p):
        return self.kv.get(p.get("ns", ""), {}).get(p["key"])

    async def _h_kv_del(self, conn, p):
        self.store.delete("kv", f"{p.get('ns', '')}\x00{p['key']}")
        return self.kv.get(p.get("ns", ""), {}).pop(p["key"], None) is not None

    async def _h_kv_keys(self, conn, p):
        prefix = p.get("prefix", "")
        return [
            k for k in self.kv.get(p.get("ns", ""), {}) if k.startswith(prefix)
        ]

    async def _h_get_internal_config(self, conn, p):
        return self.internal_config

    async def _h_get_session(self, conn, p):
        """Bootstrap info for a node joining an existing cluster (reference:
        services.py get_ray_address_from_environment + GetInternalConfig):
        the session id keys the node's shm namespace and must match
        cluster-wide."""
        return {"session_id": self.session_id, "config": self.internal_config}

    # -- nodes ---------------------------------------------------------------

    async def _h_register_node(self, conn, p):
        # A node daemon from a DIFFERENT session may dial this address
        # after a port reuse (its old GCS died; we bound the same port).
        # Accepting it would splice a foreign cluster's capacity into this
        # one — tasks would run on nodes the driver never created.
        peer_session = p.get("session_id")
        if peer_session is not None and peer_session != self.session_id:
            raise RuntimeError(
                f"session mismatch: node {p['node_id'][:8]} belongs to "
                f"session {peer_session}, this GCS serves {self.session_id}"
            )
        view = NodeView(
            node_id=p["node_id"],
            addr=tuple(p["addr"]),
            total=dict(p["resources"]),
            available=dict(p["resources"]),
            labels=dict(p.get("labels", {})),
        )
        self.nodes[p["node_id"]] = view
        meta = self.node_meta.setdefault(p["node_id"], {})
        meta["shm_root"] = p.get("shm_root")
        meta["hostname"] = p.get("hostname", "localhost")
        if p.get("store") is not None:
            meta["store"] = p["store"]
        # A partition survivor re-registering is alive again: its stale
        # death verdict must not keep tainting error messages.
        meta.pop("death_reason", None)
        # ...nor may a stale drain deadline from a previous incarnation
        # kill the fresh registration out from under it.
        ent = self.draining_nodes.pop(p["node_id"], None)
        if ent is not None and ent.get("task") is not None:
            ent["task"].cancel()
        # Deliberately NOT resetting meta["log_bid"]: a partition-survivor
        # re-registering under the same node_id is the same process with
        # the same monotonic batch counter, and its restaged heartbeat
        # cargo must still dedup against the high-water mark or subscribers
        # see every already-published batch again.
        self.node_last_seen[p["node_id"]] = time.monotonic()
        self._bump_node_version(p["node_id"])
        self.sched_index.upsert(view)
        self.events.record(
            "NODE", "DEFINITION", p["node_id"],
            {"labels": dict(p.get("labels", {})),
             "resources": dict(p["resources"])},
        )
        self.events.record("NODE", "LIFECYCLE", p["node_id"], {"state": ALIVE})
        await self._publish("nodes", {"node_id": p["node_id"], "state": ALIVE})
        await self._retry_pending_actors()
        await self._retry_pending_pgs()
        return {"session_id": self.session_id, "config": self.internal_config}

    async def _h_node_heartbeat(self, conn, p):
        if faults._ACTIVE is not None:
            rule = faults._ACTIVE.decide(
                "gcs", p["node_id"],
                actions=frozenset({"heartbeat_blackhole"}),
            )
            if rule is not None:
                # Simulated partition: the heartbeat "never arrived". The
                # node sees a failed RPC; this GCS eventually declares it
                # dead; when the rule stops firing, the next heartbeat's
                # False reply drives re-registration — the same healing
                # path a real partition exercises.
                raise FaultInjectedError(
                    f"heartbeat from {p['node_id'][:8]} blackholed"
                )
        view = self.nodes.get(p["node_id"])
        if view is None or not view.alive:
            # Unknown, OR declared dead by the health loop (a partition
            # outlived node_death_timeout_s but the node itself survived):
            # either way the node must re-register before its state counts
            # again — replying True here would leave a zombie heartbeating
            # into a view that stays dead forever.
            return False  # piggybacked sections dropped too: re-register first
        # Heartbeat piggybacking (ROADMAP): the envelope may carry the
        # node's merged metric snapshots and staged log batches — one
        # node->GCS stream instead of three.
        if p.get("metrics") is not None:
            self._ingest_node_metrics(p["node_id"], p["metrics"])
        if p.get("logs"):
            # Restaged heartbeat cargo makes log delivery at-least-once (a
            # beat whose reply was lost re-sends its batches); the node
            # stamps every batch with a monotonic "bid", so dropping ids at
            # or below the per-node high-water mark makes it exactly-once
            # for subscribers. Unstamped batches (other producers) pass.
            meta = self.node_meta.setdefault(p["node_id"], {})
            seen = meta.get("log_bid", 0)
            fresh = []
            for b in p["logs"]:
                bid = b.get("bid")
                if bid is None:
                    fresh.append(b)
                elif bid > seen:
                    seen = bid
                    fresh.append({k: v for k, v in b.items() if k != "bid"})
            meta["log_bid"] = seen
            if fresh:
                await self._publish(
                    "logs", {"node_id": p["node_id"], "batches": fresh}
                )
        self.hb_ingest_total += 1
        if _flightrec.on():
            _flightrec.record(
                "gcs", "gcs.hb_ingest", rid=p["node_id"][:12]
            )
        new_avail = dict(p["available"])
        new_total = dict(p.get("total", view.total))
        if new_avail != view.available or new_total != view.total:
            self._bump_node_version(p["node_id"])
            view.available = new_avail
            view.total = new_total
            # Values change every beat; the bucket KEY only when the
            # resource-key set does (e.g. a PG bundle commit landing in
            # the node's self-report) — upsert no-ops otherwise.
            self.sched_index.upsert(view)
        else:
            view.available = new_avail
            view.total = new_total
        meta = self.node_meta.setdefault(p["node_id"], {})
        meta["pending_demand"] = p.get("pending_demand", [])
        if p.get("store") is not None:
            # Object-store occupancy gauges (used/capacity/spills): served
            # through the cluster view for the data-plane memory governor.
            meta["store"] = p["store"]
        if p.get("idle"):
            meta.setdefault("idle_since", time.monotonic())
        else:
            meta.pop("idle_since", None)
        self.node_last_seen[p["node_id"]] = time.monotonic()
        if p.get("resources_freed"):
            await self._retry_pending_actors()
            await self._retry_pending_pgs()
        return True

    def _node_entry(self, nid) -> dict:
        v = self.nodes[nid]
        meta = self.node_meta.get(nid, {})
        return {
            "addr": v.addr,
            "total": v.total,
            "available": v.available,
            "labels": v.labels,
            "alive": v.alive,
            # Drain state travels with the view so node-side schedulers
            # stop spilling leases to a draining peer, and so library
            # controllers (train / serve) can react to a preemption notice
            # before the node actually dies.
            "draining": v.draining,
            "death_reason": meta.get("death_reason"),
            "shm_root": meta.get("shm_root"),
            "hostname": meta.get("hostname", "localhost"),
            # Last-heartbeat object-store occupancy (None until the first
            # beat lands): the memory governor's arbitration signal.
            "store": meta.get("store"),
        }

    def _bump_node_version(self, nid: str) -> None:
        # Coalesced (round 19): mark dirty; the next flush folds every
        # node dirtied since the last one into a single version bump.
        self._dirty_nodes.add(nid)

    def _flush_view_dirty(self) -> None:
        """One version generation for ALL state changes since the last
        flush. Runs lazily at view-read time plus once per health tick —
        N heartbeats landing between two reads produce one delta
        generation, not N, and an idle cluster's version never moves."""
        if not self._dirty_nodes:
            return
        self.view_version += 1
        ver = self.view_version
        dirty, self._dirty_nodes = self._dirty_nodes, set()
        for nid in dirty:
            self.node_versions[nid] = ver
        self._delta_log.append((ver, dirty))

    async def _h_get_cluster_view(self, conn, p):
        """Full view (no ``since``) or versioned delta (``since``: the
        caller's last seen version). Delta replies carry only nodes whose
        state changed — the reference's RaySyncer gossip role
        (ray_syncer.h:90) without per-heartbeat O(nodes) payloads."""
        since = p.get("since")
        if since is None:
            return {nid: self._node_entry(nid) for nid in self.nodes}
        self._flush_view_dirty()
        if since < 0 or since > self.view_version:
            # Fresh cursor, or one predating a GCS restart: full resync.
            # full=True tells the caller to REPLACE its view — merging
            # would retain nodes that vanished with the old GCS.
            if metrics_enabled():
                self._delta_nodes_hist.observe(float(len(self.nodes)))
            return {
                "version": self.view_version,
                "changed": {nid: self._node_entry(nid) for nid in self.nodes},
                "full": True,
            }
        log = self._delta_log
        if log and since >= log[0][0] - 1:
            # The cursor is inside the log window: walk the O(changed)
            # suffix of generations instead of scanning every node's
            # version (the fleet-scale path — delta cost now tracks the
            # change rate, not the fleet size).
            changed_ids: set = set()
            for ver, ids in reversed(log):
                if ver <= since:
                    break
                changed_ids.update(ids)
            changed = {
                nid: self._node_entry(nid)
                for nid in sorted(changed_ids)
                if nid in self.nodes
            }
        else:
            changed = {
                nid: self._node_entry(nid)
                for nid, ver in self.node_versions.items()
                if ver > since and nid in self.nodes
            }
        if metrics_enabled():
            self._delta_nodes_hist.observe(float(len(changed)))
        return {"version": self.view_version, "changed": changed}

    async def _h_drain_node(self, conn, p):
        """Start a graceful drain (reference: gcs_service.proto DrainNode).

        Default: mark the node DRAINING (no new leases/placements; still
        feasible so demand queues), arm the ``grace_s`` deadline, and ask
        the node to self-drain — migrate primary objects, restart its
        restartable actors elsewhere, finish running tasks — unless the
        node itself initiated (``self_initiated``: it is already draining).
        On deadline expiry the old immediate mark-dead path fires as the
        force fallback.

        ``force=true`` (or zero grace) is the compatibility path: kill the
        node record immediately, exactly the pre-drain behavior — objects
        then come back via lineage reconstruction.
        """
        node_id = p["node_id"]
        reason = p.get("reason") or "drained"
        view = self.nodes.get(node_id)
        if view is None or not view.alive:
            return {"accepted": False, "state": DEAD}
        grace = p.get("grace_s")
        if grace is None:
            grace = GLOBAL_CONFIG.drain_grace_s
        if p.get("force") or grace <= 0:
            # Escalating an in-progress graceful drain counts once: only
            # a fresh drain bumps the drains counter.
            if node_id not in self.draining_nodes:
                self.drain_stats["drains"] += 1
            self.drain_stats["deadline_forced"] += 1
            # Tell the node to die for real (best-effort): without this an
            # in-process node would zombie-heartbeat and re-register right
            # after the mark-dead below. notify — no reply needed from a
            # node we are about to declare dead.
            try:
                await self.endpoint.anotify(
                    view.addr, "node.drain",
                    {"grace_s": 0.0, "reason": reason, "node_id": node_id},
                )
            except Exception:  # raylint: disable=RL006 -- force-kill notice to an unreachable node; mark_node_dead below is authoritative
                pass
            await self._mark_node_dead(node_id, reason)
            return {"accepted": True, "state": DEAD, "forced": True}
        ent = self.draining_nodes.get(node_id)
        if ent is not None:
            # Double-drain is idempotent: report the in-progress drain
            # instead of re-arming the deadline or re-counting.
            return {
                "accepted": True,
                "state": DRAINING,
                "deadline_in_s": max(0.0, ent["deadline"] - time.monotonic()),
            }
        self.drain_stats["drains"] += 1
        ent = {
            "reason": reason,
            "grace_s": float(grace),
            "deadline": time.monotonic() + float(grace),
            "task": None,
        }
        self.draining_nodes[node_id] = ent
        view.draining = True
        self._bump_node_version(node_id)
        self.events.record(
            "NODE", "LIFECYCLE", node_id,
            {"state": DRAINING, "reason": reason, "grace_s": float(grace)},
        )
        await self._publish(
            "nodes",
            {"node_id": node_id, "state": DRAINING, "reason": reason,
             "grace_s": float(grace)},
        )
        ent["task"] = spawn(
            self._drain_deadline(node_id), name="drain deadline"
        )
        if not p.get("self_initiated"):
            try:
                await self.endpoint.acall(
                    view.addr, "node.drain",
                    {"grace_s": float(grace), "reason": reason,
                     "node_id": node_id},
                )
            except Exception:  # raylint: disable=RL006 -- node unreachable: the deadline fallback still fires
                pass  # node unreachable: the deadline fallback still fires
        return {"accepted": True, "state": DRAINING}

    async def _drain_deadline(self, node_id: str) -> None:
        """Grace-window enforcer: a drain the node never completes falls
        back to the immediate mark-dead path (today's reconstruction
        story) instead of wedging DRAINING forever."""
        ent = self.draining_nodes.get(node_id)
        if ent is None:
            return
        await asyncio.sleep(max(0.0, ent["deadline"] - time.monotonic()))
        ent = self.draining_nodes.get(node_id)
        if ent is None:
            return  # drain completed meanwhile
        ent["task"] = None  # we ARE the task; don't self-cancel below
        view = self.nodes.get(node_id)
        if view is not None and view.alive:
            self.drain_stats["deadline_forced"] += 1
            await self._mark_node_dead(node_id, ent["reason"])

    async def _h_drain_complete(self, conn, p):
        """The draining node finished its migration work: retire it now
        (with the drain's reason) instead of waiting out the deadline."""
        ent = self.draining_nodes.get(p["node_id"])
        reason = ent["reason"] if ent else (p.get("reason") or "drained")
        await self._mark_node_dead(p["node_id"], reason)
        return True

    async def _h_restart_node_actors(self, conn, p):
        """A draining node asks for its restartable actors to be restarted
        on OTHER nodes *before* it dies (pick_node skips the draining
        view), so the restart-aware submitters resend in order with no
        post-mortem detection gap. Returns the moved actor ids — the node
        then retires their local workers so submitters reconnect. Actors
        out of restart budget stay put and die with the node."""
        node_id = p["node_id"]
        reason = p.get("reason") or "drained"
        moved = []
        for rec in list(self.actors.values()):
            if rec.node_id != node_id or rec.state != ALIVE or rec.killed:
                continue
            max_restarts = rec.spec.get("max_restarts", 0)
            if max_restarts == -1 or rec.restarts < max_restarts:
                await self._on_actor_failure(
                    rec, f"node {node_id[:8]} draining ({reason})"
                )
                moved.append(rec.actor_id)
        return moved

    async def _h_report_migrations(self, conn, p):
        """A draining node migrated primary objects to peers: record
        oid -> new holder so owners resolve the copy instead of paying a
        lineage reconstruction. Bounded FIFO (drain is rare; a replica
        outliving its table entry just reconstructs like before)."""
        for oid, node_id in p["moves"]:
            self.migrated_objects[oid] = node_id
            self.migrated_objects.move_to_end(oid)
        while len(self.migrated_objects) > 50000:
            self.migrated_objects.popitem(last=False)
        return True

    async def _h_migrated_location(self, conn, p):
        return self.migrated_objects.get(p["oid"])

    async def _health_loop(self):
        cfg = GLOBAL_CONFIG
        while True:
            await asyncio.sleep(cfg.node_heartbeat_interval_s)
            now = time.monotonic()
            # Keep versions moving even with no active view readers (the
            # versioned-delta contract: a change is visible within one
            # health tick at worst).
            self._flush_view_dirty()
            for nid, view in list(self.nodes.items()):
                if not view.alive:
                    continue
                last = self.node_last_seen.get(nid, 0)
                if now - last > cfg.node_death_timeout_s:
                    await self._mark_node_dead(nid, "heartbeat_timeout")
            # Drain work parked by transient failures: pending actors/groups
            # (a failed RPC must not strand them until the next node event)
            # and bundle releases whose return_pg RPC failed.
            await self._retry_pending_actors()
            await self._retry_pending_pgs()
            await self._retry_pg_releases()

    async def _retry_pg_releases(self):
        retries, self.pg_release_retries = self.pg_release_retries, []
        for nid, pg_id in retries:
            view = self.nodes.get(nid)
            if view is None or not view.alive:
                continue  # node death resets its resources anyway
            try:
                await self.endpoint.acall(
                    view.addr, "node.return_pg", {"pg_id": pg_id}
                )
            except Exception:
                self.pg_release_retries.append((nid, pg_id))

    async def _mark_node_dead(self, node_id: str, reason: str):
        ent = self.draining_nodes.pop(node_id, None)
        if ent is not None:
            task = ent.get("task")
            if task is not None and task is not asyncio.current_task():
                task.cancel()
        view = self.nodes.get(node_id)
        if view is None or not view.alive:
            return  # unknown/already-dead: no duplicate DEAD event either
        self.events.record(
            "NODE", "LIFECYCLE", node_id, {"state": DEAD, "reason": reason}
        )
        view.alive = False
        view.draining = False
        view.available = {}
        # The reason ("drained"/"preempted"/"heartbeat_timeout") travels
        # with the dead view entry so owners can tell users WHY a lost
        # object's node went away (ObjectLostError wording).
        self.node_meta.setdefault(node_id, {})["death_reason"] = reason
        self.node_metrics.pop(node_id, None)
        self._bump_node_version(node_id)
        # Dead nodes leave the index (re-registration re-inserts): at
        # fleet scale churn would otherwise bloat every bucket with
        # corpses the probe loop has to step over.
        self.sched_index.remove(node_id)
        await self._publish(
            "nodes", {"node_id": node_id, "state": DEAD, "reason": reason}
        )
        # Fail or restart actors that lived there.
        for rec in list(self.actors.values()):
            if rec.node_id == node_id and rec.state in (ALIVE, PENDING):
                await self._on_actor_failure(
                    rec, f"node {node_id[:8]} died ({reason})"
                )
        # Reschedule placement-group bundles that were committed there.
        for pg in list(self.pgs.values()):
            if pg.state == PG_REMOVED or node_id not in pg.bundle_nodes:
                continue
            for i, nid in enumerate(pg.bundle_nodes):
                if nid == node_id:
                    pg.bundle_nodes[i] = None
            pg.state = PG_RESCHEDULING
            await self._publish("placement_groups", self._pg_info(pg))
            await self._schedule_pg(pg)

    # -- actors --------------------------------------------------------------

    async def _h_create_actor(self, conn, p):
        spec = p["spec"]
        rec = ActorRecord(
            actor_id=spec["actor_id"], name=spec.get("name"), spec=spec
        )
        if rec.name:
            if rec.name in self.named_actors:
                raise ValueError(f"actor name {rec.name!r} already taken")
            self.named_actors[rec.name] = rec.actor_id
        self.actors[rec.actor_id] = rec
        self._save_actor(rec)
        self.events.record(
            "ACTOR", "DEFINITION", rec.actor_id,
            {"name": rec.name or "",
             "class": str(spec.get("class_name", ""))},
        )
        await self._schedule_actor(rec)
        return self._actor_info(rec)

    def _stamp_suspects(self) -> None:
        """Refresh node views' suspect flags from this GCS's own breaker
        verdicts before actor/bundle placement: a node it can't talk to
        takes no new placements until the breaker half-opens, while the
        record stays pending (see scheduler.SuspectStamper)."""
        self._suspect_stamper.stamp(self.nodes.values())

    async def _schedule_actor(self, rec: ActorRecord) -> None:
        req = SchedulingRequest(
            resources=rec.spec.get("resources", {}),
            label_selector=rec.spec.get("label_selector", {}),
            soft_label_selector=rec.spec.get("soft_label_selector", {}),
            policy=rec.spec.get("policy", "hybrid"),
        )
        self._stamp_suspects()
        t0 = time.perf_counter()
        if GLOBAL_CONFIG.sched_index:
            node_id = self.sched_index.pick(req, "")
        else:
            node_id = pick_node(req, "", self.nodes)
        dt_ms = (time.perf_counter() - t0) * 1000.0
        self.place_latency_ms.append(dt_ms)
        if metrics_enabled():
            self._place_hist.observe(dt_ms)
        if _flightrec.on():
            _flightrec.record(
                "gcs", "gcs.place",
                t=time.monotonic() - dt_ms / 1000.0, dur_s=dt_ms / 1000.0,
                rid=rec.actor_id[:12], picked=node_id is not None,
            )
        if node_id is None:
            if any_feasible(req, self.nodes):
                if rec.actor_id not in self.pending_actors:
                    self.pending_actors.append(rec.actor_id)
                return
            rec.state = DEAD
            rec.error = (
                f"no feasible node for actor resources {req.resources} "
                f"selector {req.label_selector}"
            )
            self._wake(rec)
            await self._publish("actors", self._actor_info(rec))
            return
        view = self.nodes[node_id]
        rec.node_id = node_id
        try:
            reply = await self.endpoint.acall(
                view.addr, "node.start_actor", {"record": self._start_spec(rec)}
            )
        except SchedulingError:
            # The node's ACTUAL availability lagged our gossiped view (e.g.
            # task leases still returning): a capacity rejection is not an
            # actor failure — requeue and retry on the next resource event
            # (reference: GcsActorScheduler reschedules rejected leases).
            if rec.actor_id not in self.pending_actors:
                self.pending_actors.append(rec.actor_id)
            return
        except Exception as e:
            await self._on_actor_failure(rec, f"start_actor failed: {e!r}")
            return
        rec.addr = tuple(reply["worker_addr"])
        rec.worker_id = reply["worker_id"]
        rec.state = ALIVE
        self.events.record(
            "ACTOR", "LIFECYCLE", rec.actor_id,
            {"state": ALIVE, "node_id": rec.node_id},
        )
        self._wake(rec)
        await self._publish("actors", self._actor_info(rec))

    def _start_spec(self, rec: ActorRecord) -> dict:
        return {
            "actor_id": rec.actor_id,
            "spec": {
                k: v
                for k, v in rec.spec.items()
                if k != "name" or v is not None
            },
            "restart_count": rec.restarts,
            # The chosen node's id travels with the start RPC: real nodes
            # ignore it (they ARE the target), but the fleet emulator's
            # shared host endpoint serves node.start_actor for EVERY
            # emulated node and routes the debit by this key.
            "node_id": rec.node_id,
        }

    async def _retry_pending_actors(self):
        pending, self.pending_actors = self.pending_actors, []
        for actor_id in pending:
            rec = self.actors.get(actor_id)
            if rec is not None and rec.state in (PENDING, RESTARTING):
                await self._schedule_actor(rec)

    async def _on_actor_failure(self, rec: ActorRecord, reason: str):
        max_restarts = rec.spec.get("max_restarts", 0)
        if not rec.killed and (
            max_restarts == -1 or rec.restarts < max_restarts
        ):
            rec.restarts += 1
            rec.state = RESTARTING
            self.events.record(
                "ACTOR", "LIFECYCLE", rec.actor_id,
                {"state": RESTARTING, "restarts": rec.restarts,
                 "reason": reason},
            )
            rec.addr = None
            await self._publish("actors", self._actor_info(rec))
            await self._schedule_actor(rec)
        else:
            rec.state = DEAD
            rec.error = reason
            self.events.record(
                "ACTOR", "LIFECYCLE", rec.actor_id,
                {"state": DEAD, "reason": reason},
            )
            if _flightrec.on():
                # Postmortem trigger: an actor just died for good (restarts
                # exhausted or killed) — freeze the rings around the event.
                _flightrec.record(
                    "gcs", "gcs.actor_dead", rid=rec.actor_id[:12],
                    reason=reason[:120],
                )
                _flightrec.dump("actor_death")
            rec.addr = None
            self._wake(rec)
            await self._publish("actors", self._actor_info(rec))

    async def _h_report_worker_death(self, conn, p):
        """A node reports a worker process exited (possibly hosting actors).

        The report only fails an actor whose record still points at the
        dead worker: a drain (or any restart) may have already moved the
        actor to a fresh worker, and a late death report for the OLD
        incarnation must not burn a restart (or kill) the new one."""
        dead_worker = p.get("worker_id")
        for actor_id in p.get("actor_ids", []):
            rec = self.actors.get(actor_id)
            if rec is None or rec.state not in (ALIVE, RESTARTING):
                continue
            if (
                dead_worker is not None
                and rec.worker_id is not None
                and rec.worker_id != dead_worker
            ):
                continue  # stale report: the actor already restarted
            await self._on_actor_failure(rec, p.get("reason", "worker died"))
        return True

    async def _h_get_actor(self, conn, p):
        rec = self._resolve_actor(p)
        if rec is None:
            return None
        return self._actor_info(rec)

    async def _h_wait_actor_alive(self, conn, p):
        rec = self._resolve_actor(p)
        if rec is None:
            raise ValueError(f"no such actor: {p}")
        deadline = time.monotonic() + p.get("timeout", 60.0)
        while rec.state not in (ALIVE, DEAD):
            ev = asyncio.Event()
            rec.waiters.append(ev)
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"actor {rec.actor_id} not alive in time")
            try:
                await asyncio.wait_for(ev.wait(), remaining)
            except asyncio.TimeoutError:
                raise TimeoutError(f"actor {rec.actor_id} not alive in time")
        if rec.state == DEAD:
            raise ActorDiedError(rec.error or "actor died")
        return self._actor_info(rec)

    async def _h_kill_actor(self, conn, p):
        rec = self._resolve_actor(p)
        if rec is None:
            return False
        rec.killed = not p.get("allow_restart", False)
        if rec.node_id and rec.worker_id and rec.state == ALIVE:
            view = self.nodes.get(rec.node_id)
            if view is not None and view.alive:
                try:
                    await self.endpoint.acall(
                        view.addr,
                        "node.kill_worker",
                        {"worker_id": rec.worker_id, "force": True},
                    )
                except Exception:  # raylint: disable=RL006 -- force-kill of a worker on an unreachable node; node death reaps it
                    pass
        if rec.killed:
            rec.state = DEAD
            rec.error = "killed via ray_tpu_torch.kill"
            self.events.record(
                "ACTOR", "LIFECYCLE", rec.actor_id,
                {"state": DEAD, "reason": "killed"},
            )
            if rec.name:
                self.named_actors.pop(rec.name, None)
            self._wake(rec)
            await self._publish("actors", self._actor_info(rec))
        return True

    async def _h_list_actors(self, conn, p):
        return [self._actor_info(r) for r in self.actors.values()]

    # -- observability -------------------------------------------------------

    async def _h_report_task_events(self, conn, p):
        """Merge a batch of owner/executor task events into the bounded
        store (reference: TaskInfoGcsService.AddTaskEventData,
        gcs_service.proto:881)."""
        cap = GLOBAL_CONFIG.task_events_max
        for ev in p["events"]:
            tid = ev["task_id"]
            rec = self.task_events.get(tid)
            if rec is None:
                rec = {"task_id": tid}
                self.task_events[tid] = rec
                while len(self.task_events) > cap:
                    self.task_events.popitem(last=False)
            states = rec.setdefault("states", {})
            states.update(ev.get("states", {}))
            for k, v in ev.items():
                if k not in ("task_id", "states"):
                    rec[k] = v
        return True

    async def _h_list_task_events(self, conn, p):
        limit = p.get("limit", 1000)
        filt_state = p.get("state")
        filt_name = p.get("name")
        out = []
        for rec in reversed(self.task_events.values()):
            if filt_name and rec.get("name") != filt_name:
                continue
            if filt_state and rec.get("state") != filt_state:
                continue
            out.append(rec)
            if len(out) >= limit:
                break
        return out

    async def _h_get_autoscaler_state(self, conn, p):
        """Cluster load + membership for the autoscaler (reference:
        GcsAutoscalerStateManager feeding autoscaler v2)."""
        now = time.monotonic()
        nodes = []
        for nid, v in self.nodes.items():
            meta = self.node_meta.get(nid, {})
            idle_since = meta.get("idle_since")
            nodes.append(
                {
                    "node_id": nid,
                    "alive": v.alive,
                    "total": v.total,
                    "available": v.available,
                    "labels": v.labels,
                    "pending_demand": meta.get("pending_demand", []),
                    "idle_s": (now - idle_since) if idle_since else 0.0,
                }
            )
        pending = []
        for actor_id in self.pending_actors:
            rec = self.actors.get(actor_id)
            if rec is not None:
                pending.append(rec.spec.get("resources", {}))
        for pg_id in self.pending_pgs:
            rec = self.pgs.get(pg_id)
            if rec is not None:
                for i, b in enumerate(rec.bundles):
                    if i >= len(rec.bundle_nodes) or rec.bundle_nodes[i] is None:
                        pending.append(dict(b))
        return {"nodes": nodes, "pending": pending}

    async def _h_publish_logs(self, conn, p):
        await self._publish("logs", p)
        return True

    def _ingest_node_metrics(self, node_id: str, snapshots: list) -> None:
        """THE guarded ingest for node metric snapshots — shared by the
        heartbeat piggyback path and the direct report_metrics RPC.
        Reports from nodes already declared dead are ignored (stale series
        would otherwise be re-merged into every scrape forever)."""
        view = self.nodes.get(node_id)
        if view is not None and view.alive:
            self.node_metrics[node_id] = snapshots
            self._sample_history()

    async def _h_report_metrics(self, conn, p):
        """Direct metric push. No production caller since snapshots ride
        the heartbeat envelope — kept for external pushers and tests, on
        the same guarded ingest as the heartbeat path."""
        self._ingest_node_metrics(p["node_id"], p["snapshots"])
        return True

    def _sample_history(self) -> None:
        """Append the merged cluster snapshot to the per-series rings,
        rate-limited to one sample per history interval (reports arrive
        per node; sampling each would skew the time axis by node count)."""
        from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg
        from ray_tpu_torch.util.metrics import merge_snapshots

        now = time.time()
        if now - self._history_last_sample < cfg.metrics_history_interval_s:
            return
        self._history_last_sample = now
        snaps = [s for lst in self.node_metrics.values() for s in lst]
        merged = merge_snapshots(snaps)
        meta = merged.get("meta", {})
        window = max(2, cfg.metrics_history_window)
        for name, tags, value in merged.get("points", []):
            kind = meta.get(name, {}).get("kind", "gauge")
            if isinstance(value, dict):  # histogram: track the count
                value = value.get("count", 0)
            key = name
            if tags:
                key += "{" + ",".join(
                    f"{k}={v}" for k, v in sorted(tags.items())
                ) + "}"
            ring = self.metric_history.get(key)
            if ring is None or ring.maxlen != window:
                ring = deque(ring or (), maxlen=window)
                self.metric_history[key] = ring
            ring.append((round(now, 3), value))

    def _own_metric_snapshot(self) -> dict:
        """The GCS process's own service stats (per-RPC-method latency,
        in-flight, loop lag, transport counters) plus the drain lifecycle
        counters. The GCS is the metrics sink, so nothing pushes them —
        they join at scrape time."""
        meta, points = self.endpoint.service_metric_snapshot(
            {"process": "gcs"}
        )
        meta = dict(meta)
        meta.update(_GCS_METRIC_META)
        meta.update(_INDEX_METRIC_META)
        tags = {"process": "gcs"}
        points = list(points)
        points.extend(
            [
                [
                    "raytpu_node_drains_total",
                    tags,
                    float(self.drain_stats["drains"]),
                ],
                [
                    "raytpu_drain_deadline_forced_total",
                    tags,
                    float(self.drain_stats["deadline_forced"]),
                ],
                [
                    "raytpu_gcs_placement_latency_ms",
                    tags,
                    self._place_hist.as_value(),
                ],
                [
                    "raytpu_gcs_view_delta_nodes",
                    tags,
                    self._delta_nodes_hist.as_value(),
                ],
                [
                    "raytpu_gcs_heartbeat_ingest_total",
                    tags,
                    float(self.hb_ingest_total),
                ],
                [
                    "raytpu_sched_index_fallback_scans_total",
                    tags,
                    float(self.sched_index.fallback_scans),
                ],
            ]
        )
        return {"meta": meta, "points": points}

    async def _h_dump_metrics(self, conn, p):
        snaps = [s for lst in self.node_metrics.values() for s in lst]
        snaps.append(self._own_metric_snapshot())
        return snaps

    async def _h_metrics_history(self, conn, p):
        """{series: [[ts, value], ...]} — optionally filtered by metric
        name prefix (reference: the dashboard metrics module's
        time-series endpoint)."""
        prefix = p.get("name") or ""
        return {
            k: list(ring)
            for k, ring in self.metric_history.items()
            if k.startswith(prefix)
        }

    # -- structured events (reference: ray_event_recorder.h + aggregator) ----

    async def _h_record_event(self, conn, p):
        """External components (job manager, serve) record through this."""
        self.events.record(
            p["entity_kind"], p["event_type"], p["entity_id"],
            p.get("attrs"),
        )
        return True

    async def _h_list_events(self, conn, p):
        return self.events.list_events(
            kind=p.get("kind"),
            entity_id=p.get("entity_id"),
            limit=int(p.get("limit", 1000)),
        )

    async def _h_event_stats(self, conn, p):
        return self.events.stats()

    def _resolve_actor(self, p) -> Optional[ActorRecord]:
        if p.get("actor_id"):
            return self.actors.get(p["actor_id"])
        if p.get("name"):
            actor_id = self.named_actors.get(p["name"])
            return self.actors.get(actor_id) if actor_id else None
        return None

    # -- placement groups ----------------------------------------------------
    # 2-phase prepare/commit of bundles onto nodes (reference:
    # gcs_placement_group_scheduler.h:281 / CommitAllBundles :425).

    async def _h_create_placement_group(self, conn, p):
        spec = p["spec"]
        rec = PgRecord(
            pg_id=spec["pg_id"],
            name=spec.get("name"),
            bundles=[dict(b) for b in spec["bundles"]],
            strategy=spec.get("strategy", "PACK"),
            label_selectors=list(spec.get("label_selectors") or []),
            bundle_nodes=[None] * len(spec["bundles"]),
        )
        if rec.name:
            if rec.name in self.named_pgs:
                raise ValueError(f"placement group name {rec.name!r} taken")
            self.named_pgs[rec.name] = rec.pg_id
        self.events.record(
            "PLACEMENT_GROUP", "DEFINITION", rec.pg_id,
            {"name": rec.name or "", "strategy": rec.strategy,
             "bundles": len(rec.bundles)},
        )
        self.pgs[rec.pg_id] = rec
        await self._schedule_pg(rec)
        return self._pg_info(rec)

    def _bundle_selector(self, rec: PgRecord, index: int) -> dict:
        if index < len(rec.label_selectors):
            return rec.label_selectors[index] or {}
        return {}

    def _place_bundles(self, rec: PgRecord, idxs: list) -> Optional[dict]:
        """Choose a node for each unplaced bundle index, honoring the
        strategy, against a working copy of current availabilities. Returns
        {index: node_id} or None if no placement exists right now."""
        from ray_tpu_torch.core.scheduler import fits, labels_match, subtract

        # Same breaker-verdict gate as actor placement: bundles never land
        # on a node this GCS can't currently talk to (the 2PC prepare RPCs
        # would just burn deadlines). Unplaceable groups stay pending.
        self._stamp_suspects()
        avail = {
            nid: dict(v.available)
            for nid, v in self.nodes.items()
            if v.alive and not v.suspect
        }
        if not avail:
            return None
        used_nodes = {n for n in rec.bundle_nodes if n is not None}
        placement: dict = {}

        def candidates(index):
            sel = self._bundle_selector(rec, index)
            res = rec.bundles[index]
            return [
                nid
                for nid, a in avail.items()
                if labels_match(self.nodes[nid].labels, sel)
                and fits(a, res)
            ]

        if rec.strategy == "STRICT_PACK":
            pool = used_nodes or set(avail)
            for nid in sorted(pool):
                trial = dict(avail.get(nid, {}))
                ok = True
                for i in idxs:
                    sel = self._bundle_selector(rec, i)
                    if not labels_match(self.nodes[nid].labels, sel):
                        ok = False
                        break
                    if not fits(trial, rec.bundles[i]):
                        ok = False
                        break
                    subtract(trial, rec.bundles[i])
                if ok:
                    return {i: nid for i in idxs}
            return None

        for i in idxs:
            cands = candidates(i)
            if not cands:
                return None
            if rec.strategy == "STRICT_SPREAD":
                cands = [
                    c
                    for c in cands
                    if c not in used_nodes and c not in placement.values()
                ]
                if not cands:
                    return None
                choice = sorted(cands)[0]
            elif rec.strategy == "SPREAD":
                fresh = [
                    c
                    for c in cands
                    if c not in used_nodes and c not in placement.values()
                ]
                choice = sorted(fresh or cands)[0]
            else:  # PACK: prefer nodes already holding bundles of this group
                packed = [
                    c
                    for c in cands
                    if c in used_nodes or c in placement.values()
                ]
                choice = sorted(packed or cands)[0]
            placement[i] = choice
            subtract(avail[choice], rec.bundles[i])
        return placement

    async def _schedule_pg(self, rec: PgRecord) -> None:
        # One scheduling pass at a time per group; concurrent triggers
        # (pending retry, node death) re-queue instead of racing the 2PC.
        if rec.scheduling:
            if rec.pg_id not in self.pending_pgs:
                self.pending_pgs.append(rec.pg_id)
            return
        rec.scheduling = True
        try:
            await self._schedule_pg_once(rec)
        finally:
            rec.scheduling = False

    async def _schedule_pg_once(self, rec: PgRecord) -> None:
        if rec.state == PG_REMOVED:
            return
        idxs = [i for i, n in enumerate(rec.bundle_nodes) if n is None]
        if not idxs:
            rec.state = PG_CREATED
            self.events.record(
                "PLACEMENT_GROUP", "LIFECYCLE", rec.pg_id,
                {"state": PG_CREATED},
            )
            self._wake(rec)
            return
        placement = self._place_bundles(rec, idxs)
        if placement is None:
            if rec.pg_id not in self.pending_pgs:
                self.pending_pgs.append(rec.pg_id)
            return
        by_node: dict[str, list] = {}
        for i, nid in placement.items():
            by_node.setdefault(nid, []).append(i)
        # Phase 1: prepare (reserve) on every node, all-or-nothing. A node
        # whose prepare RPC *failed* may still have applied it (lost reply),
        # so it gets a cancel too — cancel_bundles is idempotent.
        attempted: list[str] = []
        ok = True
        for nid, items in by_node.items():
            attempted.append(nid)
            try:
                r = await self.endpoint.acall(
                    self.nodes[nid].addr,
                    "node.prepare_bundles",
                    {
                        "pg_id": rec.pg_id,
                        "bundles": [
                            {"index": i, "resources": rec.bundles[i]}
                            for i in items
                        ],
                    },
                )
            except Exception:  # raylint: disable=RL006 -- restart-ack failure recorded via r=False and retried by the caller loop
                r = False
            if not r:
                ok = False
                break
        if ok and rec.state == PG_REMOVED:
            ok = False  # removed while we were preparing — roll back
        if not ok:
            for nid in attempted:
                view = self.nodes.get(nid)
                if view is None or not view.alive:
                    continue
                try:
                    await self.endpoint.acall(
                        view.addr,
                        "node.cancel_bundles",
                        {"pg_id": rec.pg_id},
                    )
                except Exception:  # raylint: disable=RL006 -- pg release on an unreachable node; node death frees its bundles
                    pass
            if rec.state != PG_REMOVED and rec.pg_id not in self.pending_pgs:
                self.pending_pgs.append(rec.pg_id)
            return
        # Phase 2: commit. On a failed commit RPC the node may or may not
        # have applied it (lost reply) — send return_pg so either outcome
        # converges to "released"; node death converges via the death path.
        from ray_tpu_torch.util.placement_group import formatted_bundle_resources

        for nid, items in by_node.items():
            try:
                await self.endpoint.acall(
                    self.nodes[nid].addr,
                    "node.commit_bundles",
                    {"pg_id": rec.pg_id, "indexes": items},
                )
            except Exception:
                view = self.nodes.get(nid)
                if view is not None and view.alive:
                    try:
                        await self.endpoint.acall(
                            view.addr,
                            "node.return_pg",
                            {"pg_id": rec.pg_id},
                        )
                    except Exception:  # raylint: disable=RL006 -- pg prepare rollback on an unreachable node; reschedule loop retries
                        pass
                continue
            view = self.nodes.get(nid)
            for i in items:
                rec.bundle_nodes[i] = nid
                if view is not None:
                    fmt = formatted_bundle_resources(
                        rec.bundles[i], rec.pg_id, i
                    )
                    for k, v in fmt.items():
                        view.total[k] = view.total.get(k, 0.0) + v
                        view.available[k] = view.available.get(k, 0.0) + v
            if view is not None:
                # Bundle commits ADD resource keys (bundle_group_*): the
                # view's shape changed, so its index bucket moves.
                self.sched_index.upsert(view)
        if rec.state == PG_REMOVED:
            # Removed mid-commit: release everything we just placed.
            await self._release_pg_bundles(rec)
            return
        if all(n is not None for n in rec.bundle_nodes):
            rec.state = PG_CREATED
            self.events.record(
                "PLACEMENT_GROUP", "LIFECYCLE", rec.pg_id,
                {"state": PG_CREATED},
            )
            self._wake(rec)
        elif rec.pg_id not in self.pending_pgs:
            self.pending_pgs.append(rec.pg_id)
        await self._publish("placement_groups", self._pg_info(rec))

    async def _retry_pending_pgs(self):
        pending, self.pending_pgs = self.pending_pgs, []
        for pg_id in pending:
            rec = self.pgs.get(pg_id)
            if rec is not None and rec.state in (PG_PENDING, PG_RESCHEDULING):
                await self._schedule_pg(rec)

    async def _release_pg_bundles(self, rec: PgRecord) -> None:
        from ray_tpu_torch.util.placement_group import formatted_bundle_resources

        for nid in {n for n in rec.bundle_nodes if n is not None}:
            view = self.nodes.get(nid)
            if view is None or not view.alive:
                continue
            try:
                await self.endpoint.acall(
                    view.addr, "node.return_pg", {"pg_id": rec.pg_id}
                )
            except Exception:
                # Transient failure talking to a live node: park the release
                # for the health loop so the bundle is not leaked.
                self.pg_release_retries.append((nid, rec.pg_id))
                continue
            for i, bn in enumerate(rec.bundle_nodes):
                if bn != nid:
                    continue
                fmt = formatted_bundle_resources(rec.bundles[i], rec.pg_id, i)
                for k in fmt:
                    view.total.pop(k, None)
                    view.available.pop(k, None)
            # Release DROPS the bundle_group_* keys: shape changed back.
            self.sched_index.upsert(view)
        rec.bundle_nodes = [None] * len(rec.bundles)

    async def _h_remove_placement_group(self, conn, p):
        rec = self.pgs.get(p["pg_id"])
        if rec is None or rec.state == PG_REMOVED:
            return False
        rec.state = PG_REMOVED
        self.events.record(
            "PLACEMENT_GROUP", "LIFECYCLE", rec.pg_id, {"state": PG_REMOVED}
        )
        if rec.name:
            self.named_pgs.pop(rec.name, None)
        if rec.pg_id in self.pending_pgs:
            self.pending_pgs.remove(rec.pg_id)
        await self._release_pg_bundles(rec)
        self._wake(rec)
        await self._publish("placement_groups", self._pg_info(rec))
        return True

    async def _h_get_placement_group(self, conn, p):
        rec = None
        if p.get("pg_id"):
            rec = self.pgs.get(p["pg_id"])
        elif p.get("name"):
            pg_id = self.named_pgs.get(p["name"])
            rec = self.pgs.get(pg_id) if pg_id else None
        return self._pg_info(rec) if rec else None

    async def _h_list_placement_groups(self, conn, p):
        return [self._pg_info(r) for r in self.pgs.values()]

    async def _h_wait_pg_ready(self, conn, p):
        rec = self.pgs.get(p["pg_id"])
        if rec is None:
            raise ValueError(f"no such placement group {p['pg_id']}")
        deadline = time.monotonic() + p.get("timeout", 60.0)
        while rec.state not in (PG_CREATED, PG_REMOVED):
            ev = asyncio.Event()
            rec.waiters.append(ev)
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"pg {rec.pg_id} not ready in time")
            try:
                await asyncio.wait_for(ev.wait(), remaining)
            except asyncio.TimeoutError:
                raise TimeoutError(f"pg {rec.pg_id} not ready in time")
        if rec.state == PG_REMOVED:
            raise SchedulingError(f"placement group {rec.pg_id} was removed")
        return self._pg_info(rec)

    def _pg_info(self, rec: PgRecord) -> dict:
        return {
            "pg_id": rec.pg_id,
            "name": rec.name,
            "state": rec.state,
            "strategy": rec.strategy,
            "bundles": rec.bundles,
            "bundle_nodes": rec.bundle_nodes,
            "error": rec.error,
        }

    def _wake(self, rec):
        for ev in rec.waiters:
            ev.set()
        rec.waiters.clear()

    def _actor_info(self, rec: ActorRecord) -> dict:
        return {
            "actor_id": rec.actor_id,
            "name": rec.name,
            "state": rec.state,
            "addr": rec.addr,
            "node_id": rec.node_id,
            "worker_id": rec.worker_id,
            "restarts": rec.restarts,
            "error": rec.error,
            "max_concurrency": rec.spec.get("max_concurrency", 1),
        }


class GcsClient:
    """Thin sync/async facade over the GCS RPCs, usable from any process."""

    def __init__(self, endpoint: Endpoint, gcs_addr: tuple):
        self.endpoint = endpoint
        self.addr = tuple(gcs_addr)

    # async ------------------------------------------------------------------

    async def acall(self, method: str, payload: dict | None = None):
        return await self.endpoint.acall(self.addr, "gcs." + method, payload or {})

    # sync -------------------------------------------------------------------

    def call(self, method: str, payload: dict | None = None, timeout=60.0):
        if self.endpoint.on_loop():
            raise RuntimeError(
                f"blocking GCS call {method!r} from the endpoint loop "
                f"(async actor method?) would deadlock; use acall()"
            )
        return self.endpoint.call(
            self.addr, "gcs." + method, payload or {}, timeout=timeout
        )

    def kv_put(self, key: str, value: bytes, ns: str = "", overwrite=True):
        return self.call(
            "kv_put", {"ns": ns, "key": key, "value": value, "overwrite": overwrite}
        )

    def kv_get(self, key: str, ns: str = ""):
        return self.call("kv_get", {"ns": ns, "key": key})

    def kv_del(self, key: str, ns: str = ""):
        return self.call("kv_del", {"ns": ns, "key": key})

    def kv_keys(self, prefix: str = "", ns: str = ""):
        return self.call("kv_keys", {"ns": ns, "prefix": prefix})
