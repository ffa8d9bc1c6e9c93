"""ServeController actor: deployment reconciler + routing-table authority.
Port of ``ray_tpu/serve/controller.py``.

Reference parity: python/ray/serve/_private/controller.py:106 (control loop
:482, deploy_application :919) and the DeploymentState reconcilers
(_private/deployment_state.py), compressed into one actor: it owns the
target state, converges actual replica actors toward it, health-checks
them, and hands out versioned routing tables that routers poll.
"""

from __future__ import annotations

import asyncio
import time

import ray_tpu_torch
from ray_tpu_torch.core import api as core_api
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.serve import admission as _admission
from ray_tpu_torch.util.tasks import spawn

CONTROLLER_NAME = "serve::controller"
HEALTH_CHECK_PERIOD_S = 1.0
REGISTRATION_GRACE_S = 30.0


class ServeController:
    def __init__(self):
        # name -> {"config": dict, "payload": bytes, "init": bytes,
        #          "replicas": [(ActorHandle, started_at_monotonic)],
        #          "version": int,
        #          "next_replica_id": int}
        self._deployments: dict[str, dict] = {}
        self._version = 0
        # Edge-triggered change signal for long-polls: waiters grab the
        # CURRENT event; _bump replaces it and sets the old one, waking
        # every waiter exactly once per change (reference:
        # serve/_private/long_poll.py LongPollHost).
        self._version_event: asyncio.Event | None = None
        # replica_id -> (queue_len, monotonic, router_state): pushed by
        # replicas so the autoscaler/shed-state/router-state reads come
        # from a table instead of fanning out queue_len RPCs every tick.
        self._replica_metrics: dict[str, tuple] = {}
        self._loop_running = False
        self._proxy = None
        self._proxy_port = None
        self._grpc_port = None
        self._proxy_lock = asyncio.Lock()
        # Draining-node view cache (graceful drain / preemption): replicas
        # on a DRAINING node are proactively replaced — the replacement
        # lands on a healthy node (GCS placement skips draining views)
        # BEFORE the draining one dies, instead of the deployment eating a
        # replica-down window.
        self._draining_cache: tuple[float, set] = (0.0, set())

    # -- control plane API ----------------------------------------------------

    async def deploy(
        self, name: str, payload: bytes, init_payload: bytes, config: dict
    ) -> bool:
        self._ensure_control_loop()
        dep = self._deployments.get(name)
        if dep is None:
            dep = self._deployments[name] = {
                "replicas": [],
                "next_replica_id": 0,
            }
        # A code/init/actor-options change rolls every replica (scaling
        # num_replicas alone does not).
        roll = (
            dep.get("payload") != payload
            or dep.get("init") != init_payload
            or (dep.get("config") or {}).get("ray_actor_options")
            != config.get("ray_actor_options")
            or (dep.get("config") or {}).get("user_config")
            != config.get("user_config")
        )
        dep["config"] = dict(config)
        dep["payload"] = payload
        dep["init"] = init_payload
        if roll and dep["replicas"]:
            for r, _ in dep["replicas"]:
                try:
                    ray_tpu_torch.kill(r)
                except Exception:  # raylint: disable=RL006 -- redeploy kill of an old-version replica; already dead is success
                    pass
            dep["replicas"] = []
        dep["version"] = self._bump()
        await self._reconcile_one(name)
        return True

    async def delete_deployment(self, name: str) -> bool:
        dep = self._deployments.pop(name, None)
        if dep is None:
            return False
        self._bump()
        for r, _ in dep["replicas"]:
            try:
                ray_tpu_torch.kill(r)
            except Exception:  # raylint: disable=RL006 -- deployment delete kill; replica already dead
                pass
        return True

    @staticmethod
    def _base_target(dep: dict) -> int:
        """Configured floor: min_replicas when autoscaled, else
        num_replicas. Readiness and status report against this."""
        auto = dep["config"].get("autoscaling_config")
        if auto:
            return max(1, int(auto.get("min_replicas", 1)))
        return dep["config"].get("num_replicas", 1)

    async def wait_healthy(self, name: str, timeout_s: float = 120.0) -> bool:
        """Block until the deployment has its target number of READY
        replicas (used by serve.run). Readiness means the replica ANSWERS
        a ping — i.e. its __init__ finished — which is a stricter predicate
        than the GCS-state liveness the reconciler prunes by: a replica
        mid-model-load is alive but not yet servable, and one whose
        __init__ raises must never count as healthy."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            dep = self._deployments.get(name)
            if dep is not None:
                target = self._base_target(dep)
                replicas = [r for r, _ in dep["replicas"]]
                if len(replicas) >= target:
                    ready = await asyncio.gather(
                        *(self._ready(r) for r in replicas)
                    )
                    if sum(ready) >= target:
                        return True
            await asyncio.sleep(0.1)
        return False

    @staticmethod
    async def _ready(replica) -> bool:
        try:
            await core_api.get_async(replica.ping.remote(), timeout=5.0)
            return True
        except Exception:  # raylint: disable=RL006 -- ping probe: any failure IS the un-healthy verdict
            return False

    @staticmethod
    def _max_concurrent(cfg: dict) -> int:
        """Resolved per-replica concurrency budget: the deployment's
        max_concurrent_queries, else the serve_max_concurrent knob (the
        hoisted former hard-coded 8)."""
        return int(
            cfg.get("max_concurrent_queries")
            or GLOBAL_CONFIG.serve_max_concurrent
        )

    async def get_routing(self, name: str, version: int = -1) -> dict:
        """Routing table for one deployment. Routers pass their last seen
        version; a matching version returns just {"version": v} (cheap
        poll)."""
        dep = self._deployments.get(name)
        if dep is None:
            return {"version": -1, "replicas": None, "missing": True}
        if dep["version"] == version:
            return {"version": version}
        table = {
            "version": dep["version"],
            "replicas": [r for r, _ in dep["replicas"]],
            "max_concurrent": self._max_concurrent(dep["config"]),
            "affinity": dep["config"].get("request_affinity"),
            "affinity_config": dep["config"].get("request_affinity_config"),
        }
        # Overload plane: the resolved admission config plus the CURRENT
        # shed level ride the table (and every level change bumps the
        # version), so routers make admission decisions from state they
        # already hold — never a control-plane await on the request path.
        # With the kill switch thrown (RAY_TPU_ADMISSION=0) the table is
        # byte-identical to the pre-admission one.
        if GLOBAL_CONFIG.admission:
            info = _admission.resolve_admission_config(
                dep["config"].get("admission_config")
            )
            if info is not None:
                table["admission"] = info
                table["shed_level"] = dep.get("_shed_level", 0)
        # Disaggregated serving: per-replica roles ride the table (first
        # prefill_replicas entries in membership order are the prefill
        # tier; replacements appended by the reconciler re-balance on the
        # next table push). With the kill switch thrown
        # (RAY_TPU_DISAGG=0) the table is byte-identical to the unified
        # one — routers then never two-hop.
        if GLOBAL_CONFIG.disagg:
            dcfg = dep["config"].get("disagg_config")
            if dcfg:
                p = int(dcfg.get("prefill_replicas") or 0)
                table["disagg"] = {
                    "roles": {
                        r._actor_id: ("prefill" if i < p else "decode")
                        for i, (r, _) in enumerate(dep["replicas"])
                    }
                }
        return table

    async def poll_routing(
        self, name: str, version: int = -1, timeout_s: float = 30.0
    ) -> dict:
        """LONG-poll twin of get_routing: returns immediately when the
        deployment's table differs from ``version``, otherwise blocks until
        the next change (any _bump) or the timeout, then answers. Routers
        hold one of these open instead of polling on a period — updates
        push in one reconcile tick and an idle table costs zero round trips
        (reference: python/ray/serve/_private/long_poll.py)."""
        deadline = time.monotonic() + min(float(timeout_s), 60.0)
        while True:
            dep = self._deployments.get(name)
            if dep is None or dep["version"] != version:
                return await self.get_routing(name, version)
            if self._version_event is None:
                self._version_event = asyncio.Event()
            ev = self._version_event
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return {"version": version}
            try:
                await asyncio.wait_for(ev.wait(), timeout=remaining)
            except asyncio.TimeoutError:
                return {"version": version}

    async def push_metrics(
        self, replica_id: str, queue_len: int, router_state=None
    ) -> None:
        """Replica-pushed autoscaling metric (replaces per-tick queue_len
        fan-out; reference: replicas push autoscaling metrics to the
        controller via the long-poll/metrics channel). ``router_state``
        rides the same push: the replica callable's routing advertisement
        (prefix-pool digests + hit-rate/KV-util for LLM replicas) that
        routers read back through get_router_state."""
        self._replica_metrics[replica_id] = (
            int(queue_len), time.monotonic(), router_state,
        )

    async def get_replica_metrics(self) -> dict:
        """Pushed queue-length table (replica_id -> len); observability."""
        return {rid: m[0] for rid, m in self._replica_metrics.items()}

    async def get_router_state(self, name: str) -> dict:
        """Per-replica routing advertisement for one deployment:
        replica_id -> {queue_len, age_s, state} where ``state`` is what
        the replica's callable last pushed (None for callables that don't
        advertise). Routers poll this on a staleness window — it is a
        read of the pushed table, never a fan-out to replicas."""
        dep = self._deployments.get(name)
        if dep is None:
            return {}
        now = time.monotonic()
        out = {}
        for r, _ in dep["replicas"]:
            m = self._replica_metrics.get(r._actor_id)
            if m is None:
                continue
            out[r._actor_id] = {
                "queue_len": m[0],
                "age_s": round(now - m[1], 3),
                "state": m[2] if len(m) > 2 else None,
            }
        return out

    async def status(self) -> dict:
        return {
            name: {
                "target_replicas": self._base_target(dep),
                "live_replicas": len(dep["replicas"]),
                "replica_ids": [r._actor_id for r, _ in dep["replicas"]],
                "version": dep["version"],
            }
            for name, dep in self._deployments.items()
        }

    # -- reconciliation -------------------------------------------------------

    def _ensure_control_loop(self) -> None:
        """Start the reconcile loop as a background asyncio task on first
        deploy. NOT a remote actor call: actor tasks from one caller are
        ordered, so an infinite call would block every later call behind
        it."""
        if not self._loop_running:
            self._loop_running = True
            spawn(self._control_loop(), name="serve control loop")

    async def _control_loop(self) -> None:
        """Run forever: converge replicas toward target state and replace
        dead ones."""
        import logging

        log = logging.getLogger("ray_tpu_torch.serve")
        while True:
            for name in list(self._deployments):
                try:
                    await self._reconcile_one(name)
                    self._update_shed_state(name)
                except Exception:  # noqa: BLE001 — per-deployment: one
                    # broken deployment must not starve the others
                    log.exception(
                        "serve controller reconcile failed for %r", name
                    )
            # Prune pushed metrics of replicas no longer in any deployment
            # (the table must not grow with replica churn).
            live = {
                r._actor_id
                for dep in self._deployments.values()
                for r, _ in dep["replicas"]
            }
            for rid in [
                r for r in self._replica_metrics if r not in live
            ]:
                del self._replica_metrics[rid]
            await asyncio.sleep(HEALTH_CHECK_PERIOD_S)

    async def _draining_nodes(self) -> set:
        """Node ids currently DRAINING, cached for one health-check period
        (one cluster-view RPC per tick, not one per replica)."""
        ts, cached = self._draining_cache
        now = time.monotonic()
        if now - ts < HEALTH_CHECK_PERIOD_S:
            return cached
        worker = core_api._require_worker(auto_init=False)
        try:
            view = await worker.gcs.acall("get_cluster_view")
        except Exception:  # raylint: disable=RL006 -- GCS hiccup: keep the last verdicts
            return cached  # GCS hiccup: keep the last verdicts
        draining = {
            nid for nid, v in view.items() if v.get("draining")
        }
        self._draining_cache = (now, draining)
        return draining

    async def _ping_all(self, entries: list) -> list:
        """Liveness by GCS actor STATE, not by ping latency: a replica
        whose heavy __init__ (model load, jit compile) outlasts a ping
        timeout is STARTING, not dead — treating it as dead used to drop
        it from the table without killing it, leaking its CPU and spiraling
        into replace-churn until the cluster was out of resources.

        A replica the GCS does not know yet gets a registration grace:
        the controller is an async actor, so create_actor registration is
        fire-and-forget and may land after the first reconcile tick.

        A replica on a DRAINING node counts as not-ok: the reconciler
        replaces it NOW (on a node the scheduler still likes) instead of
        waiting for the drain deadline to kill it — preemption-aware
        rebalance rather than a replica-down window."""
        worker = core_api._require_worker(auto_init=False)
        draining = await self._draining_nodes()
        out = []
        now = time.monotonic()
        for r, started_at in entries:
            try:
                info = await worker.gcs.acall(
                    "get_actor", {"actor_id": r._actor_id}
                )
            except Exception:
                out.append(True)  # GCS hiccup: keep, re-check next tick
                continue
            if info is None:
                out.append(now - started_at < REGISTRATION_GRACE_S)
            else:
                out.append(
                    info.get("state") != "DEAD"
                    and info.get("node_id") not in draining
                )
        return out

    async def _autoscale_target(self, dep: dict) -> int:
        """Demand-driven replica target (reference:
        serve/autoscaling_policy.py + _private/autoscaling_state.py):
        desired = ceil(total ongoing requests / target_ongoing_requests),
        clamped to [min, max]; upscale applies immediately, downscale only
        after demand stays low for downscale_delay_s. min_replicas is
        floored at 1 (scale-from-zero needs router-side demand metrics
        this design does not collect)."""
        import math

        auto = dep["config"]["autoscaling_config"]
        target_ongoing = max(float(auto.get("target_ongoing_requests", 2)), 0.1)
        lo = max(1, int(auto.get("min_replicas", 1)))
        hi = int(auto.get("max_replicas", max(lo, 1)))
        delay_s = float(auto.get("downscale_delay_s", 30.0))
        current = max(len(dep["replicas"]), 1)

        async def one_len(r):
            # Pushed metric first (replicas report on-change + heartbeat);
            # RPC fallback only for replicas with no fresh push (e.g. still
            # starting) so a silent replica cannot stall downscaling.
            pushed = self._replica_metrics.get(r._actor_id)
            if pushed is not None and time.monotonic() - pushed[1] < 7.0:
                return pushed[0]
            try:
                return await core_api.get_async(
                    r.queue_len.remote(), timeout=2.0
                )
            except Exception:  # raylint: disable=RL006 -- starting/dead replica contributes no queue demand
                return 0  # starting/dead: contributes no demand

        lens = await asyncio.gather(
            *(one_len(r) for r, _ in dep["replicas"])
        )
        total = float(sum(lens))
        desired = max(lo, min(hi, math.ceil(total / target_ongoing)))
        if desired >= current:
            dep.pop("_low_since", None)
            return desired
        # downscale: require sustained low demand
        now = time.monotonic()
        low_since = dep.setdefault("_low_since", now)
        if now - low_since >= delay_s:
            dep.pop("_low_since", None)
            return desired
        return current

    async def _reconcile_one(self, name: str) -> None:
        dep = self._deployments.get(name)
        if dep is None:
            return
        # Prune dead replicas FIRST: a stale entry would both inflate the
        # autoscaler's "current" and absorb a start slot.
        if dep["replicas"]:
            alive = await self._ping_all(dep["replicas"])
            if not all(alive):
                for (r, _), ok in zip(dep["replicas"], alive):
                    if not ok:
                        try:  # release its worker even if half-alive
                            ray_tpu_torch.kill(r)
                        except Exception:  # raylint: disable=RL006 -- release its worker even if half-alive
                            pass
                dep["replicas"] = [
                    entry for entry, ok in zip(dep["replicas"], alive) if ok
                ]
                dep["version"] = self._bump()
        if dep["config"].get("autoscaling_config"):
            target = await self._autoscale_target(dep)
        else:
            target = dep["config"].get("num_replicas", 1)
        # Start missing replicas.
        started = False
        while len(dep["replicas"]) < target:
            dep["replicas"].append(
                (self._start_replica(name, dep), time.monotonic())
            )
            dep["next_replica_id"] += 1
            started = True
        # Stop surplus replicas (scale down).
        while len(dep["replicas"]) > target:
            victim, _ = dep["replicas"].pop()
            started = True
            try:
                ray_tpu_torch.kill(victim)
            except Exception:  # raylint: disable=RL006 -- downscale kill; victim already dead
                pass
        if started:
            dep["version"] = self._bump()

    def _update_shed_state(self, name: str) -> None:
        """One watermark-tracker tick for an admission-enabled deployment:
        feed the PUSHED per-replica queue depths (and any advertised
        rolling TTFT) into the hysteresis state machine; a level change
        bumps the routing version so the long-poll pushes the new shed
        level to every router within one tick."""
        dep = self._deployments.get(name)
        if dep is None or not GLOBAL_CONFIG.admission:
            return
        info = _admission.resolve_admission_config(
            dep["config"].get("admission_config")
        )
        if info is None:
            return
        tracker = dep.get("_shed_tracker")
        if tracker is None:
            tracker = dep["_shed_tracker"] = _admission.WatermarkTracker(
                info
            )
        elif tracker.cfg != info:
            # A reconfig must not reset live shed state: swap the config
            # in place, keeping the level AND the down-hold dwell clock
            # (recreating mid-dwell would silently defer recovery a full
            # extra hold period).
            tracker.cfg = info
        now = time.monotonic()
        depths, ttft_ms = [], 0.0
        for r, _ in dep["replicas"]:
            m = self._replica_metrics.get(r._actor_id)
            # Freshness guard (same 7 s window the autoscaler applies): a
            # replica whose reporter wedged mid-spike must not pin the
            # shed level on a frozen queue depth forever.
            if m is None or now - m[1] >= 7.0:
                continue
            depths.append(m[0])
            state = m[2]
            if isinstance(state, dict):
                ttft_ms = max(ttft_ms, float(state.get("ttft_ms") or 0.0))
        mean_q = sum(depths) / len(depths) if depths else 0.0
        level = tracker.update(mean_q, ttft_ms, now)
        if level != dep.get("_shed_level", 0):
            dep["_shed_level"] = level
            dep["version"] = self._bump()
        _admission.set_shed_gauge(name, level)

    def _start_replica(self, name: str, dep: dict):
        import uuid

        from ray_tpu_torch.serve.replica import ReplicaActor

        cfg = dep["config"]
        opts = dict(cfg.get("ray_actor_options") or {})
        opts.setdefault("num_cpus", 1)
        # uuid suffix: a delete + redeploy under the same name must never
        # collide with a prior generation's replica name still pending its
        # (async) kill in the GCS.
        opts["name"] = (
            f"serve::{name}#{dep['next_replica_id']}-{uuid.uuid4().hex[:6]}"
        )
        mc = self._max_concurrent(cfg)
        queue_cap = 0
        if (
            GLOBAL_CONFIG.admission
            and cfg.get("admission_config") is not None
            and GLOBAL_CONFIG.serve_queue_cap_factor > 0
        ):
            # Bounded replica queue: in-flight beyond the cap fails fast
            # back to the router; in-cap surplus waits on the replica's
            # execution semaphore (sized mc + 2 — the pre-plane width, so
            # opting in never widens concurrent execution). The actor's
            # task concurrency sits two above the CAP so the rejection
            # handler always has a slot to RUN in — a full replica must
            # shed instantly, not queue the shed decision behind the work
            # it is shedding.
            queue_cap = max(
                1, int(mc * GLOBAL_CONFIG.serve_queue_cap_factor)
            )
        opts["max_concurrency"] = (queue_cap or mc) + 2
        cls = ray_tpu_torch.remote(ReplicaActor)
        return cls.options(**opts).remote(
            name,
            dep["payload"],
            dep["init"],
            cfg.get("user_config"),
            queue_cap,
            mc,
        )

    def _bump(self) -> int:
        self._version += 1
        ev = self._version_event
        if ev is not None:
            self._version_event = None
            ev.set()
        return self._version

    # -- ingress --------------------------------------------------------------

    async def ensure_proxy(self, host: str, port: int) -> int:
        """Start (or return) the HTTP proxy actor; returns the bound port.
        Requesting a specific port while the proxy already listens on a
        different one is an error (not a silent ignore)."""
        async with self._proxy_lock:  # concurrent runs: one proxy, ever
            if self._proxy is not None:
                if port not in (0, self._proxy_port):
                    raise RuntimeError(
                        f"serve proxy already listening on port "
                        f"{self._proxy_port}; cannot rebind to {port}"
                    )
                return self._proxy_port
            from ray_tpu_torch.serve.proxy import HTTPProxyActor

            cls = ray_tpu_torch.remote(HTTPProxyActor)
            controller = await core_api.get_actor_async(CONTROLLER_NAME)
            proxy = cls.options(
                name="serve::proxy", num_cpus=0, max_concurrency=256
            ).remote(controller)
            ref = proxy.start.remote(host, port)
            self._proxy_port = await core_api.get_async(ref, timeout=30)
            self._proxy = proxy
            return self._proxy_port

    async def ensure_grpc(self, host: str, port: int) -> int:
        """Start (or return) the gRPC ingress on the proxy actor (which is
        started first if needed); returns the bound port (reference:
        serve/_private/proxy.py:534 gRPCProxy)."""
        await self.ensure_proxy(host, 0)
        async with self._proxy_lock:
            if self._grpc_port is not None:
                if port not in (0, self._grpc_port):
                    raise RuntimeError(
                        f"serve gRPC ingress already on port "
                        f"{self._grpc_port}; cannot rebind to {port}"
                    )
                return self._grpc_port
            ref = self._proxy.start_grpc.remote(host, port)
            self._grpc_port = await core_api.get_async(ref, timeout=30)
            return self._grpc_port

    async def shutdown_serve(self) -> bool:
        for name in list(self._deployments):
            await self.delete_deployment(name)
        if self._proxy is not None:
            try:
                ray_tpu_torch.kill(self._proxy)
            except Exception:  # raylint: disable=RL006 -- proxy kill during shutdown; already dead
                pass
            self._proxy = None
            self._proxy_port = None
            self._grpc_port = None  # a reused controller must restart the
            # ingress on the NEW proxy, not hand out the dead port
        return True
