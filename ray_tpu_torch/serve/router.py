"""Power-of-two-choices request router. Port of ``ray_tpu/serve/router.py``.

Reference parity: python/ray/serve/_private/router.py:473 +
request_router/pow_2_router.py:27. Each router keeps a local in-flight
estimate per replica, picks the less-loaded of two random candidates, and
retries on dead replicas after refreshing the (versioned) routing table
from the controller.
"""

from __future__ import annotations

import asyncio
import itertools
import os as _os
import random
import time as _time

from ray_tpu_torch.core import api as core_api
from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.core.errors import (
    ActorDiedError,
    ActorUnavailableError,
    OverloadedError,
    TaskError,
)
from ray_tpu_torch.serve import admission as _admission
from ray_tpu_torch.util import flightrec as _flightrec
from ray_tpu_torch.util import metrics as _metrics
from ray_tpu_torch.util.prefix_digest import chat_prompt, prompt_digests

# Flight-recorder request ids: stitch the router's phase events to the
# replica's (the id rides the dispatch as an extra, recorder-only RPC
# arg — with RAY_TPU_FLIGHTREC=0 the wire call is byte-identical to the
# pre-recorder tree). A counter, not a uuid: ids only need to be unique
# within one process's rings, and a seeded run's id sequence stays
# deterministic for the golden-export tests.
_frid_counter = itertools.count()


def _next_frid() -> str:
    return f"fr-{_os.getpid()}-{next(_frid_counter)}"

# Serve request SLO series, recorded in the routing process (driver or
# proxy) and shipped through the standard push path. Request latency
# decomposes as router wait (here) + replica execution
# (raytpu_serve_replica_exec_seconds, recorded replica-side).
_ROUTER_WAIT = _metrics.Histogram(
    "raytpu_serve_router_wait_seconds",
    "time a request spends in the router before replica dispatch "
    "(table refresh + retry backoff included)",
    boundaries=_metrics.LATENCY_BOUNDARIES_S,
    tag_keys=("deployment",),
)
_REQUESTS = _metrics.Counter(
    "raytpu_serve_requests_total",
    "requests routed, per deployment (QPS = rate of this)",
    tag_keys=("deployment",),
)
_ERRORS = _metrics.Counter(
    "raytpu_serve_errors_total",
    "requests that failed after all routing retries, per deployment",
    tag_keys=("deployment",),
)
# Prefix-affinity routing outcome, recorded per routed request on
# prompt_prefix deployments with digest routing enabled: a hit landed on
# a replica whose ADVERTISED prefix pool already held the prompt's
# leading blocks; a miss fell back to load-only pow-2 (nothing
# advertised/matched, or the hot replica was saturated).
_PREFIX_ROUTE_HITS = _metrics.Counter(
    "raytpu_serve_prefix_route_hits_total",
    "requests routed to a replica whose advertised prefix pool already "
    "held the prompt's leading blocks",
    tag_keys=("deployment",),
)
_PREFIX_ROUTE_MISSES = _metrics.Counter(
    "raytpu_serve_prefix_route_misses_total",
    "prefix-routable requests that fell back to load-only pow-2 "
    "(digest miss or saturated hot replica)",
    tag_keys=("deployment",),
)
# Disaggregated serving: requests whose prefill ran on a prefill-role
# replica and whose KV handoff was dispatched to a decode-role replica
# (the two-hop placement). Requests that fell back to unified routing
# (hop failure, empty role set, kill switch) are NOT counted.
_DISAGG_HANDOFFS = _metrics.Counter(
    "raytpu_serve_disagg_handoffs_total",
    "requests routed through the disaggregated prefill->decode two-hop",
    tag_keys=("deployment",),
)


class DeploymentNotFoundError(ValueError):
    """No deployment with this name exists (routing table says missing)."""

ROUTE_RETRIES = 8
DEAD_MEMORY_S = 30.0


class _RequestAdmission:
    """Per-request admission state shared by route()/route_stream(): the
    once-per-request check, the exactly-one-counter-event invariant, and
    the bounded-queue retry-once classification — ONE copy, so the
    invariants pinned by test_drain_during_overload_never_double_sheds
    cannot drift between the buffered and streaming paths."""

    __slots__ = (
        "_router", "_args", "_kwargs", "tenant", "priority",
        "_admitted", "_counted", "exclude", "last_overload",
    )

    def __init__(
        self, router: "Router", args: tuple, kwargs: dict,
        tenant: str, priority: str,
    ):
        self._router = router
        self._args, self._kwargs = args, kwargs
        self.tenant, self.priority = tenant, priority
        self._admitted = False
        self._counted = False
        # The one replica a bounded-queue retry must avoid.
        self.exclude: str | None = None
        # A rejection held when the retry budget ran out: the final
        # verdict is then a shed (429 contract), not a 500.
        self.last_overload: OverloadedError | None = None

    def ensure_checked(self) -> None:
        """Admission, once, before the first dispatch: raises
        OverloadedError (shed/throttled — counted by the check itself)."""
        if self._admitted:
            return
        router = self._router
        if router._admission_on():
            self.tenant, self.priority = router._resolve_identity(
                self._args, self._kwargs, self.tenant, self.priority
            )
            router._admission.check(
                self.tenant, self.priority, router._shed_level
            )
        else:
            self._counted = True  # plane off: nothing to count, ever
        self._admitted = True

    def count_once(self, decision: str) -> None:
        if self._admitted and not self._counted:
            self._counted = True
            self._router._count_admission(decision, self.priority)

    def retry_overload(self, ov: OverloadedError, rid: str) -> bool:
        """Classify a replica's bounded-queue rejection: True = retry
        ONCE on a different replica (no backoff); False = the verdict is
        a shed (already counted) and the caller raises ``ov``."""
        if self.exclude is not None or len(self._router._replicas) <= 1:
            self.count_once("shed")
            return False
        self.exclude = rid
        self.last_overload = ov  # the loop may end before the retry runs
        return True

    def exhausted(self) -> OverloadedError | None:
        """End-of-retry-loop verdict: the held rejection to raise as a
        shed, or None (the request counts as admitted — it failed, if it
        failed, for non-overload reasons)."""
        if self.last_overload is not None:
            self.count_once("shed")
            return self.last_overload
        self.count_once("admitted")
        return None


class Router:
    def __init__(self, controller, deployment: str):
        self._controller = controller
        self._deployment = deployment
        self._replicas: list = []
        self._version = -2  # never fetched
        self._inflight: dict[str, int] = {}  # actor_id -> local estimate
        # Replicas this router OBSERVED dying: filtered out of refreshed
        # tables until the controller's reconciler has certainly purged
        # them (the table it serves can be stale by one health-check
        # period).
        self._recently_dead: dict[str, float] = {}
        # Multiplexing affinity: model_id -> replica ids this router
        # recently routed that model to (their memory likely holds the
        # weights). Router-local heuristic (reference keeps it in replica
        # info pushed via the controller; a local cache converges the same
        # way without the control-plane round trip).
        self._model_replicas: dict[str, list] = {}
        # Long-poll listener: one open poll_routing call against the
        # controller pushes table changes within a reconcile tick, so
        # routers neither poll on a period nor serve stale membership
        # (reference: serve/_private/long_poll.py LongPollClient).
        self._listen_task: asyncio.Task | None = None
        # Deployment-declared request affinity ("prompt_prefix"): requests
        # with a shared prompt prefix stick to replicas whose prefix-KV
        # pool is warm (reference: prefix_aware_router.py).
        self._affinity: str | None = None
        # Digest contract for prefix routing ({"scheme", "chunk"}, from
        # the deployment config) and the last replica-state table fetched
        # from the controller: replica_id -> {queue_len, age_s, state}.
        # The table refreshes in the BACKGROUND on a staleness window —
        # routing never awaits the control plane.
        self._affinity_cfg: dict | None = None
        self._replica_state: dict = {}
        self._state_fetched = 0.0
        self._state_task: asyncio.Task | None = None
        self._max_concurrent = GLOBAL_CONFIG.serve_max_concurrent
        # Overload plane (serve/admission.py): the deployment's resolved
        # admission config and current shed level ride the routing table,
        # so every admission decision here is local — never a
        # control-plane await. None = the deployment did not opt in (or
        # RAY_TPU_ADMISSION=0 stripped the table keys).
        self._admission: _admission.AdmissionController | None = None
        self._shed_level = 0
        # Disaggregated serving: per-replica roles from the routing table
        # ({actor_id: "prefill"|"decode"}; empty = unified deployment or
        # RAY_TPU_DISAGG=0 stripped them).
        self._disagg_roles: dict = {}

    def close(self) -> None:
        for attr in ("_listen_task", "_state_task"):
            task = getattr(self, attr)
            setattr(self, attr, None)
            if task is not None:
                # close() is called from the driver thread; the task lives
                # on the endpoint loop — cancel must hop threads.
                task.get_loop().call_soon_threadsafe(task.cancel)

    def _ensure_listener(self) -> None:
        if self._listen_task is None or self._listen_task.done():
            self._listen_task = asyncio.ensure_future(self._listen_loop())

    async def _listen_loop(self) -> None:
        while True:
            try:
                table = await core_api.get_async(
                    self._controller.poll_routing.remote(
                        self._deployment, self._version, 30.0
                    ),
                    timeout=45,
                )
                if table.get("missing"):
                    # Deployment deleted: stop listening; the next route()
                    # raises DeploymentNotFoundError via _refresh.
                    self._version = -2
                    self._replicas = []
                    return
                self._apply(table)
            except (ActorDiedError, ActorUnavailableError):
                if not await self._reresolve_controller():
                    # Controller gone for good (from this listener's view):
                    # force the next route() through _refresh so it both
                    # re-resolves and restarts a listener, instead of
                    # serving this frozen table forever.
                    self._version = -2
                    return
            except asyncio.CancelledError:
                raise
            except Exception:
                await asyncio.sleep(1.0)

    async def _reresolve_controller(self) -> bool:
        """Controller crashed and was re-created WITHOUT serve.shutdown():
        re-resolve the named actor so every cached handle recovers."""
        from ray_tpu_torch.serve.controller import CONTROLLER_NAME

        for _ in range(10):
            try:
                self._controller = await core_api.get_actor_async(
                    CONTROLLER_NAME
                )
                self._version = -2  # force a full table on next poll
                return True
            except Exception:
                await asyncio.sleep(1.0)
        return False

    @staticmethod
    def _extract_prompt(args: tuple, kwargs: dict) -> str:
        """The prompt text the LLM replica will tokenize, reconstructed
        from the request envelope by the SAME rules serve_llm applies
        (chat path -> the shared chat_prompt join; everything else ->
        body['prompt']) — digest routing hashes this text, and a
        divergence would silently turn requests into digest misses."""
        req = args[0] if args else kwargs.get("request")
        if not isinstance(req, dict):
            return ""
        body = req.get("body")
        body = body if isinstance(body, dict) else req
        if str(req.get("path", "")).endswith("/v1/chat/completions"):
            msgs = body.get("messages")
            return chat_prompt(msgs) if isinstance(msgs, list) else ""
        prompt = body.get("prompt") or ""
        if not prompt:
            # Envelope without a path (plain handle calls): fall back to
            # messages so chat-shaped bodies still get an affinity key.
            msgs = body.get("messages")
            if isinstance(msgs, list):
                return chat_prompt(msgs)
        return str(prompt)

    def _affinity_key(self, args: tuple, kwargs: dict) -> str:
        """Derive the routing-affinity key for prompt-prefix deployments:
        a hash of the request's first 256 prompt characters. Rides the
        same affinity table model-multiplexing uses."""
        if self._affinity != "prompt_prefix":
            return ""
        prefix = self._extract_prompt(args, kwargs)[:256]
        if not prefix:
            return ""
        import hashlib

        return "px:" + hashlib.sha1(prefix.encode()).hexdigest()[:16]

    def _prompt_digests(self, args: tuple, kwargs: dict) -> list:
        """Block digests of the request's prompt under the deployment's
        advertised hashing contract ([] when the contract/scheme is
        unknown — the router then routes on load alone)."""
        cfg = self._affinity_cfg or {}
        text = self._extract_prompt(args, kwargs)
        if not text:
            return []
        return prompt_digests(
            text, int(cfg.get("chunk") or 0), cfg.get("scheme") or ""
        )

    def _apply(self, table: dict) -> None:
        if table.get("replicas") is None:
            return
        self._affinity = table.get("affinity")
        self._affinity_cfg = table.get("affinity_config")
        self._max_concurrent = (
            table.get("max_concurrent") or GLOBAL_CONFIG.serve_max_concurrent
        )
        self._shed_level = int(table.get("shed_level") or 0)
        self._disagg_roles = (table.get("disagg") or {}).get("roles") or {}
        adm = table.get("admission")
        if isinstance(adm, dict):
            if self._admission is None:
                self._admission = _admission.AdmissionController(
                    self._deployment, adm
                )
            elif self._admission.config != adm:
                self._admission.reconfigure(adm)
        else:
            self._admission = None
        import time

        now = time.monotonic()
        self._recently_dead = {
            rid: t
            for rid, t in self._recently_dead.items()
            if now - t < DEAD_MEMORY_S
        }
        self._replicas = [
            r
            for r in table["replicas"]
            if r._actor_id not in self._recently_dead
        ]
        self._version = table["version"]
        self._inflight = {
            r._actor_id: self._inflight.get(r._actor_id, 0)
            for r in self._replicas
        }
        # Affinity lists must track membership: a replaced replica's id
        # would otherwise sit in every list it ever joined, for the
        # router's whole lifetime (the lists are bounded per key, but a
        # long-lived router sees unbounded replica churn).
        alive = set(self._inflight)
        for key in list(self._model_replicas):
            kept = [rid for rid in self._model_replicas[key] if rid in alive]
            if kept:
                self._model_replicas[key] = kept
            else:
                del self._model_replicas[key]

    def _forget_replica(self, rid: str) -> None:
        """Drop a dead replica from every affinity list NOW (the next
        table refresh would prune it too, but the router keeps routing —
        and must not keep preferring — in between)."""
        for key in list(self._model_replicas):
            reps = self._model_replicas[key]
            if rid in reps:
                reps.remove(rid)
                if not reps:
                    del self._model_replicas[key]

    async def _refresh(self, force: bool = False) -> None:
        try:
            table = await core_api.get_async(
                self._controller.get_routing.remote(
                    self._deployment, -1 if force else self._version
                ),
                timeout=30,
            )
        except (ActorDiedError, ActorUnavailableError):
            # Controller crashed and was re-created WITHOUT serve.shutdown()
            # (so the process-wide router cache was never cleared): the
            # cached handle points at the dead incarnation. Re-resolve by
            # name and retry once so every cached handle recovers.
            from ray_tpu_torch.serve.controller import CONTROLLER_NAME

            self._controller = await core_api.get_actor_async(
                CONTROLLER_NAME
            )
            table = await core_api.get_async(
                self._controller.get_routing.remote(self._deployment, -1),
                timeout=30,
            )
        if table.get("missing"):
            raise DeploymentNotFoundError(
                f"no deployment named {self._deployment!r}"
            )
        self._apply(table)
        self._ensure_listener()

    def _prefix_routing_on(self) -> bool:
        """Digest-based prefix routing applies: the deployment declared
        prompt_prefix affinity WITH a digest contract, and the kill
        switch (RAY_TPU_PREFIX_ROUTING=0) is not thrown. Off, the
        plain pow-2 + local-affinity-table path runs untouched
        (no digest lookups, no state fetches; the px: key hashes the
        same chat-prompt text the replica tokenizes)."""
        return (
            GLOBAL_CONFIG.prefix_routing
            and self._affinity == "prompt_prefix"
            and bool(self._affinity_cfg)
        )

    def _maybe_refresh_state(self) -> None:
        """Keep the replica digest table within the staleness window via
        a background fetch; routing itself never awaits the controller
        (a stale digest costs at most one avoidable re-prefill)."""
        import time

        now = time.monotonic()
        if now - self._state_fetched < GLOBAL_CONFIG.prefix_route_staleness_s:
            return
        if self._state_task is not None and not self._state_task.done():
            return
        self._state_fetched = now  # claim the window before the fetch lands
        self._state_task = asyncio.ensure_future(self._fetch_state())

    async def _fetch_state(self) -> None:
        try:
            state = await core_api.get_async(
                self._controller.get_router_state.remote(self._deployment),
                timeout=10,
            )
            if isinstance(state, dict):
                self._replica_state = state
        except Exception:  # raylint: disable=RL006 -- keep the stale table; the next window retries
            pass  # keep the stale table; the next window retries

    # Saturation floor for the digest-preferred replica. Unlike the
    # multiplex margin (+2 — a replica running one model at a time), an
    # LLM replica CONTINUOUS-BATCHES: it absorbs up to its concurrency
    # budget of streams at little marginal cost, so prefix warmth is
    # worth riding out a burst of half that budget before spilling to a
    # load-picked replica (which prefills once, pools the prefix,
    # advertises it, and joins the hot set — capacity follows demand).
    PREFIX_SPILL_MARGIN = 2

    def _pick_prefix(
        self, digests: list, count: bool = True, candidates: list | None = None
    ):
        """The replica whose ADVERTISED prefix pool holds the longest
        leading-block match for this prompt, or None to fall back to
        load-only routing (no match anywhere, or the matched replica is
        saturated). ``digests`` are shortest-first consecutive chain
        hashes, so the match length is the highest matching index + 1.
        ``count=False`` suppresses the outcome counters (dead-replica
        RETRIES of one request must not double-count it, and an
        attempt-1 'hit' that then died avoided no re-prefill)."""
        candidates = candidates if candidates is not None else self._replicas
        alive = {r._actor_id: r for r in candidates}
        best, best_score = None, 0
        for rid, info in self._replica_state.items():
            r = alive.get(rid)
            adv = ((info or {}).get("state") or {}).get("digests")
            if r is None or not adv:
                continue
            aset = set(adv)
            score = 0
            for i, d in enumerate(digests):
                if d in aset:
                    score = i + 1
            if score > best_score:
                best, best_score = r, score
        tags = {"deployment": self._deployment}
        instrument = count and _metrics.metrics_enabled()
        if best is None:
            if instrument:
                _PREFIX_ROUTE_MISSES.inc(1.0, tags)
            return None
        load = lambda r: self._inflight.get(r._actor_id, 0)  # noqa: E731
        others = [r for r in candidates if r is not best]
        margin = max(self.PREFIX_SPILL_MARGIN, self._max_concurrent // 2)
        if others and load(best) > min(map(load, others)) + margin:
            if instrument:
                _PREFIX_ROUTE_MISSES.inc(1.0, tags)
            return None
        if instrument:
            _PREFIX_ROUTE_HITS.inc(1.0, tags)
        return best

    def _pick(
        self,
        model_id: str = "",
        digests: list | None = None,
        count_prefix: bool = True,
        exclude: str | None = None,
        candidates: list | None = None,
    ):
        """Power of two choices on the local in-flight estimates; with a
        model id, prefer replicas that model was recently routed to (its
        weights are probably still resident — reference: multiplexed
        routing in python/ray/serve/_private/replica_scheduler). With
        prompt digests, first prefer the replica whose advertised prefix
        pool already holds them (prefix-affinity routing). ``exclude``
        drops one replica from consideration — the overload retry must
        land on a DIFFERENT replica than the one that just failed fast
        (when one exists). ``candidates`` restricts the choice to a
        subset of the table (disaggregated role picks); an empty subset
        falls back to the full membership."""
        if candidates is None or not candidates:
            candidates = self._replicas
        if exclude is not None:
            filtered = [r for r in candidates if r._actor_id != exclude]
            if filtered:
                candidates = filtered
        if len(candidates) == 1:
            return candidates[0]
        if digests:
            best = self._pick_prefix(
                digests, count=count_prefix, candidates=candidates
            )
            if best is not None:
                return best
        if model_id:
            alive = {r._actor_id: r for r in candidates}
            known = [
                alive[rid]
                for rid in self._model_replicas.get(model_id, [])
                if rid in alive
            ]
            if known:
                load = lambda r: self._inflight.get(r._actor_id, 0)  # noqa
                best = min(known, key=load)
                others = [r for r in candidates if r not in known]
                # Affinity holds only while the model's replicas aren't
                # clearly hotter than the rest: a saturated hot model must
                # SPILL to a fresh replica (which loads the weights and
                # joins the affinity set) rather than cap at one replica.
                if not others or load(best) <= min(map(load, others)) + 2:
                    return best
        a, b = random.sample(candidates, 2)
        return (
            a
            if self._inflight.get(a._actor_id, 0)
            <= self._inflight.get(b._actor_id, 0)
            else b
        )

    # Affinity-table key budget: prefix keys ("px:...") are effectively
    # per-distinct-prompt, so unlike multiplex model ids the key space is
    # unbounded — LRU past this cap.
    MAX_AFFINITY_KEYS = 512

    def _note_model(self, model_id: str, rid: str) -> None:
        if not model_id:
            return
        reps = self._model_replicas.get(model_id)
        if reps is None:
            reps = self._model_replicas[model_id] = []
        else:
            # Keep insertion order ~= recency so cap eviction drops the
            # coldest keys (dict preserves insertion order).
            self._model_replicas[model_id] = self._model_replicas.pop(
                model_id
            )
        if len(self._model_replicas) > self.MAX_AFFINITY_KEYS:
            # Prefer evicting prefix keys ("px:"): their space is
            # unbounded, while multiplex model ids are naturally few AND
            # expensive to lose (a cold replica reloads the model). But
            # the cap is HARD — if a caller floods distinct model ids,
            # oldest ids evict too; bounded memory beats warm affinity.
            for key in [
                k for k in self._model_replicas if k.startswith("px:")
            ]:
                if len(self._model_replicas) <= self.MAX_AFFINITY_KEYS:
                    break
                if key != model_id:
                    self._model_replicas.pop(key)
            while len(self._model_replicas) > self.MAX_AFFINITY_KEYS:
                oldest = next(
                    k for k in self._model_replicas if k != model_id
                )
                self._model_replicas.pop(oldest)
        if rid in reps:
            return
        reps.append(rid)
        if len(reps) > 4:  # bound the memory per model
            reps.pop(0)

    # -- disaggregated two-hop (llm/disagg.py) --------------------------------

    def _role_replicas(self, role: str) -> list:
        roles = self._disagg_roles
        return [r for r in self._replicas if roles.get(r._actor_id) == role]

    def _disagg_active(self) -> bool:
        """Two-hop placement applies: the table advertises roles (the
        controller strips them under RAY_TPU_DISAGG=0), the runtime knob
        agrees, and both tiers currently have members."""
        return (
            bool(self._disagg_roles)
            and GLOBAL_CONFIG.disagg
            and bool(self._role_replicas("prefill"))
            and bool(self._role_replicas("decode"))
        )

    async def _prefill_hop(
        self, args: tuple, kwargs: dict, model_id: str, payload: bytes
    ):
        """First hop of disaggregated placement: land the request's
        prefill on a prefill-role replica (prefix-digest bias preserved
        among that tier) and return the handoff descriptor, or None — ANY
        failure (dead/overloaded prefill replica, dense engine, engine
        error) degrades to unified routing over the full membership, so
        the prefill tier can never take availability down with it.
        ``payload`` is the caller's already-serialized (args, kwargs) —
        at hop time it is still the original, handoff-free dump."""
        request = args[0] if args else None
        if not isinstance(request, dict):
            return None
        digests = None
        if self._prefix_routing_on():
            self._maybe_refresh_state()
            digests = self._prompt_digests(args, kwargs)
        replica = self._pick(
            "", digests, count_prefix=True,
            candidates=self._role_replicas("prefill"),
        )
        rid = replica._actor_id
        self._inflight[rid] = self._inflight.get(rid, 0) + 1
        try:
            out = await core_api.get_async(
                replica.handle.remote("prefill_handoff", payload, model_id)
            )
        except (ActorDiedError, ActorUnavailableError):
            import time

            self._recently_dead[rid] = time.monotonic()
            self._replicas = [
                r for r in self._replicas if r._actor_id != rid
            ]
            self._forget_replica(rid)
            self._version = -2
            return None
        except Exception:  # raylint: disable=RL006 -- hop failure (overload, deadline, engine error) degrades to unified routing
            return None
        finally:
            if rid in self._inflight:
                self._inflight[rid] -= 1
        if (
            not isinstance(out, dict)
            or out.get("unsupported")
            or out.get("error")
            or "first_token" not in out
        ):
            return None
        if _metrics.metrics_enabled():
            _DISAGG_HANDOFFS.inc(1.0, {"deployment": self._deployment})
        return out

    # -- admission (overload plane) ------------------------------------------

    def _admission_on(self) -> bool:
        return self._admission is not None and GLOBAL_CONFIG.admission

    def _resolve_identity(
        self, args: tuple, kwargs: dict, tenant: str, priority: str
    ) -> tuple[str, str]:
        """(tenant, priority) for admission: explicit handle options win,
        else the request envelope's headers (the ingress contract), else
        the defaults."""
        if tenant and priority:
            return tenant, _admission.normalize_priority(priority)
        h_tenant, h_priority = _admission.extract_identity(args, kwargs)
        return (
            tenant or h_tenant,
            _admission.normalize_priority(priority) if priority else h_priority,
        )

    def _count_admission(self, decision: str, priority: str) -> None:
        if self._admission_on():
            self._admission.count(decision, priority)

    @staticmethod
    def _overload_cause(e: TaskError) -> OverloadedError | None:
        """The replica's bounded-queue rejection, if that is what this
        TaskError carries (it crosses the RPC boundary as the cause)."""
        cause = getattr(e, "cause", None)
        return cause if isinstance(cause, OverloadedError) else None

    async def route(
        self,
        method: str,
        args: tuple,
        kwargs: dict,
        model_id: str = "",
        tenant: str = "",
        priority: str = "",
    ):
        """Route one request; returns the result value.

        Overload semantics: admission (tenant token bucket + priority vs
        the advertised shed level) runs ONCE per request, locally, before
        the first dispatch; a replica's bounded-queue rejection is retried
        exactly once against a different replica, then the request is shed
        (OverloadedError to the caller — the ingress turns it into 429 +
        Retry-After). Exactly one raytpu_serve_admission_total event per
        admission-checked request, whatever the outcome."""
        payload = serialization.dumps((args, kwargs))[0]
        instrument = _metrics.metrics_enabled()
        t0 = _time.perf_counter() if instrument else 0.0
        fr = _flightrec.on()
        frid = _next_frid() if fr else None
        t_req = _time.monotonic() if fr else 0.0
        last_err: Exception | None = None
        adm = _RequestAdmission(self, args, kwargs, tenant, priority)
        hop_tried = disagg_decode = False
        for attempt in range(ROUTE_RETRIES):
            if self._version < -1 or not self._replicas:
                await self._refresh(force=attempt > 0)
                if not self._replicas:
                    await asyncio.sleep(0.2)
                    continue
            if fr and not adm._admitted:
                t_ph = _time.monotonic()
                try:
                    adm.ensure_checked()
                except OverloadedError as ov:
                    self._flightrec_shed(frid, t_req, ov.reason or "shed")
                    raise
                _flightrec.record(
                    "serve", "serve.admission", t=t_ph,
                    dur_s=_time.monotonic() - t_ph, rid=frid,
                )
            else:
                adm.ensure_checked()  # raises shed/throttled, pre-counted
            if not hop_tried and self._disagg_active():
                # Disaggregated two-hop, leg 1: prefill on the prefill
                # tier; on success the decode dispatch below carries the
                # KV handoff. ONE hop per request — a decode-replica
                # retry reuses the same handoff (its pull fails closed
                # into local prefill on the retried replica).
                hop_tried = True
                t_ph = _time.monotonic() if fr else 0.0
                h = await self._prefill_hop(args, kwargs, model_id, payload)
                if fr:
                    _flightrec.record(
                        "serve", "serve.disagg_prefill_hop", t=t_ph,
                        dur_s=_time.monotonic() - t_ph, rid=frid,
                        ok=h is not None,
                    )
                if h is not None:
                    req2 = dict(args[0])
                    req2["_handoff"] = h
                    payload = serialization.dumps(
                        ((req2,) + args[1:], kwargs)
                    )[0]
                    disagg_decode = True
            t_ph = _time.monotonic() if fr else 0.0
            if disagg_decode:
                # Leg 2: load-only pow-2 over the decode tier (decode
                # replicas never prefill, so digests carry no signal).
                pick_key = ""
                replica = self._pick(
                    "", None, count_prefix=False, exclude=adm.exclude,
                    candidates=self._role_replicas("decode"),
                )
            else:
                pick_key = model_id or self._affinity_key(args, kwargs)
                digests = None
                if not model_id and self._prefix_routing_on():
                    self._maybe_refresh_state()
                    digests = self._prompt_digests(args, kwargs)
                replica = self._pick(
                    pick_key, digests, count_prefix=attempt == 0,
                    exclude=adm.exclude,
                )
            rid = replica._actor_id
            if fr:
                _flightrec.record(
                    "serve", "serve.pick", t=t_ph,
                    dur_s=_time.monotonic() - t_ph, rid=frid,
                    replica=rid[:12], attempt=attempt,
                )
            self._inflight[rid] = self._inflight.get(rid, 0) + 1
            if instrument:
                tags = {"deployment": self._deployment}
                _ROUTER_WAIT.observe(_time.perf_counter() - t0, tags)
                _REQUESTS.inc(1.0, tags)
                instrument = False  # one wait + one request per route()
            try:
                t_ph = _time.monotonic() if fr else 0.0
                if frid is not None:
                    ref = replica.handle.remote(
                        method, payload, model_id, frid
                    )
                else:
                    ref = replica.handle.remote(method, payload, model_id)
                result = await core_api.get_async(ref)
                self._note_model(pick_key, rid)
                adm.count_once("admitted")
                if fr:
                    now = _time.monotonic()
                    _flightrec.record(
                        "serve", "serve.dispatch", t=t_ph,
                        dur_s=now - t_ph, rid=frid, replica=rid[:12],
                    )
                    _flightrec.record(
                        "serve", "serve.request", t=t_req,
                        dur_s=now - t_req, rid=frid, outcome="ok",
                    )
                return result
            except TaskError as e:
                ov = self._overload_cause(e)
                if ov is None:
                    # Application error: admitted, surfaced as-is.
                    adm.count_once("admitted")
                    raise
                if not adm.retry_overload(ov, rid):
                    # Second saturated replica (or nowhere else to go):
                    # shed fast — no backoff, the client owns the retry.
                    self._flightrec_shed(frid, t_req, "queue_full")
                    raise ov from None
            except (ActorDiedError, ActorUnavailableError) as e:
                # Replica died mid-request: drop it locally, force-refresh
                # membership, back off (the controller may still be
                # replacing it), and retry on a healthy one.
                import time

                last_err = e
                self._recently_dead[rid] = time.monotonic()
                self._replicas = [
                    r for r in self._replicas if r._actor_id != rid
                ]
                self._forget_replica(rid)
                self._version = -2
                await asyncio.sleep(min(0.1 * (attempt + 1), 1.0))
            finally:
                if rid in self._inflight:
                    self._inflight[rid] -= 1
        held = adm.exhausted()
        if held is not None:
            self._flightrec_shed(frid, t_req, "retries_exhausted")
            raise held from None
        if _metrics.metrics_enabled():
            _ERRORS.inc(1.0, {"deployment": self._deployment})
        raise last_err or RuntimeError(
            f"routing to {self._deployment!r} failed after "
            f"{ROUTE_RETRIES} attempts"
        )

    def _flightrec_shed(self, frid, t_req: float, reason: str) -> None:
        """Record an OverloadedError verdict and trigger the (throttled)
        postmortem dump — a shed burst is exactly the moment the
        operator wants the preceding timeline for."""
        if not _flightrec.on():
            return
        now = _time.monotonic()
        _flightrec.record("serve", "serve.shed", rid=frid, reason=reason)
        if t_req:
            _flightrec.record(
                "serve", "serve.request", t=t_req, dur_s=now - t_req,
                rid=frid, outcome="shed",
            )
        _flightrec.dump("overload")

    async def route_stream(
        self,
        method: str,
        args: tuple,
        kwargs: dict,
        model_id: str = "",
        tenant: str = "",
        priority: str = "",
    ):
        """Route one STREAMING request; an async generator of response
        chunks. Dead-replica retry only before the first chunk arrives —
        once items flowed, a failure surfaces to the caller (the reference
        behaves the same: a stream is not transparently restartable).
        Admission and the single bounded-queue retry mirror route(); a
        replica rejection can only happen pre-first-chunk (the replica
        fails fast at generator start)."""
        payload = serialization.dumps((args, kwargs))[0]
        instrument = _metrics.metrics_enabled()
        t0 = _time.perf_counter() if instrument else 0.0
        fr = _flightrec.on()
        frid = _next_frid() if fr else None
        t_req = _time.monotonic() if fr else 0.0
        last_err: Exception | None = None
        adm = _RequestAdmission(self, args, kwargs, tenant, priority)
        hop_tried = disagg_decode = False
        for attempt in range(ROUTE_RETRIES):
            if self._version < -1 or not self._replicas:
                await self._refresh(force=attempt > 0)
                if not self._replicas:
                    await asyncio.sleep(0.2)
                    continue
            if fr and not adm._admitted:
                t_ph = _time.monotonic()
                try:
                    adm.ensure_checked()
                except OverloadedError as ov:
                    self._flightrec_shed(frid, t_req, ov.reason or "shed")
                    raise
                _flightrec.record(
                    "serve", "serve.admission", t=t_ph,
                    dur_s=_time.monotonic() - t_ph, rid=frid,
                )
            else:
                adm.ensure_checked()  # raises shed/throttled, pre-counted
            if not hop_tried and self._disagg_active():
                # Two-hop leg 1 (see route()): prefill before the stream
                # opens; client TTFT includes this hop by construction.
                hop_tried = True
                t_ph = _time.monotonic() if fr else 0.0
                h = await self._prefill_hop(args, kwargs, model_id, payload)
                if fr:
                    _flightrec.record(
                        "serve", "serve.disagg_prefill_hop", t=t_ph,
                        dur_s=_time.monotonic() - t_ph, rid=frid,
                        ok=h is not None,
                    )
                if h is not None:
                    req2 = dict(args[0])
                    req2["_handoff"] = h
                    payload = serialization.dumps(
                        ((req2,) + args[1:], kwargs)
                    )[0]
                    disagg_decode = True
            t_ph = _time.monotonic() if fr else 0.0
            if disagg_decode:
                pick_key = ""
                replica = self._pick(
                    "", None, count_prefix=False, exclude=adm.exclude,
                    candidates=self._role_replicas("decode"),
                )
            else:
                pick_key = model_id or self._affinity_key(args, kwargs)
                digests = None
                if not model_id and self._prefix_routing_on():
                    self._maybe_refresh_state()
                    digests = self._prompt_digests(args, kwargs)
                replica = self._pick(
                    pick_key, digests, count_prefix=attempt == 0,
                    exclude=adm.exclude,
                )
            rid = replica._actor_id
            if fr:
                _flightrec.record(
                    "serve", "serve.pick", t=t_ph,
                    dur_s=_time.monotonic() - t_ph, rid=frid,
                    replica=rid[:12], attempt=attempt,
                )
            self._inflight[rid] = self._inflight.get(rid, 0) + 1
            if instrument:
                tags = {"deployment": self._deployment}
                _ROUTER_WAIT.observe(_time.perf_counter() - t0, tags)
                _REQUESTS.inc(1.0, tags)
                instrument = False
            delivered = False
            t_dispatch = _time.monotonic() if fr else 0.0
            try:
                if frid is not None:
                    gen = replica.handle_streaming.options(
                        num_returns="streaming"
                    ).remote(method, payload, model_id, frid)
                else:
                    gen = replica.handle_streaming.options(
                        num_returns="streaming"
                    ).remote(method, payload, model_id)
                async for ref in gen:
                    value = await core_api.get_async(ref)
                    if not delivered:
                        self._note_model(pick_key, rid)
                        adm.count_once("admitted")
                        if fr:
                            _flightrec.record(
                                "serve", "serve.first_chunk", t=t_dispatch,
                                dur_s=_time.monotonic() - t_dispatch,
                                rid=frid, replica=rid[:12],
                            )
                    delivered = True
                    yield value
                adm.count_once("admitted")  # zero-chunk streams admitted too
                if fr:
                    now = _time.monotonic()
                    _flightrec.record(
                        "serve", "serve.stream", t=t_dispatch,
                        dur_s=now - t_dispatch, rid=frid,
                        replica=rid[:12],
                    )
                    _flightrec.record(
                        "serve", "serve.request", t=t_req,
                        dur_s=now - t_req, rid=frid, outcome="ok",
                    )
                return
            except TaskError as e:
                ov = self._overload_cause(e)
                if ov is None or delivered:
                    adm.count_once("admitted")
                    raise
                if not adm.retry_overload(ov, rid):
                    self._flightrec_shed(frid, t_req, "queue_full")
                    raise ov from None
            except (ActorDiedError, ActorUnavailableError) as e:
                if delivered:
                    raise
                import time

                last_err = e
                self._recently_dead[rid] = time.monotonic()
                self._replicas = [
                    r for r in self._replicas if r._actor_id != rid
                ]
                self._forget_replica(rid)
                self._version = -2
                await asyncio.sleep(min(0.1 * (attempt + 1), 1.0))
            finally:
                if rid in self._inflight:
                    self._inflight[rid] -= 1
        held = adm.exhausted()
        if held is not None:
            self._flightrec_shed(frid, t_req, "retries_exhausted")
            raise held from None
        if _metrics.metrics_enabled():
            _ERRORS.inc(1.0, {"deployment": self._deployment})
        raise last_err or RuntimeError(
            f"streaming route to {self._deployment!r} failed after "
            f"{ROUTE_RETRIES} attempts"
        )
