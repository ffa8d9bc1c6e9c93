"""Multi-tenant admission control & priority shedding (overload plane).
Port of ``ray_tpu/serve/admission.py``.

The serve tier's protection while the autoscaler catches up: a flash
crowd must degrade PREDICTABLY (lowest-priority traffic rejected fast,
high-priority tail latency bounded) instead of queuing unboundedly at
replicas and collapsing TTFT for every tenant at once.

Three mechanisms, composed per deployment (opt-in via
``DeploymentConfig.admission_config``; ``RAY_TPU_ADMISSION=0`` is the
global kill switch restoring the pre-admission router/replica behavior):

* **Per-tenant token buckets** — the router charges one token per
  request against the tenant's bucket (tenant key from the
  ``serve_tenant_header`` HTTP header / gRPC call envelope); an empty
  bucket rejects with :class:`~ray_tpu_torch.core.errors.OverloadedError`
  (``reason="throttled"``) carrying the exact refill wait as
  ``retry_after_s``.
* **Priority shedding** — requests carry a class
  (``interactive | batch | best_effort``, header ``x-raytpu-priority``);
  when a deployment's shed level (computed controller-side from the
  pushed queue-depth/TTFT metrics, advertised in the routing table so
  routers NEVER await the control plane) is 1, ``best_effort`` is shed;
  at 2, ``batch`` too. ``interactive`` is never shed at admission — the
  bounded replica queue is its backstop.
* **Watermark hysteresis** — :class:`WatermarkTracker` raises the level
  the moment a signal crosses its high watermark and lowers it one step
  only after every signal sits below its low watermark for a hold
  period, so the shed state cannot flap at the boundary.

Everything here is clock-injectable (``now_fn``) and consumes no wall
clock of its own, so a seeded arrival schedule replays to a
bit-identical admit/shed decision sequence.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.core.errors import OverloadedError
from ray_tpu_torch.util import metrics as _metrics

# Priority classes, most to least protected. Requests with no (or an
# unknown) priority label count as "interactive": unmarked traffic is
# normal user traffic and must not become sheddable by omission —
# batch/best_effort are opt-in labels.
PRIORITIES = ("interactive", "batch", "best_effort")
PRIORITY_RANK = {p: i for i, p in enumerate(PRIORITIES)}
DEFAULT_PRIORITY = "interactive"
PRIORITY_HEADER = "x-raytpu-priority"

# Shed level L sheds every priority whose rank is >= len(PRIORITIES)-L:
# level 1 -> best_effort, level 2 -> batch + best_effort. interactive is
# never admission-shed (MAX_SHED_LEVEL bounds the tracker).
MAX_SHED_LEVEL = len(PRIORITIES) - 1

_ADMISSION_TOTAL = _metrics.Counter(
    "raytpu_serve_admission_total",
    "admission outcomes, one per routed request: admitted (dispatched; "
    "non-overload failures included), shed (priority shed or bounded "
    "replica queues after the one retry), throttled (tenant bucket empty)",
    tag_keys=("deployment", "decision", "priority"),
)
_TENANT_TOKENS = _metrics.Gauge(
    "raytpu_serve_tenant_tokens",
    "tokens remaining in a tenant's admission bucket after its last "
    "charge (per deployment; only tenants with a configured/active "
    "bucket export)",
    tag_keys=("deployment", "tenant"),
)
_SHED_STATE = _metrics.Gauge(
    "raytpu_serve_shed_watermark_state",
    "current shed level of a deployment (0 = admit all, 1 = shed "
    "best_effort, 2 = shed batch too); set by the serve controller's "
    "watermark tracker",
    tag_keys=("deployment",),
)


def shed_rank_threshold(level: int) -> int:
    """Priorities with rank >= this are shed at ``level`` (a threshold of
    len(PRIORITIES) sheds nothing)."""
    return len(PRIORITIES) - max(0, min(int(level), MAX_SHED_LEVEL))


def normalize_priority(value) -> str:
    p = str(value or "").strip().lower()
    return p if p in PRIORITY_RANK else DEFAULT_PRIORITY


def tenant_from_headers(headers: dict) -> str:
    """Tenant key per the ingress contract: the ``serve_tenant_header``
    header (lower-cased by the HTTP proxy), "default" when absent."""
    if not isinstance(headers, dict):
        return "default"
    key = headers.get(GLOBAL_CONFIG.serve_tenant_header)
    return str(key) if key else "default"


def priority_from_headers(headers: dict) -> str:
    if not isinstance(headers, dict):
        return DEFAULT_PRIORITY
    return normalize_priority(headers.get(PRIORITY_HEADER))


def extract_identity(args: tuple, kwargs: dict) -> tuple[str, str]:
    """(tenant, priority) from a request envelope's headers — the same
    envelope shape the proxy builds and the router's prompt extraction
    reads. Non-envelope payloads (plain handle calls) fall back to the
    default tenant/priority; callers that want explicit identity use
    ``DeploymentHandle.options(tenant=..., priority=...)``."""
    req = args[0] if args else kwargs.get("request")
    if not isinstance(req, dict):
        return "default", DEFAULT_PRIORITY
    headers = req.get("headers")
    return tenant_from_headers(headers), priority_from_headers(headers)


def resolve_admission_config(cfg) -> Optional[dict]:
    """A deployment's admission_config with the cluster-default knobs
    filled into unset fields, or None when the deployment did not opt in.
    Resolved controller-side so every router enforces ONE authority's
    numbers (the table they already long-poll)."""
    if not isinstance(cfg, dict):
        return None
    g = GLOBAL_CONFIG
    out = {
        # Per-tenant token bucket defaults: rate in requests/s refilled,
        # burst = bucket capacity. rate <= 0 = unlimited (no bucket).
        "tenant_rate": float(cfg.get("tenant_rate", 0.0)),
        "tenant_burst": float(cfg.get("tenant_burst", 0.0)),
        # Per-tenant overrides: {tenant: {"rate": r, "burst": b}}.
        "tenants": {
            str(k): {
                "rate": float((v or {}).get("rate", 0.0)),
                "burst": float((v or {}).get("burst", 0.0)),
            }
            for k, v in (cfg.get("tenants") or {}).items()
        },
        "queue_high": float(cfg.get("queue_high", g.serve_shed_queue_high)),
        "queue_low": float(cfg.get("queue_low", g.serve_shed_queue_low)),
        "ttft_high_ms": float(
            cfg.get("ttft_high_ms", g.serve_shed_ttft_high_ms)
        ),
        "ttft_low_ms": float(cfg.get("ttft_low_ms", g.serve_shed_ttft_low_ms)),
        # Hold below the low watermarks this long before stepping the
        # shed level down (hysteresis dwell).
        "down_hold_s": float(cfg.get("down_hold_s", 2.0)),
        # Retry-After hint for priority sheds (throttles compute the
        # exact bucket wait instead).
        "retry_after_s": float(cfg.get("retry_after_s", 1.0)),
    }
    if out["tenant_burst"] <= 0.0:
        out["tenant_burst"] = max(1.0, out["tenant_rate"])
    for t in out["tenants"].values():
        if t["burst"] <= 0.0:
            t["burst"] = max(1.0, t["rate"])
    return out


class TokenBucket:
    """Classic token bucket, lazily refilled from an injectable clock.

    ``take()`` returns 0.0 on success (one token consumed) or the exact
    wait in seconds until the charge would succeed — which is what rides
    out as ``Retry-After``. Deterministic: state depends only on the
    sequence of (now, take) calls, never on real time.
    """

    __slots__ = ("rate", "burst", "tokens", "_t", "_now")

    def __init__(
        self,
        rate: float,
        burst: float,
        now_fn: Callable[[], float] = time.monotonic,
    ):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._now = now_fn
        self._t = now_fn()

    def _refill(self) -> None:
        now = self._now()
        if now > self._t:
            self.tokens = min(self.burst, self.tokens + (now - self._t) * self.rate)
        self._t = now

    def take(self, n: float = 1.0) -> float:
        self._refill()
        if self.tokens >= n:
            self.tokens -= n
            return 0.0
        if self.rate <= 0.0:
            return float("inf")
        return (n - self.tokens) / self.rate


class WatermarkTracker:
    """Hysteretic shed-level state machine.

    ``update(queue_depth, ttft_ms, now)`` returns the new level in
    [0, MAX_SHED_LEVEL]: +1 the moment ANY enabled signal crosses its
    high watermark (an overloaded deployment must start shedding within
    one controller tick), -1 only after EVERY signal has stayed below its
    low watermark for ``down_hold_s`` (recovery must not flap the moment
    the queue dips). A ttft watermark of 0 disables that signal.
    """

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.level = 0
        self._low_since: Optional[float] = None

    def update(self, queue_depth: float, ttft_ms: float, now: float) -> int:
        c = self.cfg
        high = queue_depth > c["queue_high"] or (
            c["ttft_high_ms"] > 0.0 and ttft_ms > c["ttft_high_ms"]
        )
        low = queue_depth < c["queue_low"] and (
            c["ttft_low_ms"] <= 0.0 or ttft_ms < c["ttft_low_ms"]
        )
        if high:
            self._low_since = None
            if self.level < MAX_SHED_LEVEL:
                self.level += 1
        elif low and self.level > 0:
            if self._low_since is None:
                self._low_since = now
            elif now - self._low_since >= c["down_hold_s"]:
                self.level -= 1
                self._low_since = now
        else:
            # Between the watermarks: hold the current level (the
            # hysteresis band), and a dip that did not last resets.
            self._low_since = None
        return self.level


class AdmissionController:
    """Router-side admission: tenant buckets + priority shedding for one
    deployment, driven entirely by table-advertised state (config + shed
    level) so a decision never awaits the control plane.

    Thread-safe (routers run on the endpoint loop, but tools drive this
    from harness threads); ``instrument=False`` keeps simulation replays
    (on a virtual clock) out of the live metric series.
    """

    # Tenant buckets are per-key state; unknown tenants share the default
    # budget but still get their own bucket — bounded by LRU eviction so
    # a client spraying random tenant keys cannot grow router memory.
    MAX_TENANTS = 256

    def __init__(
        self,
        deployment: str,
        config: dict,
        now_fn: Callable[[], float] = time.monotonic,
        instrument: bool = True,
    ):
        self.deployment = deployment
        self.config = config
        self._now = now_fn
        self._instrument = instrument
        self._buckets: dict[str, TokenBucket] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _budget_in(cfg: dict, tenant: str) -> tuple[float, float]:
        t = (cfg.get("tenants") or {}).get(tenant)
        if t is not None:
            return t["rate"], t["burst"]
        return cfg.get("tenant_rate", 0.0), cfg.get("tenant_burst", 0.0)

    def reconfigure(self, config: dict) -> None:
        """Adopt a new table-advertised config, keeping bucket state for
        tenants whose effective budget did not change (a reconcile-tick
        table push must not refill every bucket)."""
        with self._lock:
            old, self.config = self.config, config
            for key in list(self._buckets):
                if self._budget_in(old, key) != self._budget_in(config, key):
                    del self._buckets[key]

    def _bucket(self, tenant: str) -> Optional[TokenBucket]:
        rate, burst = self._budget_in(self.config, tenant)
        if rate <= 0.0:
            return None  # unlimited tenant: no bucket, no gauge
        b = self._buckets.get(tenant)
        if b is None:
            if len(self._buckets) >= self.MAX_TENANTS:
                # Oldest-inserted eviction (dict order ~= recency because
                # re-charged buckets are moved to the end below).
                self._buckets.pop(next(iter(self._buckets)))
            b = self._buckets[tenant] = TokenBucket(rate, burst, self._now)
        else:
            self._buckets[tenant] = self._buckets.pop(tenant)  # LRU touch
        return b

    def count(self, decision: str, priority: str) -> None:
        """One admission outcome event (router calls this exactly once
        per request — the drain-during-overload invariant)."""
        if self._instrument and _metrics.metrics_enabled():
            _ADMISSION_TOTAL.inc(
                1.0,
                {
                    "deployment": self.deployment,
                    "decision": decision,
                    "priority": priority,
                },
            )

    def check(self, tenant: str, priority: str, shed_level: int) -> None:
        """Admit or raise. Raises :class:`OverloadedError` with the
        outcome already counted; admitted requests are counted later by
        the router at their final outcome (so one request = one event)."""
        priority = normalize_priority(priority)
        if PRIORITY_RANK[priority] >= shed_rank_threshold(shed_level):
            self.count("shed", priority)
            raise OverloadedError(
                f"{self.deployment}: shedding {priority} requests "
                f"(shed level {shed_level})",
                retry_after_s=self.config["retry_after_s"],
                reason="shed",
            )
        with self._lock:
            bucket = self._bucket(tenant)
            if bucket is None:
                return
            wait = bucket.take(1.0)
            tokens = bucket.tokens
        if self._instrument and _metrics.metrics_enabled():
            _TENANT_TOKENS.set(
                tokens, {"deployment": self.deployment, "tenant": tenant}
            )
        if wait > 0.0:
            self.count("throttled", priority)
            raise OverloadedError(
                f"{self.deployment}: tenant {tenant!r} over its request "
                f"budget",
                retry_after_s=min(wait, 60.0),
                reason="throttled",
            )


def set_shed_gauge(deployment: str, level: int) -> None:
    """Controller-side: export the current watermark state."""
    if _metrics.metrics_enabled():
        _SHED_STATE.set(float(level), {"deployment": deployment})
