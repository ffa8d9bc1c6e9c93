"""Metrics: Counter / Gauge / Histogram and the process registry. Port of
``ray_tpu/util/metrics.py``.

One process-local ``MetricsRegistry`` holds every series' points; a
snapshot is a JSON-able dict that :func:`merge_snapshots` sums across
processes and :func:`to_prometheus` renders as Prometheus exposition text.
Runtime series carry the ``raytpu_`` prefix and are declared in a
process-wide catalog that rejects a bad prefix, a second kind for one name
and unbounded-cardinality tag keys. ``RAY_TPU_METRICS_ENABLED=0`` is the
global kill switch that hot-path record sites check.

Frame-scale paths (the RPC fabric, the scheduler) record into a lock-free
``LocalHistogram`` folded into a snapshot at report time. A metric pickled
into a task or an actor re-registers in the process that loads it.
"""

from __future__ import annotations

import threading
from bisect import bisect_left as _bisect_left
from typing import Dict, Optional, Tuple

from ray_tpu_torch.core.config import GLOBAL_CONFIG

_DEFAULT_HIST_BOUNDARIES = [
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 50.0, 100.0,
]

# Latency boundaries for sub-second hot paths (RPC handlers, router waits,
# token latencies): finer low end than the generic default.
LATENCY_BOUNDARIES_S = [
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
]

RUNTIME_PREFIX = "raytpu_"

# Tag keys whose values are per-entity ids — unbounded cardinality that
# would blow up the scrape and the history rings. metrics_lint (and the
# catalog declaration below) reject them outright. Truncated process-scoped
# ids (node_id[:12], worker_id[:12]) are bounded by live membership and
# allowed.
CARDINALITY_DENYLIST = frozenset(
    {"task_id", "object_id", "request_id", "lease_id", "actor_id", "oid"}
)


def metrics_enabled() -> bool:
    """Global instrumentation kill switch (RAY_TPU_METRICS_ENABLED=0):
    hot-path record sites check this so the A/B overhead of telemetry can
    be measured."""
    return GLOBAL_CONFIG.metrics_enabled


# -- runtime series catalog ---------------------------------------------------

_runtime_catalog: Dict[str, dict] = {}
_catalog_lock = threading.Lock()


def declare_runtime_metric(
    name: str,
    kind: str,
    description: str = "",
    tag_keys: tuple = (),
    boundaries: Optional[list] = None,
    layer: str = "",
) -> dict:
    """Register a runtime-owned series in the process-wide catalog and
    return its snapshot ``meta`` dict. The catalog enforces the
    ``raytpu_`` prefix, one kind per name, and no unbounded-cardinality
    tag keys at declaration time, so a bad series fails where it is declared instead of polluting
    the scrape."""
    if not name.startswith(RUNTIME_PREFIX):
        raise ValueError(
            f"runtime metric {name!r} must carry the {RUNTIME_PREFIX!r} prefix"
        )
    bad = CARDINALITY_DENYLIST.intersection(tag_keys)
    if bad:
        raise ValueError(
            f"runtime metric {name!r} declares unbounded-cardinality tag "
            f"key(s) {sorted(bad)}"
        )
    entry = {
        "kind": kind,
        "description": description,
        "tag_keys": tuple(tag_keys),
        "boundaries": list(boundaries or _DEFAULT_HIST_BOUNDARIES),
        "layer": layer,
    }
    with _catalog_lock:
        existing = _runtime_catalog.get(name)
        if existing is not None and existing["kind"] != kind:
            raise ValueError(
                f"runtime metric {name!r} already declared as "
                f"{existing['kind']}, now {kind}"
            )
        _runtime_catalog[name] = entry
    return {
        "kind": kind,
        "description": description,
        "boundaries": entry["boundaries"],
    }


def runtime_catalog() -> Dict[str, dict]:
    """Copy of the declared runtime series (for lint checks and docs)."""
    with _catalog_lock:
        return {k: dict(v) for k, v in _runtime_catalog.items()}


class LocalHistogram:
    """Lock-free histogram accumulator for single-threaded hot paths.

    The registry takes a lock per record: fine at request scale, too much
    at RPC-frame scale. A LocalHistogram is mutated by exactly one thread
    (an event loop) and folded into a snapshot point at report time.
    observe() is one bisect and one increment; buckets cumulate only in
    as_value().
    """

    __slots__ = ("boundaries", "count", "sum", "_raw")

    def __init__(self, boundaries: Optional[list] = None):
        self.boundaries = list(boundaries or _DEFAULT_HIST_BOUNDARIES)
        self.count = 0
        self.sum = 0.0
        # Per-bucket (non-cumulative) counts; the extra slot is overflow
        # (> every boundary), represented only by `count` on the wire.
        self._raw = [0] * (len(self.boundaries) + 1)

    def observe(self, value: float) -> None:
        self.count += 1
        self.sum += value
        self._raw[_bisect_left(self.boundaries, value)] += 1

    def as_value(self) -> dict:
        buckets, total = [], 0
        for n in self._raw[:-1]:
            total += n
            buckets.append(total)
        return {"count": self.count, "sum": self.sum, "buckets": buckets}


class MetricsRegistry:
    """Thread-safe store of metric points for one process.

    Keys: (name, frozenset(tag items)). Values per kind:
      counter -> float (monotonic sum)
      gauge   -> float (last value)
      histogram -> {"count": n, "sum": s, "buckets": [c_le_b0, ...]}
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._meta: Dict[str, dict] = {}  # name -> {kind, description, bounds}
        self._points: Dict[Tuple[str, frozenset], object] = {}

    def describe(
        self,
        name: str,
        kind: str,
        description: str = "",
        boundaries: Optional[list] = None,
    ) -> None:
        with self._lock:
            meta = self._meta.get(name)
            if meta is not None and meta["kind"] != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {meta['kind']}"
                )
            self._meta[name] = {
                "kind": kind,
                "description": description,
                "boundaries": list(boundaries or _DEFAULT_HIST_BOUNDARIES),
            }

    def record(self, name: str, value: float, tags: dict | None = None) -> None:
        tags = tags or {}
        key = (name, frozenset(tags.items()))
        with self._lock:
            meta = self._meta.get(name)
            if meta is None:
                raise ValueError(f"metric {name!r} not registered")
            kind = meta["kind"]
            if kind == "counter":
                self._points[key] = float(self._points.get(key, 0.0)) + value
            elif kind == "gauge":
                self._points[key] = float(value)
            else:  # histogram
                pt = self._points.get(key)
                if pt is None:
                    pt = {
                        "count": 0,
                        "sum": 0.0,
                        "buckets": [0] * len(meta["boundaries"]),
                    }
                    self._points[key] = pt
                pt["count"] += 1
                pt["sum"] += value
                for i, b in enumerate(meta["boundaries"]):
                    if value <= b:
                        pt["buckets"][i] += 1

    def snapshot(self) -> dict:
        """Wire format: {"meta": {...}, "points": [[name, tags, value]]}."""
        def copy_value(value):
            # Histogram points are mutable (buckets list included): the
            # snapshot must not alias live registry state, or records
            # racing the snapshot's serialization corrupt the report.
            if isinstance(value, dict):
                out = dict(value)
                out["buckets"] = list(out["buckets"])
                return out
            return value

        with self._lock:
            return {
                "meta": dict(self._meta),
                "points": [
                    [name, dict(tags), copy_value(value)]
                    for (name, tags), value in self._points.items()
                ],
            }


def merge_snapshots(snaps: list) -> dict:
    """Merge per-process snapshots (sum counters/histograms, last gauge)."""
    meta: dict = {}
    points: dict = {}
    for snap in snaps:
        meta.update(snap.get("meta", {}))
        for name, tags, value in snap.get("points", []):
            key = (name, frozenset(tags.items()))
            kind = meta.get(name, {}).get("kind", "gauge")
            cur = points.get(key)
            if cur is None:
                points[key] = (
                    dict(value) if isinstance(value, dict) else value
                )
            elif kind == "counter":
                points[key] = cur + value
            elif kind == "gauge":
                points[key] = value
            else:
                cur["count"] += value["count"]
                cur["sum"] += value["sum"]
                cur["buckets"] = [
                    a + b for a, b in zip(cur["buckets"], value["buckets"])
                ]
    return {
        "meta": meta,
        "points": [
            [name, dict(tags), value]
            for (name, tags), value in points.items()
        ],
    }


def _escape_label_value(v) -> str:
    """Prometheus exposition format: label values escape backslash, double
    quote, and line feed (in that order — escaping the escapes first)."""
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def to_prometheus(snapshot: dict) -> str:
    """Render a (merged) snapshot as Prometheus exposition text."""

    def fmt_tags(tags: dict) -> str:
        if not tags:
            return ""
        inner = ",".join(
            f'{k}="{_escape_label_value(v)}"'
            for k, v in sorted(tags.items())
        )
        return "{" + inner + "}"

    meta = snapshot.get("meta", {})
    lines = []
    by_name: dict = {}
    for name, tags, value in snapshot.get("points", []):
        by_name.setdefault(name, []).append((tags, value))
    for name in sorted(by_name):
        m = meta.get(name, {"kind": "gauge", "description": ""})
        kind = m["kind"]
        prom_type = {"counter": "counter", "gauge": "gauge"}.get(
            kind, "histogram"
        )
        if m.get("description"):
            lines.append(f"# HELP {name} {m['description']}")
        lines.append(f"# TYPE {name} {prom_type}")
        for tags, value in by_name[name]:
            if kind in ("counter", "gauge"):
                lines.append(f"{name}{fmt_tags(tags)} {value}")
            else:
                # record() stores buckets cumulatively already (every
                # boundary >= value is incremented) — emit as-is. ``le``
                # boundaries render as consistent floats per the
                # exposition format (a mixed "1"/"1.0" pair would read as
                # two different buckets to a scraper).
                for b, c in zip(m["boundaries"], value["buckets"]):
                    lines.append(
                        f"{name}_bucket"
                        f"{fmt_tags({**tags, 'le': float(b)})} {c}"
                    )
                lines.append(
                    f"{name}_bucket{fmt_tags({**tags, 'le': '+Inf'})} "
                    f"{value['count']}"
                )
                lines.append(f"{name}_sum{fmt_tags(tags)} {value['sum']}")
                lines.append(f"{name}_count{fmt_tags(tags)} {value['count']}")
    return "\n".join(lines) + ("\n" if lines else "")


_registry = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _registry


def _rebuild_metric(cls, name, description, tag_keys, boundaries, defaults):
    """Unpickle hook: re-run the constructor so the metric registers in
    the process that loads it. A metric captured in a cloudpickled closure
    (a remote task or actor defined next to its metrics) would otherwise
    arrive unregistered, and its first record() would raise."""
    if cls.kind == "histogram":
        metric = cls(name, description, boundaries, tag_keys)
    else:
        metric = cls(name, description, tag_keys)
    return metric.set_default_tags(defaults)


class _Metric:
    kind = ""

    def __init__(
        self,
        name: str,
        description: str = "",
        tag_keys: tuple = (),
        **kw,
    ):
        self._name = name
        self._description = description
        self._tag_keys = frozenset(tag_keys)
        self._default_tags: dict = {}
        self._boundaries = kw.get("boundaries")
        if name.startswith(RUNTIME_PREFIX):
            # Runtime-owned series self-register in the lint catalog.
            declare_runtime_metric(
                name,
                self.kind,
                description,
                tuple(tag_keys),
                boundaries=kw.get("boundaries"),
            )
        _registry.describe(name, self.kind, description, **kw)

    def set_default_tags(self, tags: dict) -> "_Metric":
        self._default_tags = dict(tags)
        return self

    def __reduce__(self):
        return (
            _rebuild_metric,
            (
                type(self),
                self._name,
                self._description,
                tuple(self._tag_keys),
                self._boundaries,
                self._default_tags,
            ),
        )

    def _tags(self, tags: dict | None) -> dict:
        out = dict(self._default_tags)
        if tags:
            out.update(tags)
        # Validate against the declared key set at record time: a tag
        # outside it (or a declared key omitted) would silently export
        # inconsistent series under one name.
        if out.keys() != self._tag_keys:
            extra = sorted(out.keys() - self._tag_keys)
            missing = sorted(self._tag_keys - out.keys())
            parts = []
            if extra:
                parts.append(f"undeclared tag key(s) {extra}")
            if missing:
                parts.append(f"missing declared tag key(s) {missing}")
            raise ValueError(
                f"metric {self._name!r}: {'; '.join(parts)} "
                f"(declared tag_keys={sorted(self._tag_keys)})"
            )
        return out


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, tags: dict | None = None) -> None:
        _registry.record(self._name, value, self._tags(tags))


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, tags: dict | None = None) -> None:
        _registry.record(self._name, value, self._tags(tags))


class Histogram(_Metric):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        description: str = "",
        boundaries: Optional[list] = None,
        tag_keys: tuple = (),
    ):
        super().__init__(
            name, description, tag_keys, boundaries=boundaries
        )

    def observe(self, value: float, tags: dict | None = None) -> None:
        _registry.record(self._name, value, self._tags(tags))
