"""Feasibility-indexed scheduling — bounded-candidate pick at fleet scale.
Port of ``ray_tpu/core/sched_index.py``.

``pick_node`` (core/scheduler.py) is a full scan: every placement decision
filters and scores every ``NodeView``. That is fine at 16 nodes and is the
control-plane bottleneck at 1,000 (PERF.md round 19: the 100->1,000-node
placement-latency curve is linear in fleet size). This module keeps the
scan's *semantics* while bounding the work per decision:

- Nodes are bucketed by **shape** (the frozenset of resource keys present
  in ``total`` or ``available``) and **exact label set**. Both change
  rarely — registration, placement-group bundle commit/release, node
  death — while availability *values* change on every heartbeat, so index
  maintenance is off the heartbeat hot path entirely.
- A demand can only fit on a node whose shape contains every demanded
  resource key (``fits`` treats a missing key as 0), and every node in a
  bucket carries the same labels, so label selectors evaluate once per
  bucket instead of once per node.
- Hybrid placement draws a **power-of-two-choices style sample**: walk the
  shape/label-feasible buckets behind rotating per-bucket cursors until
  ``sched_index_probes`` *fitting* candidates are found (or every feasible
  bucket is exhausted — the built-in full-scan fallback, so the index
  returns None exactly when the scan would), then picks max headroom among
  the sample. Spread keeps its bit-identical round-robin contract: the
  bucket filter only skips nodes the scan would reject anyway, so the
  sorted candidate list — and therefore the rr choice — is unchanged.

``RAY_TPU_SCHED_INDEX=0`` routes every decision back through the original
``pick_node`` scan byte-identically (the index is still maintained — the
flag gates the *read* path only, so it can flip at runtime).
"""

from __future__ import annotations

from bisect import insort
from typing import Mapping, Optional

from ray_tpu_torch.core.scheduler import (
    EPS,
    NodeView,
    SchedulingRequest,
    fits,
    labels_match,
)
from ray_tpu_torch.util.metrics import declare_runtime_metric

_INDEX_METRIC_META = {
    "raytpu_sched_index_fallback_scans_total": declare_runtime_metric(
        "raytpu_sched_index_fallback_scans_total", "counter",
        "index picks that exhausted every shape/label-feasible bucket "
        "without reaching the probe quota (the degenerate case where the "
        "bounded sample did the full scan's work)",
        layer="core",
    ),
}


def _headroom(v: NodeView, resources: Mapping[str, float]) -> float:
    """The scan's hybrid scoring, verbatim (pick_node's inner function)."""
    return sum(
        v.available.get(k, 0.0) - dem for k, dem in resources.items()
    ) + sum(v.available.values()) * 1e-3


def _usable(v: NodeView) -> bool:
    return v.alive and not v.suspect and not v.draining


class FeasibilityIndex:
    """Bucketed candidate index over a live ``{node_id: NodeView}`` dict.

    The index holds *references* to the caller's views — liveness flags
    (``alive``/``suspect``/``draining``) and availability values are read
    through the view at probe time and need no index maintenance. Callers
    own coherence for the rare shape/label transitions:

    - ``upsert(view)`` after registration, after a heartbeat or PG
      commit/release that changed the resource-KEY set, or after a label
      change (no-op when the bucket key is unchanged);
    - ``remove(node_id)`` on node death/retirement;
    - ``reset(views)`` when the whole dict is replaced (full view resync).
    """

    def __init__(self, views: Mapping[str, NodeView], probes: int = 0):
        # probes=0: read GLOBAL_CONFIG.sched_index_probes per pick, so the
        # knob (and tests) can change it without rebuilding the index.
        self._probes = probes
        self.fallback_scans = 0
        self.reset(views)

    # -- maintenance ---------------------------------------------------------

    @staticmethod
    def bucket_key(view: NodeView) -> tuple:
        shape = frozenset(view.total) | frozenset(view.available)
        return (shape, tuple(sorted(view.labels.items())))

    def reset(self, views: Mapping[str, NodeView]) -> None:
        self._views = views
        # bucket key -> sorted list of node ids (sorted: deterministic
        # probe order and bit-identical spread candidate lists).
        self._buckets: dict[tuple, list[str]] = {}
        self._node_bucket: dict[str, tuple] = {}
        self._cursors: dict[tuple, int] = {}
        for v in views.values():
            # Dead views stay OUT of the index (callers remove() on
            # death): fleet churn would otherwise bloat every bucket with
            # corpses the probe loop has to step over.
            if v.alive:
                self.upsert(v)

    def upsert(self, view: NodeView) -> None:
        key = self.bucket_key(view)
        old = self._node_bucket.get(view.node_id)
        if old == key:
            return
        if old is not None:
            self._evict(view.node_id, old)
        self._node_bucket[view.node_id] = key
        insort(self._buckets.setdefault(key, []), view.node_id)

    def remove(self, node_id: str) -> None:
        key = self._node_bucket.pop(node_id, None)
        if key is not None:
            self._evict(node_id, key)

    def _evict(self, node_id: str, key: tuple) -> None:
        ids = self._buckets.get(key)
        if ids is None:
            return
        try:
            ids.remove(node_id)
        except ValueError:
            pass
        if not ids:
            del self._buckets[key]
            self._cursors.pop(key, None)

    def verify(self) -> None:
        """Internal-consistency check (tests): every indexed view sits in
        exactly the bucket its current shape/labels map to, and every
        live view is indexed (dead ones may be either evicted or parked,
        filtered at probe time)."""
        seen: set = set()
        for key, ids in self._buckets.items():
            assert ids == sorted(ids), f"bucket {key} not sorted"
            for nid in ids:
                assert nid not in seen, f"{nid} in two buckets"
                seen.add(nid)
                view = self._views.get(nid)
                assert view is not None, f"{nid} indexed but not in views"
                assert self.bucket_key(view) == key, (
                    f"{nid} in stale bucket {key}"
                )
        assert seen == set(self._node_bucket), "bucket/reverse-map drift"
        alive = {nid for nid, v in self._views.items() if v.alive}
        assert alive <= seen, f"live views missing from index: {alive - seen}"

    # -- pick ----------------------------------------------------------------

    def _matching_buckets(self, req: SchedulingRequest) -> list:
        """Buckets whose shape can hold the demand and whose labels pass
        the selector, in deterministic (sorted-node-id) order."""
        demand_keys = {k for k, v in req.resources.items() if v > EPS}
        out = []
        for key, ids in self._buckets.items():
            shape, labels = key
            if not demand_keys <= shape:
                continue
            if req.label_selector and not labels_match(
                dict(labels), req.label_selector
            ):
                continue
            out.append((ids[0], key, ids))
        out.sort()
        return [(key, ids) for _, key, ids in out]

    def _candidate(
        self, nid: str, req: SchedulingRequest, exclude: Optional[str]
    ) -> Optional[NodeView]:
        if nid == exclude:
            return None
        v = self._views.get(nid)
        if v is None or not _usable(v):
            return None
        if not fits(v.available, req.resources):
            return None
        return v

    def _probe_quota(self) -> int:
        if self._probes > 0:
            return self._probes
        from ray_tpu_torch.core.config import GLOBAL_CONFIG

        return max(2, GLOBAL_CONFIG.sched_index_probes)

    def _probe(
        self, req: SchedulingRequest, exclude: Optional[str]
    ) -> list[NodeView]:
        """Up to ``probes`` FITTING candidates from the feasible buckets,
        behind rotating per-bucket cursors (successive picks sample
        different nodes; replay from a fixed state is deterministic).
        Probing extends past the quota only in the sense that it keeps
        walking until the quota is met or every feasible bucket is
        exhausted — so an empty return means the scan would return None."""
        quota = self._probe_quota()
        found: list[NodeView] = []
        examined = 0
        for key, ids in self._matching_buckets(req):
            if len(found) >= quota:
                break
            n = len(ids)
            cur = self._cursors.get(key, 0) % n
            step = 0
            while step < n and len(found) < quota:
                v = self._candidate(ids[(cur + step) % n], req, exclude)
                step += 1
                examined += 1
                if v is not None:
                    found.append(v)
            self._cursors[key] = (cur + step) % n
        if not found and examined > 2 * quota:
            # Degenerate pick: the bounded sample did full-scan work.
            self.fallback_scans += 1
        return found

    def _all_candidates(
        self, req: SchedulingRequest, exclude: Optional[str]
    ) -> list[NodeView]:
        """Every candidate the scan would keep, in sorted-node-id order
        (bucket lists are sorted; buckets are concatenated sorted-first,
        then the merge re-sorts — spread's contract needs the exact order
        pick_node's ``candidates.sort`` produces)."""
        out = []
        for _, ids in self._matching_buckets(req):
            for nid in ids:
                v = self._candidate(nid, req, exclude)
                if v is not None:
                    out.append(v)
        out.sort(key=lambda v: v.node_id)
        return out

    def pick(
        self,
        req: SchedulingRequest,
        local_node_id: str,
        rr_counter: int = 0,
        exclude: Optional[str] = None,
    ) -> Optional[str]:
        """Index-backed ``pick_node``: same None-ness, same policy
        semantics; hybrid may pick a *different fitting node* than the
        scan (max headroom among the bounded sample, not among all).
        ``exclude`` drops one node id from consideration (the node-side
        spill path excludes itself without copying the view dict)."""
        views = self._views
        if req.policy.startswith(("node_affinity:", "strict_node_affinity:")):
            target = req.policy.split(":", 1)[1]
            view = views.get(target)
            if (
                view is not None
                and target != exclude
                and _usable(view)
                and fits(view.available, req.resources)
                and labels_match(view.labels, req.label_selector)
            ):
                return target
            if req.policy.startswith("strict"):
                return None
            # soft affinity falls through to hybrid, like the scan

        if req.policy == "spread":
            candidates = self._all_candidates(req, exclude)
            if not candidates:
                return None
            if req.soft_label_selector:
                preferred = [
                    v
                    for v in candidates
                    if labels_match(v.labels, req.soft_label_selector)
                ]
                if preferred:
                    candidates = preferred
            return candidates[rr_counter % len(candidates)].node_id

        # hybrid: bounded sample. The local node joins the sample when it
        # is a candidate, so the scan's local-first and soft-preference
        # interplay is preserved: local wins IF it survives the soft
        # filter, exactly like pick_node's post-filter local check.
        sample = self._probe(req, exclude)
        if local_node_id and local_node_id != exclude:
            local = self._candidate(local_node_id, req, exclude)
            if local is not None and all(
                v.node_id != local_node_id for v in sample
            ):
                sample.append(local)
        if not sample:
            return None
        if req.soft_label_selector:
            preferred = [
                v
                for v in sample
                if labels_match(v.labels, req.soft_label_selector)
            ]
            if preferred:
                sample = preferred
        for v in sample:
            if v.node_id == local_node_id:
                return v.node_id
        return max(
            sample, key=lambda v: _headroom(v, req.resources)
        ).node_id
