"""MemoryGovernor — occupancy-driven task-submission arbitration for the
streaming data plane. Port of ``ray_tpu/data/governor.py``.

The streaming executor bounds each stage's in-flight BLOCK COUNT, but a
multi-operator pipeline has no global notion of how many BYTES its
concurrent stages have racing toward the object store: on a store smaller
than the dataset the stages win that race and the store spills (or, with
spill disabled, OOMs) mid-train. The governor closes the loop against the
store's own occupancy gauges (the round-7 ``object_store.stats()``
counters, shipped on every node heartbeat and served through the cluster
view):

* **Per-operator in-flight accounting.** Every governed task acquisition
  charges the operator's moving-average output-block size; the charge is
  released (and the average updated with the task's ACTUAL bytes) when the
  executor consumes the result. Until an operator has produced its first
  block its output size is unknown, so it runs exactly one task at a time
  — the probe that seeds the average.
* **Byte gate.** A grant is denied while
  ``polled_used + sum(charges) + estimate > data_store_high_frac *
  capacity`` — conservative by construction (a completed-but-unconsumed
  block is briefly counted both in the poll and in its charge), which is
  the right direction for a watermark invariant.
* **Watermark throttle + AIMD.** Occupancy at/above
  ``data_store_high_frac`` — or ANY node spilling — flips the governor
  into the throttled state (submission stops; per-operator budgets halve,
  multiplicative decrease); it releases only once occupancy falls back to
  ``data_store_low_frac`` (hysteresis). Below the low watermark budgets
  recover one task per poll (additive increase) up to
  ``data_max_inflight_per_op``.
* **Drain awareness.** A DRAINING node's store does not count as headroom
  (capacity): its objects are about to migrate INTO the healthy peers, so
  treating its free space as spendable would overshoot exactly when the
  cluster is shrinking. Its used bytes still count — they have to land
  somewhere.
* **Liveness.** An operator with zero tasks in flight is always granted
  one, whatever the watermark state: the pipeline's only way to LOWER
  occupancy is to keep moving blocks toward the consumer, so a full stop
  would deadlock the very backpressure loop the governor exists to close.

Kill switch: ``RAY_TPU_DATA_GOVERNOR=0`` (the ``data_governor`` knob) — the
executor never constructs a governor and runs the pre-governor submission
loop byte-identically.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Optional

from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.util import metrics as _metrics

_INFLIGHT_BYTES = _metrics.Gauge(
    "raytpu_data_operator_inflight_bytes",
    "bytes the governor has charged against one operator's in-flight "
    "block tasks (moving-average estimates, trued up on completion)",
    tag_keys=("operator",),
)
_THROTTLE_EVENTS = _metrics.Counter(
    "raytpu_data_throttle_events_total",
    "governor submission denials: high-watermark/spill throttles and "
    "byte-gate rejections",
)


def resolved_max_inflight_per_op() -> int:
    """The ``data_max_inflight_per_op`` knob with its auto default
    (0 = max(4, 2 * host cores) — the heuristic hoisted out of
    DataContext.max_in_flight_blocks)."""
    v = GLOBAL_CONFIG.data_max_inflight_per_op
    if v > 0:
        return v
    return max(4, 2 * (os.cpu_count() or 1))


def cluster_store_occupancy() -> tuple[int, int, int]:
    """(used_bytes, headroom_capacity_bytes, spills_total) across the
    cluster's object stores, from the GCS cluster view (each node's
    heartbeat ships its store gauges). Draining nodes contribute their
    USED bytes (those objects are migrating into the healthy peers) but
    not their capacity — a draining store is not headroom."""
    import ray_tpu_torch

    used = capacity = spills = 0
    for n in ray_tpu_torch.nodes():
        if not n.get("Alive"):
            continue
        st = n.get("StoreStats") or {}
        used += int(st.get("used_bytes", 0))
        spills += int(st.get("spills", 0))
        if not n.get("Draining"):
            capacity += int(st.get("capacity_bytes", 0))
    return used, capacity, spills


class _OpState:
    """One operator's in-flight accounting + AIMD budget."""

    __slots__ = ("inflight", "charged", "charges", "budget", "avg_bytes")

    def __init__(self, budget: int):
        self.inflight = 0
        self.charged = 0.0  # sum of outstanding charges (bytes)
        self.charges: deque = deque()  # FIFO: executor pops in order
        self.budget = float(budget)
        self.avg_bytes: Optional[float] = None  # None until first block


class MemoryGovernor:
    """Grants/revokes per-operator task-submission budgets from global
    object-store occupancy. One instance per streaming execution; the
    occupancy poll is throttled to ``data_governor_poll_interval_s`` so a
    busy pipeline costs one bounded cluster-view RPC per interval, not
    per task. ``occupancy_fn`` is injectable for unit tests."""

    def __init__(
        self,
        *,
        high_frac: Optional[float] = None,
        low_frac: Optional[float] = None,
        max_inflight_per_op: Optional[int] = None,
        poll_interval_s: Optional[float] = None,
        occupancy_fn: Optional[Callable[[], tuple]] = None,
    ):
        cfg = GLOBAL_CONFIG
        self.high_frac = (
            cfg.data_store_high_frac if high_frac is None else high_frac
        )
        self.low_frac = (
            cfg.data_store_low_frac if low_frac is None else low_frac
        )
        self.max_inflight = (
            max_inflight_per_op
            if max_inflight_per_op
            else resolved_max_inflight_per_op()
        )
        self._poll_s = (
            cfg.data_governor_poll_interval_s
            if poll_interval_s is None
            else poll_interval_s
        )
        self._occupancy_fn = occupancy_fn or cluster_store_occupancy
        self._lock = threading.Lock()
        self._ops: dict[str, _OpState] = {}
        self._last_poll = float("-inf")
        self._used = 0
        self._capacity = 0
        self._spills_seen: Optional[int] = None
        self.throttled = False
        self.throttle_events = 0
        self.peak_frac = 0.0
        self.polls = 0

    # -- occupancy poll + AIMD -----------------------------------------------

    def _maybe_poll(self, now: float) -> None:
        # Callers hold self._lock.
        if now - self._last_poll < self._poll_s:
            return
        self._last_poll = now
        try:
            used, capacity, spills = self._occupancy_fn()
        except Exception:  # raylint: disable=RL006 -- a failed cluster-view RPC must not fail the data plane; arbitration continues on the last good occupancy numbers
            return
        self.polls += 1
        self._used, self._capacity = int(used), int(capacity)
        frac = (used / capacity) if capacity else 0.0
        self.peak_frac = max(self.peak_frac, frac)
        spilled = (
            self._spills_seen is not None and spills > self._spills_seen
        )
        self._spills_seen = int(spills)
        over = frac >= self.high_frac or spilled
        if over and not self.throttled:
            self.throttled = True
            self.throttle_events += 1
            if _metrics.metrics_enabled():
                _THROTTLE_EVENTS.inc()
            # Multiplicative decrease: budgets collapse toward what is
            # actually running (never below the liveness floor of 1).
            for st in self._ops.values():
                st.budget = max(1.0, min(st.budget, float(st.inflight)) / 2)
        elif self.throttled and not over and frac <= self.low_frac:
            self.throttled = False
        elif not self.throttled and frac < self.low_frac:
            # Additive increase, one task per poll interval.
            for st in self._ops.values():
                st.budget = min(float(self.max_inflight), st.budget + 1.0)

    def occupancy_frac(self) -> float:
        with self._lock:
            self._maybe_poll(time.monotonic())
            return (self._used / self._capacity) if self._capacity else 0.0

    # -- acquisition protocol ------------------------------------------------

    def try_acquire(self, op: str) -> bool:
        """One task's submission permit for ``op``. Grants always when the
        operator has nothing in flight (liveness floor); otherwise the
        watermark state, the AIMD budget, and the byte gate must all
        agree. A grant charges the operator's moving-average block size
        until :meth:`release` trues it up."""
        denied = None
        with self._lock:
            st = self._ops.get(op)
            if st is None:
                st = self._ops[op] = _OpState(self.max_inflight)
            self._maybe_poll(time.monotonic())
            if st.inflight == 0:
                return self._grant(op, st)
            if self.throttled:
                denied = "throttled"
            elif st.inflight >= st.budget:
                denied = "budget"
            elif st.avg_bytes is None:
                # First block still in flight: its size seeds the
                # operator's estimate — run the probe solo.
                denied = "probe_solo"
            else:
                est = st.avg_bytes
                total_charged = sum(s.charged for s in self._ops.values())
                if (
                    self._capacity
                    and self._used + total_charged + est
                    > self.high_frac * self._capacity
                ):
                    self.throttle_events += 1
                    if _metrics.metrics_enabled():
                        _THROTTLE_EVENTS.inc()
                    denied = "byte_gate"
                else:
                    return self._grant(op, st)
        # Denials ARE the data plane's gate waits (the executor re-polls
        # until a permit lands). Recorded outside self._lock.
        from ray_tpu_torch.util import flightrec

        if flightrec.on():
            flightrec.record(
                "data", "data.governor_gate", rid=op, reason=denied
            )
        return False

    def _grant(self, op: str, st: _OpState) -> bool:
        charge = st.avg_bytes or 0.0
        st.inflight += 1
        st.charged += charge
        st.charges.append(charge)
        if _metrics.metrics_enabled():
            _INFLIGHT_BYTES.set(st.charged, {"operator": op})
        return True

    def release(self, op: str, actual_bytes: float) -> None:
        """One governed task completed and its output was consumed:
        release the FIFO charge and fold the actual block size into the
        operator's moving average."""
        with self._lock:
            st = self._ops.get(op)
            if st is None or not st.charges:
                return
            charge = st.charges.popleft()
            st.inflight -= 1
            st.charged -= charge
            actual = float(actual_bytes)
            st.avg_bytes = (
                actual
                if st.avg_bytes is None
                else 0.5 * st.avg_bytes + 0.5 * actual
            )
            if _metrics.metrics_enabled():
                _INFLIGHT_BYTES.set(st.charged, {"operator": op})
            self._maybe_poll(time.monotonic())

    def forget(self, op: str) -> None:
        """Stage teardown: zero the operator's gauge and drop its state."""
        with self._lock:
            if self._ops.pop(op, None) is not None and (
                _metrics.metrics_enabled()
            ):
                _INFLIGHT_BYTES.set(0.0, {"operator": op})

    # -- reporting -----------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "peak_occupancy_frac": round(self.peak_frac, 4),
                "throttle_events": self.throttle_events,
                "throttled": self.throttled,
                "polls": self.polls,
                "capacity_bytes": self._capacity,
                "operators": {
                    op: {
                        "inflight": st.inflight,
                        "budget": st.budget,
                        "avg_bytes": st.avg_bytes,
                    }
                    for op, st in self._ops.items()
                },
            }
