"""Flight recorder: always-on, lock-light ring buffers of phase events.
Port of ``ray_tpu/util/flightrec.py``, with the same behaviour.

Every plane (in the port so far: ``llm``) records *phase* events —
monotonic timestamp + duration + request id — into a small per-plane ring
buffer in its own process. Rings are bounded (old events are overwritten,
counted as drops), recording is a dict build plus an index bump under a
per-ring lock held for three statements, and the whole plane collapses to
a single predicate check when the ``RAY_TPU_FLIGHTREC=0`` kill switch is
thrown.

Events carry BOTH clocks: ``t`` is ``time.monotonic()`` (ordering within
the process survives wall-clock adjustment) and each snapshot carries the
per-process wall anchor ``(mono_anchor, wall_anchor)`` captured at import,
so an exporter can place any event on the wall timeline as
``wall_anchor + (t - mono_anchor)``.

Postmortem dumps: :func:`dump` writes every ring to a JSON snapshot under
``GLOBAL_CONFIG.flightrec_dump_dir`` (empty: ``ray_tpu_flightrec`` under
the system's temporary directory, where the reference writes to ``/tmp``),
throttled per reason so a fault storm produces one timeline, not
thousands.

Usage::

    from ray_tpu_torch.util import flightrec

    if flightrec.on():                       # hot paths: one attr read
        flightrec.record("llm", "llm.prefill", dur_s=dt, rid=rid)

    with flightrec.phase("llm", "llm.decode_step"):   # convenience form
        ...

    snap = flightrec.snapshot()              # this process's rings
    path = flightrec.dump("fault:kvship.sever")
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time
from typing import Optional

from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.util import metrics as _metrics
from ray_tpu_torch.util import tracing as _tracing

# Per-process wall anchor: every event timestamp is monotonic; exporters
# recover wall time as wall_anchor + (t - mono_anchor). Captured once at
# import so one pair covers every ring in the process.
MONO_ANCHOR = time.monotonic()
WALL_ANCHOR = time.time()

_EVENTS_TOTAL = _metrics.Counter(
    "raytpu_obs_events_total",
    "Flight-recorder events recorded, per plane ring",
    tag_keys=("plane",),
)
_RING_DROPS_TOTAL = _metrics.Counter(
    "raytpu_obs_ring_drops_total",
    "Flight-recorder events overwritten before any snapshot saw them "
    "(ring wrap: size the ring up if a plane you care about drops)",
    tag_keys=("plane",),
)
_DUMP_TOTAL = _metrics.Counter(
    "raytpu_obs_dump_total",
    "Flight-recorder postmortem dumps written, per trigger reason",
    tag_keys=("reason",),
)

# Metric bumps are batched (one registry touch per _METRIC_BATCH events,
# plus a flush on every snapshot/dump) so the per-event cost stays at a
# ring write even with telemetry on.
_METRIC_BATCH = 256

# One dump per (reason, interval): a fault storm or shed burst produces
# one postmortem timeline, not one file per firing.
_DUMP_MIN_INTERVAL_S = 1.0


class _Ring:
    """One plane's bounded event ring. The lock guards exactly the
    slot-write + index bump; readers copy under the same lock."""

    __slots__ = ("plane", "cap", "buf", "n", "reported", "reported_drops",
                 "lock")

    def __init__(self, plane: str, cap: int):
        self.plane = plane
        self.cap = cap
        self.buf: list = [None] * cap
        self.n = 0  # events ever recorded (n - cap of them overwritten)
        self.reported = 0  # events already flushed to the metric counter
        self.reported_drops = 0
        self.lock = threading.Lock()

    def events(self) -> list:
        """Live events, oldest first (a copy; safe to mutate)."""
        with self.lock:
            n, cap = self.n, self.cap
            if n <= cap:
                return [e for e in self.buf[:n]]
            i = n % cap
            return [e for e in self.buf[i:] + self.buf[:i]]


_rings: dict = {}
_rings_lock = threading.Lock()
_dump_state_lock = threading.Lock()
_last_dump_mono: dict = {}  # reason -> monotonic time of last dump
_dump_seq = 0


def on() -> bool:
    """Is the recorder live? Hot paths check this before building an
    event — with the kill switch thrown every site is one attr read."""
    return GLOBAL_CONFIG.flightrec


def _ring(plane: str) -> _Ring:
    r = _rings.get(plane)
    if r is None:
        with _rings_lock:
            r = _rings.get(plane)
            if r is None:
                r = _Ring(plane, max(8, GLOBAL_CONFIG.flightrec_ring_size))
                _rings[plane] = r
    return r


def record(
    plane: str,
    phase_name: str,
    *,
    dur_s: float = 0.0,
    rid: Optional[str] = None,
    t: Optional[float] = None,
    **extra,
) -> None:
    """Record one phase event into ``plane``'s ring.

    ``t`` is the phase's monotonic START time (defaults to now); ``dur_s``
    its duration (0 for point events). ``rid`` is whatever id stitches
    the event to a request/task/node. A live tracing span is captured
    automatically so driver spans and in-plane events join one tree."""
    if not GLOBAL_CONFIG.flightrec:
        return
    ev = {
        "t": time.monotonic() if t is None else t,
        "plane": plane,
        "phase": phase_name,
        "dur_s": dur_s,
    }
    if rid is not None:
        ev["rid"] = rid
    span = _tracing.current_context()
    if span is not None:
        ev["trace_id"], ev["span_id"] = span[0], span[1]
    if extra:
        ev["extra"] = extra
    ring = _ring(plane)
    with ring.lock:
        ring.buf[ring.n % ring.cap] = ev
        ring.n += 1
        n = ring.n
    if n % _METRIC_BATCH == 0:
        _flush_ring_metrics(ring)


@contextlib.contextmanager
def phase(plane: str, phase_name: str, rid: Optional[str] = None, **extra):
    """Record the enclosed block as one complete phase event (start +
    duration). Convenience form — the hottest sites guard with ``on()``
    and call :func:`record` directly instead."""
    if not GLOBAL_CONFIG.flightrec:
        yield
        return
    t0 = time.monotonic()
    try:
        yield
    finally:
        record(
            plane, phase_name,
            dur_s=time.monotonic() - t0, rid=rid, t=t0, **extra,
        )


def _flush_ring_metrics(ring: _Ring) -> None:
    if not _metrics.metrics_enabled():
        return
    with ring.lock:
        delta = ring.n - ring.reported
        ring.reported = ring.n
        dropped = max(0, ring.n - ring.cap)
        drop_delta = dropped - ring.reported_drops
        ring.reported_drops = dropped
    if delta > 0:
        _EVENTS_TOTAL.inc(float(delta), {"plane": ring.plane})
    if drop_delta > 0:
        _RING_DROPS_TOTAL.inc(float(drop_delta), {"plane": ring.plane})


def snapshot(planes=None) -> dict:
    """This process's rings as one JSON-able dict: the wall anchor plus,
    per plane, the live events (oldest first) and the overwrite count."""
    out_rings = {}
    for plane, ring in sorted(_rings.items()):
        if planes is not None and plane not in planes:
            continue
        _flush_ring_metrics(ring)
        evs = ring.events()
        out_rings[plane] = {
            "events": evs,
            "dropped": max(0, ring.n - ring.cap),
        }
    return {
        "pid": os.getpid(),
        "mono_anchor": MONO_ANCHOR,
        "wall_anchor": WALL_ANCHOR,
        "flightrec": bool(GLOBAL_CONFIG.flightrec),
        "rings": out_rings,
    }


def dump(reason: str, path: Optional[str] = None) -> Optional[str]:
    """Write a postmortem snapshot of every ring to a JSON file and
    return its path (None when the recorder is off or the reason fired
    within the throttle interval). Safe to call from any thread on any
    failure edge — it never raises."""
    global _dump_seq
    if not GLOBAL_CONFIG.flightrec:
        return None
    now = time.monotonic()
    with _dump_state_lock:
        last = _last_dump_mono.get(reason)
        if last is not None and now - last < _DUMP_MIN_INTERVAL_S:
            return None
        _last_dump_mono[reason] = now
        _dump_seq += 1
        seq = _dump_seq
    try:
        snap = snapshot()
        snap["reason"] = reason
        snap["dump_seq"] = seq
        snap["wall_time"] = WALL_ANCHOR + (now - MONO_ANCHOR)
        if path is None:
            d = GLOBAL_CONFIG.flightrec_dump_dir or os.path.join(
                tempfile.gettempdir(), "ray_tpu_flightrec"
            )
            os.makedirs(d, exist_ok=True)
            safe = "".join(
                c if c.isalnum() or c in "._-" else "_" for c in reason
            )
            path = os.path.join(
                d, f"flightrec-{os.getpid()}-{seq:04d}-{safe}.json"
            )
        with open(path, "w") as f:
            json.dump(snap, f, separators=(",", ":"), sort_keys=True)
        if _metrics.metrics_enabled():
            _DUMP_TOTAL.inc(1.0, {"reason": reason.split(":", 1)[0]})
        return path
    except Exception:  # a postmortem dump on a failure edge: the original failure must still propagate
        return None


def drops(plane: str) -> int:
    """Overwritten-event count for one plane (0 for unknown planes)."""
    ring = _rings.get(plane)
    return 0 if ring is None else max(0, ring.n - ring.cap)


def reset() -> None:
    """Drop every ring and the dump throttle state (tests)."""
    with _rings_lock:
        for ring in _rings.values():
            _flush_ring_metrics(ring)
        _rings.clear()
    with _dump_state_lock:
        _last_dump_mono.clear()
