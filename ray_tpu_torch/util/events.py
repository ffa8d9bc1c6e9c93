"""Structured cluster events: definition + lifecycle records with export.
Port of ``ray_tpu/util/events.py``.

Reference parity: src/ray/observability/ray_event_recorder.h (typed
definition/lifecycle events for actors/jobs/nodes/tasks) + the dashboard
aggregator module (python/ray/dashboard/modules/aggregator/) that ships
them to an external pipeline. Redesign: one in-process recorder owned by
the GCS; every record carries

    {event_id, timestamp, source, kind, entity_id, attrs}

with kind in {NODE, ACTOR, JOB, PLACEMENT_GROUP} x {DEFINITION, LIFECYCLE}.
Sinks: a bounded in-memory ring (the dashboard /api/events route reads it)
and an optional JSON-lines file (`RAY_TPU_EVENT_EXPORT_PATH`) an external
collector can tail — the aggregator-pipeline role without inventing a
wire protocol.
"""

from __future__ import annotations

import json
import queue
import threading
import time
import uuid
from collections import deque
from typing import Any, Optional

from ray_tpu_torch.core.config import GLOBAL_CONFIG

DEFINITION = "DEFINITION"
LIFECYCLE = "LIFECYCLE"


class EventRecorder:
    """Bounded recorder + optional file export. Thread-safe (the GCS loop
    records; dashboard reads may come from any thread)."""

    def __init__(
        self,
        source: str = "gcs",
        capacity: int = 10_000,
        export_path: Optional[str] = None,
    ):
        self._source = source
        self._events: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._io_lock = threading.Lock()
        self._export_path = (
            export_path or GLOBAL_CONFIG.event_export_path or None
        )
        self._export_file = None
        self._dropped = 0
        # Export runs on a background writer thread: record() is called on
        # the GCS event loop, and a hung export sink (NFS, full disk) must
        # never block the control plane. Bounded queue, drop on overflow.
        self._export_q: queue.Queue = queue.Queue(maxsize=4096)
        self._export_dropped = 0
        self._export_thread: Optional[threading.Thread] = None
        self._closed = False

    def record(
        self,
        entity_kind: str,  # NODE | ACTOR | JOB | PLACEMENT_GROUP
        event_type: str,  # DEFINITION | LIFECYCLE
        entity_id: str,
        attrs: dict | None = None,
    ) -> dict:
        ev = {
            "event_id": uuid.uuid4().hex[:16],
            "timestamp": time.time(),
            "source": self._source,
            "kind": f"{entity_kind}_{event_type}",
            "entity_id": entity_id,
            "attrs": dict(attrs or {}),
        }
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self._dropped += 1
            self._events.append(ev)
        if self._export_path and not self._closed:
            self._ensure_export_thread()
            try:
                self._export_q.put_nowait(ev)
            except queue.Full:
                self._export_dropped += 1
        return ev

    def _ensure_export_thread(self) -> None:
        if self._export_thread is not None:
            return
        with self._io_lock:
            if self._export_thread is None:
                t = threading.Thread(
                    target=self._export_loop,
                    name="event-export",
                    daemon=True,
                )
                self._export_thread = t
                t.start()

    def _export_loop(self) -> None:
        while True:
            ev = self._export_q.get()
            if ev is None:  # close() sentinel
                return
            self._export(ev)

    def _export(self, ev: dict) -> None:
        try:
            if self._export_file is None:
                self._export_file = open(self._export_path, "a")
            json.dump(ev, self._export_file, default=str)
            self._export_file.write("\n")
            self._export_file.flush()
        except Exception:
            # Export is best-effort; the ring buffer is the source of
            # truth for the dashboard. Drop the file handle so a later
            # event retries the open (rotated/remounted path).
            try:
                if self._export_file is not None:
                    self._export_file.close()
            except Exception:  # raylint: disable=RL006 -- export-file close after a write error; sink already broken
                pass
            self._export_file = None

    def list_events(
        self,
        *,
        kind: Optional[str] = None,
        entity_id: Optional[str] = None,
        limit: int = 1000,
    ) -> list[dict]:
        with self._lock:
            out = list(self._events)
        if kind:
            out = [e for e in out if e["kind"].startswith(kind)]
        if entity_id:
            out = [e for e in out if e["entity_id"] == entity_id]
        return out[-limit:]

    def stats(self) -> dict:
        with self._lock:
            return {
                "buffered": len(self._events),
                "dropped": self._dropped,
                "export_dropped": self._export_dropped,
                "export_path": self._export_path,
            }

    def close(self) -> None:
        """Drain queued export lines (bounded wait), then close the file."""
        self._closed = True
        t = self._export_thread
        if t is not None:
            try:
                self._export_q.put_nowait(None)
            except queue.Full:
                pass
            t.join(timeout=5.0)
        with self._lock:
            if self._export_file is not None:
                try:
                    self._export_file.close()
                except Exception:  # raylint: disable=RL006 -- export-file close during shutdown; sink already broken
                    pass
                self._export_file = None
