"""Distributed tracing: span context propagated through task submission.
Port of ``ray_tpu/util/tracing.py``, without the reference's
``trace_tree`` query (it reads the state API, not ported yet) and its
per-thread span registry (read only by the sampling profiler, not ported
yet).

Reference parity: python/ray/util/tracing/tracing_helper.py (OpenTelemetry
spans around remote calls, context piggybacked on TaskOptions, opt-in via
RAY_TRACING_ENABLED). Redesigned without an OTel dependency: spans ride
the EXISTING task-event pipeline (core worker buffer -> GCS store), so one
storage/one query path serves the timeline, the state API, and trace
trees.

Usage::

    from ray_tpu_torch.util import tracing
    tracing.enable()                 # or RAY_TPU_TRACING_ENABLED=1

    with tracing.span("ingest"):
        refs = [f.remote(x) for x in data]   # child tasks inherit the trace
        ray_tpu_torch.get(refs)
"""

from __future__ import annotations

import contextlib
import contextvars
import time
import uuid
from typing import Optional

from ray_tpu_torch.core.config import GLOBAL_CONFIG

_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_trace", default=None
)  # (trace_id, span_id) | None

_enabled_override: Optional[bool] = None

# Per-process clock anchor: span events carry monotonic start/end stamps
# (ordering survives wall-clock adjustment mid-run) plus this anchor, so
# a cross-process consumer recovers comparable wall time as
# WALL_ANCHOR + (mono - MONO_ANCHOR). Same contract as util/flightrec.py.
MONO_ANCHOR = time.monotonic()
WALL_ANCHOR = time.time()


def enable() -> None:
    global _enabled_override
    _enabled_override = True


def disable() -> None:
    global _enabled_override
    _enabled_override = False


def enabled() -> bool:
    # An inherited span context means the trace is live HERE regardless of
    # local flags — worker processes learn about tracing purely from the
    # contexts tasks carry in (no cluster-wide flag distribution needed).
    if _ctx.get() is not None:
        return True
    if _enabled_override is not None:
        return _enabled_override
    return GLOBAL_CONFIG.tracing_enabled


def current_context() -> Optional[tuple]:
    """(trace_id, span_id) of the active span, or None."""
    return _ctx.get()


def new_span_ids(parent: Optional[tuple]) -> tuple:
    """(trace_id, span_id, parent_span_id) for a fresh span."""
    span_id = uuid.uuid4().hex[:16]
    if parent is None:
        return uuid.uuid4().hex[:16], span_id, None
    return parent[0], span_id, parent[1]


@contextlib.contextmanager
def span(name: str, **attrs):
    """User span: records start/end into the task-event pipeline; nested
    remote calls inside the block inherit the trace context."""
    if not enabled():
        yield None
        return
    trace_id, span_id, parent_id = new_span_ids(_ctx.get())
    token = _ctx.set((trace_id, span_id))
    start = time.time()
    start_mono = time.monotonic()
    try:
        yield (trace_id, span_id)
    finally:
        _ctx.reset(token)
        end_mono = time.monotonic()
        _record_span_event(
            {
                "task_id": f"span-{span_id}",
                "state": "FINISHED",
                "states": {"RUNNING": start, "FINISHED": time.time()},
                "kind": "user_span",
                "name": name,
                "trace_id": trace_id,
                "span_id": span_id,
                "parent_span_id": parent_id,
                "exec_start_ts": start,
                "exec_end_ts": time.time(),
                # Monotonic stamps + this process's anchor: cross-process
                # ordering survives wall-clock steps (the wall fields
                # above stay for display/back-compat).
                "mono_start": start_mono,
                "mono_end": end_mono,
                "clock_anchor": [MONO_ANCHOR, WALL_ANCHOR],
                **({"attrs": attrs} if attrs else {}),
            }
        )


def _record_span_event(ev: dict) -> None:
    try:
        from ray_tpu_torch.core import api as core_api

        worker = core_api._require_worker(auto_init=False)
        worker._task_events_buf.append(ev)
    except Exception:  # raylint: disable=RL006 -- span record without a live worker (driver exit); trace rows are advisory
        pass


# -- submission/execution hooks (called by the core worker) ------------------


def submission_fields() -> dict:
    """Trace fields for a task being submitted NOW (ties the task's event
    record into the active trace; the task itself becomes a span)."""
    if not enabled():
        return {}
    trace_id, span_id, parent_id = new_span_ids(_ctx.get())
    out = {"trace_id": trace_id, "span_id": span_id}
    if parent_id is not None:
        out["parent_span_id"] = parent_id
    return out


@contextlib.contextmanager
def execution_scope(trace_ctx: Optional[tuple]):
    """Bind the submitter's trace context around task execution so spans
    and nested remote calls inside the user function join the trace."""
    if trace_ctx is None:
        yield
        return
    token = _ctx.set(tuple(trace_ctx))
    try:
        yield
    finally:
        _ctx.reset(token)


def wait_flushed(timeout: float = 5.0) -> bool:
    """Push every span/task event this process has buffered into the GCS
    store and return True once it landed — so ``trace_tree()`` /
    ``state.list_tasks()`` reflect all spans recorded before the call.

    Replaces the hand-rolled ``sleep(0.3)``-and-poll loops tests used to
    need: the GCS merges events by task_id, so synchronously shipping a
    COPY of the buffer is idempotent against the background flush loop
    re-sending the same entries."""
    from ray_tpu_torch.core import api as core_api

    deadline = time.monotonic() + timeout
    try:
        worker = core_api._require_worker(auto_init=False)
    except Exception:  # raylint: disable=RL006 -- no live worker: nothing buffered, nothing to flush
        return True
    while True:
        batch = list(worker._task_events_buf)
        if not batch:
            return True
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return False
        try:
            worker.gcs.call(
                "report_task_events",
                {"events": batch},
                timeout=max(0.1, remaining),
            )
            return True
        except Exception:  # raylint: disable=RL006 -- transient GCS hiccup; retried until the deadline
            time.sleep(min(0.05, max(0.0, deadline - time.monotonic())))
