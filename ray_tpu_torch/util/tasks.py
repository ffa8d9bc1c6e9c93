"""Sanctioned background-task spawner for the asyncio runtime.
Port of ``ray_tpu/util/tasks.py``.

A bare ``asyncio.ensure_future(coro())`` has two failure modes this
codebase has hit live (core/node.py lease-return path, round 10):

1. the event loop keeps only a weak reference to tasks — a task nothing
   holds can be garbage-collected mid-flight;
2. an exception in a task nobody awaits is silently parked until the
   task is GC'd, then dumped as an unreadable "Task exception was never
   retrieved" — or lost entirely at interpreter exit.

``spawn()`` fixes both: the task is strong-referenced until done, and a
done-callback logs any non-cancelled exception. tools/raylint.py rule
RL003 flags discarded ``ensure_future``/``create_task`` results and
points here.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Coroutine, Optional

logger = logging.getLogger("ray_tpu_torch.tasks")

# Strong refs until done — the loop itself only keeps weak ones.
_BACKGROUND: set = set()


def spawn(
    coro: Coroutine,
    *,
    name: str = "task",
    loop: Optional[asyncio.AbstractEventLoop] = None,
    level: int = logging.ERROR,
) -> "asyncio.Task":
    """Schedule ``coro`` as a supervised background task.

    The task is strong-referenced until it finishes, and a failure is
    logged at ``level`` (pass ``logging.DEBUG`` when the exception is
    also retrieved/surfaced elsewhere and the log would be noise).
    Returns the task, so callers can still store/cancel/await it.
    """
    if loop is not None:
        task = loop.create_task(coro)
    else:
        task = asyncio.ensure_future(coro)
    _BACKGROUND.add(task)
    task.add_done_callback(_reaper(name, level))
    return task


# Reapers memoized per (name, level): spawn() sits on the per-RPC dispatch
# path, so it must not build a fresh closure per call. Call sites use a
# bounded set of static names (enforced by the cap below).
_REAPERS: dict = {}


def _reaper(name: str, level: int):
    key = (name, level)
    reap = _REAPERS.get(key)
    if reap is None:
        if len(_REAPERS) > 4096:  # dynamic-name misuse backstop
            _REAPERS.clear()

        def reap(task: "asyncio.Task") -> None:
            _BACKGROUND.discard(task)
            if task.cancelled():
                return
            exc = task.exception()
            if exc is not None:
                logger.log(
                    level,
                    "background task %s failed: %s: %s",
                    name,
                    type(exc).__name__,
                    exc,
                    exc_info=exc if level >= logging.ERROR else None,
                )

        _REAPERS[key] = reap
    return reap


def pending_count() -> int:
    """Live supervised tasks (introspection/test hook)."""
    return len(_BACKGROUND)
