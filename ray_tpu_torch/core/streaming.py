"""Streaming generators: ``num_returns="streaming"`` task results.
Port of ``ray_tpu/core/streaming.py``.

Reference parity: python/ray/_private/object_ref_generator.py:32
(DynamicObjectRefGenerator / ObjectRefGenerator) + the streaming-generator
protocol in src/ray/core_worker (ReportGeneratorItemReturns). Redesign for
this runtime's owner protocol: the executing worker reports each yielded
item to the owner as its own object (inline or shm location) over the
endpoint fabric, one acknowledged RPC per item — the ack doubles as
backpressure, so a fast producer can run at most one item ahead of the
owner. Item object ids are deterministic in (task_id, index), which makes
re-execution after worker death idempotent: indexes the owner already has
are ignored on re-report.

The owner-side generator yields ``ObjectRef``s (call ``get`` on each, as in
the reference); it is NOT serializable — only the owner can iterate.
"""

from __future__ import annotations

import asyncio
import hashlib
from typing import Optional


def stream_item_oid(task_id: str, index: int) -> str:
    """Deterministic object id for the index-th yield of a streaming task
    (re-execution reports the same ids, making duplicate delivery safe)."""
    return hashlib.sha256(f"stream:{task_id}:{index}".encode()).hexdigest()[
        :32
    ]


class StreamState:
    """Owner-side record of one streaming task (lives on the endpoint loop)."""

    __slots__ = ("item_refs", "done", "error", "waiters")

    def __init__(self):
        self.item_refs: list = []  # ObjectRef, in yield order
        self.done = False
        self.error: Optional[Exception] = None
        self.waiters: list[asyncio.Event] = []

    def wake(self) -> None:
        for ev in self.waiters:
            ev.set()
        self.waiters.clear()


class ObjectRefGenerator:
    """Iterator over a streaming task's item ``ObjectRef``s.

    Sync iteration (driver code) blocks the calling thread; async iteration
    (``async for`` — actor methods, Serve replicas) suspends on the owner
    loop. Raises the task's error in place of the next item if the task
    failed mid-stream; ``StopIteration`` / ``StopAsyncIteration`` after the
    final item of a completed task.
    """

    def __init__(self, task_id: str, worker, sentinel_ref):
        self._task_id = task_id
        self._worker = worker
        # Keeps the task spec (lineage) alive and gives cancel() a target.
        self._sentinel_ref = sentinel_ref
        self._cursor = 0

    @property
    def task_id(self) -> str:
        return self._task_id

    def __iter__(self):
        return self

    def __next__(self):
        ref = self._worker.stream_next(self._task_id, self._cursor)
        if ref is None:
            raise StopIteration
        self._cursor += 1
        return ref

    def __aiter__(self):
        return self

    async def __anext__(self):
        ref = await self._worker.stream_next_async(
            self._task_id, self._cursor
        )
        if ref is None:
            raise StopAsyncIteration
        self._cursor += 1
        return ref

    def completed(self):
        """The sentinel ref: resolves when the whole stream finished (get()
        raises the task's error if it failed). Also what cancel() targets."""
        return self._sentinel_ref

    def __reduce__(self):
        raise TypeError(
            "ObjectRefGenerator is not serializable: only the owner process "
            "can iterate a streaming task's results"
        )

    def __del__(self):
        worker, task_id = self._worker, self._task_id
        if worker is not None:
            try:
                worker.drop_stream(task_id)
            except Exception:  # raylint: disable=RL006 -- generator GC race with worker shutdown; server ttl reaps the stream
                pass
