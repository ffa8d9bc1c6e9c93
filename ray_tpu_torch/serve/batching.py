"""@serve.batch — transparent request micro-batching inside a replica.

Reference parity: python/ray/serve/batching.py (@serve.batch). Port of
``ray_tpu/serve/batching.py``. On a GPU this is the difference between
feeding the tensor cores one request at a time and feeding them a batch: the decorated method takes a LIST of items and returns a LIST of
results; individual callers call it with ONE item and await their own
result. Items queue until the batch is full or the wait timeout fires,
whichever is first; one underlying call serves the whole batch.

    class Embedder:
        @serve.batch(max_batch_size=16, batch_wait_timeout_s=0.01)
        async def embed(self, prompts: list[str]) -> list[np.ndarray]:
            return model(np.stack(prompts))      # one batched forward

        async def __call__(self, request):
            return await self.embed(request["body"]["text"])
"""

from __future__ import annotations

import asyncio
import functools
from typing import Any, Callable, Optional
from ray_tpu_torch.util.tasks import spawn


class _BatchQueue:
    """Accumulates (item, future) pairs and fires the user fn over the
    batch when it fills or the wait timer expires."""

    def __init__(self, fn: Callable, max_batch_size: int, timeout_s: float):
        self._fn = fn
        self._max = max_batch_size
        self._timeout_s = timeout_s
        self._pending: list = []  # (item, asyncio.Future, arrival_ts)
        self._flusher: Optional[asyncio.Task] = None

    def submit(self, item) -> "asyncio.Future":
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._pending.append((item, fut, loop.time()))
        if len(self._pending) >= self._max:
            self._fire()
        elif self._flusher is None or self._flusher.done():
            self._flusher = asyncio.ensure_future(self._flush_after_wait())
        return fut

    async def _flush_after_wait(self):
        # Sleep until the OLDEST pending item's deadline: an item carried
        # over from a full batch has already waited part (or all) of its
        # budget and must not be charged a fresh full timeout.
        loop = asyncio.get_running_loop()
        while self._pending:
            oldest = self._pending[0][2]
            delay = oldest + self._timeout_s - loop.time()
            if delay <= 0:
                break
            await asyncio.sleep(delay)
        self._fire()

    def _fire(self) -> None:
        if self._flusher is not None:
            self._flusher.cancel()
            self._flusher = None
        batch, self._pending = self._pending[: self._max], self._pending[
            self._max:
        ]
        if not batch:
            return
        if self._pending:
            # Overflow: restart the timer against the leftover items' own
            # arrival times (fires immediately if they are already due).
            self._flusher = asyncio.ensure_future(self._flush_after_wait())
        spawn(self._run_batch(batch), name="serve batch run")

    async def _run_batch(self, batch: list) -> None:
        items = [item for item, _, _ in batch]
        futures = [fut for _, fut, _ in batch]
        try:
            results = await self._fn(items)
            if results is None or len(results) != len(items):
                raise TypeError(
                    f"@serve.batch function must return exactly one result "
                    f"per item ({len(items)} in, "
                    f"{'None' if results is None else len(results)} out)"
                )
        except Exception as e:  # noqa: BLE001 — every caller sees the error
            for fut in futures:
                if not fut.done():
                    fut.set_exception(e)
            return
        for fut, res in zip(futures, results):
            if not fut.done():
                fut.set_result(res)


class _BatchedCallable:
    """Wrapper returned by @serve.batch. Called directly (free async fn) it
    uses one shared queue; accessed through an instance (method) it binds a
    PER-INSTANCE queue — replicas must not share batches across instances."""

    def __init__(self, fn, max_batch_size: int, timeout_s: float):
        self._fn = fn
        self._max = max_batch_size
        self._timeout_s = timeout_s
        self._free_queue: _BatchQueue | None = None
        functools.update_wrapper(self, fn)

    async def __call__(self, item):
        if self._free_queue is None:
            self._free_queue = _BatchQueue(
                self._fn, self._max, self._timeout_s
            )
        return await self._free_queue.submit(item)

    def __get__(self, instance, owner=None):
        if instance is None:
            return self
        cache_name = f"__batch_queue_{self._fn.__name__}"
        queue = getattr(instance, cache_name, None)
        if queue is None:
            bound = self._fn.__get__(instance, owner)
            queue = _BatchQueue(bound, self._max, self._timeout_s)
            setattr(instance, cache_name, queue)

        async def call_one(item):
            return await queue.submit(item)

        functools.update_wrapper(call_one, self._fn)
        return call_one


def batch(
    _fn: Callable | None = None,
    *,
    max_batch_size: int = 10,
    batch_wait_timeout_s: float = 0.01,
) -> Any:
    """Decorate an async def taking a list and returning a list; callers
    pass single items (reference: python/ray/serve/batching.py @serve.batch).
    Works on methods and free async functions."""
    if max_batch_size < 1:
        raise ValueError("max_batch_size must be >= 1")

    def wrap(fn):
        if not asyncio.iscoroutinefunction(fn):
            raise TypeError("@serve.batch requires an async def")
        return _BatchedCallable(fn, max_batch_size, batch_wait_timeout_s)

    return wrap if _fn is None else wrap(_fn)
