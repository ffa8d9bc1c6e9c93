"""Double-buffered device input for the train loop. Port of
``ray_tpu/train/input.py``.

The other half of the host-free steady state (async dispatch being the
first): the NEXT batch must already be on the card — this rank's block of
it, under the step's ``NamedSharding`` — when the current step's launches
return, so the timed region never contains host staging (batch slicing,
pinning, the host->device copy). A staging thread keeps a bounded queue of
device-resident batches ahead of the consumer: it pins each leaf and
copies it with ``non_blocking=True`` on a dedicated CUDA stream, recording
an event behind the copies; the consumer's stream waits on that event
(``__next__``), so the step never reads a batch before its copy landed
and the staging thread never blocks on the card.

Used directly: wrap any host-batch iterator. Each staged batch is consumed
exactly once.
"""

from __future__ import annotations

import queue
import threading
import time as _time
from typing import Any, Iterable, Iterator, Optional

import numpy as np
import torch

from ray_tpu_torch.train._tree import map_leaves
from ray_tpu_torch.util import flightrec as _flightrec
from ray_tpu_torch.util import metrics as _metrics

# A miss = the consumer reached next() before the staging thread had the
# next batch on device — the host data path is slower than the step, and
# the stall it causes is exactly what this iterator exists to hide.
_PREFETCH_MISSES = _metrics.Counter(
    "raytpu_train_prefetch_misses_total",
    "train input batches the consumer had to wait on (prefetch underrun)",
)

_SENTINEL = object()


class _Staged:
    """One staged batch: its tree, the event recorded behind its copies
    (None where nothing was copied to the card) and the copied tensors."""

    __slots__ = ("tree", "ready", "on_card")

    def __init__(self, tree: Any, ready: Any, on_card: list):
        self.tree, self.ready, self.on_card = tree, ready, on_card


class DevicePrefetchIterator:
    """Stage host batches on the device ahead of the consuming train step.

    ``depth`` batches (default: config ``train_prefetch_depth``) are held
    on the device at a time; ``depth=0`` hands host batches straight
    through (no thread, no staging — the passthrough arm of the A/B).
    ``sharding`` (a :class:`~ray_tpu_torch.parallel.NamedSharding`) keeps
    this rank's block of every leaf of a global batch. ``device`` is where
    batches land (the card unless the caller asks for ``"cpu"``): for a
    CUDA device each leaf is pinned in the staging thread and copied with
    ``non_blocking=True`` on a dedicated stream, an event recorded behind
    the copies; for the CPU nothing is staged (numpy leaves become tensors
    sharing their memory). Exceptions from the source iterator surface at
    the consumer's next() call, after all successfully staged batches have
    been consumed.

    A consumer that stops early (break / exception) should call
    :meth:`close` (or drop the iterator — ``__del__`` closes too) so the
    staging thread releases its staged batches instead of parking
    on a full queue for the life of the process.
    """

    def __init__(
        self,
        batches: Iterable,
        *,
        sharding: Any = None,
        depth: Optional[int] = None,
        device: "str | torch.device" = "cuda",
    ):
        if depth is None:
            from ray_tpu_torch.core.config import GLOBAL_CONFIG

            # One kill switch restores the whole synchronous loop:
            # RAY_TPU_TRAIN_ASYNC_DISPATCH=0 also turns default-depth
            # prefetch into host passthrough (an explicit depth= wins).
            depth = (
                GLOBAL_CONFIG.train_prefetch_depth
                if GLOBAL_CONFIG.train_async_dispatch
                else 0
            )
        self._depth = max(0, int(depth))
        self._sharding = sharding
        self._device = torch.device(device)
        self._stream = None
        if self._depth > 0 and self._device.type == "cuda":
            # The card the consumer's thread trains on (no CUDA: raises).
            if self._device.index is None:
                self._device = torch.device("cuda", torch.cuda.current_device())
            self._stream = torch.cuda.Stream(self._device)
        self._it = iter(batches)
        self._error: Optional[BaseException] = None
        self._done = False
        self._first = True  # warm-up get: not an underrun by definition
        self._stop = threading.Event()
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        if self._depth > 0:
            self._queue = queue.Queue(maxsize=self._depth)
            self._thread = threading.Thread(
                target=self._fill, name="train-input-prefetch", daemon=True
            )
            self._thread.start()

    def _stage(self, batch: Any) -> "_Staged":
        sharding, stream = self._sharding, self._stream
        on_card: list = []

        def place(leaf):
            if isinstance(leaf, np.ndarray):
                leaf = torch.as_tensor(leaf)
            if not isinstance(leaf, torch.Tensor):
                return leaf
            if sharding is not None:
                leaf = sharding.shard(leaf)
            if stream is None or leaf.is_cuda:
                return leaf
            src = leaf if leaf.is_pinned() else leaf.pin_memory()
            with torch.cuda.stream(stream):
                out = src.to(self._device, non_blocking=True)
            on_card.append(out)
            return out

        tree = map_leaves(place, batch)
        ready = None
        if on_card:
            ready = torch.cuda.Event()
            ready.record(stream)
        return _Staged(tree, ready, on_card)

    def _put(self, item: Any) -> bool:
        """Bounded put that gives up when close() fired, so an abandoned
        iterator never parks the staging thread on a full queue."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _fill(self) -> None:
        try:
            for batch in self._it:
                if not self._put(self._stage(batch)):
                    return
        except BaseException as e:  # noqa: BLE001  # raylint: disable=RL006 -- stored and re-raised at the consumer's next() call
            self._error = e
        finally:
            self._put(_SENTINEL)

    def close(self) -> None:
        """Release the staging thread and every staged batch. Idempotent;
        called automatically at exhaustion and on __del__ — call it
        explicitly when breaking out of the loop early."""
        self._done = True
        if self._queue is None:
            return
        self._stop.set()
        # Drain so a put-blocked thread wakes, sees the stop flag, exits.
        for _ in range(2):
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            if self._thread is not None:
                self._thread.join(timeout=0.5)
                if not self._thread.is_alive():
                    break

    def __del__(self):
        try:
            self.close()
        except Exception:  # raylint: disable=RL006 -- interpreter-teardown __del__; nothing to report to
            pass

    def __iter__(self) -> Iterator:
        return self

    def __next__(self) -> Any:
        if self._done:
            raise StopIteration
        if self._queue is None:
            # depth=0 passthrough: the host batch, untouched and unstaged.
            try:
                return next(self._it)
            except StopIteration:
                self._done = True
                raise
        # The warm-up get races thread startup and is not a signal; from
        # then on, an empty queue means the host data path fell behind.
        underrun = not self._first and self._queue.empty()
        fr = _flightrec.on()
        t_w = _time.monotonic() if fr else 0.0
        item = self._queue.get()
        if fr:
            _flightrec.record(
                "train", "train.data_wait", t=t_w,
                dur_s=_time.monotonic() - t_w, underrun=underrun,
            )
        self._first = False
        if item is _SENTINEL:
            self._done = True
            if self._error is not None:
                raise self._error
            raise StopIteration
        if underrun and _metrics.metrics_enabled():
            _PREFETCH_MISSES.inc()
        if item.ready is not None:
            # The step's stream waits for the copies; each staged tensor is
            # marked as used there, so the caching allocator does not hand
            # its memory to the next staged batch before the step is done.
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(item.ready)
            for t in item.on_card:
                t.record_stream(consumer)
        return item.tree
