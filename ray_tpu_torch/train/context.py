"""Per-worker train context and the ``ray_tpu_torch.train.report()`` API.
Port of ``ray_tpu/train/context.py``.

Reference parity: python/ray/train/v2/api/train_fn_utils.py (report/
get_context/get_checkpoint) and the TrainContext of
train/v2/_internal/execution/context.py. The context is installed by the
TrainWorker before the user's train loop runs on its thread.

The async report ring is where the reference reads JAX arrays back; here a
report is device-resident when any leaf is a ``torch.Tensor`` (a CPU tensor
counts too, as any ``jax.Array`` counts on the reference's CPU). At
enqueue, each CUDA leaf's copy into pinned host memory starts on a side
stream, ordered after an event recorded on the producing stream; the ring's
one designated sync (:func:`_materialize_metrics`) waits on the copies and
unwraps 0-d values to Python scalars, so a report leaves the worker as
plain values, never as a tensor.
"""

from __future__ import annotations

import sys
import threading
import time as _time
from dataclasses import dataclass, field
from typing import Any, Optional

from ray_tpu_torch.train._tree import leaves as _leaves
from ray_tpu_torch.train._tree import map_leaves as _map_leaves
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.storage import StorageContext
from ray_tpu_torch.util import flightrec as _flightrec
from ray_tpu_torch.util import metrics as _metrics

# Step-time telemetry: train loops call report() once per step (reference
# convention), so the gap between consecutive report() calls on one worker
# IS the step time — data loading, compute, and collectives included.
# With async dispatch (device-resident metrics + the pipelined ring) the
# gap is launch-bounded, i.e. device time, not host readback stalls.
# Counters/histograms sum across ranks at merge time.
_STEP_SECONDS = _metrics.Histogram(
    "raytpu_train_step_seconds",
    "time between consecutive train.report() calls on one worker",
    boundaries=[0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                60.0, 300.0],
)
_REPORTS = _metrics.Counter(
    "raytpu_train_reports_total",
    "train.report() calls (steps) across all workers",
)
# Host-overlap telemetry: how long report() spends BLOCKED on
# device->host metric readback per materialization — the number async
# dispatch exists to take off the step path — and how many
# device-resident reports are in flight in the ring right now.
_HOST_BLOCKED = _metrics.Histogram(
    "raytpu_train_host_blocked_seconds",
    "time train.report() blocks on device->host metric readback",
    boundaries=[0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0,
                5.0, 30.0],
)
_DISPATCH_DEPTH = _metrics.Gauge(
    "raytpu_train_dispatch_depth",
    "device-resident metric reports currently in flight (async ring)",
)

_ctx_local = threading.local()


def _torch():
    """torch where this process has imported it, else None: a host-metrics
    train loop (plain floats) must not pay a torch import inside report()."""
    return sys.modules.get("torch")


def _has_device_leaves(metrics: Any) -> bool:
    """True when any metrics leaf is a ``torch.Tensor`` (device-resident;
    a CPU tensor counts too)."""
    torch = _torch()
    if torch is None:
        return False
    return any(isinstance(leaf, torch.Tensor) for leaf in _leaves(metrics))


class _HostCopy:
    """A report's metrics on their way to the host: the tree with each
    tensor leaf replaced by its host copy (pinned for a CUDA leaf), the
    events recorded on the copy streams behind the copies, and the CUDA
    sources, kept alive until the copies land."""

    __slots__ = ("tree", "done", "sources")

    def __init__(self, tree: Any, done: list, sources: list):
        self.tree, self.done, self.sources = tree, done, sources


_copy_streams: dict = {}


def _copy_stream(torch, device):
    stream = _copy_streams.get(device)
    if stream is None:
        stream = _copy_streams[device] = torch.cuda.Stream(device)
    return stream


def _start_host_copy(metrics: Any) -> _HostCopy:
    """Kick off NON-blocking device->host copies of every tensor leaf of an
    enqueued report. A CUDA leaf is copied into pinned host memory on a side
    stream that waits on an event recorded on the producing stream, so the
    copy runs as soon as the step finishes on the card, overlapped with the
    steps launched after it; the flush point then finds the bytes on the
    host. A CPU leaf is copied at once (a snapshot, as an immutable array
    is)."""
    torch = _torch()
    if torch is None:
        return _HostCopy(metrics, [], [])
    done, sources, streams = [], [], {}

    def start(leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        leaf = leaf.detach()
        if not leaf.is_cuda:
            return leaf.clone()
        stream = streams.get(leaf.device)
        if stream is None:
            produced = torch.cuda.Event()
            produced.record(torch.cuda.current_stream(leaf.device))
            stream = streams[leaf.device] = _copy_stream(torch, leaf.device)
            stream.wait_event(produced)
        host = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
        with torch.cuda.stream(stream):
            host.copy_(leaf, non_blocking=True)
        sources.append(leaf)
        return host

    tree = _map_leaves(start, metrics)
    for stream in streams.values():
        event = torch.cuda.Event()
        event.record(stream)
        done.append(event)
    return _HostCopy(tree, done, sources)


def _plain(leaf: Any) -> Any:
    """A host leaf as the controller wire takes it: a 0-d tensor or array
    becomes a Python scalar, any other tensor a numpy array (bf16 widened
    to f32, which numpy lacks)."""
    torch = _torch()
    if torch is not None and isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dim() == 0:
            return leaf.item()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.numpy()
    np = sys.modules.get("numpy")
    if np is not None and isinstance(leaf, np.ndarray) and leaf.ndim == 0:
        return leaf.item()
    return leaf


def _materialize_metrics(metrics: Any) -> Any:
    """Wait for a metrics tree's device->host copies (blocks until the
    producing step finished on the card) and unwrap 0-d values to Python
    scalars so reports stay plain dicts on the controller wire. Takes a
    :func:`_start_host_copy` result or a raw tree (the synchronous loop)."""
    t0 = _time.perf_counter()
    t_m = _time.monotonic()
    # The ONE intended host-sync of the async-dispatch tier: ring
    # eviction/flush/checkpoint materialization. Enqueue-time copies
    # (above) already overlapped the transfer.
    if isinstance(metrics, _HostCopy):
        for event in metrics.done:
            event.synchronize()
        host = metrics.tree
        metrics.sources = []
    else:
        host = _map_leaves(_plain, metrics)
    if _metrics.metrics_enabled():
        _HOST_BLOCKED.observe(_time.perf_counter() - t0)
    if _flightrec.on():
        _flightrec.record(
            "train", "train.d2h_report", t=t_m,
            dur_s=_time.monotonic() - t_m,
        )
    return _map_leaves(_plain, host)


@dataclass
class TrainContext:
    experiment_name: str
    world_size: int
    world_rank: int
    local_rank: int
    local_world_size: int
    node_rank: int
    # Slice identity (the reference's hierarchical collective tier): the
    # port's nodes carry no slice labels, so "" / 0 / 1 on every rank.
    slice_name: str = ""
    slice_rank: int = 0
    num_slices: int = 1
    storage: Optional[StorageContext] = None
    latest_checkpoint: Optional[Checkpoint] = None
    # reports buffered here; the controller polls them off the worker
    _reports: list = field(default_factory=list)
    _report_index: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock)
    _last_report_t: float = 0.0  # step-time anchor (perf_counter)
    _fr_last_report_m: float = 0.0  # flight-recorder step anchor (monotonic)
    # Async-dispatch ring: device-resident metric reports not yet read
    # back to host, oldest first. Bounded by train_async_dispatch_depth;
    # eviction/flush materializes entries (in index order) into _reports.
    _pending: list = field(default_factory=list)
    # Elastic plane: the latest step-boundary state the train fn handed to
    # report(elastic_state=...) — {"state", "index", "layout"} — retained
    # in worker memory (never persisted) so a membership change can move
    # it peer-to-peer instead of restoring from checkpoint storage. On a
    # resumed generation the worker pre-loads the hydrated boundary state
    # here before the fn re-runs; get_elastic_state() hands it back.
    _elastic: Optional[dict] = None
    # Set by the controller (via TrainWorker.request_pause): report()
    # raises ElasticPauseSignal AFTER capturing the step's report and
    # elastic state, so the fn unwinds at a clean boundary.
    _pause_requested: bool = False

    # -- user API ------------------------------------------------------------

    def get_experiment_name(self) -> str:
        return self.experiment_name

    def get_world_size(self) -> int:
        return self.world_size

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_local_world_size(self) -> int:
        return self.local_world_size

    def get_node_rank(self) -> int:
        return self.node_rank

    def get_slice_name(self) -> str:
        return self.slice_name

    def get_slice_rank(self) -> int:
        return self.slice_rank

    def get_num_slices(self) -> int:
        return self.num_slices

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return self.latest_checkpoint

    def get_elastic_state(self) -> Optional[dict]:
        """The hydrated step-boundary state after an elastic reshape:
        ``{"state": <tree>, "index": <report index it was captured
        at>}``, or None on a fresh (or checkpoint-restored) generation.
        A resumed train fn checks this FIRST — before get_checkpoint() —
        and continues from ``index + 1``; the step stream is then
        bit-identical to a from-checkpoint restore at the same boundary."""
        with self._lock:
            if self._elastic is None:
                return None
            return {
                "state": self._elastic["state"],
                "index": self._elastic["index"],
            }

    def request_pause(self) -> bool:
        """Arm the step-boundary pause (controller-side elastic RPC). The
        NEXT report() call completes normally — its report is buffered and
        its elastic_state retained — then raises ElasticPauseSignal."""
        with self._lock:
            self._pause_requested = True
        return True

    def report(
        self,
        metrics: dict,
        checkpoint: Optional[Checkpoint] = None,
        sharded_state: Any = None,
        elastic_state: Any = None,
        elastic_layout: str = "replicated",
    ) -> None:
        """Report metrics (all ranks, in lockstep) and optionally persist a
        checkpoint. ``checkpoint`` copies a worker-local directory into the
        run dir (per-rank files merge); ``sharded_state`` is the SPMD path:
        a state written IN PLACE into the run dir by
        :func:`~ray_tpu_torch.train.sharded_checkpoint.save_sharded`, each
        rank its own blocks — every rank must pass its (identically
        structured) state, collectively over the default process group.
        Restore with load_sharded_state(ctx.get_checkpoint(), template).

        Pipelined mode (host-free steady state): when ``metrics`` is a
        DEVICE-RESIDENT tree (torch tensor leaves) and async dispatch is on
        (``train_async_dispatch``), the tree is enqueued into a bounded
        ring instead of read back — report() returns without waiting for
        the step to execute (the device->host copy starts on a side stream
        behind the step), so up to ``train_async_dispatch_depth`` steps of
        launches run ahead of the card. Host readback happens only on
        ring eviction, at checkpoint boundaries (which flush the ring
        first), or at :meth:`flush` — each step's metrics surface at most
        ``depth`` reports late, bit-identical to the synchronous loop.

        Elastic mode: ``elastic_state`` retains the step's state tree in
        worker memory (a reference — nothing is copied or persisted; a
        state the step updates in place is the boundary's until the next
        report, and the pause unwinds the fn at a report) so a
        membership change can reshard it peer-to-peer over the transfer
        fabric instead of reading checkpoint storage; ``elastic_layout``
        declares how ranks hold it ("replicated": every rank has the full
        copy; "sharded": each rank holds its balanced dim0 shard of every
        sharded leaf). If the controller has requested a pause, report()
        raises ElasticPauseSignal AFTER the report is buffered and the
        state retained — the step boundary is the pause point."""
        if checkpoint is not None and sharded_state is not None:
            raise ValueError(
                "pass either checkpoint= or sharded_state=, not both"
            )
        with self._lock:
            index = self._report_index
            self._report_index += 1
        if _metrics.metrics_enabled():
            now = _time.perf_counter()
            _REPORTS.inc(1.0)
            if self._last_report_t:
                _STEP_SECONDS.observe(now - self._last_report_t)
            self._last_report_t = now
        if _flightrec.on():
            # The reference convention: one report() per step, so the gap
            # between consecutive calls IS the step (data + compute +
            # collectives). Own monotonic anchor — independent of the
            # metrics kill switch.
            now_m = _time.monotonic()
            if self._fr_last_report_m:
                _flightrec.record(
                    "train", "train.step", t=self._fr_last_report_m,
                    dur_s=now_m - self._fr_last_report_m, rid=str(index),
                    rank=self.world_rank,
                )
            self._fr_last_report_m = now_m
        device_resident = _has_device_leaves(metrics)
        if checkpoint is None and sharded_state is None and device_resident:
            depth = self._async_depth()
            if depth > 0:
                self._enqueue_async(index, metrics, depth)
                self._post_report(index, elastic_state, elastic_layout)
                return
            # Kill-switch arm: synchronous readback on the step path (the
            # host-blocked time lands in raytpu_train_host_blocked_seconds
            # either way, so the A/B measures exactly the stall removed).
            metrics = _materialize_metrics(metrics)
        else:
            # Checkpoint boundary (or a host-metrics report): in-flight
            # reports materialize FIRST so the restore point never precedes
            # its own metrics and _reports stays index-ordered.
            if self._pending:
                self.flush()
            if device_resident:
                metrics = _materialize_metrics(metrics)
        # Persist OUTSIDE the lock: a multi-GB copytree must not block the
        # controller's status() polls (it would read as a dead worker).
        persisted = None
        if sharded_state is not None and self.storage is not None:
            persisted = self._persist_sharded(sharded_state, index)
        elif checkpoint is not None and self.storage is not None:
            persisted = self.storage.persist_checkpoint(
                checkpoint,
                index,
                world_rank=self.world_rank,
                world_size=self.world_size,
            )
        with self._lock:
            if persisted is not None:
                self.latest_checkpoint = persisted
            self._reports.append(
                {
                    "index": index,
                    "metrics": dict(metrics),
                    "checkpoint_path": persisted.path if persisted else None,
                    "world_rank": self.world_rank,
                }
            )
        self._post_report(index, elastic_state, elastic_layout)

    def _post_report(
        self, index: int, elastic_state: Any, elastic_layout: str
    ) -> None:
        """Shared report() tail: retain the boundary state, then honor a
        pending pause — AFTER retention, so the pause point always has the
        step's state, and after a ring flush, so every report at or before
        the boundary is materialized when the controller drains."""
        pause = False
        with self._lock:
            if elastic_state is not None:
                self._elastic = {
                    "state": elastic_state,
                    "index": index,
                    "layout": elastic_layout,
                }
            if self._pause_requested:
                self._pause_requested = False
                pause = True
        if pause:
            from ray_tpu_torch.train.elastic import ElasticPauseSignal

            self.flush()
            raise ElasticPauseSignal(f"paused at step boundary {index}")

    def _persist_sharded(self, state: Any, index: int) -> Checkpoint:
        """Collective sharded save straight into the run's checkpoint dir
        (every rank writes only its own shards), then stamp this rank's
        commit marker — the controller finalizes the round once every
        rank's report arrived, exactly as for file checkpoints."""
        import os

        from ray_tpu_torch.train.sharded_checkpoint import save_sharded
        from ray_tpu_torch.train.storage import SHARDED_SUBDIR, _marker_name

        final = self.storage.checkpoint_dir(index)
        save_sharded(state, os.path.join(final, SHARDED_SUBDIR))
        with open(
            os.path.join(
                final, _marker_name(self.world_rank, self.world_size)
            ),
            "w",
        ):
            pass
        return Checkpoint(final)

    # -- async dispatch (host-free steady state) ----------------------------

    @staticmethod
    def _async_depth() -> int:
        from ray_tpu_torch.core.config import GLOBAL_CONFIG

        if not GLOBAL_CONFIG.train_async_dispatch:
            return 0
        return max(0, int(GLOBAL_CONFIG.train_async_dispatch_depth))

    def _enqueue_async(self, index: int, metrics: Any, depth: int) -> None:
        """Enqueue a device-resident report, its host copy started;
        evict (materialize) the oldest entries past ``depth`` — the only
        host blocking on the steady-state step path, and it waits on a
        step launched ``depth`` steps ago, which has almost certainly
        already executed."""
        metrics = _start_host_copy(metrics)
        evicted = []
        with self._lock:
            self._pending.append({"index": index, "metrics": metrics})
            while len(self._pending) > depth:
                evicted.append(self._pending.pop(0))
            occupancy = len(self._pending)
        if _metrics.metrics_enabled():
            _DISPATCH_DEPTH.set(float(occupancy))
        for entry in evicted:
            self._materialize_entry(entry)

    def _materialize_entry(self, entry: dict) -> None:
        report = {
            "index": entry["index"],
            "metrics": dict(_materialize_metrics(entry["metrics"])),
            "checkpoint_path": None,
            "world_rank": self.world_rank,
        }
        with self._lock:
            self._reports.append(report)

    def flush(self) -> None:
        """Force host readback of every in-flight async report, in index
        order. Called at checkpoint boundaries (report(checkpoint=...) /
        report(sharded_state=...)) and when the train fn returns, so no
        metrics are lost to the ring; user loops may also call it to bound
        staleness explicitly."""
        with self._lock:
            pending, self._pending = self._pending, []
        for entry in pending:
            self._materialize_entry(entry)
        if pending and _metrics.metrics_enabled():
            _DISPATCH_DEPTH.set(0.0)

    def drain_reports(self) -> list:
        with self._lock:
            out, self._reports = self._reports, []
            return out


def set_context(ctx: Optional[TrainContext]) -> None:
    _ctx_local.ctx = ctx


def get_context() -> TrainContext:
    ctx = getattr(_ctx_local, "ctx", None)
    if ctx is None:
        raise RuntimeError(
            "ray_tpu_torch.train.get_context() called outside a train worker"
        )
    return ctx


def report(
    metrics: dict,
    checkpoint: Optional[Checkpoint] = None,
    sharded_state: Any = None,
    elastic_state: Any = None,
    elastic_layout: str = "replicated",
) -> None:
    """Report metrics (+ optional checkpoint) from the train loop
    (reference: ray.train.report). sharded_state= persists a state tree,
    each rank its own blocks; elastic_state=
    retains the step-boundary state in worker memory for elastic
    membership changes (see TrainContext.report)."""
    get_context().report(
        metrics,
        checkpoint,
        sharded_state=sharded_state,
        elastic_state=elastic_state,
        elastic_layout=elastic_layout,
    )


def get_checkpoint() -> Optional[Checkpoint]:
    return get_context().get_checkpoint()


def get_elastic_state() -> Optional[dict]:
    """The peer-hydrated step-boundary state after an elastic reshape
    (``{"state": <tree>, "index": <boundary report index>}``), or None.
    Elastic-capable train fns check this BEFORE get_checkpoint() on entry
    and continue from ``index + 1`` (see TrainContext.get_elastic_state)."""
    return get_context().get_elastic_state()


def get_dataset_shard(name: str = "train"):
    """This worker's shard of a dataset passed to the trainer via
    ``datasets=`` (reference: ray.train.get_dataset_shard): a
    :class:`~ray_tpu_torch.data.iterator.DataIterator`."""
    shards = getattr(get_context(), "dataset_shards", None)
    if not shards or name not in shards:
        raise KeyError(
            f"no dataset shard named {name!r}; pass datasets={{'{name}': ds}} "
            f"to the trainer"
        )
    return shards[name]
