"""Asyncio RPC fabric: every runtime process runs exactly one Endpoint.
Port of ``ray_tpu/core/protocol.py``.

Plays the role of the reference's gRPC layer + client pools (reference:
src/ray/rpc/, src/ray/core_worker_rpc_client/core_worker_client_pool.h) with
one simplification the TPU design allows: a single event-loop thread per
process carries *all* services that process hosts (GCS, node manager, core
worker), and connections are dialed on demand and cached by address.

Wire format: 4-byte big-endian length | body. A plain body is pickled
(msg_type, msg_id, reply_to, payload); a segmented body (scatter-gather data
plane, round-8) starts with the "RTS1" magic and carries the pickled
envelope plus its out-of-band buffers as contiguous segments. A request
carries msg_id; the reply echoes it in reply_to with type "$reply" (result)
or "$error" (pickled exception, re-raised caller-side).

Frame coalescing (PERF.md round-5: the driver core goes to one write() +
event-loop wakeup per frame, not to pickle): outgoing frames are appended to
a per-connection queue and flushed by a single loop callback that
concatenates every queued frame into ONE ``writer.write`` — so all frames
produced in one loop tick (a burst of requests, a wave of dispatch replies)
cost one syscall. ``drain()`` is awaited only above the transport's
high-water mark; below it the write buffer absorbs the bytes without a
second coroutine hop. ``rpc_coalesce_enabled=False`` restores the old
one-write-plus-drain-per-frame path.
"""

from __future__ import annotations

import asyncio
import logging
import pickle
import random
import struct
import threading
import time
import traceback
from typing import Any, Awaitable, Callable, Optional

from ray_tpu_torch.core import faults
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.core.errors import DeadlineExceededError, PeerUnavailableError
from ray_tpu_torch.util.tasks import spawn
from ray_tpu_torch.util.metrics import (
    LATENCY_BOUNDARIES_S,
    LocalHistogram,
    declare_runtime_metric,
)

Address = tuple  # (host: str, port: int)

_REPLY = "$reply"
_ERROR = "$error"

# StreamReader buffer limit. The asyncio default (64 KiB) pauses/resumes
# the transport ~128 times per 8 MiB frame — pure loop churn that dwarfs
# the copies the data plane saves. 8 MiB of read-ahead keeps a multi-MB
# frame's bytes flowing in big recv()s.
_STREAM_LIMIT = 8 * 1024 * 1024

# read() size must MATCH the limit: StreamReader.read(n) extracts n bytes
# and memmoves the rest of its buffer down, so chunked reads from a big
# read-ahead buffer go quadratic. Draining the whole buffer per wakeup is
# one copy, no shift.
_READ_CHUNK = _STREAM_LIMIT

# Segmented (scatter-gather) frame body marker. A plain frame body is a
# pickle stream and starts with b"\x80", so the magic is unambiguous.
# Body layout (little-endian):
#   "RTS1" | u32 nseg | u64 env_len | u64 seg_len * nseg | env | seg0 | ...
# where env is the pickled (msg_type, msg_id, reply_to, payload) tuple with
# its large buffers replaced by out-of-band opcodes, and the segments are
# those buffers in callback order.
_SEG_MAGIC = b"RTS1"

# Segments at least this large are handed to the transport as their own
# write (the kernel copies straight out of the source buffer when the
# socket keeps up); smaller ones are gathered into one joined write so tiny
# envelopes never pay a syscall each.
_GATHER_CUTOVER = 64 * 1024

# Cumulative per-connection transport counters (all plain ints: the hot path
# must not pay a lock or a metrics-registry lookup per frame). Aggregated
# across connections by Endpoint.transport_stats() and exported as gauges
# through the observability tier.
STAT_KEYS = (
    "frames_sent",  # frames handed to the transport
    "writes",  # writer.write() calls issued for those frames
    "max_frames_per_write",  # largest single coalesced write
    "drains",  # flushes that awaited writer.drain()
    "drains_skipped",  # flushes below the high-water mark (no drain)
    "frames_received",  # frames decoded from the read side
    "reads",  # read wakeups that produced bytes
    "segments_written",  # scatter-gather segments handed to the transport
    "oob_bytes",  # payload bytes sent out-of-band (never flattened)
)

# Gauge name -> (stat key, description) for the metrics tier.
TRANSPORT_METRICS = {
    "raytpu_rpc_frames_sent": ("frames_sent", "RPC frames handed to the transport"),
    "raytpu_rpc_writes": ("writes", "socket writes issued for those frames"),
    "raytpu_rpc_frames_per_write": (
        "frames_per_write",
        "mean frames coalesced into one socket write",
    ),
    "raytpu_rpc_drains_skipped": (
        "drains_skipped",
        "flushes below the transport high-water mark (drain skipped)",
    ),
    "raytpu_rpc_frames_received": (
        "frames_received",
        "RPC frames decoded from socket reads",
    ),
    "raytpu_rpc_segments_per_write": (
        "segments_per_write",
        "mean frame-encoder segments per socket write (join collapse "
        "factor)",
    ),
    "raytpu_oob_bytes_zero_copy_total": (
        "oob_bytes",
        "payload bytes shipped as out-of-band segments (no intermediate "
        "flatten on the send side)",
    ),
}


def transport_metric_snapshot(stats: dict, tags: dict) -> tuple[dict, list]:
    """(meta, points) for the metrics tier from an Endpoint's transport
    stats — cumulative totals, so they are exported as gauges (a counter
    kind would re-add the running total every report interval)."""
    meta = {
        name: {"kind": "gauge", "description": desc, "boundaries": []}
        for name, (_, desc) in TRANSPORT_METRICS.items()
    }
    points = [
        [name, tags, float(stats.get(key, 0.0))]
        for name, (key, _) in TRANSPORT_METRICS.items()
    ]
    return meta, points


# Per-RPC-method service instrumentation (SLO tier): server-side handler
# latency + error counts per msg_type, an in-flight gauge, and the
# event-loop-lag probe. All mutate loop-thread-local LocalHistograms /
# plain ints — no lock, no registry lookup on the frame path — and fold
# into snapshot points at report time, like the transport counters above.
_RPC_METRIC_META = {
    "raytpu_rpc_method_latency_seconds": declare_runtime_metric(
        "raytpu_rpc_method_latency_seconds",
        "histogram",
        "server-side RPC handler latency per method",
        tag_keys=("method",),
        boundaries=LATENCY_BOUNDARIES_S,
        layer="core",
    ),
    "raytpu_rpc_method_errors_total": declare_runtime_metric(
        "raytpu_rpc_method_errors_total",
        "counter",
        "RPC handler invocations that raised, per method",
        tag_keys=("method",),
        layer="core",
    ),
    "raytpu_rpc_inflight": declare_runtime_metric(
        "raytpu_rpc_inflight",
        "gauge",
        "RPC handler invocations currently executing on this endpoint",
        layer="core",
    ),
    "raytpu_event_loop_lag_seconds": declare_runtime_metric(
        "raytpu_event_loop_lag_seconds",
        "histogram",
        "event-loop scheduling lag (self-timed sleep overshoot)",
        boundaries=LATENCY_BOUNDARIES_S,
        layer="core",
    ),
    # RPC survival semantics (robustness round): retry / deadline / breaker
    # observability — the first series an operator checks when a fleet
    # starts limping from gray failures rather than clean crashes.
    "raytpu_rpc_retries_total": declare_runtime_metric(
        "raytpu_rpc_retries_total",
        "counter",
        "idempotent RPC attempts re-sent after a transport failure "
        "(jittered-exponential-backoff retry path)",
        layer="core",
    ),
    "raytpu_rpc_deadline_exceeded_total": declare_runtime_metric(
        "raytpu_rpc_deadline_exceeded_total",
        "counter",
        "RPC attempts that got no reply within their per-call deadline",
        layer="core",
    ),
    "raytpu_rpc_breaker_state": declare_runtime_metric(
        "raytpu_rpc_breaker_state",
        "gauge",
        "peers whose circuit breaker is currently tripped (open or "
        "half-open) on this endpoint; 0 = all peers healthy",
        layer="core",
    ),
}

# Register the round-6 transport gauges in the lint catalog too (they are
# built directly, not through the user API, so they don't self-register).
for _name, (_key, _desc) in TRANSPORT_METRICS.items():
    declare_runtime_metric(_name, "gauge", _desc, layer="core")


# -- RPC survival semantics (robustness round) --------------------------------
# Per-call deadlines: every acall/call is bounded so a hung or partitioned
# peer fails the call (DeadlineExceededError) instead of wedging the caller.
# Methods whose reply is the COMPLETION of arbitrarily long user work are
# exempt — a task push replies when the task finishes, an owner.get_object
# replies when the object exists — so their lifetime belongs to the task
# layer (worker death still surfaces as ConnectionLost), not to an RPC
# timer that would kill legitimate multi-hour work.
RPC_DEADLINE_EXEMPT = frozenset(
    {
        "worker.push_task",
        "worker.push_batch",
        "worker.rdt_arm",  # staging of arbitrarily large tensors
        "worker.rdt_fetch",
        "owner.get_object",
        "owner.wait_ready",
        "owner.stream_item",  # backpressure ack: held while consumer lags
        "gcs.wait_actor_alive",  # server enforces the payload timeout
        "gcs.wait_pg_ready",
        "node.pull_object",  # whole-object; per-chunk deadlines inside
    }
)
_HEARTBEAT_RPCS = frozenset({"gcs.node_heartbeat"})
_DATA_PLANE_RPCS = frozenset(
    {
        # Store-touching RPCs: chunk reads/copies + anything serialized
        # behind the store lock, which a multi-GB spill can hold for a
        # while. Generous but bounded.
        "node.fetch_object",
        "node.object_fingerprint",
        "node.object_created",
        "node.completions_batch",
        "node.restore_object",
        "node.free_object",
    }
)
_SLOW_RPCS = frozenset(
    {
        # Bounded by their own server-side timeouts (lease queueing up to
        # lease_request_timeout_s, worker spawn up to
        # worker_start_timeout_s) plus margin.
        "node.request_lease",
        "node.request_lease_batch",
        "node.start_actor",
        "gcs.create_actor",
        "gcs.create_placement_group",
    }
)

# Methods safe to retry automatically on TRANSPORT errors (connection loss,
# deadline): pure reads, heartbeats, and requests the server dedups
# (pull_object coalesces by oid). An explicit allowlist — never task or
# actor pushes, whose replay would double-execute user code.
IDEMPOTENT_RPCS = frozenset(
    {
        "gcs.node_heartbeat",
        "gcs.get_cluster_view",
        "gcs.get_session",
        "gcs.get_internal_config",
        "gcs.kv_get",
        "gcs.kv_keys",
        "gcs.get_actor",
        "gcs.get_placement_group",
        "gcs.list_actors",
        "gcs.list_placement_groups",
        "gcs.list_task_events",
        "gcs.get_autoscaler_state",
        # Drain protocol: all server-side idempotent (drain_complete /
        # mark-dead dedup on node state; report_migrations is a set
        # insert; migrated_location is a pure read; restart_node_actors
        # only moves actors still recorded on the draining node) and a
        # drain racing a flaky transport MUST retry — the whole point is
        # beating the preemption deadline.
        "gcs.drain_node",  # double-drain reports the in-progress drain
        "gcs.drain_complete",
        "gcs.report_migrations",
        "gcs.migrated_location",
        "gcs.restart_node_actors",
        "node.drain",
        "node.request_lease",
        "node.fetch_object",
        "node.restore_object",
        "node.object_fingerprint",
        "node.get_info",
        "node.list_objects",
        "owner.get_object",
        "owner.wait_ready",
        "worker.ping",
        "worker.flightrec",  # pure read of the in-process rings
    }
)


def method_deadline_s(msg_type: str) -> float:
    """Resolve the per-call deadline for an RPC method (0 = unbounded)."""
    cfg = GLOBAL_CONFIG
    if cfg.rpc_deadline_s <= 0 or msg_type in RPC_DEADLINE_EXEMPT:
        return 0.0
    if msg_type in _HEARTBEAT_RPCS:
        return cfg.rpc_heartbeat_deadline_s
    if msg_type in _DATA_PLANE_RPCS:
        return cfg.rpc_data_deadline_s
    if msg_type in _SLOW_RPCS:
        return cfg.rpc_slow_deadline_s
    return cfg.rpc_deadline_s


class _Breaker:
    """Per-peer circuit breaker. closed -> (threshold consecutive transport
    failures) -> open: calls fail fast with PeerUnavailableError instead of
    each burning a deadline. After the reset interval one caller is let
    through as the half-open probe; its outcome closes or re-opens."""

    __slots__ = ("state", "failures", "opened_at", "touched")
    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self):
        self.state = self.CLOSED
        self.failures = 0
        self.opened_at = 0.0
        self.touched = 0.0  # last caller interest; stale entries are swept

    def allow(self, now: float, reset_s: float) -> bool:
        self.touched = now
        if self.state == self.CLOSED:
            return True
        if now - self.opened_at >= reset_s:
            # OPEN past the reset window: this caller becomes the probe.
            # HALF_OPEN past the window: the previous probe has been in
            # flight longer than a whole reset interval (a deadline-exempt
            # RPC can legitimately run for minutes) — let another caller
            # probe rather than wedging every call behind it.
            self.state = self.HALF_OPEN
            self.opened_at = now
            return True
        return False  # inside the window (open, or a probe in flight)

    def suspect(self, now: float, reset_s: float) -> bool:
        """True while schedulers should avoid placing work on the peer:
        tripped and not yet eligible for (or mid-) half-open probing."""
        return self.state != self.CLOSED and now - self.opened_at < reset_s

    def release(self) -> None:
        """A HALF_OPEN probe ended without a transport verdict (cancelled,
        or failed before reaching the wire): return to OPEN with the
        reset window already expired, so the very next caller may probe
        again — never leave the breaker wedged in HALF_OPEN, and never
        charge a full extra window for a probe that proved nothing."""
        if self.state == self.HALF_OPEN:
            self.state = self.OPEN
            self.opened_at = float("-inf")

    def failure(self, now: float, threshold: int) -> None:
        self.touched = now
        self.failures += 1
        if self.state == self.HALF_OPEN or self.failures >= max(1, threshold):
            self.state = self.OPEN
            self.opened_at = now


# Actions the transport seams can apply (see faults.py).
_SEND_FAULTS = frozenset({"drop", "delay", "dup", "sever"})
_RECV_FAULTS = frozenset({"drop", "delay", "dup"})


class RpcError(Exception):
    pass


class ConnectionLost(RpcError):
    pass


class RemoteError(RpcError):
    """Wraps a traceback string when the remote exception can't be unpickled."""


class Connection:
    """One framed, multiplexed duplex channel."""

    def __init__(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        handler: Callable[["Connection", str, Any], Awaitable[Any]],
        on_close: Optional[Callable[["Connection"], None]] = None,
    ):
        self.reader = reader
        self.writer = writer
        self.handler = handler
        self.on_close = on_close
        self._next_id = 1
        self._pending: dict[int, asyncio.Future] = {}
        self._closed = False
        self._send_lock = asyncio.Lock()  # legacy (kill-switch) path only
        self._loop = asyncio.get_running_loop()
        # Coalescing state: frames queued for the next flush callback.
        # Each entry is one frame as a list of segments (a plain frame is
        # a single-segment list; a scatter-gather frame is
        # [prefix+header+envelope, buffer_view, ...]).
        self._send_buf: list[list] = []
        self._flush_scheduled = False
        # Set while the transport is below its high-water mark; cleared when
        # a flush overruns it, re-set by the drain task — senders await it,
        # which is the backpressure the old per-frame drain() provided.
        self._drained = asyncio.Event()
        self._drained.set()
        self._drain_task: asyncio.Future | None = None
        self.stats = dict.fromkeys(STAT_KEYS, 0)
        self.peer: Any = None  # set by servers after registration
        # "host:port" of the DIALED address for outbound connections (set
        # by Endpoint.connect); "" for inbound. Fault rules match on it.
        self.peer_label: str = ""
        self._reader_task = asyncio.ensure_future(self._read_loop())

    def _encode_frame(self, msg_type, msg_id, reply_to, payload) -> list:
        """Encode one frame as a list of wire segments.

        With scatter-gather on, large buffers reached during pickling
        (FramedPayload values, raw numpy arrays) are taken out-of-band and
        returned as their own segments — the payload bytes are never
        flattened into an intermediate ``bytes``. Off (or when nothing is
        large enough), the frame is one plain pickled segment."""
        tup = (msg_type, msg_id, reply_to, payload)
        if GLOBAL_CONFIG.rpc_scatter_gather_enabled:
            oob: list = []
            threshold = max(1, GLOBAL_CONFIG.oob_min_buffer_bytes)

            def cb(pb: pickle.PickleBuffer) -> bool:
                try:
                    raw = pb.raw()
                except BufferError:
                    return True  # non-contiguous: keep in-band
                if raw.nbytes < threshold:
                    return True
                oob.append(raw)
                return False

            env = pickle.dumps(tup, protocol=5, buffer_callback=cb)
            if oob:
                lens = [m.nbytes for m in oob]
                head = struct.pack(
                    f"<4sIQ{len(oob)}Q", _SEG_MAGIC, len(oob), len(env), *lens
                )
                total = len(head) + len(env) + sum(lens)
                return [total.to_bytes(4, "big") + head + env, *oob]
        else:
            env = pickle.dumps(tup, protocol=5)
        return [len(env).to_bytes(4, "big") + env]

    async def _send(self, msg_type: str, msg_id, reply_to, payload) -> None:
        dup = False
        if faults._ACTIVE is not None:
            rule = faults._ACTIVE.decide(
                "send", msg_type, self.peer_label, _SEND_FAULTS
            )
            if rule is not None:
                if rule.action == "sever":
                    self._teardown()
                    raise ConnectionLost(
                        f"fault-injected sever (sending {msg_type})"
                    )
                if rule.action == "drop" or (
                    rule.action == "delay" and rule.delay_s == faults.INF
                ):
                    return  # blackhole: the frame silently vanishes
                if rule.action == "delay":
                    # NB: deliberately breaks same-tick FIFO framing — a
                    # delayed peer reorders against later frames, which is
                    # exactly the gray failure under test.
                    await asyncio.sleep(rule.delay_s)
                elif rule.action == "dup":
                    dup = True
        frame = self._encode_frame(msg_type, msg_id, reply_to, payload)
        if not GLOBAL_CONFIG.rpc_coalesce_enabled:
            async with self._send_lock:
                if self._closed:
                    raise ConnectionLost(
                        f"connection closed (sending {msg_type})"
                    )
                # The knob can flip at runtime (kill-switch tests/tools):
                # frames still queued for the coalesced flush must hit the
                # wire BEFORE this direct write, or wire order diverges
                # from send order (actor seq dispatch relies on it).
                while self._send_buf:
                    self._flush()
                # Legacy one-write-per-frame path: segments join here (the
                # A/B baseline arm is deliberately copy-heavy).
                self.writer.write(
                    frame[0] if len(frame) == 1 else b"".join(frame)
                )
                if dup:  # fault-injected duplicate delivery
                    self.writer.write(
                        frame[0] if len(frame) == 1 else b"".join(frame)
                    )
                st = self.stats
                st["frames_sent"] += 1
                st["writes"] += 1
                st["segments_written"] += len(frame)
                if st["max_frames_per_write"] < 1:
                    st["max_frames_per_write"] = 1
                st["drains"] += 1
                await self.writer.drain()
            return
        if self._closed:
            raise ConnectionLost(f"connection closed (sending {msg_type})")
        self._send_buf.append(frame)
        if dup:  # fault-injected duplicate delivery
            self._send_buf.append(frame)
        if not self._flush_scheduled:
            # call_soon lands AFTER every callback already in this loop
            # tick's ready queue — so all frames produced by the tick
            # (concurrent requests, a wave of dispatch replies) are queued
            # before the flush concatenates them into one write.
            self._flush_scheduled = True
            self._loop.call_soon(self._flush)
        if not self._drained.is_set():
            await self._drained.wait()
            if self._closed:
                raise ConnectionLost(
                    f"connection lost (sending {msg_type})"
                )

    def _flush(self) -> None:
        """Flush callback: drain everything queued this tick to the
        transport, bounded by the byte/frame caps (the remainder reflushes
        next tick). Byte caps count SEGMENT bytes — an out-of-band numpy
        buffer weighs its full size even though it was never flattened."""
        self._flush_scheduled = False
        if self._closed:
            self._send_buf.clear()
            return
        buf = self._send_buf
        if not buf:
            return
        max_frames = max(1, GLOBAL_CONFIG.rpc_coalesce_max_frames)
        max_bytes = max(1, GLOBAL_CONFIG.rpc_coalesce_max_bytes)
        n, size = 0, 0
        while n < len(buf) and n < max_frames:
            size += sum(len(s) for s in buf[n])
            n += 1
            if size >= max_bytes:
                break
        segs = [s for frame in buf[:n] for s in frame]
        del buf[:n]
        try:
            writes = self._write_segments(segs)
        except Exception:
            self._teardown()
            return
        st = self.stats
        st["frames_sent"] += n
        if writes == 1 and n > st["max_frames_per_write"]:
            st["max_frames_per_write"] = n
        elif st["max_frames_per_write"] < 1:
            st["max_frames_per_write"] = 1
        if buf and not self._flush_scheduled:
            self._flush_scheduled = True
            self._loop.call_soon(self._flush)
        self._maybe_drain()

    def _write_segments(self, segs: list) -> int:
        """Emit segments to the transport. Small segments gather into one
        joined write; large ones (>= _GATHER_CUTOVER) go out as their own
        write so the transport sends straight from the source buffer —
        the writev-style scatter output of the round-8 tier. Returns the
        number of writes issued."""
        st = self.stats
        st["segments_written"] += len(segs)
        if len(segs) == 1:
            self.writer.write(segs[0])
            st["writes"] += 1
            return 1
        writes = 0
        small: list = []
        for s in segs:
            if len(s) >= _GATHER_CUTOVER:
                if small:
                    self.writer.write(
                        small[0] if len(small) == 1 else b"".join(small)
                    )
                    writes += 1
                    small = []
                self.writer.write(s)
                writes += 1
                # Counted HERE, not at encode: only a segment written
                # unjoined actually reached the socket with no
                # intermediate flatten (the legacy/kill-switch paths join,
                # and must read 0).
                st["oob_bytes"] += len(s)
            else:
                small.append(s)
        if small:
            self.writer.write(
                small[0] if len(small) == 1 else b"".join(small)
            )
            writes += 1
        st["writes"] += writes
        return writes

    def _maybe_drain(self) -> None:
        """Drain only above the transport high-water mark: below it the
        write buffer absorbs the frames and a drain() await would be a pure
        event-loop tax (the round-5 probe's dominant cost)."""
        try:
            transport = self.writer.transport
            size = transport.get_write_buffer_size()
            high = transport.get_write_buffer_limits()[1]
        except Exception:  # raylint: disable=RL006 -- transport introspection varies by loop impl; defaults skip the drain wait
            size, high = 0, 1
        if size <= high:
            self.stats["drains_skipped"] += 1
            return
        if self._drain_task is None:
            self.stats["drains"] += 1
            self._drained.clear()
            self._drain_task = asyncio.ensure_future(self._drain())

    async def _drain(self) -> None:
        try:
            await self.writer.drain()
        except Exception:
            self._teardown()
        finally:
            self._drain_task = None
            self._drained.set()

    async def request(
        self, msg_type: str, payload: Any = None, timeout: float | None = None
    ) -> Any:
        if self._closed:
            raise ConnectionLost(f"connection closed (sending {msg_type})")
        msg_id = self._next_id
        self._next_id += 1
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[msg_id] = fut
        try:
            await self._send(msg_type, msg_id, None, payload)
        except BaseException:
            # The send failed (teardown raced the queue): the caller gets
            # THIS error; consume the future so its teardown-set exception
            # is never reported as unretrieved.
            self._pending.pop(msg_id, None)
            if fut.done() and not fut.cancelled():
                fut.exception()
            raise
        if not timeout or timeout <= 0:
            return await fut
        # Deadline via call_later, not wait_for: no extra task per request
        # (the hot path must not pay a wrapper coroutine for a timer that
        # almost never fires).
        handle = self._loop.call_later(
            timeout, self._expire_request, msg_id, msg_type, timeout
        )
        try:
            return await fut
        finally:
            handle.cancel()

    def _expire_request(self, msg_id, msg_type: str, timeout: float) -> None:
        fut = self._pending.pop(msg_id, None)
        if fut is not None and not fut.done():
            fut.set_exception(
                DeadlineExceededError(
                    f"{msg_type} got no reply within its {timeout:g}s "
                    f"deadline (peer {self.peer_label or 'inbound'})"
                )
            )

    async def notify(self, msg_type: str, payload: Any = None) -> None:
        if self._closed:
            raise ConnectionLost(f"connection closed (sending {msg_type})")
        await self._send(msg_type, None, None, payload)

    async def _read_loop(self) -> None:
        # One read() wakeup decodes EVERY complete frame it delivered
        # before yielding back to the loop (the readexactly-per-frame shape
        # paid a coroutine hop per 4-byte header even when the bytes were
        # already buffered).
        buf = bytearray()
        try:
            while True:
                chunk = await self.reader.read(_READ_CHUNK)
                if not chunk:
                    break  # EOF
                self.stats["reads"] += 1
                if buf:
                    buf += chunk
                    data = buf
                else:
                    # No partial frame pending: decode straight from the
                    # read's own bytes — skips re-buffering a whole multi-MB
                    # frame through the accumulator.
                    data = chunk
                off, end = 0, len(data)
                mv = memoryview(data) if data is chunk else None
                while end - off >= 4:
                    length = int.from_bytes(data[off : off + 4], "big")
                    if end - off - 4 < length:
                        break  # partial frame: wait for more bytes
                    # Slicing yields a standalone WRITABLE per-frame copy —
                    # the ONE receive-side copy (decoded numpy values view
                    # it, and views must be mutable like any unpickled
                    # array). Decoded out-of-band buffers alias the slice,
                    # so the accumulator bookkeeping below never
                    # invalidates them.
                    if mv is None:
                        body = data[off + 4 : off + 4 + length]
                    else:
                        body = bytearray(mv[off + 4 : off + 4 + length])
                    frame = self._decode_body(body)
                    off += 4 + length
                    self.stats["frames_received"] += 1
                    self._handle_frame(*frame)
                if data is buf:
                    if off:
                        del buf[:off]
                elif off < end:
                    buf += memoryview(chunk)[off:]  # stash the partial tail
        except (
            asyncio.IncompleteReadError,
            ConnectionError,
            asyncio.CancelledError,
        ):
            pass
        finally:
            self._teardown()

    @staticmethod
    def _decode_body(body: bytearray):
        """Decode one frame body: either a plain pickle stream or a
        segmented scatter-gather layout. Segmented buffers are handed to
        the unpickler as writable memoryviews of the frame's own storage
        (no per-segment copy); the consumers that persist them
        (serialization.loads, the object stores) make the one final copy
        into their destination."""
        if len(body) >= 4 and body[:4] == _SEG_MAGIC:
            nseg, env_len = struct.unpack_from("<IQ", body, 4)
            lens = struct.unpack_from(f"<{nseg}Q", body, 16)
            mv = memoryview(body)
            off = 16 + 8 * nseg
            env = mv[off : off + env_len]
            off += env_len
            buffers = []
            for ln in lens:
                buffers.append(mv[off : off + ln])
                off += ln
            return pickle.loads(env, buffers=buffers)
        return pickle.loads(body)

    def _handle_frame(self, msg_type, msg_id, reply_to, payload) -> None:
        if faults._ACTIVE is not None:
            rule = faults._ACTIVE.decide(
                "recv", msg_type, self.peer_label, _RECV_FAULTS
            )
            if rule is not None:
                if rule.action == "drop" or (
                    rule.action == "delay" and rule.delay_s == faults.INF
                ):
                    return  # frame lost on the receive side
                if rule.action == "delay":
                    self._loop.call_later(
                        rule.delay_s,
                        self._deliver_frame,
                        msg_type,
                        msg_id,
                        reply_to,
                        payload,
                    )
                    return
                if rule.action == "dup":
                    self._deliver_frame(msg_type, msg_id, reply_to, payload)
        self._deliver_frame(msg_type, msg_id, reply_to, payload)

    def _deliver_frame(self, msg_type, msg_id, reply_to, payload) -> None:
        if msg_type == _REPLY:
            fut = self._pending.pop(reply_to, None)
            if fut is not None and not fut.done():
                fut.set_result(payload)
        elif msg_type == _ERROR:
            fut = self._pending.pop(reply_to, None)
            if fut is not None and not fut.done():
                exc = payload
                if isinstance(exc, str):
                    exc = RemoteError(exc)
                try:
                    # Mark application-level errors so the retry/breaker
                    # layer never mistakes a remote OSError/TimeoutError
                    # for a transport failure of THIS hop.
                    exc._raytpu_remote = True
                except Exception:  # raylint: disable=RL006 -- exc may be immutable (e.g. tuple-backed); marking is best-effort
                    pass
                fut.set_exception(exc)
        else:
            spawn(
                self._dispatch(msg_type, msg_id, payload), name="rpc dispatch"
            )

    async def _dispatch(self, msg_type: str, msg_id, payload) -> None:
        try:
            result = await self.handler(self, msg_type, payload)
            if msg_id is not None:
                await self._send(_REPLY, None, msg_id, result)
        except Exception as e:  # noqa: BLE001 — must propagate to caller
            if msg_id is not None:
                try:
                    await self._send(_ERROR, None, msg_id, e)
                except Exception:
                    tb = traceback.format_exc()
                    try:
                        await self._send(_ERROR, None, msg_id, tb)
                    except Exception as e2:
                        # Peer unreachable: its pending call surfaces as
                        # ConnectionLost; the original error is only lost
                        # from the WIRE, so keep a local trace of it.
                        logging.getLogger("ray_tpu_torch.rpc").debug(
                            "error reply for %s dropped (%s); original: %s",
                            msg_type,
                            e2,
                            tb,
                        )

    def _teardown(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._send_buf.clear()
        self._drained.set()  # wake senders blocked on backpressure
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(ConnectionLost("connection lost"))
        self._pending.clear()
        try:
            self.writer.close()
        except Exception:  # raylint: disable=RL006 -- writer close on an already-broken transport
            pass
        if self.on_close is not None:
            self.on_close(self)

    def close(self) -> None:
        self._teardown()
        if self._reader_task is not None:
            self._reader_task.cancel()

    @property
    def closed(self) -> bool:
        return self._closed


class Endpoint:
    """Per-process RPC endpoint: one server socket + cached outbound conns.

    Handlers: {msg_type: async fn(conn, payload) -> reply}. The same handler
    table serves inbound server connections and inbound messages on outbound
    connections (full duplex — an owner can receive requests on a connection
    it dialed).
    """

    def __init__(self, name: str = "endpoint"):
        self.name = name
        self.handlers: dict[str, Callable] = {}
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._server: asyncio.AbstractServer | None = None
        self._conns: dict[Address, Connection] = {}
        self._conn_locks: dict[Address, asyncio.Lock] = {}
        # Every live connection (inbound + outbound) for transport-stat
        # aggregation; closed connections fold into the totals. The lock
        # makes fold-on-close atomic w.r.t. off-loop readers, so the
        # cumulative counters never transiently go backward (a conn must
        # be counted from exactly one of the two sources).
        self._live_conns: set[Connection] = set()
        self._transport_totals = dict.fromkeys(STAT_KEYS, 0)
        self._stats_lock = threading.Lock()
        # Per-method service stats: mutated only on the endpoint loop
        # (LocalHistogram is lock-free by design); folded into snapshot
        # points by rpc_metric_snapshot().
        self._method_hists: dict[str, LocalHistogram] = {}
        self._method_errors: dict[str, int] = {}
        self._inflight = 0
        self._loop_lag = LocalHistogram(LATENCY_BOUNDARIES_S)
        # RPC survival state: per-peer circuit breakers plus retry/deadline
        # counters (plain ints — mutated on the endpoint loop, folded into
        # rpc_metric_snapshot like the rest of the service stats).
        self._breakers: dict[Address, _Breaker] = {}
        self._rpc_retries = 0
        self._rpc_deadline_exceeded = 0
        self.address: Address | None = None
        self._started = threading.Event()
        self.on_connection_lost: Optional[Callable[[Connection], None]] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self, host: str | None = None, port: int = 0) -> Address:
        """Bind and serve. ``host=None`` uses $RAY_TPU_BIND_HOST (default
        127.0.0.1). Binding a wildcard address advertises
        $RAY_TPU_ADVERTISE_HOST (or this host's resolved IP) instead, since
        a wildcard is not dialable by peers."""
        import os

        if host is None:
            host = os.environ.get("RAY_TPU_BIND_HOST", "127.0.0.1")
        self._thread = threading.Thread(
            target=self._run_loop, args=(host, port), name=f"rpc-{self.name}",
            daemon=True,
        )
        self._thread.start()
        if not self._started.wait(
            timeout=GLOBAL_CONFIG.endpoint_start_timeout_s
        ):
            raise RpcError(f"endpoint {self.name} failed to start")
        assert self.address is not None
        return self.address

    @staticmethod
    def _advertise_host(bind_host: str) -> str:
        import os
        import socket

        if bind_host not in ("0.0.0.0", "::"):
            return bind_host
        adv = os.environ.get("RAY_TPU_ADVERTISE_HOST")
        if adv:
            return adv
        try:
            return socket.gethostbyname(socket.gethostname())
        except OSError:
            return "127.0.0.1"

    def _run_loop(self, host: str, port: int) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)

        async def boot():
            self._server = await asyncio.start_server(
                self._accept, host=host, port=port, limit=_STREAM_LIMIT
            )
            sock = self._server.sockets[0]
            bound_port = sock.getsockname()[1]
            self.address = (self._advertise_host(host), bound_port)
            if (
                GLOBAL_CONFIG.metrics_enabled
                and GLOBAL_CONFIG.loop_lag_probe_interval_s > 0
            ):
                spawn(self._lag_probe_loop(), name="loop lag probe")
            self._started.set()

        self._loop.run_until_complete(boot())
        try:
            self._loop.run_forever()
        finally:
            self._loop.close()

    def stop(self) -> None:
        if self._loop is None or self._loop.is_closed():
            return

        async def shutdown():
            for conn in list(self._conns.values()):
                conn.close()
            if self._server is not None:
                self._server.close()
            tasks = [
                t
                for t in asyncio.all_tasks()
                if t is not asyncio.current_task()
            ]
            for t in tasks:
                t.cancel()
            try:
                await asyncio.wait_for(
                    asyncio.gather(*tasks, return_exceptions=True), timeout=2
                )
            except asyncio.TimeoutError:
                pass

        # NB: the loop must be stopped from OUTSIDE the coroutine. Calling
        # loop.stop() as the coroutine's last statement kills the loop before
        # run_coroutine_threadsafe's done-callback delivers the result, so
        # .result() always burned its full timeout (3 endpoints x 5 s = the
        # deterministic 15 s teardown every test module used to pay).
        try:
            asyncio.run_coroutine_threadsafe(shutdown(), self._loop).result(
                timeout=5
            )
        except Exception:  # raylint: disable=RL006 -- best-effort goodbye to the peer; socket teardown follows regardless
            pass
        try:
            self._loop.call_soon_threadsafe(self._loop.stop)
        except RuntimeError:
            pass  # loop already closed
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=5)

    # -- serving -------------------------------------------------------------

    async def _accept(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        conn = Connection(
            reader, writer, self._handle, on_close=self._conn_closed
        )
        with self._stats_lock:
            self._live_conns.add(conn)

    def _conn_closed(self, conn: Connection) -> None:
        with self._stats_lock:
            if conn in self._live_conns:
                self._live_conns.discard(conn)
                self._fold_stats(self._transport_totals, conn.stats)
        for addr, c in list(self._conns.items()):
            if c is conn:
                del self._conns[addr]
        if self.on_connection_lost is not None:
            self.on_connection_lost(conn)

    @staticmethod
    def _fold_stats(acc: dict, stats: dict) -> None:
        for k, v in stats.items():
            if k == "max_frames_per_write":
                acc[k] = max(acc.get(k, 0), v)
            else:
                acc[k] = acc.get(k, 0) + v

    def transport_stats(self) -> dict:
        """Cumulative transport counters over every connection this
        endpoint ever carried (live + closed), plus the derived
        frames_per_write ratio — the strace-free view of how many frames
        each syscall amortizes."""
        with self._stats_lock:
            out = dict(self._transport_totals)
            for conn in list(self._live_conns):
                self._fold_stats(out, conn.stats)
        out["frames_per_write"] = (
            out["frames_sent"] / out["writes"] if out["writes"] else 0.0
        )
        out["segments_per_write"] = (
            out["segments_written"] / out["writes"] if out["writes"] else 0.0
        )
        return out

    def connection_stats(self, addr: Address) -> dict | None:
        """Live counters of the cached outbound connection to ``addr``
        (e.g. the driver->node hop), or None when not connected."""
        conn = self._conns.get(tuple(addr))
        return dict(conn.stats) if conn is not None else None

    async def _lag_probe_loop(self) -> None:
        """Event-loop-lag probe: a sleep's overshoot is pure scheduling lag
        — the first symptom of a saturated loop (missed heartbeats, stalled
        flush callbacks) and the metric an operator checks before blaming
        the network."""
        loop = asyncio.get_running_loop()
        while True:
            interval = GLOBAL_CONFIG.loop_lag_probe_interval_s
            if interval <= 0:
                return
            t0 = loop.time()
            await asyncio.sleep(interval)
            self._loop_lag.observe(max(0.0, loop.time() - t0 - interval))

    def rpc_metric_snapshot(self, tags: dict) -> tuple[dict, list]:
        """(meta, points) of this endpoint's per-method service stats for
        the metrics tier. Histograms/counters are cumulative per process;
        each report replaces the process's previous snapshot upstream, so
        cross-process merging keeps Prometheus semantics."""
        points: list = [
            ["raytpu_rpc_inflight", dict(tags), float(self._inflight)],
            [
                "raytpu_rpc_retries_total",
                dict(tags),
                float(self._rpc_retries),
            ],
            [
                "raytpu_rpc_deadline_exceeded_total",
                dict(tags),
                float(self._rpc_deadline_exceeded),
            ],
            [
                "raytpu_rpc_breaker_state",
                dict(tags),
                float(self.tripped_breakers()),
            ],
        ]
        for method, h in list(self._method_hists.items()):
            points.append(
                [
                    "raytpu_rpc_method_latency_seconds",
                    {**tags, "method": method},
                    h.as_value(),
                ]
            )
        for method, n in list(self._method_errors.items()):
            points.append(
                [
                    "raytpu_rpc_method_errors_total",
                    {**tags, "method": method},
                    float(n),
                ]
            )
        if self._loop_lag.count:
            points.append(
                [
                    "raytpu_event_loop_lag_seconds",
                    dict(tags),
                    self._loop_lag.as_value(),
                ]
            )
        return dict(_RPC_METRIC_META), points

    def service_metric_snapshot(self, tags: dict) -> tuple[dict, list]:
        """THE combined per-process endpoint telemetry: per-method service
        stats + transport coalescing counters, assembled once here so
        worker/node/GCS reporters can't drift apart series-wise."""
        meta, points = self.rpc_metric_snapshot(tags)
        tmeta, tpoints = transport_metric_snapshot(
            self.transport_stats(), tags
        )
        meta.update(tmeta)
        points.extend(tpoints)
        return meta, points

    async def _handle(self, conn: Connection, msg_type: str, payload: Any):
        handler = self.handlers.get(msg_type)
        if handler is None:
            raise RpcError(f"{self.name}: no handler for {msg_type!r}")
        if not GLOBAL_CONFIG.metrics_enabled:
            return await handler(conn, payload)
        t0 = time.perf_counter()
        self._inflight += 1
        try:
            return await handler(conn, payload)
        except Exception:
            self._method_errors[msg_type] = (
                self._method_errors.get(msg_type, 0) + 1
            )
            raise
        finally:
            self._inflight -= 1
            h = self._method_hists.get(msg_type)
            if h is None:
                h = self._method_hists[msg_type] = LocalHistogram(
                    LATENCY_BOUNDARIES_S
                )
            h.observe(time.perf_counter() - t0)

    def register(self, msg_type: str, handler: Callable) -> None:
        self.handlers[msg_type] = handler

    # -- dialing -------------------------------------------------------------

    async def connect(self, addr: Address) -> Connection:
        addr = tuple(addr)
        conn = self._conns.get(addr)
        if conn is not None and not conn.closed:
            return conn
        lock = self._conn_locks.setdefault(addr, asyncio.Lock())
        async with lock:
            conn = self._conns.get(addr)
            if conn is not None and not conn.closed:
                return conn
            reader, writer = await asyncio.open_connection(
                addr[0], addr[1], limit=_STREAM_LIMIT
            )
            conn = Connection(
                reader, writer, self._handle, on_close=self._conn_closed
            )
            conn.peer_label = f"{addr[0]}:{addr[1]}"
            with self._stats_lock:
                self._live_conns.add(conn)
            self._conns[addr] = conn
            return conn

    # -- survival semantics ---------------------------------------------------

    def peer_suspect(self, addr) -> bool:
        """True while schedulers should stop placing work on this peer:
        its circuit breaker is tripped and not yet probing half-open.
        Self-healing by construction — once the reset interval elapses the
        peer stops reading as suspect, the next call through acts as the
        probe, and its outcome closes or re-trips the breaker."""
        br = self._breakers.get(tuple(addr))
        if br is None:
            return False
        return br.suspect(time.monotonic(), GLOBAL_CONFIG.rpc_breaker_reset_s)

    # Entries untouched for this many reset windows are swept: success
    # evicts (below), but a churned ephemeral peer (reaped worker, removed
    # node) is never dialed again, so without a sweep its breaker — and an
    # OPEN verdict in the tripped gauge, and the `_breakers` truthiness
    # fast path in SuspectStamper — would leak for the life of the process.
    _BREAKER_STALE_WINDOWS = 8

    def _sweep_breakers(self, now: float) -> None:
        stale = GLOBAL_CONFIG.rpc_breaker_reset_s * self._BREAKER_STALE_WINDOWS
        dead = [
            a for a, b in self._breakers.items() if now - b.touched > stale
        ]
        for a in dead:
            del self._breakers[a]

    def tripped_breakers(self) -> int:
        # Metrics path: called once per report interval, so it doubles as
        # the periodic sweep for processes with no new failures.
        self._sweep_breakers(time.monotonic())
        return sum(
            1 for b in self._breakers.values() if b.state != _Breaker.CLOSED
        )

    def record_peer_failure(self, addr) -> None:
        """Count one transport failure toward the peer's breaker (public:
        the task layer reports conn losses it observes out-of-band)."""
        now = time.monotonic()
        self._sweep_breakers(now)
        br = self._breakers.setdefault(tuple(addr), _Breaker())
        br.failure(now, GLOBAL_CONFIG.rpc_breaker_threshold)

    def _record_peer_success(self, addr) -> None:
        # Evict rather than reset: healthy peers carry no entry at all, so
        # _breakers is sized by peers CURRENTLY failing (not every address
        # that ever blipped over a multi-week run) and the
        # `if endpoint._breakers` fast-path gates in gcs/node re-arm once
        # the cluster heals.
        self._breakers.pop(addr, None)

    async def acall(
        self,
        addr: Address,
        msg_type: str,
        payload: Any = None,
        *,
        deadline_s: float | None = None,
        retries: int | None = None,
    ):
        """One RPC with survival semantics: per-call deadline (resolved
        from the method class unless overridden), automatic jittered
        exponential-backoff retry on TRANSPORT errors for allowlisted
        idempotent methods, and a per-peer circuit breaker that fails fast
        once the peer looks down. Application exceptions pass through
        untouched and are never retried."""
        addr = tuple(addr)
        cfg = GLOBAL_CONFIG
        if deadline_s is None:
            deadline_s = method_deadline_s(msg_type)
        if retries is None:
            retries = cfg.rpc_max_retries if msg_type in IDEMPOTENT_RPCS else 0
        attempt = 0
        while True:
            br = self._breakers.get(addr)
            if br is not None and not br.allow(
                time.monotonic(), cfg.rpc_breaker_reset_s
            ):
                raise PeerUnavailableError(
                    f"peer {addr[0]}:{addr[1]} circuit breaker is open for "
                    f"{msg_type} ({br.failures} consecutive transport "
                    f"failures; half-opens {cfg.rpc_breaker_reset_s:g}s "
                    f"after the trip)"
                )
            try:
                conn = self._conns.get(addr)
                if conn is None or conn.closed:
                    conn = await asyncio.wait_for(
                        self.connect(addr), cfg.rpc_connect_timeout_s
                    )
                result = await conn.request(
                    msg_type, payload, timeout=deadline_s
                )
            except (
                ConnectionLost,
                ConnectionError,
                OSError,
                asyncio.TimeoutError,
            ) as e:
                if getattr(e, "_raytpu_remote", False):
                    # The remote HANDLER raised this — a reply arrived, so
                    # the transport works: an app error must close (not
                    # wedge) a half-open probe, and never count as a
                    # transport failure.
                    self._record_peer_success(addr)
                    raise
                if isinstance(e, DeadlineExceededError):
                    self._rpc_deadline_exceeded += 1
                elif isinstance(e, asyncio.TimeoutError) and not isinstance(
                    e, ConnectionError
                ):
                    # wait_for on the dial itself
                    self._rpc_deadline_exceeded += 1
                    e = DeadlineExceededError(
                        f"connecting to {addr[0]}:{addr[1]} for {msg_type} "
                        f"exceeded {cfg.rpc_connect_timeout_s:g}s"
                    )
                self.record_peer_failure(addr)
                if attempt >= retries:
                    raise e
                attempt += 1
                self._rpc_retries += 1
                backoff = min(
                    cfg.rpc_retry_backoff_s * (2 ** (attempt - 1)),
                    cfg.rpc_retry_backoff_max_s,
                )
                # Full jitter keeps a gang of retriers from re-synchronizing
                # into the very burst that tripped the peer.
                await asyncio.sleep(backoff * (0.5 + random.random() * 0.5))
            except BaseException as e:
                # Application error or cancellation reached us outside the
                # transport tuple. A reply-borne error proves the transport
                # works (close any half-open probe); anything else carries
                # no transport verdict — release a HALF_OPEN probe so the
                # breaker can never wedge in that state.
                if getattr(e, "_raytpu_remote", False):
                    self._record_peer_success(addr)
                else:
                    br = self._breakers.get(addr)
                    if br is not None:
                        br.release()
                raise
            else:
                self._record_peer_success(addr)
                return result

    async def anotify(self, addr: Address, msg_type: str, payload: Any = None):
        conn = await self.connect(addr)
        await conn.notify(msg_type, payload)

    # -- sync facade (for non-loop threads) ----------------------------------

    def call(
        self, addr: Address, msg_type: str, payload: Any = None,
        timeout: float | None = None,
    ) -> Any:
        """Sync facade. An EXPLICIT ``timeout`` is the caller's wall-clock
        bound — it becomes the single attempt's deadline with NO automatic
        retry, so the call returns or raises within ~timeout as it always
        did. ``timeout=None`` resolves the deadline from the method class
        and inherits the full survival semantics (deadline, idempotent
        retry, breaker); the outer wait then backstops the worst-case
        retried schedule."""
        if timeout is not None:
            deadline, retries = timeout, 0
        else:
            deadline = method_deadline_s(msg_type)
            retries = (
                GLOBAL_CONFIG.rpc_max_retries
                if msg_type in IDEMPOTENT_RPCS
                else 0
            )
        fut = asyncio.run_coroutine_threadsafe(
            self.acall(
                addr, msg_type, payload, deadline_s=deadline, retries=retries
            ),
            self._loop,
        )
        outer = None
        if timeout is not None:
            # Explicit caller bound: hard wall clock, dial included — the
            # pre-deadline-tier `.result(timeout=X)` contract.
            outer = timeout + 5.0
        elif deadline and deadline > 0:
            # Classification path: each attempt may spend up to the connect
            # timeout DIALING before its request deadline starts; the
            # backstop must cover the full retried schedule or it fires
            # while acall legitimately runs (raising a bare TimeoutError
            # and orphaning the coroutine).
            outer = (
                (deadline + GLOBAL_CONFIG.rpc_connect_timeout_s)
                * (retries + 1)
                + GLOBAL_CONFIG.rpc_retry_backoff_max_s * retries
                + 5.0
            )
        return fut.result(timeout=outer)

    def notify_sync(self, addr: Address, msg_type: str, payload: Any = None):
        t = GLOBAL_CONFIG.rpc_deadline_s
        asyncio.run_coroutine_threadsafe(
            self.anotify(addr, msg_type, payload), self._loop
        ).result(timeout=t if t > 0 else None)  # <=0 = deadlines disabled

    def submit(self, coro) -> "asyncio.Future":
        """Run a coroutine on the endpoint loop from any thread."""
        return asyncio.run_coroutine_threadsafe(coro, self._loop)

    @property
    def loop(self) -> asyncio.AbstractEventLoop:
        assert self._loop is not None
        return self._loop

    def on_loop(self) -> bool:
        """True when the caller runs ON this endpoint's event loop — where
        any blocking wait on the loop would deadlock."""
        try:
            return asyncio.get_running_loop() is self._loop
        except RuntimeError:
            return False
