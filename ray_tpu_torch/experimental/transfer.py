"""Tensor transfer between separately started processes: one arm, one pull.
Port of ``ray_tpu/experimental/transfer.py`` (its contract and its socket
transport).

Protocol (one producer process, one consumer process):

1. The producer calls ``fabric().arm(oid, tensor, partitions)``: the tensor
   is staged (a CUDA tensor is copied into pinned host memory, with a CUDA
   event recorded behind the copy) and scheduled for exactly one pull. It
   returns a small descriptor ``{uuid, address, shape, dtype,
   partitions}`` that travels by whatever control plane the caller has
   (for the KV handoff: the handoff dict).
2. The consumer calls ``fabric().pull(desc, device)``: one TCP connection
   to the producer's transfer server, which waits on the staging event and
   sends the raw bytes; the consumer lands them on ``device``.

The server (:class:`_SocketTransferServer`) is one TCP listener per process,
started at the first use of :func:`fabric`; it serves an armed entry once
and then forgets it. ``transfer_stats()["transport"]`` says ``"socket"``.
The reference pulls device to device through XLA's transfer engine where
its jax has one, and falls back to this socket transport elsewhere; the
port has only the socket, a host-staged copy (see ROADMAP for the
device-to-device transport that takes its place on one host).

On the wire, a buffer is a JSON header (its shape and the torch dtype's
name, so bfloat16 needs no numpy dtype), its byte count and its raw bytes.

Armed entries that are never pulled are bounded: past ``ARMED_CAP``
(``GLOBAL_CONFIG.xfer_armed_cap``) entries, the oldest ones older than
``ARMED_TTL_S`` are evicted (a younger entry's pull may still be in flight),
released from the server, and handed to :attr:`_Fabric.refund` where an
object store registered one, as the reference refunds its store's fetch
budget. ``release_uuid`` drops one entry (its pull completed, or its
consumer gave up).

:meth:`_Fabric.arm_group` / :meth:`_Fabric.pull_group` move several
tensors under one uid in one pull (the train tier's elastic plane reshards
a rank's state with them). The device-object store
(:mod:`ray_tpu_torch.experimental.device_objects`) arms its entries here,
drops an object's armed copies with :meth:`_Fabric.release_armed`, and
counts every host fetch it takes instead with
:meth:`_Fabric.count_fallback`; :mod:`ray_tpu_torch.experimental.multiworld`
arms and pulls a rank's shard of a sharded tensor.

The decomposition helpers read a consumer's wish: :func:`decomposition_of`
gives the per-dim partition counts of a port ``NamedSharding`` (from its
mesh's axis sizes, as its :meth:`box` cuts them), and
:func:`max_local_decomposition` the split over this process's devices,
which is one card a process in the port: ``(1, ...)``. A tensor is always
staged whole: ``partitions`` is validated and carried in the descriptor,
and a process with one device stages one shard, as the reference does
where the consumer asks for more shards than the producer has devices.
"""

from __future__ import annotations

import collections
import json
import math
import socket
import struct
import threading
import time
import uuid as _uuid
from typing import Any, Callable, Optional, Sequence

import torch


def _recv_exact(sock, n: int) -> bytes:
    """Read exactly ``n`` bytes or raise (a short read means the peer died
    or never armed the uid: callers surface that as a failed pull)."""
    chunks = []
    while n:
        piece = sock.recv(min(n, 1 << 20))
        if not piece:
            raise ConnectionError("transfer peer closed mid-message")
        chunks.append(piece)
        n -= len(piece)
    return b"".join(chunks)


def _recv_into(sock, buf: memoryview) -> None:
    """Fill ``buf`` from the socket, or raise on a short read."""
    off = 0
    while off < len(buf):
        got = sock.recv_into(buf[off:], min(len(buf) - off, 1 << 22))
        if not got:
            raise ConnectionError("transfer peer closed mid-message")
        off += got


def _torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name.removeprefix("torch."), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"not a torch dtype: {name!r}")
    return dtype


def _bytes_of(t: torch.Tensor) -> memoryview:
    """The bytes of a contiguous CPU tensor, without a copy."""
    return memoryview(t.reshape(-1).view(torch.uint8).numpy())


class _Staged:
    """One armed tensor on the host: the copy and, for a CUDA source, the
    event recorded behind the copy (the server waits on it before it
    sends, or it would send a gather that has not finished)."""

    __slots__ = ("host", "ready")

    def __init__(self, tensor: torch.Tensor):
        src = tensor.detach()
        if src.is_cuda:
            self.host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            self.host.copy_(src, non_blocking=True)
            self.ready = torch.cuda.Event()
            self.ready.record(torch.cuda.current_stream(src.device))
        else:
            self.host = src.clone(memory_format=torch.contiguous_format)
            self.ready = None

    def wait(self) -> torch.Tensor:
        if self.ready is not None:
            self.ready.synchronize()
        return self.host


class _SocketCompatConnection:
    """Puller half of the socket transport (see
    :class:`_SocketTransferServer`). One TCP connection per pull."""

    def __init__(self, address: str):
        self._address = address

    def pull(self, uid: int, specs: Sequence[dict], device=None) -> list:
        """The armed entry ``uid``'s tensors, landed on ``device`` (the
        host where None). ``specs`` holds what the consumer expects, one
        ``{"shape", "dtype"}`` per tensor; a mismatch raises."""
        device = torch.device(device) if device is not None else torch.device("cpu")
        host, _, port = self._address.rpartition(":")
        out = []
        with socket.create_connection((host, int(port)), timeout=120.0) as s:
            s.sendall(struct.pack(">Q", int(uid)))
            if _recv_exact(s, 1) != b"\x01":
                raise KeyError(
                    f"transfer uid {uid} not armed at {self._address} "
                    f"(already served, TTL-evicted, or never armed)"
                )
            (count,) = struct.unpack(">I", _recv_exact(s, 4))
            if count != len(specs):
                raise ValueError(f"armed entry has {count} buffers, pull expected {len(specs)}")
            for spec in specs:
                (hlen,) = struct.unpack(">I", _recv_exact(s, 4))
                meta = json.loads(_recv_exact(s, hlen))
                (nbytes,) = struct.unpack(">Q", _recv_exact(s, 8))
                shape, dtype = tuple(meta["shape"]), _torch_dtype(meta["dtype"])
                if shape != tuple(spec["shape"]) or dtype != _torch_dtype(spec["dtype"]):
                    raise ValueError(f"armed {shape} {dtype}, pull expected {spec}")
                if nbytes != math.prod(shape) * dtype.itemsize:
                    raise ValueError(f"armed entry sends {nbytes} bytes for {shape} {dtype}")
                raw = torch.empty(nbytes, dtype=torch.uint8, pin_memory=device.type == "cuda")
                _recv_into(s, memoryview(raw.numpy()))
                t = raw.view(dtype).reshape(shape)
                out.append(t.to(device, non_blocking=True) if device.type != "cpu" else t)
        return out


class _SocketTransferServer:
    """Arm/pull transport over one plain TCP listener: ``await_pull``
    schedules an entry, the first connection that asks for its uid gets
    it and the entry is gone (serve-once); ``release`` unschedules an
    entry nobody pulled."""

    def __init__(self, host: str):
        self._lock = threading.Lock()
        self._armed: dict[int, list] = {}
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, 0))
        self._sock.listen(32)
        self._host = host
        self._port = self._sock.getsockname()[1]
        threading.Thread(target=self._serve, name="xfer-socket-server", daemon=True).start()

    def address(self) -> str:
        return f"{self._host}:{self._port}"

    def await_pull(self, uid: int, staged: Sequence[_Staged]) -> None:
        with self._lock:
            self._armed[int(uid)] = list(staged)

    def release(self, uid: int) -> None:
        """Unschedule a never-pulled entry (without this, released fabric
        entries would keep their staged copies here forever)."""
        with self._lock:
            self._armed.pop(int(uid), None)

    def connect(self, address: str) -> _SocketCompatConnection:
        return _SocketCompatConnection(address)

    def _serve(self) -> None:
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # listener closed: process teardown
            threading.Thread(target=self._handle, args=(conn,), daemon=True).start()

    def _handle(self, conn) -> None:
        try:
            with conn:
                (uid,) = struct.unpack(">Q", _recv_exact(conn, 8))
                with self._lock:
                    staged = self._armed.pop(uid, None)  # serve-once
                if staged is None:
                    conn.sendall(b"\x00")
                    return
                conn.sendall(b"\x01" + struct.pack(">I", len(staged)))
                for entry in staged:
                    host = entry.wait()
                    meta = json.dumps(
                        {"shape": list(host.shape), "dtype": str(host.dtype).removeprefix("torch.")}
                    ).encode()
                    nbytes = host.numel() * host.element_size()
                    conn.sendall(struct.pack(">I", len(meta)) + meta + struct.pack(">Q", nbytes))
                    if nbytes:
                        conn.sendall(_bytes_of(host))
        except Exception:  # noqa: BLE001 - a dying puller sees the short read and fails its own pull
            pass


def _normalize_partitions(shape, partitions) -> tuple[int, ...]:
    partitions = tuple(int(p) for p in partitions)
    if len(partitions) != len(shape):
        raise ValueError(f"partitions {partitions} rank != array rank {len(shape)}")
    if any(p < 1 for p in partitions):
        raise ValueError(f"partitions must be >= 1, got {partitions}")
    return partitions


class _Fabric:
    """Per-process transfer server and connection cache (started lazily)."""

    # Only entries older than ARMED_TTL_S are evicted past the cap: a
    # younger entry's pull may still be in flight, and evicting it could
    # both serve the pull and refund the entry.
    ARMED_CAP = 16
    ARMED_TTL_S = 120.0

    def __init__(self):
        from ray_tpu_torch.core.config import GLOBAL_CONFIG

        self._lock = threading.Lock()
        self._server: Optional[_SocketTransferServer] = None
        self._conns: dict[str, Any] = {}
        # uuid -> (oid, staged tensor, armed_at_monotonic), oldest first.
        self._armed: "collections.OrderedDict[int, tuple]" = collections.OrderedDict()
        self._armed_cap = int(GLOBAL_CONFIG.xfer_armed_cap)
        self._stats = {"arms": 0, "pulls": 0, "fallbacks": 0}
        self._transport = "unstarted"
        # An object store's hook for TTL-evicted entries that carry an
        # oid: called as refund(oid, staged_tensor) outside the lock.
        self.refund: Optional[Callable[[Any, torch.Tensor], None]] = None

    def _ensure_server(self) -> _SocketTransferServer:
        if self._server is not None:
            return self._server
        with self._lock:
            if self._server is None:
                from ray_tpu_torch.util.net import local_ip

                self._server = _SocketTransferServer(local_ip())
                self._transport = "socket"
        return self._server

    def address(self) -> str:
        return self._ensure_server().address()

    def _connect(self, address: str) -> _SocketCompatConnection:
        server = self._ensure_server()
        with self._lock:
            conn = self._conns.get(address)
            if conn is None:
                conn = server.connect(address)
                self._conns[address] = conn
            return conn

    # -- producer side ---------------------------------------------------------

    def arm(self, oid, tensor: torch.Tensor, partitions: Sequence[int]) -> dict:
        """Stage ``tensor`` and schedule it for one remote pull. Returns the
        pull descriptor. ``partitions`` is validated; this process stages
        one shard (see the module docstring)."""
        _normalize_partitions(tensor.shape, partitions)
        partitions = (1,) * tensor.dim()
        staged = _Staged(tensor)
        uid = _uuid.uuid4().int >> 65  # 63-bit
        self._ensure_server().await_pull(uid, [staged])
        # A store's entry (an oid) keeps its source tensor, so a refund
        # puts the object back on its own device; an arm no store owns
        # keeps only the host copy.
        self._remember_armed(uid, oid, staged.host if oid is None else tensor)
        return {
            "uuid": uid,
            "address": self.address(),
            "shape": tuple(tensor.shape),
            "dtype": str(tensor.dtype).removeprefix("torch."),
            "partitions": partitions,
        }

    def arm_group(self, tensors: Sequence) -> dict:
        """Stage SEVERAL tensors under ONE uid for one remote pull (one
        descriptor, one TCP connection). Each member is staged as
        :meth:`arm` stages one (numpy arrays are taken as tensors); the
        descriptor carries each member's shape, dtype and source device
        type, which :meth:`pull_group` checks and the consumer may use to
        place the members."""
        members = [t if isinstance(t, torch.Tensor) else torch.as_tensor(t) for t in tensors]
        staged = [_Staged(t) for t in members]
        uid = _uuid.uuid4().int >> 65  # 63-bit
        self._ensure_server().await_pull(uid, staged)
        self._remember_armed(uid, None, [s.host for s in staged])
        return {
            "uuid": uid,
            "address": self.address(),
            "specs": [
                {"shape": tuple(t.shape), "dtype": str(t.dtype).removeprefix("torch."),
                 "device": t.device.type}
                for t in members
            ],
            "group": True,
        }

    def _remember_armed(self, uid: int, oid, staged: torch.Tensor) -> None:
        """Record one armed entry and run the cap/TTL eviction sweep."""
        evicted, evicted_uids = [], []
        now = time.monotonic()
        with self._lock:
            self._armed[uid] = (oid, staged, now)
            while len(self._armed) > self._armed_cap:
                old_uid, entry = next(iter(self._armed.items()))
                if now - entry[2] < self.ARMED_TTL_S:
                    break  # young entries: the pull may still be in flight
                del self._armed[old_uid]
                evicted.append(entry)
                evicted_uids.append(old_uid)
            self._stats["arms"] += 1
        self._server_release(evicted_uids)
        # A TTL-evicted entry's pull can no longer land: refund it where a
        # store keeps one (oid None = an arm no store owns: nothing to refund).
        refund = self.refund
        if refund is not None:
            for ev_oid, ev_staged, _t in evicted:
                if ev_oid is not None:
                    refund(ev_oid, ev_staged)

    def _server_release(self, uids: Sequence[int]) -> None:
        if self._server is not None:
            for uid in uids:
                self._server.release(uid)

    def release_armed(self, oid) -> None:
        """Drop every armed entry of ``oid`` (the object was freed before
        any pull)."""
        with self._lock:
            uids = [u for u, entry in self._armed.items() if entry[0] == oid]
            for uid in uids:
                del self._armed[uid]
        self._server_release(uids)

    def release_uuid(self, uid: int):
        """Drop one armed entry (its pull completed, or its consumer gave
        up). Returns ``(oid, staged_tensor)``, or None."""
        with self._lock:
            entry = self._armed.pop(int(uid), None)
        self._server_release([int(uid)])
        return None if entry is None else entry[:2]

    # -- consumer side ---------------------------------------------------------

    def pull(self, desc: dict, device=None) -> torch.Tensor:
        """Pull the armed tensor of ``desc`` onto ``device`` (the host
        where None). Raises where the entry was already served, released
        or evicted, or the producer is gone."""
        conn = self._connect(desc["address"])
        spec = {"shape": tuple(desc["shape"]), "dtype": desc["dtype"]}
        [out] = conn.pull(desc["uuid"], [spec], device)
        with self._lock:
            self._stats["pulls"] += 1
        return out

    def pull_group(self, desc: dict, device=None) -> list:
        """Pull an :meth:`arm_group` entry: every member lands on ``device``
        (the host where None), in the producer's order."""
        conn = self._connect(desc["address"])
        out = conn.pull(desc["uuid"], desc["specs"], device)
        with self._lock:
            self._stats["pulls"] += 1
        return out

    def count_fallback(self) -> None:
        """Count one host fetch taken where the fabric did not carry the
        data (``transfer_stats()["fallbacks"]``)."""
        with self._lock:
            self._stats["fallbacks"] += 1

    def stats(self) -> dict:
        with self._lock:
            return dict(self._stats, armed=len(self._armed), transport=self._transport)


_fabric: Optional[_Fabric] = None
_fabric_lock = threading.Lock()


def fabric() -> _Fabric:
    global _fabric
    if _fabric is None:
        with _fabric_lock:
            if _fabric is None:
                _fabric = _Fabric()
    return _fabric


def transfer_stats() -> dict:
    """Counters for tests and observability: arms, pulls, fallbacks, the
    armed entries and the transport."""
    if _fabric is None:
        return {"arms": 0, "pulls": 0, "fallbacks": 0, "armed": 0, "transport": "unstarted"}
    return _fabric.stats()


# -- decomposition helpers -----------------------------------------------------


def decomposition_of(sharding, shape) -> tuple[int, ...]:
    """Per-dimension partition counts of ``sharding`` (a port
    :class:`~ray_tpu_torch.parallel.NamedSharding`) applied to ``shape``:
    the decomposition a consumer asks the producer to stage. A dim split
    over mesh axes is cut into the product of their sizes, as
    ``NamedSharding.box`` cuts it; every other dim is whole."""
    from ray_tpu_torch.parallel.sharding import _entry_axes

    spec, mesh = sharding.spec, sharding.mesh
    out = []
    for dim in range(len(tuple(shape))):
        entry = spec[dim] if dim < len(spec) else None
        out.append(math.prod(mesh.size(a) for a in _entry_axes(entry)))
    return tuple(out)


def max_local_decomposition(shape) -> tuple[int, ...]:
    """The split of dim0 over this process's devices: the default when the
    consumer names no target. The reference splits dim0 over up to its
    local device count; a port process drives one card, so nothing is
    split."""
    return (1,) * len(tuple(shape))
