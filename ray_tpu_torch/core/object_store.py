"""Host-memory object plane: owner memory store + node shared-memory store.
Port of ``ray_tpu/core/object_store.py``.

Reference parity: the in-process CoreWorkerMemoryStore
(src/ray/core_worker/store_provider/memory_store/memory_store.h:47) for small
objects and the plasma store (src/ray/object_manager/plasma/store.h:55) for
large ones. TPU-era redesign: large objects are file-backed mmaps under
/dev/shm — every process on the node maps them directly (zero-copy reads, no
fd-passing protocol, no resource-tracker state), and the node daemon only
tracks metadata and capacity. Device arrays never enter this plane.
"""

from __future__ import annotations

import asyncio
import mmap
import os
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from ray_tpu_torch.core.errors import ObjectLostError
from ray_tpu_torch.core.ids import ObjectID


def default_shm_root(session_id: str, node_id_hex: str) -> str:
    base = "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir()
    return os.path.join(base, f"raytpu_{session_id}", node_id_hex[:12])


class ShmObjectStore:
    """Node-scoped store of sealed, immutable byte blobs in shared memory.

    Writers (workers on the node) create-and-fill via `create`/`seal`;
    any process on the node maps sealed blobs read-only by path. Capacity
    accounting and deletion live with the node daemon that owns this store;
    worker-side handles (`ShmReader`) just map.
    """

    def __init__(
        self, root: str, capacity_bytes: int, spill_root: str | None = None
    ):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.capacity = capacity_bytes
        self.used = 0  # bytes resident in shm (spilled bytes excluded)
        # Guards all metadata/file transitions: spill/restore copies run in
        # executor threads (off the node's event loop) while the loop keeps
        # serving RPCs.
        self._lock = threading.RLock()
        # object hex ->
        #   [size, sealed, last_access, location("shm"|"spill"), primary]
        # primary: this node is where the object was CREATED (a local
        # worker sealed it) rather than a replica pulled from a peer — the
        # set a graceful drain must migrate before the node dies.
        self.meta: dict[str, list] = {}
        self._maps: dict[str, tuple[mmap.mmap, memoryview]] = {}
        # Cumulative operation counters (mutated under self._lock, exported
        # by the node's metric snapshot): spills are this store's eviction
        # mechanism, so spill counts/bytes ARE the eviction series.
        self.op_stats = {
            "creates": 0,
            "adopts": 0,
            "deletes": 0,
            "spills": 0,
            "restores": 0,
            "bytes_spilled": 0,
            "bytes_restored": 0,
        }
        # Spill tier: sealed blobs LRU-move to durable disk when shm is at
        # capacity, and restore on access (reference:
        # src/ray/raylet/local_object_manager.h:44 spill/restore).
        self.spill_root = spill_root or os.path.join(
            tempfile.gettempdir(),
            "raytpu_spill",
            *root.rstrip("/").split("/")[-2:],
        )

    def _path(self, oid_hex: str) -> str:
        return os.path.join(self.root, oid_hex)

    def _spill_path(self, oid_hex: str) -> str:
        return os.path.join(self.spill_root, oid_hex)

    def _ensure_capacity(self, need: int) -> None:
        """Spill LRU sealed shm blobs to disk until `need` more bytes fit."""
        with self._lock:
            if self.used + need <= self.capacity:
                return
            candidates = sorted(
                (
                    (entry[2], oid)
                    for oid, entry in self.meta.items()
                    if entry[1] and entry[3] == "shm"
                ),
            )
            for _, oid in candidates:
                if self.used + need <= self.capacity:
                    return
                self._spill(oid)
            if self.used + need > self.capacity:
                raise MemoryError(
                    f"object store over capacity even after spilling: "
                    f"{self.used}+{need} > {self.capacity}"
                )

    def _spill(self, oid_hex: str) -> None:
        with self._lock:
            import shutil

            entry = self.meta[oid_hex]
            pair = self._maps.pop(oid_hex, None)
            if pair is not None:
                mm, view = pair
                view.release()
                mm.close()
            os.makedirs(self.spill_root, exist_ok=True)
            # Copy+rename (shm and disk are different filesystems), then unlink.
            tmp = self._spill_path(oid_hex) + ".tmp"
            shutil.copyfile(self._path(oid_hex), tmp)
            os.rename(tmp, self._spill_path(oid_hex))
            os.unlink(self._path(oid_hex))
            entry[3] = "spill"
            self.used -= entry[0]
            self.op_stats["spills"] += 1
            self.op_stats["bytes_spilled"] += entry[0]

    def _restore(self, oid_hex: str) -> None:
        with self._lock:
            import shutil

            entry = self.meta[oid_hex]
            self._ensure_capacity(entry[0])
            tmp = self._path(oid_hex) + ".restore"
            shutil.copyfile(self._spill_path(oid_hex), tmp)
            os.rename(tmp, self._path(oid_hex))
            os.unlink(self._spill_path(oid_hex))
            entry[3] = "shm"
            self.used += entry[0]
            self.op_stats["restores"] += 1
            self.op_stats["bytes_restored"] += entry[0]

    def create(self, oid_hex: str, size: int) -> memoryview:
        with self._lock:
            if oid_hex in self.meta:
                raise ValueError(f"object {oid_hex} already exists")
            self._ensure_capacity(size)
            path = self._path(oid_hex)
            fd = os.open(path + ".tmp", os.O_CREAT | os.O_RDWR | os.O_EXCL, 0o600)
            try:
                os.ftruncate(fd, max(size, 1))
                mm = mmap.mmap(fd, max(size, 1))
            finally:
                os.close(fd)
            # create() is the pull-transfer path: the blob is a replica of
            # an object whose primary lives elsewhere.
            self.meta[oid_hex] = [size, False, time.monotonic(), "shm", False]
            self.used += size
            self.op_stats["creates"] += 1
            self._maps[oid_hex] = (mm, memoryview(mm)[:size])
            return self._maps[oid_hex][1]

    def seal(self, oid_hex: str) -> None:
        with self._lock:
            entry = self.meta[oid_hex]
            mm, view = self._maps[oid_hex]
            mm.flush()
            os.rename(self._path(oid_hex) + ".tmp", self._path(oid_hex))
            entry[1] = True

    def adopt(self, oid_hex: str, size: int) -> None:
        """Account for a sealed object a local worker created directly in our
        root (the worker wrote the file; we track capacity/eviction). Adopt
        can push `used` past capacity momentarily; spill-down restores the
        invariant without touching the just-adopted blob (it is MRU)."""
        with self._lock:
            if oid_hex in self.meta:
                return
            # Adopted blobs were sealed by a LOCAL worker: this node is the
            # primary copy (drain migrates these).
            self.meta[oid_hex] = [size, True, time.monotonic(), "shm", True]
            self.used += size
            self.op_stats["adopts"] += 1
            if self.used > self.capacity:
                try:
                    self._ensure_capacity(0)
                except MemoryError:
                    pass  # one oversized blob; nothing left to spill

    def contains(self, oid_hex: str) -> bool:
        with self._lock:
            return oid_hex in self.meta and self.meta[oid_hex][1]

    def is_spilled(self, oid_hex: str) -> bool:
        with self._lock:
            return (
                oid_hex in self.meta and self.meta[oid_hex][3] == "spill"
            )

    def get(self, oid_hex: str) -> memoryview:
        with self._lock:
            if not self.contains(oid_hex):
                raise KeyError(oid_hex)
            entry = self.meta[oid_hex]
            entry[2] = time.monotonic()
            if entry[3] == "spill":
                self._restore(oid_hex)
            if oid_hex not in self._maps:
                size = entry[0]
                with open(self._path(oid_hex), "rb") as f:
                    mm = mmap.mmap(f.fileno(), max(size, 1), prot=mmap.PROT_READ)
                self._maps[oid_hex] = (mm, memoryview(mm)[:size])
            return self._maps[oid_hex][1]

    def size_of(self, oid_hex: str) -> Optional[int]:
        """Size of a sealed object, or None if absent."""
        with self._lock:
            if not self.contains(oid_hex):
                return None
            return self.meta[oid_hex][0]

    def primary_objects(self) -> list:
        """[(oid, size)] of sealed PRIMARY blobs — ones created on this
        node rather than pulled as replicas. Spilled primaries are
        included: their disk tier dies with the node too, and serving the
        migration pull restores them transparently (get())."""
        with self._lock:
            return [
                (oid, entry[0])
                for oid, entry in self.meta.items()
                if entry[1] and len(entry) > 4 and entry[4]
            ]

    def read_range(self, oid_hex: str, offset: int, length: int) -> bytes:
        """Copy a byte range out UNDER the lock: the returned bytes stay
        valid even if a concurrent spill releases the mmap right after."""
        with self._lock:
            view = self.get(oid_hex)
            return bytes(view[offset : offset + length])

    def apply(self, oid_hex: str, fn):
        """Run ``fn(view)`` on a sealed blob's memoryview UNDER the store
        lock — the mapping is pinned against a concurrent spill/delete for
        the duration. THE way for other components to compute over a blob
        in place (fingerprinting, checksums) without reaching into
        ``_lock`` themselves: lock ordering stays owned by the store."""
        with self._lock:
            return fn(self.get(oid_hex))

    def list_entries(self) -> list:
        """Snapshot of ``(oid, size, sealed, location, primary)`` rows,
        taken under the store lock so callers never iterate live metadata
        (or hold our private lock) themselves."""
        with self._lock:
            return [
                (
                    oid,
                    entry[0],
                    bool(entry[1]),
                    entry[3],
                    bool(entry[4]) if len(entry) > 4 else False,
                )
                for oid, entry in self.meta.items()
            ]

    def stats(self) -> dict:
        """Occupancy + cumulative operation counters for the node's metric
        snapshot (one lock hold per report interval, not per operation)."""
        with self._lock:
            return {
                **self.op_stats,
                "used_bytes": self.used,
                "capacity_bytes": self.capacity,
                "objects": len(self.meta),
                "spilled_objects": sum(
                    1 for e in self.meta.values() if e[3] == "spill"
                ),
            }

    def delete(self, oid_hex: str) -> None:
        with self._lock:
            entry = self.meta.pop(oid_hex, None)
            if entry is None:
                return
            self.op_stats["deletes"] += 1
            if entry[3] == "shm":
                self.used -= entry[0]
            pair = self._maps.pop(oid_hex, None)
            if pair is not None:
                mm, view = pair
                view.release()
                mm.close()
            for suffix in ("", ".tmp"):
                try:
                    os.unlink(self._path(oid_hex) + suffix)
                except FileNotFoundError:
                    pass
            for suffix in ("", ".tmp"):
                try:
                    os.unlink(self._spill_path(oid_hex) + suffix)
                except FileNotFoundError:
                    pass

    def close(self) -> None:
        with self._lock:
            for oid in list(self.meta):
                self.delete(oid)
            for d in (self.root, self.spill_root):
                try:
                    os.rmdir(d)
                except OSError:
                    pass


class ShmWriter:
    """Worker-side creator of sealed blobs in the node's shm root.

    The worker writes and seals the file itself (same-machine zero-copy),
    then tells the node to adopt it for accounting ("node.object_created").
    """

    def __init__(self, root: str):
        self.root = root

    def write(self, oid_hex: str, payload: bytes | memoryview) -> int:
        tmp = os.path.join(self.root, oid_hex + ".tmp")
        final = os.path.join(self.root, oid_hex)
        if os.path.exists(final):
            return len(payload)
        with open(tmp, "wb") as f:
            f.write(payload)
        os.rename(tmp, final)
        return len(payload)

    def write_framed(self, oid_hex: str, framed) -> int:
        """Stream a FramedPayload into the blob file: each buffer is copied
        exactly once, by write(2), straight from the value's own memory —
        the single-copy put path (reference analog: plasma Create+Seal with
        the client writing in place). Sequential write beats writing
        through a fresh mmap, which pays a zero-fill page fault per page."""
        tmp = os.path.join(self.root, oid_hex + ".tmp")
        final = os.path.join(self.root, oid_hex)
        if os.path.exists(final):
            return framed.nbytes
        size = framed.nbytes
        with open(tmp, "wb") as f:
            framed.write_stream(f)
        os.rename(tmp, final)
        return size


class ShmReader:
    """Read-only view of a node's shm store for worker processes."""

    def __init__(self, root: str):
        self.root = root
        self._maps: dict[str, tuple[mmap.mmap, memoryview]] = {}

    def contains(self, oid_hex: str) -> bool:
        return oid_hex in self._maps or os.path.exists(
            os.path.join(self.root, oid_hex)
        )

    def get(self, oid_hex: str) -> memoryview:
        if oid_hex not in self._maps:
            path = os.path.join(self.root, oid_hex)
            size = os.path.getsize(path)
            with open(path, "rb") as f:
                mm = mmap.mmap(f.fileno(), max(size, 1), prot=mmap.PROT_READ)
            self._maps[oid_hex] = (mm, memoryview(mm)[:size])
        return self._maps[oid_hex][1]

    def release(self, oid_hex: str) -> None:
        pair = self._maps.pop(oid_hex, None)
        if pair is not None:
            mm, view = pair
            view.release()
            mm.close()


# ---------------------------------------------------------------------------
# Owner-side store
# ---------------------------------------------------------------------------

PENDING = "PENDING"
READY = "READY"
FAILED = "FAILED"


@dataclass
class OwnedObject:
    """Owner's record of one object (reference_counter + memory_store entry)."""

    state: str = PENDING
    # Serialized value, if small: plain bytes, or a serialization
    # .FramedPayload kept segmented so RPC serves re-ship it zero-copy.
    inline: Optional[Any] = None
    locations: set = field(default_factory=set)  # node id hex strings
    size: int = 0
    error: Optional[Exception] = None
    local_refs: int = 0
    borrowers: int = 0
    # task lineage for reconstruction (task spec dict) — set by submitter
    producing_task: Any = None
    actor_task: bool = False  # produced by an actor method (not cancellable)
    waiters: list = field(default_factory=list)  # asyncio.Events


class OwnerStore:
    """The owner's table of objects it created. Lives on the endpoint loop."""

    def __init__(self, loop):
        self.loop = loop
        self.objects: dict[str, OwnedObject] = {}

    def ensure(self, oid_hex: str) -> OwnedObject:
        obj = self.objects.get(oid_hex)
        if obj is None:
            obj = self.objects[oid_hex] = OwnedObject()
        return obj

    def put_inline(self, oid_hex: str, payload) -> None:
        """Store a small serialized value: bytes, or a FramedPayload whose
        buffers are adopted as-is (the decoded frame's views / the put
        snapshot) — no flatten on the way in or out."""
        obj = self.ensure(oid_hex)
        if hasattr(payload, "exclusive"):
            # Stored = shared: every future get() must copy out of it, even
            # if it arrived as one frame's private reconstruction.
            payload.exclusive = False
            payload = self._maybe_compact(payload)
        obj.inline = payload
        obj.size = (
            payload.nbytes if hasattr(payload, "nbytes") else len(payload)
        )
        obj.state = READY
        self._wake(obj)

    @staticmethod
    def _maybe_compact(payload):
        """A decoded FramedPayload's buffers view the whole RPC frame body
        they arrived in — storing one small result of a large batch reply
        would pin the entire multi-MB frame for the object's lifetime.
        When the views cover less than half their backing buffer, spend
        one copy to detach (snapshot); otherwise adopt the views as-is
        (the frame is mostly this object anyway)."""
        bufs = getattr(payload, "buffers", None)
        if not bufs:
            return payload
        base = getattr(bufs[0], "obj", None)
        try:
            base_len = len(base) if base is not None else 0
        except TypeError:
            return payload
        owned = sum(b.nbytes for b in bufs)
        if base_len > 2 * owned and hasattr(payload, "snapshot"):
            return payload.snapshot()
        return payload

    def put_location(self, oid_hex: str, node_id_hex: str, size: int) -> None:
        obj = self.ensure(oid_hex)
        obj.locations.add(node_id_hex)
        obj.size = size
        obj.state = READY
        self._wake(obj)

    def put_error(self, oid_hex: str, error: Exception) -> None:
        obj = self.ensure(oid_hex)
        obj.error = error
        obj.state = FAILED
        self._wake(obj)

    def _wake(self, obj: OwnedObject) -> None:
        for ev in obj.waiters:
            ev.set()
        obj.waiters.clear()

    async def wait_ready(self, oid_hex: str, timeout: float | None = None):
        obj = self.ensure(oid_hex)
        while obj.state == PENDING:
            ev = asyncio.Event()
            obj.waiters.append(ev)
            if timeout is None:
                await ev.wait()
            else:
                await asyncio.wait_for(ev.wait(), timeout)
        return obj

    def delete(self, oid_hex: str) -> Optional[OwnedObject]:
        return self.objects.pop(oid_hex, None)
