"""Device-resident objects: keep tensors on their card across actor
boundaries. Port of ``ray_tpu/experimental/device_objects.py``.

Reference parity: python/ray/experimental/gpu_object_manager/
(GPUObjectStore gpu_object_store.py, owner-side GPUObjectMeta, hidden
__ray_send__/__ray_recv__ transfer methods, NCCL/NIXL transports).
Design, as the reference's:

- The store is per-PROCESS (module global) and served by core-worker RPCs
  (``worker.rdt_fetch``, ``rdt_arm``, ``rdt_done``, ``rdt_unarm``,
  ``rdt_free``), so any actor's tensors are fetchable without touching
  the user's class.
- :func:`device_get` first arms the owner's tensor on the transfer fabric
  (:mod:`ray_tpu_torch.experimental.transfer`), pulls it in one
  connection onto the target device, then acks with ``rdt_done`` so the
  owner drops its staged copy. When the arm or the pull fails, it sends
  ``rdt_unarm`` (which refunds the fetch budget the arm took), takes the
  host fetch (``rdt_fetch``) instead, and counts it in
  ``transfer_stats()["fallbacks"]``: that count is what shows whether the
  fabric carried the data. The fabric is the port's socket transport (a
  CUDA tensor crosses as pinned host bytes); ``RAY_TPU_RDT_FABRIC=0`` in
  the consumer's environment sends every fetch through the host path.
- ``enable_device_objects()`` turns on transparent interception: in this
  process, every strided torch tensor (CPU or CUDA, as the reference
  takes every jax array whatever its platform) inside a serialized value
  stays in the store and travels as a ``DeviceRef`` marker; the consumer
  fetches it eagerly at deserialization, onto the device type it left
  (a CUDA tensor lands on the consumer's current card).

Entry points land on the card: :func:`device_get` puts the tensor on the
caller's current CUDA device unless ``device=`` names another (``"cpu"``
only when asked).

Lifetime: owner-side entries are dropped on ``device_free``, when the
owning process exits, or, for intercepted values, after
``fetches_before_free`` fetches (1 matches the common produce->consume
handoff; 0 keeps the entry until freed).
"""

from __future__ import annotations

import dataclasses
import threading
import uuid
from typing import Any


@dataclasses.dataclass
class _Entry:
    array: Any
    fetches_left: int  # 0 = unlimited


def _is_tensor(value) -> bool:
    return (type(value).__module__ or "").partition(".")[0] == "torch" and hasattr(
        value, "element_size"
    )


class DeviceObjectStore:
    """Per-process store of device tensors (reference: GPUObjectStore)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._objects: dict[str, _Entry] = {}

    def put(self, oid: str, array, fetches_before_free: int = 0) -> None:
        with self._lock:
            self._objects[oid] = _Entry(array, fetches_before_free)

    def get_local(self, oid: str):
        with self._lock:
            entry = self._objects.get(oid)
        return None if entry is None else entry.array

    def fetch_host(self, oid: str):
        """Device -> host for shipping (a CPU tensor of the same dtype,
        shape and bits; a non-tensor value as it is); applies the fetch
        budget."""
        array = self.take_for_arm(oid)
        if array is None or not _is_tensor(array):
            return array
        return array.detach().cpu()

    def take_for_arm(self, oid: str):
        """Like fetch_host but returns the DEVICE tensor for staging on the
        transfer fabric (applies the same fetch budget)."""
        with self._lock:
            entry = self._objects.get(oid)
            if entry is None:
                return None
            if entry.fetches_left > 0:
                entry.fetches_left -= 1
                if entry.fetches_left == 0:
                    del self._objects[oid]
            return entry.array

    def restore_arm(self, oid: str, array) -> None:
        """Undo a take_for_arm whose staging or pull failed (budget
        refund)."""
        with self._lock:
            entry = self._objects.get(oid)
            if entry is None:
                self._objects[oid] = _Entry(array, 1)
            elif entry.fetches_left > 0:
                entry.fetches_left += 1

    def free(self, oid: str) -> bool:
        with self._lock:
            return self._objects.pop(oid, None) is not None

    def stats(self) -> dict:
        with self._lock:
            return {
                "num_objects": len(self._objects),
                "nbytes": sum(
                    e.array.numel() * e.array.element_size()
                    for e in self._objects.values()
                    if _is_tensor(e.array)
                ),
            }


_store = DeviceObjectStore()
# Per-PROCESS interception state (NOT thread-local: the user enables it in
# the executor thread, but actor-return serialization runs on the endpoint
# loop thread; a thread-local flag would silently never apply).
_intercept: dict = {"on": False, "fetches": 1}


def store() -> DeviceObjectStore:
    return _store


def _refund(oid, staged) -> None:
    """The fabric's hook for a TTL-evicted armed entry: its pull can no
    longer land, so its fetch budget returns to the store."""
    _store.restore_arm(oid, staged)


@dataclasses.dataclass(frozen=True)
class DeviceRef:
    """Picklable handle to a device tensor living in another process.

    ``owner_addr`` is the owning core worker's RPC address. ``dtype`` is
    the torch dtype's name (empty for a non-tensor value) and ``device``
    the device type the tensor lives on at its owner."""

    oid: str
    owner_addr: tuple
    shape: tuple
    dtype: str
    device: str = ""

    def __reduce__(self):
        return (DeviceRef, (self.oid, self.owner_addr, self.shape, self.dtype, self.device))


def _current_worker():
    from ray_tpu_torch.core import api as core_api

    return core_api._require_worker(auto_init=False)


def _fabric():
    from ray_tpu_torch.experimental import transfer as _xfer

    fab = _xfer.fabric()
    fab.refund = _refund
    return fab


def device_put(value, *, fetches_before_free: int = 0) -> DeviceRef:
    """Register a (device) tensor in this process's store; returns a
    picklable DeviceRef to hand to other actors."""
    worker = _current_worker()
    oid = f"dev-{uuid.uuid4().hex[:16]}"
    _store.put(oid, value, fetches_before_free)
    tensor = _is_tensor(value)
    return DeviceRef(
        oid=oid,
        owner_addr=tuple(worker.endpoint.address),
        shape=tuple(value.shape) if tensor else (),
        dtype=str(value.dtype).removeprefix("torch.") if tensor else "",
        device=value.device.type if tensor else "",
    )


def _target_device(device):
    """Where a fetched tensor lands: ``device``, else the caller's current
    card (raises where there is none)."""
    import torch

    if device is not None:
        return torch.device(device)
    return torch.device("cuda", torch.cuda.current_device())


def device_get(ref: DeviceRef, *, device=None, to_device: bool = True, sharding=None):
    """Resolve a DeviceRef: a local hit returns the original tensor;
    otherwise transfer it from the owner onto ``device`` (the caller's
    current card by default; ``"cpu"`` only when asked).

    The default path is the transfer fabric: the owner stages the tensor
    (``worker.rdt_arm``) in the decomposition the consumer names, and the
    consumer pulls it in one connection. ``sharding`` (a port
    ``NamedSharding``) names that decomposition and returns this rank's
    block under it; without it the pull is one whole tensor. The
    host-staged RPC (``worker.rdt_fetch``) is the fallback, counted in
    ``transfer_stats()["fallbacks"]``; a non-tensor value, ``to_device=
    False`` and ``RAY_TPU_RDT_FABRIC=0`` take the host path directly
    (``to_device=False`` returns the host tensor).
    """
    import os

    local = _store.get_local(ref.oid)
    if local is not None:
        return local
    worker = _current_worker()
    if worker.endpoint.on_loop():
        # Deserialization paths must never reach here (arg loads run in
        # the executor thread); blocking the endpoint loop on its own RPC
        # would deadlock it.
        raise RuntimeError(
            "device_get called on the endpoint event loop; fetch from the "
            "task/actor execution thread instead"
        )
    target = _target_device(device) if to_device and ref.dtype else None
    if to_device and ref.dtype and os.environ.get("RAY_TPU_RDT_FABRIC", "1") != "0":
        from ray_tpu_torch.experimental import transfer as _xfer

        try:
            if sharding is not None:
                partitions = _xfer.decomposition_of(sharding, ref.shape)
            else:
                partitions = _xfer.max_local_decomposition(ref.shape)
            desc = worker.endpoint.call(
                tuple(ref.owner_addr),
                "worker.rdt_arm",
                {"oid": ref.oid, "partitions": tuple(partitions)},
                timeout=120,
            )
        except Exception:  # noqa: BLE001 - the owner's arm RPC failed: host path
            desc = None
        if desc is not None and desc.get("gone"):
            raise KeyError(
                f"device object {ref.oid} is gone from its owner (freed or "
                f"fetch budget exhausted)"
            )
        if desc is None or desc.get("unsupported"):
            # The arm RPC failed or the owner cannot serve this object over
            # the fabric: the host fetch below is a fallback and counts as
            # one.
            _fabric().count_fallback()
        if desc is not None and not desc.get("unsupported"):
            try:
                out = _fabric().pull(desc, target)
            except Exception:  # noqa: BLE001 - a failed pull takes the host path
                # Refund the fetch budget the arm consumed (and drop the
                # staged copy) so the host fallback below still finds the
                # object: a budget-1 ref would read as "gone" otherwise.
                try:
                    worker.endpoint.call(
                        tuple(ref.owner_addr),
                        "worker.rdt_unarm",
                        {"uuid": desc["uuid"]},
                        timeout=30,
                    )
                except Exception:  # noqa: BLE001 - the owner's armed-cap eviction covers it
                    pass
                _fabric().count_fallback()
            else:
                # Ack so the owner drops its staged copy now rather than
                # holding it until cap eviction.
                try:
                    worker.endpoint.notify_sync(
                        tuple(ref.owner_addr), "worker.rdt_done", {"uuid": desc["uuid"]}
                    )
                except Exception:  # noqa: BLE001 - best-effort free; cap eviction covers it
                    pass
                return _landed(out, sharding)
    host = worker.endpoint.call(
        tuple(ref.owner_addr), "worker.rdt_fetch", {"oid": ref.oid}, timeout=120
    )
    if host is None:
        raise KeyError(
            f"device object {ref.oid} is gone from its owner (freed or "
            f"fetch budget exhausted)"
        )
    if target is None:
        return host
    return _landed(host.to(target), sharding)


def _landed(whole, sharding):
    """This rank's block of ``whole`` under ``sharding`` (a compact copy
    where it is split), or ``whole``."""
    if sharding is None:
        return whole
    local = sharding.shard(whole)
    return local.clone() if local.shape != whole.shape else whole


def device_free(ref: DeviceRef) -> bool:
    """Drop the owner-side entry (local call or RPC)."""
    if _store.free(ref.oid):
        return True
    worker = _current_worker()
    try:
        return bool(
            worker.endpoint.call(
                tuple(ref.owner_addr), "worker.rdt_free", {"oid": ref.oid}, timeout=30
            )
        )
    except Exception:  # noqa: BLE001 - an unreachable owner holds nothing to free
        return False


def device_store_stats() -> dict:
    return _store.stats()


# ---------------------------------------------------------------------------
# Transparent interception (reference: tensor_transport on @ray.remote)
# ---------------------------------------------------------------------------


def enable_device_objects(fetches_before_free: int = 1) -> None:
    """From now on IN THIS PROCESS, tensors inside serialized values (actor
    returns, put()s) stay here and travel as DeviceRefs; deserializing
    processes fetch them eagerly."""
    _intercept["fetches"] = fetches_before_free
    _intercept["on"] = True


def disable_device_objects() -> None:
    _intercept["on"] = False


def intercept_active() -> bool:
    return _intercept["on"]


def intercept_reduce(obj):
    """Called by the serializer for a tensor when interception is active:
    park the tensor locally, emit a fetch-on-load marker."""
    ref = device_put(obj, fetches_before_free=_intercept["fetches"])
    return (_load_device_ref, (ref,))


def _load_device_ref(ref: DeviceRef):
    """Fetch an intercepted tensor onto the device type it left: the
    consumer's current card for a CUDA tensor, the host for a CPU one."""
    return device_get(ref, device="cpu" if ref.device == "cpu" else None)


__all__ = [
    "DeviceObjectStore",
    "DeviceRef",
    "device_free",
    "device_get",
    "device_put",
    "device_store_stats",
    "disable_device_objects",
    "enable_device_objects",
    "intercept_active",
    "intercept_reduce",
    "store",
]
