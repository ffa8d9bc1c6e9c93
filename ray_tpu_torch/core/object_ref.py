"""ObjectRef: a handle to an owned, possibly-remote value.
Port of ``ray_tpu/core/object_ref.py``.

Ownership model (reference parity: src/ray/core_worker/reference_counter.h:44):
the process that created the object (by `put` or by submitting the producing
task) is its *owner*; the owner's memory store is the source of truth for the
value (inline) or its location (shared memory on some node). Deserializing a
ref in another process registers that process as a borrower with the owner;
dropping the last handle releases the borrow.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from ray_tpu_torch.core.ids import ObjectID

# Hooks installed by the live CoreWorker of this process (if any).
_on_ref_deserialized: Optional[Callable[["ObjectRef"], None]] = None
_on_ref_deleted: Optional[Callable[["ObjectRef"], None]] = None


def install_hooks(on_deserialized, on_deleted) -> None:
    global _on_ref_deserialized, _on_ref_deleted
    _on_ref_deserialized = on_deserialized
    _on_ref_deleted = on_deleted


def clear_hooks() -> None:
    install_hooks(None, None)


class ObjectRef:
    __slots__ = ("id", "owner_addr", "_task_name", "__weakref__")

    def __init__(
        self, id: ObjectID, owner_addr: tuple, task_name: str = ""
    ):
        self.id = id
        self.owner_addr = tuple(owner_addr) if owner_addr else None
        self._task_name = task_name

    def hex(self) -> str:
        return self.id.hex()

    def __repr__(self):
        return f"ObjectRef({self.id.hex()[:12]}…, owner={self.owner_addr})"

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.id == self.id

    def __hash__(self):
        return hash(self.id)

    def __reduce__(self):
        return (
            _deserialize_ref,
            (self.id.hex(), self.owner_addr, self._task_name),
        )

    def __del__(self):
        cb = _on_ref_deleted
        if cb is not None:
            try:
                cb(self)
            except Exception:
                _log_ref_hook_failure(self)


def _log_ref_hook_failure(ref) -> None:
    try:
        import logging

        logging.getLogger("ray_tpu_torch").exception(
            "ref-deleted hook failed for %s", ref.id.hex()[:12]
        )
    except Exception:  # raylint: disable=RL006 -- __del__ can run at interpreter shutdown where logging is already torn down
        pass


def _deserialize_ref(id_hex: str, owner_addr, task_name: str) -> ObjectRef:
    ref = ObjectRef(ObjectID.from_hex(id_hex), owner_addr, task_name)
    cb = _on_ref_deserialized
    if cb is not None:
        cb(ref)
    return ref
