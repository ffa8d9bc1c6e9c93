"""Unique identifiers for runtime entities.
Port of ``ray_tpu/core/ids.py``.

Equivalent role to the reference's id types (reference: src/ray/common/id.h)
— here flat 16-byte random ids with a type tag, hex-printable.
"""

from __future__ import annotations

import os
import random
import threading

# Ids need uniqueness, not cryptographic strength — and os.urandom is a
# syscall, two of which (task id + return object id) used to ride EVERY
# task submission (64% of the driver-thread submit profile on a slow
# kernel). One urandom seed per process, then a userspace PRNG. Re-seeded
# after fork so worker processes never replay the parent's stream.
_rng = random.Random(os.urandom(16))
_rng_pid = os.getpid()
_rng_lock = threading.Lock()


def _random_hex() -> str:
    global _rng, _rng_pid
    with _rng_lock:
        if os.getpid() != _rng_pid:
            _rng = random.Random(os.urandom(16))
            _rng_pid = os.getpid()
        return _rng.getrandbits(128).to_bytes(16, "big").hex()


class BaseID:
    __slots__ = ("_hex",)
    _prefix = "id"

    def __init__(self, hex_str: str):
        self._hex = hex_str

    @classmethod
    def random(cls):
        return cls(_random_hex())

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(hex_str)

    def hex(self) -> str:
        return self._hex

    def __eq__(self, other):
        return type(other) is type(self) and other._hex == self._hex

    def __hash__(self):
        return hash((self._prefix, self._hex))

    def __repr__(self):
        return f"{type(self).__name__}({self._hex[:12]}…)"

    def __reduce__(self):
        return (type(self).from_hex, (self._hex,))


class ObjectID(BaseID):
    _prefix = "obj"


class TaskID(BaseID):
    _prefix = "task"


class ActorID(BaseID):
    _prefix = "actor"


class NodeID(BaseID):
    _prefix = "node"


class WorkerID(BaseID):
    _prefix = "worker"


class PlacementGroupID(BaseID):
    _prefix = "pg"


class JobID(BaseID):
    _prefix = "job"
