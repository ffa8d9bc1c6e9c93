"""DataContext — per-process execution configuration. Port of
``ray_tpu/data/context.py``.

Reference parity: python/ray/data/context.py (DataContext.get_current with
target block sizes, parallelism defaults).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field


def _default_max_in_flight() -> int:
    """The per-operator in-flight window: the ``data_max_inflight_per_op``
    knob (0 = auto: max(4, 2 * host cores) — the heuristic that used to be
    hard-coded here)."""
    from ray_tpu_torch.data.governor import resolved_max_inflight_per_op

    return resolved_max_inflight_per_op()


@dataclass
class DataContext:
    default_parallelism: int = field(
        default_factory=lambda: max(2, (os.cpu_count() or 1))
    )
    target_max_block_size: int = 128 * 1024 * 1024
    max_in_flight_blocks: int = field(default_factory=_default_max_in_flight)

    _local = threading.local()

    @classmethod
    def get_current(cls) -> "DataContext":
        ctx = getattr(cls._local, "ctx", None)
        if ctx is None:
            ctx = cls()
            cls._local.ctx = ctx
        return ctx
