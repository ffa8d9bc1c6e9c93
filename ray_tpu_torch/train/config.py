"""Train-tier user configs. Port of ``ray_tpu/train/config.py``.

Reference parity: python/ray/train/v2/api/config.py (ScalingConfig,
RunConfig, FailureConfig, CheckpointConfig). The reference's TPU slice
fields (``use_tpu``, ``topology``, ``accelerator_version``,
``num_slices > 1``) stay on :class:`ScalingConfig` with their defaults, and
setting any of them raises ``NotPortedError`` naming it: the port has no
slice placement group. A GPU worker asks for the card through the generic
path, ``resources_per_worker={"GPU": 1}``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from ray_tpu_torch.core.errors import NotPortedError


@dataclasses.dataclass
class ScalingConfig:
    """How many workers and what each one reserves
    (``resources_per_worker``, e.g. ``{"GPU": 1}``; ``"CPU"`` defaults to
    1). The TPU slice fields are the reference's; any value but the
    default raises ``NotPortedError``."""

    num_workers: Optional[int] = None
    resources_per_worker: Optional[dict] = None
    use_tpu: bool = False
    topology: Optional[str] = None
    accelerator_version: str = "v4"
    num_slices: int = 1
    placement_strategy: str = "PACK"

    def __post_init__(self):
        tpu = [
            f"ScalingConfig.{name}={value!r}"
            for name, value, default in (
                ("use_tpu", self.use_tpu, False),
                ("topology", self.topology, None),
                ("accelerator_version", self.accelerator_version, "v4"),
            )
            if value != default
        ]
        if self.num_slices > 1:
            tpu.append(f"ScalingConfig.num_slices={self.num_slices!r} (multi-slice)")
        if tpu:
            raise NotPortedError(f"TPU slice scaling ({', '.join(tpu)})")
        if self.num_workers is None:
            raise ValueError("num_workers is required when use_tpu=False")


@dataclasses.dataclass
class DataConfig:
    """How ``datasets=`` shards feed the train loop.

    prefetch_depth: batches staged on the device ahead of the consuming
    step (``DevicePrefetchIterator``). None = the ``train_prefetch_depth``
    config knob; 0 = host handoff (no staging thread)."""

    prefetch_depth: Optional[int] = None


@dataclasses.dataclass
class FailureConfig:
    """max_failures: worker-group rebuilds before giving up (-1 = unlimited).
    Reference: train/v2/_internal/execution/failure_handling/."""

    max_failures: int = 0


@dataclasses.dataclass
class CheckpointConfig:
    """num_to_keep: retain the N most recent persisted checkpoints
    (None = all)."""

    num_to_keep: Optional[int] = None


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = dataclasses.field(
        default_factory=FailureConfig
    )
    checkpoint_config: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig
    )

    def __post_init__(self):
        if self.storage_path is None:
            from ray_tpu_torch.core.config import GLOBAL_CONFIG

            self.storage_path = GLOBAL_CONFIG.storage_path or (
                os.path.expanduser("~/ray_tpu_results")
            )
