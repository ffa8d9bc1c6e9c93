"""ray_tpu_torch.experimental: device-resident objects (RDT-equivalent).
Port of ``ray_tpu/experimental/__init__.py``.

Reference parity: python/ray/experimental/gpu_object_manager/ (Ray Direct
Transport: GPU objects stay on-device). The port's design is in
:mod:`ray_tpu_torch.experimental.device_objects` (refs and the store),
:mod:`ray_tpu_torch.experimental.transfer` (the arm/pull fabric) and
:mod:`ray_tpu_torch.experimental.multiworld` (a sharded tensor handed
between worlds rank by rank).
"""

from ray_tpu_torch.experimental.device_objects import (
    DeviceRef,
    device_free,
    device_get,
    device_put,
    device_store_stats,
    enable_device_objects,
)
from ray_tpu_torch.experimental.multiworld import (
    arm_shards,
    export_shards,
    plan_pulls,
    pull_and_assemble,
)
from ray_tpu_torch.experimental.transfer import (
    decomposition_of,
    transfer_stats,
)

__all__ = [
    "DeviceRef",
    "arm_shards",
    "decomposition_of",
    "device_free",
    "device_get",
    "device_put",
    "device_store_stats",
    "enable_device_objects",
    "export_shards",
    "plan_pulls",
    "pull_and_assemble",
    "transfer_stats",
]
