"""Multi-controller transfer fabric: per-process arm/pull of a rank's
shard, so a K-process world hands a sharded tensor to an M-process world
without gathering it anywhere. Port of
``ray_tpu/experimental/multiworld.py``.

Reference parity: python/ray/experimental/gpu_object_manager/
gpu_object_store.py (the multi-worker RDT case NIXL handles for the
reference). The single-controller fabric (:mod:`.transfer`) stages a
WHOLE tensor in one process; in a multi-process world no process holds
it: each rank holds only its block. In the port a rank is one process
driving one card, so a world's "addressable shards" are each rank's
local tensor, placed by its :class:`~ray_tpu_torch.parallel.NamedSharding`
(``box()`` gives its index box in the global tensor). A world is a
``torch.distributed`` process group whose mesh
(:func:`ray_tpu_torch.parallel.make_mesh`) gives each rank its coordinate.
Protocol:

1. Every producer rank publishes a **catalog** of its shard
   (:func:`export_shards`: the global index box and shape, no data
   moves).
2. Each consumer rank computes which producer shards overlap its own
   target region (:func:`plan_pulls`) and asks the owning producer ranks
   to **arm** exactly those (:func:`arm_shards`: one armed entry per
   shard, served once).
3. The consumer pulls each armed shard through the transfer fabric,
   slices out the overlaps, and copies each into its slice of a tensor
   preallocated on the target device (:func:`pull_and_assemble`).

The RPC plumbing between worlds stays with the caller (Train workers are
actors; the catalogs and descriptors are small dicts): these functions
are the building blocks.
"""

from __future__ import annotations

import math
import uuid as _uuid
from typing import Any, Optional, Sequence

import torch

from ray_tpu_torch.experimental.transfer import (
    _Staged,
    _torch_dtype,
    decomposition_of,
    fabric,
)


def _overlap(a: tuple, b: tuple) -> Optional[tuple]:
    """Intersection box of two (start, stop) boxes, or None."""
    out = []
    for (a0, a1), (b0, b1) in zip(a, b):
        lo, hi = max(a0, b0), min(a1, b1)
        if lo >= hi:
            return None
        out.append((lo, hi))
    return tuple(out)


def _process_index() -> int:
    """This process's rank in its world (0 outside a process group)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def export_shards(local: torch.Tensor, sharding) -> dict:
    """Catalog of THIS rank's shard of a tensor split under ``sharding``
    (``local`` is the rank's block): pure metadata."""
    parts = decomposition_of(sharding, local.shape)
    global_shape = tuple(int(s) * n for s, n in zip(local.shape, parts))
    box = sharding.box(global_shape)
    return {
        "process_index": _process_index(),
        "global_shape": global_shape,
        "dtype": str(local.dtype).removeprefix("torch."),
        "shards": [{"pos": 0, "box": box, "shape": tuple(local.shape)}],
    }


def arm_shards(local: torch.Tensor, positions: Sequence[int], *, oid: str | None = None) -> dict:
    """Arm this rank's shard (position 0: a rank holds one) for ONE pull
    per position asked. Returns {"address", "armed": {pos: uuid}}. Entries
    ride the fabric's armed table (cap and TTL evicted like single-world
    arms)."""
    fab = fabric()
    server = fab._ensure_server()
    armed = {}
    for pos in positions:
        if int(pos) != 0:
            raise IndexError(f"a rank holds one shard (position 0), asked for {pos}")
        staged = _Staged(local)
        uid = _uuid.uuid4().int >> 65  # 63-bit
        server.await_pull(uid, [staged])
        fab._remember_armed(uid, oid, staged.host)
        armed[int(pos)] = uid
    return {"address": fab.address(), "armed": armed}


def plan_pulls(catalogs: Sequence[dict], target_sharding, global_shape) -> dict:
    """{producer process_index: [pos, ...]}: the producer shards THIS
    consumer rank needs (those overlapping its target region)."""
    region = tuple(target_sharding.box(tuple(global_shape)))
    plan: dict[int, list] = {}
    for cat in catalogs:
        poss = [
            s["pos"]
            for s in cat["shards"]
            if _overlap(region, tuple(map(tuple, s["box"])))
        ]
        if poss:
            plan[cat["process_index"]] = poss
    return plan


def pull_and_assemble(
    catalogs: Sequence[dict],
    descriptors: Sequence[dict],
    target_sharding,
    *,
    global_shape: Optional[tuple] = None,
    dtype: Any = None,
    device=None,
) -> torch.Tensor:
    """Pull the shards this rank needs and build its block of the global
    tensor under ``target_sharding``, on ``device`` (the caller's current
    card by default; ``"cpu"`` only when asked).

    ``catalogs`` and ``descriptors`` line up one to one per producer rank
    (a descriptor is ``arm_shards``'s return). Each needed shard is
    pulled once. Returns this rank's block (the whole tensor where
    ``target_sharding`` splits nothing)."""
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    fab = fabric()
    global_shape = tuple(global_shape or catalogs[0]["global_shape"])
    dtype = dtype if isinstance(dtype, torch.dtype) else _torch_dtype(dtype or catalogs[0]["dtype"])
    region = tuple(target_sharding.box(global_shape))
    local_shape = tuple(hi - lo for lo, hi in region)
    out = torch.empty(local_shape, dtype=dtype, device=device)
    covered = 0
    for cat, desc in zip(catalogs, descriptors):
        for shard in cat["shards"]:
            box = tuple(map(tuple, shard["box"]))
            ov = _overlap(region, box)
            if ov is None:
                continue
            armed = desc["armed"]
            uid = armed.get(shard["pos"], armed.get(str(shard["pos"])))
            if uid is None:
                raise KeyError(
                    f"producer {cat['process_index']} did not arm shard "
                    f"{shard['pos']} (re-run plan_pulls?)"
                )
            spec = {"shape": tuple(shard["shape"]), "dtype": str(dtype).removeprefix("torch.")}
            [arr] = fab._connect(desc["address"]).pull(uid, [spec], device)
            with fab._lock:
                fab._stats["pulls"] += 1
            piece = arr[tuple(slice(lo - b0, hi - b0) for (lo, hi), (b0, _b1) in zip(ov, box))]
            out[tuple(slice(lo - r0, hi - r0) for (lo, hi), (r0, _r1) in zip(ov, region))].copy_(
                piece
            )
            covered += math.prod(hi - lo for lo, hi in ov)
    if covered != out.numel():
        raise ValueError(
            f"the catalogs cover {covered} of the {out.numel()} elements of this rank's "
            f"region {region}"
        )
    return out
