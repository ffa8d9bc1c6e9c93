"""Sharded checkpoints of a training state, restored onto any mesh layout.
Port of ``ray_tpu/train/sharded_checkpoint.py``.

The reference saves a pytree of sharded ``jax.Array``s with orbax: every
process writes its own shards, and restore lays the state onto any target
sharding. The port's leaves are plain local tensors with a
:class:`~ray_tpu_torch.parallel.NamedSharding` beside them
(:func:`~ray_tpu_torch.train.spmd.state_shardings`), not DTensors, so this
module keeps its own format:

- **Save** (:func:`save_sharded`, collective over the default process group
  where one is started): each rank writes the blocks it owns into one file,
  ``rank<r>.pt`` (``torch.save`` of a dict of CPU tensors). A leaf's block
  is the rank's :meth:`NamedSharding.box` of its global shape; a block that
  other ranks hold too (the leaf is replicated over an axis) is written
  once, by the rank at coordinate 0 on every axis that does not split the
  leaf. The ranks then exchange what they wrote, rank 0 writes
  ``manifest.json`` last (each leaf's global shape, dtype and saved boxes
  with their files; and the host-int counters, ``step`` and the optimizer's
  ``count``), and the save ends in a barrier.
- **Restore** (:func:`restore_sharded`): each rank computes its box under
  the **target** sharding of each leaf and reads only the saved boxes that
  overlap it, from files opened with ``torch.load(..., mmap=True)``, so no
  rank materialises a whole leaf unless its target keeps it whole. The
  result is bit for bit the saved values. Restoring a
  :class:`~ray_tpu_torch.train.spmd.TrainState` template gives a
  ``TrainState`` with the target's ``"shardings"``, ready for
  ``make_train_step`` on the new mesh.

The target is a template (:func:`restore_template`): the state's tree with
a :class:`LeafSpec` (global shape, dtype, target sharding, device, whether
it requires grad) in place of each tensor and the host ints as they are.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.sharding import NamedSharding

# The sharded state's directory inside a Train checkpoint (the reference's
# ``ray_tpu/train/storage.py:30``).
SHARDED_SUBDIR = "sharded_state"
MANIFEST = "manifest.json"
FORMAT = 1


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """One tensor leaf of a restore template: its global shape and dtype,
    the sharding it is restored under (None: whole on every rank), the
    device it lands on and whether it requires grad (the params of a
    ``TrainState`` do)."""

    shape: tuple
    dtype: torch.dtype
    sharding: Optional[NamedSharding] = None
    device: torch.device = torch.device("cpu")
    requires_grad: bool = False


def _is_train_state(tree: Any) -> bool:
    return isinstance(tree, dict) and {"params", "opt_state", "step", "shardings"} <= set(tree)


def _flatten(tree: Any, shardings: Any, prefix: str = "") -> list:
    """``(path, leaf, sharding)`` for every leaf of a nested dict (tensors,
    specs or host ints), in sorted-key order."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            sub = shardings.get(key) if isinstance(shardings, dict) else None
            out += _flatten(tree[key], sub, f"{prefix}{key}/")
        return out
    return [(prefix[:-1], tree, shardings)]


def _unflatten_like(tree: Any, values: dict, prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, values, f"{prefix}{k}/") for k, v in tree.items()}
    return values[prefix[:-1]]


def _default_shardings(state: Any) -> Any:
    if _is_train_state(state):
        from ray_tpu_torch.train.spmd import state_shardings

        return state_shardings(state)
    return None


def _tree_of(state: Any) -> Any:
    """The saved tree: a TrainState without its ``"shardings"`` entry."""
    if _is_train_state(state):
        return {k: v for k, v in state.items() if k != "shardings"}
    return state


def _global_shape(local: torch.Tensor, sharding: Optional[NamedSharding]) -> tuple:
    """The whole leaf's shape from this rank's block under ``sharding``."""
    if sharding is None:
        return tuple(local.shape)
    shape = list(local.shape)
    for dim, entry in enumerate(sharding.spec[: len(shape)]):
        axes = () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))
        shape[dim] *= math.prod(sharding.mesh.size(a) for a in axes)
    return tuple(shape)


def _writes(sharding: Optional[NamedSharding]) -> bool:
    """Whether this rank writes its block of a leaf: the block is written
    once, by the rank at coordinate 0 on every axis (of size > 1) that
    does not split the leaf. Without a sharding, global rank 0 writes."""
    if sharding is None:
        return not dist.is_initialized() or dist.get_rank() == 0
    mesh = sharding.mesh
    split = sharding.axes
    return all(mesh.coordinate(a) == 0 for a in mesh.axis_names if mesh.size(a) > 1 and a not in split)


def _rank_world() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def save_sharded(state: Any, path: str) -> int:
    """Write ``state`` to the directory ``path``; returns the bytes this
    rank wrote. ``state`` is a ``TrainState``, each leaf under its
    :func:`~ray_tpu_torch.train.spmd.state_shardings`, or a nested dict of
    whole tensors and host ints. Collective over the default process
    group where one is started: every rank calls it with the same path on
    a shared filesystem, and it returns once the manifest is written."""
    path = os.path.abspath(path)
    rank, world = _rank_world()
    shardings = _default_shardings(state)
    blocks, entries, ints = {}, [], {}
    for key, leaf, sharding in _flatten(_tree_of(state), shardings):
        if not isinstance(leaf, torch.Tensor):
            ints[key] = int(leaf)
            continue
        shape = _global_shape(leaf, sharding)
        box = sharding.box(shape) if sharding is not None else tuple((0, n) for n in shape)
        if _writes(sharding):
            blocks[key] = leaf.detach().to("cpu", copy=True).contiguous()
            entries.append((key, shape, _dtype_name(leaf.dtype), [list(b) for b in box]))
        else:
            entries.append((key, shape, _dtype_name(leaf.dtype), None))
    os.makedirs(path, exist_ok=True)
    name = f"rank{rank}.pt"
    tmp = os.path.join(path, name + ".tmp")
    torch.save(blocks, tmp)
    os.replace(tmp, os.path.join(path, name))
    written = sum(t.numel() * t.element_size() for t in blocks.values())
    everyone = [None] * world
    if world > 1:
        dist.all_gather_object(everyone, (name, entries))
    else:
        everyone = [(name, entries)]
    if rank == 0:
        leaves: dict = {}
        for fname, ents in everyone:
            for key, shape, dtype, box in ents:
                leaf = leaves.setdefault(key, {"shape": list(shape), "dtype": dtype, "blocks": []})
                if (list(shape), dtype) != (leaf["shape"], leaf["dtype"]):
                    raise ValueError(f"ranks disagree on {key}: {shape} {dtype} vs {leaf}")
                if box is not None:
                    leaf["blocks"].append({"file": fname, "box": box})
        manifest = {"format": FORMAT, "world": world, "leaves": leaves, "ints": ints}
        tmp = os.path.join(path, MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(path, MANIFEST))
    if world > 1:
        dist.barrier()
    return written


def restore_template(state_like: Any, shardings: Any = None, device=None) -> Any:
    """The restore target: ``state_like``'s tree with a :class:`LeafSpec`
    for each tensor (its global shape, dtype, device and requires-grad
    flag, read from ``state_like``'s local blocks under its own shardings)
    and the host ints as they are. For a ``TrainState``, ``shardings`` is
    the target params' sharding tree, as ``make_train_state(param_shardings=)``
    takes it (the moments share it; a tree of None restores every leaf
    whole), and the template keeps it under ``"shardings"``; None keeps
    ``state_like``'s own. For a plain dict, ``shardings`` is a matching
    tree of :class:`NamedSharding` (None: whole). ``device`` (by default
    each leaf's own) is where the restored leaves land."""
    own = _default_shardings(state_like)
    train = _is_train_state(state_like)
    params_target = None
    if train:
        from ray_tpu_torch.train.spmd import state_shardings

        params_target = state_like["shardings"] if shardings is None else shardings
        target = state_shardings({"params": state_like["params"], "shardings": params_target})
    else:
        target = shardings
    tree = _tree_of(state_like)
    own_by = {k: s for k, _, s in _flatten(tree, own)}
    values = {}
    for key, leaf, sharding in _flatten(tree, target):
        if isinstance(leaf, torch.Tensor):
            values[key] = LeafSpec(
                shape=_global_shape(leaf, own_by[key]), dtype=leaf.dtype, sharding=sharding,
                device=torch.device(device) if device is not None else leaf.device,
                requires_grad=leaf.requires_grad,
            )
        else:
            values[key] = leaf
    out = _unflatten_like(tree, values)
    if train:
        out["shardings"] = params_target
    return out


def _overlap(a: list, b: list) -> Optional[list]:
    """The intersection of two boxes, or None when it is empty."""
    out = []
    for (alo, ahi), (blo, bhi) in zip(a, b):
        lo, hi = max(alo, blo), min(ahi, bhi)
        if lo >= hi:
            return None
        out.append((lo, hi))
    return out


def restore_sharded(path: str, template: Any) -> Any:
    """Restore the state saved at ``path`` onto ``template``
    (:func:`restore_template`): each tensor leaf as this rank's block under
    its target sharding, read only from the saved blocks that overlap it;
    each host int from the manifest. Raises where a leaf's shape or dtype
    differs from the saved one, or the saved blocks do not cover the
    rank's block."""
    path = os.path.abspath(path)
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT:
        raise ValueError(f"{path}: unknown sharded checkpoint format {manifest.get('format')!r}")
    files: dict = {}

    def opened(name):
        if name not in files:
            files[name] = torch.load(os.path.join(path, name), mmap=True, weights_only=True)
        return files[name]

    tree = _tree_of(template)
    values = {}
    for key, spec, _ in _flatten(tree, None):
        if not isinstance(spec, LeafSpec):
            if key not in manifest["ints"]:
                raise KeyError(f"{path}: no saved value for {key}")
            values[key] = manifest["ints"][key]
            continue
        saved = manifest["leaves"].get(key)
        if saved is None:
            raise KeyError(f"{path}: no saved leaf {key}")
        if tuple(saved["shape"]) != tuple(spec.shape) or saved["dtype"] != _dtype_name(spec.dtype):
            raise ValueError(
                f"{key}: saved {saved['shape']} {saved['dtype']}, template {spec.shape} {spec.dtype}"
            )
        want = (spec.sharding.box(spec.shape) if spec.sharding is not None
                else tuple((0, n) for n in spec.shape))
        out = torch.empty([hi - lo for lo, hi in want], dtype=spec.dtype, device=spec.device)
        covered = 0
        for block in saved["blocks"]:
            part = _overlap(block["box"], want)
            if part is None:
                continue
            src = opened(block["file"])[key]
            src_idx = tuple(slice(lo - b[0], hi - b[0]) for (lo, hi), b in zip(part, block["box"]))
            dst_idx = tuple(slice(lo - w[0], hi - w[0]) for (lo, hi), w in zip(part, want))
            out[dst_idx] = src[src_idx]
            covered += math.prod(hi - lo for lo, hi in part)
        if covered != out.numel():
            raise ValueError(f"{key}: the saved blocks cover {covered} of this rank's {out.numel()} elements")
        values[key] = out.requires_grad_(True) if spec.requires_grad else out
    out = _unflatten_like(tree, values)
    if _is_train_state(template):
        out["shardings"] = template["shardings"]
    return out


def load_sharded_state(checkpoint, template: Any) -> Any:
    """Restore the sharded state kept in a Train
    :class:`~ray_tpu_torch.train.checkpoint.Checkpoint` (its
    :data:`SHARDED_SUBDIR` directory) onto ``template``."""
    return restore_sharded(os.path.join(checkpoint.path, SHARDED_SUBDIR), template)
