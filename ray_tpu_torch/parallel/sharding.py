"""Logical-axis sharding rules. Port of ``ray_tpu/parallel/sharding.py``.

Model code annotates each parameter with *logical* axis names (e.g.
``("layers", "embed", "mlp")``); a rule table maps logical names to mesh axes.
Changing the parallelism strategy = changing the rule table, never the model.

The reference places a leaf as one global ``jax.Array`` and lets XLA insert
the collectives. Here each rank holds the **local shard** its rule gives
(:func:`shard_tree`), and the few collectives the ported axes need are
explicit ``torch.distributed`` calls: :func:`all_reduce` and
:func:`grad_all_reduce` carry their gradients through autograd,
:func:`all_gather` carries none. The
reference's ``constrain`` (``with_sharding_constraint`` inside jit) has no
eager counterpart and is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.mesh import Mesh

# logical axis name -> mesh axis (str), tuple of mesh axes, or None (replicate)
LogicalRules = Mapping[str, Any]

# Default rules for transformer-family models.
#   embed   : the model/hidden dimension — sharded over fsdp (ZeRO-3 style)
#   mlp     : ffn hidden / attention-heads×head-dim — tensor parallel
#   heads   : attention head count dim — tensor parallel
#   vocab   : vocabulary dim — tensor parallel (vocab-parallel embedding/logits)
#   layers  : stacked layer dim — pipeline stages
#   experts : MoE expert dim — expert parallel
#   batch   : global batch — data parallel over (dp, fsdp)
#   seq     : sequence/context dim — sequence parallel (ring attention)
#   kv / qkv / head_dim : replicated
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("dp", "fsdp"),
    "seq": "sp",
    "embed": "fsdp",
    "mlp": "tp",
    "heads": "tp",
    "vocab": "tp",
    "layers": "pp",
    "experts": "ep",
    "head_dim": None,
    "kv": None,
    "norm": None,
}


class PartitionSpec(tuple):
    """One entry per leading dim of an array: a mesh axis, a tuple of mesh
    axes (major first), or None (replicated); trailing dims replicate.
    ``PartitionSpec(("dp", "fsdp"))`` is the reference's ``P(("dp", "fsdp"))``."""

    def __new__(cls, *parts: Any) -> "PartitionSpec":
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _entry_axes(entry: Any) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A :class:`PartitionSpec` over a :class:`Mesh`, as the reference's."""

    mesh: Mesh
    spec: PartitionSpec

    @property
    def axes(self) -> frozenset[str]:
        """The mesh axes of size > 1 the array is split over."""
        return frozenset(
            a for entry in self.spec for a in _entry_axes(entry) if self.mesh.size(a) > 1
        )

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole array ``x`` (a view): each split
        dim is cut into equal blocks, one per index along its axes, the
        first axis major, as ``jax.device_put`` lays out a NamedSharding."""
        for dim, entry in enumerate(self.spec):
            n, idx = 1, 0
            for a in _entry_axes(entry):
                idx = idx * self.mesh.size(a) + self.mesh.coordinate(a)
                n *= self.mesh.size(a)
            if n == 1:
                continue
            if x.shape[dim] % n:
                raise ValueError(
                    f"dim {dim} of shape {tuple(x.shape)} does not split into {n} "
                    f"blocks over {entry!r}"
                )
            size = x.shape[dim] // n
            x = x.narrow(dim, idx * size, size)
        return x


def logical_to_mesh_spec(
    logical: Sequence[str | None], rules: LogicalRules, mesh: Mesh
) -> PartitionSpec:
    """Translate a tuple of logical axis names into a PartitionSpec.

    Mesh axes of size 1 are dropped (replication there is free and keeping the
    spec minimal lets the same rules run on any mesh shape). A mesh axis may be
    used at most once per spec; later duplicate uses fall back to replication.
    ``mesh`` is read only through ``mesh.shape``.
    """
    used: set[str] = set()
    out: list[Any] = []
    for name in logical:
        axes = rules.get(name) if name is not None else None
        if axes is None:
            out.append(None)
            continue
        if isinstance(axes, str):
            axes = (axes,)
        picked = [
            a
            for a in axes
            if a in mesh.shape and mesh.shape[a] > 1 and a not in used
        ]
        used.update(picked)
        if not picked:
            out.append(None)
        elif len(picked) == 1:
            out.append(picked[0])
        else:
            out.append(tuple(picked))
    # Trim trailing Nones — cosmetic, keeps specs readable in debug output.
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def named_sharding(mesh: Mesh, *spec: Any) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec(*spec))


def _is_logical(x: Any) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def shardings_from_logical(logical_tree: Any, rules: LogicalRules, mesh: Mesh) -> Any:
    """Map a nested dict of logical-axis tuples to one of NamedShardings."""
    if _is_logical(logical_tree):
        return NamedSharding(mesh, logical_to_mesh_spec(logical_tree, rules, mesh))
    return {k: shardings_from_logical(v, rules, mesh) for k, v in logical_tree.items()}


def shard_tree(tree: Any, shardings: Any) -> Any:
    """Each leaf of ``tree`` (whole arrays) as this rank's shard under the
    matching leaf of ``shardings``: a compact copy where the leaf is split,
    so the whole array can be freed, and the leaf itself where it is not."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, shardings[k]) for k, v in tree.items()}
    local = shardings.shard(tree)
    return local.clone() if local.shape != tree.shape else tree


# ---------------------------------------------------------------------------
# Collectives with gradients


class _AllReduce(torch.autograd.Function):
    """Sum over one axis's group in forward when ``fwd``, and of the
    gradient in backward when ``bwd``; otherwise that direction passes
    the tensor through."""

    @staticmethod
    def forward(ctx, x, group, fwd: bool, bwd: bool):
        ctx.group, ctx.bwd = group, bwd
        if not fwd:
            return x.view_as(x)
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        if ctx.bwd:
            g = g.clone()
            dist.all_reduce(g, group=ctx.group)
        return g, None, None, None


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str, *, grad: str) -> torch.Tensor:
    """``x`` summed over the ranks along ``axis`` (``x`` itself where the
    axis has size 1). ``grad`` says what reaches each rank's ``x`` in
    backward:

    - ``"identity"``: the rank's own cotangent. Right where every rank along
      the axis runs the same graph after the sum and each keeps its whole
      gradient (the MoE combine over ``ep``); a sum would scale it by the
      axis size.
    - ``"sum"``: the cotangents summed over the axis. Right where the
      ranks' gradients are later *averaged* over the axis (a global mean
      over ``dp``): after the average each rank holds the whole gradient.
    """
    if grad not in ("identity", "sum"):
        raise ValueError(f"grad must be 'identity' or 'sum', got {grad!r}")
    if mesh.size(axis) == 1:
        return x
    return _AllReduce.apply(x, mesh.group(axis), True, grad == "sum")


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, stacked in axis order:
    ``[size, *x.shape]``. Carries no gradient."""
    if mesh.size(axis) == 1:
        return x[None]
    flat = x.reshape(-1)
    out = flat.new_empty(mesh.size(axis) * flat.numel())
    dist.all_gather_into_tensor(out, flat, group=mesh.group(axis))
    return out.view(mesh.size(axis), *x.shape)


def grad_all_reduce(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``x`` unchanged, its gradient summed over the ranks along ``axis``:
    the entry to a region where each rank computes its own part of a
    result that :func:`all_reduce` (``grad="identity"``) then sums."""
    if mesh.size(axis) == 1:
        return x
    return _AllReduce.apply(x, mesh.group(axis), False, True)
