"""Logical-axis sharding rules. Port of ``ray_tpu/parallel/sharding.py``.

Model code annotates each parameter with *logical* axis names (e.g.
``("layers", "embed", "mlp")``); a rule table maps logical names to mesh axes.
Changing the parallelism strategy = changing the rule table, never the model.

The reference places a leaf as one global ``jax.Array`` and lets XLA insert
the collectives. Here each rank holds the **local shard** its rule gives
(:func:`shard_tree`), and the collectives the ported axes need are explicit
``torch.distributed`` calls over one axis's process group (or several axes'
in turn): :func:`all_reduce`, :func:`grad_all_reduce`, :func:`all_gather_dim`
and :func:`ppermute` carry their gradients through autograd;
:func:`all_reduce_`, :func:`all_gather`, :func:`reduce_scatter_dim` and
:func:`exchange` carry none. Each takes the tensors where they are: NCCL
and gloo both take CUDA tensors for every collective (gloo stages them
through host memory itself; checked on the card with torch 2.11).
Point-to-point is the exception: gloo's ``send``/``recv`` take CPU tensors
only, so under a gloo group :func:`exchange` stages a CUDA tensor through
pinned host memory itself (:func:`p2p_transport`), and NCCL sends it card
to card. The reference's ``constrain``
(``with_sharding_constraint`` inside jit) has no eager counterpart and is
not ported.
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

    def box(self, global_shape: Sequence[int]) -> tuple[tuple[int, int], ...]:
        """This rank's index box of an array of ``global_shape``: one
        ``(start, stop)`` per dim. Each split dim is cut into equal blocks,
        one per index along its axes, the first axis major, as
        ``jax.device_put`` lays out a NamedSharding; every other dim is
        whole. Raises ``ValueError`` where a dim does not split evenly."""
        shape = tuple(global_shape)
        out = []
        for dim, size in enumerate(shape):
            entry = self.spec[dim] if dim < len(self.spec) else None
            n, idx = 1, 0
            for a in _entry_axes(entry):
                idx = idx * self.mesh.size(a) + self.mesh.coordinate(a)
                n *= self.mesh.size(a)
            if size % n:
                raise ValueError(
                    f"dim {dim} of shape {shape} does not split into {n} blocks over {entry!r}"
                )
            block = size // n
            out.append((idx * block, (idx + 1) * block))
        return tuple(out)

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole array ``x`` (a view) under
        :meth:`box`."""
        for dim, (lo, hi) in enumerate(self.box(x.shape)):
            if hi - lo != x.shape[dim]:
                x = x.narrow(dim, lo, hi - lo)
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
# Collectives


def _split_axes(mesh: Mesh, axes: "str | Sequence[str]") -> list[str]:
    """The axes of ``axes`` (one name or several) that have size > 1."""
    return [a for a in ((axes,) if isinstance(axes, str) else axes) if mesh.size(a) > 1]


def all_reduce_(x: torch.Tensor, mesh: Mesh, axes, op: str = "sum") -> torch.Tensor:
    """Reduce the contiguous ``x`` in place over the ranks along each of
    ``axes`` in turn (``op``: ``"sum"`` or ``"max"``) and return it.
    Carries no gradient."""
    reduce_op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    for a in _split_axes(mesh, axes):
        dist.all_reduce(x, op=reduce_op, group=mesh.group(a))
    return x


class _AllReduce(torch.autograd.Function):
    """Sum over one axis's group in forward when ``fwd``, and of the
    gradient in backward when ``bwd``; otherwise that direction passes
    the tensor through."""

    @staticmethod
    def forward(ctx, x, group, fwd: bool, bwd: bool):
        ctx.group, ctx.bwd = group, bwd
        if not fwd:
            return x.view_as(x)
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        if ctx.bwd:
            g = g.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(g, group=ctx.group)
        return g, None, None, None


def all_reduce(x: torch.Tensor, mesh: Mesh, axes, *, grad: str) -> torch.Tensor:
    """``x`` summed over the ranks along ``axes`` (one axis name, or several
    summed in turn; ``x`` itself where they all have size 1). ``grad`` says
    what reaches each rank's ``x`` in backward:

    - ``"identity"``: the rank's own cotangent. Right where every rank along
      the axes runs the same graph after the sum and each keeps its whole
      gradient (the MoE combine over ``ep``, a row-split product over
      ``tp``); a sum would scale it by the axes' size.
    - ``"sum"``: the cotangents summed over the axes. Right where the
      ranks' gradients are later *averaged* over the axes (a global mean
      over ``dp`` and ``fsdp``): after the average each rank holds the
      whole gradient.
    """
    if grad not in ("identity", "sum"):
        raise ValueError(f"grad must be 'identity' or 'sum', got {grad!r}")
    for a in _split_axes(mesh, axes):
        x = _AllReduce.apply(x, mesh.group(a), True, grad == "sum")
    return x


def grad_all_reduce(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """``x`` unchanged, its gradient summed over the ranks along ``axes``:
    the entry to a region where each rank computes its own part of a
    result that :func:`all_reduce` (``grad="identity"``) then sums, or
    where each rank uses only its own part of a replicated ``x`` (Megatron's
    f to :func:`all_reduce`'s g)."""
    for a in _split_axes(mesh, axes):
        x = _AllReduce.apply(x, mesh.group(a), False, True)
    return x


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, stacked in axis order:
    ``[size, *x.shape]``. Carries no gradient."""
    if mesh.size(axis) == 1:
        return x[None]
    flat = x.reshape(-1)
    out = flat.new_empty(mesh.size(axis) * flat.numel())
    dist.all_gather_into_tensor(out, flat, group=mesh.group(axis))  # gloo wants a flat output
    return out.view(mesh.size(axis), *x.shape)


def reduce_scatter_dim(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """``x`` summed over the ranks along ``axis`` and cut along ``dim`` into
    one block per rank: this rank's block, ``x.shape[dim] / size`` long.
    Carries no gradient."""
    n = mesh.size(axis)
    if n == 1:
        return x
    front = x.movedim(dim, 0).contiguous()
    if front.shape[0] % n:
        raise ValueError(f"dim {dim} of shape {tuple(x.shape)} does not split into {n} blocks")
    out = front.new_empty(front.numel() // n)
    dist.reduce_scatter_tensor(out, front.view(-1), group=mesh.group(axis))
    return out.view(front.shape[0] // n, *front.shape[1:]).movedim(0, dim)


class _AllGatherDim(torch.autograd.Function):
    """Concatenate every rank's block along ``dim`` in axis order; the
    backward sums the cotangents over the axis and keeps this rank's block
    (a reduce-scatter), since each rank may use any part of the whole."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        n = mesh.size(axis)
        front = x.movedim(dim, 0)
        out = all_gather(front.contiguous(), mesh, axis)  # [n, *front.shape]
        return out.view(n * front.shape[0], *front.shape[1:]).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


def all_gather_dim(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """The whole tensor from every rank's block ``x`` along ``dim`` over
    ``axis`` (``x`` itself where the axis has size 1): the ZeRO-3 gather of
    a leaf split over ``fsdp``, or of column blocks split over ``tp``. Its
    gradient is the reduce-scatter (sum) of the whole tensor's."""
    if mesh.size(axis) == 1:
        return x
    return _AllGatherDim.apply(x, mesh, axis, dim % x.dim())


# ---------------------------------------------------------------------------
# Point to point: the ring exchange


def p2p_transport(mesh: Mesh, axis: str, device: torch.device) -> str:
    """How :func:`exchange` moves a tensor on ``device`` between the ranks
    along ``axis``: ``"nccl"`` (card to card), ``"gloo"`` (host tensors) or
    ``"gloo-host-staged"`` (a CUDA tensor copied to pinned host memory,
    exchanged, and copied back: gloo's point-to-point takes host tensors
    only)."""
    backend = dist.get_backend(mesh.group(axis))
    if backend == "gloo" and device.type == "cuda":
        return "gloo-host-staged"
    return str(backend)


def exchange(
    send: torch.Tensor | None,
    like: torch.Tensor | None,
    mesh: Mesh,
    axis: str,
    offset: int,
) -> torch.Tensor | None:
    """Send ``send`` to the rank ``offset`` places on along ``axis`` (mod
    its size) and return what the rank ``offset`` places back sent, into a
    tensor of ``like``'s shape, dtype and device. Either half may be None:
    no send, or nothing received (and None returned). The ranks' calls
    must pair up: a rank sends to the rank that receives from it in the
    same call. Both halves are posted together (``batch_isend_irecv``), so
    a ring of ranks never deadlocks on sends that wait for receives. A
    failed exchange raises. Carries no gradient."""
    n = mesh.size(axis)
    if n == 1 or offset % n == 0:
        return send if like is not None else None
    group, i = mesh.group(axis), mesh.coordinate(axis)
    ops, out = [], None
    if send is not None:
        send = send.contiguous()
        if p2p_transport(mesh, axis, send.device) == "gloo-host-staged":
            send = torch.empty(send.shape, dtype=send.dtype, pin_memory=True).copy_(send)
        peer = dist.get_global_rank(group, (i + offset) % n)
        ops.append(dist.P2POp(dist.isend, send, peer, group))
    if like is not None:
        staged = p2p_transport(mesh, axis, like.device) == "gloo-host-staged"
        out = torch.empty(like.shape, dtype=like.dtype, device="cpu" if staged else like.device,
                          pin_memory=staged)
        peer = dist.get_global_rank(group, (i - offset) % n)
        ops.append(dist.P2POp(dist.irecv, out, peer, group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if out is not None and out.device != like.device:
        out = out.to(like.device)
    return out


class _PPermute(torch.autograd.Function):
    """The ring :func:`exchange` by ``offset`` in forward; the cotangent
    sent back by ``-offset`` in backward (the transpose of a permutation)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, offset):
        ctx.mesh, ctx.axis, ctx.offset = mesh, axis, offset
        return exchange(x, x, mesh, axis, offset)

    @staticmethod
    def backward(ctx, g):
        return exchange(g, g, ctx.mesh, ctx.axis, -ctx.offset), None, None, None


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str, offset: int = 1) -> torch.Tensor:
    """``x`` of the rank ``offset`` places back along ``axis`` (``x``
    itself where the axis has size 1): every rank sends its ``x`` to the
    rank ``offset`` places on. The counterpart of ``jax.lax.ppermute`` with
    ``perm=[(i, (i + offset) % n)]``. Its gradient travels the ring the
    other way. Every rank along the axis must call it, in the same order
    as the others, forward and backward."""
    if mesh.size(axis) == 1:
        return x
    return _PPermute.apply(x, mesh, axis, offset)
