"""Device meshes over ``torch.distributed``. Port of ``ray_tpu/parallel/mesh.py``.

The reference lays every parallelism strategy (data, fully-sharded data,
tensor, sequence, pipeline, expert) out as a named axis of one JAX mesh, and
XLA inserts the collectives. Here a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis names
in its order, over the process group the caller has started, and the port's
code issues each collective itself, over the process group of one axis.

:class:`Mesh` carries the reference's ``mesh.shape`` mapping (axis name ->
size) beside the ``DeviceMesh``, so the logical rules
(:mod:`ray_tpu_torch.parallel.sharding`) stay pure functions of the shape.
A ``Mesh`` whose axes all have size 1 needs no ``DeviceMesh`` at all
(:func:`local_mesh`): nothing is ever communicated over a size-1 axis.

The port runs every axis: ``dp``, ``fsdp``, ``ep`` and ``tp`` as the
earlier slices did, ``sp`` (ring attention) and ``pp`` (the GPipe
schedule). :func:`check_mesh` only checks that a model was given a
:class:`Mesh`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch.distributed as dist

# Outer -> inner, as in the reference: the outermost axes tolerate the most
# latency (pipeline, data), the innermost need the tightest coupling (tensor).
AXIS_NAMES = ("pp", "dp", "fsdp", "ep", "sp", "tp")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Sizes for each parallelism axis. Product must equal the device count.

    dp:   pure data parallel (gradients all-reduced)
    fsdp: data parallel with parameters sharded (ZeRO-3 style)
    tp:   tensor parallel (megatron-style sharded matmuls)
    sp:   sequence/context parallel (ring attention over this axis)
    pp:   pipeline parallel (layer stages)
    ep:   expert parallel (MoE experts)
    """

    pp: int = 1
    dp: int = 1
    fsdp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    @property
    def num_devices(self) -> int:
        return self.pp * self.dp * self.fsdp * self.ep * self.sp * self.tp

    def sizes(self) -> tuple[int, ...]:
        return tuple(getattr(self, name) for name in AXIS_NAMES)

    def asdict(self) -> dict[str, int]:
        return {name: getattr(self, name) for name in AXIS_NAMES}

    @property
    def batch_axes(self) -> tuple[str, ...]:
        """Mesh axes the global batch dimension is sharded over."""
        return ("dp", "fsdp")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A :class:`MeshSpec` and the ``DeviceMesh`` laid out from it.

    ``device_mesh`` is None for a mesh that only names a shape: one of a
    single rank (:func:`local_mesh`), or one that the rule logic reads and
    no collective runs over. Asking such a mesh for a rank's coordinate or
    an axis's process group on an axis of size > 1 raises."""

    spec: MeshSpec
    device_mesh: Any = None  # torch.distributed.device_mesh.DeviceMesh

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as the reference's ``mesh.shape``."""
        return self.spec.asdict()

    @property
    def axis_names(self) -> tuple[str, ...]:
        return AXIS_NAMES

    def size(self, axis: str) -> int:
        return getattr(self.spec, axis)

    def _require(self, axis: str) -> Any:
        if self.device_mesh is None:
            raise ValueError(
                f"axis {axis!r} has size {self.size(axis)} but this mesh has no "
                "DeviceMesh: build it with make_mesh over a started process group"
            )
        return self.device_mesh

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 on an axis of size 1)."""
        if self.size(axis) == 1:
            return 0
        return self._require(axis).get_local_rank(axis)

    def group(self, axis: str) -> Any:
        """The process group of this rank's ranks along ``axis``."""
        return self._require(axis).get_group(axis)


def make_mesh(spec: MeshSpec, device_type: str = "cuda") -> Mesh:
    """A :class:`Mesh` laying ``spec`` over the ranks of the default process
    group, which the caller has started (``torch.distributed.init_process_group``;
    NCCL for ``"cuda"``, gloo for ``"cpu"``). Ranks fill the mesh in row-major
    order over ``AXIS_NAMES``, as the reference reshapes its device list.
    Raises when ``spec`` wants another number of devices than the world has."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a started process group (torch.distributed.init_process_group); "
            "local_mesh() is the one-rank mesh that needs none"
        )
    world = dist.get_world_size()
    if spec.num_devices != world:
        raise ValueError(
            f"MeshSpec {spec.asdict()} wants {spec.num_devices} devices, got {world}"
        )
    from torch.distributed.device_mesh import init_device_mesh

    return Mesh(spec, init_device_mesh(device_type, spec.sizes(), mesh_dim_names=AXIS_NAMES))


def local_mesh() -> Mesh:
    """A trivial mesh of one rank: every axis has size 1, so it needs no
    process group and nothing runs over it."""
    return Mesh(MeshSpec())


def check_mesh(mesh: Any) -> None:
    """Raise ``TypeError`` unless ``mesh`` is a :class:`Mesh` (a JAX mesh,
    say, has no process groups to run over)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"expected a ray_tpu_torch.parallel.Mesh, got {type(mesh).__name__}")


def _largest_factor_leq(n: int, cap: int) -> int:
    for f in range(min(cap, n), 0, -1):
        if n % f == 0:
            return f
    return 1


def auto_spec(
    n_devices: int,
    *,
    max_tp: int = 4,
    max_sp: int = 2,
    want_fsdp: bool = True,
) -> MeshSpec:
    """Heuristic mesh shape for `n_devices`: tp innermost up to `max_tp`,
    an sp axis if it fits, remaining devices split between dp and fsdp.

    Examples: 8 -> (sp=2, tp=4); 4 -> (tp=4); 32 -> (dp=2, fsdp=2, sp=2, tp=4);
    16 -> (fsdp=2, sp=2, tp=4).
    """
    if n_devices < 1:
        raise ValueError("n_devices must be >= 1")
    remaining = n_devices
    tp = _largest_factor_leq(remaining, max_tp)
    remaining //= tp
    sp = _largest_factor_leq(remaining, max_sp)
    remaining //= sp
    if want_fsdp and remaining > 1:
        # Split the residue between fsdp and dp; favor fsdp for memory, keep a
        # dp axis when the residue is large and even.
        if remaining >= 4 and remaining % 2 == 0:
            dp = 2
            fsdp = remaining // 2
        else:
            dp = 1
            fsdp = remaining
    else:
        dp = remaining
        fsdp = 1
    spec = MeshSpec(dp=dp, fsdp=fsdp, sp=sp, tp=tp)
    assert spec.num_devices == n_devices, (spec, n_devices)
    return spec
