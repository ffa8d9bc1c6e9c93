"""The training step, on one GPU or over a mesh. Port of ``ray_tpu/train/spmd.py``.

The reference jits ``step(state, batch)`` with the state donated, over a
mesh with sharded params, and XLA inserts the collectives. This port runs
eagerly: forward, backward (``torch.autograd.grad``), global-norm clipping
and AdamW, then ``step + 1``. The state is updated **in place**, the
counterpart of donation: params and optimizer moments are never held twice.

Over a mesh (:mod:`ray_tpu_torch.parallel`; every axis: pp, dp, fsdp, ep,
sp and tp) each rank holds the local shard of each leaf that its sharding
gives, takes its rows of the global batch (split over dp x fsdp; under sp
the model takes its block of the sequence), and runs the collectives
itself: every gradient is averaged over dp x fsdp x sp x pp (a leaf split
over fsdp already holds the sum over fsdp, from its gather's
reduce-scatter, and a pipeline stage's layers are its own), the global
norm sums each shard's squares once, and the metrics are the global ones.
The models sum the tp and ep parts of a gradient themselves. The result
is the reference's global-view step.

Not ported: a compiled step. ``compile_train_step`` returns the step as it
is, with no flop count.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from ray_tpu_torch.parallel.mesh import Mesh, check_mesh
from ray_tpu_torch.parallel.sharding import NamedSharding, PartitionSpec, all_reduce_, shard_tree
from ray_tpu_torch.util.device import resolve_device, set_exact_matmul

# TrainState is a plain dict: {"params", "opt_state", "step", "shardings"}.
# "step" and the optimizer's "count" are host ints, so the schedule needs
# no device readback; "shardings" is the params' sharding tree, or None.
TrainState = dict

_EPS = 1e-8  # Adam's epsilon, outside the square root (optax.adamw's default)


def tree_leaves(tree: dict) -> list[torch.Tensor]:
    """The tensors of a nested dict in sorted-key order (jax.tree's order)."""
    out = []
    for key in sorted(tree):
        node = tree[key]
        out += tree_leaves(node) if isinstance(node, dict) else [node]
    return out


def _tree_map(fn: Callable, tree: dict) -> dict:
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


@dataclasses.dataclass(frozen=True)
class AdamW:
    """Global-norm clipping, then AdamW under a warmup-cosine schedule: the
    arithmetic of the reference's optax chain, ``clip_by_global_norm`` then
    ``adamw(warmup_cosine_decay_schedule(...))``.

    - Clipping is ``g / norm * max_norm`` only when ``norm >= max_norm``,
      with no epsilon (``torch.nn.utils.clip_grad_norm_`` adds 1e-6).
    - Update ``t`` (from 0) uses ``schedule(t)``: the first is zero.
    - Adam with bias correction, ``eps`` outside the square root and none
      inside; weight decay on every leaf, scaled by the scheduled rate.
    """

    lr: float
    weight_decay: float
    warmup_steps: int
    total_steps: int
    b1: float
    b2: float
    grad_clip: float

    def schedule(self, count: int) -> float:
        """optax.warmup_cosine_decay_schedule(init_value=0, peak_value=lr,
        warmup_steps, decay_steps=max(total_steps, warmup_steps + 1),
        end_value=lr * 0.1) at ``count``."""
        w, peak = self.warmup_steps, self.lr
        if count < w:
            return (0.0 - peak) * (1.0 - min(count, w) / w) + peak
        alpha = peak * 0.1 / peak if peak else 0.0
        decay = max(self.total_steps, w + 1) - w
        cosine = 0.5 * (1.0 + math.cos(math.pi * min(count - w, decay) / decay))
        return peak * ((1.0 - alpha) * cosine + alpha)

    def init(self, params: dict) -> dict:
        return {
            "count": 0,
            "mu": _tree_map(torch.zeros_like, params),
            "nu": _tree_map(torch.zeros_like, params),
        }

    @torch.no_grad()
    def update_(
        self, grads: list, opt_state: dict, params: list, norm: torch.Tensor | None = None
    ) -> None:
        """Apply one update to ``params`` (leaves in :func:`tree_leaves`
        order) and ``opt_state``, in place. ``norm`` is the gradients'
        global norm, where the caller has it from sharded leaves; by
        default, that of ``grads``."""
        lr = self.schedule(opt_state["count"])
        count = opt_state["count"] + 1
        if norm is None:
            norm = global_norm(grads, None, None)
        keep = norm < self.grad_clip
        bc1, bc2 = 1.0 - self.b1**count, 1.0 - self.b2**count
        moments = zip(tree_leaves(opt_state["mu"]), tree_leaves(opt_state["nu"]))
        for p, g, (mu, nu) in zip(params, grads, moments):
            g = torch.where(keep, g, g / norm * self.grad_clip)
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            u = (mu / bc1) / ((nu / bc2).sqrt_() + _EPS)
            p.add_(u.add_(p, alpha=self.weight_decay), alpha=-lr)
        opt_state["count"] = count


def default_optimizer(
    lr: float = 3e-4,
    *,
    weight_decay: float = 0.1,
    warmup_steps: int = 100,
    total_steps: int = 10_000,
    b1: float = 0.9,
    b2: float = 0.95,
    grad_clip: float = 1.0,
) -> AdamW:
    """AdamW + cosine schedule + global-norm clipping (GPT-2 training recipe)."""
    return AdamW(lr, weight_decay, warmup_steps, total_steps, b1, b2, grad_clip)


def make_train_state(
    init_params_fn: Callable[[torch.Generator], dict],
    optimizer: AdamW,
    generator: torch.Generator,
    device: "str | torch.device" = "cuda",
    *,
    param_shardings: Any | None = None,
) -> TrainState:
    """Params from ``init_params_fn(generator)`` on ``device`` (the card
    unless the caller asks for ``"cpu"``), as leaves that require grad, and
    the optimizer's zeroed state beside them. Sets the process's matmul
    precision as the engine does (:func:`set_exact_matmul`).

    With ``param_shardings`` (a tree of
    :class:`~ray_tpu_torch.parallel.NamedSharding`) every rank draws the
    whole tree from the same generator and keeps its own shard of each
    leaf, so the values equal the unsharded ones. The state keeps the
    shardings under ``"shardings"`` (None when unsharded)."""
    device = resolve_device(device)
    set_exact_matmul()
    params = _tree_map(lambda t: t.detach().to(device), init_params_fn(generator))
    if param_shardings is not None:
        params = shard_tree(params, param_shardings)
    params = _tree_map(lambda t: t.requires_grad_(True), params)
    return {
        "params": params,
        "opt_state": optimizer.init(params),
        "step": 0,
        "shardings": param_shardings,
    }


def state_shardings(state: TrainState) -> dict:
    """The sharding of every leaf of a live state, in its layout (for a
    checkpoint restored onto the same mesh): each param and its two
    moments share one; the host-int counters have none (None), and so has
    every leaf of an unsharded state."""
    params = state["params"]
    shardings = state["shardings"] or _tree_map(lambda _: None, params)
    return {
        "params": shardings,
        "opt_state": {"count": None, "mu": shardings, "nu": shardings},
        "step": None,
    }


def _leaf_axes(shardings: Any, n_leaves: int) -> list[frozenset]:
    """The mesh axes each leaf (in :func:`tree_leaves` order) is split over."""
    if shardings is None:
        return [frozenset()] * n_leaves
    return [s.axes for s in tree_leaves(shardings)]


def _averaging_axes(mesh: Mesh) -> list[str]:
    """The mesh axes of size > 1 over which every gradient is averaged:
    the batch axes (dp, fsdp), whose ranks hold other rows; ``sp``, whose
    ranks hold other positions of the same rows; and ``pp``, whose ranks
    all compute the same loss (the pipeline broadcasts the last stage's
    output). The models sum over tp and ep themselves."""
    return [a for a in (*mesh.spec.batch_axes, "sp", "pp") if mesh.size(a) > 1]


def _row_spec(batch_spec: PartitionSpec) -> PartitionSpec:
    """``batch_spec`` without ``sp``: the model takes its sequence block
    itself (after the next-token shift), so the batch leaves are split by
    rows only."""
    return PartitionSpec(*(
        tuple(a for a in ((e,) if isinstance(e, str) else e) if a != "sp") or None
        if e is not None else None
        for e in batch_spec
    ))


def _check_seq_split(batch: dict, batch_spec: PartitionSpec, mesh: Mesh) -> None:
    """Raise ``ValueError`` where ``batch_spec`` splits the sequence over
    ``sp`` and the sequence (after the shift of the ``{"tokens": [B, S+1]}``
    form) does not divide into ``sp`` blocks, as placing such a batch
    fails in the reference."""
    if mesh.size("sp") == 1 or len(batch_spec) < 2:
        return
    entry = batch_spec[1]
    if entry is None or "sp" not in ((entry,) if isinstance(entry, str) else entry):
        return
    form = "targets" in batch
    S = batch["tokens"].shape[1] - (0 if form else 1)
    if S % mesh.size("sp"):
        shape = '{"tokens", "targets"}' if form else '{"tokens": [B, S+1]}'
        raise ValueError(
            f"batch_spec {batch_spec!r} splits the sequence over sp={mesh.size('sp')}, and the "
            f"{shape} batch has S={S} positions"
        )


def make_grad_fn(
    loss_fn: Callable[[dict, Any], tuple[torch.Tensor, dict]],
    *,
    mesh: Mesh | None = None,
    batch_spec: PartitionSpec | None = None,
) -> Callable[[dict, Any, Any], tuple[dict, list]]:
    """The gradient half of the step: ``fn(params, batch, shardings) ->
    (metrics, grads)``, grads in :func:`tree_leaves` order.

    Over a mesh, this rank takes its rows of every batch leaf under
    ``batch_spec`` (by default the batch dim over ``MeshSpec.batch_axes``,
    dp major, as the reference's ``P(("dp", "fsdp"))``), so ``loss_fn``'s
    mean is over its own rows. A spec that also splits dim 1 over ``sp``
    (the reference's ``P(("dp", "fsdp"), "sp")``) is taken as it is meant:
    under ``sp`` the model takes the rank's block of the sequence itself,
    after the next-token shift, so the rows reach it whole (an ``sp`` the
    sequence does not divide into raises ``ValueError``, as in the
    reference); with the default spec it does the same.

    Every gradient is averaged over :func:`_averaging_axes` (dp, fsdp, sp,
    pp): a leaf that ``shardings`` splits over an axis holds its sum over
    that axis already (an fsdp gather's backward is a reduce-scatter; each
    pipeline stage holds only its own layers), so it is summed over the
    others only. No leaf is reduced twice. ``metrics["loss"]`` becomes the
    mean over the same axes and ``metrics["tokens"]`` the global count (a
    model under ``sp`` counts its sequence blocks itself); other metrics
    (``moe_aux``) are global already."""
    if mesh is not None:
        check_mesh(mesh)
        spec = batch_spec if batch_spec is not None else PartitionSpec(mesh.spec.batch_axes)
        batch_sharding = NamedSharding(mesh, _row_spec(spec))
        axes = _averaging_axes(mesh)
    else:
        axes = []
    shards = math.prod(mesh.size(a) for a in axes)
    batch_shards = math.prod(mesh.size(a) for a in axes if a in ("dp", "fsdp"))

    def grad_fn(params: dict, batch: Any, shardings: Any) -> tuple[dict, list]:
        if mesh is not None:
            _check_seq_split(batch, spec, mesh)
            batch = {k: batch_sharding.shard(v) for k, v in batch.items()}
        leaves = tree_leaves(params)
        loss, metrics = loss_fn(params, batch)
        grads = list(torch.autograd.grad(loss, leaves))
        if not axes:
            return metrics, grads
        for i, split in enumerate(_leaf_axes(shardings, len(grads))):
            grads[i] = grads[i].contiguous()  # a collective takes a dense buffer
            all_reduce_(grads[i], mesh, [a for a in axes if a not in split])
            grads[i].div_(shards)
        metrics = dict(metrics)
        metrics["loss"] = all_reduce_(metrics["loss"].clone(), mesh, axes) / shards
        metrics["tokens"] = metrics["tokens"] * batch_shards
        return metrics, grads

    return grad_fn


def global_norm(grads: list, shardings: Any, mesh: Mesh | None) -> torch.Tensor:
    """The global norm of a tree of gradients held as local shards: the
    squares of a leaf are summed over every axis that splits it (fsdp, tp,
    ep), so a replicated leaf counts once. Every rank gets the same value."""
    by_axes: dict[tuple, list] = {}
    for g, axes in zip(grads, _leaf_axes(shardings, len(grads))):
        by_axes.setdefault(tuple(sorted(axes)), []).append(g.square().sum())
    total = None
    for axes in sorted(by_axes):  # () first: the replicated leaves
        part = torch.stack(by_axes[axes]).sum()
        if axes:
            all_reduce_(part, mesh, axes)
        total = part if total is None else total + part
    return total.sqrt()


def make_train_step(
    loss_fn: Callable[[dict, Any], tuple[torch.Tensor, dict]],
    optimizer: AdamW,
    *,
    mesh: Mesh | None = None,
    batch_spec: PartitionSpec | None = None,
    param_shardings: Any | None = None,
    donate_batch: bool = False,
    donate_state: bool = True,
) -> Callable[[TrainState, Any], tuple[TrainState, dict]]:
    """Build ``step(state, batch) -> (state, metrics)``.

    ``loss_fn(params, batch)`` returns ``(scalar_loss, metrics)``; a model
    under a mesh with fsdp, ep, sp, tp or pp above 1 (or any MoE model) takes the
    mesh itself (``functools.partial(gpt2.loss_fn, cfg=cfg, mesh=mesh)``). The step
    updates ``state`` in place and returns it with the metrics, which stay
    on the device: nothing in the step waits for the card.

    ``mesh`` (any of pp, dp, fsdp, ep, sp and tp): ``batch`` is the
    **global** batch, as the reference's jitted step takes it; see
    :func:`make_grad_fn` for the rows each rank takes and the averages.
    ``param_shardings`` is the tree the state was made with (by default
    ``state["shardings"]``). The donation flags are the reference's and
    change nothing: the state is always updated in place, and the batch
    is never written."""
    del donate_batch, donate_state
    grad_fn = make_grad_fn(loss_fn, mesh=mesh, batch_spec=batch_spec)

    def step(state: TrainState, batch: Any) -> tuple[TrainState, dict]:
        shardings = param_shardings if param_shardings is not None else state["shardings"]
        metrics, grads = grad_fn(state["params"], batch, shardings)
        norm = global_norm(grads, shardings, mesh)
        optimizer.update_(grads, state["opt_state"], tree_leaves(state["params"]), norm=norm)
        state["step"] += 1
        return state, metrics

    return step


def compile_train_step(
    step: Callable, state: TrainState, batch: Any
) -> tuple[Callable, float | None]:
    """The reference AOT-compiles the jitted step for these shapes and reads
    its flop count from the executable's cost model. Eager PyTorch has
    neither: this returns ``(step, None)``, the reference's own answer
    where the backend reports no cost model."""
    del state, batch
    return step, None
