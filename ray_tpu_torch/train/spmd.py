"""The training step on one GPU. Port of ``ray_tpu/train/spmd.py``.

The reference jits ``step(state, batch)`` with the state donated, over a
mesh with sharded params. This port runs eagerly on one device: forward,
backward (``torch.autograd.grad``), global-norm clipping and AdamW, then
``step + 1``. The state is updated **in place**, the counterpart of
donation: params and optimizer moments are never held twice.

Not ported yet: ``state_shardings``, ``compile_train_step``, meshes and
batch/param shardings (data parallelism, FSDP).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from ray_tpu_torch.util.device import resolve_device, set_exact_matmul

# TrainState is a plain dict: {"params", "opt_state", "step"}. "step" and
# the optimizer's "count" are host ints, so the schedule needs no device
# readback.
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
    def update_(self, grads: list, opt_state: dict, params: list) -> None:
        """Apply one update to ``params`` (leaves in :func:`tree_leaves`
        order) and ``opt_state``, in place."""
        lr = self.schedule(opt_state["count"])
        count = opt_state["count"] + 1
        norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
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
) -> TrainState:
    """Params from ``init_params_fn(generator)`` on ``device`` (the card
    unless the caller asks for ``"cpu"``), as leaves that require grad, and
    the optimizer's zeroed state beside them. Sets the process's matmul
    precision as the engine does (:func:`set_exact_matmul`)."""
    device = resolve_device(device)
    set_exact_matmul()
    params = _tree_map(
        lambda t: t.detach().to(device).requires_grad_(True), init_params_fn(generator)
    )
    return {"params": params, "opt_state": optimizer.init(params), "step": 0}


def make_train_step(
    loss_fn: Callable[[dict, Any], tuple[torch.Tensor, dict]],
    optimizer: AdamW,
) -> Callable[[TrainState, Any], tuple[TrainState, dict]]:
    """Build ``step(state, batch) -> (state, metrics)``.

    ``loss_fn(params, batch)`` returns ``(scalar_loss, metrics)``. The step
    updates ``state`` in place and returns it with ``loss_fn``'s metrics,
    which stay on the device: nothing in the step waits for the card.
    """

    def step(state: TrainState, batch: Any) -> tuple[TrainState, dict]:
        leaves = tree_leaves(state["params"])
        loss, metrics = loss_fn(state["params"], batch)
        grads = torch.autograd.grad(loss, leaves)
        optimizer.update_(grads, state["opt_state"], leaves)
        state["step"] += 1
        return state, metrics

    return step
