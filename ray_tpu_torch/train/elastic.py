"""Elastic training plane — live re-formation without a checkpoint restore.
Port of ``ray_tpu/train/elastic.py``.

The seam that makes the train world size a variable: when membership
changes (a node drains under a preemption notice, or capacity comes back),
the controller pauses every rank at its next step boundary, re-derives the
two-level topology at the new world size, and moves the step-boundary
state to wherever the new ranks need it peer-to-peer over the transfer
fabric — the `sharded_checkpoint` reshape math applied peer-to-peer, with
zero checkpoint-storage reads and zero `FailureConfig.max_failures` burn.

Three pieces live here:

- the **pause signal** (:class:`ElasticPauseSignal`): raised out of
  ``train.report()`` AFTER the completed step's state is retained, so the
  worker thread unwinds at a clean boundary (a ``BaseException`` — user
  ``except Exception`` blocks must not swallow it);
- the **reshard plan math** (:func:`shard_rows` / :func:`plan_reshard`):
  which fragments of which old rank's dim0 shard cover each new rank's
  range — pure functions, unit-tested independently of the fabric;
- the **fabric state movement** (:func:`snapshot_state` /
  :func:`hydrate_state`): arm a paused rank's boundary state for peer
  pulls, and reassemble a new rank's state from donor descriptors
  (replicated layout reuses a local copy zero-copy; sharded layout
  concatenates pulled fragments with ``torch.cat``). The state is flattened
  with a picklable tree spec (:mod:`ray_tpu_torch.train._tree`): tensor and
  numpy leaves travel over the fabric, host scalars inside the spec; a
  pulled leaf that was on a card lands on the card this rank trains on
  (:func:`ray_tpu_torch.train.torch_backend.train_device`).

The whole plane sits behind ``GLOBAL_CONFIG.elastic_train``
(RAY_TPU_ELASTIC_TRAIN=0): off, the controller's
rebuild-from-checkpoint path runs byte-identically.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional

from ray_tpu_torch.train import _tree
from ray_tpu_torch.util import metrics as _metrics

# Elastic telemetry: reshapes by kind (shrink = survivors re-form smaller,
# grow = joiners hydrate at a boundary, fallback = a live reshape was
# abandoned for the checkpoint-restore path), bytes moved peer-to-peer by
# hydration pulls, and the gang's current world size.
_RESHAPES = _metrics.Counter(
    "raytpu_train_reshapes_total",
    "elastic worker-group re-formations by kind (shrink/grow/fallback)",
    tag_keys=("kind",),
)
_RESHARD_BYTES = _metrics.Counter(
    "raytpu_train_reshard_bytes_total",
    "bytes of train state pulled peer-to-peer during elastic hydration",
)
_WORLD_SIZE = _metrics.Gauge(
    "raytpu_train_world_size",
    "current train worker-group world size (updated on every reshape)",
)

REPLICATED = "replicated"
SHARDED = "sharded"


class ElasticPauseSignal(BaseException):
    """Unwinds the user train fn at a step boundary (elastic pause).

    Raised by ``TrainContext.report()`` after the step's report and
    ``elastic_state`` are captured. A ``BaseException`` so a user loop's
    ``except Exception`` cannot swallow the pause; the worker thread
    catches it and parks in the ``paused`` state with its context (and
    the retained boundary state) intact."""


def count_reshape(kind: str) -> None:
    if _metrics.metrics_enabled():
        _RESHAPES.inc(1.0, {"kind": kind})


def set_world_size(n: int) -> None:
    if _metrics.metrics_enabled():
        _WORLD_SIZE.set(float(n))


# -- recovery probe ------------------------------------------------------------

_recovery_lock = threading.Lock()
_last_recovery_ms: Optional[float] = None


def record_recovery_ms(ms: float) -> None:
    """Stamp one preempt-to-first-post-reshape-step measurement (the
    controller calls this when the first report after a membership change
    arrives — on the elastic path AND on the checkpoint-restore fallback,
    so both arms measure the same interval)."""
    global _last_recovery_ms
    with _recovery_lock:
        _last_recovery_ms = float(ms)


def last_recovery_ms() -> Optional[float]:
    with _recovery_lock:
        return _last_recovery_ms


# -- reshard plan math -------------------------------------------------------


def shard_rows(n_rows: int, world: int) -> list[tuple[int, int]]:
    """Balanced dim0 split: rank r's (start, stop) row range. The first
    ``n_rows % world`` ranks take one extra row (np.array_split order), so
    any length reshards cleanly — no divisibility requirement."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    base, extra = divmod(int(n_rows), world)
    out = []
    start = 0
    for r in range(world):
        stop = start + base + (1 if r < extra else 0)
        out.append((start, stop))
        start = stop
    return out


def plan_reshard(
    n_rows: int, old_world: int, new_world: int
) -> list[list[tuple[int, int, int]]]:
    """For each NEW rank: the fragments ``(old_rank, start, stop)`` —
    coordinates LOCAL to the old rank's shard — whose concatenation (in
    list order) is exactly the new rank's row range. This is the
    restore-onto-any-mesh math of ``sharded_checkpoint.restore_template``
    expressed as peer-to-peer segments instead of a storage round trip."""
    old = shard_rows(n_rows, old_world)
    new = shard_rows(n_rows, new_world)
    plans: list[list[tuple[int, int, int]]] = []
    for n_start, n_stop in new:
        frags: list[tuple[int, int, int]] = []
        for old_rank, (o_start, o_stop) in enumerate(old):
            lo = max(n_start, o_start)
            hi = min(n_stop, o_stop)
            if lo < hi:
                frags.append((old_rank, lo - o_start, hi - o_start))
        plans.append(frags)
    return plans


# -- fabric state movement ---------------------------------------------------


def _is_array(leaf: Any) -> bool:
    import numpy as np
    import torch

    return isinstance(leaf, (torch.Tensor, np.ndarray))


def flatten_state(state: Any) -> tuple[list, Any]:
    """``(leaves, spec)`` of a boundary state: its tensor and numpy leaves
    (what travels over the fabric), and a picklable spec of the rest."""
    return _tree.flatten(state, _is_array)


def leaf_rows(leaves: list) -> list:
    """Each leaf's dim0 length (None for a 0-d leaf) — what
    :func:`plan_reshard` needs."""
    return [int(leaf.shape[0]) if len(leaf.shape) else None for leaf in leaves]


def snapshot_state(state: Any) -> dict:
    """Arm a paused rank's boundary state for one peer pull. Returns the
    snapshot descriptor the controller hands to hydrating ranks: the
    fabric group-pull descriptor plus the tree spec and per-leaf dim0
    lengths (what ``plan_reshard`` needs). Each call stages a fresh arm —
    one descriptor serves exactly one puller."""
    import cloudpickle

    from ray_tpu_torch.experimental.transfer import fabric

    leaves, spec = flatten_state(state)
    desc = fabric().arm_group(leaves)
    return {
        "desc": desc,
        "treedef": cloudpickle.dumps(spec),
        "leaf_rows": leaf_rows(leaves),
    }


def _chaos_gate(new_rank: int) -> None:
    """Seeded elastic chaos: consulted once per hydration pull. ``sever``
    fails the pull (the controller falls back to checkpoint restore);
    ``delay`` sleeps it."""
    from ray_tpu_torch.core import faults

    inj = faults.active()
    if inj is None:
        return
    rule = inj.decide(
        "elastic", f"r{new_rank}", actions=frozenset({"sever", "delay"})
    )
    if rule is None:
        return
    if rule.action == "sever":
        from ray_tpu_torch.core.errors import FaultInjectedError

        raise FaultInjectedError(
            f"elastic.sever: injected reshard pull failure "
            f"(rank {new_rank})"
        )
    if rule.delay_s > 0:
        time.sleep(min(rule.delay_s, 3600.0))


def _landed(tensors: list, specs: list) -> list:
    """Each pulled member on the device it trains on: one that left a card
    lands on this rank's training card, a host one stays on the host."""
    from ray_tpu_torch.train.torch_backend import train_device

    dev = None
    out = []
    for t, spec in zip(tensors, specs):
        if spec.get("device", "cpu") == "cuda":
            dev = dev or train_device("cuda")
            t = t.to(dev, non_blocking=True)
        out.append(t)
    return out


def hydrate_state(
    snapshots: dict[int, dict],
    mode: str,
    new_rank: int,
    new_world: int,
    old_world: int,
    leaf_totals: Optional[list] = None,
) -> Any:
    """Reassemble this new rank's boundary state from donor snapshots.

    ``snapshots`` maps OLD rank -> :func:`snapshot_state` descriptor.
    Replicated mode needs exactly one donor (any boundary rank's full
    copy). Sharded mode needs the old ranks whose dim0 shards overlap
    this rank's new range (the controller computes that set from
    :func:`plan_reshard` so non-overlapping peers are never pulled);
    ``leaf_totals`` carries each leaf's GLOBAL dim0 length (None for a
    leaf that is replicated/0-d rather than sharded). Each donor's
    leaves are pulled once, then the overlapping fragments concatenate
    per leaf in old-rank order (``torch.cat``)."""
    import cloudpickle
    import torch

    from ray_tpu_torch.experimental.transfer import fabric

    _chaos_gate(new_rank)
    pulled: dict[int, list] = {}
    nbytes = 0
    for old_rank, snap in snapshots.items():
        tensors = fabric().pull_group(snap["desc"])
        nbytes += sum(t.numel() * t.element_size() for t in tensors)
        pulled[old_rank] = _landed(tensors, snap["desc"]["specs"])
    if _metrics.metrics_enabled() and nbytes:
        _RESHARD_BYTES.inc(float(nbytes))
    any_snap = next(iter(snapshots.values()))
    spec = cloudpickle.loads(any_snap["treedef"])
    any_leaves = pulled[next(iter(pulled))]
    if mode == REPLICATED:
        return _tree.unflatten(spec, any_leaves)
    if mode != SHARDED:
        raise ValueError(f"unknown elastic layout {mode!r}")
    if leaf_totals is None or len(leaf_totals) != len(any_leaves):
        raise ValueError("sharded hydration needs per-leaf global lengths")
    out_leaves = []
    for li, total in enumerate(leaf_totals):
        if total is None:
            # Replicated (or 0-d) leaf: any donor's copy is the value.
            out_leaves.append(any_leaves[li])
            continue
        frags = plan_reshard(int(total), old_world, new_world)[new_rank]
        parts = [pulled[r][li][start:stop] for r, start, stop in frags]
        out_leaves.append(parts[0] if len(parts) == 1 else torch.cat(parts, dim=0))
    return _tree.unflatten(spec, out_leaves)
