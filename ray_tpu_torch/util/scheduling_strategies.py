"""Scheduling strategies for tasks and actors.
Port of ``ray_tpu/util/scheduling_strategies.py``.

Reference parity: python/ray/util/scheduling_strategies.py —
PlacementGroupSchedulingStrategy, NodeAffinitySchedulingStrategy,
NodeLabelSchedulingStrategy. These are declarative objects translated at
submit time: placement-group strategies rewrite resource demands onto the
group's formatted resources; affinity strategies map onto the scheduler's
node-affinity policies; label strategies merge into the label selector.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class PlacementGroupSchedulingStrategy:
    """Place the task/actor inside a reserved placement-group bundle.

    ``placement_group_bundle_index`` of -1 means "any bundle of the group"
    (the wildcard formatted resources); >= 0 pins to that bundle.
    """

    placement_group: Any
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False


@dataclass
class NodeAffinitySchedulingStrategy:
    """Pin to a node by id. ``soft=True`` falls back to the default policy if
    the node cannot take the work; ``soft=False`` fails instead."""

    node_id: str
    soft: bool = False

    def to_policy(self) -> str:
        prefix = "node_affinity" if self.soft else "strict_node_affinity"
        return f"{prefix}:{self.node_id}"


@dataclass
class NodeLabelSchedulingStrategy:
    """Schedule only onto nodes whose labels match ``hard`` (exact /
    ("in", [...]) / ("not_in", [...]) / ("exists",) conditions); among those,
    prefer nodes also matching ``soft`` (falls back when none fit)."""

    hard: dict = field(default_factory=dict)
    soft: dict = field(default_factory=dict)


def resolve_strategy(
    opts: dict,
    resources: dict,
    label_selector: Optional[dict],
) -> tuple[dict, dict, dict, str, Optional[tuple]]:
    """Translate scheduling options into (resources, label_selector,
    soft_label_selector, policy, pg_info) where pg_info is
    (pg_id, capture_child_tasks) or None. Accepts
    ``scheduling_strategy=`` objects or the legacy ``placement_group=`` /
    ``placement_group_bundle_index=`` options. With no explicit strategy, a
    task submitted from inside a capture_child_tasks placement group inherits
    that group (reference: placement_group_capture_child_tasks)."""
    from ray_tpu_torch.util.placement_group import (
        PlacementGroup,
        _ambient_pg,
        translate_resources_for_pg,
    )

    label_selector = dict(label_selector or {})
    soft_label_selector: dict = {}
    policy = "hybrid"
    pg = opts.get("placement_group")
    bundle_index = opts.get("placement_group_bundle_index", -1)
    capture = bool(opts.get("placement_group_capture_child_tasks", False))

    strategy = opts.get("scheduling_strategy")
    if isinstance(strategy, str):
        policy = strategy
    elif isinstance(strategy, PlacementGroupSchedulingStrategy):
        pg = strategy.placement_group
        bundle_index = strategy.placement_group_bundle_index
        capture = strategy.placement_group_capture_child_tasks
    elif isinstance(strategy, NodeAffinitySchedulingStrategy):
        policy = strategy.to_policy()
    elif isinstance(strategy, NodeLabelSchedulingStrategy):
        label_selector = {**strategy.hard, **label_selector}
        soft_label_selector = dict(strategy.soft)

    if pg is None and strategy is None:
        ambient = _ambient_pg()
        if ambient is not None and ambient[1]:
            pg, bundle_index, capture = ambient[0], -1, True

    pg_info = None
    if pg is not None and pg != "default":
        pg_id = pg.id if isinstance(pg, PlacementGroup) else str(pg)
        resources = translate_resources_for_pg(resources, pg_id, bundle_index)
        pg_info = (pg_id, capture)
    return resources, label_selector, soft_label_selector, policy, pg_info
