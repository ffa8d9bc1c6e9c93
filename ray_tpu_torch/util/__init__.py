"""ray_tpu_torch.util — runtime utilities. Port of ``ray_tpu/util``: so far
placement groups and scheduling strategies, exported here as the reference
exports them, beside the metrics, tracing and flight-recorder modules.

Reference parity: python/ray/util/ (placement groups, scheduling strategies).
Both modules load the cluster runtime only when called, so importing this
package stays light.
"""

from ray_tpu_torch.util.placement_group import (
    PlacementGroup,
    get_current_placement_group,
    get_placement_group,
    placement_group,
    placement_group_table,
    remove_placement_group,
)
from ray_tpu_torch.util.scheduling_strategies import (
    NodeAffinitySchedulingStrategy,
    NodeLabelSchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)

__all__ = [
    "PlacementGroup",
    "placement_group",
    "remove_placement_group",
    "placement_group_table",
    "get_current_placement_group",
    "get_placement_group",
    "PlacementGroupSchedulingStrategy",
    "NodeAffinitySchedulingStrategy",
    "NodeLabelSchedulingStrategy",
]
