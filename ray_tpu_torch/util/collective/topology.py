"""Two-level (slice → host) collective topology model. Port of
``ray_tpu/util/collective/topology.py``: :class:`TwoLevelTopology` and
:func:`derive`, copied as is (the TPU helpers stay out: the port's nodes
carry no slice labels, so every gang is one synthetic slice).

The train tier stamps every worker with its slice identity
(``train/worker_group.py`` sorts ranks by ``(slice_name, tpu_worker_id)``).
This module turns those identities into the structure hierarchical
collectives need: which ranks share one fast domain (one slice), which rank
fronts each slice on the slower hop (the slice *leader* — the lowest global
rank of the slice), and whether the group spans such a hop at all.

Everything here is pure and unit-tested against the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

# Ranks with no slice identity (CPU nodes, tests without TPU labels) fold
# into one synthetic slice: a group that never crossed a DCN hop must behave
# exactly like today's flat path.
UNSLICED = "<unsliced>"


@dataclasses.dataclass(frozen=True)
class TwoLevelTopology:
    """Slice → rank structure of one collective group.

    ``slices`` is the ordered tuple of distinct slice names (order of first
    appearance in rank order — the worker group's sort makes this the
    lexicographic slice order); ``slice_of`` maps each global rank to its
    index into ``slices``. Ranks of one slice are contiguous by
    construction (``derive`` validates it): the stable-rank sort that
    prevents ICI deadlocks is also what makes the two-level decomposition
    well-formed.
    """

    slices: tuple
    slice_of: tuple

    # -- shape ---------------------------------------------------------------

    @property
    def world_size(self) -> int:
        return len(self.slice_of)

    @property
    def num_slices(self) -> int:
        return len(self.slices)

    @property
    def spans_dcn(self) -> bool:
        """True when the group crosses at least one inter-slice (DCN) hop."""
        return self.num_slices > 1

    @property
    def uniform(self) -> bool:
        """All slices contribute the same number of ranks (required for the
        single-program 2-D mesh decomposition on the XLA backend)."""
        sizes = {len(self.ranks_in_slice(s)) for s in range(self.num_slices)}
        return len(sizes) == 1

    # -- per-rank structure --------------------------------------------------

    def slice_index(self, rank: int) -> int:
        return self.slice_of[rank]

    def slice_name(self, rank: int) -> str:
        return self.slices[self.slice_of[rank]]

    def ranks_in_slice(self, slice_idx: int) -> tuple:
        return tuple(
            r for r, s in enumerate(self.slice_of) if s == slice_idx
        )

    def local_rank(self, rank: int) -> int:
        """Rank's index within its slice (0 = the slice leader)."""
        return self.ranks_in_slice(self.slice_of[rank]).index(rank)

    def leader_of_slice(self, slice_idx: int) -> int:
        """The global rank fronting ``slice_idx`` on the DCN hop."""
        return self.ranks_in_slice(slice_idx)[0]

    def leaders(self) -> tuple:
        return tuple(
            self.leader_of_slice(s) for s in range(self.num_slices)
        )

    def is_leader(self, rank: int) -> bool:
        return self.leader_of_slice(self.slice_of[rank]) == rank


def derive(slice_by_rank: Sequence[Optional[str]]) -> TwoLevelTopology:
    """Build the two-level topology from per-rank slice names (index =
    global rank). Empty/None names fold into one synthetic slice.

    Raises ``ValueError`` when a slice's ranks are not contiguous: that
    means the caller bypassed the stable (slice, host) rank sort, and a
    hierarchical decomposition over it would put a DCN hop inside what the
    mesh math believes is one ICI domain.
    """
    names = [s if s else UNSLICED for s in slice_by_rank]
    if not names:
        raise ValueError("cannot derive a topology for an empty group")
    slices: list = []
    slice_of: list = []
    for rank, name in enumerate(names):
        if name not in slices:
            slices.append(name)
        idx = slices.index(name)
        if slice_of and idx < slice_of[-1]:
            raise ValueError(
                f"slice {name!r} ranks are not contiguous (rank {rank} "
                f"returns to it after another slice started); sort ranks "
                f"by (slice_name, host) first — see train/worker_group.py"
            )
        slice_of.append(idx)
    return TwoLevelTopology(tuple(slices), tuple(slice_of))
