"""Logical plan: operator list + fusion into physical stages. Port of
``ray_tpu/data/plan.py``.

Reference parity: python/ray/data/_internal/logical/ (logical operators) and
_internal/planner/ (lowering). The optimizer here does the one transformation
that dominates performance: fusing consecutive per-block transforms into a
single task per block, so a read→map→filter chain costs one task round-trip
per block instead of three. Barrier ops (repartition / shuffle / sort) cut
the chain into stages.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ray_tpu_torch.data.block import Block, BlockAccessor, concat_blocks, rows_to_block


# -- logical ops -------------------------------------------------------------


class ActorPoolStrategy:
    """compute= strategy for map stages (reference:
    ray.data.ActorPoolStrategy): run the stage's fused chain inside a pool
    of long-lived actors so per-block setup (model load, jit compile)
    amortizes across blocks.

    ``min_size``/``max_size`` bound an AUTOSCALING pool (reference:
    ActorPoolStrategy(min_size=, max_size=)): the governed executor
    starts ``min_size`` actors, grows toward ``max_size`` on queue depth
    (under the memory governor's budget), shrinks idle actors back toward
    ``min_size``, and restarts dead actors in place. ``size=`` remains
    the legacy fixed-pool spelling (min == max == size). Defaults come
    from the ``data_actor_pool_*`` config knobs."""

    def __init__(
        self,
        size: Optional[int] = None,
        max_tasks_in_flight_per_actor: Optional[int] = None,
        *,
        min_size: Optional[int] = None,
        max_size: Optional[int] = None,
    ):
        from ray_tpu_torch.core.config import GLOBAL_CONFIG

        if size is not None:
            if min_size is not None or max_size is not None:
                raise ValueError(
                    "size= (fixed pool) and min_size=/max_size= "
                    "(autoscaling pool) are mutually exclusive"
                )
            if size < 1:
                raise ValueError("actor pool size must be >= 1")
            min_size = max_size = size
        else:
            if min_size is None:
                min_size = GLOBAL_CONFIG.data_actor_pool_min_size
            if max_size is None:
                max_size = max(
                    min_size, GLOBAL_CONFIG.data_actor_pool_max_size
                )
        if min_size < 1 or max_size < min_size:
            raise ValueError(
                f"actor pool bounds must satisfy 1 <= min_size <= "
                f"max_size (got {min_size}..{max_size})"
            )
        self.min_size = min_size
        self.max_size = max_size
        self.max_tasks_in_flight_per_actor = (
            max_tasks_in_flight_per_actor
            if max_tasks_in_flight_per_actor is not None
            else GLOBAL_CONFIG.data_actor_pool_max_tasks_per_actor
        )

    @property
    def size(self) -> int:
        """Legacy fixed-pool view: the pool's upper bound."""
        return self.max_size


@dataclass
class MapBatchesOp:
    fn: Callable
    batch_size: Optional[int] = None  # None = whole block
    batch_format: str = "numpy"
    fn_kwargs: dict = field(default_factory=dict)
    compute: Optional[ActorPoolStrategy] = None
    # Per-operator resource budget (reference: map_batches num_cpus=/
    # memory=/resources= ray_remote_args): the fused stage's tasks/actors
    # are scheduled with the LARGEST demand of any op in the chain.
    ray_remote_args: dict = field(default_factory=dict)


@dataclass
class MapRowsOp:
    fn: Callable


@dataclass
class FlatMapOp:
    fn: Callable


@dataclass
class FilterOp:
    fn: Callable


@dataclass
class AddColumnOp:
    name: str
    fn: Callable  # batch(dict of np arrays) -> np array


@dataclass
class DropColumnsOp:
    cols: list


@dataclass
class SelectColumnsOp:
    cols: list


@dataclass
class RenameColumnsOp:
    mapping: dict


@dataclass
class RepartitionOp:  # barrier
    num_blocks: int


@dataclass
class RandomShuffleOp:  # barrier
    seed: Optional[int] = None
    # Output block count. None = the upstream input block count (block
    # granularity survives the shuffle; the count must be fixed before
    # consumption starts — that is what makes streaming possible).
    num_blocks: Optional[int] = None


@dataclass
class SortOp:  # barrier
    key: str
    descending: bool = False


@dataclass
class JoinOp:  # barrier
    """Hash join against an already-materialized right side (reference:
    the hash-shuffle join operator under
    python/ray/data/_internal/execution/operators/ +
    _internal/planner/exchange/). ``right_refs`` are the right dataset's
    block refs; both sides hash-partition on the key and each partition
    joins independently (pyarrow Acero does the per-partition join)."""

    key: str
    right_refs: list
    how: str = "inner"  # inner | left outer | right outer | full outer
    num_partitions: Optional[int] = None  # None: max(len inputs, rights)


BARRIER_OPS = (RepartitionOp, RandomShuffleOp, SortOp, JoinOp)


# -- logical optimizer --------------------------------------------------------


def optimize_ops(ops: list) -> list:
    """Rule-based logical rewrites (reference:
    python/ray/data/_internal/logical/optimizers.py). Conservative rules
    only — every rewrite preserves row-level semantics:

    1. Consecutive Repartition barriers collapse to the last one.
    2. Consecutive RandomShuffle barriers collapse to the last one
       (shuffling twice is one shuffle).
    3. A RandomShuffle immediately before a Sort is dead (the sort
       redefines the order) and is dropped.
    4. Consecutive SelectColumns ops merge; consecutive DropColumns merge.
    5. Column pruning (Select/Drop at the head of a post-barrier chain)
       is pushed AHEAD of Repartition/RandomShuffle so dropped columns
       never pay shuffle bytes; for Sort only when the sort key survives
       the projection.
    """
    ops = list(ops)
    changed = True
    while changed:
        changed = False
        out: list = []
        i = 0
        while i < len(ops):
            op = ops[i]
            nxt = ops[i + 1] if i + 1 < len(ops) else None
            # Rules 1+2: consecutive same-kind barriers.
            if (
                isinstance(op, (RepartitionOp, RandomShuffleOp))
                and type(nxt) is type(op)
            ):
                i += 1  # drop `op`, keep the later one
                changed = True
                continue
            # Rule 3: shuffle immediately before sort is dead.
            if isinstance(op, RandomShuffleOp) and isinstance(nxt, SortOp):
                i += 1
                changed = True
                continue
            # Rule 4: merge column projections. Only when the second
            # select's columns all survive the first — otherwise the
            # unmerged chain raises at runtime (the user's bug must
            # surface at the select, not silently project fewer columns).
            if isinstance(op, SelectColumnsOp) and isinstance(
                nxt, SelectColumnsOp
            ):
                if all(c in set(op.cols) for c in nxt.cols):
                    out.append(SelectColumnsOp(list(nxt.cols)))
                    i += 2
                    changed = True
                    continue
            if isinstance(op, DropColumnsOp) and isinstance(
                nxt, DropColumnsOp
            ):
                # Merge only DISJOINT drops: re-dropping a column raises
                # KeyError unoptimized, and that user bug must still
                # surface (same contract as the Select merge above).
                if not set(op.cols) & set(nxt.cols):
                    out.append(DropColumnsOp(list(op.cols) + list(nxt.cols)))
                    i += 2
                    changed = True
                    continue
            # Rule 5: projection pushdown through a barrier.
            if isinstance(op, BARRIER_OPS) and isinstance(
                nxt, (SelectColumnsOp, DropColumnsOp)
            ):
                movable = True
                if isinstance(op, SortOp):
                    if isinstance(nxt, SelectColumnsOp):
                        movable = op.key in nxt.cols
                    else:
                        movable = op.key not in nxt.cols
                if movable:
                    out.append(nxt)
                    out.append(op)
                    i += 2
                    changed = True
                    continue
            out.append(op)
            i += 1
        ops = out
    return ops
CHAIN_OPS = (
    MapBatchesOp,
    MapRowsOp,
    FlatMapOp,
    FilterOp,
    AddColumnOp,
    DropColumnsOp,
    SelectColumnsOp,
    RenameColumnsOp,
)


def apply_chain_op(op, block: Block) -> Block:
    acc = BlockAccessor(block)
    if isinstance(op, MapBatchesOp):
        n = acc.num_rows()
        if n == 0:
            # Legitimately empty block (e.g. a filter removed every row). Try
            # the fn on the empty batch so the OUTPUT schema propagates to
            # downstream schema-dependent ops (sort/concat); fns that assume
            # non-empty arrays are skipped instead of crashing (the reference
            # drops zero-row bundles).
            try:
                batch = acc.to_batch(op.batch_format)
                result = op.fn(batch, **op.fn_kwargs)
                return BlockAccessor.batch_to_block(result)
            except Exception:  # raylint: disable=RL006 -- empty-batch schema probe only: fns assuming non-empty arrays are skipped, not crashed (the reference drops zero-row bundles); non-empty batches below propagate errors
                return block
        out_blocks = []
        size = op.batch_size or n
        for start in range(0, n, size):
            sub = acc.slice(start, min(start + size, n))
            batch = BlockAccessor(sub).to_batch(op.batch_format)
            result = op.fn(batch, **op.fn_kwargs)
            out_blocks.append(BlockAccessor.batch_to_block(result))
        return concat_blocks(out_blocks)
    if isinstance(op, MapRowsOp):
        return rows_to_block([op.fn(r) for r in acc.iter_rows()])
    if isinstance(op, FlatMapOp):
        out = []
        for r in acc.iter_rows():
            out.extend(op.fn(r))
        return rows_to_block(out)
    if isinstance(op, FilterOp):
        return rows_to_block([r for r in acc.iter_rows() if op.fn(r)])
    if isinstance(op, AddColumnOp):
        batch = acc.to_numpy_batch()
        col = op.fn(batch)
        from ray_tpu_torch.data.block import _column_to_arrow

        return block.append_column(op.name, _column_to_arrow(col))
    if isinstance(op, DropColumnsOp):
        return block.drop_columns(op.cols)
    if isinstance(op, SelectColumnsOp):
        return block.select(op.cols)
    if isinstance(op, RenameColumnsOp):
        names = [op.mapping.get(n, n) for n in block.column_names]
        return block.rename_columns(names)
    raise TypeError(f"not a chain op: {op}")


# -- physical plan -----------------------------------------------------------


@dataclass
class Stage:
    """A fused pipeline stage: per-input chain of transforms, preceded by an
    optional barrier op that redistributes the previous stage's blocks."""

    barrier: Optional[Any]  # None for the first stage
    chain: list  # CHAIN_OPS applied per block


@dataclass
class DataPlan:
    """Input (read tasks OR in-flight block refs) + logical op list."""

    read_tasks: Optional[list] = None
    input_refs: Optional[list] = None
    ops: list = field(default_factory=list)

    def with_op(self, op) -> "DataPlan":
        return DataPlan(
            read_tasks=self.read_tasks,
            input_refs=self.input_refs,
            ops=[*self.ops, op],
        )

    def stages(self) -> list[Stage]:
        stages = [Stage(barrier=None, chain=[])]
        for op in optimize_ops(self.ops):
            if isinstance(op, BARRIER_OPS):
                stages.append(Stage(barrier=op, chain=[]))
            elif isinstance(op, CHAIN_OPS):
                stages[-1].chain.append(op)
            else:
                raise TypeError(f"unknown op {op}")
        return stages
