"""Dataset — the user-facing distributed data API. Port of ``ray_tpu/data/dataset.py``.

Reference parity: python/ray/data/dataset.py (map_batches :468, map, filter,
flat_map, repartition, random_shuffle, sort, split, streaming_split, limit,
take, count, schema, iter_rows, iter_batches, union, zip, materialize,
write_*). Execution is lazy: transforms append logical ops; consumption runs
the StreamingExecutor.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Optional

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, BlockAccessor, concat_blocks
from ray_tpu_torch.data.executor import StreamingExecutor
from ray_tpu_torch.data.plan import (
    AddColumnOp,
    DataPlan,
    DropColumnsOp,
    FilterOp,
    FlatMapOp,
    MapBatchesOp,
    MapRowsOp,
    RandomShuffleOp,
    RenameColumnsOp,
    RepartitionOp,
    SelectColumnsOp,
    SortOp,
)


class Dataset:
    def __init__(self, plan: DataPlan, shard: Optional[tuple] = None,
                 limit: Optional[int] = None):
        self._plan = plan
        self._shard = shard
        self._limit = limit
        self._last_executor: Optional[StreamingExecutor] = None

    # -- transforms (lazy) ---------------------------------------------------

    def _with_op(self, op) -> "Dataset":
        return Dataset(self._plan.with_op(op), self._shard, self._limit)

    def map(self, fn: Callable[[dict], dict]) -> "Dataset":
        return self._with_op(MapRowsOp(fn))

    def map_batches(
        self,
        fn: Callable,
        *,
        batch_size: Optional[int] = None,
        batch_format: str = "numpy",
        fn_kwargs: Optional[dict] = None,
        compute=None,
        num_cpus: Optional[float] = None,
        memory: Optional[int] = None,
        resources: Optional[dict] = None,
        **_compat,
    ) -> "Dataset":
        """compute: None (stateless tasks), "actors", an int pool size, or
        an ActorPoolStrategy — actor pools amortize expensive per-process
        setup across blocks (reference: Dataset.map_batches compute=).
        ``ActorPoolStrategy(min_size=, max_size=)`` gets an AUTOSCALING
        pool under the memory governor: it grows on queue depth up to
        max_size, shrinks when idle or throttled, restarts dead actors,
        and preserves block order (output is block-identical to the
        stateless task path). num_cpus/memory/resources: this operator's
        per-task resource budget (reference: map_batches
        ray_remote_args) — the scheduler places the stage's tasks under
        these demands, so e.g. a 4-CPU preprocessing fn can't
        oversubscribe a node."""
        from ray_tpu_torch.data.plan import ActorPoolStrategy

        if compute == "actors":
            compute = ActorPoolStrategy()
        elif isinstance(compute, int):
            compute = ActorPoolStrategy(size=compute)
        elif compute is not None and not isinstance(compute, ActorPoolStrategy):
            raise TypeError(f"bad compute= value {compute!r}")
        remote_args: dict = {}
        if num_cpus is not None:
            remote_args["num_cpus"] = num_cpus
        if memory is not None:
            remote_args["resources"] = dict(
                remote_args.get("resources", {}), memory=float(memory)
            )
        if resources:
            remote_args["resources"] = dict(
                remote_args.get("resources", {}), **resources
            )
        return self._with_op(
            MapBatchesOp(
                fn, batch_size, batch_format, fn_kwargs or {}, compute,
                remote_args,
            )
        )

    def flat_map(self, fn: Callable[[dict], list]) -> "Dataset":
        return self._with_op(FlatMapOp(fn))

    def filter(self, fn: Callable[[dict], bool]) -> "Dataset":
        return self._with_op(FilterOp(fn))

    def add_column(self, name: str, fn: Callable) -> "Dataset":
        return self._with_op(AddColumnOp(name, fn))

    def drop_columns(self, cols: list) -> "Dataset":
        return self._with_op(DropColumnsOp(list(cols)))

    def select_columns(self, cols: list) -> "Dataset":
        return self._with_op(SelectColumnsOp(list(cols)))

    def rename_columns(self, mapping: dict) -> "Dataset":
        return self._with_op(RenameColumnsOp(dict(mapping)))

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._with_op(RepartitionOp(num_blocks))

    def random_shuffle(
        self,
        *,
        seed: Optional[int] = None,
        num_blocks: Optional[int] = None,
    ) -> "Dataset":
        """Globally randomize row order (streaming all-to-all: inputs are
        consumed incrementally, never materialized as a whole stage).
        ``num_blocks`` fixes the output block count (default: the input
        block count, so granularity survives the shuffle)."""
        return self._with_op(RandomShuffleOp(seed, num_blocks))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        return self._with_op(SortOp(key, descending))

    def limit(self, n: int) -> "Dataset":
        limit = n if self._limit is None else min(self._limit, n)
        return Dataset(self._plan, self._shard, limit)

    def shard(self, world_size: int, rank: int) -> "Dataset":
        """Deterministic 1/world_size horizontal shard (by final-stage block
        index) — the per-train-worker split (reference: streaming_split
        semantics for Train workers)."""
        if self._shard is not None:
            raise ValueError("dataset is already sharded")
        return Dataset(self._plan, (world_size, rank), self._limit)

    def union(self, *others: "Dataset") -> "Dataset":
        refs = [ref for ref, _ in self._executor().iter_blocks()]
        for o in others:
            refs.extend(ref for ref, _ in o._executor().iter_blocks())
        return Dataset(DataPlan(input_refs=refs))

    def join(
        self,
        other: "Dataset",
        on: str,
        *,
        how: str = "inner",
        num_partitions: Optional[int] = None,
    ) -> "Dataset":
        """Hash join on column ``on`` (reference: Dataset.join backed by
        the hash-shuffle operators). The right side materializes to block
        refs; the left side streams — each arriving left block is
        hash-partitioned immediately, and per-partition join tasks run in
        parallel. ``how``: inner | left_outer | right_outer | full_outer.
        """
        from ray_tpu_torch.data.plan import JoinOp

        aliases = {
            "inner": "inner",
            "left": "left outer",
            "left_outer": "left outer",
            "right": "right outer",
            "right_outer": "right outer",
            "outer": "full outer",
            "full_outer": "full outer",
        }
        if how not in aliases:
            raise ValueError(
                f"how={how!r}; expected one of {sorted(aliases)}"
            )
        right_refs = [ref for ref, _ in other._executor().iter_blocks()]
        return self._with_op(
            JoinOp(on, right_refs, aliases[how], num_partitions)
        )

    def zip(self, other: "Dataset") -> "Dataset":
        """Horizontal concat (column-wise); materializes both sides."""
        left = concat_blocks(self._fetch_blocks())
        right = concat_blocks(other._fetch_blocks())
        if left.num_rows != right.num_rows:
            raise ValueError(
                f"zip requires equal row counts "
                f"({left.num_rows} vs {right.num_rows})"
            )
        for name in right.column_names:
            out_name = name
            if name in left.column_names:
                out_name = name + "_1"
            left = left.append_column(out_name, right.column(name))
        from ray_tpu_torch.data.datasource import BlocksDatasource

        return Dataset(
            DataPlan(read_tasks=BlocksDatasource([left]).get_read_tasks(1))
        )

    # -- grouped -------------------------------------------------------------

    def groupby(self, key: str):
        from ray_tpu_torch.data.grouped import GroupedData

        return GroupedData(self, key)

    # -- execution -----------------------------------------------------------

    def _executor(self) -> StreamingExecutor:
        ex = StreamingExecutor(
            self._plan, shard=self._shard, limit=self._limit
        )
        # Retained so stats() reports the most recent execution of THIS
        # dataset object (reference: Dataset.stats()/DatasetStats).
        self._last_executor = ex
        return ex

    def stats(self) -> str:
        """Per-operator execution statistics of the most recent execution
        (materialize/take/iter_*) of this dataset (reference:
        Dataset.stats()). Empty string if it never executed. With the
        memory governor on, a trailing line reports peak store occupancy
        and throttle events for the execution."""
        ex = self._last_executor
        if ex is None:
            return ""
        out = ex.stats.summary()
        gov = ex.governor_stats()
        if gov is not None:
            out += (
                f"\nGovernor: peak store occupancy "
                f"{gov['peak_occupancy_frac']:.1%}, "
                f"{gov['throttle_events']} throttle events"
            )
        return out

    def governor_stats(self) -> Optional[dict]:
        """The most recent execution's MemoryGovernor summary (peak
        occupancy fraction, throttle events, per-operator budgets), or
        None (never executed / governor disabled)."""
        ex = self._last_executor
        return ex.governor_stats() if ex is not None else None

    def stats_dict(self) -> list[dict]:
        """The same stats as structured rows (one per stage/barrier)."""
        ex = self._last_executor
        return ex.stats.as_dicts() if ex is not None else []

    def iter_internal_block_refs(self):
        yield from self._executor().iter_blocks()

    def _fetch_blocks(self) -> list[Block]:
        return [
            ray_tpu_torch.get(ref) for ref, _ in self._executor().iter_blocks()
        ]

    def materialize(self) -> "Dataset":
        """Execute now; the result holds block refs (reference:
        Dataset.materialize → MaterializedDataset)."""
        refs = [ref for ref, _ in self._executor().iter_blocks()]
        return Dataset(DataPlan(input_refs=refs))

    def count(self) -> int:
        return sum(n for _, n in self._executor().iter_blocks())

    def schema(self):
        for ref, n in self._executor().iter_blocks():
            if n > 0:
                return ray_tpu_torch.get(ref).schema
        return None

    def columns(self) -> list:
        s = self.schema()
        return list(s.names) if s is not None else []

    def num_blocks(self) -> int:
        return sum(1 for _ in self._executor().iter_blocks())

    def take(self, n: int = 20) -> list[dict]:
        out: list[dict] = []
        limited = self.limit(n)
        ex = limited._executor()
        # stats() on THIS object must cover take() per its contract — the
        # executor ran on a derived (limited) dataset.
        self._last_executor = ex
        for ref, _ in ex.iter_blocks():
            out.extend(BlockAccessor(ray_tpu_torch.get(ref)).take_rows(n - len(out)))
            if len(out) >= n:
                break
        return out[:n]

    def take_all(self) -> list[dict]:
        out: list[dict] = []
        for block in self._fetch_blocks():
            out.extend(BlockAccessor(block).iter_rows())
        return out

    def show(self, n: int = 20) -> None:
        for row in self.take(n):
            print(row)

    def iter_rows(self) -> Iterator[dict]:
        for ref, _ in self._executor().iter_blocks():
            yield from BlockAccessor(ray_tpu_torch.get(ref)).iter_rows()

    def iter_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        batch_format: str = "numpy",
        drop_last: bool = False,
    ) -> Iterator[Any]:
        from ray_tpu_torch.data.iterator import iter_batches_from_blocks

        yield from iter_batches_from_blocks(
            (ray_tpu_torch.get(ref) for ref, _ in self._executor().iter_blocks()),
            batch_size=batch_size,
            batch_format=batch_format,
            drop_last=drop_last,
        )

    def iter_torch_batches(self, *, batch_size: Optional[int] = 256,
                           drop_last: bool = False) -> Iterator[dict]:
        import torch

        for batch in self.iter_batches(
            batch_size=batch_size, batch_format="numpy", drop_last=drop_last
        ):
            yield {k: torch.as_tensor(v) for k, v in batch.items()}

    def split(self, n: int, *, equal: bool = False) -> list["Dataset"]:
        refs = [ref for ref, _ in self._executor().iter_blocks()]
        if equal:
            # Equalize by repartitioning to n blocks of equal row count.
            return Dataset(
                DataPlan(input_refs=refs, ops=[RepartitionOp(n)])
            ).split(n)
        groups: list[list] = [[] for _ in range(n)]
        for i, ref in enumerate(refs):
            groups[i % n].append(ref)
        return [Dataset(DataPlan(input_refs=g)) for g in groups]

    def streaming_split(self, n: int, *, equal: bool = False):
        """n disjoint iterators (reference: streaming_split). Block-granular
        round-robin; ``equal`` first repartitions to n equal-row blocks."""
        from ray_tpu_torch.data.iterator import DataIterator

        if self._shard is not None:
            raise ValueError("dataset is already sharded")
        base = self.repartition(n) if equal else self
        return [DataIterator(base.shard(n, i)) for i in range(n)]

    # -- writes --------------------------------------------------------------

    def _write(self, path: str, writer_name: str, suffix: str) -> None:
        import os

        os.makedirs(path, exist_ok=True)
        write = ray_tpu_torch.remote(_write_block)
        refs = []
        for i, (ref, n) in enumerate(self._executor().iter_blocks()):
            out = os.path.join(path, f"part_{i:05d}{suffix}")
            refs.append(write.remote(ref, out, writer_name))
        ray_tpu_torch.get(refs)

    def write_parquet(self, path: str) -> None:
        self._write(path, "parquet", ".parquet")

    def write_csv(self, path: str) -> None:
        self._write(path, "csv", ".csv")

    def write_json(self, path: str) -> None:
        self._write(path, "json", ".json")

    def to_pandas(self):
        return concat_blocks(self._fetch_blocks()).to_pandas()

    def __repr__(self):
        return f"Dataset(ops={len(self._plan.ops)})"


def _write_block(block, path: str, writer: str) -> str:
    if writer == "parquet":
        import pyarrow.parquet as pq

        pq.write_table(block, path)
    elif writer == "csv":
        from pyarrow import csv as pacsv

        pacsv.write_csv(block, path)
    elif writer == "json":
        rows = BlockAccessor(block).iter_rows()
        import json

        with open(path, "w") as f:
            for r in rows:
                f.write(json.dumps(r, default=str) + "\n")
    return path
