"""GroupedData — groupby aggregations. Port of ``ray_tpu/data/grouped.py``.

Reference parity: python/ray/data/grouped_data.py (GroupedData: count, sum,
mean, min, max, map_groups). Aggregations compile to pyarrow group_by on the
materialized table; map_groups fans each group out as a task.
"""

from __future__ import annotations

from typing import Callable

import ray_tpu_torch
from ray_tpu_torch.data.block import BlockAccessor, concat_blocks


class GroupedData:
    def __init__(self, dataset, key: str):
        self._ds = dataset
        self._key = key

    def _agg(self, cols_aggs: list[tuple]) -> "Dataset":
        from ray_tpu_torch.data.dataset import Dataset
        from ray_tpu_torch.data.datasource import BlocksDatasource
        from ray_tpu_torch.data.plan import DataPlan

        table = concat_blocks(self._ds._fetch_blocks())
        out = table.group_by(self._key).aggregate(cols_aggs)
        return Dataset(
            DataPlan(read_tasks=BlocksDatasource([out]).get_read_tasks(1))
        )

    def count(self):
        return self._agg([(self._key, "count")])

    def sum(self, col: str):
        return self._agg([(col, "sum")])

    def mean(self, col: str):
        return self._agg([(col, "mean")])

    def min(self, col: str):
        return self._agg([(col, "min")])

    def max(self, col: str):
        return self._agg([(col, "max")])

    def std(self, col: str):
        return self._agg([(col, "stddev")])

    def map_groups(self, fn: Callable, *, batch_format: str = "numpy"):
        """fn(group_batch) -> batch, one task per group."""
        from ray_tpu_torch.data.dataset import Dataset
        from ray_tpu_torch.data.plan import DataPlan

        table = concat_blocks(self._ds._fetch_blocks())
        keys = table.column(self._key).unique().to_pylist()
        import pyarrow.compute as pc

        run = ray_tpu_torch.remote(_map_group)
        refs = []
        for k in keys:
            group = table.filter(pc.equal(table.column(self._key), k))
            refs.append(run.remote(group, fn, batch_format))
        return Dataset(DataPlan(input_refs=refs))


def _map_group(group, fn, batch_format: str):
    batch = BlockAccessor(group).to_batch(batch_format)
    return BlockAccessor.batch_to_block(fn(batch))
