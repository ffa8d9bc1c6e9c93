"""ray_tpu_torch.data — distributed datasets with streaming execution. Port of
``ray_tpu/data/__init__.py``.

Reference parity: python/ray/data/ (read_* constructors, Dataset transforms,
streaming executor, iter_batches). Blocks are pyarrow Tables flowing through
the object store; the batch formats feed numpy (and torch) host batches to
the train loop's input pipeline.
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch.data.block import Block, BlockAccessor, BlockMetadata
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.dataset import Dataset
from ray_tpu_torch.data.iterator import DataIterator
from ray_tpu_torch.data.plan import ActorPoolStrategy, DataPlan


def _from_source(source, parallelism: int) -> Dataset:
    if parallelism in (None, -1):
        parallelism = DataContext.get_current().default_parallelism
    return Dataset(DataPlan(read_tasks=source.get_read_tasks(parallelism)))


def range(n: int, *, parallelism: int = -1) -> Dataset:  # noqa: A001
    from ray_tpu_torch.data.datasource import RangeDatasource

    return _from_source(RangeDatasource(n), parallelism)


def from_items(items: list, *, parallelism: int = -1) -> Dataset:
    from ray_tpu_torch.data.datasource import ItemsDatasource

    return _from_source(ItemsDatasource(items), parallelism)


def from_numpy(arrays, column: str = "data") -> Dataset:
    from ray_tpu_torch.data.datasource import NumpyDatasource

    return _from_source(NumpyDatasource(arrays, column), 1)


def from_pandas(dfs) -> Dataset:
    import pyarrow as pa

    from ray_tpu_torch.data.datasource import BlocksDatasource

    if not isinstance(dfs, list):
        dfs = [dfs]
    blocks = [pa.Table.from_pandas(df, preserve_index=False) for df in dfs]
    return _from_source(BlocksDatasource(blocks), len(blocks))


def from_arrow(tables) -> Dataset:
    from ray_tpu_torch.data.datasource import BlocksDatasource

    if not isinstance(tables, list):
        tables = [tables]
    return _from_source(BlocksDatasource(tables), len(tables))


def read_parquet(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    from ray_tpu_torch.data.datasource import ParquetDatasource

    return _from_source(ParquetDatasource(paths, **kwargs), parallelism)


def read_csv(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    from ray_tpu_torch.data.datasource import CSVDatasource

    return _from_source(CSVDatasource(paths, **kwargs), parallelism)


def read_json(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    from ray_tpu_torch.data.datasource import JSONDatasource

    return _from_source(JSONDatasource(paths, **kwargs), parallelism)


def read_datasource(source, *, parallelism: int = -1) -> Dataset:
    return _from_source(source, parallelism)


__all__ = [
    "ActorPoolStrategy",
    "Block",
    "BlockAccessor",
    "BlockMetadata",
    "DataContext",
    "DataIterator",
    "Dataset",
    "from_arrow",
    "from_items",
    "from_numpy",
    "from_pandas",
    "range",
    "read_csv",
    "read_datasource",
    "range_tensor",
    "read_binary_files",
    "read_images",
    "read_json",
    "read_text",
    "read_tfrecords",
    "read_parquet",
]


def read_text(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    """One row per line as {"text", "path"} (reference:
    ray.data.read_text; drop_empty_lines=True matches its default)."""
    from ray_tpu_torch.data.datasource import TextDatasource

    return _from_source(TextDatasource(paths, **kwargs), parallelism)


def read_binary_files(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    """Whole files as {"bytes", "path"} rows (reference:
    ray.data.read_binary_files)."""
    from ray_tpu_torch.data.datasource import BinaryDatasource

    return _from_source(BinaryDatasource(paths, **kwargs), parallelism)


def read_images(
    paths, *, size=None, mode="RGB", parallelism: int = -1, **kwargs
) -> Dataset:
    """Decoded images as {"image": [H, W, C], "path"} rows (reference:
    ray.data.read_images)."""
    from ray_tpu_torch.data.datasource import ImageDatasource

    return _from_source(
        ImageDatasource(paths, size=size, mode=mode, **kwargs), parallelism
    )


def read_tfrecords(
    paths, *, verify_crc: bool = False, parallelism: int = -1, **kwargs
) -> Dataset:
    """TFRecord files as raw-bytes {"data"} rows; decode with map_batches
    (reference: ray.data.read_tfrecords)."""
    from ray_tpu_torch.data.datasource import TFRecordDatasource

    return _from_source(
        TFRecordDatasource(paths, verify_crc=verify_crc, **kwargs),
        parallelism,
    )


def range_tensor(n: int, *, shape=(1,), parallelism: int = -1) -> Dataset:
    """{"data": ndarray(shape)} rows valued by row id (reference:
    ray.data.range_tensor)."""
    from ray_tpu_torch.data.datasource import RangeTensorDatasource

    return _from_source(RangeTensorDatasource(n, shape), parallelism)
