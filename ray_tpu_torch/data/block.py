"""Blocks — the unit of data movement. Port of ``ray_tpu/data/block.py``.

Reference parity: python/ray/data/block.py (Block/BlockAccessor/
BlockMetadata) + _internal/arrow_block.py. A block is a pyarrow Table;
BlockAccessor adapts it to rows / pandas / numpy-batch views and builds
blocks from any of those. Tables serialize compactly through the object
store and zero-copy into numpy for the host-feed path.

pyarrow is imported at first use, not with this module (``pa`` below is
a stand-in that imports it on the first attribute read), so importing the
data tier needs no pyarrow; building or reading a block does.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Iterable, Iterator, Optional

import numpy as np


class _LazyModule:
    """A module imported on the first read of one of its attributes."""

    def __init__(self, name: str):
        self._name = name

    def __getattr__(self, attr: str):
        if attr.startswith("__"):
            raise AttributeError(attr)
        return getattr(importlib.import_module(self._name), attr)

    def __reduce__(self):
        return (_LazyModule, (self._name,))


pa = _LazyModule("pyarrow")


class _BlockType(type):
    def __instancecheck__(cls, obj) -> bool:
        return (type(obj).__module__ or "").startswith("pyarrow") and isinstance(obj, pa.Table)


class Block(metaclass=_BlockType):
    """A block is a ``pyarrow.Table``: ``isinstance(x, Block)`` asks
    exactly that, without importing pyarrow for a value that is not one."""


@dataclasses.dataclass
class BlockMetadata:
    num_rows: int
    size_bytes: int
    schema: Optional[pa.Schema]
    input_files: list = dataclasses.field(default_factory=list)
    exec_stats: Optional[dict] = None


class BlockAccessor:
    def __init__(self, block: Block):
        self._block = block

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        return BlockAccessor(block)

    # -- builders ------------------------------------------------------------

    @staticmethod
    def batch_to_block(batch: Any) -> Block:
        """dict-of-arrays / pandas DataFrame / pyarrow Table / list-of-row-
        dicts → Block."""
        if isinstance(batch, pa.Table):
            return batch
        if isinstance(batch, dict):
            arrays, fields = [], []
            for k, v in batch.items():
                arr, shape = _column_to_arrow_with_shape(v)
                meta = (
                    {b"tensor_shape": repr(shape).encode()} if shape else None
                )
                arrays.append(arr)
                fields.append(pa.field(k, arr.type, metadata=meta))
            return pa.Table.from_arrays(arrays, schema=pa.schema(fields))
        try:
            import pandas as pd

            if isinstance(batch, pd.DataFrame):
                return pa.Table.from_pandas(batch, preserve_index=False)
        except ImportError:
            pass
        if isinstance(batch, (list, tuple)):
            return rows_to_block(batch)
        raise TypeError(
            f"cannot convert batch of type {type(batch)} to a block; "
            f"return a dict of arrays, pandas DataFrame, pyarrow Table, or "
            f"list of row dicts"
        )

    # -- views ---------------------------------------------------------------

    def num_rows(self) -> int:
        return self._block.num_rows

    def size_bytes(self) -> int:
        return self._block.nbytes

    def schema(self) -> pa.Schema:
        return self._block.schema

    def metadata(self) -> BlockMetadata:
        return BlockMetadata(
            num_rows=self.num_rows(),
            size_bytes=self.size_bytes(),
            schema=self.schema(),
        )

    def iter_rows(self) -> Iterator[dict]:
        # Tensor columns (FixedSizeList + tensor_shape metadata) must come
        # back as shaped ndarrays per row, not nested python lists — the
        # reference's tensor extension behaves the same in iter_rows.
        tensor_shapes = {}
        for i, name in enumerate(self._block.column_names):
            meta = self._block.schema.field(i).metadata or {}
            shape_repr = meta.get(b"tensor_shape")
            if shape_repr is not None:
                import ast

                tensor_shapes[name] = ast.literal_eval(shape_repr.decode())
        for batch in self._block.to_batches():
            names = list(batch.column_names)
            # Only NON-tensor columns go through python lists; tensor
            # columns stay ndarrays end-to-end (to_pydict would box every
            # pixel into a python int just to throw it away).
            cols = {
                n: batch.column(n).to_pylist()
                for n in names
                if n not in tensor_shapes
            }
            tensor_cols = {
                n: _arrow_to_numpy(batch.column(n)).reshape(
                    (batch.num_rows,) + tuple(tensor_shapes[n])
                )
                for n in names
                if n in tensor_shapes
            }
            for i in range(batch.num_rows):
                row = {}
                for n in names:
                    if n in tensor_cols:
                        row[n] = tensor_cols[n][i]
                    else:
                        row[n] = cols[n][i]
                yield row

    def to_pandas(self):
        return self._block.to_pandas()

    def to_numpy_batch(self) -> dict[str, np.ndarray]:
        out = {}
        for i, name in enumerate(self._block.column_names):
            col = self._block.column(name)
            arr = _arrow_to_numpy(col)
            meta = self._block.schema.field(i).metadata or {}
            shape_repr = meta.get(b"tensor_shape")
            if shape_repr is not None:
                import ast

                shape = ast.literal_eval(shape_repr.decode())
                arr = arr.reshape(len(arr), *shape)
            out[name] = arr
        return out

    def to_batch(self, batch_format: str):
        if batch_format in ("numpy", "default"):
            return self.to_numpy_batch()
        if batch_format == "pandas":
            return self.to_pandas()
        if batch_format in ("pyarrow", "arrow"):
            return self._block
        raise ValueError(f"unknown batch_format {batch_format!r}")

    def slice(self, start: int, end: int) -> Block:
        return self._block.slice(start, end - start)

    def take_rows(self, n: int) -> list[dict]:
        out = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out


def _column_to_arrow(v):
    return _column_to_arrow_with_shape(v)[0]


def _column_to_arrow_with_shape(v):
    """(arrow array, per-row tensor shape or None). Multi-dim columns store
    as fixed-size lists with the original shape in field metadata (the
    tensor-extension pattern of reference _internal/tensor_extensions,
    minus the custom type)."""
    if isinstance(v, (pa.Array, pa.ChunkedArray)):
        return v, None
    arr = np.asarray(v)
    if arr.ndim > 1:
        flat = arr.reshape(len(arr), -1)
        return (
            pa.FixedSizeListArray.from_arrays(
                pa.array(flat.ravel()), flat.shape[1]
            ),
            tuple(arr.shape[1:]),
        )
    return pa.array(arr), None


def _arrow_to_numpy(col) -> np.ndarray:
    if isinstance(col, pa.ChunkedArray):
        col = col.combine_chunks()
    if isinstance(col, pa.FixedSizeListArray):
        width = col.type.list_size
        values = col.flatten().to_numpy(zero_copy_only=False)
        return values.reshape(len(col), width)
    return col.to_numpy(zero_copy_only=False)


def rows_to_block(rows: Iterable[Any]) -> Block:
    rows = list(rows)
    if rows and not isinstance(rows[0], dict):
        # bare values → single-column "item" table (reference from_items)
        return pa.table({"item": _column_to_arrow([r for r in rows])})
    if not rows:
        return pa.table({})
    cols: dict[str, list] = {k: [] for k in rows[0]}
    for r in rows:
        for k in cols:
            cols[k].append(r.get(k))
    return pa.table({k: _column_to_arrow(v) for k, v in cols.items()})


def concat_blocks(blocks: list[Block]) -> Block:
    blocks = [b for b in blocks if b.num_rows > 0] or blocks[:1]
    if not blocks:
        return pa.table({})
    if len(blocks) == 1:
        return blocks[0]
    return pa.concat_tables(blocks, promote_options="default")
