"""Datasources — pluggable readers producing ReadTasks. Port of
``ray_tpu/data/datasource.py``.

Reference parity: python/ray/data/datasource/ (Datasource ABC + ReadTask;
parquet/csv/json/range/items sources). A ReadTask is a serializable zero-arg
callable returning one Block plus size metadata the optimizer can use for
block sizing.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Optional

import numpy as np

from ray_tpu_torch.data.block import Block, pa, rows_to_block


@dataclass
class ReadTask:
    fn: Callable[[], Block]
    num_rows: Optional[int] = None
    input_files: list = None

    def __call__(self) -> Block:
        return self.fn()


class Datasource:
    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        raise NotImplementedError

    def estimated_num_rows(self) -> Optional[int]:
        return None


class RangeDatasource(Datasource):
    def __init__(self, n: int):
        self._n = n

    def estimated_num_rows(self):
        return self._n

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        n = self._n
        parallelism = max(1, min(parallelism, n or 1))
        step = -(-n // parallelism) if n else 1
        tasks = []
        for start in range(0, n, step):
            end = min(start + step, n)

            def make(start=start, end=end):
                return pa.table(
                    {"id": pa.array(np.arange(start, end, dtype=np.int64))}
                )

            tasks.append(ReadTask(make, num_rows=end - start))
        return tasks or [ReadTask(lambda: pa.table({"id": pa.array([], pa.int64())}), num_rows=0)]


class ItemsDatasource(Datasource):
    def __init__(self, items: list):
        self._items = list(items)

    def estimated_num_rows(self):
        return len(self._items)

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        items = self._items
        if not items:
            return [ReadTask(lambda: rows_to_block([]), num_rows=0)]
        parallelism = max(1, min(parallelism, len(items)))
        step = -(-len(items) // parallelism)
        tasks = []
        for start in range(0, len(items), step):
            chunk = items[start : start + step]
            tasks.append(
                ReadTask(
                    lambda chunk=chunk: rows_to_block(chunk),
                    num_rows=len(chunk),
                )
            )
        return tasks


class BlocksDatasource(Datasource):
    """In-memory blocks (from_numpy / from_pandas / from_arrow)."""

    def __init__(self, blocks: list[Block]):
        self._blocks = blocks

    def estimated_num_rows(self):
        return sum(b.num_rows for b in self._blocks)

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        return [
            ReadTask(lambda b=b: b, num_rows=b.num_rows)
            for b in self._blocks
        ]


def _expand_paths(paths, suffixes: tuple) -> list[str]:
    if isinstance(paths, str):
        paths = [paths]
    out = []
    for p in paths:
        p = os.path.expanduser(p)
        if os.path.isdir(p):
            for suf in suffixes:
                out.extend(sorted(glob.glob(os.path.join(p, f"*{suf}"))))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files found for {paths}")
    return out


class FileDatasource(Datasource):
    suffixes: tuple = ()

    def __init__(self, paths, **read_kwargs):
        self._files = _expand_paths(paths, self.suffixes)
        self._kwargs = read_kwargs

    def read_file(self, path: str) -> Block:
        raise NotImplementedError

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        # One task per file: parquet/csv row groups could split further, but
        # file granularity matches the reference's default behavior.
        return [
            ReadTask(
                lambda p=p: self.read_file(p),
                input_files=[p],
            )
            for p in self._files
        ]


class ParquetDatasource(FileDatasource):
    suffixes = (".parquet",)

    def read_file(self, path: str) -> Block:
        import pyarrow.parquet as pq

        return pq.read_table(path, **self._kwargs)


class CSVDatasource(FileDatasource):
    suffixes = (".csv",)

    def read_file(self, path: str) -> Block:
        from pyarrow import csv as pacsv

        return pacsv.read_csv(path, **self._kwargs)


class JSONDatasource(FileDatasource):
    suffixes = (".json", ".jsonl")

    def read_file(self, path: str) -> Block:
        from pyarrow import json as pajson

        return pajson.read_json(path, **self._kwargs)


class TextDatasource(FileDatasource):
    """One row per line: {"text", "path"} (reference:
    ray.data.read_text). drop_empty_lines matches the reference default."""

    suffixes = (".txt", ".text", ".log", ".md")

    def read_file(self, path: str) -> Block:
        from ray_tpu_torch.data.block import BlockAccessor

        drop_empty = self._kwargs.get("drop_empty_lines", True)
        encoding = self._kwargs.get("encoding", "utf-8")
        with open(path, "r", encoding=encoding, errors="replace") as f:
            lines = [ln.rstrip("\n") for ln in f]
        if drop_empty:
            lines = [ln for ln in lines if ln.strip()]
        return BlockAccessor.batch_to_block(
            {"text": lines, "path": [path] * len(lines)}
        )


class NumpyDatasource(Datasource):
    def __init__(self, arrays: "np.ndarray | list[np.ndarray]", column: str = "data"):
        if isinstance(arrays, np.ndarray):
            arrays = [arrays]
        self._arrays = arrays
        self._column = column

    def estimated_num_rows(self):
        return sum(len(a) for a in self._arrays)

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        from ray_tpu_torch.data.block import BlockAccessor

        # Bind the column name, not self — capturing self would ship the
        # whole arrays list with every read task.
        return [
            ReadTask(
                lambda a=a, c=self._column: BlockAccessor.batch_to_block(
                    {c: a}
                ),
                num_rows=len(a),
            )
            for a in self._arrays
        ]


class BinaryDatasource(FileDatasource):
    """Whole files as rows: {"bytes": ..., "path": ...} (reference:
    ray.data.read_binary_files)."""

    suffixes = ("",)

    def __init__(self, paths, **kw):
        super().__init__(paths, **kw)
        # The empty suffix globs '*' in directories, which matches
        # subdirectories too — only regular files are readable rows.
        self._files = [p for p in self._files if os.path.isfile(p)]
        if not self._files:
            raise FileNotFoundError(f"no regular files found for {paths}")

    def read_file(self, path: str) -> Block:
        from ray_tpu_torch.data.block import BlockAccessor

        with open(path, "rb") as f:
            data = f.read()
        return BlockAccessor.batch_to_block(
            {"bytes": [data], "path": [path]}
        )


class ImageDatasource(FileDatasource):
    """Images decoded to ndarray rows: {"image": [H, W, C] uint8, "path"}
    (reference: ray.data.read_images). ``size=(H, W)`` resizes; ``mode``
    converts (e.g. "RGB", "L")."""

    suffixes = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp")

    def __init__(self, paths, size=None, mode="RGB", **kw):
        super().__init__(paths, **kw)
        self._size = tuple(size) if size else None
        self._mode = mode

    def read_file(self, path: str) -> Block:
        import numpy as _np
        from PIL import Image

        from ray_tpu_torch.data.block import BlockAccessor

        with Image.open(path) as im:
            if self._mode:
                im = im.convert(self._mode)
            if self._size:
                # PIL takes (W, H); the API takes (H, W) like the reference.
                im = im.resize((self._size[1], self._size[0]))
            arr = _np.asarray(im)
        return BlockAccessor.batch_to_block(
            {"image": arr[None], "path": [path]}
        )


# -- TFRecord -----------------------------------------------------------------
# Wire format (TensorFlow's record IO): per record
#   uint64 length | uint32 masked_crc32c(length) | bytes data |
#   uint32 masked_crc32c(data)
# CRC32C in pure python (small table; the files here are test/ingest scale —
# a native crc is an optimization, not a dependency worth adding).

_CRC32C_POLY = 0x82F63B78
_CRC32C_TABLE = []
for _n in range(256):
    _c = _n
    for _ in range(8):
        _c = (_c >> 1) ^ _CRC32C_POLY if _c & 1 else _c >> 1
    _CRC32C_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC32C_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


def write_tfrecords(records, path: str) -> int:
    """Write an iterable of bytes records as one TFRecord file; returns the
    record count. (Counterpart of TFRecordDatasource; interoperable with
    TensorFlow readers — masked crc32c included.)"""
    import struct

    n = 0
    with open(path, "wb") as f:
        for rec in records:
            if not isinstance(rec, (bytes, bytearray)):
                raise TypeError(
                    f"tfrecord records must be bytes, got {type(rec)}"
                )
            length = struct.pack("<Q", len(rec))
            f.write(length)
            f.write(struct.pack("<I", _masked_crc(length)))
            f.write(rec)
            f.write(struct.pack("<I", _masked_crc(bytes(rec))))
            n += 1
    return n


class TFRecordDatasource(FileDatasource):
    """TFRecord files as raw-bytes rows {"data": ...} (reference:
    ray.data.read_tfrecords; that parses tf.train.Example — here records
    stay opaque bytes and ``map_batches`` applies the user's decoder,
    which is the accelerator-friendly shape anyway: decode on the host CPU
    workers, feed arrays to the cards). ``verify_crc=True`` checks record CRCs."""

    suffixes = (".tfrecord", ".tfrecords")

    def __init__(self, paths, verify_crc: bool = False, **kw):
        super().__init__(paths, **kw)
        self._verify = verify_crc

    def read_file(self, path: str) -> Block:
        import struct

        from ray_tpu_torch.data.block import BlockAccessor

        records = []
        with open(path, "rb") as f:
            while True:
                header = f.read(8)
                if not header:
                    break
                if len(header) < 8:
                    raise ValueError(f"{path}: truncated record length")
                (length,) = struct.unpack("<Q", header)
                len_crc_raw = f.read(4)
                if len(len_crc_raw) < 4:
                    raise ValueError(f"{path}: truncated length crc")
                (len_crc,) = struct.unpack("<I", len_crc_raw)
                data = f.read(length)
                if len(data) < length:
                    raise ValueError(f"{path}: truncated record body")
                data_crc_raw = f.read(4)
                if len(data_crc_raw) < 4:
                    raise ValueError(f"{path}: truncated data crc")
                (data_crc,) = struct.unpack("<I", data_crc_raw)
                if self._verify:
                    if _masked_crc(header) != len_crc:
                        raise ValueError(f"{path}: length crc mismatch")
                    if _masked_crc(data) != data_crc:
                        raise ValueError(f"{path}: data crc mismatch")
                records.append(data)
        return BlockAccessor.batch_to_block({"data": records})


class RangeTensorDatasource(Datasource):
    """{"data": ndarray of ``shape``} rows, id-valued — the quick way to
    synthesize tensor datasets at any scale (reference:
    ray.data.range_tensor)."""

    def __init__(self, n: int, shape: tuple = (1,)):
        self._n = int(n)
        self._shape = tuple(shape)

    def estimated_num_rows(self):
        return self._n

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        from ray_tpu_torch.data.block import BlockAccessor

        if self._n <= 0:
            return []
        parallelism = max(1, min(parallelism, self._n))
        step = -(-self._n // parallelism)
        tasks = []
        for start in range(0, self._n, step):
            end = min(start + step, self._n)

            def make(start=start, end=end, shape=self._shape):
                ids = np.arange(start, end, dtype=np.int64)
                block = np.broadcast_to(
                    ids.reshape((-1,) + (1,) * len(shape)),
                    (end - start,) + shape,
                ).copy()
                return BlockAccessor.batch_to_block({"data": block})

            tasks.append(ReadTask(make, num_rows=end - start))
        return tasks
