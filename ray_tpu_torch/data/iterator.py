"""Batch iteration: re-batching a block stream to a fixed batch size. Port of
``ray_tpu/data/iterator.py``.

Reference parity: python/ray/data/iterator.py (iter_batches /
iter_torch_batches; DataIterator returned by streaming_split).
"""

from __future__ import annotations

from typing import Iterator, Optional

from ray_tpu_torch.data.block import BlockAccessor, concat_blocks


def iter_batches_from_blocks(
    blocks,
    *,
    batch_size: Optional[int] = 256,
    batch_format: str = "numpy",
    drop_last: bool = False,
) -> Iterator:
    """Slice a stream of blocks into uniform batches, carrying remainders
    across block boundaries."""
    carry = None
    for block in blocks:
        if block.num_rows == 0:
            continue
        if carry is not None:
            block = concat_blocks([carry, block])
            carry = None
        if batch_size is None:
            yield BlockAccessor(block).to_batch(batch_format)
            continue
        acc = BlockAccessor(block)
        n = acc.num_rows()
        start = 0
        while n - start >= batch_size:
            yield BlockAccessor(
                acc.slice(start, start + batch_size)
            ).to_batch(batch_format)
            start += batch_size
        if start < n:
            carry = acc.slice(start, n)
    if carry is not None and not drop_last:
        yield BlockAccessor(carry).to_batch(batch_format)


class DataIterator:
    """One consumer's view of a (sharded) dataset.

    ``prefetch_depth`` (set by the trainer from ``DataConfig``) is the
    default device-staging depth for :meth:`iter_device_batches`."""

    def __init__(self, dataset, prefetch_depth: Optional[int] = None):
        self._dataset = dataset
        self._prefetch_depth = prefetch_depth

    def iter_batches(self, **kwargs) -> Iterator:
        return self._dataset.iter_batches(**kwargs)

    def iter_device_batches(
        self,
        *,
        sharding=None,
        prefetch_depth: Optional[int] = None,
        device="cuda",
        **kwargs,
    ) -> Iterator:
        """iter_batches, but each batch is staged on ``device`` (the card
        by default; ``"cpu"`` only when asked) ahead of consumption, under
        ``sharding`` where given (a port ``NamedSharding``: each leaf is
        cut to this rank's block), so ``data → train`` feeds the step with
        no host staging in the timed region. ``prefetch_depth`` overrides
        the trainer's ``DataConfig`` value (else the
        ``train_prefetch_depth`` config default); 0 = host passthrough.

        This is the governed pipeline's device-side terminus: upstream,
        the MemoryGovernor bounds what the executor races into the object
        store (``data → governed executor → DevicePrefetchIterator →
        step``), so an out-of-core dataset feeds a train loop continuously
        at bounded host memory."""
        from ray_tpu_torch.train.input import DevicePrefetchIterator

        if prefetch_depth is None:
            prefetch_depth = self._prefetch_depth
        return DevicePrefetchIterator(
            self.iter_batches(**kwargs),
            sharding=sharding,
            depth=prefetch_depth,
            device=device,
        )

    def iter_rows(self) -> Iterator[dict]:
        return self._dataset.iter_rows()

    def iter_torch_batches(self, **kwargs) -> Iterator[dict]:
        return self._dataset.iter_torch_batches(**kwargs)

    def count(self) -> int:
        return self._dataset.count()

    def materialize(self):
        return self._dataset.materialize()
