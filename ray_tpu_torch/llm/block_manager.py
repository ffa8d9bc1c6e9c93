"""Host-side KV block accounting: free list + refcounts. Port of
``ray_tpu/llm/block_manager.py`` (the port keeps its own copy).

Device-side layout lives in :mod:`ray_tpu_torch.models.paged`; this class is
pure host bookkeeping and touches no tensor.

Block 0 is reserved as the scratch block: free slots and padded prefill
tails write there, so it is never allocatable.
"""

from __future__ import annotations


class BlockManager:
    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (block 0 is scratch)")
        self.num_blocks = num_blocks
        # LIFO free list: recently freed blocks are re-used first.
        self._free = list(range(num_blocks - 1, 0, -1))
        self._rc: dict[int, int] = {}

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return (self.num_blocks - 1) - len(self._free)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> list[int]:
        """n fresh blocks at refcount 1; raises if the pool is short
        (callers gate on :meth:`can_alloc` for admission control)."""
        if n > len(self._free):
            raise RuntimeError(f"KV pool exhausted: want {n}, have {len(self._free)}")
        ids = [self._free.pop() for _ in range(n)]
        for b in ids:
            self._rc[b] = 1
        return ids

    def incref(self, ids) -> None:
        for b in ids:
            self._rc[b] += 1

    def decref(self, ids) -> list[int]:
        """Drop one reference per id; blocks reaching zero return to the
        free list. Returns the freed ids."""
        freed = []
        for b in ids:
            rc = self._rc[b] - 1
            if rc == 0:
                del self._rc[b]
                self._free.append(b)
                freed.append(b)
            else:
                self._rc[b] = rc
        return freed

    def refcount(self, block: int) -> int:
        return self._rc.get(block, 0)
