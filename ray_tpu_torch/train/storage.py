"""StorageContext — where a run's checkpoints and artifacts persist. Port
of ``ray_tpu/train/storage.py`` (plain Python, copied as is).

Reference parity: python/ray/train/v2/_internal/execution/storage.py (and
legacy train/_internal/storage.py:358). Local/NFS paths with atomic-rename
persistence; the same interface takes a pyarrow.fs for cloud backends.

Multi-rank protocol: every rank merges its files into one checkpoint dir per
report index (per-rank sharded checkpoints are the standard layout)
and stamps a `.committed_r<rank>_of_<world>` marker. A directory is only
*restorable* once the marker set covers all ranks, so a reader never restores
a sharded checkpoint missing a slow rank's files. Markerless directories
(single-writer callers) are restorable as soon as they exist, because the
single writer publishes them with an atomic rename.
"""

from __future__ import annotations

import os
import re
import shutil
import time
import uuid

from ray_tpu_torch.train.checkpoint import Checkpoint

_MARKER_RE = re.compile(r"^\.committed_r(\d+)_of_(\d+)$")
_CKPT_RE = re.compile(r"^checkpoint_\d{6}$")
# Subdirectory of a checkpoint dir holding a sharded-state tree
# (written in place by TrainContext.report(sharded_state=...)).
SHARDED_SUBDIR = "sharded_state"


def _marker_name(world_rank: int, world_size: int) -> str:
    return f".committed_r{world_rank}_of_{world_size}"


_COMPLETE_MARKER = ".complete"


def _is_restorable(path: str) -> bool:
    """True if the checkpoint dir is complete. Markerless dirs (single-writer
    callers) are published by one atomic rename, so existing == complete.
    Dirs carrying per-rank commit markers are restorable only once the
    controller finalized the report round (`.complete`) — the set of ranks
    that WILL contribute files is only known to the controller (e.g. rank 0
    may be the sole checkpointing rank in a data-parallel run)."""
    try:
        names = os.listdir(path)
    except OSError:
        return False
    if any(_MARKER_RE.match(n) for n in names):
        return _COMPLETE_MARKER in names
    return True


class StorageContext:
    def __init__(
        self,
        storage_path: str,
        experiment_name: str | None = None,
        num_to_keep: int | None = None,
    ):
        self.storage_path = os.path.abspath(os.path.expanduser(storage_path))
        self.experiment_name = experiment_name or (
            f"run_{time.strftime('%Y%m%d-%H%M%S')}_{uuid.uuid4().hex[:6]}"
        )
        self.num_to_keep = num_to_keep
        self.experiment_dir = os.path.join(
            self.storage_path, self.experiment_name
        )
        os.makedirs(self.experiment_dir, exist_ok=True)
        self._persisted: list[tuple[int, str]] = []

    def checkpoint_dir(self, index: int) -> str:
        return os.path.join(self.experiment_dir, f"checkpoint_{index:06d}")

    def persist_checkpoint(
        self,
        local: Checkpoint,
        index: int,
        world_rank: int | None = None,
        world_size: int | None = None,
    ) -> Checkpoint:
        """Copy a worker-local checkpoint into the run dir.

        The first rank to persist an index renames a staged copy into place;
        later ranks MERGE their files into the existing directory — per-rank
        sharded checkpoints contribute distinct files from every rank, so
        first-writer-wins would silently drop ranks 1..N-1's shards
        (reference: train/v2/_internal/execution/storage.py
        persist_current_checkpoint merges via create_dir + copy_files).
        With (world_rank, world_size), a commit marker is stamped after this
        rank's files land; readers require the full marker set (see
        `_is_restorable`) before restoring.
        """
        final = self.checkpoint_dir(index)
        tmp = final + f".tmp_{uuid.uuid4().hex[:6]}"
        shutil.copytree(local.path, tmp)
        if world_rank is not None and world_size is not None:
            # Stamped inside tmp so the rename path publishes files+marker
            # atomically together.
            with open(os.path.join(tmp, _marker_name(world_rank, world_size)), "w"):
                pass
        renamed = False
        if not os.path.exists(final):
            try:
                os.rename(tmp, final)
                renamed = True
            except OSError:
                if not os.path.exists(final):
                    shutil.rmtree(tmp, ignore_errors=True)
                    raise
                # Lost the rename race: fall through and merge.
        if not renamed:
            # Merge: move each staged file into the final dir. os.replace is
            # atomic per file, so concurrent mergers interleave safely;
            # identical filenames (e.g. metadata written by every rank)
            # last-writer-win. The commit marker must land only after this
            # rank's data files, so it is moved explicitly last.
            marker = (
                _marker_name(world_rank, world_size)
                if world_rank is not None and world_size is not None
                else None
            )
            deferred = None
            for root, _dirs, files in os.walk(tmp):
                rel = os.path.relpath(root, tmp)
                dst_dir = final if rel == "." else os.path.join(final, rel)
                os.makedirs(dst_dir, exist_ok=True)
                for f in files:
                    if marker is not None and rel == "." and f == marker:
                        deferred = (os.path.join(root, f), os.path.join(dst_dir, f))
                        continue
                    os.replace(os.path.join(root, f), os.path.join(dst_dir, f))
            if deferred is not None:  # marker lands only after the files did
                os.replace(*deferred)
            shutil.rmtree(tmp, ignore_errors=True)
        # Track for retention on EVERY participation (not only rename wins):
        # each rank then prunes consistently, honoring num_to_keep even when
        # it always loses the rename race.
        if not any(i == index for i, _ in self._persisted):
            self._persisted.append((index, final))
            self._persisted.sort()
            self._apply_retention()
        return Checkpoint(final)

    def finalize_checkpoint(self, index: int) -> None:
        """Controller-side commit: called once every rank's report for
        ``index`` has been drained (so no rank is still merging files into
        the directory). Makes the checkpoint restorable."""
        final = self.checkpoint_dir(index)
        if os.path.isdir(final):
            with open(os.path.join(final, _COMPLETE_MARKER), "w"):
                pass

    def prune_incomplete(self) -> None:
        """Delete checkpoint dirs that carry rank markers but were never
        finalized (a gang died mid-round). Called at generation start, when
        no worker is writing: the next generation re-reports the same index
        and must not merge fresh shards into stale partial ones."""
        for d in os.listdir(self.experiment_dir):
            path = os.path.join(self.experiment_dir, d)
            if not _CKPT_RE.match(d) or not os.path.isdir(path):
                continue
            names = os.listdir(path)
            if any(_MARKER_RE.match(n) for n in names) and (
                _COMPLETE_MARKER not in names
            ):
                shutil.rmtree(path, ignore_errors=True)

    def _apply_retention(self) -> None:
        if self.num_to_keep is None:
            return
        while len(self._persisted) > self.num_to_keep:
            _, path = self._persisted.pop(0)
            shutil.rmtree(path, ignore_errors=True)

    def latest_checkpoint(self) -> Checkpoint | None:
        # Only complete checkpoints: markerless dirs are published by one
        # atomic rename; marked dirs need every rank's commit marker (a gang
        # failure mid-merge must not surface a checkpoint missing shards).
        dirs = sorted(
            (
                d
                for d in os.listdir(self.experiment_dir)
                if _CKPT_RE.match(d)
                and os.path.isdir(os.path.join(self.experiment_dir, d))
            ),
            reverse=True,
        )
        for d in dirs:
            path = os.path.join(self.experiment_dir, d)
            if _is_restorable(path):
                return Checkpoint(path)
        return None
