"""Checkpoint: a directory handle, the unit of training persistence. Port
of ``ray_tpu/train/checkpoint.py`` (plain Python, as there): a directory on
a local or shared filesystem, ``from_directory``/``to_directory``/
``as_directory``, and a JSON metadata sidecar."""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile
import uuid

_METADATA_FILE = ".metadata.json"


class Checkpoint:
    """A handle to a checkpoint directory on a filesystem."""

    def __init__(self, path: str):
        self.path = os.path.abspath(os.fspath(path))

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        if not os.path.isdir(path):
            raise ValueError(f"not a directory: {path}")
        return cls(path)

    def to_directory(self, path: str | None = None) -> str:
        """Materialize the checkpoint into ``path`` (default: a fresh temp
        dir) and return it."""
        if path is None:
            path = os.path.join(tempfile.gettempdir(), f"ckpt_{uuid.uuid4().hex[:8]}")
        path = os.path.abspath(path)
        if path != self.path:
            if os.path.exists(path):
                shutil.rmtree(path)
            shutil.copytree(self.path, path)
        return path

    @contextlib.contextmanager
    def as_directory(self):
        """Local directory view. A local checkpoint is yielded in place (no
        copy); a remote backend would download to a temp dir."""
        yield self.path

    # -- metadata ------------------------------------------------------------

    def get_metadata(self) -> dict:
        meta_path = os.path.join(self.path, _METADATA_FILE)
        if not os.path.exists(meta_path):
            return {}
        with open(meta_path) as f:
            return json.load(f)

    def set_metadata(self, metadata: dict) -> None:
        with open(os.path.join(self.path, _METADATA_FILE), "w") as f:
            json.dump(metadata, f)

    def update_metadata(self, metadata: dict) -> None:
        merged = self.get_metadata()
        merged.update(metadata)
        self.set_metadata(merged)

    def __repr__(self):
        return f"Checkpoint(path={self.path!r})"

    def __eq__(self, other):
        return isinstance(other, Checkpoint) and other.path == self.path
