"""Backend ABC: per-framework worker-group setup hooks. Port of
``ray_tpu/train/backend.py`` (plain Python, copied as is).

Reference parity: python/ray/train/backend.py (Backend/BackendConfig) —
on_start wires up the framework's distributed runtime across the worker
group before the train loop runs.
"""

from __future__ import annotations


class BackendConfig:
    def backend_cls(self):
        return Backend


class Backend:
    def on_start(self, worker_group, backend_config) -> None:
        pass

    def on_reshape(self, worker_group, backend_config) -> None:
        """Re-wire the framework runtime after an elastic membership
        change (the group re-formed at a new world size, survivors kept
        their processes). Default: run the start hook again — backends
        whose runtime can't re-init in place override this."""
        self.on_start(worker_group, backend_config)

    def on_shutdown(self, worker_group, backend_config) -> None:
        pass
