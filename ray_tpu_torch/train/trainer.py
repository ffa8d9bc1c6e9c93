"""Trainers — the user-facing entry points of the train tier. Port of
``ray_tpu/train/trainer.py``.

Reference parity: python/ray/train/v2/api/data_parallel_trainer.py
(DataParallelTrainer, fit :154) and python/ray/train/v2/torch/
torch_trainer.py (TorchTrainer), the counterpart of the reference's
JaxTrainer (train/v2/jax/jax_trainer.py:19). The device work inside the
train loop is the user's program (the step of
:mod:`ray_tpu_torch.train.spmd`, over a mesh where the backend formed a
process group); the trainer does placement, process bootstrap,
health/failure handling, and checkpoint/report plumbing. ``datasets=``
needs the data tier, which is not ported: it raises ``NotPortedError``.
"""

from __future__ import annotations

from typing import Callable, Optional

from ray_tpu_torch.core.errors import NotPortedError
from ray_tpu_torch.train.backend import BackendConfig
from ray_tpu_torch.train.config import DataConfig, RunConfig, ScalingConfig
from ray_tpu_torch.train.controller import Result, TrainController, TrainingFailedError
from ray_tpu_torch.train.torch_backend import TorchConfig


class DataParallelTrainer:
    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[dict] = None,
        backend_config: Optional[BackendConfig] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[dict] = None,
        data_config: Optional[DataConfig] = None,
    ):
        if datasets:
            raise NotPortedError("the data tier (ray_tpu/data): a trainer's datasets=")
        del data_config  # it configures datasets= only
        self._train_fn = train_loop_per_worker
        self._train_loop_config = train_loop_config
        self._backend_config = backend_config or BackendConfig()
        self._scaling_config = scaling_config or ScalingConfig(num_workers=1)
        self._run_config = run_config or RunConfig()

    def fit(self) -> Result:
        """Run to completion; raises TrainingFailedError on unrecovered
        failure (after FailureConfig.max_failures group rebuilds)."""
        controller = TrainController(
            self._train_fn,
            self._train_loop_config,
            self._scaling_config,
            self._run_config,
            self._backend_config,
        )
        result = controller.run()
        if result.error is not None:
            raise result.error
        return result


class TorchTrainer(DataParallelTrainer):
    """DataParallelTrainer whose backend forms one ``torch.distributed``
    process group over the group (``torch_config=``, by default
    :class:`TorchConfig`: NCCL, one card a rank), as the reference's
    JaxTrainer takes ``jax_config=``."""

    def __init__(self, train_loop_per_worker, **kwargs):
        backend = kwargs.pop("torch_config", None) or kwargs.pop("backend_config", None)
        kwargs["backend_config"] = backend if backend is not None else TorchConfig()
        super().__init__(train_loop_per_worker, **kwargs)


__all__ = [
    "DataParallelTrainer",
    "TorchTrainer",
    "Result",
    "TrainingFailedError",
]
