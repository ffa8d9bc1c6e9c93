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
(:mod:`ray_tpu_torch.data` datasets) are materialised once; each worker's
context then holds a ``DataIterator`` over its shard, read in the train
fn through :func:`ray_tpu_torch.train.get_dataset_shard`.
"""

from __future__ import annotations

from typing import Callable, Optional

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
        self._train_fn = train_loop_per_worker
        self._train_loop_config = train_loop_config
        self._backend_config = backend_config or BackendConfig()
        self._scaling_config = scaling_config or ScalingConfig(num_workers=1)
        self._run_config = run_config or RunConfig()
        self._datasets = datasets or {}
        self._data_config = data_config or DataConfig()

    def fit(self) -> Result:
        """Run to completion; raises TrainingFailedError on unrecovered
        failure (after FailureConfig.max_failures group rebuilds)."""
        controller = TrainController(
            self._wrapped_train_fn(),
            self._train_loop_config,
            self._scaling_config,
            self._run_config,
            self._backend_config,
        )
        result = controller.run()
        if result.error is not None:
            raise result.error
        return result

    def _wrapped_train_fn(self):
        train_fn = self._train_fn
        if not self._datasets:
            return train_fn
        # Materialize to object refs before closure capture: the train fn is
        # cloudpickled to every worker, and in-memory datasets (from_numpy /
        # from_pandas) would otherwise ship N full copies of the data through
        # the actor-call path instead of block refs through the object store.
        datasets = {name: ds.materialize() for name, ds in self._datasets.items()}
        prefetch_depth = self._data_config.prefetch_depth

        from ray_tpu_torch.train.context import get_context

        def with_datasets(*maybe_config):
            # Per-worker dataset shards land in the context before the loop
            # (reference: streaming_split feeding RayTrainWorkers). The
            # DataConfig prefetch depth rides along so iter_device_batches
            # stages batches on the device without per-loop plumbing.
            from ray_tpu_torch.data.iterator import DataIterator

            ctx = get_context()
            ctx.dataset_shards = {
                name: DataIterator(
                    ds.shard(ctx.get_world_size(), ctx.get_world_rank()),
                    prefetch_depth=prefetch_depth,
                )
                for name, ds in datasets.items()
            }
            return train_fn(*maybe_config)

        return with_datasets


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
