"""Training: the train step (:mod:`ray_tpu_torch.train.spmd`), sharded
checkpoints, and the train tier (a port of ``ray_tpu/train``): trainers,
the worker group and its controller, ``report``/``get_context``, the async
report ring and the device prefetch iterator.

The step machinery is importable without the cluster runtime; the
trainer/controller/worker-group stack builds on :mod:`ray_tpu_torch.core`
and loads on first use. ``TorchTrainer``/``TorchConfig`` stand where the
reference's ``JaxTrainer``/``JaxConfig`` stand.

Reference parity: python/ray/train/ (v2 API surface — Checkpoint, report,
get_context, ScalingConfig/RunConfig/FailureConfig/CheckpointConfig,
DataParallelTrainer, TorchTrainer, Result).
"""

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    DataConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.context import (
    get_checkpoint,
    get_context,
    get_dataset_shard,
    get_elastic_state,
    report,
)
from ray_tpu_torch.train.input import DevicePrefetchIterator
from ray_tpu_torch.train.sharded_checkpoint import (
    load_sharded_state,
    restore_sharded,
    restore_template,
    save_sharded,
)
from ray_tpu_torch.train.spmd import (
    TrainState,
    compile_train_step,
    make_train_state,
    make_train_step,
    state_shardings,
)
from ray_tpu_torch.train.torch_backend import TorchConfig

__all__ = [
    "Checkpoint",
    "CheckpointConfig",
    "DataConfig",
    "DevicePrefetchIterator",
    "FailureConfig",
    "RunConfig",
    "ScalingConfig",
    "TorchConfig",
    "TrainState",
    "compile_train_step",
    "get_checkpoint",
    "get_context",
    "get_dataset_shard",
    "get_elastic_state",
    "load_sharded_state",
    "make_train_state",
    "make_train_step",
    "report",
    "restore_sharded",
    "restore_template",
    "save_sharded",
    "state_shardings",
    # lazy (import the runtime stack only when asked for)
    "DataParallelTrainer",
    "TorchTrainer",
    "Result",
    "TrainingFailedError",
]

_LAZY = {
    "DataParallelTrainer": "ray_tpu_torch.train.trainer",
    "TorchTrainer": "ray_tpu_torch.train.trainer",
    "Result": "ray_tpu_torch.train.controller",
    "TrainingFailedError": "ray_tpu_torch.train.controller",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module 'ray_tpu_torch.train' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)
