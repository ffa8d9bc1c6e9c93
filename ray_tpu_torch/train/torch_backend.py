"""Torch backend: forms one ``torch.distributed`` process group over the
worker group. The port's counterpart of ``ray_tpu/train/jax_backend.py``.

Reference parity: python/ray/train/torch/config.py (TorchConfig,
_TorchBackend: worker 0's address and a free port become the rendezvous,
every worker runs ``init_process_group``) in the place of the reference's
JaxConfig (worker 0's address becomes the coordinator, every worker runs
``jax.distributed.initialize(coordinator, num_workers, index)``). Workers
are already rank-sorted, so ranks are stable across restarts.

Each rank trains on the card ``local_rank % device_count()``: the runtime
sets no ``CUDA_VISIBLE_DEVICES``, so every worker of a node sees every
card. NCCL refuses two ranks on one card; where ranks share a card, pass
``TorchConfig(backend="gloo")``. A worker asked for ``"cuda"`` that sees no
card raises; nothing falls back to the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import cloudpickle

from ray_tpu_torch.core.errors import NotPortedError
from ray_tpu_torch.train.backend import Backend, BackendConfig

# The device this process's rank trains on (set by _torch_init_worker):
# the train fn's thread makes it current (enter_device), and the elastic
# plane lands pulled state there.
_device = None


@dataclass
class TorchConfig(BackendConfig):
    """distributed: start a process group across the group (turn off for
    single-worker debug runs). backend: ``"nccl"`` (one card a rank) or
    ``"gloo"`` (ranks sharing a card, or the CPU). device: ``"cuda"`` (the
    card) or ``"cpu"`` (tests), the counterpart of JaxConfig's platform.
    num_slices: the reference's multi-slice field; above 1 raises
    ``NotPortedError``."""

    distributed: bool = True
    backend: str = "nccl"
    device: str = "cuda"
    num_slices: int = 1

    def __post_init__(self):
        if self.num_slices > 1:
            raise NotPortedError(f"multi-slice training (TorchConfig.num_slices={self.num_slices})")
        if self.device not in ("cuda", "cpu"):
            raise ValueError(f"TorchConfig.device must be 'cuda' or 'cpu', got {self.device!r}")

    def backend_cls(self):
        return _TorchBackend


def train_device(default: str = "cpu"):
    """The device this rank trains on: the backend's choice, else
    ``default`` (``"cuda"``: the current card)."""
    import torch

    if _device is not None:
        return _device
    if default == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(default)


def enter_device() -> None:
    """Make the backend's card current on the calling thread (the current
    device is per thread, and the train fn runs on its own thread)."""
    if _device is not None and _device.type == "cuda":
        import torch

        torch.cuda.set_device(_device)


def _torch_shutdown_worker():
    """Tear down the process group inside a surviving worker so the
    elastic re-formation can start another at the new world size (the
    default group is process-global; a second init raises)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    return True


def _torch_init_worker(
    device: str,
    backend: Optional[str],
    init_method: Optional[str],
    world_size: int,
    rank: int,
    local_rank: int,
):
    """Runs inside each train worker before the train fn: pick the card,
    then join the process group (backend None: no group)."""
    global _device
    import torch
    import torch.distributed as dist

    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "TorchConfig(device='cuda') on a worker that sees no CUDA device "
                "(pass device='cpu' to train on the host)"
            )
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    _device = dev
    if backend is not None and not dist.is_initialized():
        kw = dict(device_id=dev) if backend == "nccl" else {}
        dist.init_process_group(
            backend, init_method=init_method, world_size=world_size, rank=rank, **kw
        )
    return str(dev)


class _TorchBackend(Backend):
    def on_start(self, worker_group, backend_config: TorchConfig) -> None:
        import ray_tpu_torch

        workers = worker_group.workers
        n = len(workers)
        init_method = None
        if backend_config.distributed and n >= 1:
            head = workers[0]
            port = ray_tpu_torch.get(head.actor.free_port.remote(), timeout=60)
            ip = head.metadata.get("ip") or "127.0.0.1"
            init_method = f"tcp://{ip}:{port}"
        payload = cloudpickle.dumps(_torch_init_worker)
        backend = backend_config.backend if backend_config.distributed else None
        local_ranks = [spec["local_rank"] for spec in worker_group.context_specs(None, None)]
        refs = [
            w.actor.execute.remote(
                payload, backend_config.device, backend, init_method, n, w.world_rank, lr
            )
            for w, lr in zip(workers, local_ranks)
        ]
        ray_tpu_torch.get(refs, timeout=300)

    def on_reshape(self, worker_group, backend_config: TorchConfig) -> None:
        """Live re-init at the new world size: survivors destroy their old
        process group (its rank 0 may be on a preempted node), then the
        start hook forms a new one with the new rank 0 as rendezvous."""
        import ray_tpu_torch

        if backend_config.distributed:
            payload = cloudpickle.dumps(_torch_shutdown_worker)
            ray_tpu_torch.get(
                [w.actor.execute.remote(payload) for w in worker_group.workers],
                timeout=120,
            )
        self.on_start(worker_group, backend_config)
