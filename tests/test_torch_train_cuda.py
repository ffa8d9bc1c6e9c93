"""The train tier on the card: the device prefetch iterator's staging on
its side stream, the async report ring's pinned host copies, and
``TorchConfig()`` forming a one-rank NCCL group.

The tests carry the ``cuda`` marker and skip without a card. This file
imports neither jax nor the JAX package, so it runs on a machine that has
only PyTorch:

    python -m pytest tests/test_torch_train_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.train import context, torch_backend
from ray_tpu_torch.train.input import DevicePrefetchIterator

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def test_prefetch_stages_on_a_side_stream_and_marks_the_consumer(card, monkeypatch):
    """Pinned host batches land on the card with their values; each staged
    tensor was allocated on the iterator's own stream and is marked as used
    on the consumer's (record_stream), which waits for the copies."""
    marked = []
    real = torch.Tensor.record_stream

    def record(t, stream):
        marked.append((t.data_ptr(), stream))
        return real(t, stream)

    monkeypatch.setattr(torch.Tensor, "record_stream", record)
    host = [{"x": torch.arange(4096, dtype=torch.float32).reshape(64, 64).add(i).pin_memory(),
             "n": np.full((3,), i, np.int64)} for i in range(5)]
    it = DevicePrefetchIterator(iter(host), depth=2, device=card)
    assert it._stream is not None and it._stream != torch.cuda.current_stream(card)
    consumer = torch.cuda.current_stream(card)
    out = []
    for batch in it:
        assert batch["x"].device == card and batch["n"].device == card
        out.append({k: v.clone() for k, v in batch.items()})  # on the consumer stream
    torch.cuda.synchronize()
    assert len(out) == 5
    for i, b in enumerate(out):
        assert torch.equal(b["x"].cpu(), host[i]["x"])
        assert b["n"].cpu().tolist() == [i] * 3
    assert len(marked) == 10 and all(s == consumer for _, s in marked)


def test_prefetch_takes_the_ranks_block_before_the_copy(card):
    from ray_tpu_torch.parallel import Mesh, MeshSpec, NamedSharding, P

    class _Rank1:
        def get_local_rank(self, axis):
            return 1

    sh = NamedSharding(Mesh(MeshSpec(dp=2), _Rank1()), P("dp"))
    host = [torch.arange(32, dtype=torch.float32).reshape(8, 4)]
    [got] = list(DevicePrefetchIterator(iter(host), sharding=sh, depth=1, device=card))
    assert got.shape == (4, 4) and torch.equal(got.cpu(), host[0][4:])


def test_ring_copies_into_pinned_host_memory_on_a_side_stream(card):
    saved = (GLOBAL_CONFIG.train_async_dispatch, GLOBAL_CONFIG.train_async_dispatch_depth)
    GLOBAL_CONFIG.train_async_dispatch, GLOBAL_CONFIG.train_async_dispatch_depth = True, 2
    try:
        loss = torch.full((), 2.5, device=card)
        staged = context._start_host_copy({"loss": loss * 2, "v": torch.ones(3, device=card)})
        assert staged.tree["loss"].is_pinned() and staged.tree["v"].is_pinned()
        assert len(staged.done) == 1
        host = context._materialize_metrics(staged)
        assert host["loss"] == 5.0 and type(host["loss"]) is float
        assert isinstance(host["v"], np.ndarray) and host["v"].tolist() == [1.0] * 3
        ctx = context.TrainContext(experiment_name="t", world_size=1, world_rank=0, local_rank=0,
                                   local_world_size=1, node_rank=0)
        for i in range(4):
            ctx.report({"loss": torch.full((), float(i), device=card), "step": i})
        evicted = ctx.drain_reports()
        ctx.flush()
        rest = ctx.drain_reports()
    finally:
        GLOBAL_CONFIG.train_async_dispatch, GLOBAL_CONFIG.train_async_dispatch_depth = saved
    assert [r["metrics"] for r in evicted] == [{"loss": 0.0, "step": 0}, {"loss": 1.0, "step": 1}]
    assert [r["metrics"] for r in rest] == [{"loss": 2.0, "step": 2}, {"loss": 3.0, "step": 3}]
    assert all(type(r["metrics"]["loss"]) is float for r in evicted + rest)


def test_torch_config_forms_a_one_rank_nccl_group(card):
    import torch.distributed as dist

    from ray_tpu_torch.util.net import free_port

    assert torch_backend.TorchConfig().backend == "nccl"
    try:
        got = torch_backend._torch_init_worker(
            "cuda", "nccl", f"tcp://127.0.0.1:{free_port()}", 1, 0, 0)
        assert got == f"cuda:{0 % torch.cuda.device_count()}"
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        t = torch.ones(8, device=card)
        dist.all_reduce(t)
        assert torch.equal(t.cpu(), torch.ones(8))
        assert torch_backend.train_device() == torch.device(got)
    finally:
        torch_backend._torch_shutdown_worker()
        torch_backend._device = None
    assert not dist.is_initialized()
