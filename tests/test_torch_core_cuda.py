"""The port's runtime on the card: a CUDA bf16 tensor returned from a
``num_gpus=1`` task, and one put from this process, arrive as host tensors
with their dtype, shape and bits.

The test carries the ``cuda`` marker and skips without a card. This file
imports neither jax nor the JAX package, so it runs on a machine that has
only PyTorch:

    python -m pytest tests/test_torch_core_cuda.py -m cuda --noconftest -q
"""

import pytest
import torch

import ray_tpu_torch

pytestmark = pytest.mark.cuda

SHAPE = (1024, 2048)


def _seeded_bf16(device):
    g = torch.Generator(device=device).manual_seed(3)
    return torch.randn(SHAPE, generator=g, device=device, dtype=torch.float32).to(torch.bfloat16)


@pytest.fixture(scope="module")
def runtime():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ray_tpu_torch.init(num_cpus=2)
    yield
    ray_tpu_torch.shutdown()


def test_cuda_tensor_from_a_gpu_task_arrives_on_the_host(runtime):
    assert ray_tpu_torch.cluster_resources()["GPU"] == float(torch.cuda.device_count())

    @ray_tpu_torch.remote(num_gpus=1)
    def make():
        import torch

        g = torch.Generator(device="cuda").manual_seed(3)
        t = torch.randn(SHAPE, generator=g, device="cuda", dtype=torch.float32).to(torch.bfloat16)
        return t, t.device.type

    got, made_on = ray_tpu_torch.get(make.remote(), timeout=120)
    want = _seeded_bf16("cuda").cpu()
    assert made_on == "cuda"
    assert got.device.type == "cpu" and got.dtype == torch.bfloat16 and got.shape == SHAPE
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_cuda_tensor_put_from_this_process(runtime):
    t = _seeded_bf16("cuda")
    got = ray_tpu_torch.get(ray_tpu_torch.put(t), timeout=60)
    assert got.device.type == "cpu" and got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), t.cpu().view(torch.int16))
