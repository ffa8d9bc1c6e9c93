"""Device objects and the data tier's device terminus on the card: a
``DeviceRef`` to a CUDA tensor held by an actor lands on the caller's
card with its bits, over the fabric (a pull, no fallback), and
``iter_device_batches`` yields CUDA tensors by default.

The tests carry the ``cuda`` marker and skip without a card. This file
imports neither jax nor the JAX package, so it runs on a machine that has
only PyTorch:

    python -m pytest tests/test_torch_data_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cluster():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import ray_tpu_torch

    runtime = ray_tpu_torch.init(num_cpus=4)
    yield runtime
    ray_tpu_torch.shutdown()


def test_a_device_ref_lands_on_the_callers_card(cluster):
    import ray_tpu_torch as rt
    from ray_tpu_torch.experimental import device_get, transfer_stats

    @rt.remote(num_gpus=0.5)
    class Producer:
        def make(self):
            import torch

            from ray_tpu_torch.experimental import device_put

            g = torch.Generator(device="cuda").manual_seed(3)
            self.t = torch.randn(256, 128, device="cuda", generator=g).to(torch.bfloat16)
            return device_put(self.t)

    p = Producer.remote()
    ref = rt.get(p.make.remote(), timeout=120)
    assert (ref.shape, ref.dtype, ref.device) == ((256, 128), "bfloat16", "cuda")
    before = transfer_stats()
    out = device_get(ref)
    after = transfer_stats()
    assert out.device.type == "cuda" and out.dtype == torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(3)
    want = torch.randn(256, 128, device="cuda", generator=g).to(torch.bfloat16)
    assert torch.equal(out, want)
    assert (after["pulls"] - before["pulls"], after["fallbacks"] - before["fallbacks"]) == (1, 0)
    assert device_get(ref, device="cpu").device.type == "cpu"
    rt.kill(p)


def test_iter_device_batches_yields_cuda_tensors(cluster):
    import ray_tpu_torch.data as rd
    from ray_tpu_torch.data.iterator import DataIterator

    rows = np.arange(64 * 9, dtype=np.int32).reshape(64, 9)
    it = DataIterator(rd.from_numpy(rows, column="tokens"), prefetch_depth=2)
    seen = []
    for batch in it.iter_device_batches(batch_size=16):
        assert batch["tokens"].device.type == "cuda"
        seen.append(batch["tokens"].cpu().numpy())
    np.testing.assert_array_equal(np.concatenate(seen), rows)
