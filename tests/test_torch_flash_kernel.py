"""The CUDA flash-attention forward against its plain version, on the card.

Every test here needs an sm_90 GPU and ``nvcc``: they carry the ``cuda``
marker and skip without a card. This file imports neither jax nor the JAX
package, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_flash_kernel.py -m cuda --noconftest -q
"""

import pytest
import torch

from ray_tpu_torch.ops import attention

pytestmark = pytest.mark.cuda

# bf16 O: the kernel and the plain version round p to bf16 against different
# running maxima, then O to bf16 (unit roundoff 2^-9 of |O| <= max|v| ~ 5).
O_TOL = 2e-2
# LSE: f32 throughout, only the summation order differs.
LSE_TOL = 1e-2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernel is built for sm_90a")
    return torch.device("cuda", 0)


def _qkv_views(S, dev, B=1, H=12, D=64, seed=0):
    """q, k, v as the strided views prefill hands the kernel: heads split
    out of one [B, S, 3*H*D] projection."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((B, S, 3 * H * D), generator=g, device=dev).to(torch.bfloat16)
    return [t.reshape(B, S, H, D).transpose(1, 2) for t in qkv.split(H * D, dim=-1)]


@pytest.mark.parametrize("S", [1, 17, 64, 100, 129, 1024])
def test_kernel_matches_plain_version(card, S):
    q, k, v = _qkv_views(S, card, seed=S)
    scale = 0.125
    before = attention.flash_fwd_launches
    o, lse = attention.flash_attention_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    assert attention.flash_fwd_launches == before + 1
    o_ref, lse_ref = attention.flash_attention_fwd_reference(q, k, v, scale)
    assert o.shape == (1, 12, S, 64) and lse.shape == (1, 12, S, 1)
    assert (o.float() - o_ref.float()).abs().max().item() <= O_TOL
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL
    # causal_attention dispatches a CUDA tensor to the kernel.
    assert attention.uses_flash_kernel(q)
    out = attention.causal_attention(q, k, v, scale=scale)
    assert torch.equal(out, o)


def test_kernel_refuses_what_it_cannot_take(card):
    q, k, v = _qkv_views(64, card)
    with pytest.raises(TypeError, match="bfloat16"):
        attention.causal_attention(q.float(), k.float(), v.float(), impl="cuda")
    q32 = torch.zeros((1, 2, 64, 32), dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        attention.causal_attention(q32, q32, q32, impl="cuda")
    with pytest.raises(RuntimeError, match="forward only"):
        attention.causal_attention(q.detach().requires_grad_(), k, v)
