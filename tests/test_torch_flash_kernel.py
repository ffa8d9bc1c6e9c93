"""The CUDA flash-attention kernels against their plain versions, on the card.

Every test here needs an sm_90 GPU and ``nvcc``: they carry the ``cuda``
marker and skip without a card. This file imports neither jax nor the JAX
package, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_flash_kernel.py -m cuda --noconftest -q
"""

import dataclasses

import pytest
import torch

from ray_tpu_torch.models import gpt2, llama
from ray_tpu_torch.ops import attention
from ray_tpu_torch.train.spmd import tree_leaves

pytestmark = pytest.mark.cuda

# bf16 O: the kernel and the plain version round p to bf16 against different
# running maxima, then O to bf16 (unit roundoff 2^-9 of |O| <= max|v| ~ 5).
O_TOL = 2e-2
# LSE: f32 throughout, only the summation order differs.
LSE_TOL = 1e-2
# dq, dk, dv, as max abs error over the largest magnitude of each: p and dS
# are rounded to bf16 in both versions, but a 1-ulp (2^-8) flip of either,
# from f32 sums in another order, moves a product summed over up to S rows,
# and each result is then rounded to bf16 itself.
BWD_TOL = 2e-2


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


# (B, S) of the kernel checks: every edge of the 64- and 128-row tiles at
# B=1 (serving), and the shapes of a small and of the real training batch.
SHAPES = [(1, S) for S in (1, 17, 63, 64, 65, 100, 127, 128, 129, 255, 1024, 2048)]
SHAPES += [(2, 256), (8, 1024)]


@pytest.mark.parametrize("B,S", SHAPES)
def test_kernel_matches_plain_version(card, B, S):
    q, k, v = _qkv_views(S, card, B=B, seed=S)
    scale = 0.125
    before = attention.flash_fwd_launches
    o, lse = attention.flash_attention_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    assert attention.flash_fwd_launches == before + 1
    o_ref, lse_ref = attention.flash_attention_fwd_reference(q, k, v, scale)
    assert o.shape == (B, 12, S, 64) and lse.shape == (B, 12, S, 1)
    assert (o.float() - o_ref.float()).abs().max().item() <= O_TOL
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL
    # causal_attention dispatches a CUDA tensor to the kernel.
    assert attention.uses_flash_kernel(q)
    out = attention.causal_attention(q, k, v, scale=scale)
    assert torch.equal(out, o)


@pytest.mark.parametrize("S", [100, 1024])
def test_kernel_takes_llama_gqa_layout(card, S):
    """Llama's dense prefill hands the kernel a contiguous q (out of RoPE's
    concatenation) and K/V expanded from 4 KV heads by repeat_interleave;
    the kernel takes them as they are and agrees with its plain version.
    Llama-125M's head_dim is 64, the kernel's."""
    g = torch.Generator(device=card).manual_seed(S)
    q = torch.randn((1, 12, S, 64), generator=g, device=card).to(torch.bfloat16)
    k, v = (
        torch.randn((1, 4, S, 64), generator=g, device=card).to(torch.bfloat16)
        .repeat_interleave(3, dim=1)
        for _ in range(2)
    )
    assert all(attention._kernel_layout_ok(t) for t in (q, k, v))
    before = attention.flash_fwd_launches
    o, lse = attention.flash_attention_fwd(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert attention.flash_fwd_launches == before + 1
    o_ref, lse_ref = attention.flash_attention_fwd_reference(q, k, v, 0.125)
    assert (o.float() - o_ref.float()).abs().max().item() <= O_TOL
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL


def test_no_heads_launch_nothing(card):
    """A tensor-parallel rank past the head count hands the wrappers zero
    heads: no kernel launches (the grid would be empty), and the outputs
    are empty of the right shapes."""
    q, k, v = (t[:, :0] for t in _qkv_views(64, card))
    fwd, bwd = attention.flash_fwd_launches, attention.flash_bwd_launches
    o, lse = attention.flash_attention_fwd(q, k, v, 0.125)
    assert o.shape == q.shape and lse.shape == (1, 0, 64, 1)
    grads = attention.flash_attention_bwd(q, k, v, o, lse, torch.zeros_like(o), 0.125)
    assert [g.shape for g in grads] == [q.shape] * 3
    assert (attention.flash_fwd_launches, attention.flash_bwd_launches) == (fwd, bwd)


def test_kernel_refuses_what_it_cannot_take(card):
    q, k, v = _qkv_views(64, card)
    with pytest.raises(TypeError, match="bfloat16"):
        attention.causal_attention(q.float(), k.float(), v.float(), impl="cuda")
    q32 = torch.zeros((1, 2, 64, 32), dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        attention.causal_attention(q32, q32, q32, impl="cuda")
    # An input that requires grad goes through the autograd Function to the
    # kernel (the forward-only guard went with the backward kernel's port).
    before = attention.flash_fwd_launches
    o = attention.causal_attention(q.detach().requires_grad_(), k, v)
    assert o.requires_grad and attention.flash_fwd_launches == before + 1
    o, lse = attention.flash_attention_fwd(q, k, v, 0.125)
    with pytest.raises(TypeError, match="bfloat16"):
        attention.flash_attention_bwd(q, k, v, o, lse, o.float(), 0.125)
    with pytest.raises(ValueError, match="lse"):
        attention.flash_attention_bwd(q, k, v, o, lse[..., 0], o, 0.125)


def _grad_inputs(S, dev, B=1, H=12, seed=0):
    """q, k, v as strided head views of one projection, and dO as training
    hands it to the backward: the gradient of O, laid out [B, S, H, D]."""
    q, k, v = _qkv_views(S, dev, B=B, H=H, seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    do = torch.randn((B, S, H, 64), generator=g, device=dev).to(torch.bfloat16)
    return q, k, v, do.transpose(1, 2)


def _rel_err(got, want):
    """Max abs error over the largest magnitude of ``want``, floored at 1e-2:
    at S=1, dq and dk are zero but for rounding (dP - delta cancels), and
    both versions give noise of about 1e-7."""
    scale = max(want.float().abs().max().item(), 1e-2)
    return (got.float() - want.float()).abs().max().item() / scale


@pytest.mark.parametrize("B,S", SHAPES)
def test_backward_kernel_matches_plain_version(card, B, S):
    q, k, v, do = _grad_inputs(S, card, B=B, seed=S)
    scale = 0.125
    o, lse = attention.flash_attention_fwd(q, k, v, scale)
    before = attention.flash_bwd_launches
    got = attention.flash_attention_bwd(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    assert attention.flash_bwd_launches == before + 1
    want = attention.flash_attention_bwd_reference(q, k, v, o, lse, do, scale)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == (B, 12, S, 64) and g.dtype == torch.bfloat16
        assert bool(torch.isfinite(g.float()).all()), f"d{name}"
        assert _rel_err(g, w) <= BWD_TOL, f"d{name}"


def test_backward_kernel_is_deterministic(card):
    q, k, v, do = _grad_inputs(1024, card, B=2, seed=7)
    o, lse = attention.flash_attention_fwd(q, k, v, 0.125)
    first = attention.flash_attention_bwd(q, k, v, o, lse, do, 0.125)
    second = attention.flash_attention_bwd(q, k, v, o, lse, do, 0.125)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_autograd_runs_both_kernels(card):
    """A CUDA tensor that needs grad runs the forward kernel, then the
    backward kernel, and never the plain versions."""
    q, k, v, do = _grad_inputs(300, card, B=2, seed=3)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    before = (attention.flash_fwd_launches, attention.flash_bwd_launches)
    o = attention.causal_attention(*leaves, scale=0.125)
    got = torch.autograd.grad(o, leaves, do)
    assert (attention.flash_fwd_launches, attention.flash_bwd_launches) == (
        before[0] + 1, before[1] + 1
    )
    o_ref, lse = attention.flash_attention_fwd_reference(q, k, v, 0.125)
    want = attention.flash_attention_bwd_reference(q, k, v, o_ref, lse, do, 0.125)
    for name, g, w in zip("qkv", got, want):
        assert _rel_err(g, w) <= BWD_TOL, f"d{name}"
    # The gradient of a sum arrives expanded (zero strides); it is laid out
    # for the kernel, not refused.
    o = attention.flash_attention(*leaves, 0.125)
    o.float().sum().backward()
    assert attention.flash_bwd_launches == before[1] + 2
    assert all(bool(torch.isfinite(t.grad.float()).all()) for t in leaves)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_remat_policies_on_the_card(card, family):
    """A tiny GPT-2 or Llama (head_dim 64; Llama's K/V repeated from 1 KV
    head) trained on the card: each remat policy gives the same gradients,
    and the kernels launch once a layer under "none" and "mlp", the forward
    twice under "dots" and "full" (the checkpoint re-runs it in backward)."""
    model = gpt2 if family == "gpt2" else llama
    shape = dict(n_layer=2, d_model=128, n_head=2, vocab_size=512, max_seq=128)
    if family == "llama":
        shape["n_kv_head"] = 1
    config = gpt2.GPT2Config if family == "gpt2" else llama.LlamaConfig
    base = config.tiny(**shape)
    params = model.init_params(torch.Generator(device=card).manual_seed(0), base, device=card)
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    g = torch.Generator(device=card).manual_seed(1)
    batch = {"tokens": torch.randint(0, 512, (2, 129), generator=g, device=card)}
    grads = {}
    for remat, fwd_per_layer in (("none", 1), ("mlp", 1), ("dots", 2), ("full", 2)):
        cfg = dataclasses.replace(base, remat=remat, loss_chunk=0)
        before = (attention.flash_fwd_launches, attention.flash_bwd_launches)
        loss, _ = model.loss_fn(params, batch, cfg)
        grads[remat] = torch.autograd.grad(loss, leaves)
        launched = (attention.flash_fwd_launches - before[0], attention.flash_bwd_launches - before[1])
        assert launched == (fwd_per_layer * base.n_layer, base.n_layer), remat
    for remat, gs in grads.items():
        assert all(torch.equal(a, b) for a, b in zip(gs, grads["none"])), remat
