"""The port's causal attention against the JAX package's, on the CPU.

The same numpy inputs go through ``ray_tpu.ops.attention`` (its Pallas flash
kernel in interpret mode, and its jnp reference) and through
``ray_tpu_torch.ops.attention`` (its plain versions: a CPU tensor never
reaches the CUDA kernel). Tolerance: rtol=atol=1e-4 in f32, the JAX suite's
own for interpret-vs-reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jax_attn
from ray_tpu_torch.ops import attention as pt_attn

TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, B, H, S, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, S, D), dtype=np.float32) for _ in range(3)]


# S=96 with block_q != block_k exercises the diagonal-straddling mask
# (as tests/test_ops_attention.py does); B*H > 1 in both.
CASES = [
    pytest.param(64, 32, 32, 32, id="S64"),
    pytest.param(96, 16, 32, 48, id="S96-uneven-blocks"),
]


@pytest.mark.parametrize("S,D,block_q,block_k", CASES)
def test_causal_attention_matches_jax(S, D, block_q, block_k):
    q, k, v = _inputs(S, 2, 2, S, D)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    flash = np.asarray(
        jax_attn.causal_attention(
            jq, jk, jv, impl="pallas", block_q=block_q, block_k=block_k, interpret=True
        )
    )
    ref = np.asarray(jax_attn.causal_attention(jq, jk, jv, impl="reference"))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    ours = pt_attn.causal_attention(tq, tk, tv, impl="reference").numpy()
    auto = pt_attn.causal_attention(tq, tk, tv).numpy()  # CPU tensor: plain path
    for got in (ours, auto):
        np.testing.assert_allclose(got, flash, **TOL)
        np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("S,D,block_q,block_k", CASES)
def test_flash_fwd_reference_matches_pallas_kernel_with_lse(S, D, block_q, block_k):
    """The plain twin of the CUDA kernel returns the Pallas kernel's O and
    its log-sum-exp, both in base 2."""
    q, k, v = _inputs(100 + S, 2, 3, S, D)
    scale = 1.0 / np.sqrt(D)
    o_j, lse_j = jax_attn._flash_attention_fwd_impl(
        *map(jnp.asarray, (q, k, v)), scale, block_q, block_k, interpret=True
    )
    o_t, lse_t = pt_attn.flash_attention_fwd_reference(
        *map(torch.from_numpy, (q, k, v)), scale
    )
    assert lse_t.shape == (2, 3, S, 1) and lse_t.dtype == torch.float32
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **TOL)
    # flash_attention_fwd on a CPU tensor is the same plain version.
    o_w, lse_w = pt_attn.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), scale)
    assert torch.equal(o_w, o_t) and torch.equal(lse_w, lse_t)


def test_ragged_sequence_needs_no_divisibility():
    """The port has no divisibility fallback: any S works on the plain path
    (the CUDA kernel masks its own ragged edge)."""
    q, k, v = _inputs(7, 1, 2, 100, 16)
    ref = np.asarray(jax_attn.causal_attention(*map(jnp.asarray, (q, k, v)), impl="reference"))
    ours = pt_attn.causal_attention(*map(torch.from_numpy, (q, k, v)), block_q=32, block_k=32)
    np.testing.assert_allclose(ours.numpy(), ref, **TOL)


def test_cpu_tensor_never_reaches_the_kernel():
    q = torch.zeros(1, 1, 8, 64)
    assert not pt_attn.uses_flash_kernel(q)
    assert not pt_attn.uses_flash_kernel(q, impl="reference")
    assert not pt_attn.uses_flash_kernel(q, impl="cuda")  # causal_attention raises
    before = pt_attn.flash_fwd_launches
    with pytest.raises(ValueError, match="CUDA"):
        pt_attn.causal_attention(q, q, q, impl="cuda")
    with pytest.raises(ValueError, match="unknown attention impl"):
        pt_attn.causal_attention(q, q, q, impl="pallas")
    pt_attn.causal_attention(q, q, q)
    assert pt_attn.flash_fwd_launches == before


@pytest.mark.parametrize("S,D,block_q,block_k", CASES)
def test_flash_attention_gradients_match_pallas_interpret(S, D, block_q, block_k):
    """jax.grad through the Pallas flash kernels (interpret mode) against
    torch.autograd through the port's flash Function, which runs the plain
    forward and backward for CPU tensors."""
    q, k, v = _inputs(200 + S, 1, 2, S, D)
    do = np.random.default_rng(300 + S).standard_normal(q.shape, dtype=np.float32)

    def jflash(q, k, v):
        return jax_attn.causal_attention(
            q, k, v, impl="pallas", block_q=block_q, block_k=block_k, interpret=True
        )

    _, vjp = jax.vjp(jflash, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    before = (pt_attn.flash_fwd_launches, pt_attn.flash_bwd_launches)
    o = pt_attn.flash_attention(tq, tk, tv, 1.0 / np.sqrt(D))
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    assert (pt_attn.flash_fwd_launches, pt_attn.flash_bwd_launches) == before
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("S", [64, 100])
def test_flash_bwd_reference_matches_autograd(S):
    """The plain twin of the backward kernel, fed the forward's (o, lse),
    against autograd through the reference's plain attention."""
    q, k, v = _inputs(400 + S, 2, 2, S, 16)
    do = np.random.default_rng(500 + S).standard_normal(q.shape, dtype=np.float32)
    scale = 0.25
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = pt_attn.flash_attention_fwd_reference(tq, tk, tv, scale)
    got = pt_attn.flash_attention_bwd_reference(tq, tk, tv, o, lse, tdo, scale)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    ref = pt_attn._reference_causal_attention(*leaves, scale)
    want = torch.autograd.grad(ref, leaves, tdo)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=f"d{name}", **TOL)
    # flash_attention_bwd on a CPU tensor is the same plain version.
    for g, w in zip(pt_attn.flash_attention_bwd(tq, tk, tv, o, lse, tdo, scale), got):
        assert torch.equal(g, w)
