"""Causal self-attention: a hand-written CUDA flash forward on Hopper, plain
PyTorch on the CPU. Port of ``ray_tpu/ops/attention.py``.

The contract is the reference's: ``[B, H, S, D]`` tensors, causal mask,
f32 softmax statistics. Two plain versions live here:

- :func:`_reference_causal_attention` is the reference's plain path
  (f32 scores, mask value -1e30, softmax cast to the v dtype);
- :func:`flash_attention_fwd_reference` is the same function as the
  kernel, returning ``(o, lse)``. Like the TPU kernel it pre-scales q by
  ``scale * log2(e)`` in f32 and rounds it back to q's dtype, and its
  log-sum-exp is in **base 2** (``lse = max + log2(sum exp2(s - max))``),
  ``[B, H, S, 1]`` f32. The kernel uses the same base.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel (``csrc/flash_fwd.cu``) or raises if the kernel cannot take it.
Nothing falls back quietly. The kernel is forward only: the backward is
later work, so the kernel path raises on inputs that require grad.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ray_tpu_torch.ops import _build

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634

# Launches of the CUDA flash forward kernel in this process. The wrapper
# adds one per launch and nowhere else; a run resets it to read its own.
flash_fwd_launches = 0


def _causal_mask(S_q: int, S_k: int, device) -> torch.Tensor:
    return torch.ones((S_q, S_k), dtype=torch.bool, device=device).tril()


def _reference_causal_attention(q, k, v, scale):
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    s = torch.where(_causal_mask(q.shape[2], k.shape[2], q.device), s, _NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def flash_attention_fwd_reference(q, k, v, scale):
    """Plain version of the flash kernel: ``(o, lse)`` with lse in base 2.

    The kernel's rounding points are kept: q is pre-scaled by
    ``scale * log2(e)`` in f32 and rounded to q's dtype, the scores and the
    softmax statistics are f32, and the probabilities are rounded to v's
    dtype before the second product (the row sum is taken before that
    rounding). In f32 every rounding is a no-op. The kernel's online
    softmax sums in another order, so the two agree to a tolerance, not
    bit for bit.
    """
    qs = (q.float() * (scale * _LOG2E)).to(q.dtype)
    s = torch.einsum("bhqd,bhkd->bhqk", qs.float(), k.float())
    s = torch.where(_causal_mask(q.shape[2], k.shape[2], q.device), s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype), m + torch.log2(l)


_KERNEL_D = 64


@functools.cache
def _lib():
    """The kernel's library, built on first use, with its C signatures."""
    lib = _build.load("flash_fwd")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_fwd_bf16.argtypes = [p, p, p, p, p, i, i, i, i] + [ll] * 12 + [ctypes.c_float, p]
    lib.flash_fwd_bf16.restype = i
    lib.flash_fwd_error_string.argtypes = [i]
    lib.flash_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _is_hopper(device: torch.device) -> bool:
    return torch.cuda.get_device_capability(device) == (9, 0)


def _check_kernel_inputs(q, k, v) -> None:
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError(
            "the CUDA flash kernel is forward only (its backward is not ported "
            "yet); pass tensors that do not require grad, or impl='reference'"
        )
    if not (q.shape == k.shape == v.shape):
        raise ValueError(f"q/k/v shapes differ: {q.shape}, {k.shape}, {v.shape}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if not _is_hopper(q.device):
        cap = torch.cuda.get_device_capability(q.device)
        raise RuntimeError(f"the flash kernel is built for sm_90a; device is sm_{cap[0]}{cap[1]}")
    B, H, S, D = q.shape
    if D != _KERNEL_D:
        raise ValueError(f"the flash kernel takes head_dim {_KERNEL_D}, got {D}")
    if S < 1 or B > 65535 or H > 65535:
        raise ValueError(f"the flash kernel cannot take shape {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the flash kernel takes bfloat16, got {name}.dtype={t.dtype}")
        if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(
                f"the flash kernel needs {name} rows contiguous and 16-byte aligned "
                f"(strides {t.stride()})"
            )


def _flash_fwd_cuda(q, k, v, scale):
    global flash_fwd_launches
    _check_kernel_inputs(q, k, v)
    B, H, S, D = q.shape
    # O is laid out [B, S, H, D] and returned as its [B, H, S, D] view, so
    # the caller's merge of the heads back into d_model is a free reshape.
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((B, H, S, 1), dtype=torch.float32, device=q.device)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.flash_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            B, H, S, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            float(scale * _LOG2E), stream,
        )
    if rc != 0:
        msg = lib.flash_fwd_error_string(rc).decode()
        raise RuntimeError(f"flash_fwd launch failed: {msg} (cuda error {rc})")
    flash_fwd_launches += 1
    return o, lse


def flash_attention_fwd(q, k, v, scale):
    """``(o, lse)``: the CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor."""
    if q.is_cuda:
        return _flash_fwd_cuda(q, k, v, scale)
    return flash_attention_fwd_reference(q, k, v, scale)


def uses_flash_kernel(x: torch.Tensor, *, impl: str = "auto") -> bool:
    """Whether :func:`causal_attention` on ``x`` runs the CUDA kernel: for
    ``impl`` "auto" or "cuda", true for a CUDA tensor on an sm_90 device,
    whatever its sequence length (the kernel masks the ragged edge itself).
    Where this is false, "auto" takes the plain path and "cuda" raises."""
    return impl in ("auto", "cuda") and x.is_cuda and _is_hopper(x.device)


def causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    impl: str = "auto",
    scale: float | None = None,
    block_q: int = 256,
    block_k: int = 256,
) -> torch.Tensor:
    """Causal attention over ``[batch, heads, seq, head_dim]`` tensors.

    impl: ``"auto"`` (the CUDA kernel for a CUDA tensor, the reference for
    a CPU tensor), ``"cuda"`` (the kernel; raises on a CPU tensor) or
    ``"reference"`` (the plain path on any device).
    block_q, block_k: accepted for the reference's signature and advisory
    only; the kernel's tiles are its own (64 x 64).
    """
    del block_q, block_k
    if q.ndim != 4:
        raise ValueError(f"expected [B, H, S, D], got shape {tuple(q.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if impl == "auto":
        impl = "cuda" if q.is_cuda else "reference"
    if impl == "reference":
        return _reference_causal_attention(q, k, v, scale)
    if impl != "cuda":
        raise ValueError(f"unknown attention impl {impl!r}")
    if not q.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors; use impl='reference' on the CPU")
    return _flash_fwd_cuda(q, k, v, scale)[0]
