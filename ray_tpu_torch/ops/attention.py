"""Causal self-attention: hand-written CUDA flash kernels on Hopper, plain
PyTorch on the CPU. Port of ``ray_tpu/ops/attention.py``.

The contract is the reference's: ``[B, H, S, D]`` tensors, causal mask,
f32 softmax statistics. Three plain versions live here:

- :func:`_reference_causal_attention` is the reference's plain path
  (f32 scores, mask value -1e30, softmax cast to the v dtype);
- :func:`flash_attention_fwd_reference` is the same function as the
  forward kernel, returning ``(o, lse)``. Like the TPU kernel it pre-scales
  q by ``scale * log2(e)`` in f32 and rounds it back to q's dtype, and its
  log-sum-exp is in **base 2** (``lse = max + log2(sum exp2(s - max))``),
  ``[B, H, S, 1]`` f32. The kernel uses the same base;
- :func:`flash_attention_bwd_reference` is the same function as the
  backward kernel: ``(dq, dk, dv)`` from the forward's residuals
  ``(q, k, v, o, lse)`` and the output gradient, with the TPU kernel's
  rounding points.

:func:`flash_attention` is the differentiable flash path: a
``torch.autograd.Function`` whose forward saves exactly the reference's
residuals (``ray_tpu/ops/attention.py:282-286``) and whose backward is the
backward kernel. Dispatch: a CPU tensor takes the plain versions; a CUDA
tensor launches the kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``)
or raises if a kernel cannot take it. Nothing falls back quietly.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ray_tpu_torch.ops import _build

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634

# Launches of the CUDA flash kernels in this process. Each wrapper adds one
# per launch and nowhere else; a run resets them to read its own.
flash_fwd_launches = 0
flash_bwd_launches = 0


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


def flash_attention_bwd_reference(q, k, v, o, lse, do, scale):
    """Plain version of the backward kernel: ``(dq, dk, dv)``.

    The TPU kernel's rounding points are kept (``ray_tpu/ops/attention.py``
    ``:152-227``, and delta at ``:237-239``): delta = rowsum(dO * O) in f32;
    q pre-scaled by ``scale * log2(e)`` and rounded to q's dtype; scores in
    f32 masked with -1e30; ``p = exp2(s - lse)`` from the forward's base-2
    lse; p rounded to the input dtype before ``p^T dO``; dS rounded before
    ``dS^T q`` and ``dS k``; dK and dQ multiplied by ``scale`` in f32, then
    cast. In f32 every rounding is a no-op.
    """
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    qs = (q.float() * (scale * _LOG2E)).to(q.dtype)
    s = torch.einsum("bhqd,bhkd->bhqk", qs.float(), k.float())
    s = torch.where(_causal_mask(q.shape[2], k.shape[2], q.device), s, _NEG_INF)
    p = torch.exp2(s - lse)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(), do.float())
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = (p * (dp - delta)).to(q.dtype).float()
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_KERNEL_D = 64


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signatures of the kernels' launch functions, by library name.
_SIGNATURES = {
    "flash_fwd": [_P] * 5 + [_I] * 4 + [_LL] * 12 + [_F, _P],
    "flash_bwd": [_P] * 10 + [_I] * 4 + [_LL] * 24 + [_F, _F, _P],
}


@functools.cache
def _lib(name: str):
    """A kernel's library, built on first use, with its C signatures."""
    lib = _build.load(name)
    launch, error_string = getattr(lib, f"{name}_bf16"), getattr(lib, f"{name}_error_string")
    launch.argtypes = _SIGNATURES[name]
    launch.restype = _I
    tile_rows = getattr(lib, f"{name}_tile_rows")
    tile_rows.argtypes = [ctypes.POINTER(_I)]
    tile_rows.restype = None
    error_string.argtypes = [_I]
    error_string.restype = ctypes.c_char_p
    return lib


# Tile rows a launch reports, by library: the forward's (q rows per CTA,
# k rows per tile); the backward's dK/dV pass (k rows per CTA, q rows per
# tile) and dQ pass (q rows per CTA, k rows per tile).
_TILE_FIELDS = {"flash_fwd": ("q", "k"), "flash_bwd": ("dkdv_k", "dkdv_q", "dq_q", "dq_k")}


def kernel_tile_rows(name: str) -> dict[str, int]:
    """The tile rows of the kernel ``name``, as its C launcher reports them."""
    fields = _TILE_FIELDS[name]
    out = (_I * len(fields))()
    getattr(_lib(name), f"{name}_tile_rows")(out)
    return dict(zip(fields, out))


def _raise_on_error(name: str, rc: int) -> None:
    if rc != 0:
        msg = getattr(_lib(name), f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cuda error {rc})")


def _is_hopper(device: torch.device) -> bool:
    return torch.cuda.get_device_capability(device) == (9, 0)


def _kernel_layout_ok(t: torch.Tensor) -> bool:
    """Rows contiguous and 16-byte aligned, and every stride of a dim longer
    than 1 a positive multiple of 16 bytes, as the kernels' TMA copies need."""
    strides_ok = all(
        (st > 0 and st % 8 == 0) or n == 1 for st, n in zip(t.stride()[:3], t.shape[:3])
    )
    return t.stride(-1) == 1 and strides_ok and t.data_ptr() % 16 == 0


def _check_kernel_inputs(q, **others) -> None:
    """Raise unless the kernels take q and the named tensors: one shape, one
    device (an sm_90 card), bf16, head_dim 64, aligned rows. Tensors that
    require grad are fine: inside the autograd Function's forward q, k and
    v still carry ``requires_grad``."""
    named = {"q": q, **others}
    if any(t.shape != q.shape for t in named.values()):
        raise ValueError(f"flash kernel input shapes differ: { {n: tuple(t.shape) for n, t in named.items()} }")
    if any(t.device != q.device for t in named.values()):
        raise ValueError("the flash kernel's inputs must be on one device")
    if not _is_hopper(q.device):
        cap = torch.cuda.get_device_capability(q.device)
        raise RuntimeError(f"the flash kernel is built for sm_90a; device is sm_{cap[0]}{cap[1]}")
    B, H, S, D = q.shape
    if D != _KERNEL_D:
        raise ValueError(f"the flash kernel takes head_dim {_KERNEL_D}, got {D}")
    if S < 1 or B > 65535 or H > 65535:
        raise ValueError(f"the flash kernel cannot take shape {tuple(q.shape)}")
    for name, t in named.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the flash kernel takes bfloat16, got {name}.dtype={t.dtype}")
        if not _kernel_layout_ok(t):
            raise ValueError(
                f"the flash kernel needs {name} rows contiguous and 16-byte aligned "
                f"(strides {t.stride()})"
            )


def _flash_fwd_cuda(q, k, v, scale):
    global flash_fwd_launches
    B, H, S, D = q.shape
    if H == 0:
        # A tensor-parallel rank past the head count: the grid is empty, so
        # nothing launches and nothing is counted.
        return q.new_empty((B, S, 0, D)).transpose(1, 2), q.new_empty((B, 0, S, 1), dtype=torch.float32)
    _check_kernel_inputs(q, k=k, v=v)
    # O is laid out [B, S, H, D] and returned as its [B, H, S, D] view, so
    # the caller's merge of the heads back into d_model is a free reshape.
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((B, H, S, 1), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = _lib("flash_fwd").flash_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            B, H, S, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            float(scale * _LOG2E), stream,
        )
    _raise_on_error("flash_fwd", rc)
    flash_fwd_launches += 1
    return o, lse


def _flash_bwd_cuda(q, k, v, o, lse, do, scale):
    global flash_bwd_launches
    if q.shape[1] == 0:  # no heads: an empty grid, as in the forward
        return tuple(torch.zeros_like(t) for t in (q, k, v))
    if not _kernel_layout_ok(do):
        # Autograd may hand over an expanded or transposed gradient (the
        # gradient of a sum has zero strides). The training path's dO, laid
        # out as O's [B, S, H, D] storage, is taken as it is, with no copy.
        do = do.contiguous()
    _check_kernel_inputs(q, k=k, v=v, o=o, dO=do)
    B, H, S, D = q.shape
    if lse.shape != (B, H, S, 1) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous f32 [B, H, S, 1], got {tuple(lse.shape)}")
    # dq, dk, dv are laid out [B, S, H, D] like O, so the gradient's way
    # back through the head split into the QKV projection is a free reshape.
    dq, dk, dv = (
        torch.empty((B, S, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
        for _ in range(3)
    )
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = _lib("flash_bwd").flash_bwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, H, S, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            *do.stride()[:3], *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3],
            float(scale), float(scale * _LOG2E), stream,
        )
    _raise_on_error("flash_bwd", rc)
    flash_bwd_launches += 1
    return dq, dk, dv


def flash_attention_fwd(q, k, v, scale):
    """``(o, lse)``: the CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor."""
    if q.is_cuda:
        return _flash_fwd_cuda(q, k, v, scale)
    return flash_attention_fwd_reference(q, k, v, scale)


def flash_attention_bwd(q, k, v, o, lse, do, scale):
    """``(dq, dk, dv)``: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if q.is_cuda:
        return _flash_bwd_cuda(q, k, v, o, lse, do, scale)
    return flash_attention_bwd_reference(q, k, v, o, lse, do, scale)


class _FlashAttention(torch.autograd.Function):
    """The counterpart of the reference's ``custom_vjp`` (``:276-296``): the
    forward saves ``(q, k, v, o, lse)`` and the backward recomputes the
    probabilities from them."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = flash_attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, scale):
    """Differentiable causal flash attention over ``[B, H, S, D]``: the CUDA
    kernels for CUDA tensors, their plain versions for CPU tensors."""
    return _FlashAttention.apply(q, k, v, scale)


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
    only; the kernels' tiles are their own: 64 q rows a block with 128-row
    K/V tiles in the forward, 64-row tiles in both backward passes
    (:func:`kernel_tile_rows`).
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
    return flash_attention(q, k, v, scale)
