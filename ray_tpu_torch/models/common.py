"""The sequence-chunked LM-head loss. Port of ``ray_tpu/models/common.py``
(``chunked_lm_loss``; the GPipe ``pipelined_blocks`` is not ported yet).

``chunked_lm_loss(x, head, targets, chunk)``: ``head`` is the output
projection oriented ``[V, D]`` (contract over D); a tied-embedding model
passes its ``wte`` cast to the activation dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an f32 result and the operands in their own dtype:
    the reference's ``preferred_element_type=f32``. On the card a bf16
    product accumulates in f32 and is never rounded to bf16 (an f32 x f32
    product would run off the tensor cores); on the CPU the operands are
    upcast."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _LogitsF32(torch.autograd.Function):
    """``x [N, D] @ head[V, D]^T`` as f32 logits from operands in the
    activation dtype. PyTorch's ``mm`` with ``out_dtype`` has no autograd
    formula, so the gradient is written out: the f32 cotangent is rounded
    to the operands' dtype (as the TPU's default-precision product of an
    f32 operand does) and both products again accumulate in f32."""

    @staticmethod
    def forward(ctx, x, head):
        ctx.save_for_backward(x, head)
        return _mm_f32(x, head.t())

    @staticmethod
    def backward(ctx, g):
        x, head = ctx.saved_tensors
        g = g.to(x.dtype)
        return _mm_f32(g, head).to(x.dtype), _mm_f32(g.t(), x).to(head.dtype)


def _chunk_loss(x_c: torch.Tensor, head: torch.Tensor, t_c: torch.Tensor) -> torch.Tensor:
    B, C, D = x_c.shape
    logits = _LogitsF32.apply(x_c.reshape(B * C, D), head).reshape(B, C, -1)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, t_c.clamp(min=0)[..., None])[..., 0]
    return torch.where(t_c >= 0, lse - tgt, 0.0).sum()


def chunked_lm_loss(
    x: torch.Tensor, head: torch.Tensor, targets: torch.Tensor, chunk: int
) -> torch.Tensor:
    """Sum of next-token cross-entropies over SEQUENCE chunks.

    Each chunk's f32 logits ``[B, chunk, vocab]`` live only inside its
    checkpoint and are recomputed in backward, so nothing ``O(B*S*vocab)``
    stays resident. Padded positions carry target -1 and add zero. Returns
    the f32 sum; the caller divides by ``targets.numel()``.
    """
    B, S, D = x.shape
    n_chunks = -(-S // chunk)
    pad = n_chunks * chunk - S
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad), value=-1)
    targets = targets.long()
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        total = total + checkpoint(_chunk_loss, x[:, sl], head, targets[:, sl], use_reentrant=False)
    return total
