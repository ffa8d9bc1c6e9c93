"""What both model families' training paths share. Port of
``ray_tpu/models/common.py`` (``chunked_lm_loss``; the GPipe
``pipelined_blocks`` is not ported yet), plus the pieces of the
reference's ``gpt2.py``/``llama.py`` that both families run alike: the
remat ladder (:func:`remat_policy`, :func:`remat_block`), the per-layer
views of the stacked leaves (:func:`unbind_layers`) and the next-token
loss over a batch (:func:`split_batch`, :func:`lm_loss`).

``chunked_lm_loss(x, head, targets, chunk)``: ``head`` is the output
projection oriented ``[V, D]`` (contract over D); a tied-embedding model
passes its ``wte`` cast to the activation dtype, an untied one its
``[D, V]`` head transposed.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ray_tpu_torch.ops.attention import uses_flash_kernel


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


# ---------------------------------------------------------------------------
# The remat ladder


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the outputs of the weight matmuls (unbatched ``mm``/``addmm``)
    and recompute everything else, attention's batched products included:
    the counterpart of ``dots_with_no_batch_dims_saveable``."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def remat_policy(cfg, x: torch.Tensor) -> str:
    """The policy a model's ``hidden`` applies to activations like ``x``:
    ``cfg.remat`` with bools resolved, and "mlp" turned into "dots" under
    mixture-of-experts (``ray_tpu/models/gpt2.py:334-335``) and where
    attention does not run the flash kernel (the plain path has no saved
    residuals to keep, and would hold the S x S probabilities of every
    layer), as at ``ray_tpu/models/gpt2.py:339-352`` and
    ``ray_tpu/models/llama.py:229-237``. An unknown policy raises."""
    remat = {True: "full", False: "none"}.get(cfg.remat, cfg.remat)
    if remat not in ("full", "dots", "mlp", "none"):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    if remat == "mlp" and getattr(cfg, "n_experts", 0) > 0:
        remat = "dots"  # the "mlp" policy checkpoints the DENSE sublayer
    if remat == "mlp" and not uses_flash_kernel(x, impl=cfg.attn_impl):
        remat = "dots"
    return remat


def remat_block(attn: Callable, mlp: Callable, x: torch.Tensor, p: dict, remat: str):
    """One block, ``mlp(attn(x, p), p)``, under the resolved policy:
    "full" recomputes the whole block in backward, "dots" saves only the
    weight matmuls' outputs, "mlp" checkpoints the MLP as "dots" and leaves
    attention outside, "none" saves everything."""
    ckpt = functools.partial(checkpoint, use_reentrant=False)

    def block(x, p):
        return mlp(attn(x, p), p)

    if remat == "full":
        return ckpt(block, x, p)
    if remat == "dots":
        return ckpt(block, x, p, context_fn=_dots_context)
    if remat == "mlp":
        # Attention stays outside the checkpoint, so the flash Function's
        # saved (q, k, v, o, lse) survive to backward and the forward
        # kernel never re-runs there.
        return ckpt(mlp, attn(x, p), p, context_fn=_dots_context)
    return block(x, p)


def unbind_layers(params: dict) -> list[dict]:
    """Each layer's leaves of the stacked ``params["blocks"]``, from one
    unbind per leaf: its backward is one stack, where indexing layer by
    layer would allocate a full-size zero gradient per layer."""
    per_leaf = {k: v.unbind(0) for k, v in params["blocks"].items()}
    n_layer = len(next(iter(per_leaf.values())))
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(n_layer)]


# ---------------------------------------------------------------------------
# The next-token loss


def split_batch(batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """(inputs, targets) of a batch ``{"tokens": [B, S+1]}`` or
    ``{"tokens": [B, S], "targets": [B, S]}``."""
    tokens = batch["tokens"]
    if "targets" in batch:
        return tokens, batch["targets"].long()
    return tokens[:, :-1], tokens[:, 1:].long()


def lm_loss(x: torch.Tensor, head: torch.Tensor, targets: torch.Tensor, chunk: int):
    """Mean next-token cross-entropy of hidden states ``x [B, S, D]`` under
    the output projection ``head [V, D]``: ``(loss, {"loss", "tokens"})``,
    the metrics left on the device. With ``chunk`` set and S past it, the
    chunked loss with f32 logits from operands in the activation dtype;
    otherwise one product in the activation dtype upcast to f32
    (``ray_tpu/models/gpt2.py:432-439``)."""
    if chunk and x.shape[1] > chunk:
        ce = chunked_lm_loss(x, head, targets, chunk) / targets.numel()
    else:
        logits = (x @ head.T).float()
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, targets[..., None])[..., 0]
        ce = (lse - tgt).mean()
    tokens_n = torch.full((), targets.numel(), dtype=torch.int32, device=ce.device)
    return ce, {"loss": ce.detach(), "tokens": tokens_n}
