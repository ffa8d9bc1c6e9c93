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

Under a mesh (:mod:`ray_tpu_torch.parallel`) each rank holds the local
shard of every leaf that ``DEFAULT_RULES`` gives (:func:`model_mesh` checks
it). The ``fsdp`` axis splits every ``embed`` dim: :func:`gathered` is the
ZeRO-3 gather of a leaf where it is used, inside its layer's remat region,
and :func:`reshard_after_forward` keeps autograd from holding a gathered
weight until backward (it is gathered again there). The ``tp`` axis splits
the vocabulary: :func:`vocab_parallel_embed` and the loss
(:class:`_VocabParallelCE`) never build a whole ``[B, S, V]``; serving
gathers each rank's logits of its vocabulary shard whole
(:func:`gather_vocab`), since it samples on the host.
"""

from __future__ import annotations

import contextlib
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
from ray_tpu_torch.parallel.mesh import Mesh, check_ported_axes, local_mesh
from ray_tpu_torch.parallel.sharding import (
    DEFAULT_RULES,
    all_gather,
    all_gather_dim,
    all_reduce,
    all_reduce_,
    grad_all_reduce,
    logical_to_mesh_spec,
)


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


class _VocabParallelCE(torch.autograd.Function):
    """Per-token cross-entropy ``logsumexp(logits) - logits[target]`` from
    f32 logits ``[N, V/tp]``, this rank's columns of the vocabulary starting
    at ``start`` (all of it off a mesh): the global max and the sum of
    exponentials are one all-reduce over ``tp`` each, and the target's
    logit is taken on the rank that owns it and all-reduced. The backward
    is the softmax minus the one-hot on this rank's own columns. A target
    no rank owns (-1, padding) has no logit: its value is the logsumexp,
    which the caller masks."""

    @staticmethod
    def forward(ctx, logits, targets, start, mesh):
        V = logits.shape[-1]
        m = all_reduce_(logits.amax(-1), mesh, "tp", "max")
        e = (logits - m[:, None]).exp_()
        s = all_reduce_(e.sum(-1), mesh, "tp")
        local = targets - start
        own = (local >= 0) & (local < V)
        local = local.clamp(0, V - 1)
        tgt = torch.where(own, logits.gather(-1, local[:, None])[:, 0], 0.0)
        all_reduce_(tgt, mesh, "tp")
        ctx.save_for_backward(e, s, local, own)
        return m + torch.log(s) - tgt

    @staticmethod
    def backward(ctx, g):
        e, s, local, own = ctx.saved_tensors
        grad = e * (g / s)[:, None]
        grad.scatter_add_(-1, local[:, None], torch.where(own, -g, 0.0)[:, None])
        return grad, None, None, None


def _vocab_parallel_ce(logits: torch.Tensor, targets: torch.Tensor, head, mesh: Mesh):
    """:class:`_VocabParallelCE` of ``logits [..., V/tp]`` under ``head``,
    this rank's ``[V/tp, D]`` rows of the vocabulary."""
    start = mesh.coordinate("tp") * head.shape[0]
    flat = logits.reshape(-1, logits.shape[-1])
    return _VocabParallelCE.apply(flat, targets.reshape(-1), start, mesh).view(targets.shape)


def _chunk_loss(x_c, head, t_c, mesh: Mesh) -> torch.Tensor:
    B, C, D = x_c.shape
    logits = _LogitsF32.apply(x_c.reshape(B * C, D), head)
    return torch.where(t_c >= 0, _vocab_parallel_ce(logits, t_c, head, mesh), 0.0).sum()


def chunked_lm_loss(
    x: torch.Tensor, head: torch.Tensor, targets: torch.Tensor, chunk: int, mesh: Mesh | None = None
) -> torch.Tensor:
    """Sum of next-token cross-entropies over SEQUENCE chunks.

    Each chunk's f32 logits ``[B, chunk, vocab]`` live only inside its
    checkpoint and are recomputed in backward, so nothing ``O(B*S*vocab)``
    stays resident. Padded positions carry target -1 and add zero. Returns
    the f32 sum; the caller divides by ``targets.numel()``. Under a mesh
    with ``tp`` above 1, ``head`` is this rank's vocabulary rows and each
    chunk's logits are ``[B, chunk, vocab / tp]`` (:class:`_VocabParallelCE`).
    """
    mesh = mesh or local_mesh()
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
        total = total + checkpoint(
            _chunk_loss, x[:, sl], head, targets[:, sl], mesh, use_reentrant=False
        )
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


def lm_loss(
    x: torch.Tensor, head: torch.Tensor, targets: torch.Tensor, chunk: int, mesh: Mesh | None = None
):
    """Mean next-token cross-entropy of hidden states ``x [B, S, D]`` under
    the output projection ``head [V, D]``: ``(loss, {"loss", "tokens"})``,
    the metrics left on the device. With ``chunk`` set and S past it, the
    chunked loss with f32 logits from operands in the activation dtype;
    otherwise one product in the activation dtype upcast to f32
    (``ray_tpu/models/gpt2.py:432-439``). Under a mesh with ``tp`` above 1,
    ``head`` is this rank's rows of the vocabulary and the loss is
    vocab-parallel; ``x`` (replicated over ``tp``) enters through
    :func:`grad_all_reduce`, since each rank's logits give it a part of its
    gradient."""
    mesh = mesh or local_mesh()
    x = grad_all_reduce(x, mesh, "tp")
    if chunk and x.shape[1] > chunk:
        ce = chunked_lm_loss(x, head, targets, chunk, mesh) / targets.numel()
    else:
        ce = _vocab_parallel_ce((x @ head.T).float(), targets, head, mesh).mean()
    tokens_n = torch.full((), targets.numel(), dtype=torch.int32, device=ce.device)
    return ce, {"loss": ce.detach(), "tokens": tokens_n}


# ---------------------------------------------------------------------------
# The mesh: local shards, fsdp gathers, the vocabulary over tp


def model_mesh(params: dict, cfg, mesh: Mesh | None, logical: dict) -> tuple[Mesh, dict]:
    """The mesh a model's training path runs on (``mesh``, or one rank's
    where None) and :func:`fsdp_dims` of the model's logical specs
    ``logical`` on it. Raises for an axis the port does not run, and
    ``ValueError`` when the leaves are not this mesh's local shards under
    ``DEFAULT_RULES`` (``wte`` is split over ``tp`` by vocabulary and over
    ``fsdp`` by ``embed``): shards given with no mesh are never computed on
    as if they were whole."""
    if mesh is None:
        mesh, where = local_mesh(), "no mesh was given: pass the mesh the leaves are sharded over"
    else:
        check_ported_axes(mesh)
        where = f"the local shard that mesh {mesh.spec.asdict()} gives under DEFAULT_RULES"
    want = (cfg.vocab_size // mesh.size("tp"), cfg.d_model // mesh.size("fsdp"))
    got = tuple(params["wte"].shape)
    if got != want:
        raise ValueError(f"wte has shape {got}, not {want}, {where} (mesh=)")
    return mesh, fsdp_dims(logical, mesh)


def fsdp_dims(logical: dict, mesh: Mesh) -> dict:
    """Leaf name -> the dim ``DEFAULT_RULES`` splits over ``fsdp`` on
    ``mesh`` (of one layer's leaf, for the leaves under ``"blocks"``), or
    None where the leaf is whole over ``fsdp``."""
    blocks = logical["blocks"]
    out = {}
    for name, lg in [(k, v) for k, v in logical.items() if k != "blocks"] + list(blocks.items()):
        spec = logical_to_mesh_spec(lg, DEFAULT_RULES, mesh)
        dim = next((i for i, entry in enumerate(spec) if entry == "fsdp"), None)
        out[name] = None if dim is None else dim - (name in blocks)
    return out


def sharded_layers(mesh: Mesh) -> bool:
    """Whether a layer's weights under ``mesh`` are anything but its whole
    leaves: split over ``fsdp`` (gathered where used) or over ``tp`` (this
    rank's heads and columns). Off such a mesh the models pass each layer's
    leaves to its sublayers as they are."""
    return mesh.size("fsdp") > 1 or mesh.size("tp") > 1


def gathered(w: torch.Tensor, mesh: Mesh, dim: int | None, dtype, select: Callable | None = None):
    """The leaf ``w`` gathered whole over ``fsdp`` along ``dim`` (``w``
    itself where ``dim`` is None or ``fsdp`` has size 1), then ``select``
    of it where given, cast to ``dtype``; the gather's gradient is the
    reduce-scatter of the whole leaf's. Under ``fsdp`` the result carries
    the recipe that computes it again, which :func:`reshard_after_forward`
    uses in place of keeping it for backward."""

    def finish(t):
        return (t if select is None else select(t)).to(dtype)

    if dim is None or mesh.size("fsdp") == 1:
        return finish(w)
    out = finish(all_gather_dim(w, mesh, "fsdp", dim))
    out._regather = lambda: finish(all_gather_dim(w.detach(), mesh, "fsdp", dim))
    return out


class _Regather:
    __slots__ = ("fn",)

    def __init__(self, fn):
        self.fn = fn


def _pack(t: torch.Tensor):
    fn = getattr(t, "_regather", None)
    return t if fn is None else _Regather(fn)


def _unpack(saved):
    if isinstance(saved, _Regather):
        with torch.no_grad():
            return saved.fn()
    return saved


def reshard_after_forward(mesh: Mesh):
    """Under ``fsdp``, a context in which autograd saves a :func:`gathered`
    weight as its recipe and gathers it again when backward needs it
    (FSDP's reshard-after-forward), so no layer's whole weights outlive its
    forward; a no-op otherwise. A checkpointed region inside handles its
    own saved tensors: its gathers run again in its recompute."""
    if mesh.size("fsdp") == 1:
        return contextlib.nullcontext()
    return torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)


def vocab_parallel_embed(wte: torch.Tensor, tokens: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``wte[tokens]`` with ``wte`` this rank's rows of the vocabulary under
    ``tp``: each rank looks up the tokens in its range, writes zeros for
    the rest, and one all-reduce over ``tp`` sums them (its backward the
    identity: every rank keeps the whole gradient of the result)."""
    if mesh.size("tp") == 1:
        return wte[tokens]
    V = wte.shape[0]
    local = tokens - mesh.coordinate("tp") * V
    own = (local >= 0) & (local < V)
    rows = torch.where(own[..., None], wte[local.clamp(0, V - 1)], 0.0)
    return all_reduce(rows, mesh, "tp", grad="identity")


def gather_vocab(logits: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole logits ``[..., V]`` from every rank's columns ``[...,
    V/tp]`` of the vocabulary under ``tp``, in rank order (``logits``
    itself where ``tp`` has size 1). A gather moves bits and sums nothing,
    so every rank holds the same result bit for bit. Carries no gradient:
    the serving paths' readback."""
    if mesh.size("tp") == 1:
        return logits
    parts = all_gather(logits.contiguous(), mesh, "tp")  # [tp, ..., V/tp]
    return torch.cat(parts.unbind(0), dim=-1)
