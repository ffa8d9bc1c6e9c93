"""What both model families' training paths share. Port of
``ray_tpu/models/common.py`` (``chunked_lm_loss`` and the GPipe
``pipelined_blocks``), plus the pieces of the reference's
``gpt2.py``/``llama.py`` that both families run alike: the remat ladder
(:func:`remat_policy`, :func:`remat_block`), the per-layer views of the
stacked leaves (:func:`unbind_layers`), the next-token loss over a batch
(:func:`split_batch`, :func:`lm_loss`) and the sequence split over ``sp``
(:func:`seq_shard`, :func:`sequence_attention`).

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

The ``sp`` axis splits the sequence: each rank takes a contiguous block of
``S/sp`` positions of its rows (:func:`seq_shard`; the whole sequence on
every rank where ``sp`` does not divide it), and attention runs over the
ring (:func:`~ray_tpu_torch.ops.ring_attention.ring_attention`), or, inside
the pipeline, over the sequence gathered whole (the reference turns the
ring off there).

The ``pp`` axis splits the stacked layers into stages
(:func:`pipelined_blocks`): GPipe over microbatches, each microbatch's
activations sent stage to stage by the ring exchange
(:func:`~ray_tpu_torch.parallel.sharding.exchange`), forward in step order
and backward in reverse. Bubble steps are skipped, not computed on clamped
duplicates as in the reference: the result is the same, and a stage runs
its layers once for each microbatch, forward and backward. The last
stage's output is broadcast over ``pp`` (the head and the loss are
replicated there).
"""

from __future__ import annotations

import contextlib
import dataclasses
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
from ray_tpu_torch.ops.ring_attention import ring_attention
from ray_tpu_torch.parallel.mesh import Mesh, check_mesh, local_mesh
from ray_tpu_torch.parallel.sharding import (
    DEFAULT_RULES,
    all_gather,
    all_gather_dim,
    all_reduce,
    all_reduce_,
    exchange,
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


def remat_policy(cfg, x: torch.Tensor, ring: bool = False) -> str:
    """The policy a model's ``hidden`` applies to activations like ``x``:
    ``cfg.remat`` with bools resolved, and "mlp" turned into "dots" under
    mixture-of-experts (``ray_tpu/models/gpt2.py:334-335``) and where
    attention does not run the flash kernel: on the ring (``ring``) or on
    the plain path, neither of which has saved residuals to keep, and
    either would hold every layer's probabilities, as at
    ``ray_tpu/models/gpt2.py:336-352`` and ``ray_tpu/models/llama.py:229-237``.
    An unknown policy raises."""
    remat = {True: "full", False: "none"}.get(cfg.remat, cfg.remat)
    if remat not in ("full", "dots", "mlp", "none"):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    if remat == "mlp" and getattr(cfg, "n_experts", 0) > 0:
        remat = "dots"  # the "mlp" policy checkpoints the DENSE sublayer
    if remat == "mlp" and (ring or not uses_flash_kernel(x, impl=cfg.attn_impl)):
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
    x: torch.Tensor,
    head: torch.Tensor,
    targets: torch.Tensor,
    chunk: int,
    mesh: Mesh | None = None,
    seq_split: bool = False,
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
    gradient. With ``seq_split``, ``x`` and ``targets`` are this rank's
    block of the sequence under ``sp``; the loss is the block's mean, and
    the token count the count of the ``sp`` ranks' blocks together."""
    mesh = mesh or local_mesh()
    x = grad_all_reduce(x, mesh, "tp")
    if chunk and x.shape[1] > chunk:
        ce = chunked_lm_loss(x, head, targets, chunk, mesh) / targets.numel()
    else:
        ce = _vocab_parallel_ce((x @ head.T).float(), targets, head, mesh).mean()
    count = targets.numel() * (mesh.size("sp") if seq_split else 1)
    tokens_n = torch.full((), count, dtype=torch.int32, device=ce.device)
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
    as if they were whole. Under ``pp`` the stages split ``cfg.n_layer``
    (else ``ValueError``, as in the reference) and each holds its own
    layers."""
    if mesh is None:
        mesh, where = local_mesh(), "no mesh was given: pass the mesh the leaves are sharded over"
    else:
        check_mesh(mesh)
        where = f"the local shard that mesh {mesh.spec.asdict()} gives under DEFAULT_RULES"
    pp = mesh.size("pp")
    if cfg.n_layer % pp:
        raise ValueError(
            f"n_layer {cfg.n_layer} not divisible by the {pp} pipeline stages (pp mesh axis)"
        )
    want = (cfg.vocab_size // mesh.size("tp"), cfg.d_model // mesh.size("fsdp"))
    got = tuple(params["wte"].shape)
    if got != want:
        raise ValueError(f"wte has shape {got}, not {want}, {where} (mesh=)")
    layers = next(iter(params["blocks"].values())).shape[0]
    if layers != cfg.n_layer // pp:
        raise ValueError(
            f"blocks hold {layers} layers, not {cfg.n_layer // pp}, {where} (mesh=)"
        )
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


# ---------------------------------------------------------------------------
# The sequence over sp


@dataclasses.dataclass(frozen=True)
class SeqShard:
    """This rank's block ``[start, start + length)`` of a sequence under
    ``sp``; ``split`` is whether the ``sp`` ranks hold different blocks
    (else every one holds the whole sequence)."""

    start: int
    length: int
    split: bool

    def take(self, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's block of ``t`` along ``dim`` (a view)."""
        return t.narrow(dim, self.start, self.length) if self.split else t


def seq_shard(mesh: Mesh, S: int) -> SeqShard:
    """The block of a sequence of ``S`` positions this rank takes under
    ``mesh``'s ``sp``: rank ``r`` the contiguous ``[r*S/sp, (r+1)*S/sp)``,
    or, where ``sp`` does not divide ``S`` (the reference then attends
    over the whole sequence), all of it on every rank."""
    sp = mesh.size("sp")
    if sp == 1 or S % sp:
        return SeqShard(0, S, False)
    n = S // sp
    return SeqShard(mesh.coordinate("sp") * n, n, True)


def sequence_attention(q, k, v, mesh: Mesh, seq: SeqShard, pipelined: bool, attn: Callable,
                       expand: Callable = lambda t: t):
    """Causal attention of this rank's queries ``q [B, H, T, Dh]`` (the
    positions of ``seq``) with ``attn(q, k, v)`` the whole-sequence
    attention and ``expand`` the step that makes ``k``/``v`` one head per
    query head (GQA). Where the sequence is whole on this rank: ``attn``.
    Where it is split over ``sp``: ring attention, or, inside the
    pipeline, ``attn`` over q, k and v gathered whole over ``sp`` and this
    rank's rows of the result (the gathers' backward sums each block's
    gradient over the ranks)."""
    if not seq.split:
        return attn(q, expand(k), expand(v))
    if not pipelined:
        return ring_attention(q, expand(k), expand(v), mesh)
    q, k, v = (all_gather_dim(t, mesh, "sp", 2).contiguous() for t in (q, k, v))
    return attn(q, expand(k), expand(v)).narrow(2, seq.start, seq.length)


# ---------------------------------------------------------------------------
# GPipe over pp


def pipeline_microbatches(rows: int, n_micro: int, mesh: Mesh) -> tuple[int, int]:
    """``(local, group)`` for ``n_micro`` microbatches of a global batch
    whose ``rows`` are this rank's under ``mesh``'s batch shards (dp x
    fsdp, ``k`` of them). The reference cuts the *global* batch into
    ``n_micro`` contiguous microbatches, so each shard holds
    ``local = n_micro / k`` whole ones where ``k`` divides ``n_micro``, or a
    part of one (``local = 1``) that ``group = k / n_micro`` shards share
    where ``n_micro`` divides ``k``; a microbatch is what a mixture-of-
    experts layer routes together. Raises ``ValueError`` when ``n_micro``
    does not divide the batch (as the reference does), or neither of
    ``n_micro`` and ``k`` divides the other."""
    k = mesh.size("dp") * mesh.size("fsdp")
    B = rows * k
    if n_micro < 1 or B % n_micro:
        raise ValueError(f"batch {B} not divisible by pipeline_microbatches {n_micro}")
    if n_micro % k == 0:
        return n_micro // k, 1
    if k % n_micro == 0:
        return 1, k // n_micro
    raise ValueError(
        f"pipeline_microbatches {n_micro} and the {k} batch shards (dp x fsdp): "
        "one must divide the other"
    )


class _GPipe:
    """The schedule of one pipeline stage: ``stage(x, leaves) -> (x,
    aux)`` runs this stage's layers on a microbatch. At step ``t`` stage
    ``s`` holds microbatch ``t - s``; a stage with none at a step (a
    bubble) computes nothing. After each step a stage sends its output on
    to the next (:func:`~ray_tpu_torch.parallel.sharding.exchange` by +1,
    only the pairs that carry a microbatch posting); backward runs the
    steps in reverse, and the gradient of each microbatch's input goes back
    by -1."""

    def __init__(self, stage: Callable, mesh: Mesh, n_local: int):
        self.stage, self.mesh, self.n_local = stage, mesh, n_local
        self.pp, self.idx = mesh.size("pp"), mesh.coordinate("pp")
        self.steps = n_local + self.pp - 1

    def holds(self, t: int) -> bool:
        """Whether this stage holds a microbatch at step ``t``."""
        return 0 <= t - self.idx < self.n_local

    def forward(self, x: torch.Tensor, leaves: list, keep: bool):
        """``(out, aux, saved)``: the last stage's output (zeros on every
        other stage), this stage's aux summed over its microbatches, and
        with ``keep`` each microbatch's (input, output, aux) with their
        graphs, for :meth:`backward`."""
        pp, idx = self.pp, self.idx
        xs = x.chunk(self.n_local)
        outs, saved, recv = [], {}, None
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for t in range(self.steps):
            sent = None
            if self.holds(t):
                m = t - idx
                inp = xs[m] if idx == 0 else recv
                if keep:
                    inp = inp.detach().requires_grad_()
                    with torch.enable_grad():
                        out, a = self.stage(inp, leaves)
                    saved[m] = (inp, out, a)
                else:
                    out, a = self.stage(inp, leaves)
                aux = aux + a.detach()
                if idx == pp - 1:
                    outs.append(out.detach())
                else:
                    sent = out.detach()
            if t < self.steps - 1:
                takes = idx > 0 and self.holds(t + 1)
                recv = exchange(sent, xs[0] if takes else None, self.mesh, "pp", 1)
        out = torch.cat(outs) if idx == pp - 1 else torch.zeros_like(x)
        return out, aux, saved

    def backward(self, saved: dict, leaves: list, g_out, g_aux):
        """``(g_x, g_leaves)`` from the cotangents of :meth:`forward`'s out
        and aux: each microbatch's graph differentiated in reverse step
        order, its input's gradient sent to the previous stage. Only stage
        0 reads ``x``; the others give it a zero gradient."""
        pp, idx = self.pp, self.idx
        g_outs = g_out.chunk(self.n_local) if idx == pp - 1 else None
        wants = [i for i, leaf in enumerate(leaves) if leaf.requires_grad]
        g_leaves = [None] * len(leaves)
        like = next(iter(saved.values()))[0]  # every microbatch has one shape
        g_xs, recv = [None] * self.n_local, None
        for t in reversed(range(self.steps)):
            sent = None
            if self.holds(t):
                m = t - idx
                inp, out, a = saved.pop(m)
                outputs, cotangents = [out], [g_outs[m] if g_outs is not None else recv]
                if a.requires_grad:
                    outputs.append(a)
                    cotangents.append(g_aux)
                got = torch.autograd.grad(
                    outputs, [inp] + [leaves[i] for i in wants], cotangents, allow_unused=True
                )
                for i, g in zip(wants, got[1:]):
                    if g is not None:
                        g_leaves[i] = g if g_leaves[i] is None else g_leaves[i] + g
                if idx == 0:
                    g_xs[m] = got[0]
                else:
                    sent = got[0]
            if t > 0:
                takes = idx < pp - 1 and self.holds(t - 1)
                recv = exchange(sent, like if takes else None, self.mesh, "pp", -1)
        if idx == 0:
            return torch.cat(g_xs), g_leaves
        return like.new_zeros((self.n_local * like.shape[0], *like.shape[1:])), g_leaves


class _Pipeline(torch.autograd.Function):
    """A stage's :class:`_GPipe` schedule as one autograd node: forward
    keeps each microbatch's graph, backward runs the reverse schedule."""

    @staticmethod
    def forward(ctx, sched: _GPipe, x, *leaves):
        params = [leaf.detach().requires_grad_(leaf.requires_grad) for leaf in leaves]
        out, aux, saved = sched.forward(x, params, keep=True)
        ctx.sched, ctx.params, ctx.saved = sched, params, saved
        return out, aux

    @staticmethod
    def backward(ctx, g_out, g_aux):
        g_x, g_leaves = ctx.sched.backward(ctx.saved, ctx.params, g_out, g_aux)
        ctx.saved = ctx.params = None
        return (None, g_x, *g_leaves)


def pipelined_blocks(
    blocks: dict, x: torch.Tensor, block_fn: Callable, mesh: Mesh, *, n_micro: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """GPipe over ``mesh``'s ``pp`` axis (``ray_tpu/models/common.py:64``):
    ``blocks`` is this stage's ``L/pp`` stacked layers (its local shard
    under ``"layers": "pp"``), ``x`` the embedded batch (replicated over
    ``pp``; stage 0 reads it) and ``block_fn(x, layer) -> (x, aux)`` one
    layer. Returns ``(x, aux)``: the last stage's output, broadcast over
    ``pp`` (an all-reduce whose backward sums the cotangents, as the
    reference's ``psum``), and the aux of the genuine microbatch steps
    summed over the stages (and the batch shards' microbatches) over
    ``n_micro``, the unpipelined layer sum's value (``psum(aux)/n_micro``).
    Every rank of the mesh must call it together."""
    n_local, group = pipeline_microbatches(x.shape[0], n_micro, mesh)
    names = sorted(blocks)

    def stage(inp, leaves):
        aux = torch.zeros((), dtype=torch.float32, device=inp.device)
        for p in unbind_layers({"blocks": dict(zip(names, leaves))}):
            inp, a = block_fn(inp, p)
            aux = aux + a
        return inp, aux

    sched = _GPipe(stage, mesh, n_local)
    leaves = [blocks[k] for k in names]
    if torch.is_grad_enabled():
        out, aux = _Pipeline.apply(sched, x, *leaves)
    else:
        out, aux, _ = sched.forward(x, leaves, keep=False)
    out = all_reduce(out, mesh, "pp", grad="sum")
    aux = all_reduce(aux, mesh, ("pp", *mesh.spec.batch_axes), grad="sum") / (n_micro * group)
    return out, aux
