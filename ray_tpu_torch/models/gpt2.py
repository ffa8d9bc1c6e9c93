"""GPT-2 in PyTorch, dense and mixture-of-experts. Port of
``ray_tpu/models/gpt2.py``.

Parameters are a plain dict with the reference's stacked layout: every
per-layer leaf lives under ``params["blocks"]`` with a leading ``[L, ...]``
dim, so a JAX pytree converts key for key (:mod:`ray_tpu_torch.models.convert`).
Activations run in ``cfg.dtype`` (bf16 by default) and parameters are kept
in ``cfg.param_dtype`` (f32); each matmul weight is cast to the activation
dtype where the reference casts it (``.to`` is a no-op on a weight that
:func:`compute_params` already cast once). Training passes the f32 masters
themselves, so each cast is in the graph and gradients reach them.

:func:`loss_fn` is the training loss (unchunked, or the chunked
:func:`ray_tpu_torch.models.common.chunked_lm_loss`), and :func:`hidden`
applies the reference's remat policies (``cfg.remat``) whenever grad is
enabled. With ``cfg.n_experts > 0`` each block's MLP is the reference's
top-1 switch layer (:func:`_moe_sublayer`), and the loss adds its
load-balancing term.

Under a mesh (:mod:`ray_tpu_torch.parallel`) each rank holds the local
shard of every leaf that ``DEFAULT_RULES`` gives, and the model computes
the reference's global-view result over ``dp``, ``fsdp``, ``ep`` and
``tp``: leaves split over ``fsdp`` are gathered where a layer uses them
(:func:`~ray_tpu_torch.models.common.gathered`); under ``tp`` the
embedding and the tied logits are vocab-parallel, ``qkv_w``/``fc_w``
(and the experts' ``exp_w1``) are split by columns and ``proj_w``/``fc2_w``
(``exp_w2``) by rows, whose partial products one all-reduce sums (Megatron).
The rule's ``qkv_w`` blocks are not aligned with the heads (rank 0's
columns hold all of q and part of k), so each layer gathers ``qkv_w``'s
columns over ``tp`` and takes its own heads' q, k and v. Over ``sp`` each
rank takes a contiguous block of the sequence (``wpe`` at the block's
global positions) and attention runs over the ring
(:func:`~ray_tpu_torch.ops.ring_attention.ring_attention`), as
``ray_tpu/models/gpt2.py:207-235``; over ``pp`` the stacked layers run as
the GPipe schedule of ``cfg.pipeline_microbatches`` microbatches
(:func:`~ray_tpu_torch.models.common.pipelined_blocks`), inside which
attention takes the whole sequence (gathered over ``sp``) and the flash
kernels, and a mixture-of-experts layer routes each global microbatch's
tokens together (:class:`Routing`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.nn.functional as F

from ray_tpu_torch.models.common import (
    SeqShard,
    gathered,
    lm_loss,
    model_mesh,
    pipeline_microbatches,
    pipelined_blocks,
    remat_block,
    remat_policy,
    reshard_after_forward,
    seq_shard,
    sequence_attention,
    sharded_layers,
    split_batch,
    unbind_layers,
    vocab_parallel_embed,
)
from ray_tpu_torch.ops.attention import causal_attention
from ray_tpu_torch.parallel.mesh import Mesh, local_mesh
from ray_tpu_torch.parallel.sharding import (
    all_gather,
    all_gather_dim,
    all_reduce,
    grad_all_reduce,
)
from ray_tpu_torch.util.device import resolve_device

Params = dict


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50304  # 50257 rounded up to a multiple of 128
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    d_ff: int = 3072
    max_seq: int = 1024
    dtype: Any = torch.bfloat16  # activation dtype
    param_dtype: Any = torch.float32
    attn_impl: str = "auto"  # "auto" | "cuda" | "reference"
    # Kept for field parity with the reference; the CUDA kernel picks its
    # own tiles, so these are advisory.
    attn_block_q: int = 512
    attn_block_k: int = 512
    # Rematerialization in training (read by hidden() when grad is enabled):
    #   "full"  recompute the whole block in backward
    #   "dots"  save the weight-matmul outputs, recompute the rest
    #   "mlp"   attention not checkpointed (the flash kernel's saved o/lse
    #           serve backward), the MLP checkpointed as "dots"; "dots"
    #           where the flash kernel is not in use
    #   "none"  save everything; True/False mean "full"/"none"
    remat: bool | str = "mlp"
    # LM-head loss: sequence positions per chunk of the rematerialized
    # logits (0: one unchunked product).
    loss_chunk: int = 128
    pipeline_microbatches: int = 0
    n_experts: int = 0
    expert_capacity_factor: float = 1.5
    moe_aux_weight: float = 0.01

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_head == 0
        return self.d_model // self.n_head

    @staticmethod
    def gpt2_125m() -> "GPT2Config":
        return GPT2Config()

    @staticmethod
    def tiny(
        n_layer: int = 2,
        d_model: int = 128,
        n_head: int = 4,
        vocab_size: int = 512,
        max_seq: int = 256,
    ) -> "GPT2Config":
        return GPT2Config(
            vocab_size=vocab_size,
            n_layer=n_layer,
            n_head=n_head,
            d_model=d_model,
            d_ff=4 * d_model,
            max_seq=max_seq,
        )


# Leaves the reference casts to the activation dtype at each use; the
# layer-norm scales and biases stay in f32.
MATMUL_LEAVES = (
    "qkv_w", "qkv_b", "proj_w", "proj_b", "fc_w", "fc_b", "fc2_w", "fc2_b",
    "gate_w", "exp_w1", "exp_b1", "exp_w2", "exp_b2",
)


def param_logical_specs(cfg: GPT2Config) -> Params:
    """Logical axis names per parameter (leaves are tuples of names)."""
    L = ("layers",)
    if cfg.n_experts > 0:
        ffn = {
            "gate_w": L + ("embed", "norm"),  # tiny; replicate
            "exp_w1": L + ("experts", "embed", "mlp"),
            "exp_b1": L + ("experts", "mlp"),
            "exp_w2": L + ("experts", "mlp", "embed"),
            "exp_b2": L + ("norm",),
        }
    else:
        ffn = {
            "fc_w": L + ("embed", "mlp"),
            "fc_b": L + ("mlp",),
            "fc2_w": L + ("mlp", "embed"),
            "fc2_b": L + ("norm",),
        }
    return {
        "wte": ("vocab", "embed"),
        "wpe": ("seq_param", "embed"),
        "blocks": {
            "ln1_scale": L + ("norm",),
            "ln1_bias": L + ("norm",),
            "qkv_w": L + ("embed", "mlp"),
            "qkv_b": L + ("mlp",),
            "proj_w": L + ("mlp", "embed"),
            "proj_b": L + ("norm",),
            "ln2_scale": L + ("norm",),
            "ln2_bias": L + ("norm",),
            **ffn,
        },
        "lnf_scale": ("norm",),
        "lnf_bias": ("norm",),
    }


def init_params(
    generator: torch.Generator, cfg: GPT2Config, device: "str | torch.device" = "cuda"
) -> Params:
    """GPT-2 initialization: N(0, 0.02), residual projections scaled by
    1/sqrt(2*n_layer), zeros for biases, ones for LN scales. Draws on the
    generator's device, then moves to ``device``: the card unless the caller
    asks for ``"cpu"`` (a CUDA request with no GPU raises). The numbers
    differ from the reference's ``jax.random`` for the same seed."""
    device = resolve_device(device)
    std = 0.02
    pd = cfg.param_dtype
    L, D, F_, V, S = cfg.n_layer, cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.max_seq
    resid_std = std / (2 * L) ** 0.5
    gen_dev = generator.device

    def normal(shape, s):
        x = torch.randn(shape, generator=generator, device=gen_dev, dtype=torch.float32)
        return (x * s).to(device=device, dtype=pd)

    def zeros(shape):
        return torch.zeros(shape, dtype=pd, device=device)

    def ones(shape):
        return torch.ones(shape, dtype=pd, device=device)

    if cfg.n_experts > 0:
        E = cfg.n_experts
        ffn = {
            "gate_w": normal((L, D, E), std),
            "exp_w1": normal((L, E, D, F_), std),
            "exp_b1": zeros((L, E, F_)),
            "exp_w2": normal((L, E, F_, D), resid_std),
            "exp_b2": zeros((L, D)),
        }
    else:
        ffn = {
            "fc_w": normal((L, D, F_), std),
            "fc_b": zeros((L, F_)),
            "fc2_w": normal((L, F_, D), resid_std),
            "fc2_b": zeros((L, D)),
        }
    wte = normal((V, D), std)
    wpe = normal((S, D), std)
    qkv_w = normal((L, D, 3 * D), std)
    proj_w = normal((L, D, D), resid_std)
    return {
        "wte": wte,
        "wpe": wpe,
        "blocks": {
            "ln1_scale": ones((L, D)),
            "ln1_bias": zeros((L, D)),
            "qkv_w": qkv_w,
            "qkv_b": zeros((L, 3 * D)),
            "proj_w": proj_w,
            "proj_b": zeros((L, D)),
            "ln2_scale": ones((L, D)),
            "ln2_bias": zeros((L, D)),
            **ffn,
        },
        "lnf_scale": ones((D,)),
        "lnf_bias": zeros((D,)),
    }


def compute_params(params: Params, cfg: GPT2Config) -> Params:
    """The same tree with every matmul weight (and the tied embeddings)
    cast once to the activation dtype. Values are identical to the
    reference's per-matmul ``.astype(cfg.dtype)``; the layer-norm leaves
    stay in their parameter dtype."""
    blocks = {
        k: (v.to(cfg.dtype) if k in MATMUL_LEAVES else v)
        for k, v in params["blocks"].items()
    }
    out = dict(params, blocks=blocks)
    out["wte"] = params["wte"].to(cfg.dtype)
    out["wpe"] = params["wpe"].to(cfg.dtype)
    return out


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s leaves (views into the stacked ``[L, ...]`` tensors)."""
    return {k: v[i] for k, v in params["blocks"].items()}


def _layer_norm(x, scale, bias, eps=1e-5):
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=-1, keepdim=True)  # population variance
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def _attn_sublayer(x, p, cfg: GPT2Config, mesh: Mesh = local_mesh(),
                   seq: SeqShard | None = None, pipelined: bool = False):
    """``x`` plus attention over this rank's heads (all of them off a mesh).
    ``p`` holds the layer's weights as :func:`_attn_weights` gives them:
    ``qkv_w``/``qkv_b`` this rank's heads' q, k and v columns, ``proj_w``
    their rows. Under ``tp`` the input enters through
    :func:`grad_all_reduce` and the partial products are summed. ``x`` is
    the positions ``seq`` of its rows (all of them by default); where they
    are a block of the sequence split over ``sp``, attention runs over the
    ring, or inside the pipeline over the gathered sequence
    (:func:`~ray_tpu_torch.models.common.sequence_attention`)."""
    B, S, D = x.shape
    Dh = cfg.head_dim
    h = grad_all_reduce(_layer_norm(x, p["ln1_scale"], p["ln1_bias"]), mesh, "tp")
    qkv = h @ p["qkv_w"].to(cfg.dtype) + p["qkv_b"].to(cfg.dtype)
    q, k_, v = qkv.split(qkv.shape[-1] // 3, dim=-1)

    def heads(t):  # [B,S,H*Dh] -> [B,H,S,Dh]
        return t.reshape(B, S, -1, Dh).transpose(1, 2)

    def whole(q, k, v):
        return causal_attention(
            q, k, v, impl=cfg.attn_impl, block_q=cfg.attn_block_q, block_k=cfg.attn_block_k
        )

    seq = seq or SeqShard(0, S, False)
    attn = sequence_attention(heads(q), heads(k_), heads(v), mesh, seq, pipelined, whole)
    attn = attn.transpose(1, 2).reshape(B, S, -1)
    out = all_reduce(attn @ p["proj_w"].to(cfg.dtype), mesh, "tp", grad="identity")
    return x + out + p["proj_b"].to(cfg.dtype)


def _mlp_sublayer(x, p, cfg: GPT2Config, mesh: Mesh = local_mesh()):
    h = grad_all_reduce(_layer_norm(x, p["ln2_scale"], p["ln2_bias"]), mesh, "tp")
    h = h @ p["fc_w"].to(cfg.dtype) + p["fc_b"].to(cfg.dtype)
    h = F.gelu(h, approximate="tanh")
    out = all_reduce(h @ p["fc2_w"].to(cfg.dtype), mesh, "tp", grad="identity")
    return x + out + p["fc2_b"].to(cfg.dtype)


def _own_heads(t: torch.Tensor, cfg: GPT2Config, mesh: Mesh) -> torch.Tensor:
    """This rank's heads' q, k and v columns ``[..., 3D/tp]`` of the fused
    ``qkv`` leaf ``t``, whose last dim the rule splits over ``tp`` in
    contiguous blocks that do not follow the heads: the blocks are
    gathered, and rank r keeps columns ``[r*D/tp, (r+1)*D/tp)`` of each of
    q, k and v."""
    tp = mesh.size("tp")
    if tp == 1:
        return t
    if cfg.n_head % tp:  # the rule's even blocks of proj_w's rows must be whole heads
        raise ValueError(f"n_head={cfg.n_head} does not split over tp={tp}")
    return heads_columns(all_gather_dim(t, mesh, "tp", -1), cfg, tp, mesh.coordinate("tp"))


def head_block(n_head: int, tp: int, rank: int) -> tuple[int, int]:
    """The heads ``[lo, hi)`` of rank ``rank`` of ``tp``: contiguous blocks
    as even as they go (``lo = rank * n_head // tp``), ``n_head / tp``
    each where ``tp`` divides ``n_head``. Where ``tp`` exceeds the head
    count, rank ``r`` holds head ``r`` and the ranks past the head count
    hold none (an empty block)."""
    if tp > n_head:
        return min(rank, n_head), min(rank + 1, n_head)
    return rank * n_head // tp, (rank + 1) * n_head // tp


def heads_columns(whole: torch.Tensor, cfg: GPT2Config, tp: int, rank: int) -> torch.Tensor:
    """Columns of the whole fused ``qkv`` leaf ``whole`` (``[..., 3D]``: q,
    k, v, each head-major) that hold rank ``rank``'s heads
    (:func:`head_block`) of q, k and v, in that order."""
    lo, hi = head_block(cfg.n_head, tp, rank)
    return whole.unflatten(-1, (3, cfg.n_head, cfg.head_dim))[..., lo:hi, :].flatten(-3)


def _attn_weights(p, cfg: GPT2Config, mesh: Mesh, dims: dict) -> dict:
    """This rank's attention weights of one layer, in the activation dtype:
    gathered over ``fsdp`` and, for ``qkv``, its own heads' columns (the
    leaves as they are off such a mesh: the sublayer casts them)."""
    if not sharded_layers(mesh):
        return p
    own = functools.partial(_own_heads, cfg=cfg, mesh=mesh)
    return dict(
        p,
        qkv_w=gathered(p["qkv_w"], mesh, dims["qkv_w"], cfg.dtype, own),
        qkv_b=own(p["qkv_b"]).to(cfg.dtype),
        proj_w=gathered(p["proj_w"], mesh, dims["proj_w"], cfg.dtype),
    )


def _mlp_weights(p, cfg: GPT2Config, mesh: Mesh, dims: dict) -> dict:
    """This rank's MLP (or expert) weights of one layer, in the activation
    dtype, gathered over ``fsdp`` (the leaves as they are off such a mesh)."""
    if not sharded_layers(mesh):
        return p
    names = ("gate_w", "exp_w1", "exp_w2") if cfg.n_experts > 0 else ("fc_w", "fc2_w")
    return dict(p, **{k: gathered(p[k], mesh, dims[k], cfg.dtype) for k in names})


@dataclasses.dataclass(frozen=True)
class Routing:
    """The tokens a mixture-of-experts layer routes together (its capacity,
    positions and aux count them all): the rows of ``group`` consecutive
    batch shards (dp major; all of them outside the pipeline, the shards
    of one microbatch inside it) and, where ``seq_split``, every ``sp``
    rank's block of those rows."""

    group: int = 1
    seq_split: bool = False


def _shard(mesh: Mesh) -> int:
    """This rank's batch shard: its index over dp x fsdp, dp major."""
    return mesh.coordinate("dp") * mesh.size("fsdp") + mesh.coordinate("fsdp")


def _expert_positions(expert, B: int, S: int, E: int, mesh: Mesh, routing: Routing):
    """``(pos, counts, N)`` for this rank's ``[B, S]`` tokens routed to
    ``expert`` (flat, row-major): each token's position among the tokens
    of its routing group sent to its expert, in the group's global order
    (batch shard, row, sequence position), each expert's count over the
    group, and the group's token count. The local positions come from one
    flat scan of the ``[E, n]`` one-hot (a scan down the n rows of an
    ``[n, E]`` one-hot runs E threads, 1.2 ms a call on an H100 at
    n = 8192); the other ranks' counts offset them: per shard, or, where
    the sequence is split over ``sp``, per row and block."""
    hot = expert[None, :] == torch.arange(E, device=expert.device)[:, None]
    cum = hot.reshape(-1).cumsum(0).view(E, -1)
    starts = F.pad(cum[:-1, -1], (1, 0))
    counts = cum[:, -1] - starts
    pos = cum.gather(0, expert[None])[0] - starts[expert] - 1
    g = routing.group
    shard = _shard(mesh)
    first = shard // g * g
    if not routing.seq_split:
        if g > 1:
            every = all_gather(all_gather(counts, mesh, "fsdp"), mesh, "dp").view(-1, E)
            pos = pos + every[first:shard].sum(0)[expert]
            counts = every[first:first + g].sum(0)
        return pos, counts, B * S * g
    sp = mesh.size("sp")
    ends = cum.view(E, B, S)[:, :, -1] - starts[:, None]  # [E, B]: in rows up to b
    before = F.pad(ends[:, :-1], (1, 0))  # [E, B]: in rows before b
    rows = torch.arange(B * S, device=expert.device) // S
    in_row = pos - before[expert, rows]
    every = all_gather(all_gather(all_gather(ends - before, mesh, "sp"), mesh, "fsdp"), mesh, "dp")
    every = every.view(-1, sp, E, B)[first:first + g]  # [g, sp, E, B]
    order = every.permute(2, 0, 3, 1).reshape(E, -1)  # the group's order: shard, row, block
    offsets = (order.cumsum(1) - order).view(E, g, B, sp)
    offsets = offsets[:, shard - first, :, mesh.coordinate("sp")]  # [E, B]
    return in_row + offsets[expert, rows], every.sum((0, 1, 3)), B * S * g * sp


def _group_sum(x, mesh: Mesh, routing: Routing):
    """``x`` summed over the ranks of this rank's routing group (see
    :class:`Routing`), its gradient summed back over them (the gradients
    are averaged over those axes later)."""
    if routing.seq_split:
        x = all_reduce(x, mesh, "sp", grad="sum")
    k = mesh.size("dp") * mesh.size("fsdp")
    if routing.group == k:
        return all_reduce(x, mesh, mesh.spec.batch_axes, grad="sum")
    if routing.group == 1:
        return x
    every = all_gather_dim(all_gather_dim(x[None], mesh, "fsdp", 0), mesh, "dp", 0)  # [k, ...]
    first = _shard(mesh) // routing.group * routing.group
    return every[first:first + routing.group].sum(0)


def _moe_sublayer(x, p, cfg: GPT2Config, mesh: Mesh, routing: Routing | None = None):
    """Top-1 switch MoE (Fedus et al.) in place of the dense MLP, as the
    reference's: a softmax gate routes each token to one expert under a
    capacity limit; dropped tokens pass through the residual unchanged.
    Returns ``(x, aux)``, aux the Switch load-balancing loss
    ``E * sum_e f_e * P_e``.

    The reference dispatches with dense one-hot ``[N, E, C]`` tensors; this
    computes the same function in index form: each routed token's row goes
    to slot ``(expert, position)`` of an ``[E, C, D]`` buffer, and the
    result comes back by a gather scaled by the gate. Each one-hot einsum
    sums exactly one non-zero product, so the values are the same. Tokens
    not served here (dropped, or routed to another rank's expert) go to a
    sink row past the buffer, so no position past capacity is ever an index.

    The reference's program is global-view; under a mesh it is computed as
    such. The tokens routed together (``routing``, :class:`Routing`) are the
    global batch (the default), or inside the pipeline one global
    microbatch. Over the
    batch axes (``dp`` and ``fsdp``) each rank holds its rows of them: the
    capacity counts the group's N, a token's position counts the tokens of
    lower batch shards (an exclusive scan of their per-expert counts), and
    ``f`` and ``P`` are the group's means. Over ``sp`` each rank holds a
    block of every row, and a token's position also counts the blocks of
    lower ``sp`` ranks in its row and those of the rows before. Over ``ep``
    each rank holds ``E / ep`` experts and the whole of its batch rows: it
    serves the tokens routed to its own experts. Over ``tp`` each rank holds
    its slice of every local expert's hidden dim and the routing is
    replicated. The partial outputs are summed over ``ep`` and ``tp``."""
    B, S, D = x.shape
    E, cdt = cfg.n_experts, cfg.dtype
    routing = routing or Routing(mesh.size("dp") * mesh.size("fsdp"))
    h = _layer_norm(x, p["ln2_scale"], p["ln2_bias"])
    hf = h.reshape(B * S, D).to(cdt)

    probs = torch.softmax((hf @ p["gate_w"].to(cdt)).float(), dim=-1)  # [n, E]
    gate, expert = probs.max(dim=-1)
    pos, counts, N = _expert_positions(expert, B, S, E, mesh, routing)
    cap = max(int(cfg.expert_capacity_factor * N / E), 1)
    # Switch load-balancing auxiliary loss: f is the (pre-capacity) routed
    # fraction, P the mean router probability, both over the tokens routed
    # together.
    aux = E * torch.sum((counts.float() / N) * (_group_sum(probs.sum(0), mesh, routing) / N))
    keep = pos < cap  # over-capacity tokens dropped

    E_local = p["exp_w1"].shape[0]
    if E_local * mesh.size("ep") != E:
        raise ValueError(
            f"{E_local} local experts x ep={mesh.size('ep')} != n_experts={E}: "
            "pass the mesh the expert leaves are sharded over"
        )
    first = mesh.coordinate("ep") * E_local
    sink = E_local * cap
    served = keep & (expert >= first) & (expert < first + E_local)
    slot = torch.where(served, (expert - first) * cap + pos, sink)
    hf_e = grad_all_reduce(hf, mesh, ("ep", "tp"))
    gate_e = grad_all_reduce(gate, mesh, ("ep", "tp"))
    xe = hf_e.new_zeros(sink + 1, D).index_copy(0, slot, hf_e)[:sink].view(E_local, cap, D)
    he = torch.bmm(xe, p["exp_w1"].to(cdt)) + p["exp_b1"].to(cdt)[:, None, :]
    ye = torch.bmm(F.gelu(he, approximate="tanh"), p["exp_w2"].to(cdt)).reshape(sink, D)
    ye = torch.cat([ye, ye.new_zeros(1, D)])
    y = all_reduce(
        ye.index_select(0, slot) * gate_e.to(cdt)[:, None], mesh, ("ep", "tp"), grad="identity"
    )
    # Output bias only for tokens an expert actually served — dropped
    # (over-capacity) tokens pass through the residual truly unchanged.
    y = y + p["exp_b2"].to(cdt) * keep.to(cdt)[:, None]
    return x + y.reshape(B, S, D).to(x.dtype), aux


def hidden(
    params: Params, tokens: torch.Tensor, cfg: GPT2Config, mesh: Mesh | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] int -> ``(x, moe_aux)``: the final-LN hidden states
    [B, S, d_model] and the summed Switch load-balancing loss of the MoE
    layers (an f32 zero when dense).

    With grad enabled each block runs under ``cfg.remat``
    (:func:`~ray_tpu_torch.models.common.remat_policy`; "mlp" is "dots"
    under MoE and on the ring); without it, as it is. ``mesh``: the mesh
    the leaves are the local shards of; needed under any axis but ``dp``,
    and sharded leaves with no mesh raise ``ValueError``. Under ``sp`` the
    rank computes its block of the sequence and the hidden states are
    gathered whole; under ``pp`` the layers run as the GPipe schedule of
    ``cfg.pipeline_microbatches`` microbatches (one where it is 0)."""
    mesh, dims = _model_mesh(params, cfg, mesh)
    x, aux, seq = _hidden(params, tokens, cfg, mesh, dims)
    return (all_gather_dim(x, mesh, "sp", 1) if seq.split else x), aux


def _model_mesh(params: Params, cfg: GPT2Config, mesh: Mesh | None) -> tuple[Mesh, dict]:
    """The mesh of a call and the leaves' fsdp dims on it, resolved once a
    call (:func:`~ray_tpu_torch.models.common.model_mesh`)."""
    return model_mesh(params, cfg, mesh, param_logical_specs(cfg))


def _hidden(params: Params, tokens: torch.Tensor, cfg: GPT2Config, mesh: Mesh, dims: dict):
    """``(x, aux, seq)``: the hidden states of this rank's block ``seq`` of
    the whole rows ``tokens`` (all of it but under ``sp``)."""
    B, S = tokens.shape
    seq = seq_shard(mesh, S)
    tokens = seq.take(tokens)
    x = vocab_parallel_embed(gathered(params["wte"], mesh, dims["wte"], cfg.dtype), tokens, mesh)
    wpe = params["wpe"][seq.start:seq.start + seq.length]  # the block's global positions
    x = x + gathered(wpe, mesh, dims["wpe"], cfg.dtype)[None]
    pipelined = mesh.size("pp") > 1
    # raises on an unknown policy, as the reference does
    remat = remat_policy(cfg, x, ring=seq.split and not pipelined)
    if not torch.is_grad_enabled():
        remat = "none"  # nothing to save for a backward: run each block as it is
    n_micro = max(cfg.pipeline_microbatches, 1)
    if pipelined:
        routing = Routing(pipeline_microbatches(B, n_micro, mesh)[1], seq.split)
    else:  # the global batch
        routing = Routing(mesh.size("dp") * mesh.size("fsdp"), seq.split)

    def attn(x, p):
        return _attn_sublayer(x, _attn_weights(p, cfg, mesh, dims), cfg, mesh, seq, pipelined)

    if cfg.n_experts > 0:

        def mlp(x, p):
            return _moe_sublayer(x, _mlp_weights(p, cfg, mesh, dims), cfg, mesh, routing)

        def block(x, p):
            return remat_block(attn, mlp, x, p, remat)

    else:

        def mlp(x, p):
            return _mlp_sublayer(x, _mlp_weights(p, cfg, mesh, dims), cfg, mesh)

        def block(x, p):
            return remat_block(attn, mlp, x, p, remat), torch.zeros((), device=x.device)

    with reshard_after_forward(mesh):
        if pipelined:
            x, aux = pipelined_blocks(params["blocks"], x, block, mesh, n_micro=n_micro)
        else:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            for p in unbind_layers(params):
                x, layer_aux = block(x, p)
                aux = aux + layer_aux
    return _layer_norm(x, params["lnf_scale"], params["lnf_bias"]), aux, seq


def _head(params: Params, cfg: GPT2Config, mesh: Mesh, dims: dict) -> torch.Tensor:
    """The tied output projection ``wte`` [V/tp, D] in the activation dtype:
    this rank's vocabulary rows, gathered over ``fsdp``."""
    return gathered(params["wte"], mesh, dims["wte"], cfg.dtype)


def forward(params: Params, tokens: torch.Tensor, cfg: GPT2Config, mesh=None) -> torch.Tensor:
    """tokens [B, S] int -> logits [B, S, vocab] (activation dtype).
    Tied embeddings: logits = x @ wte^T (gathered over ``tp``, and over
    ``sp`` where the sequence is split, under a mesh)."""
    mesh, dims = _model_mesh(params, cfg, mesh)
    x, _, seq = _hidden(params, tokens, cfg, mesh, dims)
    logits = all_gather_dim(x @ _head(params, cfg, mesh, dims).T, mesh, "tp", -1)
    return all_gather_dim(logits, mesh, "sp", 1) if seq.split else logits


def loss_fn(params: Params, batch: dict, cfg: GPT2Config, mesh=None) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy: ``(loss, {"loss", "tokens"})``. batch:
    ``{"tokens": [B, S+1]}`` or ``{"tokens": [B, S], "targets": [B, S]}``.

    With ``cfg.loss_chunk`` and S past it, the loss is the chunked one with
    f32 logits from bf16 operands. Otherwise the logits are one product in
    the activation dtype, upcast to f32 (``ray_tpu/models/gpt2.py:432-439``).
    Under ``tp`` both are vocab-parallel. Under MoE the loss is
    ``ce + moe_aux_weight * moe_aux`` and the metrics add ``"moe_aux"``;
    ``"loss"`` stays the cross-entropy. The metrics stay on the device.
    ``mesh`` as for :func:`hidden`; the loss is the mean over this rank's
    rows, and under ``sp`` over its block of their positions, taken after
    the next-token shift."""
    inputs, targets = split_batch(batch)
    mesh, dims = _model_mesh(params, cfg, mesh)
    x, moe_aux, seq = _hidden(params, inputs, cfg, mesh, dims)
    ce, metrics = lm_loss(
        x, _head(params, cfg, mesh, dims), seq.take(targets), cfg.loss_chunk, mesh, seq.split
    )
    if cfg.n_experts == 0:
        return ce, metrics
    metrics["moe_aux"] = moe_aux.detach()
    return ce + cfg.moe_aux_weight * moe_aux, metrics


def num_params(cfg: GPT2Config) -> int:
    V, D, F_, L, S = cfg.vocab_size, cfg.d_model, cfg.d_ff, cfg.n_layer, cfg.max_seq
    per_layer = 4 * D + (D * 3 * D + 3 * D) + (D * D + D) + (D * F_ + F_) + (F_ * D + D)
    return V * D + S * D + L * per_layer + 2 * D
