"""Llama-family decoder in PyTorch: RMSNorm, RoPE, GQA, SwiGLU. Port of
``ray_tpu/models/llama.py`` (``hidden`` with the remat ladder, ``forward``,
``loss_fn``).

Parameters are a plain dict with the reference's stacked layout (every
per-layer leaf under ``params["blocks"]`` with a leading ``[L, ...]`` dim),
so a JAX pytree converts key for key
(:func:`ray_tpu_torch.models.convert.llama_params_from_numpy`). Activations
run in ``cfg.dtype`` and parameters are kept in ``cfg.param_dtype``; each
matmul weight is cast to the activation dtype where the reference casts it.

Differences from GPT-2, as in the reference: RMSNorm (no mean-centring, no
bias), rotary position embeddings (no learned position table), SwiGLU MLP,
no biases, an untied output head, and grouped-query attention: each KV head
is repeated for its group of query heads before the attention kernel (in
training, autograd sums the expanded K/V's gradients over each group).

Training runs the remat policies and the next-token loss that GPT-2 runs
(:mod:`ray_tpu_torch.models.common`). Under a mesh each rank holds the
local shard of every leaf that ``DEFAULT_RULES`` gives, and the model
computes the reference's global-view result over ``dp``, ``fsdp``, ``ep``
and ``tp``: leaves split over ``fsdp`` are gathered where a layer uses them;
under ``tp`` ``wq`` is split by heads, SwiGLU by columns (``w_gate``,
``w_up``) and rows (``w_down``), ``wo`` by rows, and the embedding and
``lm_head`` by vocabulary. ``wk``/``wv`` stay whole over ``tp``; each rank
projects only the KV heads its query heads read, so its gradient of them
is partial and is summed over ``tp``. Over ``sp`` each rank takes a block
of the sequence, with RoPE at the block's global positions, and attention
runs over the ring with K/V repeated to the query heads first; over
``pp`` the stacked layers run as the GPipe schedule of
``cfg.pipeline_microbatches`` microbatches
(:func:`~ray_tpu_torch.models.common.pipelined_blocks`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from ray_tpu_torch.models.common import (
    SeqShard,
    gathered,
    lm_loss,
    model_mesh,
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
from ray_tpu_torch.models.gpt2 import head_block, layer_params  # the same stacked layout
from ray_tpu_torch.ops.attention import causal_attention
from ray_tpu_torch.parallel.mesh import Mesh, local_mesh
from ray_tpu_torch.parallel.sharding import all_gather_dim, all_reduce, grad_all_reduce
from ray_tpu_torch.util.device import resolve_device

Params = dict


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    n_layer: int = 12
    n_head: int = 12
    n_kv_head: int = 4  # grouped-query attention (n_head % n_kv_head == 0)
    d_model: int = 768
    d_ff: int = 2048  # SwiGLU hidden (~8/3 * d rounded to 256)
    max_seq: int = 1024
    rope_theta: float = 10000.0
    dtype: Any = torch.bfloat16  # activation dtype
    param_dtype: Any = torch.float32
    attn_impl: str = "auto"  # "auto" | "cuda" | "reference"
    rms_eps: float = 1e-5
    # Rematerialization in training, as GPT2Config.remat: "full", "dots",
    # "mlp" (attention outside the checkpoint; "dots" where the flash
    # kernel is not in use) or "none".
    remat: str = "mlp"
    # LM-head loss: sequence positions per chunk of the rematerialized
    # logits (0: one unchunked product).
    loss_chunk: int = 128
    # GPipe microbatches over the mesh's pp axis, as GPT2Config's (one
    # microbatch where it is 0 and pp is above 1).
    pipeline_microbatches: int = 0

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_head == 0
        return self.d_model // self.n_head

    @property
    def kv_dim(self) -> int:
        assert self.n_head % self.n_kv_head == 0
        return self.n_kv_head * self.head_dim

    @staticmethod
    def llama_125m() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def tiny(
        n_layer: int = 2,
        d_model: int = 128,
        n_head: int = 4,
        n_kv_head: int = 2,
        vocab_size: int = 512,
        max_seq: int = 256,
    ) -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=vocab_size,
            n_layer=n_layer,
            n_head=n_head,
            n_kv_head=n_kv_head,
            d_model=d_model,
            d_ff=2 * d_model,
            max_seq=max_seq,
        )


# Leaves the reference casts to the activation dtype at each use; the norm
# scales stay in f32.
MATMUL_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def param_logical_specs(cfg: LlamaConfig) -> Params:
    """Logical axis names per parameter (leaves are tuples of names)."""
    L = ("layers",)
    return {
        "wte": ("vocab", "embed"),
        "blocks": {
            "attn_norm": L + ("norm",),
            "wq": L + ("embed", "mlp"),
            "wk": L + ("embed", "kv"),
            "wv": L + ("embed", "kv"),
            "wo": L + ("mlp", "embed"),
            "mlp_norm": L + ("norm",),
            "w_gate": L + ("embed", "mlp"),
            "w_up": L + ("embed", "mlp"),
            "w_down": L + ("mlp", "embed"),
        },
        "final_norm": ("norm",),
        "lm_head": ("embed", "vocab"),
    }


def init_params(
    generator: torch.Generator, cfg: LlamaConfig, device: "str | torch.device" = "cuda"
) -> Params:
    """N(0, 0.02) weights, the output projections of each block scaled by
    1/sqrt(2*n_layer), ones for the norm scales. Draws on the generator's
    device, then moves to ``device``: the card unless the caller asks for
    ``"cpu"`` (a CUDA request with no GPU raises). The numbers differ from
    the reference's ``jax.random`` for the same seed."""
    device = resolve_device(device)
    std = 0.02
    pd = cfg.param_dtype
    L, D, F_, V, KD = cfg.n_layer, cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.kv_dim
    resid_std = std / (2 * L) ** 0.5
    gen_dev = generator.device

    def normal(shape, s=std):
        x = torch.randn(shape, generator=generator, device=gen_dev, dtype=torch.float32)
        return (x * s).to(device=device, dtype=pd)

    def ones(shape):
        return torch.ones(shape, dtype=pd, device=device)

    return {
        "wte": normal((V, D)),
        "blocks": {
            "attn_norm": ones((L, D)),
            "wq": normal((L, D, D)),
            "wk": normal((L, D, KD)),
            "wv": normal((L, D, KD)),
            "wo": normal((L, D, D), resid_std),
            "mlp_norm": ones((L, D)),
            "w_gate": normal((L, D, F_)),
            "w_up": normal((L, D, F_)),
            "w_down": normal((L, F_, D), resid_std),
        },
        "final_norm": ones((D,)),
        "lm_head": normal((D, V)),
    }


def compute_params(params: Params, cfg: LlamaConfig) -> Params:
    """The same tree with every matmul weight, the embedding and the output
    head cast once to the activation dtype (the reference's per-matmul
    ``.astype(cfg.dtype)`` gives the same values); norm scales stay in
    their parameter dtype."""
    blocks = {
        k: (v.to(cfg.dtype) if k in MATMUL_LEAVES else v)
        for k, v in params["blocks"].items()
    }
    out = dict(params, blocks=blocks)
    out["wte"] = params["wte"].to(cfg.dtype)
    out["lm_head"] = params["lm_head"].to(cfg.dtype)
    return out


def _rms_norm(x, scale, eps):
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * rms * scale).to(x.dtype)


def rope_tables(cfg: LlamaConfig, seq: int, device):
    """(cos, sin) ``[seq, head_dim/2]`` f32 rotary tables."""
    half = cfg.head_dim // 2
    freqs = cfg.rope_theta ** (-torch.arange(0, half, dtype=torch.float32, device=device) / half)
    angles = torch.arange(seq, dtype=torch.float32, device=device)[:, None] * freqs[None, :]
    return torch.cos(angles), torch.sin(angles)


def _apply_rope(t, cos, sin):
    """The half-split (GPT-NeoX/HF) rotation of ``t [B, n, T, Dh]``:
    dimension i pairs with i + Dh/2. ``cos``/``sin`` are the tables' rows
    for t's positions, ``[T, Dh/2]`` (one position per row for the whole
    batch) or ``[B, T, Dh/2]`` (per slot); they are cast to t's dtype before
    the multiply, as in the reference. The result is contiguous."""
    t1, t2 = t.chunk(2, dim=-1)
    c, s = cos.unsqueeze(-3).to(t.dtype), sin.unsqueeze(-3).to(t.dtype)
    return torch.cat([t1 * c - t2 * s, t1 * s + t2 * c], dim=-1)


def expand_kv(t, group: int):
    """GQA: ``[B, KH, S, Dh]`` -> ``[B, KH*group, S, Dh]``, each KV head
    repeated for its ``group`` query heads in a row (``jnp.repeat`` on the
    head axis). The result is contiguous, as the flash kernel takes it."""
    return t.repeat_interleave(group, dim=1)


def _qkv_rope(x, p, cfg: LlamaConfig, cos, sin, mesh: Mesh = local_mesh()):
    """x [B, T, D] -> (q [B,H,T,Dh], k [B,KH,T,Dh], v [B,KH,T,Dh]): RMSNorm,
    the three projections, and q and k rotated with the position rows
    ``cos``/``sin`` (see :func:`_apply_rope`). The head counts are the
    weights' own: under ``tp`` (``p`` from :func:`_attn_weights`) this
    rank's query heads and the KV heads they read, the normed input
    entering through :func:`grad_all_reduce`."""
    B, T, _ = x.shape
    Dh = cfg.head_dim
    h = grad_all_reduce(_rms_norm(x, p["attn_norm"], cfg.rms_eps), mesh, "tp")

    def heads(w):
        cols = p[w].shape[-1]  # a rank past the head count has none
        return (h @ p[w].to(cfg.dtype)).reshape(B, T, cols // Dh, Dh).transpose(1, 2)

    return (
        _apply_rope(heads("wq"), cos, sin),
        _apply_rope(heads("wk"), cos, sin),
        heads("wv"),
    )


def kv_heads(cfg: LlamaConfig, tp: int, rank: int) -> list[int]:
    """The KV heads, in order, that rank ``rank`` of ``tp`` keeps for its
    query heads (:func:`~ray_tpu_torch.models.gpt2.head_block`; query head ``h`` reads KV head
    ``h // (n_head / n_kv_head)``): each it reads once, where every one of
    them serves as many of its query heads as the others (a block of whole
    groups, a part of one group that ranks share, or one head of each of
    several groups); else one for each query head, a KV head kept as often
    as its query heads read it. Either way the rank's query head ``i``
    reads its KV head ``i // (H_local / KH_local)``, as the grouped
    attention paths take it."""
    lo, hi = head_block(cfg.n_head, tp, rank)
    group = cfg.n_head // cfg.n_kv_head
    reads = [h // group for h in range(lo, hi)]
    once = sorted(set(reads))
    if all(reads.count(k) * len(once) == len(reads) for k in once):
        return once
    return reads


def kv_columns(t: torch.Tensor, heads: list[int], head_dim: int) -> torch.Tensor:
    """The columns of ``t [..., n_kv_head * head_dim]`` of ``heads`` in
    order: a view where they are one contiguous run (no columns for no
    heads)."""
    if not heads:
        return t[..., :0]
    if heads == list(range(heads[0], heads[-1] + 1)):
        return t[..., heads[0] * head_dim:(heads[-1] + 1) * head_dim]
    return torch.cat([t[..., h * head_dim:(h + 1) * head_dim] for h in heads], dim=-1)


def _train_kv_heads(cfg: LlamaConfig, mesh: Mesh) -> list[int]:
    """:func:`kv_heads` of this rank in training, where ``wq`` is split
    by the rule's even column blocks: raises unless ``tp`` divides the
    query heads."""
    tp = mesh.size("tp")
    if cfg.n_head % tp:
        raise ValueError(f"n_head={cfg.n_head} does not split over tp={tp}")
    return kv_heads(cfg, tp, mesh.coordinate("tp"))


def _attn_weights(p, cfg: LlamaConfig, mesh: Mesh, dims: dict) -> dict:
    """This rank's attention weights of one layer in the activation dtype,
    gathered over ``fsdp``: ``wq``'s columns and ``wo``'s rows of its own
    heads, and the columns of ``wk``/``wv`` for the KV heads they read.
    ``wk``/``wv`` are whole over ``tp``, and each rank uses a part of them,
    so their gradients are summed over ``tp`` (:func:`grad_all_reduce`).
    Off such a mesh the leaves as they are: the sublayer casts them."""
    if not sharded_layers(mesh):
        return p
    heads = _train_kv_heads(cfg, mesh)

    def kv(t):
        return kv_columns(t, heads, cfg.head_dim)

    out = dict(p, **{k: gathered(p[k], mesh, dims[k], cfg.dtype) for k in ("wq", "wo")})
    for k in ("wk", "wv"):
        out[k] = gathered(grad_all_reduce(p[k], mesh, "tp"), mesh, dims[k], cfg.dtype, kv)
    return out


def _mlp_weights(p, cfg: LlamaConfig, mesh: Mesh, dims: dict) -> dict:
    """This rank's SwiGLU weights of one layer in the activation dtype,
    gathered over ``fsdp`` (the leaves as they are off such a mesh)."""
    if not sharded_layers(mesh):
        return p
    names = ("w_gate", "w_up", "w_down")
    return dict(p, **{k: gathered(p[k], mesh, dims[k], cfg.dtype) for k in names})


def _attn_sublayer(x, p, cfg: LlamaConfig, cos, sin, mesh: Mesh = local_mesh(),
                   seq: SeqShard | None = None, pipelined: bool = False):
    """``x`` plus attention over this rank's heads, ``cos``/``sin`` the
    rotary rows of ``x``'s positions ``seq`` (all of them by default).
    K/V are repeated to the query heads before the ring where the sequence
    is split over ``sp``, as the reference repeats them; inside the
    pipeline they are gathered whole over ``sp`` first, then repeated
    (:func:`~ray_tpu_torch.models.common.sequence_attention`)."""
    B, S, D = x.shape
    q, k, v = _qkv_rope(x, p, cfg, cos, sin, mesh)
    group = q.shape[1] // k.shape[1]

    def whole(q, k, v):
        return causal_attention(q, k, v, impl=cfg.attn_impl)

    seq = seq or SeqShard(0, S, False)
    attn = sequence_attention(q, k, v, mesh, seq, pipelined, whole,
                              expand=lambda t: expand_kv(t, group))
    attn = attn.transpose(1, 2).reshape(B, S, -1)
    return x + all_reduce(attn @ p["wo"].to(cfg.dtype), mesh, "tp", grad="identity")


def _mlp_sublayer(x, p, cfg: LlamaConfig, mesh: Mesh = local_mesh()):
    h = grad_all_reduce(_rms_norm(x, p["mlp_norm"], cfg.rms_eps), mesh, "tp")
    gate = h @ p["w_gate"].to(cfg.dtype)
    up = h @ p["w_up"].to(cfg.dtype)
    out = (F.silu(gate) * up) @ p["w_down"].to(cfg.dtype)
    return x + all_reduce(out, mesh, "tp", grad="identity")


def hidden(params: Params, tokens: torch.Tensor, cfg: LlamaConfig, mesh=None) -> torch.Tensor:
    """tokens [B, S] int -> final-RMSNorm hidden states [B, S, d_model].

    With grad enabled each block runs under ``cfg.remat``
    (:func:`~ray_tpu_torch.models.common.remat_policy`; "mlp" is "dots" on
    the ring); without it, as it is. ``mesh``: the mesh the leaves are the
    local shards of; needed under any axis but ``dp``, and sharded leaves
    with no mesh raise ``ValueError``. Under ``sp`` the rank computes its
    block of the sequence (RoPE at the block's global positions) and the
    hidden states are gathered whole; under ``pp`` the layers run as the
    GPipe schedule of ``cfg.pipeline_microbatches`` microbatches (one
    where it is 0), as ``ray_tpu/models/llama.py:210-275``."""
    mesh, dims = _model_mesh(params, cfg, mesh)
    x, seq = _hidden(params, tokens, cfg, mesh, dims)
    return all_gather_dim(x, mesh, "sp", 1) if seq.split else x


def _model_mesh(params: Params, cfg: LlamaConfig, mesh: Mesh | None) -> tuple[Mesh, dict]:
    """The mesh of a call and the leaves' fsdp dims on it, resolved once a
    call (:func:`~ray_tpu_torch.models.common.model_mesh`)."""
    return model_mesh(params, cfg, mesh, param_logical_specs(cfg))


def _hidden(params: Params, tokens: torch.Tensor, cfg: LlamaConfig, mesh: Mesh, dims: dict):
    """``(x, seq)``: the hidden states of this rank's block ``seq`` of the
    whole rows ``tokens`` (all of it but under ``sp``)."""
    S = tokens.shape[1]
    seq = seq_shard(mesh, S)
    tokens = seq.take(tokens)
    x = vocab_parallel_embed(gathered(params["wte"], mesh, dims["wte"], cfg.dtype), tokens, mesh)
    cos, sin = (seq.take(t, 0) for t in rope_tables(cfg, S, tokens.device))  # global positions
    pipelined = mesh.size("pp") > 1
    # raises on an unknown policy, as the reference does
    remat = remat_policy(cfg, x, ring=seq.split and not pipelined)
    if not torch.is_grad_enabled():
        remat = "none"  # nothing to save for a backward: run each block as it is

    def attn(x, p):
        return _attn_sublayer(x, _attn_weights(p, cfg, mesh, dims), cfg, cos, sin, mesh, seq,
                              pipelined)

    def mlp(x, p):
        return _mlp_sublayer(x, _mlp_weights(p, cfg, mesh, dims), cfg, mesh)

    def block(x, p):
        return remat_block(attn, mlp, x, p, remat), torch.zeros((), device=x.device)

    with reshard_after_forward(mesh):
        if pipelined:
            n_micro = max(cfg.pipeline_microbatches, 1)
            x = pipelined_blocks(params["blocks"], x, block, mesh, n_micro=n_micro)[0]
        else:
            for p in unbind_layers(params):
                x = remat_block(attn, mlp, x, p, remat)
    return _rms_norm(x, params["final_norm"], cfg.rms_eps), seq


def _head(params: Params, cfg: LlamaConfig, mesh: Mesh, dims: dict) -> torch.Tensor:
    """``lm_head`` [D, V/tp] in the activation dtype, transposed to
    [V/tp, D]: this rank's vocabulary columns, gathered over ``fsdp``."""
    return gathered(params["lm_head"], mesh, dims["lm_head"], cfg.dtype).T


def forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig, mesh=None) -> torch.Tensor:
    """tokens [B, S] int -> logits [B, S, vocab] (activation dtype;
    gathered over ``tp``, and over ``sp`` where the sequence is split,
    under a mesh)."""
    mesh, dims = _model_mesh(params, cfg, mesh)
    x, seq = _hidden(params, tokens, cfg, mesh, dims)
    logits = all_gather_dim(x @ _head(params, cfg, mesh, dims).T, mesh, "tp", -1)
    return all_gather_dim(logits, mesh, "sp", 1) if seq.split else logits


def loss_fn(params: Params, batch: dict, cfg: LlamaConfig, mesh=None) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy: ``(loss, {"loss", "tokens"})``, with the
    batch contract of :func:`ray_tpu_torch.models.gpt2.loss_fn`. The
    untied head ``lm_head [D, V]`` goes to the loss transposed, as at
    ``ray_tpu/models/llama.py:298-301``; under ``tp`` it is this rank's
    vocabulary columns and the loss is vocab-parallel. Under ``sp`` the
    loss is the mean over this rank's block of the positions, taken after
    the next-token shift."""
    inputs, targets = split_batch(batch)
    mesh, dims = _model_mesh(params, cfg, mesh)
    x, seq = _hidden(params, inputs, cfg, mesh, dims)
    head = _head(params, cfg, mesh, dims)
    return lm_loss(x, head, seq.take(targets), cfg.loss_chunk, mesh, seq.split)


def num_params(cfg: LlamaConfig) -> int:
    D, F_, V, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layer
    KD = cfg.kv_dim
    per_layer = 2 * D + D * D + 2 * D * KD + D * D + 3 * D * F_
    return V * D + L * per_layer + D + D * V
