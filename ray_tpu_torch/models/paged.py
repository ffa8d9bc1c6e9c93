"""Paged (block-table) KV cache for both model families. Port of
``ray_tpu/models/paged.py`` (``paged_prefill``, ``paged_decode`` and
``paged_verify``, the multi-token forward of speculative decoding).

- **The pool** is ``{"k","v": [L, N_blocks, KH, block, Dh]}`` tensors. A
  request owns a *block table*, ``[W]`` physical block ids with ``W =
  max_seq // block``, so device memory is held per block of tokens in use,
  not per ``max_seq`` slot row. Block 0 is a reserved scratch block:
  padded and free-slot writes land there and are never read unmasked.
- **Scatter, then gather.** New K/V are written straight into their
  (block, offset) homes **in place**; the attending pass gathers the
  request's blocks back into a dense ``[KH, S, Dh]`` row (a transient)
  and runs the same masked grouped-head products as the dense cache path,
  with the reference's rounding points: scores in the activation dtype
  then f32, scale and the -1e30 mask in f32, softmax in f32 cast to the
  value dtype before P·V. Plain PyTorch products, as the reference has
  plain ``jnp.einsum``: no kernel runs here.
- **Prefix sharing is free**: a pooled prefix is a list of block ids; a
  hit points the new request's first table entries at the shared blocks
  (host-side refcount), with no device copy.

Index semantics differ from JAX's, where a gather clamps an out-of-range
index and a scatter drops it. Here a prefill or a verify whose rows reach
past the table raises ``ValueError`` before anything is written; the
engine's bucket guards and its spec-step guard keep every served write
inside the table.

Family dispatch (GPT-2: learned positions, multi-head; Llama: RoPE, GQA)
is a small hook table built by :func:`_family`, once per engine; the rest
is family-agnostic, because GQA with group 1 is multi-head attention.

Under a mesh whose ``tp`` axis has size > 1 the pool holds this rank's KV
heads and the hooks are the tensor-parallel ones of the family's decode
module (vocab-parallel embedding, one all-reduce after each row-split
product, logits gathered whole): the block ids, tables and masks are the
same on every rank, so the host's block manager serves them all.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ray_tpu_torch.models import gpt2, gpt2_decode, llama, llama_decode
from ray_tpu_torch.parallel.mesh import Mesh, local_mesh

Params = dict


def init_block_pool(
    cfg, num_blocks: int, block_size: int, *, device: "str | torch.device",
    mesh: Mesh = local_mesh(),
):
    """Zeroed pool {"k","v"}: [L, N, KH, block, Dh] in the activation
    dtype, on ``device``. KH is the KV-head count (unexpanded GQA for
    Llama) that this rank holds under ``mesh``."""
    kh = _decode_module(cfg).local_heads(cfg, mesh)[1]
    shape = (cfg.n_layer, num_blocks, kh, block_size, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
    }


# ---------------------------------------------------------------------------
# Family hooks


def _is_llama(cfg) -> bool:
    return isinstance(cfg, llama.LlamaConfig)


def _decode_module(cfg):
    return llama_decode if _is_llama(cfg) else gpt2_decode


class Hooks(NamedTuple):
    """``embed(params, tokens, pos2d)``, ``qkv(x, p, pos2d)`` -> (q [B,H,T,Dh],
    k and v [B,KH,T,Dh]), ``finish(x, attn, p)``, ``final(params, last)``
    -> f32 logits; ``pos2d`` is always [B, T] absolute positions."""

    embed: Callable
    qkv: Callable
    finish: Callable
    final: Callable
    H: int
    KH: int
    Dh: int


def _family(cfg, S: int, device, mesh: Mesh = local_mesh()) -> Hooks:
    """The hook table for ``cfg``'s family at cache length ``S``, for this
    rank's heads under ``mesh``. Llama's RoPE tables are computed here,
    once for all positions below S."""
    H, KH = _decode_module(cfg).local_heads(cfg, mesh)
    Dh = cfg.head_dim
    if _is_llama(cfg):
        cos_full, sin_full = llama.rope_tables(cfg, S, device)

        def embed(params, tokens, pos2d):
            return llama_decode._embed(params, tokens, cfg, mesh)

        def qkv(x, p, pos2d):
            return llama._qkv_rope(x, p, cfg, cos_full[pos2d], sin_full[pos2d])

        def finish(x, attn, p):
            return llama_decode._attn_out(x, attn, p, cfg, mesh)

        def final(params, last):  # [..., D] -> [..., vocab] f32
            return llama_decode._logits(params, last, cfg, mesh)

    else:

        def embed(params, tokens, pos2d):
            wpe = params["wpe"].to(cfg.dtype)
            return gpt2_decode._embed(params, tokens, cfg, mesh) + wpe[pos2d]

        def qkv(x, p, pos2d):
            return gpt2_decode._qkv(x, p, cfg)

        def finish(x, attn, p):
            return gpt2_decode._finish_block(x, attn, p, cfg, mesh)

        def final(params, last):
            return gpt2_decode._logits(params, last, cfg, mesh)

    return Hooks(embed, qkv, finish, final, H, KH, Dh)


# ---------------------------------------------------------------------------
# Paged ops


def paged_prefill(
    params: Params,
    tokens: torch.Tensor,  # [1, T] int: suffix tokens (the whole prompt if
    #                        start == 0), left-aligned in a bucket
    length: int,  # true suffix token count (<= T)
    start: int,  # cached-prefix length (block-aligned; 0 for a fresh prompt)
    table: torch.Tensor,  # [W] int block table of this request
    pool,
    cfg,
    *,
    block_size: int,
    hooks: Hooks | None = None,
):
    """Prefill positions [start, start+T) into the pool in place; return
    (pool, last_logits [vocab] f32).

    One function serves the fresh path (start=0) and the prefix-continue
    path: attention always spans the full gathered row under the mask
    ``col <= start + row``. ``hooks`` is :func:`_family`'s table, built
    here when not given. Raises ``ValueError`` when the rows reach past
    the table, where the reference would clamp them into its last block."""
    B, T = tokens.shape
    W = table.shape[0]
    S = W * block_size
    if B != 1 or start < 0 or start + T > S:
        raise ValueError(
            f"paged prefill of rows [{start}, {start + T}) for batch {B} does not fit "
            f"a table of {W} blocks of {block_size}"
        )
    embed, qkv, finish, final, H, KH, Dh = hooks or _family(cfg, S, tokens.device)
    group = H // max(KH, 1)  # a rank past the head count has no heads
    dev = tokens.device

    pos = start + torch.arange(T, device=dev)  # [T]
    x = embed(params, tokens, pos[None])
    bids = table[pos // block_size][:, None]  # [T, 1] physical blocks to write
    offs = (pos % block_size)[:, None]
    khi = torch.arange(KH, device=dev)[None, :]
    # Rows of the pool viewed as [N*KH, block*Dh]: (block table[w], head k)
    # is row table[w]*KH + k, so one gather on dim 0 writes [KH, W, block*Dh].
    gather = table[None, :] * KH + khi.T  # [KH, W]
    mask = torch.arange(S, device=dev)[None, :] <= pos[:, None]  # [T, S]
    scale = 1.0 / (Dh**0.5)
    for i in range(cfg.n_layer):
        p = gpt2.layer_params(params, i)
        pk, pv = pool["k"][i], pool["v"][i]  # [N, KH, block, Dh] views
        q, k, v = qkv(x, p, pos[None])  # q [1,H,T,Dh], k/v [1,KH,T,Dh]
        pk[bids, khi, offs] = k[0].transpose(0, 1)  # [T, KH, Dh]
        pv[bids, khi, offs] = v[0].transpose(0, 1)
        # This request's row (a transient), viewed as [KH, S, Dh].
        kd = pk.view(-1, block_size * Dh)[gather].view(KH, S, Dh)
        vd = pv.view(-1, block_size * Dh)[gather].view(KH, S, Dh)
        qg = q[0].reshape(KH, group, T, Dh)
        s = torch.einsum("kgtd,ksd->kgts", qg, kd).float() * scale
        s = torch.where(mask, s, -1e30)
        pa = torch.softmax(s, dim=-1).to(vd.dtype)
        attn = torch.einsum("kgts,ksd->kgtd", pa, vd).reshape(1, H, T, Dh)
        x = finish(x, attn, p)
    return pool, final(params, x[0, length - 1])


def paged_verify(
    params: Params,
    tokens: torch.Tensor,  # [B, T] int: token t of row b sits at position
    #                        positions[b] + t
    positions: torch.Tensor,  # [B] int, on the host: first write position per slot
    tables: torch.Tensor,  # [B, W] int: per-slot block tables
    pool,
    cfg,
    *,
    block_size: int,
    hooks: Hooks | None = None,
):
    """Score T consecutive tokens per slot in one forward, the target's
    verification pass in speculative decoding (:func:`paged_decode` is the
    T=1 case). Their K/V are written into the pool in place; returns
    (pool, logits [B, T, vocab] f32), logits[b, t] being the next-token
    distribution after tokens[b, t].

    ``positions`` is read on the host: rows that would reach past the table
    (``positions + T > W * block``) raise ``ValueError`` before anything is
    written, where the reference's scatter would clamp them into the slot's
    last block. The gather is :func:`paged_decode`'s one-index row gather."""
    B, T = tokens.shape
    W = tables.shape[1]
    S = W * block_size
    if positions.shape != (B,) or int(positions.min()) < 0 or int(positions.max()) + T > S:
        raise ValueError(
            f"paged verify of {T} rows at positions {positions.tolist()} does not fit "
            f"a table of {W} blocks of {block_size}"
        )
    embed, qkv, finish, final, H, KH, Dh = hooks or _family(cfg, S, tokens.device)
    group = H // max(KH, 1)  # a rank past the head count has no heads
    dev = tokens.device

    # Host to device without a stream sync (the caller pins a CUDA run's copy).
    pos2d = positions.to(dev, non_blocking=True).long()[:, None] + torch.arange(T, device=dev)
    x = embed(params, tokens, pos2d)  # [B, T, D]
    rows = torch.arange(B, device=dev)[:, None]
    bids = tables[rows, pos2d // block_size][:, :, None]  # [B, T, 1]
    offs = (pos2d % block_size)[:, :, None]
    khi = torch.arange(KH, device=dev)
    gather = tables[:, None, :] * KH + khi[None, :, None]  # [B, KH, W] rows, as in paged_decode
    mask = torch.arange(S, device=dev)[None, None, :] <= pos2d[:, :, None]  # [B, T, S]
    scale = 1.0 / (Dh**0.5)
    for i in range(cfg.n_layer):
        p = gpt2.layer_params(params, i)
        pk, pv = pool["k"][i], pool["v"][i]  # [N, KH, block, Dh] views
        q, k, v = qkv(x, p, pos2d)  # q [B,H,T,Dh], k/v [B,KH,T,Dh]
        pk[bids, khi[None, None, :], offs] = k.transpose(1, 2)  # [B, T, KH, Dh]
        pv[bids, khi[None, None, :], offs] = v.transpose(1, 2)
        kd = pk.view(-1, block_size * Dh)[gather].view(B, KH, S, Dh)
        vd = pv.view(-1, block_size * Dh)[gather].view(B, KH, S, Dh)
        qg = q.reshape(B, KH, group, T, Dh)
        s = torch.einsum("bkgtd,bksd->bkgts", qg, kd).float() * scale
        s = torch.where(mask[:, None, None], s, -1e30)
        pa = torch.softmax(s, dim=-1).to(vd.dtype)
        attn = torch.einsum("bkgts,bksd->bkgtd", pa, vd).reshape(B, H, T, Dh)
        x = finish(x, attn, p)
    return pool, final(params, x.reshape(B * T, -1)).reshape(B, T, -1)


def paged_decode(
    params: Params,
    last_tokens: torch.Tensor,  # [B] int
    positions: torch.Tensor,  # [B] int: write position per slot
    tables: torch.Tensor,  # [B, W] int: per-slot block tables
    pool,
    cfg,
    *,
    block_size: int,
    hooks: Hooks | None = None,
):
    """One token per slot against the shared pool, written in place;
    returns (pool, logits [B, vocab] f32). Free slots must point their
    table at the scratch block (id 0) so their writes never land in a block
    another request owns; every position must lie inside the table."""
    B = last_tokens.shape[0]
    W = tables.shape[1]
    S = W * block_size
    embed, qkv, finish, final, H, KH, Dh = hooks or _family(cfg, S, last_tokens.device)
    group = H // max(KH, 1)  # a rank past the head count has no heads
    dev = last_tokens.device
    positions = positions.long()

    x = embed(params, last_tokens[:, None], positions[:, None])  # [B, 1, D]
    rows = torch.arange(B, device=dev)
    bids = tables[rows, positions // block_size][:, None]  # [B, 1]
    offs = (positions % block_size)[:, None]
    khi = torch.arange(KH, device=dev)[None, :]
    gather = tables[:, None, :] * KH + khi[:, :, None]  # [B, KH, W] rows, as in paged_prefill
    mask = torch.arange(S, device=dev)[None, :] <= positions[:, None]  # [B, S]
    scale = 1.0 / (Dh**0.5)
    for i in range(cfg.n_layer):
        p = gpt2.layer_params(params, i)
        pk, pv = pool["k"][i], pool["v"][i]  # [N, KH, block, Dh] views
        q, k, v = qkv(x, p, positions[:, None])  # [B, {H,KH}, 1, Dh]
        pk[bids, khi, offs] = k[:, :, 0, :]
        pv[bids, khi, offs] = v[:, :, 0, :]
        # Every slot's row in one gather, already in [B, KH, S, Dh] order.
        kd = pk.view(-1, block_size * Dh)[gather].view(B, KH, S, Dh)
        vd = pv.view(-1, block_size * Dh)[gather].view(B, KH, S, Dh)
        qg = q[:, :, 0, :].reshape(B, KH, group, Dh)
        s = torch.einsum("bkgd,bksd->bkgs", qg, kd).float() * scale
        s = torch.where(mask[:, None, None, :], s, -1e30)
        pa = torch.softmax(s, dim=-1).to(vd.dtype)
        attn = torch.einsum("bkgs,bksd->bkgd", pa, vd).reshape(B, H, 1, Dh)
        x = finish(x, attn, p)
    return pool, final(params, x[:, 0, :])
