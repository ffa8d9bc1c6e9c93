"""Llama autoregressive inference: GQA KV cache, RoPE-aware prefill and
decode. Port of ``ray_tpu/models/llama_decode.py``.

The cache stores the ``n_kv_head`` heads unexpanded, ``[L, B, KH, S, Dh]``,
``n_head / n_kv_head`` times smaller than a full multi-head cache.

- :func:`prefill` repeats each KV head for its query-head group and runs
  causal attention (the CUDA flash kernel on an H100) over the expanded
  K/V; the cache keeps the unexpanded heads.
- :func:`prefill_continue` and :func:`decode_step` fold the group into
  the query-head axis instead (``q [B, KH, group, ., Dh]`` against the
  cache's ``[B, KH, S, Dh]``), with plain PyTorch products as the reference
  has plain ``jnp.einsum``: no kernel runs there.

As in :mod:`ray_tpu_torch.models.gpt2_decode`, the cache is updated **in
place** and returned for the reference's call shape, and a write that
does not fit the cache raises where the reference would clamp it.

Under a mesh whose ``tp`` axis has size > 1 each rank holds its query
heads and the KV heads they read (:func:`local_heads`; ``params`` from
:func:`ray_tpu_torch.models.convert.tp_shard`): the cache carries those KV
heads only, the embedding is vocab-parallel, ``wo``'s and ``w_down``'s
partial products are each summed by one all-reduce, and the logits of each
rank's ``lm_head`` columns are gathered whole. Head counts come from the
projections and the cache.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.models.common import gather_vocab, vocab_parallel_embed
from ray_tpu_torch.models.gpt2 import head_block
from ray_tpu_torch.models.llama import (
    LlamaConfig,
    _mlp_sublayer,
    _qkv_rope,
    _rms_norm,
    expand_kv,
    kv_heads,
    layer_params,
    rope_tables,
)
from ray_tpu_torch.ops.attention import causal_attention
from ray_tpu_torch.parallel.mesh import Mesh, local_mesh
from ray_tpu_torch.parallel.sharding import all_reduce_

Params = dict


def init_kv_cache(
    cfg: LlamaConfig,
    n_slots: int,
    max_seq: int | None = None,
    *,
    device: "str | torch.device",
    mesh: Mesh = local_mesh(),
):
    """Zeroed cache: {"k","v"}: [L, B, KH, S, Dh] (unexpanded GQA) in the
    activation dtype, on ``device`` (no default: the caller names where the
    cache lives); KH is the KV heads this rank reads under ``mesh``."""
    S = max_seq or cfg.max_seq
    shape = (cfg.n_layer, n_slots, local_heads(cfg, mesh)[1], S, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
    }


def local_heads(cfg: LlamaConfig, mesh: Mesh) -> tuple[int, int]:
    """(query heads, KV heads) of one rank under ``mesh``'s ``tp``: its
    block of query heads (:func:`~ray_tpu_torch.models.gpt2.head_block`,
    uneven where ``tp`` does not divide them) and the KV heads it keeps
    for them (:func:`~ray_tpu_torch.models.llama.kv_heads`; ranks whose
    query heads share a KV head each hold it)."""
    tp, r = mesh.size("tp"), mesh.coordinate("tp")
    lo, hi = head_block(cfg.n_head, tp, r)
    return hi - lo, len(kv_heads(cfg, tp, r))


def _attn_out(x, attn, p, cfg: LlamaConfig, mesh: Mesh = local_mesh()):
    """Merge heads ``[B, H, T, Dh]``, project, add, then the MLP sublayer;
    under ``tp`` both ``wo``'s and ``w_down``'s partial products are
    summed by one all-reduce each."""
    B, H, T, Dh = attn.shape
    out = attn.transpose(1, 2).reshape(B, T, H * Dh) @ p["wo"].to(cfg.dtype)
    x = x + all_reduce_(out, mesh, "tp")
    return _mlp_sublayer(x, p, cfg, mesh)


def _embed(params, tokens, cfg: LlamaConfig, mesh: Mesh):
    """Token embeddings, vocab-parallel under ``tp``."""
    return vocab_parallel_embed(params["wte"].to(cfg.dtype), tokens, mesh)


def _logits(params, x, cfg: LlamaConfig, mesh: Mesh = local_mesh()):
    """Final RMSNorm and the LM head: hidden states [..., D] -> f32 logits,
    gathered whole over ``tp``."""
    x = _rms_norm(x, params["final_norm"], cfg.rms_eps)
    return gather_vocab((x @ params["lm_head"].to(cfg.dtype)).float(), mesh)


def _last_logits(params, x, lengths, cfg: LlamaConfig, mesh: Mesh):
    """Logits of the hidden state after token lengths[b]-1 of each row."""
    idx = (lengths - 1).long()[:, None, None].expand(-1, 1, x.shape[-1])
    return _logits(params, torch.gather(x, 1, idx)[:, 0], cfg, mesh)  # [B, vocab]


def prefill(
    params: Params,
    tokens: torch.Tensor,  # [B, T] int, left-aligned, padded with anything
    lengths: torch.Tensor,  # [B] true prompt lengths (<= T)
    cache,
    cfg: LlamaConfig,
    mesh: Mesh = local_mesh(),
):
    """Fill cache[:, :, :, :T] in place; return (cache, last_logits
    [B, vocab] f32). All T rows are written, padding included."""
    B, T = tokens.shape
    if T > cache["k"].shape[3]:
        raise ValueError(f"prefill of {T} rows does not fit a cache of {cache['k'].shape[3]}")
    x = _embed(params, tokens, cfg, mesh)
    cos, sin = rope_tables(cfg, T, tokens.device)
    for i in range(cfg.n_layer):
        p = layer_params(params, i)
        q, k, v = _qkv_rope(x, p, cfg, cos, sin)
        group = q.shape[1] // max(k.shape[1], 1)  # no KV heads: no query heads
        attn = causal_attention(
            q, expand_kv(k, group), expand_kv(v, group), impl=cfg.attn_impl
        )
        x = _attn_out(x, attn, p, cfg, mesh)
        cache["k"][i, :, :, :T] = k
        cache["v"][i, :, :, :T] = v
    return cache, _last_logits(params, x, lengths, cfg, mesh)


def prefill_continue(
    params: Params,
    tokens: torch.Tensor,  # [B, T] int: the tokens AFTER the cached prefix
    lengths: torch.Tensor,  # [B] true new-token counts (<= T)
    start: int,  # cached prefix length: rows [0, start) are already valid
    cache,
    cfg: LlamaConfig,
    mesh: Mesh = local_mesh(),
):
    """Prefill positions [start, start+T) over an existing cache prefix:
    each new token attends over the full cache row under the mask
    ``col <= start + row``, grouped, without expanding the cache. Returns
    (cache, last_logits) like :func:`prefill`."""
    B, T = tokens.shape
    S = cache["k"].shape[3]
    if start < 0 or start + T > S:
        raise ValueError(f"rows [{start}, {start + T}) do not fit a cache of {S}")
    KH, Dh = cache["k"].shape[2], cfg.head_dim  # this rank's KV heads
    dev = tokens.device
    x = _embed(params, tokens, cfg, mesh)
    cos_full, sin_full = rope_tables(cfg, S, dev)
    cos, sin = cos_full[start : start + T], sin_full[start : start + T]

    cols = torch.arange(S, device=dev)
    rows = torch.arange(T, device=dev)
    mask = cols[None, :] <= (start + rows)[:, None]  # [T, S]
    scale = 1.0 / (Dh**0.5)
    for i in range(cfg.n_layer):
        p = layer_params(params, i)
        ck, cv = cache["k"][i], cache["v"][i]  # [B, KH, S, Dh] views
        q, k, v = _qkv_rope(x, p, cfg, cos, sin)
        ck[:, :, start : start + T] = k
        cv[:, :, start : start + T] = v
        H = q.shape[1]
        qg = q.reshape(B, KH, H // max(KH, 1), T, Dh)  # [B, KH, group, T, Dh]
        s = torch.einsum("bkgtd,bksd->bkgts", qg, ck).float() * scale
        s = torch.where(mask, s, -1e30)
        pattn = torch.softmax(s, dim=-1).to(cv.dtype)
        attn = torch.einsum("bkgts,bksd->bkgtd", pattn, cv).reshape(B, H, T, Dh)
        x = _attn_out(x, attn, p, cfg, mesh)
    return cache, _last_logits(params, x, lengths, cfg, mesh)


def decode_step(
    params: Params,
    last_tokens: torch.Tensor,  # [B] int: token generated at positions-1
    positions: torch.Tensor,  # [B] int: where last_tokens goes in the cache
    cache,
    cfg: LlamaConfig,
    mesh: Mesh = local_mesh(),
):
    """One token per slot with the grouped (unexpanded) cache: write k/v at
    ``positions`` in place, attend over the prefix, return (cache, logits
    [B, vocab] f32)."""
    B = last_tokens.shape[0]
    KH, S = cache["k"].shape[2:4]  # this rank's KV heads
    Dh = cfg.head_dim
    dev = last_tokens.device
    positions = positions.long()
    x = _embed(params, last_tokens, cfg, mesh)[:, None, :]  # [B, 1, D]
    cos_full, sin_full = rope_tables(cfg, S, dev)
    cos, sin = cos_full[positions][:, None], sin_full[positions][:, None]  # [B, 1, Dh/2]

    rows = torch.arange(B, device=dev)[:, None]
    kv_heads = torch.arange(KH, device=dev)[None, :]
    pos = positions[:, None]
    mask = torch.arange(S, device=dev)[None, :] <= pos  # [B, S]
    scale = 1.0 / (Dh**0.5)
    for i in range(cfg.n_layer):
        p = layer_params(params, i)
        ck, cv = cache["k"][i], cache["v"][i]  # [B, KH, S, Dh] views
        q, k, v = _qkv_rope(x, p, cfg, cos, sin)  # [B, {H,KH}, 1, Dh]
        ck[rows, kv_heads, pos] = k[:, :, 0, :]
        cv[rows, kv_heads, pos] = v[:, :, 0, :]
        H = q.shape[1]
        qg = q[:, :, 0, :].reshape(B, KH, H // max(KH, 1), Dh)  # [B, KH, group, Dh]
        s = torch.einsum("bkgd,bksd->bkgs", qg, ck).float() * scale
        s = torch.where(mask[:, None, None, :], s, -1e30)
        pattn = torch.softmax(s, dim=-1).to(cv.dtype)
        attn = torch.einsum("bkgs,bksd->bkgd", pattn, cv).reshape(B, H, 1, Dh)
        x = _attn_out(x, attn, p, cfg, mesh)
    return cache, _logits(params, x[:, 0], cfg, mesh)
