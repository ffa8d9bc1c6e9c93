"""GPT-2 autoregressive inference: KV cache, prefill, single-token decode.
Port of ``ray_tpu/models/gpt2_decode.py``.

- The cache is a dict of ``[L, B, H, S_max, Dh]`` tensors (slot-batched:
  row b is one request slot, reused across requests).
- :func:`prefill` runs the prompt through causal attention (the CUDA flash
  kernel on a GPU) and writes k/v for positions ``[0, T)``.
- :func:`prefill_continue` prefills ``[start, start+T)`` on top of a cached
  prefix, attending over the full cache row with a mask.
- :func:`decode_step` embeds one token per slot at its own position,
  scatters its k/v into the cache and attends over the masked prefix.

Unlike the reference, which returns a new cache pytree, these functions
update ``cache`` **in place** (no second 1.2 GB cache at full width) and
return it for the same call shape. Out-of-range writes raise: the
reference's ``dynamic_update_slice`` would clamp the start and shift the
cache silently.

Under a mesh whose ``tp`` axis has size > 1 (the serving engine's; the
reference shards the same einsums through XLA) each rank holds its heads
(``params`` from :func:`ray_tpu_torch.models.convert.tp_shard`): the cache
carries ``n_head / tp`` heads, the embedding is vocab-parallel, the
attention output and the MLP output are each summed by one all-reduce with
``proj_b`` and ``fc2_b`` added once after the sum, and the logits of each
rank's vocabulary shard are gathered whole, so every rank returns the same
logits. Every function takes its head count from the weights or the cache.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ray_tpu_torch.models.common import gather_vocab, vocab_parallel_embed
from ray_tpu_torch.models.gpt2 import GPT2Config, _layer_norm, head_block, layer_params
from ray_tpu_torch.ops.attention import causal_attention
from ray_tpu_torch.parallel.mesh import Mesh, local_mesh
from ray_tpu_torch.parallel.sharding import all_reduce_

Params = dict


def init_kv_cache(
    cfg: GPT2Config,
    n_slots: int,
    max_seq: int | None = None,
    *,
    device: "str | torch.device",
    mesh: Mesh = local_mesh(),
):
    """Zeroed cache: {"k","v"}: [L, B, H, S, Dh] in the activation dtype,
    on ``device`` (no default: the caller names where the cache lives);
    H is this rank's heads under ``mesh`` (:func:`local_heads`)."""
    S = max_seq or cfg.max_seq
    shape = (cfg.n_layer, n_slots, local_heads(cfg, mesh)[1], S, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
    }


def local_heads(cfg: GPT2Config, mesh: Mesh) -> tuple[int, int]:
    """(query heads, KV heads) of one rank under ``mesh``'s ``tp``: both its
    block of heads (:func:`~ray_tpu_torch.models.gpt2.head_block`; uneven
    where ``tp`` does not divide them), as in multi-head attention."""
    lo, hi = head_block(cfg.n_head, mesh.size("tp"), mesh.coordinate("tp"))
    return hi - lo, hi - lo


def _check_dense(cfg: GPT2Config) -> None:
    if cfg.n_experts > 0:
        raise NotImplementedError("decode path is dense-GPT2 only")


def _qkv(x, p, cfg):
    B, T, _ = x.shape
    h = _layer_norm(x, p["ln1_scale"], p["ln1_bias"])
    qkv = h @ p["qkv_w"].to(cfg.dtype) + p["qkv_b"].to(cfg.dtype)
    q, k, v = qkv.unflatten(-1, (3, -1)).unbind(-2)  # this rank's heads' columns

    def heads(t):  # a rank past the head count has none
        return t.reshape(B, T, t.shape[-1] // cfg.head_dim, cfg.head_dim).transpose(1, 2)

    return heads(q), heads(k), heads(v)


def _finish_block(x, attn, p, cfg, mesh: Mesh = local_mesh()):
    """The attention output projection and the MLP. Under ``tp`` each
    product over this rank's rows is a partial sum: one all-reduce each,
    and the row biases added once, after it."""
    B, H, T, Dh = attn.shape
    attn = attn.transpose(1, 2).reshape(B, T, H * Dh)
    x = x + all_reduce_(attn @ p["proj_w"].to(cfg.dtype), mesh, "tp") + p["proj_b"].to(cfg.dtype)
    h = _layer_norm(x, p["ln2_scale"], p["ln2_bias"])
    h = h @ p["fc_w"].to(cfg.dtype) + p["fc_b"].to(cfg.dtype)
    h = F.gelu(h, approximate="tanh")
    return x + all_reduce_(h @ p["fc2_w"].to(cfg.dtype), mesh, "tp") + p["fc2_b"].to(cfg.dtype)


def _embed(params, tokens, cfg, mesh: Mesh):
    """Token embeddings (vocab-parallel under ``tp``), without positions."""
    return vocab_parallel_embed(params["wte"].to(cfg.dtype), tokens, mesh)


def _logits(params, x, cfg, mesh: Mesh = local_mesh()):
    """Final LN and the tied LM head: hidden states [..., D] -> f32 logits,
    gathered whole over ``tp``."""
    x = _layer_norm(x, params["lnf_scale"], params["lnf_bias"])
    return gather_vocab((x @ params["wte"].to(cfg.dtype).T).float(), mesh)


def _last_logits(params, x, lengths, cfg, mesh: Mesh):
    """Logits of the hidden state after token lengths[b]-1 of each row."""
    idx = (lengths - 1).long()[:, None, None].expand(-1, 1, x.shape[-1])
    return _logits(params, torch.gather(x, 1, idx)[:, 0], cfg, mesh)  # [B, vocab]


def prefill(
    params: Params,
    tokens: torch.Tensor,  # [B, T] int, left-aligned, padded with anything
    lengths: torch.Tensor,  # [B] true prompt lengths (<= T)
    cache,
    cfg: GPT2Config,
    mesh: Mesh = local_mesh(),
):
    """Process prompts, fill cache[:, :, :, :T] in place, return
    (cache, last_logits [B, vocab] f32).

    last_logits[b] is the logits after token lengths[b]-1. All T rows are
    written, padding included, as in the reference.
    """
    _check_dense(cfg)
    B, T = tokens.shape
    if T > cache["k"].shape[3]:
        raise ValueError(f"prefill of {T} rows does not fit a cache of {cache['k'].shape[3]}")
    x = _embed(params, tokens, cfg, mesh)
    x = x + params["wpe"].to(cfg.dtype)[:T][None]
    for i in range(cfg.n_layer):
        p = layer_params(params, i)
        q, k, v = _qkv(x, p, cfg)
        attn = causal_attention(q, k, v, impl=cfg.attn_impl)
        x = _finish_block(x, attn, p, cfg, mesh)
        cache["k"][i, :, :, :T] = k
        cache["v"][i, :, :, :T] = v
    return cache, _last_logits(params, x, lengths, cfg, mesh)


def prefill_continue(
    params: Params,
    tokens: torch.Tensor,  # [B, T] int: the tokens AFTER the cached prefix
    lengths: torch.Tensor,  # [B] true new-token counts (<= T)
    start: int,  # cached prefix length: rows [0, start) are already valid
    cache,
    cfg: GPT2Config,
    mesh: Mesh = local_mesh(),
):
    """Prefill positions [start, start+T) on top of an existing cache
    prefix. Each new token attends over the full cache row with the mask
    ``col <= start + row`` (the reference's static-shape trade). Plain
    PyTorch attention: the reference runs no kernel here either.
    Returns (cache, last_logits) like :func:`prefill`.
    """
    _check_dense(cfg)
    B, T = tokens.shape
    S = cache["k"].shape[3]
    if start < 0 or start + T > S:
        raise ValueError(f"rows [{start}, {start + T}) do not fit a cache of {S}")
    dev = tokens.device
    x = _embed(params, tokens, cfg, mesh)
    x = x + params["wpe"].to(cfg.dtype)[start : start + T][None]

    cols = torch.arange(S, device=dev)
    rows = torch.arange(T, device=dev)
    mask = cols[None, :] <= (start + rows)[:, None]  # [T, S]
    scale = 1.0 / (cfg.head_dim**0.5)
    for i in range(cfg.n_layer):
        p = layer_params(params, i)
        ck, cv = cache["k"][i], cache["v"][i]  # [B, H, S, Dh] views
        q, k, v = _qkv(x, p, cfg)
        ck[:, :, start : start + T] = k
        cv[:, :, start : start + T] = v
        s = torch.einsum("bhtd,bhsd->bhts", q, ck).float() * scale
        s = torch.where(mask[None, None], s, -1e30)
        pattn = torch.softmax(s, dim=-1).to(cv.dtype)
        attn = torch.einsum("bhts,bhsd->bhtd", pattn, cv)
        x = _finish_block(x, attn, p, cfg, mesh)
    return cache, _last_logits(params, x, lengths, cfg, mesh)


def decode_step(
    params: Params,
    last_tokens: torch.Tensor,  # [B] int: token generated at positions-1
    positions: torch.Tensor,  # [B] int: where last_tokens goes in the cache
    cache,
    cfg: GPT2Config,
    mesh: Mesh = local_mesh(),
):
    """One token per slot: write kv at ``positions`` (in place), attend
    over the prefix, return (cache, logits [B, vocab] f32)."""
    _check_dense(cfg)
    B = last_tokens.shape[0]
    H, S = cache["k"].shape[2:4]  # this rank's heads
    dev = last_tokens.device
    positions = positions.long()
    x = _embed(params, last_tokens, cfg, mesh)  # [B, D]
    x = x + params["wpe"].to(cfg.dtype)[positions]
    x = x[:, None, :]  # [B, 1, D]

    rows = torch.arange(B, device=dev)[:, None]
    heads = torch.arange(H, device=dev)[None, :]
    pos = positions[:, None]
    # Slot b may attend to cache positions <= positions[b].
    mask = torch.arange(S, device=dev)[None, :] <= pos  # [B, S]
    scale = 1.0 / (cfg.head_dim**0.5)
    for i in range(cfg.n_layer):
        p = layer_params(params, i)
        ck, cv = cache["k"][i], cache["v"][i]  # [B, H, S, Dh] views
        q, k, v = _qkv(x, p, cfg)  # [B, H, 1, Dh]
        ck[rows, heads, pos] = k[:, :, 0, :]
        cv[rows, heads, pos] = v[:, :, 0, :]
        s = torch.einsum("bhd,bhsd->bhs", q[:, :, 0, :], ck).float() * scale
        s = torch.where(mask[:, None, :], s, -1e30)
        pattn = torch.softmax(s, dim=-1).to(cv.dtype)
        attn = torch.einsum("bhs,bhsd->bhd", pattn, cv)[:, :, None, :]
        x = _finish_block(x, attn, p, cfg, mesh)
    return cache, _logits(params, x[:, 0], cfg, mesh)
