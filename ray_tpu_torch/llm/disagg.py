"""Disaggregated serving: the prefill→decode KV handoff over the transfer
fabric. Port of ``ray_tpu/llm/disagg.py``.

A *prefill* engine runs a prompt once, samples the first token and arms the
request's KV, at paged-pool block granularity, for one pull through the
transfer fabric (:mod:`ray_tpu_torch.experimental.transfer`). The *decode*
engine pulls the blocks, scatters them into its own pool and joins the
request to its continuous batch mid-decode: it never prefills the prompt.

Wire contract (the ``handoff`` dict carried between the two engines):

    {"prompt":      [token ids],
     "first_token": int,            # sampled on the prefill engine
     "nblocks":     int,            # KV blocks covering [0, len(prompt))
     "block_size":  int,
     "kv":          arm descriptor  # transfer.fabric().arm() return
     "finished":    bool}           # stop/max_tokens hit at prefill:
                                    # no KV ships, decode short-circuits

The shipped stack is ``[2, L, nb_pad, KH, bs, Dh]`` (k then v; every KV head
of the model), with ``nb_pad`` the block count rounded up to a power of two
and the padding rows taken from scratch block 0.

Failure semantics: the pull is guarded by the seeded ``kvship`` fault site
(``RAY_TPU_FAULTS="…:kvship.sever"``) and by a broad except around the real
transfer: any failure frees the reservation and falls the request back to
local (chunked, where configured) prefill on the decode engine, with the
same greedy tokens.

Armed exports that are never pulled are released after
:data:`EXPORT_TTL_S` by the next export on the same engine, on top of the
fabric's own cap/TTL eviction.

**Tensor parallelism.** The wire contract stays the same: one descriptor
for the whole KV, with all heads, and one pull per handoff, whatever the
degree of either engine. A prefill engine's ranks gather their KV head
blocks over the tp group (blocks may be uneven or empty, so each is padded
to the largest for gloo's ``all_gather``); rank 0 arms the whole stack and
broadcasts the handoff dict, so every rank returns the same one. On a
decode engine rank 0 pulls and broadcasts the verdict and the stack over
the group, and each rank scatters its own KV heads. So engines of any two
degrees hand off to each other.

The gather and the scatter are indexed copies, as the reference's are plain
``jnp`` under ``jax.jit``: no kernel runs here.
"""

from __future__ import annotations

import time as _time

import torch
import torch.distributed as dist

from ray_tpu_torch.core.errors import PeerUnavailableError
from ray_tpu_torch.util import flightrec as _flightrec
from ray_tpu_torch.util import metrics as _metrics

_KV_SHIP_BYTES = _metrics.Counter(
    "raytpu_llm_kv_ship_bytes_total",
    "KV-cache bytes pulled replica-to-replica over the transfer fabric "
    "(disaggregated prefill->decode handoffs)",
)

# Prefill-side retention for armed-but-never-pulled exports: the consumer's
# pull normally lands within one router hop; after this long it certainly
# failed (sever, dead decode engine) and the staged copy is released.
EXPORT_TTL_S = 30.0


def _pad_pow2(n: int) -> int:
    """Block-count padding: the shipped stack's block dim is a power of two,
    as the reference pads it for one compile per power. Padded entries
    index the scratch block (id 0): the bytes shipped are at most twice the
    request's, and the decode-side scatter parks the padding in scratch,
    which is never read."""
    p = 1
    while p < n:
        p *= 2
    return p


def _gather_blocks(pool: dict, idx: torch.Tensor) -> torch.Tensor:
    """``[2, L, nb, KH, bs, Dh]`` copy of the pool rows at ``idx``: the
    shippable view of one request's KV (this rank's KV heads)."""
    return torch.stack([pool["k"][:, idx], pool["v"][:, idx]])


def _scatter_blocks(pool: dict, kv: torch.Tensor, idx: torch.Tensor) -> dict:
    """Write a pulled KV block stack into the pool rows at ``idx``, in
    place (padding rows all land on scratch block 0)."""
    pool["k"][:, idx] = kv[0]
    pool["v"][:, idx] = kv[1]
    return pool


def _rank_kv_heads(cfg, tp: int, rank: int) -> list[int]:
    """The model's KV heads, in pool order, that rank ``rank`` of ``tp``
    keeps (all of them at tp=1)."""
    from ray_tpu_torch.models import gpt2, llama

    if isinstance(cfg, llama.LlamaConfig):
        return llama.kv_heads(cfg, tp, rank)
    lo, hi = gpt2.head_block(cfg.n_head, tp, rank)
    return list(range(lo, hi))


def _n_kv_heads(cfg) -> int:
    return getattr(cfg, "n_kv_head", cfg.n_head)


def _tp(engine) -> int:
    return engine.mesh.size("tp")


def _gather_heads(engine, local: torch.Tensor) -> torch.Tensor:
    """The whole-model stack ``[2, L, nb, KH, bs, Dh]`` from every rank's
    ``local`` stack of its own KV heads: each block padded to the largest
    rank's head count, one ``all_gather_into_tensor`` over the tp group,
    then each KV head taken from the first rank that keeps it."""
    cfg, tp = engine.model_config, _tp(engine)
    heads = [_rank_kv_heads(cfg, tp, r) for r in range(tp)]
    width = max(len(h) for h in heads)
    shape = list(local.shape)
    padded = local.new_zeros(shape[:3] + [width] + shape[4:])
    padded[:, :, :, : shape[3]] = local
    out = local.new_empty(tp * padded.numel())
    dist.all_gather_into_tensor(out, padded.reshape(-1), group=engine.mesh.group("tp"))
    ranks = out.view(tp, *padded.shape)
    src = {}
    for r, hs in enumerate(heads):
        for i, h in enumerate(hs):
            src.setdefault(h, (r, i))
    r_idx = torch.tensor([src[h][0] for h in range(_n_kv_heads(cfg))], device=local.device)
    i_idx = torch.tensor([src[h][1] for h in range(_n_kv_heads(cfg))], device=local.device)
    # ranks[r, :, :, :, i] over (r_idx, i_idx): [KH, 2, L, nb, bs, Dh].
    whole = ranks.permute(0, 4, 1, 2, 3, 5, 6)[r_idx, i_idx]
    return whole.permute(1, 2, 3, 0, 4, 5).contiguous()


def export_kv(engine, req, first_token: int, finished: bool) -> dict:
    """Arm ``req``'s prompt KV for one remote pull and return the handoff
    dict. Called by the engine at the end of a prefill-only request, while
    the request still holds its blocks (the gather copies, so the blocks
    free right after). Under tensor parallelism every rank calls it and
    every rank returns rank 0's handoff."""
    handoff = {
        "prompt": list(req.prompt),
        "first_token": int(first_token),
        "finished": bool(finished),
    }
    if finished:
        return handoff  # stop/max_tokens at prefill: nothing to ship
    from ray_tpu_torch.experimental.transfer import fabric

    bs = engine._block_size
    T = len(req.prompt)
    nb = -(-T // bs)
    ids = list(req.blocks[:nb])
    ids += [0] * (_pad_pow2(nb) - nb)  # pad: scratch rows, ignored remotely
    t_x = _time.monotonic()
    kv = _gather_blocks(engine.pool, torch.tensor(ids, device=engine.device))
    tp = _tp(engine)
    if tp > 1:
        kv = _gather_heads(engine, kv)
    lead = tp == 1 or engine.mesh.coordinate("tp") == 0
    if lead:
        fab = fabric()
        desc = fab.arm(None, kv, (1,) * kv.dim())
        handoff.update({"nblocks": nb, "block_size": bs, "kv": desc})
    if tp > 1:
        box = [handoff]
        dist.broadcast_object_list(box, src=dist.get_global_rank(engine.mesh.group("tp"), 0),
                                   group=engine.mesh.group("tp"))
        handoff = box[0]
    if _flightrec.on():
        # Disagg leg 1 of 2: gather + arm on the prefill engine.
        _flightrec.record(
            "llm", "llm.kv_export", t=t_x, dur_s=_time.monotonic() - t_x,
            rid=req.request_id, nblocks=nb,
        )
    if lead:
        now = _time.monotonic()
        exports = engine._kv_exports
        exports.append((handoff["kv"]["uuid"], now))
        # Release exports past the TTL: their pull can no longer land (the
        # fabric's own cap/TTL eviction is the backstop for idle engines).
        while exports and now - exports[0][1] > EXPORT_TTL_S:
            uid, _t = exports.pop(0)
            fab.release_uuid(uid)
    return handoff


def pull_kv(handoff: dict, request_id: str = "", device=None) -> torch.Tensor:
    """Pull one handoff's KV block stack onto ``device`` (the host where
    None). Raises on a severed transfer (injected through the seeded
    ``kvship`` site, or real): the caller owns the local-prefill fallback."""
    from ray_tpu_torch.core import faults

    inj = faults.active()
    if inj is not None:
        rule = inj.decide("kvship", request_id, actions=frozenset({"sever", "delay"}))
        if rule is not None:
            if rule.action == "sever":
                raise PeerUnavailableError(
                    f"kv handoff severed mid-transfer (injected) for request {request_id!r}"
                )
            if rule.delay_s > 0:
                _time.sleep(min(rule.delay_s, 3600.0))
    from ray_tpu_torch.experimental.transfer import fabric

    t_x = _time.monotonic()
    try:
        kv = fabric().pull(handoff["kv"], device)
    except Exception:
        # Disagg leg 2 of 2, failed pull: the caller's fallback takes
        # over; record the leg so the timeline shows where the fabric
        # broke, then re-raise unchanged.
        _record_pull(t_x, request_id, ok=False)
        raise
    _record_pull(t_x, request_id, ok=True)
    _count_bytes(kv)
    return kv


def _record_pull(t_x: float, request_id: str, ok: bool) -> None:
    if _flightrec.on():
        _flightrec.record(
            "llm", "llm.kv_pull", t=t_x, dur_s=_time.monotonic() - t_x, rid=request_id, ok=ok,
        )


def _count_bytes(kv: torch.Tensor) -> None:
    if _metrics.metrics_enabled():
        _KV_SHIP_BYTES.inc(float(kv.numel() * kv.element_size()))


def pull_local_kv(engine, handoff: dict, request_id: str) -> torch.Tensor:
    """The pulled stack with this rank's KV heads, on the engine's device:
    :func:`pull_kv` itself at tp=1. Under tensor parallelism rank 0 pulls
    and broadcasts the verdict (raising on every rank where the pull
    failed) and the whole stack, and each rank keeps its heads; every rank
    records the ``llm.kv_pull`` leg and counts the bytes, as each counts
    its requests. Under gloo the stack crosses the group on the host (its
    collectives stage CUDA tensors there anyway); under NCCL on the cards."""
    cfg, tp = engine.model_config, _tp(engine)
    if tp == 1:
        return pull_kv(handoff, request_id, engine.device)
    group = engine.mesh.group("tp")
    root = dist.get_global_rank(group, 0)
    via = torch.device("cpu") if dist.get_backend(group) == "gloo" else engine.device
    rank = engine.mesh.coordinate("tp")
    kv, verdict = None, [None]
    t_x = _time.monotonic()
    if rank == 0:
        try:
            kv = pull_kv(handoff, request_id, via)
            verdict = [(tuple(kv.shape), str(kv.dtype).removeprefix("torch."))]
        except Exception as e:  # noqa: BLE001 - every rank takes the fallback together
            verdict = [f"{type(e).__name__}: {e}"]
    dist.broadcast_object_list(verdict, src=root, group=group)
    if isinstance(verdict[0], str):
        if rank != 0:
            _record_pull(t_x, request_id, ok=False)
        raise PeerUnavailableError(f"kv handoff pull failed on rank 0: {verdict[0]}")
    shape, dtype = verdict[0]
    if rank != 0:
        kv = torch.empty(shape, dtype=getattr(torch, dtype), device=via)
    dist.broadcast(kv, src=root, group=group)
    if rank != 0:
        _record_pull(t_x, request_id, ok=True)
        _count_bytes(kv)
    if kv.shape[3] != _n_kv_heads(cfg):
        raise ValueError(f"handoff KV shape {tuple(kv.shape)} does not carry {_n_kv_heads(cfg)} KV heads")
    heads = torch.tensor(_rank_kv_heads(cfg, tp, rank), dtype=torch.long, device=kv.device)
    return kv.index_select(3, heads).to(engine.device)


def all_ranks_ok(engine, ok: bool) -> bool:
    """``ok`` on every rank of the engine's tp group (``ok`` itself at
    tp=1): one all-reduce of a flag, so that a rank whose own part of an
    admission failed takes every rank to the fallback with it."""
    if _tp(engine) == 1:
        return ok
    flag = torch.tensor([0 if ok else 1], device=engine.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=engine.mesh.group("tp"))
    return not flag.item()


def scatter_into_pool(engine, kv: torch.Tensor, block_ids: list) -> dict:
    """Land a pulled block stack in the engine's pool at ``block_ids``, in
    place (padded rows go to scratch block 0: written, never read)."""
    pad = kv.shape[2] - len(block_ids)
    ids = list(block_ids) + [0] * pad
    return _scatter_blocks(engine.pool, kv, torch.tensor(ids, device=engine.device))
