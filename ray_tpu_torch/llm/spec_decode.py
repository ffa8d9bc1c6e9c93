"""Speculative decoding: a draft model proposes, the target verifies. Port
of ``ray_tpu/llm/spec_decode.py``.

A small draft model proposes ``k`` greedy tokens per engine step; the
target scores the carried last token and all ``k`` proposals in one
multi-token forward (:func:`ray_tpu_torch.models.paged.paged_verify`, or
:func:`dense_verify` on the dense cache) and accepts the longest matching
prefix plus one corrected token, so a step yields 1..k+1 tokens for one
target forward. Greedy verification gives the tokens vanilla decode
gives: every accepted token is the argmax the vanilla loop would have
produced in turn.

Under tensor parallelism the draft is not split, as in the reference
(``ray_tpu/llm/spec_decode.py:160-172`` places no sharding on it): every
rank runs the whole draft with its own whole draft KV, and so proposes the
same tokens; the target's verify runs over the rank's heads, its logits
gathered whole, so every rank accepts the same ones.

The draft **shares the engine's block ids**: in paged mode its KV is a
parallel pool indexed by the same block tables, sized by the draft's own
layers and heads (prefix-shared blocks hold the same draft KV whoever
wrote them: the same tokens through the same draft weights). In dense mode
it has its own slot cache.

Engine contract (kept by ``LLMEngine.step``): a spec step runs only when
every active slot is greedy, has draft KV (``spec_ready``) and sits ``k``
rows clear of ``max_seq``; any other step is the vanilla one. Rejected
positions leave stale KV in both caches, which is safe: the next consume
at those positions scatters before it gathers, and unconsumed positions
are masked (``col <= position``).

Telemetry, as the reference's: a spec step observes one inter-token
latency per accepted token (the first pays the step's gap, the rest of the
burst 0.0) into the engine's histogram, and counts drafted and accepted
proposals with a cumulative accept-rate gauge. ``RAY_TPU_SPEC_DECODE=0``
is the kill switch: the engine then builds no ``SpecDecoder`` and every
step is the vanilla one.
"""

from __future__ import annotations

import dataclasses
import pickle
import time as _time

import numpy as np
import torch

from ray_tpu_torch.models import paged
from ray_tpu_torch.util import metrics as _metrics

# Telemetry rides the engine histograms/counters (ITL is observed by the
# engine per accepted token); these series are the speculation-specific
# view: proposal volume, acceptance, and the resulting rate.
_SPEC_DRAFTED = _metrics.Counter(
    "raytpu_llm_spec_drafted_total",
    "draft tokens proposed AND eligible for acceptance (the per-slot k is "
    "budget-clamped: a request one token from max_tokens can accept no "
    "drafts, so its step contributes none — keeping accept_rate a pure "
    "draft-quality signal). Draft-model cost is spec step count x k.",
)
_SPEC_ACCEPTED = _metrics.Counter(
    "raytpu_llm_spec_accepted_total",
    "draft tokens accepted by target verification (rate of this over "
    "drafted = the accept rate)",
)
_SPEC_ACCEPT_RATE = _metrics.Gauge(
    "raytpu_llm_spec_accept_rate",
    "cumulative fraction of drafted tokens the target model accepted",
    tag_keys=("replica",),  # gauge: untagged would last-wins across replicas
)


def dense_verify(
    params,
    tokens: torch.Tensor,  # [B, T] int: token t of row b sits at position positions[b] + t
    positions: torch.Tensor,  # [B] int, on the host: first write position per slot
    cache,
    cfg,
    *,
    hooks: paged.Hooks | None = None,
):
    """The dense twin of :func:`~ray_tpu_torch.models.paged.paged_verify`
    on the slot cache ``{"k","v": [L, B, KH, S, Dh]}``: writes the T
    tokens' K/V in place and returns (cache, logits [B, T, vocab] f32).

    The slot cache is a pool of B blocks of S rows whose slot b has the
    one-entry table ``[b]``, so this is ``paged_verify`` on that table: the
    same products at the same rounding points as the reference's dense
    verify, and the same host-side bound check. ``hooks`` is
    :func:`~ray_tpu_torch.models.paged._family`'s table at ``S``."""
    B = tokens.shape[0]
    S = cache["k"].shape[3]
    tables = torch.arange(B, device=tokens.device)[:, None]
    return paged.paged_verify(
        params, tokens, positions, tables, cache, cfg, block_size=S, hooks=hooks
    )


class SpecDecoder:
    """The draft model and the verify pass of one ``LLMEngine``.

    Owns the draft's weights and KV (a pool parallel to the engine's in
    paged mode, a slot cache in dense mode) and runs the propose, verify
    and accept cycle of one engine step. The engine decides when a spec
    step may run; this class only runs it."""

    def __init__(self, engine, draft_cfg, k: int):
        from ray_tpu_torch.llm.engine import _model_ops

        if k < 1:
            raise ValueError(f"spec_decode_tokens must be >= 1, got {k}")
        target_cfg = engine.model_config
        if draft_cfg is None:
            raise ValueError(
                "spec_decode_tokens > 0 requires draft_model_config "
                "(a small model of the same families as model_config)"
            )
        if draft_cfg.vocab_size != target_cfg.vocab_size:
            raise ValueError(
                f"draft vocab ({draft_cfg.vocab_size}) must equal the target vocab "
                f"({target_cfg.vocab_size}): proposals are target token ids"
            )
        self.engine = engine
        self.k = int(k)
        S = engine.config.max_seq
        # The draft's position table must cover the serving window.
        if draft_cfg.max_seq < S:
            draft_cfg = dataclasses.replace(draft_cfg, max_seq=S)
        self.cfg = draft_cfg
        model, self._decode_mod, from_numpy = _model_ops(draft_cfg)
        dev = engine.device
        if engine.config.draft_weights_path:
            # A pickle of numpy arrays, as LLMConfig.weights_path for the target.
            with open(engine.config.draft_weights_path, "rb") as f:
                params = from_numpy(pickle.load(f), draft_cfg, dev)
        else:
            gen = torch.Generator(device=dev).manual_seed(engine.config.seed)
            params = model.init_params(gen, draft_cfg, dev)
        # Matmul weights cast once to the activation dtype, as the engine's.
        self.params = model.compute_params(params, draft_cfg)
        if engine.paged:
            bs = engine._block_size
            self.pool = paged.init_block_pool(draft_cfg, engine.block_mgr.num_blocks, bs, device=dev)
            self._draft_hooks = paged._family(draft_cfg, S, dev)
            self._verify_hooks = engine._hooks
        else:
            self.cache = self._decode_mod.init_kv_cache(
                draft_cfg, engine.config.max_slots, S, device=dev
            )
            self._verify_hooks = paged._family(target_cfg, S, dev, engine.mesh)

    # -- draft prefill --------------------------------------------------------

    def prefill_draft(self, req) -> bool:
        """Run the draft over ``req``'s whole prompt so its KV covers [0, T):
        once, when the request joins the decode batch (the draft has no
        prefix pool: it prefills shared prefixes again, writing the same
        values). Returns False when no prefill bucket fits inside max_seq;
        the request then never speculates."""
        eng = self.engine
        T = len(req.prompt)
        bucket = next(
            (b for b in eng.config.prefill_buckets if T <= b <= eng.config.max_seq), None
        )
        if bucket is None:
            return False
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :T] = req.prompt
        if eng.paged:
            paged.paged_prefill(
                self.params, eng._h2d(toks), T, 0, eng._h2d(eng.block_tables[req.slot]),
                self.pool, self.cfg, block_size=eng._block_size, hooks=self._draft_hooks,
            )
        else:
            # One slot's rows of the draft cache, written through the views.
            view = {n: t[:, req.slot : req.slot + 1] for n, t in self.cache.items()}
            self._decode_mod.prefill(self.params, eng._h2d(toks), eng._h2d([T]), view, self.cfg)
        return True

    # -- the spec step --------------------------------------------------------

    def step(self, active: list) -> list:
        """One propose, verify and accept cycle for the whole decode batch.
        Moves the engine's cache, positions and last tokens as a run of
        vanilla steps would; returns the requests that finished."""
        from ray_tpu_torch.llm.engine import _ITL_SECONDS, _replica_tags

        eng = self.engine
        k = self.k
        instrument = _metrics.metrics_enabled()
        last = eng._h2d(eng.last_tokens)
        pos = eng._h2d(eng.positions)
        tables = eng._h2d(eng.block_tables) if eng.paged else None
        # 1) The draft proposes k tokens. The chain stays on the device (each
        # argmax feeds the next draft decode); only the [B, k+1] tokens and
        # the verify argmax come back, once.
        proposals = []
        dlast, dpos = last, pos
        for _ in range(k):
            if eng.paged:
                _, dlogits = paged.paged_decode(
                    self.params, dlast, dpos, tables, self.pool, self.cfg,
                    block_size=eng._block_size, hooks=self._draft_hooks,
                )
            else:
                _, dlogits = self._decode_mod.decode_step(
                    self.params, dlast, dpos, self.cache, self.cfg
                )
            dlast = dlogits.argmax(dim=-1)
            proposals.append(dlast)
            dpos = dpos + 1
        tokens = torch.stack([last, *proposals], dim=1)  # [B, k+1]
        # 2) The target verifies all k+1 tokens in one forward. Positions go
        # on the host, where the verify checks its rows against the table
        # (pinned on the card, so their copy to it waits for nothing).
        host_pos = torch.from_numpy(eng.positions.astype(np.int64))
        if eng.device.type == "cuda":
            host_pos = host_pos.pin_memory()
        if eng.paged:
            _, logits = paged.paged_verify(
                eng._cparams, tokens, host_pos, tables, eng.pool, eng.model_config,
                block_size=eng._block_size, hooks=self._verify_hooks,
            )
        else:
            _, logits = dense_verify(
                eng._cparams, tokens, host_pos, eng.cache, eng.model_config,
                hooks=self._verify_hooks,
            )
        both = eng._d2h(torch.cat([tokens[:, 1:], logits.argmax(dim=-1)], dim=1))  # the one readback
        prop, greedy = both[:, :k], both[:, k:]
        # 3) Acceptance per active slot, on the host: the longest matching
        # draft prefix plus the corrected token, clamped to the request's
        # remaining budget; a stop token ends the burst.
        now = _time.perf_counter()
        finished = []
        drafted = accepted = 0
        for req in active:
            b = req.slot
            d = 0
            while d < k and prop[b, d] == greedy[b, d]:
                d += 1
            remaining = req.max_tokens - len(req.generated)
            applied = 0
            for i in range(min(d + 1, remaining)):
                tok = int(greedy[b, i])
                req.generated.append(tok)
                applied += 1
                if instrument and (req.t_last_token or i):
                    # Burst semantics: the first token pays the step gap,
                    # the rest land with it (that IS the client-visible
                    # inter-token latency of an accepted burst).
                    _ITL_SECONDS.observe((now - req.t_last_token) if i == 0 else 0.0)
                if tok == req.stop_token or len(req.generated) >= req.max_tokens:
                    break
            req.t_last_token = now
            eng.stats["tokens_generated"] += applied
            # The accept rate counts only drafts the budget could accept (a
            # perfect draft scores 1.0 wherever max_tokens falls).
            drafted += min(k, max(0, remaining - 1))
            accepted += max(0, applied - 1)
            eng.positions[b] += applied
            eng.last_tokens[b] = req.generated[-1]
            eng._maybe_finish(req)
            if req.finished:
                finished.append(req)
        eng.stats["spec_steps"] += 1
        eng.stats["spec_drafted"] += drafted
        eng.stats["spec_accepted"] += accepted
        if instrument:
            _SPEC_DRAFTED.inc(float(drafted))
            if accepted:
                _SPEC_ACCEPTED.inc(float(accepted))
            total = eng.stats["spec_drafted"]
            if total:
                _SPEC_ACCEPT_RATE.set(eng.stats["spec_accepted"] / total, _replica_tags())
        return finished

    def accept_rate(self) -> float:
        total = self.engine.stats["spec_drafted"]
        return (self.engine.stats["spec_accepted"] / total) if total else 0.0
