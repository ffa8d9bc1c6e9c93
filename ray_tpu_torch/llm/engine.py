"""LLMEngine: slot-based continuous batching over the PyTorch decode paths.
Port of ``ray_tpu/llm/engine.py`` (its paged and dense caches, both model
families).

- **Paged KV cache** (``kv_block_size > 0``, the default, as in the
  reference): requests hold block tables over one shared pool
  (:mod:`ray_tpu_torch.models.paged`), with host-side refcounts
  (:class:`~ray_tpu_torch.llm.block_manager.BlockManager`). Admission
  reserves the blocks a request can ever need, pooled prefixes are shared
  by reference with no copy, and the pool gives way to an admission under
  pressure. Paged prefill and decode are plain torch products, as the
  reference's are plain ``jnp``: no kernel runs on this path.
- **Dense per-slot cache** (``kv_block_size=0``): ``[L, max_slots, KH,
  max_seq, Dh]`` k and v tensors, updated in place. A fresh prompt
  prefills through the family's ``prefill``, whose causal attention is the
  hand-written CUDA flash kernel on an H100.
- **Both families**, GPT-2 and Llama, picked at one dispatch point
  (:func:`_model_ops`); the rest of the engine is family-agnostic.
- **Continuous batching**: a request holds a slot from admission until
  EOS/max_tokens; new requests prefill into freed slots between decode
  steps. The decode batch is always ``[max_slots]``: idle slots decode
  garbage that is never read (paged: into the scratch block), as in the
  reference.
- **Prefix caching** and **chunked prefill** behave as the reference's do,
  with the same bucket guards: every padded write is checked to fit inside
  ``max_seq`` before it is issued.
- **Speculative decoding** (``spec_decode_tokens > 0`` with a
  ``draft_model_config``): a step in which every active slot is greedy,
  has draft KV and sits ``k`` rows clear of ``max_seq`` runs the draft's
  ``k`` proposals and the target's one verify pass
  (:class:`~ray_tpu_torch.llm.spec_decode.SpecDecoder`); any other step is
  the vanilla one, with the same greedy tokens.
- **Disaggregated prefill→decode** (the paged cache on the prefill side):
  ``add_request(..., prefill_only=True)`` finishes a request at its first
  sampled token with its prompt KV armed on the transfer fabric, carried
  out as the finished request's ``handoff_out``;
  ``add_handoff_request(rid, handoff)`` on another engine pulls that KV
  into its own pool at admission and joins the request to the decode batch
  with no prefill (:mod:`ray_tpu_torch.llm.disagg`). A failed pull falls
  back to local (chunked) prefill, counted in ``kv_fallbacks``; a dense
  decode engine re-prefills the prompt. Either way the greedy tokens are
  the same.

- **Telemetry**, recorded where the reference records it: the serving
  series (TTFT and inter-token-latency histograms, request, prompt-token,
  generated-token and prefill-chunk counters, KV-utilization and
  prefix-hit-rate gauges) in the process registry
  (:mod:`ray_tpu_torch.util.metrics`), and the flight-recorder phases
  ``llm.prefill``, ``llm.prefill_chunk``, ``llm.first_token`` and
  ``llm.decode_step`` (and a handoff's ``llm.kv_export`` and
  ``llm.kv_pull``) in the ``llm`` ring
  (:mod:`ray_tpu_torch.util.flightrec`). Every timestamp is a host clock
  read where the host already is: a prefill phase's duration is the
  host's dispatch time, and TTFT and ITL stamps follow the readback that
  the step takes anyway, so telemetry adds no device sync.
  ``RAY_TPU_METRICS_ENABLED=0`` and ``RAY_TPU_FLIGHTREC=0`` turn the two
  off; ``RAY_TPU_SPEC_DECODE=0`` builds no draft model
  (:mod:`ray_tpu_torch.core.config`).

Host state (positions, last tokens, slot table, block tables) lives in
numpy. Each step reads the device back once, for the decode logits (a
spec step: for the proposals and the verify argmax); admission reads back
the last-logits of a prompt to sample its first token, as the reference
does.

**Tensor parallelism** (``tensor_parallelism = tp > 1``, as the
reference's ``ray_tpu/llm/engine.py:188-218``) makes the engine one rank of
an SPMD group: every rank builds it with the same config and makes the
same calls in the same order (``add_request``, ``step``, ``generate``),
each in its own process, under a process group the caller has started
(``torch.distributed.init_process_group`` with ``tp`` ranks; NCCL with a
card for each rank, or gloo, with which ranks may share one card). Each
rank holds its query heads and the KV heads they read (in its own dense
cache or block pool), its columns of the MLP's up projection and its rows
of the down and output projections, and its shard of the vocabulary
(:func:`ray_tpu_torch.models.convert.tp_shard`); each layer sums the
attention output and the MLP output with one all-reduce each, and the
logits are gathered whole before the readback. The host loop
(scheduling, the prefix pool, the block manager, sampling) runs on every
rank on the same logits, so every rank makes the same decisions with no
further sync and returns the same tokens. On the card rank ``r`` uses
``cuda:r`` where the machine has a card for every rank, else card 0.
With ``tp > 1`` and no started process group, or one of another size, the
engine raises; it never serves as one rank. The draft model of
speculative decoding is not split, as in the reference: every rank runs
all of it. A front end that takes requests on one rank and drives the
others belongs to the serve layer and is not here. A handoff's KV crosses
between engines of any two degrees (see :mod:`ray_tpu_torch.llm.disagg`).
"""

from __future__ import annotations

import dataclasses
import pickle
import sys
import time as _time
from collections import deque
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.llm.block_manager import BlockManager
from ray_tpu_torch.llm.config import LLMConfig, SamplingParams
from ray_tpu_torch.llm.spec_decode import SpecDecoder
from ray_tpu_torch.llm.tokenizer import ByteTokenizer
from ray_tpu_torch.models import convert, gpt2, gpt2_decode, llama, llama_decode, paged
from ray_tpu_torch.parallel.mesh import Mesh, MeshSpec, local_mesh, make_mesh
from ray_tpu_torch.util import flightrec as _flightrec
from ray_tpu_torch.util import metrics as _metrics
from ray_tpu_torch.util.device import resolve_device, set_exact_matmul
from ray_tpu_torch.util.prefix_digest import BYTE_BOS_SCHEME, chain_digests

# Serving SLO series (recorded per step, not per frame: a decode step is
# milliseconds-scale, so registry locking is negligible here). TTFT =
# admission to first sampled token; ITL = gap between a request's
# consecutive tokens. Tokens-per-second is the rate of the counters.
_TTFT_SECONDS = _metrics.Histogram(
    "raytpu_llm_ttft_seconds",
    "time to first token (request admission to first sample)",
    boundaries=_metrics.LATENCY_BOUNDARIES_S,
)
_ITL_SECONDS = _metrics.Histogram(
    "raytpu_llm_itl_seconds",
    "inter-token latency (gap between consecutive generated tokens)",
    boundaries=_metrics.LATENCY_BOUNDARIES_S,
)
_PROMPT_TOKENS = _metrics.Counter(
    "raytpu_llm_prompt_tokens_total",
    "prompt tokens admitted (prefix-cache reuse included)",
)
_GEN_TOKENS = _metrics.Counter(
    "raytpu_llm_generated_tokens_total",
    "tokens sampled by the decode loop",
)
_PREFILL_CHUNKS = _metrics.Counter(
    "raytpu_llm_prefill_chunks_total",
    "prefill chunks executed on the chunked-prefill path "
    "(prefill_chunk_tokens > 0; one long prompt = several chunks "
    "interleaved with decode steps)",
)
_REQUESTS = _metrics.Counter(
    "raytpu_llm_requests_total", "requests admitted to the engine"
)
# Gauges carry a replica tag: merge is last-wins per (name, tags), so an
# untagged gauge from N engine replicas would show one arbitrary
# replica's value. Histograms/counters sum correctly and stay untagged.
_KV_UTIL = _metrics.Gauge(
    "raytpu_llm_kv_utilization",
    "fraction of KV blocks in use (paged mode)",
    tag_keys=("replica",),
)
_PREFIX_HIT_RATE = _metrics.Gauge(
    "raytpu_llm_prefix_hit_rate",
    "fraction of prefix-pool lookups that reused cached KV",
    tag_keys=("replica",),
)

_replica_tags_cache: Optional[dict] = None


def _replica_tags() -> dict:
    """Engine-identity gauge tags: the hosting actor's truncated id
    (bounded by live replicas; series vanish with the process's
    snapshot), or "local" outside an actor (tests, batch inference). Reads
    the process's attached worker, if any: the probe never starts a
    runtime."""
    global _replica_tags_cache
    if _replica_tags_cache is None:
        api = sys.modules.get("ray_tpu_torch.core.api")
        rid = getattr(getattr(api, "_worker", None), "_actor_id", None) or ""
        _replica_tags_cache = {"replica": rid[:12] or "local"}
    return _replica_tags_cache


def _validate_block_multiple(name: str, value: int, block_size: int) -> None:
    """Config check for every token-granularity knob that must align with
    the paged-KV block size (pooled prefixes are shared, and prefill chunks
    written, at block granularity)."""
    if value % block_size:
        raise ValueError(
            f"{name} ({value}) must be a multiple of kv_block_size "
            f"({block_size}): pooled prefixes are shared and prefill "
            f"chunks written at block granularity"
        )


def _model_ops(cfg):
    """(model module, decode module, converter from numpy) for a model
    config's family: the one dispatch point. Everything else in the engine
    is family-agnostic (the cache layouts agree: [L, B, heads, S, Dh])."""
    if isinstance(cfg, llama.LlamaConfig):
        return llama, llama_decode, convert.llama_params_from_numpy
    return gpt2, gpt2_decode, convert.gpt2_params_from_numpy


def _tp_mesh(tp: int, device: torch.device) -> tuple[torch.device, Mesh]:
    """(this rank's device, the ``MeshSpec(tp=tp)`` mesh over the caller's
    process group); the given device and the one-rank mesh at ``tp=1``.
    On the card, an unindexed ``"cuda"`` becomes ``cuda:rank`` where the
    machine has ``tp`` cards, else card 0 (ranks over gloo sharing it)."""
    if tp == 1:
        return device, local_mesh()
    if not dist.is_initialized():
        raise RuntimeError(
            f"tensor_parallelism={tp} needs a started process group of {tp} ranks "
            "(torch.distributed.init_process_group), one process per rank"
        )
    if dist.get_world_size() != tp:
        raise ValueError(
            f"tensor_parallelism={tp} but the process group has {dist.get_world_size()} ranks"
        )
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        if dist.get_backend() == "nccl" and cards < tp:
            raise ValueError(
                f"NCCL needs a card for each of the {tp} ranks, and this machine has {cards}: "
                "start a gloo process group to share a card"
            )
        if device.index is None:
            device = torch.device("cuda", dist.get_rank() if cards >= tp else 0)
        torch.cuda.set_device(device)
    return device, make_mesh(MeshSpec(tp=tp), device.type)


@dataclasses.dataclass
class _Request:
    request_id: str
    prompt: list
    max_tokens: int
    temperature: float
    stop_token: Optional[int]
    generated: list = dataclasses.field(default_factory=list)
    slot: int = -1
    finished: bool = False
    blocks: list = dataclasses.field(default_factory=list)  # paged mode
    # Chunked prefill: the request holds a slot but is still prefilling
    # its prompt one chunk per step; pf_next is the next absolute prompt
    # position to prefill. No token samples until pf_next reaches the
    # prompt length.
    prefilling: bool = False
    pf_next: int = 0
    # Admission failure surfaced through pop_finished (a reservation no
    # pool state can satisfy fails the request, not the engine loop).
    error: Optional[str] = None
    # Disaggregated serving: prefill_only requests finish at their first
    # sampled token and carry the exported KV descriptor out through
    # ``handoff_out``; handoff-admitted requests carry the inbound
    # descriptor in ``handoff`` until admission pulls (or falls back).
    prefill_only: bool = False
    handoff: Optional[dict] = None
    handoff_out: Optional[dict] = None
    # Speculative decoding: the draft model prefilled this request's
    # prompt, so the slot may join spec steps.
    spec_ready: bool = False
    # Telemetry anchors: admission wall-clock and the previous token's
    # timestamp (TTFT / inter-token latency).
    t_admit: float = 0.0
    t_last_token: float = 0.0


class LLMEngine:
    def __init__(
        self,
        config: LLMConfig,
        tokenizer=None,
        *,
        device: "str | torch.device" = "cuda",
    ):
        """``device`` is the card unless the caller asks for ``"cpu"``; a
        CUDA request with no GPU raises. With ``tensor_parallelism > 1``
        the caller's process group must have that many ranks (see the
        module docstring); a config whose heads, vocabulary or MLP width
        the degree does not split raises ``ValueError``."""
        device = resolve_device(device)
        set_exact_matmul()
        self.config = config
        self.tokenizer = tokenizer or ByteTokenizer()
        cfg = config.build_model_config()
        self.device, self.mesh = _tp_mesh(config.tensor_parallelism, device)
        if cfg.vocab_size < self.tokenizer.vocab_size:
            raise ValueError("model vocab smaller than tokenizer vocab")
        self._model, self._decode_mod, from_numpy = _model_ops(cfg)
        if self._model is gpt2 and config.max_seq > cfg.max_seq:
            # Positions past GPT-2's learned table would index wpe out of
            # range (the reference clamps them silently). Llama has no
            # table: its RoPE tables are computed for the cache length.
            raise ValueError(
                f"max_seq ({config.max_seq}) exceeds the model's position "
                f"table ({cfg.max_seq})"
            )
        self.model_config = cfg

        # Each rank keeps its part of every leaf (all of it at tp=1). Random
        # weights are drawn whole on the engine's device, as at tp=1, so a
        # seed gives the same model at every degree.
        if config.weights_path:
            with open(config.weights_path, "rb") as f:
                params = from_numpy(pickle.load(f), cfg, self.device, mesh=self.mesh)
        else:
            gen = torch.Generator(device=self.device).manual_seed(config.seed)
            whole = self._model.init_params(gen, cfg, self.device)
            params = convert.tp_shard(whole, cfg, self.mesh)
            del whole
        self.params = params
        # Matmul weights cast once to the activation dtype (the reference
        # casts per matmul; the values are identical).
        self._cparams = self._model.compute_params(params, cfg)

        B, S = config.max_slots, config.max_seq
        self.paged = config.kv_block_size > 0
        if self.paged:
            bs = config.kv_block_size
            if S % bs:
                raise ValueError("max_seq must be a multiple of kv_block_size")
            if config.enable_prefix_caching:
                _validate_block_multiple("prefix_chunk", config.prefix_chunk, bs)
            if config.prefill_chunk_tokens:
                _validate_block_multiple("prefill_chunk_tokens", config.prefill_chunk_tokens, bs)
            self._block_size = bs
            self._table_width = S // bs
            n = config.num_kv_blocks or max(
                (B * self._table_width) // 2, self._table_width + 1
            ) + 1  # +1: block 0 is scratch
            self.block_mgr = BlockManager(n)
            self.pool = paged.init_block_pool(cfg, n, bs, device=self.device, mesh=self.mesh)
            self.block_tables = np.zeros((B, self._table_width), np.int32)
            # The family's hook table (and Llama's RoPE tables), built once.
            self._hooks = paged._family(cfg, S, self.device, self.mesh)
        else:
            self.cache = self._decode_mod.init_kv_cache(
                cfg, B, S, device=self.device, mesh=self.mesh
            )
        # Prefix pool: key (chunk-aligned token tuple hash, length) ->
        # {"len", "used", "tokens"} and, dense, {"k","v": [L, 1, KH, P, Dh]
        # tensors}; paged, {"blocks": the shared block ids}. LRU within
        # max_prefix_cache_tokens.
        self._prefix_pool: dict = {}
        self._prefix_tokens_cached = 0
        self._prefix_clock = 0
        # Routing advertisement, rebuilt on pool mutation and swapped in
        # whole (a reader on another thread sees one snapshot or the next).
        self._digest_snapshot: tuple = ()
        self._digest_version = 0
        self.stats = {
            "prefill_tokens": 0,  # tokens that PAID prefill compute
            "prefill_chunks": 0,  # chunked-prefill pieces executed
            "prefix_hits": 0,
            "prefix_lookups": 0,
            "prefix_tokens_reused": 0,
            "tokens_generated": 0,
            # Speculative decoding (llm/spec_decode.py):
            "spec_steps": 0,
            "spec_drafted": 0,
            "spec_accepted": 0,
            # Disaggregated serving (llm/disagg.py):
            "handoffs_out": 0,  # prefill-only requests exported
            "handoffs_in": 0,  # handoff admissions that pulled KV
            "kv_fallbacks": 0,  # pulls that failed -> local prefill
        }
        # Armed KV exports (uuid, monotonic) not yet past EXPORT_TTL_S.
        self._kv_exports: list = []
        # Host-side slot state (numpy: mutated per step)
        self.positions = np.zeros(B, np.int32)  # next write position
        self.last_tokens = np.zeros(B, np.int32)
        self.slot_free = [True] * B
        self.requests: dict[str, _Request] = {}
        self._slot_req: list = [None] * B
        self._rng = np.random.default_rng(config.seed)
        self._pf_rr = 0  # round-robin cursor over prefilling slots
        self._steps = 0
        self._published_tokens = 0  # tokens already inc'd into the counter
        # Rolling TTFT window of (monotonic, seconds) pairs: a routing and
        # overload signal; samples expire by age as well as by count.
        self._ttft_window: deque = deque(maxlen=64)
        self.TTFT_WINDOW_S = 30.0
        # Speculative decoding: built only when the config asks for it and
        # the kill switch is not thrown.
        self._spec = None
        if config.spec_decode_tokens > 0 and GLOBAL_CONFIG.spec_decode:
            self._spec = SpecDecoder(self, config.draft_model_config, config.spec_decode_tokens)

    # -- device helpers --------------------------------------------------------
    def _h2d(self, arr) -> torch.Tensor:
        """A host array on the engine's device. On the card the copy is
        staged through pinned memory and issued without a host sync, so a
        step's only device-to-host wait is its logits readback."""
        t = torch.from_numpy(np.array(arr, dtype=np.int64))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    @staticmethod
    def _d2h(logits: torch.Tensor) -> np.ndarray:
        return logits.cpu().numpy()

    # -- per-slot bodies (in-place cache update) -------------------------------
    def _slot_view(self, slot: int) -> dict:
        """Slot ``slot``'s cache rows as ``[L, 1, KH, S, Dh]`` views: the
        model functions write through them into the engine's cache."""
        return {n: t[:, slot : slot + 1] for n, t in self.cache.items()}

    def _prefill_impl(self, tokens: np.ndarray, length: int, slot: int):
        """Prefill ONE slot: tokens [1, T]; returns last-logits [vocab]."""
        _, logits = self._decode_mod.prefill(
            self._cparams,
            self._h2d(tokens),
            self._h2d([length]),
            self._slot_view(slot),
            self.model_config,
            self.mesh,
        )
        return logits[0]

    def _prefill_cont_impl(self, tokens: np.ndarray, length: int, start: int, slot: int):
        """Prefill ONE slot's suffix on top of a cached prefix already in
        that slot's rows [0, start). The caller's bucket choice keeps
        ``start + T <= max_seq``; the model function raises otherwise."""
        _, logits = self._decode_mod.prefill_continue(
            self._cparams,
            self._h2d(tokens),
            self._h2d([length]),
            start,
            self._slot_view(slot),
            self.model_config,
            self.mesh,
        )
        return logits[0]

    def _pg_prefill_impl(self, tokens: np.ndarray, length: int, start: int, row: np.ndarray):
        """Paged prefill of positions [start, start+T) through the block
        table ``row``, in place; returns last-logits [vocab]."""
        _, logits = paged.paged_prefill(
            self._cparams,
            self._h2d(tokens),
            length,
            start,
            self._h2d(row),
            self.pool,
            self.model_config,
            block_size=self._block_size,
            hooks=self._hooks,
        )
        return logits

    def _copy_prefix_in_impl(self, pk, pv, slot: int) -> None:
        """Write a pooled prefix ([L, 1, KH, P, Dh], this rank's KV heads)
        into a slot's rows [0, P), in place."""
        P = pk.shape[3]
        self.cache["k"][:, slot : slot + 1, :, :P] = pk
        self.cache["v"][:, slot : slot + 1, :, :P] = pv

    def _copy_prefix_out_impl(self, slot: int, length: int):
        """A copy of a slot's rows [0, length) as a pool entry."""
        view = self._slot_view(slot)
        return view["k"][:, :, :, :length].clone(), view["v"][:, :, :, :length].clone()

    # -- admission -----------------------------------------------------------
    def add_request(
        self,
        request_id: str,
        prompt: "str | list",
        sampling: SamplingParams | None = None,
        prefill_only: bool = False,
    ) -> None:
        """Admit a request (prompt text or token ids). ``prefill_only``
        (disaggregated serving's prefill leg; paged cache only) finishes
        the request at its first sampled token with the prompt KV exported
        as ``handoff_out`` instead of joining the decode batch."""
        if prefill_only and not self.paged:
            raise ValueError(
                "prefill_only requests need the paged KV cache "
                "(kv_block_size > 0): handoffs ship pool blocks"
            )
        sampling = sampling or SamplingParams()
        ids = self.tokenizer.encode(prompt) if isinstance(prompt, str) else list(prompt)
        max_prompt = max(self.config.prefill_buckets)
        if len(ids) > max_prompt:
            ids = ids[-max_prompt:]
        stop = sampling.stop_token if sampling.stop_token is not None else self.tokenizer.eos_id
        self.requests[request_id] = _Request(
            request_id=request_id,
            prompt=ids,
            max_tokens=sampling.max_tokens,
            temperature=sampling.temperature,
            stop_token=stop,
            prefill_only=prefill_only,
            t_admit=_time.perf_counter(),
        )
        if _metrics.metrics_enabled():
            _REQUESTS.inc(1.0)
            _PROMPT_TOKENS.inc(float(len(ids)))

    def add_handoff_request(
        self,
        request_id: str,
        handoff: dict,
        sampling: SamplingParams | None = None,
    ) -> None:
        """Admit a disaggregated request from a prefill engine's handoff:
        the prompt KV arrives over the transfer fabric at admission and the
        request joins the decode batch with its first token already
        sampled; this engine never prefills the prompt, unless the pull
        fails and admission falls back to local (chunked, where
        configured) prefill. A dense engine cannot land shipped blocks and
        re-prefills. Counts neither requests nor prompt tokens: the prefill
        engine did."""
        sampling = sampling or SamplingParams()
        stop = sampling.stop_token if sampling.stop_token is not None else self.tokenizer.eos_id
        req = _Request(
            request_id=request_id,
            prompt=list(handoff.get("prompt") or []),
            max_tokens=sampling.max_tokens,
            temperature=sampling.temperature,
            stop_token=stop,
            handoff=dict(handoff),
            t_admit=_time.perf_counter(),
        )
        if not self.paged:
            req.handoff = None  # degrade to a plain re-prefill admission
        self.requests[request_id] = req

    # -- prefix pool ---------------------------------------------------------
    def _aligned_prefix_len(self, prompt_len: int) -> int:
        """Longest chunk-aligned STRICT prefix (>= 1 token must remain to
        prefill, or there are no last-logits to sample from)."""
        chunk = self.config.prefix_chunk
        return ((prompt_len - 1) // chunk) * chunk

    def _chain_hashes(self, prompt: list) -> dict:
        """Rolling per-chunk hash chain: H_p = hash((H_{p-c}, chunk))."""
        chunk = self.config.prefix_chunk
        chain: dict[int, int] = {}
        h = 0
        for p in range(chunk, self._aligned_prefix_len(len(prompt)) + 1, chunk):
            h = hash((h, tuple(prompt[p - chunk : p])))
            chain[p] = h
        return chain

    def _find_prefix(self, prompt: list):
        """Longest pooled prefix of ``prompt`` (verified against the stored
        tokens, so a hash collision never serves another prompt's KV)."""
        if not self.config.enable_prefix_caching:
            return None
        self.stats["prefix_lookups"] += 1
        chain = self._chain_hashes(prompt)
        for p in sorted(chain, reverse=True):
            entry = self._prefix_pool.get((chain[p], p))
            if entry is not None and entry["tokens"] == tuple(prompt[:p]):
                self._prefix_clock += 1
                entry["used"] = self._prefix_clock
                return entry
        return None

    def _insert_prefix(self, prompt: list, slot: int, blocks=None) -> None:
        """Pool the prompt's longest aligned prefix. Dense mode copies the
        slot's rows out; paged mode takes a reference on the request's
        first P/block blocks (``blocks``): sharing, not copying."""
        if not self.config.enable_prefix_caching:
            return
        p = self._aligned_prefix_len(len(prompt))
        if p < self.config.prefix_chunk or p > self.config.max_prefix_cache_tokens:
            return
        chain = self._chain_hashes(prompt)
        key = (chain[p], p)
        self._prefix_clock += 1
        existing = self._prefix_pool.get(key)
        if existing is not None and existing["tokens"] == tuple(prompt[:p]):
            existing["used"] = self._prefix_clock
            return
        while (
            self._prefix_pool
            and self._prefix_tokens_cached + p > self.config.max_prefix_cache_tokens
        ):
            self._evict_one_prefix()
        entry = {"len": p, "used": self._prefix_clock, "tokens": tuple(prompt[:p])}
        if self.paged:
            shared = list(blocks[: p // self._block_size])
            self.block_mgr.incref(shared)
            entry["blocks"] = shared
        else:
            entry["k"], entry["v"] = self._copy_prefix_out_impl(slot, p)
        self._prefix_pool[key] = entry
        self._prefix_tokens_cached += p
        self._refresh_digest_snapshot()

    def _evict_one_prefix(self, keep=None) -> bool:
        """Drop the LRU prefix-pool entry (skipping ``keep``), returning its
        tokens to the budget and its block references to the pool. The
        caller refreshes the digest snapshot, once per eviction wave."""
        victims = [k for k, e in self._prefix_pool.items() if e is not keep]
        if not victims:
            return False
        victim = min(victims, key=lambda k: self._prefix_pool[k]["used"])
        evicted = self._prefix_pool.pop(victim)
        self._prefix_tokens_cached -= evicted["len"]
        if "blocks" in evicted:
            self.block_mgr.decref(evicted["blocks"])
        return True

    def _evict_prefixes_until(self, need: int, keep=None) -> None:
        """LRU-evict prefix-pool entries until ``need`` blocks are
        allocatable or nothing evictable remains. Entries whose blocks are
        still shared by running requests free nothing when dropped; the
        loop goes on past them."""
        evicted = False
        while not self.block_mgr.can_alloc(need):
            if not self._evict_one_prefix(keep=keep):
                break
            evicted = True
        if evicted:
            self._refresh_digest_snapshot()

    def _admit_waiting(self) -> list:
        """Admit waiting requests into free slots; returns requests that
        finished during admission (max_tokens=1, a stop token at prefill,
        or an error).

        FIFO: the first request that cannot be admitted (no slot, or, paged,
        not enough free KV blocks) stops the wave, so a big request is not
        starved by small ones slipping past it."""
        admit_finished: list = []
        waiting = [r for r in self.requests.values() if r.slot < 0 and not r.finished]
        for req in waiting:
            try:
                slot = self.slot_free.index(True)
            except ValueError:
                return admit_finished
            if req.handoff is not None:
                verdict = self._admit_handoff(req, slot)
                if verdict == "wait":
                    return admit_finished
                if verdict == "done":
                    if req.finished:
                        admit_finished.append(req)
                    continue
                # "fallback": the pull failed and the handoff is cleared;
                # the local admission below (chunked prefill included)
                # takes over, with the same greedy tokens.
            if self.paged:
                logits = self._admit_paged(req, slot)
            else:
                logits = self._admit_dense(req, slot)
            if req.finished:
                # A reservation no pool state can satisfy finished with an
                # error; the wave goes on for the admittable ones.
                admit_finished.append(req)
                continue
            if req.prefilling:
                # Chunked prefill took the slot but defers its first
                # sample to _advance_prefills; keep admitting.
                continue
            if logits is None:
                return admit_finished  # the pool is short right now
            T = len(req.prompt)
            tok = self._sample(self._d2h(logits), req)
            req.slot = slot
            self.slot_free[slot] = False
            self._slot_req[slot] = req
            if req.prefill_only:
                # Disaggregated prefill leg: export the prompt KV and
                # finish here; the decode engine takes it from the handoff.
                self._finish_prefill_only(req, tok)
                admit_finished.append(req)
                continue
            self._first_token(req, tok)
            self.positions[slot] = T
            self.last_tokens[slot] = tok
            if self._spec is not None:
                req.spec_ready = self._spec.prefill_draft(req)
            self._maybe_finish(req)
            if req.finished:
                admit_finished.append(req)
        return admit_finished

    def _first_token(self, req: _Request, tok: int) -> None:
        """Record a request's first sampled token (taken after the logits
        readback): the TTFT window, histogram and flight-recorder phase."""
        req.generated.append(tok)
        self.stats["tokens_generated"] += 1
        req.t_last_token = _time.perf_counter()
        self._ttft_window.append((_time.monotonic(), req.t_last_token - req.t_admit))
        if _metrics.metrics_enabled():
            _TTFT_SECONDS.observe(req.t_last_token - req.t_admit)
        self._rec_first_token(req)

    @staticmethod
    def _rec_first_token(req: _Request) -> None:
        """Flight-recorder TTFT phase: admission -> first sampled token,
        recorded as one interval ending now (mono clock; t_admit is a
        perf_counter anchor so the duration, not its wall start, is the
        trusted quantity)."""
        if not _flightrec.on():
            return
        ttft = max(0.0, req.t_last_token - req.t_admit)
        _flightrec.record(
            "llm", "llm.first_token",
            t=_time.monotonic() - ttft, dur_s=ttft, rid=req.request_id,
        )

    @staticmethod
    def _rec_prefill(phase: str, t0: float, req: _Request, **extra) -> None:
        """A prefill phase from ``t0`` (monotonic) to now. The duration is
        the host's dispatch time: on the card the kernels are still queued
        when it ends, and their device time is the profiler's to read."""
        if _flightrec.on():
            _flightrec.record(
                "llm", phase, t=t0, dur_s=_time.monotonic() - t0,
                rid=req.request_id, **extra,
            )

    def _admit_handoff(self, req: _Request, slot: int) -> str:
        """Admit a disaggregated handoff: reserve blocks, pull the shipped
        KV into them, join the decode batch with the first token already
        sampled. Returns "done" (admitted, or finished without a slot),
        "wait" (no blocks free: the FIFO wave stops), or "fallback" (the
        pull failed: handoff cleared, the caller runs local admission)."""
        from ray_tpu_torch.llm import disagg

        h = req.handoff
        if h.get("finished"):
            # Stop token / max_tokens hit at prefill: the shipped first
            # token is the whole response; no KV, no slot.
            req.handoff = None
            req.generated.append(int(h["first_token"]))
            self.stats["tokens_generated"] += 1
            req.t_last_token = _time.perf_counter()
            req.finished = True
            return "done"
        if not h.get("kv") or int(h.get("block_size") or 0) != self._block_size:
            # Malformed or foreign block geometry: local prefill.
            req.handoff = None
            self.stats["kv_fallbacks"] += 1
            return "fallback"
        T = len(req.prompt)
        bs = self._block_size
        total = min(T + req.max_tokens, self.config.max_seq)
        nb_total = -(-total // bs)
        nb_kv = int(h["nblocks"])
        if nb_total > self.block_mgr.num_blocks - 1:
            req.error = (
                f"request {req.request_id} needs {nb_total} KV blocks but "
                f"the pool only has {self.block_mgr.num_blocks - 1}; raise "
                f"num_kv_blocks or lower max_tokens"
            )
            req.finished = True
            return "done"
        if not self.block_mgr.can_alloc(nb_total):
            self._evict_prefixes_until(nb_total)
            if not self.block_mgr.can_alloc(nb_total):
                return "wait"
        table = self.block_mgr.alloc(nb_total)
        try:
            kv = disagg.pull_local_kv(self, h, req.request_id)
            pk = self.pool["k"]
            ok = (
                kv.shape[0] == 2
                and kv.shape[1] == pk.shape[0]
                and kv.shape[2] >= nb_kv
                and kv.shape[3:] == pk.shape[2:]
                and kv.dtype == pk.dtype
            )
        except Exception:  # noqa: BLE001 - any pull failure (sever, dead peer) takes the counted fallback
            ok = False
        # Under tensor parallelism every rank takes the same verdict, or
        # the ranks' collectives would part ways.
        if not disagg.all_ranks_ok(self, ok):
            self.block_mgr.decref(table)
            req.handoff = None
            self.stats["kv_fallbacks"] += 1
            return "fallback"
        disagg.scatter_into_pool(self, kv, table[:nb_kv])
        req.blocks = table
        row = np.zeros(self._table_width, np.int32)
        row[: len(table)] = table
        self.block_tables[slot] = row
        req.slot = slot
        self.slot_free[slot] = False
        self._slot_req[slot] = req
        tok = int(h["first_token"])
        req.handoff = None
        req.generated.append(tok)
        self.stats["tokens_generated"] += 1
        self.stats["handoffs_in"] += 1
        # No TTFT here: the prefill engine produced the first token and
        # observed its TTFT; this clock anchors ITL only.
        req.t_last_token = _time.perf_counter()
        self.positions[slot] = T
        self.last_tokens[slot] = tok
        if self._spec is not None:
            req.spec_ready = self._spec.prefill_draft(req)
        self._maybe_finish(req)
        return "done"

    def _finish_prefill_only(self, req: _Request, tok: int) -> None:
        """Finish a prefill-only request at its first sampled token: record
        the token and its TTFT (the prefill engine produced it), export the
        prompt KV while the blocks are still held (the gather copies), then
        release the slot."""
        from ray_tpu_torch.llm import disagg

        self._first_token(req, tok)
        done = req.max_tokens <= 1 or tok == req.stop_token
        req.handoff_out = disagg.export_kv(self, req, tok, finished=done)
        self.stats["handoffs_out"] += 1
        req.finished = True
        self._release_slot(req)

    def _admit_paged(self, req: _Request, slot: int):
        """Reserve blocks, point the slot's table at them (sharing a pooled
        prefix's blocks), prefill the suffix. Returns the last-logits, or
        None when chunked prefill took the slot, when the pool cannot
        cover the reservation right now, or when no pool state ever can
        (the request then finishes with ``error``).

        Admission reserves ceil(min(T + max_tokens, max_seq) / block)
        blocks up front, so a running request never meets an exhausted
        pool mid-decode."""
        T = len(req.prompt)
        bs = self._block_size
        # Prefill-only requests (disagg) never decode here: reserve for the
        # prompt and the one sampled token, not the decode budget.
        mt = 1 if req.prefill_only else req.max_tokens
        total = min(T + mt, self.config.max_seq)
        entry = self._find_prefix(req.prompt)
        P = 0
        if entry is not None:
            # The suffix bucket must fit behind the prefix: a padded row
            # past max_seq has no table entry (the reference would clamp it
            # into the request's last real block). No fitting bucket -> a
            # full prefill.
            P = entry["len"]
            rem = T - P
            bucket = next(
                (
                    b
                    for b in self.config.prefill_buckets
                    if b >= rem and P + b <= self.config.max_seq
                ),
                None,
            )
            if bucket is None:
                entry, P = None, 0
        if entry is None:
            rem = T
            bucket = next(
                (b for b in self.config.prefill_buckets if b >= T),
                self.config.prefill_buckets[-1],
            )
        nb_total = -(-total // bs)
        need = max(nb_total - P // bs, 0)
        if nb_total > self.block_mgr.num_blocks - 1:
            # The full table (shared prefix blocks included: they are live
            # at the same time) can never fit the pool. Finish this request
            # with an error instead of raising from every later step().
            req.error = (
                f"request {req.request_id} needs {nb_total} KV blocks but "
                f"the pool only has {self.block_mgr.num_blocks - 1}; raise "
                f"num_kv_blocks or lower max_tokens"
            )
            req.finished = True
            return None
        if not self.block_mgr.can_alloc(need):
            # Under allocation pressure the prefix pool gives way (LRU),
            # except the entry this request is about to share.
            self._evict_prefixes_until(need, keep=entry)
            if not self.block_mgr.can_alloc(need):
                return None
        shared: list = []
        if entry is not None:
            shared = list(entry["blocks"])
            self.block_mgr.incref(shared)
        table = shared + self.block_mgr.alloc(need)
        req.blocks = table
        row = np.zeros(self._table_width, np.int32)
        row[: len(table)] = table
        self.block_tables[slot] = row
        if entry is not None:
            self.stats["prefix_hits"] += 1
            self.stats["prefix_tokens_reused"] += P
        if self._chunks_feasible(P, T):
            self._begin_chunked_prefill(req, slot, P)
            return None
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :rem] = req.prompt[P:]
        t_pf = _time.monotonic()
        logits = self._pg_prefill_impl(toks, rem, P, row)
        self.stats["prefill_tokens"] += rem
        self._rec_prefill("llm.prefill", t_pf, req, tokens=rem, reused=P)
        self._insert_prefix(req.prompt, slot, blocks=table)
        return logits

    def _admit_dense(self, req: _Request, slot: int):
        """Dense per-slot cache admission. Returns the prompt's
        last-logits, or None when chunked prefill took the slot."""
        T = len(req.prompt)
        entry = self._find_prefix(req.prompt)
        if entry is not None:
            # The suffix bucket must FIT behind the prefix: no fitting
            # bucket -> full prefill (correct, just unaided).
            P = entry["len"]
            rem = T - P
            bucket = next(
                (
                    b
                    for b in self.config.prefill_buckets
                    if b >= rem and P + b <= self.config.max_seq
                ),
                None,
            )
            if bucket is None:
                entry = None
        if entry is not None:
            # Prefix hit: copy the pooled KV into the slot, prefill only
            # the suffix.
            self._copy_prefix_in_impl(entry["k"], entry["v"], slot)
            self.stats["prefix_hits"] += 1
            self.stats["prefix_tokens_reused"] += P
            if self._chunks_feasible(P, T):
                self._begin_chunked_prefill(req, slot, P)
                return None
            toks = np.zeros((1, bucket), np.int64)
            toks[0, :rem] = req.prompt[P:]
            t_pf = _time.monotonic()
            logits = self._prefill_cont_impl(toks, rem, P, slot)
            self.stats["prefill_tokens"] += rem
            self._rec_prefill("llm.prefill", t_pf, req, tokens=rem, reused=P)
        else:
            if self._chunks_feasible(0, T):
                self._begin_chunked_prefill(req, slot, 0)
                return None
            bucket = next(
                (b for b in self.config.prefill_buckets if b >= T),
                self.config.prefill_buckets[-1],
            )
            toks = np.zeros((1, bucket), np.int64)
            toks[0, :T] = req.prompt
            t_pf = _time.monotonic()
            logits = self._prefill_impl(toks, T, slot)
            self.stats["prefill_tokens"] += T
            self._rec_prefill("llm.prefill", t_pf, req, tokens=T, reused=0)
        self._insert_prefix(req.prompt, slot)
        return logits

    # -- chunked prefill -----------------------------------------------------
    # A long prompt's suffix prefills in prefill_chunk_tokens-sized pieces,
    # one chunk per engine step, interleaved with decode steps. While a slot
    # is prefilling, positions[slot] == pf_next, so the fixed-shape decode's
    # garbage write for that slot lands where the next chunk (or the first
    # real decode) overwrites it.

    def _chunk_bucket(self, start: int, clen: int):
        """Smallest prefill bucket that holds a ``clen``-token chunk at
        ``start`` WITHOUT reaching past max_seq; None when none fits."""
        for b in self.config.prefill_buckets:
            if b >= clen and start + b <= self.config.max_seq:
                return b
        return None

    def _chunks_feasible(self, start: int, T: int) -> bool:
        """True when the [start, T) suffix should prefill chunked: the knob
        is on, the suffix is longer than one chunk, and EVERY chunk has a
        fitting bucket (checked up front)."""
        chunk = self.config.prefill_chunk_tokens
        if chunk <= 0 or T - start <= chunk:
            return False
        s = start
        while s < T:
            clen = min(chunk, T - s)
            if self._chunk_bucket(s, clen) is None:
                return False
            s += clen
        return True

    def _begin_chunked_prefill(self, req: _Request, slot: int, start: int):
        req.slot = slot
        req.prefilling = True
        req.pf_next = start
        self.slot_free[slot] = False
        self._slot_req[slot] = req
        self.positions[slot] = start
        self.last_tokens[slot] = 0

    def _prefill_one_chunk(self, req: _Request):
        """Prefill the next chunk of ``req``'s prompt; returns the chunk's
        last-logits (only the final chunk's are ever sampled)."""
        T = len(req.prompt)
        start = req.pf_next
        clen = min(self.config.prefill_chunk_tokens, T - start)
        bucket = self._chunk_bucket(start, clen)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :clen] = req.prompt[start : start + clen]
        t_pf = _time.monotonic()
        if self.paged:
            logits = self._pg_prefill_impl(toks, clen, start, self.block_tables[req.slot])
        else:
            logits = self._prefill_cont_impl(toks, clen, start, req.slot)
        self.stats["prefill_tokens"] += clen
        self.stats["prefill_chunks"] += 1
        if _metrics.metrics_enabled():
            _PREFILL_CHUNKS.inc(1.0)
        self._rec_prefill("llm.prefill_chunk", t_pf, req, tokens=clen, start=start)
        req.pf_next = start + clen
        self.positions[req.slot] = req.pf_next
        return logits

    def _advance_prefills(self) -> list:
        """ONE chunk, for ONE prefilling slot (round-robin), per step. A
        slot whose final chunk lands samples its first token and joins the
        decode batch. Returns requests that finished here."""
        B = len(self._slot_req)
        req = None
        for off in range(B):
            slot = (self._pf_rr + off) % B
            cand = self._slot_req[slot]
            if cand is not None and cand.prefilling:
                req = cand
                self._pf_rr = (slot + 1) % B
                break
        if req is None:
            return []
        logits = self._prefill_one_chunk(req)
        T = len(req.prompt)
        if req.pf_next < T:
            return []
        req.prefilling = False
        tok = self._sample(self._d2h(logits), req)
        self._insert_prefix(req.prompt, req.slot, blocks=req.blocks if self.paged else None)
        if req.prefill_only:
            # Disaggregated prefill leg, chunked variant: export + finish.
            self._finish_prefill_only(req, tok)
            return [req]
        self._first_token(req, tok)
        self.positions[req.slot] = T
        self.last_tokens[req.slot] = tok
        if self._spec is not None:
            req.spec_ready = self._spec.prefill_draft(req)
        self._maybe_finish(req)
        return [req] if req.finished else []

    def _sample(self, logits: np.ndarray, req: _Request) -> int:
        if req.temperature <= 0.0:
            return int(np.argmax(logits))
        z = logits / req.temperature
        z = z - z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(self._rng.choice(len(p), p=p))

    def _maybe_finish(self, req: _Request) -> None:
        done = (
            len(req.generated) >= req.max_tokens
            or req.generated[-1] == req.stop_token
            or (req.slot >= 0 and self.positions[req.slot] + 1 >= self.config.max_seq)
        )
        if done:
            req.finished = True
            self._release_slot(req)

    def _release_slot(self, req: _Request) -> None:
        """Return a request's slot and block references. Shared prefix
        blocks stay alive under the pool's own references; the slot's table
        points at the scratch block, so its garbage decode writes never
        land in a block someone else now owns."""
        if req.slot >= 0:
            if self.paged:
                self.block_mgr.decref(req.blocks)
                req.blocks = []
                self.block_tables[req.slot] = 0
                self.positions[req.slot] = 0
                self.last_tokens[req.slot] = 0
            self.slot_free[req.slot] = True
            self._slot_req[req.slot] = None
            req.slot = -1

    # -- the engine loop ------------------------------------------------------
    @torch.no_grad()
    def step(self) -> list:
        """Admit + one decode step for all active slots. Returns the
        requests that finished this step."""
        instrument = _metrics.metrics_enabled()
        # Prefill chunks of already-admitted long prompts advance BEFORE
        # this step's admissions: one chunk per request per step.
        finished = self._advance_prefills()
        finished += self._admit_waiting()
        active = [r for r in self._slot_req if r is not None and not r.prefilling]
        if active and self._spec is not None and self._spec_eligible(active):
            finished += self._spec.step(active)
        elif active:
            # Prefilling slots decode too, as in the reference: their write
            # lands at positions[slot] == pf_next, in their own block or
            # row, where the next chunk overwrites it.
            t_dec = _time.monotonic()
            if self.paged:
                _, logits = paged.paged_decode(
                    self._cparams,
                    self._h2d(self.last_tokens),
                    self._h2d(self.positions),
                    self._h2d(self.block_tables),
                    self.pool,
                    self.model_config,
                    block_size=self._block_size,
                    hooks=self._hooks,
                )
            else:
                _, logits = self._decode_mod.decode_step(
                    self._cparams,
                    self._h2d(self.last_tokens),
                    self._h2d(self.positions),
                    self.cache,
                    self.model_config,
                    self.mesh,
                )
            logits_np = self._d2h(logits)  # the decode step's one readback (whole over tp)
            now = _time.perf_counter()
            for req in active:
                slot = req.slot
                self.positions[slot] += 1
                tok = self._sample(logits_np[slot], req)
                req.generated.append(tok)
                self.stats["tokens_generated"] += 1
                if instrument and req.t_last_token:
                    _ITL_SECONDS.observe(now - req.t_last_token)
                req.t_last_token = now
                self.last_tokens[slot] = tok
                self._maybe_finish(req)
                if req.finished:
                    finished.append(req)
            if _flightrec.on():
                # Batch-wide phase (no rid): dispatch + logits readback +
                # host sampling for every active slot this step.
                _flightrec.record(
                    "llm", "llm.decode_step", t=t_dec,
                    dur_s=_time.monotonic() - t_dec, batch=len(active),
                )
        self._steps += 1
        if instrument:
            self._publish_metrics()
        return finished

    def _spec_eligible(self, active: list) -> bool:
        """A spec step may run only when every active slot is greedy with
        draft KV, and every occupied slot (prefilling ones too: the verify
        writes k+1 garbage rows at their cursor, as the vanilla decode
        writes one) sits k rows clear of max_seq, which keeps every verify
        write inside the table. All or nothing: the verify is one batch;
        an ineligible step runs the vanilla one."""
        k = self._spec.k
        lim = self.config.max_seq - 1
        for r in self._slot_req:
            if r is None:
                continue
            if self.positions[r.slot] + k > lim:
                return False
            if not r.prefilling and not (r.spec_ready and r.temperature <= 0.0):
                return False
        return True

    def _publish_metrics(self) -> None:
        """Per-step gauge/counter publication: the generated-token delta
        since the last publish, KV-block utilization (the batching
        headroom signal), and the prefix-pool hit rate."""
        delta = self.stats["tokens_generated"] - self._published_tokens
        if delta:
            _GEN_TOKENS.inc(float(delta))
            self._published_tokens = self.stats["tokens_generated"]
        tags = _replica_tags()
        if self.paged:
            total = self.block_mgr.num_blocks - 1
            if total > 0:
                _KV_UTIL.set(self.block_mgr.used_blocks / total, tags)
        lookups = self.stats["prefix_lookups"]
        if lookups:
            _PREFIX_HIT_RATE.set(self.stats["prefix_hits"] / lookups, tags)

    # Advertisement cap: the pool's token budget already bounds the digest
    # count, but a tiny chunk against a big budget must not grow it unboundedly.
    MAX_ADVERTISED_DIGESTS = 512

    def _refresh_digest_snapshot(self) -> None:
        """Rebuild the routing advertisement from the pool: every
        chunk-multiple prefix of every pooled entry. Snapshot first,
        version last, so a reader never pairs a new version with stale
        digests."""
        chunk = self.config.prefix_chunk
        out: set = set()
        for e in self._prefix_pool.values():
            out.update(chain_digests(e["tokens"], chunk, strict=False))
            if len(out) >= self.MAX_ADVERTISED_DIGESTS:
                break
        self._digest_snapshot = tuple(out)
        self._digest_version += 1

    def prefix_digest(self) -> dict:
        """Compact routing advertisement: what the prefix pool holds plus
        the cache-pressure signals a router biases on."""
        version = self._digest_version
        digests = list(self._digest_snapshot)
        lookups = self.stats["prefix_lookups"]
        # The BlockManager holds at least one allocatable block.
        kv_util = self.block_mgr.used_blocks / (self.block_mgr.num_blocks - 1) if self.paged else 0.0
        return {
            "scheme": BYTE_BOS_SCHEME if isinstance(self.tokenizer, ByteTokenizer) else "custom",
            "chunk": self.config.prefix_chunk,
            "digests": digests,
            "version": version,
            "hit_rate": (self.stats["prefix_hits"] / lookups) if lookups else 0.0,
            "kv_util": kv_util,
            "prefill_tokens": self.stats["prefill_tokens"],
            "prefix_tokens_reused": self.stats["prefix_tokens_reused"],
        }

    def rolling_ttft_ms(self) -> float:
        """p95 of the recent-TTFT window in milliseconds, counting only
        samples younger than TTFT_WINDOW_S (0.0 when none)."""
        cutoff = _time.monotonic() - self.TTFT_WINDOW_S
        window = sorted(v for t, v in list(self._ttft_window) if t >= cutoff)
        if not window:
            return 0.0
        idx = min(len(window) - 1, int(0.95 * len(window)))
        return round(window[idx] * 1e3, 3)

    def has_unfinished(self) -> bool:
        return any(not r.finished for r in self.requests.values())

    def kv_stats(self) -> dict:
        """Block-pool occupancy (paged mode) for routing and observability."""
        if not self.paged:
            return {"paged": False}
        return {
            "paged": True,
            "block_size": self._block_size,
            "blocks_total": self.block_mgr.num_blocks - 1,
            "blocks_free": self.block_mgr.free_blocks,
            "blocks_used": self.block_mgr.used_blocks,
        }

    def pop_finished(self) -> list:
        done = [r for r in self.requests.values() if r.finished]
        for r in done:
            del self.requests[r.request_id]
        return done

    # -- convenience -----------------------------------------------------------
    def generate(self, prompts: list, sampling: SamplingParams | None = None) -> list[dict]:
        """Blocking batch generation; returns [{text, token_ids}] in order."""
        base = self._steps
        ids = [f"gen-{base}-{i}" for i in range(len(prompts))]
        for rid, p in zip(ids, prompts):
            self.add_request(rid, p, sampling)
        while self.has_unfinished():
            self.step()
        done = {r.request_id: r for r in self.pop_finished()}
        out = []
        for rid in ids:
            req = done[rid]
            toks = [t for t in req.generated if t != req.stop_token]
            out.append(
                {
                    "request_id": rid,
                    "token_ids": list(req.generated),
                    "text": self.tokenizer.decode(toks),
                    "num_generated": len(req.generated),
                    "error": req.error,
                }
            )
        return out
