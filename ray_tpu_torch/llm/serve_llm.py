"""serve.llm: OpenAI-compatible serving on the Serve tier.
Port of ``ray_tpu/llm/serve_llm.py``.

Reference parity: python/ray/llm/_internal/serve/ (LLMServer deployment +
OpenAI-compatible router). The replica owns one LLMEngine on one card (the
port's explicit ``device``, ``"cuda"`` unless the caller asks for
``"cpu"``); an asyncio pump loop runs the engine's continuous-batching
steps while requests await their finish events, so concurrent HTTP requests
batch onto the same decode step. The card is fixed when the replica starts
(the current device of the thread that builds it) and made current in the
executor thread that steps the engine, since the current device is per
thread. A replica asked for the card on a machine without one raises in
its constructor, so the deployment fails its health check instead of
serving on the CPU.

Endpoints (via the Serve HTTP proxy, path-routed to this deployment):
  POST /{name}/v1/completions       {"prompt": ..., "max_tokens": ...}
  POST /{name}/v1/chat/completions  {"messages": [{role, content}...]}
"""

from __future__ import annotations

import asyncio
import itertools
import threading
import time

import torch

from ray_tpu_torch.core.errors import NotPortedError
from ray_tpu_torch.llm.config import LLMConfig, SamplingParams
from ray_tpu_torch.llm.engine import LLMEngine
from ray_tpu_torch.serve import api as serve_api
from ray_tpu_torch.util import metrics as _metrics
from ray_tpu_torch.util.device import resolve_device
from ray_tpu_torch.util.tasks import spawn

# Replica-level serving view on top of the engine's own series (TTFT/ITL/
# token counters/KV gauges live in llm/engine.py): how long each
# continuous-batching step holds the executor thread and how many requests
# are riding the batch.
_STEP_SECONDS = _metrics.Histogram(
    "raytpu_llm_engine_step_seconds",
    "wall time of one continuous-batching step (admissions included)",
    boundaries=_metrics.LATENCY_BOUNDARIES_S,
)
_ACTIVE_REQUESTS = _metrics.Gauge(
    "raytpu_llm_active_requests",
    "requests admitted or decoding on this engine replica",
    tag_keys=("replica",),  # gauge: untagged would last-wins across replicas
)


class LLMServer:
    """The deployment callable (one engine per replica)."""

    def __init__(self, config: LLMConfig, *, device: "str | torch.device" = "cuda"):
        _refuse_tensor_parallel(config)
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.config = config
        self.engine = LLMEngine(config, device=dev)
        self._counter = itertools.count()
        self._finished: dict[str, object] = {}  # request_id -> _Request
        self._events: dict[str, asyncio.Event] = {}
        # Token streaming: request_id -> queue of decoded token ids (None =
        # end of stream), fed by the pump after each decode step.
        self._token_queues: dict[str, asyncio.Queue] = {}
        self._delivered: dict[str, int] = {}  # tokens pushed so far
        # Thread-safety: the engine is touched ONLY by the pump's executor
        # thread. The event loop enqueues admissions here; the pump drains
        # them into the engine at step boundaries (a direct add_request from
        # the loop would mutate engine.requests while step() iterates it).
        self._pending: list[tuple] = []
        self._pending_lock = threading.Lock()
        self._pump_task = None

    def _ensure_pump(self) -> None:
        if self._pump_task is None or self._pump_task.done():
            self._pump_task = spawn(self._pump(), name="llm engine pump")

    def _step_with_admissions(self) -> list:
        if self.engine.device.type == "cuda":
            # The executor thread's current card, for the kernels' launches.
            torch.cuda.set_device(self.engine.device)
        with self._pending_lock:
            batch, self._pending = self._pending, []
        for rid, prompt, sampling, prefill_only, handoff in batch:
            if handoff is not None:
                self.engine.add_handoff_request(rid, handoff, sampling)
            else:
                self.engine.add_request(
                    rid, prompt, sampling, prefill_only=prefill_only
                )
        finished = self.engine.step()
        for req in finished:
            self.engine.requests.pop(req.request_id, None)
        more = self.engine.has_unfinished()
        return finished, more

    def _push_new_tokens(self, finished: list) -> None:
        """Between steps (engine quiescent): forward newly generated tokens
        of streaming requests to their queues; None terminates a stream."""
        live = list(self.engine.requests.values()) + list(finished)
        for req in live:
            q = self._token_queues.get(req.request_id)
            if q is None:
                continue
            sent = self._delivered.get(req.request_id, 0)
            for tok in req.generated[sent:]:
                q.put_nowait(tok)
            self._delivered[req.request_id] = len(req.generated)
        for req in finished:
            q = self._token_queues.get(req.request_id)
            if q is not None:
                q.put_nowait(None)

    async def _pump(self) -> None:
        """Engine loop: steps while work exists, yields to the event loop
        between steps so new requests can join the batch."""
        loop = asyncio.get_running_loop()
        while True:
            instrument = _metrics.metrics_enabled()
            t0 = time.perf_counter() if instrument else 0.0
            finished, more = await loop.run_in_executor(
                None, self._step_with_admissions
            )
            if instrument:
                from ray_tpu_torch.llm.engine import _replica_tags

                _STEP_SECONDS.observe(time.perf_counter() - t0)
                _ACTIVE_REQUESTS.set(
                    float(len(self.engine.requests)), _replica_tags()
                )
            self._push_new_tokens(finished)
            for req in finished:
                self._finished[req.request_id] = req
                ev = self._events.pop(req.request_id, None)
                if ev is not None:
                    ev.set()
            with self._pending_lock:
                if not more and not self._pending:
                    return

    def _admit(
        self,
        prompt,
        sampling: SamplingParams,
        prefill_only: bool = False,
        handoff: dict | None = None,
    ) -> str:
        rid = f"req-{next(self._counter)}"
        from ray_tpu_torch.util import flightrec

        if flightrec.on():
            # Stitch the router's flight-recorder request id (propagated via
            # the replica's contextvar) to the engine-local req-N id, so the
            # timeline exporter can join serve hops to engine phases.
            from ray_tpu_torch.serve.replica import current_frid

            frid = current_frid()
            if frid is not None:
                flightrec.record("llm", "llm.bind", rid=rid, frid=frid)
        with self._pending_lock:
            self._pending.append((rid, prompt, sampling, prefill_only, handoff))
        return rid

    async def _generate(
        self, prompt, sampling: SamplingParams, handoff: dict | None = None
    ) -> dict:
        rid = self._admit(prompt, sampling, handoff=handoff)
        ev = asyncio.Event()
        self._events[rid] = ev
        self._ensure_pump()
        await ev.wait()
        req = self._finished.pop(rid)
        toks = [t for t in req.generated if t != req.stop_token]
        return {
            "text": self.engine.tokenizer.decode(toks),
            "token_ids": list(req.generated),
            "num_generated": len(req.generated),
            # Admission failure (e.g. a reservation the KV pool can never
            # satisfy): the engine finishes the request with req.error set
            # instead of wedging; it must not leave here as an empty 200.
            "error": getattr(req, "error", None),
        }

    async def _stream_tokens(
        self, prompt, sampling: SamplingParams, handoff: dict | None = None
    ):
        """Async generator of decoded text pieces, one per generated token,
        emitted as each decode step lands (true token streaming: the chip is
        still decoding later tokens while early ones are on the wire)."""
        rid = self._admit(prompt, sampling, handoff=handoff)
        q: asyncio.Queue = asyncio.Queue()
        self._token_queues[rid] = q
        ev = asyncio.Event()
        self._events[rid] = ev
        self._ensure_pump()
        try:
            while True:
                tok = await q.get()
                if tok is None:
                    done = self._finished.get(rid)
                    if done is not None and getattr(done, "error", None):
                        # Surface through the SSE error channel (the proxy
                        # emits a data: {"error": ...} event + [DONE]).
                        raise RuntimeError(done.error)
                    break
                req = self.engine.requests.get(rid) or self._finished.get(rid)
                if req is not None and tok == req.stop_token:
                    continue
                yield self.engine.tokenizer.decode([tok])
        finally:
            self._token_queues.pop(rid, None)
            self._delivered.pop(rid, None)
            self._finished.pop(rid, None)
            self._events.pop(rid, None)

    def router_state(self) -> dict:
        """Routing advertisement, pushed by the hosting ReplicaActor's
        report loop: which prefix blocks this replica's KV pool already
        holds (stable digests), plus hit-rate/KV-util — the signals the
        prefix-affinity router biases pow-2 on — and the rolling p95 TTFT
        the serve controller's overload watermarks compare against. Reads
        only atomic engine snapshots, so it is safe against the pump's
        executor thread."""
        state = self.engine.prefix_digest()
        state["ttft_ms"] = self.engine.rolling_ttft_ms()
        return state

    @staticmethod
    def _sampling(body: dict) -> SamplingParams:
        return SamplingParams(
            max_tokens=int(body.get("max_tokens", 16)),
            temperature=float(body.get("temperature", 0.0)),
        )

    @staticmethod
    def _prompt_of(request: dict) -> str:
        """The prompt text this replica will tokenize — the same rules the
        router's _extract_prompt mirrors (chat path -> the shared
        chat_prompt join, everything else -> body['prompt'])."""
        body = request.get("body") or {}
        if not isinstance(body, dict):
            return ""
        if str(request.get("path", "")).endswith("/v1/chat/completions"):
            from ray_tpu_torch.util.prefix_digest import chat_prompt

            msgs = body.get("messages", [])
            return chat_prompt(msgs if isinstance(msgs, list) else [])
        return body.get("prompt", "")

    async def prefill_handoff(self, request: dict) -> dict:
        """Prefill leg of the disaggregated two-hop (router-invoked on
        prefill-role replicas): run admission + prefill for the request's
        prompt, sample the first token, and return the handoff descriptor
        — prompt ids, the first token, and the armed KV-block export the
        decode replica pulls over the transfer fabric. Returns
        {"unsupported": True} when this replica cannot export (dense
        cache, or the RAY_TPU_DISAGG kill switch landed here first) — the
        router then falls back to unified routing."""
        from ray_tpu_torch.core.config import GLOBAL_CONFIG

        if (
            not getattr(self.engine, "paged", False)
            or not GLOBAL_CONFIG.disagg
        ):
            return {"unsupported": True}
        body = request.get("body") or {}
        if not isinstance(body, dict):
            return {"error": "JSON body required"}
        rid = self._admit(
            self._prompt_of(request), self._sampling(body), prefill_only=True
        )
        ev = asyncio.Event()
        self._events[rid] = ev
        self._ensure_pump()
        await ev.wait()
        req = self._finished.pop(rid)
        if getattr(req, "error", None):
            return {"error": req.error}
        return req.handoff_out or {"unsupported": True}

    def _stream_chunks(
        self, prompt, body: dict, created: int, chat: bool,
        handoff: dict | None = None,
    ):
        """OpenAI-convention chunk objects (chat.completion.chunk /
        text_completion chunks), one per token, + a finish_reason tail."""

        async def chunks():
            idx = 0
            async for piece in self._stream_tokens(
                prompt, self._sampling(body), handoff=handoff
            ):
                idx += 1
                if chat:
                    yield {
                        "id": "chatcmpl-raytpu",
                        "object": "chat.completion.chunk",
                        "created": created,
                        "model": self.config.model_id,
                        "choices": [
                            {
                                "index": 0,
                                "delta": {"content": piece},
                                "finish_reason": None,
                            }
                        ],
                    }
                else:
                    yield {
                        "id": "cmpl-raytpu",
                        "object": "text_completion",
                        "created": created,
                        "model": self.config.model_id,
                        "choices": [
                            {"index": 0, "text": piece,
                             "finish_reason": None}
                        ],
                    }
            tail_choice = (
                {"index": 0, "delta": {}, "finish_reason": "stop"}
                if chat
                else {"index": 0, "text": "", "finish_reason": "stop"}
            )
            yield {
                "id": "chatcmpl-raytpu" if chat else "cmpl-raytpu",
                "object": (
                    "chat.completion.chunk" if chat else "text_completion"
                ),
                "created": created,
                "model": self.config.model_id,
                "choices": [tail_choice],
                "usage": {"completion_tokens": idx},
            }

        return chunks()

    async def __call__(self, request: dict):
        path = request.get("path", "")
        body = request.get("body") or {}
        if not isinstance(body, dict):
            return {"error": "JSON body required"}
        created = int(time.time())
        # Disaggregated two-hop: the router attaches the prefill replica's
        # handoff; this (decode) replica joins the request mid-decode.
        handoff = request.get("_handoff")
        if path.endswith("/v1/chat/completions"):
            # ONE prompt-derivation rule (shared with prefill_handoff —
            # the handoff pairing depends on both replicas deriving the
            # same text the shipped KV encodes).
            prompt = self._prompt_of(request)
            if body.get("stream"):
                return self._stream_chunks(
                    prompt, body, created, chat=True, handoff=handoff
                )
            out = await self._generate(
                prompt, self._sampling(body), handoff=handoff
            )
            if out.get("error"):
                return {"error": out["error"]}
            return {
                "id": "chatcmpl-raytpu",
                "object": "chat.completion",
                "created": created,
                "model": self.config.model_id,
                "choices": [
                    {
                        "index": 0,
                        "message": {
                            "role": "assistant",
                            "content": out["text"],
                        },
                        "finish_reason": "stop",
                    }
                ],
                "usage": {"completion_tokens": out["num_generated"]},
            }
        # default: completions
        prompt = self._prompt_of(request)
        if body.get("stream"):
            return self._stream_chunks(
                prompt, body, created, chat=False, handoff=handoff
            )
        out = await self._generate(
            prompt, self._sampling(body), handoff=handoff
        )
        if out.get("error"):
            return {"error": out["error"]}
        return {
            "id": "cmpl-raytpu",
            "object": "text_completion",
            "created": created,
            "model": self.config.model_id,
            "choices": [
                {"index": 0, "text": out["text"], "finish_reason": "stop"}
            ],
            "usage": {"completion_tokens": out["num_generated"]},
        }


def _refuse_tensor_parallel(config: LLMConfig) -> None:
    if config.tensor_parallelism > 1:
        # The port's tp engine is one rank of an SPMD group of processes;
        # a replica that spans its rank processes is not ported.
        raise NotPortedError("LLMServer with tensor_parallelism > 1")


def build_openai_app(
    config: LLMConfig,
    *,
    name: str = "llm",
    num_replicas: int = 1,
    admission_config: dict | None = None,
    prefill_replicas: int = 0,
    device: str = "cuda",
):
    """An Application serving OpenAI-style routes under /{name}/v1/...
    (reference: ray.serve.llm build_openai_app). ``admission_config``
    opts the deployment into the serve overload plane (tenant token
    buckets, priority shedding on queue/TTFT watermarks, bounded replica
    queues — see README "Overload protection"); LLM replicas advertise a
    rolling p95 TTFT, so the ttft_high_ms/ttft_low_ms watermarks are
    live for this deployment.

    ``prefill_replicas`` > 0 opts into DISAGGREGATED serving: the
    deployment runs ``prefill_replicas`` prefill-role replicas plus
    ``num_replicas`` decode-role replicas, roles advertised in the
    routing table. The router lands each request's prefill on a prefill
    replica (prefix-digest bias preserved), ships the finished KV blocks
    to a decode replica over the transfer fabric (the handoff carries the
    first sampled token), and decode replicas never run whole-suffix
    prefill — see README "Disaggregated serving". Requires the paged KV
    cache; RAY_TPU_DISAGG=0 restores unified serving byte-identically.

    ``device`` reaches each replica's :class:`LLMServer` through ``bind``:
    the card unless the caller asks for ``"cpu"``. ``config.placement`` is
    each replica actor's resource demand: ``{"num_cpus": 1, "num_gpus": 1}``
    holds a card of the port's runtime (two replicas sharing one card take
    ``0.5`` each)."""
    _refuse_tensor_parallel(config)
    from ray_tpu_torch.util.prefix_digest import BYTE_BOS_SCHEME

    disagg_config = None
    if prefill_replicas > 0:
        if config.kv_block_size <= 0:
            raise ValueError(
                "disaggregated serving (prefill_replicas > 0) requires "
                "the paged KV cache (kv_block_size > 0): handoffs ship "
                "pool blocks over the transfer fabric"
            )
        disagg_config = {"prefill_replicas": int(prefill_replicas)}
        num_replicas = int(num_replicas) + int(prefill_replicas)
    dep = serve_api.deployment(
        LLMServer,
        name=name,
        num_replicas=num_replicas,
        admission_config=admission_config,
        disagg_config=disagg_config,
        ray_actor_options=dict(config.placement),
        # Same-prefix requests stick to a replica whose engine already
        # pooled that prefix's KV (no re-prefill of shared system prompts).
        request_affinity=(
            "prompt_prefix" if config.enable_prefix_caching else None
        ),
        # Digest contract for prefix-affinity routing: the engine's
        # default ByteTokenizer is byte-level, so routers can hash a
        # prompt's leading blocks from TEXT and match the replica-pooled
        # digests exactly (a custom tokenizer would advertise "custom"
        # and routers fall back to load-only).
        request_affinity_config=(
            {"scheme": BYTE_BOS_SCHEME, "chunk": config.prefix_chunk}
            if config.enable_prefix_caching
            else None
        ),
    )
    return dep.bind(config, device=device)
