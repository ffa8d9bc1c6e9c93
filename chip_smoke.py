#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which fails the script (non-zero exit) when it fails:

1. Print the card's name and power limit (``nvidia-smi``) and build the
   port's CUDA kernels with ``nvcc`` from the checkout's sources, one
   ``nvcc`` per source, all started together.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the serving path (B=1) and the training path (B=8, S=1024) give
   it, and the forward also at Llama's layout (contiguous q, K/V expanded
   from 4 KV heads, B=1, S=1024) and at one tensor-parallel rank's 6 heads
   of GPT-2-125M (B=1, S=1024); time kernel, plain version and the
   PyTorch library call that computes the same function.
3. Serve through the port's ``LLMEngine`` at the reference engine's
   default shape (16 slots, 2048 positions), four paths in turn, each at
   full width with random weights from a seed and telemetry on (the
   reference's default): GPT-2-125M on the dense KV cache (``serve``),
   GPT-2-125M on the paged cache, the default (``serve_paged``), Llama-125M
   on the dense cache (``serve_llama``) and on the paged cache
   (``serve_llama_paged``). Each gets 6 requests of ~20 to ~1000 prompt
   tokens, two of them sharing a 64-token prefix; the kernels' launch
   counts are zeroed just before each path and read just after it. Dense
   paths launch flash_fwd 12 times per fresh prefill; the paged paths run
   no kernel (0 launches), as the reference's paged prefill and decode run
   no Pallas kernel. On the paged paths the shared prefix runs on shared
   blocks (refcount >= 2), and after the run only the prefix pool's blocks
   stay in use.
4. Check each path's telemetry over that run: the registry's snapshot
   delta (request, prompt-token, generated-token and prefill-chunk
   counters; TTFT and ITL observation counts; KV-utilization and
   prefix-hit-rate gauges) and the flight recorder's ``llm`` ring
   (``llm.first_token``, ``llm.prefill``, ``llm.prefill_chunk`` and
   ``llm.decode_step`` events, their tokens and reused prefixes) against
   what the engine did, counted on the host step by step; the path's line
   carries them under ``"telemetry"``, with the TTFT and ITL summaries.
5. Check each path's first-token logits of one prompt: a dense path's
   (the kernel) against the plain attention within bf16's own noise, a
   paged path's against its family's dense plain-attention logits for
   exact equality.
6. Profile where a step's time goes on each path (torch.profiler: device
   busy share and the heaviest kernels of one prefill step and of decode
   steps), with the flight recorder's summed ``llm`` phase host times of
   the same windows beside the device time.
7. The telemetry A/B on ``serve`` and ``serve_paged``: the same 6-request
   traffic with ``metrics_enabled`` and ``flightrec`` off, then on, one
   round each on one engine, each timed on the host clock and then
   profiled over 24 decode steps. The greedy streams must be identical
   between the arms and the decode device time other than the copies
   (the logits readback to pageable memory, whose recorded time follows
   the host) may move by at most 3 %; printed as one
   ``{"telemetry_ab": ...}`` line.
8. Batch inference: ``build_llm_processor`` on GPT-2-125M (the default
   config) takes one batch of 4 prompts twice; the second call must reuse
   the cached engine, and the texts must equal that engine's
   ``generate`` (``{"batch": ...}``).
9. Disaggregated serving (``disagg``), GPT-2-125M and Llama-125M at full
   width on the paged cache at phase 3's shape: phase 3's 6-request
   traffic prefilled by a prefill-only engine and decoded by another from
   the handoffs (the KV over the socket transfer fabric), with the launch
   counts zeroed just before and read just after (0: the paged path runs
   no kernel). The streams must equal a unified engine's exactly, with no
   prefill on the decode engine, no fallback and 6 handoffs in, and each
   handoff must ship 2 * L * nb_pad * KH * 16 * 64 * 2 bytes. Then one
   request under a seeded ``kvship.sever`` (seed 7) must fall back to the
   decode engine's local chunked prefill with the tokens of a unified
   engine that chunks alike, and one handoff to a dense engine must
   re-prefill with n_layer flash_fwd launches. The ``llm.kv_export`` and
   ``llm.kv_pull`` medians and the bytes a handoff are printed beside the
   card line (``{"disagg": ...}``).
10. Train GPT-2-125M at full width through the port's ``make_train_step``
   (batch [8, 1024], bf16 activations, f32 masters, ``remat="mlp"``,
   ``loss_chunk=0``): one step's loss and gradient norm through the kernels
   against the plain attention, 3 warm-up and 10 timed steps with the
   launch counts zeroed just before the timed steps and read just after,
   one step at ``loss_chunk=128`` against ``loss_chunk=0``, and one
   profiled step (``train``).
11. The same for Llama-125M (``train_llama``): ``LlamaConfig.llama_125m()``
   with its defaults ``remat="mlp"`` and ``loss_chunk=128`` (checked
   against ``loss_chunk=0``); the kernels run on K/V repeated from 4 KV
   heads, 12 flash_fwd and 12 flash_bwd launches a step.
12. MoE GPT-2 (``train_moe``): GPT-2-125M's widths with 4 experts in every
   block (capacity 1.5, aux weight 0.01), trained as in phase 10; "mlp"
   remat resolves to "dots" under MoE, so each step runs 24 flash_fwd and
   12 flash_bwd launches. It also prints the aux of every step (finite)
   and the share of tokens an expert served in each layer.
13. The mesh path (``train_mesh``): ``bench.py``'s call sequence on the
   port (``make_mesh``, ``shardings_from_logical``,
   ``make_train_state(param_shardings=)``, ``make_train_step(mesh=,
   batch_spec=, param_shardings=)``, ``compile_train_step``) over NCCL at
   world size 1, from a ``file://`` store in a temporary directory: one
   all-reduce through the group; GPT-2-125M under ``MeshSpec(dp=1)`` and
   MoE GPT-2 under ``MeshSpec(ep=1)``, each two steps equal to the
   unsharded step's bit for bit (losses, params, moments); then the dense
   sharded step timed as in phase 10 (12 + 12 launches a step).
14. Sharded steps (``train_shard``), the same call sequence over several
   rank processes (this script with ``--mesh-rank``), at full width:
   GPT-2-125M under ``MeshSpec(tp=2)``, Llama-125M under
   ``MeshSpec(fsdp=2, tp=2)`` and MoE GPT-2 under ``MeshSpec(tp=2)`` (global
   batch [8, 1024] each), then GPT-2-125M under ``dp=2`` (batch [16,
   1024]) and MoE under ``ep=2``; then the sequence and pipeline axes
   (batch [8, 1024], 4 ranks each): GPT-2-125M under ``sp=2 x tp=2`` and
   Llama-125M under ``fsdp=2 x sp=2``, both with the reference gate's
   batch spec ``P(("dp", "fsdp"), "sp")`` (each rank its 512-position
   block, attention over the ring: no kernel), and MoE GPT-2 under
   ``pp=2 x ep=2`` with 2 microbatches (each stage 6 layers, the kernels
   inside it at [4, 12, 1024, 64]). With a card for every rank the ranks
   run over NCCL, one a card; with fewer (one H100), all on card 0 over a
   gloo group, which takes the CUDA tensors of every collective and
   stages them through host memory, while point-to-point (the ring and
   the stages) the port stages through pinned host memory itself
   (printed as each rank's ``"transport"``). Each rank's loss and
   gradient norm are held to the unsharded step's on card 0 within the
   training tolerances (for the pipelined MoE, the mean over its two
   microbatches, each routed alone as the pipeline routes it); each rank
   then takes one full step with the launch counts zeroed just before
   and read just after (12 + 12, MoE 24 + 12; 0 + 0 on the ring; 24 + 12
   a stage of the pipelined MoE: 6 layers x 2 microbatches, "dots"), and
   prints its peak memory and the size of its state beside the unsharded
   step's. Ranks that share one card are not speed evidence. The last
   case, GPT-2-125M under ``fsdp=2 x tp=2``, then takes a second step,
   saves the state (``train/sharded_checkpoint.py``: each rank its own
   blocks) and restores it onto its own mesh, onto ``dp=2 x tp=2`` and
   whole onto the host: every saved leaf and every leaf restored onto
   ``dp=2 x tp=2`` must be bit for bit its block of the whole one. One
   step each on the live state, the state restored onto the same mesh
   and the one restored onto the new mesh follow, with the launch counts
   zeroed just before and read just after: the resumed loss must equal
   the live one bit for bit on the same mesh and within the training
   tolerance on the new one. The bytes each rank wrote and the save and
   restore seconds are printed.
15. Tensor-parallel serving (``serve_tp``): ``LLMEngine`` with
   ``tensor_parallelism`` > 1, each rank a process (this script with
   ``--serve-rank``), placed as in phase 14: GPT-2-125M at ``tp=2`` on the
   paged and the dense cache, Llama-125M at ``tp=2`` paged and ``tp=4``
   dense, each on phase 3's configuration and traffic, and the spec
   probe's 1-layer draft arm (phase 16's shape, dense) at ``tp=2`` on
   streams cut to 64 tokens. A one-rank engine of the same fields and seed
   serves the same traffic in this process first. Every rank's streams,
   counters and first-token logits must equal rank 0's; rank 0's streams
   must equal the one-rank engine's, or first diverge at a near tie within
   bf16's noise (as phase 16's spec arms against vanilla); rank 0's
   first-token logits of the 1000-token prompt (spec: of its first
   stream) within twice the family's bf16 tolerance of phase 5 of the
   one-rank engine's; each rank's flash_fwd launches those of the one-rank
   path on that traffic (spec: its target and draft prefills), and its KV
   bytes the one-rank engine's divided by tp. Each rank's telemetry is
   checked as in phase 4. Peak memory, KV size, launches, transport and
   the ranks' seconds are printed, and are not speed evidence. In the
   ranks of ``gpt2_tp2`` a tp=2 prefill-only engine then hands the same
   traffic to a tp=2 decode engine: the streams must equal the ranks' own
   unified ones, with no prefill and no fallback on the decode engine.
16. Speculative decoding with a GPT-2-125M target, in the reference's own
   spec-decoding probe shape (4 slots, 1024 positions, 3 greedy streams of
   200 tokens after a warm-up request, k=4), on the dense cache (``spec``)
   and the paged one (``spec_paged``). Three arms each: vanilla, a 1-layer
   d128 draft, and the target itself as its draft (loaded from a pickle of
   the target's weights). Each spec arm must run spec steps and give the
   vanilla arm's streams, except where the vanilla step's f32 logits put
   the two tokens within bf16's noise (a near tie rounded the other way
   by the verify's wider products); the dense arms launch flash_fwd 12
   times per target prefill plus once per draft layer per draft prefill,
   the paged ones never. Every arm's telemetry is checked as in phase 4,
   with the drafted and accepted counters and the accept-rate gauge.

17. The core runtime (``runtime``): ``ray_tpu_torch.init(num_cpus=4)``
   starts the port's own GCS, node manager and worker processes
   (``ray_tpu_torch.core.worker_main``), whose ``GPU`` resource must count
   the cards ``nvidia-smi`` lists. The host plane: a no-op task's round
   trip (median of 50) and ``put``/``get`` of a 256 MiB bf16 CPU tensor
   (GB/s, bits equal). A ``num_gpus=1`` task makes a 64 MiB bf16 tensor on
   the card from a seeded generator and returns it: this process gets a CPU
   bf16 tensor with the bits of the same tensor made here. A
   ``num_gpus=1`` actor builds phase 3's ``serve`` engine in its own
   process and serves phase 3's warm-up and 6 requests as token ids: its
   greedy streams must equal ``serve``'s and its own flash_fwd launches
   ``serve``'s (60); it reports its pid, card, peak memory and decode
   tok/s. While it holds the one ``GPU``, a second ``num_gpus=1`` task must
   stay unscheduled for 2 s, and run after ``kill(actor)``. A ``num_gpus=1``
   task takes one training step of phase 10's GPT-2-125M on its batch and
   initial state: 12 launches of each kernel, loss and gradient norm of
   the initial params within the training tolerances of phase 10's (their
   bit equality printed), and the step's loss against phase 10's first
   step. After ``shutdown()`` no worker process may survive and
   ``nvidia-smi`` may list none as a compute app. Printed as one
   ``{"runtime": ...}`` line with the host copy path ``_native`` took.
18. The train tier (``train_loop``), in phase 17's session before its
   ``shutdown()``: ``TorchTrainer(...).fit()`` as a user calls it. Case 1:
   one worker (``resources_per_worker={"GPU": 1}``, ``TorchConfig()``:
   NCCL at world size 1, ``FailureConfig(max_failures=1)``) trains phase
   10's GPT-2-125M ([8, 1024], ``remat="mlp"``, seeds 0 and 1) six steps,
   its batches pinned on the host and staged through
   ``DevicePrefetchIterator`` (depth 2), each step's loss reported as a
   CUDA tensor through the async ring (depth 4), the state saved with
   ``report(sharded_state=...)`` at steps 3 and 6. Its first attempt raises
   after step 3; the controller rebuilds the group and the train fn
   resumes from ``get_checkpoint()`` through ``load_sharded_state``. The
   history must hold steps 1-6 once each, in order; the losses within the
   training tolerance of the same six steps run in this process (their bit
   equality printed); 12 + 12 launches every step, counted in the worker;
   the final checkpoint, restored whole on the host, with each leaf's
   digest the one the worker took. Case 2: two workers sharing the card
   (``{"GPU": 0.5}`` each, ``TorchConfig(backend="gloo")``) take two steps
   of GPT-2-125M under ``MeshSpec(dp=2)`` ([16, 1024]) and save the state:
   both ranks' loss and gradient norm within the training tolerances of
   ``train_shard``'s unsharded dp2 step, the checkpoint restored whole,
   and a third ``GPU`` demand waits while the group holds the card. The
   fit times, the first worker's start, the rebuild and each attempt's
   ring readbacks and ``train`` phases are printed as one
   ``{"train_loop": ...}`` line.
19. The serve tier (``serve_app``), in phase 17's session after phase 18:
   ``serve.run(build_openai_app(...))`` as a user deploys it, GPT-2-125M
   at phase 3's serve shape with seed-0 weights; each replica's callable
   is ``SmokeLLMServer``, an ``LLMServer`` that also reports the counts of
   its own process. (a) Unified: one replica holding the ``GPU`` unit on
   the dense cache; a warm-up, then phase 3's six prompts as text (20,
   100, 300, 1000, 94 and 114 bytes, the last two sharing a 64-byte
   prefix; 32 greedy tokens each) POSTed at once from threads to
   ``/llm/v1/completions`` on ``serve.proxy_port()``, a streamed chat
   completion and its non-streamed twin, and a ``max_tokens=1`` request.
   The replica's streams must equal those of an engine of the same fields
   in this process on the same texts, or first diverge at a near tie
   within phase 5's bf16 bound; each response's text and count must be
   its ids'; the streamed chat, joined, must equal its twin; the
   replica's flash_fwd launches, zeroed just before the traffic and read
   just after in its process, must be n_layer times its fresh prefills
   (its requests less its prefix hits), flash_bwd 0. (b) Disaggregated:
   after ``serve.delete``, one prefill and one decode replica at 0.5 GPU
   each on the paged cache (``prefill_replicas=1``); the six prompts
   through a ``DeploymentHandle`` in this process and one over HTTP. The
   routing table must carry the roles, this process's
   ``raytpu_serve_disagg_handoffs_total`` must rise by one a handle
   request, the decode replica must prefill nothing and both replicas
   fall back never and launch nothing; the decode replica's streams are
   held to an in-process paged engine's as in (a). Then, with
   ``GLOBAL_CONFIG.disagg`` off in this process, one request must be
   answered with no handoff counted. Each replica's start, peak memory
   and engine step time, the HTTP latencies, the streamed chat's first
   byte and the tokens per second over HTTP are printed as one
   ``{"serve_app": ...}`` line, with the card line.
20. Device objects (``device_objects``), in phase 17's session after phase
   19: two actors at ``num_gpus=0.5`` each. (a) The producer turns
   ``enable_device_objects()`` on and returns a seeded 64 MiB bf16 CUDA
   tensor (phase 17's CUDA return, side by side): it must stay in the
   producer's store, and the consumer, given the return as an argument,
   must hold it on its card with the bits of the same seeded tensor, its
   ``transfer_stats()`` showing at least one pull and no fallback; with
   the fetch budget of 1 the producer's store must then be empty. (b) An
   explicit ``device_put`` (budget 0), ``device_get`` onto the consumer's
   card (timed there) and ``device_free``: kept until freed, then gone.
   (c) A multi-world handoff: the two actors join a two-rank gloo world
   (``make_mesh(MeshSpec(dp=2))``) and each keeps its row half of a seeded
   [8192, 4096] bf16 tensor (64 MiB) under ``P("dp", None)``; this process
   plans, has both arm and assembles the whole tensor on its card
   (``pull_and_assemble``): two pulls, no fallback, the bits equal. The
   ms and GB/s of each handoff are printed as one ``{"device_objects":
   ...}`` line. No kernel runs: the launch counts, zeroed just before
   the handoffs in this process and in both actors and read just after,
   must sum to 0.
21. The data tier feeding training (``train_data``), in the same session:
   ``TorchTrainer(datasets={"train": from_numpy(rows)})`` where ``rows``
   are seeded int32 tokens of shape [24, 1025]; one worker holding the
   ``GPU`` unit trains phase 10's GPT-2-125M ([8, 1024], ``remat="mlp"``,
   initial state seed 0) three steps on the batches of
   ``get_dataset_shard("train").iter_device_batches(batch_size=8)``. The
   losses must equal bit for bit those of the same rows through
   ``train_loop``'s in-process loop, with 12 + 12 launches every step,
   counted in the worker (``{"train_data": ...}``).
22. Batch inference as a data stage (``batch_data``), in the same session:
   ``from_items`` of phase 8's four prompts in two blocks through
   ``map_batches(build_llm_processor(...), resources={"GPU": 1})``,
   GPT-2-125M at the serve paths' shape on the dense cache: the stage
   holds the card, and its generated token ids and texts must equal the
   processor's called in this process on the same blocks (the token ids
   carry the check: ``ByteTokenizer`` decodes only ids below 256, so the
   random weights' texts are mostly empty, and the count of non-empty
   ones is printed). The flash_fwd launches of each block, zeroed just
   before its call and read just after in the stage's process, must be
   12 a fresh prefill that the block's call ran there;
   they and the stage's wall time are printed as one ``{"batch_data":
   ...}`` line.

Telemetry stays on (``GLOBAL_CONFIG`` of :mod:`ray_tpu_torch.core.config`)
for every phase but the A/B's "off" arm.

Prints one ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. Without a CUDA device it prints no result
and exits 1. Long output (nvcc's register report) goes to stderr.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import datetime
import functools
import json
import math
import os
import pickle
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import weakref
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ray_tpu_torch.core import faults
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.experimental import transfer as ptransfer
from ray_tpu_torch.llm import (ByteTokenizer, LLMConfig, LLMEngine, LLMServer, SamplingParams,
                               build_llm_processor, build_openai_app)
from ray_tpu_torch.llm import batch as llm_batch
from ray_tpu_torch.models import common, gpt2, llama, paged
from ray_tpu_torch.models.llama import LlamaConfig
from ray_tpu_torch.ops import _build, attention
from ray_tpu_torch.parallel import (
    DEFAULT_RULES,
    Mesh,
    MeshSpec,
    P,
    make_mesh,
    p2p_transport,
    shardings_from_logical,
)
from ray_tpu_torch.train import sharded_checkpoint, spmd
from ray_tpu_torch.util import flightrec, metrics

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its bytes over the memory rate and its operations over
# the bf16 tensor-core rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOP_PER_S = 989e12

# Kernel-vs-plain tolerances in bf16. O: both versions round p and O to
# bf16 (unit roundoff 2^-9) but the kernel rounds p against its running
# maximum, so single elements may differ by a few bf16 ulps of |O| <= ~5.
# LSE: f32 throughout, only the order of the sums differs.
O_TOL = 2e-2
LSE_TOL = 1e-2
# Backward kernel vs plain, as max abs error over the largest magnitude of
# each of dq, dk, dv: both round p and dS to bf16, but a one-ulp (2^-8)
# flip of either, from f32 sums in another order, moves a product summed
# over up to S rows, and each result is rounded to bf16 itself.
BWD_TOL = 2e-2
# Training step through the kernels vs through the plain attention (and
# loss_chunk=128 vs 0): the difference may be at most twice the one between
# the plain bf16 step and the plain f32 step, or these floors, whichever
# is larger (loss: absolute, near ln(50304) = 10.8; gradient norm: relative).
TRAIN_LOSS_TOL = 1e-2
TRAIN_GNORM_TOL = 2e-2

SERVE_SHAPES = [32, 128, 512, 1024, 2048, 100]  # prefill buckets + one ragged S
TP_RANK_HEADS = 6  # GPT-2-125M's heads on one rank of tensor_parallelism=2
HEADLINE_S = 1024
MAX_TOKENS = 32
TRAIN_B, TRAIN_S = 8, 1024  # bench.py's per-chip batch at max_seq
WARMUP_STEPS, TIMED_STEPS = 3, 10
# The reference's spec-decoding probe (tools/ray_perf.py:461-515).
SPEC_K, SPEC_STREAMS, SPEC_TOKENS = 4, 3, 200
KERNELS = ("flash_fwd", "flash_bwd")
# Telemetry A/B: alternating rounds of each arm, decode steps profiled per
# round, and the most the decode device time may move between the arms.
# A round's profiled window spans 24 of the 31 decode steps a request of
# MAX_TOKENS has. The check holds the device time of everything but the
# copies: the logits readback to pageable memory is staged through the
# host, and its recorded duration follows the host (3.9 to 9.2 ms in a
# window whose other device time held within 1 %).
AB_ROUNDS, AB_DECODE_STEPS, AB_DEVICE_TOL = 1, 24, 0.03
BATCH_PROMPTS = ["The quick brown fox", "Hello, world", "ray_tpu on the H100", "batch inference"]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Mean device time of one call, from CUDA events around ``iters``
    back-to-back calls after a warm-up. A spin kernel holds the stream
    while the host enqueues them, so the events bracket device work and
    not the host's launch rate (a call costs tens of microseconds of
    Python and ctypes, longer than the kernel itself at small S). The
    inputs stay in the 50 MB L2 between calls, as they are when prefill's
    QKV projection has just written them."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) * iters
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * min(2.0 * host_s + 0.01, 1.0)))  # ~2 GHz SM clock
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def qkv_views(S, dev, B=1, H=12, D=64, seed=0):
    """q, k, v as prefill and training hand them to the kernels: strided
    head views of one [B, S, 3*H*D] projection."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((B, S, 3 * H * D), generator=g, device=dev).to(torch.bfloat16)
    return [t.reshape(B, S, H, D).transpose(1, 2) for t in qkv.split(H * D, dim=-1)]


def gqa_layout(S, dev, B=1, H=12, KH=4, D=64, seed=0):
    """q, k, v as Llama's dense prefill hands them to the forward kernel: q
    contiguous [B, H, S, D] (it comes out of RoPE's concatenation), K/V
    contiguous [B, H, S, D] from ``repeat_interleave`` of KH heads."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, H, S, D), generator=g, device=dev).to(torch.bfloat16)
    k, v = (
        torch.randn((B, KH, S, D), generator=g, device=dev)
        .to(torch.bfloat16)
        .repeat_interleave(H // KH, dim=1)
        for _ in range(2)
    )
    return q, k, v


def grad_out(S, dev, B=1, H=12, D=64, seed=0):
    """dO as training hands it to the backward: the gradient of O, whose
    storage is [B, S, H, D], seen as [B, H, S, D]."""
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    return torch.randn((B, S, H, D), generator=g, device=dev).to(torch.bfloat16).transpose(1, 2)


def build_kernels() -> dict:
    """One nvcc per kernel source, all started together."""
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        built = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
    for b in built.values():
        log(f"--- nvcc {b.name}.cu ({b.seconds:.2f} s)\n{b.log.strip()}")
    return built


# SASS opcodes that show what a kernel executes: HGMMA (wgmma), UTMALDG and
# UTMASTG (TMA loads and stores), SYNCS (mbarrier operations), HMMA (mma.sync).
SASS_OPS = ("HGMMA", "UTMALDG", "UTMASTG", "SYNCS", "HMMA")


def parse_sass(text: str) -> dict:
    """Count SASS_OPS in each kernel function of a ``cuobjdump -sass`` listing."""
    counts: dict = {}
    fn = None
    for line in text.splitlines():
        if "Function :" in line:
            mangled = line.split("Function :")[1].strip()
            m = re.search(r"(flash_[a-z_]+_kernel)", mangled)
            fn = m[1] if m else mangled
            counts[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn is not None:
            op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)", line)
            if op and op[1] in counts[fn]:
                counts[fn][op[1]] += 1
    return counts


def sass_counts(lib: Path) -> dict | str:
    """Instructions of each kind in each kernel function of a built library,
    from ``cuobjdump -sass``; "not available" without the tool."""
    tool = shutil.which("cuobjdump") or str(Path(_build.nvcc_path()).parent / "cuobjdump")
    if not Path(tool).exists():
        return "not available"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        return "not available"
    return parse_sass(out.stdout)


def flash_bound_ms(B, H, S, D) -> tuple[float, str]:
    """Least time for a causal forward: q, k, v read once, O (bf16) and LSE
    (f32) written once; two products over the S(S+1)/2 causal pairs."""
    nbytes = 4 * B * H * S * D * 2 + B * H * S * 4
    flops = 2 * 2 * B * H * D * S * (S + 1) / 2
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_bwd_bound_ms(B, H, S, D) -> tuple[float, str]:
    """Least time for a causal backward: q, k, v, O and dO read once, dq, dk
    and dv written once (bf16), LSE and delta (f32); five products over the
    S(S+1)/2 causal pairs."""
    nbytes = 8 * B * H * S * D * 2 + 2 * B * H * S * 4
    flops = 10 * B * H * D * S * (S + 1) / 2
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_shapes():
    """(B, S) of every kernel check: the serving buckets at B=1, then the
    training shape."""
    return [(1, S) for S in SERVE_SHAPES] + [(TRAIN_B, TRAIN_S)]


def check_flash_kernel(dev) -> list[dict]:
    """The forward kernel against its plain version at every serving and
    training shape on GPT-2's strided head views, at B=1, S=1024 on
    Llama's layout (contiguous q, K/V expanded from 4 KV heads), and at
    B=1, S=1024 on one tensor-parallel rank's 6 heads of GPT-2 (serve_tp)."""
    rows = []
    cases = [("qkv_views", B, S, 12) for B, S in attention_shapes()]
    cases.append(("gqa_expanded", 1, HEADLINE_S, 12))
    cases.append(("qkv_views", 1, HEADLINE_S, TP_RANK_HEADS))
    for layout, B, S, H in cases:
        make = qkv_views if layout == "qkv_views" else gqa_layout
        q, k, v = make(S, dev, B=B, H=H, seed=S)
        scale = 1.0 / 8.0
        o, lse = attention.flash_attention_fwd(q, k, v, scale)
        torch.cuda.synchronize()
        o_ref, lse_ref = attention.flash_attention_fwd_reference(q, k, v, scale)
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        finite = bool(torch.isfinite(o.float()).all() and torch.isfinite(lse).all())
        iters = 200 if B * S <= 512 else 50
        ms = time_ms(lambda: attention.flash_attention_fwd(q, k, v, scale), iters)
        plain_ms = time_ms(lambda: attention.flash_attention_fwd_reference(q, k, v, scale), 10)
        library_ms = time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=scale), iters
        )
        bound_ms, bound_by = flash_bound_ms(B, H, S, 64)
        row = dict(layout=layout, B=B, H=H, S=S, max_abs_err=err_o, max_abs_err_lse=err_lse, ms=ms,
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=library_ms)
        log("flash_fwd", json.dumps(row))
        if not finite or err_o > O_TOL or err_lse > LSE_TOL:
            raise AssertionError(f"flash_fwd disagrees with its plain version: {row}")
        rows.append(row)
    return rows


def check_flash_bwd_kernel(dev) -> list[dict]:
    """The backward kernel against its plain version on the forward
    kernel's (o, lse), with strided q/k/v and a [B, S, H, D]-laid dO; and
    twice on the same inputs, which must give bit-equal gradients."""
    rows = []
    for B, S in attention_shapes():
        q, k, v = qkv_views(S, dev, B=B, seed=S)
        do = grad_out(S, dev, B=B, seed=S)
        scale = 1.0 / 8.0
        o, lse = attention.flash_attention_fwd(q, k, v, scale)
        got = attention.flash_attention_bwd(q, k, v, o, lse, do, scale)
        again = attention.flash_attention_bwd(q, k, v, o, lse, do, scale)
        torch.cuda.synchronize()
        want = attention.flash_attention_bwd_reference(q, k, v, o, lse, do, scale)
        abs_err = [(g.float() - w.float()).abs().max().item() for g, w in zip(got, want)]
        rel_err = [e / w.float().abs().max().item() for e, w in zip(abs_err, want)]
        finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
        deterministic = all(torch.equal(a, b) for a, b in zip(got, again))
        iters = 200 if B * S <= 512 else 50
        ms = time_ms(lambda: attention.flash_attention_bwd(q, k, v, o, lse, do, scale), iters)
        plain_ms = time_ms(
            lambda: attention.flash_attention_bwd_reference(q, k, v, o, lse, do, scale), 5
        )
        # The library's backward alone, on a graph built once.
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, is_causal=True, scale=scale)
        library_ms = time_ms(
            lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), iters
        )
        del out
        bound_ms, bound_by = flash_bwd_bound_ms(B, 12, S, 64)
        row = dict(B=B, S=S, max_abs_err=max(abs_err), max_rel_err=max(rel_err),
                   rel_err_dq_dk_dv=rel_err, deterministic=deterministic, ms=ms,
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=library_ms)
        log("flash_bwd", json.dumps(row))
        if not finite or not deterministic or max(rel_err) > BWD_TOL:
            raise AssertionError(f"flash_bwd disagrees with its plain version at B={B} S={S}: {row}")
        rows.append(row)
    return rows


# The serving paths, in order: (name, LLMConfig fields, flash_fwd launches
# per fresh prefill per layer). Each paged path follows the dense one of its
# family, whose plain-attention logits it is held against. The paged
# prefill and decode run no kernel, as the reference's run no Pallas kernel.
LLAMA_125M = LlamaConfig.llama_125m()
SERVE_PATHS = (
    ("serve", dict(kv_block_size=0), 1),
    ("serve_paged", dict(), 0),
    ("serve_llama", dict(model_config=LLAMA_125M, kv_block_size=0), 1),
    ("serve_llama_paged", dict(model_config=LLAMA_125M), 0),
)


def build_engine(fields: dict) -> LLMEngine:
    """An engine at the reference's default configuration (16 slots, 2048
    positions, buckets 32…2048, the paged pool unless ``kv_block_size=0``)
    for one model at full width, with random weights from seed 0."""
    engine = LLMEngine(LLMConfig(seed=0, **fields))
    cfg, c = engine.model_config, engine.config
    if isinstance(cfg, LlamaConfig):
        want = (12, 12, 4, 768, 2048, 32000)
        got = (cfg.n_layer, cfg.n_head, cfg.n_kv_head, cfg.d_model, cfg.d_ff, cfg.vocab_size)
    else:
        want = (12, 12, 12, 768, 3072, 50304)
        got = (cfg.n_layer, cfg.n_head, cfg.n_head, cfg.d_model, cfg.d_ff, cfg.vocab_size)
    assert got == want, cfg
    assert (c.max_slots, c.max_seq, engine.paged) == (16, 2048, "kv_block_size" not in fields)
    kh = want[2]
    if engine.paged:
        # 16 slots x 128 blocks, halved, plus the scratch block.
        assert engine.pool["k"].shape == (12, 1025, kh, 16, 64), engine.pool["k"].shape
    else:
        assert engine.cache["k"].shape == (12, 16, kh, 2048, 64), engine.cache["k"].shape
    return engine


def kv_bytes(engine) -> int:
    kv = engine.pool if engine.paged else engine.cache
    return sum(t.numel() * t.element_size() for t in kv.values())


def token_ids(rng, engine):
    """Random prompt ids below the model's real vocabulary (GPT-2's 50257
    inside its padded 50304; Llama's 32000)."""
    vocab = engine.model_config.vocab_size
    if engine._model is gpt2:
        vocab = min(vocab, 50257)
    return lambda n: rng.integers(0, vocab, n).tolist()


def llm_points() -> dict:
    """The port registry's raytpu_llm_* points, by (name, tags)."""
    return {(n, frozenset(t.items())): v for n, t, v in metrics.registry().snapshot()["points"]
            if n.startswith("raytpu_llm_")}


def begin_telemetry(engine) -> dict:
    """Empty the flight recorder's rings and keep the registry's points and
    the engine's stats, at the start of a window."""
    flightrec.reset()
    return dict(points=llm_points(), stats=dict(engine.stats))


def llm_events() -> list:
    ring = flightrec.snapshot(planes=["llm"])["rings"].get("llm", {"events": [], "dropped": 0})
    assert ring["dropped"] == 0, ring["dropped"]
    return ring["events"]


def hist_summary(name, points, before) -> dict:
    """Observations of one histogram in a window: count, sum, mean and the
    bucket bounds under which half and 95 % of them fall."""
    key = (name, frozenset())
    now = points.get(key)
    if now is None:
        return dict(count=0)
    old = before.get(key, dict(count=0, sum=0.0, buckets=[0] * len(now["buckets"])))
    count, total = now["count"] - old["count"], now["sum"] - old["sum"]
    bounds = metrics.registry().snapshot()["meta"][name]["boundaries"]
    buckets = [n - o for n, o in zip(now["buckets"], old["buckets"])]
    le = lambda q: next((1e3 * x for x, c in zip(bounds, buckets) if c >= q * count), None)  # noqa: E731
    return dict(count=count, sum_s=total, mean_ms=1e3 * total / count if count else None,
                p50_le_ms=le(0.5), p95_le_ms=le(0.95))


def phase_ms(events) -> dict:
    """Host time summed over each llm phase, and its event count."""
    out: dict = {}
    for e in events:
        ms, n = out.get(e["phase"], (0.0, 0))
        out[e["phase"]] = (ms + 1e3 * e["dur_s"], n + 1)
    return {k: dict(ms=ms, events=n) for k, (ms, n) in sorted(out.items())}


def check_telemetry(engine, start: dict, run: dict) -> dict:
    """The window's registry delta and llm ring against what the engine did
    (``run``, from :func:`drive`); fails unless every check holds."""
    points = llm_points()
    before = start["points"]

    def counter(name):
        key = (name, frozenset())
        return points.get(key, 0.0) - before.get(key, 0.0)

    def gauge(name):
        return points.get((name, frozenset({("replica", "local")})))

    events = llm_events()
    stats = {k: engine.stats[k] - start["stats"][k] for k in engine.stats}
    phases = [e["phase"] for e in events]
    ttft = hist_summary("raytpu_llm_ttft_seconds", points, before)
    itl = hist_summary("raytpu_llm_itl_seconds", points, before)
    prefill_events = [e for e in events if e["phase"] in ("llm.prefill", "llm.prefill_chunk")]
    checks = {
        "generated_tokens": (counter("raytpu_llm_generated_tokens_total"), stats["tokens_generated"]),
        "requests": (counter("raytpu_llm_requests_total"), run["requests"]),
        "prompt_tokens": (counter("raytpu_llm_prompt_tokens_total"), run["prompt_tokens"]),
        "ttft_count": (ttft["count"], run["first_tokens"]),
        # Every token after a request's first observes one inter-token
        # latency (a spec burst's later tokens observe 0.0).
        "itl_count": (itl["count"], stats["tokens_generated"] - run["first_tokens"]),
        "first_token_events": (phases.count("llm.first_token"), run["requests"]),
        "decode_step_events": (phases.count("llm.decode_step"), run["vanilla_decode_steps"]),
        "prefill_and_chunk_events": (len(prefill_events), run["prefill_calls"]),
        "prefill_chunk_events": (phases.count("llm.prefill_chunk"), stats["prefill_chunks"]),
        "prefill_chunks_counter": (counter("raytpu_llm_prefill_chunks_total"), stats["prefill_chunks"]),
        "prefill_event_tokens": (sum(e["extra"]["tokens"] for e in prefill_events),
                                 stats["prefill_tokens"]),
        "prefill_event_reused": (sum(e["extra"].get("reused", 0) for e in prefill_events),
                                 stats["prefix_tokens_reused"]),
    }
    if engine.stats["prefix_lookups"]:
        checks["prefix_hit_rate"] = (gauge("raytpu_llm_prefix_hit_rate"),
                                     engine.stats["prefix_hits"] / engine.stats["prefix_lookups"])
    if engine.paged:
        kv = engine.kv_stats()
        checks["kv_utilization"] = (gauge("raytpu_llm_kv_utilization"),
                                    kv["blocks_used"] / kv["blocks_total"])
    if engine._spec is not None:
        checks["spec_drafted"] = (counter("raytpu_llm_spec_drafted_total"), stats["spec_drafted"])
        checks["spec_accepted"] = (counter("raytpu_llm_spec_accepted_total"), stats["spec_accepted"])
        checks["spec_accept_rate"] = (gauge("raytpu_llm_spec_accept_rate"), engine._spec.accept_rate())
    failed = {k: v for k, v in checks.items() if v[0] != v[1]}
    assert not failed, f"telemetry disagrees with the engine: {failed}"
    assert all(e["dur_s"] >= 0.0 for e in events)
    return dict(switches={f: getattr(GLOBAL_CONFIG, f) for f in ("metrics_enabled", "flightrec",
                                                                  "spec_decode")},
                checks={k: v[0] for k, v in checks.items()}, all_checks_hold=True,
                ttft=ttft, itl=itl, host_phases=phase_ms(events))


def count_prefill_calls(engine) -> list:
    """Wrap the engine's three prefill bodies on the instance to count their
    calls (fresh, continued and paged prefills and chunks); returns the
    one-element counter. The wrappers hold the engine weakly: a cycle
    through its own attributes would keep a deleted engine's cache alive
    into the next path's peak memory."""
    calls, ref = [0], weakref.ref(engine)
    for name in ("_prefill_impl", "_prefill_cont_impl", "_pg_prefill_impl"):

        def counted(*a, _body=getattr(type(engine), name), **kw):
            calls[0] += 1
            return _body(ref(), *a, **kw)

        setattr(engine, name, counted)
    return calls


def drive(engine, prompts: dict, sampling, on_step=None) -> dict:
    """Admit ``prompts`` (request id -> prompt) and step ``engine`` until
    every request finishes, counting on the host what each step did: first
    tokens, vanilla decode steps (a step whose tokens are not all first
    tokens, and that ran no spec step), prefill calls, and the host time of
    steps that admitted nothing (each ends in its logits readback, so it is
    synchronised)."""
    calls = engine.__dict__.get("_prefill_calls")
    if calls is None:
        calls = engine._prefill_calls = count_prefill_calls(engine)
    calls0 = calls[0]
    reqs = {}
    for rid, p in prompts.items():
        engine.add_request(rid, p, sampling)
        reqs[rid] = engine.requests[rid]
    out = dict(requests=len(prompts), prompt_tokens=sum(len(r.prompt) for r in reqs.values()),
               first_tokens=0, vanilla_decode_steps=0, steps=0, decode_s=0.0, decode_steps=0,
               decode_tokens=0)
    finished = []
    while engine.has_unfinished():
        admitting = any(r.slot < 0 for r in engine.requests.values() if not r.finished)
        fresh = [r for r in reqs.values() if not r.generated]
        tok0, spec0 = engine.stats["tokens_generated"], engine.stats["spec_steps"]
        ts = time.perf_counter()
        finished += engine.step()
        dt = time.perf_counter() - ts
        firsts = sum(1 for r in fresh if r.generated)
        decoded = engine.stats["tokens_generated"] - tok0 - firsts
        out["steps"] += 1
        out["first_tokens"] += firsts
        if decoded and engine.stats["spec_steps"] == spec0:
            out["vanilla_decode_steps"] += 1
        if not admitting:
            out["decode_s"] += dt
            out["decode_steps"] += 1
            out["decode_tokens"] += engine.stats["tokens_generated"] - tok0
        if on_step is not None:
            on_step()
    out["prefill_calls"] = calls[0] - calls0
    out["finished"] = finished
    out["streams"] = {rid: list(r.generated) for rid, r in reqs.items()}
    return out


def serve_engine(engine, rng) -> dict:
    """One serving path: 6 requests of ~20 to ~1000 prompt tokens through
    ``engine``, two of them sharing a 64-token prefix, with the kernels'
    launch counts zeroed just before and read just after; then a lone
    1000-token prompt for its TTFT."""
    ids = token_ids(rng, engine)
    # Warm-up request (cuBLAS handles, allocator), not part of the run.
    warmup = ids(40)
    engine.generate([warmup], SamplingParams(max_tokens=2))

    prompts = traffic(engine, rng)  # shared_b hits shared_a's pooled 64-token prefix
    prefix = prompts["shared_a"][:64]
    hits0 = engine.stats["prefix_hits"]
    ttft0 = len(engine._ttft_window)
    shared_refcounts = []

    def check_sharing():
        b = engine.requests.get("shared_b")
        if engine.paged and b is not None and b.slot >= 0:
            # shared_b runs on shared_a's pooled prefix blocks, not a copy.
            entry = next(e for e in engine._prefix_pool.values() if e["tokens"] == tuple(prefix))
            assert b.blocks[: len(entry["blocks"])] == entry["blocks"], (b.blocks, entry)
            shared_refcounts.append(min(engine.block_mgr.refcount(x) for x in entry["blocks"]))

    start = begin_telemetry(engine)
    attention.flash_fwd_launches = attention.flash_bwd_launches = 0  # zeroed just before the path
    t0 = time.perf_counter()
    run = drive(engine, prompts, SamplingParams(max_tokens=MAX_TOKENS), check_sharing)
    wall_s = time.perf_counter() - t0
    launches = attention.flash_fwd_launches  # read just after
    bwd_launches = attention.flash_bwd_launches
    telemetry = check_telemetry(engine, start, run)
    finished, decode_s, decode_steps = run["finished"], run["decode_s"], run["decode_steps"]
    engine.pop_finished()

    hits = engine.stats["prefix_hits"] - hits0
    fresh = len(prompts) - hits
    by_id = {r.request_id: r for r in finished}
    assert set(by_id) == set(prompts), sorted(by_id)
    for rid, r in by_id.items():
        ok = len(r.generated) == MAX_TOKENS or r.generated[-1] == r.stop_token
        assert r.error is None and ok, (rid, r.error, len(r.generated))
        assert all(0 <= t < engine.model_config.vocab_size for t in r.generated), rid
    assert hits == 1, f"expected one prefix hit (shared_b), got {hits}"
    assert bwd_launches == 0, bwd_launches  # serving runs no backward
    paged_run = {}
    if engine.paged:
        pinned = set().union(*(e["blocks"] for e in engine._prefix_pool.values()))
        kv = engine.kv_stats()
        assert shared_refcounts and min(shared_refcounts) >= 2, shared_refcounts
        assert kv["blocks_used"] == len(pinned), (kv, len(pinned))  # only the pool's pins
        assert not engine.block_tables.any()
        paged_run = dict(shared_block_refcounts=sorted(set(shared_refcounts)),
                         blocks_pinned_after=len(pinned), kv_stats=kv)
    ttft_ms = [round(v * 1e3, 3) for _, v in list(engine._ttft_window)[ttft0:]]

    # One request alone on the idle engine: its TTFT is its own prefill.
    engine.add_request("alone1000", ids(1000), SamplingParams(max_tokens=1))
    engine.step()
    engine.pop_finished()
    alone_ttft_ms = engine._ttft_window[-1][1] * 1e3
    return dict(
        launches=launches, bwd_launches=bwd_launches, fresh_prefills=fresh,
        prefix_hits=hits, **paged_run,
        steps=run["steps"], wall_s=wall_s, ttft_ms_in_admission_order=ttft_ms,
        ttft_ms_alone_1000=alone_ttft_ms,
        decode_tok_s=run["decode_tokens"] / decode_s if decode_s else 0.0,
        decode_step_ms=1e3 * decode_s / decode_steps if decode_steps else 0.0,
        generated={rid: len(r.generated) for rid, r in by_id.items()},
        first_tokens={rid: r.generated[0] for rid, r in by_id.items()},
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        kv_gb=kv_bytes(engine) / 1e9,
        prompt=prompts["p300"],
        telemetry=telemetry,
        traffic=dict(warmup=warmup, prompts=prompts, streams=run["streams"]),
    )


def prefill_logits(engine, prompt, cfg, params) -> torch.Tensor:
    """First-token logits of ``prompt`` in the 512-row bucket the engine
    gives it: through the dense family's ``prefill`` on a fresh one-slot
    cache, or, for a paged engine, through ``paged_prefill`` on a fresh
    pool with the engine's table width."""
    T = len(prompt)
    toks = torch.tensor([prompt + [0] * (512 - T)], device=engine.device)
    if not engine.paged:
        cache = engine._decode_mod.init_kv_cache(cfg, 1, 512, device=engine.device)
        return engine._decode_mod.prefill(params, toks, torch.tensor([T], device=engine.device),
                                          cache, cfg)[1][0]
    bs = engine._block_size
    pool = paged.init_block_pool(cfg, 512 // bs + 1, bs, device=engine.device)
    table = torch.zeros(engine._table_width, dtype=torch.long, device=engine.device)
    table[: 512 // bs] = torch.arange(1, 512 // bs + 1)
    return paged.paged_prefill(params, toks, T, 0, table, pool, cfg, block_size=bs)[1]


def check_first_token_logits(engine, prompt, first_token, dense_check=None) -> dict:
    """First-token logits of one prompt, on the card, in bf16. A dense
    engine's own path (the kernel) is held against the plain attention, and
    the f32 run of the plain attention shows bf16's own noise floor. A paged
    engine's path is held against its family's dense plain-attention
    logits (``dense_check``, same weights from the same seed) for exact
    equality: both run the same plain products at the same rounding points,
    and the columns the paged row adds are masked, so any difference is a
    paging fault (a position read from or written to the wrong block)."""
    cfg = engine.model_config
    with torch.no_grad():
        got = prefill_logits(engine, prompt, cfg, engine._cparams)
        if dense_check is None:
            plain = prefill_logits(
                engine, prompt, dataclasses.replace(cfg, attn_impl="reference"), engine._cparams
            )
            plain_f32 = prefill_logits(
                engine, prompt,
                dataclasses.replace(cfg, attn_impl="reference", dtype=torch.float32),
                engine.params,
            )
            noise = (plain - plain_f32).abs().max().item()
            scale = plain_f32.abs().max().item()
        else:
            assert torch.equal(engine.params["wte"], dense_check["wte"]), "not the dense run's weights"
            plain, noise, scale = dense_check["plain"], dense_check["noise"], dense_check["scale"]
    for v in (got, plain):
        assert v.shape == (cfg.vocab_size,) and bool(torch.isfinite(v).all())
    diff = (got - plain).abs().max().item()
    # The kernel may move the logits by no more than bf16 itself does; paging
    # may not move them at all.
    tol = max(2.0 * noise, 2e-2) if dense_check is None else 0.0
    assert int(got.argmax()) == first_token, "engine's first token != its path's argmax"
    assert diff <= tol, f"first-token logits: engine path vs plain {diff} > {tol}"
    out = dict(max_abs_diff=diff, bf16_vs_f32=noise, tol=tol, max_abs_logit=scale,
               argmax_equal=int(got.argmax()) == int(plain.argmax()))
    keep = dict(plain=plain, noise=noise, scale=scale, wte=engine.params["wte"])
    return out, keep


# Device kernels by kind, from the first matching substring of their names.
KERNEL_KINDS = (
    ("flash_fwd", "flash_fwd"), ("flash_bwd", "flash_bwd"),
    ("gemm", "nvjet"), ("gemm", "gemm"), ("gemm", "cutlass"), ("gemm", "xmma"),
    ("memcpy", "Memcpy"), ("memcpy", "Memset"),
    ("reduce", "reduce_kernel"), ("softmax", "softmax"),
    ("elementwise", "elementwise"), ("elementwise", "copy_kern"),
)


def kernel_kind(name: str) -> str:
    return next((kind for kind, key in KERNEL_KINDS if key in name), "other")


def profile_window(run, steps: int) -> dict:
    """Wall time, device busy time and share, and the heaviest kernels of
    ``steps`` calls of ``run``, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
    device_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    by_kind: dict = {}
    for name, (ms, n) in by_name.items():
        kind_ms, kind_n = by_kind.get(kernel_kind(name), (0.0, 0))
        by_kind[kernel_kind(name)] = (kind_ms + ms, kind_n + n)
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:6]
    return dict(
        steps=steps, wall_ms=wall_ms, device_ms=device_ms,
        busy_share=device_ms / wall_ms if wall_ms else None,
        device_kernels=sum(n for _, n in by_name.values()),
        device_ms_by_kind={k: dict(ms=ms, calls=n) for k, (ms, n) in
                           sorted(by_kind.items(), key=lambda kv: -kv[1][0])},
        top_kernels=[dict(name=k[:80], ms=ms, calls=n) for k, (ms, n) in top],
        top_host_ops=[dict(name=e.key[:60], self_ms=e.self_cpu_time_total / 1e3, calls=e.count)
                      for e in host],
    )


def profile_engine(engine, rng) -> dict:
    """Where a step's time goes, over (a) one step that prefills a
    1000-token prompt on an idle engine and decodes it once, and (b) 8
    decode steps with 6 requests in flight."""
    ids = token_ids(rng, engine)
    window = functools.partial(profile_window, engine.step)

    engine.add_request("prof-prefill", ids(1000), SamplingParams(max_tokens=2))
    flightrec.reset()
    prefill = window(1)
    prefill["host_phases"] = phase_ms(llm_events())  # the same window's flight recorder
    while engine.has_unfinished():
        engine.step()
    for i in range(6):
        engine.add_request(f"prof-{i}", ids(100), SamplingParams(max_tokens=16))
    engine.step()  # admissions
    flightrec.reset()
    decode = window(8)
    decode["host_phases"] = phase_ms(llm_events())
    while engine.has_unfinished():
        engine.step()
    engine.pop_finished()
    return dict(prefill_1000=prefill, decode_6_active=decode)


PROFILED_PHASES = ("llm.prefill", "llm.prefill_chunk", "llm.decode_step")


def profiled_phases(prof: dict) -> dict:
    """Each profiled window's device time beside the host time that the
    flight recorder's prefill and decode phases summed over the same window
    (a first-token phase there would span the time since admission, which
    includes the profiler's start)."""
    return {name: dict(device_ms=w["device_ms"], wall_ms=w["wall_ms"],
                       host_phases={k: v for k, v in w["host_phases"].items() if k in PROFILED_PHASES})
            for name, w in prof.items()}


def traffic(engine, rng) -> dict:
    """The serving paths' 6 requests: ~20 to ~1000 prompt tokens, two of
    them sharing a 64-token prefix."""
    ids = token_ids(rng, engine)
    prefix = ids(64)
    return {"p20": ids(20), "p100": ids(100), "p300": ids(300), "p1000": ids(1000),
            "shared_a": prefix + ids(30), "shared_b": prefix + ids(50)}


def median(xs):
    return float(np.median(xs))


def telemetry_ab(engine, per_layer: int) -> dict:
    """The telemetry switches' A/B on one engine: the serving traffic with
    ``metrics_enabled`` and ``flightrec`` off, then on, AB_ROUNDS times in
    turn, after one warm-up round that fills the prefix pool (so that every
    round sees the same pool and runs the same prefills). Each round
    times the traffic on the host clock, then runs it again and profiles
    AB_DECODE_STEPS decode steps at 6 active slots. The greedy streams must
    be identical between arms and the decode device time other than the
    copies (``compute_ms``) may move by no more than AB_DEVICE_TOL; the
    whole device time is printed beside it."""
    prompts = traffic(engine, np.random.default_rng(2))
    sampling = SamplingParams(max_tokens=MAX_TOKENS)

    def one_round(tag: str, on: bool) -> dict:
        GLOBAL_CONFIG.metrics_enabled = GLOBAL_CONFIG.flightrec = on
        try:
            timed = drive(engine, {f"{tag}-{k}": p for k, p in prompts.items()}, sampling)
            engine.pop_finished()
            for k, p in prompts.items():
                engine.add_request(f"{tag}-prof-{k}", p, sampling)
            engine.step()  # admissions
            prof = profile_window(engine.step, AB_DECODE_STEPS)
            while engine.has_unfinished():
                engine.step()
            prof_streams = {r.request_id: r.generated for r in engine.pop_finished()}
        finally:
            GLOBAL_CONFIG.metrics_enabled = GLOBAL_CONFIG.flightrec = True
        return dict(
            streams=[timed["streams"][f"{tag}-{k}"] for k in prompts],
            profiled_streams=[prof_streams[f"{tag}-prof-{k}"] for k in prompts],
            decode_tok_s=timed["decode_tokens"] / timed["decode_s"],
            host_ms_per_step=1e3 * timed["decode_s"] / timed["decode_steps"],
            device_ms=prof["device_ms"], profiled_wall_ms=prof["wall_ms"],
            memcpy_ms=prof["device_ms_by_kind"].get("memcpy", {}).get("ms", 0.0),
            compute_ms=prof["device_ms"] - prof["device_ms_by_kind"].get("memcpy", {}).get("ms", 0.0),
        )

    one_round("ab-warm", True)
    calls0, hits0 = engine._prefill_calls[0], engine.stats["prefix_hits"]
    attention.flash_fwd_launches = attention.flash_bwd_launches = 0  # zeroed just before the A/B
    rounds = [one_round(f"ab{i}-{arm}", arm == "on") for i in range(AB_ROUNDS) for arm in ("off", "on")]
    launches = attention.flash_fwd_launches  # read just after
    bwd_launches = attention.flash_bwd_launches
    fresh = engine._prefill_calls[0] - calls0 - (engine.stats["prefix_hits"] - hits0)
    assert launches == per_layer * engine.model_config.n_layer * fresh, (launches, fresh)
    assert bwd_launches == 0, bwd_launches
    for key in ("streams", "profiled_streams"):
        assert all(r[key] == rounds[0][key] for r in rounds), f"A/B: {key} differ between rounds"
    arms = {}
    for arm, rs in (("off", rounds[0::2]), ("on", rounds[1::2])):
        arms[arm] = {k: [r[k] for r in rs] for k in ("decode_tok_s", "host_ms_per_step", "device_ms",
                                                    "profiled_wall_ms", "memcpy_ms", "compute_ms")}
        arms[arm].update({f"median_{k}": median(v) for k, v in list(arms[arm].items())})
    moved = arms["on"]["median_compute_ms"] / arms["off"]["median_compute_ms"] - 1.0
    assert abs(moved) <= AB_DEVICE_TOL, f"A/B: decode device time moved {moved:+.4f}"
    return dict(rounds=AB_ROUNDS, order="off,on alternating", decode_steps_profiled=AB_DECODE_STEPS,
                arms=arms, compute_ms_moved=moved, device_tol=AB_DEVICE_TOL,
                device_ms_moved=arms["on"]["median_device_ms"] / arms["off"]["median_device_ms"] - 1.0,
                host_ms_per_step_on_over_off=arms["on"]["median_host_ms_per_step"]
                / arms["off"]["median_host_ms_per_step"],
                streams_identical=True, launches=launches, bwd_launches=bwd_launches,
                fresh_prefills=fresh)


def batch_path() -> dict:
    """``build_llm_processor`` on GPT-2-125M (the default config: paged KV,
    16 slots x 2048 positions, seed 0): one batch of 4 prompts through the
    processor twice, which must reuse its cached engine; its texts must
    equal that engine's ``generate``."""
    config = LLMConfig(seed=0)
    sampling = SamplingParams(max_tokens=MAX_TOKENS)
    proc = build_llm_processor(config, sampling=sampling)
    batch = {"prompt": BATCH_PROMPTS, "id": list(range(len(BATCH_PROMPTS)))}
    n0 = len(llm_batch._ENGINE_CACHE)
    requests0 = llm_points().get(("raytpu_llm_requests_total", frozenset()), 0.0)
    attention.flash_fwd_launches = attention.flash_bwd_launches = 0  # zeroed just before the path
    t0 = time.perf_counter()
    first = proc(batch)  # builds the engine
    first_s = time.perf_counter() - t0
    engine = llm_batch._engine_for(config, "cuda")
    t0 = time.perf_counter()
    second = proc(batch)
    second_s = time.perf_counter() - t0
    launches = attention.flash_fwd_launches  # read just after
    bwd_launches = attention.flash_bwd_launches
    requests = llm_points()[("raytpu_llm_requests_total", frozenset())] - requests0
    assert llm_batch._engine_for(config, "cuda") is engine, "the processor built a second engine"
    assert len(llm_batch._ENGINE_CACHE) == n0 + 1
    texts = [o["text"] for o in engine.generate(BATCH_PROMPTS, sampling)]
    assert first["generated_text"] == second["generated_text"] == texts, (first, second, texts)
    assert first["id"] == batch["id"] and len(texts) == len(BATCH_PROMPTS)
    assert requests == 2 * len(BATCH_PROMPTS), requests
    assert engine.paged and (launches, bwd_launches) == (0, 0), (launches, bwd_launches)
    llm_batch._ENGINE_CACHE.clear()
    return dict(model="GPT2Config", paged=True, prompts=len(BATCH_PROMPTS), calls=2,
                engine_reused=True, texts_equal_generate=True, first_call_s=first_s,
                second_call_s=second_s, requests_counted=requests, launches=launches,
                bwd_launches=bwd_launches, texts=texts)


# Disaggregated serving (disagg): per family, a prefill-only engine A, a
# decode engine B (chunked prefill on, for the severed pull's fallback), a
# unified engine C; C2, unified with B's chunking, for the severed request;
# D, a dense engine for the re-prefill of a handoff.
DISAGG_FAMILIES = (("gpt2", dict()), ("llama", dict(model_config=LLAMA_125M)))
DISAGG_CHUNK = 256
DISAGG_SEVER_SEED = 7


def kv_ship_bytes() -> float:
    return sum(v for n, _t, v in metrics.registry().snapshot()["points"]
               if n == "raytpu_llm_kv_ship_bytes_total")


def handoff_bytes(engine, prompt_len: int) -> int:
    """2 * L * nb_pad * KH * bs * Dh * itemsize: the stack one handoff of a
    ``prompt_len``-token prompt ships (nb_pad: its blocks padded to a power
    of two)."""
    cfg, bs = engine.model_config, engine._block_size
    nb = -(-prompt_len // bs)
    nb_pad = 1 << (nb - 1).bit_length()
    kh = getattr(cfg, "n_kv_head", cfg.n_head)
    return 2 * cfg.n_layer * nb_pad * kh * bs * cfg.head_dim * torch.finfo(cfg.dtype).bits // 8


def prefill_handoffs(engine, prompts: dict, sampling) -> dict:
    """Prefill-only requests on ``engine``: request id -> handoff dict."""
    for rid, p in prompts.items():
        engine.add_request(rid, p, sampling, prefill_only=True)
    while engine.has_unfinished():
        engine.step()
    done = {r.request_id: r for r in engine.pop_finished()}
    assert all(r.error is None and r.handoff_out is not None for r in done.values()), done
    return {rid: done[rid].handoff_out for rid in prompts}


def decode_handoffs(engine, handoffs: dict, sampling) -> dict:
    """Handoff admissions on ``engine``, stepped to the end: request id ->
    its stream."""
    for rid, h in handoffs.items():
        engine.add_handoff_request(rid, h, sampling)
    steps = 0
    while engine.has_unfinished():
        engine.step()
        steps += 1
        assert steps < 10_000, "handoff decode does not converge"
    done = {r.request_id: r for r in engine.pop_finished()}
    assert all(r.error is None for r in done.values())
    return {rid: list(done[rid].generated) for rid in handoffs}


def disagg_family(name: str, fields: dict) -> dict:
    """One family's disaggregated serving at full width on the paged cache
    (the reference engine's default shape): serve's 6-request traffic
    prefilled on A and decoded on B from the handoffs, with the launch
    counts zeroed just before and read just after; B's streams equal to
    C's exactly, with no prefill on B, no fallback and 6 handoffs in; the
    shipped bytes of each handoff 2 * L * nb_pad * KH * bs * Dh * 2; then
    one request under a seeded kvship.sever (B's chunked local prefill,
    C2's tokens) and one handoff to a dense engine (a re-prefill: n_layer
    flash_fwd launches)."""
    sampling = SamplingParams(max_tokens=MAX_TOKENS)
    A, B, C = build_engine(fields), build_engine(dict(fields, prefill_chunk_tokens=DISAGG_CHUNK)), \
        build_engine(fields)
    rng = np.random.default_rng(0)
    ids = token_ids(rng, A)
    warm = {"warm": ids(40)}  # cuBLAS handles, allocator, the fabric's server
    decode_handoffs(B, prefill_handoffs(A, warm, SamplingParams(max_tokens=2)), SamplingParams(max_tokens=2))
    C.generate(list(warm.values()), SamplingParams(max_tokens=2))
    prompts = traffic(A, rng)
    want = drive(C, prompts, sampling)["streams"]
    C.pop_finished()
    stats_a, stats_b = dict(A.stats), dict(B.stats)
    flightrec.reset()
    shipped0 = kv_ship_bytes()
    attention.flash_fwd_launches = attention.flash_bwd_launches = 0  # zeroed just before the path
    t0 = time.perf_counter()
    handoffs = prefill_handoffs(A, prompts, sampling)
    got = decode_handoffs(B, handoffs, sampling)
    wall_s = time.perf_counter() - t0
    launches = (attention.flash_fwd_launches, attention.flash_bwd_launches)  # read just after
    events = llm_events()
    shipped = kv_ship_bytes() - shipped0
    d_a = {k: A.stats[k] - stats_a[k] for k in A.stats}
    d_b = {k: B.stats[k] - stats_b[k] for k in B.stats}
    assert got == want, f"disagg {name}: B's streams differ from the unified engine's"
    assert d_b["prefill_tokens"] == 0 and d_b["kv_fallbacks"] == 0, d_b
    assert d_b["handoffs_in"] == len(prompts) == d_a["handoffs_out"], (d_a, d_b)
    assert launches == (0, 0), launches  # the paged path runs no kernel
    per = {rid: handoff_bytes(A, len(p)) for rid, p in prompts.items()}
    for rid, h in handoffs.items():
        shape = h["kv"]["shape"]
        assert math.prod(shape) * torch.finfo(A.model_config.dtype).bits // 8 == per[rid], (rid, shape)
    assert shipped == sum(per.values()), (shipped, per)

    def leg_ms(phase):
        return [1e3 * e["dur_s"] for e in events if e["phase"] == phase]

    exports, pulls = leg_ms("llm.kv_export"), leg_ms("llm.kv_pull")
    assert len(exports) == len(pulls) == len(prompts), (len(exports), len(pulls))
    assert all(e["extra"]["ok"] for e in events if e["phase"] == "llm.kv_pull")

    # One request again under a seeded sever: B falls back to local chunked
    # prefill; C2 (unified, B's chunking) serves it too.
    sever = {"p1000": prompts["p1000"]}
    h = prefill_handoffs(A, sever, sampling)
    stats_b = dict(B.stats)
    faults.install(faults.parse_spec(DISAGG_SEVER_SEED, "kvship.sever"))
    try:
        severed = decode_handoffs(B, h, sampling)
    finally:
        faults.clear()
    d_sever = {k: B.stats[k] - stats_b[k] for k in B.stats}
    del C
    torch.cuda.empty_cache()
    C2 = build_engine(dict(fields, prefill_chunk_tokens=DISAGG_CHUNK))
    C2.generate(list(warm.values()), SamplingParams(max_tokens=2))
    chunked = drive(C2, sever, sampling)["streams"]
    assert severed == chunked, f"disagg {name}: the severed request's tokens differ from C2's"
    assert d_sever["kv_fallbacks"] == 1 and d_sever["handoffs_in"] == 0, d_sever
    assert d_sever["prefill_tokens"] == len(sever["p1000"]) and d_sever["prefill_chunks"] >= 2, d_sever
    del C2
    torch.cuda.empty_cache()

    # One handoff to a dense engine: it re-prefills, through the kernel.
    D = build_engine(dict(fields, kv_block_size=0))
    D.generate(list(warm.values()), SamplingParams(max_tokens=2))
    h = prefill_handoffs(A, {"p300": prompts["p300"]}, sampling)
    stats_d = dict(D.stats)
    attention.flash_fwd_launches = attention.flash_bwd_launches = 0  # zeroed just before
    dense = decode_handoffs(D, h, sampling)
    dense_launches = (attention.flash_fwd_launches, attention.flash_bwd_launches)  # read just after
    d_d = {k: D.stats[k] - stats_d[k] for k in D.stats}
    L = A.model_config.n_layer
    assert dense_launches == (L, 0), dense_launches
    assert d_d["prefill_tokens"] == len(prompts["p300"]) and d_d["handoffs_in"] == 0, d_d
    del A, B, D
    torch.cuda.empty_cache()
    return dict(
        model=name, paged=True, requests=len(prompts), streams_equal_unified=True,
        decode_engine=dict(prefill_tokens=d_b["prefill_tokens"], kv_fallbacks=d_b["kv_fallbacks"],
                           handoffs_in=d_b["handoffs_in"]),
        bytes_per_handoff=per, bytes_shipped=shipped, bytes_p1000=per["p1000"],
        kv_export_ms=dict(median=median(exports), max=max(exports)),
        kv_pull_ms=dict(median=median(pulls), max=max(pulls)),
        pull_gb_s_p1000=per["p1000"] / 1e6 / pulls[list(prompts).index("p1000")],
        wall_s=wall_s, launches=launches[0], bwd_launches=launches[1],
        sever=dict(seed=DISAGG_SEVER_SEED, kv_fallbacks=d_sever["kv_fallbacks"],
                   prefill_chunks=d_sever["prefill_chunks"], tokens_equal_unified_chunked=True,
                   tokens_equal_unified=severed["p1000"] == want["p1000"]),
        dense_reprefill=dict(launches=dense_launches[0], prefill_tokens=d_d["prefill_tokens"],
                             tokens_equal_paged_unified=dense["p300"] == want["p300"]),
    )


def disagg_path(card: str) -> dict:
    """Both families (see disagg_family); the kernels line's ``disagg``
    launches are the dense re-prefills' (the handoff path itself launches
    none)."""
    t0 = time.perf_counter()
    fams = {name: disagg_family(name, fields) for name, fields in DISAGG_FAMILIES}
    launches = sum(f["launches"] + f["dense_reprefill"]["launches"] for f in fams.values())
    return dict(card=card, families=fams, launches=launches, bwd_launches=0,
                transport=ptransfer.transfer_stats()["transport"], phase_s=time.perf_counter() - t0)


def model_of(cfg):
    return llama if isinstance(cfg, LlamaConfig) else gpt2


def loss_and_grad_norm(cfg, params, batch) -> tuple[float, float]:
    """One forward and backward of the family's ``loss_fn``: the loss and
    the global gradient norm over every parameter."""
    loss, _ = model_of(cfg).loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, spmd.tree_leaves(params))
    norm = torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()
    return loss.item(), norm.item()


def train_config() -> "gpt2.GPT2Config":
    """GPT-2-125M at full width as bench.py's first candidate trains it:
    loss_chunk=0, the default remat="mlp", bf16 activations, f32 masters."""
    cfg = dataclasses.replace(gpt2.GPT2Config.gpt2_125m(), loss_chunk=0)
    assert (cfg.n_layer, cfg.n_head, cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.max_seq) == (
        12, 12, 768, 3072, 50304, TRAIN_S
    ), cfg
    assert cfg.remat == "mlp" and cfg.dtype == torch.bfloat16 and cfg.param_dtype == torch.float32
    return cfg


def moe_train_config() -> "gpt2.GPT2Config":
    """GPT-2-125M's widths with 4 experts in each block, at the reference's
    MoE test setting (capacity 1.5, aux weight 0.01,
    tests/test_parallel_pp_ep.py:88), trained as train_config() is:
    loss_chunk=0 and remat="mlp", which resolves to "dots" under MoE."""
    cfg = dataclasses.replace(
        train_config(), n_experts=4, expert_capacity_factor=1.5, moe_aux_weight=0.01
    )
    assert (cfg.n_experts, cfg.loss_chunk, cfg.remat) == (4, 0, "mlp"), cfg
    return cfg


def moe_pp_train_config() -> "gpt2.GPT2Config":
    """moe_train_config() as the reference gate's pipelined MoE runs
    (__graft_entry__.py:189-197): GPipe over pp with 2 microbatches."""
    return dataclasses.replace(moe_train_config(), pipeline_microbatches=2)


def llama_train_config() -> LlamaConfig:
    """Llama-125M at full width with its defaults: remat="mlp",
    loss_chunk=128, bf16 activations, f32 masters."""
    cfg = LlamaConfig.llama_125m()
    assert (cfg.n_layer, cfg.n_head, cfg.n_kv_head, cfg.d_model, cfg.d_ff, cfg.vocab_size,
            cfg.max_seq) == (12, 12, 4, 768, 2048, 32000, TRAIN_S), cfg
    assert cfg.remat == "mlp" and cfg.loss_chunk == 128
    assert cfg.dtype == torch.bfloat16 and cfg.param_dtype == torch.float32
    return cfg


def train_setup(dev, cfg):
    """The training path's model module, batch (seed 1), optimizer and
    initial state (seed 0) on ``dev``."""
    model = model_of(cfg)
    g = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_B, cfg.max_seq), generator=g, device=dev)
    batch = {"tokens": tokens, "targets": tokens.roll(-1, dims=1)}
    opt = spmd.default_optimizer(warmup_steps=2, total_steps=20)
    state = spmd.make_train_state(
        functools.partial(model.init_params, cfg=cfg, device=dev), opt,
        torch.Generator(device=dev).manual_seed(0), device=dev,
    )
    return model, batch, opt, state


def train_path(dev, cfg) -> dict:
    """The training path on one GPU: make_train_step over the family's
    loss_fn with default_optimizer, driven as bench.py drives the JAX step
    (batch [TRAIN_B, max_seq], targets = tokens rolled by one)."""
    model, batch, opt, state = train_setup(dev, cfg)
    tokens = batch["tokens"]

    # One step from the initial params through the kernels, through the
    # plain attention (bf16, and f32 for bf16's own noise floor), and with
    # the other loss (chunked against unchunked).
    params = state["params"]
    other_chunk = 0 if cfg.loss_chunk else 128
    other = f"loss_chunk_{other_chunk}"
    checks = {
        "kernel": loss_and_grad_norm(cfg, params, batch),
        "plain": loss_and_grad_norm(dataclasses.replace(cfg, attn_impl="reference"), params, batch),
        "plain_f32": loss_and_grad_norm(
            dataclasses.replace(cfg, attn_impl="reference", dtype=torch.float32), params, batch
        ),
        other: loss_and_grad_norm(dataclasses.replace(cfg, loss_chunk=other_chunk), params, batch),
    }
    (l_k, n_k), (l_p, n_p), (l_32, n_32) = checks["kernel"], checks["plain"], checks["plain_f32"]
    loss_tol = max(2 * abs(l_p - l_32), TRAIN_LOSS_TOL)
    gnorm_tol = max(2 * abs(n_p - n_32) / n_32, TRAIN_GNORM_TOL)
    for name in ("plain", other):
        l_x, n_x = checks[name]
        assert abs(l_k - l_x) <= loss_tol, f"loss: kernel {l_k} vs {name} {l_x} (tol {loss_tol})"
        assert abs(n_k - n_x) / n_x <= gnorm_tol, f"grad norm: kernel {n_k} vs {name} {n_x}"
    log("train checks", json.dumps(checks))

    step = spmd.make_train_step(functools.partial(model.loss_fn, cfg=cfg), opt)
    out = timed_steps(step, state, batch)
    n_experts = getattr(cfg, "n_experts", 0)
    policy, per_step = launches_per_step(cfg, tokens, out["launches"])
    if n_experts:
        assert all(math.isfinite(x) for x in out["moe_aux"]), out["moe_aux"]
        out["routed_share"] = routed_share(cfg, state["params"], tokens)
    return dict(
        model=type(cfg).__name__, n_experts=n_experts, batch=list(tokens.shape), remat=policy,
        loss_chunk=cfg.loss_chunk, checks=checks, loss_tol=loss_tol, gnorm_tol=gnorm_tol,
        launches_per_step=per_step, **out,
        profile_one_step=profile_window(lambda: step(state, batch), 1),
    )


def launches_per_step(cfg, tokens, launches) -> tuple[str, dict]:
    """The remat policy a training step runs and its kernel launches a
    step, checked against ``launches`` over TIMED_STEPS steps. "mlp" keeps
    the flash forward's residuals; under MoE it is "dots"
    (ray_tpu/models/gpt2.py:334), and attention's forward runs again in
    backward."""
    policy = common.remat_policy(cfg, tokens)
    assert policy == ("dots" if getattr(cfg, "n_experts", 0) else "mlp"), policy
    per_step = {"flash_fwd": cfg.n_layer * (2 if policy in ("full", "dots") else 1),
                "flash_bwd": cfg.n_layer}
    assert launches == {k: n * TIMED_STEPS for k, n in per_step.items()}, launches
    return policy, per_step


def timed_steps(step, state, batch) -> dict:
    """WARMUP_STEPS steps, then TIMED_STEPS on the host clock with the
    launch counts zeroed just before and read just after; the losses (and
    the MoE aux) of all of them must be finite and the loss must fall."""
    step0 = state["step"]
    metrics = [step(state, batch)[1] for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attention.flash_fwd_launches = attention.flash_bwd_launches = 0  # zeroed just before the path
    t0 = time.perf_counter()
    metrics += [step(state, batch)[1] for _ in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"flash_fwd": attention.flash_fwd_launches,  # read just after
                "flash_bwd": attention.flash_bwd_launches}
    losses = [m["loss"].item() for m in metrics]
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], f"the loss did not fall: {losses}"
    assert state["step"] == step0 + WARMUP_STEPS + TIMED_STEPS
    tokens = batch["tokens"].numel()
    out = dict(launches=launches, timed_steps=TIMED_STEPS, seconds=seconds,
               ms_per_step=1e3 * seconds / TIMED_STEPS, tok_s=tokens * TIMED_STEPS / seconds,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, losses=losses)
    if "moe_aux" in metrics[0]:
        out["moe_aux"] = [m["moe_aux"].item() for m in metrics]
    return out


def routed_share(cfg, params, tokens) -> list[float]:
    """Per MoE layer, the share of the batch's tokens that an expert served
    (the rest were over capacity), from one forward without grad: the
    router's per-expert counts, each capped at the capacity."""
    shares, inner = [], gpt2._moe_sublayer

    def counting(x, p, cfg, mesh, routing):
        h = gpt2._layer_norm(x, p["ln2_scale"], p["ln2_bias"]).reshape(-1, x.shape[-1])
        probs = torch.softmax((h.to(cfg.dtype) @ p["gate_w"].to(cfg.dtype)).float(), dim=-1)
        n = probs.shape[0]
        cap = max(int(cfg.expert_capacity_factor * n / cfg.n_experts), 1)
        counts = torch.bincount(probs.argmax(-1), minlength=cfg.n_experts)
        shares.append(counts.clamp(max=cap).sum().item() / n)
        return inner(x, p, cfg, mesh, routing)

    gpt2._moe_sublayer = counting
    try:
        with torch.no_grad():
            gpt2.hidden(params, tokens, cfg)
    finally:
        gpt2._moe_sublayer = inner
    assert len(shares) == cfg.n_layer and all(0.0 < s <= 1.0 for s in shares), shares
    return shares


# The mesh path: bench.py:110-131's call sequence on the port. At world
# size 1 (one card) over NCCL, each sharded step must equal the unsharded
# one exactly (train_mesh).
MESH_JOIN_S = 600

# The sharded cases (train_shard): name -> (config, MeshSpec fields, global
# batch rows, batch spec). Each runs one process per rank: over NCCL one
# rank per card where the machine has a card for every rank, else every
# rank on card 0 over a gloo group (NCCL refuses two ranks on one device).
# Each is held to the unsharded step on card 0 within the training
# tolerances. The dp and ep cases are the parallel layer's first slice's;
# the last three run the sp axis (ring attention, the reference gate's
# batch spec) and the pp axis (GPipe, the experts of each stage over ep).
ROW_SPEC = (("dp", "fsdp"),)
SEQ_SPEC = (("dp", "fsdp"), "sp")  # __graft_entry__.py:159
SHARD_CASES = {
    "gpt2_tp2": (train_config, dict(tp=2), TRAIN_B, ROW_SPEC),
    "llama_fsdp2_tp2": (llama_train_config, dict(fsdp=2, tp=2), TRAIN_B, ROW_SPEC),
    "moe_tp2": (moe_train_config, dict(tp=2), TRAIN_B, ROW_SPEC),
    "dp2": (train_config, dict(dp=2), 2 * TRAIN_B, ROW_SPEC),
    "ep2": (moe_train_config, dict(ep=2), TRAIN_B, ROW_SPEC),
    "gpt2_sp2_tp2": (train_config, dict(sp=2, tp=2), TRAIN_B, SEQ_SPEC),
    "llama_fsdp2_sp2": (llama_train_config, dict(fsdp=2, sp=2), TRAIN_B, SEQ_SPEC),
    "moe_pp2_ep2": (moe_pp_train_config, dict(pp=2, ep=2), TRAIN_B, ROW_SPEC),
    "gpt2_fsdp2_tp2_ckpt": (train_config, dict(fsdp=2, tp=2), TRAIN_B, ROW_SPEC),
}
SEQ_PIPE_CASES = ("gpt2_sp2_tp2", "llama_fsdp2_sp2", "moe_pp2_ep2")
# The sharded-checkpoint case: saved after its step under its own mesh,
# restored onto this layout (and onto its own), one more step on each.
CKPT_CASES = {"gpt2_fsdp2_tp2_ckpt": dict(dp=2, tp=2)}


def shard_launches(cfg, spec: dict, rows: int) -> dict:
    """Flash launches of one rank's full step of a sharded case. Where the
    sequence is split over sp outside a pipeline, attention runs over the
    ring and no kernel; otherwise a rank runs its stage's n_layer/pp
    layers once for each of its microbatches (GPipe skips the bubble
    steps), the forward again in backward where the policy is "dots"
    (MoE)."""
    mesh = MeshSpec(**spec)
    if mesh.sp > 1 and cfg.max_seq % mesh.sp == 0 and mesh.pp == 1:
        return {"flash_fwd": 0, "flash_bwd": 0}
    micro = 1
    if mesh.pp > 1:
        micro = common.pipeline_microbatches(
            rows // (mesh.dp * mesh.fsdp), max(cfg.pipeline_microbatches, 1), Mesh(mesh))[0]
    runs = cfg.n_layer // mesh.pp * micro
    return {"flash_fwd": runs * (2 if getattr(cfg, "n_experts", 0) else 1), "flash_bwd": runs}


def mesh_setup(cfg, mesh, opt, dev, generator, batch, batch_spec=ROW_SPEC):
    """bench.py's sequence: shardings from the logical rules, the state
    sharded at creation, the step over the mesh with the batch under
    ``batch_spec`` (split over (dp, fsdp), and for SEQ_SPEC the sequence
    over sp), and compile_train_step. Returns (step, state, shardings)."""
    model = model_of(cfg)
    shardings = shardings_from_logical(model.param_logical_specs(cfg), DEFAULT_RULES, mesh)
    state = spmd.make_train_state(
        functools.partial(model.init_params, cfg=cfg, device=dev), opt, generator, device=dev,
        param_shardings=shardings,
    )
    step = spmd.make_train_step(
        functools.partial(model.loss_fn, cfg=cfg, mesh=mesh), opt, mesh=mesh,
        batch_spec=P(*batch_spec), param_shardings=shardings,
    )
    step, flops = spmd.compile_train_step(step, state, batch)
    assert flops is None  # eager PyTorch has no cost model
    return step, state, shardings


def loss_and_norm(cfg, params, batch, shardings=None, mesh=None, batch_spec=ROW_SPEC) -> dict:
    """The gradient half of the step (make_grad_fn, global_norm) once:
    the global cross-entropy, the gradients' global norm and the MoE aux.
    Unsharded, a pipelined MoE config is the mean over its microbatches of
    the step on each (the pipeline routes each microbatch's tokens
    together): its loss and aux, and the norm of the mean gradient."""
    loss_fn = functools.partial(model_of(cfg).loss_fn, cfg=cfg, mesh=mesh)
    spec = P(*batch_spec) if mesh is not None else None
    grad_fn = spmd.make_grad_fn(loss_fn, mesh=mesh, batch_spec=spec)
    n_micro = getattr(cfg, "pipeline_microbatches", 0)
    if mesh is None and n_micro > 1 and getattr(cfg, "n_experts", 0):
        parts = [grad_fn(params, {k: v.chunk(n_micro)[i] for k, v in batch.items()}, None)
                 for i in range(n_micro)]
        metrics = {k: sum(m[k] for m, _ in parts) / n_micro for k in ("loss", "moe_aux")}
        grads = [sum(gs) / n_micro for gs in zip(*(g for _, g in parts))]
        del parts
    else:
        metrics, grads = grad_fn(params, batch, shardings)
    out = dict(loss=metrics["loss"].item(),
               gnorm=spmd.global_norm(grads, shardings, mesh).item())
    if "moe_aux" in metrics:
        out["moe_aux"] = metrics["moe_aux"].item()
    return out


def mesh_batch(cfg, rows, dev) -> dict:
    g = torch.Generator().manual_seed(1)  # on the CPU: the same batch on every rank
    tokens = torch.randint(0, cfg.vocab_size, (rows, cfg.max_seq), generator=g).to(dev)
    return {"tokens": tokens, "targets": tokens.roll(-1, dims=1)}


def mesh_exact(cfg, mesh, dev):
    """Two steps of the sharded step at world size 1 against two of the
    unsharded one from the same seed (the first at zero learning rate, the
    second moving the params): losses, params and both moments equal.
    Returns the record and (step, state, batch) of the sharded run."""
    opt = spmd.default_optimizer(warmup_steps=2, total_steps=20)
    batch = mesh_batch(cfg, TRAIN_B, dev)
    step, state, _ = mesh_setup(
        cfg, mesh, opt, dev, torch.Generator(device=dev).manual_seed(0), batch
    )
    ref = spmd.make_train_state(
        functools.partial(gpt2.init_params, cfg=cfg, device=dev), opt,
        torch.Generator(device=dev).manual_seed(0), device=dev,
    )
    ref_step = spmd.make_train_step(functools.partial(gpt2.loss_fn, cfg=cfg), opt)
    init = [t.detach().clone() for t in spmd.tree_leaves(ref["params"])]
    got = [step(state, batch)[1] for _ in range(2)]
    want = [ref_step(ref, batch)[1] for _ in range(2)]
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and all(torch.equal(g[k], w[k]) for k in g), (g, w)
    for part in ("params", "mu", "nu"):
        xs, ys = ((st["params"] if part == "params" else st["opt_state"][part]) for st in (state, ref))
        assert all(torch.equal(x, y) for x, y in zip(spmd.tree_leaves(xs), spmd.tree_leaves(ys))), (
            f"{part} differ after two steps")
    moved = sum((x.detach() != y).sum().item() for x, y in zip(spmd.tree_leaves(state["params"]), init))
    assert moved > 0, "the second step moved no param"
    del ref, init
    record = dict(n_experts=cfg.n_experts, mesh=mesh.spec.asdict(),
                  batch=list(batch["tokens"].shape), losses=[m["loss"].item() for m in got],
                  params_moved=moved, exact=True)
    return record, (step, state, batch)


def train_mesh(dev, tmp: str) -> dict:
    """The mesh path on this card over NCCL at world size 1: one all-reduce
    through the process group; GPT-2-125M (MeshSpec(dp=1)) and MoE GPT-2
    (MeshSpec(ep=1)) each equal to the unsharded step exactly; then the
    dense sharded step timed as train_path times its step, with the launch
    counts zeroed just before and read just after."""
    cuda = dev.type == "cuda"
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"file://{Path(tmp) / 'store'}",
                            world_size=1, rank=0, **(dict(device_id=dev) if cuda else {}))
    try:
        ones = torch.ones(4, device=dev)
        dist.all_reduce(ones)
        assert torch.equal(ones, torch.ones(4, device=dev)), ones
        exact, timed = {}, None
        for name, cfg, spec in (("gpt2_dp1", train_config(), MeshSpec(dp=1)),
                                ("moe_ep1", moe_train_config(), MeshSpec(ep=1))):
            exact[name], (step, state, batch) = mesh_exact(cfg, make_mesh(spec, dev.type), dev)
            if timed is None:  # the dense sharded step, timed as train_path times its own
                timed = timed_steps(step, state, batch)
                timed["launches_per_step"] = launches_per_step(
                    cfg, batch["tokens"], timed["launches"])[1]
                timed["profile_one_step"] = profile_window(lambda: step(state, batch), 1)
            del step, state, batch
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return dict(nccl_all_reduce_ok=True, exact=exact, timed=timed, launches=timed["launches"])


def state_gb(params) -> float:
    """GB of f32 params, grads and both Adam moments over these leaves."""
    return 4 * sum(t.numel() * t.element_size() for t in spmd.tree_leaves(params)) / 1e9


def shard_step(step, state, batch, dev) -> dict:
    """One full step with the launch counts zeroed just before and read
    just after; the peak memory since the caller's reset (made once the
    state exists, so the whole tree each rank draws before keeping its
    shard is not counted)."""
    attention.flash_fwd_launches = attention.flash_bwd_launches = 0  # zeroed just before the step
    step_loss = step(state, batch)[1]["loss"].item()
    launches = {"flash_fwd": attention.flash_fwd_launches,  # read just after
                "flash_bwd": attention.flash_bwd_launches}
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None
    return dict(step_loss=step_loss, launches=launches, peak_mem_gb=peak,
                state_gb=state_gb(state["params"]))


def unsharded_step(cfg, rows, dev) -> dict:
    """The unsharded step's gradient half (loss, gradient norm) and one
    full step on ``dev``, from the seed every rank draws from."""
    opt = spmd.default_optimizer(warmup_steps=2, total_steps=20)
    model, batch = model_of(cfg), mesh_batch(cfg, rows, dev)
    state = spmd.make_train_state(functools.partial(model.init_params, cfg=cfg, device=dev), opt,
                                  torch.Generator().manual_seed(0), device=dev)
    step = spmd.make_train_step(functools.partial(model.loss_fn, cfg=cfg), opt)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out = loss_and_norm(cfg, state["params"], batch)
    out.update(shard_step(step, state, batch, dev))
    return out


def shard_case(name: str, device_type: str, tmp: str, cfg=None) -> dict:
    """One of SHARD_CASES: one process per rank (this script with
    ``--mesh-rank``), over NCCL with a card each where there are enough
    cards, else all on card 0 over gloo (or on the CPU over gloo), against
    the unsharded step in this process from the same seed: loss and
    gradient norm within the training tolerances, and each rank's
    launches of one full step."""
    config, spec, rows, batch_spec = SHARD_CASES[name]
    cfg = cfg or config()
    world = MeshSpec(**spec).num_devices
    cuda = device_type == "cuda"
    backend = "nccl" if cuda and torch.cuda.device_count() >= world else "gloo"
    case = Path(tmp) / f"{name}.pkl"
    ckpt = dict(path=str(Path(tmp) / f"{name}.ckpt"), target=CKPT_CASES[name]) if name in CKPT_CASES else None
    with open(case, "wb") as f:
        pickle.dump(dict(cfg=cfg, spec=spec, rows=rows, batch_spec=batch_spec,
                         device_type=device_type, backend=backend, ckpt=ckpt), f)
    store = Path(tmp) / f"{name}.store"
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, __file__, "--mesh-rank", str(r), str(world),
                               str(store), str(case)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    outs = []
    try:
        for r, proc in enumerate(procs):
            out, err = proc.communicate(timeout=MESH_JOIN_S)
            assert proc.returncode == 0, f"{name} rank {r} exited {proc.returncode}:\n{err}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    ranks_s = time.perf_counter() - t0
    dev = torch.device(device_type, 0) if cuda else torch.device("cpu")
    want = unsharded_step(cfg, rows, dev)
    per_step = shard_launches(cfg, spec, rows)
    for got in outs:
        assert abs(got["loss"] - want["loss"]) <= TRAIN_LOSS_TOL, (name, got, want)
        assert abs(got["gnorm"] - want["gnorm"]) / want["gnorm"] <= TRAIN_GNORM_TOL, (name, got, want)
        if cuda:
            assert got["launches"] == per_step, (name, got["launches"], per_step)
        if ckpt is not None:  # the resumed step: bitwise on the same mesh, within tolerance off it
            c = got["ckpt"]
            assert c["same_mesh_loss"] == c["live_loss"], (name, c)
            assert abs(c["new_mesh_loss"] - c["live_loss"]) <= TRAIN_LOSS_TOL, (name, c)
            if cuda:
                assert c["launches"] == {k: 3 * v for k, v in per_step.items()}, (name, c["launches"])
    if ckpt is not None:
        assert sum(o["ckpt"]["bytes_written"] for o in outs) == outs[0]["ckpt"]["state_bytes"]
    if cuda:
        torch.cuda.empty_cache()
    return dict(model=type(cfg).__name__, n_experts=getattr(cfg, "n_experts", 0), mesh=spec,
                world=world, backend=backend, batch=[rows, cfg.max_seq],
                batch_spec=[list(e) if isinstance(e, tuple) else e for e in batch_spec],
                pipeline_microbatches=getattr(cfg, "pipeline_microbatches", 0),
                launches_per_step=per_step, ranks=outs, unsharded=want, ranks_s=ranks_s)


def mesh_rank(rank: int, world: int, store: str, case_path: str) -> None:
    """One rank of a sharded case (run as ``chip_smoke.py --mesh-rank``):
    prints its loss, gradient norm, one full step's loss and launches, its
    peak memory and the collectives' transport as one JSON line."""
    with open(case_path, "rb") as f:
        case = pickle.load(f)
    cfg, backend = case["cfg"], case["backend"]
    if case["device_type"] == "cuda":
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    dist.init_process_group(backend, init_method=f"file://{store}", world_size=world, rank=rank)
    try:
        mesh = make_mesh(MeshSpec(**case["spec"]), case["device_type"])
        opt = spmd.default_optimizer(warmup_steps=2, total_steps=20)
        # Every rank draws the whole tree on the CPU from one seed.
        batch = mesh_batch(cfg, case["rows"], dev)
        step, state, shardings = mesh_setup(
            cfg, mesh, opt, dev, torch.Generator().manual_seed(0), batch, case["batch_spec"]
        )
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        out = loss_and_norm(cfg, state["params"], batch, shardings, mesh, case["batch_spec"])
        out.update(shard_step(step, state, batch, dev))
        out["coords"] = {a: mesh.coordinate(a) for a in mesh.axis_names if mesh.size(a) > 1}
        if case["ckpt"] is not None:
            out["ckpt"] = ckpt_rank(cfg, case, opt, step, state, batch, dev)
        # gloo takes CUDA tensors for every collective the port runs and
        # stages them through host memory; NCCL keeps them on the cards.
        # Point to point (the sp ring, the pp stages) gloo takes on the
        # host only: the port copies through pinned host memory itself.
        out["transport"] = dict(backend=dist.get_backend(), tensors=str(dev), p2p={
            a: p2p_transport(mesh, a, dev) for a in ("sp", "pp") if mesh.size(a) > 1})
        print(json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()


def ckpt_rank(cfg, case, opt, step, state, batch, dev) -> dict:
    """The checkpoint case on this rank, after its first step (at the
    schedule's zero learning rate): one more step, which moves the params,
    then save the state, restore it onto the case's mesh and onto the
    target mesh, and
    whole onto the host; every saved leaf and every leaf restored onto the
    target is bitwise its block of the whole one. Then one step each on
    the live state (the uninterrupted run), the state restored onto the
    same mesh and the one restored onto the target, with the launch counts
    zeroed just before and read just after: their losses, the bytes this
    rank wrote and the save and restore seconds."""
    path, target = case["ckpt"]["path"], MeshSpec(**case["ckpt"]["target"])
    step(state, batch)
    t0 = time.perf_counter()
    written = sharded_checkpoint.save_sharded(state, path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    same = sharded_checkpoint.restore_sharded(path, sharded_checkpoint.restore_template(state))
    restore_same_s = time.perf_counter() - t0
    tmesh = make_mesh(target, case["device_type"])
    tshard = shardings_from_logical(gpt2.param_logical_specs(cfg), DEFAULT_RULES, tmesh)
    t0 = time.perf_counter()
    new = sharded_checkpoint.restore_sharded(path, sharded_checkpoint.restore_template(state, tshard))
    restore_new_s = time.perf_counter() - t0
    none = spmd._tree_map(lambda _: None, state["params"])
    whole = sharded_checkpoint.restore_sharded(
        path, sharded_checkpoint.restore_template(state, none, device="cpu"))
    leaves = 0
    for st in (state, new):
        flat = sharded_checkpoint._flatten(sharded_checkpoint._tree_of(st), spmd.state_shardings(st))
        for (key, leaf, sh), (_, w, _) in zip(flat, sharded_checkpoint._flatten(
                sharded_checkpoint._tree_of(whole), None)):
            if isinstance(leaf, torch.Tensor):
                assert torch.equal(leaf.detach().cpu(), sh.shard(w)), f"ckpt leaf {key} differs"
                leaves += 1
            else:
                assert leaf == w, key
    state_bytes = sum(t.numel() * t.element_size() for _, t, _ in sharded_checkpoint._flatten(
        sharded_checkpoint._tree_of(whole), None) if isinstance(t, torch.Tensor))
    del whole
    new_step = spmd.make_train_step(functools.partial(gpt2.loss_fn, cfg=cfg, mesh=tmesh), opt,
                                    mesh=tmesh, batch_spec=P(*case["batch_spec"]),
                                    param_shardings=tshard)
    attention.flash_fwd_launches = attention.flash_bwd_launches = 0  # zeroed just before the steps
    live_loss = step(state, batch)[1]["loss"].item()
    same_loss = step(same, batch)[1]["loss"].item()
    new_loss = new_step(new, batch)[1]["loss"].item()
    launches = {"flash_fwd": attention.flash_fwd_launches,  # read just after
                "flash_bwd": attention.flash_bwd_launches}
    return dict(target=case["ckpt"]["target"], bytes_written=written, state_bytes=state_bytes,
                save_s=save_s, restore_same_s=restore_same_s, restore_new_s=restore_new_s,
                leaves_bitwise=leaves, live_loss=live_loss, same_mesh_loss=same_loss,
                new_mesh_loss=new_loss, launches=launches)


def train_shard(dev, tmp: str) -> dict:
    """Every case of SHARD_CASES in turn (see shard_case); the launches of
    all ranks' one full step, summed per kernel: over the earlier cases
    (``launches``) and over the sp and pp cases (``launches_sp_pp``)."""
    cases = {}
    for name in SHARD_CASES:
        t0 = time.perf_counter()
        cases[name] = shard_case(name, dev.type, tmp)
        cases[name]["case_s"] = time.perf_counter() - t0
        log(f"train_shard {name}: {json.dumps(cases[name])}")

    def summed(names):
        return {k: sum(r["launches"][k] for n in names for r in cases[n]["ranks"])
                for k in KERNELS}

    ckpt_launches = {k: sum(r["ckpt"]["launches"][k] for n in CKPT_CASES for r in cases[n]["ranks"])
                     for k in KERNELS}
    return dict(cases=cases, launches=summed([n for n in cases if n not in SEQ_PIPE_CASES]),
                launches_sp_pp=summed(SEQ_PIPE_CASES), launches_ckpt=ckpt_launches)


# Speculative decoding: the arms of each cache, in order. The vanilla arm
# comes first: its streams and f32 logits are what the spec arms are held to.
SPEC_PATHS = (("spec", dict(kv_block_size=0)), ("spec_paged", dict(num_kv_blocks=420)))
SPEC_ARMS = ("vanilla", "draft_1layer", "self_draft")


def spec_engine(fields: dict, arm: str, self_draft_path: str) -> LLMEngine:
    """The probe's engine (GPT-2-125M target, random weights from seed 0)
    for one arm (:func:`spec_config`)."""
    engine = LLMEngine(LLMConfig(**spec_config(fields, arm, self_draft_path)))
    assert (engine._spec is None) == (arm == "vanilla")
    return engine


def spec_config(fields: dict, arm: str, self_draft_path: str | None) -> dict:
    """The probe's LLMConfig fields for one arm: no draft, the probe's
    1-layer d128 draft (2 heads, so head_dim is the kernel's 64; the
    target's vocabulary), or the target's own config with its weights from
    ``self_draft_path``."""
    target = gpt2.GPT2Config.gpt2_125m()
    drafts = {
        "vanilla": {},
        "draft_1layer": dict(
            spec_decode_tokens=SPEC_K,
            draft_model_config=gpt2.GPT2Config.tiny(
                n_layer=1, d_model=128, n_head=2, vocab_size=target.vocab_size, max_seq=1024
            ),
        ),
        "self_draft": dict(spec_decode_tokens=SPEC_K, draft_model_config=target,
                           draft_weights_path=self_draft_path),
    }
    return dict(model_config=target, max_slots=4, max_seq=1024, prefill_buckets=(32, 128, 1024),
                enable_prefix_caching=False, seed=0, **fields, **drafts[arm])


def spec_arm(engine, record_logits: bool) -> dict:
    """The probe's traffic: a warm-up request, then SPEC_STREAMS greedy
    streams of SPEC_TOKENS tokens, with the launch counts zeroed just
    before the streams and read just after. With ``record_logits`` every
    sampled position's f32 logits are kept, by (stream, index)."""
    logits_at = record_sampled_logits(engine) if record_logits else {}
    engine.generate(["warm me"], SamplingParams(max_tokens=8))
    logits_at.clear()
    stats0 = dict(engine.stats)
    start = begin_telemetry(engine)
    attention.flash_fwd_launches = attention.flash_bwd_launches = 0  # zeroed just before
    t0 = time.perf_counter()
    run = drive(engine, {f"s{i}": f"stream {i}" for i in range(SPEC_STREAMS)},
                SamplingParams(max_tokens=SPEC_TOKENS))
    seconds = time.perf_counter() - t0
    launches = attention.flash_fwd_launches  # read just after
    bwd_launches = attention.flash_bwd_launches
    telemetry = check_telemetry(engine, start, run)
    engine.pop_finished()
    delta = {k: engine.stats[k] - stats0[k] for k in engine.stats}
    assert all(r.error is None for r in run["finished"])
    streams = run["streams"]  # by stream, "s0"... (the same ids in every arm)
    spec = engine._spec
    draft_layers = spec.cfg.n_layer if spec is not None else 0
    prompts = len(streams)  # no prefix caching: every stream prefills whole
    per_prefill = 0 if engine.paged else engine.model_config.n_layer + draft_layers
    assert launches == per_prefill * prompts, (launches, per_prefill, prompts)
    if spec is not None:
        assert delta["spec_steps"] > 0, delta
    return dict(
        streams=streams, logits_at=logits_at,
        tokens=delta["tokens_generated"], seconds=seconds,
        tok_s=delta["tokens_generated"] / seconds, steps_stats=delta,
        accept_rate=(delta["spec_accepted"] / delta["spec_drafted"]) if delta["spec_drafted"] else None,
        launches=launches, bwd_launches=bwd_launches, launches_per_prefill=per_prefill,
        lengths=[len(t) for t in streams.values()], vanilla_decode_steps=run["vanilla_decode_steps"],
        telemetry=telemetry,
    )


def record_sampled_logits(engine) -> dict:
    """Keep the f32 logits of every position ``engine`` samples on the
    host, by (request id, index in its stream); returns the dict it fills."""
    logits_at: dict = {}
    sample, ref = type(engine)._sample, weakref.ref(engine)  # no cycle: see count_prefill_calls

    def recording_sample(logits, req):
        logits_at[(req.request_id, len(req.generated))] = np.array(logits, np.float32)
        return sample(ref(), logits, req)

    engine._sample = recording_sample
    return logits_at


def compare_streams(vanilla: dict, spec: dict, bound: float) -> list[dict]:
    """The spec arm's streams against the vanilla arm's, token for token.
    At each stream's first difference the vanilla step's f32 logits must
    put the two tokens within ``bound`` (bf16's noise on these logits,
    phase 4); any other difference fails."""
    divergences = []
    for rid, want in vanilla["streams"].items():
        got = spec["streams"][rid]
        i = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)
        if i is None:
            assert len(got) == len(want), f"{rid}: spec stream of {len(got)} vs {len(want)} tokens"
            continue
        logits = vanilla["logits_at"][(rid, i)]
        margin = float(logits[want[i]] - logits[got[i]])
        div = dict(stream=rid, index=i, vanilla_token=want[i], spec_token=got[i], margin=margin)
        assert 0.0 <= margin <= bound, f"spec stream diverges past bf16 noise: {div}, bound {bound}"
        divergences.append(div)
    return divergences


def spec_path(name: str, fields: dict, bound: float, tmp: str) -> dict:
    """One cache's three arms, printed as one ``{"spec": ...}`` line."""
    arms, self_draft_path = {}, str(Path(tmp) / "target.pkl")
    for arm in SPEC_ARMS:
        t_arm = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        engine = spec_engine(fields, arm, self_draft_path)
        if arm == "vanilla":
            # The target's weights as numpy, for the self-draft arm.
            tree = {k: (v.cpu().numpy() if torch.is_tensor(v) else
                        {b: w.cpu().numpy() for b, w in v.items()})
                    for k, v in engine.params.items()}
            with open(self_draft_path, "wb") as f:
                pickle.dump(tree, f)
            del tree
        run = spec_arm(engine, record_logits=arm == "vanilla")
        if arm != "vanilla":
            run["divergences"] = compare_streams(arms["vanilla"], run, bound)
            run["profile_steps"] = profile_spec_steps(engine)
            run["telemetry"]["profiled"] = profiled_phases({"spec_steps": run["profile_steps"]})
        run.update(peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   phase_s=time.perf_counter() - t_arm)
        arms[arm] = run
        del engine
        torch.cuda.empty_cache()
    launches = sum(a["launches"] for a in arms.values())
    bwd_launches = sum(a["bwd_launches"] for a in arms.values())
    assert bwd_launches == 0, bwd_launches  # serving runs no backward
    for a in arms.values():
        del a["logits_at"], a["streams"]
    log(name, json.dumps({k: dict(tok_s=a["tok_s"], accept_rate=a["accept_rate"])
                          for k, a in arms.items()}))
    return dict(path=name, paged="kv_block_size" not in fields, k=SPEC_K,
                bf16_bound=bound, arms=arms, launches=launches, bwd_launches=bwd_launches)


def profile_spec_steps(engine) -> dict:
    """Device time and busy share of 4 engine steps with SPEC_STREAMS
    greedy streams in flight (spec steps where eligible)."""
    for i in range(SPEC_STREAMS):
        engine.add_request(f"prof-{i}", f"profile {i}", SamplingParams(max_tokens=64))
    engine.step()  # admissions and the draft prefills
    steps0 = engine.stats["spec_steps"]
    flightrec.reset()
    prof = profile_window(engine.step, 4)
    prof["host_phases"] = phase_ms(llm_events())  # the same window's flight recorder
    prof["spec_steps"] = engine.stats["spec_steps"] - steps0
    while engine.has_unfinished():
        engine.step()
    engine.pop_finished()
    return prof


# Tensor-parallel serving (serve_tp): name -> (LLMConfig fields, tp, the
# one-rank reference's fields). Each case is served by tp rank processes
# (this script with --serve-rank), SPMD ranks of one LLMEngine: over NCCL
# with a card each where the machine has a card for every rank, else all on
# card 0 over gloo. The serving cases take the serve phase's configuration
# (16 slots x 2048, paged unless kv_block_size=0) and traffic, held against
# the one-rank engine of the same fields and seed; the spec case is the
# probe's 1-layer draft arm on the dense cache, its streams cut from
# SPEC_TOKENS to TP_SPEC_TOKENS tokens for time, held against the probe's
# vanilla arm as the spec phases hold theirs.
TP_SPEC_TOKENS = 64
TP_COLLECTIVE_S = 300  # a collective waiting this long on a dead rank raises
TP_CASES = {
    "gpt2_tp2": (dict(), 2, dict()),
    "gpt2_tp2_dense": (dict(kv_block_size=0), 2, dict(kv_block_size=0)),
    "llama_tp2": (dict(model_config=LLAMA_125M), 2, dict(model_config=LLAMA_125M)),
    "llama_tp4_dense": (dict(model_config=LLAMA_125M, kv_block_size=0), 4,
                        dict(model_config=LLAMA_125M, kv_block_size=0)),
    "gpt2_tp2_spec": (spec_config(dict(kv_block_size=0), "draft_1layer", None), 2,
                      spec_config(dict(kv_block_size=0), "vanilla", None)),
}


# The serve_tp case whose ranks also hand its traffic from a tp=2
# prefill-only engine to a tp=2 decode engine (disaggregated serving).
TP_HANDOFF_CASES = ("gpt2_tp2",)


def tp_reference(name: str) -> tuple[dict, dict]:
    """One serve_tp case's one-rank engine on card 0, from the same seed:
    the warm-up, then the case's traffic with the launch counts zeroed just
    before and read just after, every sampled position's f32 logits kept.
    Returns (the case as the ranks run it, the reference's record)."""
    fields, tp, ref_fields = TP_CASES[name]
    spec = "spec_decode_tokens" in fields
    engine = LLMEngine(LLMConfig(**{"seed": 0, **ref_fields}))
    logits_at = record_sampled_logits(engine)
    if spec:
        warm, warm_tokens, first_of = ["warm me"], 8, "s0"
        prompts = {f"s{i}": f"stream {i}" for i in range(SPEC_STREAMS)}
        tokens = TP_SPEC_TOKENS
    else:
        rng = np.random.default_rng(0)
        warm, warm_tokens, first_of = [token_ids(rng, engine)(40)], 2, "p1000"
        prompts, tokens = traffic(engine, rng), MAX_TOKENS
    engine.generate(warm, SamplingParams(max_tokens=warm_tokens))
    logits_at.clear()
    attention.flash_fwd_launches = attention.flash_bwd_launches = 0  # zeroed just before
    run = drive(engine, prompts, SamplingParams(max_tokens=tokens))
    launches = attention.flash_fwd_launches  # read just after
    cfg = engine.model_config
    if spec:  # the draft's dense prefill runs the kernel too, per draft layer
        launches += fields["draft_model_config"].n_layer * len(prompts)
    ref = dict(streams=run["streams"], logits_at=logits_at, launches=launches,
               kv_bytes=kv_bytes(engine), family=type(cfg).__name__, paged=engine.paged,
               n_layer=cfg.n_layer)
    case = dict(name=name, fields={**{"seed": 0, **fields}, "tensor_parallelism": tp}, warm=warm,
                warm_tokens=warm_tokens, prompts=prompts, tokens=tokens, first_of=first_of,
                handoff=name in TP_HANDOFF_CASES)
    del engine
    torch.cuda.empty_cache()
    return case, ref


def tp_rank_case(case: dict, rank: int, out_dir: str) -> dict:
    """One serve_tp case on this rank: the engine built, the warm-up, then
    the traffic with the launch counts zeroed just before and read just
    after, and its telemetry checked as a serving path's; the first-token
    logits of ``first_of`` saved beside the record."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = LLMEngine(LLMConfig(**case["fields"]))
    logits_at = record_sampled_logits(engine)
    engine.generate(case["warm"], SamplingParams(max_tokens=case["warm_tokens"]))
    logits_at.clear()
    start = begin_telemetry(engine)
    attention.flash_fwd_launches = attention.flash_bwd_launches = 0  # zeroed just before
    t_run = time.perf_counter()
    run = drive(engine, case["prompts"], SamplingParams(max_tokens=case["tokens"]))
    run_s = time.perf_counter() - t_run
    launches = attention.flash_fwd_launches  # read just after
    bwd_launches = attention.flash_bwd_launches
    telemetry = check_telemetry(engine, start, run)
    assert all(r.error is None for r in run["finished"])
    np.save(Path(out_dir) / f"{case['name']}_rank{rank}.npy", logits_at[(case["first_of"], 0)])
    kv = engine.pool if engine.paged else engine.cache
    out = dict(
        rank=rank, device=str(engine.device), streams=run["streams"],
        stats={k: engine.stats[k] - start["stats"][k] for k in engine.stats},
        kv_stats=engine.kv_stats(), kv_shape=list(kv["k"].shape), kv_bytes=kv_bytes(engine),
        kv_gb=kv_bytes(engine) / 1e9, launches=launches, bwd_launches=bwd_launches,
        peak_mem_gb=torch.cuda.max_memory_allocated(engine.device) / 1e9,
        run_s=run_s, build_and_run_s=time.perf_counter() - t0,
        transport=dict(backend=dist.get_backend(), tensors=str(engine.device)),
        telemetry=telemetry["checks"], telemetry_checks_hold=telemetry["all_checks_hold"],
    )
    del engine, kv
    torch.cuda.empty_cache()
    if case["handoff"]:
        out["handoff"] = tp_handoff(case)
    return out


def tp_handoff(case: dict) -> dict:
    """The case's traffic handed from a tp-rank prefill-only engine to a
    tp-rank decode engine (fresh ones, so the prefix pool is the unified
    run's), with the launch counts zeroed just before and read just
    after: this rank's streams and its decode engine's counters."""
    sampling = SamplingParams(max_tokens=case["tokens"])
    A, B = LLMEngine(LLMConfig(**case["fields"])), LLMEngine(LLMConfig(**case["fields"]))
    attention.flash_fwd_launches = attention.flash_bwd_launches = 0  # zeroed just before
    t0 = time.perf_counter()
    streams = decode_handoffs(B, prefill_handoffs(A, case["prompts"], sampling), sampling)
    seconds = time.perf_counter() - t0
    launches = attention.flash_fwd_launches + attention.flash_bwd_launches  # read just after
    stats = {k: B.stats[k] for k in ("prefill_tokens", "kv_fallbacks", "handoffs_in")}
    del A, B
    torch.cuda.empty_cache()
    return dict(streams=streams, stats=stats, launches=launches, seconds=seconds)


def serve_rank(rank: int, world: int, store: str, cases_path: str, out_dir: str) -> None:
    """One rank of serve_tp's cases of one world (run as ``chip_smoke.py
    --serve-rank``): every case in turn on this rank's card, one JSON list
    of their records as the last line of its output."""
    with open(cases_path, "rb") as f:
        cases = pickle.load(f)
    backend = cases[0]["backend"]
    torch.cuda.set_device(rank if backend == "nccl" else 0)
    dist.init_process_group(backend, init_method=f"file://{store}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TP_COLLECTIVE_S))
    GLOBAL_CONFIG.metrics_enabled = GLOBAL_CONFIG.flightrec = GLOBAL_CONFIG.spec_decode = True
    try:
        out = [dict(name=c["name"], **tp_rank_case(c, rank, out_dir)) for c in cases]
    finally:
        dist.destroy_process_group()
    print(json.dumps(out), flush=True)


def tp_spawn(world: int, cases: list, tmp: str) -> tuple[dict, float]:
    """Run ``cases`` on ``world`` rank processes; ({case: each rank's
    record}, the ranks' wall seconds). Every rank is joined within
    MESH_JOIN_S and killed after; a rank that fails fails the phase."""
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    path, store = Path(tmp) / f"tp{world}.pkl", Path(tmp) / f"tp{world}.store"
    with open(path, "wb") as f:
        pickle.dump([dict(c, backend=backend) for c in cases], f)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, __file__, "--serve-rank", str(r), str(world), str(store),
                               str(path), tmp], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    outs = []
    try:
        for r, proc in enumerate(procs):
            out, err = proc.communicate(timeout=MESH_JOIN_S)
            assert proc.returncode == 0, f"serve_tp world {world} rank {r} exited {proc.returncode}:\n{err}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    by_case = {c["name"]: [ranks[i] for ranks in outs] for i, c in enumerate(cases)}
    return by_case, time.perf_counter() - t0


def serve_tp(tmp: str, stream_bound: float, logits_tol: dict) -> dict:
    """Every case of TP_CASES: the one-rank references first, then each
    world's ranks, then the checks. Every rank's streams, counters and
    first-token logits equal rank 0's; rank 0's streams equal the one-rank
    engine's, or first diverge where that engine's f32 logits put the two
    tokens within ``stream_bound``; rank 0's first-token logits of the
    1000-token prompt (the spec case: its first stream's) within twice the
    family's bf16 tolerance of the one-rank engine's; each rank's flash_fwd
    launches equal to the one-rank path's on that traffic, and its KV bytes
    the one-rank engine's divided by tp."""
    cases, refs = {}, {}
    for name in TP_CASES:
        cases[name], refs[name] = tp_reference(name)
    ranks, spawn_s = {}, {}
    for world in sorted({tp for _, tp, _ in TP_CASES.values()}):
        names = [n for n, (_, tp, _) in TP_CASES.items() if tp == world]
        got, spawn_s[world] = tp_spawn(world, [cases[n] for n in names], tmp)
        ranks.update(got)
    out = {}
    for name, (fields, tp, _) in TP_CASES.items():
        ref, rs = refs[name], ranks[name]
        r0 = rs[0]
        firsts = [np.load(Path(tmp) / f"{name}_rank{r['rank']}.npy") for r in rs]
        for r, first in zip(rs[1:], firsts[1:]):
            for key in ("streams", "stats", "kv_stats"):
                assert r[key] == r0[key], f"serve_tp {name}: rank {r['rank']}'s {key} differ from rank 0's"
            assert np.array_equal(first, firsts[0]), f"serve_tp {name}: rank {r['rank']}'s logits differ"
        divergences = compare_streams(ref, r0, stream_bound)
        want = ref["logits_at"][(cases[name]["first_of"], 0)]
        bound = 2.0 * logits_tol[ref["family"]]
        diff = float(np.abs(firsts[0] - want).max())
        assert diff <= bound, f"serve_tp {name}: first-token logits {diff} from one rank's > {bound}"
        for r in rs:
            assert r["launches"] == ref["launches"], (name, r["rank"], r["launches"], ref["launches"])
            assert r["bwd_launches"] == 0, (name, r["bwd_launches"])
            assert r["kv_bytes"] * tp == ref["kv_bytes"], (name, r["kv_bytes"], ref["kv_bytes"], tp)
            assert r["telemetry_checks_hold"], (name, r["rank"])
        if "spec_decode_tokens" in fields:
            assert r0["stats"]["spec_steps"] > 0, r0["stats"]
        handoff = None
        if cases[name]["handoff"]:  # tp=2 prefill -> tp=2 decode: the tp=2 unified streams
            for r in rs:
                h = r["handoff"]
                assert h["streams"] == r["streams"], f"serve_tp {name}: rank {r['rank']}'s handoff streams"
                assert h["stats"] == dict(prefill_tokens=0, kv_fallbacks=0,
                                          handoffs_in=len(cases[name]["prompts"])), h["stats"]
                assert h["launches"] == 0, h["launches"]  # paged: no kernel
            handoff = dict(streams_equal_tp_unified=True, decode_stats=r0["handoff"]["stats"],
                           launches=0, ranks_s=[r["handoff"]["seconds"] for r in rs])
        shared = r0["transport"]["backend"] == "gloo" and torch.cuda.device_count() < tp
        out[name] = dict(
            model=ref["family"], tp=tp, paged=ref["paged"], spec="spec_decode_tokens" in fields,
            first_token_logits=dict(request=cases[name]["first_of"], max_abs_diff=diff, bound=bound),
            handoff=handoff,
            streams_equal_one_rank=not divergences, divergences=divergences,
            launches_per_rank=ref["launches"], kv_gb_one_rank=ref["kv_bytes"] / 1e9,
            ranks_identical=True, stats=r0["stats"],
            speed_evidence=("none: the ranks share one card over gloo, which stages every "
                            "collective through host memory" if shared else "none: not timed"),
            ranks=[{k: r[k] for k in ("rank", "device", "peak_mem_gb", "kv_gb", "kv_shape", "launches",
                                      "transport", "run_s", "build_and_run_s")} for r in rs],
        )
        log(f"serve_tp {name}: {json.dumps(out[name])}")
    launches = sum(r["launches"] for rs in ranks.values() for r in rs)
    return dict(cases=out, ranks_wall_s=spawn_s, launches=launches, bwd_launches=0,
                stream_bound=stream_bound)


# The core runtime (runtime): the port's own GCS, node manager and worker
# processes (ray_tpu_torch.core) drive the card from a GPU actor that serves
# and a GPU task that trains. The launch counts live in each worker process:
# the actor and the task zero theirs just before their path and report them
# just after.
RUNTIME_CPUS = 4
RUNTIME_NOOP_CALLS = 50
RUNTIME_PUT_BYTES = 256 * 2**20  # the host plane's bf16 CPU tensor
RUNTIME_CUDA_BYTES = 64 * 2**20  # the bf16 tensor a GPU task returns
RUNTIME_CUDA_SEED = 3
RUNTIME_WAIT_S = 2.0  # a second GPU demand must stay unscheduled this long
RUNTIME_TIMEOUT_S = 300
WORKER_MODULE = "ray_tpu_torch.core.worker_main"


def seeded_bf16(n_bytes: int, device, seed: int) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(n_bytes // 2, generator=g, device=device).to(torch.bfloat16)


def card_name() -> str:
    return torch.cuda.get_device_name() if torch.cuda.is_available() else "cpu"


def peak_gb() -> float:
    return torch.cuda.max_memory_allocated() / 1e9 if torch.cuda.is_available() else 0.0


def runtime_noop():
    return os.getpid()


def runtime_cuda_tensor(device: str):
    """A GPU task's result: a bf16 tensor made on the card from a seeded
    generator, returned as it is (the object store brings it to the host)."""
    t = seeded_bf16(RUNTIME_CUDA_BYTES, device, RUNTIME_CUDA_SEED)
    return os.getpid(), t


class RuntimeServer:
    """Phase 3's ``serve`` engine (GPT-2-125M on the dense cache, 16 slots x
    2048 positions, seed-0 weights), built in a worker process of the
    port's runtime."""

    def __init__(self):
        self.engine = build_engine(dict(kv_block_size=0))

    def ready(self) -> int:
        return os.getpid()

    def serve(self, warmup: list, prompts: dict) -> dict:
        """Phase 3's warm-up request, then its 6 requests (token ids), with
        this process's launch counts zeroed just before and read just
        after."""
        engine = self.engine
        engine.generate([warmup], SamplingParams(max_tokens=2))
        attention.flash_fwd_launches = attention.flash_bwd_launches = 0  # zeroed just before the path
        run = drive(engine, prompts, SamplingParams(max_tokens=MAX_TOKENS))
        launches = {"flash_fwd": attention.flash_fwd_launches,  # read just after
                    "flash_bwd": attention.flash_bwd_launches}
        return dict(pid=os.getpid(), device=card_name(), peak_mem_gb=peak_gb(), launches=launches,
                    decode_tok_s=run["decode_tokens"] / run["decode_s"] if run["decode_s"] else 0.0,
                    streams=run["streams"])


def runtime_probe():
    return os.getpid()


def runtime_train_step(device: str) -> dict:
    """One ``make_train_step`` step of GPT-2-125M at ``train_config()`` on
    the ``train`` path's batch and initial state, in a worker process: the
    loss and gradient norm of the initial params (the ``train`` path's
    ``checks["kernel"]``), then the step with this process's launch counts
    zeroed just before and read just after."""
    dev = torch.device(device)
    cfg = train_config()
    model, batch, opt, state = train_setup(dev, cfg)
    loss, grad_norm = loss_and_grad_norm(cfg, state["params"], batch)
    step = spmd.make_train_step(functools.partial(model.loss_fn, cfg=cfg), opt)
    attention.flash_fwd_launches = attention.flash_bwd_launches = 0  # zeroed just before the step
    _, m = step(state, batch)
    step_loss = m["loss"].item()
    launches = {"flash_fwd": attention.flash_fwd_launches,  # read just after
                "flash_bwd": attention.flash_bwd_launches}
    return dict(pid=os.getpid(), device=card_name(), loss=loss, grad_norm=grad_norm,
                step_loss=step_loss, launches=launches, peak_mem_gb=peak_gb())


def nvidia_smi(*query: str) -> list[str]:
    out = subprocess.run(["nvidia-smi", *query, "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def live_workers(pids) -> list[int]:
    """Those of ``pids`` still running (a reaped or zombie process is not),
    and any child of this process that runs the port's worker module."""
    alive = []
    for pid in sorted(set(pids)):
        try:
            state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0]
        except OSError:
            continue
        if state != "Z":
            alive.append(pid)
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
            cmd = (stat.parent / "cmdline").read_bytes().replace(b"\0", b" ").decode()
        except OSError:
            continue
        if int(fields[1]) == os.getpid() and fields[0] != "Z" and WORKER_MODULE in cmd:
            alive.append(int(stat.parent.name))
    return sorted(set(alive))


def runtime_path(card: str, serve_run: dict, train_run: dict, device: str = "cuda",
                 dp2_ref: dict | None = None, stream_bound: float = 0.0) -> dict:
    """The core runtime on the card (see the module docstring, phase 17),
    then the train tier (``out["train_loop"]``, see :func:`train_loop`),
    the serve tier (``out["serve_app"]``, see :func:`serve_app`; streams
    held to ``stream_bound``, phase 5's bf16 noise), device objects
    (``out["device_objects"]``) and the data tier (``out["train_data"]``,
    ``out["batch_data"]``) in the same session, so the no-survivor check
    covers their workers."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import _native
    from ray_tpu_torch.core import api as rt_api

    t_phase = time.perf_counter()
    gpu = {"num_gpus": 1} if device == "cuda" else {}
    timeout = RUNTIME_TIMEOUT_S
    out = dict(card=card)
    pids = set()
    rt.init(num_cpus=RUNTIME_CPUS)
    try:
        out["init_s"] = time.perf_counter() - t_phase
        cards = len(nvidia_smi("--query-gpu=name")) if device == "cuda" else 0
        out["cluster_gpus"] = rt.cluster_resources().get("GPU", 0.0)
        assert out["cluster_gpus"] == cards, (rt.cluster_resources(), cards)

        # Host plane: a no-op task's round trip, and put/get of a bf16 tensor.
        noop = rt.remote(runtime_noop)
        pids.add(rt.get(noop.remote(), timeout=timeout))  # starts the worker
        rtt = []
        for _ in range(RUNTIME_NOOP_CALLS):
            t0 = time.perf_counter()
            pids.add(rt.get(noop.remote(), timeout=timeout))
            rtt.append(time.perf_counter() - t0)
        out["noop_rtt_ms_median"] = 1e3 * median(rtt)
        host = seeded_bf16(RUNTIME_PUT_BYTES, device, 0).cpu()
        t0 = time.perf_counter()
        ref = rt.put(host)
        put_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = rt.get(ref, timeout=timeout)
        get_s = time.perf_counter() - t0
        assert back.dtype == torch.bfloat16 and back.device.type == "cpu", (back.dtype, back.device)
        assert torch.equal(back.view(torch.int16), host.view(torch.int16)), "put/get changed the bits"
        out["put_get"] = dict(mib=RUNTIME_PUT_BYTES / 2**20, put_ms=1e3 * put_s, get_ms=1e3 * get_s,
                              put_gb_s=RUNTIME_PUT_BYTES / put_s / 1e9,
                              get_gb_s=RUNTIME_PUT_BYTES / get_s / 1e9, equal=True)
        del ref, back, host

        # A CUDA tensor through the object store: made on the card by a GPU
        # task, read back on the host with its dtype, shape and bits.
        make = rt.remote(**gpu)(runtime_cuda_tensor)
        t0 = time.perf_counter()
        pid, first = rt.get(make.remote(device), timeout=timeout)  # starts the worker, CUDA context
        first_s = time.perf_counter() - t0
        pids.add(pid)
        t0 = time.perf_counter()
        pid, got = rt.get(make.remote(device), timeout=timeout)
        warm_s = time.perf_counter() - t0
        pids.add(pid)
        want = seeded_bf16(RUNTIME_CUDA_BYTES, device, RUNTIME_CUDA_SEED).cpu()
        for t in (first, got):
            assert t.device.type == "cpu" and t.dtype == torch.bfloat16 and t.shape == want.shape, (
                t.device, t.dtype, t.shape)
            assert torch.equal(t.view(torch.int16), want.view(torch.int16)), "the CUDA return changed bits"
        out["cuda_return"] = dict(mib=RUNTIME_CUDA_BYTES / 2**20, first_call_s=first_s, ms=1e3 * warm_s,
                                  gb_s=RUNTIME_CUDA_BYTES / warm_s / 1e9, equal=True)
        del first, got, want

        # A GPU actor serves phase 3's traffic on phase 3's engine.
        t0 = time.perf_counter()
        server = rt.remote(**gpu)(RuntimeServer).remote()
        pids.add(rt.get(server.ready.remote(), timeout=timeout))
        start_s = time.perf_counter() - t0
        traffic = serve_run["traffic"]
        res = rt.get(server.serve.remote(traffic["warmup"], traffic["prompts"]), timeout=timeout)
        pids.add(res["pid"])
        assert res["pid"] != os.getpid()
        assert res["streams"] == traffic["streams"], "the actor's greedy streams differ from serve's"
        assert res["launches"] == {"flash_fwd": serve_run["launches"], "flash_bwd": 0}, res["launches"]
        if device == "cuda":
            assert res["device"] == torch.cuda.get_device_name(0), res["device"]
        out["actor"] = dict(pid=res["pid"], device=res["device"], start_s=start_s,
                            peak_mem_gb=res["peak_mem_gb"], decode_tok_s=res["decode_tok_s"],
                            serve_decode_tok_s=serve_run["decode_tok_s"],
                            serve_peak_mem_gb=serve_run["peak_mem_gb"], launches=res["launches"],
                            streams_equal_serve=True)

        # GPU accounting: while the actor holds the one GPU, a second GPU
        # demand stays unscheduled; after kill(actor) it runs.
        probe = rt.remote(**gpu)(runtime_probe).remote()
        ready, _ = rt.wait([probe], timeout=RUNTIME_WAIT_S)
        waited = not ready
        t0 = time.perf_counter()
        rt.kill(server)
        kill_s = time.perf_counter() - t0
        while rt.available_resources().get("GPU", 0.0) < cards and time.perf_counter() - t0 < timeout:
            time.sleep(0.01)
        freed_s = time.perf_counter() - t0
        probe_pid = rt.get(probe, timeout=timeout)
        out["gpu_accounting"] = dict(waited_while_held=waited, wait_s=RUNTIME_WAIT_S, kill_s=kill_s,
                                     gpu_free_after_kill_s=freed_s,
                                     ran_after_kill_s=time.perf_counter() - t0,
                                     probe_on_new_worker=probe_pid not in pids)
        pids.add(probe_pid)
        if device == "cuda":
            assert waited, "a second num_gpus=1 task ran while the actor held the GPU"

        # A GPU task takes one training step on the train path's batch.
        tr = rt.get(rt.remote(**gpu)(runtime_train_step).remote(device), timeout=timeout)
        pids.add(tr["pid"])
        (l_d, n_d), step_d = train_run["checks"]["kernel"], train_run["losses"][0]
        n_layer = train_config().n_layer  # "mlp" remat: one forward and one backward a layer
        assert tr["launches"] == {"flash_fwd": n_layer, "flash_bwd": n_layer}, tr["launches"]
        assert abs(tr["loss"] - l_d) <= TRAIN_LOSS_TOL, (tr["loss"], l_d)
        assert abs(tr["grad_norm"] - n_d) / n_d <= TRAIN_GNORM_TOL, (tr["grad_norm"], n_d)
        assert abs(tr["step_loss"] - step_d) <= TRAIN_LOSS_TOL, (tr["step_loss"], step_d)
        out["train_task"] = dict(tr, train_loss=l_d, train_grad_norm=n_d, train_step_loss=step_d,
                                 bit_equal=dict(loss=tr["loss"] == l_d, grad_norm=tr["grad_norm"] == n_d,
                                                step_loss=tr["step_loss"] == step_d))
        # The train tier: TorchTrainer fits in this session.
        t_loop = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            loop = train_loop(rt, device, tmp, dp2_ref)
        loop["phase_s"] = time.perf_counter() - t_loop
        pids.update(loop.pop("pids"))
        out["train_loop"] = loop
        # The serve tier: build_openai_app deployed with serve.run.
        out["serve_app"] = serve_app(rt, card, device, stream_bound, pids)
        # Device objects, then the data tier feeding training and batch
        # inference.
        out["device_objects"] = device_objects_path(rt, device, pids)
        with tempfile.TemporaryDirectory() as tmp:
            out["train_data"] = train_data_path(rt, device, tmp, pids)
        out["batch_data"] = batch_data_path(device, pids)
        for node in rt_api._runtime.nodes:
            pids.update(w.proc.pid for w in node.workers.values() if w.proc is not None)
    finally:
        rt.shutdown()

    # Nothing of the session survives: no worker process, no compute app.
    out["workers_seen"] = len(pids)
    survivors = live_workers(pids)
    assert not survivors, f"worker processes survived shutdown(): {survivors}"
    if device == "cuda":
        apps = {int(p) for p in nvidia_smi("--query-compute-apps=pid") if p.isdigit()}
        assert not apps & pids, f"worker pids still hold the card: {sorted(apps & pids)}"
        out["compute_apps_after"] = sorted(apps)
    out["native_copy_path"] = _native.copy_path()
    out["launches"] = {"flash_fwd": res["launches"]["flash_fwd"] + tr["launches"]["flash_fwd"],
                       "flash_bwd": res["launches"]["flash_bwd"] + tr["launches"]["flash_bwd"]}
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# The train tier on the card (train_loop): TorchTrainer.fit over the port's
# runtime, inside the runtime phase's session. Case 1: one worker on the
# card trains GPT-2-125M LOOP_STEPS steps, batches through the device
# prefetch iterator, each loss reported as a CUDA tensor through the async
# ring, the state saved sharded at LOOP_CKPT_STEPS; its first attempt
# fails after LOOP_FAIL_AFTER and the rebuilt group resumes from the
# checkpoint. Case 2: two workers sharing the card over gloo, dp=2.
LOOP_STEPS = 6
LOOP_FAIL_AFTER = 3
LOOP_CKPT_STEPS = (LOOP_FAIL_AFTER, LOOP_STEPS)
LOOP_RING_DEPTH = 4
LOOP_PREFETCH_DEPTH = 2
LOOP_DP2_STEPS = 2
LOOP_TIMEOUT_S = 600
LOOP_GPU_HELD_S = 120  # the dp=2 group must hold the GPU resource within this


def loop_batches(cfg, rows: int, n: int, pin: bool) -> list:
    """``n`` host batches of [rows, max_seq] tokens drawn in turn from phase
    10's batch seed (1) on the CPU, pinned where there is a card."""
    g = torch.Generator().manual_seed(1)
    out = []
    for _ in range(n):
        tokens = torch.randint(0, cfg.vocab_size, (rows, cfg.max_seq), generator=g)
        batch = {"tokens": tokens, "targets": tokens.roll(-1, dims=1)}
        out.append({k: v.pin_memory() for k, v in batch.items()} if pin else batch)
    return out


def state_digests(state) -> dict:
    """sha1 of each tensor leaf's bytes (on the host), by its path."""
    import hashlib

    out = {}
    for key, leaf, _ in sharded_checkpoint._flatten(sharded_checkpoint._tree_of(state), None):
        if isinstance(leaf, torch.Tensor):
            raw = leaf.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()
            out[key] = hashlib.sha1(raw).hexdigest()
    return out


def loop_train_fn(config):
    """Case 1's train loop, in the worker (TorchTrainer's train fn): resume
    from the checkpoint where there is one, then one report a step with the
    loss as a CUDA tensor, the step's launches (counted in this process,
    zeroed just before the step and read just after) and the wall clock."""
    import ray_tpu_torch.train as rtrain
    from ray_tpu_torch.train import torch_backend

    t_entry = time.time()
    dev = torch_backend.train_device()
    cfg = train_config()
    model, _, opt, state = train_setup(dev, cfg)
    ckpt = rtrain.get_checkpoint()
    start = 0
    if ckpt is not None:
        state = rtrain.load_sharded_state(ckpt, sharded_checkpoint.restore_template(state))
        start = state["step"]
    step = spmd.make_train_step(functools.partial(model.loss_fn, cfg=cfg), opt)
    batches = loop_batches(cfg, TRAIN_B, LOOP_STEPS, pin=dev.type == "cuda")[start:]
    flightrec.reset()
    feed = rtrain.DevicePrefetchIterator(iter(batches), depth=LOOP_PREFETCH_DEPTH, device=dev)
    for i, batch in enumerate(feed, start=start + 1):
        attention.flash_fwd_launches = attention.flash_bwd_launches = 0  # zeroed just before the step
        state, m = step(state, batch)
        rec = {"step": i, "loss": m["loss"], "attempt": 1 if ckpt is None else 2,
               "flash_fwd": attention.flash_fwd_launches,  # read just after
               "flash_bwd": attention.flash_bwd_launches, "t": time.time(), "pid": os.getpid()}
        if i == start + 1:
            rec.update(t_entry=t_entry, device=str(dev),
                       resumed_from=os.path.basename(ckpt.path) if ckpt is not None else None)
        rtrain.report(rec, sharded_state=state if i in LOOP_CKPT_STEPS else None)
        if ckpt is None and i == LOOP_FAIL_AFTER:
            loop_record(rec["attempt"])
            raise RuntimeError(f"injected failure after step {i} (first attempt)")
    loop_record(rec["attempt"], digests=state_digests(state))


def loop_record(attempt: int, **extra) -> None:
    """This worker's record of its attempt, written beside the run's
    checkpoints once its last report is in (the worker ends with the
    attempt): the ring's host-blocked readbacks
    (``raytpu_train_host_blocked_seconds``), the ``train`` ring's phases,
    the peak memory, and ``extra`` (the last attempt's state digests)."""
    import ray_tpu_torch.train as rtrain

    ctx = rtrain.get_context()
    ctx.flush()
    points = {(n, frozenset(t.items())): v for n, t, v in metrics.registry().snapshot()["points"]}
    ring = flightrec.snapshot(planes=["train"])["rings"].get("train", {"events": []})
    record = dict(host_blocked=hist_summary("raytpu_train_host_blocked_seconds", points, {}),
                  phases=phase_ms(ring["events"]), peak_mem_gb=peak_gb(), **extra)
    with open(os.path.join(ctx.storage.experiment_dir, f"attempt_{attempt}.json"), "w") as f:
        json.dump(record, f)


def loop_dp2_fn(config):
    """Case 2's train loop, in each of two workers sharing the card over
    gloo: GPT-2-125M under MeshSpec(dp=2) on the global batch [2 * TRAIN_B,
    max_seq], the gradient half once (loss, norm) and LOOP_DP2_STEPS steps
    with the launch counts zeroed just before and read just after; rank 0
    reports every rank's numbers (gathered), and the state is saved."""
    import ray_tpu_torch.train as rtrain
    from ray_tpu_torch.train import torch_backend

    dev = torch_backend.train_device()
    cfg = train_config()
    mesh = make_mesh(MeshSpec(dp=2), dev.type)
    opt = spmd.default_optimizer(warmup_steps=2, total_steps=20)
    batch = mesh_batch(cfg, 2 * TRAIN_B, dev)
    step, state, shardings = mesh_setup(cfg, mesh, opt, dev, torch.Generator().manual_seed(0), batch)
    rec = loss_and_norm(cfg, state["params"], batch, shardings, mesh)
    attention.flash_fwd_launches = attention.flash_bwd_launches = 0  # zeroed just before the steps
    rec["losses"] = [step(state, batch)[1]["loss"].item() for _ in range(LOOP_DP2_STEPS)]
    rec["launches"] = {"flash_fwd": attention.flash_fwd_launches,  # read just after
                       "flash_bwd": attention.flash_bwd_launches}
    rec.update(pid=os.getpid(), device=str(dev), backend=dist.get_backend(),
               rank=rtrain.get_context().get_world_rank(), peak_mem_gb=peak_gb())
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, rec)
    params = state_digests({"params": state["params"]}) if rec["rank"] == 0 else None
    rtrain.report({"ranks": ranks, "param_digests": params}, sharded_state=state)


def train_loop(rt, device: str, tmp: str, dp2_ref: dict | None = None) -> dict:
    """The train tier on the card (see the module docstring, phase 17):
    two TorchTrainer fits in the runtime phase's session, whose cluster has
    one ``GPU`` unit. ``dp2_ref`` is train_shard's unsharded step at the dp2
    case's batch (computed here where it is None)."""
    from ray_tpu_torch.train import (FailureConfig, RunConfig, ScalingConfig, TorchConfig,
                                     TorchTrainer)

    cuda = device == "cuda"
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    out, pids = {}, set()
    saved = (GLOBAL_CONFIG.train_async_dispatch, GLOBAL_CONFIG.train_async_dispatch_depth)
    GLOBAL_CONFIG.train_async_dispatch, GLOBAL_CONFIG.train_async_dispatch_depth = True, LOOP_RING_DEPTH
    try:
        # Case 1: one worker on the card; the first attempt fails after
        # step LOOP_FAIL_AFTER and the rebuilt group resumes.
        t0_wall, t0 = time.time(), time.perf_counter()
        result = TorchTrainer(
            loop_train_fn,
            train_loop_config={},
            scaling_config=ScalingConfig(num_workers=1, resources_per_worker={"GPU": 1}),
            torch_config=TorchConfig() if cuda else TorchConfig(backend="gloo", device="cpu"),
            run_config=RunConfig(name="train_loop", storage_path=os.path.join(tmp, "one"),
                                 failure_config=FailureConfig(max_failures=1)),
        ).fit()
        fit_s = time.perf_counter() - t0
        hist = result.metrics_history
        assert [m["step"] for m in hist] == list(range(1, LOOP_STEPS + 1)), [m["step"] for m in hist]
        attempts = [m["attempt"] for m in hist]
        assert attempts == [1] * LOOP_FAIL_AFTER + [2] * (LOOP_STEPS - LOOP_FAIL_AFTER), attempts
        assert all(type(m["loss"]) is float and math.isfinite(m["loss"]) for m in hist), hist
        first, resumed = hist[0], hist[LOOP_FAIL_AFTER]
        assert resumed["resumed_from"] == f"checkpoint_{LOOP_FAIL_AFTER - 1:06d}", resumed
        assert os.path.basename(result.checkpoint.path) == f"checkpoint_{LOOP_STEPS - 1:06d}"
        n_layer = train_config().n_layer  # "mlp" remat: one forward and one backward a layer
        if cuda:
            assert all((m["flash_fwd"], m["flash_bwd"]) == (n_layer, n_layer) for m in hist), hist
            assert first["device"] == resumed["device"] == "cuda:0", (first, resumed)
        pids.update(m["pid"] for m in hist)
        assert len({first["pid"], resumed["pid"]}) == 2, "the rebuilt group reused the failed worker"

        # The same six steps in this process, from the same seeds and batches.
        model, _, opt, ref_state = train_setup(dev, train_config())
        step = spmd.make_train_step(functools.partial(model.loss_fn, cfg=train_config()), opt)
        ref = [step(ref_state, {k: v.to(dev) for k, v in b.items()})[1]["loss"].item()
               for b in loop_batches(train_config(), TRAIN_B, LOOP_STEPS, pin=cuda)]
        losses = [m["loss"] for m in hist]
        diffs = [abs(a - b) for a, b in zip(losses, ref)]
        assert max(diffs) <= TRAIN_LOSS_TOL, (losses, ref)

        # The final checkpoint, restored whole on the host: each leaf's
        # digest the one the worker took of the state it saved.
        records = [json.loads(Path(result.path, f"attempt_{a}.json").read_text()) for a in (1, 2)]
        whole = sharded_checkpoint.restore_template(ref_state, device="cpu")
        restored = sharded_checkpoint.load_sharded_state(result.checkpoint, whole)
        got = state_digests(restored)
        assert got == records[1].pop("digests"), "the restored checkpoint differs from the saved state"
        assert restored["step"] == LOOP_STEPS
        inproc = state_digests(ref_state)
        del restored, ref_state
        out["case1"] = dict(
            model="GPT2Config", batch=[TRAIN_B, train_config().max_seq], steps=LOOP_STEPS,
            remat=train_config().remat, ring_depth=LOOP_RING_DEPTH,
            prefetch_depth=LOOP_PREFETCH_DEPTH, losses=losses, inprocess_losses=ref,
            max_loss_diff=max(diffs), loss_tol=TRAIN_LOSS_TOL,
            losses_bit_equal=losses == ref, state_bit_equal_inprocess=got == inproc,
            attempts=attempts, failed_after=LOOP_FAIL_AFTER, resumed_from=resumed["resumed_from"],
            final_checkpoint=os.path.basename(result.checkpoint.path), digests_equal=True,
            launches_per_step={"flash_fwd": first["flash_fwd"], "flash_bwd": first["flash_bwd"]},
            fit_s=fit_s, first_worker_start_s=first["t_entry"] - t0_wall,
            rebuild_s=resumed["t_entry"] - hist[LOOP_FAIL_AFTER - 1]["t"],
            step_wall_s=[b["t"] - a["t"] for a, b in zip(hist, hist[1:])],
            worker_telemetry=records,
        )
        launches = {"flash_fwd": sum(m["flash_fwd"] for m in hist),
                    "flash_bwd": sum(m["flash_bwd"] for m in hist)}
        out["launches"] = launches
        log("train_loop case1", json.dumps(out["case1"]))
        if cuda:
            torch.cuda.empty_cache()

        # Case 2: two workers sharing the card over gloo, dp=2. While they
        # hold the GPU resource, a third demand waits.
        box = {}
        t0 = time.perf_counter()
        fit = TorchTrainer(
            loop_dp2_fn,
            train_loop_config={},
            scaling_config=ScalingConfig(num_workers=2, resources_per_worker={"GPU": 0.5}),
            torch_config=TorchConfig(backend="gloo", device=device),
            run_config=RunConfig(name="train_loop_dp2", storage_path=os.path.join(tmp, "dp2")),
        )
        th = threading.Thread(target=lambda: box.setdefault("result", fit.fit()), daemon=True)
        th.start()
        deadline = time.perf_counter() + LOOP_GPU_HELD_S
        while rt.available_resources().get("GPU", 0.0) > 0.0 and time.perf_counter() < deadline:
            time.sleep(0.01)
        held_s = time.perf_counter() - t0
        probe = rt.remote(num_gpus=0.5)(runtime_probe).remote()
        ready, _ = rt.wait([probe], timeout=RUNTIME_WAIT_S)
        th.join(LOOP_TIMEOUT_S)
        assert not th.is_alive() and "result" in box, "the dp=2 fit did not finish"
        fit2_s = time.perf_counter() - t0
        pids.add(rt.get(probe, timeout=RUNTIME_TIMEOUT_S))
        accounting = dict(gpu_held_after_s=held_s, waited_while_held=not ready, wait_s=RUNTIME_WAIT_S,
                          ran_after_fit=True)
        assert held_s < LOOP_GPU_HELD_S, "the dp=2 group never held the GPU resource"
        assert accounting["waited_while_held"], "a GPU demand ran while the dp=2 group held it"
        result2 = box["result"]
        ranks = result2.metrics["ranks"]
        want = dp2_ref or unsharded_step(train_config(), 2 * TRAIN_B, dev)
        for r in ranks:
            assert abs(r["loss"] - want["loss"]) <= TRAIN_LOSS_TOL, (r, want)
            assert abs(r["gnorm"] - want["gnorm"]) / want["gnorm"] <= TRAIN_GNORM_TOL, (r, want)
            assert all(math.isfinite(x) for x in r["losses"]), r
            if cuda:
                assert r["launches"] == {"flash_fwd": LOOP_DP2_STEPS * n_layer,
                                         "flash_bwd": LOOP_DP2_STEPS * n_layer}, r
                assert (r["device"], r["backend"]) == ("cuda:0", "gloo"), r
        pids.update(r["pid"] for r in ranks)
        restored = sharded_checkpoint.load_sharded_state(result2.checkpoint, whole)
        assert state_digests({"params": restored["params"]}) == result2.metrics["param_digests"]
        assert restored["step"] == LOOP_DP2_STEPS
        del restored
        out["case2"] = dict(
            mesh=dict(dp=2), batch=[2 * TRAIN_B, train_config().max_seq], backend="gloo",
            ranks=ranks, unsharded=dict(loss=want["loss"], gnorm=want["gnorm"]),
            restored_whole=True, fit_s=fit2_s, gpu_accounting=accounting,
        )
        out["launches_dp2"] = {k: sum(r["launches"][k] for r in ranks) for k in KERNELS}
        log("train_loop case2", json.dumps(out["case2"]))
    finally:
        GLOBAL_CONFIG.train_async_dispatch, GLOBAL_CONFIG.train_async_dispatch_depth = saved
    out["pids"] = sorted(pids)
    return out


# The serve tier on the card (serve_app): build_openai_app deployed with
# serve.run, as a user deploys it, inside the runtime phase's session. The
# traffic is phase 3's six prompts as text (the endpoint takes text); the
# replica's own counts are read in its process through SmokeLLMServer.
SERVE_APP_TIMEOUT_S = 300
SERVE_APP_WARMUP = "a warm-up request for the serving replica"
SERVE_APP_ONE = "x"  # the max_tokens=1 request (tests/test_llm.py:219-222)


def serve_app_texts(seed: int = 0) -> dict:
    """Phase 3's six prompts as text: 20, 100, 300, 1000, 94 and 114 bytes of
    seeded lowercase letters and spaces, the last two sharing a 64-byte
    prefix."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz     "))
    text = lambda n: "".join(rng.choice(letters, n))  # noqa: E731
    prefix = text(64)
    return {"p20": text(20), "p100": text(100), "p300": text(300), "p1000": text(1000),
            "shared_a": prefix + text(30), "shared_b": prefix + text(50)}


class SmokeLLMServer(LLMServer):
    """``LLMServer`` as ``build_openai_app`` deploys it, plus what this script
    reads in the replica's own process (launch counts are per process): its
    pid, card and peak memory, the kernels' launch counts and its engine's
    counters (zeroed on request), its fresh dense prefills, the host time of
    each engine step (admissions included) and the prompt and token ids of
    every request it finished. Serving is LLMServer's."""

    def __init__(self, config, *, device="cuda"):
        super().__init__(config, device=device)
        self.ready_wall = time.time()
        self.fresh_prefills, self.finished_ids, self.stats0 = 0, [], dict(self.engine.stats)
        self.step_s = []
        fresh = self.engine._prefill_impl

        def counted(*a, **kw):
            self.fresh_prefills += 1
            return fresh(*a, **kw)

        self.engine._prefill_impl = counted

    def _step_with_admissions(self):
        t0 = time.perf_counter()
        finished, more = super()._step_with_admissions()
        self.step_s.append(time.perf_counter() - t0)
        self.finished_ids += [(list(r.prompt), list(r.generated)) for r in finished]
        return finished, more

    def zero_counts(self) -> int:
        attention.flash_fwd_launches = attention.flash_bwd_launches = 0  # zeroed just before the path
        self.fresh_prefills, self.finished_ids, self.stats0 = 0, [], dict(self.engine.stats)
        self.step_s = []
        return os.getpid()

    def counts(self) -> dict:
        stats = {k: v - self.stats0.get(k, 0) for k, v in self.engine.stats.items()}
        return dict(pid=os.getpid(), device=str(self.engine.device), card=card_name(),
                    ready_wall=self.ready_wall, peak_mem_gb=peak_gb(), paged=self.engine.paged,
                    launches={"flash_fwd": attention.flash_fwd_launches,  # read just after
                              "flash_bwd": attention.flash_bwd_launches},
                    fresh_prefills=self.fresh_prefills, stats=stats, finished=self.finished_ids,
                    steps=len(self.step_s), step_ms_median=1e3 * median(self.step_s) if self.step_s else 0.0,
                    step_s_total=sum(self.step_s))


def smoke_app(config, name: str, device: str, **kw):
    """``build_openai_app``'s deployment, options and bound arguments, with
    SmokeLLMServer as its callable."""
    from ray_tpu_torch.serve.api import Deployment

    app = build_openai_app(config, name=name, device=device, **kw)
    return Deployment(SmokeLLMServer, app.deployment._config).bind(*app.args, **app.kwargs)


def replica_call(rt, replica, method: str):
    """Call a method of one replica's callable through its actor."""
    from ray_tpu_torch.core import serialization

    payload = serialization.dumps(((), {}))[0]
    return rt.get(replica.handle.remote(method, payload), timeout=SERVE_APP_TIMEOUT_S)


def routing(rt, name: str) -> dict:
    ctrl = rt.get_actor("serve::controller")
    return rt.get(ctrl.get_routing.remote(name, -1), timeout=60)


def http_post(port: int, path: str, body: dict) -> tuple[dict, float]:
    t0 = time.perf_counter()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=SERVE_APP_TIMEOUT_S) as r:
        out = json.loads(r.read())
    return out, time.perf_counter() - t0


def http_sse(port: int, path: str, body: dict) -> tuple[list, float, float]:
    """The SSE events of one streamed request, the seconds to the first
    event and to ``[DONE]``."""
    payload = json.dumps(body).encode()
    t0 = time.perf_counter()
    first, buf = None, b""
    with socket.create_connection(("127.0.0.1", port), timeout=SERVE_APP_TIMEOUT_S) as sock:
        sock.sendall(f"POST {path} HTTP/1.1\r\nHost: 127.0.0.1\r\nContent-Type: application/json\r\n"
                     f"Content-Length: {len(payload)}\r\nConnection: close\r\n\r\n".encode() + payload)
        while data := sock.recv(65536):
            buf += data
            if first is None and b"data: " in buf:
                first = time.perf_counter() - t0
    total = time.perf_counter() - t0
    head, _, rest = buf.partition(b"\r\n\r\n")
    assert b"200 OK" in head.splitlines()[0], head
    events = [e.decode().strip() for e in rest.split(b"\n\n") if e.strip()]
    assert events[-1] == "data: [DONE]", events[-3:]
    return [json.loads(e[len("data: "):]) for e in events[:-1]], first, total


def served_streams(counts: dict, prompts: dict, tokenizer) -> dict:
    """The replica's token ids for each named prompt."""
    by_prompt = {tuple(p): g for p, g in counts["finished"]}
    return {name: by_prompt[tuple(tokenizer.encode(text))] for name, text in prompts.items()}


def check_text(body: dict, ids: list, tokenizer) -> None:
    """A completion's text and count are those of the replica's ids."""
    text = tokenizer.decode([t for t in ids if t != tokenizer.eos_id])
    assert body["choices"][0]["text"] == text, (body, ids)
    assert body["usage"]["completion_tokens"] == len(ids), (body, ids)


def reference_streams(fields: dict, prompts: dict, tokenizer) -> dict:
    """The same texts through an engine of the same fields in this process:
    its streams and the f32 logits of every position it sampled."""
    engine = build_engine(fields)
    logits_at = record_sampled_logits(engine)
    ids = {name: tokenizer.encode(text) for name, text in prompts.items()}
    run = drive(engine, ids, SamplingParams(max_tokens=MAX_TOKENS))
    out = dict(streams=run["streams"], logits_at=logits_at, n_layer=engine.model_config.n_layer)
    del engine
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def handoffs_counted(deployment: str) -> float:
    return sum(v for n, tags, v in metrics.registry().snapshot()["points"]
               if n == "raytpu_serve_disagg_handoffs_total" and tags.get("deployment") == deployment)


def serve_app(rt, card: str, device: str, stream_bound: float, pids: set) -> dict:
    """The serve tier on the card (see the module docstring, phase 19), in
    the runtime phase's session; every replica's pid joins ``pids``."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve import api as serve_api

    t_phase = time.perf_counter()
    texts = serve_app_texts()
    tok = ByteTokenizer()
    out = dict(card=card, prompt_bytes={k: len(v) for k, v in texts.items()})
    try:
        # (a) Unified: GPT-2-125M on the dense cache, one replica on the card.
        t0, t0_wall = time.perf_counter(), time.time()
        serve.run(smoke_app(LLMConfig(seed=0, kv_block_size=0, placement={"num_cpus": 1, "num_gpus": 1}),
                            "llm", device), wait_timeout_s=SERVE_APP_TIMEOUT_S)
        deploy_s = time.perf_counter() - t0
        (replica,) = routing(rt, "llm")["replicas"]
        port = serve_api.proxy_port()
        http_post(port, "/llm/v1/completions", {"prompt": SERVE_APP_WARMUP, "max_tokens": 2})
        pids.add(replica_call(rt, replica, "zero_counts"))
        bodies, latency = {}, {}

        def fire(name):
            bodies[name], latency[name] = http_post(
                port, "/llm/v1/completions", {"prompt": texts[name], "max_tokens": MAX_TOKENS})

        threads = [threading.Thread(target=fire, args=(name,)) for name in texts]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(SERVE_APP_TIMEOUT_S)
        batch_s = time.perf_counter() - t0
        assert set(bodies) == set(texts), sorted(bodies)
        chat = {"messages": [{"role": "user", "content": texts["p100"]}], "max_tokens": MAX_TOKENS}
        chunks, ttfb_s, stream_s = http_sse(port, "/llm/v1/chat/completions", dict(chat, stream=True))
        whole, chat_s = http_post(port, "/llm/v1/chat/completions", chat)
        one, one_s = http_post(port, "/llm/v1/completions", {"prompt": SERVE_APP_ONE, "max_tokens": 1})
        counts = replica_call(rt, replica, "counts")
        pids.add(counts["pid"])

        streamed = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
        assert streamed == whole["choices"][0]["message"]["content"], (streamed, whole)
        assert chunks[-1]["choices"][0]["finish_reason"] == "stop", chunks[-1]
        assert one["usage"]["completion_tokens"] == 1, one
        streams = served_streams(counts, texts, tok)
        for name in texts:
            check_text(bodies[name], streams[name], tok)
        ref = reference_streams(dict(kv_block_size=0), texts, tok)
        divergences = compare_streams(ref, {"streams": streams}, stream_bound)
        hits = counts["stats"]["prefix_hits"]
        fresh = counts["fresh_prefills"]
        assert fresh >= 1 and fresh == len(counts["finished"]) - hits, (fresh, len(counts["finished"]), hits)
        assert counts["launches"] == {"flash_fwd": ref["n_layer"] * fresh, "flash_bwd": 0}, counts["launches"]
        if device == "cuda":
            assert counts["device"] == "cuda:0" and counts["card"] == torch.cuda.get_device_name(0), counts
        generated = sum(b["usage"]["completion_tokens"] for b in bodies.values())
        out["unified"] = dict(
            model="GPT2Config", paged=False, slots=16, max_seq=2048, deploy_s=deploy_s,
            replica_start_s=counts["ready_wall"] - t0_wall, replica_pid=counts["pid"],
            replica_device=counts["device"], replica_peak_mem_gb=counts["peak_mem_gb"],
            http_latency_s=latency, batch_wall_s=batch_s, http_tok_s=generated / batch_s,
            stream_ttfb_s=ttfb_s, stream_s=stream_s, chat_s=chat_s, max_tokens_1_s=one_s,
            generated=generated, fresh_prefills=fresh, prefix_hits=hits,
            requests=len(counts["finished"]), launches=counts["launches"],
            replica_steps=counts["steps"], replica_step_ms_median=counts["step_ms_median"],
            replica_step_s_total=counts["step_s_total"],
            divergences=divergences, streams_equal=not divergences, streaming_equal=True)
        log("serve_app unified", json.dumps(out["unified"]))
        serve.delete("llm")

        # (b) Disaggregated: GPT-2-125M on the paged cache, one prefill and
        # one decode replica sharing the card.
        t0, t0_wall = time.perf_counter(), time.time()
        h = serve.run(smoke_app(LLMConfig(seed=0, placement={"num_cpus": 1, "num_gpus": 0.5}), "dllm",
                                device, num_replicas=1, prefill_replicas=1),
                      wait_timeout_s=SERVE_APP_TIMEOUT_S)
        deploy_s = time.perf_counter() - t0
        table = routing(rt, "dllm")
        roles = table["disagg"]["roles"]
        assert sorted(roles.values()) == ["decode", "prefill"], roles
        by_role = {roles[r._actor_id]: r for r in table["replicas"]}

        def ask(prompt, max_tokens=MAX_TOKENS):
            return h.remote({"path": "/dllm/v1/completions",
                             "body": {"prompt": prompt, "max_tokens": max_tokens}})

        ask(SERVE_APP_WARMUP, 2).result(timeout=SERVE_APP_TIMEOUT_S)
        for r in by_role.values():
            pids.add(replica_call(rt, r, "zero_counts"))
        h0 = handoffs_counted("dllm")
        t0 = time.perf_counter()
        futs = {name: ask(text) for name, text in texts.items()}
        dbodies = {name: f.result(timeout=SERVE_APP_TIMEOUT_S) for name, f in futs.items()}
        dbatch_s = time.perf_counter() - t0
        handoffs = handoffs_counted("dllm") - h0
        assert handoffs == len(texts), handoffs  # one a handle request
        via_http, dhttp_s = http_post(port, "/dllm/v1/completions",
                                      {"prompt": texts["p300"], "max_tokens": MAX_TOKENS})
        dcounts = {role: replica_call(rt, r, "counts") for role, r in by_role.items()}
        pids.update(c["pid"] for c in dcounts.values())
        dec, pre = dcounts["decode"], dcounts["prefill"]
        assert dec["stats"]["prefill_tokens"] == 0, dec["stats"]  # the decode tier never prefilled
        assert dec["stats"]["handoffs_in"] == len(texts) + 1, dec["stats"]
        assert dec["stats"]["kv_fallbacks"] == pre["stats"]["kv_fallbacks"] == 0, (dec["stats"], pre["stats"])
        for c in (dec, pre):
            assert c["paged"] and c["launches"] == {"flash_fwd": 0, "flash_bwd": 0}, c["launches"]
        dstreams = served_streams(dec, texts, tok)
        for name in texts:
            check_text(dbodies[name], dstreams[name], tok)
        check_text(via_http, dstreams["p300"], tok)
        dref = reference_streams(dict(), texts, tok)
        ddivergences = compare_streams(dref, {"streams": dstreams}, stream_bound)

        # The kill switch: one flag in this process, and its router no
        # longer takes the two-hop.
        saved = GLOBAL_CONFIG.disagg
        GLOBAL_CONFIG.disagg = False
        try:
            off = ask(texts["p20"]).result(timeout=SERVE_APP_TIMEOUT_S)
            assert off["object"] == "text_completion" and off["usage"]["completion_tokens"] >= 1, off
            assert handoffs_counted("dllm") - h0 == handoffs, "the kill switch took the two-hop"
        finally:
            GLOBAL_CONFIG.disagg = saved
        dgen = sum(b["usage"]["completion_tokens"] for b in dbodies.values())
        out["disagg"] = dict(
            model="GPT2Config", paged=True, roles=sorted(roles.values()), deploy_s=deploy_s,
            replica_start_s={role: c["ready_wall"] - t0_wall for role, c in dcounts.items()},
            replica_peak_mem_gb={role: c["peak_mem_gb"] for role, c in dcounts.items()},
            replica_device={role: c["device"] for role, c in dcounts.items()},
            handle_batch_wall_s=dbatch_s, handle_tok_s=dgen / dbatch_s, http_latency_s=dhttp_s,
            handoffs=handoffs, handoffs_in=dec["stats"]["handoffs_in"],
            decode_prefill_tokens=dec["stats"]["prefill_tokens"],
            prefill_prefill_tokens=pre["stats"]["prefill_tokens"],
            kv_fallbacks={role: c["stats"]["kv_fallbacks"] for role, c in dcounts.items()},
            launches={role: c["launches"] for role, c in dcounts.items()},
            replica_steps={role: c["steps"] for role, c in dcounts.items()},
            replica_step_ms_median={role: c["step_ms_median"] for role, c in dcounts.items()},
            divergences=ddivergences, streams_equal=not ddivergences, kill_switch_answered=True)
        log("serve_app disagg", json.dumps(out["disagg"]))
        out["launches"] = dict(counts["launches"])
        out["launches_disagg"] = {k: dec["launches"][k] + pre["launches"][k] for k in KERNELS}
        serve.delete("dllm")
    finally:
        serve.shutdown()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# Device objects on the card (device_objects), in the runtime phase's
# session: a CUDA tensor handed between two GPU actors over the transfer
# fabric with its bits kept, an explicit device_put/get/free, and a
# multi-world handoff of a row-split tensor assembled whole here.
DEVOBJ_BYTES = RUNTIME_CUDA_BYTES  # the runtime phase's CUDA return, side by side
DEVOBJ_SEED = RUNTIME_CUDA_SEED
MW_SHAPE = (8192, 4096)  # bf16: 64 MiB, two row halves of 32 MiB
MW_SEED = 5
DEVOBJ_TIMEOUT_S = 300


def seeded_matrix(shape, device, seed: int) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(torch.bfloat16)


class DevObjActor:
    """One end of the device-object handoffs, holding half a GPU: it makes,
    takes and checks tensors on its card, and is one rank of a two-process
    world whose ranks hold the two row halves of the multi-world tensor."""

    def __init__(self, device: str):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            self.device = torch.device("cuda", torch.cuda.current_device())

    def ready(self) -> int:
        return os.getpid()

    def produce(self) -> torch.Tensor:
        """The seeded 64 MiB bf16 tensor, returned with device objects on:
        it stays here and travels as a DeviceRef (fetch budget 1)."""
        from ray_tpu_torch.experimental import enable_device_objects

        enable_device_objects(fetches_before_free=1)
        return seeded_bf16(DEVOBJ_BYTES, self.device, DEVOBJ_SEED)

    def put_explicit(self):
        """device_put with a fetch budget of 0: kept until freed."""
        from ray_tpu_torch.experimental import device_put

        return device_put(seeded_bf16(DEVOBJ_BYTES, self.device, DEVOBJ_SEED + 1),
                          fetches_before_free=0)

    def consume(self, value) -> dict:
        """``value`` arrived as an argument, fetched from its owner at
        deserialization: on this card, with the seeded bits."""
        from ray_tpu_torch.experimental import transfer_stats

        want = seeded_bf16(DEVOBJ_BYTES, self.device, DEVOBJ_SEED)
        return dict(pid=os.getpid(), device=str(value.device), dtype=str(value.dtype),
                    on_card=value.device == self.device, equal=bool(torch.equal(value, want)),
                    stats=transfer_stats())

    def fetch(self, ref) -> dict:
        """An explicit device_get of ``ref`` onto this card, timed."""
        from ray_tpu_torch.experimental import device_get, transfer_stats

        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        value = device_get(ref, device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        want = seeded_bf16(DEVOBJ_BYTES, self.device, DEVOBJ_SEED + 1)
        return dict(ms=ms, on_card=value.device == self.device, equal=bool(torch.equal(value, want)),
                    stats=transfer_stats())

    def launches(self, zero: bool = False) -> dict:
        """This process's kernel launches, then zeroed where asked."""
        got = {"flash_fwd": attention.flash_fwd_launches, "flash_bwd": attention.flash_bwd_launches}
        if zero:
            attention.flash_fwd_launches = attention.flash_bwd_launches = 0
        return got

    def store_stats(self) -> dict:
        from ray_tpu_torch.experimental import device_store_stats, transfer_stats

        return dict(store=device_store_stats(), transfer=transfer_stats())

    def join_world(self, port: int, rank: int) -> dict:
        """Join the two-rank gloo world and keep this rank's row half of
        the seeded [8192, 4096] tensor under P("dp", None)."""
        from ray_tpu_torch.experimental.multiworld import export_shards
        from ray_tpu_torch.parallel import NamedSharding

        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                                rank=rank)
        self.sharding = NamedSharding(make_mesh(MeshSpec(dp=2), self.device.type), P("dp", None))
        whole = seeded_matrix(MW_SHAPE, self.device, MW_SEED)
        self.local = self.sharding.shard(whole).clone()
        del whole
        return export_shards(self.local, self.sharding)

    def arm_for(self, positions) -> dict:
        from ray_tpu_torch.experimental.multiworld import arm_shards

        return arm_shards(self.local, positions)

    def leave_world(self) -> bool:
        dist.destroy_process_group()
        self.local = None
        return True


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def device_objects_path(rt, device: str, pids: set) -> dict:
    """Device objects on the card (see the module docstring, phase 20)."""
    from ray_tpu_torch.experimental import transfer_stats
    from ray_tpu_torch.experimental.multiworld import plan_pulls, pull_and_assemble
    from ray_tpu_torch.parallel import NamedSharding, local_mesh

    t_phase = time.perf_counter()
    cuda = device == "cuda"
    half = {"num_gpus": 0.5} if cuda else {}
    timeout = DEVOBJ_TIMEOUT_S
    actor = rt.remote(**half)(DevObjActor)
    producer, consumer = actor.remote(device), actor.remote(device)
    t0 = time.perf_counter()
    pids.update(rt.get([producer.ready.remote(), consumer.ready.remote()], timeout=timeout))
    out = dict(actors_start_s=time.perf_counter() - t0)
    try:
        # The launch counts, zeroed just before the handoffs here and in
        # both actors.
        rt.get([producer.launches.remote(zero=True), consumer.launches.remote(zero=True)],
               timeout=timeout)
        attention.flash_fwd_launches = attention.flash_bwd_launches = 0
        # (a) An actor's return handed to another actor as an argument.
        value = producer.produce.remote()
        rt.wait([value], timeout=timeout)
        held = rt.get(producer.store_stats.remote(), timeout=timeout)["store"]
        assert held["num_objects"] == 1 and held["nbytes"] == DEVOBJ_BYTES, held
        t0 = time.perf_counter()
        got = rt.get(consumer.consume.remote(value), timeout=timeout)
        wall_s = time.perf_counter() - t0
        after = rt.get(producer.store_stats.remote(), timeout=timeout)
        assert got["on_card"] and got["equal"] and got["dtype"] == "torch.bfloat16", got
        assert got["stats"]["pulls"] >= 1 and got["stats"]["fallbacks"] == 0, got["stats"]
        assert after["store"]["num_objects"] == 0, after  # budget 1: freed by the handoff
        out["intercepted"] = dict(
            mib=DEVOBJ_BYTES / 2**20, held_before=held, held_after=after["store"],
            consumer_device=got["device"], bits_equal=True, consumer_stats=got["stats"],
            producer_stats=after["transfer"], call_wall_ms=1e3 * wall_s,
            call_gb_s=DEVOBJ_BYTES / wall_s / 1e9)
        del value

        # (b) device_put / device_get / device_free, budget 0.
        ref = rt.get(producer.put_explicit.remote(), timeout=timeout)
        assert (ref.shape, ref.dtype, ref.device) == ((DEVOBJ_BYTES // 2,), "bfloat16", device), ref
        fetched = rt.get(consumer.fetch.remote(ref), timeout=timeout)
        still = rt.get(producer.store_stats.remote(), timeout=timeout)["store"]
        from ray_tpu_torch.experimental import device_free

        freed = device_free(ref)
        gone = rt.get(producer.store_stats.remote(), timeout=timeout)["store"]
        assert fetched["on_card"] and fetched["equal"], fetched
        assert fetched["stats"]["fallbacks"] == 0, fetched["stats"]
        assert still["num_objects"] == 1 and freed and gone["num_objects"] == 0, (still, freed, gone)
        out["explicit"] = dict(ms=fetched["ms"], gb_s=DEVOBJ_BYTES / fetched["ms"] / 1e6,
                               bits_equal=True, kept_until_freed=True, freed=True,
                               consumer_stats=fetched["stats"])

        # (c) Multi-world: the two actors are a two-rank world holding the
        # row halves; this process assembles the whole tensor on its card.
        port = free_port()
        catalogs = rt.get([producer.join_world.remote(port, 0), consumer.join_world.remote(port, 1)],
                          timeout=timeout)
        assert [c["process_index"] for c in catalogs] == [0, 1], catalogs
        whole = NamedSharding(local_mesh(), P())
        plan = plan_pulls(catalogs, whole, MW_SHAPE)
        assert plan == {0: [0], 1: [0]}, plan
        ranks = (producer, consumer)
        descs = rt.get([ranks[c["process_index"]].arm_for.remote(plan[c["process_index"]])
                        for c in catalogs], timeout=timeout)
        before = transfer_stats()
        target = torch.device("cuda", 0) if cuda else torch.device("cpu")
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        assembled = pull_and_assemble(catalogs, descs, whole, device=target)
        if cuda:
            torch.cuda.synchronize()
        mw_s = time.perf_counter() - t0
        stats = transfer_stats()
        want = seeded_matrix(MW_SHAPE, target, MW_SEED)
        assert assembled.device == target and torch.equal(assembled, want), "the multi-world handoff changed bits"
        pulls, fallbacks = stats["pulls"] - before["pulls"], stats["fallbacks"] - before["fallbacks"]
        assert (pulls, fallbacks) == (2, 0), stats
        rt.get([r.leave_world.remote() for r in ranks], timeout=timeout)
        mw_bytes = assembled.numel() * assembled.element_size()
        out["multiworld"] = dict(shape=list(MW_SHAPE), mib=mw_bytes / 2**20,
                                 boxes=[c["shards"][0]["box"] for c in catalogs], plan=plan,
                                 pulls=pulls, fallbacks=fallbacks, bits_equal=True,
                                 ms=1e3 * mw_s, gb_s=mw_bytes / mw_s / 1e9)
        del assembled, want
        # ... and read just after, summed over the three processes.
        counts = [{"flash_fwd": attention.flash_fwd_launches,
                   "flash_bwd": attention.flash_bwd_launches}]
        counts += rt.get([producer.launches.remote(), consumer.launches.remote()], timeout=timeout)
        out["launches"] = {k: sum(c[k] for c in counts) for k in KERNELS}
        assert out["launches"] == {"flash_fwd": 0, "flash_bwd": 0}, counts  # no kernel runs
    finally:
        for h in (producer, consumer):
            rt.kill(h)
    log("device_objects", json.dumps(out))
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# The data tier feeding the train tier on the card (train_data): a seeded
# from_numpy Dataset of int32 token rows through TorchTrainer(datasets=),
# one worker holding the card, read with iter_device_batches.
DATA_TRAIN_STEPS = 3
DATA_SEED = 11


def data_rows(cfg) -> np.ndarray:
    """[DATA_TRAIN_STEPS * TRAIN_B, max_seq + 1] int32 token rows from a
    seeded generator: each row holds its inputs and, shifted by one, its
    targets."""
    rng = np.random.default_rng(DATA_SEED)
    return rng.integers(0, cfg.vocab_size, (DATA_TRAIN_STEPS * TRAIN_B, cfg.max_seq + 1),
                        dtype=np.int32)


def data_train_fn(config):
    """train_data's train loop, in the worker: phase 10's model and initial
    state, batches from this worker's dataset shard staged on the card,
    one report a step with the loss and the step's launches (zeroed just
    before the step and read just after)."""
    import ray_tpu_torch.train as rtrain
    from ray_tpu_torch.train import torch_backend

    t_entry = time.time()
    dev = torch_backend.train_device()
    cfg = train_config()
    model, _, opt, state = train_setup(dev, cfg)
    step = spmd.make_train_step(functools.partial(model.loss_fn, cfg=cfg), opt)
    shard = rtrain.get_dataset_shard("train")
    for i, batch in enumerate(shard.iter_device_batches(batch_size=TRAIN_B, device=dev), start=1):
        attention.flash_fwd_launches = attention.flash_bwd_launches = 0  # zeroed just before the step
        state, m = step(state, batch)
        rtrain.report({"step": i, "loss": m["loss"], "flash_fwd": attention.flash_fwd_launches,
                       "flash_bwd": attention.flash_bwd_launches,  # read just after
                       "device": str(batch["tokens"].device), "dtype": str(batch["tokens"].dtype),
                       "shape": list(batch["tokens"].shape), "t": time.time(), "t_entry": t_entry,
                       "pid": os.getpid()})


def train_data_path(rt, device: str, tmp: str, pids: set) -> dict:
    """TorchTrainer.fit from a Dataset on the card (see the module
    docstring, phase 21); the losses held bit for bit to the same rows fed
    through train_loop's in-process loop."""
    import ray_tpu_torch.data as rdata
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchConfig, TorchTrainer

    t_phase = time.perf_counter()
    cuda = device == "cuda"
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    cfg = train_config()
    rows = data_rows(cfg)
    ds = rdata.from_numpy(rows, column="tokens")
    t0_wall, t0 = time.time(), time.perf_counter()
    result = TorchTrainer(
        data_train_fn,
        train_loop_config={},
        scaling_config=ScalingConfig(num_workers=1, resources_per_worker={"GPU": 1}),
        torch_config=TorchConfig() if cuda else TorchConfig(backend="gloo", device="cpu"),
        run_config=RunConfig(name="train_data", storage_path=os.path.join(tmp, "data")),
        datasets={"train": ds},
    ).fit()
    fit_s = time.perf_counter() - t0
    hist = result.metrics_history
    assert [m["step"] for m in hist] == list(range(1, DATA_TRAIN_STEPS + 1)), hist
    assert all(m["shape"] == [TRAIN_B, cfg.max_seq + 1] and m["dtype"] == "torch.int32" for m in hist), hist
    n_layer = cfg.n_layer
    if cuda:
        assert all(m["device"] == "cuda:0" for m in hist), hist
        assert all((m["flash_fwd"], m["flash_bwd"]) == (n_layer, n_layer) for m in hist), hist
    pids.update(m["pid"] for m in hist)
    # The same rows through train_loop's in-process loop.
    model, _, opt, ref_state = train_setup(dev, cfg)
    step = spmd.make_train_step(functools.partial(model.loss_fn, cfg=cfg), opt)
    ref = [step(ref_state, {"tokens": torch.from_numpy(rows[i:i + TRAIN_B]).to(dev)})[1]["loss"].item()
           for i in range(0, len(rows), TRAIN_B)]
    del ref_state
    losses = [m["loss"] for m in hist]
    assert losses == ref, ("the Dataset-fed losses differ from the in-process loop's", losses, ref)
    out = dict(model="GPT2Config", rows=list(rows.shape), dtype="int32", batch=[TRAIN_B, cfg.max_seq],
               remat=cfg.remat, steps=DATA_TRAIN_STEPS, losses=losses, inprocess_losses=ref,
               losses_bit_equal=True, fit_s=fit_s, worker_start_s=hist[0]["t_entry"] - t0_wall,
               step_wall_s=[b["t"] - a["t"] for a, b in zip(hist, hist[1:])],
               launches_per_step={"flash_fwd": hist[0]["flash_fwd"], "flash_bwd": hist[0]["flash_bwd"]},
               launches={"flash_fwd": sum(m["flash_fwd"] for m in hist),
                         "flash_bwd": sum(m["flash_bwd"] for m in hist)})
    log("train_data", json.dumps(out))
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# Batch inference as a data stage on the card (batch_data):
# from_items of the batch path's prompts in two blocks through
# map_batches(build_llm_processor(...)), the stage holding the card.
BATCH_DATA_BLOCKS = 2


def batch_data_config() -> LLMConfig:
    """GPT-2-125M at the serve paths' shape on the dense cache, seed 0."""
    return LLMConfig(seed=0, kv_block_size=0)


def counted_processor(proc, config, device):
    """``proc`` that also returns, per row, the generated token ids, the
    kernels' launches of the block's call in the calling process (zeroed
    just before the call and read just after), the fresh prefills its
    engine ran in that call (prefill calls less prefix hits, as the A/B
    counts them), and that process's pid and card."""

    def stage(batch):
        engine = llm_batch._engine_for(config, device)  # the one ``proc`` uses
        if "_prefill_calls" not in engine.__dict__:
            engine._prefill_calls, generate = count_prefill_calls(engine), engine.generate

            def kept(*a, **kw):
                engine.smoke_results = generate(*a, **kw)
                return engine.smoke_results

            engine.generate = kept
        calls0, hits0 = engine._prefill_calls[0], engine.stats["prefix_hits"]
        attention.flash_fwd_launches = attention.flash_bwd_launches = 0  # zeroed just before the call
        out = proc(batch)
        n = len(out["generated_text"])
        fresh = engine._prefill_calls[0] - calls0 - (engine.stats["prefix_hits"] - hits0)
        return {**out, "token_ids": [list(r["token_ids"]) for r in engine.smoke_results],
                "flash_fwd": [attention.flash_fwd_launches] * n,  # read just after
                "flash_bwd": [attention.flash_bwd_launches] * n,
                "prefills": [fresh] * n, "pid": [os.getpid()] * n, "card": [card_name()] * n}

    return stage


def batch_data_path(device: str, pids: set) -> dict:
    """map_batches(build_llm_processor(...)) on the card (see the module
    docstring, phase 22)."""
    import ray_tpu_torch.data as rdata

    t_phase = time.perf_counter()
    config, sampling = batch_data_config(), SamplingParams(max_tokens=MAX_TOKENS)
    proc = build_llm_processor(config, sampling=sampling, device=device)
    items = [{"prompt": p, "id": i} for i, p in enumerate(BATCH_PROMPTS)]
    gpu = {"GPU": 1.0} if device == "cuda" else None
    t0 = time.perf_counter()
    ds = rdata.from_items(items, parallelism=BATCH_DATA_BLOCKS).map_batches(
        counted_processor(proc, config, device), resources=gpu)
    rows = ds.take_all()
    stage_s = time.perf_counter() - t0
    assert [r["prompt"] for r in rows] == BATCH_PROMPTS and [r["id"] for r in rows] == list(range(4))
    # The same processor called in this process on the same blocks.
    per_block = len(BATCH_PROMPTS) // BATCH_DATA_BLOCKS
    local, inproc = counted_processor(proc, config, device), []
    for i in range(0, len(BATCH_PROMPTS), per_block):
        got = local({"prompt": BATCH_PROMPTS[i:i + per_block]})
        inproc += [dict(text=t, ids=[int(i) for i in ids])
                   for t, ids in zip(got["generated_text"], got["token_ids"])]
    llm_batch._ENGINE_CACHE.clear()
    texts = [r["generated_text"] for r in rows]
    streams = [dict(text=r["generated_text"], ids=[int(t) for t in r["token_ids"]]) for r in rows]
    assert streams == inproc, ("the stage's texts differ from the in-process processor's", streams, inproc)
    assert all(len(s["ids"]) == MAX_TOKENS for s in streams), streams
    per_row = ("flash_fwd", "flash_bwd", "prefills")
    blocks = [{k: rows[i][k] for k in per_row} for i in range(0, len(rows), per_block)]
    assert all(rows[i][k] == b[k] for b, j in zip(blocks, range(0, len(rows), per_block))
               for i in range(j, j + per_block) for k in per_row), rows
    launches = {k: sum(b[k] for b in blocks) for k in KERNELS}
    prefills = sum(b["prefills"] for b in blocks)
    pids.update(r["pid"] for r in rows)
    assert all(b["prefills"] >= 1 for b in blocks), blocks
    if device == "cuda":
        assert all(r["card"] == torch.cuda.get_device_name(0) for r in rows), rows
        n_layer = config.build_model_config().n_layer  # one flash_fwd a layer a fresh prefill
        assert launches == {"flash_fwd": n_layer * prefills, "flash_bwd": 0}, (launches, prefills)
    assert os.getpid() not in {r["pid"] for r in rows}
    out = dict(model="GPT2Config", paged=False, slots=config.max_slots, max_seq=config.max_seq,
               prompts=len(BATCH_PROMPTS), blocks=BATCH_DATA_BLOCKS,
               stage_pids=sorted({r["pid"] for r in rows}), texts_equal_inprocess=True,
               stage_wall_s=stage_s, fresh_prefills=prefills, per_block=blocks,
               launches=launches, texts=texts, nonempty_texts=sum(bool(t) for t in texts),
               token_ids_equal_inprocess=True,
               first_ids=[s["ids"][:8] for s in streams])
    log("batch_data", json.dumps(out))
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def kernel_entry(name, built, rows, head, launches_by_path, replaces) -> dict:
    return {
        "name": name,
        "route": "cuda",
        "source": f"ray_tpu_torch/ops/csrc/{name}.cu",
        "replaces": replaces,
        "launches": sum(launches_by_path.values()),
        "launches_by_path": launches_by_path,
        "shape": [head["B"], 12, head["S"], 64],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "sass": sass_counts(built[name].path),
        "tiles": [dict(B=r["B"], S=r["S"], **attention.kernel_tile_rows(name)) for r in rows],
        "build_s": built[name].seconds,
        "by_shape": rows,
    }


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; the port's smoke run needs an H100")
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)

    built = build_kernels()

    fwd_rows = check_flash_kernel(dev)
    bwd_rows = check_flash_bwd_kernel(dev)
    # Telemetry on, as the reference runs by default, for every phase but
    # the A/B's "off" arm.
    GLOBAL_CONFIG.metrics_enabled = GLOBAL_CONFIG.flightrec = GLOBAL_CONFIG.spec_decode = True
    serve_launches, dense_checks, bf16_bound, ab, family_tol = {}, {}, None, {}, {}
    serve_run = None  # the serve path's run, whose traffic the runtime phase replays
    for name, fields, per_layer in SERVE_PATHS:
        t_phase = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        engine = build_engine(fields)
        run = serve_engine(engine, np.random.default_rng(0))
        traffic = run.pop("traffic")
        if name == "serve":
            serve_run = dict(run, traffic=traffic)
        family = type(engine.model_config).__name__
        assert run["launches"] == per_layer * engine.model_config.n_layer * run["fresh_prefills"], (
            name, run["launches"], run["fresh_prefills"])
        serve_launches[name] = (run["launches"], run["bwd_launches"])
        logits, keep = check_first_token_logits(
            engine, run.pop("prompt"), run["first_tokens"]["p300"], dense_checks.get(family)
        )
        if not engine.paged:
            dense_checks[family] = keep
            family_tol[family] = logits["tol"]
        if name == "serve":
            bf16_bound = logits["tol"]  # GPT-2's bf16 noise on first-token logits
        prof = profile_engine(engine, np.random.default_rng(1))
        run["telemetry"]["profiled"] = profiled_phases(prof)
        print(json.dumps({"serve": {"path": name, "model": family, "paged": engine.paged,
                                    "engine": run, "first_token_logits": logits,
                                    "profile": prof,
                                    "phase_s": time.perf_counter() - t_phase}}), flush=True)
        if name in ("serve", "serve_paged"):
            t_ab = time.perf_counter()
            ab[name] = telemetry_ab(engine, per_layer)
            ab[name]["phase_s"] = time.perf_counter() - t_ab
            serve_launches[f"{name}_ab"] = (ab[name]["launches"], ab[name]["bwd_launches"])
        del engine, keep
        torch.cuda.empty_cache()
    del dense_checks
    print(json.dumps({"telemetry_ab": ab}), flush=True)

    t_batch = time.perf_counter()
    batch = batch_path()
    batch["phase_s"] = time.perf_counter() - t_batch
    serve_launches["batch"] = (batch["launches"], batch["bwd_launches"])
    print(json.dumps({"batch": batch}), flush=True)
    torch.cuda.empty_cache()

    disagg = disagg_path(card)
    serve_launches["disagg"] = (disagg["launches"], disagg["bwd_launches"])
    print(json.dumps({"disagg": disagg}), flush=True)
    torch.cuda.empty_cache()

    train = train_path(dev, train_config())
    print(json.dumps({"train": train}), flush=True)
    torch.cuda.empty_cache()
    train_llama = train_path(dev, llama_train_config())
    print(json.dumps({"train": train_llama}), flush=True)
    torch.cuda.empty_cache()
    train_moe = train_path(dev, moe_train_config())
    print(json.dumps({"train_moe": train_moe}), flush=True)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        mesh_run = train_mesh(dev, tmp)
    mesh_run["timed"]["vs_train_device_ms"] = (
        mesh_run["timed"]["profile_one_step"]["device_ms"] / train["profile_one_step"]["device_ms"]
    )
    print(json.dumps({"train_mesh": mesh_run}), flush=True)
    torch.cuda.empty_cache()
    t_shard = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        shard_run = train_shard(dev, tmp)
    shard_run["phase_s"] = time.perf_counter() - t_shard
    print(json.dumps({"train_shard": shard_run}), flush=True)
    torch.cuda.empty_cache()
    t_tp = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tp_run = serve_tp(tmp, bf16_bound, family_tol)
    tp_run["phase_s"] = time.perf_counter() - t_tp
    serve_launches["serve_tp"] = (tp_run["launches"], tp_run["bwd_launches"])
    print(json.dumps({"serve_tp": tp_run}), flush=True)
    torch.cuda.empty_cache()

    spec_launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, fields in SPEC_PATHS:
            spec = spec_path(name, fields, bf16_bound, tmp)
            spec_launches[name] = (spec["launches"], spec["bwd_launches"])
            print(json.dumps({"spec": spec}), flush=True)
    torch.cuda.empty_cache()

    runtime = runtime_path(card, serve_run, train, dp2_ref=shard_run["cases"]["dp2"]["unsharded"],
                           stream_bound=bf16_bound)
    loop = runtime.pop("train_loop")
    app = runtime.pop("serve_app")
    devobj = runtime.pop("device_objects")
    train_data = runtime.pop("train_data")
    batch_data = runtime.pop("batch_data")
    print(json.dumps({"train_loop": loop}), flush=True)
    print(json.dumps({"serve_app": app}), flush=True)
    print(json.dumps({"device_objects": devobj}), flush=True)
    print(json.dumps({"train_data": train_data}), flush=True)
    print(json.dumps({"batch_data": batch_data}), flush=True)
    print(json.dumps({"runtime": runtime}), flush=True)

    fwd_head = next(
        r for r in fwd_rows if (r["layout"], r["B"], r["H"], r["S"]) == ("qkv_views", 1, 12, HEADLINE_S)
    )
    bwd_head = next(r for r in bwd_rows if (r["B"], r["S"]) == (TRAIN_B, TRAIN_S))
    fwd = kernel_entry("flash_fwd", built, fwd_rows, fwd_head,
                       {**{k: f for k, (f, _) in serve_launches.items()},
                        "train": train["launches"]["flash_fwd"],
                        "train_llama": train_llama["launches"]["flash_fwd"],
                        "train_moe": train_moe["launches"]["flash_fwd"],
                        "train_mesh": mesh_run["launches"]["flash_fwd"],
                        "train_shard": shard_run["launches"]["flash_fwd"],
                        "train_shard_sp_pp": shard_run["launches_sp_pp"]["flash_fwd"],
                        "train_shard_ckpt": shard_run["launches_ckpt"]["flash_fwd"],
                        **{k: f for k, (f, _) in spec_launches.items()},
                        "runtime": runtime["launches"]["flash_fwd"],
                        "train_loop": loop["launches"]["flash_fwd"],
                        "train_loop_dp2": loop["launches_dp2"]["flash_fwd"],
                        "serve_app": app["launches"]["flash_fwd"],
                        "serve_app_disagg": app["launches_disagg"]["flash_fwd"],
                        "device_objects": devobj["launches"]["flash_fwd"],
                        "train_data": train_data["launches"]["flash_fwd"],
                        "batch_data": batch_data["launches"]["flash_fwd"]},
                       "ray_tpu/ops/attention.py:72")
    fwd["max_abs_err_lse"] = max(r["max_abs_err_lse"] for r in fwd_rows)
    bwd = kernel_entry("flash_bwd", built, bwd_rows, bwd_head,
                       {**{k: b for k, (_, b) in serve_launches.items()},
                        "train": train["launches"]["flash_bwd"],
                        "train_llama": train_llama["launches"]["flash_bwd"],
                        "train_moe": train_moe["launches"]["flash_bwd"],
                        "train_mesh": mesh_run["launches"]["flash_bwd"],
                        "train_shard": shard_run["launches"]["flash_bwd"],
                        "train_shard_sp_pp": shard_run["launches_sp_pp"]["flash_bwd"],
                        "train_shard_ckpt": shard_run["launches_ckpt"]["flash_bwd"],
                        **{k: b for k, (_, b) in spec_launches.items()},
                        "runtime": runtime["launches"]["flash_bwd"],
                        "train_loop": loop["launches"]["flash_bwd"],
                        "train_loop_dp2": loop["launches_dp2"]["flash_bwd"],
                        "serve_app": app["launches"]["flash_bwd"],
                        "serve_app_disagg": app["launches_disagg"]["flash_bwd"],
                        "device_objects": devobj["launches"]["flash_bwd"],
                        "train_data": train_data["launches"]["flash_bwd"],
                        "batch_data": batch_data["launches"]["flash_bwd"]},
                       "ray_tpu/ops/attention.py:152")
    bwd["max_rel_err"] = max(r["max_rel_err"] for r in bwd_rows)
    print(json.dumps({"kernels": [fwd, bwd]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:  # one rank of a sharded case, started by shard_case
        mesh_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
        sys.exit(0)
    if sys.argv[1:2] == ["--serve-rank"]:  # one rank of serve_tp's cases, started by tp_spawn
        serve_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6])
        sys.exit(0)
    sys.exit(main())
