#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which fails the script (non-zero exit) when it fails:

1. Print the card's name and power limit (``nvidia-smi``) and build the
   port's CUDA kernel with ``nvcc`` from the checkout's sources.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it, and time kernel, plain version and
   the PyTorch library call that computes the same function.
3. Serve GPT-2-125M at full width (random weights from a seed) through the
   port's ``LLMEngine`` with the dense KV cache: 6 requests of ~20 to ~1000
   prompt tokens, two of them sharing a 64-token prefix. The kernels' launch
   counts are zeroed just before this run and read just after it.
4. Check the first-token logits of one prompt against a run through the
   plain attention, on the card.
5. Profile where a step's time goes (torch.profiler: device busy share and
   the heaviest kernels of one prefill step and of decode steps).

Prints one ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. Without a CUDA device it prints no result
and exits 1. Long output (nvcc's register report) goes to stderr.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.llm.config import LLMConfig, SamplingParams
from ray_tpu_torch.llm.engine import LLMEngine
from ray_tpu_torch.models import gpt2_decode
from ray_tpu_torch.ops import _build, attention

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

SERVE_SHAPES = [32, 128, 512, 1024, 2048, 100]  # prefill buckets + one ragged S
HEADLINE_S = 1024
MAX_TOKENS = 32


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
    """q, k, v as prefill hands them to the kernel: strided head views of
    one [B, S, 3*H*D] projection."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((B, S, 3 * H * D), generator=g, device=dev).to(torch.bfloat16)
    return [t.reshape(B, S, H, D).transpose(1, 2) for t in qkv.split(H * D, dim=-1)]


def flash_bound_ms(B, H, S, D) -> tuple[float, str]:
    """Least time for a causal forward: q, k, v read once, O (bf16) and LSE
    (f32) written once; two products over the S(S+1)/2 causal pairs."""
    nbytes = 4 * B * H * S * D * 2 + B * H * S * 4
    flops = 2 * 2 * B * H * D * S * (S + 1) / 2
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_flash_kernel(dev) -> list[dict]:
    rows = []
    for S in SERVE_SHAPES:
        q, k, v = qkv_views(S, dev, seed=S)
        scale = 1.0 / 8.0
        o, lse = attention.flash_attention_fwd(q, k, v, scale)
        torch.cuda.synchronize()
        o_ref, lse_ref = attention.flash_attention_fwd_reference(q, k, v, scale)
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        finite = bool(torch.isfinite(o.float()).all() and torch.isfinite(lse).all())
        iters = 200 if S <= 512 else 50
        ms = time_ms(lambda: attention.flash_attention_fwd(q, k, v, scale), iters)
        plain_ms = time_ms(lambda: attention.flash_attention_fwd_reference(q, k, v, scale), 10)
        library_ms = time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=scale), iters
        )
        bound_ms, bound_by = flash_bound_ms(1, 12, S, 64)
        row = dict(S=S, max_abs_err=err_o, max_abs_err_lse=err_lse, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
        log("flash_fwd", json.dumps(row))
        if not finite or err_o > O_TOL or err_lse > LSE_TOL:
            raise AssertionError(f"flash_fwd disagrees with its plain version at S={S}: {row}")
        rows.append(row)
    return rows


def serve_engine(rng) -> dict:
    """The main path: GPT-2-125M, dense KV, 6 requests through LLMEngine."""
    torch.cuda.reset_peak_memory_stats()
    engine = LLMEngine(LLMConfig(kv_block_size=0, seed=0))
    cfg = engine.model_config
    assert (cfg.n_layer, cfg.n_head, cfg.d_model, cfg.d_ff, cfg.vocab_size) == (
        12, 12, 768, 3072, 50304
    ), cfg
    assert engine.cache["k"].shape == (12, 16, 12, 2048, 64), engine.cache["k"].shape
    ids = lambda n: rng.integers(0, 50257, n).tolist()  # noqa: E731
    # Warm-up request (cuBLAS handles, allocator), not part of the run.
    engine.generate([ids(40)], SamplingParams(max_tokens=2))

    prefix = ids(64)
    prompts = {
        "p20": ids(20),
        "p100": ids(100),
        "p300": ids(300),
        "p1000": ids(1000),
        "shared_a": prefix + ids(30),
        "shared_b": prefix + ids(50),  # hits shared_a's pooled 64-token prefix
    }
    hits0 = engine.stats["prefix_hits"]
    ttft0 = len(engine._ttft_window)
    attention.flash_fwd_launches = 0  # zeroed just before the main path
    t0 = time.perf_counter()
    for rid, p in prompts.items():
        engine.add_request(rid, p, SamplingParams(max_tokens=MAX_TOKENS))
    finished, decode_s, decode_tokens, decode_steps, steps = [], 0.0, 0, 0, 0
    while engine.has_unfinished():
        admitting = any(r.slot < 0 for r in engine.requests.values() if not r.finished)
        before = engine.stats["tokens_generated"]
        ts = time.perf_counter()
        finished += engine.step()  # ends in the logits readback: synchronised
        dt = time.perf_counter() - ts
        steps += 1
        if not admitting:
            decode_s += dt
            decode_steps += 1
            decode_tokens += engine.stats["tokens_generated"] - before
    wall_s = time.perf_counter() - t0
    launches = attention.flash_fwd_launches  # read just after
    engine.pop_finished()

    hits = engine.stats["prefix_hits"] - hits0
    fresh = len(prompts) - hits
    by_id = {r.request_id: r for r in finished}
    assert set(by_id) == set(prompts), sorted(by_id)
    for rid, r in by_id.items():
        ok = len(r.generated) == MAX_TOKENS or r.generated[-1] == r.stop_token
        assert r.error is None and ok, (rid, r.error, len(r.generated))
        assert all(0 <= t < cfg.vocab_size for t in r.generated), rid
    assert hits == 1, f"expected one prefix hit (shared_b), got {hits}"
    assert launches == cfg.n_layer * fresh, (launches, fresh)
    ttft_ms = [round(v * 1e3, 3) for _, v in list(engine._ttft_window)[ttft0:]]

    # One request alone on the idle engine: its TTFT is its own prefill.
    engine.add_request("alone1000", ids(1000), SamplingParams(max_tokens=1))
    engine.step()
    engine.pop_finished()
    alone_ttft_ms = engine._ttft_window[-1][1] * 1e3
    return dict(
        engine=engine, launches=launches, fresh_prefills=fresh, prefix_hits=hits,
        steps=steps, wall_s=wall_s, ttft_ms_in_admission_order=ttft_ms,
        ttft_ms_alone_1000=alone_ttft_ms,
        decode_tok_s=decode_tokens / decode_s if decode_s else 0.0,
        decode_step_ms=1e3 * decode_s / decode_steps if decode_steps else 0.0,
        generated={rid: len(r.generated) for rid, r in by_id.items()},
        first_tokens={rid: r.generated[0] for rid, r in by_id.items()},
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        prompt=prompts["p300"],
    )


def check_first_token_logits(engine, prompt, first_token) -> dict:
    """First-token logits of one prompt through the kernel (the engine's
    own path) and through the plain attention, on the card, in bf16; the
    f32 run of the plain attention shows bf16's own noise floor."""
    cfg = engine.model_config
    T = len(prompt)
    toks = torch.tensor([prompt + [0] * (512 - T)], device=engine.device)
    lengths = torch.tensor([T], device=engine.device)
    out = {}
    with torch.no_grad():
        for name, c, params in (
            ("cuda", cfg, engine._cparams),
            ("plain", dataclasses.replace(cfg, attn_impl="reference"), engine._cparams),
            ("plain_f32",
             dataclasses.replace(cfg, attn_impl="reference", dtype=torch.float32),
             engine.params),
        ):
            cache = gpt2_decode.init_kv_cache(c, 1, 512, device=engine.device)
            out[name] = gpt2_decode.prefill(params, toks, lengths, cache, c)[1][0]
    for v in out.values():
        assert v.shape == (cfg.vocab_size,) and bool(torch.isfinite(v).all())
    diff = (out["cuda"] - out["plain"]).abs().max().item()
    noise = (out["plain"] - out["plain_f32"]).abs().max().item()
    scale = out["plain_f32"].abs().max().item()
    # The kernel may move the logits by no more than bf16 itself does.
    tol = max(2.0 * noise, 2e-2)
    assert int(out["cuda"].argmax()) == first_token, "engine's first token != kernel argmax"
    assert diff <= tol, f"first-token logits: kernel vs plain {diff} > {tol}"
    return dict(max_abs_diff=diff, bf16_vs_f32=noise, tol=tol, max_abs_logit=scale,
                argmax_equal=int(out["cuda"].argmax()) == int(out["plain"].argmax()))


def profile_engine(engine, rng) -> dict:
    """Where a step's time goes: wall time, device
    busy time and share, and the heaviest kernels, from torch.profiler over
    (a) one step that prefills a 1000-token prompt on an idle engine and
    decodes it once, and (b) 8 decode steps with 6 requests in flight."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ids = lambda n: rng.integers(0, 50257, n).tolist()  # noqa: E731

    def window(steps: int) -> dict:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                engine.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_name: dict = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                ms, n = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
        device_ms = sum(ms for ms, _ in by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
        return dict(
            steps=steps, wall_ms=wall_ms, device_ms=device_ms,
            busy_share=device_ms / wall_ms if wall_ms else None,
            top_kernels=[dict(name=k[:80], ms=ms, calls=n) for k, (ms, n) in top],
        )

    engine.add_request("prof-prefill", ids(1000), SamplingParams(max_tokens=2))
    prefill = window(1)
    while engine.has_unfinished():
        engine.step()
    for i in range(6):
        engine.add_request(f"prof-{i}", ids(100), SamplingParams(max_tokens=16))
    engine.step()  # admissions
    decode = window(8)
    while engine.has_unfinished():
        engine.step()
    engine.pop_finished()
    return dict(prefill_1000=prefill, decode_6_active=decode)


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; the port's smoke run needs an H100")
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)

    built = _build.build("flash_fwd")
    log(f"--- nvcc {built.name}.cu ({built.seconds:.2f} s)\n{built.log.strip()}")

    rows = check_flash_kernel(dev)
    run = serve_engine(np.random.default_rng(0))
    engine = run.pop("engine")
    logits = check_first_token_logits(engine, run.pop("prompt"), run["first_tokens"]["p300"])
    print(json.dumps({"engine": run, "first_token_logits": logits}), flush=True)
    print(json.dumps({"profile": profile_engine(engine, np.random.default_rng(1))}), flush=True)

    head = next(r for r in rows if r["S"] == HEADLINE_S)
    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/attention.py:72",
        "launches": run["launches"],
        "shape": [1, 12, HEADLINE_S, 64],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "max_abs_err_lse": max(r["max_abs_err_lse"] for r in rows),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "build_s": built.seconds,
        "by_shape": rows,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
