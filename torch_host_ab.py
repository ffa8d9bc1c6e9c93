#!/usr/bin/env python3
"""A/B of the port's one-rank training and serving paths between two
source trees, on one CUDA card.

    python3 torch_host_ab.py ROOT_A ROOT_B [--rounds N] [--out FILE]

Each run is a fresh process that imports ``ray_tpu_torch`` from one tree
(built from that tree's sources) and drives, at chip_smoke.py's full-width
configurations with random weights from seed 0:

- ``train`` (GPT-2-125M, ``loss_chunk=0``), ``train_llama`` (Llama-125M,
  ``loss_chunk=128``) and ``train_moe`` (GPT-2-125M widths, 4 experts):
  ``make_train_step`` at batch [8, 1024] with ``remat="mlp"``; 3 warm-up
  steps, then 3 windows of 10 steps on the host clock, the peak memory over
  them, and the device time of 2 profiled steps;
- ``serve``, ``serve_llama`` (dense KV) and ``serve_llama_paged`` (paged KV):
  an ``LLMEngine`` at the reference's default shape (16 slots, 2048
  positions); the TTFT of a lone 1000-token prompt (3 times), then 6
  requests of 100 prompt tokens decoding together: 3 windows of 10 decode
  steps on the host clock and the device time of 8 profiled decode steps.

The runs go A, B, B, A in each round, so that a drift of the machine over
the call shows as a difference between a tree's two runs. Prints one JSON
line per run, then one ``{"ab": ...}`` line: per path and metric, each
tree's median over its runs' values and B's median over A's. Without a CUDA
device it prints no result and exits 1.
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

TRAIN_PATHS = ("train", "train_llama", "train_moe")
SERVE_PATHS = ("serve", "serve_llama", "serve_llama_paged")
WARMUP_STEPS, WINDOWS, WINDOW_STEPS, PROFILED_STEPS = 3, 3, 10, 2
DECODE_PROFILED = 8
DEVICE = "cuda"


def device_ms(run, steps: int) -> float:
    """Summed device time of ``steps`` calls of ``run`` (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
    return sum((e.time_range.end - e.time_range.start) / 1e3
               for e in prof.events() if e.device_type == DeviceType.CUDA)


def train_path(name: str) -> dict:
    import dataclasses

    import torch

    from ray_tpu_torch.models import gpt2, llama
    from ray_tpu_torch.train import spmd

    if name == "train_llama":
        model, cfg = llama, llama.LlamaConfig.llama_125m()
    else:
        model, cfg = gpt2, dataclasses.replace(gpt2.GPT2Config.gpt2_125m(), loss_chunk=0)
        if name == "train_moe":
            cfg = dataclasses.replace(
                cfg, n_experts=4, expert_capacity_factor=1.5, moe_aux_weight=0.01
            )
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (8, cfg.max_seq), generator=g, device=dev)
    batch = {"tokens": tokens, "targets": tokens.roll(-1, dims=1)}
    opt = spmd.default_optimizer(warmup_steps=2, total_steps=100)
    state = spmd.make_train_state(
        functools.partial(model.init_params, cfg=cfg, device=dev), opt,
        torch.Generator(device=dev).manual_seed(0), device=dev,
    )
    step = spmd.make_train_step(functools.partial(model.loss_fn, cfg=cfg), opt)
    first_loss = [step(state, batch)[1]["loss"].item()]
    for _ in range(WARMUP_STEPS - 1):
        step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    host_ms = []
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        for _ in range(WINDOW_STEPS):
            step(state, batch)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3 / WINDOW_STEPS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    dev_ms = device_ms(lambda: step(state, batch), PROFILED_STEPS) / PROFILED_STEPS
    return dict(first_loss=first_loss[0], host_ms_per_step=host_ms,
                tok_s=[tokens.numel() * 1e3 / ms for ms in host_ms],
                device_ms_per_step=dev_ms, peak_gb=peak_gb)


def serve_path(name: str) -> dict:
    import numpy as np
    import torch

    from ray_tpu_torch.llm import LLMConfig, LLMEngine, SamplingParams
    from ray_tpu_torch.models.llama import LlamaConfig

    fields = {} if name == "serve" else dict(model_config=LlamaConfig.llama_125m())
    if name != "serve_llama_paged":
        fields["kv_block_size"] = 0
    engine = LLMEngine(LLMConfig(seed=0, **fields))
    rng = np.random.default_rng(0)
    vocab = min(engine.model_config.vocab_size, 50257)

    def ids(n):
        return rng.integers(0, vocab, n).tolist()

    engine.generate([ids(40)], SamplingParams(max_tokens=2))  # warm-up
    ttft_ms = []
    for i in range(3):
        engine.add_request(f"alone{i}", ids(1000), SamplingParams(max_tokens=1))
        engine.step()
        engine.pop_finished()
        ttft_ms.append(engine._ttft_window[-1][1] * 1e3)
    for i in range(6):
        engine.add_request(f"d{i}", ids(100), SamplingParams(max_tokens=64))
    while any(not r.generated for r in engine.requests.values()):
        engine.step()  # admissions
    host_ms, tok_s = [], []
    for _ in range(WINDOWS):
        tok0 = engine.stats["tokens_generated"]
        t0 = time.perf_counter()
        for _ in range(WINDOW_STEPS):
            engine.step()  # each step ends in its logits readback
        seconds = time.perf_counter() - t0
        host_ms.append(seconds * 1e3 / WINDOW_STEPS)
        tok_s.append((engine.stats["tokens_generated"] - tok0) / seconds)
    dev_ms = device_ms(engine.step, DECODE_PROFILED) / DECODE_PROFILED
    while engine.has_unfinished():
        engine.step()
    finished = engine.pop_finished()
    assert len(finished) == 6 and all(r.error is None for r in finished), finished
    return dict(ttft_ms_alone_1000=ttft_ms, host_ms_per_decode_step=host_ms,
                decode_tok_s=tok_s, device_ms_per_decode_step=dev_ms)


def run_tree(root: str) -> dict:
    """One run in this process, on the tree at ``root``."""
    sys.path.insert(0, root)
    import torch

    import ray_tpu_torch

    assert Path(ray_tpu_torch.__file__).resolve().is_relative_to(Path(root).resolve())
    out = {"root": root}
    for name in TRAIN_PATHS + SERVE_PATHS:
        t0 = time.perf_counter()
        out[name] = train_path(name) if name in TRAIN_PATHS else serve_path(name)
        out[name]["wall_s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    return out


def median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else (xs[n // 2 - 1] + xs[n // 2]) / 2


def summary(runs: list[dict], roots: tuple[str, str]) -> dict:
    """Per path and metric: each tree's median over the values of its runs
    (every window of every run), and B's median over A's."""
    out = {}
    for name in TRAIN_PATHS + SERVE_PATHS:
        metrics = {}
        for key in runs[0][name]:
            if key == "wall_s":
                continue
            per = []
            for root in roots:
                vals = []
                for r in runs:
                    if r["root"] == root:
                        v = r[name][key]
                        vals += v if isinstance(v, list) else [v]
                per.append(dict(median=median(vals), lo=min(vals), hi=max(vals)))
            ratio = per[1]["median"] / per[0]["median"] if per[0]["median"] else None
            metrics[key] = dict(a=per[0], b=per[1], b_over_a=ratio)
        out[name] = metrics
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs=2, help="source trees A and B (each holds ray_tpu_torch/)")
    ap.add_argument("--rounds", type=int, default=1, help="rounds of A, B, B, A")
    ap.add_argument("--out", help="also write every run and the summary to this JSON file")
    ap.add_argument("--run", help=argparse.SUPPRESS)  # one run, in a child process
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: nothing to measure", file=sys.stderr)
        return 1
    roots = tuple(str(Path(r).resolve()) for r in args.roots)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    runs = []
    for _ in range(args.rounds):
        for root in (roots[0], roots[1], roots[1], roots[0]):
            r = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), *roots, "--run", root],
                cwd=root, capture_output=True, text=True, timeout=1200,
            )
            sys.stderr.write(r.stderr[-4000:])
            if r.returncode != 0:
                print(f"run on {root} failed: rc {r.returncode}", file=sys.stderr)
                return 1
            runs.append(json.loads(r.stdout.strip().splitlines()[-1]))
            print(json.dumps(runs[-1]), flush=True)
    result = {"card": card, "roots": {"a": roots[0], "b": roots[1]},
              "summary": summary(runs, roots)}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(result, runs=runs), indent=1))
    print(json.dumps({"ab": result}))
    return 0


if __name__ == "__main__":
    if "--run" in sys.argv:
        print(json.dumps(run_tree(sys.argv[sys.argv.index("--run") + 1])))
        sys.exit(0)
    sys.exit(main())
