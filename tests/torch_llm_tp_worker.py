"""One rank of ``tests/test_torch_llm_tp.py``'s gloo runs (not a test file).

    python tests/torch_llm_tp_worker.py RANK WORLD STORE CASES OUT

Starts a gloo process group of WORLD ranks from the ``file://`` STORE (a
collective that waits longer than ``COLLECTIVE_S`` on a rank that died
raises instead of hanging), serves every case of the pickle CASES through
the port's tensor-parallel ``LLMEngine`` on the CPU (imports no jax: the
JAX engine runs in the test's own process) and pickles this rank's results
to ``OUT/rank{RANK}.pkl``. A case is a dict with ``name`` and ``kind``:

- ``"serve"``: ``config`` (``LLMConfig`` fields; ``model_config`` and
  ``draft_model_config`` as ``(family, fields)``) and ``runs``, a list of
  ``(prompts, SamplingParams fields)`` served in turn by ``generate`` on
  one engine. Returns each run's token streams, the first-token logits of
  every request (what ``_sample`` was given), the engine's stats and
  ``kv_stats()``, the shapes of the cache or pool and of the attention
  weights, the registry's ``raytpu_llm_*`` deltas and the ``llm`` ring of
  the whole case, and the collectives of one decode step (a 3-token
  request's second step, which admits nothing);
- ``"batch"``: ``build_llm_processor`` on ``config`` twice over ``batch``;
  its outputs and whether the second call reused the engine;
- ``"raises"``: ``configs``, each of which must raise on building the
  engine; the exception's type and message of each;
- ``"handoff"``: disaggregated serving of ``prompts`` (greedy, ``tokens``
  each) from a prefill-only engine to a decode engine, both of
  ``config`` (paged): tp to tp, tp to a one-rank engine on rank 0, and a
  one-rank prefill engine on rank 0 (its handoffs broadcast to every rank)
  to tp. Returns each hop's streams and the decode engines' stats.
"""

import dataclasses
import datetime
import pickle
import sys
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from ray_tpu_torch.llm import LLMConfig, LLMEngine, SamplingParams, build_llm_processor
from ray_tpu_torch.llm import batch as llm_batch
from ray_tpu_torch.models.gpt2 import GPT2Config
from ray_tpu_torch.models.llama import LlamaConfig
from ray_tpu_torch.util import flightrec, metrics

COLLECTIVE_S = 60
FAMILIES = {"gpt2": GPT2Config, "llama": LlamaConfig}
# Collectives issued through torch.distributed, counted by name.
CALLS = {"all_reduce": 0, "all_gather_into_tensor": 0}


def _counting(name):
    inner = getattr(dist, name)

    def call(*a, **kw):
        CALLS[name] += 1
        return inner(*a, **kw)

    return call


def _config(fields: dict) -> LLMConfig:
    fields = dict(fields)
    for key in ("model_config", "draft_model_config"):
        if key in fields:
            family, cfg = fields[key]
            fields[key] = FAMILIES[family](**cfg, dtype=torch.float32)
    return LLMConfig(**fields)


def _points() -> dict:
    return {(n, frozenset(t.items())): v for n, t, v in metrics.registry().snapshot()["points"]
            if n.startswith("raytpu_llm_")}


def _delta(before: dict, after: dict) -> dict:
    """Counter deltas and histogram observation counts, nonzero only."""
    meta = metrics.registry().snapshot()["meta"]
    out = {}
    for key, v in after.items():
        kind = meta[key[0]]["kind"]
        if kind == "counter":
            d = v - before.get(key, 0.0)
        elif kind == "histogram":
            d = v["count"] - (before[key]["count"] if key in before else 0)
        else:
            continue
        if d:
            out[key[0]] = d
    return out


def _ring() -> list:
    ring = flightrec.snapshot(planes=["llm"])["rings"].get("llm", {"events": [], "dropped": 0})
    assert ring["dropped"] == 0
    return [(e["phase"], e.get("rid"), *(e.get("extra", {}).get(k) for k in
                                         ("tokens", "reused", "start", "batch")))
            for e in ring["events"]]


def serve(case: dict) -> dict:
    engine = LLMEngine(_config(case["config"]), device="cpu")
    firsts = {}
    sample = engine._sample

    def recording(logits, req):
        if not req.generated:
            firsts[req.request_id] = logits.copy()
        return sample(logits, req)

    engine._sample = recording
    flightrec.reset()
    before = _points()
    streams = [[o["token_ids"] for o in engine.generate(prompts, SamplingParams(**sampling))]
               for prompts, sampling in case["runs"]]
    delta, ring = _delta(before, _points()), _ring()
    stats, kv, first_logits = dict(engine.stats), engine.kv_stats(), dict(firsts)
    # One decode step that admits nothing: its collectives. Sampled, so
    # that a spec engine takes vanilla steps too.
    engine.add_request("probe", case["runs"][0][0][0],
                       SamplingParams(max_tokens=3, temperature=0.8))
    engine.step()
    calls0 = dict(CALLS)
    engine.step()
    step_calls = {k: CALLS[k] - calls0[k] for k in CALLS}
    engine.pop_finished()
    kv_store = engine.pool if engine.paged else engine.cache
    blocks = engine.params["blocks"]
    return dict(
        streams=streams, firsts=first_logits, stats=stats, kv_stats=kv, delta=delta, ring=ring,
        kv_shape=tuple(kv_store["k"].shape), step_calls=step_calls,
        weight_shapes={k: tuple(blocks[k].shape) for k in ("qkv_w", "proj_w", "wq", "wk", "wo")
                       if k in blocks},
        vocab_rows=tuple(engine.params["wte"].shape),
        spec=engine._spec is not None,
    )


def batch(case: dict) -> dict:
    config = _config(case["config"])
    proc = build_llm_processor(config, sampling=SamplingParams(**case["sampling"]), device="cpu")
    first = proc(case["batch"])
    engine = llm_batch._engine_for(config, "cpu")
    second = proc(case["batch"])
    reused = llm_batch._engine_for(config, "cpu") is engine and len(llm_batch._ENGINE_CACHE) == 1
    llm_batch._ENGINE_CACHE.clear()
    return dict(first=first, second=second, reused=reused)


def raises(case: dict) -> dict:
    out = []
    for fields in case["configs"]:
        try:
            LLMEngine(_config(fields), device="cpu")
        except Exception as e:  # noqa: BLE001 - the test checks the type and message
            out.append((type(e).__name__, str(e)))
        else:
            out.append(None)
    return dict(raised=out)


def _prefill(engine, prompts, sampling) -> list:
    for i, p in enumerate(prompts):
        engine.add_request(f"p{i}", p, sampling, prefill_only=True)
    while engine.has_unfinished():
        engine.step()
    done = {r.request_id: r.handoff_out for r in engine.pop_finished()}
    return [done[f"p{i}"] for i in range(len(prompts))]


def _decode(engine, handoffs, sampling) -> tuple[list, dict]:
    for i, h in enumerate(handoffs):
        engine.add_handoff_request(f"d{i}", h, sampling)
    while engine.has_unfinished():
        engine.step()
    done = {r.request_id: r.generated for r in engine.pop_finished()}
    return [done[f"d{i}"] for i in range(len(handoffs))], dict(engine.stats)


def handoff(case: dict) -> dict:
    config = _config(case["config"])
    one = dataclasses.replace(config, tensor_parallelism=1)
    sampling = SamplingParams(max_tokens=case["tokens"])
    rank = dist.get_rank()
    out = {}
    # tp -> tp: every rank returns rank 0's handoffs, and decodes them.
    hs = _prefill(LLMEngine(config, device="cpu"), case["prompts"], sampling)
    out["tp_tp"] = _decode(LLMEngine(config, device="cpu"), hs, sampling)
    # tp -> one rank: the tp group prefills, rank 0 alone decodes.
    hs = _prefill(LLMEngine(config, device="cpu"), case["prompts"], sampling)
    if rank == 0:
        out["tp_one"] = _decode(LLMEngine(one, device="cpu"), hs, sampling)
    # one rank -> tp: rank 0 prefills alone and broadcasts its handoffs.
    box = [_prefill(LLMEngine(one, device="cpu"), case["prompts"], sampling) if rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    out["one_tp"] = _decode(LLMEngine(config, device="cpu"), box[0], sampling)
    dist.barrier()  # rank 0's fabric serves every pull before it moves on
    return out


KINDS = {"serve": serve, "batch": batch, "raises": raises, "handoff": handoff}


def main(rank: int, world: int, store: str, cases_path: str, out_dir: str) -> None:
    torch.manual_seed(0)
    for name in CALLS:
        setattr(dist, name, _counting(name))
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_S))
    try:
        with open(cases_path, "rb") as f:
            cases = pickle.load(f)
        results = {c["name"]: KINDS[c["kind"]](c) for c in cases}
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    try:
        rank, world, store, cases_path, out_dir = sys.argv[1:]
        main(int(rank), int(world), store, cases_path, out_dir)
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
