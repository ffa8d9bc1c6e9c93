"""The port's tensor-parallel LLMEngine against the JAX engine at the same
``tensor_parallelism``, on the CPU in f32.

The port's ranks are processes (``tests/torch_llm_tp_worker.py``, no jax)
in a gloo group from a ``file://`` store under ``tmp_path``: one spawn of 2
ranks and one of 4, every case of a world in its spawn, each child joined
under a time limit and killed after. The JAX engine runs in this process on
the 8 virtual CPU devices of ``conftest.py``, while the ranks run. Both load
the same pickled tiny weights (GPT-2 with 2 heads; Llama with 4 query heads
over 2 KV heads, so at ``tensor_parallelism=4`` each rank holds one query
head and two ranks hold the same KV head), and serve the same token-id
prompts: a shared 32-token prefix (a prefix hit), a prompt for a larger
bucket and more requests than slots; greedy, then sampled at temperature
0.8 on the same engine. Dense and paged caches, chunked prefill (Llama) and
speculative decoding with a perturbed 1-layer draft (k=3) are covered, and
so is ``build_llm_processor``.

Held, for every case and every rank: token streams bit-equal to the JAX
engine's; the engine's counters, ``spec_*`` stats and ``kv_stats()``
equal; every request's first-token logits within 1e-5; the registry's
``raytpu_llm_*`` deltas and the ``llm`` ring equal to the JAX package's;
every rank's outputs identical to rank 0's, logits bit for bit. Each rank's
cache or pool carries only its KV heads, its weights only its heads and
vocabulary rows, and a decode step issues one all-reduce per layer after
the attention output and one after the MLP, one for the embedding and one
gather of the logits: nothing else. A degree above the head count is
served, the ranks past it holding no head. A degree that does not split
the vocabulary, and a process group of another size, raise on every rank;
with no process group the engine raises in this process. Disaggregated
serving hands a request's KV from a tp=2 engine to a tp=2 one and to a
one-rank one, and from a one-rank engine to a tp=2 one, with the unified
streams.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.core.config import GLOBAL_CONFIG as JCONFIG
from ray_tpu.llm import batch as jbatch
from ray_tpu.llm.config import LLMConfig as JLLMConfig
from ray_tpu.llm.config import SamplingParams as JSampling
from ray_tpu.llm.engine import LLMEngine as JEngine
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu.util import flightrec as jflightrec
from ray_tpu.util import metrics as jmetrics
from ray_tpu_torch.llm import LLMConfig as PLLMConfig
from ray_tpu_torch.llm import LLMEngine as PEngine
from ray_tpu_torch.models import gpt2 as pgpt2
from ray_tpu_torch.models import llama as pllama

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_llm_tp_worker.py"
JOIN_S = 120

# The shapes of tests/test_torch_llm_engine.py, and its serving shape but for
# the buckets.
SHAPE = dict(n_layer=2, d_model=64, n_head=2, vocab_size=512, max_seq=256)
LLAMA_SHAPE = dict(n_layer=2, d_model=64, n_head=4, n_kv_head=2, vocab_size=512, max_seq=128)
# Degrees that do not divide the heads (the vocabulary and the MLP still
# divide): GPT-2's 3 heads over tp=2 (1 and 2 a rank); Llama's 10 query
# heads over 5 KV heads at tp=4 (2, 3, 2 and 3 a rank: rank 1's heads 2-4
# read KV heads 1, 1, 2 and rank 3's 7-9 read 3, 4, 4, so those ranks keep
# a KV head for each query head; rank 2's heads 5-6 read KV heads 2 and 3);
# and GPT-2 with one head over tp=2, where rank 1 holds no head at all.
UNEVEN_SHAPES = {
    "gpt2_1h": dict(n_layer=2, d_model=64, n_head=1, vocab_size=512, max_seq=256),
    "gpt2_3h": dict(n_layer=2, d_model=96, n_head=3, vocab_size=512, max_seq=256),
    "llama_10h": dict(n_layer=2, d_model=160, n_head=10, n_kv_head=5, vocab_size=512,
                      max_seq=128),
}
SERVE = dict(
    max_slots=3,
    max_seq=256,
    prefill_buckets=(64, 128),  # each bucket costs the JAX engine a compile
    prefix_chunk=32,
    max_prefix_cache_tokens=1024,
    seed=5,
)
COUNTERS = (
    "prefill_tokens", "prefill_chunks", "prefix_hits", "prefix_lookups",
    "prefix_tokens_reused", "tokens_generated", "spec_steps", "spec_drafted", "spec_accepted",
)
K = 3  # draft tokens a spec step
GREEDY = dict(max_tokens=8)
SAMPLED = dict(max_tokens=8, temperature=0.8)
BATCH = {"prompt": ["hello", "tensor parallel", "abc"], "id": [0, 1, 2]}


def _prompts():
    rng = np.random.default_rng(3)
    ids = lambda n: rng.integers(0, 256, n).tolist()  # noqa: E731
    prefix = ids(32)
    return [
        ids(10),
        prefix + ids(8),  # pools its 32-token prefix
        prefix + ids(20),  # prefix hit
        ids(100),  # bucket 128 (four chunks where chunked)
        ids(45),  # waits for a free slot (max_slots=3)
    ]


# name -> (world, family, LLMConfig fields, runs). The world is the
# tensor_parallelism; runs are the samplings of the prompts, in turn.
CASES = {
    "gpt2_dense": (2, "gpt2", dict(kv_block_size=0), (GREEDY, SAMPLED)),
    "gpt2_paged": (2, "gpt2", dict(kv_block_size=16), (GREEDY, SAMPLED)),
    "llama_dense_chunked": (2, "llama", dict(kv_block_size=0, prefill_chunk_tokens=32), (GREEDY,)),
    "llama_paged": (2, "llama", dict(kv_block_size=16), (GREEDY, SAMPLED)),
    "gpt2_spec_paged": (2, "gpt2", dict(kv_block_size=16, spec_decode_tokens=K), (GREEDY,)),
    "llama_dense_tp4": (4, "llama", dict(kv_block_size=0), (GREEDY, SAMPLED)),
    "llama_paged_chunked_tp4": (4, "llama", dict(kv_block_size=16, prefill_chunk_tokens=32),
                                (GREEDY, SAMPLED)),
    "llama_spec_dense_tp4": (4, "llama", dict(kv_block_size=0, spec_decode_tokens=K), (GREEDY,)),
    "gpt2_3h_paged_tp2": (2, "gpt2_3h", dict(kv_block_size=16), (GREEDY,)),
    "llama_10h_dense_tp4": (4, "llama_10h", dict(kv_block_size=0), (GREEDY,)),
    "gpt2_1h_dense_tp2": (2, "gpt2_1h", dict(kv_block_size=0), (GREEDY,)),
    "gpt2_1h_paged_tp2": (2, "gpt2_1h", dict(kv_block_size=16), (GREEDY,)),
}
UNEVEN = [name for name, case in CASES.items() if case[1] in UNEVEN_SHAPES]
BATCH_CASE = (2, "gpt2", dict(kv_block_size=16))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """family -> (jax config, port config fields, target pickle, draft
    pickle). Every leaf of the target is perturbed from its init (so that
    GPT-2's biases are not zero: a row bias added on every rank before the
    sum would hide behind a zero one), and the draft is the target's first
    layer perturbed again, so its proposals are sometimes rejected."""
    out = {}
    for family, jmod, pcfg, fields, seed in (
        ("gpt2", jgpt2, pgpt2.GPT2Config, SHAPE, 11),
        ("llama", jllama, pllama.LlamaConfig, LLAMA_SHAPE, 12),
        ("gpt2_3h", jgpt2, pgpt2.GPT2Config, UNEVEN_SHAPES["gpt2_3h"], 13),
        ("llama_10h", jllama, pllama.LlamaConfig, UNEVEN_SHAPES["llama_10h"], 14),
        ("gpt2_1h", jgpt2, pgpt2.GPT2Config, UNEVEN_SHAPES["gpt2_1h"], 15),
    ):
        config = jmod.LlamaConfig if family.startswith("llama") else jmod.GPT2Config
        jcfg = dataclasses.replace(config.tiny(**fields), dtype=jnp.float32, attn_impl="reference")
        pcfg = pcfg.tiny(**fields)
        rng = np.random.default_rng(seed)
        noise = lambda a: a + 0.02 * rng.standard_normal(a.shape, dtype=np.float32)  # noqa: E731
        tree = jax.tree.map(lambda a: noise(np.asarray(a)), jmod.init_params(jax.random.key(seed), jcfg))
        draft = dict(tree, blocks={k: v[:1] for k, v in tree["blocks"].items()})
        draft = jax.tree.map(noise, draft)
        paths = []
        for name, t in (("target", tree), ("draft", draft)):
            path = tmp_path_factory.mktemp("weights") / f"{family}_{name}.pkl"
            with open(path, "wb") as f:
                pickle.dump(t, f)
            paths.append(str(path))
        pfields = {f.name: getattr(pcfg, f.name) for f in dataclasses.fields(pcfg)
                   if f.name not in ("dtype", "param_dtype")}
        out[family] = (jcfg, pfields, *paths)
    return out


def _fields(weights, world, family, over):
    """The LLMConfig fields of a case, for the JAX engine (its config
    objects) and for the worker ((family, fields) pairs)."""
    jcfg, pfields, path, dpath = weights[family]
    serve = {**SERVE, **over, "tensor_parallelism": world, "weights_path": path}
    jax_fields = dict(serve, model_config=jcfg)
    family = family.split("_")[0]  # the shapes' model family
    port_fields = dict(serve, model_config=(family, pfields))
    if over.get("spec_decode_tokens"):
        jax_fields.update(draft_model_config=dataclasses.replace(jcfg, n_layer=1),
                          draft_weights_path=dpath)
        port_fields.update(draft_model_config=(family, dict(pfields, n_layer=1)),
                           draft_weights_path=dpath)
    return jax_fields, port_fields


def _worker_cases(weights, world):
    cases = []
    for name, (w, family, over, runs) in CASES.items():
        if w == world:
            _, port = _fields(weights, w, family, over)
            cases.append(dict(name=name, kind="serve", config=port,
                              runs=[(_prompts(), s) for s in runs]))
    if world == 2:
        w, family, over = BATCH_CASE
        cases.append(dict(name="batch", kind="batch", config=_fields(weights, w, family, over)[1],
                          sampling=GREEDY, batch=BATCH))
        _, good = _fields(weights, 2, "gpt2", dict(kv_block_size=16))
        odd_vocab = dict(good, model_config=("gpt2", dict(good["model_config"][1], vocab_size=513)))
        _, llama4 = _fields(weights, 4, "llama", dict(kv_block_size=16))
        cases.append(dict(name="raises", kind="raises", configs=[
            odd_vocab,  # tp=2 does not divide vocab_size=513
            llama4,  # tp=4 over a group of 2 ranks
        ]))
        cases.append(dict(name="handoff", kind="handoff", config=good, prompts=_prompts(),
                          tokens=GREEDY["max_tokens"]))
    return cases


def _start(world, cases, tmp):
    cases_path, store = tmp / "cases.pkl", tmp / "store"
    with open(cases_path, "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(r), str(world), str(store), str(cases_path), str(tmp)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for r in range(world)
    ]


def _join(procs, tmp):
    """Each rank's results; a rank that fails or outlives JOIN_S fails the
    test, and every child still running is killed."""
    errors = []
    try:
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(timeout=JOIN_S)
            except subprocess.TimeoutExpired:
                errors.append(f"rank {r} still running after {JOIN_S} s")
                break
            if p.returncode != 0:
                errors.append(f"rank {r} exited {p.returncode}:\n{err}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not errors, "\n".join(errors)
    out = []
    for r in range(len(procs)):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _points() -> dict:
    return {(n, frozenset(t.items())): v for n, t, v in jmetrics.registry().snapshot()["points"]
            if n.startswith("raytpu_llm_")}


def _delta(before: dict, after: dict) -> dict:
    meta = jmetrics.registry().snapshot()["meta"]
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
    ring = jflightrec.snapshot(planes=["llm"])["rings"].get("llm", {"events": [], "dropped": 0})
    assert ring["dropped"] == 0
    return [(e["phase"], e.get("rid"), *(e.get("extra", {}).get(k) for k in
                                         ("tokens", "reused", "start", "batch")))
            for e in ring["events"]]


def _jax_serve(weights, name, tp=None):
    """The JAX engine's results on a case, at its degree or at ``tp``."""
    world, family, over, runs = CASES[name]
    fields = _fields(weights, world, family, over)[0]
    engine = JEngine(JLLMConfig(**dict(fields, tensor_parallelism=tp or world)))
    firsts = {}
    sample = engine._sample

    def recording(logits, req):
        if not req.generated:
            firsts[req.request_id] = np.array(logits, np.float32)
        return sample(logits, req)

    engine._sample = recording
    jflightrec.reset()
    before = _points()
    streams = [[o["token_ids"] for o in engine.generate(_prompts(), JSampling(**s))] for s in runs]
    return dict(streams=streams, firsts=firsts, stats=dict(engine.stats),
                kv_stats=engine.kv_stats(), delta=_delta(before, _points()), ring=_ring())


def _jax_batch(weights):
    world, family, over = BATCH_CASE
    proc = jbatch.build_llm_processor(JLLMConfig(**_fields(weights, world, family, over)[0]),
                                      sampling=JSampling(**GREEDY))
    try:
        return proc(BATCH)
    finally:
        jbatch._ENGINE_CACHE.clear()


@pytest.fixture(scope="module")
def runs(weights, tmp_path_factory):
    """(ranks by world, JAX results by case): both worlds' ranks start
    first, then the JAX engine serves every case here while they run."""
    saved = {f: getattr(JCONFIG, f) for f in ("metrics_enabled", "flightrec", "spec_decode")}
    JCONFIG.metrics_enabled = JCONFIG.flightrec = JCONFIG.spec_decode = True
    started = {}
    try:
        for world in (2, 4):
            tmp = tmp_path_factory.mktemp(f"world{world}")
            started[world] = (_start(world, _worker_cases(weights, world), tmp), tmp)
        # The uneven cases' JAX engines serve in their tests (_want), so the
        # fixture's work stays what it was before them.
        want = {name: _jax_serve(weights, name) for name in CASES if name not in UNEVEN}
        want["batch"] = _jax_batch(weights)
        ranks = {w: _join(*started.pop(w)) for w in (2, 4)}
    finally:
        for procs, _ in started.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for f, v in saved.items():
            setattr(JCONFIG, f, v)
    return ranks, want


def _want(runs, weights, name):
    """The JAX engine's results on a case: from the fixture, or served here
    (once) for an uneven case."""
    want = runs[1]
    if name not in want:
        saved = {f: getattr(JCONFIG, f) for f in ("metrics_enabled", "flightrec", "spec_decode")}
        JCONFIG.metrics_enabled = JCONFIG.flightrec = JCONFIG.spec_decode = True
        try:
            want[name] = _jax_serve(weights, name)
        finally:
            for f, v in saved.items():
                setattr(JCONFIG, f, v)
    return want[name]


def _shape(family):
    return UNEVEN_SHAPES.get(family) or (LLAMA_SHAPE if family == "llama" else SHAPE)


def _local_heads(family, world, rank):
    """(query heads, KV heads) rank ``rank`` holds: a contiguous block of
    ``n_head * r // world`` to ``n_head * (r+1) // world``, and the KV heads
    it reads, once each where each serves as many of its query heads, else
    one per query head."""
    shape = _shape(family)
    lo, hi = rank * shape["n_head"] // world, (rank + 1) * shape["n_head"] // world
    if world > shape["n_head"]:  # rank r holds head r; the ranks past the heads none
        lo, hi = min(rank, shape["n_head"]), min(rank + 1, shape["n_head"])
    if not family.startswith("llama"):
        return hi - lo, hi - lo
    reads = [h * shape["n_kv_head"] // shape["n_head"] for h in range(lo, hi)]
    uniform = len({reads.count(k) for k in reads}) == 1
    return hi - lo, len(set(reads)) if uniform else len(reads)


@pytest.mark.parametrize("name", list(CASES))
def test_tp_engine_matches_jax(runs, weights, name):
    world, family, over, _ = CASES[name]
    ranks, want = runs[0], _want(runs, weights, name)
    got = [r[name] for r in ranks[world]]
    for rank, g in enumerate(got):
        assert g["streams"] == want["streams"], rank
        assert {k: g["stats"][k] for k in COUNTERS} == {k: want["stats"][k] for k in COUNTERS}, rank
        assert g["kv_stats"] == want["kv_stats"], rank
        assert g["firsts"].keys() == want["firsts"].keys()
        for rid, logits in want["firsts"].items():
            np.testing.assert_allclose(g["firsts"][rid], logits, rtol=0, atol=1e-5, err_msg=rid)
        assert g["delta"] == want["delta"], rank
        assert g["ring"] == want["ring"], rank
    if not over.get("prefill_chunk_tokens"):  # chunked, the pool fills after the wave's admissions
        assert got[0]["stats"]["prefix_hits"] >= 1
    if over.get("spec_decode_tokens"):
        assert got[0]["spec"]
        # Proposals both accepted and rejected.
        assert 0 < got[0]["stats"]["spec_accepted"] < got[0]["stats"]["spec_drafted"]
    if over.get("prefill_chunk_tokens"):
        assert got[0]["stats"]["prefill_chunks"] > 0
    if len(CASES[name][3]) == 2:
        assert got[0]["streams"][0] != got[0]["streams"][1]  # the second run sampled


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_returns_rank0s_outputs(runs, name):
    world = CASES[name][0]
    got = [r[name] for r in runs[0][world]]
    for g in got[1:]:
        for key in ("streams", "stats", "kv_stats", "delta", "ring", "step_calls"):
            assert g[key] == got[0][key], key
        assert all(np.array_equal(g["firsts"][rid], f) for rid, f in got[0]["firsts"].items())


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_its_heads_and_gathers_nothing_per_layer(runs, name):
    """The cache or pool carries the rank's KV heads; the weights its heads
    and vocabulary rows; one decode step issues 2 all-reduces a layer, one
    for the embedding, and one gather of the logits."""
    world, family, _, _ = CASES[name]
    shape = _shape(family)
    L, D, Dh = shape["n_layer"], shape["d_model"], shape["d_model"] // shape["n_head"]
    for rank, g in enumerate(r[name] for r in runs[0][world]):
        H, KH = _local_heads(family, world, rank)
        assert g["kv_shape"][:3:2] == (L, KH)
        assert g["kv_shape"][3:] in ((16, Dh), (SERVE["max_seq"], Dh))
        assert g["vocab_rows"] == (shape["vocab_size"] // world, D)
        if family.startswith("gpt2"):
            assert g["weight_shapes"] == {"qkv_w": (L, D, 3 * H * Dh), "proj_w": (L, H * Dh, D)}
        else:
            assert g["weight_shapes"] == {"wq": (L, D, H * Dh), "wk": (L, D, KH * Dh),
                                          "wo": (L, H * Dh, D)}
        assert g["step_calls"] == {"all_reduce": 2 * L + 1, "all_gather_into_tensor": 1}


def test_batch_processor_serves_a_tp_engine(runs):
    ranks, want = runs
    for r in ranks[2]:
        got = r["batch"]
        assert got["reused"]
        assert got["first"] == got["second"] == want["batch"]


def test_failing_configurations_raise_on_every_rank(runs):
    for r in runs[0][2]:
        (kind1, msg1), (kind2, msg2) = r["raises"]["raised"]
        assert kind1 == "ValueError" and "does not divide vocab_size=513" in msg1
        assert kind2 == "ValueError" and "2 ranks" in msg2


def test_tp_without_a_process_group_raises(weights):
    _, pfields, path, _ = weights["gpt2"]
    cfg = dataclasses.replace(pgpt2.GPT2Config(**pfields), dtype=torch.float32)
    config = PLLMConfig(model_config=cfg, weights_path=path, **SERVE, tensor_parallelism=2)
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group of 2 ranks"):
        PEngine(config, device="cpu")
    with pytest.raises(RuntimeError, match="process group of 4 ranks"):
        PEngine(dataclasses.replace(config, tensor_parallelism=4), device="cpu")


@pytest.mark.parametrize("name", UNEVEN)
def test_jax_engine_serves_uneven_heads_as_at_tp1(runs, weights, name):
    """The reference serves a degree that does not divide the heads (XLA
    splits the fused columns whatever the heads), and its greedy streams
    equal its own at tensor_parallelism=1: so the port serves it too
    (test_tp_engine_matches_jax holds the port's ranks to these streams)."""
    assert _want(runs, weights, name)["streams"] == _jax_serve(weights, name, tp=1)["streams"]
    assert CASES[name][0] > 1 and _shape(CASES[name][1])["n_head"] % CASES[name][0]


def test_jax_engine_serves_fewer_heads_than_ranks(weights):
    """The reference also serves a degree above the head count (GPT-2 with
    one head at tensor_parallelism=2), with its own tp=1 streams; so does
    the port, its rank past the head count holding no head
    (test_tp_engine_matches_jax holds its gpt2_1h cases to the JAX
    engine's streams)."""
    jcfg = dataclasses.replace(weights["gpt2"][0], n_head=1)
    prompts = _prompts()[:2]
    streams = [
        [o["token_ids"] for o in JEngine(JLLMConfig(
            model_config=jcfg, **{**SERVE, "prefill_buckets": (64,)}, tensor_parallelism=tp,
        )).generate(prompts, JSampling(**GREEDY))]
        for tp in (1, 2)
    ]
    assert streams[0] == streams[1]


def test_tp_handoffs_equal_the_unified_streams(runs):
    """Disaggregated serving under tensor parallelism: a tp=2 prefill
    engine hands off to a tp=2 decode engine, to a one-rank engine, and a
    one-rank prefill engine to a tp=2 one; every hop's greedy streams equal
    the JAX engine's unified ones, with no prefill on the decode side, no
    fallback, and every rank returning rank 0's."""
    ranks, want = runs
    streams = want["gpt2_paged"]["streams"][0]
    for r in ranks[2]:
        got = r["handoff"]
        hops = ("tp_tp", "tp_one", "one_tp") if "tp_one" in got else ("tp_tp", "one_tp")
        for hop in hops:
            out, stats = got[hop]
            assert out == streams, hop
            assert stats["prefill_tokens"] == 0 and stats["kv_fallbacks"] == 0, hop
            assert stats["handoffs_in"] == len(streams), hop
        assert got["tp_tp"] == ranks[2][0]["handoff"]["tp_tp"]
    assert "tp_one" in ranks[2][0]["handoff"]
