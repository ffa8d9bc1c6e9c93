"""The port's telemetry against the JAX package's, on the CPU in f32.

Both engines load the same pickled numpy weights (a tiny GPT-2, and a
perturbed 1-layer copy as the draft) and serve the same token-id prompts:
a 40-token prompt prefilled in two chunks pools its 32-token prefix, then
a prefix hit (``prefill_continue`` of the suffix, or shared blocks), a
100-token prompt in four chunks, a short fresh prompt and a 45-token one
that waits for a slot. Around each run the registry's snapshot delta and
the ``llm`` flight-recorder ring are taken in each package (registry state
is per process, shared with other test files, so only deltas and gauges
set by the run are compared):

- every ``raytpu_llm_*`` counter's delta, the gauges, the TTFT and ITL
  observation counts and the series' ``meta`` are equal, dense and paged,
  vanilla and speculative;
- the ``llm`` rings hold the same ``(phase, rid, tokens, reused, start,
  batch)`` sequence, with durations >= 0;
- the kill switches (``metrics_enabled``, ``flightrec``, ``spec_decode``)
  turn off only what they name: the streams stay equal;
- ``util/metrics`` and ``util/flightrec`` give the JAX package's
  Prometheus text, ring wrap, drop counts and dump throttle on the same
  records, and reject the same bad declarations;
- ``build_llm_processor`` gives the JAX package's output column and caches
  its engine.
"""

import dataclasses
import functools
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.llm.disagg  # noqa: F401 (declares the JAX kv-ship series)
import ray_tpu.llm.spec_decode  # noqa: F401 (declares the JAX spec series)
import ray_tpu_torch.llm.disagg  # noqa: F401 (declares the port's kv-ship series)
from ray_tpu.core.config import GLOBAL_CONFIG as JCONFIG
from ray_tpu.llm import batch as jbatch
from ray_tpu.llm.config import LLMConfig as JLLMConfig
from ray_tpu.llm.config import SamplingParams as JSampling
from ray_tpu.llm.engine import LLMEngine as JEngine
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.util import flightrec as jflightrec
from ray_tpu.util import metrics as jmetrics
from ray_tpu_torch import llm as pllm
from ray_tpu_torch.core.config import GLOBAL_CONFIG as PCONFIG
from ray_tpu_torch.llm import batch as pbatch
from ray_tpu_torch.models import gpt2 as pgpt2
from ray_tpu_torch.util import flightrec as pflightrec
from ray_tpu_torch.util import metrics as pmetrics

SHAPE = dict(n_layer=2, d_model=64, n_head=2, vocab_size=512, max_seq=256)
SERVE = dict(
    max_slots=3,
    max_seq=256,
    prefill_buckets=(32, 128),
    prefix_chunk=32,
    max_prefix_cache_tokens=1024,
    prefill_chunk_tokens=32,
    seed=5,
)
K = 3  # draft tokens per spec step
MAX_TOKENS = 12
KV = {"dense": 0, "paged": 16}
SWITCHES = ("metrics_enabled", "flightrec", "flightrec_ring_size", "flightrec_dump_dir", "spec_decode")
PACKAGES = {"jax": (jmetrics, jflightrec, JCONFIG), "port": (pmetrics, pflightrec, PCONFIG)}


@pytest.fixture(autouse=True)
def _switches_on():
    """Every test starts with both packages' telemetry and spec decoding on,
    as by default; the switches are restored after."""
    configs = (JCONFIG, PCONFIG)
    saved = [{f: getattr(c, f) for f in SWITCHES} for c in configs]
    for c in configs:
        c.metrics_enabled = c.flightrec = c.spec_decode = True
    yield
    for c, fields in zip(configs, saved):
        for f, v in fields.items():
            setattr(c, f, v)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(jax cfg, port cfg, target pickle, draft pickle): a tiny f32 GPT-2,
    and as its draft the target's first layer with every leaf perturbed, so
    the draft's proposals are sometimes rejected."""
    jcfg = dataclasses.replace(jgpt2.GPT2Config.tiny(**SHAPE), dtype=jnp.float32, attn_impl="reference")
    pcfg = dataclasses.replace(pgpt2.GPT2Config.tiny(**SHAPE), dtype=torch.float32)
    tree = jax.tree.map(np.asarray, jgpt2.init_params(jax.random.key(11), jcfg))
    rng = np.random.default_rng(7)
    draft = dict(tree, blocks={k: v[:1] for k, v in tree["blocks"].items()})
    draft = jax.tree.map(lambda a: a + 0.02 * rng.standard_normal(a.shape, dtype=np.float32), draft)
    paths = []
    for name, t in (("target", tree), ("draft", draft)):
        path = tmp_path_factory.mktemp("weights") / f"{name}.pkl"
        with open(path, "wb") as f:
            pickle.dump(t, f)
        paths.append(str(path))
    return jcfg, pcfg, *paths


def _configs(weights, kv, spec, **over):
    """(jax LLMConfig, port LLMConfig) of one scenario."""
    jcfg, pcfg, path, dpath = weights
    serve = {**SERVE, "kv_block_size": KV[kv], **over}
    out = []
    for cls, cfg in ((JLLMConfig, jcfg), (pllm.LLMConfig, pcfg)):
        draft = {}
        if spec:
            draft = dict(spec_decode_tokens=K, draft_model_config=dataclasses.replace(cfg, n_layer=1),
                         draft_weights_path=dpath)
        out.append(cls(model_config=cfg, weights_path=path, **draft, **serve))
    return out


def _prompts():
    rng = np.random.default_rng(3)
    ids = lambda n: rng.integers(0, 256, n).tolist()  # noqa: E731
    prefix = ids(32)
    return [
        ids(10),
        prefix + ids(8),  # two chunks; pools its 32-token prefix
        prefix + ids(20),  # prefix hit, its 20-token suffix unchunked
        ids(100),  # four chunks
        ids(45),  # two chunks, after waiting for a free slot (max_slots=3)
    ]


def _waves():
    p = _prompts()
    return [p[1]], [p[2], p[3], p[0], p[4]]


def _points(metrics) -> dict:
    """The registry's raytpu_llm_* points, by (name, tags)."""
    return {
        (n, frozenset(t.items())): v
        for n, t, v in metrics.registry().snapshot()["points"]
        if n.startswith("raytpu_llm_")
    }


def _delta(metrics, before: dict, after: dict) -> dict:
    """Counter deltas and histogram observation counts, nonzero only, by
    name. Gauges are last values, compared after the run instead."""
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


def _gauges(points: dict) -> dict:
    return {name: v for (name, tags), v in points.items() if not isinstance(v, dict)}


def _observe(package, run):
    """Run ``run()`` in one package with fresh rings; returns (its result,
    the snapshot delta, the llm ring's events, the gauges before and after
    the run)."""
    metrics, flightrec, _ = PACKAGES[package]
    flightrec.reset()
    before = _points(metrics)
    out = run()
    after = _points(metrics)
    ring = flightrec.snapshot(planes=["llm"])["rings"].get("llm", {"events": [], "dropped": 0})
    assert ring["dropped"] == 0
    return out, _delta(metrics, before, after), ring["events"], (_gauges(before), _gauges(after))


def _serve(engine, sampling_cls):
    return [
        o["token_ids"]
        for wave in _waves()
        for o in engine.generate(wave, sampling_cls(max_tokens=MAX_TOKENS))
    ]


def _key(ev) -> tuple:
    x = ev.get("extra", {})
    return (ev["phase"], ev.get("rid"), x.get("tokens"), x.get("reused"), x.get("start"),
            x.get("batch"))


@pytest.fixture(scope="module")
def scenario(weights):
    """run(kv, spec) -> {"jax": (engine, streams, delta, ring, (gauges
    before, gauges after)), "port": (...)}, each scenario served once per
    module."""

    @functools.lru_cache(maxsize=None)
    def run(kv, spec):
        jconf, pconf = _configs(weights, kv, spec)
        j = JEngine(jconf)
        p = pllm.LLMEngine(pconf, device="cpu")
        out = {}
        for name, eng, sampling in (("jax", j, JSampling), ("port", p, pllm.SamplingParams)):
            streams, delta, ring, gauges = _observe(name, functools.partial(_serve, eng, sampling))
            out[name] = (eng, streams, delta, ring, gauges)
        return out

    return run


def _check_series(res, spec: bool):
    (j, jstreams, jdelta, _, (_, jgauges)), (p, pstreams, pdelta, _, (pbefore, pgauges)) = (
        res["jax"], res["port"])
    assert pstreams == jstreams
    assert pdelta == jdelta
    prompts = [t for wave in _waves() for t in wave]
    firsts = len(prompts)
    gen = p.stats["tokens_generated"]
    assert pdelta["raytpu_llm_requests_total"] == firsts
    assert pdelta["raytpu_llm_prompt_tokens_total"] == sum(map(len, prompts))
    assert pdelta["raytpu_llm_generated_tokens_total"] == gen == sum(map(len, pstreams))
    assert pdelta["raytpu_llm_prefill_chunks_total"] == p.stats["prefill_chunks"] == 8
    assert pdelta["raytpu_llm_ttft_seconds"] == firsts
    # Every token after a request's first observes an inter-token latency
    # (a spec burst's later tokens observe 0.0).
    assert pdelta["raytpu_llm_itl_seconds"] == gen - firsts
    hit_rate = p.stats["prefix_hits"] / p.stats["prefix_lookups"]
    assert pgauges["raytpu_llm_prefix_hit_rate"] == jgauges["raytpu_llm_prefix_hit_rate"] == hit_rate
    if p.paged:
        # Every request has finished: only the prefix pool's blocks are in use.
        kv = p.kv_stats()
        util = kv["blocks_used"] / kv["blocks_total"]
        assert pgauges["raytpu_llm_kv_utilization"] == jgauges["raytpu_llm_kv_utilization"] == util
        assert util > 0.0
    else:  # dense engines leave it alone
        assert pgauges.get("raytpu_llm_kv_utilization") == pbefore.get("raytpu_llm_kv_utilization")
    if spec:
        assert pdelta["raytpu_llm_spec_drafted_total"] == p.stats["spec_drafted"]
        assert pdelta["raytpu_llm_spec_accepted_total"] == p.stats["spec_accepted"]
        assert 0 < p.stats["spec_accepted"] < p.stats["spec_drafted"]  # some rejected
        rate = p._spec.accept_rate()
        assert pgauges["raytpu_llm_spec_accept_rate"] == jgauges["raytpu_llm_spec_accept_rate"] == rate
    else:
        assert not any(n.startswith("raytpu_llm_spec_") for n in pdelta)
    # The series are declared alike (kind, description, histogram boundaries).
    pmeta = pmetrics.registry().snapshot()["meta"]
    jmeta = jmetrics.registry().snapshot()["meta"]
    names = [n for n in pmeta if n.startswith("raytpu_llm_")]
    # The engine's 12, and the serving replica's step-time and active-request
    # series, which each package's llm/serve_llm.py declares on import.
    assert len(names) == 14
    assert {n: pmeta[n] for n in names} == {n: jmeta[n] for n in names}
    assert pmetrics.runtime_catalog()["raytpu_llm_itl_seconds"] == jmetrics.runtime_catalog()[
        "raytpu_llm_itl_seconds"]


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_serving_series_equal_jax(scenario, kv):
    """Counters, gauges, TTFT/ITL counts and meta, with a prefix hit and
    chunked prefill."""
    _check_series(scenario(kv, False), spec=False)


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_spec_series_equal_jax(scenario, kv):
    """The spec engine: drafted, accepted, the accept-rate gauge and the
    burst ITL counts too; its streams equal the vanilla engine's."""
    res = scenario(kv, True)
    _check_series(res, spec=True)
    assert res["port"][1] == scenario(kv, False)["port"][1]
    assert res["port"][0].stats["spec_steps"] == res["jax"][0].stats["spec_steps"] > 0


@pytest.mark.parametrize("spec", [False, True], ids=["vanilla", "spec"])
@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_llm_ring_equal_jax(scenario, kv, spec):
    """The llm phases in the same order with the same fields; every
    request's first token, prefill and chunks are there."""
    res = scenario(kv, spec)
    jring, pring = res["jax"][3], res["port"][3]
    assert [_key(e) for e in pring] == [_key(e) for e in jring]
    assert all(e["dur_s"] >= 0.0 and e["plane"] == "llm" for e in pring)
    p = res["port"][0]
    phases = [e["phase"] for e in pring]
    assert phases.count("llm.first_token") == 5
    assert phases.count("llm.prefill_chunk") == p.stats["prefill_chunks"] == 8
    assert phases.count("llm.prefill") == 2  # the short fresh prompt and the prefix hit
    prefill_tokens = sum(e["extra"]["tokens"] for e in pring if e["phase"].startswith("llm.prefill"))
    assert prefill_tokens == p.stats["prefill_tokens"]
    reused = sum(e["extra"].get("reused", 0) for e in pring if e["phase"] == "llm.prefill")
    assert reused == p.stats["prefix_tokens_reused"] == 32
    # Every vanilla decode step is a phase; spec steps are not (here every
    # decode step of the spec engine is a spec step).
    decode_steps = phases.count("llm.decode_step")
    assert (decode_steps == 0) if spec else (0 < decode_steps <= p._steps)
    assert all(e["extra"]["batch"] >= 1 for e in pring if e["phase"] == "llm.decode_step")
    json.dumps(pflightrec.snapshot())  # the snapshot is JSON-able as-is


@pytest.mark.parametrize("switch", ["metrics_enabled", "flightrec", "spec_decode"])
def test_kill_switch_turns_off_only_its_part(scenario, weights, switch):
    """Each switch off, on the paged spec configuration: metrics off leaves
    the registry unchanged, flightrec off records no event, spec_decode off
    builds no draft; the streams equal the switches-on run's."""
    want = scenario("paged", True)["port"][1]
    setattr(PCONFIG, switch, False)
    _, pconf = _configs(weights, "paged", True)
    eng = pllm.LLMEngine(pconf, device="cpu")
    before = pmetrics.registry().snapshot()["points"]
    streams, delta, ring, _ = _observe("port", functools.partial(_serve, eng, pllm.SamplingParams))
    after = pmetrics.registry().snapshot()["points"]
    assert streams == want
    if switch == "metrics_enabled":
        assert after == before and delta == {}
        assert ring  # the flight recorder still records
    elif switch == "flightrec":
        assert ring == [] and pflightrec.snapshot()["rings"] == {}
        assert pflightrec.dump("overload") is None
        assert delta["raytpu_llm_spec_drafted_total"] == eng.stats["spec_drafted"] > 0
    else:  # the vanilla engine's run, phase for phase
        assert eng._spec is None and eng.stats["spec_steps"] == 0
        vanilla = scenario("paged", False)["port"]
        assert delta == vanilla[2]
        assert [_key(e) for e in ring] == [_key(e) for e in vanilla[3]]


def test_spec_decode_switch_matches_jax(weights):
    """The JAX engine with its switch thrown also builds no draft, and needs
    no draft config either (it is checked only when a draft is built)."""
    JCONFIG.spec_decode = PCONFIG.spec_decode = False
    jconf, pconf = _configs(weights, "dense", False, spec_decode_tokens=K)
    assert JEngine(jconf)._spec is None
    assert pllm.LLMEngine(pconf, device="cpu")._spec is None


# -- util/metrics and util/flightrec against the JAX package's ---------------


def _fill(metrics):
    """The same describes and records in a fresh registry of either package."""
    reg = metrics.MetricsRegistry()
    reg.describe("raytpu_test_total", "counter", "a counter")
    reg.describe("raytpu_test_gauge", "gauge", 'a "quoted" gauge')
    reg.describe("raytpu_test_seconds", "histogram", "latency", boundaries=metrics.LATENCY_BOUNDARIES_S)
    reg.describe("raytpu_test_default_seconds", "histogram")
    for i in range(5):
        reg.record("raytpu_test_total", 1.5, {"plane": "llm"})
        reg.record("raytpu_test_total", 1.0, {"plane": 'a\\b"c\nd'})
        reg.record("raytpu_test_gauge", 0.25 * i, {"replica": "local"})
        reg.record("raytpu_test_seconds", 10.0 ** -i)
        reg.record("raytpu_test_default_seconds", 3.0 * i)
    return reg.snapshot()


def test_prometheus_text_and_merge_equal_jax():
    jsnap, psnap = _fill(jmetrics), _fill(pmetrics)
    assert psnap == jsnap
    ptext = pmetrics.to_prometheus(psnap)
    assert ptext == jmetrics.to_prometheus(jsnap)
    assert 'le="+Inf"' in ptext and '{plane="a\\\\b\\"c\\nd"} 5.0' in ptext
    assert '# HELP raytpu_test_gauge a "quoted" gauge' in ptext
    pmerged = pmetrics.merge_snapshots([psnap, _fill(pmetrics)])
    assert pmerged == jmetrics.merge_snapshots([jsnap, _fill(jmetrics)])
    assert pmetrics.to_prometheus(pmerged) == jmetrics.to_prometheus(pmerged)
    assert pmetrics.to_prometheus({}) == jmetrics.to_prometheus({}) == ""


@pytest.mark.parametrize("package", ["jax", "port"])
def test_declare_runtime_metric_rejects_bad_series(package):
    metrics = PACKAGES[package][0]
    with pytest.raises(ValueError, match="prefix"):
        metrics.declare_runtime_metric("llm_unprefixed_total", "counter")
    with pytest.raises(ValueError, match="cardinality"):
        metrics.declare_runtime_metric("raytpu_test_req_total", "counter", tag_keys=("request_id",))
    with pytest.raises(ValueError, match="cardinality"):
        metrics.Counter("raytpu_test_task_total", tag_keys=("task_id", "plane"))
    meta = metrics.declare_runtime_metric("raytpu_test_ok_total", "counter", "ok", ("plane",))
    assert meta == {"kind": "counter", "description": "ok", "boundaries": metrics._DEFAULT_HIST_BOUNDARIES}
    with pytest.raises(ValueError, match="already declared"):
        metrics.declare_runtime_metric("raytpu_test_ok_total", "gauge")
    counter = metrics.Counter("raytpu_test_tagged_total", tag_keys=("plane",))
    with pytest.raises(ValueError, match="missing declared tag"):
        counter.inc()
    with pytest.raises(ValueError, match="undeclared tag"):
        counter.inc(1.0, {"plane": "llm", "other": "x"})


def _obs_totals(metrics) -> dict:
    out: dict = {}
    for n, _t, v in metrics.registry().snapshot()["points"]:
        if n.startswith("raytpu_obs_"):
            out[n] = out.get(n, 0.0) + v
    return out


def _ring_run(package):
    """20 events into an 8-event ring, one with a span context, then a
    snapshot; returns (events without their clock, drops, obs counter
    deltas)."""
    metrics, flightrec, config = PACKAGES[package]
    config.flightrec_ring_size = 8
    flightrec.reset()
    obs0 = _obs_totals(metrics)
    for i in range(20):
        flightrec.record("llm", "llm.decode_step", dur_s=0.5, rid=f"r{i}", batch=i)
    with flightrec.phase("serve", "serve.pick", rid="p", reason="x"):
        pass
    snap = flightrec.snapshot()
    obs = _obs_totals(metrics)
    events = {plane: [{k: v for k, v in e.items() if k != "t"} for e in ring["events"]]
              for plane, ring in snap["rings"].items()}
    (pick,) = events["serve"]
    assert pick.pop("dur_s") >= 0.0  # the timed block's duration
    dropped = {plane: ring["dropped"] for plane, ring in snap["rings"].items()}
    assert (flightrec.drops("llm"), flightrec.drops("nowhere")) == (12, 0)
    flightrec.reset()
    # Nonzero deltas only: another test in this process may have left a
    # point (a dump count, say) that this run does not move.
    return events, dropped, {k: obs[k] - obs0.get(k, 0.0) for k in obs if obs[k] != obs0.get(k, 0.0)}


def test_ring_wrap_and_drops_equal_jax():
    pout, jout = _ring_run("port"), _ring_run("jax")
    assert pout == jout
    events, dropped, obs = pout
    assert [e["rid"] for e in events["llm"]] == [f"r{i}" for i in range(12, 20)]
    assert dropped == {"llm": 12, "serve": 0}
    pick = {"plane": "serve", "phase": "serve.pick", "rid": "p", "extra": {"reason": "x"}}
    assert events["serve"] == [pick]
    assert obs["raytpu_obs_events_total"] == 21 and obs["raytpu_obs_ring_drops_total"] == 12


def _dump_run(package, tmp_path):
    """Dumps: a reason, the same reason again within the throttle, another
    reason; then with the recorder off."""
    _, flightrec, config = PACKAGES[package]
    config.flightrec_dump_dir = str(tmp_path / package)
    flightrec.reset()
    flightrec.record("llm", "llm.prefill", rid="a", tokens=3)
    first = flightrec.dump("actor_death")
    again = flightrec.dump("actor_death")
    other = flightrec.dump("fault:kvship.sever")
    explicit = flightrec.dump("overload", path=str(tmp_path / f"{package}-explicit.json"))
    config.flightrec = False
    off = flightrec.dump("shed")
    config.flightrec = True
    with open(first) as f:
        doc = json.load(f)
    flightrec.reset()
    # File names are flightrec-<pid>-<seq>-<reason>.json; the sequence is
    # per process and never reset, so it is compared relative to the first.
    parts = [p if p is None else p.split("/")[-1].split("-", 3)[2:] for p in (first, again, other, off)]
    seq0 = int(parts[0][0])
    names = [p if p is None else (int(p[0]) - seq0, p[1]) for p in parts]
    rings = {k: [{f: v for f, v in e.items() if f != "t"} for e in r["events"]]
             for k, r in doc["rings"].items()}
    return names, explicit is not None, doc["reason"], rings


def test_dump_throttle_equal_jax(tmp_path):
    pout = _dump_run("port", tmp_path)
    assert pout == _dump_run("jax", tmp_path)
    names, explicit, reason, rings = pout
    assert names == [(0, "actor_death.json"), None, (1, "fault_kvship.sever.json"), None]
    assert explicit and reason == "actor_death"
    assert rings["llm"][0]["extra"] == {"tokens": 3}


# -- batch inference -----------------------------------------------------------


def test_build_llm_processor_equals_jax_and_caches_its_engine(weights):
    jconf, pconf = _configs(weights, "paged", False, prefill_chunk_tokens=0)
    batch = {"prompt": ["one", "two three", "four five six", "seven"], "id": [1, 2, 3, 4]}
    sampling = dict(max_tokens=6)
    jout = jbatch.build_llm_processor(jconf, sampling=JSampling(**sampling))(batch)
    proc = pllm.build_llm_processor(pconf, sampling=pllm.SamplingParams(**sampling), device="cpu")
    n0 = len(pbatch._ENGINE_CACHE)
    out = proc(batch)
    engine = pbatch._engine_for(pconf, "cpu")
    assert len(pbatch._ENGINE_CACHE) == n0 + 1
    again = proc(batch)
    assert pbatch._engine_for(pconf, "cpu") is engine and len(pbatch._ENGINE_CACHE) == n0 + 1
    assert out == again == jout and out["id"] == batch["id"]
    texts = [o["text"] for o in engine.generate(batch["prompt"], pllm.SamplingParams(**sampling))]
    assert out["generated_text"] == texts and len(texts) == 4
    assert proc({"prompt": []}) == {"prompt": [], "generated_text": []}
    named = pllm.build_llm_processor(pconf, input_column="q", output_column="a", device="cpu")
    assert list(named({"q": ["one"]})) == ["q", "a"]
    if not torch.cuda.is_available():  # the card is the default device
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pllm.build_llm_processor(dataclasses.replace(pconf, seed=99))({"prompt": ["x"]})
