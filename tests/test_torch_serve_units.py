"""The port's serve tier against the reference's classes, without a cluster.

The same inputs go through ``ray_tpu.serve`` and ``ray_tpu_torch.serve``
and the decisions must agree: admission (token buckets, priority shedding
and the watermark tracker) over one seeded arrival replay on a virtual
clock (``instrument=False``, as ``tests/test_admission.py`` replays), the
router's ``_pick`` / ``_pick_prefix`` under one seeded ``random`` state on
the fake replicas of ``tests/test_serve_llm_routing.py``, ``_apply`` of a
table with disaggregated roles, the controller's routing table under the
kill switches, the new config fields' environment parsing, the prompt
digests the router hashes against the engine's ``chain_digests``, the
proxy's request parsing and 429 reply, ``@serve.batch`` and
``@serve.multiplexed`` on the same call sequences, and
``build_openai_app``'s refusals.
"""

import asyncio
import dataclasses
import random
import time

import numpy as np
import pytest
import torch

from ray_tpu.core import config as jconfig
from ray_tpu.core import errors as jerrors
from ray_tpu.serve import admission as jadm
from ray_tpu.serve import batching as jbatching
from ray_tpu.serve import multiplex as jmultiplex
from ray_tpu.serve.controller import ServeController as JController
from ray_tpu.serve.proxy import HTTPProxyActor as JProxy
from ray_tpu.serve.proxy import _overload_response as j_overload_response
from ray_tpu.serve.router import Router as JRouter
from ray_tpu.util import prefix_digest as jdigest
from ray_tpu_torch.core import config as pconfig
from ray_tpu_torch.core import errors as perrors
from ray_tpu_torch.llm import LLMConfig, LLMServer, build_openai_app
from ray_tpu_torch.llm.tokenizer import ByteTokenizer
from ray_tpu_torch.models.gpt2 import GPT2Config
from ray_tpu_torch.serve import admission as padm
from ray_tpu_torch.serve import batching as pbatching
from ray_tpu_torch.serve import multiplex as pmultiplex
from ray_tpu_torch.serve.controller import ServeController as PController
from ray_tpu_torch.serve.proxy import HTTPProxyActor as PProxy
from ray_tpu_torch.serve.proxy import _overload_response as p_overload_response
from ray_tpu_torch.serve.router import Router as PRouter
from ray_tpu_torch.util import prefix_digest as pdigest

SIDES = {
    "ref": dict(adm=jadm, cfg=jconfig.GLOBAL_CONFIG, errors=jerrors, router=JRouter,
                controller=JController, batching=jbatching, multiplex=jmultiplex),
    "port": dict(adm=padm, cfg=pconfig.GLOBAL_CONFIG, errors=perrors, router=PRouter,
                 controller=PController, batching=pbatching, multiplex=pmultiplex),
}


def both(fn):
    """fn(side) on the reference and on the port."""
    return fn(SIDES["ref"]), fn(SIDES["port"])


# -- admission ------------------------------------------------------------------


def _arrivals(seed: int, n: int = 600):
    """(t, tenant, priority): a flash crowd over a base rate, tenant-0 heavy."""
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    for i in range(n):
        rate = 60.0 if n // 3 <= i < 2 * n // 3 else 15.0
        t += float(rng.exponential(1.0 / rate))
        tenant = "t0" if rng.random() < 0.6 else f"t{int(rng.integers(1, 4))}"
        priority = str(rng.choice(["interactive", "batch", "best_effort", "", "BATCH"],
                                  p=[0.4, 0.25, 0.2, 0.1, 0.05]))
        out.append((t, tenant, priority))
    return out


ADMISSION_CONFIGS = {
    "buckets_and_watermarks": dict(tenant_rate=5.0, tenant_burst=8, queue_high=6.0,
                                   queue_low=2.0, down_hold_s=0.5, retry_after_s=0.7,
                                   tenants={"t0": {"rate": 12.0, "burst": 4}}),
    "unlimited_tenants": dict(queue_high=4.0, queue_low=1.0, down_hold_s=1.0),
    "cluster_defaults": {},
}


def _replay(side, cfg_in: dict, seed: int, capacity_rps: float = 20.0):
    adm = side["adm"]
    cfg = adm.resolve_admission_config(cfg_in)
    clock = [0.0]
    ac = adm.AdmissionController("d", cfg, now_fn=lambda: clock[0], instrument=False)
    tracker = adm.WatermarkTracker(cfg)
    queue, last, out = 0.0, 0.0, []
    for t, tenant, priority in _arrivals(seed):
        queue = max(0.0, queue - (t - last) * capacity_rps)
        last = clock[0] = t
        level = tracker.update(queue, 0.0, t)
        try:
            ac.check(tenant, priority, level)
        except side["errors"].OverloadedError as e:
            out.append((level, e.reason, round(e.retry_after_s, 12)))
            continue
        out.append((level, "admitted", ac._buckets[tenant].tokens if tenant in ac._buckets else None))
        queue += 1.0
    return cfg, out


@pytest.mark.parametrize("name", list(ADMISSION_CONFIGS))
@pytest.mark.parametrize("seed", [7, 19])
def test_admission_replay_same_decisions(name, seed):
    (jcfg, ref), (pcfg, port) = both(lambda s: _replay(s, ADMISSION_CONFIGS[name], seed))
    assert pcfg == jcfg
    assert port == ref
    reasons = {r for _, r, _ in ref}
    assert "admitted" in reasons and "shed" in reasons, reasons
    if name == "buckets_and_watermarks":
        assert "throttled" in reasons


def test_admission_reconfigure_and_identity_helpers():
    def run(side):
        adm = side["adm"]
        clock = [0.0]
        cfg = adm.resolve_admission_config(dict(tenant_rate=2.0, tenant_burst=2))
        ac = adm.AdmissionController("d", cfg, now_fn=lambda: clock[0], instrument=False)
        for tenant in ("a", "b", "a"):
            ac.check(tenant, "", 0)
        ac.reconfigure(adm.resolve_admission_config(
            dict(tenant_rate=2.0, tenant_burst=2, tenants={"b": {"rate": 9.0}})))
        kept = {k: b.tokens for k, b in ac._buckets.items()}
        headers = {"x-raytpu-tenant": "acme", "x-raytpu-priority": "Best_Effort"}
        return (
            kept,
            adm.extract_identity(({"headers": headers},), {}),
            adm.extract_identity(("plain",), {}),
            [adm.normalize_priority(p) for p in ("batch", "", None, "BATCH", "nope")],
            [adm.shed_rank_threshold(level) for level in (-1, 0, 1, 2, 3)],
            adm.resolve_admission_config(None),
        )

    ref, port = both(run)
    assert port == ref
    assert ref[0] == {"a": 0.0}  # b's budget changed: its bucket is dropped


# -- router ------------------------------------------------------------------------


class _FakeReplica:
    def __init__(self, rid):
        self._actor_id = rid


def _router(side, replicas, state=None, inflight=None):
    """The routing-test router of tests/test_serve_llm_routing.py:207-228."""
    r = side["router"].__new__(side["router"])
    r._controller = None
    r._deployment = "unit"
    r._replicas = replicas
    r._version = 1
    r._inflight = dict(inflight or {x._actor_id: 0 for x in replicas})
    r._recently_dead = {}
    r._model_replicas = {}
    r._listen_task = None
    r._affinity = "prompt_prefix"
    r._affinity_cfg = {"scheme": "byte-bos", "chunk": 16}
    r._replica_state = dict(state or {})
    r._state_fetched = time.monotonic() + 3600  # no background fetches
    r._state_task = None
    r._max_concurrent = 8
    r._admission = None
    r._shed_level = 0
    r._disagg_roles = {}
    return r


def _adv(digests, qlen=0):
    return {"queue_len": qlen, "age_s": 0.1, "state": {"digests": digests}}


def _pick_sequence(side, seed: int):
    """A seeded sequence of picks over 4 replicas: pure pow-2, prefix
    matches (longest wins, saturated spills), model affinity, exclusion and
    role subsets; the in-flight estimates move between picks."""
    reps = [_FakeReplica(c * 12) for c in "abcd"]
    state = {"a" * 12: _adv([101]), "b" * 12: _adv([101, 102]), "c" * 12: _adv([7])}
    router = _router(side, reps, state=state)
    rng = np.random.default_rng(seed)
    random.seed(seed)
    picks = []
    for i in range(200):
        for r in reps:
            router._inflight[r._actor_id] = int(rng.integers(0, 12))
        kind = i % 6
        if kind == 0:
            got = router._pick("")
        elif kind == 1:
            got = router._pick("", [101, 102, 103])
        elif kind == 2:
            got = router._pick("", [7, 8], count_prefix=False)
        elif kind == 3:
            key = f"m{int(rng.integers(0, 3))}"
            got = router._pick(key)
            router._note_model(key, got._actor_id)
        elif kind == 4:
            got = router._pick("", None, exclude=reps[int(rng.integers(0, 4))]._actor_id)
        else:
            got = router._pick("", [101], candidates=reps[1:3])
        picks.append(got._actor_id[0])
    prefix = (router._pick_prefix([101, 102, 103]), router._pick_prefix([1, 2]))
    return picks, {k: list(v) for k, v in router._model_replicas.items()}, [
        None if p is None else p._actor_id for p in prefix]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_router_picks_same_under_one_seed(seed):
    ref, port = both(lambda s: _pick_sequence(s, seed))
    assert port == ref
    assert len(set(ref[0])) == 4  # every replica was picked at some point


@pytest.mark.parametrize("case", ["longest_match", "miss", "within_margin", "past_margin"])
def test_pick_prefix_cases(case):
    def run(side):
        a, b = _FakeReplica("a" * 12), _FakeReplica("b" * 12)
        if case == "longest_match":
            r = _router(side, [a, b], state={"a" * 12: _adv([101]), "b" * 12: _adv([101, 102])})
            return r._pick_prefix([101, 102, 103]) is b, r._pick("px:deadbeef", [101, 102, 103]) is b
        if case == "miss":
            r = _router(side, [a, b], state={"a" * 12: _adv([999])})
            return r._pick_prefix([1, 2, 3]) is None, r._pick("", [1, 2, 3]) in (a, b)
        load = 2 if case == "within_margin" else 9
        r = _router(side, [a, b], state={"a" * 12: _adv([7])}, inflight={"a" * 12: load, "b" * 12: 0})
        got = r._pick_prefix([7])
        return None if got is None else got._actor_id, r._pick("", [7])._actor_id

    ref, port = both(run)
    assert port == ref
    want = {"longest_match": (True, True), "miss": (True, True),
            "within_margin": ("a" * 12, "a" * 12), "past_margin": (None, "b" * 12)}
    assert ref == want[case]


def _apply_disagg(side, disagg_on: bool, prefill_alive: bool = True):
    reps = [_FakeReplica(c * 12) for c in "pqd"]
    router = _router(side, [])
    table = {
        "version": 5,
        "replicas": reps if prefill_alive else reps[2:],
        "max_concurrent": 3,
        "affinity": "prompt_prefix",
        "affinity_config": {"scheme": "byte-bos", "chunk": 32},
        "admission": side["adm"].resolve_admission_config({"tenant_rate": 4.0}),
        "shed_level": 1,
        "disagg": {"roles": {"p" * 12: "prefill", "q" * 12: "prefill", "d" * 12: "decode"}},
    }
    router._model_replicas = {"px:k": ["p" * 12, "gone"]}
    old = side["cfg"].disagg
    side["cfg"].disagg = disagg_on
    try:
        router._apply(table)
        return dict(
            version=router._version,
            roles=router._disagg_roles,
            prefill=[r._actor_id for r in router._role_replicas("prefill")],
            decode=[r._actor_id for r in router._role_replicas("decode")],
            active=router._disagg_active(),
            max_concurrent=router._max_concurrent,
            shed_level=router._shed_level,
            admission=router._admission.config,
            admission_on=router._admission_on(),
            model_replicas=router._model_replicas,
            prefix_routing_on=router._prefix_routing_on(),
        )
    finally:
        side["cfg"].disagg = old


@pytest.mark.parametrize("disagg_on", [True, False], ids=["disagg_on", "kill_switch"])
@pytest.mark.parametrize("prefill_alive", [True, False], ids=["both_tiers", "no_prefill_tier"])
def test_router_apply_disagg_table(disagg_on, prefill_alive):
    ref, port = both(lambda s: _apply_disagg(s, disagg_on, prefill_alive))
    assert port == ref
    assert ref["active"] == (disagg_on and prefill_alive)
    assert ref["decode"] == ["d" * 12]


@pytest.mark.parametrize("switch", ["prefix_routing", "admission", "disagg"])
def test_router_kill_switches(switch):
    def run(side):
        router = _router(side, [_FakeReplica("p" * 12), _FakeReplica("d" * 12)])
        router._apply({
            "version": 2, "replicas": router._replicas, "affinity": "prompt_prefix",
            "affinity_config": {"scheme": "byte-bos", "chunk": 16},
            "admission": side["adm"].resolve_admission_config({}),
            "disagg": {"roles": {"p" * 12: "prefill", "d" * 12: "decode"}},
        })
        probe = {"prefix_routing": router._prefix_routing_on, "admission": router._admission_on,
                 "disagg": router._disagg_active}[switch]
        old = getattr(side["cfg"], switch)
        on = probe()
        setattr(side["cfg"], switch, False)
        try:
            return on, probe()
        finally:
            setattr(side["cfg"], switch, old)

    ref, port = both(run)
    assert port == ref == (True, False)


# -- controller ----------------------------------------------------------------------


def _bare_controller(side, config: dict, replicas: list):
    ctrl = side["controller"].__new__(side["controller"])
    ctrl._deployments = {"d": {"config": config, "payload": b"", "init": b"",
                               "replicas": [(r, 0.0) for r in replicas], "version": 3,
                               "next_replica_id": len(replicas)}}
    return ctrl


def _tables(side, flag: str):
    """get_routing with the switch on, off, and of the same deployment
    without the plane: the off table must equal the plane-less one."""
    reps = [_FakeReplica(c * 12) for c in "abc"]
    config = {"num_replicas": 3, "disagg_config": {"prefill_replicas": 2},
              "admission_config": {"tenant_rate": 3.0}, "max_concurrent_queries": 5}
    ctrl = _bare_controller(side, dict(config), reps)
    plain = _bare_controller(side, {k: v for k, v in config.items()
                                    if k != f"{flag}_config"}, reps)
    loop = asyncio.new_event_loop()
    old = getattr(side["cfg"], flag)
    try:
        on = loop.run_until_complete(ctrl.get_routing("d", -1))
        setattr(side["cfg"], flag, False)
        off = loop.run_until_complete(ctrl.get_routing("d", -1))
        unified = loop.run_until_complete(plain.get_routing("d", -1))
        cheap = loop.run_until_complete(ctrl.get_routing("d", 3))
    finally:
        setattr(side["cfg"], flag, old)
        loop.close()
    strip = lambda t: {k: ([r._actor_id for r in v] if k == "replicas" else v)  # noqa: E731
                       for k, v in t.items()}
    return strip(on), strip(off), strip(unified), cheap


@pytest.mark.parametrize("flag", ["disagg", "admission"])
def test_controller_strips_plane_under_kill_switch(flag):
    ref, port = both(lambda s: _tables(s, flag))
    assert port == ref
    on, off, unified, cheap = ref
    assert flag in on and flag not in off and off == unified
    assert cheap == {"version": 3}
    if flag == "disagg":
        # The first prefill_replicas replicas in membership order prefill.
        assert on["disagg"]["roles"] == {"a" * 12: "prefill", "b" * 12: "prefill",
                                         "c" * 12: "decode"}


# -- config ------------------------------------------------------------------------

NEW_FIELDS = {
    "prefix_routing": "0", "prefix_route_staleness_s": "0.25", "admission": "false",
    "disagg": "no", "serve_max_concurrent": "3", "serve_queue_cap_factor": "1.5",
    "serve_shed_queue_high": "4.5", "serve_shed_queue_low": "1.25",
    "serve_shed_ttft_high_ms": "800", "serve_shed_ttft_low_ms": "200",
    "serve_tenant_header": "x-org",
}


@pytest.mark.parametrize("field", list(NEW_FIELDS))
def test_config_field_default_and_env_parsing(field, monkeypatch):
    assert getattr(pconfig.Config(), field) == getattr(jconfig.Config(), field)
    monkeypatch.setenv(f"RAY_TPU_{field.upper()}", NEW_FIELDS[field])
    ref, port = getattr(jconfig.load_config(), field), getattr(pconfig.load_config(), field)
    assert port == ref and type(port) is type(ref)
    assert port != getattr(pconfig.Config(), field)


# -- prompt digests ----------------------------------------------------------------

TEXTS = ["", "hi", "SYSTEM: concise assistant. answer briefly please. Q: why?",
         "héllo wörld " * 40, "x" * 5000]


@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("text", TEXTS, ids=lambda t: f"len{len(t)}")
def test_prompt_digests_are_the_engines_chain_digests(text, chunk):
    got = pdigest.prompt_digests(text, chunk, pdigest.BYTE_BOS_SCHEME)
    ids = ByteTokenizer().encode(text)
    assert got == pdigest.chain_digests(ids, chunk, max_blocks=pdigest.MAX_PROMPT_BLOCKS)
    assert got == jdigest.prompt_digests(text, chunk, jdigest.BYTE_BOS_SCHEME)
    assert len(got) == min((len(ids) - 1) // chunk, pdigest.MAX_PROMPT_BLOCKS)
    assert pdigest.prompt_digests(text, chunk, "custom") == []


def test_chat_prompt_matches_reference():
    msgs = [{"role": "system", "content": "be brief"}, {"content": "no role"},
            "not a dict", {"role": "user", "content": "héllo"}, {"role": "assistant"}]
    assert pdigest.chat_prompt(msgs) == jdigest.chat_prompt(msgs)
    assert pdigest.chat_prompt(msgs) == "system: be brief\nuser: no role\nuser: héllo\nassistant: "


# -- proxy ---------------------------------------------------------------------------

PARSE_CASES = [
    ("POST", "/llm/v1/completions?x=1&x=2&y=z", {"content-type": "application/json"}, b'{"a": 1}'),
    ("GET", "/", {}, b""),
    ("GET", "/Doubler", {"accept": "text/event-stream"}, b"not json"),
    ("POST", "/dep/a/b/", {}, b'{"stream": true}'),
    ("POST", "/dep", {}, b'[1, 2]'),
]


@pytest.mark.parametrize("case", range(len(PARSE_CASES)))
def test_proxy_parse_body_and_stream(case):
    method, target, headers, raw = PARSE_CASES[case]

    def run(proxy):
        parsed = proxy._parse_body(raw)
        return parsed, proxy._parse(method, target, headers, parsed, raw), proxy._wants_stream(headers, parsed)

    assert run(PProxy) == run(JProxy)


@pytest.mark.parametrize("retry", [0.0, 0.2, 1.0, 2.5])
def test_proxy_overload_response(retry):
    for reason in ("shed", "throttled", "queue_full"):
        j = j_overload_response(jerrors.OverloadedError("full", retry_after_s=retry, reason=reason))
        p = p_overload_response(perrors.OverloadedError("full", retry_after_s=retry, reason=reason))
        assert p == j and p[0] == 429


# -- @serve.batch and @serve.multiplexed ----------------------------------------------


def _batch_sequence(side, n_items: int, max_batch: int):
    batch = side["batching"].batch
    seen = []

    class Model:
        @batch(max_batch_size=max_batch, batch_wait_timeout_s=0.05)
        async def double(self, xs):
            seen.append(list(xs))
            if -1 in xs:
                raise ValueError("bad item")
            return [2 * x for x in xs]

    async def go():
        m = Model()
        results = await asyncio.gather(*(m.double(i) for i in range(n_items)))
        bad = await asyncio.gather(m.double(-1), m.double(5), return_exceptions=True)
        return results, [type(b).__name__ if isinstance(b, Exception) else b for b in bad]

    results, bad = asyncio.run(go())
    return results, bad, seen


@pytest.mark.parametrize("n_items,max_batch", [(7, 3), (4, 4), (1, 5)])
def test_serve_batch_same_batches(n_items, max_batch):
    ref, port = both(lambda s: _batch_sequence(s, n_items, max_batch))
    assert port == ref
    assert ref[0] == [2 * i for i in range(n_items)]
    assert ref[1] == ["ValueError", "ValueError"]


def _multiplex_sequence(side):
    mp = side["multiplex"]
    loads = []

    class Multi:
        @mp.multiplexed(max_num_models_per_replica=2)
        async def get_model(self, model_id):
            loads.append(model_id)
            await asyncio.sleep(0.01)
            return f"model:{model_id}"

    async def go():
        m = Multi()
        out = [await m.get_model(k) for k in ("a", "b", "a", "c", "b", "a")]
        out += await asyncio.gather(m.get_model("d"), m.get_model("d"))  # one load
        token = mp._set_model_id("e")
        try:
            out.append(mp.get_multiplexed_model_id())
        finally:
            mp._model_id_ctx.reset(token)
        out.append(mp.get_multiplexed_model_id())
        return out

    return asyncio.run(go()), loads


def test_serve_multiplexed_same_loads():
    ref, port = both(_multiplex_sequence)
    assert port == ref
    assert ref[1] == ["a", "b", "c", "b", "a", "d"]


# -- build_openai_app and LLMServer ---------------------------------------------------


def _tiny(**kw):
    model = dataclasses.replace(GPT2Config.tiny(n_layer=2, d_model=64, n_head=2, max_seq=256),
                                dtype=torch.float32)
    return LLMConfig(model_config=model, max_slots=4, max_seq=256,
                     prefill_buckets=(16, 32, 64, 128, 256), prefix_chunk=16, **kw)


def test_disagg_requires_paged_cache():
    with pytest.raises(ValueError, match="paged"):
        build_openai_app(_tiny(kv_block_size=0), name="x", prefill_replicas=1, device="cpu")


def test_tensor_parallel_replica_is_not_ported():
    with pytest.raises(perrors.NotPortedError, match="tensor_parallelism"):
        build_openai_app(_tiny(tensor_parallelism=2), name="x", device="cpu")
    with pytest.raises(perrors.NotPortedError, match="tensor_parallelism"):
        LLMServer(_tiny(tensor_parallelism=2), device="cpu")


def test_openai_app_deployment_options():
    """The deployment build_openai_app binds: placement as the actor
    options, prefix-affinity routing on the engine's digest contract, the
    disaggregated roles, and ``device`` through bind."""
    app = build_openai_app(_tiny(placement={"num_cpus": 1, "num_gpus": 0.5}), name="d",
                           num_replicas=2, prefill_replicas=1, device="cpu")
    cfg = app.deployment._config
    assert (cfg.name, cfg.num_replicas) == ("d", 3)
    assert cfg.ray_actor_options == {"num_cpus": 1, "num_gpus": 0.5}
    assert cfg.disagg_config == {"prefill_replicas": 1}
    assert cfg.request_affinity == "prompt_prefix"
    assert cfg.request_affinity_config == {"scheme": "byte-bos", "chunk": 16}
    assert app.kwargs == {"device": "cpu"}
    assert LLMConfig().placement == {"num_cpus": 1}
    assert build_openai_app(_tiny()).kwargs == {"device": "cuda"}  # the card by default


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the card-less refusal")
def test_llm_server_asked_for_the_card_without_one_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMServer(_tiny())
