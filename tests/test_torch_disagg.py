"""The port's disaggregated prefill→decode serving against the JAX engine's,
on the CPU in f32, case by case from ``tests/test_llm_disagg.py:53-228``;
and the two planes under it, the seeded fault injector
(``ray_tpu_torch/core/faults.py``) and the socket transfer fabric
(``ray_tpu_torch/experimental/transfer.py``).

Both engines load the same pickled tiny weights (GPT-2 with 2 heads; Llama
with 4 query heads over 2 KV heads) and serve the same token-id prompts. A
prefill-only request on engine A hands its KV to engine B, which decodes
with no prefill: B's greedy stream equals a unified engine's, the port's
and the JAX engine's. The JAX package's fabric binds to the loopback
address given in ``RAY_TPU_HOST_IP``, as the port's does by default.
"""

import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.core import faults as jfaults
from ray_tpu.core.config import load_config as jload_config
from ray_tpu.llm import disagg as jdisagg
from ray_tpu.llm.config import LLMConfig as JLLMConfig
from ray_tpu.llm.config import SamplingParams as JSampling
from ray_tpu.llm.engine import LLMEngine as JEngine
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu_torch.core import faults as pfaults
from ray_tpu_torch.core.config import load_config as pload_config
from ray_tpu_torch.core.errors import PeerUnavailableError
from ray_tpu_torch.experimental import transfer as ptransfer
from ray_tpu_torch.llm import disagg as pdisagg
from ray_tpu_torch.llm.config import LLMConfig as PLLMConfig
from ray_tpu_torch.llm.config import SamplingParams as PSampling
from ray_tpu_torch.llm.engine import LLMEngine as PEngine
from ray_tpu_torch.models import gpt2 as pgpt2
from ray_tpu_torch.models import llama as pllama
from ray_tpu_torch.util import flightrec as pflightrec
from ray_tpu_torch.util import metrics as pmetrics

SHAPE = dict(n_layer=2, d_model=64, n_head=2, vocab_size=512, max_seq=256)
LLAMA_SHAPE = dict(n_layer=2, d_model=64, n_head=4, n_kv_head=2, vocab_size=512, max_seq=256)
# tests/test_llm_disagg.py's serving shape; two buckets (each one costs the
# JAX engine a compile).
SERVE = dict(max_slots=4, max_seq=256, prefill_buckets=(32, 128), prefix_chunk=16,
             max_prefix_cache_tokens=512, seed=5)
PROMPT = list(range(2, 70))
GREEDY = dict(max_tokens=10)


@pytest.fixture(scope="module", autouse=True)
def loopback():
    """The JAX package's fabric reads its address from RAY_TPU_HOST_IP."""
    saved = os.environ.get("RAY_TPU_HOST_IP")
    os.environ["RAY_TPU_HOST_IP"] = "127.0.0.1"
    yield
    if saved is None:
        os.environ.pop("RAY_TPU_HOST_IP")
    else:
        os.environ["RAY_TPU_HOST_IP"] = saved


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """family -> (jax config, port config, pickled params)."""
    out = {}
    for family, jmod, pmod, shape, seed in (("gpt2", jgpt2, pgpt2, SHAPE, 11),
                                            ("llama", jllama, pllama, LLAMA_SHAPE, 12)):
        config = "LlamaConfig" if family == "llama" else "GPT2Config"
        jcfg = dataclasses.replace(getattr(jmod, config).tiny(**shape), dtype=jnp.float32,
                                   attn_impl="reference")
        pcfg = dataclasses.replace(getattr(pmod, config).tiny(**shape), dtype=torch.float32)
        path = tmp_path_factory.mktemp("weights") / f"{family}.pkl"
        with open(path, "wb") as f:
            pickle.dump(jax.tree.map(np.asarray, jmod.init_params(jax.random.key(seed), jcfg)), f)
        out[family] = (jcfg, pcfg, str(path))
    return out


def _port(weights, family="gpt2", **kw):
    _, pcfg, path = weights[family]
    return PEngine(PLLMConfig(model_config=pcfg, weights_path=path, **{**SERVE, **kw}), device="cpu")


def _jax(weights, family="gpt2", **kw):
    jcfg, _, path = weights[family]
    return JEngine(JLLMConfig(model_config=jcfg, weights_path=path, **{**SERVE, **kw}))


def _handoff(engine, prompt, sampling, rid="p"):
    engine.add_request(rid, prompt, sampling, prefill_only=True)
    while engine.has_unfinished():
        engine.step()
    (req,) = engine.pop_finished()
    assert req.finished and req.handoff_out is not None
    return req.handoff_out


def _decode(engine, handoffs: dict, sampling) -> dict:
    for rid, h in handoffs.items():
        engine.add_handoff_request(rid, h, sampling)
    steps = 0
    while engine.has_unfinished():
        engine.step()
        steps += 1
        assert steps < 200  # converges: no hang
    return {r.request_id: r.generated for r in engine.pop_finished()}


@pytest.fixture(scope="module")
def unified(weights):
    """The unified engines' greedy stream of PROMPT: (port, JAX)."""
    port = _port(weights).generate([PROMPT], PSampling(**GREEDY))[0]["token_ids"]
    jax_ = _jax(weights).generate([PROMPT], JSampling(**GREEDY))[0]["token_ids"]
    return port, jax_


# -- engine-level handoff -----------------------------------------------------


def test_two_hop_equals_both_unified_engines(weights, unified):
    """Prefill on A, KV shipped to B, decode on B: B's greedy stream equals
    the port's unified engine's and the JAX unified engine's, and B paid no
    prefill token."""
    A, B = _port(weights), _port(weights)
    h = _handoff(A, PROMPT, PSampling(**GREEDY))
    assert h["prompt"] == PROMPT and not h["finished"]
    assert h["nblocks"] == -(-len(PROMPT) // 16) and h["block_size"] == 16
    assert A.stats["handoffs_out"] == 1 and all(A.slot_free)
    got = _decode(B, {"d": h}, PSampling(**GREEDY))["d"]
    assert got == unified[0] == unified[1]
    assert B.stats["handoffs_in"] == 1
    assert B.stats["kv_fallbacks"] == 0
    assert B.stats["prefill_tokens"] == 0


def test_finished_at_prefill_ships_no_kv(weights):
    """max_tokens=1: the first token is the response; no KV ships and the
    decode engine takes no slot."""
    A, B = _port(weights), _port(weights)
    s = PSampling(max_tokens=1)
    h = _handoff(A, PROMPT, s)
    assert h["finished"] and "kv" not in h
    assert _decode(B, {"d": h}, s)["d"] == [h["first_token"]]
    assert B.stats["handoffs_in"] == 0 and all(B.slot_free)


def test_kv_ship_bytes_counted(weights):
    """The pull counts the shipped stack's bytes: 2 * L * nb_pad * KH * bs
    * Dh * itemsize, with nb_pad the block count padded to a power of two;
    the export and the pull are each one flight-recorder event."""

    def shipped():
        return sum(v for n, _t, v in pmetrics.registry().snapshot()["points"]
                   if n == "raytpu_llm_kv_ship_bytes_total")

    A, B = _port(weights), _port(weights)
    h = _handoff(A, PROMPT, PSampling(**GREEDY))
    before = shipped()
    pflightrec.reset()
    _decode(B, {"d": h}, PSampling(**GREEDY))
    nb_pad = pdisagg._pad_pow2(h["nblocks"])
    assert nb_pad == 8 and tuple(h["kv"]["shape"]) == (2, 2, nb_pad, 2, 16, 32)
    assert shipped() - before == 2 * 2 * nb_pad * 2 * 16 * 32 * 4
    events = pflightrec.snapshot(planes=["llm"])["rings"]["llm"]["events"]
    pulls = [e for e in events if e["phase"] == "llm.kv_pull"]
    assert len(pulls) == 1 and pulls[0]["rid"] == "d" and pulls[0]["extra"]["ok"] is True


def test_chunked_prefill_only_gives_the_same_handoff(weights, unified):
    A1, A2 = _port(weights), _port(weights, prefill_chunk_tokens=16)
    h1 = _handoff(A1, PROMPT, PSampling(**GREEDY))
    h2 = _handoff(A2, PROMPT, PSampling(**GREEDY))
    assert A2.stats["prefill_chunks"] >= 2
    assert (h1["first_token"], h1["nblocks"]) == (h2["first_token"], h2["nblocks"])
    assert _decode(_port(weights), {"d": h2}, PSampling(**GREEDY))["d"] == unified[0]


def test_handoff_with_spec_decode_on_the_decode_engine(weights, unified):
    """A handoff-admitted request speculates on the decode engine (its
    draft prefilled locally from the shipped prompt) with the unified
    engine's greedy stream."""
    draft = dataclasses.replace(pgpt2.GPT2Config.tiny(n_layer=1, d_model=32, n_head=2, vocab_size=512,
                                                      max_seq=256), dtype=torch.float32)
    A = _port(weights)
    B = _port(weights, spec_decode_tokens=3, draft_model_config=draft)
    h = _handoff(A, PROMPT, PSampling(**GREEDY))
    assert _decode(B, {"d": h}, PSampling(**GREEDY))["d"] == unified[0]
    assert B.stats["spec_steps"] >= 1
    assert B.stats["prefill_tokens"] == 0


def test_dense_decode_engine_reprefills(weights, unified):
    A, D = _port(weights), _port(weights, kv_block_size=0)
    h = _handoff(A, PROMPT, PSampling(**GREEDY))
    assert _decode(D, {"d": h}, PSampling(**GREEDY))["d"] == unified[0]
    assert D.stats["prefill_tokens"] == len(PROMPT)
    assert D.stats["handoffs_in"] == 0 and D.stats["kv_fallbacks"] == 0


def test_prefill_only_on_a_dense_engine_raises(weights):
    with pytest.raises(ValueError, match="paged KV cache"):
        _port(weights, kv_block_size=0).add_request("p", PROMPT, PSampling(), prefill_only=True)


# -- seeded kvship chaos --------------------------------------------------------


def _severed_run(weights, seed):
    A, B = _port(weights), _port(weights, prefill_chunk_tokens=32)
    h = _handoff(A, PROMPT, PSampling(**GREEDY))
    pfaults.install(pfaults.parse_spec(seed, "kvship.sever"))
    try:
        got = _decode(B, {"d": h}, PSampling(**GREEDY))["d"]
    finally:
        pfaults.clear()
    return got, dict(B.stats)


def test_sever_falls_back_to_local_chunked_prefill(weights, unified):
    """A severed pull: local chunked prefill, the same tokens, the fallback
    counted; the seeded run replays bit-identically."""
    got, stats = _severed_run(weights, 7)
    assert got == unified[0]
    assert stats["kv_fallbacks"] == 1 and stats["handoffs_in"] == 0
    assert stats["prefill_chunks"] >= 2 and stats["prefill_tokens"] == len(PROMPT)
    assert _severed_run(weights, 7) == (got, stats)


def _verdicts(engine) -> list:
    """Record each handoff admission's verdict, in order."""
    out = []
    admit = engine._admit_handoff

    def recording(req, slot):
        verdict = admit(req, slot)
        out.append((req.request_id, verdict))
        return verdict

    engine._admit_handoff = recording
    return out


def test_probabilistic_sever_takes_the_jax_engines_decisions(weights):
    """``kvship.sever,p=0.5`` at seed 21 over four handoffs: the port's
    decode engine falls back on the same requests as the JAX engine's, in
    the same order, and both give the unified streams."""
    prompts = [list(range(2, 40 + 8 * i)) for i in range(4)]
    spec = "kvship.sever,p=0.5"
    want = [o["token_ids"] for o in _port(weights).generate(prompts, PSampling(**GREEDY))]

    def run(new, sampling, faults):
        A, B = new(weights), new(weights, prefill_chunk_tokens=32)
        hs = {f"d{i}": _handoff(A, p, sampling(**GREEDY), rid=f"p{i}") for i, p in enumerate(prompts)}
        verdicts = _verdicts(B)
        faults.install(faults.parse_spec(21, spec))
        try:
            done = _decode(B, hs, sampling(**GREEDY))
        finally:
            faults.clear()
        return [done[f"d{i}"] for i in range(4)], verdicts, (B.stats["kv_fallbacks"],
                                                             B.stats["handoffs_in"])

    port = run(_port, PSampling, pfaults)
    jax_ = run(_jax, JSampling, jfaults)
    assert port[0] == jax_[0] == want
    assert port[1] == jax_[1] and port[2] == jax_[2]
    assert 0 < port[2][0] < 4  # p=0.5 mixed both outcomes
    assert run(_port, PSampling, pfaults)[1:] == port[1:]  # the seeded replay


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_pulled_stack_equals_the_jax_engines_gather(weights, family):
    """The stack the port ships for a prompt equals the one the JAX engine
    ships (its ``_gather_blocks`` of the same prompt, pulled through its
    fabric) within 1e-5 over the request's blocks; same shape and first
    token."""
    s = dict(max_tokens=4)
    ph = _handoff(_port(weights, family), PROMPT, PSampling(**s))
    jh = _handoff(_jax(weights, family), PROMPT, JSampling(**s))
    assert ph["first_token"] == jh["first_token"] and ph["nblocks"] == jh["nblocks"]
    got = pdisagg.pull_kv(ph, "p").numpy()
    want = np.asarray(jdisagg.pull_kv(jh, "p"))
    assert got.shape == want.shape == tuple(ph["kv"]["shape"])
    nb = ph["nblocks"]
    np.testing.assert_allclose(got[:, :, :nb], want[:, :, :nb], rtol=0, atol=1e-5)


# -- the fault injector -----------------------------------------------------------


FAULT_SPECS = [
    (21, "kvship.sever,p=0.5"),
    (7, "kvship.sever"),
    (3, "kvship.delay,p=0.3,ms=5,match=d1*;kvship.sever,p=0.4,after=2,count=3"),
    (11, "send.drop,p=0.2,peer=10.*;recv.dup,p=0.5;kvship.sever,p=0.25,count=2"),
]


@pytest.mark.parametrize("seed, spec", FAULT_SPECS)
def test_fault_injector_decides_as_the_references(seed, spec):
    """The same seed and spec take the same decisions, call for call, over
    one sequence of decision points, with the same rule state after."""
    names = [f"d{i % 13}" for i in range(300)]
    sites = ["kvship", "send", "recv", "kvship"]
    pin, jin = pfaults.parse_spec(seed, spec), jfaults.parse_spec(seed, spec)
    for i, name in enumerate(names):
        site = sites[i % len(sites)]
        peer = "10.0.0.1:5" if i % 3 else "127.0.0.1:5"
        p = pin.decide(site, name, peer=peer)
        j = jin.decide(site, name, peer=peer)
        assert (p is None) == (j is None), i
        if p is not None:
            assert (p.site, p.action, p.delay_s, p.fired) == (j.site, j.action, j.delay_s, j.fired), i
    assert pin.stats() == jin.stats()
    assert pfaults.parse_env(f"{seed}:{spec}").stats() == jfaults.parse_env(f"{seed}:{spec}").stats()


@pytest.mark.parametrize("bad", ["kvship.explode", "nosuch.sever", "kvship.sever,p", "kvship.sever,x=1"])
def test_fault_specs_the_reference_refuses_raise(bad):
    with pytest.raises(ValueError) as want:
        jfaults.parse_spec(1, bad)
    with pytest.raises(ValueError) as got:
        pfaults.parse_spec(1, bad)
    assert str(got.value) == str(want.value)


def test_fault_config_parses_as_the_references(monkeypatch):
    monkeypatch.setenv("RAY_TPU_FAULTS", "5:kvship.sever,p=0.5")
    monkeypatch.setenv("RAY_TPU_XFER_ARMED_CAP", "3")
    p, j = pload_config(), jload_config()
    assert (p.faults, p.xfer_armed_cap) == (j.faults, j.xfer_armed_cap) == ("5:kvship.sever,p=0.5", 3)


def test_injected_sever_raises_peer_unavailable():
    pfaults.install(pfaults.parse_spec(1, "kvship.sever,match=x*"))
    try:
        with pytest.raises(PeerUnavailableError) as e:
            pdisagg.pull_kv({"kv": None}, "x1")
        assert isinstance(e.value, ConnectionError)
    finally:
        pfaults.clear()


# -- the socket transfer fabric ---------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_socket_fabric_arms_and_pulls(dtype):
    """An armed tensor is pulled once, bit for bit, with its dtype on the
    wire; a second pull raises; release_uuid returns the entry."""
    fab = ptransfer.fabric()
    x = torch.randn(2, 3, 5, generator=torch.Generator().manual_seed(0)).to(dtype)
    desc = fab.arm("obj", x, (1, 1, 1))
    assert desc["dtype"] == str(dtype).removeprefix("torch.") and desc["shape"] == (2, 3, 5)
    got = fab.pull(desc)
    assert got.dtype == dtype and torch.equal(got, x)
    with pytest.raises(KeyError, match="not armed"):
        fab.pull(desc)
    oid, staged = fab.release_uuid(desc["uuid"])
    assert oid == "obj" and torch.equal(staged, x)
    assert fab.release_uuid(desc["uuid"]) is None
    assert ptransfer.transfer_stats()["transport"] == "socket"
    with pytest.raises(ValueError, match="partitions"):
        fab.arm(None, x, (1, 1))


def test_fabric_evicts_old_entries_past_the_cap_and_refunds_them():
    """Past the cap, an entry older than the TTL is evicted, unserved and
    refunded to the store's hook; a released entry is unserved too."""
    fab = ptransfer._Fabric()
    fab._armed_cap, fab.ARMED_TTL_S = 1, 0.0
    refunded = []
    fab.refund = lambda oid, t: refunded.append((oid, t.clone()))
    a, b = torch.arange(4.0), torch.arange(6.0)
    da = fab.arm("a", a, (1,))
    db = fab.arm(None, b, (1,))
    assert [o for o, _ in refunded] == ["a"] and torch.equal(refunded[0][1], a)
    assert fab.stats()["armed"] == 1
    with pytest.raises(KeyError):
        fab.pull(da)
    fab.release_uuid(db["uuid"])
    with pytest.raises(KeyError):
        fab.pull(db)
    assert fab.stats() == {"arms": 2, "pulls": 0, "fallbacks": 0, "armed": 0, "transport": "socket"}


def test_local_ip_and_free_port(monkeypatch):
    """The fabric's address: RAY_TPU_HOST_IP where set, else loopback (the
    port never probes the network); free_port gives a port that binds."""
    import socket

    from ray_tpu_torch.util import net

    monkeypatch.setenv("RAY_TPU_HOST_IP", "10.1.2.3")
    assert net.local_ip() == "10.1.2.3"
    monkeypatch.delenv("RAY_TPU_HOST_IP")
    assert net.local_ip() == "127.0.0.1"
    with socket.socket() as s:
        s.bind(("127.0.0.1", net.free_port()))
