"""The port's OpenAI-style serving (``LLMServer`` / ``build_openai_app`` on
``ray_tpu_torch.serve``) against the JAX package's, on the CPU.

A tiny f32 GPT-2 is drawn with JAX's ``init_params`` and pickled as numpy;
the JAX ``LLMEngine``, the JAX serve tier and the port's deployment
(``device="cpu"``) all load it through ``weights_path``. One module runtime
of the port (``init(num_cpus=8)``) serves every case here; the reference's
``test_openai_serving_e2e`` scenario (``tests/test_llm.py:186``) runs once
under the JAX serve tier in its own runtime, in a thread started with the
module, and the port's HTTP bodies must equal its bodies apart from
``created``. Token ids are held bit-equal to the JAX engine's greedy
streams: a response's text and completion count against the engine's
ids, an SSE stream's pieces one per id, and the ids themselves through the
deployment's ``_generate`` on a driver handle.

Then the disaggregated counterparts of ``tests/test_llm_disagg.py:255-468``
(a one-prefill + one-decode deployment answers as a unified one, one
handoff counted per handle request, the roles in the routing table, no
prefill on the decode replica, the one-flag kill switch, the decode tier
surviving the prefill replica's death) and prefix-affinity convergence
(``tests/test_serve_llm_routing.py:341``). Every call has a timeout.
"""

import dataclasses
import json
import pickle
import socket
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import wait_for_condition
from ray_tpu.llm.config import LLMConfig as JLLMConfig
from ray_tpu.llm.config import SamplingParams as JSampling
from ray_tpu.llm.engine import LLMEngine as JEngine
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.llm.config import LLMConfig as PLLMConfig
from ray_tpu_torch.llm.config import SamplingParams as PSampling
from ray_tpu_torch.llm.tokenizer import ByteTokenizer
from ray_tpu_torch.models import gpt2 as pgpt2
from ray_tpu_torch.util.prefix_digest import chat_prompt

pytestmark = pytest.mark.timeout(170)

SHAPE = dict(n_layer=2, d_model=64, n_head=2, vocab_size=512, max_seq=256)
SERVE = dict(max_slots=4, max_seq=256, prefill_buckets=(32, 128), prefix_chunk=16,
             max_prefix_cache_tokens=512, seed=5)
TIMEOUT = 120
CHAT = [{"role": "system", "content": "be brief"}, {"role": "user", "content": "hey there"}]
# The reference's e2e scenario (tests/test_llm.py:186-222), plus a streamed
# completion and a streamed chat.
REQUESTS = {
    "completions": ("/llm/v1/completions", {"prompt": "hi there, how are you", "max_tokens": 6}),
    "chat": ("/llm/v1/chat/completions", {"messages": CHAT, "max_tokens": 6}),
    "max_tokens_1": ("/llm/v1/completions", {"prompt": "x", "max_tokens": 1}),
    "stream_completions": ("/llm/v1/completions",
                           {"prompt": "stream me a reply", "max_tokens": 6, "stream": True}),
    "stream_chat": ("/llm/v1/chat/completions", {"messages": CHAT, "max_tokens": 6, "stream": True}),
}


def _post(port: int, path: str, body: dict, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})}, method="POST")
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def _sse(port: int, path: str, body: dict) -> list:
    """Raw HTTP POST reading the SSE events until ``[DONE]``."""
    payload = json.dumps(body).encode()
    with socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT) as sock:
        sock.sendall(f"POST {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                     f"Content-Type: application/json\r\nContent-Length: {len(payload)}\r\n"
                     f"Connection: close\r\n\r\n".encode() + payload)
        buf = b""
        while True:
            data = sock.recv(65536)
            if not data:
                break
            buf += data
    head, _, rest = buf.partition(b"\r\n\r\n")
    assert b"200 OK" in head.splitlines()[0] and b"text/event-stream" in head, head
    events = [e.decode().strip() for e in rest.split(b"\n\n") if e.strip()]
    assert events[-1] == "data: [DONE]", events[-3:]
    return [json.loads(e[len("data: "):]) for e in events[:-1]]


def _ask(port: int, name: str) -> object:
    path, body = REQUESTS[name]
    return _sse(port, path, body) if body.get("stream") else _post(port, path, body)


def _without_created(body):
    if isinstance(body, list):
        return [_without_created(b) for b in body]
    return {k: v for k, v in body.items() if k != "created"}


def _reference_run(config, out: dict) -> None:
    """The reference's e2e scenario under the JAX serve tier, in a runtime
    of its own; the bodies land in ``out``."""
    try:
        import ray_tpu
        from ray_tpu.llm.serve_llm import build_openai_app
        from ray_tpu.serve import api as serve_api

        ray_tpu.init(num_cpus=4)
        try:
            serve_api.run(build_openai_app(config, name="llm"))
            port = serve_api.proxy_port()
            out["bodies"] = {name: _ask(port, name) for name in REQUESTS}
        finally:
            try:
                serve_api.shutdown()
            finally:
                ray_tpu.shutdown()
    except BaseException as e:  # noqa: BLE001 - the test reports it
        out["error"] = e


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    jcfg = dataclasses.replace(jgpt2.GPT2Config.tiny(**SHAPE), dtype=jnp.float32,
                               attn_impl="reference")
    pcfg = dataclasses.replace(pgpt2.GPT2Config.tiny(**SHAPE), dtype=torch.float32)
    path = tmp_path_factory.mktemp("weights") / "gpt2_tiny.pkl"
    with open(path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, jgpt2.init_params(jax.random.key(11), jcfg)), f)
    return jcfg, pcfg, str(path)


def _jconfig(weights, **kw):
    return JLLMConfig(model_config=weights[0], weights_path=weights[2], **{**SERVE, **kw})


def _pconfig(weights, **kw):
    return PLLMConfig(model_config=weights[1], weights_path=weights[2], **{**SERVE, **kw})


@pytest.fixture(scope="module")
def env():
    mp = pytest.MonkeyPatch()
    # The reference's local_ip() would otherwise look for an egress
    # interface; every process here lives on this host.
    mp.setenv("RAY_TPU_HOST_IP", "127.0.0.1")
    yield
    mp.undo()


@pytest.fixture(scope="module")
def reference(env, weights):
    """The JAX serve tier's bodies, from a thread started with the module
    (its runtime and the port's run at once)."""
    out = {}
    th = threading.Thread(target=_reference_run, args=(_jconfig(weights), out), daemon=True)
    th.start()
    return th, out


@pytest.fixture(scope="module")
def cluster(env, reference, weights):
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import build_openai_app

    runtime = ray_tpu_torch.init(num_cpus=8)
    try:
        serve.run(build_openai_app(_pconfig(weights), name="llm", device="cpu"))
        yield runtime
    finally:
        try:
            serve.shutdown()
        finally:
            ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def jax_engine_ids(weights):
    """The JAX engine's greedy ids for a prompt, one fresh engine a call
    (the pool state of a deployment's replica is not the question here)."""
    cache = {}

    def ids(prompt, max_tokens):
        key = (json.dumps(prompt), max_tokens)
        if key not in cache:
            eng = JEngine(_jconfig(weights))
            cache[key] = eng.generate([prompt], JSampling(max_tokens=max_tokens))[0]["token_ids"]
        return cache[key]

    return ids


@pytest.fixture(scope="module")
def port_bodies(cluster):
    from ray_tpu_torch.serve import api as serve_api

    port = serve_api.proxy_port()
    return {name: _ask(port, name) for name in REQUESTS}


@pytest.mark.parametrize("name", list(REQUESTS))
def test_openai_bodies_equal_the_reference_serve_tier(name, reference, port_bodies,
                                                      jax_engine_ids):
    th, out = reference
    th.join(timeout=150)
    assert not th.is_alive(), "the JAX serve run did not finish"
    assert "error" not in out, out.get("error")
    got, want = port_bodies[name], out["bodies"][name]
    assert _without_created(got) == _without_created(want)

    path, body = REQUESTS[name]
    prompt = chat_prompt(body["messages"]) if "messages" in body else body["prompt"]
    ids = jax_engine_ids(prompt, body["max_tokens"])
    tok = ByteTokenizer()
    text_ids = [t for t in ids if t != tok.eos_id]
    if body.get("stream"):
        *pieces, tail = got
        key = "delta" if "messages" in body else "text"
        assert [c["choices"][0][key]["content"] if key == "delta" else c["choices"][0]["text"]
                for c in pieces] == [tok.decode([t]) for t in text_ids]
        assert tail["choices"][0]["finish_reason"] == "stop"
        assert tail["usage"]["completion_tokens"] == len(text_ids)
    else:
        choice = got["choices"][0]
        text = choice["message"]["content"] if "messages" in body else choice["text"]
        assert text == tok.decode(text_ids)
        assert got["usage"]["completion_tokens"] == len(ids)
    if name == "max_tokens_1":  # finished at admission: must still resolve
        assert got["usage"]["completion_tokens"] == 1


def test_generate_ids_bit_equal_to_jax_engine(cluster, weights):
    """Concurrent requests through a driver handle batch onto the
    replica's shared steps (6 requests, 4 slots, a shared 32-token prefix);
    each stream's ids equal the JAX engine's greedy ids."""
    from ray_tpu_torch import serve

    rng = np.random.default_rng(3)
    ids = lambda n: rng.integers(0, 256, n).tolist()  # noqa: E731
    prefix = ids(32)
    prompts = [ids(10), prefix + ids(8), prefix + ids(20), ids(100), ids(45), "plain text prompt"]
    h = serve.get_handle("llm").method("_generate")
    futs = [h.remote(p, PSampling(max_tokens=8)) for p in prompts]
    got = [f.result(timeout=TIMEOUT)["token_ids"] for f in futs]
    want = [r["token_ids"] for r in JEngine(_jconfig(weights)).generate(prompts, JSampling(max_tokens=8))]
    assert got == want


# -- disaggregated serving ---------------------------------------------------------


def _counter(name, deployment):
    from ray_tpu_torch.util.metrics import registry

    return sum(v for n, tags, v in registry().snapshot()["points"]
               if n == name and tags.get("deployment") == deployment)


def _routing(name):
    import ray_tpu_torch

    ctrl = ray_tpu_torch.get_actor("serve::controller")
    return ray_tpu_torch.get(ctrl.get_routing.remote(name, -1), timeout=30)


def _router_state(name):
    import ray_tpu_torch

    ctrl = ray_tpu_torch.get_actor("serve::controller")
    return ray_tpu_torch.get(ctrl.get_router_state.remote(name), timeout=30)


def _completion(handle, name, prompt, max_tokens=8, stream=False):
    req = {"path": f"/{name}/v1/completions",
           "body": {"prompt": prompt, "max_tokens": max_tokens, "stream": stream}}
    if stream:
        return list(handle.options(stream=True).remote(req))
    return handle.remote(req).result(timeout=TIMEOUT)


@pytest.fixture(scope="module")
def disagg(cluster, weights):
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import build_openai_app

    d = serve.run(build_openai_app(_pconfig(weights), name="dxllm", num_replicas=1,
                                   prefill_replicas=1, device="cpu"))
    u = serve.run(build_openai_app(_pconfig(weights), name="uxllm", device="cpu"))
    yield d, u
    serve.delete("dxllm")
    serve.delete("uxllm")


def test_disagg_two_hop_equals_unified(disagg):
    """Buffered and streamed, through a driver handle and the proxy: the
    one-prefill + one-decode deployment answers as the unified one, with
    one handoff counted per handle request, the roles in the table and no
    prefill on the decode replica."""
    from ray_tpu_torch.serve import api as serve_api

    d, u = disagg
    prompts = ["SYSTEM: disagg e2e. Q: alpha", "short", "a much longer prompt " * 6]
    h0 = _counter("raytpu_serve_disagg_handoffs_total", "dxllm")
    for i, p in enumerate(prompts):
        out_d, out_u = _completion(d, "dxllm", p), _completion(u, "uxllm", p)
        assert _without_created(out_d) == _without_created(out_u), (p, out_d, out_u)
        assert _counter("raytpu_serve_disagg_handoffs_total", "dxllm") == h0 + i + 1
    streamed = _completion(d, "dxllm", prompts[0], stream=True)
    unified = _completion(u, "uxllm", prompts[0], stream=True)
    assert _without_created(streamed) == _without_created(unified)
    assert _counter("raytpu_serve_disagg_handoffs_total", "dxllm") == h0 + len(prompts) + 1
    # Through the proxy: the proxy's router runs the two-hop.
    port = serve_api.proxy_port()
    body = {"prompt": prompts[1], "max_tokens": 8}
    assert _without_created(_post(port, "/dxllm/v1/completions", body)) == _without_created(
        _post(port, "/uxllm/v1/completions", body))

    table = _routing("dxllm")
    roles = table["disagg"]["roles"]
    assert sorted(roles.values()) == ["decode", "prefill"]
    decode_rid = next(r for r, role in roles.items() if role == "decode")
    prefill_rid = next(r for r, role in roles.items() if role == "prefill")

    t_done = time.monotonic()

    def pushed():  # both replicas pushed their state after the traffic ended
        st = _router_state("dxllm")
        now = time.monotonic()
        fresh = all(r in st and now - st[r]["age_s"] > t_done and st[r]["state"] for r in roles)
        return st if fresh else None

    st = wait_for_condition(pushed, timeout=20, interval=0.3)
    assert st[decode_rid]["state"]["prefill_tokens"] == 0  # the decode tier never prefilled
    assert st[prefill_rid]["state"]["prefill_tokens"] > 0


def test_disagg_kill_switch_one_flag_flip(disagg):
    d, _ = disagg
    _completion(d, "dxllm", "kill switch 0", 4)
    on0 = _counter("raytpu_serve_disagg_handoffs_total", "dxllm")
    old = GLOBAL_CONFIG.disagg
    GLOBAL_CONFIG.disagg = False
    try:
        assert _completion(d, "dxllm", "kill switch 1", 4)["object"] == "text_completion"
        assert _counter("raytpu_serve_disagg_handoffs_total", "dxllm") == on0
    finally:
        GLOBAL_CONFIG.disagg = old
    _completion(d, "dxllm", "kill switch 2", 4)
    assert _counter("raytpu_serve_disagg_handoffs_total", "dxllm") == on0 + 1


def test_disagg_decode_tier_survives_prefill_death(cluster, weights):
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import build_openai_app

    h = serve.run(build_openai_app(_pconfig(weights), name="dfllm", num_replicas=1,
                                   prefill_replicas=1, device="cpu"))
    try:
        assert _completion(h, "dfllm", "failover 0", 4)["object"] == "text_completion"
        table = _routing("dfllm")
        prefill_rid = next(r for r, role in table["disagg"]["roles"].items() if role == "prefill")
        ray_tpu_torch.kill(next(r for r in table["replicas"] if r._actor_id == prefill_rid))
        for i in range(1, 6):  # during and after the replacement window
            assert _completion(h, "dfllm", f"failover {i}", 4)["object"] == "text_completion"
            time.sleep(0.3)

        def healed():
            roles = (_routing("dfllm").get("disagg") or {}).get("roles") or {}
            return sorted(roles.values()) == ["decode", "prefill"] and prefill_rid not in roles

        wait_for_condition(healed, timeout=60, interval=0.5)
        assert _completion(h, "dfllm", "failover 9", 4)["object"] == "text_completion"
    finally:
        serve.delete("dfllm")


# -- prefix-affinity routing ---------------------------------------------------------


def test_shared_prefix_requests_converge(cluster, weights):
    """Shared-prefix traffic converges on ONE replica: after the first
    request pools the prefix and the advertisement propagates, follow-ups
    route to that replica (the route-hit counter rises) and the other
    replica pays no prefill for them."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import build_openai_app

    h = serve.run(build_openai_app(_pconfig(weights, prefill_chunk_tokens=32), name="pxllm",
                                   num_replicas=2, device="cpu"))
    try:
        shared = "SYSTEM: you are a helpful assistant, be brief. Q: "
        ask = lambda suffix: _completion(h, "pxllm", shared + suffix, 3)  # noqa: E731
        assert ask("warmup")["object"] == "text_completion"
        wait_for_condition(lambda: any((i.get("state") or {}).get("digests")
                                       for i in _router_state("pxllm").values()),
                           timeout=30, interval=0.5)
        time.sleep(GLOBAL_CONFIG.prefix_route_staleness_s + 0.5)
        hits0 = _counter("raytpu_serve_prefix_route_hits_total", "pxllm")

        def routed_hit():
            ask("probe")
            return _counter("raytpu_serve_prefix_route_hits_total", "pxllm") > hits0

        wait_for_condition(routed_hit, timeout=30, interval=0.2)
        hits1 = _counter("raytpu_serve_prefix_route_hits_total", "pxllm")

        def prefill_map(since):
            """Each replica's prefill tokens, once both pushed their state
            after ``since`` (a push can be a 5 s heartbeat late)."""
            st, now = _router_state("pxllm"), time.monotonic()
            if len(st) != 2 or any(now - i["age_s"] <= since for i in st.values()):
                return None
            return {rid: (i.get("state") or {}).get("prefill_tokens", 0) for rid, i in st.items()}

        t0 = time.monotonic()
        split0 = wait_for_condition(lambda: prefill_map(t0), timeout=30, interval=0.3)
        for i in range(4):
            ask(f"question {i}")
        assert _counter("raytpu_serve_prefix_route_hits_total", "pxllm") >= hits1 + 4
        t1 = time.monotonic()
        cur = wait_for_condition(lambda: prefill_map(t1), timeout=30, interval=0.3)
        deltas = [cur[r] - split0.get(r, 0) for r in cur]
        pos = [x for x in deltas if x > 0]
        # One replica paid (suffix-only: far below 4 full prompts of ~64
        # tokens each), the other paid nothing.
        assert len(pos) == 1 and 0 < pos[0] <= 4 * 32 and min(deltas) == 0, deltas
    finally:
        serve.delete("pxllm")


def test_replica_asked_for_the_card_fails_its_health_check(cluster, weights):
    """Without a card, a replica asked for one raises in its constructor:
    the deployment never becomes healthy (no fallback to the CPU)."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import build_openai_app

    if torch.cuda.is_available():
        pytest.skip("checks the card-less refusal")
    with pytest.raises(RuntimeError, match="did not become healthy"):
        serve.run(build_openai_app(_pconfig(weights), name="nocard"), wait_timeout_s=4.0)
    serve.delete("nocard")
