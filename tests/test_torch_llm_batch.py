"""Batch inference as a data stage on both packages: ``build_llm_processor``
run through ``Dataset.map_batches`` (``tests/test_llm.py:173``'s tiny f32
GPT-2, three prompts, four greedy tokens each) under ``ray_tpu.data`` and
under ``ray_tpu_torch.data``, each against its own runtime. Both load the
SAME pickled numpy params through ``weights_path``, so the generated texts
must be equal; the port's must also equal its processor called in this
process.

The port's stage claims the ``GPU`` resource (``map_batches(...,
resources={"GPU": 1})``), as it does on the card; here the runtime
advertises one stand-in unit and the engine runs on the CPU
(``device="cpu"``), so the resource accounting runs and the two blocks'
tasks take the unit in turn. The two sessions run at once, one thread
each.
"""

import dataclasses
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

PROMPTS = ["one", "two", "three"]
SHAPE = dict(vocab_size=512, max_seq=128)
SERVE = dict(max_slots=2, max_seq=64, prefill_buckets=(16,), seed=1)

pytestmark = pytest.mark.timeout(300)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    from ray_tpu.models import gpt2 as jgpt2
    from ray_tpu_torch.models import gpt2 as pgpt2

    jcfg = dataclasses.replace(jgpt2.GPT2Config.tiny(**SHAPE), dtype=jnp.float32,
                               attn_impl="reference")
    pcfg = dataclasses.replace(pgpt2.GPT2Config.tiny(**SHAPE), dtype=torch.float32)
    path = tmp_path_factory.mktemp("weights") / "gpt2_tiny.pkl"
    with open(path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, jgpt2.init_params(jax.random.key(21), jcfg)), f)
    return jcfg, pcfg, str(path)


def _jax_session(jcfg, path):
    import ray_tpu
    import ray_tpu.data as rd
    from ray_tpu.llm.batch import build_llm_processor
    from ray_tpu.llm.config import LLMConfig, SamplingParams

    ray_tpu.init(num_cpus=4)
    try:
        proc = build_llm_processor(LLMConfig(model_config=jcfg, weights_path=path, **SERVE),
                                   sampling=SamplingParams(max_tokens=4))
        ds = rd.from_items([{"prompt": p} for p in PROMPTS], parallelism=2)
        return ds.map_batches(proc).take_all()
    finally:
        ray_tpu.shutdown()


def _port_session(pcfg, path):
    import ray_tpu_torch
    import ray_tpu_torch.data as rd
    from ray_tpu_torch.llm.batch import build_llm_processor
    from ray_tpu_torch.llm.config import LLMConfig, SamplingParams

    ray_tpu_torch.init(num_cpus=4, resources={"GPU": 1})
    try:
        proc = build_llm_processor(LLMConfig(model_config=pcfg, weights_path=path, **SERVE),
                                   sampling=SamplingParams(max_tokens=4), device="cpu")
        ds = rd.from_items([{"prompt": p} for p in PROMPTS], parallelism=2)
        staged = ds.map_batches(proc, resources={"GPU": 1})
        rows = staged.take_all()
        blocks = staged.num_blocks()
        local = proc({"prompt": list(PROMPTS)})
        return {"rows": rows, "blocks": blocks, "local": local}
    finally:
        ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def results(weights):
    mp = pytest.MonkeyPatch()
    # The reference's local_ip() would otherwise look for an egress
    # interface; every process of these clusters lives on this host.
    mp.setenv("RAY_TPU_HOST_IP", "127.0.0.1")
    jcfg, pcfg, path = weights
    out = {}

    def run(name, fn, *args):
        try:
            out[name] = fn(*args)
        except Exception as e:  # noqa: BLE001 - reported by the tests
            out[name] = {"raised": f"{type(e).__name__}: {e}"}

    threads = [threading.Thread(target=run, args=("ray_tpu", _jax_session, jcfg, path)),
               threading.Thread(target=run, args=("ray_tpu_torch", _port_session, pcfg, path))]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(240)
        assert not any(th.is_alive() for th in threads), "a batch session did not finish"
        yield out
    finally:
        mp.undo()


def test_map_batches_llm_processor_texts_equal_the_jax_stage(results):
    ref, port = results["ray_tpu"], results["ray_tpu_torch"]
    assert isinstance(ref, list), ref
    assert "raised" not in port, port
    assert [r["prompt"] for r in port["rows"]] == [r["prompt"] for r in ref] == PROMPTS
    texts = [r["generated_text"] for r in port["rows"]]
    assert texts == [r["generated_text"] for r in ref]
    assert all(isinstance(t, str) for t in texts)


def test_the_stage_equals_the_processor_called_in_process(results):
    port = results["ray_tpu_torch"]
    assert "raised" not in port, port
    assert port["blocks"] == 2
    assert port["local"]["generated_text"] == [r["generated_text"] for r in port["rows"]]
