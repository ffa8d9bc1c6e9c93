"""Unit parity of the core runtime's pure parts, no processes: the same
seeded inputs through ``ray_tpu``'s modules and their ports in
``ray_tpu_torch``, at exact equality.

- ``ids``: the same hex gives the same hex, length and equality;
- ``protocol``: the same message encodes to the same wire segments, and
  each package decodes the other's;
- ``serialization``: the same nested numpy value gives the same pickle
  header and out-of-band segments, and each package loads the other's;
- ``scheduler.fits`` / ``labels_match`` / ``pick_node`` and the
  ``FeasibilityIndex``'s choice, on many seeded node tables and demands.

Then the port's own pieces that need no cluster: tensors through
``serialization`` (bf16 included, the large one out-of-band), the GPU
resource count under ``CUDA_VISIBLE_DEVICES``, and the config table's
``RAY_TPU_<NAME>`` parsing.
"""

import random

import numpy as np
import pytest
import torch

from ray_tpu.core import ids as ref_ids
from ray_tpu.core import protocol as ref_protocol
from ray_tpu.core import sched_index as ref_sched_index
from ray_tpu.core import scheduler as ref_scheduler
from ray_tpu.core import serialization as ref_ser
from ray_tpu_torch.accelerators import gpu
from ray_tpu_torch.core import ids as port_ids
from ray_tpu_torch.core import protocol as port_protocol
from ray_tpu_torch.core import sched_index as port_sched_index
from ray_tpu_torch.core import scheduler as port_scheduler
from ray_tpu_torch.core import serialization as port_ser
from ray_tpu_torch.core.config import Config

ID_CLASSES = ("ObjectID", "TaskID", "ActorID", "NodeID", "WorkerID", "PlacementGroupID", "JobID")


@pytest.mark.parametrize("cls", ID_CLASSES)
def test_ids_same_hex_same_id(cls):
    rng = random.Random(cls)
    for _ in range(50):
        raw = rng.getrandbits(128).to_bytes(16, "big").hex()
        a = getattr(ref_ids, cls).from_hex(raw)
        b = getattr(port_ids, cls).from_hex(raw)
        assert a.hex() == b.hex() == raw
        assert len(b.hex()) == len(a.hex()) == 32
        assert b == getattr(port_ids, cls).from_hex(raw)
    assert len(getattr(port_ids, cls).random().hex()) == len(getattr(ref_ids, cls).random().hex())


def _messages():
    rng = np.random.default_rng(3)
    return [
        ("gcs.get_cluster_view", 1, None, {}),
        ("node.request_lease", 7, None, {"resources": {"CPU": 1.0}, "labels": {"zone": "b"}, "ids": [1, 2, 3]}),
        ("$reply", 8, 7, {"granted": True, "addr": ("127.0.0.1", 4242), "blob": bytes(range(200))}),
        ("worker.push_task", 9, None, {"args": [rng.standard_normal((64, 64)), "x" * 10]}),  # out-of-band
        ("$reply", 10, 9, {"value": rng.integers(0, 255, 100_000, dtype=np.uint8), "small": np.arange(4)}),
    ]


def _encode(protocol, msg):
    return protocol.Connection._encode_frame(None, *msg)


def _decode(protocol, segments):
    return protocol.Connection._decode_body(bytearray(b"".join(bytes(s) for s in segments)[4:]))


def _same(a, b):
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_same, a, b))
    return a == b


@pytest.mark.parametrize("scatter_gather", [True, False])
def test_protocol_frames_encode_alike_and_cross_decode(scatter_gather, monkeypatch):
    from ray_tpu.core.config import GLOBAL_CONFIG as ref_cfg
    from ray_tpu_torch.core.config import GLOBAL_CONFIG as port_cfg

    monkeypatch.setattr(ref_cfg, "rpc_scatter_gather_enabled", scatter_gather)
    monkeypatch.setattr(port_cfg, "rpc_scatter_gather_enabled", scatter_gather)
    n_oob = 0
    for msg in _messages():
        ref, port = _encode(ref_protocol, msg), _encode(port_protocol, msg)
        assert [bytes(s) for s in port] == [bytes(s) for s in ref], msg[0]
        n_oob += len(port) - 1
        assert _same(_decode(port_protocol, ref), msg)
        assert _same(_decode(ref_protocol, port), msg)
    assert n_oob == (2 if scatter_gather else 0)


def _nested_values():
    rng = np.random.default_rng(11)
    return [
        {"w": rng.standard_normal((256, 64)).astype(np.float32), "meta": {"step": 3, "names": ["a", "b"]}},
        [rng.integers(-5, 5, (1000,)), (rng.standard_normal(2048), "tail"), np.zeros(3)],
        {"k": [{"deep": rng.standard_normal((32, 32, 8)).astype(np.float16)}]},
    ]


def test_serialization_same_out_of_band_segments():
    for value in _nested_values():
        ref, ref_refs = ref_ser.dumps_oob(value)
        port, port_refs = port_ser.dumps_oob(value)
        assert ref_refs == port_refs == []
        assert type(port).__name__ == type(ref).__name__ == "FramedPayload"
        assert port.header == ref.header
        assert [bytes(b) for b in port.buffers] == [bytes(b) for b in ref.buffers]
        assert port.nbytes == ref.nbytes
        assert port.to_bytes() == ref.to_bytes()
        assert _same(port_ser.loads(ref.to_bytes())[0], value)
        assert _same(ref_ser.loads(port.to_bytes())[0], value)


def test_serialization_tensors_keep_dtype_shape_and_bits():
    g = torch.Generator().manual_seed(5)
    big = torch.randn(1024, 1024, generator=g).to(torch.bfloat16)  # 2 MB
    cases = [
        big,
        torch.randn(3, 5, generator=g),
        torch.randn(8, 6, generator=g).t()[1:5],  # non-contiguous
        torch.tensor(7, dtype=torch.int64),
        torch.zeros(0, 4, dtype=torch.bfloat16),
        torch.tensor([True, False, True]),
        torch.nn.Parameter(torch.randn(4, 4, generator=g)),
    ]
    payload, _ = port_ser.dumps_oob({"tensors": cases})
    # Only the large tensor's bytes go out-of-band, as one uint8 segment.
    assert [b.nbytes for b in payload.buffers] == [big.numel() * 2]
    out = port_ser.loads(payload.to_bytes())[0]["tensors"]
    for want, got in zip(cases, out):
        assert type(got) is type(want) and got.dtype == want.dtype and got.shape == want.shape
        assert got.requires_grad == want.requires_grad
        assert torch.equal(got.detach().contiguous().reshape(-1).view(torch.uint8),
                           want.detach().contiguous().reshape(-1).view(torch.uint8))
    # The plain path (in-band) agrees.
    plain = port_ser.loads(port_ser.dumps(cases)[0])[0]
    assert all(torch.equal(a.detach(), b.detach()) for a, b in zip(plain, cases))


def _seeded_views(rng, sched):
    keys = ["CPU", "GPU", "memory", "accel"]
    views = {}
    for i in range(rng.randint(1, 12)):
        total = {k: float(rng.choice([1, 2, 4, 8])) for k in rng.sample(keys, rng.randint(1, 4))}
        avail = {k: v - float(rng.randint(0, int(v))) for k, v in total.items()}
        labels = {k: rng.choice(["a", "b", "c"]) for k in rng.sample(["zone", "rack", "tier"], rng.randint(0, 3))}
        views[f"n{i:02d}"] = sched.NodeView(
            node_id=f"n{i:02d}",
            addr=("127.0.0.1", 1000 + i),
            total=total,
            available=avail,
            labels=labels,
            alive=rng.random() > 0.1,
            suspect=rng.random() < 0.1,
            draining=rng.random() < 0.05,
        )
    return views


def _seeded_request(rng, sched, node_ids):
    keys = ["CPU", "GPU", "memory", "accel"]
    demand = {k: float(rng.choice([0.5, 1, 2, 3])) for k in rng.sample(keys, rng.randint(1, 2))}
    ops = [lambda: rng.choice(["a", "b", "c"]), lambda: ("in", rng.sample(["a", "b", "c"], 2)),
           lambda: ("not_in", [rng.choice(["a", "b", "c"])]), lambda: ("exists",)]
    sel = {k: rng.choice(ops)() for k in rng.sample(["zone", "rack"], rng.randint(0, 2))}
    soft = {k: rng.choice(["a", "b", "c"]) for k in rng.sample(["tier"], rng.randint(0, 1))}
    policy = rng.choice(["hybrid", "spread", f"node_affinity:{rng.choice(node_ids)}",
                         f"strict_node_affinity:{rng.choice(node_ids)}"])
    return sched.SchedulingRequest(resources=demand, label_selector=sel, soft_label_selector=soft, policy=policy)


@pytest.mark.parametrize("seed", range(4))
def test_scheduler_and_index_choose_alike(seed):
    n_fit = n_pick = 0
    for case in range(150):
        picks = []
        for sched, index in ((ref_scheduler, ref_sched_index), (port_scheduler, port_sched_index)):
            rng = random.Random(f"{seed}:{case}")
            views = _seeded_views(rng, sched)
            reqs = [_seeded_request(rng, sched, list(views)) for _ in range(4)]
            idx = index.FeasibilityIndex(views, probes=3)
            local = rng.choice(list(views) + [""])
            out = []
            for rr, req in enumerate(reqs):
                out.append([
                    [sched.fits(v.available, req.resources) for v in views.values()],
                    [sched.labels_match(v.labels, req.label_selector) for v in views.values()],
                    sched.any_feasible(req, views),
                    sched.pick_node(req, local, views, rr_counter=rr),
                    idx.pick(req, local, rr_counter=rr),
                ])
            picks.append(out)
        assert picks[0] == picks[1], (seed, case)
        n_fit += sum(sum(p[0]) for p in picks[1])
        n_pick += sum(p[4] is not None for p in picks[1])
    assert n_fit > 0 and n_pick > 0  # the tables exercise both answers


@pytest.mark.parametrize(
    "physical, env, want",
    [(4, None, 4), (4, "", 0), (4, "0,2", 2), (4, "1,-1,2", 1), (1, "0,1", 1), (2, "GPU-abc,MIG-x", 2),
     (2, "0,0", 1), (0, None, 0)],
)
def test_gpu_visible_count(physical, env, want):
    assert gpu.visible_count(physical, env) == want


def test_gpu_detect_resources_without_a_card():
    # No NVIDIA driver here: no GPU resource.
    assert gpu.detect_resources() == {}


def test_config_parses_env_like_the_reference(monkeypatch):
    from ray_tpu.core.config import load_config as ref_load
    from ray_tpu_torch.core.config import load_config as port_load

    monkeypatch.setenv("RAY_TPU_OBJECT_STORE_BYTES", "123456")
    monkeypatch.setenv("RAY_TPU_RPC_COALESCE_ENABLED", "0")
    monkeypatch.setenv("RAY_TPU_TRACING_ENABLED", "yes")
    monkeypatch.setenv("RAY_TPU_DRAIN_GRACE_S", "2.5")
    ref, port = ref_load(), port_load()
    for f in Config.__dataclass_fields__:
        assert getattr(port, f) == getattr(ref, f), f
    assert (port.object_store_bytes, port.rpc_coalesce_enabled, port.tracing_enabled, port.drain_grace_s) == (
        123456, False, True, 2.5)
