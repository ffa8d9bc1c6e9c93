"""The multi-world transfer fabric: ``ray_tpu_torch.experimental.multiworld``
against ``ray_tpu.experimental.multiworld``.

``plan_pulls`` is held against the reference's on the same boxes: the
producer catalogs of ``tests/test_multiworld_transfer.py`` (a global
[8, 4] array cut into row blocks) and of other layouts, read by a
consumer rank whose region the port's ``NamedSharding.box()`` gives and
the reference's ``addressable_devices_indices_map`` names.

Then the world-to-world transfer of ``tests/test_multiworld_transfer.py:157``
on the port's runtime: a producer world of two actor processes (a gloo
process group, its mesh from ``parallel.make_mesh``) holds the global
array row-split, one block a rank, under ``P("dp", None)``; a consumer
world of two more wants it column-split under ``P(None, "dp")``. Each
consumer plans, asks both producers to arm, pulls and assembles its
block: the bits of the global array, every shard pulled once, no
fallback. Actors are defined inside the test (pickled by value).
"""

import numpy as np
import pytest
import torch

from ray_tpu.experimental import multiworld as jmw
from ray_tpu_torch.experimental import multiworld as pmw
from ray_tpu_torch.parallel import Mesh, MeshSpec, NamedSharding, P

GLOBAL = np.arange(32.0, dtype=np.float32).reshape(8, 4)

pytestmark = pytest.mark.timeout(300)


class _Coordinates:
    """A rank's place on a mesh, standing in for a ``DeviceMesh``."""

    def __init__(self, coords):
        self.coords = coords

    def get_local_rank(self, axis):
        return self.coords[axis]


class _JaxRegion:
    """The reference's view of one consumer rank: its addressable region."""

    def __init__(self, box):
        self.box = box

    def addressable_devices_indices_map(self, shape):
        return {"dev": tuple(slice(lo, hi) for lo, hi in self.box)}


def _sharding(n, spec, rank):
    return NamedSharding(Mesh(MeshSpec(dp=n), _Coordinates({"dp": rank})), P(*spec))


def _catalogs(n, spec):
    """One catalog per producer rank of a world of ``n`` ranks holding
    GLOBAL under ``spec``, built by the port's ``export_shards``."""
    cats = []
    for r in range(n):
        sh = _sharding(n, spec, r)
        cat = pmw.export_shards(sh.shard(torch.from_numpy(GLOBAL)), sh)
        cats.append(dict(cat, process_index=r))
    return cats


LAYOUTS = [
    (2, ("dp", None), 2, (None, "dp")),  # the reference test's rows -> columns
    (4, ("dp", None), 2, ("dp", None)),  # four row blocks -> two
    (2, ("dp", None), 4, ("dp", None)),  # two row blocks -> four
    (2, (None, "dp"), 1, ()),  # columns -> whole
    (4, (None, "dp"), 2, ("dp", None)),  # four column blocks -> two row blocks
]


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: f"{x[0]}{x[1]}->{x[2]}{x[3]}")
def test_plan_pulls_equals_the_reference_on_the_same_boxes(layout):
    n_prod, prod_spec, n_cons, cons_spec = layout
    cats = _catalogs(n_prod, prod_spec)
    boxes = sorted(tuple(s["box"]) for c in cats for s in c["shards"])
    assert sum(np.prod([hi - lo for lo, hi in b]) for b in boxes) == GLOBAL.size
    for r in range(n_cons):
        target = _sharding(n_cons, cons_spec, r)
        box = target.box(GLOBAL.shape)
        got = pmw.plan_pulls(cats, target, GLOBAL.shape)
        want = jmw.plan_pulls(cats, _JaxRegion(box), GLOBAL.shape)
        assert got == want, (layout, r)
        assert got  # every rank needs something


@pytest.mark.parametrize("n,spec,jspec", [
    (4, ("dp", None), ("x", None)),
    (4, (None, "dp"), (None, "x")),
    (2, ("dp",), ("x",)),
    (1, (), ()),
], ids=lambda x: str(x))
def test_decomposition_of_equals_the_reference(n, spec, jspec):
    """The per-dim partition counts a consumer asks for: the port's from
    its ``NamedSharding``'s mesh sizes, the reference's from a JAX
    ``NamedSharding`` of the same layout over n of the virtual devices."""
    import jax
    from jax.sharding import Mesh as JMesh
    from jax.sharding import NamedSharding as JSharding
    from jax.sharding import PartitionSpec as JP

    from ray_tpu.experimental import transfer as jtransfer
    from ray_tpu_torch.experimental import transfer as ptransfer

    jsh = JSharding(JMesh(np.array(jax.devices()[:n]), ("x",)), JP(*jspec))
    for r in range(n):
        assert ptransfer.decomposition_of(_sharding(n, spec, r), GLOBAL.shape) == \
            jtransfer.decomposition_of(jsh, GLOBAL.shape)
    assert ptransfer.max_local_decomposition(GLOBAL.shape) == (1, 1)


def test_the_reference_test_catalog_boxes():
    cats = _catalogs(2, ("dp", None))
    assert [c["shards"][0]["box"] for c in cats] == [((0, 4), (0, 4)), ((4, 8), (0, 4))]
    assert all(c["global_shape"] == (8, 4) and c["dtype"] == "float32" for c in cats)


@pytest.fixture(scope="module")
def cluster():
    import ray_tpu_torch

    runtime = ray_tpu_torch.init(num_cpus=8)
    yield runtime
    ray_tpu_torch.shutdown()


def test_two_process_world_to_world_transfer(cluster):
    import socket

    import ray_tpu_torch as rt

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    @rt.remote(num_cpus=1)
    class Rank:
        """One rank of a two-process world: a gloo group, the port's mesh,
        and this rank's sharding of the global [8, 4] array."""

        def __init__(self, port, rank, spec, produce):
            import numpy as np
            import torch
            import torch.distributed as dist

            from ray_tpu_torch.parallel import MeshSpec, NamedSharding, P, make_mesh

            dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                    world_size=2, rank=rank)
            self.sharding = NamedSharding(make_mesh(MeshSpec(dp=2), "cpu"), P(*spec))
            whole = torch.from_numpy(np.arange(32.0, dtype=np.float32).reshape(8, 4))
            self.local = self.sharding.shard(whole).clone() if produce else None

        def catalog(self):
            from ray_tpu_torch.experimental.multiworld import export_shards

            return export_shards(self.local, self.sharding)

        def arm_for(self, positions):
            from ray_tpu_torch.experimental.multiworld import arm_shards

            return arm_shards(self.local, positions)

        def plan(self, catalogs):
            from ray_tpu_torch.experimental.multiworld import plan_pulls

            return plan_pulls(catalogs, self.sharding, (8, 4))

        def assemble(self, catalogs, descriptors):
            from ray_tpu_torch.experimental import transfer_stats
            from ray_tpu_torch.experimental.multiworld import pull_and_assemble

            out = pull_and_assemble(catalogs, descriptors, self.sharding, device="cpu")
            return self.sharding.box((8, 4)), out.numpy(), str(out.device), transfer_stats()

        def stats(self):
            from ray_tpu_torch.experimental import transfer_stats

            return transfer_stats()

    pport, cport = free_port(), free_port()
    prods = [Rank.remote(pport, r, ("dp", None), True) for r in range(2)]
    cons = [Rank.remote(cport, r, (None, "dp"), False) for r in range(2)]
    catalogs = rt.get([p.catalog.remote() for p in prods], timeout=150)
    assert [c["process_index"] for c in catalogs] == [0, 1]
    assert sorted(tuple(c["shards"][0]["box"]) for c in catalogs) == [
        ((0, 4), (0, 4)), ((4, 8), (0, 4))]
    for c in cons:
        plan = rt.get(c.plan.remote(catalogs), timeout=150)
        # Column blocks cut across every row block: both producers serve.
        assert plan == {0: [0], 1: [0]}
        descs = [rt.get(prods[i].arm_for.remote(plan[cat["process_index"]]), timeout=150)
                 for i, cat in enumerate(catalogs)]
        box, data, device, stats = rt.get(c.assemble.remote(catalogs, descs), timeout=150)
        (r0, r1), (c0, c1) = box
        assert (r1 - r0, c1 - c0) == (8, 2)
        assert device == "cpu"
        np.testing.assert_array_equal(data, GLOBAL[r0:r1, c0:c1])
        assert data.tobytes() == np.ascontiguousarray(GLOBAL[r0:r1, c0:c1]).tobytes()
        assert (stats["pulls"], stats["fallbacks"]) == (2, 0)
    for p in prods:
        pstats = rt.get(p.stats.remote(), timeout=60)
        assert (pstats["arms"], pstats["fallbacks"], pstats["armed"]) == (2, 0, 2)
    for h in (*prods, *cons):
        rt.kill(h)
