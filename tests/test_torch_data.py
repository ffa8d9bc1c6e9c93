"""The data tier on both packages: every scenario of ``tests/test_data.py``
and ``tests/test_data_datasources.py`` (constructors, transforms, fusion,
barriers, groupby, batching, sharding, file IO, datasources) runs under
``ray_tpu.data`` and under the port's ``ray_tpu_torch.data``, each against
its own runtime, and the rows, batches, counts, schemas and frames that
each package's datasets hand back are equal, in order.

``tests/torch_data_harness.py`` loads each reference file twice (once
naming the port), calls every test with its own file's fixtures, and
records what the datasets return, in a child process of its own; the
reference's assertions run in both packages.
"""

import pytest

import torch_data_harness as harness

REFS = ("test_data.py", "test_data_datasources.py")
IDS = harness.scenario_ids(REFS)
# Columns that name one runtime's node or process.
RUNTIME_KEYS = {"test_map_batches_resource_budget": {"node"}}

pytestmark = pytest.mark.timeout(300)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return harness.run_in_child(REFS, tmp_path_factory.mktemp("data"))


def test_every_reference_scenario_ran_in_both(results):
    assert "child_error" not in results, results.get("child_error")
    assert len(IDS) == 28
    for pkg in harness.PACKAGES:
        for ref in REFS:
            assert "session_error" not in results[pkg][ref], results[pkg][ref]
            assert sorted(results[pkg][ref]) == sorted(n for r, n in IDS if r == ref)


@pytest.mark.parametrize("ref,name", IDS, ids=[f"{r[:-3]}::{n}" for r, n in IDS])
def test_same_rows_and_batches_as_the_reference(results, ref, name):
    jax_run, port_run = results["ray_tpu"][ref][name], results["ray_tpu_torch"][ref][name]
    assert jax_run["ok"], jax_run["error"]
    assert port_run["ok"], port_run["error"]
    keys = RUNTIME_KEYS.get(name, set())
    assert harness.drop_keys(port_run["log"], keys) == harness.drop_keys(jax_run["log"], keys)
