"""The data tier's executor on both packages: every scenario of
``tests/test_data_distributed.py`` (distributed sort, the actor pool),
``tests/test_data_join_sort.py`` (streaming sort and repartition, hash
joins) and ``tests/test_data_optimizer.py`` (the logical optimizer's
rewrites, streaming shuffle) runs under ``ray_tpu.data`` and under
``ray_tpu_torch.data``, and the rows and batches each package's datasets
hand back are equal, in order (see ``tests/torch_data_harness.py``).
"""

import pytest

import torch_data_harness as harness

REFS = ("test_data_distributed.py", "test_data_join_sort.py", "test_data_optimizer.py")
IDS = harness.scenario_ids(REFS)
# Columns that name one runtime's process.
RUNTIME_KEYS = {"test_actor_pool_map_batches_bounded_processes": {"pid"}}
# Joins: pyarrow's hash join emits matches in thread order, in both
# packages alike (the reference's tests sort before comparing), so rows
# are compared as sorted lists.
UNORDERED = {"test_inner_join_matches_pandas", "test_left_outer_join_keeps_unmatched",
             "test_full_outer_join", "test_join_string_keys_deterministic_across_processes",
             "test_join_streams_left_side", "test_join_duplicate_value_column_gets_suffix"}

pytestmark = pytest.mark.timeout(300)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return harness.run_in_child(REFS, tmp_path_factory.mktemp("data"))


def test_every_reference_scenario_ran_in_both(results):
    assert "child_error" not in results, results.get("child_error")
    assert len(IDS) == 29
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
    port, ref_log = (harness.drop_keys(r["log"], keys) for r in (port_run, jax_run))
    if name in UNORDERED:
        port, ref_log = harness.unordered(port), harness.unordered(ref_log)
    assert port == ref_log
