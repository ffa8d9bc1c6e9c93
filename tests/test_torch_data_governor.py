"""The data tier's memory governor and actor pool on both packages: every
scenario of ``tests/test_data_governor.py`` (the governor's arbitration
units, drain-aware occupancy, the out-of-core pipeline governed and with
the kill switch, the actor pool's order, scaling and restart, data → train
through ``iter_device_batches``) runs under ``ray_tpu.data`` and under
``ray_tpu_torch.data``, and the rows and batches each package's datasets
hand back are equal, in order (see ``tests/torch_data_harness.py``).

The reference's data → train scenario drives a jitted JAX step; the
port's runs the same pipeline through ``DataIterator.iter_device_batches``
into a torch step on the CPU (``device="cpu"``: the port lands on the card
unless asked), with the same assertions.
"""

import pytest

import torch_data_harness as harness

REFS = ("test_data_governor.py",)
IDS = harness.scenario_ids(REFS)

pytestmark = pytest.mark.timeout(300)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return harness.run_in_child(REFS, tmp_path_factory.mktemp("data"))


def test_every_reference_scenario_ran_in_both(results):
    assert "child_error" not in results, results.get("child_error")
    assert len(IDS) == 13
    for pkg in harness.PACKAGES:
        for ref in REFS:
            assert "session_error" not in results[pkg][ref], results[pkg][ref]
            assert sorted(results[pkg][ref]) == sorted(n for r, n in IDS if r == ref)


@pytest.mark.parametrize("ref,name", IDS, ids=[f"{r[:-3]}::{n}" for r, n in IDS])
def test_same_rows_and_batches_as_the_reference(results, ref, name):
    jax_run, port_run = results["ray_tpu"][ref][name], results["ray_tpu_torch"][ref][name]
    assert jax_run["ok"], jax_run["error"]
    assert port_run["ok"], port_run["error"]
    assert port_run["log"] == jax_run["log"]
