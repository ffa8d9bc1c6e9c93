"""The port stands alone: ``ray_tpu_torch``, ``chip_smoke.py``,
``torch_host_ab.py`` and the rank workers of the gloo tests import neither
jax nor anything of the JAX package, and importing the port builds
nothing and pulls in no jax."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "ray_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py",
    ROOT / "torch_host_ab.py",
    ROOT / "tests" / "torch_parallel_worker.py",
    ROOT / "tests" / "torch_llm_tp_worker.py",
    ROOT / "tests" / "torch_seq_pipe_worker.py",
    ROOT / "tests" / "torch_ckpt_worker.py",
    ROOT / "tests" / "test_torch_core_cuda.py",
    ROOT / "tests" / "test_torch_train_cuda.py",
    ROOT / "tests" / "test_torch_serve_cuda.py",
    ROOT / "tests" / "test_torch_data_cuda.py",
]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "ray_tpu")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_and_nothing_of_ray_tpu(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_pulls_in_no_jax():
    code = (
        "import sys, ray_tpu_torch, ray_tpu_torch.llm, ray_tpu_torch.llm.engine, "
        "ray_tpu_torch.util.flightrec, ray_tpu_torch.core.config, "
        "ray_tpu_torch.ops.attention, ray_tpu_torch.ops.ring_attention, "
        "ray_tpu_torch.models.convert, ray_tpu_torch.train.spmd, "
        "ray_tpu_torch.parallel, ray_tpu_torch.parallel.mesh, ray_tpu_torch.parallel.sharding, "
        "ray_tpu_torch.core.errors, ray_tpu_torch.core.faults, ray_tpu_torch.util.net, "
        "ray_tpu_torch.experimental.transfer, ray_tpu_torch.llm.disagg, "
        "ray_tpu_torch.train.checkpoint, ray_tpu_torch.train.sharded_checkpoint, "
        "ray_tpu_torch.core.api, ray_tpu_torch.core.core_worker, ray_tpu_torch.core.node, "
        "ray_tpu_torch.core.gcs, ray_tpu_torch.core.worker_main, ray_tpu_torch.util, "
        "ray_tpu_torch.train, ray_tpu_torch.train.trainer, ray_tpu_torch.train.controller, "
        "ray_tpu_torch.train.worker_group, ray_tpu_torch.train.elastic, "
        "ray_tpu_torch.util.collective.topology, ray_tpu_torch.util.prefix_digest, "
        "ray_tpu_torch.serve, ray_tpu_torch.serve.admission, ray_tpu_torch.serve.api, "
        "ray_tpu_torch.serve.asgi, ray_tpu_torch.serve.batching, ray_tpu_torch.serve.controller, "
        "ray_tpu_torch.serve.grpc_ingress, ray_tpu_torch.serve.handle, "
        "ray_tpu_torch.serve.multiplex, ray_tpu_torch.serve.proxy, ray_tpu_torch.serve.replica, "
        "ray_tpu_torch.serve.router, ray_tpu_torch.serve.schema, ray_tpu_torch.llm.serve_llm, "
        "ray_tpu_torch.llm.batch, ray_tpu_torch.experimental, "
        "ray_tpu_torch.experimental.device_objects, ray_tpu_torch.experimental.multiworld, "
        "ray_tpu_torch.data, ray_tpu_torch.data.block, ray_tpu_torch.data.context, "
        "ray_tpu_torch.data.governor, ray_tpu_torch.data.plan, ray_tpu_torch.data.executor, "
        "ray_tpu_torch.data.datasource, ray_tpu_torch.data.dataset, ray_tpu_torch.data.grouped, "
        "ray_tpu_torch.data.iterator\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ray_tpu', 'yaml', 'grpc')]\n"
        "assert not bad, bad\n"
        "from ray_tpu_torch.ops import _build\n"
        "assert not _build._libs\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert r.returncode == 0, r.stderr


def test_package_import_is_light_and_the_runtime_loads_lazily():
    code = (
        "import sys, ray_tpu_torch\n"
        "assert 'torch' not in sys.modules and 'ray_tpu_torch.core.api' not in sys.modules\n"
        "ray_tpu_torch.remote\n"
        "assert 'ray_tpu_torch.core.api' in sys.modules\n"
        "assert 'torch' not in sys.modules, 'the runtime imports torch only for a tensor'\n"
        "assert sorted(ray_tpu_torch.__all__) == sorted(ray_tpu_torch._CORE_API)\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert r.returncode == 0, r.stderr


def test_the_data_tier_imports_without_pyarrow():
    """The port's Dataset needs pyarrow only to build or read a block:
    importing the data tier (and building a plan) imports neither pyarrow
    nor pandas, and a process without them can still import it."""
    code = (
        "import sys\n"
        "import ray_tpu_torch.data as rd, ray_tpu_torch.data.executor\n"
        "assert not any(m.split('.')[0] in ('pyarrow', 'pandas') for m in sys.modules)\n"
        "assert not isinstance(object(), rd.Block)\n"
        "assert not any(m.split('.')[0] in ('pyarrow', 'pandas') for m in sys.modules)\n"
        "sys.modules['pyarrow'] = None\n"
        "sys.modules['pandas'] = None\n"
        "for m in [m for m in sys.modules if m.startswith('ray_tpu_torch.data')]:\n"
        "    del sys.modules[m]\n"
        "import ray_tpu_torch.data\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert r.returncode == 0, r.stderr
