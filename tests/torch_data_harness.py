"""Runs the reference's data-tier tests through both packages and records
what each one's datasets hand back, for the ``test_torch_data*.py`` files.

Each reference file (``tests/test_data*.py``) is loaded twice from its
source: once as it is (the JAX package) and once with every ``ray_tpu``
name turned into ``ray_tpu_torch`` (the port), each as a module of its own
whose functions travel to workers by value. Every test function of a
variant is called with its own file's fixtures (the ``cluster`` fixture
and any autouse fixture of that file, through their undecorated
functions; ``tmp_path`` and ``tmp_path_factory`` under the caller's
directory), so its assertions run against the package it names.
Meanwhile every row, batch, count, schema and frame that a ``Dataset``
returns to the driver is recorded in order; the test files then hold the
two packages' records equal. The packages run one after the other, each
against its own runtime.

:func:`run_in_child` runs all of it in a fresh Python process and hands
back the records: the governor's out-of-core scenario bounds the store's
peak against how fast the driver drains it, which a test process that
has run many clusters before slows (its reference arm then overshot in
a long pytest process), and a crash (pandas' pyarrow-backed strings
segfaulted with two sessions at once) ends only the child.

Where a reference test drives jax itself, the port's variant runs
``PORT_OVERRIDES``' body instead: the same pipeline and the same
assertions on torch tensors, on the CPU.
"""

from __future__ import annotations

import inspect
import os
import pathlib
import pickle
import re
import subprocess
import sys
import time
import traceback
import types

import cloudpickle
import numpy as np

TESTS = pathlib.Path(__file__).resolve().parent
PACKAGES = ("ray_tpu", "ray_tpu_torch")
RECORDED = ("take_all", "take", "take_batch", "count", "schema", "columns", "num_blocks",
            "to_pandas", "iter_batches", "iter_rows", "iter_torch_batches")


def plain(value):
    """A value as plain Python, for comparing the packages' records."""
    if isinstance(value, dict):
        return {k: plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [plain(v) for v in value]
    if isinstance(value, np.ndarray) or isinstance(value, np.generic):
        return value.tolist()
    mod = type(value).__module__ or ""
    if mod.startswith("torch"):
        return value.tolist()
    if mod.startswith("pandas"):
        return {str(k): plain(list(v)) for k, v in value.to_dict("list").items()}
    if mod.startswith("pyarrow"):
        names = getattr(value, "names", None)
        if names is not None and not hasattr(value, "to_pydict"):
            return ["schema", list(names)]
        return plain(value.to_pydict())
    return value


class Recorder:
    """Wraps the terminal methods of one package's ``Dataset`` so that
    what they return is appended to ``log`` (None: not recording)."""

    def __init__(self, pkg: str):
        import importlib

        self.log = None
        cls = importlib.import_module(f"{pkg}.data.dataset").Dataset
        for name in RECORDED:
            orig = getattr(cls, name, None)
            if orig is not None and not hasattr(orig, "_recorded"):
                setattr(cls, name, self._wrap(name, orig))

    def _wrap(self, name, orig):
        rec = self
        if inspect.isgeneratorfunction(orig):
            def method(self, *args, **kwargs):
                for item in orig(self, *args, **kwargs):
                    if rec.log is not None:
                        rec.log.append((name, plain(item)))
                    yield item
        else:
            def method(self, *args, **kwargs):
                out = orig(self, *args, **kwargs)
                if rec.log is not None:
                    rec.log.append((name, plain(out)))
                return out
        method._recorded = True
        method.__name__ = name
        return method


def load_variant(ref_name: str, pkg: str) -> types.ModuleType:
    """The reference test file ``ref_name`` as a module naming ``pkg``."""
    path = TESTS / ref_name
    src = path.read_text()
    if pkg == "ray_tpu_torch":
        src = re.sub(r"\bray_tpu\b", "ray_tpu_torch", src)
    name = f"_torch_data_variant_{pkg}_{path.stem}"
    mod = types.ModuleType(name)
    mod.__file__ = str(path)
    sys.modules[name] = mod
    exec(compile(src, str(path), "exec"), mod.__dict__)
    cloudpickle.register_pickle_by_value(mod)
    return mod


def _untmp(value, tmp_dirs):
    """``value`` with each test's temporary directory written as
    ``<tmp>`` (each package writes its files under its own)."""
    if isinstance(value, str):
        for d in tmp_dirs:
            value = value.replace(d, "<tmp>")
        return value
    if isinstance(value, dict):
        return {k: _untmp(v, tmp_dirs) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_untmp(v, tmp_dirs) for v in value)
    return value


def _fixture_fn(obj):
    return obj._get_wrapped_function() if hasattr(obj, "_get_wrapped_function") else obj


def _autouse(mod):
    return [_fixture_fn(v) for v in vars(mod).values()
            if getattr(getattr(v, "_fixture_function_marker", None), "autouse", False)]


def _scenario_names(mod) -> list:
    return [n for n, v in vars(mod).items() if n.startswith("test_") and callable(v)]


def run_file(ref_name: str, pkg: str, recorder: Recorder, tmp_factory, overrides) -> dict:
    """Every test of ``ref_name`` under ``pkg``: {name: {"ok", "error",
    "log", "seconds"}}. The file's ``cluster`` fixture is set up before
    the first test that asks for it and torn down after the last."""
    mod = load_variant(ref_name, pkg)
    names = _scenario_names(mod)
    out = {}
    cluster_gen, cluster = None, None
    try:
        for name in names:
            fn = overrides.get(name, getattr(mod, name))
            fn = getattr(fn, "__wrapped__", fn)
            params = inspect.signature(fn).parameters
            kwargs, tmp_dirs = {}, []
            if "cluster" in params:
                if cluster_gen is None:
                    cluster_gen = _fixture_fn(mod.cluster)()
                    cluster = next(cluster_gen)
                kwargs["cluster"] = cluster
            if "tmp_path" in params:
                kwargs["tmp_path"] = tmp_factory.mktemp(f"{pkg}_{name}")
                tmp_dirs.append(str(kwargs["tmp_path"]))
            if "tmp_path_factory" in params:
                kwargs["tmp_path_factory"] = tmp_factory
                tmp_dirs.append(str(tmp_factory.getbasetemp()))
            if "mod" in params:
                kwargs["mod"] = mod
            autos = [a() for a in _autouse(mod)]
            for a in autos:
                next(a)
            recorder.log = []
            t0 = time.perf_counter()
            try:
                fn(**kwargs)
                error = None
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:  # noqa: BLE001 - a failed assertion is the result
                error = "".join(traceback.format_exception_only(type(e), e)) + traceback.format_exc()
            finally:
                log, recorder.log = recorder.log, None
                for a in autos:
                    next(a, None)
            out[name] = {"ok": error is None, "error": error, "log": _untmp(log, tmp_dirs),
                         "seconds": time.perf_counter() - t0}
    finally:
        if cluster_gen is not None:
            next(cluster_gen, None)
    return out


def run_both(ref_names, tmp_factory) -> dict:
    """Each package's runs of ``ref_names``, the JAX package's first and
    then the port's (one at a time: two sessions at once crashed in
    pandas' pyarrow-backed strings). Returns {pkg: {ref_name:
    run_file(...)}} plus "seconds"."""
    out, seconds = {}, {}
    for pkg in PACKAGES:
        t0 = time.perf_counter()
        recorder = Recorder(pkg)
        res = {}
        for ref in ref_names:
            overrides = PORT_OVERRIDES.get(ref, {}) if pkg == "ray_tpu_torch" else {}
            try:
                res[ref] = run_file(ref, pkg, recorder, tmp_factory, overrides)
            except Exception:  # noqa: BLE001 - reported by the tests
                res[ref] = {"session_error": traceback.format_exc()}
        out[pkg] = res
        seconds[pkg] = time.perf_counter() - t0
    out["seconds"] = seconds
    return out


def port_data_to_train_e2e_through_device_batches(cluster, mod):
    """``tests/test_data_governor.py``'s data → train scenario on the port:
    the same pipeline through ``DataIterator.iter_device_batches`` into a
    torch step, on the CPU (``device="cpu"``: the port lands on the card
    unless asked), with the same assertions."""
    import torch

    from ray_tpu_torch.data.iterator import DataIterator

    rd = mod.rd
    ds = rd.range(512, parallelism=8).map_batches(lambda b: {"x": b["id"].astype(np.float32)})
    it = DataIterator(ds, prefetch_depth=2)

    def step(acc, x):
        return acc + torch.sum(x)

    acc = torch.zeros((), dtype=torch.float32)
    n_batches = 0
    for batch in it.iter_device_batches(batch_size=64, device="cpu"):
        assert isinstance(batch["x"], torch.Tensor)  # staged for the step
        acc = step(acc, batch["x"])
        n_batches += 1
    assert n_batches == 512 // 64
    assert float(acc) == float(sum(range(512)))
    assert ds.governor_stats() is not None


PORT_OVERRIDES = {"test_data_governor.py": {
    "test_data_to_train_e2e_through_device_batches":
        port_data_to_train_e2e_through_device_batches,
}}


class TmpFactory:
    """``tmp_path_factory``'s two calls the reference tests make, under
    one directory."""

    def __init__(self, base):
        self._base = pathlib.Path(base)
        self._n = 0

    def getbasetemp(self) -> pathlib.Path:
        return self._base

    def mktemp(self, name: str) -> pathlib.Path:
        self._n += 1
        path = self._base / f"{name}{self._n}"
        path.mkdir(parents=True)
        return path


def _child(ref_names, base: str, out_path: str) -> None:
    out = run_both(ref_names, TmpFactory(base))
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def run_in_child(ref_names, base, timeout_s: float = 280.0) -> dict:
    """:func:`run_both` of ``ref_names`` in a fresh Python process, its
    temporary files under ``base``: the same result, or
    ``{"child_error": ...}`` where the child died or gave none."""
    out_path = pathlib.Path(base) / "results.pkl"
    code = ("import sys; sys.path.insert(0, %r); import torch_data_harness as h; "
            "h._child(%r, %r, %r)" % (str(TESTS), list(ref_names), str(base), str(out_path)))
    root = str(TESTS.parent)
    env = dict(os.environ, JAX_PLATFORMS="cpu", RAY_TPU_HOST_IP="127.0.0.1",
               PYTHONPATH=os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p))
    try:
        r = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                           text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired as e:
        return {"child_error": f"timed out after {timeout_s} s: {(e.stderr or '')[-4000:]}"}
    if r.returncode != 0 or not out_path.exists():
        return {"child_error": f"exit {r.returncode}: {r.stderr[-4000:]}"}
    with open(out_path, "rb") as f:
        return pickle.load(f)


def scenario_ids(ref_names) -> list:
    """(ref file, test name) of every test in ``ref_names``, read from
    the source (no import), in file order."""
    ids = []
    for ref in ref_names:
        for m in re.finditer(r"^def (test_\w+)\(", (TESTS / ref).read_text(), re.M):
            ids.append((ref, m.group(1)))
    return ids


def drop_keys(log, keys):
    """``log`` with the columns ``keys`` removed from every row and batch
    (values that name a process or node of one runtime)."""
    def strip(v):
        if isinstance(v, dict):
            return {k: strip(x) for k, x in v.items() if k not in keys}
        if isinstance(v, list):
            return [strip(x) for x in v]
        return v
    return [(name, strip(v)) for name, v in log]


def unordered(log):
    """``log`` with each record's rows in a canonical order: for results
    whose row order the engine leaves unspecified (pyarrow's hash join
    emits its matches in thread order)."""
    def canon(v):
        if isinstance(v, list) and all(isinstance(x, dict) for x in v):
            return sorted(v, key=repr)
        return v
    return [(name, canon(v)) for name, v in log]
