"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library, ``_build/lib<name>-<key>.so`` beside the package (git-ignored).
The key (:func:`library_key`) hashes the source, every ``csrc`` header it
includes and the flags, so an edited source or shared header rebuilds and
a stale library is never loaded. Nothing builds at import: :func:`load`
compiles on first use.

The libraries link the CUDA runtime statically and share PyTorch's primary
context; the caller passes device pointers and PyTorch's current stream as
``ctypes.c_void_p``. The driver's tensor-map encoder is looked up at run
time (``cudaGetDriverEntryPoint``), so nothing links ``libcuda``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


@dataclass
class Built:
    name: str
    path: Path
    seconds: float  # wall time of this call's nvcc run; 0.0 when reused
    log: str  # nvcc's output (ptxas register/shared-memory report)


_libs: dict[str, ctypes.CDLL] = {}


def included_headers(src: Path) -> list[Path]:
    """The quoted ``#include`` files of ``src`` that live beside it, and
    theirs, in the order first met."""
    seen: list[Path] = []
    todo = [src]
    while todo:
        for inc in _INCLUDE.findall(todo.pop(0).read_bytes()):
            path = src.parent / inc.decode()
            if path.exists() and path not in seen:
                seen.append(path)
                todo.append(path)
    return seen


def library_key(name: str, csrc: Path = CSRC) -> str:
    """The hash that names ``lib<name>``: the source's bytes, those of each
    header it includes, and the nvcc flags."""
    src = csrc / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes())
    for header in included_headers(src):
        key.update(header.name.encode() + b"\0" + header.read_bytes())
    key.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return key.hexdigest()[:16]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` unless its key-named library exists."""
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}-{library_key(name)}.so"
    if out.exists():
        return Built(name, out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent builder never loads a partial file
    return Built(name, out, seconds, proc.stdout)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it on first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = _libs.setdefault(name, ctypes.CDLL(str(build(name).path)))
    return lib
