"""ray_tpu_torch._native — lazily-built C++ helpers for the object data plane.
Port of ``ray_tpu/_native``.

The .so builds once per machine with the system g++ (no pip, no cmake) into
the package's git-ignored ``_build/`` directory, beside the CUDA kernels'
libraries; every entry point degrades to a pure-Python fallback when no
compiler is available, so the framework never hard-requires the native
path — it just gets faster with it. :func:`copy_path` says which path a
large copy takes in this process.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fastcopy.cpp")
_SO = os.path.join(os.path.dirname(_HERE), "_build", "_fastcopy.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    # pid-unique tmp: several worker processes may build concurrently on a
    # fresh checkout; os.replace is the only cross-process-visible step.
    tmp = f"{_SO}.{os.getpid()}.tmp"
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-pthread", "-std=c++17",
        _SRC, "-o", tmp,
    ]
    try:
        subprocess.run(
            cmd, check=True, capture_output=True, timeout=120
        )
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.SubprocessError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def get_lib():
    """The loaded ctypes library, or None when unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) or os.path.getmtime(
            _SO
        ) < os.path.getmtime(_SRC):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        lib.rt_copy.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64
        ]
        lib.rt_parallel_copy.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
            ctypes.c_int32,
        ]
        lib.rt_fnv1a.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.rt_fnv1a.restype = ctypes.c_uint64
        _lib = lib
    return _lib


def copy_path() -> str:
    """``"native"`` when the g++-built library loads in this process, else
    ``"python"`` (the slice-assignment fallback). Builds it if needed."""
    return "native" if get_lib() is not None else "python"


def _addr_of(buf) -> int:
    """Base address of any bytes-like object (read-only included)."""
    import numpy as np

    return int(np.frombuffer(buf, dtype=np.uint8).ctypes.data)


def copy_into(dst: memoryview, src) -> None:
    """dst[:] = src, using the native multi-threaded copy when available.

    dst must be writable and contiguous; src may be read-only.
    """
    n = len(src)
    if len(dst) != n:
        raise ValueError(f"length mismatch: dst={len(dst)} src={n}")
    if n < (1 << 20):
        # Size check BEFORE get_lib(): small copies must never trigger the
        # synchronous first-use g++ build (it would stall the endpoint
        # loop); warm_build() handles compilation off the hot path.
        if n:
            dst[:] = src
        return
    lib = get_lib()
    if lib is None:
        dst[:] = src
        return
    nthreads = min(8, os.cpu_count() or 1)
    lib.rt_parallel_copy(_addr_of(dst), _addr_of(src), n, nthreads)


def warm_build() -> None:
    """Kick the one-time g++ build on a background thread (called at
    process bootstrap so the first large copy finds the .so ready)."""
    threading.Thread(target=get_lib, daemon=True, name="fastcopy-build").start()


def fingerprint(data) -> int | None:
    """FNV-1a of a buffer via the native lib (None when unavailable)."""
    if len(data) == 0:
        return 0
    lib = get_lib()
    if lib is None:
        return None
    return int(lib.rt_fnv1a(_addr_of(data), len(data)))
