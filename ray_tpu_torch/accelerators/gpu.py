"""GPU detection: how many CUDA cards this process can see. The port's
counterpart of ``ray_tpu/accelerators/tpu.py::detect_resources``.

The count comes from NVML (``libnvidia-ml``, which ships with the NVIDIA
driver) and is cut to what ``CUDA_VISIBLE_DEVICES`` lets through. NVML
creates no CUDA context and needs no torch, so the calling process stays
free to fork and to pick its own card later. A box without the NVIDIA
driver has no ``GPU`` resource.
"""

from __future__ import annotations

import ctypes
import os

GPU_RESOURCE = "GPU"


def _nvml_count() -> int:
    """Cards NVML reports; 0 without the NVIDIA driver."""
    try:
        lib = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError:
        return 0
    lib.nvmlInit_v2.restype = lib.nvmlShutdown.restype = ctypes.c_int
    lib.nvmlDeviceGetCount_v2.argtypes = [ctypes.POINTER(ctypes.c_uint)]
    lib.nvmlDeviceGetCount_v2.restype = ctypes.c_int
    if lib.nvmlInit_v2() != 0:
        return 0
    try:
        count = ctypes.c_uint(0)
        if lib.nvmlDeviceGetCount_v2(ctypes.byref(count)) != 0:
            return 0
        return int(count.value)
    finally:
        lib.nvmlShutdown()


def visible_count(physical: int, cuda_visible_devices: str | None) -> int:
    """How many of ``physical`` cards CUDA exposes under
    ``CUDA_VISIBLE_DEVICES``: unset exposes all; otherwise the entries up to
    the first invalid one (CUDA's own rule), each an index below
    ``physical`` or a ``GPU-``/``MIG-`` UUID, counted once."""
    if cuda_visible_devices is None:
        return physical
    seen: list[str] = []
    for tok in (t.strip() for t in cuda_visible_devices.split(",")):
        if tok.isdigit() and int(tok) < physical:
            key = str(int(tok))
        elif tok.startswith(("GPU-", "MIG-")):
            key = tok
        else:
            break
        if key in seen:
            break
        seen.append(key)
    return min(len(seen), physical)


def detect_resources() -> dict:
    """``{"GPU": <visible cards>}``, or ``{}`` on a box without one."""
    n = visible_count(_nvml_count(), os.environ.get("CUDA_VISIBLE_DEVICES"))
    return {GPU_RESOURCE: float(n)} if n > 0 else {}
