"""Device selection and numeric settings shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. A CUDA request with no usable GPU raises instead of carrying
    on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def set_exact_matmul() -> None:
    """Keep float32 matmuls in full float32 and bf16 GEMMs accumulating in
    float32.

    The JAX reference computes float32 products in float32 and bf16
    products with float32 accumulation. TF32 (about three decimal digits)
    would break the float32 parity the tests hold at 1e-4, and cuBLAS's
    reduced-precision bf16 reduction would add rounding the reference does
    not have. Both flags are process-wide; they are set, not toggled.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
