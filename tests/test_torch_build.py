"""The CUDA kernels' host-side plumbing, on the CPU (no nvcc, no card):

- the libraries' build key names the built library, so an edited source or
  shared header must rebuild and nothing else may;
- the layout check that decides whether a tensor can be handed to the
  kernels' TMA copies;
- chip_smoke's count of wgmma, TMA and mbarrier instructions in a SASS
  listing.
"""

import torch

import chip_smoke
from ray_tpu_torch.ops import _build, attention


def _tree(tmp_path, header=b"// shared v1\n", nested=b"// nested v1\n"):
    csrc = tmp_path / "csrc"
    csrc.mkdir(exist_ok=True)
    (csrc / "kern.cu").write_bytes(b'#include "shared.cuh"\n#include <cuda.h>\nint x;\n')
    (csrc / "shared.cuh").write_bytes(b'#pragma once\n#include "nested.cuh"\n' + header)
    (csrc / "nested.cuh").write_bytes(nested)
    (csrc / "unrelated.cuh").write_bytes(b"// not included\n")
    return csrc


def test_key_follows_included_headers(tmp_path):
    csrc = _tree(tmp_path)
    key = _build.library_key("kern", csrc)
    assert key == _build.library_key("kern", csrc)  # same bytes, same key
    assert [p.name for p in _build.included_headers(csrc / "kern.cu")] == [
        "shared.cuh", "nested.cuh"
    ]

    (csrc / "unrelated.cuh").write_bytes(b"// edited, still not included\n")
    assert _build.library_key("kern", csrc) == key

    _tree(tmp_path, header=b"// shared v2\n")
    assert _build.library_key("kern", csrc) != key
    _tree(tmp_path)
    assert _build.library_key("kern", csrc) == key

    _tree(tmp_path, nested=b"// nested v2\n")  # a header included by a header
    assert _build.library_key("kern", csrc) != key


def test_key_follows_source_and_flags(tmp_path, monkeypatch):
    csrc = _tree(tmp_path)
    key = _build.library_key("kern", csrc)
    (csrc / "kern.cu").write_bytes(b'#include "shared.cuh"\nint y;\n')
    edited = _build.library_key("kern", csrc)
    assert edited != key
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lineinfo"])
    assert _build.library_key("kern", csrc) != edited


def test_the_port_kernels_include_the_shared_header():
    for name in ("flash_fwd", "flash_bwd"):
        headers = _build.included_headers(_build.CSRC / f"{name}.cu")
        assert [p.name for p in headers] == ["hopper.cuh"], name


def test_kernel_layout_check():
    """Strides must be positive multiples of 16 bytes (TMA's rule), except
    along a dim of extent 1, which is never stepped; rows unit-stride and
    16-byte aligned."""
    qkv = torch.zeros((2, 40, 3 * 4 * 64), dtype=torch.bfloat16)
    q = qkv[..., : 4 * 64].reshape(2, 40, 4, 64).transpose(1, 2)  # a strided head view
    assert attention._kernel_layout_ok(q)
    assert attention._kernel_layout_ok(torch.zeros((2, 4, 40, 64), dtype=torch.bfloat16))
    expanded = torch.zeros((2, 1, 40, 64), dtype=torch.bfloat16).expand(2, 4, 40, 64)
    assert not attention._kernel_layout_ok(expanded)  # a zero stride along 4 heads
    one_head = torch.zeros((2, 40, 64), dtype=torch.bfloat16).unsqueeze(1)
    assert attention._kernel_layout_ok(one_head.as_strided(one_head.shape, (2560, 3, 64, 1)))
    assert not attention._kernel_layout_ok(q.transpose(2, 3))  # head dim not unit-stride
    flat = torch.zeros(2 * 4 * 40 * 64 + 1, dtype=torch.bfloat16)
    assert not attention._kernel_layout_ok(flat[1:].view(2, 4, 40, 64))  # 2-byte aligned


SASS = """
        code for sm_90a
                Function : _ZN45_GLOBAL__N__8f4ed862_12_flash_fwd_cu_48fe48b516flash_fwd_kernelENS_9FwdParamsE
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0ab0*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT, gsb0 ;
        /*0ac0*/              @!P0 SYNCS.PHASECHK.TRANS64.TRYWAIT P1, [R3+URZ], R4 ;
        /*0ad0*/              @P1 UTMALDG.4D [UR8], [UR4] ;
        /*0ae0*/                   UTMALDG.4D [UR16], [UR4] ;
        /*0af0*/              @UP0 SYNCS.ARRIVE.TRANS64 RZ, [UR5], RZ ;
        /*0b00*/                   UTMASTG.4D [UR4], [UR6] ;
                Function : _ZN45_GLOBAL__N__14df9a74_12_flash_bwd_cu_ccb4464f19flash_bwd_dq_kernelENS_9BwdParamsE
        /*0000*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0010*/                   HGMMA.64x64x16.F32.BF16 R24, R8, gdesc[UR8], R24, gsb0 ;
"""


def test_sass_counts_by_kernel():
    counts = chip_smoke.parse_sass(SASS)
    assert counts == {
        "flash_fwd_kernel": {"HGMMA": 1, "UTMALDG": 2, "UTMASTG": 1, "SYNCS": 2, "HMMA": 0},
        "flash_bwd_dq_kernel": {"HGMMA": 1, "UTMALDG": 0, "UTMASTG": 0, "SYNCS": 0, "HMMA": 1},
    }
