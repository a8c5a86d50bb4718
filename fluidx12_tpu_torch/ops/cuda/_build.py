"""Build and load the port's CUDA kernels.

Every `fluidx12_tpu_torch/csrc/*.cu` is compiled by its own `nvcc` process,
all started together, and the objects are linked into ONE shared library
with a plain C interface for sm_90a (Hopper), at first use, into
`build/kernels/` at the root of the checkout.  The library is named by a
hash of the sources, the headers they share (`csrc/*.cuh`) and the flags,
so an edited source rebuilds and a stale library is never loaded.  It is
bound with ctypes: every pointer and the stream travel as `c_void_p`, and
every C function returns `cudaGetLastError()` after its launches, which
`check` turns into an exception.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

# --fmad=false: each f32 product and sum rounds on its own, as in the plain
# PyTorch versions and the Pallas kernels, so the kernels agree with them to
# the last bit wherever the transcendentals do not differ.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC"]

# Shared memory a CTA may take on an H100 (227 KB): the launch plans fit it.
SMEM_PER_CTA = 232448

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "fx_advect_xy": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "fx_advect_xy_perthread": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "fx_advect_axis": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                       _P],
    "fx_advect_axis_perthread": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "fx_advect_z_forces": [_P, _P, _P, _P, _F, _F, _F, _F, _F, _I, _I,
                           _I, _I, _I, _I, _I, _I, _I, _P],
    "fx_advect_z_forces_perthread": [_P, _P, _P, _P, _F, _F, _F, _F, _F, _I, _I,
                                     _I, _I, _I, _I, _P],
    "fx_shear_scan": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "fx_shear_scan_twopass": [_P, _P, _P, _P, _I, _I, _I, _P],
    "fx_composite_resample": [_P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I,
                              _I, _I, _I, _P],
    "fx_composite": [_P, _P, _P, _P, _F, _I, _I, _I, _I, _P],
    "fx_divergence": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "fx_divergence_perthread": [_P, _P, _I, _I, _I, _I, _P],
    "fx_residual": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "fx_residual_perthread": [_P, _P, _P, _I, _I, _I, _P],
    "fx_prolong_correct": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "fx_prolong_correct_perthread": [_P, _P, _P, _I, _I, _I, _P],
    "fx_grad_damp": [_P, _P, _F, _I, _I, _I, _I, _I, _I, _I, _P],
    "fx_grad_damp_perthread": [_P, _P, _F, _I, _I, _I, _I, _P],
    "fx_jacobi": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "fx_jacobi_window": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "fx_jacobi2d": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "fx_jacobi_packed": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "fx_jacobi_rr": [_P, _P, _P, _P, _P, _I, _F, _I, _I, _I, _P],
    "fx_jacobi_divrr": [_P, _I, _P, _P, _P, _P, _P, _I, _F, _I, _I, _I, _P],
    "fx_jacobi_grad": [_P, _P, _P, _P, _P, _I, _F, _I, _I, _I, _I, _P],
    "fx_jacobi_sweepwise": [_I, _P, _I, _P, _P, _P, _P, _P, _F, _F, _I, _I, _I, _I,
                            _P],
    "fx_div6_mismatches": [_P, _P],
    "fx_gradient3": [_P, _P, _I, _I, _I, _I, _I, _I, _P],
    "fx_gradient3_perthread": [_P, _P, _I, _I, _I, _P],
    "fx_gi_light": [_P, _P, _P, _P, _P, _F, _I, _I, _I, _P],
}

_lib = None
build_seconds = None  # wall time of the build this process ran (None: cached or not built)


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfluidx_kernels_{h.hexdigest()[:16]}.so"


def _run(cmd) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")


def build() -> Path:
    """Compile the library if it is missing; returns its path."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in _sources()]
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(max_workers=len(objs)) as pool:
            list(pool.map(_run, ([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                                 for src, obj in zip(_sources(), objs))))
        _run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} (cudaError_t)")


def stream_ptr(t) -> int:
    """PyTorch's current stream on `t`'s device, as a pointer-sized int."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
