"""Hand-written CUDA kernels for Hopper (the counterpart of
fluidx12_tpu/ops/pallas/), each beside its plain PyTorch version.

Each wrapper takes the plain version for a CPU tensor and launches its
kernel for a CUDA tensor (or raises); it adds one to its `launches` count
where it launches, so a run can show that the main path went through it.
Kernel modules import nothing CUDA-specific at import time: the library is
built and loaded at the first launch (ops/cuda/_build.py).
"""

from __future__ import annotations


def wrappers():
    """{name: wrapper} of every kernel wrapper: the default preset's in
    frame order, then B12 `advect_z` (on neither preset's path), then the
    2D preset's B11 and B14."""
    from fluidx12_tpu_torch.ops.cuda.advect import (
        advect_axis,
        advect_xy,
        advect_z,
        advect_z_forces,
    )
    from fluidx12_tpu_torch.ops.cuda.composite import composite_resample
    from fluidx12_tpu_torch.ops.cuda.jacobi import jacobi, jacobi2d, jacobi_packed
    from fluidx12_tpu_torch.ops.cuda.stencil import (
        divergence,
        grad_damp,
        prolong_correct,
        residual,
    )
    from fluidx12_tpu_torch.ops.cuda.sweep import shear_scan

    return {"advect_xy": advect_xy, "advect_z_forces": advect_z_forces,
            "divergence": divergence, "jacobi": jacobi, "residual": residual,
            "jacobi_packed": jacobi_packed, "prolong_correct": prolong_correct,
            "grad_damp": grad_damp, "shear_scan": shear_scan,
            "composite_resample": composite_resample, "advect_z": advect_z,
            "advect_axis": advect_axis, "jacobi2d": jacobi2d}


def reset_launch_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}
