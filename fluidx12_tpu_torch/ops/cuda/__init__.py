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
    frame order, then B12 `advect_z` (on no preset's path), the 2D
    preset's B11 and B14, the 256^3 GI frame's B13 and B16, the fused
    projection's B18 (`jacobi_divrr`, `jacobi_grad`) and the 256x256x60 GI
    frame's B15 and B17."""
    from fluidx12_tpu_torch.ops.cuda.advect import (
        advect_axis,
        advect_xy,
        advect_z,
        advect_z_forces,
    )
    from fluidx12_tpu_torch.ops.cuda.composite import composite, composite_resample
    from fluidx12_tpu_torch.ops.cuda.jacobi import (
        jacobi,
        jacobi2d,
        jacobi_divrr,
        jacobi_grad,
        jacobi_packed,
        jacobi_rr,
    )
    from fluidx12_tpu_torch.ops.cuda.stencil import (
        divergence,
        gi_light,
        grad_damp,
        gradient3,
        prolong_correct,
        residual,
    )
    from fluidx12_tpu_torch.ops.cuda.sweep import shear_scan

    return {"advect_xy": advect_xy, "advect_z_forces": advect_z_forces,
            "divergence": divergence, "jacobi": jacobi, "residual": residual,
            "jacobi_packed": jacobi_packed, "prolong_correct": prolong_correct,
            "grad_damp": grad_damp, "shear_scan": shear_scan,
            "composite_resample": composite_resample, "advect_z": advect_z,
            "advect_axis": advect_axis, "jacobi2d": jacobi2d, "jacobi_rr": jacobi_rr,
            "gi_light": gi_light, "jacobi_divrr": jacobi_divrr, "jacobi_grad": jacobi_grad,
            "gradient3": gradient3, "composite": composite}


def reset_launch_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0
    wrappers()["jacobi"].planewise_launches = 0


def launch_counts() -> dict:
    """{name: launches} of every wrapper, and under "jacobi_planewise" the
    launches of B4 in its plane-sweep order (also counted in "jacobi")."""
    fns = wrappers()
    counts = {name: fn.launches for name, fn in fns.items()}
    counts["jacobi_planewise"] = fns["jacobi"].planewise_launches
    return counts


def add_launch_counts(counts: dict, times: int = 1) -> None:
    """Add `times` x `counts` ({name: launches}, as `launch_counts` gives
    them) to the wrappers' counts.  A CUDA graph's replay runs no wrapper:
    the engine takes a capture's launches back out of the counts (times
    -1) and adds them again on every replay."""
    fns = wrappers()
    for name, n in counts.items():
        if name == "jacobi_planewise":
            fns["jacobi"].planewise_launches += times * n
        else:
            fns[name].launches += times * n
