"""Dimensional-split semi-Lagrangian advection of the combined
(7, Z, Y, X) state (mirror of fluidx12_tpu/sim/advect_fast.py).

The port runs the TPU kernels' semantics on every grid, all
clamp-addressed (ops/cuda/advect.py).  In 3D: kernel B1 (x then y, with the
x result rounded to storage) and kernel B2 (z, with the forces epilogue
fused on the last sub-step); B1 hands B2 its result in f32.  With
`advect_fuse_xy=False` the TPU runs x and then y as single-axis kernels,
each rounded to storage (fluidx12_tpu/ops/pallas/advect.py:957-983), and
so does the port: B11 twice, then B2 on the stored result.  In 2D: kernel
B11 on x, then on y, each rounded to storage, as the TPU's
`backtrace_pallas` runs a plane too large for B1 (the 2D preset's 512^2);
B1 rounded to storage gives the same bits on a plane it would take, so the
port takes B11 on every 2D grid.  The forces follow as their own step.
The JAX package's mirror-addressed f32 twin, which it runs on the CPU, is
not ported; the difference is bounded by the golden gates
(tests/test_torch_frame.py).
"""

from __future__ import annotations

import functools

import torch

from fluidx12_tpu_torch.core.config import FluidConfig
from fluidx12_tpu_torch.ops.cuda import advect as _kernels
from fluidx12_tpu_torch.ops.cuda.advect import (
    advect_axis,
    advect_xy,
    advect_z,
    advect_z_forces,
    force_consts,
    forces_table,
)
from fluidx12_tpu_torch.sim.advect import apply_impulse_forces

# The kernels' clamp on a per-axis backtrace displacement, in voxels
# (fluidx12_tpu/sim/advect_fast.py:36).
MAX_DISP = int(_kernels.MAX_DISP)


def max_backtrace_disp(velocity: torch.Tensor, time_step: float,
                       config: FluidConfig) -> torch.Tensor:
    """Largest per-axis, per-substep backtrace displacement in voxels of
    the (3, Z, Y, X) velocity, as an f32 scalar on its device
    (fluidx12_tpu/sim/advect_fast.py:39).  The frame loop's watchdog reads
    it between frames, never inside a captured one, to warn before the
    fast advect's MAX_DISP clamp makes it part ways with the faithful
    one.  The port stores the grid compact, so there is nothing to crop."""
    z, y, x = config.zyx
    n_sub = max(int(config.advect_substeps), 1)
    dt_sub = float(torch.tensor(time_step, dtype=torch.float32) / n_sub)
    dims = (x, y, z) if config.is_3d else (x, y)
    peak = velocity[:len(dims)].abs().float().amax(dim=(1, 2, 3))
    disp = [peak[i] * n for i, n in enumerate(dims)]
    return torch.stack(disp).amax() * dt_sub


@functools.lru_cache(maxsize=None)
def _forces_table_on(config: FluidConfig, device: torch.device) -> torch.Tensor:
    """B2's (7, 5) forces table of `config` on `device`, built and copied
    there once per (config, device) rather than once a step, and kept: a
    captured frame reads it by address.  The kernels only read it."""
    return torch.from_numpy(forces_table(config)).to(device)


def advect_fields_fast(fields: torch.Tensor, time_step: torch.Tensor,
                       config: FluidConfig) -> torch.Tensor:
    """Advect + forces of the combined (7, Z, Y, X) state; returns the new
    fields in the storage dtype.  `time_step` is an f32 tensor on the
    fields' device."""
    n_sub = max(int(config.advect_substeps), 1)
    z, y, x = config.zyx
    dt_full = time_step.to(torch.float32)
    dt = dt_full / n_sub
    both = fields
    if not config.is_3d:
        # No forces epilogue in 2D (zpass_forces_supported needs 3D).
        sx, sy = dt * x, dt * y
        for _ in range(n_sub):
            both = advect_axis(both, sx, axis=2, disp_ch=0)
            both = advect_axis(both, sy, axis=1, disp_ch=1)
    else:
        # The forces epilogue fuses into B2 for premultiplied colour, as
        # ops/pallas/advect.zpass_forces_supported allows it on the TPU.
        table = _forces_table_on(config, fields.device)
        consts = force_consts(config)
        xy_scales = torch.stack([dt * x, dt * y])
        z_scal = torch.stack([dt * z, dt_full])
        for i in range(n_sub):
            if config.advect_fuse_xy:
                both = advect_xy(both, xy_scales)
            else:
                both = advect_axis(both, xy_scales[0], axis=2, disp_ch=0)
                both = advect_axis(both, xy_scales[1], axis=1, disp_ch=1).float()
            if config.pre_multiplied and i == n_sub - 1:
                return advect_z_forces(both, z_scal, table, consts, store=fields.dtype)
            both = advect_z(both, z_scal, store=fields.dtype)
    vel, col = apply_impulse_forces(both[:3], both[3:], dt_full, config)
    return torch.cat([vel, col])
