"""Dimensional-split semi-Lagrangian advection of the combined
(7, Z, Y, X) state (mirror of fluidx12_tpu/sim/advect_fast.py).

The port runs the TPU kernels' semantics on every grid: kernel B1 (x then y,
with the x result rounded to storage) and kernel B2 (z, with the forces
epilogue fused on the last sub-step), both clamp-addressed
(ops/cuda/advect.py); B1 hands B2 its result in f32.  The JAX package's
mirror-addressed f32 twin, which it runs on the CPU, is not ported; the
difference is bounded by the golden gates (tests/test_torch_frame.py).
"""

from __future__ import annotations

import torch

from fluidx12_tpu_torch.core.config import FluidConfig
from fluidx12_tpu_torch.ops.cuda.advect import (
    advect_xy,
    advect_z,
    advect_z_forces,
    force_consts,
    forces_table,
)
from fluidx12_tpu_torch.sim.advect import apply_impulse_forces


def advect_fields_fast(fields: torch.Tensor, time_step: torch.Tensor,
                       config: FluidConfig) -> torch.Tensor:
    """Advect + forces of the combined (7, Z, Y, X) state; returns the new
    fields in the storage dtype.  `time_step` is an f32 tensor on the
    fields' device."""
    if not config.is_3d:
        raise NotImplementedError(
            "2D simulation is not ported yet (ROADMAP.md queue A, item 5)")
    n_sub = max(int(config.advect_substeps), 1)
    z, y, x = config.zyx
    dt_full = time_step.to(torch.float32)
    dt = dt_full / n_sub
    # The forces epilogue fuses into B2 for premultiplied colour, as
    # ops/pallas/advect.zpass_forces_supported allows it on the TPU.
    fused = config.pre_multiplied
    table = torch.from_numpy(forces_table(config)).to(fields.device)
    consts = force_consts(config)
    xy_scales = torch.stack([dt * x, dt * y])
    z_scal = torch.stack([dt * z, dt_full])
    both = fields
    for i in range(n_sub):
        both = advect_xy(both, xy_scales)
        if fused and i == n_sub - 1:
            both = advect_z_forces(both, z_scal, table, consts, store=fields.dtype)
        else:
            both = advect_z(both, z_scal, store=fields.dtype)
    if fused:
        return both
    vel, col = apply_impulse_forces(both[:3], both[3:], dt_full, config)
    return torch.cat([vel, col])
