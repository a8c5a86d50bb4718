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

With `use_pallas=False` or `pallas_advect=False` the JAX package runs its
XLA twin instead, and so does the port, in plain torch and in f32 whatever
the storage dtype (fluidx12_tpu/sim/advect_fast.py:170-173): each 1D pass
is a dense weighted sum of shifted copies, `_advect_1d` with mirror
('symmetric') addressing at the walls, the reference's LINEAR_MIRROR
sampler.  On a grid the TPU stores padded (core/padding.padded_zyx, which
the JAX package applies on every backend) it runs the clamped twin,
`_advect_1d_clamped`, against the logical extents; the port stores that
grid compact and runs the same clamp there, which on the logical cells
gives the padded twin's values.  The twins hand f32 to the projection, and
the step rounds once at its end.
"""

from __future__ import annotations

import functools

import torch

from fluidx12_tpu_torch.core.config import FluidConfig
from fluidx12_tpu_torch.core.padding import padded_zyx
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


def _mirror_index(n: int, offset: int, device) -> torch.Tensor:
    """Indices i + offset for i < n, mirrored at both walls with the edge
    repeated (numpy's 'symmetric' pad, periodic for offsets beyond n)."""
    m = torch.remainder(torch.arange(n, device=device) + offset, 2 * n)
    return torch.where(m >= n, 2 * n - 1 - m, m)


def _shift_axis(field: torch.Tensor, axis: int, offset: int) -> torch.Tensor:
    """field shifted so out[i] = field[i + offset], mirror-padded at the
    edges (advect_fast.py:64-77; torch's pad has no 'symmetric' mode)."""
    if offset == 0:
        return field
    return field.index_select(axis, _mirror_index(field.shape[axis], offset, field.device))


def _advect_1d(field: torch.Tensor, disp: torch.Tensor, axis: int) -> torch.Tensor:
    """Resample `field` (C, Z, Y, X) along array `axis` at i + disp, disp
    (Z, Y, X) in voxels clamped to +-MAX_DISP, as the hat-weighted sum of
    the shifted copies (advect_fast.py:80-91)."""
    d = torch.clamp(disp, -float(MAX_DISP), float(MAX_DISP))
    out = torch.zeros_like(field)
    for a in range(-MAX_DISP, MAX_DISP + 2):
        w = torch.clamp_min(1.0 - (d - a).abs(), 0.0)
        out = out + _shift_axis(field, axis, a) * w[None]
    return out


def _advect_1d_clamped(field: torch.Tensor, disp: torch.Tensor, axis: int,
                       n_log: int) -> torch.Tensor:
    """Clamp-addressed resample against the logical extent `n_log` of
    array `axis` (advect_fast.py:94-112): each cell's displacement is
    clamped in bounds, so the taps that `roll` wraps around carry zero
    weight, and cells at or beyond `n_log` copy themselves."""
    shape = [1, 1, 1]
    shape[axis - 1] = disp.shape[axis - 1]
    ids = torch.arange(disp.shape[axis - 1], dtype=torch.float32,
                       device=disp.device).reshape(shape).expand_as(disp)
    d = torch.clamp(disp, -float(MAX_DISP), float(MAX_DISP))
    d = torch.where(ids > n_log - 1.0, torch.zeros_like(d),
                    torch.minimum(torch.maximum(d, -ids), (n_log - 1.0) - ids))
    out = torch.zeros_like(field)
    for a in range(-MAX_DISP, MAX_DISP + 2):
        w = torch.clamp_min(1.0 - (d - a).abs(), 0.0)
        out = out + torch.roll(field, -a, axis) * w[None]
    return out


def _backtrace_split_clamped(both: torch.Tensor, dt: torch.Tensor,
                             config: FluidConfig) -> torch.Tensor:
    """x, y, then z clamped passes of the combined (7, Z, Y, X) f32 field
    (advect_fast.py:115-126): the twin on grids the TPU stores padded."""
    z, y, x = config.zyx
    sampled = _advect_1d_clamped(both, -both[0] * dt * x, axis=3, n_log=x)
    sampled = _advect_1d_clamped(sampled, -sampled[1] * dt * y, axis=2, n_log=y)
    return _advect_1d_clamped(sampled, -sampled[2] * dt * z, axis=1, n_log=z)


def _backtrace_split(both: torch.Tensor, dt: torch.Tensor, config: FluidConfig) -> torch.Tensor:
    """x, y and (3D) z mirror passes of the combined (7, Z, Y, X) f32
    field, each displaced by the velocity the passes before it advected
    (advect_fast.py:129-144)."""
    z, y, x = config.zyx
    sampled = _advect_1d(both, -both[0] * dt * x, axis=3)
    sampled = _advect_1d(sampled, -sampled[1] * dt * y, axis=2)
    if config.is_3d:
        sampled = _advect_1d(sampled, -sampled[2] * dt * z, axis=1)
    return sampled


def advect_fields_twin(fields: torch.Tensor, time_step: torch.Tensor,
                       config: FluidConfig) -> torch.Tensor:
    """The XLA twin of the fast advect (advect_fast.py:147-200 with
    `use_kernel` false): f32 sub-steps of the mirror twin, or of the
    clamped one where the TPU stores the grid padded, then the forces;
    returns the f32 (7, Z, Y, X) fields."""
    n_sub = max(int(config.advect_substeps), 1)
    dt_full = time_step.to(torch.float32)
    backtrace = _backtrace_split_clamped if padded_zyx(config) else _backtrace_split
    both = fields.to(torch.float32)
    for _ in range(n_sub):
        both = backtrace(both, dt_full / n_sub, config)
    vel, col = apply_impulse_forces(both[:3], both[3:], dt_full, config)
    return torch.cat([vel, col])


@functools.lru_cache(maxsize=None)
def _forces_table_on(config: FluidConfig, device: torch.device) -> torch.Tensor:
    """B2's (7, 5) forces table of `config` on `device`, built and copied
    there once per (config, device) rather than once a step, and kept: a
    captured frame reads it by address.  The kernels only read it."""
    return torch.from_numpy(forces_table(config)).to(device)


def advect_fields_fast(fields: torch.Tensor, time_step: torch.Tensor,
                       config: FluidConfig) -> torch.Tensor:
    """Advect + forces of the combined (7, Z, Y, X) state; returns the new
    fields in the storage dtype, or in f32 from the twin, which runs where
    `use_pallas` or `pallas_advect` is off (`advect_fields_twin`).
    `time_step` is an f32 tensor on the fields' device."""
    if not (config.use_pallas and config.pallas_advect):
        return advect_fields_twin(fields, time_step, config)
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
