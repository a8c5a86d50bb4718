"""Pressure projection: divergence -> Jacobi / multigrid relaxation ->
gradient subtraction -> boundary damp (mirror of fluidx12_tpu/sim/project.py).

A config with `use_pallas and pallas_jacobi` runs what the JAX package
runs on its TPU, chosen by the same shape gates (ROADMAP.md C5).  In 3D: the
streaming stencils B3 (divergence) and B8 (gradient + damp, in place) where
`stencil_pallas_supported` holds, the multigrid of sim/mg.py with its
kernels, or B4 for all the sweeps where `jacobi_tuning` gives a plan; with
`mg_project_fused`, where `mg_fused_supported` holds, the fused V-cycle
with B18 at both ends in place of B3, the fine smoothers and B8.  The
kernels compute in f32 from the bf16 state.  In 2D: B14 for all the sweeps
where `jacobi2d_pallas_supported` holds, between the bf16 twins.  Where the TPU
stores a 3D grid padded (core/padding.py), the projection follows its
`project_padded` instead: B3, B8 and the multigrid of `mg_solve_padded`
with every gate on the storage dims, on the port's compact state, and
neither B13 nor B18.  Everywhere else the XLA twins
below run, with the dtypes of the JAX code as written: the divergence,
gradient subtract and boundary damp on the storage-dtype (bf16) velocity,
the Poisson solve in f32.  Paths the port has no kernel for yet raise
NotImplementedError naming it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from fluidx12_tpu_torch.core.config import FluidConfig
from fluidx12_tpu_torch.core.padding import storage_zyx
from fluidx12_tpu_torch.ops.cuda import stencil
from fluidx12_tpu_torch.ops.cuda.jacobi import (
    jacobi,
    jacobi2d,
    jacobi2d_pallas_supported,
    jacobi_tuning,
)
from fluidx12_tpu_torch.ops.sampling import neighbor_shift

_AX_Z, _AX_Y, _AX_X = 0, 1, 2


def divergence(velocity: torch.Tensor, is_3d: bool) -> torch.Tensor:
    """Central-difference divergence with edge-clamped neighbours, as f32.

    Every op runs in the velocity's dtype except the last, which runs in
    f32: that is how XLA compiles the JAX package's
    `divergence(fields).astype(float32)` (it drops the final rounding before
    the widening convert), so the port's right-hand side matches it bit for
    bit on bf16 state."""
    ux, uy, uz = velocity[0], velocity[1], velocity[2]
    xy = ((neighbor_shift(ux, _AX_X, +1) - neighbor_shift(ux, _AX_X, -1))
          + (neighbor_shift(uy, _AX_Y, +1) - neighbor_shift(uy, _AX_Y, -1)))
    if not is_3d:
        return 0.5 * xy.to(torch.float32)
    dz = neighbor_shift(uz, _AX_Z, +1) - neighbor_shift(uz, _AX_Z, -1)
    return (0.5 * xy).to(torch.float32) + (0.5 * dz).to(torch.float32)


def jacobi_sweeps(pressure: torch.Tensor, div: torch.Tensor, iters: int,
                  is_3d: bool) -> torch.Tensor:
    """`iters` synchronous Jacobi sweeps of laplace(q) = b."""
    n = 6.0 if is_3d else 4.0
    q = pressure
    for _ in range(iters):
        s = (neighbor_shift(q, _AX_X, +1) + neighbor_shift(q, _AX_X, -1)
             + neighbor_shift(q, _AX_Y, +1) + neighbor_shift(q, _AX_Y, -1))
        if is_3d:
            s = s + neighbor_shift(q, _AX_Z, +1) + neighbor_shift(q, _AX_Z, -1)
        q = (s - div) / n
    return q


def subtract_gradient(velocity: torch.Tensor, pressure: torch.Tensor, rho: float,
                      is_3d: bool) -> torch.Tensor:
    """u -= 0.5 * grad(q) / rho with edge-clamped central differences."""
    dtype = velocity.dtype
    gx = 0.5 * (neighbor_shift(pressure, _AX_X, +1) - neighbor_shift(pressure, _AX_X, -1)) / rho
    gy = 0.5 * (neighbor_shift(pressure, _AX_Y, +1) - neighbor_shift(pressure, _AX_Y, -1)) / rho
    comps = [velocity[0] - gx.to(dtype), velocity[1] - gy.to(dtype)]
    if is_3d:
        gz = 0.5 * (neighbor_shift(pressure, _AX_Z, +1) - neighbor_shift(pressure, _AX_Z, -1)) / rho
        comps.append(velocity[2] - gz.to(dtype))
    else:
        comps.append(velocity[2])
    return torch.stack(comps)


def boundary_damp(velocity: torch.Tensor, config: FluidConfig) -> torch.Tensor:
    """Damp/reflect outward velocities in the 3% wall band
    (CSProject3D.hlsl:104-108), in the velocity's dtype."""
    z, y, x = config.zyx
    dtype = velocity.dtype
    dev = velocity.device

    def axis_pos(n):
        i = torch.arange(n, device=dev).to(dtype)
        return ((i + 0.5) / n) * 2.0 - 1.0

    px = axis_pos(x).reshape(1, 1, x)
    py = axis_pos(y).reshape(1, y, 1)
    pz = axis_pos(z).reshape(z, 1, 1)
    # JAX casts a Python constant to the array's dtype before the op, where
    # torch would apply it in f32: make the bf16 rounding explicit.
    band_hi = torch.tensor(0.97, dtype=dtype, device=dev)
    band = torch.tensor(0.03, dtype=dtype, device=dev)

    def damp(u, p):
        scale = torch.clamp((band_hi - p.abs()) / band, -1.0, 1.0)
        return torch.where(u * p > 0.0, u * scale, u)

    comps = [damp(velocity[0], px), damp(velocity[1], py)]
    comps.append(damp(velocity[2], pz) if config.is_3d else velocity[2])
    return torch.stack(comps)


def project(fields: torch.Tensor, pressure: torch.Tensor, time_step: float,
            config: FluidConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full projection; identity when time_step == 0 (ref ..hlsl:97 guard).
    `time_step` is the host value (the branch needs no device sync).
    Returns (fields', pressure').  Consumes `fields`: where B8 or B18 runs,
    the velocity channels of `fields` are updated in place and `fields`
    itself is returned (fluidx12_tpu/sim/project.py:142-222, the TPU
    branch)."""
    if not float(time_step) > 0.0:
        return fields, pressure
    is_3d = config.is_3d
    rho = config.fluid_density_3d if is_3d else config.fluid_density_2d
    if is_3d and storage_zyx(config) != config.zyx:
        return _project_padded(fields, pressure, config, rho)
    kernels = config.use_pallas and config.pallas_jacobi
    tuning = None
    use_stencil = False
    use_j2d = kernels and not is_3d and jacobi2d_pallas_supported(config.zyx[1:])
    if kernels and is_3d:
        tuning = jacobi_tuning(config.zyx, config.num_pressure_iters)
        use_stencil = stencil.stencil_pallas_supported(config.zyx)
    use_mg = False
    if config.fast_sim and config.mg_pressure and is_3d:
        from fluidx12_tpu_torch.sim.mg import (
            mg_fused_supported,
            mg_project_fused,
            mg_supported,
        )

        z, y, x = config.zyx
        use_mg = y * x >= config.mg_min_plane and mg_supported(config.zyx)
        if (use_mg and use_stencil and config.mg_project_fused
                and mg_fused_supported(config.zyx, vel_bytes=fields.element_size())):
            # B18 (fluidx12_tpu/sim/project.py:171-186): B8's in-place
            # update rides the post-smoother, so `fields` is returned.
            return mg_project_fused(fields, pressure, rho)

    if use_stencil:
        b = stencil.divergence(fields)
    else:
        b = divergence(fields, is_3d)
    if use_j2d:
        q = jacobi2d(pressure[0], b[0], config.num_pressure_iters)[None]
    elif use_mg:
        from fluidx12_tpu_torch.sim.mg import mg_solve

        q = mg_solve(pressure, b, use_pallas=kernels)
    elif tuning is not None:
        q = jacobi(pressure, b, config.num_pressure_iters, *tuning)
    else:
        q = jacobi_sweeps(pressure, b, config.num_pressure_iters, is_3d)
    return _finish(fields, q, rho, use_stencil, config)


def _finish(fields: torch.Tensor, q: torch.Tensor, rho: float, use_stencil: bool,
            config: FluidConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient subtraction and the wall-band damp: B8 in place, or the
    twins."""
    if use_stencil:
        return stencil.grad_damp(fields, q, rho), q
    vel = subtract_gradient(fields, q, rho, config.is_3d)
    vel = boundary_damp(vel, config).to(fields.dtype)
    return torch.cat([vel, fields[3:]]) if fields.shape[0] > 3 else vel, q


def _project_padded(fields: torch.Tensor, pressure: torch.Tensor, config: FluidConfig,
                    rho: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The projection of a 3D grid that the TPU stores padded, as it runs
    `project_padded` (fluidx12_tpu/sim/padded.py:260-300): the stencil
    kernels B3 and B8 where their gate holds on the storage dims, the
    multigrid of `mg_solve_padded` (or the smoother alone below the
    multigrid's plane), all decided by `use_pallas` (that route does not
    read `pallas_jacobi`), never B13 or B18.  On the compact state each
    kernel clamps where the TPU's clamps at the logical extents."""
    from fluidx12_tpu_torch.sim.mg import mg_solve_padded, mg_supported, smooth_padded

    storage = storage_zyx(config)
    z, y, x = config.zyx
    use_stencil = config.use_pallas and stencil.stencil_pallas_supported(storage)
    b = stencil.divergence(fields) if use_stencil else divergence(fields, True)
    if (config.fast_sim and config.mg_pressure and y * x >= config.mg_min_plane
            and mg_supported(config.zyx)):
        q = mg_solve_padded(pressure, b, storage, use_pallas=config.use_pallas)
    else:
        q = smooth_padded(pressure, b, config.num_pressure_iters, storage, config.use_pallas)
    return _finish(fields, q, rho, use_stencil, config)
