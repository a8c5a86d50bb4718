"""The sharded simulation step: Z-slab domain decomposition with halo
exchange between neighbouring ranks (mirror of
fluidx12_tpu/parallel/domain.py).

The grid splits along Z over a `GridMesh` (parallel/mesh.py): each rank
holds (C, Z / n, Y, X).  Every stencil and sampling pass runs on the local
slab extended by halo planes from its two neighbours, which
`_exchange_z_halo` trades by paired sends and receives (the JAX package's
`ppermute`); the first and last rank repeat their edge plane, the clamp of
the single-device stencils.

- The advect exchanges `ADVECT_HALO` planes once and clamps the backtrace
  to them, then runs the faithful gather advect of sim/advect.py on the
  extended slab.
- The Jacobi solve is halo-depth batched: one exchange of k planes buys k
  local sweeps with the halo recomputed redundantly, so a 64-sweep solve
  takes 8 exchange rounds instead of 64; the multigrid V-cycle takes 6.
- The divergence, gradient and residual exchange one plane.

`GridMesh.exchanges` counts the rounds.  Everything here is plain torch on
the CPU (gloo) and on the card (nccl at world size 1): the JAX package
runs no Pallas kernel on this path either.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from fluidx12_tpu_torch.core.config import FluidConfig
from fluidx12_tpu_torch.core.constants import device_constant
from fluidx12_tpu_torch.core.state import FluidState
from fluidx12_tpu_torch.ops.sampling import AddressMode, neighbor_shift, trilinear_sample
from fluidx12_tpu_torch.parallel.mesh import GridMesh
from fluidx12_tpu_torch.sim.advect import apply_impulse_forces

ADVECT_HALO = 4  # z-slabs exchanged for the semi-Lagrangian backtrace

# Planes exchanged per round of the batched Jacobi sweeps: each round buys
# that many local sweeps (8 rounds per 64-sweep solve).
_SWEEP_HALO = 8


def slab_of(full, mesh: GridMesh, axis: int) -> torch.Tensor:
    """This rank's slab of a full array (numpy or torch) along the Z
    `axis`, on the mesh's device."""
    t = torch.as_tensor(np.asarray(full) if not isinstance(full, torch.Tensor) else full)
    n = t.shape[axis]
    if n % mesh.size:
        raise ValueError(f"z = {n} does not split over {mesh.size} ranks")
    zl = n // mesh.size
    return t.narrow(axis, mesh.index * zl, zl).to(mesh.device).contiguous()


def shard_state(state: FluidState, mesh: GridMesh, config: FluidConfig = None) -> FluidState:
    """This rank's Z-slab of a full state (torch tensors or numpy arrays,
    fields (7, Z, Y, X), pressure (Z, Y, X)), on the mesh's device.  With
    `config`, a state in the TPU's padded storage layout (a checkpoint of
    the JAX package) is cropped to the logical volume first."""
    fields, pressure = state
    if config is not None:
        z, y, x = config.zyx
        fields, pressure = fields[:, :z, :y, :x], pressure[:z, :y, :x]
    return FluidState(fields=slab_of(fields, mesh, 1), pressure=slab_of(pressure, mesh, 0))


def gather_z(x: torch.Tensor, mesh: GridMesh, axis: int) -> torch.Tensor:
    """The full array of the ranks' slabs along the Z `axis`, on every
    rank (an `all_gather`)."""
    parts = mesh.all_gather(x)
    return torch.cat(list(parts.unbind(0)), dim=axis)


def gather_state(state: FluidState, mesh: GridMesh) -> FluidState:
    """The full state of the ranks' slabs, on every rank."""
    return FluidState(fields=gather_z(state.fields, mesh, 1),
                      pressure=gather_z(state.pressure, mesh, 0))


def _exchange_z_halo(x: torch.Tensor, halo: int, axis: int, mesh: GridMesh) -> torch.Tensor:
    """`x` extended by `halo` planes from both Z neighbours along `axis`
    (parallel/domain.py:59-91): a rank sends its lowest planes down and its
    highest up, and receives the neighbours'; the first and last rank
    repeat their own edge plane instead.  One exchange round."""
    mesh.exchanges += 1
    n, idx, size = mesh.size, mesh.index, x.shape[axis]
    lo_slab = x.narrow(axis, 0, halo).contiguous()
    hi_slab = x.narrow(axis, size - halo, halo).contiguous()
    lower = x.narrow(axis, 0, 1).expand_as(lo_slab) if idx == 0 else torch.empty_like(lo_slab)
    upper = (x.narrow(axis, size - 1, 1).expand_as(hi_slab) if idx == n - 1
             else torch.empty_like(hi_slab))
    ops = []
    # Each pair of neighbours trades one message each way; both post the
    # lower pair's operations first.
    if idx > 0:
        ops += [dist.P2POp(dist.isend, lo_slab, mesh.ranks[idx - 1], mesh.group),
                dist.P2POp(dist.irecv, lower, mesh.ranks[idx - 1], mesh.group)]
    if idx < n - 1:
        ops += [dist.P2POp(dist.irecv, upper, mesh.ranks[idx + 1], mesh.group),
                dist.P2POp(dist.isend, hi_slab, mesh.ranks[idx + 1], mesh.group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([lower, x, upper], dim=axis)


def _global_centres(n: int, offset: int, total: int, device) -> torch.Tensor:
    """(offset + i + 0.5) / total for i < n, f32, divided tensor by tensor
    as ops/sampling.texel_centres divides (so the slab of a rank at offset
    0 gets the single-device centres on every device)."""
    i = offset + torch.arange(n, dtype=torch.float32, device=device)
    return torch.div(i + 0.5, device_constant(float(total), torch.float32, device))


def _sharded_advect(velocity: torch.Tensor, color: torch.Tensor, time_step: torch.Tensor,
                    config: FluidConfig, mesh: GridMesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gather advect of a slab (parallel/domain.py:94-149): f32 velocity
    (3, zl, Y, X) and colour (4, zl, Y, X) backtraced in global simulation
    space and sampled, MIRROR-addressed, from the slab extended by
    `ADVECT_HALO` planes, the backtrace's z clamped to them; then the
    single-device impulse, forces and dissipation (sim/advect.py) at the
    slab's global voxel centres."""
    f32 = torch.float32
    dev = velocity.device
    dt = time_step.to(device=dev, dtype=f32)
    zg, yg, xg = config.zyx
    zl = velocity.shape[1]
    h = min(ADVECT_HALO, zl)
    z0 = mesh.index * zl

    ext = _exchange_z_halo(torch.cat([velocity, color]), h, 1, mesh)   # (7, zl + 2h, Y, X)
    cz, cy, cx = torch.meshgrid(_global_centres(zl, z0, zg, dev),
                                _global_centres(yg, 0, yg, dev),
                                _global_centres(xg, 0, xg, dev), indexing="ij")
    pos = torch.stack([cx, cy, cz], dim=-1)
    adv = pos - velocity.movedim(0, -1) * dt
    # The global z texture coordinate in the extended slab's texels,
    # clamped to the exchanged planes.
    local_z = torch.clamp(adv[..., 2] * zg - z0 + h, 0.5, zl + 2 * h - 0.5)
    adv_local = torch.stack([adv[..., 0], adv[..., 1],
                             torch.div(local_z, device_constant(float(zl + 2 * h), f32, dev))],
                            dim=-1)
    sampled = trilinear_sample(ext, adv_local, mode=AddressMode.MIRROR)
    return apply_impulse_forces(sampled[:3], sampled[3:], dt, config, z0)


def _halo_shift_z(q_ext: torch.Tensor, offset: int) -> torch.Tensor:
    """The z neighbour at `offset` of a field extended by one plane a side."""
    return q_ext.narrow(0, 1 + offset, q_ext.shape[0] - 2)


def _lateral_sum(e: torch.Tensor) -> torch.Tensor:
    return (neighbor_shift(e, 2, +1) + neighbor_shift(e, 2, -1)
            + neighbor_shift(e, 1, +1) + neighbor_shift(e, 1, -1))


def _z_fetch(e: torch.Tensor, gz: torch.Tensor, nzg: int):
    """(z-1, z+1) neighbours of an extended block whose planes have global
    ids `gz`, clamped at the global ends (never reading a replicated halo
    there)."""
    zm = torch.cat([e[:1], e[:-1]])
    zp = torch.cat([e[1:], e[-1:]])
    return torch.where(gz == 0, e, zm), torch.where(gz == nzg - 1, e, zp)


def _sharded_sweeps(q: torch.Tensor, div: torch.Tensor, iters: int, is_3d: bool,
                    mesh: GridMesh, halo_depth: int = _SWEEP_HALO) -> torch.Tensor:
    """`iters` Jacobi sweeps, halo-depth batched (parallel/domain.py:167-224):
    a round exchanges k planes, the first also carrying the right-hand
    side, then runs k sweeps on the extended block; a sweep spoils one
    plane inward from the block's edge, so after k sweeps the slab itself
    is exact.  The global-edge clamp rides a mask of global plane ids.  The
    neighbours add in sim/project.jacobi_sweeps' order, so the result is
    that of the single-device sweeps bit for bit."""
    njac = 6.0 if is_3d else 4.0
    if not is_3d:
        for _ in range(iters):
            q = (_lateral_sum(q) - div) / njac
        return q
    zl = q.shape[0]
    k = max(1, min(halo_depth, zl, iters))
    nzg = mesh.size * zl
    gz = (mesh.index * zl - k + torch.arange(zl + 2 * k, device=q.device))[:, None, None]
    ext2 = _exchange_z_halo(torch.stack([q, div]), k, 1, mesh)
    div_ext = ext2[1]

    def run_round(e, m):
        for _ in range(m):
            zm, zp = _z_fetch(e, gz, nzg)
            e = (_lateral_sum(e) + zp + zm - div_ext) / njac
        return e[k:k + zl]

    done = min(k, iters)
    q = run_round(ext2[0], done)
    while done < iters:
        m = min(k, iters - done)
        q = run_round(_exchange_z_halo(q, k, 0, mesh), m)
        done += m
    return q


def _sharded_residual(q: torch.Tensor, div: torch.Tensor, mesh: GridMesh) -> torch.Tensor:
    """r = div - (sum of the 6 neighbours - 6 q), one plane exchanged."""
    q_ext = _exchange_z_halo(q, 1, 0, mesh)
    s = _lateral_sum(q) + _halo_shift_z(q_ext, +1) + _halo_shift_z(q_ext, -1)
    return div - (s - 6.0 * q)


def _sharded_mg(q: torch.Tensor, div: torch.Tensor, mesh: GridMesh, pre=None, post=None,
                coarse_iters=None) -> torch.Tensor:
    """The Z-sharded 2-level V-cycle, twin of sim/mg.mg_solve
    (parallel/domain.py:236-320): the restriction pairs z planes within a
    slab (even local z), the prolongation's z lerp exchanges one coarse
    plane; the pre-smoother and the residual ride one (pre + 1)-deep
    exchange, the coarse sweeps batch 11 a round and the post-smoother
    takes one: 6 rounds a V-cycle."""
    from fluidx12_tpu_torch.sim.mg import (
        MG_COARSE_ITERS,
        MG_POST,
        MG_PRE,
        _mat,
        _prolong_matrix,
        _restrict_matrix,
    )

    pre = MG_PRE if pre is None else pre
    post = MG_POST if post is None else post
    coarse_iters = MG_COARSE_ITERS if coarse_iters is None else coarse_iters
    zl, ny, nx = q.shape

    def restrict(r):
        r = torch.einsum("zyx,xm->zym", r, _mat(_restrict_matrix, nx, r))
        r = torch.einsum("zym,yn->znm", r, _mat(_restrict_matrix, ny, r))
        return r.reshape(zl // 2, 2, ny // 2, nx // 2).mean(dim=1)

    def prolong(e):
        e = torch.einsum("zyx,xm->zym", e, _mat(_prolong_matrix, nx // 2, e))
        e = torch.einsum("zym,yn->znm", e, _mat(_prolong_matrix, ny // 2, e))
        ext = _exchange_z_halo(e, 1, 0, mesh)
        even = 0.25 * ext[:-2] + 0.75 * e
        odd = 0.75 * e + 0.25 * ext[2:]
        return torch.stack([even, odd], dim=1).reshape(zl, ny, nx)

    nzg = mesh.size * zl
    if zl >= pre + 1:
        # With a (pre + 1)-deep halo the extended block keeps one fresh
        # ring after `pre` sweeps: what the residual's z stencil needs.
        k = pre + 1
        gz = (mesh.index * zl - k + torch.arange(zl + 2 * k, device=q.device))[:, None, None]
        ext2 = _exchange_z_halo(torch.stack([q, div]), k, 1, mesh)
        div_ext = ext2[1]
        e = ext2[0]
        for _ in range(pre):
            zm, zp = _z_fetch(e, gz, nzg)
            e = (_lateral_sum(e) + zp + zm - div_ext) / 6.0
        q = e[k:k + zl]
        zm, zp = _z_fetch(e, gz, nzg)
        r = (div_ext - (_lateral_sum(e) + zp + zm - 6.0 * e))[k:k + zl]
    else:
        q = _sharded_sweeps(q, div, pre, True, mesh)
        r = _sharded_residual(q, div, mesh)
    r_c = restrict(r) * 4.0
    e_c = _sharded_sweeps(torch.zeros_like(r_c), r_c, coarse_iters, True, mesh, halo_depth=11)
    q = q + prolong(e_c)
    return _sharded_sweeps(q, div, post, True, mesh, halo_depth=post)


def _sharded_project(velocity: torch.Tensor, pressure: torch.Tensor, time_step: float,
                     config: FluidConfig, mesh: GridMesh):
    """The projection of a slab (parallel/domain.py:323-388): divergence
    with a one-plane halo, the multigrid V-cycle on the grids where the
    single-device step takes it (and an even local z), else the batched
    Jacobi sweeps, then the gradient subtraction and the wall-band damp at
    global coordinates.  Identity when `time_step` is 0 (a host value)."""
    if not float(time_step) > 0.0:
        return velocity, pressure
    from fluidx12_tpu_torch.sim.mg import mg_supported

    is_3d = config.is_3d
    rho = config.fluid_density_3d if is_3d else config.fluid_density_2d
    vel, q = velocity, pressure
    ux, uy = vel[0], vel[1]
    div = 0.5 * ((neighbor_shift(ux, 2, +1) - neighbor_shift(ux, 2, -1))
                 + (neighbor_shift(uy, 1, +1) - neighbor_shift(uy, 1, -1)))
    if is_3d:
        uz_ext = _exchange_z_halo(vel[2], 1, 0, mesh)
        div = div + 0.5 * (_halo_shift_z(uz_ext, +1) - _halo_shift_z(uz_ext, -1))
    div = div.to(torch.float32)

    zl, ny, nx = q.shape
    # The single-device gate on the global dims, plus an even local z for
    # the slab-local restriction.
    use_mg = (config.fast_sim and config.mg_pressure and is_3d
              and ny * nx >= config.mg_min_plane and mg_supported(config.zyx) and zl % 2 == 0)
    if use_mg:
        q = _sharded_mg(q, div, mesh)
    else:
        q = _sharded_sweeps(q, div, config.num_pressure_iters, is_3d, mesh)

    gx = 0.5 * (neighbor_shift(q, 2, +1) - neighbor_shift(q, 2, -1)) / rho
    gy = 0.5 * (neighbor_shift(q, 1, +1) - neighbor_shift(q, 1, -1)) / rho
    comps = [vel[0] - gx.to(vel.dtype), vel[1] - gy.to(vel.dtype), vel[2]]
    if is_3d:
        q_ext = _exchange_z_halo(q, 1, 0, mesh)
        gz = 0.5 * (_halo_shift_z(q_ext, +1) - _halo_shift_z(q_ext, -1)) / rho
        comps[2] = vel[2] - gz.to(vel.dtype)

    # The wall band at global coordinates (CSProject3D.hlsl:104-108).
    zg, yg, xg = config.zyx
    dev, dtype = vel.device, vel.dtype

    def pos(n, offset, total):
        return ((offset + torch.arange(n, device=dev).to(dtype) + 0.5) / total) * 2.0 - 1.0

    def damp(u, p):
        scale = torch.clamp((0.97 - p.abs()) / 0.03, -1.0, 1.0)
        return torch.where(u * p > 0.0, u * scale, u)

    comps[0] = damp(comps[0], pos(xg, 0, xg).reshape(1, 1, xg))
    comps[1] = damp(comps[1], pos(yg, 0, yg).reshape(1, yg, 1))
    if is_3d:
        comps[2] = damp(comps[2], pos(zl, mesh.index * zl, zg).reshape(zl, 1, 1))
    return torch.stack(comps), q


def sharded_step_fields(fields: torch.Tensor, pressure: torch.Tensor, time_step: float,
                        dt: torch.Tensor, config: FluidConfig, mesh: GridMesh):
    """One step of one member's slab, (7, zl, Y, X) fields in the storage
    dtype and (zl, Y, X) pressure: f32 arithmetic, one rounding to the
    storage dtype at the end, as the single-device step."""
    store = fields.dtype
    vel, col = _sharded_advect(fields[:3].float(), fields[3:].float(), dt, config, mesh)
    vel, q = _sharded_project(vel, pressure, time_step, config, mesh)
    return torch.cat([vel, col]).to(store), q


def sharded_simulate(state: FluidState, time_step: float, config: FluidConfig,
                     mesh: GridMesh) -> FluidState:
    """One simulation step of this rank's Z-slab (parallel/domain.py:391-414);
    every rank of the mesh calls it on its own slab (`shard_state`)."""
    dt = torch.tensor(float(time_step), dtype=torch.float32, device=state.fields.device)
    fields, q = sharded_step_fields(state.fields, state.pressure, time_step, dt, config, mesh)
    return FluidState(fields=fields, pressure=q)
