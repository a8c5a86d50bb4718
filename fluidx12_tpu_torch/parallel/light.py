"""The Z-sharded light map: the shear sweeps and the GI ambient of
render/lightmap_sweep.py decomposed over Z-slabs (mirror of
fluidx12_tpu/parallel/light.py).

The sweep is pool -> shear -> exclusive cumsum over slices -> unshear ->
unpool, and only the cumsum crosses slices.  So:

- A z-major sweep (and the AO's two z sweeps) keeps its slices in the
  slab: pooling, shear and unshear are local, and the term from the ranks
  nearer the light is the sum of their total sheared optical depths, one
  (W_a, W_b) plane a rank, gathered once (`prefix_fn`).
- An x- or y-major sweep with a lateral slope mixes z rows across ranks:
  the pooled slice stack is resharded from Z-slabs to blocks of whole
  slices by one all-to-all, swept there, and sent back by a second.
- An axis-aligned x or y sweep (four of the AO's six) has no slope, so
  the single-device sweep runs on the slab unchanged.
- A point light outside the volume takes the same two layouts: its slope
  frame depends on global constants only.

The GI ambient decomposes the same way: the restriction is slab-local, the
gradient and the prolongation exchange one plane, and the SH combine is
per voxel.  Plain torch everywhere; the sweeps take the einsum form, as
the JAX package's sharded sweep does (its scan kernel numbers slices by
program id, which only the single-device sweep matches).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from fluidx12_tpu_torch.core.config import FluidConfig
from fluidx12_tpu_torch.core.constants import device_constant
from fluidx12_tpu_torch.core.state import SceneParams
from fluidx12_tpu_torch.ops.cuda.stencil import fallback_normal_dirs, gradient_axis
from fluidx12_tpu_torch.ops.transform import transform_point_h, transform_vector
from fluidx12_tpu_torch.parallel.domain import _exchange_z_halo
from fluidx12_tpu_torch.parallel.mesh import GridMesh
from fluidx12_tpu_torch.render.lightmap_sweep import (
    _AXIS_SWEEPS,
    _ao_levels,
    _lat_pooled_ok,
    _pool2_lat,
    _pool_mats,
    _sweep_pooled,
    _sweep_pooled_point,
    directional_transmittance,
    gi_ambient_from_parts,
    point_sweep_supported,
)
from fluidx12_tpu_torch.render.raymarch_core import MAX_DIST
from fluidx12_tpu_torch.render.slicecomp import mxu_einsum
from fluidx12_tpu_torch.sim.mg import _mat, _prolong_matrix, _restrict


def _axis_ok(n_m: int, zl: int, is_z: bool, n_dev: int, max_slices: int) -> bool:
    """A sweep of `max_slices` along an axis of `n_m` tiles the slabs: a
    z-major sweep's slice groups align with the slab boundaries, a lateral
    one's slice count splits evenly over the ranks."""
    stride = max(-(-n_m // max_slices), 1)
    n_s = n_m // stride
    return (zl % stride == 0) if is_z else (n_s % n_dev == 0)


def sharded_light_supported(config: FluidConfig, n_dev: int) -> bool:
    """The light map decomposes over `n_dev` Z-slabs for this config: the
    main sweep and the AO's z sweeps tile, and every resolution choice of
    the single-device light map (half-lateral shadow pooling, half or
    quarter resolution AO) is reproducible slab by slab
    (parallel/light.py:84-120)."""
    zg, y, x = config.zyx
    if zg % n_dev:
        return False
    if config.point_light and not point_sweep_supported(config):
        return False
    zl = zg // n_dev
    lp = np.asarray(config.light_pos, np.float32)
    major = int(np.argmax(np.abs(lp)))
    ok = _axis_ok((x, y, zg)[major], zl, major == 2, n_dev, 128)
    if not config.point_light:
        arr_axis = {0: 2, 1: 1, 2: 0}[major]
        if _lat_pooled_ok((zg, y, x), arr_axis):
            ok = ok and (arr_axis == 0 or zl % 2 == 0)
    if config.has_light_probe:
        lv = _ao_levels((zg, y, x))
        if lv and not (zl % (1 << lv) == 0 and zl >= (1 << lv)):
            return False
        ok = ok and _axis_ok(zg >> lv, zl >> lv, True, n_dev, 64)
    return ok


def _all_to_all(x: torch.Tensor, mesh: GridMesh) -> torch.Tensor:
    """Block j of `x`'s leading dim to rank j; returns the blocks received,
    stacked in rank order on the leading dim."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh.group)
    return out


def _sharded_sweep(dens_local: torch.Tensor, major_axis: int, flip: bool, max_slices: int,
                   sweep, mesh: GridMesh) -> torch.Tensor:
    """The decomposition shared by the directional and point sweeps
    (parallel/light.py:123-200); `sweep(dens_o, sizes, stride, k_ids,
    prefix_fn, n_s_global)` is the pooled-stack core.  z-major: the slab's
    own slices, the earlier ranks' optical depth from `prefix_fn`.  x or
    y-major: the pooled stack resharded to whole slices and back."""
    n, idx = mesh.size, mesh.index
    dtype = dens_local.dtype
    dev = dens_local.device
    zl, y, x = dens_local.shape
    zg = zl * n
    sizes = (x, y, zg)
    n_m = sizes[major_axis]
    stride = max(-(-n_m // max_slices), 1)
    n_s = n_m // stride

    def prefix_fn(k0, k0_of):
        def fn(slab_sum):
            sums = mesh.all_gather(slab_sum)                       # (n, W_a, W_b)
            mask = torch.tensor([float(k0_of(j) < k0) for j in range(n)], dtype=sums.dtype,
                                device=sums.device)
            return (sums * mask[:, None, None]).sum(dim=0)
        return fn

    if major_axis == 2:
        m_l = zl // stride
        pool, up = _pool_mats(zl, m_l, stride, flip, dev)

        def k0_of(j):
            # Slice 0 is the one nearest the light.
            return (n_s - (j + 1) * m_l) if flip else j * m_l

        dens_o = mxu_einsum("zyx,zm->myx", dens_local, pool).to(dtype)
        k0 = k0_of(idx)
        transm = sweep(dens_o, sizes, stride, k0 + torch.arange(m_l, dtype=torch.float32,
                                                                device=dev),
                       prefix_fn(k0, k0_of), n_s)
        return mxu_einsum("myx,mz->zyx", transm, up).to(dtype)

    m_l = n_s // n
    pool, up = _pool_mats(n_m, n_s, stride, flip, dev)
    eq = {0: "zyx,xm->mzy", 1: "zyx,ym->mzx"}[major_axis]
    dens_o = mxu_einsum(eq, dens_local, pool).to(dtype)                  # (n_s, zl, lat)
    # (n_s, zl, lat) -> (m_l, zg, lat): whole slices, this rank's block.
    got = _all_to_all(dens_o, mesh).reshape(n, m_l, zl, -1)
    dens_o = got.permute(1, 0, 2, 3).reshape(m_l, zg, -1)

    def k0_of(j):
        return j * m_l

    k0 = k0_of(idx)
    transm = sweep(dens_o, sizes, stride, k0 + torch.arange(m_l, dtype=torch.float32,
                                                            device=dev),
                   prefix_fn(k0, k0_of), n_s)
    # (m_l, zg, lat) -> (n_s, zl, lat), then unpool on the slab.
    send = transm.reshape(m_l, n, zl, -1).permute(1, 0, 2, 3)
    transm = _all_to_all(send, mesh).reshape(n_s, zl, -1)
    eq_up = {0: "mzy,mx->zyx", 1: "mzx,my->zyx"}[major_axis]
    return mxu_einsum(eq_up, transm, up).to(dtype)


def sharded_directional_transmittance(dens_local: torch.Tensor, light_dir: torch.Tensor,
                                      major_axis: int, ref_step: torch.Tensor,
                                      absorption: float, flip: bool, mesh: GridMesh,
                                      zero_slope: bool = False,
                                      max_slices: int = 128) -> torch.Tensor:
    """Per-voxel transmittance toward a directional light of this rank's
    (zl, Y, X) density slab (parallel/light.py:203-231)."""
    if major_axis != 2 and zero_slope:
        # An axis-aligned lateral sweep mixes no z: the single-device sweep.
        return directional_transmittance(dens_local, light_dir, major_axis, ref_step,
                                         absorption, flip, max_slices=max_slices,
                                         axis_aligned=True)

    def sweep(dens_o, sizes, stride, k_ids, prefix_fn, n_s_global):
        return _sweep_pooled(dens_o, light_dir, major_axis, sizes, stride, ref_step,
                             absorption, k_ids=k_ids, prefix_fn=prefix_fn, use_pallas=False)

    return _sharded_sweep(dens_local, major_axis, flip, max_slices, sweep, mesh)


def sharded_point_transmittance(dens_local: torch.Tensor, light_local: torch.Tensor,
                                major_axis: int, ref_step: torch.Tensor, absorption: float,
                                flip: bool, mesh: GridMesh,
                                max_slices: int = 128) -> torch.Tensor:
    """Per-voxel transmittance toward a point light outside the volume, of
    this rank's density slab (parallel/light.py:234-258): the projective
    sweep decomposes as the directional one."""

    def sweep(dens_o, sizes, stride, k_ids, prefix_fn, n_s_global):
        return _sweep_pooled_point(dens_o, light_local, major_axis, sizes, stride, ref_step,
                                   absorption, flip, k_ids=k_ids, prefix_fn=prefix_fn,
                                   n_s_global=n_s_global)

    return _sharded_sweep(dens_local, major_axis, flip, max_slices, sweep, mesh)


def _exchange_plane(f: torch.Tensor, mesh: GridMesh, axis: int = 0):
    """(lower, upper) one-plane z neighbours of a slab, the edge plane
    repeated at the global ends."""
    ext = _exchange_z_halo(f, 1, axis, mesh)
    return ext.narrow(axis, 0, 1), ext.narrow(axis, ext.shape[axis] - 1, 1)


def _sharded_gradient(f: torch.Tensor, mesh: GridMesh):
    """(gz, gy, gx) of a slab as jnp.gradient computes them on the whole
    volume: central differences, one-sided at the global z ends."""
    zl = f.shape[0]
    gy = gradient_axis(f, 1)
    gx = gradient_axis(f, 2)
    lo, hi = _exchange_plane(f, mesh)
    gz = 0.5 * (torch.cat([f[1:], hi]) - torch.cat([lo, f[:-1]]))
    gids = torch.arange(zl, device=f.device)[:, None, None] + mesh.index * zl
    edge = (gids == 0) | (gids == mesh.size * zl - 1)
    return torch.where(edge, 2.0 * gz, gz), gy, gx


def _sharded_restrict(f: torch.Tensor) -> torch.Tensor:
    """The 2x box restriction of a slab (z pairs stay in it; even local z)."""
    return _restrict(f)


def _z_lerp2(vol: torch.Tensor, mesh: GridMesh) -> torch.Tensor:
    """The cell-centred 2x lerp along z of a slab, its two outer planes'
    neighbours from the adjacent ranks."""
    lo, hi = _exchange_plane(vol, mesh)
    even = 0.25 * torch.cat([lo, vol[:-1]]) + 0.75 * vol
    odd = 0.75 * vol + 0.25 * torch.cat([vol[1:], hi])
    return torch.stack([even, odd], dim=1).reshape(2 * vol.shape[0], *vol.shape[1:])


def _sharded_prolong(e: torch.Tensor, mesh: GridMesh) -> torch.Tensor:
    """The 2x trilinear prolongation of a slab (sim/mg._prolong's)."""
    e = torch.einsum("zyx,xm->zym", e, _mat(_prolong_matrix, e.shape[2], e))
    e = torch.einsum("zym,yn->znm", e, _mat(_prolong_matrix, e.shape[1], e))
    return _z_lerp2(e, mesh)


def _sharded_unpool2_lat(vol: torch.Tensor, arr_axis: int, mesh: GridMesh) -> torch.Tensor:
    """lightmap_sweep._unpool2_lat of a slab: the x and y upsamples are
    local, the z lerp (x- or y-major) clamps only at the global ends."""
    if arr_axis != 2:
        vol = torch.einsum("zyx,xm->zym", vol, _mat(_prolong_matrix, vol.shape[2], vol))
    if arr_axis != 1:
        vol = torch.einsum("zyx,ym->zmx", vol, _mat(_prolong_matrix, vol.shape[1], vol))
    if arr_axis != 0:
        vol = _z_lerp2(vol, mesh)
    return vol


def _sharded_ambient_occlusion(density: torch.Tensor, nx_, ny_, nz_, ref_step: torch.Tensor,
                               config: FluidConfig, mesh: GridMesh) -> torch.Tensor:
    """lightmap_sweep._ambient_occlusion of a slab (parallel/light.py:342-385):
    six axis sweeps blended by the gradient direction, at the resolution
    the single-device light map picks."""
    dtype = density.dtype
    zl, y, x = density.shape
    zg = zl * mesh.size
    levels = _ao_levels((zg, y, x))
    if levels and not (zl % (1 << levels) == 0 and zl >= (1 << levels)):
        levels = 0  # sharded_light_supported rejects this case
    if levels:
        dens_s = density.float()
        for _ in range(levels):
            dens_s = _sharded_restrict(dens_s)
        dens_s = dens_s.to(dtype)
        gz, gy, gx = _sharded_gradient(dens_s, mesh)
        cx, cy, cz = fallback_normal_dirs(gx, gy, gz, z0=mesh.index * (zl >> levels),
                                          zg=zg >> levels)
    else:
        dens_s = density
        cx, cy, cz = nx_, ny_, nz_
    sweeps = []
    for ax, sgn in _AXIS_SWEEPS:
        d6 = device_constant(tuple(float(sgn) if i == ax else 0.0 for i in range(3)),
                             dtype, density.device)
        sweeps.append(sharded_directional_transmittance(
            dens_s, d6, ax, ref_step, config.absorption, sgn > 0, mesh, zero_slope=True,
            max_slices=64))
    comp = [torch.clamp_min(cx, 0.0), torch.clamp_min(-cx, 0.0),
            torch.clamp_min(cy, 0.0), torch.clamp_min(-cy, 0.0),
            torch.clamp_min(cz, 0.0), torch.clamp_min(-cz, 0.0)]
    total = torch.clamp_min(sum(comp), 1e-8)
    ao = sum(s * c for s, c in zip(sweeps, comp)) / total
    if levels:
        ao = ao.float()
        for _ in range(levels):
            ao = _sharded_prolong(ao, mesh)
        ao = ao.to(dtype)
    return ao


def sharded_light_map(grid_local: torch.Tensor, params: SceneParams, config: FluidConfig,
                      mesh: GridMesh, sh_coeffs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """render_light_map_fast of this rank's (4, zl, Y, X) colour slab
    (parallel/light.py:388-455): its (3, zl, Y, X) light-map slab.  Every
    rank of the mesh calls it."""
    dtype = config.render_dtype
    density = grid_local[3].to(dtype)
    zl = density.shape[0]
    zg = zl * mesh.size
    lp = np.asarray(config.light_pos, np.float32)
    major_axis = int(np.argmax(np.abs(lp)))
    flip = bool(lp[major_axis] > 0)
    ref_step = MAX_DIST / params.num_light_samples.to(dtype)
    if config.point_light:
        light_local = transform_point_h(params.light_pt, params.world_i)[:3].to(dtype)
        shadow = sharded_point_transmittance(density, light_local, major_axis, ref_step,
                                             config.absorption, flip, mesh)
    else:
        local_light = transform_vector(params.light_pt, params.world_i)
        light_dir = (local_light / torch.linalg.vector_norm(local_light)).to(dtype)
        arr_axis = {0: 2, 1: 1, 2: 0}[major_axis]
        if (_lat_pooled_ok((zg,) + tuple(density.shape[1:]), arr_axis)
                and (arr_axis == 0 or zl % 2 == 0)):
            # The single-device half-lateral sweep of big grids: the pool is
            # slab-local, the unpool's z lerp crosses the seams.
            shadow = _sharded_unpool2_lat(sharded_directional_transmittance(
                _pool2_lat(density, arr_axis), light_dir, major_axis, ref_step,
                config.absorption, flip, mesh), arr_axis, mesh)
        else:
            shadow = sharded_directional_transmittance(density, light_dir, major_axis,
                                                       ref_step, config.absorption, flip,
                                                       mesh)
    env3 = params.light_color[:3] * params.light_color[3]
    dense = density >= config.zero_threshold
    shadow = torch.where(dense, shadow, torch.ones_like(shadow))
    if config.has_light_probe and sh_coeffs is not None:
        gz, gy, gx = _sharded_gradient(density, mesh)
        nx_, ny_, nz_ = fallback_normal_dirs(gx, gy, gz, z0=mesh.index * zl, zg=zg)
        ao = _sharded_ambient_occlusion(density, nx_, ny_, nz_, ref_step, config, mesh)
        ambient = gi_ambient_from_parts(dense, nx_, ny_, nz_, ao, sh_coeffs,
                                        params.world[:3, :3])
    else:
        ambient = (params.ambient[:3] * params.ambient[3])[:, None, None, None]
    return (env3[:, None, None, None] * shadow[None] + ambient).to(dtype)
