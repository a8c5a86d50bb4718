"""The sharded render: a march per slab and transmittance composition
across ranks (mirror of fluidx12_tpu/parallel/render.py).

- The light map and its GI are fully decomposed (parallel/light.py).
- The Z faces (+Z, -Z) march along Z, so each rank composites its own
  block of slices and returns a partial image and the block's
  transmittance; one all_gather of the (R, R, 5) partials and the OVER
  operator in the march's order complete the face.
- The X and Y faces march laterally, but their first resample contracts
  over Z: each rank contracts its rows of the weights, and one
  all_reduce of the (4, n_s, R, lat) partial product completes the
  resample; the rest runs replicated.

Every rank ends with the whole cube and resolves the frame.  Where the
slabs do not align with the march's slice groups, the JAX package gathers
the volume and marches faces round-robin (`_gathered_render_frame`), and
so does the port.  Plain torch: the marches take the einsum + cumprod
chain of render/slicecomp.py.
"""

from __future__ import annotations

from typing import Optional

import torch

from fluidx12_tpu_torch.core.config import FluidConfig
from fluidx12_tpu_torch.core.state import SceneParams
from fluidx12_tpu_torch.ops.transform import transform_point_h
from fluidx12_tpu_torch.parallel.domain import gather_z
from fluidx12_tpu_torch.parallel.light import sharded_light_map, sharded_light_supported
from fluidx12_tpu_torch.parallel.mesh import GridMesh
from fluidx12_tpu_torch.render.lightmap_sweep import render_light_map_fast
from fluidx12_tpu_torch.render.resolve import resolve_cube
from fluidx12_tpu_torch.render.slicecomp import (  # _pool_matrix: parallel/render.py:50
    _FACES,
    _axis_volume,
    _march_face,
    _march_face_einsum,
    _pool_matrix,
    mxu16,
    mxu_einsum,
)
from fluidx12_tpu_torch.utils.image import quantize_unorm8


def slice_parallel_render_supported(config: FluidConfig, n_dev: int) -> bool:
    """The Z faces march slab by slab only where the slabs align with the
    pooled slice groups (parallel/render.py:57-65)."""
    z = config.grid_size[2]
    if z % n_dev:
        return False
    stride = max(-(-z // max(config.max_ray_samples, 1)), 1)
    zl = z // n_dev
    return not (zl % stride or zl < stride)


def _strides(config: FluidConfig):
    cap = max(config.max_ray_samples, 1)
    return {a: max(-(-config.grid_size[a] // cap), 1) for a in range(3)}


def _visible(params: SceneParams, device) -> torch.Tensor:
    face_ids = torch.arange(6, dtype=torch.int32, device=device)
    return ((params.visibility_mask >> face_ids) & 1) > 0


def _render_local(grid_local: torch.Tensor, params: SceneParams, config: FluidConfig,
                  sh_coeffs, mesh: GridMesh, light_sharded: bool) -> torch.Tensor:
    """The per-rank render body (parallel/render.py:68-146): the light map,
    the slice-parallel or row-split march of each face, the cube's u8
    rounding and the resolve; (H, W, 4) premultiplied, the same on every
    rank of the mesh."""
    n, idx = mesh.size, mesh.index
    dev = grid_local.device
    dtype = config.render_dtype
    mx = mxu16(dev)
    zl = grid_local.shape[1]
    x, y, z = config.grid_size
    sizes = (x, y, z)
    strides = _strides(config)
    local_eye = transform_point_h(params.eye_pt, params.world_i)[:3].to(dtype)
    if light_sharded:
        light_local = sharded_light_map(grid_local, params, config, mesh, sh_coeffs)
    else:
        # Shapes the sweep cannot decompose: gather the density and sweep
        # the whole volume on every rank.
        dens_full = gather_z(grid_local[3:4].to(mx), mesh, 1)
        full = torch.cat([torch.zeros((3,) + tuple(dens_full.shape[1:]), dtype=dtype,
                                      device=dev), dens_full.to(dtype)])
        light_local = render_light_map_fast(full, params, config, sh_coeffs).narrow(
            1, idx * zl, zl)
    vol = torch.cat([grid_local[3:4].to(dtype),
                     grid_local[:3].to(dtype) * light_local.to(dtype)]).to(mx)
    visible = _visible(params, dev)
    faces = []
    for f in range(6):
        axis, sign = _FACES[f][0], _FACES[f][1]
        stride = strides[axis]
        if axis == 2:
            # My block of slices, composed front to back across the ranks.
            n_sl = zl // stride
            volf = mxu_einsum("czyx,zm->cmyx", vol, _pool_matrix(zl, n_sl, stride, dev)).to(mx)
            part, t_tot = _march_face_einsum(f, volf, local_eye, params.num_samples, config,
                                             dtype, slice_start=idx * n_sl, partial=True)
            parts = mesh.all_gather(torch.cat([part, t_tot[..., None]], dim=-1))
            face = torch.zeros_like(part)
            transm = torch.ones_like(t_tot)
            for i in (range(n) if sign > 0 else range(n - 1, -1, -1)):
                face = face + transm[..., None] * parts[i, ..., :4]
                transm = transm * parts[i, ..., 4]
        else:
            # Pool the (whole) lateral march axis; my z rows of the first
            # resample, all-reduced.
            n_m = sizes[axis]
            n_sl = n_m // stride
            eq = {1: "czyx,ym->cmzx", 0: "czyx,xm->cmzy"}[axis]
            volf = mxu_einsum(eq, vol, _pool_matrix(n_m, n_sl, stride, dev)).to(mx)
            face = _march_face_einsum(f, volf, local_eye, params.num_samples, config, dtype,
                                      row_start=idx * zl, psum_axis=mesh)
        faces.append(torch.where(visible[f], face, torch.zeros_like(face)))
    cube = torch.stack(faces)
    if config.quantize_cube_map:
        cube = quantize_unorm8(cube)
    return resolve_cube(cube, params, config)


def sharded_render_frame(grid_local: torch.Tensor, params: SceneParams, config: FluidConfig,
                         mesh: GridMesh, sh_coeffs: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """The (H, W, 4) premultiplied frame of a Z-sharded (4, zl, Y, X)
    colour grid (parallel/render.py:149-182); every rank of the mesh calls
    it with its slab and gets the whole frame."""
    if not slice_parallel_render_supported(config, mesh.size):
        return _gathered_render_frame(grid_local, params, config, mesh, sh_coeffs)
    return _render_local(grid_local, params, config, sh_coeffs, mesh,
                         sharded_light_supported(config, mesh.size))


def _gathered_render_frame(grid_local: torch.Tensor, params: SceneParams,
                           config: FluidConfig, mesh: GridMesh,
                           sh_coeffs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX package's route where the slabs do not align with the slice
    groups (parallel/render.py:185-222): gather the volume, march face f
    on rank f mod n, all-reduce the cube, resolve."""
    grid_full = gather_z(grid_local, mesh, 1)
    light_map = render_light_map_fast(grid_full, params, config, sh_coeffs)
    dtype = config.render_dtype
    local_eye = transform_point_h(params.eye_pt, params.world_i)[:3].to(dtype)
    vol = torch.cat([grid_full[3:4].to(dtype), grid_full[:3].to(dtype) * light_map.to(dtype)])
    visible = _visible(params, grid_local.device)
    volaxes = {axis: _axis_volume(vol, axis, config) for axis in (0, 1, 2)}
    faces = []
    for f in range(6):
        face = _march_face(f, volaxes[_FACES[f][0]], local_eye, params.num_samples, config,
                           dtype)
        mine = torch.logical_and(visible[f], torch.tensor(f % mesh.size == mesh.index,
                                                          device=face.device))
        faces.append(torch.where(mine, face, torch.zeros_like(face)))
    cube = mesh.psum(torch.stack(faces).float().contiguous())
    if config.quantize_cube_map:
        cube = quantize_unorm8(cube)
    return resolve_cube(cube, params, config)
