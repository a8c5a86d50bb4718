"""The fast DIRECT screen-space methods: a perspective shear-warp (mirror of
fluidx12_tpu/render/screencomp.py).

1. **Shear + composite.**  The base plane is the volume face the view rays
   exit through along the dominant eye axis.  For rays from the eye to that
   plane's texels, each axis slice is cut in a scale + translate of the
   plane grid, so the march is the cube face's (render/slicecomp.py), run
   once on an enlarged plane: extents past 1 cover the rays that exit
   through side faces, and lateral texels outside the volume get zero
   weight (B10's zero_outside mode, or the zero-outside resample before
   B17, by the TPU's gate, `slicecomp.plane_kernel`).
2. **Warp.**  Per pixel, the eye ray's hit on the base plane maps the
   composited plane image to the screen by one bilinear fetch.

The plane's geometry (face, extents, texels) is host math per camera pose
(`direct_plane_spec`, an own copy of the JAX package's); an eye inside the
volume has none, and render/pipeline.py raises for it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from fluidx12_tpu_torch.core import math3d as m3
from fluidx12_tpu_torch.core.camera import OrbitCamera
from fluidx12_tpu_torch.core.config import FluidConfig
from fluidx12_tpu_torch.core.state import SceneParams
from fluidx12_tpu_torch.ops.transform import transform_point_h
from fluidx12_tpu_torch.render.resolve import (
    _compute_ray_hit,
    _texcoord_to_local,
    bilinear_fetch,
)
from fluidx12_tpu_torch.render.slicecomp import (
    _FACES,
    _axis_volume,
    _march_face,
    mxu16,
    plane_kernel,
    sample_face_inputs,
)


class DirectPlaneSpec(NamedTuple):
    """Base-plane geometry for one camera pose."""

    face_id: int                    # 0..5, the exit face marched as the base plane
    extent: tuple                   # (Lu, Lv) lateral half-extents (>= 1.0)
    res: tuple                      # (Ru, Rv) plane texels


# Plane texels per dimension: at least 256, at most 1024.
_RES_MIN, _RES_MAX = 256, 1024


def direct_plane_spec(local_eye: np.ndarray, wvp: np.ndarray, viewport,
                      config: FluidConfig,
                      density_scale: float = 1.0) -> Optional[DirectPlaneSpec]:
    """Host-side plane selection (fluidx12_tpu/render/screencomp.py:63-116);
    None when the eye is inside the volume.  The face is the far face of
    the dominant eye axis; the extents bound the projections of the box's
    8 corners from the eye onto the plane, rounded up to 1/4; the texels
    match the viewport's pixel density at the volume centre times
    `density_scale`, rounded up to a multiple of 128 within [256, 1024]."""
    e = np.asarray(local_eye, np.float64)
    axis = int(np.argmax(np.abs(e)))
    if abs(e[axis]) <= 1.05:
        return None
    sign = -1 if e[axis] > 0 else +1
    face_id = 2 * axis + (0 if sign > 0 else 1)
    _, _, (ua, _), (va, _) = _FACES[face_id]

    corners = np.array([(x, y, z) for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)],
                       np.float64)
    t = (sign - e[axis]) / (corners[:, axis] - e[axis])
    proj = e[None, :] + (corners - e[None, :]) * t[:, None]

    def quant(v):
        return float(np.ceil(max(1.0, v) * 4.0 + 0.02) / 4.0)

    l_u = quant(np.abs(proj[:, ua]).max())
    l_v = quant(np.abs(proj[:, va]).max())

    def to_px(p_local):
        h = wvp.T @ np.array([*p_local, 1.0])
        ndc = h[:2] / max(abs(h[3]), 1e-9)
        return ndc * np.array([viewport[0], viewport[1]]) * 0.5

    du = np.zeros(3)
    du[ua] = 0.2
    px_per_unit = np.linalg.norm(to_px(du) - to_px(np.zeros(3))) / 0.2

    def res_for(extent):
        r = int(px_per_unit * 2.0 * extent * density_scale)
        return min(max(-(-r // 128) * 128, _RES_MIN), _RES_MAX)

    return DirectPlaneSpec(face_id=face_id, extent=(l_u, l_v),
                           res=(res_for(l_u), res_for(l_v)))


def _plane_cast(img: torch.Tensor, ut: torch.Tensor, vt: torch.Tensor) -> torch.Tensor:
    """Bilinear LINEAR_CLAMP fetch from an (Rv, Ru, c) plane image at
    per-pixel texel coordinates (texel centres at integers), through bf16
    where both sides have 64+ texels (screencomp.py:119-145)."""
    return bilinear_fetch(img[None], 0, ut, vt).to(ut.dtype)


def _warp_plane_to_screen(img: torch.Tensor, spec: DirectPlaneSpec, params: SceneParams,
                          config: FluidConfig, rect=None) -> torch.Tensor:
    """(H, W, 4) premultiplied RGBA: per pixel, the local-space eye ray's
    hit on the base plane, fetched from the plane image; zero where the ray
    misses the box, hits the plane behind the eye, or the alpha is zero.
    `rect` = (x0, y0, w, h) restricts the work to the volume's screen box
    (screencomp.py:148-197)."""
    axis, sign, (ua, us), (va, vs) = _FACES[spec.face_id]
    h, w = config.viewport[1], config.viewport[0]
    dtype = config.render_dtype
    dev = img.device
    x0, y0, rw, rh = rect if rect is not None else (0, 0, w, h)
    ju = (x0 + torch.arange(rw, dtype=dtype, device=dev) + 0.5) / w
    jv = (y0 + torch.arange(rh, dtype=dtype, device=dev) + 0.5) / h
    vv, uu = torch.meshgrid(jv, ju, indexing="ij")
    uv = torch.stack([uu, vv], dim=-1)

    pos = _texcoord_to_local(params, uv).to(dtype)
    local_eye = transform_point_h(params.eye_pt, params.world_i)[:3].to(dtype)
    ray_dir = pos - local_eye
    ray_dir = ray_dir / torch.linalg.vector_norm(ray_dir, dim=-1, keepdim=True)
    _, _, is_hit = _compute_ray_hit(pos, ray_dir)

    d_m = ray_dir[..., axis]
    d_safe = torch.where(d_m.abs() < 1e-8, torch.full_like(d_m, 1e-8), d_m)
    t_hit = (float(sign) - local_eye[axis]) / d_safe
    hit = local_eye + ray_dir * t_hit[..., None]
    valid = is_hit & (t_hit > 0.0)

    l_u, l_v = spec.extent
    r_u, r_v = spec.res
    pu = (hit[..., ua] * us) / l_u
    pv = (hit[..., va] * vs) / l_v
    ut = (pu * 0.5 + 0.5) * r_u - 0.5
    vt = (1.0 - (pv * 0.5 + 0.5)) * r_v - 0.5

    rgba = _plane_cast(img.to(dtype), ut, vt)
    rgba = torch.where(valid[..., None], rgba, torch.zeros_like(rgba))
    rgba = torch.where(rgba[..., 3:4] > 0.0, rgba, torch.zeros_like(rgba))
    if rect is not None:
        full = torch.zeros((h, w, rgba.shape[-1]), dtype=rgba.dtype, device=dev)
        full[y0:y0 + rh, x0:x0 + rw] = rgba
        rgba = full
    return rgba


def ray_cast_direct_fast(grid: torch.Tensor, params: SceneParams, config: FluidConfig,
                         light_map: torch.Tensor, spec: DirectPlaneSpec,
                         num_samples: torch.Tensor, rect=None) -> torch.Tensor:
    """(H, W, 4) premultiplied RGBA of the (4, Z, Y, X) colour grid lit by
    `light_map`, by the DIRECT methods' shear-warp (screencomp.py:200-257):
    the base plane's march, then its warp to the screen.  `num_samples` is
    the method's ray-sample count: max_ray_samples for the merged method,
    the LOD-clamped count for the separate one."""
    img = march_direct_plane(grid, params, config, light_map, spec, num_samples)
    return _warp_plane_to_screen(img, spec, params, config, rect=rect)


def march_direct_plane(grid: torch.Tensor, params: SceneParams, config: FluidConfig,
                       light_map: torch.Tensor, spec: DirectPlaneSpec,
                       num_samples: torch.Tensor) -> torch.Tensor:
    """The base plane's (Rv, Ru, 4) premultiplied image: the colour grid
    lit by `light_map`, resampled onto the plane and composited (B10 in its
    zero-outside mode, or B17, `slicecomp.plane_kernel`)."""
    dtype = config.render_dtype
    local_eye = transform_point_h(params.eye_pt, params.world_i)[:3].to(dtype)
    dens = grid[3:4].to(dtype)
    prod = grid[:3].to(dtype) * light_map.to(dtype)
    vol = torch.cat([dens, prod]).to(mxu16(grid.device))
    volf = _axis_volume(vol, _FACES[spec.face_id][0], config, lod=0)
    return _march_face(spec.face_id, volf, local_eye, num_samples, config, dtype, lod=0,
                       b17=plane_kernel(config, spec.face_id, spec.res) == "B17",
                       extent=spec.extent, res=spec.res)


def sample_camera(viewport=(800, 800), orbit=(0.0, 0.0)) -> OrbitCamera:
    """The default camera for `viewport`, turned by `orbit` (the mouse
    delta in pixels of `OrbitCamera.orbit`) where it is not zero."""
    cam = OrbitCamera(width=viewport[0], height=viewport[1])
    if any(orbit):
        cam.orbit(*orbit)
    return cam


def sample_plane_inputs(grid, device, seed: int = 0, viewport=(800, 800), orbit=(0.0, 0.0)):
    """(spec, B10's arguments) for the DIRECT base plane of a smooth lit
    smoke volume on grid `grid` (x, y, z), made from `seed`, as the default
    camera turned by `orbit` (`sample_camera`) sees it at lod 0 in
    `viewport`: the plane march's own shapes and coordinates
    (`slicecomp.sample_face_inputs`), for holding the plane's kernel (B10's
    zero-outside mode, or B17 after `slicecomp.resampled_stack`) against
    its plain version."""
    cfg = FluidConfig(grid_size=grid, viewport=viewport)
    cam = sample_camera(viewport, orbit)
    world = m3.scaling(cfg.volume_scale)
    local_eye = (np.append(np.asarray(cam.eye, np.float64), 1.0) @ m3.inverse(world))[:3]
    spec = direct_plane_spec(local_eye, world @ cam.view_proj, cfg.viewport, cfg)
    return spec, sample_face_inputs(grid, spec.face_id, device, seed, extent=spec.extent,
                                    res=spec.res, camera=cam)
