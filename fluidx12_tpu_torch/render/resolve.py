"""Screen-space resolve of the ray-marched cube map (mirror of
fluidx12_tpu/render/resolve.py: the plain bilinear CubeCast, without the
depth-aware and 2x2-blocked variants).

Per pixel: unproject to a local-space near-plane point, intersect the eye
ray with the [-1, 1]^3 box's exit face (PSRayCastCube.hlsl:33-59), map the
hit to a face + uv (:64-93), and filter the face bilinearly with
LINEAR_CLAMP at its borders (PSCube.hlsli:41-118).  Output is premultiplied
RGBA, zero where the ray misses the box or the alpha is zero.
"""

from __future__ import annotations

import torch

from fluidx12_tpu_torch.core.config import FluidConfig
from fluidx12_tpu_torch.core.state import SceneParams
from fluidx12_tpu_torch.ops.transform import transform_ndc, transform_point_h


def _texcoord_to_local(params: SceneParams, uv: torch.Tensor) -> torch.Tensor:
    """Screen uv in [0,1] -> local-space point on the near plane."""
    xy = uv * 2.0 - 1.0
    ndc = torch.stack([xy[..., 0], -xy[..., 1]], dim=-1)
    return transform_ndc(ndc, 0.0, params.world_view_proj_i)


def _compute_ray_hit(pos: torch.Tensor, ray_dir: torch.Tensor):
    """Exit-face intersection; returns (hit_pos, hit_plane, is_hit)."""
    u_best = torch.full(pos.shape[:-1], 3.4e38, dtype=pos.dtype, device=pos.device)
    plane = torch.full(pos.shape[:-1], 3, dtype=torch.int32, device=pos.device)
    for i in range(3):
        j, k = (i + 1) % 3, (i + 2) % 3
        u = (torch.sign(ray_dir[..., i]) - pos[..., i]) / ray_dir[..., i]
        ok = u >= 0.0
        ok &= (ray_dir[..., j] * u + pos[..., j]).abs() <= 1.0
        ok &= (ray_dir[..., k] * u + pos[..., k]).abs() <= 1.0
        better = ok & (u < u_best)
        u_best = torch.where(better, u, u_best)
        plane = torch.where(better, torch.full_like(plane, i), plane)
    hit_pos = ray_dir * u_best[..., None] + pos
    return hit_pos, plane, plane < 3


def _cube_texcoord(pos: torch.Tensor, plane: torch.Tensor):
    """Hit position + axis -> (face, u, v), uv in [0,1] with v flipped."""
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
    u = torch.where(plane == 0, -x * z, torch.where(plane == 1, x, z * x))
    v = torch.where(plane == 1, -y * z, y)

    def pick(cond, a, b):
        return torch.where(cond, torch.full_like(plane, a), torch.full_like(plane, b))

    face = torch.where(plane == 0, pick(x < 0, 1, 0),
                       torch.where(plane == 1, pick(y < 0, 3, 2), pick(z < 0, 5, 4)))
    return face, u * 0.5 + 0.5, 1.0 - (v * 0.5 + 0.5)


def bilinear_fetch(faces: torch.Tensor, face, ut: torch.Tensor,
                   vt: torch.Tensor) -> torch.Tensor:
    """Bilinear fetch from (F, H, W, c) images at texel coordinates ut, vt
    (texel centres at integers) of image `face`, with exact LINEAR_CLAMP at
    the borders: the fractions are clipped against the clamped 2x2 origin.
    Images of 64+ texels each way are read through bf16, as the JAX package
    stores its 2x2 record table (resolve.py `_records_2x2`); the filter
    arithmetic is in ut's dtype."""
    _, h, w, c = faces.shape
    texels = faces.to(torch.bfloat16) if min(h, w) >= 64 else faces
    texels = texels.to(ut.dtype).reshape(-1, c)
    u0 = torch.clamp(torch.floor(ut).to(torch.int64), 0, w - 2)
    v0 = torch.clamp(torch.floor(vt).to(torch.int64), 0, h - 2)
    lin = (face * h + v0) * w + u0
    s00 = texels[lin]
    s10 = texels[lin + 1]
    s01 = texels[lin + w]
    s11 = texels[lin + w + 1]
    fu = torch.clamp(ut - u0, 0.0, 1.0)[..., None]
    fv = torch.clamp(vt - v0, 0.0, 1.0)[..., None]
    top = s00 + (s10 - s00) * fu
    bot = s01 + (s11 - s01) * fu
    return top + (bot - top) * fv


def cube_cast(cube: torch.Tensor, face: torch.Tensor, u: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """Bilinear fetch from cube face `face` at uv in [0, 1], with exact
    LINEAR_CLAMP at face borders (`bilinear_fetch`)."""
    size = cube.shape[1]
    return bilinear_fetch(cube, face.to(torch.int64), u * size - 0.5, v * size - 0.5)


def resolve_cube(cube: torch.Tensor, params: SceneParams, config: FluidConfig,
                 rect=None) -> torch.Tensor:
    """(H, W, 4) premultiplied RGBA of the cube map seen from the camera.
    `rect` = (x0, y0, w, h) restricts the work to the volume's screen box;
    pixels outside it are the zero discard either way."""
    h, w = config.viewport[1], config.viewport[0]
    dtype = config.render_dtype
    dev = cube.device
    x0, y0, rw, rh = rect if rect is not None else (0, 0, w, h)
    ju = (x0 + torch.arange(rw, dtype=dtype, device=dev) + 0.5) / w
    jv = (y0 + torch.arange(rh, dtype=dtype, device=dev) + 0.5) / h
    vv, uu = torch.meshgrid(jv, ju, indexing="ij")
    uv = torch.stack([uu, vv], dim=-1)

    pos = _texcoord_to_local(params, uv).to(dtype)
    local_eye = transform_point_h(params.eye_pt, params.world_i)[:3].to(dtype)
    ray_dir = pos - local_eye
    ray_dir = ray_dir / torch.linalg.vector_norm(ray_dir, dim=-1, keepdim=True)

    hit_pos, plane, is_hit = _compute_ray_hit(pos, ray_dir)
    face, u, v = _cube_texcoord(hit_pos, plane)
    face = torch.where(is_hit, face, torch.zeros_like(face))
    rgba = cube_cast(cube.to(dtype), face, u, v)
    rgba = torch.where(is_hit[..., None], rgba, torch.zeros_like(rgba))
    rgba = torch.where(rgba[..., 3:4] > 0.0, rgba, torch.zeros_like(rgba))
    if rect is not None:
        full = torch.zeros((h, w, rgba.shape[-1]), dtype=rgba.dtype, device=dev)
        full[y0:y0 + rh, x0:x0 + rw] = rgba
        rgba = full
    return rgba
