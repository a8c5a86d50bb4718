"""Cube-map-space view ray marching, the paper's core pass, faithful form
(mirror of fluidx12_tpu/render/cubemap.py; ref CSRayMarch.hlsl).

For every texel of every cube-map face (at the LOD's resolution), march
from the eye ray's box entry toward that texel's position on the box
surface, accumulating premultiplied in-scattered radiance front to back,
lit by the light map (`_LIGHT_PASS_`, CSRayMarchV.hlsl) or per sample
(merged).  All 6 R^2 rays march in one launch of kernel R1 on the card
(ops/cuda/raymarch.view_march, through
raymarch_core.march_view); faces that are not visible (the config's
host mask, or the in-graph eye-side test under FaceCullMode.NONE) are
masked off and written as zeros.
"""

from __future__ import annotations

from typing import Optional

import torch

from fluidx12_tpu_torch.core.config import FaceCullMode, FluidConfig
from fluidx12_tpu_torch.core.state import SceneParams
from fluidx12_tpu_torch.ops.cubemap import face_texel_local_positions
from fluidx12_tpu_torch.ops.transform import transform_point_h
from fluidx12_tpu_torch.render.raymarch_core import (
    compute_ray_origin,
    compute_target_hit,
    face_visibility_in_graph,
    make_light_env,
    march_view,
    norm3,
)
from fluidx12_tpu_torch.utils.image import quantize_unorm8


def cube_rays(params: SceneParams, config: FluidConfig, lod: int, device):
    """The cube map's texel rays (6, R, R), R = cube_map_size >> lod:
    (origin at the box entry, direction, t_max at the texel's face, active:
    hit and on a visible face)."""
    size = max(config.cube_map_size >> lod, 1)
    dtype = config.render_dtype
    # The local-space eye (CSRayMarch.hlsl:104: mul(eyePt, worldI)).
    local_eye = transform_point_h(params.eye_pt, params.world_i)[:3].to(dtype)
    targets = face_texel_local_positions(size, dtype, device)
    ray_dir = targets - local_eye
    ray_dir = ray_dir / norm3(ray_dir)
    origin, hit = compute_ray_origin(local_eye.expand(targets.shape), ray_dir)
    t_max = compute_target_hit(origin, targets, ray_dir)
    # Face visibility: the host mask's bit (cull modes 1 and 2) or the
    # in-graph eye-side test (mode 0); CSRayMarch.hlsl:100-112.
    if config.face_cull == FaceCullMode.NONE:
        visible = face_visibility_in_graph(local_eye)
    else:
        face_ids = torch.arange(6, dtype=torch.int32, device=device)
        visible = ((params.visibility_mask >> face_ids) & 1) > 0
    return origin, ray_dir, t_max, hit & visible[:, None, None]


def ray_march_cube(grid: torch.Tensor, params: SceneParams, config: FluidConfig,
                   lod: int = 0, light_map: Optional[torch.Tensor] = None,
                   sh_coeffs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """March the (4, Z, Y, X) colour grid (any storage dtype) into a
    (6, R, R, 4) cube map, R = cube_map_size >> lod."""
    origin, ray_dir, t_max, active = cube_rays(params, config, lod, grid.device)
    scatter = march_view(grid, origin, ray_dir, t_max, params.num_samples,
                         make_light_env(params, sh_coeffs, config), config, light_map=light_map,
                         num_light_samples=params.num_light_samples, active=active)
    if config.quantize_cube_map:
        scatter = quantize_unorm8(scatter)
    return scatter
