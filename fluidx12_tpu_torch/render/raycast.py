"""Direct screen-space ray marching (mirror of fluidx12_tpu/render/raycast.py;
ref PSRayCast.hlsl / PSRayCastV.hlsl).

The baseline the paper compares its cube-map method against: for every
viewport pixel, unproject to the near plane, clip the eye ray to the volume
box, and march at viewport resolution.  The `V` variant samples the light
map instead of casting per-sample shadow rays.  The march is kernel R1 on
the card (ops/cuda/raymarch.view_march, through
raymarch_core.march_view).  The engine takes this path for a
DIRECT method whose eye is inside the volume (no base plane for the
shear-warp) and on the faithful stack.
"""

from __future__ import annotations

from typing import Optional

import torch

from fluidx12_tpu_torch.core.config import FluidConfig
from fluidx12_tpu_torch.core.constants import device_constant
from fluidx12_tpu_torch.core.state import SceneParams
from fluidx12_tpu_torch.ops.sampling import texel_centres
from fluidx12_tpu_torch.ops.transform import transform_ndc, transform_point_h
from fluidx12_tpu_torch.render.raymarch_core import (
    compute_ray_origin,
    make_light_env,
    march_view,
    norm3,
)


def direct_rays(params: SceneParams, config: FluidConfig, device):
    """The viewport's rays (H, W): (origin, direction, hit), the origin at
    the ray's box entry, or the near-plane point where that lies inside
    the box (PSRayCast.hlsl:52-67)."""
    h, w = config.viewport[1], config.viewport[0]
    dtype = config.render_dtype
    vv, uu = torch.meshgrid(texel_centres(h, dtype, device), texel_centres(w, dtype, device),
                            indexing="ij")
    xy = torch.stack([uu * 2.0 - 1.0, -(vv * 2.0 - 1.0)], dim=-1)
    near_pt = transform_ndc(xy, 0.0, params.world_view_proj_i).to(dtype)
    local_eye = transform_point_h(params.eye_pt, params.world_i)[:3].to(dtype)
    ray_dir = near_pt - local_eye
    ray_dir = ray_dir / norm3(ray_dir)
    origin, hit = compute_ray_origin(near_pt, ray_dir)
    return origin, ray_dir, hit


def ray_cast_direct(grid: torch.Tensor, params: SceneParams, config: FluidConfig,
                    light_map: Optional[torch.Tensor] = None,
                    sh_coeffs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """March the (4, Z, Y, X) colour grid (any storage dtype) to the
    viewport; returns (H, W, 4) premultiplied RGBA.  `light_map` selects
    the separate-light variant, which binds the LOD-clamped sample count
    (Fluid.cpp:968); the merged one binds `max_ray_samples` (Fluid.cpp:943)."""
    dev = grid.device
    origin, ray_dir, hit = direct_rays(params, config, dev)
    num = (params.num_samples if light_map is not None
           else device_constant(config.max_ray_samples, torch.int32, dev))
    t_max = torch.full(origin.shape[:-1], float("inf"), dtype=origin.dtype, device=dev)
    return march_view(grid, origin, ray_dir, t_max, num, make_light_env(params, sh_coeffs, config),
                      config, light_map=light_map, num_light_samples=params.num_light_samples,
                      active=hit)
