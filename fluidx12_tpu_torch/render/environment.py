"""The sky background from the radiance cube map (mirror of
fluidx12_tpu/render/environment.py; ref PSEnvironment.hlsl).

Per pixel: unproject the far-plane point through screen_to_world, form the
world-space view ray and sample the cube map along it with the resolve's
bilinear fetch.  The engine renders it once per camera pose.
"""

from __future__ import annotations

import torch

from fluidx12_tpu_torch.core.config import FluidConfig
from fluidx12_tpu_torch.core.state import SceneParams
from fluidx12_tpu_torch.ops.cubemap import direction_to_face_uv
from fluidx12_tpu_torch.ops.transform import transform_ndc
from fluidx12_tpu_torch.render.resolve import cube_cast


def render_environment(radiance: torch.Tensor, params: SceneParams,
                       config: FluidConfig) -> torch.Tensor:
    """radiance (6, S, S, 3) -> background (H, W, 3) of the viewport."""
    h, w = config.viewport[1], config.viewport[0]
    dtype = config.render_dtype
    dev = radiance.device
    ju = (torch.arange(w, dtype=dtype, device=dev) + 0.5) / w
    jv = (torch.arange(h, dtype=dtype, device=dev) + 0.5) / h
    vv, uu = torch.meshgrid(jv, ju, indexing="ij")
    xy = torch.stack([uu * 2.0 - 1.0, -(vv * 2.0 - 1.0)], dim=-1)
    world_pt = transform_ndc(xy, 1.0, params.screen_to_world)
    ray_dir = world_pt - params.eye_pt.to(dtype)
    ray_dir = ray_dir / torch.linalg.vector_norm(ray_dir, dim=-1, keepdim=True)
    face, u, v = direction_to_face_uv(ray_dir)
    return cube_cast(radiance.to(dtype), face, u, v)
