"""Light-space ray marching: per-voxel incident light (mirror of
fluidx12_tpu/render/lightmap.py; ref CSRayMarchL.hlsl).

For every voxel of the light map (the grid's extents): a shadow ray toward
the light, optionally the SH probe's irradiance along the negated density
gradient attenuated by an AO ray, stored as `shadow * lightColor +
ambient` (CSRayMarchL.hlsl:44-79).  Voxels below the density threshold
skip the rays (:43).  The march is kernel R2 on the card
(ops/cuda/raymarch.light_march), `light_map_plain` on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from fluidx12_tpu_torch.core.config import FluidConfig
from fluidx12_tpu_torch.core.state import SceneParams
from fluidx12_tpu_torch.ops.cuda import raymarch as cuda_raymarch
from fluidx12_tpu_torch.ops.sampling import texel_centres, trilinear_sample
from fluidx12_tpu_torch.render import raymarch_core as RC


def light_map_plain(grid: torch.Tensor, env: RC.LightEnv, num_light_samples: torch.Tensor,
                    config: FluidConfig) -> torch.Tensor:
    """Plain version of R2 (fluidx12_tpu/render/lightmap.py:36-108) on the
    render-dtype grid (4, Z, Y, X): (3, Z, Y, X), light colour * shadow +
    ambient per voxel centre."""
    z, y, x = grid.shape[-3:]
    dtype, dev = grid.dtype, grid.device
    # Voxel centres in local space [-1, 1] (CSRayMarchL.hlsl:20-22).
    cz, cy, cx = torch.meshgrid(*(texel_centres(n, dtype, dev) * 2.0 - 1.0 for n in (z, y, x)),
                                indexing="ij")
    pos = torch.stack([cx, cy, cz], dim=-1)
    density = grid[-1:]
    uvw = RC.local_to_tex(pos)
    d_here = trilinear_sample(density, uvw)[0]
    dense = d_here >= config.zero_threshold
    step = RC.step_size(num_light_samples, dtype)
    ones = torch.ones_like(d_here)
    # The rays run only from dense voxels (CSRayMarchL.hlsl:43).
    shadow = RC.cast_light_ray(density, ones, pos, RC.light_direction_at(env, pos), step,
                               config.max_light_samples, num_light_samples, config, dense)
    shadow = torch.where(dense, shadow, ones)
    if env.has_probe:
        irradiance, ao = RC.probe_terms(grid, pos, env, step, config.max_light_samples,
                                        num_light_samples, config, dense)
        ambient = (torch.where(dense[..., None], irradiance, 0.0)
                   * torch.where(dense, ao, ones)[..., None])
    else:
        ambient = env.ambient
    light = env.light_color * shadow[..., None] + ambient
    return light.movedim(-1, 0).contiguous()


def render_light_map(grid: torch.Tensor, params: SceneParams, config: FluidConfig,
                     sh_coeffs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (3, Z, Y, X) light map, in the render dtype, of the (4, Z, Y, X)
    colour grid (any storage dtype): R2 for a CUDA grid, the plain
    version for a CPU grid.  Under autograd R2 runs as an autograd Function
    whose backward is R2b (without the light probe)."""
    env = RC.make_light_env(params, sh_coeffs, config)
    if grid.device.type == "cpu":
        return light_map_plain(grid.to(config.render_dtype), env, params.num_light_samples,
                               config)
    return cuda_raymarch.light_march(grid, RC.pack_env(env), RC.env_flags(env, config),
                                     params.num_light_samples, config).to(config.render_dtype)
