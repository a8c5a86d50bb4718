"""The per-frame render dispatch after `simulate` (mirror of
fluidx12_tpu/render/pipeline.py, fast cube-map branch).

Ported: the 2D visualization (every render method and stack, as in the
JAX package), and the fast stack for the two cube-map methods
(RAY_MARCH_SEPARATE and RAY_MARCH_MERGED, which the fast stack renders
identically) with a directional light, with or without the light probe's
GI and sky.  The other branches raise NotImplementedError naming their
ROADMAP.md item rather than running something else.
"""

from __future__ import annotations

from typing import Optional

import torch

from fluidx12_tpu_torch.core.config import FluidConfig, RenderMethod
from fluidx12_tpu_torch.core.state import SceneParams
from fluidx12_tpu_torch.render.lightmap_sweep import render_light_map_fast
from fluidx12_tpu_torch.render.resolve import resolve_cube
from fluidx12_tpu_torch.render.slicecomp import ray_march_cube_fast
from fluidx12_tpu_torch.render.visualize2d import visualize_color_2d
from fluidx12_tpu_torch.utils.image import composite_premultiplied

_OTHER_METHODS = "ROADMAP.md queue A, 'The other render methods'"


def unported_render(config: FluidConfig, method: RenderMethod):
    """The ROADMAP item a render config still needs, or None when the port
    renders it."""
    if not config.is_3d:
        return None
    if not config.fast_render:
        return f"the faithful render stack, fast_render=False ({_OTHER_METHODS})"
    if not method.uses_cube_map:
        return f"the DIRECT render methods ({_OTHER_METHODS})"
    if config.point_light:
        return f"the point-light sweep ({_OTHER_METHODS})"
    return None


def render_frame(grid: torch.Tensor, params: SceneParams, config: FluidConfig,
                 method: RenderMethod, sh_coeffs: Optional[torch.Tensor] = None, *,
                 lod: int = 0, vis_mask=None, rect=None,
                 env_bg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Render one frame of the (4, Z, Y, X) colour grid; returns the
    composited (H, W, 3) image in [0, 1].  `sh_coeffs` (9, 3) lights the
    smoke with the probe (when the config has one); `env_bg` (H, W, 3), the
    sky, replaces the clear colour behind a 3D volume."""
    missing = unported_render(config, method)
    if missing is not None:
        raise NotImplementedError(f"not ported yet: {missing}")
    if not config.is_3d:
        rgba = visualize_color_2d(grid, config)
    else:
        light_map = render_light_map_fast(grid, params, config, sh_coeffs)
        cube = ray_march_cube_fast(grid, params, config, light_map, lod=lod,
                                   static_mask=vis_mask)
        rgba = resolve_cube(cube, params, config, rect=rect)
    if env_bg is not None and config.is_3d:
        bg = env_bg.to(rgba.dtype)
    else:
        bg = torch.tensor(config.clear_color[:3], dtype=rgba.dtype,
                          device=rgba.device).expand(rgba.shape[:-1] + (3,))
    return torch.clamp(composite_premultiplied(rgba, bg), 0.0, 1.0)
