"""The per-frame render dispatch after `simulate` (mirror of
fluidx12_tpu/render/pipeline.py, fast cube-map branch).

Ported: the 2D visualization (every render method and stack, as in the
JAX package), and the fast stack for the two cube-map methods
(RAY_MARCH_SEPARATE and RAY_MARCH_MERGED, which the fast stack renders
identically) with a directional light.  The other branches raise
NotImplementedError naming their ROADMAP.md item rather than running
something else.
"""

from __future__ import annotations

import torch

from fluidx12_tpu_torch.core.config import FluidConfig, RenderMethod
from fluidx12_tpu_torch.core.state import SceneParams
from fluidx12_tpu_torch.render.lightmap_sweep import render_light_map_fast
from fluidx12_tpu_torch.render.resolve import resolve_cube
from fluidx12_tpu_torch.render.slicecomp import ray_march_cube_fast
from fluidx12_tpu_torch.render.visualize2d import visualize_color_2d
from fluidx12_tpu_torch.utils.image import composite_premultiplied


def unported_render(config: FluidConfig, method: RenderMethod):
    """The ROADMAP item a render config still needs, or None when the port
    renders it."""
    if not config.is_3d:
        return None
    if not config.fast_render:
        return "the faithful render stack, fast_render=False (ROADMAP.md queue A, item 4)"
    if not method.uses_cube_map:
        return "the DIRECT render methods (ROADMAP.md queue A, item 4)"
    if config.point_light:
        return "the point-light sweep (ROADMAP.md queue A, item 4)"
    if config.has_light_probe:
        return "GI and the light probe (ROADMAP.md queue A, item 6)"
    return None


def render_frame(grid: torch.Tensor, params: SceneParams, config: FluidConfig,
                 method: RenderMethod, *, lod: int = 0, vis_mask=None,
                 rect=None) -> torch.Tensor:
    """Render one frame of the (4, Z, Y, X) colour grid; returns the
    composited (H, W, 3) image in [0, 1]."""
    missing = unported_render(config, method)
    if missing is not None:
        raise NotImplementedError(f"not ported yet: {missing}")
    if not config.is_3d:
        rgba = visualize_color_2d(grid, config)
    else:
        light_map = render_light_map_fast(grid, params, config)
        cube = ray_march_cube_fast(grid, params, config, light_map, lod=lod,
                                   static_mask=vis_mask)
        rgba = resolve_cube(cube, params, config, rect=rect)
    bg = torch.tensor(config.clear_color[:3], dtype=rgba.dtype,
                      device=rgba.device).expand(rgba.shape[:-1] + (3,))
    return torch.clamp(composite_premultiplied(rgba, bg), 0.0, 1.0)
