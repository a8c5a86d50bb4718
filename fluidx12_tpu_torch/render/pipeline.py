"""The per-frame render dispatch after `simulate` (mirror of
fluidx12_tpu/render/pipeline.py).

2D visualizes the colour grid.  In 3D the fast stack runs where
`fast_render` is on and `point_light_ok` holds: the light map of the
directional (B9) or projective point sweep, the cube-map methods by slice
compositing (B10), and the DIRECT methods by the shear-warp of
render/screencomp.py when the engine gives a base plane (`plane_spec`).
Otherwise the faithful per-ray stack runs, exactly where the JAX package
takes it: the light map by render/lightmap.py (kernel R2) for the separate
methods, the cube march of render/cubemap.py or the screen-space march of
render/raycast.py (kernel R1; also a fast-stack DIRECT frame whose eye is
inside the volume, `plane_spec` None).  `use_pallas=False` on the fast
stack runs the JAX package's XLA twins there: the einsum shear sweep and
the einsum + cumprod march (render/lightmap_sweep.py, render/slicecomp.py).
`block_resolve` raises NotImplementedError naming its ROADMAP.md item
rather than running something else.
"""

from __future__ import annotations

from typing import Optional

import torch

from fluidx12_tpu_torch.core.config import FluidConfig, RenderMethod
from fluidx12_tpu_torch.core.constants import device_constant
from fluidx12_tpu_torch.core.state import SceneParams
from fluidx12_tpu_torch.render.cubemap import ray_march_cube
from fluidx12_tpu_torch.render.lightmap import render_light_map
from fluidx12_tpu_torch.render.lightmap_sweep import (
    point_sweep_supported,
    render_light_map_fast,
)
from fluidx12_tpu_torch.render.raycast import ray_cast_direct
from fluidx12_tpu_torch.render.resolve import resolve_cube
from fluidx12_tpu_torch.render.screencomp import ray_cast_direct_fast
from fluidx12_tpu_torch.render.slicecomp import ray_march_cube_fast
from fluidx12_tpu_torch.render.visualize2d import visualize_color_2d
from fluidx12_tpu_torch.utils.image import composite_premultiplied


def point_light_ok(config: FluidConfig) -> bool:
    """Can the fast stack serve this config's light?  A point light needs
    the projective sweep, which needs the light outside the volume
    (pipeline.py:35-45)."""
    return not config.point_light or point_sweep_supported(config)


def unported_render(config: FluidConfig):
    """The ROADMAP item a render config still needs, or None when the port
    renders it."""
    if not config.is_3d:
        return None
    if config.block_resolve:
        return ("cube_cast_blocked, block_resolve=True (ROADMAP.md, 'Do not port'; "
                "queue C, C7)")
    return None


def render_frame(grid: torch.Tensor, params: SceneParams, config: FluidConfig,
                 method: RenderMethod, sh_coeffs: Optional[torch.Tensor] = None, *,
                 lod: int = 0, vis_mask=None, plane_spec=None, rect=None,
                 env_bg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Render one frame of the (4, Z, Y, X) colour grid; returns the
    composited (H, W, 3) image in [0, 1].  `sh_coeffs` (9, 3) lights the
    smoke with the probe (when the config has one); `env_bg` (H, W, 3), the
    sky, replaces the clear colour behind a 3D volume; `plane_spec` is the
    DIRECT methods' base plane (render/screencomp.DirectPlaneSpec), None
    with the eye inside the volume."""
    missing = unported_render(config)
    if missing is not None:
        raise NotImplementedError(f"not ported yet: {missing}")
    if not config.is_3d:
        rgba = visualize_color_2d(grid, config)
    else:
        # pipeline.py:84-121: the fast stack, or the faithful per-ray one.
        fast = config.fast_render and point_light_ok(config)
        fast_direct = fast and not method.uses_cube_map and plane_spec is not None
        light_map = None
        if method.separate_light_pass or (fast and method.uses_cube_map) or fast_direct:
            light_map = (render_light_map_fast(grid, params, config, sh_coeffs) if fast
                         else render_light_map(grid, params, config, sh_coeffs))
        if method.uses_cube_map:
            if fast:
                cube = ray_march_cube_fast(grid, params, config, light_map, lod=lod,
                                           static_mask=vis_mask)
            else:
                cube = ray_march_cube(grid, params, config, lod=lod, light_map=light_map,
                                      sh_coeffs=sh_coeffs)
            rgba = resolve_cube(cube, params, config, rect=rect)
        elif not fast_direct:
            rgba = ray_cast_direct(grid, params, config, light_map=light_map,
                                   sh_coeffs=sh_coeffs)
        else:
            # The merged method binds max_ray_samples (Fluid.cpp:943), the
            # separate one the LOD-clamped count (Fluid.cpp:968).
            num = (params.num_samples if method.separate_light_pass
                   else device_constant(config.max_ray_samples, torch.int32, grid.device))
            rgba = ray_cast_direct_fast(grid, params, config, light_map, plane_spec, num,
                                        rect=rect)
    if env_bg is not None and config.is_3d:
        bg = env_bg.to(rgba.dtype)
    else:
        bg = device_constant(tuple(config.clear_color[:3]), rgba.dtype,
                             rgba.device).expand(rgba.shape[:-1] + (3,))
    return torch.clamp(composite_premultiplied(rgba, bg), 0.0, 1.0)
