"""The per-frame render dispatch after `simulate` (mirror of
fluidx12_tpu/render/pipeline.py, fast stack).

Ported: the 2D visualization (every render method and stack, as in the
JAX package), and the fast 3D stack on the kernels (`use_pallas`): the two
cube-map methods (RAY_MARCH_SEPARATE and RAY_MARCH_MERGED, which the fast
stack renders identically) and the two DIRECT methods (the shear-warp of
render/screencomp.py, given the base plane's `plane_spec`), with a
directional light or a point light outside the volume, with or without the
light probe's GI and sky.  The faithful stack, which the JAX package takes
for `fast_render=False`, a point light inside the volume and a DIRECT
frame whose eye is inside the volume, and `block_resolve`, raise
NotImplementedError naming their ROADMAP.md item rather than running
something else.
"""

from __future__ import annotations

from typing import Optional

import torch

from fluidx12_tpu_torch.core.config import FluidConfig, RenderMethod
from fluidx12_tpu_torch.core.constants import device_constant
from fluidx12_tpu_torch.core.state import SceneParams
from fluidx12_tpu_torch.render.lightmap_sweep import (
    point_sweep_supported,
    render_light_map_fast,
)
from fluidx12_tpu_torch.render.resolve import resolve_cube
from fluidx12_tpu_torch.render.screencomp import ray_cast_direct_fast
from fluidx12_tpu_torch.render.slicecomp import ray_march_cube_fast
from fluidx12_tpu_torch.render.visualize2d import visualize_color_2d
from fluidx12_tpu_torch.utils.image import composite_premultiplied

_OTHER_METHODS = "ROADMAP.md queue A, 'The other render methods'"


def point_light_ok(config: FluidConfig) -> bool:
    """Can the fast stack serve this config's light?  A point light needs
    the projective sweep, which needs the light outside the volume
    (pipeline.py:35-45)."""
    return not config.point_light or point_sweep_supported(config)


def unported_render(config: FluidConfig, method: RenderMethod, plane_spec=None):
    """The ROADMAP item a render config still needs, or None when the port
    renders it.  A DIRECT method needs the base plane's `plane_spec`
    (engine `_direct_plane_spec`), which is None with the eye inside the
    volume; `method=None` asks about the config alone."""
    if not config.is_3d:
        return None
    if not config.use_pallas:
        return ("the einsum shear sweep and the einsum + cumprod march, "
                "use_pallas=False (ROADMAP.md queue A, 'The XLA twins')")
    if config.block_resolve:
        return ("cube_cast_blocked, block_resolve=True (ROADMAP.md, 'Do not port'; "
                "queue C, C7)")
    if not config.fast_render:
        return f"the faithful render stack, fast_render=False ({_OTHER_METHODS})"
    if not point_light_ok(config):
        return f"the faithful render stack for a point light inside the volume ({_OTHER_METHODS})"
    if method is not None and not method.uses_cube_map and plane_spec is None:
        return (f"the faithful DIRECT march for an eye inside the volume "
                f"({_OTHER_METHODS})")
    return None


def render_frame(grid: torch.Tensor, params: SceneParams, config: FluidConfig,
                 method: RenderMethod, sh_coeffs: Optional[torch.Tensor] = None, *,
                 lod: int = 0, vis_mask=None, plane_spec=None, rect=None,
                 env_bg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Render one frame of the (4, Z, Y, X) colour grid; returns the
    composited (H, W, 3) image in [0, 1].  `sh_coeffs` (9, 3) lights the
    smoke with the probe (when the config has one); `env_bg` (H, W, 3), the
    sky, replaces the clear colour behind a 3D volume; `plane_spec` is the
    DIRECT methods' base plane (render/screencomp.DirectPlaneSpec)."""
    missing = unported_render(config, method, plane_spec)
    if missing is not None:
        raise NotImplementedError(f"not ported yet: {missing}")
    if not config.is_3d:
        rgba = visualize_color_2d(grid, config)
    else:
        light_map = render_light_map_fast(grid, params, config, sh_coeffs)
        if method.uses_cube_map:
            cube = ray_march_cube_fast(grid, params, config, light_map, lod=lod,
                                       static_mask=vis_mask)
            rgba = resolve_cube(cube, params, config, rect=rect)
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
