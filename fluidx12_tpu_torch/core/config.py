"""Configuration of the PyTorch engine: a field-for-field mirror of
fluidx12_tpu/core/config.py with torch dtypes in place of jnp ones.

The JAX package keeps the field comments (the reference's CLI flags, hotkeys
and shader defines); only what differs in the port is noted here.  Gates that
select TPU kernels (`use_pallas`, `pallas_advect`, `pallas_jacobi`,
`advect_fuse_xy`, `mg_project_fused`, `block_resolve`) keep their names so a
config carries across packages unchanged; the port reads them as described
in fluidx12_tpu_torch/engine/fluidx.py.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import torch


class RenderMethod(enum.IntEnum):
    """The four render methods (ref: FluidX12.cpp:19-29)."""

    RAY_MARCH_MERGED = 0
    RAY_MARCH_SEPARATE = 1
    RAY_MARCH_DIRECT_MERGED = 2
    RAY_MARCH_DIRECT_SEPARATE = 3

    def next(self) -> "RenderMethod":
        return RenderMethod((self + 1) % 4)

    def prev(self) -> "RenderMethod":
        return RenderMethod((self + 3) % 4)

    @property
    def uses_cube_map(self) -> bool:
        return self in (RenderMethod.RAY_MARCH_MERGED, RenderMethod.RAY_MARCH_SEPARATE)

    @property
    def separate_light_pass(self) -> bool:
        return self in (
            RenderMethod.RAY_MARCH_SEPARATE,
            RenderMethod.RAY_MARCH_DIRECT_SEPARATE,
        )


class FaceCullMode(enum.IntEnum):
    """Cube-face culling strategy (ref: SharedConsts.h:5-6)."""

    NONE = 0
    MASK = 1
    LIST = 2


@dataclasses.dataclass(frozen=True)
class FluidConfig:
    """Static configuration; defaults mirror the reference app defaults."""

    grid_size: Tuple[int, int, int] = (128, 128, 128)
    viewport: Tuple[int, int] = (800, 800)
    max_ray_samples: int = 192
    max_light_samples: int = 64
    num_pressure_iters: int = 64
    num_cube_mips: int = 5
    has_light_probe: bool = False
    face_cull: FaceCullMode = FaceCullMode.MASK
    pre_multiplied: bool = True
    point_light: bool = False
    quantize_cube_map: bool = True
    # Storage of the velocity/color state; all arithmetic runs in f32.
    sim_dtype: torch.dtype = torch.bfloat16
    render_dtype: torch.dtype = torch.float32
    use_pallas: bool = True
    pallas_advect: bool = True
    pallas_jacobi: bool = True
    advect_fuse_xy: bool = True
    mg_pressure: bool = True
    mg_project_fused: bool = False
    mg_min_plane: int = 128 * 128
    fast_render: bool = True
    fast_sim: bool = True
    block_resolve: bool = False
    advect_substeps: int = 1

    # ---- physics constants (ref: CSAdvect.hlsl:11-14, Impulse.hlsli) ----
    ext_force: Tuple[float, float, float] = (0.0, 48.0, 0.0)
    force_scale_3d: float = 4.0
    vort_scale: float = 200.0
    dissipation: float = 0.2
    impulse_pos: Tuple[float, float, float] = (0.5, 0.1, 0.5)
    impulse_radius: float = 1.0 / 16.0
    impulse_color: Tuple[float, float, float] = (0.2, 0.4, 1.0)
    impulse_density: float = 40.0
    fluid_density_3d: float = 0.48
    fluid_density_2d: float = 1.0

    # ---- render constants (ref: RayMarch.hlsli:11-12, Fluid.cpp ctor) ----
    absorption: float = 0.8
    zero_threshold: float = 0.01
    light_pos: Tuple[float, float, float] = (75.0, 75.0, -75.0)
    light_color: Tuple[float, float, float, float] = (1.0, 0.7, 0.3, 3.0 * 3.141592653589793)
    ambient: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.5 * 3.141592653589793)
    volume_scale: float = 10.0
    clear_color: Tuple[float, float, float, float] = (0.2, 0.2, 0.2, 0.0)
    z_near: float = 1.0
    z_far: float = 1000.0
    fov_y: float = 3.141592653589793 / 4.0

    # ------------------------------------------------------------------
    @property
    def is_3d(self) -> bool:
        return self.grid_size[2] > 1

    @property
    def time_step(self) -> float:
        """Resolution-locked dt (ref: FluidX12.cpp:266): (3D? 2 : 1)/grid.y."""
        return (2.0 if self.is_3d else 1.0) / self.grid_size[1]

    @property
    def cube_map_size(self) -> int:
        return self.grid_size[0]

    @property
    def zyx(self) -> Tuple[int, int, int]:
        """Grid extents in array order (Z, Y, X)."""
        x, y, z = self.grid_size
        return (z, y, x)

    def validate(self) -> "FluidConfig":
        x, y, z = self.grid_size
        if x != y:
            raise ValueError(f"grid_size.x must equal grid_size.y, got {self.grid_size}")
        if x < 8 or y < 8 or z < 1:
            raise ValueError(f"grid too small: {self.grid_size}")
        if self.max_ray_samples < 1 or self.max_light_samples < 1:
            raise ValueError("sample counts must be >= 1")
        return self


PRESETS = {
    "fluid3d": FluidConfig(),
    "fluid2d": FluidConfig(grid_size=(512, 512, 1)),
    "fluidgi": FluidConfig(grid_size=(150, 150, 150), has_light_probe=True),
}
