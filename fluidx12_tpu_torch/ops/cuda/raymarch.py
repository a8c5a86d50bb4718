"""The faithful stack's per-ray marches: kernels R1 (`view_march`) and R2
(`light_march`).

These replace no TPU kernel: they replace the JAX package's XLA scans of
fluidx12_tpu/render/raymarch_core.py `view_march` (:337-420; in merged
mode nesting `cast_light_ray`'s scan per sample) and of
fluidx12_tpu/render/lightmap.py `render_light_map` (:36-108), which as
plain PyTorch would be hundreds of thousands of launches a frame.  The
Hopper design (one thread a ray or voxel, the plain versions' arithmetic
op for op) and what bounds it: fluidx12_tpu_torch/csrc/raymarch.cu.

Unlike the other wrappers here, these two launch only: their plain
versions march with the render layer's machinery, so they live beside
their JAX counterparts (render/raymarch_core.view_march and
render/lightmap.light_map_plain), and render/ takes them for a CPU tensor
(`raymarch_core.march_view`, `lightmap.render_light_map`).  The light
environment arrives packed, one (48,) f32 tensor made on the frame's device
by tensor ops (render/raymarch_core.pack_env), with its switches as
`flags`; the sample counts are device int32 scalars, so a frame copies
nothing from the host.
"""

from __future__ import annotations

from typing import Optional

import torch

from fluidx12_tpu_torch.core.config import FluidConfig
from fluidx12_tpu_torch.ops.cuda import _build

# The switches `flags` carries (csrc/raymarch.cu's Flags).
FLAG_PREMULTIPLIED, FLAG_PROBE, FLAG_POINT_LIGHT = 1, 2, 4
ENV_SIZE = 48


def _check(grid: torch.Tensor, env: torch.Tensor, counts, name: str) -> None:
    if grid.device.type != "cuda":
        raise ValueError(f"{name}: runs on a CUDA tensor, got {grid.device} (the plain "
                         f"version is in render/)")
    if (grid.ndim != 4 or grid.shape[0] != 4 or not grid.is_contiguous()
            or grid.dtype not in (torch.bfloat16, torch.float32)):
        raise ValueError(f"{name}: expected a contiguous bf16 or f32 (4, Z, Y, X) grid, "
                         f"got {tuple(grid.shape)} {grid.dtype}")
    if (env.dtype != torch.float32 or env.shape != (ENV_SIZE,) or env.device != grid.device):
        raise ValueError(f"{name}: env must be the packed ({ENV_SIZE},) f32 light environment "
                         "on the grid's device")
    for num in counts:
        if num.dtype != torch.int32 or num.numel() != 1 or num.device != grid.device:
            raise ValueError(f"{name}: sample counts must be int32 scalars on the grid's device")


def view_march(grid: torch.Tensor, origin: torch.Tensor, ray_dir: torch.Tensor,
               t_max: torch.Tensor, active: torch.Tensor, num_samples: torch.Tensor,
               env: torch.Tensor, flags: int, config: FluidConfig,
               light_map: Optional[torch.Tensor] = None,
               num_light_samples: Optional[torch.Tensor] = None,
               samples: Optional[torch.Tensor] = None) -> torch.Tensor:
    """R1: render/raymarch_core.view_march's rays, (..., 4) f32.  grid
    (4, Z, Y, X) in its storage dtype (bf16 or f32); origin, ray_dir
    (..., 3) and t_max (...,) f32, active (...,) bool; num_samples (and,
    in merged mode, num_light_samples) int32 device scalars; env and
    flags the packed light environment; light_map (3, Z', Y', X') f32, of
    its own dims, selects the separate mode.  `samples` (an int32 tensor
    of (..., 3)), where given, receives each ray's view samples, dense
    view samples and light-ray samples taken (the bound's count)."""
    if light_map is None and num_light_samples is None:
        raise ValueError("view_march: merged mode needs num_light_samples")
    counts = [num_samples] + ([] if num_light_samples is None else [num_light_samples])
    _check(grid, env, counts, "view_march")
    dev = grid.device
    lead = tuple(origin.shape[:-1])
    n = 1
    for d in lead:
        n *= d
    rays = [origin.reshape(n, 3), ray_dir.reshape(n, 3), t_max.reshape(n), active.reshape(n)]
    if (any(r.device != dev or not r.is_contiguous() for r in rays)
            or any(r.dtype != torch.float32 for r in rays[:3]) or rays[3].dtype != torch.bool):
        raise ValueError("view_march: origin, ray_dir, t_max (f32) and active (bool) must be "
                         "contiguous on the grid's device")
    if light_map is not None and (light_map.ndim != 4 or light_map.shape[0] != 3
                                  or light_map.dtype != torch.float32
                                  or not light_map.is_contiguous() or light_map.device != dev):
        raise ValueError("view_march: light_map must be a contiguous f32 (3, Z, Y, X) "
                         "tensor on the grid's device")
    if samples is not None and (samples.dtype != torch.int32 or samples.numel() != 3 * n
                                or not samples.is_contiguous() or samples.device != dev):
        raise ValueError("view_march: samples must be a contiguous int32 (..., 3) tensor")
    out = torch.empty(lead + (4,), dtype=torch.float32, device=dev)
    lm_dims = (0, 0, 0) if light_map is None else tuple(light_map.shape[1:])
    err = _build.lib().fx_view_march(
        grid.data_ptr(), int(grid.dtype == torch.bfloat16), *grid.shape[1:],
        None if light_map is None else light_map.data_ptr(), *lm_dims, env.data_ptr(),
        *(r.data_ptr() for r in rays), num_samples.data_ptr(),
        None if num_light_samples is None else num_light_samples.data_ptr(),
        out.data_ptr(), None if samples is None else samples.data_ptr(), n,
        config.max_ray_samples, config.max_light_samples, float(config.absorption),
        float(config.zero_threshold), flags, _build.stream_ptr(grid))
    view_march.launches += 1
    _build.check(err, "fx_view_march")
    return out


view_march.launches = 0


def light_march(grid: torch.Tensor, env: torch.Tensor, flags: int,
                num_light_samples: torch.Tensor, config: FluidConfig,
                samples: Optional[torch.Tensor] = None) -> torch.Tensor:
    """R2: the (3, Z, Y, X) f32 light map of the (4, Z, Y, X) colour grid
    in its storage dtype (bf16 or f32) (render/lightmap.light_map_plain);
    env and flags the packed light environment; num_light_samples an
    int32 device scalar.  `samples` (int32, (Z, Y, X)), where given,
    receives each voxel's light samples taken."""
    _check(grid, env, [num_light_samples], "light_march")
    if samples is not None and (samples.dtype != torch.int32
                                or samples.numel() != grid[0].numel()
                                or not samples.is_contiguous() or samples.device != grid.device):
        raise ValueError("light_march: samples must be a contiguous int32 (Z, Y, X) tensor")
    out = torch.empty((3,) + tuple(grid.shape[1:]), dtype=torch.float32, device=grid.device)
    err = _build.lib().fx_light_march(
        grid.data_ptr(), int(grid.dtype == torch.bfloat16), *grid.shape[1:], env.data_ptr(),
        num_light_samples.data_ptr(), out.data_ptr(),
        None if samples is None else samples.data_ptr(), config.max_light_samples,
        float(config.absorption), float(config.zero_threshold), flags,
        _build.stream_ptr(grid))
    light_march.launches += 1
    _build.check(err, "fx_light_march")
    return out


light_march.launches = 0
