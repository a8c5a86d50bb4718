"""Light map for a directional light: the sheared slice sweep (mirror of
fluidx12_tpu/render/lightmap_sweep.py, directional branch without GI).

For parallel rays the accumulated optical depth is, in a frame sheared by
the light's lateral slope, an exclusive cumulative sum over slices:

    log T = unshear( cumsum_excl( shear( log att ) ) )

which kernel B9 computes in one streaming scan (ops/cuda/sweep.py).  The
slice-major relayout + box pooling around it are matmuls against pooling
matrices, in bf16 on the card (`mxu_einsum`), as the JAX package runs them.
The port takes the scan on every grid; the JAX package falls back to an
einsum shear form where its kernel does not tile (n_b % 128), which agrees
with the scan to f32 summation order (tests/test_pallas.py).
"""

from __future__ import annotations

import numpy as np
import torch

from fluidx12_tpu_torch.core.config import FluidConfig
from fluidx12_tpu_torch.core.state import SceneParams
from fluidx12_tpu_torch.ops.cuda.sweep import shear_scan
from fluidx12_tpu_torch.ops.transform import transform_vector
from fluidx12_tpu_torch.render.raymarch_core import MAX_DIST
from fluidx12_tpu_torch.render.slicecomp import mxu_einsum

_ARR_TO_LOCAL = {0: 2, 1: 1, 2: 0}


def scan_args(dens_o: torch.Tensor, light_dir: torch.Tensor, major_axis: int,
              sizes, stride: int, ref_step: torch.Tensor, absorption: float):
    """(log_att, s): kernel B9's arguments for a pooled, light-to-far
    ordered (m, n_a, n_b) slice stack -- the step-normalised log
    attenuation and [slope_a, slope_b, pad_a, pad_b] per slice step."""
    arr_axis = _ARR_TO_LOCAL[major_axis]
    n_m = sizes[major_axis]
    rem_local = [_ARR_TO_LOCAL[a] for a in (0, 1, 2) if a != arr_axis]
    l_m = light_dir[major_axis]
    n_a, n_b = dens_o.shape[1], dens_o.shape[2]
    step_m_local = 2.0 * stride / n_m
    abs_lm = torch.clamp_min(l_m.abs(), 0.35)
    slope_a = light_dir[rem_local[0]] / l_m * step_m_local * (sizes[rem_local[0]] / 2.0)
    slope_b = light_dir[rem_local[1]] / l_m * step_m_local * (sizes[rem_local[1]] / 2.0)
    step_len = step_m_local / abs_lm
    n_steps = step_len / ref_step
    att = torch.clamp(1.0 - dens_o * absorption, 1e-6, 1.0)
    log_att = torch.log(att) * n_steps
    # |slope| <= n_lat / n_m: a W = 2n frame with a sign-dependent pad holds
    # every sheared column.
    zero = torch.zeros((), dtype=torch.float32, device=dens_o.device)
    pad_a = torch.where(slope_a < 0, zero + n_a, zero)
    pad_b = torch.where(slope_b < 0, zero + n_b, zero)
    s = torch.stack([slope_a, slope_b, pad_a, pad_b]).to(torch.float32)
    return log_att.to(torch.float32).contiguous(), s


def _sweep_pooled(dens_o: torch.Tensor, light_dir: torch.Tensor, major_axis: int,
                  sizes, stride: int, ref_step: torch.Tensor,
                  absorption: float) -> torch.Tensor:
    """Shear -> exclusive cumsum -> unshear of a pooled, light-to-far
    ordered (m, n_a, n_b) slice stack; returns its transmittance."""
    log_t = shear_scan(*scan_args(dens_o, light_dir, major_axis, sizes, stride,
                                  ref_step, absorption))
    return torch.exp(torch.clamp_max(log_t, 0.0)).to(dens_o.dtype)


def _pool_mats(n_m: int, n_s: int, stride: int, flip: bool, device):
    """(pool (n_m, n_s), up (n_s, n_m)) slice-pooling operands with the
    light-to-far flip folded in; tail voxels extend the last group."""
    pool = torch.zeros((n_m, n_s), dtype=torch.float32, device=device)
    up = torch.zeros((n_s, n_m), dtype=torch.float32, device=device)
    rows = torch.arange(n_s * stride, device=device)
    groups = torch.arange(n_s, device=device).repeat_interleave(stride)
    pool[rows, groups] = 1.0 / stride
    up[groups, rows] = 1.0
    if n_s * stride < n_m:
        up[n_s - 1, n_s * stride:] = 1.0
    if flip:
        pool = pool.flip(1)
        up = up.flip(0)
    return pool, up


# Sweep slice budget: 2x the reference's 64 light samples per ray.
_MAX_SLICES = 128


def directional_transmittance(density: torch.Tensor, light_dir: torch.Tensor,
                              major_axis: int, ref_step: torch.Tensor,
                              absorption: float, flip: bool) -> torch.Tensor:
    """Per-voxel transmittance toward a directional light; (Z, Y, X)."""
    dtype = density.dtype
    z, y, x = density.shape
    sizes = (x, y, z)
    n_m = sizes[major_axis]
    stride = max(-(-n_m // _MAX_SLICES), 1)
    n_s = n_m // stride
    pool, up = _pool_mats(n_m, n_s, stride, flip, density.device)
    eq = {0: "zyx,xm->mzy", 1: "zyx,ym->mzx", 2: "zyx,zm->myx"}[major_axis]
    dens_o = mxu_einsum(eq, density, pool).to(dtype)
    transm = _sweep_pooled(dens_o, light_dir, major_axis, sizes, stride,
                           ref_step, absorption)
    eq_up = {0: "mzy,mx->zyx", 1: "mzx,my->zyx", 2: "myx,mz->zyx"}[major_axis]
    return mxu_einsum(eq_up, transm, up).to(dtype)


# Lateral dims at/above this make the JAX package sweep at half lateral
# resolution (its `_pool2_lat`), which the port does not do yet.
_LAT_POOL_MIN = 256


def render_light_map_fast(grid: torch.Tensor, params: SceneParams,
                          config: FluidConfig) -> torch.Tensor:
    """(3, Z, Y, X) incident light per voxel for the configured directional
    light: light colour * shadow + flat ambient (no GI; point lights and
    the light probe are rejected by render/pipeline.unported_render)."""
    dtype = config.render_dtype
    density = grid[3].to(dtype)
    local_light = transform_vector(params.light_pt, params.world_i)
    light_dir = (local_light / torch.linalg.vector_norm(local_light)).to(dtype)
    # Host-static major axis and sign from the config's fixed light (the
    # world is a pure scale, so local and world directions agree).
    lp = np.asarray(config.light_pos, np.float32)
    major_axis = int(np.argmax(np.abs(lp)))
    flip = bool(lp[major_axis] > 0)
    ref_step = MAX_DIST / params.num_light_samples.to(dtype)
    arr_axis = _ARR_TO_LOCAL[major_axis]
    lateral = [n for d, n in enumerate(density.shape) if d != arr_axis]
    if all(n % 2 == 0 and n >= _LAT_POOL_MIN for n in lateral):
        raise NotImplementedError(
            "the half-resolution light sweep for lateral dims >= 256 is not "
            "ported yet (ROADMAP.md queue A, item 2)")
    shadow = directional_transmittance(density, light_dir, major_axis, ref_step,
                                       config.absorption, flip)
    env3 = (params.light_color[:3] * params.light_color[3])[:, None, None, None]
    dense = density >= config.zero_threshold
    shadow = torch.where(dense, shadow, torch.ones_like(shadow))
    ambient = (params.ambient[:3] * params.ambient[3])[:, None, None, None]
    return (env3 * shadow[None] + ambient).to(dtype)
