"""Light map: the sheared slice sweep for a directional light, the
projective sweep for a point light outside the volume, and the GI ambient
from the light probe (mirror of fluidx12_tpu/render/lightmap_sweep.py,
with the Z-sharding hooks that parallel/light.py calls).

For parallel rays the accumulated optical depth is, in a frame sheared by
the light's lateral slope, an exclusive cumulative sum over slices:

    log T = unshear( cumsum_excl( shear( log att ) ) )

which kernel B9 computes in one streaming scan (ops/cuda/sweep.py).  The
slice-major relayout + box pooling around it are matmuls against pooling
matrices, in bf16 on the card (`mxu_einsum`), as the JAX package runs them.
The port takes the scan on every grid (ROADMAP.md C4).  With
`use_pallas=False`, and in the Z-sharded sweep (a `prefix_fn`), it runs the
JAX package's einsum form instead (lightmap_sweep.py:132-160): dense
shear weights, four f32 einsums and a cumsum, in plain torch.  The sharded
form passes each slice's global index (`k_ids`) and a `prefix_fn` that adds
the optical depth of the earlier ranks' slices, one sheared (W_a, W_b)
plane each.  Lateral dims of 256 and more sweep at half lateral resolution
(`_pool2_lat`).

A point light (`point_light`, the reference's dormant _POINT_LIGHT_ mode)
outside the volume rides the projective form of the same sweep
(`point_transmittance`): rays from the light have constant lateral slope
per slice step, so the optical depth is again an exclusive cumsum over
slices in that slope frame.  The JAX package runs it as einsums, with no
Pallas kernel, and so does the port (plain torch, f32 matmuls); a
point-light frame runs no B9.  A light inside the volume
(`point_sweep_supported` false) takes the faithful per-ray light map
instead, kernel R2 by render/lightmap.py (render/pipeline.render_frame).

With a light probe (`sh_coeffs`), the ambient term is the SH irradiance
along the density's negated gradient, times a six-sweep ambient occlusion,
where the voxel is dense.  Where the TPU runs it, that whole chain is kernel
B16 (ops/cuda/stencil.gi_light); elsewhere it runs as the XLA chain's
plain-torch twin.  The gradients of the GI normals and of the AO's
downsampled field are kernel B15 (ops/cuda/stencil.gradient3) where the
stencil gate holds, as on the TPU, and the twin elsewhere.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fluidx12_tpu_torch.core.config import FluidConfig
from fluidx12_tpu_torch.core.constants import device_constant
from fluidx12_tpu_torch.core.state import SceneParams
from fluidx12_tpu_torch.gi.sh import evaluate_sh_irradiance_planar
from fluidx12_tpu_torch.ops.cuda.stencil import (
    fallback_normal_dirs,
    gi_light,
    gradient3,
    gradient_axis,
    stencil_pallas_supported,
)
from fluidx12_tpu_torch.ops.cuda.sweep import shear_scan
from fluidx12_tpu_torch.ops.transform import transform_point_h, transform_vector
from fluidx12_tpu_torch.render.raymarch_core import MAX_DIST
from fluidx12_tpu_torch.render.slicecomp import mxu_einsum
from fluidx12_tpu_torch.sim.mg import _mat, _prolong, _prolong_matrix, _restrict, _restrict_matrix

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
                  sizes, stride: int, ref_step: torch.Tensor, absorption: float,
                  k_ids: torch.Tensor | None = None, prefix_fn=None,
                  use_pallas: bool = True) -> torch.Tensor:
    """Shear -> exclusive cumsum -> unshear of a pooled, light-to-far
    ordered (m, n_a, n_b) slice stack; returns its transmittance.  Kernel
    B9 where `use_pallas` holds and the stack is the whole sweep; else the
    einsum form (lightmap_sweep.py:60-160), where `k_ids` (m,) are the
    slices' global indices (arange by default) and `prefix_fn`, given this
    stack's total sheared optical depth (W_a, W_b), returns the earlier
    ranks' (parallel/light.py)."""
    log_att, s = scan_args(dens_o, light_dir, major_axis, sizes, stride, ref_step, absorption)
    if use_pallas and prefix_fn is None and k_ids is None:
        log_t = shear_scan(log_att, s)
        return torch.exp(torch.clamp_max(log_t, 0.0)).to(dens_o.dtype)
    dtype = dens_o.dtype
    dev = dens_o.device
    m, n_a, n_b = dens_o.shape
    log_att = log_att.to(dtype)
    slope_a, slope_b, pad_a, pad_b = s.to(dtype).unbind()
    k = (torch.arange(m, dtype=dtype, device=dev) if k_ids is None else k_ids.to(dtype))
    w_a, w_b = 2 * n_a, 2 * n_b
    # Shear weights: G[j, w] = logA[j, w - pad - j * slope].
    sw_a = _resample_weights(torch.arange(w_a, dtype=dtype, device=dev)[None, :] - pad_a
                             - k[:, None] * slope_a, n_a)                 # (m, W_a, n_a)
    sw_b = _resample_weights(torch.arange(w_b, dtype=dtype, device=dev)[None, :] - pad_b
                             - k[:, None] * slope_b, n_b)                 # (m, W_b, n_b)
    sheared = torch.einsum("kwa,kab->kwb", sw_a, log_att)
    sheared = torch.einsum("kvb,kwb->kwv", sw_b, sheared)                 # (m, W_a, W_b)
    # Exclusive: CastLightRay's first sample is a step beyond the voxel.
    excl = torch.cumsum(sheared, dim=0) - sheared
    if prefix_fn is not None:
        excl = excl + prefix_fn(sheared.sum(dim=0))[None]
    # Unshear: D[k, p] = E[k, p + pad + k * slope].
    uw_a = _resample_weights(torch.arange(n_a, dtype=dtype, device=dev)[None, :] + pad_a
                             + k[:, None] * slope_a, w_a)                 # (m, n_a, W_a)
    uw_b = _resample_weights(torch.arange(n_b, dtype=dtype, device=dev)[None, :] + pad_b
                             + k[:, None] * slope_b, w_b)
    out = torch.einsum("kaw,kwv->kav", uw_a, excl)
    log_t = torch.einsum("kbv,kav->kab", uw_b, out)
    return torch.exp(torch.clamp_max(log_t, 0.0))


@functools.lru_cache(maxsize=None)
def _pool_mats(n_m: int, n_s: int, stride: int, flip: bool, device):
    """(pool (n_m, n_s), up (n_s, n_m)) slice-pooling operands with the
    light-to-far flip folded in; tail voxels extend the last group.  Made
    once per shape and kept: a captured frame reads them by address
    (core/constants.py)."""
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
                              absorption: float, flip: bool,
                              max_slices: int = _MAX_SLICES,
                              axis_aligned: bool = False,
                              use_pallas: bool = True) -> torch.Tensor:
    """Per-voxel transmittance toward a directional light; (Z, Y, X).
    `axis_aligned` (a light exactly along the major axis, as the AO's six
    sweeps are) replaces the shear by a bare exclusive cumsum over the
    slices, which is what the shear computes at zero slope; `use_pallas`
    False takes the einsum sweep for B9 (`_sweep_pooled`)."""
    dtype = density.dtype
    z, y, x = density.shape
    sizes = (x, y, z)
    n_m = sizes[major_axis]
    stride = max(-(-n_m // max_slices), 1)
    n_s = n_m // stride
    pool, up = _pool_mats(n_m, n_s, stride, flip, density.device)
    eq = {0: "zyx,xm->mzy", 1: "zyx,ym->mzx", 2: "zyx,zm->myx"}[major_axis]
    dens_o = mxu_einsum(eq, density, pool).to(dtype)
    if axis_aligned:
        step_len = torch.full_like(ref_step, 2.0 * stride / n_m)  # |l_major| == 1
        n_steps = step_len / ref_step
        att = torch.clamp(1.0 - dens_o * absorption, 1e-6, 1.0)
        log_att = torch.log(att) * n_steps
        excl = torch.cumsum(log_att, dim=0) - log_att
        transm = torch.exp(torch.clamp_max(excl, 0.0))
    else:
        transm = _sweep_pooled(dens_o, light_dir, major_axis, sizes, stride,
                               ref_step, absorption, use_pallas=use_pallas)
    eq_up = {0: "mzy,mx->zyx", 1: "mzx,my->zyx", 2: "myx,mz->zyx"}[major_axis]
    return mxu_einsum(eq_up, transm, up).to(dtype)


def _resample_weights(coords: torch.Tensor, n_src: int) -> torch.Tensor:
    """(..., n_out) source coordinates -> (..., n_out, n_src) lerp weights,
    zero for taps outside the source: with log attenuation as the payload,
    a ray that leaves the volume laterally gathers no optical depth there
    (lightmap_sweep.py:40-56)."""
    i0 = torch.floor(coords)
    frac = coords - i0
    i0i = i0.long()
    src = torch.arange(n_src, device=coords.device)
    in0 = ((i0i >= 0) & (i0i < n_src)).to(coords.dtype)
    in1 = ((i0i + 1 >= 0) & (i0i + 1 < n_src)).to(coords.dtype)
    m0 = (src == torch.clamp(i0i, 0, n_src - 1)[..., None]).to(coords.dtype)
    m1 = (src == torch.clamp(i0i + 1, 0, n_src - 1)[..., None]).to(coords.dtype)
    return m0 * ((1.0 - frac) * in0)[..., None] + m1 * (frac * in1)[..., None]


def _sweep_pooled_point(dens_o: torch.Tensor, light_local: torch.Tensor, major_axis: int,
                        sizes, stride: int, ref_step: torch.Tensor, absorption: float,
                        flip: bool, k_ids: torch.Tensor | None = None, prefix_fn=None,
                        n_s_global: int | None = None) -> torch.Tensor:
    """Projective shear sweep of a pooled, light-to-far ordered (n_s, n_a,
    n_b) slice stack toward the light at `light_local`, which lies outside
    the volume on the near side of the sweep (lightmap_sweep.py:163-281).
    Rays from the light have constant lateral slope w = (p - pL) / (k - kL)
    in index units; slice j contributes at pL + w (j - kL), so the optical
    depth is an exclusive cumsum over slices on a (2 n_a, 2 n_b) grid of
    slopes that spans every voxel's ray, scaled per ray by its path length
    per slice step; then each voxel reads its ray's sum back."""
    dtype = dens_o.dtype
    arr_axis = _ARR_TO_LOCAL[major_axis]
    rem_local = [_ARR_TO_LOCAL[a] for a in (0, 1, 2) if a != arr_axis]
    n_m = sizes[major_axis]
    n_s, n_a, n_b = dens_o.shape
    n_sg = n_s if n_s_global is None else n_s_global
    step_m = 2.0 * stride / n_m
    dev = dens_o.device

    l_m = light_local[major_axis].to(dtype)
    l_a = light_local[rem_local[0]].to(dtype)
    l_b = light_local[rem_local[1]].to(dtype)
    # The light in slice / lateral index coordinates (slice 0 nearest it).
    s_l = (l_m + 1.0) * 0.5 * n_sg - 0.5
    k_l = (n_sg - 1.0 - s_l) if flip else s_l
    k_l = torch.clamp_max(k_l, -0.5)
    pl_a = (l_a + 1.0) * 0.5 * n_a - 0.5
    pl_b = (l_b + 1.0) * 0.5 * n_b - 0.5
    k = torch.arange(n_s, dtype=dtype, device=dev) if k_ids is None else k_ids.to(dtype)
    denom = k - k_l

    # Slope grids spanning every voxel's ray: both extremes of p and of the
    # (positive) denominator.
    w_a, w_b = 2 * n_a, 2 * n_b
    den0 = -k_l
    den1 = (n_sg - 1.0) - k_l

    def w_bounds(pl, n_lat):
        cands = torch.stack([(0.0 - pl) / den0, (0.0 - pl) / den1,
                             (n_lat - 1.0 - pl) / den0, (n_lat - 1.0 - pl) / den1])
        return cands.min(), cands.max()

    wa_min, wa_max = w_bounds(pl_a, n_a)
    wb_min, wb_max = w_bounds(pl_b, n_b)
    dwa = (wa_max - wa_min) / (w_a - 1)
    dwb = (wb_max - wb_min) / (w_b - 1)
    wa = wa_min + torch.arange(w_a, dtype=dtype, device=dev) * dwa
    wb = wb_min + torch.arange(w_b, dtype=dtype, device=dev) * dwb

    log_att = torch.log(torch.clamp(1.0 - dens_o * absorption, 1e-6, 1.0))
    # Shear: G[j, w] = logA[j, pL + w (j - kL)].
    sw_a = _resample_weights(pl_a + wa[None, :] * denom[:, None], n_a)   # (n_s, W_a, n_a)
    sw_b = _resample_weights(pl_b + wb[None, :] * denom[:, None], n_b)   # (n_s, W_b, n_b)
    sheared = torch.einsum("kwa,kab->kwb", sw_a, log_att)
    sheared = torch.einsum("kvb,kwb->kwv", sw_b, sheared)                 # (n_s, W_a, W_b)
    # Samples per slice step along each ray: its local tangent per slice
    # is (step_m, w_a 2 / n_a, w_b 2 / n_b).
    ds = torch.sqrt(step_m * step_m + (wa * (2.0 / n_a))[:, None] ** 2
                    + (wb * (2.0 / n_b))[None, :] ** 2)
    sheared = sheared * (ds / ref_step)[None]
    excl = torch.cumsum(sheared, dim=0) - sheared
    if prefix_fn is not None:
        excl = excl + prefix_fn(sheared.sum(dim=0))[None]

    # Unshear: D[k, p] = E[k, (p - pL) / (k - kL) on the slope grid].
    pa = torch.arange(n_a, dtype=dtype, device=dev)
    pb = torch.arange(n_b, dtype=dtype, device=dev)
    uw_a = _resample_weights(((pa[None, :] - pl_a) / denom[:, None] - wa_min) / dwa, w_a)
    uw_b = _resample_weights(((pb[None, :] - pl_b) / denom[:, None] - wb_min) / dwb, w_b)
    out = torch.einsum("kaw,kwv->kav", uw_a, excl)
    log_t = torch.einsum("kbv,kav->kab", uw_b, out)
    return torch.exp(torch.clamp_max(log_t, 0.0))


def point_sweep_supported(config: FluidConfig) -> bool:
    """True where the projective sweep serves the config's point light: the
    light lies outside the volume along its dominant axis, by more than a
    tenth of the half-size (lightmap_sweep.py:283-289)."""
    lp = np.asarray(config.light_pos, np.float32)
    major = int(np.argmax(np.abs(lp)))
    return abs(float(lp[major])) / config.volume_scale > 1.1


def point_transmittance(density: torch.Tensor, light_local: torch.Tensor, major_axis: int,
                        ref_step: torch.Tensor, absorption: float, flip: bool,
                        max_slices: int = _MAX_SLICES) -> torch.Tensor:
    """Per-voxel transmittance toward a point light at `light_local` (local
    space, outside the volume); (Z, Y, X).  The pooling around the sweep is
    `directional_transmittance`'s (lightmap_sweep.py:292-322)."""
    dtype = density.dtype
    z, y, x = density.shape
    sizes = (x, y, z)
    n_m = sizes[major_axis]
    stride = max(-(-n_m // max_slices), 1)
    n_s = n_m // stride
    pool, up = _pool_mats(n_m, n_s, stride, flip, density.device)
    eq = {0: "zyx,xm->mzy", 1: "zyx,ym->mzx", 2: "zyx,zm->myx"}[major_axis]
    dens_o = mxu_einsum(eq, density, pool).to(dtype)
    transm = _sweep_pooled_point(dens_o, light_local, major_axis, sizes, stride, ref_step,
                                 absorption, flip)
    eq_up = {0: "mzy,mx->zyx", 1: "mzx,my->zyx", 2: "myx,mz->zyx"}[major_axis]
    return mxu_einsum(eq_up, transm, up).to(dtype)


# Lateral dims at/above this sweep the shadow at half lateral resolution
# (tests monkeypatch it down to exercise the path, as the JAX tests do).
_LAT_POOL_MIN = 256


def _pool2_lat(vol: torch.Tensor, arr_axis: int) -> torch.Tensor:
    """2x box-pool the two non-major array dims of a (Z, Y, X) volume:
    trailing dims as matmuls against the restriction matrix, the leading
    dim as a pair mean (lightmap_sweep.py:440-457)."""
    if arr_axis != 2:
        vol = torch.einsum("zyx,xm->zym", vol, _mat(_restrict_matrix, vol.shape[2], vol))
    if arr_axis != 1:
        vol = torch.einsum("zyx,ym->zmx", vol, _mat(_restrict_matrix, vol.shape[1], vol))
    if arr_axis != 0:
        vol = vol.reshape(vol.shape[0] // 2, 2, *vol.shape[1:]).mean(dim=1)
    return vol


def _unpool2_lat(vol: torch.Tensor, arr_axis: int) -> torch.Tensor:
    """Linear 2x upsample of the two non-major array dims, the inverse
    layout of `_pool2_lat` (cell-centred lerp, as sim/mg._prolong)."""
    if arr_axis != 2:
        vol = torch.einsum("zyx,xm->zym", vol, _mat(_prolong_matrix, vol.shape[2], vol))
    if arr_axis != 1:
        vol = torch.einsum("zyx,ym->zmx", vol, _mat(_prolong_matrix, vol.shape[1], vol))
    if arr_axis != 0:
        lo = torch.cat([vol[:1], vol])
        hi = torch.cat([vol, vol[-1:]])
        even = 0.25 * lo[:-1] + 0.75 * vol
        odd = 0.75 * vol + 0.25 * hi[1:]
        vol = torch.stack([even, odd], dim=1).reshape(2 * vol.shape[0], *vol.shape[1:])
    return vol


def _lat_pooled_ok(shape, arr_axis: int) -> bool:
    lat = [n for d, n in enumerate(shape) if d != arr_axis]
    return all(n % 2 == 0 and n >= _LAT_POOL_MIN for n in lat)


# ---------------------------------------------------------------------------
# GI: the SH ambient
# ---------------------------------------------------------------------------

_AXIS_SWEEPS = ((0, +1), (0, -1), (1, +1), (1, -1), (2, +1), (2, -1))


def gi_ambient_from_parts(dense, nx_, ny_, nz_, ao, sh_coeffs, world3):
    """The GI ambient from its parts: world-rotate + normalise the normal
    direction, evaluate the SH irradiance, mask by density and modulate by
    the AO (CSRayMarchL.hlsl:44-79); (3, Z, Y, X)."""
    wx = nx_ * world3[0, 0] + ny_ * world3[1, 0] + nz_ * world3[2, 0]
    wy = nx_ * world3[0, 1] + ny_ * world3[1, 1] + nz_ * world3[2, 1]
    wz = nx_ * world3[0, 2] + ny_ * world3[1, 2] + nz_ * world3[2, 2]
    inv = 1.0 / torch.sqrt(torch.clamp_min(wx * wx + wy * wy + wz * wz, 1e-24))
    irradiance = evaluate_sh_irradiance_planar(sh_coeffs.to(nx_.dtype), wx * inv,
                                               wy * inv, wz * inv)
    return torch.where(dense[None], irradiance * ao[None], torch.zeros_like(irradiance))


def _gradient(density: torch.Tensor, use_pallas: bool = True):
    """(gz, gy, gx) like jnp.gradient: kernel B15 on the f32 density, cast
    back to its dtype, where the stencil gate holds, as the TPU runs it
    (fluidx12_tpu/render/lightmap_sweep.py:623-636); else the twin."""
    if use_pallas and stencil_pallas_supported(density.shape):
        g = gradient3(density.float().contiguous()).to(density.dtype)
        return g[2], g[1], g[0]
    return tuple(gradient_axis(density, axis) for axis in range(3))


def _ao_half_res(shape) -> bool:
    """True where the AO sweeps may run on a 2x box-downsampled field (the
    predicate shared by the B16 gate and `_ambient_occlusion`)."""
    return all(n % 2 == 0 and n >= 32 for n in shape)


def _ao_levels(shape) -> int:
    """Box-downsample levels of the AO sweeps: 2 (quarter resolution) on
    grids of 256 and more, 1 (half) on medium ones, else 0."""
    if all(n % 4 == 0 and n >= 256 for n in shape):
        return 2
    if _ao_half_res(shape):
        return 1
    return 0


def _ambient_occlusion(density, nx_, ny_, nz_, ref_step, config: FluidConfig):
    """Six axis sweeps blended by the (unnormalised) gradient direction.
    On a downsampled field (`_ao_levels`) the blend weights come from its
    own gradient, and the normal directions passed in are not read (None
    on the B16 path)."""
    dtype = density.dtype
    levels = _ao_levels(density.shape)
    if levels:
        dens_s = density.float()
        for _ in range(levels):
            dens_s = _restrict(dens_s)
        dens_s = dens_s.to(dtype)
        gz, gy, gx = _gradient(dens_s, config.use_pallas)
        cx, cy, cz = fallback_normal_dirs(gx, gy, gz)
    else:
        dens_s = density
        cx, cy, cz = nx_, ny_, nz_

    sweeps = []
    for ax, sgn in _AXIS_SWEEPS:
        d6 = device_constant(tuple(float(sgn) if i == ax else 0.0 for i in range(3)),
                             dtype, density.device)
        sweeps.append(directional_transmittance(
            dens_s, d6, ax, ref_step, config.absorption, flip=sgn > 0,
            max_slices=64, axis_aligned=True))
    comp = [torch.clamp_min(cx, 0.0), torch.clamp_min(-cx, 0.0),
            torch.clamp_min(cy, 0.0), torch.clamp_min(-cy, 0.0),
            torch.clamp_min(cz, 0.0), torch.clamp_min(-cz, 0.0)]
    total = torch.clamp_min(sum(comp), 1e-8)
    ao = sum(s * c for s, c in zip(sweeps, comp)) / total
    if levels:
        ao = ao.float()
        for _ in range(levels):
            ao = _prolong(ao)
        ao = ao.to(dtype)
    return ao


def render_light_map_fast(grid: torch.Tensor, params: SceneParams,
                          config: FluidConfig,
                          sh_coeffs: torch.Tensor | None = None) -> torch.Tensor:
    """(3, Z, Y, X) incident light per voxel for the configured light,
    directional or (`point_light`) a point outside the volume: light
    colour * shadow, plus the flat ambient or, with a light probe and its
    (9, 3) `sh_coeffs`, the GI ambient (a point light inside the volume
    takes the faithful stack instead, render/pipeline.render_frame)."""
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
    if config.point_light:
        # The projective sweep about the light's position, at full lateral
        # resolution (lightmap_sweep.py:511-523).
        light_local = transform_point_h(params.light_pt, params.world_i)[:3]
        shadow = point_transmittance(density, light_local.to(dtype), major_axis, ref_step,
                                     config.absorption, flip)
    elif _lat_pooled_ok(density.shape, arr_axis):
        # Big grids sweep at half lateral resolution: the slope math reads
        # the lateral sizes from the pooled shape.
        shadow = _unpool2_lat(directional_transmittance(
            _pool2_lat(density, arr_axis), light_dir, major_axis, ref_step,
            config.absorption, flip, use_pallas=config.use_pallas), arr_axis)
    else:
        shadow = directional_transmittance(density, light_dir, major_axis, ref_step,
                                           config.absorption, flip,
                                           use_pallas=config.use_pallas)
    env3 = params.light_color[:3] * params.light_color[3]
    dense = density >= config.zero_threshold
    shadow = torch.where(dense, shadow, torch.ones_like(shadow))

    if config.has_light_probe and sh_coeffs is not None:
        if (config.use_pallas and stencil_pallas_supported(density.shape)
                and _ao_half_res(density.shape)):
            # B16 fuses gradient -> fallback -> rotate -> normalise -> SH
            # irradiance -> mask -> light combine, as the TPU runs it; the
            # AO is downsampled here, so the full-res gradient lives only
            # inside the kernel.
            ao = _ambient_occlusion(density, None, None, None, ref_step, config)
            return gi_light(density.float(), shadow.float(), ao.float(), sh_coeffs,
                            params.world[:3, :3], env3, config.zero_threshold).to(dtype)
        gz, gy, gx = _gradient(density, config.use_pallas)
        nx_, ny_, nz_ = fallback_normal_dirs(gx, gy, gz)
        ao = _ambient_occlusion(density, nx_, ny_, nz_, ref_step, config)
        ambient = gi_ambient_from_parts(dense, nx_, ny_, nz_, ao, sh_coeffs,
                                        params.world[:3, :3])
    else:
        ambient = (params.ambient[:3] * params.ambient[3])[:, None, None, None]
    return (env3[:, None, None, None] * shadow[None] + ambient).to(dtype)
