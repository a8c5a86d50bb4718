"""Cube-map volume march by slice compositing (mirror of
fluidx12_tpu/render/slicecomp.py, unsharded compact path).

Cube faces are axis-aligned, so the rays of all texels of a face cut each
volume slice in a scale + translate of the texel grid: per-slice resampling
is separable, and front-to-back compositing runs slice by slice.  Kernel B10
(ops/cuda/composite.py) does both for one face in one pass.  The route of
each face is the TPU's (`march_kernels`).  Where the TPU stores the grid
padded (core/padding.py) it re-pads the march volume and takes B10 on
every face, when each live axis passes B10's gate at the padded lateral
dims (`padded_march`); the port then takes B10 on the compact volume,
whose clamps at its edges give the padded kernel's zero-weight ghosts.
Elsewhere, where the TPU cannot run B10 on a big stack (`_takes_b17`: a
lateral dim that does not tile, which with x = y means a lateral plane of
768^2 or more), it resamples the stack with two matmuls and composites it
with kernel B17; the port does the same there, and takes B10 on every
other face.  The DIRECT methods (render/screencomp.py) march one enlarged
base plane of a face the same way, by the same gate (`plane_kernel`), with
zero weight outside the volume.  (The JAX package keeps an einsum +
cumprod twin for small stacks, below its `_FUSE_MIN_STACK`; that twin
agrees with the kernel within 2e-3, tests/test_pallas.py, and is not
ported.)
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from fluidx12_tpu_torch.core import math3d as m3
from fluidx12_tpu_torch.core.camera import OrbitCamera
from fluidx12_tpu_torch.core.config import FaceCullMode, FluidConfig
from fluidx12_tpu_torch.core.constants import device_constant
from fluidx12_tpu_torch.core.padding import storage_zyx
from fluidx12_tpu_torch.core.state import SceneParams
from fluidx12_tpu_torch.ops.cuda.composite import (
    composite,
    composite_resample,
    composite_resample_supported,
    composite_supported,
)
from fluidx12_tpu_torch.ops.transform import transform_point_h
from fluidx12_tpu_torch.render.raymarch_core import MAX_DIST, face_visibility_in_graph
from fluidx12_tpu_torch.utils.image import quantize_unorm8

# (axis, sign, (u_axis, u_sign), (v_axis, v_sign)) per face, matching
# GetLocalPos (CSRayMarch.hlsl:39-64).
_FACES = [
    (0, +1, (2, -1), (1, +1)),
    (0, -1, (2, +1), (1, +1)),
    (1, +1, (0, +1), (2, -1)),
    (1, -1, (0, +1), (2, +1)),
    (2, +1, (0, +1), (1, +1)),
    (2, -1, (0, -1), (1, +1)),
]

_ARR_AXIS = {0: 3, 1: 2, 2: 1}       # local axis -> (C, Z, Y, X) array dim
_ARR_TO_LOCAL = {1: 2, 2: 1, 3: 0}   # array dim -> local axis

# Stack size (slices x rows x cols) from which the TPU composites a face in
# a kernel rather than its XLA chain (fluidx12_tpu/render/slicecomp.py:71).
_FUSE_MIN_STACK = 1024 * 1024


def mxu16(device) -> torch.dtype:
    """Half-precision matmul dtype: bf16 on the card, f32 on the CPU (the
    JAX package's `_mxu16` rule)."""
    return torch.float32 if torch.device(device).type == "cpu" else torch.bfloat16


def mxu_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with both operands rounded to `mxu16` and an f32 result --
    JAX's `einsum(a.astype(mx), b.astype(mx), preferred_element_type=f32)`.
    Products of bf16 values are exact in f32, so an f32 contraction of the
    rounded operands (TF32 off) gives the same numbers."""
    mx = mxu16(a.device)
    return torch.einsum(eq, a.to(mx).float(), b.to(mx).float())


@functools.lru_cache(maxsize=None)
def _pool_matrix(n_m: int, n_s: int, stride: int, device: torch.device) -> torch.Tensor:
    """(n_m, n_s) f32 box-pooling matrix of `stride` slices a group, made
    once per shape and kept: a captured frame reads it by address
    (core/constants.py)."""
    pool = torch.zeros((n_m, n_s), dtype=torch.float32, device=device)
    pool[torch.arange(n_s * stride, device=device),
         torch.arange(n_s, device=device).repeat_interleave(stride)] = 1.0 / stride
    return pool


def _axis_volume(vol: torch.Tensor, axis: int, config: FluidConfig,
                 lod: int = 0) -> torch.Tensor:
    """(C, Z, Y, X) -> (C, n_s, A, B) slice-axis-major, box-pooled view of
    the volume for one march axis, in the matmul dtype."""
    n_m = config.grid_size[axis]
    cap = max(config.max_ray_samples >> lod, 1)
    stride = max(-(-n_m // cap), 1)
    n_s = n_m // stride
    mx = mxu16(vol.device)
    v16 = vol.to(mx)
    if axis == 2 and stride == 1:
        return v16
    if axis == 2 and n_s * stride == n_m:
        return (v16.reshape(v16.shape[0], n_s, stride, *v16.shape[2:])
                .float().mean(dim=2).to(mx))
    pool = _pool_matrix(n_m, n_s, stride, vol.device)
    if axis == 0:
        return mxu_einsum("czyx,xm->czym", v16, pool).to(mx).movedim(3, 1)
    eq = {2: "czyx,zm->cmyx", 1: "czyx,ym->cmzx"}[axis]
    return mxu_einsum(eq, v16, pool).to(mx)


def _local_from_uv(face_id, u, v, dtype, device):
    axis, sign, (ua, us), (va, vs) = _FACES[face_id]
    comps = [None, None, None]
    comps[axis] = device_constant(float(sign), dtype, device)
    comps[ua] = u * us
    comps[va] = v * vs
    return comps


def _rem_local(face_id: int):
    """The local axes of the face's two lateral array dims, in array order
    (rows, then columns)."""
    axis = _FACES[face_id][0]
    return [_ARR_TO_LOCAL[a] for a in (1, 2, 3) if a != _ARR_AXIS[axis]]


def plane_dims(face_id: int, res) -> tuple:
    """(rows, cols, swapped) of the march's output for a plane of `res`
    texels, an int or (Ru, Rv): the rows resample the face's first lateral
    array dim, and the X faces (`swapped`) resample u along rows, so their
    image is transposed (fluidx12_tpu/render/slicecomp.py:279-281)."""
    _, _, (ua, _), (va, _) = _FACES[face_id]
    r_u, r_v = (res, res) if isinstance(res, int) else res
    rem_local = _rem_local(face_id)
    return (r_u if rem_local[0] == ua else r_v, r_u if rem_local[1] == ua else r_v,
            rem_local == [ua, va])


def face_geometry(face_id: int, n_s: int, local_eye: torch.Tensor,
                  num_samples: torch.Tensor, config: FluidConfig, dtype,
                  lod: int = 0, extent=1.0, res=None):
    """Kernel B10's per-face arguments: (h_rows (n_s, R1), h_cols
    (n_s, R2), valid (n_s,), n_steps (R1, R2)), all f32 and contiguous,
    plus `swapped` (`plane_dims`).  A cube face by default; the DIRECT
    methods' base plane with `extent` (Lu, Lv) > 1, its lateral half-extents,
    and `res` (Ru, Rv), its texels."""
    axis, sign, (ua, us), (va, vs) = _FACES[face_id]
    dev = local_eye.device
    z, y, x = config.zyx
    sizes = (x, y, z)
    n_m = sizes[axis]
    stride = -(-n_m // max(config.max_ray_samples >> lod, 1))
    plane_res = res if res is not None else max(config.cube_map_size >> lod, 1)
    r_u, r_v = (plane_res, plane_res) if isinstance(plane_res, int) else plane_res
    l_u, l_v = (extent, extent) if isinstance(extent, float) else extent

    u_line = ((torch.arange(r_u, dtype=dtype, device=dev) + 0.5) / r_u * 2.0 - 1.0) * l_u
    v_line = -((torch.arange(r_v, dtype=dtype, device=dev) + 0.5) / r_v * 2.0 - 1.0) * l_v
    e_m = local_eye[axis]
    cell = ((torch.arange(n_s, dtype=dtype, device=dev) * stride + 0.5 * stride)
            / n_m) * 2.0 - 1.0
    denom = float(sign) - e_m
    denom = torch.where(denom.abs() < 1e-8, torch.full_like(denom, 1e-8), denom)
    s = (cell - e_m) / denom

    rem_local = _rem_local(face_id)
    swapped = rem_local == [ua, va]

    def coords_for(local_axis):
        if local_axis == ua:
            q_line, e_q, unit_sign = u_line, local_eye[ua], us
        else:
            q_line, e_q, unit_sign = v_line, local_eye[va], vs
        n_src = sizes[local_axis]
        h = e_q + (q_line[None, :] * unit_sign - e_q) * s[:, None]
        return (h + 1.0) * 0.5 * n_src - 0.5

    tex_pos = torch.stack(torch.broadcast_tensors(
        *_local_from_uv(face_id, u_line[None, :], v_line[:, None], dtype, dev)), dim=-1)
    rd = tex_pos - local_eye
    rd = rd / torch.linalg.vector_norm(rd, dim=-1, keepdim=True)
    dm = rd[..., axis].abs()
    step_len = (2.0 * stride / n_m) / torch.clamp_min(dm, 1e-4)
    ref_step = MAX_DIST / num_samples.to(dtype)
    n_steps = step_len / ref_step
    if swapped:
        n_steps = n_steps.T
    valid = (s > 0.0) & (s <= 1.0)
    f32 = torch.float32
    return (coords_for(rem_local[0]).to(f32).contiguous(),
            coords_for(rem_local[1]).to(f32).contiguous(),
            valid.to(f32), n_steps.to(f32).contiguous(), swapped)


def _takes_b17(n_s: int, a: int, b: int, r, config: FluidConfig) -> bool:
    """True where the TPU composites an (n_s, R1, R2) stack of an
    (A, B)-sliced volume with B17, `r` being R or (R1, R2): a big stack
    (`_FUSE_MIN_STACK`) that B10's gate rejects and B17's takes
    (fluidx12_tpu/render/slicecomp.py:288-378, the unsharded compact
    layout)."""
    r1, r2 = (r, r) if isinstance(r, int) else r
    return (config.use_pallas and n_s * r1 * r2 >= _FUSE_MIN_STACK
            and not composite_resample_supported(n_s, a, b, r1, r2)
            and composite_supported(n_s, r1, r2))


def _lateral(zyx, axis: int):
    """(A, B), the lateral dims of an axis volume of a (Z, Y, X) grid
    (`_axis_volume`): X faces (Z, Y), Y faces (Z, X), Z faces (Y, X)."""
    z, y, x = zyx
    return {0: (z, y), 1: (z, x), 2: (y, x)}[axis]


def _n_slices(config: FluidConfig, axis: int, lod: int) -> int:
    """Slices of the axis volume: the axis pooled down to the LOD-scaled
    ray-sample budget (`_axis_volume`)."""
    n_m = config.grid_size[axis]
    return n_m // max(-(-n_m // max(config.max_ray_samples >> lod, 1)), 1)


def _pads(config: FluidConfig, lod: int, planes) -> bool:
    """True where the TPU re-pads the march volume to its storage dims for
    the (axis, R1, R2) stacks `planes`: the grid pads, and each passes
    `composite_resample_supported` at the padded lateral dims with the
    logical grid's slice count (fluidx12_tpu/render/slicecomp.py:466-498,
    screencomp.py:226-252)."""
    storage = storage_zyx(config)
    if not (config.use_pallas and config.is_3d) or storage == config.zyx:
        return False
    return all(composite_resample_supported(_n_slices(config, axis, lod),
                                            *_lateral(storage, axis), r1, r2)
               for axis, r1, r2 in planes)


def _route(config: FluidConfig, lod: int, planes) -> list:
    """"B10" or "B17" for each (axis, R1, R2) of `planes`: B10 on every
    one where the TPU re-pads (`_pads`; the port marches the compact
    volume, whose clamps give the padded kernel's zero-weight ghosts), else
    B17 where `_takes_b17` holds on the compact dims and B10 elsewhere."""
    if _pads(config, lod, planes):
        return ["B10"] * len(planes)
    return ["B17" if _takes_b17(_n_slices(config, axis, lod), *_lateral(config.zyx, axis),
                                (r1, r2), config) else "B10"
            for axis, r1, r2 in planes]


def _cube_planes(config: FluidConfig, lod: int, live) -> list:
    r = max(config.cube_map_size >> lod, 1)
    return [(_FACES[f][0], r, r) for f in live]


def padded_march(config: FluidConfig, lod: int, live) -> bool:
    """True where the TPU re-pads the cube march's volume and takes B10 on
    every live face (`_pads`)."""
    return _pads(config, lod, _cube_planes(config, lod, live))


def march_kernels(config: FluidConfig, lod: int, live) -> dict:
    """{face: "B10" or "B17"} for the cube faces in `live`: the TPU's route
    for each face at this LOD."""
    live = list(live)
    return dict(zip(live, _route(config, lod, _cube_planes(config, lod, live))))


def plane_kernel(config: FluidConfig, face_id: int, res) -> str:
    """"B10" or "B17": the TPU's route for the DIRECT methods' base plane
    of cube face `face_id` with `res` (Ru, Rv) texels, at lod 0.  Its
    re-pad asks B10's gate in both orientations of the plane
    (screencomp.py:241-247); the compact route reads the plane's own."""
    axis = _FACES[face_id][0]
    r1, r2, _ = plane_dims(face_id, res)
    return _route(config, 0, [(axis, r1, r2), (axis, r2, r1)])[0]


def _interp_weights(coords: torch.Tensor, n_src: int,
                    zero_outside: bool = False) -> torch.Tensor:
    """(..., n_out) source coordinates -> (..., n_out, n_src) dense lerp
    weights, edges clamped; with `zero_outside`, coordinates more than half
    a texel beyond the edges get zero weight instead
    (fluidx12_tpu/render/slicecomp.py:80-102)."""
    c = torch.clamp(coords, 0.0, n_src - 1.0)
    i0 = torch.floor(c)
    frac = c - i0
    i0 = i0.long()
    i1 = torch.clamp_max(i0 + 1, n_src - 1)
    src = torch.arange(n_src, device=coords.device)
    m0 = (src == i0[..., None]).to(coords.dtype) * (1.0 - frac)[..., None]
    m1 = (src == i1[..., None]).to(coords.dtype) * frac[..., None]
    w = m0 + m1
    if zero_outside:
        inside = (coords >= -0.5) & (coords <= n_src - 0.5)
        w = w * inside[..., None].to(w.dtype)
    return w


def resampled_stack(volf: torch.Tensor, h_rows: torch.Tensor, h_cols: torch.Tensor,
                    valid: torch.Tensor, zero_outside: bool = False):
    """B17's stack: the (4, n_s, A, B) slice-major volume resampled to the
    face by the two matmuls of fluidx12_tpu/render/slicecomp.py:338-363
    (operands and results rounded to the matmul dtype, f32 accumulation),
    then the density masked by `valid`.  Returns (dens (n_s, R1, R2), prod
    (3, n_s, R1, R2)), contiguous, in the matmul dtype."""
    mx = mxu16(volf.device)
    w_rows = _interp_weights(h_rows, volf.shape[2], zero_outside)    # (n_s, R1, A)
    w_cols = _interp_weights(h_cols, volf.shape[3], zero_outside)    # (n_s, R2, B)
    t1 = mxu_einsum("mrv,cmvu->cmru", w_rows, volf).to(mx)
    res = mxu_einsum("msu,cmru->cmrs", w_cols, t1).to(mx)
    dens = torch.where(valid[:, None, None] > 0.0, res[0], torch.zeros_like(res[0]))
    return dens.contiguous(), res[1:4].contiguous()


def _march_face(face_id: int, volf: torch.Tensor, local_eye: torch.Tensor,
                num_samples: torch.Tensor, config: FluidConfig, dtype,
                lod: int = 0, b17: bool = False, extent=1.0, res=None) -> torch.Tensor:
    """March one cube face with B10, or with the resample and B17 where
    `b17`; returns (R, R, 4) = (rgb / 2pi, alpha), R = cube_map_size >> lod.
    With `extent` (Lu, Lv) and `res` (Ru, Rv) it marches the DIRECT
    methods' enlarged base plane instead, (Rv, Ru, 4): where the plane
    reaches beyond the volume, texels outside it get zero weight, not the
    edge clamp (fluidx12_tpu/render/slicecomp.py:226-234)."""
    h_rows, h_cols, valid, n_steps, swapped = face_geometry(
        face_id, volf.shape[1], local_eye, num_samples, config, dtype, lod, extent, res)
    flip = _FACES[face_id][1] < 0
    outside = max((extent, extent) if isinstance(extent, float) else extent) > 1.0
    if b17:
        acc = composite(*resampled_stack(volf, h_rows, h_cols, valid, outside), n_steps,
                        float(config.absorption), flip=flip)
    else:
        acc = composite_resample(volf.to(torch.bfloat16).contiguous(), h_rows, h_cols, valid,
                                 n_steps, float(config.absorption), flip=flip,
                                 zero_outside=outside)
    out_rgb = acc[1:].movedim(0, -1)
    scatter = torch.cat([out_rgb / (2.0 * math.pi), acc[0][..., None]], dim=-1).to(dtype)
    if swapped:
        scatter = scatter.transpose(0, 1)
    return scatter


def ray_march_cube_fast(grid: torch.Tensor, params: SceneParams, config: FluidConfig,
                        light_map: torch.Tensor, lod: int = 0,
                        static_mask: Optional[int] = None) -> torch.Tensor:
    """(6, R, R, 4) cube map of the (4, Z, Y, X) colour grid lit by
    `light_map`; faces outside `static_mask` are not marched at all."""
    dtype = config.render_dtype
    dev = grid.device
    local_eye = transform_point_h(params.eye_pt, params.world_i)[:3].to(dtype)
    dens = grid[3:4].to(dtype)
    prod = grid[:3].to(dtype) * light_map.to(dtype)
    vol = torch.cat([dens, prod]).to(mxu16(dev))

    if config.face_cull == FaceCullMode.NONE:
        visible = face_visibility_in_graph(local_eye)
    else:
        face_ids = torch.arange(6, dtype=torch.int32, device=dev)
        visible = ((params.visibility_mask >> face_ids) & 1) > 0
    live = [f for f in range(6) if static_mask is None or (static_mask >> f) & 1]
    kernels = march_kernels(config, lod, live)

    volaxes = {axis: _axis_volume(vol, axis, config, lod)
               for axis in sorted({_FACES[f][0] for f in live})}
    r = max(config.cube_map_size >> lod, 1)
    faces = []
    for f in range(6):
        if f not in live:
            faces.append(torch.zeros((r, r, 4), dtype=dtype, device=dev))
            continue
        face = _march_face(f, volaxes[_FACES[f][0]], local_eye, params.num_samples,
                           config, dtype, lod, b17=kernels[f] == "B17")
        faces.append(torch.where(visible[f], face, torch.zeros_like(face)))
    cube = torch.stack(faces)
    if config.quantize_cube_map:
        cube = quantize_unorm8(cube)
    return cube


def sample_face_inputs(grid, face: int, device, seed: int = 0, extent=1.0, res=None,
                       camera: Optional[OrbitCamera] = None):
    """B10's arguments (volf, h_rows, h_cols, valid, n_steps) for cube face
    `face` of a smooth lit smoke volume on grid `grid` (x, y, z), made from
    `seed`, as `camera` (the default camera where None) sees it at lod 0:
    the march's own shapes and coordinates, for holding B10 against its
    plain version.  With `extent` and `res`, those of a DIRECT base plane
    on that face (`face_geometry`)."""
    cfg = FluidConfig(grid_size=grid)
    rng = np.random.default_rng(seed)
    dens = torch.from_numpy(rng.uniform(0.0, 0.6, cfg.zyx).astype(np.float32)).to(device)
    for ax in range(3):
        dens = (dens.roll(1, ax) + dens + dens.roll(-1, ax)) / 3.0
    vol = torch.cat([dens[None], dens[None].expand(3, -1, -1, -1) * 0.5]).to(torch.bfloat16)
    volf = _axis_volume(vol, _FACES[face][0], cfg).to(torch.bfloat16).contiguous()
    cam = camera if camera is not None else OrbitCamera(width=cfg.viewport[0],
                                                        height=cfg.viewport[1])
    eye = torch.from_numpy(np.append(cam.eye, 1.0).astype(np.float32)).to(device)
    world_i = torch.from_numpy(m3.inverse(m3.scaling(cfg.volume_scale))).to(device)
    h_rows, h_cols, valid, n_steps, _ = face_geometry(
        face, volf.shape[1], (eye @ world_i)[:3],
        torch.tensor(cfg.max_ray_samples, device=device), cfg, torch.float32, 0, extent, res)
    return volf, h_rows, h_cols, valid, n_steps
