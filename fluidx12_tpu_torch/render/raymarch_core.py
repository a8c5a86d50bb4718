"""Shared volume ray-marching machinery (mirror of
fluidx12_tpu/render/raymarch_core.py): the faithful stack's per-ray
marches as plain PyTorch, and the in-graph face-visibility test.

The reference marches one GPU thread per ray with `break` early-outs
(RayMarch.hlsli, CSRayMarch.hlsl, PSRayCast.hlsl).  These plain versions
march all rays in lock step with per-ray liveness masks, as the JAX
package's `lax.scan`s do, and stop once no ray is alive (which changes no
value).  On the card the marches are the hand kernels R1 and R2
(ops/cuda/raymarch.py), which compute the same per ray; these versions
run on the CPU and are the kernels' yardstick.  `march_view` takes R1 or
`view_march` by the grid's device, and `pack_env` packs the light
environment into the kernels' one tensor.  Details reproduced from the
reference:

- the adaptive step controller `GetStep` (RayMarch.hlsli:200-210); the
  reference's `step = (step + newStep) * 0.5` is a dead store, so the step
  is `newStep`;
- shadow rays `CastLightRay` with the transmittance early-out
  (RayMarch.hlsli:215-247);
- density-gradient normals, SH irradiance ambient and an AO ray (GetLight,
  RayMarch.hlsli:252-295);
- the ray-box entry `ComputeRayOrigin` (:146-173) and `ComputeTargetHit`
  (:178-183);
- front-to-back premultiplied accumulation with the final 1/(2 pi)
  (CSRayMarch.hlsl:141-193).

Divisions by a tensor are written `torch.div(a, b)` with both operands
tensors: PyTorch computes `float / tensor` as a reciprocal and a product,
which rounds differently from the division the JAX package and the kernels
do.  A 3-vector's norm is sqrt((x*x + y*y) + z*z), as in the kernels.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from fluidx12_tpu_torch.core.config import FluidConfig
from fluidx12_tpu_torch.core.constants import device_constant
from fluidx12_tpu_torch.core.state import SceneParams
from fluidx12_tpu_torch.gi.sh import evaluate_sh_irradiance
from fluidx12_tpu_torch.ops.cuda import raymarch as cuda_raymarch
from fluidx12_tpu_torch.ops.sampling import trilinear_sample
from fluidx12_tpu_torch.ops.transform import transform_point_h, transform_vector

# Local-space box diagonal (RayMarch.hlsli:29).
MAX_DIST = 2.0 * math.sqrt(3.0)


class LightEnv(NamedTuple):
    """Per-frame lighting in volume-local space, as tensors on the frame's
    device, and two host-static switches."""

    light_dir: torch.Tensor    # (3,) normalised local-space directional light
    light_pos: torch.Tensor    # (3,) local-space light point (point-light mode)
    light_color: torch.Tensor  # (3,) rgb * intensity
    ambient: torch.Tensor      # (3,) rgb * intensity
    world3x3: torch.Tensor     # (3, 3) volume -> world rotation and scale (SH eval)
    sh_coeffs: torch.Tensor    # (9, 3) SH irradiance coefficients (zeros if none)
    has_probe: bool
    point_light: bool


def norm3(v: torch.Tensor) -> torch.Tensor:
    """|v| over the last axis of (..., 3), keepdim: sqrt((x*x + y*y) + z*z)."""
    x, y, z = v[..., 0:1], v[..., 1:2], v[..., 2:3]
    return torch.sqrt((x * x + y * y) + z * z)


def step_size(num: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """MAX_DIST / num for a device scalar `num`, as one division."""
    return torch.div(device_constant(MAX_DIST, dtype, num.device), num.to(dtype))


def make_light_env(params: SceneParams, sh_coeffs: Optional[torch.Tensor],
                   config: FluidConfig) -> LightEnv:
    """Local-space lighting (CSRayMarch.hlsl:131-139): the directional light
    via the inverse world rotation, or under `_POINT_LIGHT_` the light's
    point via the full inverse transform."""
    local_light = transform_vector(params.light_pt, params.world_i)
    has_probe = sh_coeffs is not None and config.has_light_probe
    if sh_coeffs is None:
        sh_coeffs = device_constant((0.0,) * 27, torch.float32,
                                    params.light_pt.device).reshape(9, 3)
    return LightEnv(
        light_dir=local_light / norm3(local_light),
        light_pos=transform_point_h(params.light_pt, params.world_i)[..., :3],
        light_color=params.light_color[:3] * params.light_color[3],
        ambient=params.ambient[:3] * params.ambient[3],
        world3x3=params.world[:3, :3],
        sh_coeffs=sh_coeffs,
        has_probe=has_probe,
        point_light=config.point_light,
    )


def pack_env(env: LightEnv) -> torch.Tensor:
    """The kernels' (48,) f32 light environment, made on its device by
    tensor ops: light_dir, light_pos, light_color, ambient (3 each),
    world3x3 row-major (9), SH (9, 3)."""
    parts = [env.light_dir, env.light_pos, env.light_color, env.ambient,
             env.world3x3.reshape(9), env.sh_coeffs.reshape(27)]
    return torch.cat([p.to(torch.float32) for p in parts])


def env_flags(env: LightEnv, config: FluidConfig) -> int:
    """The kernels' switches: premultiplied colour, the probe, the point light."""
    return ((cuda_raymarch.FLAG_PREMULTIPLIED if config.pre_multiplied else 0)
            | (cuda_raymarch.FLAG_PROBE if env.has_probe else 0)
            | (cuda_raymarch.FLAG_POINT_LIGHT if env.point_light else 0))


def light_direction_at(env: LightEnv, pos: torch.Tensor) -> torch.Tensor:
    """The light's direction at `pos` (..., 3): constant for a directional
    light, normalised (light_pos - pos) for a point light
    (CSRayMarch.hlsl:158-161)."""
    if not env.point_light:
        return env.light_dir
    d = env.light_pos - pos
    return d / torch.clamp_min(norm3(d), 1e-12)


def face_visibility_in_graph(local_eye: torch.Tensor) -> torch.Tensor:
    """(6,) bool: face f is visible iff the local eye is on its outward side
    (IsVisible, CSRayMarch.hlsl:69-74)."""
    comps = torch.stack([local_eye[0], local_eye[0], local_eye[1],
                         local_eye[1], local_eye[2], local_eye[2]])
    odd = device_constant((False, True) * 3, torch.bool, local_eye.device)
    return torch.where(odd, comps > -1.0, comps < 1.0)


def local_to_tex(pos: torch.Tensor) -> torch.Tensor:
    """Local space [-1, 1]^3 -> texture space [0, 1]^3 (RayMarch.hlsli:188-195)."""
    return pos * 0.5 + 0.5


def get_step(d_density, transm, density, step_scale):
    """The adaptive step (RayMarch.hlsli:200-210)."""
    ev_num = device_constant(1.0 / 256.0, d_density.dtype, d_density.device)
    factor_ev = torch.div(ev_num, torch.clamp_min(d_density.abs(), 1.0 / 512.0))
    factor_ui = torch.clamp_max(1.0 - density, 1.0)
    factor_th = 1.0 - transm
    return step_scale * torch.clamp_min(1.5 * factor_ev * factor_ui * factor_th, 1.0)


def density_gradient(grid: torch.Tensor, uvw: torch.Tensor) -> torch.Tensor:
    """6-tap density gradient (RayMarch.hlsli:73-95) of grid (C, Z, Y, X),
    whose last channel is density, at uvw (..., 3): (..., 3), unnormalised,
    one texel either side along x, y and z."""
    z, y, x = grid.shape[-3:]
    dev = uvw.device
    density = grid[-1:]
    texel = device_constant((1.0 / x, 1.0 / y, 1.0 / z), uvw.dtype, dev)

    def tap(offset):
        off = device_constant(offset, uvw.dtype, dev)
        return trilinear_sample(density, uvw + texel * off)[0]

    gx = tap((1.0, 0.0, 0.0)) - tap((-1.0, 0.0, 0.0))
    gy = tap((0.0, 1.0, 0.0)) - tap((0.0, -1.0, 0.0))
    gz = tap((0.0, 0.0, 1.0)) - tap((0.0, 0.0, -1.0))
    return torch.stack([gx, gy, gz], dim=-1)


def compute_ray_origin(origin: torch.Tensor, ray_dir: torch.Tensor):
    """Clip ray origins (..., 3) to the box entry face (RayMarch.hlsli:146-173).
    Returns (entry point, hit); origins inside the box pass unchanged."""
    inside = (origin.abs() <= 1.0).all(dim=-1)
    u_best = torch.full(origin.shape[:-1], 3.4e38, dtype=origin.dtype, device=origin.device)
    hit = torch.zeros(origin.shape[:-1], dtype=torch.bool, device=origin.device)
    for i in range(3):
        j, k = (i + 1) % 3, (i + 2) % 3
        u = (-torch.sign(ray_dir[..., i]) - origin[..., i]) / ray_dir[..., i]
        ok = u >= 0.0
        ok &= (ray_dir[..., j] * u + origin[..., j]).abs() <= 1.0
        ok &= (ray_dir[..., k] * u + origin[..., k]).abs() <= 1.0
        better = ok & (u < u_best)
        u_best = torch.where(better, u, u_best)
        hit |= better
    u_best = torch.where(inside, 0.0, u_best)
    entry = torch.clamp(ray_dir * u_best[..., None] + origin, -1.0, 1.0)
    entry = torch.where(inside[..., None], origin, entry)
    return entry, hit | inside


def compute_target_hit(origin: torch.Tensor, target: torch.Tensor,
                       ray_dir: torch.Tensor) -> torch.Tensor:
    """t at which the ray reaches the target's face plane (RayMarch.hlsli:178-183)."""
    return ((target - origin) / ray_dir).amax(dim=-1)


def cast_light_ray(density: torch.Tensor, transm0: torch.Tensor, origin: torch.Tensor,
                   ray_dir: torch.Tensor, step_scale: torch.Tensor, max_samples: int,
                   num_samples: torch.Tensor, config: FluidConfig,
                   alive: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Transmittance along secondary rays (CastLightRay, RayMarch.hlsli:215-247).
    density (1, Z, Y, X); origin (..., 3) local space; ray_dir (..., 3) or
    (3,); step_scale and num_samples device scalars.  A ray starts alive
    where transm0 >= zero_threshold (and `alive`, where given: rays whose
    result the caller discards need not march).  Returns (...,)."""
    absorb = config.absorption
    zero = config.zero_threshold
    ray_dir = ray_dir.expand(origin.shape)
    t = step_scale.expand(origin.shape[:-1])
    transm = transm0
    prev = torch.zeros_like(transm0)
    live = transm0 >= zero
    if alive is not None:
        live = live & alive
    for i in range(max_samples):
        live = live & (num_samples > i)
        pos = origin + ray_dir * t[..., None]
        live = live & (pos.abs() <= 1.0).all(dim=-1)
        if not bool(live.any()):
            break
        d = trilinear_sample(density, local_to_tex(pos))[0]
        new_step = get_step(d - prev, transm, d, step_scale)
        transm = torch.where(live, transm * (1.0 - d * absorb), transm)
        live = live & (transm >= zero)
        t = torch.where(live, t + new_step, t)
        prev = torch.where(live, d, prev)
    return transm


def eval_light_merged(grid: torch.Tensor, pos: torch.Tensor, env: LightEnv,
                      light_step: torch.Tensor, max_light_samples: int,
                      num_light_samples: torch.Tensor, config: FluidConfig,
                      alive: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Light at samples `pos` (..., 3) in merged mode (GetLight,
    RayMarch.hlsli:261-295): a shadow ray toward the light, plus, with the
    probe, SH irradiance along the negated density gradient times an AO
    ray along it, else the flat ambient.  Only rays in `alive` march."""
    density = grid[-1:]
    ones = torch.ones(pos.shape[:-1], dtype=pos.dtype, device=pos.device)
    shadow = cast_light_ray(density, ones, pos, light_direction_at(env, pos), light_step,
                            max_light_samples, num_light_samples, config, alive)
    light = env.light_color * shadow[..., None]
    if not env.has_probe:
        return light + env.ambient
    irradiance, ao = probe_terms(grid, pos, env, light_step, max_light_samples,
                                 num_light_samples, config, alive)
    return light + irradiance * ao[..., None]


def probe_terms(grid: torch.Tensor, pos: torch.Tensor, env: LightEnv,
                light_step: torch.Tensor, max_light_samples: int,
                num_light_samples: torch.Tensor, config: FluidConfig,
                alive: Optional[torch.Tensor] = None):
    """The light probe's terms at `pos` (..., 3) (RayMarch.hlsli:270-290):
    the SH irradiance (..., 3) along the negated density gradient (the
    position where the gradient is 0), rotated to world space, and the AO
    ray's transmittance (...,) along the normalised gradient."""
    grad = -density_gradient(grid, local_to_tex(pos))
    # Avoid a zero gradient in uniform regions (RayMarch.hlsli:279).
    grad = torch.where((grad == 0.0).all(dim=-1, keepdim=True), pos, grad)
    world_dir = transform_vector(grad, env.world3x3)
    world_dir = world_dir / torch.clamp_min(norm3(world_dir), 1e-12)
    irradiance = evaluate_sh_irradiance(env.sh_coeffs, world_dir)
    grad_n = grad / torch.clamp_min(norm3(grad), 1e-12)
    ones = torch.ones(pos.shape[:-1], dtype=pos.dtype, device=pos.device)
    ao = cast_light_ray(grid[-1:], ones, pos, grad_n, light_step, max_light_samples,
                        num_light_samples, config, alive)
    return irradiance, ao


def view_march(grid: torch.Tensor, origin: torch.Tensor, ray_dir: torch.Tensor,
               t_max: torch.Tensor, num_samples: torch.Tensor, env: LightEnv,
               config: FluidConfig, light_map: Optional[torch.Tensor] = None,
               num_light_samples: Optional[torch.Tensor] = None,
               active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Primary view-ray march (CSRayMarch.hlsl:141-193, PSRayCast.hlsl:69-124).

    grid (4, Z, Y, X) premultiplied RGBA in the render dtype; origin and
    ray_dir (..., 3) local-space entry points and directions; t_max (...,)
    exit distances; light_map (3, Z', Y', X') selects the separate-light
    mode, else each sample casts its own shadow (and AO) rays; active (...,)
    masks rays off.  Returns (..., 4) premultiplied in-scattered radiance,
    rgb already / (2 pi), zero where inactive."""
    absorb = config.absorption
    zero = config.zero_threshold
    dtype, dev = origin.dtype, origin.device
    step_scale = step_size(num_samples, dtype)
    light_step = None if num_light_samples is None else step_size(num_light_samples, dtype)
    if active is None:
        active = torch.ones(origin.shape[:-1], dtype=torch.bool, device=dev)
    t = torch.zeros(origin.shape[:-1], dtype=dtype, device=dev)
    scatter = torch.zeros(origin.shape[:-1] + (4,), dtype=dtype, device=dev)
    prev = torch.zeros_like(t)
    alive = active
    for i in range(config.max_ray_samples):
        alive = alive & (num_samples > i)
        pos = origin + ray_dir * t[..., None]
        alive = alive & (pos.abs() <= 1.0).all(dim=-1)
        if not bool(alive.any()):
            break
        uvw = local_to_tex(pos)
        color = trilinear_sample(grid, uvw).movedim(0, -1)
        dens = color[..., 3]
        hit = alive & (dens > zero)
        if light_map is not None:
            light = trilinear_sample(light_map, uvw).movedim(0, -1)
        else:
            light = eval_light_merged(grid, pos, env, light_step, config.max_light_samples,
                                      num_light_samples, config, alive=hit)
        transm = 1.0 - scatter[..., 3]
        new_step = torch.where(hit, get_step(dens - prev, transm, dens, step_scale),
                               step_scale)
        rgb = color[..., :3]
        if not config.pre_multiplied:
            rgb = rgb * color[..., 3:4]
        contrib = torch.cat([rgb * light, color[..., 3:4]], dim=-1) * (absorb * transm)[..., None]
        scatter = torch.where(hit[..., None], scatter + contrib, scatter)
        # The opacity early-out happens on dense samples only (CSRayMarch.hlsl:186).
        alive = alive & ~(hit & (1.0 - scatter[..., 3] < zero))
        t_new = t + new_step
        alive = alive & (t_new <= t_max)
        t = torch.where(alive, t_new, t)
        prev = torch.where(hit, dens, prev)
    inv_2pi = 1.0 / (2.0 * math.pi)
    scatter = scatter * device_constant((inv_2pi, inv_2pi, inv_2pi, 1.0), dtype, dev)
    return torch.where(active[..., None], scatter, 0.0)


def march_view(grid: torch.Tensor, origin: torch.Tensor, ray_dir: torch.Tensor,
               t_max: torch.Tensor, num_samples: torch.Tensor, env: LightEnv,
               config: FluidConfig, light_map: Optional[torch.Tensor] = None,
               num_light_samples: Optional[torch.Tensor] = None,
               active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`view_march` on the grid's device: kernel R1 for a CUDA grid (in its
    storage dtype, with a contiguous f32 light map of its own dims), the
    plain version in the render dtype for a CPU grid.  Both keep autograd's
    graph (the casts are differentiable): on the card, where the grid or
    the light map requires grad, R1 runs as an autograd Function whose
    backward is R1b (separate mode only)."""
    if active is None:
        active = torch.ones(origin.shape[:-1], dtype=torch.bool, device=origin.device)
    if grid.device.type == "cpu":
        lm = None if light_map is None else light_map.to(config.render_dtype)
        return view_march(grid.to(config.render_dtype), origin, ray_dir, t_max, num_samples,
                          env, config, light_map=lm, num_light_samples=num_light_samples,
                          active=active)
    lm = None if light_map is None else light_map.to(torch.float32).contiguous()
    return cuda_raymarch.view_march(grid, origin, ray_dir, t_max, active, num_samples,
                                    pack_env(env), env_flags(env, config), config,
                                    light_map=lm, num_light_samples=num_light_samples)
