"""The faithful stack's per-ray marches: kernels R1 (`view_march`) and R2
(`light_march`).

These replace no TPU kernel: they replace the JAX package's XLA scans of
fluidx12_tpu/render/raymarch_core.py `view_march` (:337-420; in merged
mode nesting `cast_light_ray`'s scan per sample) and of
fluidx12_tpu/render/lightmap.py `render_light_map` (:36-108), which as
plain PyTorch would be hundreds of thousands of launches a frame.  R1 is
laid out by `view_plan` (persistent warps that fetch rays by 8 x 4 tiles
from a per-launch counter), R2 by `light_plan` (a CTA a brick of voxels, its dense ones
queued and marched as full warps).  `view_march_perthread` and `light_march_perthread`
keep the one-thread-a-ray designs they replaced as yardsticks.  The Hopper
designs and what bounds them: fluidx12_tpu_torch/csrc/raymarch.cu.

Unlike the other wrappers here, these two launch only: their plain
versions march with the render layer's machinery, so they live beside
their JAX counterparts (render/raymarch_core.view_march and
render/lightmap.light_map_plain), and render/ takes them for a CPU tensor
(`raymarch_core.march_view`, `lightmap.render_light_map`).  The light
environment arrives packed, one (48,) f32 tensor made on the frame's device
by tensor ops (render/raymarch_core.pack_env), with its switches as
`flags`; the sample counts are device int32 scalars, so a frame copies
nothing from the host.

Under autograd (`torch.is_grad_enabled()` and the grid or the light map
requiring grad) `view_march` and `light_march` run as autograd Functions:
the forward launches R1 or R2 exactly as without grad, and the backward
launches R1b (`view_march_grad`) or R2b (`light_march_grad`), the hand
adjoints in fluidx12_tpu_torch/csrc/raymarch_grad.cu.  The merged march and
the light probe have no adjoint on the card yet (ROADMAP.md queue A, item
6b): they raise under grad, as do gradients asked of the rays or the light
environment.  R1b and R2b add their cotangents by f32 atomicAdd, whose
order varies from run to run, so under
`torch.use_deterministic_algorithms(True)` their backwards raise before
launching (or warn, with `warn_only=True`), as torch's own atomic CUDA
backwards do (`check_deterministic`).
"""

from __future__ import annotations

import functools
import math
import warnings
from typing import NamedTuple, Optional

import torch

from fluidx12_tpu_torch.core.config import FluidConfig
from fluidx12_tpu_torch.ops.cuda import _build

# The switches `flags` carries (csrc/raymarch.cu's Flags).
FLAG_PREMULTIPLIED, FLAG_PROBE, FLAG_POINT_LIGHT = 1, 2, 4
ENV_SIZE = 48

# ---------------------------------------------------------------------------
# The launch plans (csrc/raymarch.cu's constants)
# ---------------------------------------------------------------------------

# R1: CTAs of VIEW_THREADS threads, as many as the card holds at once (or
# fewer where the rays are fewer); a warp's rays are a tile of TILE_RAYS,
# tile_w x TILE_RAYS / tile_w of the rays' (rows, cols) plane, tile_w one
# of TILE_WIDTHS (8 x 4 tiles, or 32 x 1 where the plane has fewer than 4
# rows); a warp fetches once all its lanes are idle.
VIEW_THREADS = 128
TILE_RAYS = 32
TILE_WIDTHS = (8, 32)
# R2: CTAs of LIGHT_WARPS warps, each a brick of BRICK_X x by x bz voxels,
# by * bz at most MAX_BRICK_ROWS; the plan's (by, bz) is BRICK_YZ, or
# BRICK_YZ_PROBE with the light probe (a dense voxel then marches two rays,
# and half the brick keeps its CTA's queue to one voxel a lane).
LIGHT_WARPS = 8
BRICK_X = 32
MAX_BRICK_ROWS = 32
BRICK_YZ = (4, 4)
BRICK_YZ_PROBE = (4, 2)
# Tap offsets are 32-bit below this many values a grid's channels hold.
OFFSETS_32 = 1 << 31


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class ViewPlan(NamedTuple):
    """How R1 orders an (rows, cols) plane of rays (`view_plan`)."""
    rows: int
    cols: int
    tile_w: int     # tile columns; a tile is tile_w x TILE_RAYS // tile_w rays
    tiles_x: int
    tiles_y: int
    wide: bool      # 64-bit tap offsets

    @property
    def slots(self) -> int:
        return TILE_RAYS * self.tiles_x * self.tiles_y


def view_layout(rows: int, cols: int, tile_w: int, wide: bool = False) -> ViewPlan:
    """The plan of `tile_w`-wide tiles on an (rows, cols) plane of rays:
    `view_plan`'s own, or one forced; not checked here (fx_view_march
    refuses what its kernel does not take)."""
    tile_h = TILE_RAYS // tile_w if tile_w > 0 else 1
    return ViewPlan(rows, cols, tile_w, _cdiv(cols, max(tile_w, 1)), _cdiv(rows, tile_h), wide)


def _lead_plane(lead) -> tuple:
    """(rows, cols) of rays of leading shape `lead`: the last axis along a
    row, the others' product down the rows."""
    lead = tuple(int(d) for d in lead)
    return (math.prod(lead[:-1]), lead[-1]) if lead else (1, 1)


@functools.lru_cache(maxsize=None)
def view_plan(lead: tuple, grid_zyx: tuple, map_zyx: Optional[tuple] = None) -> ViewPlan:
    """The launch plan of R1 on rays of leading shape `lead` ((6, R, R)
    cube texels, (H, W) screen rows, (N,)), over a (4, *grid_zyx) grid and
    a (3, *map_zyx) light map, if any.  Slot s of the launch is ray
    s % TILE_RAYS of tile s // TILE_RAYS (row-major in the tile, tiles
    row-major); a warp whose lanes are all idle takes the next slots from a
    counter, one a lane.  Offsets are 64-bit only where 32-bit ones do not
    reach every tap.  Cached: the wrapper asks on every call.  Raises
    ValueError where no plan fits: no rays, or 2^31 slots or more."""
    rows, cols = _lead_plane(lead)
    if rows < 1 or cols < 1:
        raise ValueError(f"view_plan: no plan for rays of shape {lead}")
    wide = (4 * math.prod(grid_zyx) >= OFFSETS_32
            or (map_zyx is not None and 3 * math.prod(map_zyx) >= OFFSETS_32))
    plan = view_layout(rows, cols, 8 if rows >= TILE_RAYS // 8 else 32, wide=wide)
    if plan.slots >= OFFSETS_32:
        raise ValueError(f"view_plan: no plan for rays of shape {lead}")
    return plan


class LightPlan(NamedTuple):
    """How R2 cuts a (Z, Y, X) grid into bricks (`light_plan`)."""
    by: int
    bz: int
    bricks: tuple   # (along x, along y, along z); a CTA each, x fastest
    wide: bool


def light_layout(zyx, by: int, bz: int, wide: bool = False) -> LightPlan:
    """The plan of BRICK_X x by x bz bricks on a (Z, Y, X) grid:
    `light_plan`'s own, or one forced; not checked here (fx_light_march
    refuses what its kernel does not take)."""
    z, y, x = (int(d) for d in zyx)
    return LightPlan(by, bz, (_cdiv(x, BRICK_X), _cdiv(y, max(by, 1)), _cdiv(z, max(bz, 1))),
                     wide)


@functools.lru_cache(maxsize=None)
def light_plan(zyx: tuple, probe: bool = False) -> LightPlan:
    """The launch plan of R2 on a (4, *zyx) grid, with the light probe or
    without.  CTA (i, j, k) owns voxels
    x in [BRICK_X i, + BRICK_X), y in [by j, + by), z in [bz k, + bz),
    where inside the grid: warp w tests rows w, w + LIGHT_WARPS, ... of the brick
    (row r at y = by j + r % by, z = bz k + r // by; one voxel a lane),
    writes the light of every empty voxel and queues the dense ones in
    shared memory; then the warps march the queue 32 voxels at a time.
    Cached.  Raises ValueError where no plan fits: an empty grid, 2^31
    bricks or more."""
    z, y, x = (int(d) for d in zyx)
    if min(z, y, x) < 1:
        raise ValueError(f"light_plan: no plan for a {zyx} grid")
    plan = light_layout(zyx, *(BRICK_YZ_PROBE if probe else BRICK_YZ),
                        wide=4 * z * y * x >= OFFSETS_32)
    if math.prod(plan.bricks) >= OFFSETS_32:
        raise ValueError(f"light_plan: no plan for a {zyx} grid")
    return plan


# ---------------------------------------------------------------------------
# R1 and R2
# ---------------------------------------------------------------------------

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


def _view_operands(grid, origin, ray_dir, t_max, active, num_samples, env, light_map,
                   num_light_samples, samples, name: str):
    """Checks R1's operands; returns the rays as (n, ...) views, n and the
    rays' leading shape."""
    if light_map is None and num_light_samples is None:
        raise ValueError(f"{name}: merged mode needs num_light_samples")
    counts = [num_samples] + ([] if num_light_samples is None else [num_light_samples])
    _check(grid, env, counts, name)
    dev = grid.device
    lead = tuple(origin.shape[:-1])
    n = math.prod(lead)
    rays = [origin.reshape(n, 3), ray_dir.reshape(n, 3), t_max.reshape(n), active.reshape(n)]
    if (any(r.device != dev or not r.is_contiguous() for r in rays)
            or any(r.dtype != torch.float32 for r in rays[:3]) or rays[3].dtype != torch.bool):
        raise ValueError(f"{name}: origin, ray_dir, t_max (f32) and active (bool) must be "
                         "contiguous on the grid's device")
    if light_map is not None and (light_map.ndim != 4 or light_map.shape[0] != 3
                                  or light_map.dtype != torch.float32
                                  or not light_map.is_contiguous() or light_map.device != dev):
        raise ValueError(f"{name}: light_map must be a contiguous f32 (3, Z, Y, X) "
                         "tensor on the grid's device")
    if samples is not None and (samples.dtype != torch.int32 or samples.numel() != 3 * n
                                or not samples.is_contiguous() or samples.device != dev):
        raise ValueError(f"{name}: samples must be a contiguous int32 (..., 3) tensor")
    return rays, n, lead


def _view_common(grid, rays, n, light_map, env, num_samples, num_light_samples, out, samples,
                 flags, config) -> list:
    """fx_view_march's arguments up to its plan."""
    lm_dims = (0, 0, 0) if light_map is None else tuple(light_map.shape[1:])
    return [grid.data_ptr(), int(grid.dtype == torch.bfloat16), *grid.shape[1:],
            None if light_map is None else light_map.data_ptr(), *lm_dims, env.data_ptr(),
            *(r.data_ptr() for r in rays), num_samples.data_ptr(),
            None if num_light_samples is None else num_light_samples.data_ptr(),
            out.data_ptr(), None if samples is None else samples.data_ptr(), n,
            config.max_ray_samples, config.max_light_samples, float(config.absorption),
            float(config.zero_threshold), flags]


def _view_launch(plan, grid, origin, ray_dir, t_max, active, num_samples, env, flags, config,
                 light_map=None, num_light_samples=None, samples=None, name: str = "view_march"):
    """R1 with `plan`: a ViewPlan as given, "own" for `view_plan`'s, None
    for the per-thread design; returns (out, error code)."""
    rays, n, lead = _view_operands(grid, origin, ray_dir, t_max, active, num_samples, env,
                                   light_map, num_light_samples, samples, name)
    if plan == "own":
        plan = view_plan(lead, tuple(grid.shape[1:]),
                         None if light_map is None else tuple(light_map.shape[1:]))
    out = torch.empty(lead + (4,), dtype=torch.float32, device=grid.device)
    args = _view_common(grid, rays, n, light_map, env, num_samples, num_light_samples, out,
                        samples, flags, config)
    if plan is None:
        err = _build.lib().fx_view_march_perthread(*args, _build.stream_ptr(grid))
    else:
        err = _build.lib().fx_view_march(*args, plan.rows, plan.cols, plan.tile_w,
                                         int(plan.wide), _build.stream_ptr(grid))
    return out, err


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _refuse_unported_grad(name: str, what: str) -> None:
    raise NotImplementedError(
        f"{name}: no adjoint on the card yet for {what} (ROADMAP.md queue A, item 6b). "
        "Differentiate a separate-light method without the light probe "
        "(RAY_MARCH_SEPARATE, RAY_MARCH_DIRECT_SEPARATE), or run on the CPU")


def check_deterministic(name: str) -> None:
    """Refuse an adjoint kernel that accumulates by atomics under
    `torch.use_deterministic_algorithms(True)`, as torch's own CUDA
    backwards that do (`grid_sample`'s among them) refuse: a RuntimeError
    naming the kernel, or a warning under `warn_only=True`.  Both flags
    are read here, before any launch."""
    if not torch.are_deterministic_algorithms_enabled():
        return
    msg = (f"{name} does not have a deterministic implementation (it adds its "
           "cotangents by f32 atomicAdd, in an order that varies from run to run), but "
           "you set 'torch.use_deterministic_algorithms(True)'. You can turn off "
           "determinism just for this operation, or you can use the 'warn_only=True' "
           "option, if that's acceptable for your application.")
    if torch.is_deterministic_algorithms_warn_only_enabled():
        warnings.warn(msg)
    else:
        raise RuntimeError(msg)


def _refuse_operand_grad(name: str, *tensors) -> None:
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the adjoint on the card gives the gradients of the grid and the light "
            "map only, not of the rays or the light environment")


class _ViewMarchFn(torch.autograd.Function):
    """R1 forward, R1b backward: the cotangents of the grid and the light map."""

    @staticmethod
    def forward(ctx, grid, light_map, origin, ray_dir, t_max, active, num_samples, env, flags,
                config, samples):
        ctx.save_for_backward(grid, light_map, origin, ray_dir, t_max, active, num_samples, env)
        ctx.flags, ctx.config = flags, config
        return _view_forward(grid, origin, ray_dir, t_max, active, num_samples, env, flags,
                             config, light_map, None, samples)

    @staticmethod
    def backward(ctx, grad_out):
        check_deterministic("view_march_grad (R1b)")
        grid, light_map, *rest = ctx.saved_tensors
        g_grid, g_lm = view_march_grad(grid, light_map, *rest, ctx.flags, ctx.config, grad_out)
        return ((g_grid.to(grid.dtype) if ctx.needs_input_grad[0] else None,
                 g_lm if ctx.needs_input_grad[1] else None) + (None,) * 9)


class _LightMarchFn(torch.autograd.Function):
    """R2 forward, R2b backward: the cotangent of the grid (its density)."""

    @staticmethod
    def forward(ctx, grid, env, flags, num_light_samples, config, samples):
        ctx.save_for_backward(grid, env, num_light_samples)
        ctx.flags, ctx.config = flags, config
        return _light_forward(grid, env, flags, num_light_samples, config, samples)

    @staticmethod
    def backward(ctx, grad_out):
        check_deterministic("light_march_grad (R2b)")
        grid, env, num_light_samples = ctx.saved_tensors
        g_grid = light_march_grad(grid, env, ctx.flags, num_light_samples, ctx.config, grad_out)
        return (g_grid.to(grid.dtype),) + (None,) * 5


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
    view samples and light-ray samples taken (the bound's count).  One
    launch, laid out by `view_plan`; launches on one device must follow
    each other on one stream (they share the fetch counter).  Under
    autograd, where the grid or the light map requires grad, the same
    launch runs in an autograd Function whose backward is R1b; the merged
    mode raises there."""
    if _wants_grad(grid, light_map, origin, ray_dir, t_max, env):
        if light_map is None:
            _refuse_unported_grad("view_march", "the merged march (a shadow ray a sample)")
        _refuse_operand_grad("view_march", origin, ray_dir, t_max, env)
        return _ViewMarchFn.apply(grid, light_map, origin, ray_dir, t_max, active, num_samples,
                                  env, flags, config, samples)
    return _view_forward(grid, origin, ray_dir, t_max, active, num_samples, env, flags, config,
                         light_map, num_light_samples, samples)


def _view_forward(grid, origin, ray_dir, t_max, active, num_samples, env, flags, config,
                  light_map, num_light_samples, samples) -> torch.Tensor:
    """R1's launch, counted."""
    out, err = _view_launch("own", grid, origin, ray_dir, t_max, active, num_samples, env, flags,
                            config, light_map, num_light_samples, samples)
    view_march.launches += 1
    _build.check(err, "fx_view_march")
    return out


view_march.launches = 0


def view_march_perthread(*args, **kwargs) -> torch.Tensor:
    """The design R1 replaced, one thread a ray in storage order
    (`fx_view_march_perthread`), kept only as a yardstick to time it
    against.  Arguments as `view_march`.  No path of the port calls it,
    and it counts no launch."""
    _build.refuse_grad("view_march_perthread", *args[:6], *kwargs.values())
    out, err = _view_launch(None, *args, name="view_march_perthread", **kwargs)
    _build.check(err, "fx_view_march_perthread")
    return out


def _light_launch(plan, grid, env, flags, num_light_samples, config, samples=None,
                  name: str = "light_march"):
    """R2 with `plan`: a LightPlan as given, "own" for `light_plan`'s, None
    for the per-thread design; returns (out, error code)."""
    _check(grid, env, [num_light_samples], name)
    if plan == "own":
        plan = light_plan(tuple(grid.shape[1:]), bool(flags & FLAG_PROBE))
    if samples is not None and (samples.dtype != torch.int32
                                or samples.numel() != grid[0].numel()
                                or not samples.is_contiguous() or samples.device != grid.device):
        raise ValueError(f"{name}: samples must be a contiguous int32 (Z, Y, X) tensor")
    out = torch.empty((3,) + tuple(grid.shape[1:]), dtype=torch.float32, device=grid.device)
    args = [grid.data_ptr(), int(grid.dtype == torch.bfloat16), *grid.shape[1:], env.data_ptr(),
            num_light_samples.data_ptr(), out.data_ptr(),
            None if samples is None else samples.data_ptr(), config.max_light_samples,
            float(config.absorption), float(config.zero_threshold), flags]
    if plan is None:
        err = _build.lib().fx_light_march_perthread(*args, _build.stream_ptr(grid))
    else:
        err = _build.lib().fx_light_march(*args, plan.by, plan.bz, int(plan.wide),
                                          _build.stream_ptr(grid))
    return out, err


def light_march(grid: torch.Tensor, env: torch.Tensor, flags: int,
                num_light_samples: torch.Tensor, config: FluidConfig,
                samples: Optional[torch.Tensor] = None) -> torch.Tensor:
    """R2: the (3, Z, Y, X) f32 light map of the (4, Z, Y, X) colour grid
    in its storage dtype (bf16 or f32) (render/lightmap.light_map_plain);
    env and flags the packed light environment; num_light_samples an
    int32 device scalar.  `samples` (int32, (Z, Y, X)), where given,
    receives each voxel's light samples taken.  One launch, laid out by
    `light_plan`.  Under autograd, where the grid requires grad, the same
    launch runs in an autograd Function whose backward is R2b; the light
    probe raises there."""
    if _wants_grad(grid, env):
        if flags & FLAG_PROBE:
            _refuse_unported_grad("light_march", "the light probe (the AO ray and the SH "
                                  "irradiance along the density gradient)")
        _refuse_operand_grad("light_march", env)
        return _LightMarchFn.apply(grid, env, flags, num_light_samples, config, samples)
    return _light_forward(grid, env, flags, num_light_samples, config, samples)


def _light_forward(grid, env, flags, num_light_samples, config, samples) -> torch.Tensor:
    """R2's launch, counted."""
    out, err = _light_launch("own", grid, env, flags, num_light_samples, config, samples)
    light_march.launches += 1
    _build.check(err, "fx_light_march")
    return out


light_march.launches = 0


def light_march_perthread(*args, **kwargs) -> torch.Tensor:
    """The design R2 replaced, one thread a voxel (`fx_light_march_perthread`),
    kept only as a yardstick to time it against.  Arguments as
    `light_march`.  No path of the port calls it, and it counts no launch."""
    _build.refuse_grad("light_march_perthread", *args[:2])
    out, err = _light_launch(None, *args, name="light_march_perthread", **kwargs)
    _build.check(err, "fx_light_march_perthread")
    return out


# ---------------------------------------------------------------------------
# R1b and R2b: the adjoints (csrc/raymarch_grad.cu)
# ---------------------------------------------------------------------------

# R1b: persistent warps in CTAs of VIEW_GRAD_THREADS on tiles of
# VIEW_GRAD_TILE_W x 32 / VIEW_GRAD_TILE_W rays (`view_grad_plan`).  R2b:
# persistent warps in CTAs of LIGHT_GRAD_WARPS, each taking bricks of 32 x
# by x bz voxels (`light_grad_plan`, LIGHT_GRAD_BRICK, by * bz at most
# MAX_WARP_ROWS) in a stride of the launch's warps.  Each kernel's launch
# bounds ask for VIEW_GRAD_CTAS or LIGHT_GRAD_CTAS CTAs an SM.  A lane of
# either owns a tape slot of max samples entries of TAPE_FLOATS f32 (t,
# the opacity or transmittance, prev) for the whole launch.
VIEW_GRAD_THREADS = 128
VIEW_GRAD_CTAS = 4
VIEW_GRAD_TILE_W = 32
LIGHT_GRAD_WARPS = 8
LIGHT_GRAD_CTAS = 4
MAX_WARP_ROWS = 8
LIGHT_GRAD_BRICK = (2, 1)
TAPE_FLOATS = 3
# R1b's lanes merge their atomics at one offset (csrc/raymarch_grad.cu's
# kTree) where an image of rays has MERGE_RAYS_PER_VOXEL rays or more for
# each voxel of the grid's largest face: neighbouring rays then cross the
# same cells (`view_grad_merges`).  R2b's lanes always merge theirs (kShiftX).
# `tools/sweep_raymarch_plans.py --grad` times both ways at 1 (the cube
# faces), 2.25, 4.0, 9.8, 19.1, 25 and 39 (the 800^2 screen) rays a voxel
# of 128^3's largest face: merging loses up to 9.8 and wins on dense smoke
# from 19.1 (PERF.md §6).
MERGE_RAYS_PER_VOXEL = 16
# fx_raymarch_grad_occupancy's kernels.
GRAD_KERNELS = {"view_march_grad": 0, "light_march_grad": 1, "view_march_grad_perthread": 2,
                "light_march_grad_perthread": 3}


def grad_tape_floats(resident_ctas: int, threads: int, work_ctas: int, max_samples: int) -> int:
    """The f32 values of tape a launch of R1b or R2b needs (csrc/
    raymarch_grad.cu's tape_floats, which the launch checks): a slot of
    `max_samples` entries of TAPE_FLOATS for each lane of the
    min(resident_ctas, work_ctas) CTAs of `threads` it runs."""
    return min(resident_ctas, work_ctas) * threads * max_samples * TAPE_FLOATS


@functools.lru_cache(maxsize=None)
def view_grad_plan(lead: tuple, grid_zyx: tuple, map_zyx: tuple) -> ViewPlan:
    """R1b's launch plan on rays of leading shape `lead` over a (4,
    *grid_zyx) grid and a (3, *map_zyx) light map: `view_plan`'s with
    tiles VIEW_GRAD_TILE_W wide.  Cached."""
    plan = view_plan(lead, grid_zyx, map_zyx)
    return view_layout(plan.rows, plan.cols, VIEW_GRAD_TILE_W, plan.wide)


def view_grad_merges(lead: tuple, grid_zyx: tuple) -> bool:
    """Whether R1b's lanes merge their atomics on rays of leading shape
    `lead` over a (4, *grid_zyx) grid: where one image of the rays (the
    last two axes) holds MERGE_RAYS_PER_VOXEL rays or more for each voxel
    of the grid's largest face (the 800^2 screen over 128^3; not the cube
    faces' 128^2 texels)."""
    z, y, x = (int(d) for d in grid_zyx)
    image = math.prod(int(d) for d in lead[-2:])
    return image >= MERGE_RAYS_PER_VOXEL * max(z * y, z * x, y * x)


@functools.lru_cache(maxsize=None)
def light_grad_plan(zyx: tuple) -> LightPlan:
    """R2b's launch plan on a (4, *zyx) grid: bricks of BRICK_X x
    LIGHT_GRAD_BRICK voxels (x fastest), a warp's unit of work; warp w of
    the launch's W takes bricks w, w + W, ...  Cached.  Raises ValueError
    where no plan fits."""
    z, y, x = (int(d) for d in zyx)
    if min(z, y, x) < 1:
        raise ValueError(f"light_grad_plan: no plan for a {zyx} grid")
    plan = light_layout(zyx, *LIGHT_GRAD_BRICK, wide=4 * z * y * x >= OFFSETS_32)
    if math.prod(plan.bricks) >= OFFSETS_32:
        raise ValueError(f"light_grad_plan: no plan for a {zyx} grid")
    return plan


@functools.lru_cache(maxsize=None)
def _occupancy(kernel: str, bf16: bool, wide: bool, merge: bool, device: int) -> dict:
    import ctypes

    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        err = _build.lib().fx_raymarch_grad_occupancy(GRAD_KERNELS[kernel], int(bf16), int(wide),
                                                      int(merge), out)
    _build.check(err, "fx_raymarch_grad_occupancy")
    return dict(ctas_per_sm=out[0], threads=out[1], registers=out[2], local_bytes=out[3],
                sms=out[4])


def grad_occupancy(kernel: str, grid: torch.Tensor, wide: bool = False,
                   merge: bool = False) -> dict:
    """What cudaFuncGetAttributes and cudaOccupancyMaxActiveBlocksPerMultiprocessor
    say of `kernel` (a key of GRAD_KERNELS) for `grid`'s storage type on its
    card: CTAs an SM, threads a CTA, registers a thread, local (spilled)
    bytes a thread, the card's SMs (R1b's with `merge` as its launch's).
    Cached."""
    return dict(_occupancy(kernel, grid.dtype == torch.bfloat16, bool(wide), bool(merge),
                           grid.device.index or 0))


def _cotangent(grad_out: torch.Tensor, shape, ref: torch.Tensor, name: str) -> torch.Tensor:
    """grad_out as a contiguous f32 tensor of `shape` on ref's device whose
    start is 16-byte aligned (R1b reads it as float4)."""
    if tuple(grad_out.shape) != tuple(shape) or grad_out.device != ref.device:
        raise ValueError(f"{name}: the cotangent must be {tuple(shape)} on {ref.device}, got "
                         f"{tuple(grad_out.shape)} on {grad_out.device}")
    g = grad_out.to(torch.float32).contiguous()
    return g if g.data_ptr() % 16 == 0 else g.clone()


def _samples_ok(samples, numel: int, ref: torch.Tensor) -> bool:
    return samples is None or (samples.dtype == torch.int32 and samples.numel() == numel
                               and samples.is_contiguous() and samples.device == ref.device)


def view_grad_tape_floats(plan: ViewPlan, grid: torch.Tensor, max_ray: int,
                          merge: bool = False) -> int:
    """The tape R1b's launch under `plan` takes on `grid`'s card."""
    occ = grad_occupancy("view_march_grad", grid, plan.wide, merge)
    return grad_tape_floats(occ["ctas_per_sm"] * occ["sms"], VIEW_GRAD_THREADS,
                            _cdiv(plan.slots, VIEW_GRAD_THREADS), max_ray)


def _view_grad_launch(plan, grid, light_map, origin, ray_dir, t_max, active, num_samples, env,
                      flags, config, grad_out, samples=None, merge: Optional[bool] = None,
                      tape_floats: Optional[int] = None, name: str = "view_march_grad"):
    """R1b with `plan`: a ViewPlan as given, "own" for `view_grad_plan`'s,
    None for the per-thread design; `merge` (None: `view_grad_merges`);
    `tape_floats` forces the scratch's size (else the launch's own).
    Returns (g_grid, g_lm, error code)."""
    if light_map is None:
        raise ValueError(f"{name}: separate mode only (a light map)")
    rays, n, lead = _view_operands(grid, origin, ray_dir, t_max, active, num_samples, env,
                                   light_map, None, None, name)
    if not _samples_ok(samples, 2 * n, grid):
        raise ValueError(f"{name}: samples must be a contiguous int32 (..., 2) tensor")
    g = _cotangent(grad_out, lead + (4,), grid, name)
    own = view_grad_plan(lead, tuple(grid.shape[1:]), tuple(light_map.shape[1:]))
    plan = own if plan == "own" else plan
    if merge is None:
        merge = view_grad_merges(lead, tuple(grid.shape[1:]))
    if plan is None:
        tape_floats = TAPE_FLOATS * config.max_ray_samples * n
    elif tape_floats is None:
        tape_floats = view_grad_tape_floats(plan, grid, config.max_ray_samples, merge)
    g_grid = torch.zeros(grid.shape, dtype=torch.float32, device=grid.device)
    g_lm = torch.zeros(light_map.shape, dtype=torch.float32, device=grid.device)
    tape = torch.empty(max(tape_floats, 1), dtype=torch.float32, device=grid.device)
    args = [grid.data_ptr(), int(grid.dtype == torch.bfloat16), *grid.shape[1:],
            light_map.data_ptr(), *light_map.shape[1:], env.data_ptr(),
            *(r.data_ptr() for r in rays), num_samples.data_ptr(), g.data_ptr(),
            g_grid.data_ptr(), g_lm.data_ptr(), tape.data_ptr()]
    rest = [None if samples is None else samples.data_ptr(), n, config.max_ray_samples,
            float(config.absorption), float(config.zero_threshold), flags]
    if plan is None:
        err = _build.lib().fx_view_march_grad_perthread(*args, *rest, int(own.wide),
                                                        _build.stream_ptr(grid))
    else:
        err = _build.lib().fx_view_march_grad(*args, tape_floats, *rest, plan.rows, plan.cols,
                                              plan.tile_w, int(plan.wide), int(merge),
                                              _build.stream_ptr(grid))
    return g_grid, g_lm, err


def view_march_grad(grid: torch.Tensor, light_map: torch.Tensor, origin: torch.Tensor,
                    ray_dir: torch.Tensor, t_max: torch.Tensor, active: torch.Tensor,
                    num_samples: torch.Tensor, env: torch.Tensor, flags: int,
                    config: FluidConfig, grad_out: torch.Tensor,
                    samples: Optional[torch.Tensor] = None):
    """R1b: the adjoint of `view_march` in separate mode.  From grad_out,
    the (..., 4) cotangent of R1's output on these operands, the f32
    cotangents of the grid (4, Z, Y, X) and of the light map (3, Z', Y',
    X'), as autograd through render/raymarch_core.view_march gives them
    (to rounding: the taps' cotangents are summed by atomics).  `samples`
    (an int32 tensor of (..., 2)), where given, receives each ray's view
    samples run again and dense samples walked (0 and 0 for a ray skipped:
    inactive, or a cotangent of 0).  One launch of persistent warps on
    `view_grad_plan`'s tiles, a tape slot of max_ray_samples entries a
    resident lane (`view_grad_tape_floats`), the lanes' atomics merged
    where `view_grad_merges`; launches on one device must follow each
    other on one stream (they share R1b's fetch counter)."""
    g_grid, g_lm, err = _view_grad_launch("own", grid, light_map, origin, ray_dir, t_max, active,
                                          num_samples, env, flags, config, grad_out, samples)
    view_march_grad.launches += 1
    _build.check(err, "fx_view_march_grad")
    return g_grid, g_lm


view_march_grad.launches = 0


def view_march_grad_perthread(*args, **kwargs):
    """The design R1b replaced, one thread a ray in storage order with a
    tape slot of max_ray_samples entries a ray
    (`fx_view_march_grad_perthread`), kept only as a yardstick to time it
    against.  Arguments as `view_march_grad`.  No path of the port calls
    it, and it counts no launch."""
    g_grid, g_lm, err = _view_grad_launch(None, *args, name="view_march_grad_perthread",
                                          **kwargs)
    _build.check(err, "fx_view_march_grad_perthread")
    return g_grid, g_lm


def light_grad_tape_floats(plan: LightPlan, grid: torch.Tensor, max_light: int) -> int:
    """The tape R2b's launch under `plan` (a brick a warp at a time) takes
    on `grid`'s card."""
    occ = grad_occupancy("light_march_grad", grid, plan.wide)
    return grad_tape_floats(occ["ctas_per_sm"] * occ["sms"], 32 * LIGHT_GRAD_WARPS,
                            _cdiv(math.prod(plan.bricks), LIGHT_GRAD_WARPS), max_light)


def _light_grad_launch(plan, grid, env, flags, num_light_samples, config, grad_out,
                       samples=None, tape_floats: Optional[int] = None,
                       name: str = "light_march_grad"):
    """R2b with `plan`: a LightPlan as given, "own" for `light_grad_plan`'s,
    None for the per-thread design; `tape_floats` forces the scratch's
    size.  Returns (g_grid, error code)."""
    _check(grid, env, [num_light_samples], name)
    if flags & FLAG_PROBE:
        raise ValueError(f"{name}: no light probe")
    if not _samples_ok(samples, grid[0].numel(), grid):
        raise ValueError(f"{name}: samples must be a contiguous int32 (Z, Y, X) tensor")
    g = _cotangent(grad_out, (3,) + tuple(grid.shape[1:]), grid, name)
    own = light_grad_plan(tuple(grid.shape[1:]))
    plan = own if plan == "own" else plan
    if plan is None:
        tape_floats = TAPE_FLOATS * config.max_light_samples * grid[0].numel()
    elif tape_floats is None:
        tape_floats = light_grad_tape_floats(plan, grid, config.max_light_samples)
    g_grid = torch.zeros(grid.shape, dtype=torch.float32, device=grid.device)
    tape = torch.empty(max(tape_floats, 1), dtype=torch.float32, device=grid.device)
    args = [grid.data_ptr(), int(grid.dtype == torch.bfloat16), *grid.shape[1:], env.data_ptr(),
            num_light_samples.data_ptr(), g.data_ptr(), g_grid[3].data_ptr(), tape.data_ptr()]
    rest = [None if samples is None else samples.data_ptr(), config.max_light_samples,
            float(config.absorption), float(config.zero_threshold), flags]
    if plan is None:
        err = _build.lib().fx_light_march_grad_perthread(*args, *rest, int(own.wide),
                                                         _build.stream_ptr(grid))
    else:
        err = _build.lib().fx_light_march_grad(*args, tape_floats, *rest, plan.by, plan.bz,
                                               int(plan.wide), _build.stream_ptr(grid))
    return g_grid, err


def light_march_grad(grid: torch.Tensor, env: torch.Tensor, flags: int,
                     num_light_samples: torch.Tensor, config: FluidConfig,
                     grad_out: torch.Tensor,
                     samples: Optional[torch.Tensor] = None) -> torch.Tensor:
    """R2b: the adjoint of `light_march` without the light probe.  From
    grad_out, the (3, Z, Y, X) cotangent of R2's light map on these
    operands, the f32 (4, Z, Y, X) cotangent of the grid (channels 0-2
    zero), as autograd through render/lightmap.light_map_plain gives it (to
    rounding).  `samples` (int32, (Z, Y, X)), where given, receives each
    voxel's light samples walked (0 where none).  One launch of persistent
    warps on `light_grad_plan`'s bricks, each queueing the dense voxels
    whose cotangent is not 0 and walking them 32 at a time, a tape slot of
    max_light_samples entries a resident lane (`light_grad_tape_floats`)."""
    g_grid, err = _light_grad_launch("own", grid, env, flags, num_light_samples, config,
                                     grad_out, samples)
    light_march_grad.launches += 1
    _build.check(err, "fx_light_march_grad")
    return g_grid


light_march_grad.launches = 0


def light_march_grad_perthread(*args, **kwargs) -> torch.Tensor:
    """The design R2b replaced, one thread a voxel with a tape slot of
    max_light_samples entries a voxel (`fx_light_march_grad_perthread`),
    kept only as a yardstick to time it against.  Arguments as
    `light_march_grad`.  No path of the port calls it, and it counts no
    launch."""
    g_grid, err = _light_grad_launch(None, *args, name="light_march_grad_perthread", **kwargs)
    _build.check(err, "fx_light_march_grad_perthread")
    return g_grid
