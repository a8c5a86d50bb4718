"""Per-pass profiling (mirror of fluidx12_tpu/engine/profiler.py).

`profile_passes(engine)` times every stage of the engine's frame on its
current state and returns milliseconds per call by stage.  On the card a
stage is timed with CUDA events around `reps` back-to-back calls after one
warm call; on the CPU with the host clock.  The engine's state is read,
never changed.
"""

from __future__ import annotations

import time
from typing import Dict

import torch


def _device_of(out) -> torch.device:
    while isinstance(out, (tuple, list)):
        out = out[0]
    return out.device


def time_fn(fn, *args, reps: int = 5) -> float:
    """Mean ms per call of fn(*args) over `reps` calls after one warm call,
    on the device of its result."""
    out = fn(*args)
    if _device_of(out).type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    return (time.perf_counter() - t0) / reps * 1000.0


def profile_passes(engine, reps: int = 5) -> Dict[str, float]:
    """ms per call of each stage of the engine's frame on its current
    state: `advect` (the fast advect or, with `fast_sim` off, the gather
    advect), `project`, and in 3D `light_map` (the sweep, or R2 on the
    faithful stack) where the frame makes one, then under the cube-map
    methods `cube_march` and `resolve` (the JAX function's keys), under the
    DIRECT methods `plane_march` (the base plane's march) and `warp` (its
    warp to the screen) on the fast stack, or `direct_march` (R1's screen
    march) on the faithful stack and with the eye inside the volume; and
    `total`, their sum."""
    from fluidx12_tpu_torch.core.constants import device_constant
    from fluidx12_tpu_torch.core.state import unpack_scene_params
    from fluidx12_tpu_torch.render.cubemap import ray_march_cube
    from fluidx12_tpu_torch.render.lightmap import render_light_map
    from fluidx12_tpu_torch.render.lightmap_sweep import render_light_map_fast
    from fluidx12_tpu_torch.render.pipeline import point_light_ok
    from fluidx12_tpu_torch.render.raycast import ray_cast_direct
    from fluidx12_tpu_torch.render.resolve import resolve_cube
    from fluidx12_tpu_torch.render.screencomp import _warp_plane_to_screen, march_direct_plane
    from fluidx12_tpu_torch.render.slicecomp import ray_march_cube_fast
    from fluidx12_tpu_torch.sim.advect import advect
    from fluidx12_tpu_torch.sim.advect_fast import advect_fields_fast
    from fluidx12_tpu_torch.sim.project import project

    cfg = engine.config
    method = engine.render_method
    packed, lod, vis_mask = engine.update_frame()
    params = unpack_scene_params(packed)
    state = engine.state
    dt = device_constant(float(cfg.time_step), torch.float32, state.fields.device)
    out: Dict[str, float] = {}

    if cfg.fast_sim:
        def adv():
            return advect_fields_fast(state.fields, dt, cfg)
    else:
        def adv():
            return torch.cat(advect(state.fields[:3], state.fields[3:], dt, cfg))
    out["advect"] = time_fn(adv, reps=reps)
    fields = adv()

    # `project` consumes its fields: each call takes its own copy.
    copies = iter([fields.clone() for _ in range(reps + 1)])
    out["project"] = time_fn(
        lambda: project(next(copies), state.pressure, cfg.time_step, cfg), reps=reps)

    if cfg.is_3d:
        grid = fields[3:]
        sh = engine.sh_coeffs
        fast = cfg.fast_render and point_light_ok(cfg)
        spec = None if method.uses_cube_map or not fast else engine._direct_plane_spec(lod)
        light = None
        if method.separate_light_pass or (fast and method.uses_cube_map) or spec is not None:
            lm = render_light_map_fast if fast else render_light_map
            out["light_map"] = time_fn(lm, grid, params, cfg, sh, reps=reps)
            light = lm(grid, params, cfg, sh)
        if method.uses_cube_map:
            if fast:
                def march():
                    return ray_march_cube_fast(grid, params, cfg, light, lod=lod,
                                               static_mask=vis_mask)
            else:
                def march():
                    return ray_march_cube(grid, params, cfg, lod=lod, light_map=light,
                                          sh_coeffs=sh)
            out["cube_march"] = time_fn(march, reps=reps)
            out["resolve"] = time_fn(resolve_cube, march(), params, cfg, reps=reps)
        elif spec is None:
            out["direct_march"] = time_fn(ray_cast_direct, grid, params, cfg, light, sh,
                                          reps=reps)
        else:
            num = (params.num_samples if method.separate_light_pass
                   else device_constant(cfg.max_ray_samples, torch.int32, grid.device))
            out["plane_march"] = time_fn(march_direct_plane, grid, params, cfg, light, spec,
                                         num, reps=reps)
            plane = march_direct_plane(grid, params, cfg, light, spec, num)
            out["warp"] = time_fn(_warp_plane_to_screen, plane, spec, params, cfg,
                                  engine._screen_rect(), reps=reps)

    out["total"] = sum(out.values())
    return out
