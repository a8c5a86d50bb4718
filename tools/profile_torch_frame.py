"""Where the time of one frame of the PyTorch port goes, on one NVIDIA GPU.

    python3 tools/profile_torch_frame.py [--preset fluid3d|fluid2d]
                                         [--grid X Y Z] [--probe]
                                         [--pallas-jacobi 0|1]
                                         [--mg-project-fused] [--method 0-3]
                                         [--point-light] [--light-pos X Y Z]
                                         [--faithful] [--eye-inside] [--frames 10]

Runs `FluidXEngine(PRESETS[preset])` (fluid3d: 128^3 grid, fluid2d:
512x512x1 grid, both with an 800x800 viewport; `--grid` replaces the
preset's grid, `--probe` adds the light probe assets/rnl_cross.npz, so
`--grid 256 256 256 --probe` is bench.py's "FluidGI SH irradiance 256^3",
`--grid 256 256 60 --probe` the 256x256x60 GI frame (B15; stored padded on
the TPU) and `--grid 150 150 150 --probe` PRESETS["fluidgi"];
`--pallas-jacobi 0` takes the projection's twins instead of its kernels
(on grids the TPU does not store padded);
`--mg-project-fused` the fused projection, B18, where its gate holds, as
at 256^3; `--method` the render method by number, 2 and 3 the DIRECT
methods; `--point-light` the point light, lit by the projective sweep in
place of B9, and with `--light-pos` inside the volume (e.g. 5 2 -3) by the
faithful stack; `--faithful` the faithful stack, `toggle_ez()` after
construction (the gather advect, the projection without multigrid, R2
and R1); `--eye-inside` the camera dollied into the volume, where a
DIRECT method takes R1) and prints, each beside the card's name and power
limit:
  - the host ms/frame of the frame replayed from its CUDA graph
    (`step_frame`) and of the same frame op by op (`_frame_eager`), in
    turns (op by op, replayed, op by op, replayed): medians of `--frames`
    steps, each ending in a synchronize, with no profiler attached;
  - each layer's CUDA-event span per call, over 20 back-to-back calls on the
    engine's state.  3D: advect (B1 + B2), projection, light map (B9; with
    the probe also the AO and B16), cube march (B10 per visible face),
    resolve + composite; under a DIRECT method, in place of the last two,
    the plane march with its warp (B10 or B17 once) and the warp +
    composite alone; on the faithful stack the gather advect, R2's light
    map and R1's cube march or screen march.  fluid2d: advect (B11 twice + forces),
    projection (B14), visualize + composite;
  - from `torch.profiler` over `--frames` steps, replayed and then op by
    op: device time and launches per frame (kernels, and copies/sets by
    kind; the sum of their durations and the union of their intervals,
    which counts once the overlap of a programmatic dependent launch with
    the kernel before it), the launches of the port's own kernels that
    start before the kernel before them ends (the programmatic dependent
    launches that took effect), the device busy share, the union per frame
    over the unprofiled frame time (the profiler's own host cost stretches
    the frame it watches, so its wall time is not the denominator); for
    the replayed frames also the 12 kernels with the most device time and
    then the port's own kernels outside them.
Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SPAN_CALLS = 20


def span_ms(fn, calls: int = SPAN_CALLS) -> float:
    """CUDA-event span of the calls fn(0) .. fn(calls - 1), per call, after
    one warm-up call fn(calls)."""
    fn(calls)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(calls):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def profile_frames(step, kind: str, frames: int, frame_ms: float, card: str,
                   top: bool) -> int:
    """torch.profiler over `frames` calls of `step`: device time, busy,
    launches, copies, programmatic dependent launches that took effect and
    busy share per frame (and with `top` the kernels with the most device
    time); 1 where the profiler recorded no device time, else 0."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            step()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    copy_like = [e for e in device if e.name.startswith(("Memcpy", "Memset"))]
    kernels = [e for e in device if not e.name.startswith(("Memcpy", "Memset"))]
    dev_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3 / frames
    if dev_ms == 0.0:
        print(f"[{card}] {kind}: torch.profiler recorded no device time")
        return 1
    # The union of the events' intervals: a kernel started by programmatic
    # dependent launch runs (waiting) while the one before it finishes, so
    # the sum of durations counts that overlap twice.
    busy_us, reach = 0.0, None
    overlaps = 0
    for start, end, name in sorted((e.time_range.start, e.time_range.end, e.name)
                                   for e in device):
        if reach is not None and start < reach and "(anonymous namespace)::" in name:
            overlaps += 1
        if reach is None or start > reach:
            busy_us += end - start
            reach = end
        elif end > reach:
            busy_us += end - reach
            reach = end
    busy_ms = busy_us / 1e3 / frames
    print(f"[{card}] {kind}, profiler: {dev_ms:.3f} ms of device time per frame (sum of "
          f"durations), {busy_ms:.3f} ms busy (their union); "
          f"{len(kernels) / frames:.1f} kernel launches and "
          f"{len(copy_like) / frames:.1f} copies/sets per frame; "
          f"{overlaps / frames:.1f} of the port's own launches a frame start before the "
          f"kernel before them ends; device busy "
          f"{100.0 * busy_ms / frame_ms:.1f}% of the unprofiled frame ({frame_ms:.3f} ms)")
    copies = collections.Counter(e.name for e in copy_like)
    print(f"[{card}] {kind}, copies/sets per frame by kind: " + ", ".join(
        f"{name} {n / frames:.1f}" for name, n in copies.most_common()))
    if not top:
        return 0
    by_name = collections.Counter()
    count = collections.Counter()
    for e in device:
        by_name[e.name] += e.time_range.elapsed_us()
        count[e.name] += 1
    names = [name for name, _ in by_name.most_common(12)]
    # Then the port's own kernels (csrc/*.cu, each in a top-level anonymous
    # namespace) that the 12 longest leave out.
    own = [name for name, _ in by_name.most_common()
           if name not in names and name.startswith(("(anonymous namespace)::",
                                                     "void (anonymous namespace)::"))]
    for name in names + own:
        print(f"  {by_name[name] / 1e3 / frames:8.4f} ms/frame  "
              f"{count[name] / frames:6.1f}x  {name[:110]}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="fluid3d", choices=("fluid3d", "fluid2d"))
    ap.add_argument("--grid", type=int, nargs=3, metavar=("X", "Y", "Z"))
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--pallas-jacobi", type=int, default=1, choices=(0, 1))
    ap.add_argument("--mg-project-fused", action="store_true")
    ap.add_argument("--method", type=int, default=1, choices=(0, 1, 2, 3))
    ap.add_argument("--point-light", action="store_true")
    ap.add_argument("--light-pos", type=float, nargs=3, metavar=("X", "Y", "Z"))
    ap.add_argument("--faithful", action="store_true")
    ap.add_argument("--eye-inside", action="store_true")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_frame: no CUDA device")

    from fluidx12_tpu_torch.core.config import PRESETS, RenderMethod
    from fluidx12_tpu_torch.core.state import unpack_scene_params
    from fluidx12_tpu_torch.engine.fluidx import FluidXEngine
    from fluidx12_tpu_torch.render.cubemap import ray_march_cube
    from fluidx12_tpu_torch.render.lightmap import render_light_map
    from fluidx12_tpu_torch.render.lightmap_sweep import render_light_map_fast
    from fluidx12_tpu_torch.render.pipeline import point_light_ok, render_frame
    from fluidx12_tpu_torch.render.raycast import ray_cast_direct
    from fluidx12_tpu_torch.render.resolve import resolve_cube
    from fluidx12_tpu_torch.render.screencomp import (
        _warp_plane_to_screen,
        ray_cast_direct_fast,
    )
    from fluidx12_tpu_torch.render.slicecomp import ray_march_cube_fast
    from fluidx12_tpu_torch.sim.advect import advect
    from fluidx12_tpu_torch.sim.advect_fast import advect_fields_fast
    from fluidx12_tpu_torch.sim.project import project
    from fluidx12_tpu_torch.utils.image import composite_premultiplied

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    cfg = dataclasses.replace(PRESETS[args.preset], pallas_jacobi=bool(args.pallas_jacobi),
                              has_light_probe=args.probe,
                              mg_project_fused=args.mg_project_fused,
                              point_light=args.point_light)
    if args.grid:
        cfg = dataclasses.replace(cfg, grid_size=tuple(args.grid))
    if args.light_pos:
        cfg = dataclasses.replace(cfg, light_pos=tuple(args.light_pos))
    radiance = None
    if args.probe:
        import numpy as np

        radiance = np.load(Path(__file__).resolve().parents[1] / "assets" / "rnl_cross.npz")[
            "radiance"]
    engine = FluidXEngine(cfg, radiance=radiance)
    engine.render_method = RenderMethod(args.method)
    if args.faithful:
        engine.toggle_ez()
        cfg = engine.config
    if args.eye_inside:
        engine.camera.dolly(15.5)
    for _ in range(args.warmup):
        engine.step_frame()
    torch.cuda.synchronize()

    steps = {"replayed": engine.step_frame, "op by op": engine._frame_eager}
    medians = {kind: [] for kind in steps}
    for kind in ("op by op", "replayed", "op by op", "replayed"):
        times = []
        for _ in range(args.frames):
            t0 = time.perf_counter()
            steps[kind]()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        medians[kind].append(statistics.median(times))
    print(f"[{card}] {args.preset}, grid {cfg.grid_size}, probe {args.probe}, "
          f"pallas_jacobi={cfg.pallas_jacobi}, mg_project_fused={cfg.mg_project_fused}, "
          f"{engine.render_method.name}, point_light={cfg.point_light} at {cfg.light_pos}, "
          f"fast_render={cfg.fast_render}, fast_sim={cfg.fast_sim}, eye inside "
          f"{args.eye_inside}: "
          f"host ms/frame, medians of {args.frames} frames in turns: "
          + "; ".join(f"{kind} {a:.3f}, {b:.3f}" for kind, (a, b) in medians.items()))

    # Per-layer spans on the engine's state, as step_frame calls them.
    st = engine.state
    packed, lod, vis_mask = engine.update_frame()
    params = unpack_scene_params(packed)
    dt = torch.tensor(cfg.time_step, dtype=torch.float32, device=st.fields.device)
    # The projection's input: f32 fields after the gather advect, the
    # storage dtype after the fast one.
    proj_dtype = st.fields.dtype if cfg.fast_sim else torch.float32
    copies = [st.fields.to(proj_dtype).clone() for _ in range(SPAN_CALLS + 1)]
    grid = st.color
    layers = {
        "advect (the gather, plain torch)": lambda _: advect(st.fields[:3], st.fields[3:], dt,
                                                             cfg),
    } if not cfg.fast_sim else {
        "advect (B1 + B2)" if cfg.is_3d else "advect (B11 x2 + forces)":
            lambda _: advect_fields_fast(st.fields, dt, cfg),
    }
    layers.update({
        "projection (B18)" if cfg.mg_project_fused else "projection":
            lambda i: project(copies[i], st.pressure, cfg.time_step, cfg),
    })
    faithful = cfg.is_3d and not (cfg.fast_render and point_light_ok(cfg))
    faithful_direct = (cfg.is_3d and not engine.render_method.uses_cube_map
                       and engine._direct_plane_spec(lod) is None)
    if faithful or faithful_direct:
        sh = engine.sh_coeffs
        bg = torch.tensor(cfg.clear_color[:3], device=grid.device)
        env_bg = engine._env_bg(params)
        light = None
        if engine.render_method.separate_light_pass:
            if faithful:
                layers["light map (R2)"] = lambda _: render_light_map(grid, params, cfg, sh)
                light = render_light_map(grid, params, cfg, sh)
            else:
                layers["light map (B9)"] = lambda _: render_light_map_fast(grid, params, cfg, sh)
                light = render_light_map_fast(grid, params, cfg, sh)
        if engine.render_method.uses_cube_map:
            cube = ray_march_cube(grid, params, cfg, lod=lod, light_map=light, sh_coeffs=sh)
            layers["cube march (R1)"] = lambda _: ray_march_cube(grid, params, cfg, lod=lod,
                                                                 light_map=light, sh_coeffs=sh)

            def resolve(_):
                rgba = resolve_cube(cube, params, cfg, rect=engine._screen_rect())
                back = bg.expand(rgba.shape[:-1] + (3,)) if env_bg is None else env_bg
                return composite_premultiplied(rgba, back)

            layers["resolve + composite"] = resolve
        else:
            layers["screen march (R1)"] = lambda _: ray_cast_direct(grid, params, cfg,
                                                                    light_map=light, sh_coeffs=sh)
    elif cfg.is_3d:
        sh = engine.sh_coeffs
        light = render_light_map_fast(grid, params, cfg, sh)
        cube = ray_march_cube_fast(grid, params, cfg, light, lod=lod, static_mask=vis_mask)
        rect = engine._screen_rect()
        bg = torch.tensor(cfg.clear_color[:3], device=grid.device)

        env_bg = engine._env_bg(params)

        def resolve(_):
            rgba = resolve_cube(cube, params, cfg, rect=rect)
            back = bg.expand(rgba.shape[:-1] + (3,)) if env_bg is None else env_bg
            return composite_premultiplied(rgba, back)

        light_name = "light map (B9)" if sh is None else "light map (B9, AO, B15 or B16)"
        if cfg.point_light:
            light_name = light_name.replace("B9", "the point sweep")
        layers[light_name] = (
            lambda _: render_light_map_fast(grid, params, cfg, sh))
        if engine.render_method.uses_cube_map:
            layers.update({
                "cube march (B10, B17)": lambda _: ray_march_cube_fast(
                    grid, params, cfg, light, lod=lod, static_mask=vis_mask),
                "resolve + composite": resolve,
            })
        else:
            spec = engine._direct_plane_spec(lod)
            num = params.num_samples if engine.render_method.separate_light_pass else (
                torch.tensor(cfg.max_ray_samples, dtype=torch.int32, device=grid.device))
            print(f"[{card}] DIRECT base plane {spec}")

            def march(_):
                return ray_cast_direct_fast(grid, params, cfg, light, spec, num, rect=rect)

            layers["plane march + warp (B10 or B17)"] = march
            plane = torch.zeros((spec.res[1], spec.res[0], 4), device=grid.device)

            def warp(_):
                rgba = _warp_plane_to_screen(plane, spec, params, cfg, rect=rect)
                back = bg.expand(rgba.shape[:-1] + (3,)) if env_bg is None else env_bg
                return composite_premultiplied(rgba, back)

            layers["warp + composite"] = warp
    else:
        layers["visualize + composite"] = lambda _: render_frame(
            grid, params, cfg, engine.render_method)
    for name, fn in layers.items():
        print(f"[{card}] layer {name}: {span_ms(fn):.3f} ms/call (CUDA events, "
              f"{SPAN_CALLS} calls)")

    for kind, step in steps.items():
        if profile_frames(step, kind, args.frames, statistics.median(medians[kind]), card,
                          top=kind == "replayed"):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
