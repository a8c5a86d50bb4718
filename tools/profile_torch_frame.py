"""Where the time of one frame of the PyTorch port goes, on one NVIDIA GPU.

    python3 tools/profile_torch_frame.py [--preset fluid3d|fluid2d]
                                         [--grid X Y Z] [--probe]
                                         [--pallas-jacobi 0|1]
                                         [--mg-project-fused] [--frames 10]

Runs `FluidXEngine(PRESETS[preset])` (fluid3d: 128^3 grid, fluid2d:
512x512x1 grid, both with an 800x800 viewport; `--grid` replaces the
preset's grid, `--probe` adds the light probe assets/rnl_cross.npz, so
`--grid 256 256 256 --probe` is bench.py's "FluidGI SH irradiance 256^3",
`--grid 256 256 60 --probe` the 256x256x60 GI frame (B15; stored padded on
the TPU) and `--grid 150 150 150 --probe` PRESETS["fluidgi"];
`--pallas-jacobi 0` takes the projection's twins instead of its kernels
(on grids the TPU does not store padded);
`--mg-project-fused` the fused projection, B18, where its gate holds, as
at 256^3) and prints, each beside the card's name and power limit:
  - the host ms/frame: median of `--frames` steps, each ending in a
    synchronize, with no profiler attached;
  - each layer's CUDA-event span per call, over 20 back-to-back calls on the
    engine's state.  3D: advect (B1 + B2), projection, light map (B9; with
    the probe also the AO and B16), cube march (B10 per visible face),
    resolve + composite.  fluid2d: advect (B11 twice + forces),
    projection (B14), visualize + composite;
  - from `torch.profiler` over `--frames` steps: device time and launches
    per frame (kernels, and copies/sets by kind; the sum of their durations
    and the union of their intervals, which counts once the overlap of a
    programmatic dependent launch with the kernel before it), the 12
    kernels with the most device time and then the port's own kernels
    outside them, and the device busy share, the union
    per frame over the unprofiled frame time (the profiler's own host cost
    stretches the frame it watches, so its wall time is not the
    denominator).
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="fluid3d", choices=("fluid3d", "fluid2d"))
    ap.add_argument("--grid", type=int, nargs=3, metavar=("X", "Y", "Z"))
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--pallas-jacobi", type=int, default=1, choices=(0, 1))
    ap.add_argument("--mg-project-fused", action="store_true")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_frame: no CUDA device")

    from fluidx12_tpu_torch.core.config import PRESETS
    from fluidx12_tpu_torch.core.state import unpack_scene_params
    from fluidx12_tpu_torch.engine.fluidx import FluidXEngine
    from fluidx12_tpu_torch.render.lightmap_sweep import render_light_map_fast
    from fluidx12_tpu_torch.render.pipeline import render_frame
    from fluidx12_tpu_torch.render.resolve import resolve_cube
    from fluidx12_tpu_torch.render.slicecomp import ray_march_cube_fast
    from fluidx12_tpu_torch.sim.advect_fast import advect_fields_fast
    from fluidx12_tpu_torch.sim.project import project
    from fluidx12_tpu_torch.utils.image import composite_premultiplied

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    cfg = dataclasses.replace(PRESETS[args.preset], pallas_jacobi=bool(args.pallas_jacobi),
                              has_light_probe=args.probe,
                              mg_project_fused=args.mg_project_fused)
    if args.grid:
        cfg = dataclasses.replace(cfg, grid_size=tuple(args.grid))
    radiance = None
    if args.probe:
        import numpy as np

        radiance = np.load(Path(__file__).resolve().parents[1] / "assets" / "rnl_cross.npz")[
            "radiance"]
    engine = FluidXEngine(cfg, radiance=radiance)
    for _ in range(args.warmup):
        engine.step_frame()
    torch.cuda.synchronize()

    times = []
    for _ in range(args.frames):
        t0 = time.perf_counter()
        engine.step_frame()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    frame_ms = statistics.median(times)
    print(f"[{card}] {args.preset}, grid {cfg.grid_size}, probe {args.probe}, "
          f"pallas_jacobi={cfg.pallas_jacobi}, mg_project_fused={cfg.mg_project_fused}: "
          f"host ms/frame median "
          f"{frame_ms:.3f} over {args.frames} frames (min {min(times):.3f}, "
          f"max {max(times):.3f})")

    # Per-layer spans on the engine's state, as step_frame calls them.
    st = engine.state
    packed, lod, vis_mask = engine.update_frame()
    params = unpack_scene_params(packed)
    dt = torch.tensor(cfg.time_step, dtype=torch.float32, device=st.fields.device)
    copies = [st.fields.clone() for _ in range(SPAN_CALLS + 1)]
    grid = st.color
    layers = {
        "advect (B1 + B2)" if cfg.is_3d else "advect (B11 x2 + forces)":
            lambda _: advect_fields_fast(st.fields, dt, cfg),
        "projection (B18)" if cfg.mg_project_fused else "projection":
            lambda i: project(copies[i], st.pressure, cfg.time_step, cfg),
    }
    if cfg.is_3d:
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

        layers.update({
            "light map (B9)" if sh is None else "light map (B9, AO, B15 or B16)":
                lambda _: render_light_map_fast(grid, params, cfg, sh),
            "cube march (B10, B17)": lambda _: ray_march_cube_fast(grid, params, cfg, light,
                                                              lod=lod, static_mask=vis_mask),
            "resolve + composite": resolve,
        })
    else:
        layers["visualize + composite"] = lambda _: render_frame(
            grid, params, cfg, engine.render_method)
    for name, fn in layers.items():
        print(f"[{card}] layer {name}: {span_ms(fn):.3f} ms/call (CUDA events, "
              f"{SPAN_CALLS} calls)")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.frames):
            engine.step_frame()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    copy_like = [e for e in device if e.name.startswith(("Memcpy", "Memset"))]
    kernels = [e for e in device if not e.name.startswith(("Memcpy", "Memset"))]
    dev_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3 / args.frames
    if dev_ms == 0.0:
        print("torch.profiler recorded no device time")
        return 1
    # The union of the events' intervals: a kernel started by programmatic
    # dependent launch runs (waiting) while the one before it finishes, so
    # the sum of durations counts that overlap twice.
    busy_us, reach = 0.0, None
    for start, end in sorted((e.time_range.start, e.time_range.end) for e in device):
        if reach is None or start > reach:
            busy_us += end - start
            reach = end
        elif end > reach:
            busy_us += end - reach
            reach = end
    busy_ms = busy_us / 1e3 / args.frames
    print(f"[{card}] profiler: {dev_ms:.3f} ms of device time per frame (sum of "
          f"durations), {busy_ms:.3f} ms busy (their union); "
          f"{len(kernels) / args.frames:.1f} kernel launches and "
          f"{len(copy_like) / args.frames:.1f} copies/sets per frame; device busy "
          f"{100.0 * busy_ms / frame_ms:.1f}% of the unprofiled frame")
    copies = collections.Counter(e.name for e in copy_like)
    print(f"[{card}] copies/sets per frame by kind: " + ", ".join(
        f"{name} {n / args.frames:.1f}" for name, n in copies.most_common()))
    by_name = collections.Counter()
    count = collections.Counter()
    for e in device:
        by_name[e.name] += e.time_range.elapsed_us()
        count[e.name] += 1
    top = [name for name, _ in by_name.most_common(12)]
    # Then the port's own kernels (csrc/*.cu, each in a top-level anonymous
    # namespace) that the 12 longest leave out.
    own = [name for name, _ in by_name.most_common()
           if name not in top and name.startswith(("(anonymous namespace)::",
                                                   "void (anonymous namespace)::"))]
    for name in top + own:
        print(f"  {by_name[name] / 1e3 / args.frames:8.4f} ms/frame  "
              f"{count[name] / args.frames:6.1f}x  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
