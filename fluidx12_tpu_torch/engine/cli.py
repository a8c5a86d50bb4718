"""Command-line interface mirroring the reference's flags and presets
(mirror of fluidx12_tpu/engine/cli.py, with the same flags and defaults).

Reference CLI (ParseCommandLineArgs, FluidX12.cpp:398-433):
    -gridSize x y z, -maxRaySamples n, -maxLightSamples n, -radiance file,
    -warp (software device), -uma
Launch presets (Bin/Fluid2D.bat, Bin/FluidGI.bat) are exposed as --preset.

The engine runs on the CUDA card; `--cpu` runs it on the CPU instead (the
kernels' plain versions).  Without `--cpu` and without a CUDA device the
CLI exits non-zero before it builds anything.

Run:  python -m fluidx12_tpu_torch.engine.cli --frames 120 --screenshot out.png
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fluidx12-tpu-torch", description=__doc__)
    p.add_argument("--preset", choices=["fluid3d", "fluid2d", "fluidgi"], default="fluid3d")
    p.add_argument("--gridSize", nargs=3, type=int, metavar=("X", "Y", "Z"), default=None)
    p.add_argument("--maxRaySamples", type=int, default=None)
    p.add_argument("--maxLightSamples", type=int, default=None)
    p.add_argument("--radiance", type=str, default=None, help="DDS cube-map light probe")
    p.add_argument("--viewport", nargs=2, type=int, metavar=("W", "H"), default=None)
    p.add_argument("--method", type=int, default=1,
                   help="render method 0..3 (ref hotkeys Left/Right)")
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--batch", type=int, default=1, metavar="K",
                   help="frames per dispatch (FluidXEngine.step_frames, for "
                        "headless runs; ignored with --interactive)")
    p.add_argument("--screenshot", type=str, default=None,
                   help="PNG path; {frame} is substituted (ref hotkey F11)")
    p.add_argument("--screenshot-every", type=int, default=None)
    p.add_argument("--checkpoint", type=str, default=None, help="save final state (.npz)")
    p.add_argument("--restore", type=str, default=None, help="load initial state (.npz)")
    p.add_argument("--paused", action="store_true", help="start paused (ref: Space)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the CUDA card (the reference's "
                        "-warp analog)")
    p.add_argument("--no-fps", action="store_true", help="hide FPS readout (ref: F1)")
    p.add_argument("--interactive", action="store_true",
                   help="live hotkeys on a TTY: Space pause, f FPS, arrows "
                        "method, s screenshot, x fast/faithful stack, "
                        "a/d/w/z orbit + +/- dolly (camera), q quit "
                        "(ref OnKeyUp + mouse camera, FluidX12.cpp:311-396)")
    p.add_argument("--profile", type=str, default=None,
                   help="write a torch.profiler trace (trace.json) to this directory")
    p.add_argument("--profile-passes", action="store_true",
                   help="print per-pass timings after the run")
    p.add_argument("--watchdog", type=int, default=0, metavar="N",
                   help="check/recover sim state every N frames")
    p.add_argument("--metrics", type=str, default=None,
                   help="append JSON-lines frame metrics to this file")
    p.add_argument("--preview", type=int, nargs="?", const=1, default=0,
                   metavar="N",
                   help="draw every Nth frame to the terminal as ANSI "
                        "half-block art (the present analog of the "
                        "reference's window, Win32Application.cpp:205-211; "
                        "also the p hotkey with --interactive)")
    return p


def config_from_args(args) -> "FluidConfig":
    from fluidx12_tpu_torch.core.config import PRESETS

    cfg = PRESETS[args.preset]
    updates = {}
    if args.gridSize:
        updates["grid_size"] = tuple(args.gridSize)
    if args.maxRaySamples:
        updates["max_ray_samples"] = args.maxRaySamples
    if args.maxLightSamples:
        updates["max_light_samples"] = args.maxLightSamples
    if args.viewport:
        updates["viewport"] = tuple(args.viewport)
    if args.radiance:
        updates["has_light_probe"] = True
    return dataclasses.replace(cfg, **updates)


def _profiled(trace_dir: str, run) -> None:
    """`run()` under torch.profiler (host and CUDA activity); the trace
    goes to trace_dir/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    if args.cpu:
        device = "cpu"
    elif not torch.cuda.is_available():
        print("[fluidx12-tpu-torch] no CUDA device: the engine runs on the card; "
              "pass --cpu to run it on the CPU", file=sys.stderr)
        return 2
    else:
        device = "cuda"

    from fluidx12_tpu_torch.core.config import RenderMethod
    from fluidx12_tpu_torch.engine.checkpoint import load_session, save_session
    from fluidx12_tpu_torch.engine.fluidx import FluidXEngine
    from fluidx12_tpu_torch.engine.frame_loop import FrameLoop

    card = f" ({torch.cuda.get_device_name()})" if device == "cuda" else ""
    count = torch.cuda.device_count() if device == "cuda" else 1
    print(f"[fluidx12-tpu-torch] device: {device}{card}, devices: {count}", file=sys.stderr)

    cfg = config_from_args(args)
    radiance = None
    if args.radiance:
        from fluidx12_tpu_torch.gi.dds import load_dds_cubemap

        radiance = load_dds_cubemap(args.radiance)
    elif cfg.has_light_probe:
        default = os.path.join(os.path.dirname(__file__), "..", "..", "assets", "rnl_cross.npz")
        if os.path.exists(default):
            radiance = np.load(default)["radiance"]

    engine = FluidXEngine(cfg, radiance=radiance, device=device)
    engine.render_method = RenderMethod(args.method)
    engine.is_paused = args.paused
    if args.restore:
        # Session checkpoint: fluid + frame index, camera, method, pause
        # (engine/checkpoint.py).  Restore first, then reapply explicit
        # --method/--paused flags.
        load_session(args.restore, engine)
        if args.method != build_parser().get_default("method"):
            engine.render_method = RenderMethod(args.method)
        if args.paused:
            engine.is_paused = True

    loop = FrameLoop(engine, show_fps=not args.no_fps,
                     watchdog_every=args.watchdog, metrics_path=args.metrics,
                     preview_every=args.preview)

    def run():
        loop.run(args.frames, args.screenshot, args.screenshot_every,
                 interactive=args.interactive, batch=args.batch)

    if args.profile:
        _profiled(args.profile, run)
    else:
        run()

    if args.checkpoint:
        save_session(args.checkpoint, engine)

    if args.profile_passes:
        from fluidx12_tpu_torch.engine.profiler import profile_passes

        for name, ms in profile_passes(engine).items():
            print(f"[profile] {name:12s} {ms:8.2f} ms", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
