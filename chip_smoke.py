"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from fluidx12_tpu_torch/csrc (one nvcc per
source, in parallel), checks each against its plain PyTorch version on the
card at its path's shapes (the 128^3 frame's; B11 and B14 at the 2D
preset's 512^2; B13, B4's plane-sweep order, B16 and the fused projection
B18 at 256^3; B15 and B17 at the 256x256x60 GI frame's) and times both.
The plane-sweep march (B4's plane-sweep order, B13, B18) is also held at
the compact dims of the two padded frames and at uneven shapes, timed in
turns with the per-sweep design it replaced (`jacobi.sweepwise`), and its
branch-free division is checked against x / 6.0f on all 2^32 inputs.  B4's
whole-window order (the z-sweep) and B6 (one cluster launch) are held at
error 0 and timed in turns with the per-sweep design they replaced: B4 at
the default preset's 4 sweeps and on the coarse levels of the 256^3,
256x256x60 and 150^3 frames (32 sweeps), B6 at 64^3 and at the thinnest
and the largest shape its gate admits, (2, 16, 64) and (4, 1024, 64).  B14
(eight sweeps a launch over tiles with a ring) is held at error 0 at the
2D preset's 64 sweeps of 512^2 and timed in turns with the per-sweep
design, B9 (one launch, the carry in registers) at error 0 on the stacks
of the 128^3 (and 256^3), 256x256x60 and 150^3 frames, timed in turns
with the two-launch design; B1 (one launch, the y taps from shared
memory) at error 0 and B2 (a staged z-window) within one bf16 ulp at
128^3, 256^3, 256x256x60 and 150^3, on states whose velocities pass the
12-voxel clip in part of the volume, each timed in turns with its
per-voxel design (`advect.perthread`); each must beat its yardstick
there.  B3, B5, B7 and B8, z-marches laid out by `stencil.stencil_plan`,
are held and timed the same way against their per-cell designs
(`stencil.perthread`): B3 at error 0 at 128^3, 256^3, the 256x256x60
frame's compact (60, 256, 256) and 150^3, B5 at error 0 at 128^3, (60,
256, 256) and 150^3, B7 at error 0 at 128^3, 256^3 and (60, 256, 256), B8
equal to its per-cell design and within one bf16 ulp of each plain value at
those and at 150^3; all are timed again in turns with their operands out
of L2 (`measure_cold`), and B3 and B5 must beat their per-cell designs
there too.  B11 (`advect.axis_plan`: whole rows staged along x, B2's
window in the storage type along y and z) is held equal to its plain
version and its per-voxel design on both passes of the 2D preset's
512^2, on every axis of 128^3 and 150^3 and on 512^2 in f32, and B15 (a
z-march on `stencil.stencil_plan`) at (30, 128, 128); both are timed in
turns with their per-cell designs, warm and L2-cold (B11 on the 2D
preset's two passes and along x and y at 128^3), and must beat them in
each.  It drives `FluidXEngine` for 60 frames of the main path
(PRESETS["fluid3d"] as it is: 128^3 grid, 800x800 viewport, the
projection on kernels B3-B8),
20 frames of the pallas_jacobi=False path, 60 frames of PRESETS["fluid2d"]
(512x512x1 grid, 800x800 viewport, B11 and B14), 30 frames of the 256^3 GI
frame (bench.py's "FluidGI SH irradiance 256^3": the in-repo light probe,
B13 and B16), 20 of 256^3 without the probe, 20 of 256^3 with the fused
projection (mg_project_fused=True: B18), 20 of the 256x256x60 GI frame
(the in-repo probe: B15; stored padded on the TPU, so the padded
projection and B10 on every face) and 20 of PRESETS["fluidgi"] (150^3,
the in-repo probe, stored padded), counting the kernel launches of each,
times the projection of the 128^3 paths and of the fused and unfused 256^3
ones, and compares the port on CUDA with the port on the CPU at seven small
grids, one of them 2D, four with the probe and two stored padded on the
TPU.  B10 is also held on a 256^3 face and on 150-lateral faces.  B17
(rings of staged slices, a few columns a thread: `composite.composite_plan`)
is held equal to the one-thread-a-texel design it replaced
(`composite.composite_perthread`) and within 2e-6 of the scale of its
plain version, both march directions, and timed in turns with that design,
warm and L2-cold, beside the bound of what the inputs need (`b17_work`:
prod only where a density is above 0), on three stacks: the 24^3 golden
case's DIRECT plane
(24, 256, 256) (phase 2f), the stack the 256x256x60 frame's X+ face would
give it on the compact layout (128, 256, 256) (phase 2d), and a 512^3
grid's DIRECT plane (170, 896, 1024), 1.27 GB, seen by the default camera
turned by ORBIT_512 (phase 2g).  B10's zero-outside mode (the DIRECT
methods' enlarged base plane) is held against its plain version on the
default camera's (1024, 896) base plane of 128^3 and of 150^3 (compact),
both march directions, and timed in turns with the plain version, warm and
L2-cold, beside a bound that counts only the texels inside the volume on
the live slices (phase 2f).  Phase 3f
drives 20 frames of PRESETS["fluid3d"] under RAY_MARCH_DIRECT_SEPARATE and
5 under RAY_MARCH_DIRECT_MERGED (B10 once a frame on the base plane) and 20
with the point light (the projective sweep, no B9), with exact launch
counts; phase 4 adds a DIRECT frame where B17 composites the plane (the
24^3 golden case, 64x64 viewport), one where B10 does (32^3) and a
point-light frame.  The engine runs a frame as one CUDA graph a key (its
first frame op by op, then captured; later frames replayed), so every
launch count above is counted from replays, and phases 3, 3b, 3c and 3f
print the host ms/frame of the frame replayed and op by op, in turns.
Phase 3g holds the replayed frame to the frame op by op bit for bit
(fields, pressure, image, launch counts) through ten frames of
PRESETS["fluid3d"] (an orbit, a small orbit that keeps the key, the pause
key, a DIRECT key and back), checks torch.profiler's count of one
replay's device operations against one frame op by op, prints the memory
the card reserves after one key and after six, and holds step_frames(8)
to eight step_frame calls bit for bit on PRESETS["fluid2d"] and on the
256^3 GI frame.  The faithful stack's two marches, R1 (`view_march`,
persistent warps fetching rays by tiles: `raymarch.view_plan`) and R2
(`light_march`, a CTA a brick, its dense voxels queued: `raymarch.light_plan`),
which replace the JAX package's XLA scans and no TPU kernel, are held
against their plain versions at full width on developed smoke and on dense
smoke (phase 2h: R2 at 128^3 and at 150^3 with the probe, R1 on the
default camera's cube faces and on the 800^2 DIRECT rays, separate and
merged; within 1e-5 except on at most 0.1% of the values, with bounds
counted from the samples each ray took), equal bit for bit to the
one-thread-a-ray designs they replaced (`raymarch.view_march_perthread`,
`light_march_perthread`) and timed in turns with them, warm and L2-cold,
and must beat them in each; phase 3h drives PRESETS["fluid3d"] after toggle_ez() under the four
methods, the DIRECT methods with the eye inside the volume, a point light
inside the volume and PRESETS["fluidgi"] after toggle_ez() (the probe's SH
and AO in both kernels), with exact launch counts, the host ms/frame
replayed and op by op, and each key's replays held to its frames op by op
bit for bit; phase 3i runs the engine shell at full width,
`fluidx12_tpu_torch.engine.cli.main` in-process: the default launch for 60
frames with screenshots, metrics and the watchdog at batch 1 and 8 (equal
frames, PNGs equal to the frames, launches exactly phase 3's), a session
saved after 30 frames and resumed in a fresh engine (frames 31-60 bit for
bit), PRESETS["fluidgi"] with the npz probe and with it as a float DDS
(equal frames), PRESETS["fluid2d"] and --method 2 (launches as phases 3e,
3b and 3f counted them), --profile-passes and a --profile trace with CUDA
kernel events, and prints the host ms/frame of FrameLoop.run against bare
step_frame calls and the watchdog's cost; phase 3j differentiates the
faithful stack at full width (`adjoint_config`, ADJOINT: PRESETS["fluid3d"]
with fast_sim, fast_render, use_pallas, mg_pressure and quantize_cube_map
off and f32 state): two steps of SmokeModel.step with grad give the frames
of the same steps without it bit for bit and the same launches, the
backward of the second image's sum launches R1b and R2b (the adjoints,
csrc/raymarch_grad.cu) once each and gives a finite non-zero gradient, R2b
at 128^3 and R1b on the cube rays and on DIRECT rays are held to autograd
through the plain versions within 1e-4 of its largest magnitude and timed,
tests/test_adjoint.py's finite-difference check passes at 16^3, and the
fast stack's kernels, the merged march and the light probe raise under
grad; phase 4 adds two faithful frames at 32^3.  Every phase prints its
lines; any failure raises, so the exit code is non-zero and the final JSON
line is not printed.  The last line is {"ok": true, "device": {...}}; the
line before it lists each kernel's launches (on its path), error, time,
plain and library times, and bound.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

FRAMES = 60
SLICE_FRAMES = 20
FRAMES_2D = 60
FRAMES_GI = 30
FRAMES_256 = 20
FRAMES_FUSED = 20
FRAMES_SLAB = 20
FRAMES_FLUIDGI = 20
FRAMES_DIRECT = 20
FRAMES_DIRECT_MERGED = 5
FRAMES_POINT = 20
WARMUP_FRAMES = 10
# Phase 3i's watchdog period, in frames.
WATCHDOG = 20
GRID_256 = (256, 256, 256)
# The 256x256x60 GI frame: a wide, shallow smoke layer.
GRID_SLAB = (256, 256, 60)
# A 512^3 grid, and the default camera turned by this orbit (mouse pixels):
# its DIRECT base plane is face Z+ at (Ru, Rv) = (1024, 896), a (170, 896,
# 1024) stack that B10's VMEM gate refuses, so B17 composites it.
GRID_512 = (512, 512, 512)
ORBIT_512 = (10.0, 40.0)
PROBE = "assets/rnl_cross.npz"
# About 10 ms of an H100's clock: longer than the host takes to queue the
# timed calls of any kernel wrapper.
SLEEP_CYCLES = 20_000_000

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

_ADV = "fluidx12_tpu_torch/csrc/advect.cu"
_STN = "fluidx12_tpu_torch/csrc/stencil.cu"
_JAC = "fluidx12_tpu_torch/csrc/jacobi.cu"
_RM = "fluidx12_tpu_torch/csrc/raymarch.cu"
_RMG = "fluidx12_tpu_torch/csrc/raymarch_grad.cu"
# name: (ID, source, the TPU kernel it replaces), in frame order.
KERNELS = {
    "advect_xy": ("B1", _ADV, "fluidx12_tpu/ops/pallas/advect.py:365"),
    "advect_z_forces": ("B2", _ADV, "fluidx12_tpu/ops/pallas/advect.py:712"),
    "divergence": ("B3", _STN, "fluidx12_tpu/ops/pallas/stencil.py:57"),
    "jacobi": ("B4", _JAC, "fluidx12_tpu/ops/pallas/jacobi.py:114"),
    "residual": ("B5", _STN, "fluidx12_tpu/ops/pallas/stencil.py:322"),
    "jacobi_packed": ("B6", _JAC, "fluidx12_tpu/ops/pallas/jacobi.py:798"),
    "prolong_correct": ("B7", _STN, "fluidx12_tpu/ops/pallas/stencil.py:234"),
    "grad_damp": ("B8", _STN, "fluidx12_tpu/ops/pallas/stencil.py:78"),
    "shear_scan": ("B9", "fluidx12_tpu_torch/csrc/sweep.cu",
                   "fluidx12_tpu/ops/pallas/sweep.py:47"),
    "composite_resample": ("B10", "fluidx12_tpu_torch/csrc/composite.cu",
                           "fluidx12_tpu/ops/pallas/composite.py:125"),
    "advect_z": ("B12", _ADV, "fluidx12_tpu/ops/pallas/advect.py:639"),
    "advect_axis": ("B11", _ADV, "fluidx12_tpu/ops/pallas/advect.py:176"),
    "jacobi2d": ("B14", _JAC, "fluidx12_tpu/ops/pallas/jacobi.py:760"),
    "jacobi_rr": ("B13", _JAC, "fluidx12_tpu/ops/pallas/jacobi.py:481"),
    "gi_light": ("B16", _STN, "fluidx12_tpu/ops/pallas/stencil.py:162"),
    "jacobi_divrr": ("B18", _JAC, "fluidx12_tpu/ops/pallas/jacobi.py:564"),
    "jacobi_grad": ("B18", _JAC, "fluidx12_tpu/ops/pallas/jacobi.py:580"),
    "gradient3": ("B15", _STN, "fluidx12_tpu/ops/pallas/stencil.py:138"),
    "composite": ("B17", "fluidx12_tpu_torch/csrc/composite.cu",
                  "fluidx12_tpu/ops/pallas/composite.py:33"),
    # R1 and R2 replace no TPU kernel: the XLA scans of the faithful stack.
    "view_march": ("R1", _RM, "fluidx12_tpu/render/raymarch_core.py:337"),
    "light_march": ("R2", _RM, "fluidx12_tpu/render/lightmap.py:36"),
    # R1b and R2b replace the JAX autodiff (jax.grad) of those scans.
    "view_march_grad": ("R1b", _RMG, "fluidx12_tpu/render/raymarch_core.py:337"),
    "light_march_grad": ("R2b", _RMG, "fluidx12_tpu/render/lightmap.py:36"),
}
# The projection's kernels: launched on the default preset's path only.
PROJECTION = ("divergence", "jacobi", "residual", "jacobi_packed", "prolong_correct",
              "grad_damp")
# The 2D preset's kernels, launched on its path only.
KERNELS_2D = ("advect_axis", "jacobi2d")
# The 256^3 path's own kernels (B16 with the probe only).
KERNELS_256 = ("jacobi_rr", "gi_light")
# The fused projection's B18, on the mg_project_fused path only.
KERNELS_FUSED = ("jacobi_divrr", "jacobi_grad")
# B15, on the 256x256x60 GI frame only, and B17, on no frame of phase 3
# (the DIRECT plane of phase 4's 24^3 golden case is its path).
KERNELS_SLAB = ("gradient3", "composite")
# The faithful stack's R1 and R2, on the paths of phase 3h only.
KERNELS_FAITHFUL = ("view_march", "light_march")
# The adjoint's R1b and R2b, on the backward of phase 3j only.
KERNELS_ADJOINT = ("view_march_grad", "light_march_grad")
# Each path's own kernels: launched on no other path of phase 3.
OWN = KERNELS_2D + KERNELS_256 + KERNELS_FUSED + KERNELS_SLAB + KERNELS_FAITHFUL + KERNELS_ADJOINT


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def time_ms(fn, reps: int, warmup: int = 2, what: str | None = None) -> float:
    """Mean device time of `fn` over `reps` back-to-back calls (CUDA events).
    A sleep kernel queued before the start event holds the stream while the
    host queues the calls, so the events see the device's work and not the
    host's rate of wrapper calls (tens of microseconds each, longer than the
    smallest kernels).  With `what` given, says so where the sleep ended
    before the host had queued every call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    if what is not None and start.query():
        print(f"  note: {what}: the host queued its calls slower than the card ran "
              f"them; its time includes the host's gaps")
    end.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, flops: float):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the bytes moved (each input read once, each output written once) over
    the HBM rate and the f32 operations over the f32 peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def phase0_device():
    phase("phase 0: device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script needs the GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi.splitlines()[0])
    return name, smi.splitlines()[0]


def phase1_build():
    phase("phase 1: build")
    from fluidx12_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    _build.lib()
    secs = time.perf_counter() - t0
    built = _build.build_seconds
    print(f"kernels ready in {secs:.2f} s "
          f"({'nvcc ' + format(built, '.2f') + ' s' if built is not None else 'cached library'})"
          f": {_build.library_path().name}")


def measure(results, name, err, kernel, plain, n_bytes, flops, reps=20, plain_reps=5,
            library=None, calls=1, yardstick=None, yardstick_name="per-sweep design"):
    """Times `kernel` and its plain version (and the library call, if any)
    and stores them with the error and the bound under `name`.  Where
    `kernel` and `plain` each make `calls` launches (n_bytes and flops are
    those of one), the times are per launch.  `yardstick`, an earlier
    design of the same kernel (`yardstick_name`), is timed in turns with it
    (yardstick, kernel, kernel, yardstick; `ms` is then the kernel's
    mean)."""
    bound_ms, bound_by = bound(n_bytes, flops)
    row = dict(max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by,
               yardstick_name=yardstick_name)
    if yardstick is None:
        row["ms"] = time_ms(kernel, reps, what=name) / calls
    else:
        y0 = time_ms(yardstick, reps) / calls
        k0 = time_ms(kernel, reps, what=name) / calls
        k1 = time_ms(kernel, reps, what=name) / calls
        row["yardstick_ms"] = [y0, time_ms(yardstick, reps) / calls]
        row["kernel_ms"] = [k0, k1]
        row["ms"] = (k0 + k1) / 2
    row["plain_ms"] = time_ms(plain, plain_reps) / calls
    row["library_ms"] = None if library is None else time_ms(library, reps)
    results[name] = row


def measure_cold(results, name, kernel, yardstick, operands, reps=20, calls=1):
    """Times `kernel(*ops)` and its `yardstick(*ops)` in turns (yardstick,
    kernel, kernel, yardstick), each call on the next of enough copies of
    `operands` that a round through them moves four times the card's L2:
    every call finds its operands out of L2, as in the frame, where other
    kernels run between two calls of one.  Where each makes `calls`
    launches, the times are per launch.  Stored under `name` as
    "cold_kernel_ms" and "cold_yardstick_ms"."""
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 50 << 20)
    sets = [tuple(t.clone() for t in operands)
            for _ in range(max(2, math.ceil(4 * l2 / nbytes(*operands))))]

    def rotating(fn):
        turn = iter(range(1 << 30))
        return lambda: fn(*sets[next(turn) % len(sets)])

    y0 = time_ms(rotating(yardstick), reps) / calls
    k0 = time_ms(rotating(kernel), reps, what=name) / calls
    k1 = time_ms(rotating(kernel), reps, what=name) / calls
    r = results[name]
    r["cold_kernel_ms"] = [k0, k1]
    r["cold_yardstick_ms"] = [y0, time_ms(rotating(yardstick), reps) / calls]
    r["cold_copies"] = len(sets)
    del sets
    torch.cuda.empty_cache()


def check_faster(results, name, cold: bool = False) -> None:
    """Fails unless both timed runs of `name`'s kernel beat both of its
    yardstick's, in turns in this call (with `cold`, those of
    `measure_cold`)."""
    r = results[name]
    k, y = ("cold_kernel_ms", "cold_yardstick_ms") if cold else ("kernel_ms", "yardstick_ms")
    check(max(r[k]) < min(r[y]),
          f"{name} is faster than the {r['yardstick_name']} in turns"
          + (" with its operands out of L2" if cold else ""))


def print_times(results, names) -> None:
    for name in names:
        r = results[name]
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        kid = (KERNELS[name][0] if name in KERNELS
               else "B1" if name.startswith("advect_xy")
               else "B2" if name.startswith("advect_z_forces")
               else "B3" if name.startswith("divergence")
               else "B10" if name.startswith("composite_resample")
               else "B17" if name.startswith("composite")
               else "B5" if name.startswith("residual")
               else "B6" if name.startswith("jacobi_packed")
               else "B7" if name.startswith("prolong_correct")
               else "B8" if name.startswith("grad_damp")
               else "B9" if name.startswith("shear_scan")
               else "B11" if name.startswith("advect_axis")
               else "B15" if name.startswith("gradient3")
               else "R1b" if name.startswith("view_march_grad")
               else "R2b" if name.startswith("light_march_grad")
               else "R1" if name.startswith("view_march")
               else "R2" if name.startswith("light_march") else "B4")
        print(f"  {kid} {name}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {lib}, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
        if "yardstick_ms" in r:
            k, y = r["kernel_ms"], r["yardstick_ms"]
            yn = r["yardstick_name"]
            print(f"    {kid} {name}, in turns: {yn} {y[0]:.4f} ms, kernel {k[0]:.4f}, "
                  f"{k[1]:.4f} ms, {yn} {y[1]:.4f} ms; bound {r['bound_ms']:.4f} ms, kernel "
                  f"at {r['ms'] / r['bound_ms']:.2f}x it")
        if "cold_kernel_ms" in r:
            k, y = r["cold_kernel_ms"], r["cold_yardstick_ms"]
            print(f"    {kid} {name}, L2-cold ({r['cold_copies']} copies of the operands "
                  f"in rotation), in turns: {yn} {y[0]:.4f} ms, kernel {k[0]:.4f}, "
                  f"{k[1]:.4f} ms, {yn} {y[1]:.4f} ms; kernel at "
                  f"{sum(k) / 2 / r['bound_ms']:.2f}x the bound")


def b10_work(volf, h_rows, h_cols, valid, n_steps, zero_outside: bool = False):
    """Bytes and operations B10 needs on these inputs.  The output depends
    only on the live slices (valid != 0), and of each on the source rows
    and columns its taps touch (every pair of them: all four channels,
    bf16); valid is read whole, n_steps once, and the live slices' row
    and column coordinates.  Per live slice and face texel: 4 channels x
    2 two-tap lerps, then the front-to-back step, 40 operations.  With
    `zero_outside`, only the texels whose row and column both lie inside
    the volume in a live slice count, and only their taps."""
    _, _, a_dim, b_dim = volf.shape
    r1, r2 = n_steps.shape
    live = valid != 0
    n_live = int(live.sum())

    def taps_inside(h, n):
        """(taps a live slice needs (n_live, n) as a count, rows or columns
        inside per live slice (n_live,))."""
        h = h[live]
        inside = ((h >= -0.5) & (h <= n - 0.5)) if zero_outside else torch.ones_like(h, dtype=torch.bool)
        c = h.clamp(0.0, n - 1.0)
        i0 = c.floor().long()
        i1 = (i0 + 1).clamp_max(n - 1)
        hit = torch.zeros((n_live, n + 1), dtype=torch.bool, device=h.device)
        for i in (i0, i1):
            hit.scatter_(1, torch.where(inside, i, torch.full_like(i, n)), True)
        return hit[:, :n].sum(1), inside.sum(1)

    rows, rows_in = taps_inside(h_rows, a_dim)
    cols, cols_in = taps_inside(h_cols, b_dim)
    src = int((rows * cols).sum())
    n_bytes = (4 * volf.element_size() * src + 4 * n_live * (r1 + r2)
               + nbytes(valid, n_steps) + 4 * 4 * r1 * r2)
    return n_bytes, 40 * int((rows_in * cols_in).sum())


def b17_work(dens, prod, n_steps):
    """Bytes and operations B17 needs on these inputs: every density
    (bf16), the three prod channels only in the 32-byte sectors (16 bf16
    of a row) that hold a density above 0 (w_rate is 0 elsewhere, so prod
    adds nothing there), n_steps once and the four f32 planes written
    once.  Per texel-slice with a density above 0: the clips, the alpha
    (two transcendentals), the weight, its rate and four accumulations,
    20 operations; 2 (the clip and its test) per other one."""
    live = (dens > 0).reshape(-1)
    n_live = int(live.sum())
    pad = live.new_zeros((-live.numel()) % 16)
    sectors = int(torch.cat([live, pad]).view(-1, 16).any(1).sum())
    n_bytes = (dens.numel() * dens.element_size() + 3 * 32 * sectors
               + nbytes(n_steps) + 4 * n_steps.numel() * 4)
    return n_bytes, 20 * n_live + 2 * (dens.numel() - n_live)


def check_b10_face(label, args, absorption, results=None):
    """B10 against its plain version on one face, both march directions,
    within 1e-4, and the kernel's time (flip=False) beside its bound; with
    `results`, also records the face as B10's row of the kernels line."""
    from fluidx12_tpu_torch.ops.cuda import composite as C

    volf, h_rows, h_cols, valid, n_steps = args
    err = 0.0
    for flip in (False, True):
        got = C.composite_resample(*args, absorption, flip)
        ref = C.composite_resample_plain(*args, absorption, flip)
        err = max(err, float((got - ref).abs().max()))
    check(err <= 1e-4, f"B10 composite_resample vs plain, {label}")
    n_bytes, flops = b10_work(*args)
    ms = time_ms(lambda: C.composite_resample(*args, absorption, False), 20, what=label)
    bound_ms, bound_by = bound(n_bytes, flops)
    print(f"B10 composite_resample, {label}: volf {tuple(volf.shape)}, face "
          f"{tuple(n_steps.shape)}, {int((valid != 0).sum())} live slices: max abs diff "
          f"{err:.3e} over both flips (limit 1e-4: the segments' OVER merge re-associates "
          f"the serial composite); kernel {ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    if results is not None:
        measure(results, "composite_resample", err,
                lambda: C.composite_resample(*args, absorption, False),
                lambda: C.composite_resample_plain(*args, absorption, False),
                n_bytes, flops, plain_reps=3)


def padded_projection_counts(cfg) -> dict:
    """Launches of the projection's kernels per frame on a grid the TPU
    stores padded, from the copied gates on its storage dims
    (sim/project._project_padded, sim/mg.mg_solve_padded)."""
    from fluidx12_tpu_torch.core.padding import storage_zyx
    from fluidx12_tpu_torch.ops.cuda import jacobi as J
    from fluidx12_tpu_torch.ops.cuda import stencil as ST
    from fluidx12_tpu_torch.sim import mg

    storage = storage_zyx(cfg)
    check(storage != cfg.zyx and mg.mg_supported(cfg.zyx)
          and cfg.zyx[1] * cfg.zyx[2] >= cfg.mg_min_plane, f"{cfg.grid_size} pads, with MG")
    stencil = int(ST.stencil_pallas_supported(storage))
    counts = dict(divergence=stencil, residual=stencil, grad_damp=stencil,
                  prolong_correct=int(stencil and ST.prolong_pallas_supported(storage)),
                  jacobi=0, jacobi_planewise=0)
    coarse = tuple(n // 2 for n in storage)
    for shape, iters in ((storage, mg.MG_PRE), (coarse, mg.MG_COARSE_ITERS),
                         (storage, mg.MG_POST)):
        tuning = J.jacobi_tuning(shape, iters)
        if tuning is not None:
            counts["jacobi"] += 1
            counts["jacobi_planewise"] += J.window_order(shape, tuning[1]) == J.ORDER_PLANEWISE
    return counts


def light_map_counts(cfg) -> dict:
    """Launches of B15 and B16 per frame of the GI light map, from the
    copied gates on the compact grid (render/lightmap_sweep.py)."""
    from fluidx12_tpu_torch.ops.cuda import stencil as ST
    from fluidx12_tpu_torch.render import lightmap_sweep as L

    zyx = cfg.zyx
    if not cfg.has_light_probe:
        return dict(gi_light=0, gradient3=0)
    b16 = int(ST.stencil_pallas_supported(zyx) and L._ao_half_res(zyx))
    ao = zyx
    for _ in range(L._ao_levels(zyx)):
        ao = tuple(n // 2 for n in ao)
    normals = int(not b16 and ST.stencil_pallas_supported(zyx))
    return dict(gi_light=b16,
                gradient3=normals + int(ao != zyx and ST.stencil_pallas_supported(ao)))


# The other 3D paths' grids, where B1 and B2 are held and timed too:
# 256^3 (the GI, plain and fused frames), the 256x256x60 GI frame and
# PRESETS["fluidgi"].
ADVECT_FRAMES = (("256^3", GRID_256), ("256x256x60", GRID_SLAB),
                 ("fluidgi", (150, 150, 150)))


def advect_args(cfg, dev, seed: int = 0):
    """B1's and B2's operands on `cfg`'s grid: a bf16 state with velocities
    up to +-1.5 (|d| <= 3 voxels at dt = 2 / Y) and a patch of an eighth of
    the volume eight times faster, past the 12-voxel clip; B1's scales and
    B2's (scal, table, consts)."""
    from fluidx12_tpu_torch.ops.cuda import advect as A

    z, y, x = cfg.zyx
    rng = np.random.default_rng(seed)
    f = rng.uniform(0.0, 1.0, (7, z, y, x)).astype(np.float32)
    f[:3] = (f[:3] - 0.5) * 3.0
    f[:3, z // 4: z // 4 + z // 2, y // 4: y // 4 + y // 2, x // 4: x // 4 + x // 2] *= 8.0
    vol = torch.from_numpy(f).to(dev, torch.bfloat16)
    dt = torch.tensor(cfg.time_step, dtype=torch.float32, device=dev)
    table = torch.from_numpy(A.forces_table(cfg)).to(dev)
    return (vol, torch.stack([dt * x, dt * y]), torch.stack([dt * z, dt]), table,
            A.force_consts(cfg))


def check_advect(results, suffix, vol, scales, scal, table, consts):
    """B1 at error 0 and B2 within one bf16 ulp of their plain versions,
    each timed in turns with the design it replaced (`advect.perthread`:
    two launches through a scratch, one thread a voxel) and failing unless
    faster; rows "advect_xy" + suffix and "advect_z_forces" + suffix of
    `results`.  Returns B1's output, B2's input."""
    from fluidx12_tpu_torch.utils.compare import bf16_ulps
    from fluidx12_tpu_torch.ops.cuda import advect as A

    shape = tuple(vol.shape)
    n = vol[0].numel()
    plan = A.advect_plan(shape[1:], vol.dtype)
    got = A.advect_xy(vol, scales)
    ref = A.advect_xy_plain(vol, scales)
    err = float((got - ref).abs().max())
    yard = float((A.perthread("xy", vol, scales) - ref).abs().max())
    print(f"B1 advect_xy at {shape} (plan {plan}): max abs diff {err:.3e}, two-launch "
          f"design {yard:.3e} (limit 0: the same f32 operations)")
    check(torch.equal(got, ref) and yard == 0.0, f"B1 advect_xy vs plain at {shape}")
    del ref
    # Per cell: two displacements and 7 channels x 2 two-tap lerps.
    measure(results, "advect_xy" + suffix, err, lambda: A.advect_xy(vol, scales),
            lambda: A.advect_xy_plain(vol, scales), nbytes(vol, scales, got), 66 * n,
            yardstick=lambda: A.perthread("xy", vol, scales),
            yardstick_name="two-launch design")
    check_faster(results, "advect_xy" + suffix)
    xy = got
    got = A.advect_z_forces(xy, scal, table, consts)
    ref = A.advect_z_forces_plain(xy, scal, table, consts)
    err = float((got.float() - ref.float()).abs().max())
    ulps = bf16_ulps(got, ref)
    yard = bf16_ulps(A.perthread("z_forces", xy, scal, table, consts), ref)
    print(f"B2 advect_z_forces at {shape}: max abs diff {err:.3e}, {ulps:.2f} bf16 ulp at "
          f"each channel's scale, per-voxel design {yard:.2f} (limit 1 ulp: expf may differ "
          f"in its last f32 bit)")
    check(ulps <= 1.0 and yard <= 1.0, f"B2 advect_z_forces vs plain at {shape}")
    del ref
    measure(results, "advect_z_forces" + suffix, err,
            lambda: A.advect_z_forces(xy, scal, table, consts),
            lambda: A.advect_z_forces_plain(xy, scal, table, consts),
            nbytes(xy, scal, table, got), 110 * n,
            yardstick=lambda: A.perthread("z_forces", xy, scal, table, consts),
            yardstick_name="per-voxel design")
    check_faster(results, "advect_z_forces" + suffix)
    return xy


def check_advect_frames(dev, results):
    """B1 and B2 on the other 3D paths' grids (`ADVECT_FRAMES`), as
    `check_advect` holds them at 128^3; rows "advect_xy_<frame>" and
    "advect_z_forces_<frame>" (not in the kernels line)."""
    from fluidx12_tpu_torch.core.config import FluidConfig

    phase("phase 2e: B1 and B2 on the 256^3, 256x256x60 and 150^3 grids")
    for label, grid in ADVECT_FRAMES:
        args = advect_args(FluidConfig(grid_size=grid), dev)
        check_advect(results, "_" + label, *args)
        del args
        torch.cuda.empty_cache()
    print_times(results, [f"{k}_{label}" for label, _ in ADVECT_FRAMES
                          for k in ("advect_xy", "advect_z_forces")])


def check_divergence(results, name, fields):
    """B3 (the z-march of `stencil_plan`) and its per-cell design
    (`stencil.perthread`) at error 0 against the plain version, timed in
    turns, L2-warm and L2-cold, and failing unless the z-march is faster in
    both; row `name` of `results`.  Returns the divergence."""
    from fluidx12_tpu_torch.ops.cuda import stencil as ST

    shape = tuple(fields.shape[1:])
    got = ST.divergence(fields)
    ref = ST.divergence_plain(fields)
    err = float((got - ref).abs().max())
    yard = float((ST.perthread("divergence", fields) - ref).abs().max())
    print(f"B3 divergence at {shape}, {fields.dtype} (plan "
          f"{ST.stencil_plan('divergence', shape)}): max abs diff {err:.3e}, per-cell design "
          f"{yard:.3e} (limit 0: same f32 operations)")
    check(torch.equal(got, ref) and yard == 0.0, f"B3 divergence vs plain at {shape}")
    del ref
    n = got.numel()
    measure(results, name, err, lambda: ST.divergence(fields),
            lambda: ST.divergence_plain(fields), nbytes(fields[:3], got), 6 * n,
            yardstick=lambda: ST.perthread("divergence", fields),
            yardstick_name="per-cell design")
    check_faster(results, name)
    measure_cold(results, name, ST.divergence, lambda f: ST.perthread("divergence", f),
                 (fields[:3],))
    check_faster(results, name, cold=True)
    return got


def check_residual(results, name, q, b):
    """B5 (the staged z-march of `stencil_plan`) and its per-cell design
    (`stencil.perthread`) at error 0 against the plain version, timed in
    turns, L2-warm and L2-cold, and failing unless the z-march is faster in
    both; row `name` of `results`."""
    from fluidx12_tpu_torch.ops.cuda import stencil as ST

    shape = tuple(q.shape)
    got = ST.residual(q, b)
    ref = ST.residual_plain(q, b)
    err = float((got - ref).abs().max())
    yard = float((ST.perthread("residual", q, b) - ref).abs().max())
    print(f"B5 residual at {shape} (plan {ST.stencil_plan('residual', shape)}): max abs diff "
          f"{err:.3e}, per-cell design {yard:.3e} (limit 0: same f32 operations)")
    check(torch.equal(got, ref) and yard == 0.0, f"B5 residual vs plain at {shape}")
    del ref
    measure(results, name, err, lambda: ST.residual(q, b), lambda: ST.residual_plain(q, b),
            nbytes(q, b, got), 8 * q.numel(),
            yardstick=lambda: ST.perthread("residual", q, b),
            yardstick_name="per-cell design")
    check_faster(results, name)
    measure_cold(results, name, ST.residual, lambda q, b: ST.perthread("residual", q, b),
                 (q, b))
    check_faster(results, name, cold=True)


def check_prolong(results, name, q, e_c):
    """B7 (the z-march of `stencil_plan`) and its per-cell design
    (`stencil.perthread`) at error 0 against the plain version, timed in
    turns and failing unless the z-march is faster; the library yardstick q
    + F.interpolate beside them; row `name` of `results`."""
    from fluidx12_tpu_torch.ops.cuda import stencil as ST

    shape = tuple(q.shape)
    got = ST.prolong_correct(q, e_c)
    ref = ST.prolong_correct_plain(q, e_c)
    err = float((got - ref).abs().max())
    yard = float((ST.perthread("prolong_correct", q, e_c) - ref).abs().max())
    print(f"B7 prolong_correct at {shape} (plan {ST.stencil_plan('prolong', shape)}): max abs "
          f"diff {err:.3e}, per-cell design {yard:.3e} (limit 0: same f32 operations)")
    check(torch.equal(got, ref) and yard == 0.0, f"B7 prolong_correct vs plain at {shape}")

    def interpolate_add():
        up = torch.nn.functional.interpolate(e_c[None, None], scale_factor=2,
                                             mode="trilinear", align_corners=False)
        return q + up[0, 0]

    lib_err = float((interpolate_add() - ref).abs().max())
    print(f"  library yardstick q + F.interpolate(trilinear): max abs diff {lib_err:.3e}")
    del ref
    # Per fine cell: the z lerp (3) and the add, and half an upsampled coarse
    # plane (9 operations a fine (y, x)).
    n = q.numel()
    measure(results, name, err, lambda: ST.prolong_correct(q, e_c),
            lambda: ST.prolong_correct_plain(q, e_c), nbytes(q, e_c, got), 4 * n + 9 * n // 2,
            library=interpolate_add, yardstick=lambda: ST.perthread("prolong_correct", q, e_c),
            yardstick_name="per-cell design")
    check_faster(results, name)
    measure_cold(results, name, ST.prolong_correct,
                 lambda q, e_c: ST.perthread("prolong_correct", q, e_c), (q, e_c))


def check_grad_damp(results, name, fields, p, rho):
    """B8 (the staged z-march of `stencil_plan`) equal to its per-cell
    design (`stencil.perthread`) and within one bf16 ulp of each plain
    value, channels 3.. untouched; timed in turns with the per-cell design
    and failing unless faster; row `name` of `results`."""
    from fluidx12_tpu_torch.ops.cuda import stencil as ST

    shape = tuple(p.shape)
    got = ST.grad_damp(fields.clone(), p, rho)
    yard = ST.perthread("grad_damp", fields.clone(), p, rho)
    ref = ST.grad_damp_plain(fields.clone(), p, rho)
    check(torch.equal(got[3:], fields[3:]), f"B8 leaves channels 3.. untouched at {shape}")
    check(torch.equal(got, yard), f"B8 equals its per-cell design at {shape}")
    diff = (got[:3].float() - ref[:3].float()).abs()
    err = float(diff.max())
    ulp = (ref[:3].float().abs() * 2.0 ** -7).clamp_min(2.0 ** -126)
    grad = torch.stack([ST._diff(p, ax) * ST.grad_scale(rho)
                        for ax in (ST._AX_X, ST._AX_Y, ST._AX_Z)]).abs()
    print(f"B8 grad_damp at {shape} (plan {ST.stencil_plan('grad_damp', shape)}): equal to "
          f"the per-cell design; max abs diff {err:.3e}, {float((diff / ulp).max()):.2f} bf16 "
          f"ulp of each value (limit 1 ulp per value); gradient term |(p+ - p-)*0.5/rho| max "
          f"{float(grad.max()):.3f}, median {float(grad.median()):.3f} against a median limit "
          f"of {float(ulp.median()):.2e}; channels 3.. untouched")
    check(bool((diff <= ulp).all()), f"B8 grad_damp vs plain, per value, at {shape}")
    del got, yard, ref, diff, ulp, grad
    work = fields.clone()
    measure(results, name, err, lambda: ST.grad_damp(work, p, rho),
            lambda: ST.grad_damp_plain(work, p, rho),
            2 * nbytes(fields[:3]) + nbytes(p), 39 * p.numel(),
            yardstick=lambda: ST.perthread("grad_damp", work, p, rho),
            yardstick_name="per-cell design")
    check_faster(results, name)
    del work
    measure_cold(results, name, lambda f, p: ST.grad_damp(f, p, rho),
                 lambda f, p: ST.perthread("grad_damp", f, p, rho), (fields[:3], p))


def stencil_operands(zyx, dev, seed, channels=7):
    """B7's and B8's operands on a (Z, Y, X) grid: a smooth f32 pressure q
    (spread 0.05), a coarse correction of spread 0.1, a bf16 state of
    `channels` channels in +-0.75 and a pressure uniform in +-1, whose
    gradient term is many bf16 ulps of the velocity."""
    rng = np.random.default_rng(seed)

    def rand(shape, lo, hi):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).to(dev)

    q = rand(zyx, -0.05, 0.05)
    for ax in range(3):
        q = (q.roll(1, ax) + q + q.roll(-1, ax)) / 3.0
    e_c = rand(tuple(k // 2 for k in zyx), -0.1, 0.1)
    fields = rand((channels,) + tuple(zyx), -0.75, 0.75).to(torch.bfloat16)
    return q, e_c, fields, rand(zyx, -1.0, 1.0)


def check_stencil_frames(dev, results, frames):
    """B3 and B8, and B5 and B7 where the frame runs them (`b5`, `b7`), on
    other paths' grids, as phase 2 holds them at 128^3; rows
    "divergence_<label>", "residual_<label>", "prolong_correct_<label>" and
    "grad_damp_<label>" (not in the kernels line).  B5's right-hand side is
    B3's result."""
    from fluidx12_tpu_torch.core.config import FluidConfig

    rows = []
    for i, (label, grid, b5, b7) in enumerate(frames):
        cfg = FluidConfig(grid_size=grid)
        q, e_c, fields, p = stencil_operands(cfg.zyx, dev, seed=11 + 2 * i)
        b = check_divergence(results, f"divergence_{label}", fields)
        rows.append(f"divergence_{label}")
        if b5:
            check_residual(results, f"residual_{label}", q, b)
            rows.append(f"residual_{label}")
        del b
        if b7:
            check_prolong(results, f"prolong_correct_{label}", q, e_c)
            rows.append(f"prolong_correct_{label}")
        check_grad_damp(results, f"grad_damp_{label}", fields, p, cfg.fluid_density_3d)
        rows.append(f"grad_damp_{label}")
        del q, e_c, fields, p
        torch.cuda.empty_cache()
    print_times(results, rows)


def phase2_kernels(dev):
    """Each kernel of the 3D paths against its plain version on the card,
    at 128^3 shapes (B6 at the 64^3 coarse level), with times and bounds."""
    phase("phase 2: kernels vs plain versions at 128^3")
    from fluidx12_tpu_torch.core.config import PRESETS
    from fluidx12_tpu_torch.ops.cuda import advect as A
    from fluidx12_tpu_torch.ops.cuda import jacobi as J
    from fluidx12_tpu_torch.ops.cuda import stencil as ST
    from fluidx12_tpu_torch.render import slicecomp as SC

    cfg = PRESETS["fluid3d"]
    z, y, x = cfg.zyx
    n = z * y * x
    rng = np.random.default_rng(0)
    results = {}
    record = functools.partial(measure, results)

    # B1 / B2 / B12 at 128^3, each timed in turns with the design it replaced.
    vol, scales, scal, table, consts = advect_args(cfg, dev)
    xy = check_advect(results, "", vol, scales, scal, table, consts)
    got = A.advect_z(xy, scal)
    ref = A.advect_z_forces_plain(xy, scal, None, None, forces=False)
    err = float((got.float() - ref.float()).abs().max())
    print(f"B12 advect_z: max abs diff {err:.3e} (limit 0: the same f32 operations, one "
          f"rounding)")
    check(torch.equal(got, ref), "B12 advect_z vs plain")
    record("advect_z", err, lambda: A.advect_z(xy, scal),
           lambda: A.advect_z_forces_plain(xy, scal, None, None, forces=False),
           nbytes(xy, scal, got), 33 * n, yardstick=lambda: A.perthread("z", xy, scal),
           yardstick_name="per-voxel design")

    # B3-B8 on the projection's operands: the advected bf16 state, a smooth
    # f32 pressure and its right-hand side, the 64^3 coarse level.
    fields = A.advect_z_forces(xy, scal, table, consts)
    del vol, scales
    q = torch.from_numpy(rng.uniform(-0.05, 0.05, (z, y, x)).astype(np.float32)).to(dev)
    for ax in range(3):
        q = (q.roll(1, ax) + q + q.roll(-1, ax)) / 3.0
    b = check_divergence(results, "divergence", fields)

    tuning = J.jacobi_tuning(cfg.zyx, 4)
    check(J.window_order(cfg.zyx, tuning[1]) == J.ORDER_WINDOW,
          "B4 runs in its whole-window order at 128^3")
    got = J.jacobi(q, b, 4, *tuning)
    ref = J.jacobi_plain(q, b, 4, *tuning)
    err = float((got - ref).abs().max())
    print(f"B4 jacobi, whole-window order (4 sweeps, TPU plan {tuning}, launch plan "
          f"{J.window_plan(cfg.zyx)}): max abs diff {err:.3e} (limit 0: the same neighbour "
          f"order and correctly rounded divisions)")
    check(err == 0.0, "B4 jacobi (whole-window order) vs plain")
    record("jacobi", err, lambda: J.jacobi(q, b, 4, *tuning),
           lambda: J.jacobi_plain(q, b, 4, *tuning), nbytes(q, b, got), 7 * 4 * n,
           yardstick=lambda: J.sweepwise("sweeps", q, b, 4, order=J.ORDER_WINDOW))

    check_residual(results, "residual", q, b)

    r_c = torch.from_numpy(rng.uniform(-0.1, 0.1, (z // 2, y // 2, x // 2))
                           .astype(np.float32)).to(dev)
    zero_c = torch.zeros_like(r_c)
    check(J.jacobi_packed_supported(r_c.shape), "the TPU packs the 64^3 coarse level")
    e_c = J.jacobi_packed(zero_c, r_c, 32)
    ref = J.jacobi_packed_plain(zero_c, r_c, 32)
    err = float((e_c - ref).abs().max())
    print(f"B6 jacobi_packed (32 sweeps at 64^3, one cluster: plan {J.packed_plan(r_c.shape)}): "
          f"max abs diff {err:.3e} (limit 0: the same neighbour order and correctly rounded "
          f"divisions)")
    check(err == 0.0, "B6 jacobi_packed vs plain")
    record("jacobi_packed", err, lambda: J.jacobi_packed(zero_c, r_c, 32),
           lambda: J.jacobi_packed_plain(zero_c, r_c, 32), nbytes(zero_c, r_c, e_c),
           7 * 32 * r_c.numel(),
           yardstick=lambda: J.sweepwise("sweeps", zero_c, r_c, 32, order=J.ORDER_PACKED))

    check_prolong(results, "prolong_correct", q, e_c)

    # B8 with a pressure of spread 1, so that its gradient term is many
    # bf16 ulps of the velocity, held per value: within one bf16 ulp of each
    # plain result.
    p = torch.from_numpy(rng.uniform(-1.0, 1.0, (z, y, x)).astype(np.float32)).to(dev)
    check_grad_damp(results, "grad_damp", fields, p, cfg.fluid_density_3d)

    # B9: the light sweep's own arguments for a smooth 128^3 density.
    check_b9_stack("fluid3d", cfg.grid_size, dev, results)

    # B10: the +X face of the default camera's view of a lit 128^3 volume
    # (the row of the kernels line), then a 256^3 face and two 150-lateral
    # faces (PRESETS["fluidgi"], R = 150), each with its own time and bound.
    check_b10_face("128^3 X+ face", SC.sample_face_inputs((x, y, z), 0, dev), cfg.absorption, results)
    check_b10_face("128^3 Z+ face", SC.sample_face_inputs((x, y, z), 4, dev), cfg.absorption)
    check_b10_face("256^3 X+ face", SC.sample_face_inputs(GRID_256, 0, dev), cfg.absorption)
    for face, name in ((0, "X+"), (4, "Z+")):
        check_b10_face(f"150^3 {name} face", SC.sample_face_inputs((150, 150, 150), face, dev),
                       cfg.absorption)
    check_coarse_levels(dev, results)
    check_packed_shapes(dev, results)
    for label, grid in B9_FRAMES:
        check_b9_stack(label, grid, dev, results, row=f"shear_scan_{label}")
    print_times(results, results)
    return results


# The other frames' B9 stacks: the 256x256x60 GI frame's (128, 60, 256) and
# PRESETS["fluidgi"]'s (75, 150, 150) (the 256^3 frames sweep at half
# lateral resolution, the 128^3 frame's (128, 128, 128) stack).
B9_FRAMES = (("256x256x60", GRID_SLAB), ("fluidgi", (150, 150, 150)))


def b9_stack(grid, dev, seed: int = 7):
    """B9's operands (log_att, s) on a grid's frame, as
    render/lightmap_sweep.render_light_map_fast makes them from a smooth
    density: the config's light, pooled to at most 128 slices along its
    major axis, at half lateral resolution where the light map takes it."""
    from fluidx12_tpu_torch.core.config import FluidConfig
    from fluidx12_tpu_torch.core import math3d as m3
    from fluidx12_tpu_torch.render import lightmap_sweep as L
    from fluidx12_tpu_torch.render import slicecomp as SC
    from fluidx12_tpu_torch.render.raymarch_core import MAX_DIST

    cfg = FluidConfig(grid_size=grid)
    rng = np.random.default_rng(seed)
    dens = torch.from_numpy(rng.uniform(0.0, 0.6, cfg.zyx).astype(np.float32)).to(dev)
    for ax in range(3):
        dens = (dens.roll(1, ax) + dens + dens.roll(-1, ax)) / 3.0
    world_i = torch.from_numpy(m3.inverse(m3.scaling(cfg.volume_scale))).to(dev)
    light = torch.tensor(cfg.light_pos, dtype=torch.float32, device=dev) @ world_i[:3, :3]
    light_dir = light / torch.linalg.vector_norm(light)
    major = int(np.argmax(np.abs(cfg.light_pos)))
    arr_axis = L._ARR_TO_LOCAL[major]
    if L._lat_pooled_ok(dens.shape, arr_axis):
        dens = L._pool2_lat(dens, arr_axis)
    z, y, x = dens.shape
    sizes = (x, y, z)
    stride = max(-(-sizes[major] // L._MAX_SLICES), 1)
    n_s = sizes[major] // stride
    pool, _ = L._pool_mats(sizes[major], n_s, stride, cfg.light_pos[major] > 0, dev)
    eq = {0: "zyx,xm->mzy", 1: "zyx,ym->mzx", 2: "zyx,zm->myx"}[major]
    dens_o = SC.mxu_einsum(eq, dens, pool)
    ref_step = MAX_DIST / torch.tensor(float(cfg.max_light_samples), device=dev)
    return L.scan_args(dens_o, light_dir, major, sizes, stride, ref_step, cfg.absorption)


def check_b9_stack(label, grid, dev, results, row="shear_scan"):
    """B9 on a frame's stack (`b9_stack`) at error 0 against its plain
    version, timed in turns with the two-launch design it replaced
    (`sweep.twopass`), under `row` of `results`."""
    from fluidx12_tpu_torch.ops.cuda import sweep as S

    log_att, s = b9_stack(grid, dev)
    got = S.shear_scan(log_att, s)
    ref = S.shear_scan_plain(log_att, s)
    err = float((got - ref).abs().max())
    yard_err = float((S.twopass(log_att, s) - ref).abs().max())
    print(f"B9 shear_scan, the {label} frame's stack {tuple(log_att.shape)} (slopes "
          f"{float(s[0]):.4f}, {float(s[1]):.4f}; plan {S.shear_plan(log_att.shape)}): max abs "
          f"diff {err:.3e}, two-launch design {yard_err:.3e} (limit 0: the same f32 sum order)")
    check(torch.equal(got, ref) and yard_err == 0.0, f"B9 shear_scan vs plain, {label}")
    # Per output: four taps into the sheared carry and four out of it.
    measure(results, row, err, lambda: S.shear_scan(log_att, s),
            lambda: S.shear_scan_plain(log_att, s), nbytes(log_att, s, got),
            40 * log_att.numel(), plain_reps=3, yardstick=lambda: S.twopass(log_att, s),
            yardstick_name="two-launch design")
    check_faster(results, row)


# The coarse levels B4's whole-window order smooths with 32 sweeps, by
# frame: 256^3 (its own dims; the fused and unfused frames alike),
# 256x256x60 and 150^3 (compact dims, with the TPU's tuning from the coarse
# storage dims, as sim/mg.smooth_padded runs them).
COARSE_LEVELS = (("256^3 frame", (128, 128, 128), None),
                 ("256x256x60 frame", (30, 128, 128), (32, 128, 128)),
                 ("150^3 frame", (75, 75, 75), (80, 80, 128)))


def check_coarse_levels(dev, results):
    """B4's whole-window order on each frame's coarse level as the
    multigrid calls it -- 32 sweeps from a zero correction against a
    restricted residual, through `jacobi` -- at error 0 against the plain
    version, timed in turns with the per-sweep design it replaced; rows
    "jacobi_coarse_*" of `results` (not in the kernels line)."""
    from fluidx12_tpu_torch.ops.cuda import jacobi as J
    from fluidx12_tpu_torch.sim.mg import MG_COARSE_ITERS

    rng = np.random.default_rng(8)
    for label, zyx, storage in COARSE_LEVELS:
        tuning = J.jacobi_tuning(storage or zyx, MG_COARSE_ITERS)
        check(J.window_order(storage or zyx, tuning[1]) == J.ORDER_WINDOW,
              f"the {label}'s coarse level takes the whole-window B4")
        zero = torch.zeros(zyx, device=dev)
        r_c = torch.from_numpy(rng.uniform(-0.1, 0.1, zyx).astype(np.float32)).to(dev)
        for ax in range(3):
            r_c = (r_c.roll(1, ax) + r_c + r_c.roll(-1, ax)) / 3.0

        def kernel():
            return J.jacobi(zero, r_c, MG_COARSE_ITERS, *tuning, storage=storage)

        got = kernel()
        err = float((got - J.sweeps_plain(zero, r_c, MG_COARSE_ITERS, J.ORDER_WINDOW))
                    .abs().max())
        print(f"B4 jacobi, whole-window order, the {label}'s coarse level ({MG_COARSE_ITERS} "
              f"sweeps at {zyx}, launch plan {J.window_plan(zyx)}): max abs diff {err:.3e} "
              f"(limit 0)")
        check(err == 0.0, f"B4 on the {label}'s coarse level vs plain")
        measure(results, f"jacobi_coarse_{zyx[0]}", err, kernel,
                lambda: J.sweeps_plain(zero, r_c, MG_COARSE_ITERS, J.ORDER_WINDOW),
                nbytes(zero, r_c, got), 7 * MG_COARSE_ITERS * got.numel(), reps=10,
                plain_reps=3,
                yardstick=lambda: J.sweepwise("sweeps", zero, r_c, MG_COARSE_ITERS,
                                              order=J.ORDER_WINDOW))


# B6's gate admits (Z, Y, 64) volumes of 2 to 4096 rows; no path runs
# these two, the thinnest (a cluster of two CTAs) and the largest (16 CTAs
# of 256 rows, every z neighbour another CTA's).
PACKED_SHAPES = ((2, 16, 64), (4, 1024, 64))


def check_packed_shapes(dev, results):
    """B6's cluster kernel, 32 sweeps at the thinnest and the largest shape
    its gate admits, at error 0 against the plain version and timed in
    turns with the per-sweep design it replaced; rows "jacobi_packed_*" of
    `results` (not in the kernels line)."""
    from fluidx12_tpu_torch.ops.cuda import jacobi as J

    rng = np.random.default_rng(9)
    for zyx in PACKED_SHAPES:
        check(J.jacobi_packed_supported(zyx), f"B6's gate admits {zyx}")
        zero = torch.zeros(zyx, device=dev)
        r_c = torch.from_numpy(rng.uniform(-0.1, 0.1, zyx).astype(np.float32)).to(dev)
        got = J.jacobi_packed(zero, r_c, 32)
        err = float((got - J.jacobi_packed_plain(zero, r_c, 32)).abs().max())
        print(f"B6 jacobi_packed (32 sweeps at {zyx}, plan {J.packed_plan(zyx)}): max abs "
              f"diff {err:.3e} (limit 0)")
        check(err == 0.0, f"B6 at {zyx} vs plain")
        measure(results, f"jacobi_packed_{zyx[0]}x{zyx[1]}", err,
                lambda: J.jacobi_packed(zero, r_c, 32),
                lambda: J.jacobi_packed_plain(zero, r_c, 32), nbytes(zero, r_c, got),
                7 * 32 * got.numel(), reps=10, plain_reps=3,
                yardstick=lambda: J.sweepwise("sweeps", zero, r_c, 32, order=J.ORDER_PACKED))


def check_axis(vol, scale, axis, ch):
    """B11 along `axis` equal (`torch.equal`) to its plain version and to
    its per-voxel design (`advect.perthread`); returns its output and its
    max abs difference from the plain version."""
    from fluidx12_tpu_torch.ops.cuda import advect as A

    shape = tuple(vol.shape)
    got = A.advect_axis(vol, scale, axis, ch)
    ref = A.advect_axis_plain(vol, scale, axis, ch)
    yard = A.perthread("axis", vol, scale, axis=axis, disp_ch=ch)
    err = float((got.float() - ref.float()).abs().max())
    print(f"B11 advect_axis along {'zyx'[axis]} at {shape} {vol.dtype} (plan "
          f"{A.axis_plan(shape[1:], vol.dtype, axis, shape[0])}): max abs diff {err:.3e} "
          f"(limit 0: the same f32 operations, one rounding), per-voxel design "
          f"{'equal' if torch.equal(yard, ref) else 'differs'}")
    check(torch.equal(got, ref) and torch.equal(yard, ref),
          f"B11 advect_axis along {'zyx'[axis]} vs plain at {shape} {vol.dtype}")
    return got, err


def phase2b_kernels_2d(dev, results):
    """B11 and B14 against their plain versions on the card at the 2D
    preset's shapes, (7, 1, 512, 512) bf16 and a 512^2 plane, with times
    and bounds.  B11 (`advect.axis_plan`) is held equal to its plain
    version and its per-voxel design on both passes of the 512^2 plane, on
    every axis of 128^3 and 150^3 (the z stride, rows of 300 bytes) and on
    the plane in f32, and timed in turns with the per-voxel design, warm
    and L2-cold, on the 2D preset's two passes and along x and y at 128^3;
    it must beat it in each."""
    phase("phase 2b: the 2D preset's kernels vs plain versions at 512^2")
    from fluidx12_tpu_torch.core.config import PRESETS
    from fluidx12_tpu_torch.ops.cuda import advect as A
    from fluidx12_tpu_torch.ops.cuda import jacobi as J

    record = functools.partial(measure, results)
    cfg = PRESETS["fluid2d"]
    z, y, x = cfg.zyx
    n = z * y * x
    rng = np.random.default_rng(1)
    # Velocities up to +-1.5 voxels per step and a fast patch past the
    # 12-voxel clip (scale dt * 512 = 1).
    f = rng.uniform(0.0, 1.0, (7, z, y, x)).astype(np.float32)
    f[:3] = (f[:3] - 0.5) * 3.0
    f[:3, :, 200:260, 200:260] *= 10.0
    vol = torch.from_numpy(f).to(dev, torch.bfloat16)
    dt = torch.tensor(cfg.time_step, dtype=torch.float32, device=dev)
    sx, sy = dt * x, dt * y
    tx, err_x = check_axis(vol, sx, 2, 0)
    ty, err_y = check_axis(tx, sy, 1, 1)

    def both_passes(fn):
        return lambda v: fn(fn(v, sx, 2, 0), sy, 1, 1)

    def perthread(v, s, axis, ch):
        return A.perthread("axis", v, s, axis=axis, disp_ch=ch)

    # Per cell and pass: the displacement and its clamps, the two weights,
    # 7 channels x a two-tap lerp.
    record("advect_axis", max(err_x, err_y), lambda: both_passes(A.advect_axis)(vol),
           lambda: both_passes(A.advect_axis_plain)(vol), nbytes(vol, sx, tx), 33 * n, calls=2,
           yardstick=lambda: both_passes(perthread)(vol), yardstick_name="per-voxel design")
    check_faster(results, "advect_axis")
    measure_cold(results, "advect_axis", both_passes(A.advect_axis), both_passes(perthread),
                 (vol,), calls=2)
    check_faster(results, "advect_axis", cold=True)
    del tx, ty
    # Every axis of 128^3 (x and y: the 3D path with advect_fuse_xy=False,
    # timed L2-cold as there) and of 150^3 (rows of 300 bytes: 4-byte
    # copies, a ragged strip), and the 2D plane in f32, with displacements
    # up to 6 voxels at 128^3 and past the clip in a patch.
    rows = []
    for label, shape, dtype in (("128", (7, 128, 128, 128), torch.bfloat16),
                                ("150", (7, 150, 150, 150), torch.bfloat16),
                                ("512_f32", (7, 1, 512, 512), torch.float32)):
        v = rng.uniform(-1.5, 1.5, shape).astype(np.float32)
        v[:3, :, : shape[2] // 4, : shape[3] // 4] *= 8.0
        v = torch.from_numpy(v).to(dev, dtype)
        s = torch.tensor(4.0, device=dev)
        errs = [check_axis(v, s, axis, ch)[1] for axis, ch in ((2, 0), (1, 1), (0, 2))
                if shape[1] > 1 or axis > 0]
        if label == "128":
            for axis, ch, name in ((2, 0, "advect_axis_x_128"), (1, 1, "advect_axis_y_128")):
                record(name, errs[2 - axis], lambda: A.advect_axis(v, s, axis, ch),
                       lambda: A.advect_axis_plain(v, s, axis, ch), 2 * nbytes(v) + 4,
                       33 * v[0].numel(), yardstick=lambda: perthread(v, s, axis, ch),
                       yardstick_name="per-voxel design")
                check_faster(results, name)
                measure_cold(results, name, lambda u: A.advect_axis(u, s, axis, ch),
                             lambda u: perthread(u, s, axis, ch), (v,))
                check_faster(results, name, cold=True)
                rows.append(name)
        del v
        torch.cuda.empty_cache()
    print_times(results, rows)

    # B14: 64 sweeps on a smooth pressure against a smooth right-hand side.
    q = torch.from_numpy(rng.uniform(-0.05, 0.05, (y, x)).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.uniform(-0.01, 0.01, (y, x)).astype(np.float32)).to(dev)
    for ax in range(2):
        q = (q.roll(1, ax) + q + q.roll(-1, ax)) / 3.0
        b = (b.roll(1, ax) + b + b.roll(-1, ax)) / 3.0
    iters = cfg.num_pressure_iters
    check(J.jacobi2d_pallas_supported((y, x)), "the TPU runs B14 at 512^2")
    got = J.jacobi2d(q, b, iters)
    err = float((got - J.jacobi2d_plain(q, b, iters)).abs().max())
    print(f"B14 jacobi2d ({iters} sweeps at {y}x{x}, plan {J.jacobi2d_plan((y, x), iters)}): "
          f"max abs diff {err:.3e} (limit 0: same sum order, exact division by 4)")
    check(err == 0.0, "B14 jacobi2d vs plain")
    # Per cell and sweep: three adds, a subtract and a division.  A call
    # makes ceil(iters / ring) launches, the per-sweep design `iters`: few
    # calls, so that the host queues them all before the sleep kernel ends.
    record("jacobi2d", err, lambda: J.jacobi2d(q, b, iters),
           lambda: J.jacobi2d_plain(q, b, iters), nbytes(q, b, got), 5 * iters * n,
           reps=5, plain_reps=3,
           yardstick=lambda: J.sweepwise("sweeps", q[None], b[None], iters,
                                         order=J.ORDER_2D))
    check_faster(results, "jacobi2d")
    print_times(results, KERNELS_2D)


def phase2c_kernels_256(dev, results):
    """B13, B4 in its plane-sweep order and B16 against their plain
    versions on the card at 256^3, the shapes of the 256^3 GI frame, with
    times and bounds."""
    phase("phase 2c: the 256^3 path's kernels vs plain versions at 256^3")
    from fluidx12_tpu_torch.gi.sh import project_cubemap_sh
    from fluidx12_tpu_torch.ops.cuda import jacobi as J
    from fluidx12_tpu_torch.ops.cuda import stencil as ST
    from fluidx12_tpu_torch.sim.mg import MG_POST, MG_PRE

    record = functools.partial(measure, results)
    z, y, x = GRID_256[::-1]
    n = z * y * x
    rng = np.random.default_rng(2)

    def smooth(lo, hi):
        v = torch.from_numpy(rng.uniform(lo, hi, (z, y, x)).astype(np.float32)).to(dev)
        for ax in range(3):
            v = (v.roll(1, ax) + v + v.roll(-1, ax)) / 3.0
        return v

    # B13 and B4 on a smooth pressure and a right-hand side of spread 1, as
    # the multigrid's fine level sees them.
    q, b = smooth(-0.05, 0.05), smooth(-1.0, 1.0)
    check(J.jacobi_rr_supported(q.shape, MG_PRE), "the TPU runs B13 at 256^3")
    got_q, got_rc = J.jacobi_rr(q, b, MG_PRE, 4.0)
    ref_q, ref_rc = J.jacobi_rr_plain(q, b, MG_PRE, 4.0)
    err = max(float((got_q - ref_q).abs().max()), float((got_rc - ref_rc).abs().max()))
    print(f"B13 jacobi_rr ({MG_PRE} sweeps + residual + restrict x4 at 256^3): max abs diff "
          f"{err:.3e} over q and r_c (limit 0: the same f32 operations in the same order)")
    check(err == 0.0, "B13 jacobi_rr vs plain")
    # Per fine cell: 4 sweeps of 7 operations, the residual's 8, the pooling's
    # z pair; per coarse cell the x and y pools (6).
    record("jacobi_rr", err, lambda: J.jacobi_rr(q, b, MG_PRE, 4.0),
           lambda: J.jacobi_rr_plain(q, b, MG_PRE, 4.0),
           nbytes(q, b, got_q, got_rc), (7 * MG_PRE + 8 + 1) * n + 6 * got_rc.numel(),
           reps=10, plain_reps=3,
           yardstick=lambda: J.sweepwise("rr", q, b, MG_PRE, scale=4.0))

    tuning = J.jacobi_tuning(q.shape, MG_POST)
    check(J.window_order(q.shape, tuning[1]) == J.ORDER_PLANEWISE,
          "B4 runs in its plane-sweep order at 256^3")
    got = J.jacobi(q, b, MG_POST, *tuning)
    err = float((got - J.jacobi_plain(q, b, MG_POST, *tuning)).abs().max())
    print(f"B4 jacobi, plane-sweep order ({MG_POST} sweeps, TPU plan {tuning}, 256^3): max "
          f"abs diff {err:.3e} (limit 0: the same neighbour order and true divisions)")
    check(err == 0.0, "B4 jacobi (plane-sweep order) vs plain")
    record("jacobi_planewise", err, lambda: J.jacobi(q, b, MG_POST, *tuning),
           lambda: J.jacobi_plain(q, b, MG_POST, *tuning), nbytes(q, b, got),
           7 * MG_POST * n, reps=10, plain_reps=3,
           yardstick=lambda: J.sweepwise("sweeps", q, b, MG_POST))
    bad = J.div6_mismatches(dev)
    print(f"the branch-free division (the march's, and the z-sweep's and cluster kernel's) "
          f"against x / 6.0f: {bad} of the 2^32 "
          f"f32 bit patterns differ (limit 0)")
    check(bad == 0, "the branch-free division is the division")

    # B16 on a smooth density with an empty slab (radial fallback, zero
    # ambient), the probe's SH coefficients, the engine's world rotation
    # and light colour.
    dens = smooth(0.0, 0.6)
    dens[:, :32] = 0.0
    shadow = torch.from_numpy(rng.uniform(0.2, 1.0, (z, y, x)).astype(np.float32)).to(dev)
    ao = torch.from_numpy(rng.uniform(0.0, 1.0, (z, y, x)).astype(np.float32)).to(dev)
    radiance = torch.from_numpy(np.load(PROBE)["radiance"].astype(np.float32)).to(dev)
    sh = project_cubemap_sh(radiance, 3)[:9]
    world3 = torch.eye(3, device=dev) * 10.0
    from fluidx12_tpu_torch.core.config import FluidConfig

    cfg = FluidConfig(grid_size=GRID_256, has_light_probe=True)
    lc = torch.tensor(cfg.light_color, device=dev)
    env = lc[:3] * lc[3]
    args = (dens, shadow, ao, sh, world3, env, cfg.zero_threshold)
    got = ST.gi_light(*args)
    ref = ST.gi_light_plain(*args)
    err = float((got - ref).abs().max())
    lim = 1e-6 * float(ref.abs().max())
    print(f"B16 gi_light at 256^3: max abs diff {err:.3e} (limit {lim:.2e}: 1e-6 of the "
          f"scale; both take a correctly rounded 1 / sqrt)")
    check(err <= lim, "B16 gi_light vs plain")
    # Per voxel: the gradient and fallback (~15), rotation and normalisation
    # (~20), the basis (~12), three channels of irradiance, ambient and sum
    # (~63).
    record("gi_light", err, lambda: ST.gi_light(*args), lambda: ST.gi_light_plain(*args),
           nbytes(dens, shadow, ao, got), 110 * n, reps=10, plain_reps=3)
    print_times(results, ("jacobi_rr", "jacobi_planewise", "gi_light"))
    del q, b, dens, shadow, ao, args, got, ref
    check_stencil_frames(dev, results, (("256^3", GRID_256, False, True),))


# The plane-sweep march off 256^3: the compact dims of the 256x256x60 and
# 150^3 frames, an even shape and an odd one that no tile divides.
MARCH_GRIDS = ((60, 256, 256), (150, 150, 150), (30, 130, 98), (33, 130, 97))


def check_b17(results, name, label, stack, absorption, reps=20):
    """B17 on one (dens, prod, n_steps) stack: equal to the one-thread-a-
    texel design it replaced (`composite_perthread`) and within 2e-6 of the
    scale of its plain version, both march directions; timed in turns with
    that design, warm and L2-cold (`measure_cold`), beside the bound of
    what these inputs need (`b17_work`), and faster than it in both;
    recorded under `name`.  Prints the plan and the share of the bound."""
    from fluidx12_tpu_torch.ops.cuda import composite as C

    dens, prod, n_steps = stack
    plan = C.composite_plan(*dens.shape)
    n_bytes, flops = b17_work(dens, prod, n_steps)
    live = float((dens.float() > 0).float().mean())
    print(f"B17 composite, {label}: stack {tuple(dens.shape)}, {100 * live:.1f}% of the "
          f"texel-slices with density > 0, {n_bytes / 1e6:.1f} MB needed of "
          f"{nbytes(*stack) / 1e6 + 16e-6 * n_steps.numel():.1f} MB in and out; plan {plan}")
    err = 0.0
    for flip in (False, True):
        got = C.composite(dens, prod, n_steps, absorption, flip)
        same = torch.equal(got, C.composite_perthread(dens, prod, n_steps, absorption, flip))
        ref = C.composite_plain(dens, prod, n_steps, absorption, flip)
        scale = float(ref.abs().max())
        e = float((got - ref).abs().max())
        print(f"  flip={flip}: {'equal to' if same else 'DIFFERS from'} the per-texel design; "
              f"max abs diff to plain {e:.3e} (limit {2e-6 * scale:.2e}: 2e-6 of the scale, "
              f"expf and log1pf)")
        check(same and e <= 2e-6 * scale and scale > 0.1, f"B17 composite, {label}, flip={flip}")
        err = max(err, e)
        del ref

    def kernel(d, p, n):
        return C.composite(d, p, n, absorption, False)

    def yardstick(d, p, n):
        return C.composite_perthread(d, p, n, absorption, False)

    measure(results, name, err, lambda: kernel(*stack),
            lambda: C.composite_plain(dens, prod, n_steps, absorption, False),
            n_bytes, flops, reps=reps, plain_reps=2,
            yardstick=lambda: yardstick(*stack), yardstick_name="per-texel design")
    check_faster(results, name)
    measure_cold(results, name, kernel, yardstick, stack, reps=reps)
    check_faster(results, name, cold=True)
    r = results[name]
    print(f"  B17 {label}: share of the bound {r['bound_ms']:.4f} ms: warm "
          f"{100 * r['bound_ms'] / r['ms']:.1f}% (per-texel design "
          f"{100 * r['bound_ms'] / (sum(r['yardstick_ms']) / 2):.1f}%), L2-cold "
          f"{100 * r['bound_ms'] / (sum(r['cold_kernel_ms']) / 2):.1f}% (per-texel design "
          f"{100 * r['bound_ms'] / (sum(r['cold_yardstick_ms']) / 2):.1f}%)")


def check_march_grids(dev):
    """B4's plane-sweep order, B13 and both B18 halves against their plain
    versions at MARCH_GRIDS (B13 and B18's head where every dim is even),
    with the multigrid's 4 sweeps: q, b and r_c at error 0, B18's velocity
    within one bf16 ulp of each value."""
    from fluidx12_tpu_torch.ops.cuda import jacobi as J
    from fluidx12_tpu_torch.sim.mg import MG_POST, MG_PRE

    rng = np.random.default_rng(6)
    for zyx in MARCH_GRIDS:
        def rand(shape, lo=-1.0, hi=1.0):
            return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).to(dev)

        q, b = rand(zyx, -0.05, 0.05), rand(zyx)
        fields = rand((4,) + zyx, -0.75, 0.75).to(torch.bfloat16)
        got = J._launch(q, b, MG_POST, J.ORDER_PLANEWISE)
        errs = {"B4": float((got - J.sweeps_plain(q, b, MG_POST, J.ORDER_PLANEWISE)).abs().max())}
        if all(k % 2 == 0 for k in zyx):
            got = J.jacobi_rr(q, b, MG_PRE, 4.0)
            ref = J.jacobi_rr_plain(q, b, MG_PRE, 4.0)
            errs["B13"] = max(float((g - r).abs().max()) for g, r in zip(got, ref))
            got = J.jacobi_divrr(fields, q, MG_PRE, 4.0)
            ref = J.jacobi_divrr_plain(fields, q, MG_PRE, 4.0)
            errs["B18 head"] = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        p = rand(zyx)
        got_q, got_f = J.jacobi_grad(p, b, fields.clone(), MG_POST, 0.48)
        ref_q, ref_f = J.jacobi_grad_plain(p, b, fields.clone(), MG_POST, 0.48)
        errs["B18 tail q"] = float((got_q - ref_q).abs().max())
        diff = (got_f[:3].float() - ref_f[:3].float()).abs()
        ulps = float((diff / (ref_f[:3].float().abs() * 2.0 ** -7).clamp_min(2.0 ** -126)).max())
        print(f"plane-sweep march at zyx {zyx}: max abs diff "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (limit 0); B18 tail velocity {ulps:.2f} bf16 ulp of each value (limit 1); "
              f"colour untouched")
        check(all(v == 0.0 for v in errs.values()) and ulps <= 1.0
              and torch.equal(got_f[3:], fields[3:]), f"the plane-sweep march at {zyx}")


def slab_face_stack(dev, face: int = 0):
    """B17's operands at the 256x256x60 GI frame's shapes: the resampled
    (128, 256, 256) stack of cube face `face` (X+ by default) of a smooth
    smoke volume as the default camera sees it, at lod 0, as the compact
    route would resample it (no path takes B17: the TPU stores that grid
    padded and marches it with B10)."""
    from fluidx12_tpu_torch.core.camera import OrbitCamera
    from fluidx12_tpu_torch.core.config import FluidConfig
    from fluidx12_tpu_torch.core import math3d as m3
    from fluidx12_tpu_torch.render import slicecomp as SC

    cfg = FluidConfig(grid_size=GRID_SLAB, has_light_probe=True)
    z, y, x = cfg.zyx
    rng = np.random.default_rng(4)
    dens = torch.from_numpy(rng.uniform(0.0, 0.6, (z, y, x)).astype(np.float32)).to(dev)
    for ax in range(3):
        dens = (dens.roll(1, ax) + dens + dens.roll(-1, ax)) / 3.0
    dens[:, :64] = 0.0
    vol = torch.cat([dens[None], dens[None].expand(3, -1, -1, -1) * 0.4]).to(torch.bfloat16)
    axis = SC._FACES[face][0]
    volf = SC._axis_volume(vol, axis, cfg)
    cam = OrbitCamera(width=cfg.viewport[0], height=cfg.viewport[1])
    eye = torch.from_numpy(np.append(cam.eye, 1.0).astype(np.float32)).to(dev)
    world_i = torch.from_numpy(m3.inverse(m3.scaling(cfg.volume_scale))).to(dev)
    local_eye = (eye @ world_i)[:3]
    h_rows, h_cols, valid, n_steps, _ = SC.face_geometry(
        face, volf.shape[1], local_eye, torch.tensor(cfg.max_ray_samples, device=dev), cfg,
        torch.float32)
    # The compact gate sends this face to B17; the TPU stores the grid
    # padded and takes B10 there (render/slicecomp.march_kernels), so B17
    # is held here on the stack the compact route would give it.
    check(SC._takes_b17(*volf.shape[1:], h_rows.shape[1], cfg)
          and SC.march_kernels(cfg, 0, [face])[face] == "B10",
          "the compact gate takes B17, the padded route B10")
    dens_m, prod = SC.resampled_stack(volf, h_rows, h_cols, valid)
    return cfg, dens_m, prod, n_steps


def phase2d_kernels_fused_slab(dev, results):
    """B18's two halves at 256^3, and B15 and B17 at the 256x256x60 GI
    frame's shapes ((30, 128, 128), the AO's half field; a 128x256x256
    face stack), against their plain versions on the card, with times and
    bounds.  B15 (a z-march on `stencil.stencil_plan`) is held equal to
    its plain version and its per-cell design, timed beside
    `torch.gradient`, and in turns with the per-cell design, warm and
    L2-cold; it must beat it in both."""
    phase("phase 2d: B18 at 256^3, B15 and B17 at the 256x256x60 frame's shapes")
    from fluidx12_tpu_torch.ops.cuda import jacobi as J
    from fluidx12_tpu_torch.ops.cuda import stencil as ST
    from fluidx12_tpu_torch.sim.mg import MG_POST, MG_PRE, mg_fused_supported

    record = functools.partial(measure, results)
    zyx = GRID_256[::-1]
    n = math.prod(zyx)
    rng = np.random.default_rng(3)

    def smooth(shape, lo, hi):
        v = torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).to(dev)
        for ax in range(-3, 0):
            v = (v.roll(1, ax) + v + v.roll(-1, ax)) / 3.0
        return v

    check(mg_fused_supported(zyx, vel_bytes=2), "the TPU runs B18 at 256^3")
    # The combined state: three bf16 velocity channels and one colour
    # channel, which B18 must not touch.
    fields = smooth((4,) + zyx, -0.75, 0.75).to(torch.bfloat16)
    q = smooth(zyx, -0.05, 0.05)
    got = J.jacobi_divrr(fields, q, MG_PRE, 4.0)
    ref = J.jacobi_divrr_plain(fields, q, MG_PRE, 4.0)
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    print(f"B18 jacobi_divrr (divergence + {MG_PRE} sweeps + residual + restrict x4 at "
          f"256^3): max abs diff {err:.3e} over q, b and r_c (limit 0: B3's and B13's f32 "
          f"operations in their order)")
    check(err == 0.0, "B18 jacobi_divrr vs plain")
    # Per fine cell: the divergence (6), 4 sweeps of 7 operations, the
    # residual's 8 and the z pair; per coarse cell the x and y pools (6).
    record("jacobi_divrr", err, lambda: J.jacobi_divrr(fields, q, MG_PRE, 4.0),
           lambda: J.jacobi_divrr_plain(fields, q, MG_PRE, 4.0),
           nbytes(q, fields[:3]) + nbytes(*got),
           (6 + 7 * MG_PRE + 8 + 1) * n + 6 * got[2].numel(), reps=10, plain_reps=3,
           yardstick=lambda: J.sweepwise("divrr", q, None, MG_PRE, fields, scale=4.0))

    # The tail on a pressure uniform in +-1, so that its gradient is many
    # bf16 ulps of the velocity, held per value.
    rho = 0.48
    p = torch.from_numpy(rng.uniform(-1.0, 1.0, zyx).astype(np.float32)).to(dev)
    b = smooth(zyx, -1.0, 1.0)
    got_q, got_f = J.jacobi_grad(p, b, fields.clone(), MG_POST, rho)
    ref_q, ref_f = J.jacobi_grad_plain(p, b, fields.clone(), MG_POST, rho)
    check(torch.equal(got_f[3:], fields[3:]), "B18 jacobi_grad leaves the colour untouched")
    err_q = float((got_q - ref_q).abs().max())
    diff = (got_f[:3].float() - ref_f[:3].float()).abs()
    ulp = (ref_f[:3].float().abs() * 2.0 ** -7).clamp_min(2.0 ** -126)
    moved = float((ref_f[:3].float() - fields[:3].float()).abs().median())
    print(f"B18 jacobi_grad ({MG_POST} sweeps + gradient + damp at 256^3): q max abs diff "
          f"{err_q:.3e} (limit 0), velocity max abs diff {float(diff.max()):.3e}, "
          f"{float((diff / ulp).max()):.2f} bf16 ulp of each value (limit 1 ulp per value); "
          f"median change of the velocity {moved:.3f}; colour untouched")
    check(err_q == 0.0 and bool((diff <= ulp).all()), "B18 jacobi_grad vs plain")
    work = fields.clone()
    record("jacobi_grad", max(err_q, float(diff.max())),
           lambda: J.jacobi_grad(p, b, work, MG_POST, rho),
           lambda: J.jacobi_grad_plain(p, b, work, MG_POST, rho),
           nbytes(p, b, got_q) + 2 * nbytes(fields[:3]), (7 * MG_POST + 39) * n,
           reps=10, plain_reps=3,
           yardstick=lambda: J.sweepwise("grad", p, b, MG_POST, work, rho=rho))
    check_march_grids(dev)

    # B15 on the AO's half field of the 256x256x60 frame.
    half = tuple(k // 2 for k in GRID_SLAB[::-1])
    check(ST.stencil_pallas_supported(half), "the TPU runs B15 on the half field")
    dens = smooth(half, 0.0, 0.6)
    got = ST.gradient3(dens)
    ref = ST.gradient3_plain(dens)
    err = float((got - ref).abs().max())
    yard = ST.perthread("gradient3", dens)

    def library():
        return torch.gradient(dens, dim=(0, 1, 2))

    lib_err = float((torch.stack(library()[::-1]) - ref).abs().max())
    print(f"B15 gradient3 at {half} (plan {ST.stencil_plan('gradient3', half)}): max abs diff "
          f"{err:.3e} (limit 0: one difference and one exact scale), per-cell design "
          f"{'equal' if torch.equal(yard, ref) else 'differs'}; library torch.gradient max "
          f"abs diff {lib_err:.3e}")
    check(torch.equal(got, ref) and torch.equal(yard, ref), "B15 gradient3 vs plain")
    del yard
    # Per cell and axis: a difference and a scale.
    record("gradient3", err, lambda: ST.gradient3(dens), lambda: ST.gradient3_plain(dens),
           nbytes(dens, got), 6 * dens.numel(), library=library,
           yardstick=lambda: ST.perthread("gradient3", dens), yardstick_name="per-cell design")
    check_faster(results, "gradient3")
    measure_cold(results, "gradient3", ST.gradient3, lambda q: ST.perthread("gradient3", q),
                 (dens,))
    check_faster(results, "gradient3", cold=True)

    # B17 on the X+ face's stack of the 256x256x60 frame.
    _, dens_m, prod, n_steps = slab_face_stack(dev)
    check_b17(results, "composite_slab", "the compact 256x256x60 X+ stack",
              (dens_m, prod, n_steps), 0.8)
    del dens_m, prod, n_steps
    print_times(results, KERNELS_FUSED + ("gradient3", "composite_slab"))
    # B3, B5, B7 and B8 on the padded frames' compact grids (the 150^3
    # frame prolongs with the twin: no B7).
    check_stencil_frames(dev, results, (("256x256x60", GRID_SLAB, True, True),
                                        ("fluidgi", (150, 150, 150), True, False)))


def phase2f_direct_plane(dev, results):
    """B10's zero-outside mode on the DIRECT methods' base plane as the
    default camera sees it (face Z+, extents (2.0, 2.75), (1024, 896)
    texels): 128^3 and 150^3 on the compact layout (the TPU re-pads 150^3
    and clamps at the logical extent, which is the compact clamp).  Against
    its plain version, both march directions, within 1e-4, as B10 is held
    on the cube faces (its segments' OVER merge re-associates the serial
    composite); timed in turns with the plain version, warm and L2-cold,
    beside a bound that counts only the texels inside the volume on the
    live slices (`b10_work`)."""
    phase("phase 2f: B10's zero-outside mode on the DIRECT base plane, 128^3 and 150^3")
    from fluidx12_tpu_torch.core.config import FluidConfig
    from fluidx12_tpu_torch.ops.cuda import composite as C
    from fluidx12_tpu_torch.render.screencomp import sample_plane_inputs
    from fluidx12_tpu_torch.render.slicecomp import plane_kernel, resampled_stack

    absorption = 0.8
    names = []
    for label, grid in (("128^3", (128, 128, 128)), ("150^3", (150, 150, 150))):
        spec, args = sample_plane_inputs(grid, dev)
        volf, h_rows, h_cols, valid, n_steps = args
        n = grid[0]
        check(spec == (4, (2.0, 2.75), (896, 1024)) and tuple(volf.shape) == (4, n, n, n)
              and tuple(n_steps.shape) == (1024, 896)
              and plane_kernel(FluidConfig(grid_size=grid), spec.face_id, spec.res) == "B10",
              f"the default camera's base plane at {label} takes B10: {spec}")
        err = 0.0
        for flip in (False, True):
            got = C.composite_resample(*args, absorption, flip, zero_outside=True)
            ref = C.composite_resample_plain(*args, absorption, flip, zero_outside=True)
            err = max(err, float((got - ref).abs().max()))
        check(err <= 1e-4, f"B10 zero-outside vs plain, {label} base plane")
        moved = float((C.composite_resample(*args, absorption, False)
                       - C.composite_resample(*args, absorption, False, zero_outside=True)
                       ).abs().max())
        check(moved > 1e-2, f"the zero-outside mode changes the {label} plane")
        n_bytes, flops = b10_work(*args, zero_outside=True)
        inside = flops / 40 / (int((valid != 0).sum()) * 1024 * 896)
        print(f"B10 composite_resample zero_outside, {label} base plane {spec}: volf "
              f"{tuple(volf.shape)}, plane {tuple(n_steps.shape)}, "
              f"{int((valid != 0).sum())} live slices, {100 * inside:.1f}% of the live "
              f"texel-slices inside the volume: max abs diff {err:.3e} over both flips "
              f"(limit 1e-4: the segments' OVER merge re-associates the serial composite); "
              f"clamped mode differs by up to {moved:.3e}")
        name = f"composite_resample_plane_{label}"

        def kernel(v, hr, hc, va, ns):
            return C.composite_resample(v, hr, hc, va, ns, absorption, False, zero_outside=True)

        def plain(v, hr, hc, va, ns):
            return C.composite_resample_plain(v, hr, hc, va, ns, absorption, False,
                                              zero_outside=True)

        measure(results, name, err, lambda: kernel(*args), lambda: plain(*args), n_bytes,
                flops, reps=10, plain_reps=2, yardstick=lambda: plain(*args),
                yardstick_name="plain version")
        check_faster(results, name)
        measure_cold(results, name, kernel, plain, args, reps=10)
        check_faster(results, name, cold=True)
        names.append(name)

    # B17's branch-free division against `/` on every divisor it can meet.
    bad = C.div_fast_mismatches(dev)
    print(f"B17's branch-free division (div_fast) against the IEEE division: {bad} of "
          f"739 M quotients differ (every f32 divisor in [2^-21, 2), four dividends in "
          f"[2^-64, 2) each; limit 0)")
    check(bad == 0, "B17's division is the division")
    # B17 on its path: the 24^3 golden case's (256, 256) base plane (64x64
    # viewport), resampled with zero-outside weights.
    spec, args = sample_plane_inputs((24, 24, 24), dev, viewport=(64, 64))
    check(spec == (4, (2.0, 2.75), (256, 256))
          and plane_kernel(FluidConfig(grid_size=(24, 24, 24)), spec.face_id, spec.res)
          == "B17", f"the 24^3 golden case's base plane takes B17: {spec}")
    volf, h_rows, h_cols, valid, n_steps = args
    dens_m, prod = resampled_stack(volf, h_rows, h_cols, valid, True)
    check_b17(results, "composite", "the 24^3 golden case's DIRECT plane",
              (dens_m, prod, n_steps), absorption)
    print_times(results, names + ["composite"])


def phase2g_b17_plane_512(dev, results):
    """B17 on a 512^3 grid's DIRECT base plane: the default camera turned
    by ORBIT_512 sees it as face Z+ at (1024, 896) texels, where B10's VMEM
    gate fails and the TPU composites the resampled (170, 896, 1024) stack
    with B17 (`plane_kernel`).  The stack is resampled with zero-outside
    weights from a smooth 512^3 smoke volume (1.27 GB on the card), held
    and timed by `check_b17`."""
    phase("phase 2g: B17 on the 512^3 DIRECT plane, stack (170, 896, 1024)")
    from fluidx12_tpu_torch.core.config import FluidConfig
    from fluidx12_tpu_torch.render.screencomp import sample_camera, sample_plane_inputs
    from fluidx12_tpu_torch.render.slicecomp import plane_kernel, resampled_stack

    cfg = FluidConfig(grid_size=GRID_512)
    spec, args = sample_plane_inputs(GRID_512, dev, orbit=ORBIT_512)
    eye = sample_camera(cfg.viewport, ORBIT_512).eye
    print(f"camera: the default orbit turned by orbit{ORBIT_512}, eye "
          f"({eye[0]:.3f}, {eye[1]:.3f}, {eye[2]:.3f}); plane {spec}")
    check(spec.face_id == 4 and spec.res == (1024, 896)
          and plane_kernel(cfg, spec.face_id, spec.res) == "B17",
          f"the 512^3 DIRECT plane takes B17: {spec}")
    volf, h_rows, h_cols, valid, n_steps = args
    del args
    torch.cuda.reset_peak_memory_stats()
    stack = resampled_stack(volf, h_rows, h_cols, valid, True) + (n_steps,)
    del volf
    check(tuple(stack[0].shape) == (170, 896, 1024), f"the 512^3 stack: {stack[0].shape}")
    print(f"  stack {nbytes(*stack) / 1e9:.3f} GB; peak allocated while resampling "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    check_b17(results, "composite_plane_512", "the 512^3 DIRECT plane", stack, cfg.absorption,
              reps=10)
    del stack
    torch.cuda.empty_cache()
    print_times(results, ["composite_plane_512"])


def projection_span_ms(engine, reps: int = 20) -> float:
    """CUDA-event span of one `project` call on the engine's state, over
    `reps` back-to-back calls (each on its own copy of the fields, which
    `project` consumes)."""
    from fluidx12_tpu_torch.sim.project import project

    st, cfg = engine.state, engine.config
    copies = [st.fields.clone() for _ in range(reps + 2)]
    for f in copies[:2]:
        project(f, st.pressure, cfg.time_step, cfg)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for f in copies[2:]:
        project(f, st.pressure, cfg.time_step, cfg)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def run_frames(cfg, frames: int, dev, smi_line, label: str, radiance=None, method=None,
               state=None, setup=None):
    """`frames` frames of FluidXEngine(cfg, radiance) under `method` (the
    engine's default, RAY_MARCH_SEPARATE, when None), from `state` (the
    engine's initial one when None) after `setup(engine)`, with the launch
    counts set to 0 just before; returns (counts, visible faces, engine)."""
    from fluidx12_tpu_torch.core.state import unpack_scene_params
    from fluidx12_tpu_torch.engine.fluidx import FluidXEngine
    from fluidx12_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    engine = FluidXEngine(cfg, radiance=radiance, device=dev)
    if method is not None:
        engine.render_method = method
    if state is not None:
        engine.state = state
    if setup is not None:
        setup(engine)
    _, _, vis_mask = engine.update_frame()
    faces = bin(vis_mask).count("1") if cfg.is_3d else 0
    reset_launch_counts()
    times = []
    image = None
    for _ in range(frames):
        t0 = time.perf_counter()
        image = engine.step_frame()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = launch_counts()
    print(f"{label}: launches over {frames} frames: {counts} (visible faces per frame: "
          f"{faces})")
    check(tuple(image.shape) == (cfg.viewport[1], cfg.viewport[0], 3), "image shape")
    check(bool(torch.isfinite(image).all()), "image finite")
    if engine.radiance is None:
        bg = torch.tensor(cfg.clear_color[:3], device=dev)
        what = "the clear colour"
    else:
        bg = engine._env_bg(unpack_scene_params(engine.update_frame()[0]))
        check(bool(((bg - torch.tensor(cfg.clear_color[:3], device=dev)).abs().amax(-1)
                    > 0.02).float().mean() > 0.5), "the sky is drawn")
        what = "the sky"
    smoke = int(((image - bg).abs().amax(-1) > 0.02).sum())
    print(f"{label}: image {tuple(image.shape)}: finite, {smoke} pixels differ from {what}")
    check(smoke > 1000, "smoke visible in the frame")
    first = WARMUP_FRAMES if frames > WARMUP_FRAMES else 1
    steady = times[first:]
    med = statistics.median(steady)
    print(f"{label}: median ms/frame (frames {first + 1}-{frames}, host clock "
          f"around a synchronized step): {med:.3f} ms = {1e3 / med:.2f} steps/s; "
          f"min {min(steady):.3f}, max {max(steady):.3f}; first frame {times[0]:.1f} ms "
          f"(op by op, then its capture) [{smi_line}]")
    return counts, faces, engine


def eager_vs_replayed(engine, label: str, smi_line: str, frames: int = 10) -> None:
    """Host ms/frame of the engine's frame op by op (`_frame_eager`) and
    replayed (`step_frame`) in turns, op by op, replayed, op by op,
    replayed: the median of `frames` synchronized frames each.  The key's
    graph exists already (run_frames ran it)."""
    medians = {"op by op": [], "replayed": []}
    for kind in ("op by op", "replayed", "op by op", "replayed"):
        step = engine._frame_eager if kind == "op by op" else engine.step_frame
        times = []
        for _ in range(frames):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        medians[kind].append(statistics.median(times))
    print(f"{label}: host ms/frame in turns (median of {frames} synchronized frames each): "
          + "; ".join(f"{kind} {a:.3f}, {b:.3f}" for kind, (a, b) in medians.items())
          + f" [{smi_line}]")


def phase3_main_path(dev, smi_line):
    """The main path: FRAMES frames of PRESETS["fluid3d"] (128^3 / 800^2,
    the projection on B3-B8), then SLICE_FRAMES frames of the same preset
    with pallas_jacobi=False (the projection's twins, no B3-B8)."""
    phase(f"phase 3: main path, {FRAMES} frames of PRESETS['fluid3d'] at 128^3 / 800^2")
    from fluidx12_tpu_torch.core.config import PRESETS

    cfg = PRESETS["fluid3d"]
    counts, faces, engine = run_frames(cfg, FRAMES, dev, smi_line, "fluid3d")
    expect = {name: FRAMES for name in KERNELS}
    expect.update(jacobi=2 * FRAMES, composite_resample=FRAMES * faces, advect_z=0,
                  jacobi_planewise=0, **{name: 0 for name in OWN})
    check(counts == expect, f"launch counts {counts} != {expect}")
    eager_vs_replayed(engine, "fluid3d", smi_line)
    span = projection_span_ms(engine)
    print(f"fluid3d: projection span {span:.3f} ms/call (CUDA events, 20 calls) "
          f"[{smi_line}]")

    slice_cfg = dataclasses.replace(cfg, pallas_jacobi=False)
    slice_counts, faces, engine = run_frames(slice_cfg, SLICE_FRAMES, dev, smi_line,
                                             "pallas_jacobi=False")
    expect = {name: SLICE_FRAMES for name in KERNELS}
    expect.update(composite_resample=SLICE_FRAMES * faces, advect_z=0, jacobi_planewise=0,
                  **{name: 0 for name in PROJECTION + OWN})
    check(slice_counts == expect, f"launch counts {slice_counts} != {expect}")
    span = projection_span_ms(engine)
    print(f"pallas_jacobi=False: projection span {span:.3f} ms/call (CUDA events, "
          f"20 calls) [{smi_line}]")
    return counts


def phase3b_fluid2d(dev, smi_line):
    """FRAMES_2D frames of PRESETS["fluid2d"] as it is (512x512x1 grid,
    800x800 viewport): B11 twice and B14 once per frame, no 3D kernel."""
    phase(f"phase 3b: {FRAMES_2D} frames of PRESETS['fluid2d'] at 512^2 / 800^2")
    from fluidx12_tpu_torch.core.config import PRESETS

    counts, _, engine = run_frames(PRESETS["fluid2d"], FRAMES_2D, dev, smi_line, "fluid2d")
    expect = {name: 0 for name in KERNELS}
    expect.update(advect_axis=2 * FRAMES_2D, jacobi2d=FRAMES_2D, jacobi_planewise=0)
    check(counts == expect, f"launch counts {counts} != {expect}")
    eager_vs_replayed(engine, "fluid2d", smi_line)
    return counts


def phase3c_256(dev, smi_line):
    """FRAMES_GI frames of the 256^3 GI frame (bench.py's "FluidGI SH
    irradiance 256^3": FluidConfig(grid_size=(256, 256, 256),
    has_light_probe=True), 800x800 viewport, the in-repo probe), then
    FRAMES_256 frames of 256^3 without it.  Per frame: B13 once, B4 twice
    (the plane-sweep post-smoother and the whole-window coarse sweeps), B16
    once with the probe; B5, B6, B11, B12, B14, B15, B17 and B18 never.
    Returns the GI frame's counts and the engine without the probe, whose
    projection phase 3d times beside the fused one."""
    phase(f"phase 3c: {FRAMES_GI} frames of the 256^3 GI frame, {FRAMES_256} without the "
          f"probe")
    from fluidx12_tpu_torch.core.config import FluidConfig

    radiance = np.load(PROBE)["radiance"]
    out = {}
    for probe, frames in ((True, FRAMES_GI), (False, FRAMES_256)):
        cfg = FluidConfig(grid_size=GRID_256, has_light_probe=probe)
        label = "256^3 GI" if probe else "256^3"
        counts, faces, engine = run_frames(cfg, frames, dev, smi_line, label,
                                           radiance=radiance if probe else None)
        expect = {name: frames for name in KERNELS}
        expect.update(jacobi=2 * frames, jacobi_planewise=frames,
                      composite_resample=frames * faces, gi_light=frames if probe else 0,
                      **{name: 0 for name in ("residual", "jacobi_packed", "advect_z")
                         + KERNELS_2D + KERNELS_FUSED + KERNELS_SLAB + KERNELS_FAITHFUL
                         + KERNELS_ADJOINT})
        check(counts == expect, f"launch counts {counts} != {expect}")
        if probe:
            eager_vs_replayed(engine, label, smi_line)
        out[probe] = counts, engine
    return out[True][0], out[False][1]


def march_routes(cfg, vis_mask: int, lod: int):
    """(faces taking B17, faces taking B10) among the visible faces, by the
    port's copies of the JAX march gates (render/slicecomp.march_kernels)."""
    from fluidx12_tpu_torch.render import slicecomp as SC

    kernels = SC.march_kernels(cfg, lod, [f for f in range(6) if (vis_mask >> f) & 1])
    b17 = sum(k == "B17" for k in kernels.values())
    return b17, len(kernels) - b17


def phase3d_fused_and_slab(dev, smi_line, engine_256):
    """FRAMES_FUSED frames of 256^3 with the fused projection
    (FluidConfig(grid_size=(256, 256, 256), mg_project_fused=True), 800x800
    viewport, no probe) and FRAMES_SLAB frames of the 256x256x60 GI frame
    (the in-repo probe; stored padded on the TPU), with their launch counts
    derived from the copied JAX gates; then the projection span of the
    fused 256^3 frame beside the unfused one of phase 3c (`engine_256`), in
    turns."""
    phase(f"phase 3d: {FRAMES_FUSED} frames of 256^3 with mg_project_fused, {FRAMES_SLAB} of "
          f"the 256x256x60 GI frame")
    from fluidx12_tpu_torch.core.config import FluidConfig
    from fluidx12_tpu_torch.ops.cuda import jacobi as J
    from fluidx12_tpu_torch.ops.cuda import stencil as ST
    from fluidx12_tpu_torch.render import lightmap_sweep as L
    from fluidx12_tpu_torch.sim import mg

    # Path A: B18's head and tail once a frame in place of B3, B13, B4's
    # plane-sweep post-smoother and B8; the coarse level's whole-window B4
    # and B7 as in the unfused frame.
    cfg = FluidConfig(grid_size=GRID_256, mg_project_fused=True)
    zyx, coarse = cfg.zyx, tuple(n // 2 for n in cfg.zyx)
    check(mg.mg_fused_supported(zyx, vel_bytes=2) and ST.stencil_pallas_supported(zyx),
          "the TPU takes B18 at 256^3")
    check(J.window_order(coarse, J.jacobi_tuning(coarse, mg.MG_COARSE_ITERS)[1])
          == J.ORDER_WINDOW, "the coarse level takes the whole-window B4")
    frames = FRAMES_FUSED
    counts_a, faces, engine_a = run_frames(cfg, frames, dev, smi_line, "256^3 fused")
    expect = {name: 0 for name in KERNELS}
    expect.update(advect_xy=frames, advect_z_forces=frames, jacobi=frames, jacobi_planewise=0,
                  prolong_correct=frames, shear_scan=frames,
                  composite_resample=frames * faces, jacobi_divrr=frames, jacobi_grad=frames)
    check(counts_a == expect, f"launch counts {counts_a} != {expect}")

    # Path B: stored (64, 256, 256) on the TPU, so the padded projection
    # (B3, the plane-sweep B4 twice, B5, the whole-window B4 on the coarse
    # storage, B7, B8) and B10 on every visible face; the GI normals'
    # gradient the twin, the AO's half field B15.
    cfg = FluidConfig(grid_size=GRID_SLAB, has_light_probe=True)
    frames = FRAMES_SLAB
    counts_b, faces, engine_b = run_frames(cfg, frames, dev, smi_line, "256x256x60 GI",
                                           radiance=np.load(PROBE)["radiance"])
    _, lod, vis_mask = engine_b.update_frame()
    b17, b10 = march_routes(cfg, vis_mask, lod)
    proj = padded_projection_counts(cfg)
    check((vis_mask, lod, b17, b10) == (0b11011, 0, 0, 4),
          f"the default camera: B10 on X+, X-, Y- and Z+ ({vis_mask:#b}, lod {lod}, "
          f"{b17}, {b10})")
    check(proj == dict(divergence=1, residual=1, grad_damp=1, prolong_correct=1, jacobi=3,
                       jacobi_planewise=2), f"the padded projection's route {proj}")
    expect = {name: 0 for name in KERNELS}
    expect.update(advect_xy=frames, advect_z_forces=frames, shear_scan=frames,
                  composite_resample=frames * b10, composite=frames * b17,
                  **{k: frames * v for k, v in {**proj, **light_map_counts(cfg)}.items()})
    check(expect["gradient3"] == frames and expect["gi_light"] == 0, "B15, no B16")
    check(counts_b == expect, f"launch counts {counts_b} != {expect}")

    spans = {}
    for label, engine in (("unfused", engine_256), ("fused", engine_a), ("fused", engine_a),
                          ("unfused", engine_256)):
        spans.setdefault(label, []).append(projection_span_ms(engine))
    for label, ms in spans.items():
        print(f"256^3 {label} projection span: {ms[0]:.3f}, {ms[1]:.3f} ms/call (CUDA events, "
              f"20 calls each, in turns) [{smi_line}]")
    return counts_a, counts_b


def phase3e_fluidgi(dev, smi_line):
    """FRAMES_FLUIDGI frames of PRESETS["fluidgi"] as it is (150^3 grid,
    800x800 viewport, the in-repo probe), stored (160, 160, 256) on the TPU:
    the padded projection (B3, B4 in the storage dims' orders, B5, the twin
    prolongation where B7's gate fails, B8), B10 on every visible face, the
    GI chain's twins (no gate holds at 150 lanes); launch counts derived
    from the copied gates, exactly.  Returns the counts."""
    phase(f"phase 3e: {FRAMES_FLUIDGI} frames of PRESETS['fluidgi'] at 150^3 / 800^2")
    from fluidx12_tpu_torch.core.config import PRESETS

    cfg = PRESETS["fluidgi"]
    frames = FRAMES_FLUIDGI
    counts, faces, engine = run_frames(cfg, frames, dev, smi_line, "fluidgi",
                                       radiance=np.load(PROBE)["radiance"])
    _, lod, vis_mask = engine.update_frame()
    b17, b10 = march_routes(cfg, vis_mask, lod)
    proj = padded_projection_counts(cfg)
    check(b17 == 0 and b10 == faces and proj["prolong_correct"] == 0,
          f"fluidgi: B10 on every face, the twin prolongation ({b17}, {b10}, {proj})")
    expect = {name: 0 for name in KERNELS}
    expect.update(advect_xy=frames, advect_z_forces=frames, shear_scan=frames,
                  composite_resample=frames * b10,
                  **{k: frames * v for k, v in {**proj, **light_map_counts(cfg)}.items()})
    check(counts == expect, f"launch counts {counts} != {expect}")
    span = projection_span_ms(engine)
    print(f"fluidgi: projection span {span:.3f} ms/call (CUDA events, 20 calls) [{smi_line}]")
    return counts


def phase3f_direct_and_point(dev, smi_line):
    """PRESETS["fluid3d"] (128^3, 800x800) under the DIRECT methods,
    FRAMES_DIRECT frames of RAY_MARCH_DIRECT_SEPARATE and
    FRAMES_DIRECT_MERGED of RAY_MARCH_DIRECT_MERGED: per frame B1-B9 as on
    the cube path and B10 once, in its zero-outside mode, on the (1024,
    896) base plane of face Z+ (no B17); then FRAMES_POINT frames with
    point_light=True (the cube path; the projective sweep, no B9; B10 once
    per visible face).  Exact launch counts."""
    phase(f"phase 3f: PRESETS['fluid3d'] under the DIRECT methods ({FRAMES_DIRECT} + "
          f"{FRAMES_DIRECT_MERGED} frames) and with the point light ({FRAMES_POINT})")
    from fluidx12_tpu_torch.core.config import PRESETS, RenderMethod
    from fluidx12_tpu_torch.render import slicecomp as SC
    from fluidx12_tpu_torch.render.slicecomp import plane_kernel

    cfg = PRESETS["fluid3d"]
    out = {}
    # The march's B10 calls, with the mode each asked for.
    zero_outside = []
    wrapped = SC.composite_resample

    def spy(*args, **kwargs):
        zero_outside.append(kwargs.get("zero_outside", False))
        return wrapped(*args, **kwargs)

    for method, frames in ((RenderMethod.RAY_MARCH_DIRECT_SEPARATE, FRAMES_DIRECT),
                           (RenderMethod.RAY_MARCH_DIRECT_MERGED, FRAMES_DIRECT_MERGED)):
        SC.composite_resample = spy
        zero_outside.clear()
        try:
            counts, _, engine = run_frames(cfg, frames, dev, smi_line, method.name,
                                           method=method)
        finally:
            SC.composite_resample = wrapped
        _, lod, _ = engine.update_frame()
        spec = engine._direct_plane_spec(lod)
        print(f"{method.name}: lod {lod}, base plane {spec}, route "
              f"{plane_kernel(cfg, spec.face_id, spec.res)}")
        check(lod == 0 and spec == (4, (2.0, 2.75), (896, 1024))
              and plane_kernel(cfg, spec.face_id, spec.res) == "B10",
              f"the default camera's base plane takes B10: lod {lod}, {spec}")
        # The key's first frame and its capture call the march; replays
        # run no Python.
        check(zero_outside == [True, True], "B10 ran in its zero-outside mode")
        expect = {name: frames for name in KERNELS}
        expect.update(jacobi=2 * frames, composite_resample=frames, advect_z=0,
                      jacobi_planewise=0, **{name: 0 for name in OWN})
        check(counts == expect, f"launch counts {counts} != {expect}")
        if method == RenderMethod.RAY_MARCH_DIRECT_SEPARATE:
            eager_vs_replayed(engine, method.name, smi_line)
        out[method.name] = counts

    point = dataclasses.replace(cfg, point_light=True)
    counts, faces, _ = run_frames(point, FRAMES_POINT, dev, smi_line, "point_light=True")
    frames = FRAMES_POINT
    expect = {name: frames for name in KERNELS}
    expect.update(jacobi=2 * frames, composite_resample=frames * faces, shear_scan=0,
                  advect_z=0, jacobi_planewise=0, **{name: 0 for name in OWN})
    check(counts == expect, f"launch counts {counts} != {expect}")
    out["point_light"] = counts
    return out


def profiled_kernels(step) -> tuple:
    """(device operations, the port's own kernels) that torch.profiler
    records on the card during one call of `step`.  The operations count
    kernels, copies and sets together: the profiler records a copy that a
    CUDA graph replays as a kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    return len(names), sum("(anonymous namespace)::" in n for n in names)


def held_memory() -> int:
    """The bytes the card reserves for live tensors and graph pools: the
    memory reserved once the caching allocator's free blocks are
    released."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def phase3g_replay_vs_eager(dev, smi_line):
    """The frame as one CUDA graph a key, held to the frame op by op.  Two
    engines of PRESETS["fluid3d"] from the same (initial) state run the
    same ten frames, one by `_frame_eager`, the other by `step_frame`:
    the default pose; an orbit (new rect and parameters: a new key); a
    small orbit that keeps the key but changes the packed parameters (a
    graph that captured a stale parameter tensor would differ here);
    toggle_pause (a key of its own; the state must not move);
    RAY_MARCH_DIRECT_SEPARATE; back to RAY_MARCH_SEPARATE (a replay of an
    earlier key).  Fields, pressure, image and launch counts must be equal
    bit for bit after every frame, and each frame must capture or replay
    as its key says.  torch.profiler's kernel count of one replay must
    equal that of one frame op by op.  The memory the card reserves is
    printed after one key and after six.  Then `step_frames(8)` against 8
    `step_frame` calls from the same state, bit for bit, on
    PRESETS["fluid2d"] and on the 256^3 GI frame."""
    from fluidx12_tpu_torch.utils.compare import bf16_ulps
    phase("phase 3g: replayed frames against the frame op by op, bit for bit")
    from fluidx12_tpu_torch.core.config import PRESETS, FluidConfig, RenderMethod
    from fluidx12_tpu_torch.engine.fluidx import FluidXEngine
    from fluidx12_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    cfg = PRESETS["fluid3d"]
    eager = FluidXEngine(cfg, device=dev)
    graph = FluidXEngine(cfg, device=dev)
    sep, direct = RenderMethod.RAY_MARCH_SEPARATE, RenderMethod.RAY_MARCH_DIRECT_SEPARATE

    def method(m):
        return lambda e: setattr(e, "render_method", m)

    def unpause_direct(e):
        e.toggle_pause()
        e.render_method = direct

    # (what, action on both engines, the graph engine's keys after it)
    steps = [("the default pose", None, 1), ("the default pose", None, 1),
             ("orbit(60, 25): new rect and parameters", lambda e: e.camera.orbit(60.0, 25.0), 2),
             ("the same pose", None, 2),
             ("orbit(1, 0): new parameters, the same key", lambda e: e.camera.orbit(1.0, 0.0), 2),
             ("toggle_pause", lambda e: e.toggle_pause(), 3), ("paused", None, 3),
             ("toggle_pause, RAY_MARCH_DIRECT_SEPARATE", unpause_direct, 4),
             ("RAY_MARCH_DIRECT_SEPARATE", None, 4),
             ("back to RAY_MARCH_SEPARATE", method(sep), 4)]
    key = packed_before = None
    for i, (what, action, n_keys) in enumerate(steps):
        if action is not None:
            action(eager)
            action(graph)
        prev_key, key = key, graph._prepare()
        if what.startswith("orbit(1"):
            check(key == prev_key and not torch.equal(graph._packed, packed_before),
                  "the small orbit keeps the key and changes the parameters")
        packed_before = graph._packed.clone()
        fields_before = graph.state.fields.clone()
        replays = key in graph._graphs
        reset_launch_counts()
        image_a = eager._frame_eager()
        counts_a = launch_counts()
        reset_launch_counts()
        image_b = graph.step_frame()
        counts_b = launch_counts()
        torch.cuda.synchronize()
        same = {"fields": torch.equal(eager.state.fields, graph.state.fields),
                "pressure": torch.equal(eager.state.pressure, graph.state.pressure),
                "image": torch.equal(image_a, image_b), "launch counts": counts_a == counts_b}
        print(f"frame {i + 1} ({what}): {'replay' if replays else 'op by op, then capture'}, "
              f"{len(graph._graphs)} keys; equal: {same}; fields max abs diff "
              f"{float((eager.state.fields.float() - graph.state.fields.float()).abs().max()):.3e}"
              f" ({bf16_ulps(eager.state.fields, graph.state.fields):.2f} bf16 ulp), image "
              f"{float((image_a - image_b).abs().max()):.3e}")
        check(all(same.values()), f"frame {i + 1} ({what}): the replayed frame equals the "
                                  f"frame op by op: {same}")
        check(len(graph._graphs) == n_keys and replays == (i not in (0, 2, 5, 7)),
              f"frame {i + 1} ({what}): {len(graph._graphs)} keys, replay {replays}")
        if graph.is_paused:
            check(torch.equal(graph.state.fields, fields_before), "a paused frame keeps the state")
        if i == 1:
            mem_1 = held_memory()
    # The replay alone (`_run`), without step_frame's copy of the image.
    kernels = {"replay": profiled_kernels(lambda: graph._run(graph._prepare())),
               "op by op": profiled_kernels(graph._frame_eager)}
    print(f"torch.profiler, one frame of RAY_MARCH_SEPARATE: (device operations, the "
          f"port's own kernels) {kernels}")
    check(kernels["replay"] == kernels["op by op"] and kernels["replay"][1] > 0,
          "a replay runs every kernel of the frame op by op")
    for m in (RenderMethod.RAY_MARCH_MERGED, RenderMethod.RAY_MARCH_DIRECT_MERGED):
        graph.render_method = m
        graph.step_frame()
    check(len(graph._graphs) == 6, "six keys")
    mem_6 = held_memory()
    print(f"memory the card reserves for both engines, the allocator's cache emptied first "
          f"(each capture empties it too): {mem_1 / 2**20:.0f} MiB after one key, "
          f"{mem_6 / 2**20:.0f} MiB after six [{smi_line}]")
    del eager, graph
    torch.cuda.empty_cache()

    radiance = np.load(PROBE)["radiance"]
    for label, cfg, rad in (("fluid2d", PRESETS["fluid2d"], None),
                            ("256^3 GI", FluidConfig(grid_size=GRID_256, has_light_probe=True),
                             radiance)):
        one, seq = (FluidXEngine(cfg, radiance=rad, device=dev) for _ in range(2))
        for e in (one, seq):
            e.step_frame()
            e.step_frame()
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        images = one.step_frames(8)
        torch.cuda.synchronize()
        ms_k = (time.perf_counter() - t0) * 1e3 / 8
        counts_k = launch_counts()
        reset_launch_counts()
        t0 = time.perf_counter()
        images_seq = torch.stack([seq.step_frame() for _ in range(8)])
        torch.cuda.synchronize()
        ms_seq = (time.perf_counter() - t0) * 1e3 / 8
        same = {"images": torch.equal(images, images_seq),
                "fields": torch.equal(one.state.fields, seq.state.fields),
                "pressure": torch.equal(one.state.pressure, seq.state.pressure),
                "launch counts": counts_k == launch_counts(),
                "frame_index": one.frame_index == seq.frame_index == 10}
        print(f"{label}: step_frames(8) {tuple(images.shape)} against 8 step_frame calls: "
              f"equal {same}; host {ms_k:.3f} against {ms_seq:.3f} ms/frame [{smi_line}]")
        check(all(same.values()), f"{label}: step_frames(8) equals 8 step_frame calls")
        del one, seq, images, images_seq
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The faithful stack: R1 (view_march) and R2 (light_march)
# ---------------------------------------------------------------------------

# f32 operations a sample of the faithful marches does (csrc/raymarch.cu),
# for their bound: every view sample forms its position, box test and uvw
# and the density's trilinear value (12 for the corners' coordinates, 21
# for the seven lerps) and its step (53); a dense one adds the rgb's three
# trilinear channels, the step controller and the accumulation, and the
# light map's trilinear sample (163 in all) or, merged, the light's
# combination (108), plus with the probe the six gradient taps, the
# rotation, the normalisations and the SH irradiance (333); every
# light-ray sample forms its position, box test, uvw, one trilinear
# channel, the step and the transmittance (65).  R2's voxel forms its
# centre and its density (54), and a dense voxel its light (20, or 353
# with the probe).
R1_VIEW_OPS, R1_DENSE_OPS, R1_DENSE_MERGED_OPS, PROBE_OPS, LIGHT_SAMPLE_OPS = 53, 163, 108, 333, 65
R2_VOXEL_OPS, R2_DENSE_OPS = 54, 20
# Frames of a developed smoke state that the faithful kernels and frames
# start from (replays of the fast stack), and frames of each faithful run.
WARM_FRAMES = 60
FRAMES_FAITHFUL = 6
# The DIRECT methods' eye inside the volume: the default camera dollied
# most of the way to its focus.
DOLLY_INSIDE = 15.5
# A point light inside the volume (light_pos / volume_scale < 1.1).
INTERIOR_LIGHT = dict(point_light=True, light_pos=(5.0, 2.0, -3.0))
# R1 merged is held to its plain version on every this-many-th 800^2 ray.
MERGED_STRIDE = 7
# Dense smoke for R1 and R2: PRESETS["fluid3d"] after DENSE_FRAMES frames;
# where under DENSE_MIN of its view samples are dense, a synthetic field
# of seed DENSE_SEED with DENSE_SHARE of its voxels dense.
DENSE_FRAMES = 600
DENSE_MIN = 0.10
DENSE_SEED = 18
DENSE_SHARE = 0.30


def warm_engine(cfg, dev, radiance=None, frames: int = WARM_FRAMES):
    """A FluidXEngine of `cfg` after `frames` frames of the fast stack: a
    developed smoke state for the faithful kernels and frames."""
    from fluidx12_tpu_torch.engine.fluidx import FluidXEngine

    engine = FluidXEngine(cfg, radiance=radiance, device=dev)
    for _ in range(frames):
        engine.step_frame()
    torch.cuda.synchronize()
    return engine


def held(got, ref, what: str) -> float:
    """Holds `got` to `ref` with the faithful stack's tolerance
    (utils/compare.few_off: within 1e-5 except on at most 0.1% of the
    values, a sample so near zero_threshold or the box edge that the two
    take the other branch); returns the max abs difference."""
    from fluidx12_tpu_torch.utils.compare import few_off

    ok, err = few_off(got, ref, what)
    check(ok, f"{what} within 1e-5 of its plain version")
    return err


def r1_flops(samples, merged: bool, probe: bool) -> float:
    """R1's f32 operations on this run's rays, from its sample counts
    (view, dense view, light-ray samples per ray)."""
    views, dense, lights = (float(samples[..., k].sum()) for k in range(3))
    dense_ops = (R1_DENSE_MERGED_OPS + (PROBE_OPS if probe else 0)) if merged else R1_DENSE_OPS
    return views * R1_VIEW_OPS + dense * dense_ops + lights * LIGHT_SAMPLE_OPS


def r2_flops(samples, grid, zero: float, probe: bool) -> float:
    """R2's f32 operations on this run's voxels, from its sample counts."""
    dense = float((grid[3].float() >= zero).sum())
    return (grid[3].numel() * R2_VOXEL_OPS + dense * (R2_DENSE_OPS + (PROBE_OPS if probe else 0))
            + float(samples.sum()) * LIGHT_SAMPLE_OPS)


def time_r_designs(results, name, kernel, yardstick, operands, reps: int = 10,
                   checked: bool = True) -> None:
    """Times R1's, R2's, R1b's or R2b's design in turns with the per-thread
    design it replaced, warm (`kernel()`, `yardstick()`) and with the
    operands out of L2 (`kernel(*ops)`, `yardstick(*ops)` over copies of
    `operands`), and (`checked`) fails unless it beats it in both."""
    r = results[name]
    y0 = time_ms(yardstick, reps)
    k0 = time_ms(kernel, reps, what=name)
    k1 = time_ms(kernel, reps, what=name)
    r.update(yardstick_name="per-thread design", yardstick_ms=[y0, time_ms(yardstick, reps)],
             kernel_ms=[k0, k1], ms=(k0 + k1) / 2)
    measure_cold(results, name, kernel, yardstick, operands, reps=reps)
    print_times(results, [name])
    if checked:
        check_faster(results, name)
        check_faster(results, name, cold=True)


def check_r2(results, name, engine, label, grid=None):
    """R2 on the warm engine's colour grid (or `grid`, of its dims) against
    its plain version and, bit for bit, the per-thread design it replaced;
    timed in turns with that design, warm and L2-cold, with its bound;
    returns the kernel's light map."""
    from fluidx12_tpu_torch.core.state import unpack_scene_params
    from fluidx12_tpu_torch.ops.cuda import raymarch as R
    from fluidx12_tpu_torch.render import raymarch_core as RC
    from fluidx12_tpu_torch.render.lightmap import light_map_plain

    cfg = engine.config
    params = unpack_scene_params(engine.update_frame()[0])
    grid = engine.state.color if grid is None else grid
    env = RC.make_light_env(params, engine.sh_coeffs, cfg)
    packed, flags = RC.pack_env(env), RC.env_flags(env, cfg)
    num = params.num_light_samples
    samples = torch.empty(cfg.zyx, dtype=torch.int32, device=grid.device)
    samples_old = torch.empty_like(samples)
    got = R.light_march(grid, packed, flags, num, cfg, samples=samples)
    old = R.light_march_perthread(grid, packed, flags, num, cfg, samples=samples_old)
    check(torch.equal(got, old) and torch.equal(samples, samples_old),
          f"R2 {label}: equal to its per-thread design bit for bit")
    err = held(got, light_map_plain(grid.float(), env, num, cfg), f"R2 {label}")
    flops = r2_flops(samples, grid, cfg.zero_threshold, env.has_probe)
    measure(results, name, err, lambda: R.light_march(grid, packed, flags, num, cfg),
            lambda: light_map_plain(grid.float(), env, num, cfg), nbytes(grid, got), flops,
            reps=10, plain_reps=1)
    time_r_designs(results, name, lambda g=grid: R.light_march(g, packed, flags, num, cfg),
                   lambda g=grid: R.light_march_perthread(g, packed, flags, num, cfg), (grid,))
    r = results[name]
    dense = float((grid[3].float() >= cfg.zero_threshold).float().mean())
    print(f"R2 {label}: {r['ms']:.4f} ms (per-thread design {min(r['yardstick_ms']):.4f}, plain "
          f"{r['plain_ms']:.2f} ms); {100 * dense:.2f}% of the voxels dense, "
          f"{float(samples.sum()):.4g} light samples, bound {r['bound_ms'] * 1e3:.1f} us "
          f"({r['bound_by']})")
    return got


def check_r1(results, name, grid, rays, num, env, cfg, label, light_map=None, num_light=None,
             stride: int = 1):
    """R1 on `rays` (origin, direction, t_max, active) against its plain
    version, the plain one on every `stride`-th ray (merged: its nested
    loops run per sample), and, bit for bit, the per-thread design it
    replaced; timed in turns with that design, warm and L2-cold, with its
    bound.  Returns the share of the view samples that were dense."""
    from fluidx12_tpu_torch.ops.cuda import raymarch as R
    from fluidx12_tpu_torch.render import raymarch_core as RC

    origin, ray_dir, t_max, active = rays
    n = active.numel()
    lead = tuple(active.shape)
    samples = torch.empty(lead + (3,), dtype=torch.int32, device=grid.device)
    samples_old = torch.empty_like(samples)
    kw = dict(light_map=light_map, num_light_samples=num_light)
    packed, flags = RC.pack_env(env), RC.env_flags(env, cfg)
    got = R.view_march(grid, origin, ray_dir, t_max, active, num, packed, flags, cfg,
                       samples=samples, **kw)
    old = R.view_march_perthread(grid, origin, ray_dir, t_max, active, num, packed, flags, cfg,
                                 samples=samples_old, **kw)
    check(torch.equal(got, old) and torch.equal(samples, samples_old),
          f"R1 {label}: equal to its per-thread design bit for bit")

    def plain():
        sub = [t.reshape(n, -1)[::stride].squeeze(-1) for t in (origin, ray_dir, t_max, active)]
        sub[0], sub[1] = sub[0].contiguous(), sub[1].contiguous()
        return RC.view_march(grid.float(), sub[0], sub[1], sub[2], num, env, cfg,
                             active=sub[3], **kw)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = plain()
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err = held(got.reshape(n, 4)[::stride], ref, f"R1 {label}")
    merged = light_map is None
    flops = r1_flops(samples, merged, env.has_probe)
    n_bytes = nbytes(grid, origin, ray_dir, t_max, active, got) + (
        0 if light_map is None else nbytes(light_map))
    operands = (grid, origin, ray_dir, t_max, active) + (() if merged else (light_map,))

    def launch(fn):
        def call(g=grid, o=origin, d=ray_dir, t=t_max, a=active, lm=light_map):
            return fn(g, o, d, t, a, num, packed, flags, cfg, light_map=lm,
                      num_light_samples=num_light)
        return call

    kernel, yardstick = launch(R.view_march), launch(R.view_march_perthread)
    if stride == 1:
        measure(results, name, err, kernel, plain, n_bytes, flops, reps=10, plain_reps=1)
    else:
        bound_ms, bound_by = bound(n_bytes, flops)
        results[name] = dict(max_abs_err=err, plain_ms=plain_s * 1e3, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=None)
    time_r_designs(results, name, kernel, yardstick, operands, reps=10 if stride == 1 else 5)
    r = results[name]
    views, dense, lights = (float(samples[..., k].sum()) for k in range(3))
    print(f"R1 {label}: {n} rays, {r['ms']:.4f} ms (per-thread design "
          f"{min(r['yardstick_ms']):.4f} ms, plain {r['plain_ms']:.2f} ms"
          f"{f' on every {stride}th ray, one call' if stride > 1 else ''}); samples: "
          f"{views:.4g} view, {dense:.4g} dense ({100 * dense / max(views, 1.0):.2f}%), "
          f"{lights:.4g} light; bound {r['bound_ms'] * 1e3:.1f} us ({r['bound_by']})")
    return dense / max(views, 1.0)


def synthetic_smoke(cfg, dev, seed: int = DENSE_SEED):
    """A (4, Z, Y, X) colour grid in the storage dtype of seeded smooth
    noise (numpy default_rng(seed), three box passes along each axis),
    DENSE_SHARE of its voxels above zero_threshold: density up to 0.5,
    rgb a fixed colour times it."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.0, 1.0, cfg.zyx).astype(np.float32)
    for ax in range(3):
        for _ in range(3):
            d = (np.roll(d, 1, ax) + d + np.roll(d, -1, ax)) / 3.0
    cut = np.quantile(d, 1.0 - DENSE_SHARE)
    d = np.where(d > cut, cfg.zero_threshold + 0.5 * (d - cut) / (d.max() - cut), 0.0)
    rgb = np.array([0.9, 0.7, 0.5], np.float32)[:, None, None, None] * d[None]
    grid = np.concatenate([rgb, d[None]]).astype(np.float32)
    return torch.from_numpy(grid).to(dev, torch.bfloat16).contiguous()


def phase2h_faithful_kernels(dev, results):
    """R1 and R2, the faithful stack's marches, against their plain versions
    and, bit for bit, the per-thread designs they replaced, timed in turns
    with those designs, warm and L2-cold, at full width on developed smoke
    (WARM_FRAMES frames of the fast stack): R2 on PRESETS["fluid3d"]'s
    128^3 grid (the kernels line's row) and on PRESETS["fluidgi"]'s 150^3
    with the probe (SH irradiance and AO rays); R1 on the default camera's
    cube faces at lod 0 with R2's light map (the kernels line's row), on
    the 800^2 DIRECT rays separate, and merged (shadow rays per sample),
    held on every MERGED_STRIDE-th ray.  Then the same four on dense smoke:
    PRESETS["fluid3d"] after DENSE_FRAMES frames, or, where under
    DENSE_MIN of its cube view samples are dense, a seeded synthetic field
    (`synthetic_smoke`).  Returns the two warm engines, whose states phase
    3h starts from."""
    phase("phase 2h: R1 and R2 (the faithful marches) vs plain versions and their per-thread "
          "designs at full width")
    from fluidx12_tpu_torch.core.config import PRESETS
    from fluidx12_tpu_torch.core.constants import device_constant
    from fluidx12_tpu_torch.core.state import unpack_scene_params
    from fluidx12_tpu_torch.ops.cuda import raymarch as R
    from fluidx12_tpu_torch.render import raymarch_core as RC
    from fluidx12_tpu_torch.render.cubemap import cube_rays
    from fluidx12_tpu_torch.render.raycast import direct_rays

    warm = warm_engine(PRESETS["fluid3d"], dev)
    warm_gi = warm_engine(PRESETS["fluidgi"], dev, radiance=np.load(PROBE)["radiance"])
    dense_engine = warm_engine(PRESETS["fluid3d"], dev, frames=DENSE_FRAMES)
    check_r2(results, "light_march_150_probe", warm_gi, "150^3 with the probe")

    cfg = warm.config
    packed, lod, _ = warm.update_frame()
    params = unpack_scene_params(packed)
    env = RC.make_light_env(params, None, cfg)
    cube = cube_rays(params, cfg, lod, dev)
    origin, ray_dir, hit = direct_rays(params, cfg, dev)
    rays = (origin, ray_dir, torch.full(hit.shape, float("inf"), device=dev), hit)
    merged_num = device_constant(cfg.max_ray_samples, torch.int32, dev)
    light_map = None
    for engine, suffix, what in ((warm, "", f"{WARM_FRAMES} frames"),
                                 (dense_engine, "_dense", f"{DENSE_FRAMES} frames")):
        grid = engine.state.color
        if suffix:
            # The same pose as the 60-frame state's rays (the engines' poses agree).
            lm = R.light_march(grid, RC.pack_env(env), RC.env_flags(env, cfg),
                               params.num_light_samples, cfg)
            probe = torch.empty(cube[3].shape + (3,), dtype=torch.int32, device=dev)
            R.view_march(grid, *cube, params.num_samples, RC.pack_env(env),
                         RC.env_flags(env, cfg), cfg, light_map=lm, samples=probe)
            share = float(probe[..., 1].sum()) / max(float(probe[..., 0].sum()), 1.0)
            voxels = float((grid[3].float() >= cfg.zero_threshold).float().mean())
            print(f"dense smoke: after {DENSE_FRAMES} frames {100 * voxels:.2f}% of the voxels "
                  f"and {100 * share:.2f}% of the cube view samples are dense")
            if share < DENSE_MIN:
                grid = synthetic_smoke(cfg, dev)
                what = (f"a seeded synthetic field (default_rng({DENSE_SEED}), "
                        f"{100 * DENSE_SHARE:.0f}% of the voxels dense)")
                print(f"dense smoke: under {100 * DENSE_MIN:.0f}% dense there; R1 and R2 are "
                      f"held and timed on {what} instead")
        light_map = check_r2(results, f"light_march{suffix}", engine, f"128^3, {what}", grid=grid)
        check_r1(results, f"view_march{suffix}", grid, cube, params.num_samples, env, cfg,
                 f"cube faces, lod {lod}, separate, {what}", light_map=light_map)
        check_r1(results, f"view_march_direct{suffix}", grid, rays, params.num_samples, env,
                 cfg, f"800^2 DIRECT, separate, {what}", light_map=light_map)
        check_r1(results, f"view_march_direct_merged{suffix}", grid, rays, merged_num, env, cfg,
                 f"800^2 DIRECT, merged, {what}", num_light=params.num_light_samples,
                 stride=MERGED_STRIDE)
    del dense_engine
    torch.cuda.empty_cache()
    return warm, warm_gi


def faithful_projection_counts(cfg) -> dict:
    """Launches of the projection's kernels per frame with fast_sim=False
    (no multigrid; sim/project.py): B3 and B8 where the stencil gate holds,
    B4 once for all the sweeps where the TPU tunes it (its plane-sweep
    order where the order says so), on the storage dims where the TPU
    stores the grid padded."""
    from fluidx12_tpu_torch.core.padding import storage_zyx
    from fluidx12_tpu_torch.ops.cuda import jacobi as J
    from fluidx12_tpu_torch.ops.cuda import stencil as ST

    storage = storage_zyx(cfg)
    kernels = cfg.use_pallas and (storage != cfg.zyx or cfg.pallas_jacobi)
    stencil = int(kernels and ST.stencil_pallas_supported(storage))
    tuning = J.jacobi_tuning(storage, cfg.num_pressure_iters) if kernels else None
    return dict(divergence=stencil, grad_damp=stencil, jacobi=int(tuning is not None),
                jacobi_planewise=int(tuning is not None and J.window_order(storage, tuning[1])
                                     == J.ORDER_PLANEWISE))


def fast_sim_counts(frames: int) -> dict:
    """The default preset's fast simulation a frame (phase 3): B1, B2, B3,
    B4 twice, B5, B6, B7, B8."""
    return dict(advect_xy=frames, advect_z_forces=frames, divergence=frames, jacobi=2 * frames,
                residual=frames, jacobi_packed=frames, prolong_correct=frames,
                grad_damp=frames)


def replay_matches_eager(cfg, dev, label, setup, method, state, radiance=None,
                         frames: int = 3) -> None:
    """Two engines of `cfg` from `state`, after `setup`, under `method`: the
    frames `step_frame` replays equal those of `_frame_eager` bit for bit
    (fields, pressure, image, launch counts), as phase 3g holds them."""
    from fluidx12_tpu_torch.engine.fluidx import FluidXEngine
    from fluidx12_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    eager, graph = (FluidXEngine(cfg, radiance=radiance, device=dev) for _ in range(2))
    for e in (eager, graph):
        e.state = state
        e.render_method = method
        setup(e)
    for i in range(frames):
        reset_launch_counts()
        image_a = eager._frame_eager()
        counts_a = launch_counts()
        reset_launch_counts()
        image_b = graph.step_frame()
        torch.cuda.synchronize()
        same = {"fields": torch.equal(eager.state.fields, graph.state.fields),
                "pressure": torch.equal(eager.state.pressure, graph.state.pressure),
                "image": torch.equal(image_a, image_b), "launch counts": counts_a == launch_counts()}
        check(all(same.values()) and len(graph._graphs) == 1,
              f"{label}, frame {i + 1}: the replayed frame equals the frame op by op: {same}")
    print(f"{label}: {frames} frames replayed equal the frames op by op bit for bit (fields, "
          f"pressure, image, launch counts)")
    del eager, graph
    torch.cuda.empty_cache()


def eye_inside_256(dev, smi_line, results, frames, inside):
    """RAY_MARCH_DIRECT_SEPARATE at 256^3 (no probe) with the eye inside
    the volume, from 4 * WARM_FRAMES frames of smoke (after 20 frames the
    plume is not yet in the view from inside): the fast simulation as
    phase 3c runs it (B1-B4, B7, B8, B13; B4 twice, once in its
    plane-sweep order), B9's light map (swept at half the lateral size,
    upsampled to the grid's dims) and R1 on it, exact launch counts, the
    replays held to the frames op by op; then R1 held to its plain version
    on the 800^2 rays with that map and with it averaged to
    (3, 256, 128, 128)."""
    from fluidx12_tpu_torch.core.config import FluidConfig, RenderMethod
    from fluidx12_tpu_torch.core.state import unpack_scene_params
    from fluidx12_tpu_torch.render import raymarch_core as RC
    from fluidx12_tpu_torch.render.lightmap_sweep import render_light_map_fast
    from fluidx12_tpu_torch.render.raycast import direct_rays

    cfg = FluidConfig(grid_size=GRID_256)
    method = RenderMethod.RAY_MARCH_DIRECT_SEPARATE
    label = "256^3, eye inside the volume, RAY_MARCH_DIRECT_SEPARATE"
    warm = warm_engine(cfg, dev, frames=4 * WARM_FRAMES)
    state = warm.state
    del warm
    counts, _, engine = run_frames(cfg, frames, dev, smi_line, label, method=method,
                                   state=state, setup=inside)
    # Phase 3c's 256^3 counts, with R1 for B10.
    expect = {name: frames for name in KERNELS}
    expect.update(jacobi=2 * frames, jacobi_planewise=frames, composite_resample=0,
                  gi_light=0, light_march=0,
                  **{name: 0 for name in ("residual", "jacobi_packed", "advect_z")
                     + KERNELS_2D + KERNELS_FUSED + KERNELS_SLAB + KERNELS_ADJOINT})
    check(counts == expect, f"{label}: launch counts {counts} != {expect}")
    eager_vs_replayed(engine, label, smi_line, frames=5)
    params = unpack_scene_params(engine.update_frame()[0])
    grid = engine.state.color
    # B9 sweeps at half the lateral size here and the map comes back
    # upsampled to the grid's dims; R1 is held on that map and on it
    # averaged to (3, Z, Y/2, X/2), a map of other dims than the grid's.
    light_map = render_light_map_fast(grid, params, cfg, None).float().contiguous()
    check(tuple(light_map.shape) == (3,) + cfg.zyx,
          f"B9's light map at the grid's dims: {tuple(light_map.shape)}")
    z, y, x = cfg.zyx
    half = light_map.reshape(3, z, y // 2, 2, x // 2, 2).mean(dim=(3, 5)).contiguous()
    origin, ray_dir, hit = direct_rays(params, cfg, dev)
    rays = (origin, ray_dir, torch.full(hit.shape, float("inf"), device=dev), hit)
    env = RC.make_light_env(params, None, cfg)
    for name, lm, what in (("view_march_direct_256_inside", light_map, "B9's map"),
                           ("view_march_direct_256_half_map", half,
                            "B9's map averaged to (3, 256, 128, 128)")):
        check_r1(results, name, grid, rays, params.num_samples, env, cfg,
                 f"800^2 DIRECT from inside the 256^3 volume, separate, {what}", light_map=lm)
    del engine
    replay_matches_eager(cfg, dev, label, inside, method, state)


def phase3h_faithful_frames(dev, smi_line, warm, warm_gi, results):
    """The faithful stack at full width, each run FRAMES_FAITHFUL frames
    from a warm engine's developed state, with exact launch counts:
    PRESETS["fluid3d"] after toggle_ez() under the four methods (the gather
    advect: no B1 or B2; the projection without multigrid: B3, B4's 64
    sweeps in one call, B8; R2 a frame under the separate methods, R1 a
    frame; no B9 or B10); the DIRECT methods with the eye inside the volume
    (the fast stack but the faithful march: B1-B8, B9 under
    DIRECT_SEPARATE, R1, no B10); a point light inside the volume (the
    fast simulation, the faithful render: R2 and R1, no B9 or B10); and
    PRESETS["fluidgi"] after toggle_ez() under the separate and merged cube
    methods (the probe's SH and AO in R2 and in R1; the padded route's
    projection without multigrid).  The host ms/frame replayed and op by
    op, and every key's replays held to its frames op by op bit for bit.
    Last the eye inside the 256^3 volume under DIRECT_SEPARATE, where R1
    reads the light map of B9's half-size sweep (`eye_inside_256`).
    Returns the counts of the toggled default preset's RAY_MARCH_SEPARATE
    run (R1's and R2's row)."""
    phase(f"phase 3h: the faithful stack, {FRAMES_FAITHFUL} frames a run from "
          f"{WARM_FRAMES} frames of developed smoke")
    from fluidx12_tpu_torch.core.config import PRESETS, RenderMethod

    t0 = time.perf_counter()
    frames = FRAMES_FAITHFUL
    cfg = PRESETS["fluid3d"]
    toggled = dataclasses.replace(cfg, fast_render=False, fast_sim=False)
    state = warm.state

    def toggle(e):
        check(e.toggle_ez() is False and not e.config.fast_sim, "toggle_ez: the faithful stack")

    def inside(e):
        e.camera.dolly(DOLLY_INSIDE)
        check(e._direct_plane_spec(0) is None, "the eye inside the volume: no base plane")

    out = None
    for method in RenderMethod:
        label = f"toggle_ez, {method.name}"
        counts, _, engine = run_frames(cfg, frames, dev, smi_line, label, method=method,
                                       state=state, setup=toggle)
        expect = {name: 0 for name in KERNELS}
        expect.update(view_march=frames, light_march=frames if method.separate_light_pass else 0,
                      **{k: frames * v for k, v in faithful_projection_counts(toggled).items()})
        check(counts == expect, f"{label}: launch counts {counts} != {expect}")
        eager_vs_replayed(engine, label, smi_line, frames=5)
        if method == RenderMethod.RAY_MARCH_SEPARATE:
            out = counts
        del engine
    for method in (RenderMethod.RAY_MARCH_DIRECT_SEPARATE, RenderMethod.RAY_MARCH_DIRECT_MERGED):
        label = f"eye inside the volume, {method.name}"
        counts, _, engine = run_frames(cfg, frames, dev, smi_line, label, method=method,
                                       state=state, setup=inside)
        expect = {name: 0 for name in KERNELS}
        expect.update(jacobi_planewise=0, view_march=frames, **fast_sim_counts(frames),
                      shear_scan=frames if method.separate_light_pass else 0)
        check(counts == expect, f"{label}: launch counts {counts} != {expect}")
        eager_vs_replayed(engine, label, smi_line, frames=5)
        del engine
    point = dataclasses.replace(cfg, **INTERIOR_LIGHT)
    counts, _, engine = run_frames(point, frames, dev, smi_line, "interior point light",
                                   state=state)
    expect = {name: 0 for name in KERNELS}
    expect.update(jacobi_planewise=0, view_march=frames, light_march=frames,
                  **fast_sim_counts(frames))
    check(counts == expect, f"interior point light: launch counts {counts} != {expect}")
    eager_vs_replayed(engine, "interior point light", smi_line, frames=5)
    del engine

    gi = PRESETS["fluidgi"]
    radiance = np.load(PROBE)["radiance"]
    gi_proj = faithful_projection_counts(dataclasses.replace(gi, fast_render=False,
                                                             fast_sim=False))
    for method in (RenderMethod.RAY_MARCH_SEPARATE, RenderMethod.RAY_MARCH_MERGED):
        label = f"fluidgi, toggle_ez, {method.name}"
        counts, _, engine = run_frames(gi, frames, dev, smi_line, label, radiance=radiance,
                                       method=method, state=warm_gi.state, setup=toggle)
        expect = {name: 0 for name in KERNELS}
        expect.update(view_march=frames, light_march=frames if method.separate_light_pass else 0,
                      **{k: frames * v for k, v in gi_proj.items()})
        check(counts == expect, f"{label}: launch counts {counts} != {expect}")
        eager_vs_replayed(engine, label, smi_line, frames=5)
        del engine
    torch.cuda.empty_cache()

    for label, c, setup, method, st, rad in (
            ("toggle_ez, RAY_MARCH_SEPARATE", cfg, toggle, RenderMethod.RAY_MARCH_SEPARATE,
             state, None),
            ("toggle_ez, RAY_MARCH_DIRECT_MERGED", cfg, toggle,
             RenderMethod.RAY_MARCH_DIRECT_MERGED, state, None),
            ("eye inside, RAY_MARCH_DIRECT_SEPARATE", cfg, inside,
             RenderMethod.RAY_MARCH_DIRECT_SEPARATE, state, None),
            ("interior point light", point, lambda e: None, RenderMethod.RAY_MARCH_SEPARATE,
             state, None),
            ("fluidgi, toggle_ez, RAY_MARCH_MERGED", gi, toggle, RenderMethod.RAY_MARCH_MERGED,
             warm_gi.state, radiance)):
        replay_matches_eager(c, dev, label, setup, method, st, radiance=rad)
    eye_inside_256(dev, smi_line, results, frames, inside)
    print(f"phase 3h wall time: {time.perf_counter() - t0:.1f} s [{smi_line}]")
    return out


# ---------------------------------------------------------------------------
# The adjoint: torch.autograd through the faithful stack, R1b and R2b
# ---------------------------------------------------------------------------

# f32 operations of the adjoints, for their bound (csrc/raymarch_grad.cu;
# counted from the source, as R1_VIEW_OPS and the rest; each tape entry is
# read once and its prev taken from it, not recomputed): R1b runs each view
# sample of its ray again (R1's 53) and, per dense sample, the step and the
# opacity again (16, replay_view :291-292) and the walk back: the position
# and two corner sets (33, walk_view :334-337), the 7 channels' lerps (147,
# :343-348), the accumulation's and the step's adjoints (65, :354-376), the
# 7 lerps' adjoints (357, :380-389), 56 atomics and the position's adjoint
# (15, :393-396): 689.  R2b tests each voxel (R2's 54) and, per light
# sample of a dense voxel, runs it again (65, walk_light :449-452) and
# walks it back: the position and corners (21, :473), one lerp (21, :477),
# the transmittance's and the step's adjoints (35, :479-482), the lerp's
# adjoint (51, :486), 8 atomics and the position's adjoint (8, :488-490):
# 209.
R1B_VIEW_OPS, R1B_DENSE_OPS = R1_VIEW_OPS, 689
R2B_VOXEL_OPS, R2B_SAMPLE_OPS = R2_VOXEL_OPS, 209
# What the tape of one launch of R1b or R2b may take at ADJOINT's shapes.
GRAD_SCRATCH_MAX = 256e6
# The pieces the plain march's autograd takes the 800^2 DIRECT rays in: it
# keeps about 450 bytes a ray a step (some 55 GB at 800^2 rays and 192
# steps), so it marches and differentiates 200 rows of rays at a time.
ADJOINT_DIRECT_PIECES = 4
# tests/test_adjoint.py's render config (:85-89) for the finite differences.
ADJOINT_FD = dict(grid_size=(16, 16, 16), viewport=(24, 24), num_pressure_iters=4,
                  max_ray_samples=12, max_light_samples=4)


def adjoint_config(**kw):
    """ADJOINT: PRESETS["fluid3d"] on the faithful stack the JAX package
    differentiates (README.md; tests/test_adjoint.py), f32 state."""
    from fluidx12_tpu_torch.core.config import PRESETS

    return dataclasses.replace(PRESETS["fluid3d"], **dict(
        dict(fast_sim=False, fast_render=False, use_pallas=False, mg_pressure=False,
             quantize_cube_map=False, sim_dtype=torch.float32), **kw))


def held_grad(got, ref, what: str) -> float:
    """Holds an adjoint's gradient to autograd's through the plain version:
    within 1e-4 of its largest magnitude (atomics and autograd sum in other
    orders); returns the max abs difference."""
    err = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    print(f"{what}: max |autograd| {scale:.4g}, max |kernel - autograd| {err:.3e} "
          f"({err / max(scale, 1e-30):.2e} of it)")
    check(bool(torch.isfinite(got).all()) and scale > 0.0 and err <= 1e-4 * scale,
          f"{what} within 1e-4 of autograd's largest magnitude")
    return err


def plain_backward_ms(loss) -> float:
    """The device time of one autograd backward of `loss` (CUDA events)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    loss.backward()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def grad_occupancy_line(grid, wide: bool = False) -> None:
    """Prints what cudaFuncGetAttributes and cudaOccupancyMaxActiveBlocksPerMultiprocessor
    say of R1b, R2b and their yardsticks for `grid`'s storage type."""
    from fluidx12_tpu_torch.ops.cuda import raymarch as R

    for kernel, merge in [(k, False) for k in R.GRAD_KERNELS] + [("view_march_grad", True)]:
        o = R.grad_occupancy(kernel, grid, wide, merge)
        print(f"  {kernel}{', merged atomics' if merge else ''}: {o['registers']} registers a "
              f"thread, {o['local_bytes']} bytes local, "
              f"{o['ctas_per_sm']} CTAs of {o['threads']} threads an SM: "
              f"{o['ctas_per_sm'] * o['threads'] // 32} resident warps an SM")


def check_scratch(label: str, floats: int, yardstick_floats: int, smi_line: str) -> None:
    """Prints a launch's tape beside its yardstick's and fails above
    GRAD_SCRATCH_MAX."""
    print(f"{label}: scratch (the tape) {4 * floats / 1e6:.1f} MB a launch, the per-thread "
          f"design's {4 * yardstick_floats / 1e6:.1f} MB [{smi_line}]")
    check(4 * floats <= GRAD_SCRATCH_MAX,
          f"{label}: the tape within {GRAD_SCRATCH_MAX / 1e6:.0f} MB")


def held_yardstick(got, ref, what: str) -> float:
    """Holds a new adjoint kernel to its yardstick within 1e-4 of the
    yardstick's largest magnitude (the atomics' order); returns the max
    abs difference."""
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    check(bool(torch.isfinite(got).all()) and scale > 0.0 and err <= 1e-4 * scale,
          f"{what} within 1e-4 of its per-thread design's largest magnitude")
    return err


def check_r2b(results, name, grid, env, cfg, num, label, smi_line, plain: bool = True):
    """R2b at full width against autograd through `light_map_plain` with a
    seeded cotangent (or, `plain` false, against its per-thread design
    only), timed in turns with the per-thread design it replaced, warm and
    L2-cold (where `plain`, it must beat it in both), beside the plain
    backward, with its bound and its scratch."""
    from fluidx12_tpu_torch.ops.cuda import raymarch as R
    from fluidx12_tpu_torch.render import raymarch_core as RC
    from fluidx12_tpu_torch.render.lightmap import light_map_plain

    packed, flags = RC.pack_env(env), RC.env_flags(env, cfg)
    cot = torch.from_numpy(np.random.default_rng(20).standard_normal((3,) + cfg.zyx)
                           .astype(np.float32)).to(grid.device)
    samples = torch.empty(cfg.zyx, dtype=torch.int32, device=grid.device)
    samples_old = torch.empty_like(samples)
    got = R.light_march_grad(grid, packed, flags, num, cfg, cot, samples=samples)
    old = R.light_march_grad_perthread(grid, packed, flags, num, cfg, cot, samples=samples_old)
    check(torch.equal(samples, samples_old),
          f"R2b {label}: the same samples walked as the per-thread design")
    err_old = held_yardstick(got, old, f"R2b {label}")
    plain_ms, plain_peak, err = float("nan"), float("nan"), err_old
    if plain:
        torch.cuda.reset_peak_memory_stats()
        g_ref = grid.detach().to(torch.float32, copy=True).requires_grad_(True)
        loss = (light_map_plain(g_ref, env, num, cfg) * cot).sum()
        plain_ms = plain_backward_ms(loss)
        plain_peak = torch.cuda.max_memory_allocated()
        err = held_grad(got, g_ref.grad, f"R2b {label}")
        del loss, g_ref
    taken = float(samples.sum())
    flops = grid[3].numel() * R2B_VOXEL_OPS + taken * R2B_SAMPLE_OPS
    # In: the density channel (the only one R2b reads) and the cotangent;
    # out: the grid's cotangent (channels 0-2 zero).
    bound_ms, bound_by = bound(nbytes(grid[3], cot, got), flops)
    results[name] = dict(max_abs_err=err, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=None)
    time_r_designs(results, name,
                   lambda g=grid, c=cot: R.light_march_grad(g, packed, flags, num, cfg, c),
                   lambda g=grid, c=cot: R.light_march_grad_perthread(g, packed, flags, num,
                                                                      cfg, c),
                   (grid, cot), reps=5, checked=plain)
    plan = R.light_grad_plan(cfg.zyx)
    check_scratch(f"R2b {label}", R.light_grad_tape_floats(plan, grid, cfg.max_light_samples),
                  3 * cfg.max_light_samples * grid[0].numel(), smi_line)
    # The traffic if every tap and atomic went to device memory.
    traffic = taken * 8 * (2 * 4 + 8)
    print(f"R2b {label}: {results[name]['ms']:.4f} ms, plain autograd backward {plain_ms:.2f} ms "
          f"(peak {plain_peak / 2**30:.2f} GiB with its forward), bound {bound_ms * 1e3:.1f} us "
          f"({bound_by}); {taken:.4g} light samples walked; {err_old:.3e} from the per-thread "
          f"design; every tap and atomic at the memory rate "
          f"{traffic / HBM_BYTES_PER_S * 1e3:.4f} ms [{smi_line}]")


def check_r1b(results, name, grid, light_map, rays, num, env, cfg, label, smi_line,
              pieces: int = 1, plain: bool = True):
    """R1b against autograd through the plain separate-light march with a
    seeded cotangent on `rays` (origin, direction, t_max, active) (or,
    `plain` false, against its per-thread design only), timed in turns
    with the per-thread design it replaced, warm and L2-cold (where
    `plain`, it must beat it in both), beside the plain backward, with its
    bound and its scratch; stored under `name`.  The plain march takes the
    rays in `pieces` along their first axis, each piece's backward adding
    into the same gradients: rays march independently, so the sum is the
    whole rays' gradient, and the plain ms is the pieces' sum."""
    from fluidx12_tpu_torch.ops.cuda import raymarch as R
    from fluidx12_tpu_torch.render import raymarch_core as RC

    packed, flags = RC.pack_env(env), RC.env_flags(env, cfg)
    lead = tuple(rays[3].shape)
    cot = torch.from_numpy(np.random.default_rng(21).standard_normal(lead + (4,))
                           .astype(np.float32)).to(grid.device)
    samples = torch.empty(lead + (2,), dtype=torch.int32, device=grid.device)
    samples_old = torch.empty_like(samples)
    g_grid, g_lm = R.view_march_grad(grid, light_map, *rays, num, packed, flags, cfg, cot,
                                     samples=samples)
    old = R.view_march_grad_perthread(grid, light_map, *rays, num, packed, flags, cfg, cot,
                                      samples=samples_old)
    check(torch.equal(samples, samples_old),
          f"R1b {label}: the same samples walked as the per-thread design")
    err_old = max(held_yardstick(g_grid, old[0], f"R1b {label}, grid"),
                  held_yardstick(g_lm, old[1], f"R1b {label}, light map"))
    del old
    plain_ms, plain_peak, err = float("nan"), float("nan"), err_old
    if plain:
        torch.cuda.reset_peak_memory_stats()
        g_ref = grid.detach().to(torch.float32, copy=True).requires_grad_(True)
        lm_ref = light_map.clone().requires_grad_(True)
        plain_ms = 0.0
        for piece, c in zip(zip(*(r.chunk(pieces) for r in rays)), cot.chunk(pieces)):
            loss = (RC.view_march(g_ref, piece[0], piece[1], piece[2], num, env, cfg,
                                  light_map=lm_ref, active=piece[3]) * c).sum()
            plain_ms += plain_backward_ms(loss)
            del loss
        plain_peak = torch.cuda.max_memory_allocated()
        err = max(held_grad(g_grid, g_ref.grad, f"R1b {label}, grid"),
                  held_grad(g_lm, lm_ref.grad, f"R1b {label}, light map"))
        del g_ref, lm_ref
    views, dense = (float(samples[..., k].sum()) for k in range(2))
    flops = views * R1B_VIEW_OPS + dense * R1B_DENSE_OPS
    # In: the grid, the map, the rays, the cotangent; out: the grid's and the map's cotangents.
    bound_ms, bound_by = bound(nbytes(grid, light_map, *rays, cot, grid, light_map), flops)
    results[name] = dict(max_abs_err=err, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=None)

    def launch(fn):
        def call(g=grid, lm=light_map, o=rays[0], d=rays[1], t=rays[2], a=rays[3], c=cot):
            return fn(g, lm, o, d, t, a, num, packed, flags, cfg, c)
        return call

    time_r_designs(results, name, launch(R.view_march_grad), launch(R.view_march_grad_perthread),
                   (grid, light_map, *rays, cot), reps=5, checked=plain)
    plan = R.view_grad_plan(lead, tuple(grid.shape[1:]), tuple(light_map.shape[1:]))
    merge = R.view_grad_merges(lead, tuple(grid.shape[1:]))
    print(f"R1b {label}: tiles {plan.tile_w} x {32 // plan.tile_w}, the lanes' atomics "
          f"{'merged' if merge else 'not merged'}")
    check_scratch(f"R1b {label}", R.view_grad_tape_floats(plan, grid, cfg.max_ray_samples, merge),
                  3 * cfg.max_ray_samples * math.prod(lead), smi_line)
    traffic = dense * 8 * 7 * (4 + 8)
    print(f"R1b {label}: {results[name]['ms']:.4f} ms on {math.prod(lead)} rays ({views:.4g} "
          f"view samples, {dense:.4g} dense walked), plain autograd backward {plain_ms:.2f} ms in "
          f"{pieces} piece(s) (peak {plain_peak / 2**30:.2f} GiB with its forward), bound "
          f"{bound_ms * 1e3:.1f} us ({bound_by}); {err_old:.3e} from the per-thread design; "
          f"every tap and atomic at the memory rate {traffic / HBM_BYTES_PER_S * 1e3:.4f} ms "
          f"[{smi_line}]")


def adjoint_fd_start(model):
    """The FD checks' state: two steps of `model` from its initial state."""
    params = model.default_params()
    state = model.init()
    with torch.no_grad():
        for _ in range(2):
            state, _ = model.step(state, params)
    return state


def adjoint_card_vs_cpu(dev):
    """The 16^3 / 24^2 adjoint (ADJOINT_FD) on the card, through R1, R2, R1b
    and R2b, against the same on the CPU, through the plain versions under
    autograd, from one state, with the simulation (the gather advect, the
    Jacobi twins) in f32 and in bf16: the gradient of the second image's
    sum with respect to an initial velocity perturbation, of the
    simulation's dtype, within 1e-4 (f32) or 5e-2 (bf16, some six
    roundings of its largest magnitude: the state, the perturbation and
    every sim op's gradient are bf16 there) of the CPU's largest
    magnitude."""
    from fluidx12_tpu_torch.core.state import FluidState
    from fluidx12_tpu_torch.models.smoke import SmokeModel

    start = adjoint_fd_start(SmokeModel(adjoint_config(**ADJOINT_FD), device=dev))
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
        grads = []
        for device in (dev, torch.device("cpu")):
            model = SmokeModel(adjoint_config(**ADJOINT_FD, sim_dtype=dtype), device=device)
            params = model.default_params()
            fields = start.fields.to(device=device, dtype=dtype)
            v = torch.zeros((3,) + model.config.zyx, dtype=dtype, device=device,
                            requires_grad=True)
            st = FluidState(fields=torch.cat([fields[:3] + v, fields[3:]]),
                            pressure=start.pressure.to(device=device, dtype=dtype))
            st, _ = model.step(st, params)
            model.step(st, params)[1].sum().backward()
            check(v.grad.dtype == dtype, f"the gradient is {dtype}: {v.grad.dtype}")
            grads.append(v.grad.float().cpu())
        err = float((grads[0] - grads[1]).abs().max())
        scale = float(grads[1].abs().max())
        print(f"16^3 adjoint, {dtype} simulation: card vs CPU max |g| {scale:.4g}, max |card - "
              f"CPU| {err:.3e} ({err / max(scale, 1e-30):.2e} of it, tolerance {tol:g})")
        check(bool(torch.isfinite(grads[0]).all()) and scale > 0.0 and err <= tol * scale,
              f"the card's {dtype} adjoint within {tol:g} of the CPU's largest magnitude")


def adjoint_fd(dev):
    """tests/test_adjoint.py's directional-derivative check at its own 16^3
    / 24^2 config on the card, through R1 and R2 and their adjoints: from
    two steps of the initial state, the image's sum, central differences
    along default_rng(7)'s direction with its step and tolerance."""
    from fluidx12_tpu_torch.core.state import FluidState
    from fluidx12_tpu_torch.models.smoke import SmokeModel
    from fluidx12_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    model = SmokeModel(adjoint_config(**ADJOINT_FD), device=dev)
    params = model.default_params()
    state = adjoint_fd_start(model)

    def loss(v):
        st = FluidState(fields=torch.cat([state.fields[:3] + v, state.fields[3:]]),
                        pressure=state.pressure)
        return model.step(st, params)[1].sum()

    v = torch.zeros((3,) + model.config.zyx, device=dev, requires_grad=True)
    reset_launch_counts()
    loss(v).backward()
    counts = launch_counts()
    check(counts["view_march_grad"] == 1 and counts["light_march_grad"] == 1,
          f"the 16^3 adjoint ran R1b and R2b once each: {counts}")
    d = np.random.default_rng(7).normal(size=tuple(v.shape)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d)).to(dev)
    eps = 2e-2
    with torch.no_grad():
        fd = float(loss(eps * d) - loss(-eps * d)) / (2 * eps)
    ad = float((v.grad * d).sum())
    print(f"16^3 / 24^2 adjoint on the card: directional derivative {ad:.6g}, central FD "
          f"{fd:.6g} (rtol 8e-2, atol 1e-3)")
    check(math.isfinite(ad) and math.isfinite(fd) and abs(ad - fd) <= 1e-3 + 8e-2 * abs(fd)
          and abs(v.grad).max() > 1e-8, "the 16^3 adjoint agrees with finite differences")


def adjoint_guards(dev, state):
    """Under grad the fast stack's kernels (use_pallas=True with
    fast_sim=False: B3 first), the merged march and the light probe raise
    NotImplementedError; ADJOINT's own forward does not."""
    from fluidx12_tpu_torch.core.config import RenderMethod
    from fluidx12_tpu_torch.core.state import FluidState
    from fluidx12_tpu_torch.models.smoke import SmokeModel

    sh = torch.from_numpy(np.random.default_rng(23).uniform(-0.4, 1.2, (9, 3))
                          .astype(np.float32)).to(dev)
    for label, cfg, method, match in (
            ("use_pallas=True", adjoint_config(use_pallas=True), RenderMethod.RAY_MARCH_SEPARATE,
             "divergence: this kernel has no adjoint"),
            ("RAY_MARCH_MERGED", adjoint_config(), RenderMethod.RAY_MARCH_MERGED, "6b"),
            ("the light probe", adjoint_config(has_light_probe=True),
             RenderMethod.RAY_MARCH_SEPARATE, "6b")):
        model = SmokeModel(cfg, method=method, sh_coeffs=sh, device=dev)
        v = torch.zeros((3,) + cfg.zyx, device=dev, requires_grad=True)
        st = FluidState(fields=torch.cat([state.fields[:3] + v, state.fields[3:]]),
                        pressure=state.pressure)
        try:
            model.step(st, model.default_params())
        except NotImplementedError as e:
            check(match in str(e), f"{label}: the refusal names its cause: {e}")
            print(f"under grad, {label} raises: {str(e)[:110]}...")
        else:
            raise RuntimeError(f"check failed: {label} under grad did not raise")
    torch.cuda.synchronize()


def phase3j_adjoint(dev, smi_line, warm, results):
    """The adjoint on the card: torch.autograd through the faithful stack at
    ADJOINT (`adjoint_config`: PRESETS["fluid3d"], 128^3 / 800^2, 192 view
    and 64 light samples, 64 Jacobi sweeps, RAY_MARCH_SEPARATE) from the
    warm engine's developed smoke (f32).  (a) Two steps of SmokeModel.step
    with grad give the frames of the same steps under torch.no_grad() bit
    for bit, with the same launches (R1 and R2 once a step).  (b) R2b at
    128^3 and R1b on the 6 x 128^2 cube rays against autograd through the
    plain versions (seeded cotangents), and R1b on the 800^2 DIRECT_SEPARATE
    rays (the plain march in ADJOINT_DIRECT_PIECES pieces); each against
    the per-thread design it replaced (the same samples walked) and faster than it
    in turns, warm and L2-cold, its tape within GRAD_SCRATCH_MAX; the same
    three timed on dense smoke (`synthetic_smoke`); the registers and
    resident warps of R1b, R2b and their yardsticks.  (c) The loss is
    the second image's sum, its gradient with respect to an initial
    velocity perturbation (3 x 128^3): finite, non-zero, with R1b and R2b
    launched once each in the backward (the counts set to 0 just before
    the forward, read after the backward).  (d) tests/test_adjoint.py's FD
    check at 16^3, and the 16^3 adjoint with an f32 and a bf16 simulation
    against the CPU's (`adjoint_card_vs_cpu`).  (e) The guards.  Prints the forward's and the
    backward's ms (CUDA events) and the peak memory.  Returns the launch
    counts of (c)."""
    phase("phase 3j: the adjoint, torch.autograd through the faithful stack at full width")
    from fluidx12_tpu_torch.core.state import FluidState
    from fluidx12_tpu_torch.models.smoke import SmokeModel
    from fluidx12_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from fluidx12_tpu_torch.render import raymarch_core as RC
    from fluidx12_tpu_torch.render.cubemap import cube_rays
    from fluidx12_tpu_torch.render.lightmap import render_light_map
    from fluidx12_tpu_torch.render.raycast import direct_rays

    t0 = time.perf_counter()
    cfg = adjoint_config()
    model = SmokeModel(cfg, device=dev)
    params = model.default_params()
    state = FluidState(fields=warm.state.fields.float().contiguous(),
                       pressure=warm.state.pressure.clone())

    def two_steps(v):
        st = FluidState(fields=torch.cat([state.fields[:3] + v, state.fields[3:]]),
                        pressure=state.pressure)
        st, first = model.step(st, params)
        return first, model.step(st, params)[1]

    # (a) and (c): the forward without grad, then with it, then its backward.
    v = torch.zeros((3,) + cfg.zyx, device=dev)
    reset_launch_counts()
    with torch.no_grad():
        frames_ng = two_steps(v)
    counts_ng = launch_counts()
    v.requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    reset_launch_counts()
    ev[0].record()
    frames = two_steps(v)
    loss = frames[1].sum()
    ev[1].record()
    counts_fwd = launch_counts()
    loss.backward()
    ev[2].record()
    ev[2].synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    fwd_ms, bwd_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    check(all(torch.equal(a.detach(), b) for a, b in zip(frames, frames_ng)),
          "ADJOINT's frames with grad equal those under torch.no_grad() bit for bit")
    expect = {name: 0 for name in KERNELS}
    expect.update(jacobi_planewise=0, view_march=2, light_march=2)
    check(counts_ng == expect and counts_fwd == expect,
          f"ADJOINT's forward launches R1 and R2 once a step, with grad and without: "
          f"{counts_ng}, {counts_fwd}")
    check(counts == dict(expect, view_march_grad=1, light_march_grad=1),
          f"the backward launched R1b and R2b once each: {counts}")
    g = v.grad
    gmax = float(g.abs().max())
    check(bool(torch.isfinite(g).all()) and gmax > 0.0,
          "the 2-step adjoint's gradient is finite and non-zero")
    print(f"ADJOINT, 2 steps of SmokeModel.step (128^3 / 800^2, f32 state): forward with grad "
          f"{fwd_ms:.2f} ms, backward {bwd_ms:.2f} ms (CUDA events); peak memory above the "
          f"state {peak / 2**30:.2f} GiB, torch.cuda.max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; gradient of the image's sum "
          f"w.r.t. the initial velocity: max |g| {gmax:.4g}, {int((g != 0).sum())} of "
          f"{g.numel()} non-zero [{smi_line}]")
    del frames, frames_ng, loss, g, v
    torch.cuda.empty_cache()

    # (b) The kernels against autograd through the plain versions and their
    # per-thread designs; on dense smoke against those designs only.
    env = RC.make_light_env(params, None, cfg)
    origin, ray_dir, hit = direct_rays(params, cfg, dev)
    direct = (origin, ray_dir, torch.full(hit.shape, float("inf"), device=dev), hit)
    print(f"R1b and R2b on an f32 grid [{smi_line}]:")
    grad_occupancy_line(state.color)
    for grid, suffix, what in ((state.color.contiguous(), "", f"{WARM_FRAMES} frames of smoke"),
                               (synthetic_smoke(cfg, dev).float().contiguous(), "_dense",
                                f"dense smoke (default_rng({DENSE_SEED}))")):
        plain = not suffix
        light_map = render_light_map(grid, params, cfg).float().contiguous()
        check_r2b(results, f"light_march_grad{suffix}", grid, env, cfg,
                  params.num_light_samples, f"at {cfg.zyx}, {what}", smi_line, plain=plain)
        torch.cuda.empty_cache()
        check_r1b(results, f"view_march_grad{suffix}", grid, light_map,
                  cube_rays(params, cfg, 0, dev), params.num_samples, env, cfg,
                  f"on the 6 x 128^2 cube rays, {what}", smi_line, plain=plain)
        torch.cuda.empty_cache()
        check_r1b(results, f"view_march_grad_direct{suffix}", grid, light_map, direct,
                  params.num_samples, env, cfg, f"on the 800^2 DIRECT_SEPARATE rays, {what}",
                  smi_line, pieces=ADJOINT_DIRECT_PIECES, plain=plain)
        torch.cuda.empty_cache()
    adjoint_fd(dev)
    adjoint_card_vs_cpu(dev)
    adjoint_guards(dev, state)
    torch.cuda.empty_cache()
    print(f"phase 3j wall time: {time.perf_counter() - t0:.1f} s [{smi_line}]")
    return counts


def scaled_counts(counts: dict, frames_from: int, frames_to: int) -> dict:
    """`counts` of `frames_from` frames scaled to `frames_to` frames (each
    count a whole number of launches a frame)."""
    check(all(n % frames_from == 0 for n in counts.values()),
          f"{counts} are whole launches a frame over {frames_from} frames")
    return {k: n // frames_from * frames_to for k, n in counts.items()}


def write_float_cube_dds(path: str, cube: np.ndarray) -> None:
    """A DX10 RGBA32F cube-map DDS of the (6, S, S, 3) f32 `cube`, alpha 1."""
    import struct

    size = cube.shape[1]
    header = bytearray(148)
    header[0:4] = b"DDS "
    struct.pack_into("<7I", header, 4, 124, 0x1007, size, size, 0, 1, 1)
    struct.pack_into("<II", header, 4 + 72, 32, 0x4)
    header[4 + 80:4 + 84] = b"DX10"
    struct.pack_into("<I", header, 4 + 108, 0x1000 | 0x8)
    struct.pack_into("<I", header, 4 + 112, 0x200 | 0xFE00)
    struct.pack_into("<5I", header, 128, 2, 3, 0x4, 1, 0)
    rgba = np.concatenate([cube, np.ones(cube.shape[:-1] + (1,), np.float32)], axis=-1)
    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(np.ascontiguousarray(rgba, np.float32).tobytes())


def run_cli(argv, label: str, expect=None) -> dict:
    """cli.main(argv) on the card with the launch counts set to 0 just
    before; the frames it dispatched (as FrameLoop paced them), its engine,
    its stderr and the launch counts of its frame loop (read as
    FrameLoop.run returns, before --profile-passes), which must equal
    `expect` where given."""
    import contextlib
    import io

    from fluidx12_tpu_torch.engine import cli
    from fluidx12_tpu_torch.engine import frame_loop as FL
    from fluidx12_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    got = {"frames": []}
    pace, run = FL.FrameLoop._pace, FL.FrameLoop.run

    def recording(self, image):
        got["frames"].extend(image.unbind(0) if image.ndim == 4 else [image])
        got["engine"] = self.engine
        return pace(self, image)

    def counted(self, *args, **kwargs):
        out = run(self, *args, **kwargs)
        got["counts"] = launch_counts()
        return out

    err = io.StringIO()
    FL.FrameLoop._pace, FL.FrameLoop.run = recording, counted
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(err):
            rc = cli.main(argv)
    finally:
        FL.FrameLoop._pace, FL.FrameLoop.run = pace, run
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got["stderr"] = err.getvalue()
    print(f"{label}: cli.main({' '.join(argv)}) -> {rc} in {secs:.2f} s, "
          f"{len(got['frames'])} frames; stderr: {got['stderr'].strip()!r}")
    check(rc == 0, f"{label}: exit code {rc}")
    check(got["stderr"].startswith("[fluidx12-tpu-torch] device: cuda ("),
          f"{label}: the banner names the card")
    if expect is not None:
        check(got["counts"] == expect, f"{label}: launch counts {got['counts']} != {expect}")
    image = got["frames"][-1]
    check(bool(torch.isfinite(image).all()) and image.is_cuda, f"{label}: finite frames")
    return got


def passes_printed(stderr: str) -> dict:
    """{pass: ms} of the `[profile] name ms` lines."""
    out = {}
    for line in stderr.splitlines():
        if line.startswith("[profile]"):
            _, name, ms, _ = line.split()
            out[name] = float(ms)
    return out


def shell_ms(engine, frames: int, turns: int = 3) -> dict:
    """Host ms/frame, in turns on one engine whose key is captured: a
    bare loop of `frames` step_frame calls and FrameLoop.run(frames) with
    batch 1 and 8, each ending in a synchronize (FrameLoop.run ends with
    the last frame on the host), and step_frame synchronized each frame
    (the median of its frames)."""
    from fluidx12_tpu_torch.engine.frame_loop import FrameLoop

    loop = FrameLoop(engine, show_fps=False)

    def bare():
        for _ in range(frames):
            engine.step_frame()
        torch.cuda.synchronize()

    def synced():
        times = []
        for _ in range(frames):
            t0 = time.perf_counter()
            engine.step_frame()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    out = {"step_frame": [], "FrameLoop.run, batch 1": [], "FrameLoop.run, batch 8": [],
           "step_frame synchronized (median)": []}
    for _ in range(turns):
        for name, fn in (("step_frame", bare),
                         ("FrameLoop.run, batch 1", lambda: loop.run(frames)),
                         ("FrameLoop.run, batch 8", lambda: loop.run(frames, batch=8))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            out[name].append((time.perf_counter() - t0) * 1e3 / frames)
        out["step_frame synchronized (median)"].append(synced())
    return out


def phase3i_shell(dev, smi_line, counts_3d, counts_2d, counts_fluidgi, counts_direct_merged):
    """The engine shell at full width: `python -m fluidx12_tpu_torch.engine.cli`
    called in-process on the card.  (a) The default launch (PRESETS["fluid3d"],
    128^3 / 800^2) for FRAMES frames with screenshots, metrics and the
    watchdog, with batch 1 and 8: the two last frames equal bit for bit,
    the PNGs decode to the frames' to_srgb_u8, the launches exactly phase
    3's.  (b) 30 frames and a checkpoint, then a fresh engine restored from
    it for 30 more: its frames equal the uninterrupted run's frames 31-60
    bit for bit.  (c) PRESETS["fluidgi"] with the default probe and with the
    same probe written to a float DDS (equal frames), PRESETS["fluid2d"]
    and --method 2, launches as phases 3e, 3b and 3f counted them.  (d)
    --profile-passes and a --profile trace with CUDA kernel events.  (e)
    printed, not gated: host ms/frame of FrameLoop.run against bare
    step_frame calls, and the watchdog's cost."""
    import os
    import tempfile

    from fluidx12_tpu_torch.core.config import PRESETS
    from fluidx12_tpu_torch.engine.fluidx import FluidXEngine
    from fluidx12_tpu_torch.engine.frame_loop import FrameLoop
    from fluidx12_tpu_torch.utils.image import to_srgb_u8
    from fluidx12_tpu_torch.utils.native import get_native_lib
    from fluidx12_tpu_torch.utils.png import read_png

    phase("phase 3i: the shell, python -m fluidx12_tpu_torch.engine.cli at full width")
    half = FRAMES // 2
    base = ["--no-fps"]
    print(f"PNG encoder: {'native' if get_native_lib() is not None else 'numpy'}")
    with tempfile.TemporaryDirectory() as tmp:
        # (a) The default launch, per frame and eight frames a dispatch.
        runs = {}
        for batch in (1, 8):
            shots = os.path.join(tmp, f"b{batch}_f_{{frame}}.png")
            metrics = os.path.join(tmp, f"b{batch}_m.jsonl")
            runs[batch] = run_cli(
                base + ["--frames", str(FRAMES), "--screenshot", shots, "--screenshot-every",
                        str(half), "--metrics", metrics, "--watchdog", str(WATCHDOG), "--batch",
                        str(batch)], f"fluid3d, batch {batch}", expect=counts_3d)
            frames = runs[batch]["frames"]
            check(len(frames) == FRAMES, f"batch {batch}: {len(frames)} frames")
            for n in (half, FRAMES):
                check(np.array_equal(read_png(shots.format(frame=n)),
                                     to_srgb_u8(frames[n - 1])),
                      f"batch {batch}: the PNG of frame {n} is its frame")
            # The watchdog runs after the dispatch that crosses each multiple
            # of its period (frames 24, 40, 60 with batch 8).
            ends = list(range(batch, FRAMES, batch)) + [FRAMES]
            due = [e for p, e in zip([0] + ends, ends) if e // WATCHDOG > p // WATCHDOG]
            recs = [json.loads(line) for line in open(metrics)]
            check([r["frame"] for r in recs] == due
                  and all(r["healthy"] and r["cfl_disp"] is not None for r in recs),
                  f"batch {batch}: the watchdog's metrics {recs}")
            print(f"batch {batch}: watchdog metrics {recs}")
        check(torch.equal(runs[1]["frames"][-1], runs[8]["frames"][-1]),
              "batch 1 and batch 8 give the same last frame")
        same = sum(torch.equal(a, b) for a, b in zip(runs[1]["frames"], runs[8]["frames"]))
        print(f"batch 1 and 8: {same} of {FRAMES} frames equal bit for bit")
        check(same == FRAMES, "batch 1 and 8 give the same frames")

        # (b) Resume from a checkpoint in a fresh engine.
        ckpt = os.path.join(tmp, "session.npz")
        first = run_cli(base + ["--frames", str(half), "--checkpoint", ckpt], "first half")
        check(all(torch.equal(a, b) for a, b in zip(first["frames"], runs[1]["frames"])),
              "the first half equals the uninterrupted run")
        second = run_cli(base + ["--frames", str(FRAMES - half), "--restore", ckpt],
                         "restored half")
        check(second["engine"].frame_index == FRAMES, "the restored run ends at frame 60")
        diff = [i + half + 1 for i, (a, b) in enumerate(zip(second["frames"],
                                                             runs[1]["frames"][half:]))
                if not torch.equal(a, b)]
        check(not diff, f"resumed frames equal frames {half + 1}-{FRAMES} (differ: {diff})")
        print(f"resume: frames {half + 1}-{FRAMES} equal bit for bit")
        del runs, first, second

        # (c) The other launches.
        gi = run_cli(base + ["--preset", "fluidgi", "--frames", str(FRAMES_FLUIDGI)],
                     "fluidgi", expect=counts_fluidgi)
        dds_path = os.path.join(tmp, "probe.dds")
        write_float_cube_dds(dds_path, np.load(PROBE)["radiance"])
        gi_dds = run_cli(base + ["--preset", "fluidgi", "--radiance", dds_path, "--frames",
                                 str(FRAMES_FLUIDGI)], "fluidgi --radiance", expect=counts_fluidgi)
        check(torch.equal(gi["frames"][-1], gi_dds["frames"][-1]),
              "the DDS probe renders what the npz probe does")
        del gi, gi_dds
        run_cli(base + ["--preset", "fluid2d", "--frames", str(FRAMES_2D)], "fluid2d",
                expect=counts_2d)
        direct = run_cli(base + ["--method", "2", "--frames", str(FRAMES_DIRECT),
                                 "--profile-passes"], "--method 2",
                         expect=scaled_counts(counts_direct_merged, FRAMES_DIRECT_MERGED,
                                              FRAMES_DIRECT))
        ms = passes_printed(direct["stderr"])
        check(list(ms) == ["advect", "project", "light_map", "plane_march", "warp", "total"]
              and all(v > 0 for v in ms.values()), f"--method 2 passes {ms}")
        del direct

        # (d) The pass profiler and a trace.
        prof_dir = os.path.join(tmp, "prof")
        n = 10
        prof = run_cli(base + ["--frames", str(n), "--profile", prof_dir, "--profile-passes"],
                       "--profile", expect=scaled_counts(counts_3d, FRAMES, n))
        ms = passes_printed(prof["stderr"])
        check(list(ms) == ["advect", "project", "light_map", "cube_march", "resolve", "total"]
              and all(v > 0 for v in ms.values()), f"fluid3d passes {ms}")
        print(f"fluid3d passes, ms (CUDA events, 5 calls each): {ms} [{smi_line}]")
        del prof
        trace = os.path.join(prof_dir, "trace.json")
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        print(f"--profile: {trace} {os.path.getsize(trace)} bytes, {len(events)} events, "
              f"{len(kernels)} CUDA kernel events")
        check(len(kernels) > 0, "the trace holds CUDA kernel events")

    # (e) The loop's own cost, printed.
    engine = FluidXEngine(PRESETS["fluid3d"], device=dev)
    for _ in range(WARMUP_FRAMES):
        engine.step_frame()
    times = shell_ms(engine, FRAMES)
    for name, ms in times.items():
        print(f"shell, fluid3d: {name}: " + ", ".join(f"{t:.3f}" for t in ms)
              + f" ms/frame ({FRAMES} frames a turn, in turns) [{smi_line}]")
    # What FrameLoop.run adds once a run: its last frame to the host as u8.
    image = engine.step_frame()
    finish = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        to_srgb_u8(image)
        finish.append((time.perf_counter() - t0) * 1e3)
    print(f"shell, fluid3d: a run's end, the last frame to the host as u8: median "
          f"{statistics.median(finish):.3f} ms (10 calls) [{smi_line}]")
    import contextlib
    import io

    loop = FrameLoop(engine, show_fps=False)
    costs = []
    with contextlib.redirect_stdout(io.StringIO()):  # the CFL warnings
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loop._watchdog()
            costs.append((time.perf_counter() - t0) * 1e3)
    print(f"shell, fluid3d: the watchdog's cost: median {statistics.median(costs):.3f} ms a "
          f"call, min {min(costs):.3f}, max {max(costs):.3f} (20 calls, the card idle; "
          f"{loop.cfl_warnings} CFL warnings) [{smi_line}]")


# ---------------------------------------------------------------------------
# Phase 3k: the XLA twins, the ensemble and the sharded frame
# ---------------------------------------------------------------------------

FRAMES_TWIN = 13
ENSEMBLE = 4


def twin_frames(cfg, dev, label: str, expect: dict, frames: int = 3) -> None:
    """`frames` frames of `cfg` from rest on the card, replayed (step_frame)
    and op by op (_frame_eager), each held to the same frames on the CPU
    within phase 4's tolerance (1 bf16 ulp at each channel's scale, 2 u8
    levels), with the launch counts of the two card runs `expect` times
    `frames` each."""
    from fluidx12_tpu_torch.utils.compare import bf16_ulps
    from fluidx12_tpu_torch.engine.fluidx import FluidXEngine
    from fluidx12_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from fluidx12_tpu_torch.utils.image import to_srgb_u8

    runs = {}
    for kind, device in (("cpu", "cpu"), ("replayed", dev), ("op by op", dev)):
        engine = FluidXEngine(cfg, device=device)
        step = engine._frame_eager if kind == "op by op" else engine.step_frame
        if kind == "replayed":
            reset_launch_counts()
        for _ in range(frames):
            img = step()
        runs[kind] = (engine.state.fields.float().cpu(), to_srgb_u8(img).astype(np.int32))
    counts = launch_counts()
    want = {k: 2 * frames * v for k, v in expect.items()}
    check(counts == want, f"{label}: launch counts {counts} != {want}")
    for kind in ("replayed", "op by op"):
        ulps = bf16_ulps(runs[kind][0], runs["cpu"][0])
        img_err = int(np.abs(runs[kind][1] - runs["cpu"][1]).max())
        print(f"{label}: {frames} frames {kind} on the card vs the CPU: fields {ulps:.2f} bf16 "
              f"ulp at each channel's scale, image max u8 diff {img_err} (limits 1 and 2)")
        check(ulps <= 1.0 and img_err <= 2, f"{label}: {kind} CUDA vs CPU")


def phase3k_twins_ensemble_sharded(dev, smi_line, counts_main):
    """(a) The XLA twins at full width: replace(PRESETS["fluid3d"],
    use_pallas=False), which launches no kernel, and pallas_advect=False,
    which launches B3-B10 as the main path and neither B1 nor B2; a few
    frames replayed and op by op held to the CPU's, then FRAMES_TWIN frames
    timed.  (b) SmokeEnsemble(PRESETS["fluid3d"], batch=ENSEMBLE): each
    member bit for bit with a lone SmokeModel.step from its state, the
    launches exactly ENSEMBLE times one member's, ms per ensemble frame.
    (c) sharded_simulate + sharded_render_frame at world size 1 on nccl
    (use_pallas=False, 128^3 / 800^2, without and with the probe), held to
    the single-device reference the dry run builds (parallel/dryrun.py):
    from rest, as the JAX dry run, colour within 2e-5 and image within
    2e-4; from the twin's developed state, within 1 bf16 ulp at each
    channel's scale and image within 2e-4."""
    phase("phase 3k: use_pallas=False and pallas_advect=False, SmokeEnsemble(batch="
          f"{ENSEMBLE}) and the world-size-1 sharded frame at 128^3 / 800^2")
    from fluidx12_tpu_torch.core.config import PRESETS
    from fluidx12_tpu_torch.core.state import FluidState
    from fluidx12_tpu_torch.models.smoke import SmokeModel
    from fluidx12_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from fluidx12_tpu_torch.parallel import dryrun
    from fluidx12_tpu_torch.parallel.domain import shard_state, sharded_simulate
    from fluidx12_tpu_torch.parallel.ensemble import SmokeEnsemble
    from fluidx12_tpu_torch.parallel.mesh import init_distributed, make_grid_mesh
    from fluidx12_tpu_torch.parallel.render import sharded_render_frame

    t_start = time.perf_counter()
    base = PRESETS["fluid3d"]
    twin = dataclasses.replace(base, use_pallas=False)
    no_advect = dataclasses.replace(base, pallas_advect=False)
    per_frame = {k: v // FRAMES for k, v in counts_main.items()}
    twin_frames(twin, dev, "use_pallas=False", {k: 0 for k in counts_main})
    twin_frames(no_advect, dev, "pallas_advect=False",
                dict(per_frame, advect_xy=0, advect_z_forces=0))
    engine = None
    for label, cfg in (("use_pallas=False", twin), ("pallas_advect=False", no_advect)):
        counts, faces, engine = run_frames(cfg, FRAMES_TWIN, dev, smi_line, label)
        want = ({k: 0 for k in counts_main} if cfg is twin else
                dict({k: FRAMES_TWIN * v for k, v in per_frame.items()}, advect_xy=0,
                     advect_z_forces=0, composite_resample=FRAMES_TWIN * faces))
        check(counts == want, f"{label}: launch counts {counts} != {want}")
        eager_vs_replayed(engine, label, smi_line, frames=5)
        if cfg is twin:
            developed = FluidState(engine.state.fields.clone(), engine.state.pressure.clone())

    ens = SmokeEnsemble(base, batch=ENSEMBLE, device=dev)
    states, params = ens.init(seed=0), ens.default_params()
    model = ens.model
    reset_launch_counts()
    lone = [model.step(FluidState(states.fields[0].clone(), states.pressure[0].clone()),
                       model.default_params())]
    one = launch_counts()
    lone += [model.step(FluidState(states.fields[b].clone(), states.pressure[b].clone()),
                        model.default_params()) for b in range(1, ENSEMBLE)]
    reset_launch_counts()
    out, images = ens.step(states, params)
    ens_counts = launch_counts()
    check(ens_counts == {k: ENSEMBLE * v for k, v in one.items()} and one["advect_xy"] == 1,
          f"ensemble launches {ens_counts} != {ENSEMBLE} x {one}")
    for b, (st, img) in enumerate(lone):
        check(torch.equal(st.fields, out.fields[b]) and torch.equal(st.pressure, out.pressure[b])
              and torch.equal(img, images[b]), f"ensemble member {b} bit for bit with a lone run")
    check(not torch.equal(out.fields[0], out.fields[1]), "ensemble members differ")
    times = []
    for _ in range(6):
        t0 = time.perf_counter()
        out, images = ens.step(out, params)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"SmokeEnsemble(batch={ENSEMBLE}): members bit for bit with lone SmokeModel.step "
          f"runs; launches a frame {ens_counts} ({ENSEMBLE} x one member's); median ms per "
          f"ensemble frame (op by op, host clock around a synchronized step, frames 2-6) "
          f"{statistics.median(times[1:]):.3f} [{smi_line}]")

    init_distributed(0, 1, dev, None)
    try:
        mesh = make_grid_mesh(1, dev)
        # From rest, as the JAX dry run, under its gates; then from the
        # twin's developed smoke, where the bf16 state's last bit differs
        # here and there: within 1 bf16 ulp at each channel's scale.
        for label, cfg, start in (
                ("sharded, from rest", twin, None),
                ("sharded, probe, from rest", dataclasses.replace(twin, has_light_probe=True),
                 None),
                ("sharded, developed", twin, developed),
                ("sharded, probe, developed", dataclasses.replace(twin, has_light_probe=True),
                 developed)):
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = dryrun.run_domain(mesh, cfg, frames=2, state0=start)
            print(f"{label}, world size 1 on nccl: {res} against the single-device reference "
                  f"(limits: from rest colour 2e-5 and image 2e-4; developed 1 bf16 ulp and "
                  f"image 2e-4); two sharded frames and their reference "
                  f"{(time.perf_counter() - t0) * 1e3:.1f} ms [{smi_line}]")
            if start is None:
                dryrun.check(res)
            check(res["state_ulps"] <= 1.0 and res["image"] <= 2e-4, f"{label}: held")
            check(sum(launch_counts().values()) == 0, f"{label}: no kernel launched")
        times = []
        state = shard_state(developed, mesh)
        params = SmokeModel(twin, device=dev).default_params()
        for _ in range(4):
            t0 = time.perf_counter()
            state = sharded_simulate(state, twin.time_step, twin, mesh)
            sharded_render_frame(state.color, params, twin, mesh)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        print(f"sharded frame, world size 1 on nccl: median ms/frame "
              f"{statistics.median(times[1:]):.3f} (host clock, frames 2-4) [{smi_line}]")
    finally:
        torch.distributed.destroy_process_group()
    print(f"phase 3k wall time: {time.perf_counter() - t_start:.1f} s [{smi_line}]")


def phase4_cpu_vs_cuda(dev):
    """The port on CUDA against the port on the CPU, 3 frames at six small
    grids: the pallas_jacobi=False path at (128, 128, 16), the default
    projection kernels at (128, 128, 64), the 2D path with B11 and B14 at
    (128, 128, 1), and with the probe at (384, 384, 32), where the TPU runs
    B13, B4's plane-sweep order and B16 (and the AO at half resolution, 192
    lanes, no B15); at (256, 256, 32) with the fused projection, where it
    runs B18, B16 and B15 (the AO's (16, 128, 128) half field); and at
    (128, 128, 20), stored (32, 128, 128) on the TPU, where it runs B15 on
    the full-resolution GI normals, the padded projection and B10 on every
    face, with a 256x256 viewport (lod 0); and at (150, 150, 72), stored
    (80, 160, 256) as 150^3 is, where the padded projection prolongs with
    the twin.  Then three frames of the fast DIRECT methods and the point
    light: RAY_MARCH_DIRECT_MERGED on tests/test_golden.py's 24^3
    `fluid3d_direct` case (64x64 viewport, 32 ray and 8 light samples, 16
    Jacobi sweeps), whose (256, 256) base plane B10's gate refuses (24 %
    16), so B17 composites it after the zero-outside resample;
    RAY_MARCH_DIRECT_SEPARATE at 32^3, where B10 marches the plane in its
    zero-outside mode; and the point light at 32^3 (the cube path, no B9).
    Last the faithful stack at 32^3 (64 ray and 16 light samples): the
    separate cube method (R2 and R1) and RAY_MARCH_DIRECT_MERGED with the
    probe (R1's shadow, SH and AO per sample), the CPU's frames through the
    kernels' plain versions.  Returns the launch counts of the 24^3 DIRECT
    frames, B17's path."""
    from fluidx12_tpu_torch.utils.compare import bf16_ulps
    phase("phase 4: port on CUDA vs port on CPU, 3 frames each")
    from fluidx12_tpu_torch.core.config import FluidConfig, RenderMethod
    from fluidx12_tpu_torch.engine.fluidx import FluidXEngine
    from fluidx12_tpu_torch.utils.image import to_srgb_u8

    from fluidx12_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    radiance = np.load(PROBE)["radiance"]
    golden = dict(grid_size=(24, 24, 24), viewport=(64, 64), max_ray_samples=32,
                  max_light_samples=8, num_pressure_iters=16)
    direct = RenderMethod.RAY_MARCH_DIRECT_MERGED
    # The faithful stack (R1 and R2's plain versions on the CPU), with the
    # sample counts cut so that the CPU's nested loops stay short.
    faithful = dict(fast_render=False, fast_sim=False, max_ray_samples=64, max_light_samples=16)
    b17_counts = None
    for kw, method in ((dict(grid_size=(128, 128, 16), pallas_jacobi=False), None),
                       (dict(grid_size=(128, 128, 64), pallas_jacobi=True), None),
                       (dict(grid_size=(128, 128, 1), pallas_jacobi=True), None),
                       (dict(grid_size=(384, 384, 32), has_light_probe=True), None),
                       (dict(grid_size=(256, 256, 32), has_light_probe=True,
                             mg_project_fused=True), None),
                       (dict(grid_size=(128, 128, 20), has_light_probe=True,
                             viewport=(256, 256)), None),
                       (dict(grid_size=(150, 150, 72), has_light_probe=True), None),
                       (golden, direct),
                       (dict(grid_size=(32, 32, 32)), RenderMethod.RAY_MARCH_DIRECT_SEPARATE),
                       (dict(grid_size=(32, 32, 32), point_light=True), None),
                       (dict(faithful, grid_size=(32, 32, 32)), None),
                       (dict(faithful, grid_size=(32, 32, 32), has_light_probe=True),
                        RenderMethod.RAY_MARCH_DIRECT_MERGED)):
        cfg = FluidConfig(**dict(dict(viewport=(96, 96)), **kw))
        engines = [FluidXEngine(cfg, radiance=radiance, device=d) for d in ("cpu", dev)]
        for e in engines:
            e.render_method = method if method is not None else e.render_method
        if method is not None:
            kw = dict(kw, method=method.name)
        reset_launch_counts()
        images = []
        for e in engines:
            for _ in range(3):
                img = e.step_frame()
            images.append(to_srgb_u8(img).astype(np.int32))
        fa, fb = (e.state.fields.float().cpu() for e in engines)
        field_err = float((fa - fb).abs().max())
        ulps = bf16_ulps(fa, fb)
        img_err = int(np.abs(images[0] - images[1]).max())
        print(f"{kw}: fields max abs diff {field_err:.3e} ({ulps:.2f} bf16 ulp at each "
              f"channel's scale), image max u8 diff {img_err} (limits 1 ulp and 2: only "
              f"exp/log1p/log differ between the CPU and CUDA math libraries)")
        check(ulps <= 1.0 and img_err <= 2, f"CUDA vs CPU port, {kw}")
        counts = launch_counts()
        if cfg.grid_size == (384, 384, 32):
            check(counts["jacobi_rr"] == counts["jacobi_planewise"] == counts["gi_light"] == 3,
                  f"B13, plane-sweep B4 and B16 ran on {kw}: {counts}")
        if cfg.mg_project_fused:
            check(counts["jacobi_divrr"] == counts["jacobi_grad"] == counts["gradient3"]
                  == counts["gi_light"] == 3 and counts["jacobi_rr"] == 0,
                  f"B18, B15 and B16 ran on {kw}: {counts}")
        if cfg.grid_size in ((128, 128, 20), (150, 150, 72)):
            _, lod, vis_mask = engines[1].update_frame()
            b17, b10 = march_routes(cfg, vis_mask, lod)
            proj = padded_projection_counts(cfg)
            want = {k: 3 * v for k, v in {**proj, **light_map_counts(cfg)}.items()}
            want.update(composite=0, composite_resample=3 * b10)
            check(b17 == 0 and {k: counts[k] for k in want} == want,
                  f"the padded route ran on {kw}: {counts}, expected {want}")
        if not cfg.fast_render:
            separate = method is None or method.separate_light_pass
            check(counts["view_march"] == 3 and counts["light_march"] == 3 * separate
                  and counts["advect_xy"] == counts["shear_scan"] == 0,
                  f"the faithful stack ran R1 and R2 on {kw}: {counts}")
        elif method is not None:
            b17 = cfg.grid_size == golden["grid_size"]
            check(counts["composite"] == (3 if b17 else 0)
                  and counts["composite_resample"] == (0 if b17 else 3),
                  f"the DIRECT plane took {'B17' if b17 else 'B10'} on {kw}: {counts}")
            if b17:
                b17_counts = counts
        if cfg.point_light:
            check(counts["shear_scan"] == 0 and counts["composite_resample"] > 0,
                  f"the point light ran the projective sweep, no B9, on {kw}: {counts}")
    return b17_counts


def main() -> int:
    name, smi_line = phase0_device()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase1_build()
    results = phase2_kernels(dev)
    phase2b_kernels_2d(dev, results)
    phase2c_kernels_256(dev, results)
    phase2d_kernels_fused_slab(dev, results)
    check_advect_frames(dev, results)
    phase2f_direct_plane(dev, results)
    phase2g_b17_plane_512(dev, results)
    warm, warm_gi = phase2h_faithful_kernels(dev, results)
    counts = phase3_main_path(dev, smi_line)
    counts_2d = phase3b_fluid2d(dev, smi_line)
    counts_gi, engine_256 = phase3c_256(dev, smi_line)
    counts_fused, counts_slab = phase3d_fused_and_slab(dev, smi_line, engine_256)
    del engine_256
    counts_fluidgi = phase3e_fluidgi(dev, smi_line)
    counts_direct = phase3f_direct_and_point(dev, smi_line)
    phase3g_replay_vs_eager(dev, smi_line)
    counts_faithful = phase3h_faithful_frames(dev, smi_line, warm, warm_gi, results)
    counts_adjoint = phase3j_adjoint(dev, smi_line, warm, results)
    del warm, warm_gi
    torch.cuda.empty_cache()
    phase3i_shell(dev, smi_line, counts, counts_2d, counts_fluidgi,
                  counts_direct["RAY_MARCH_DIRECT_MERGED"])
    torch.cuda.empty_cache()
    phase3k_twins_ensemble_sharded(dev, smi_line, counts)
    torch.cuda.empty_cache()
    counts_direct24 = phase4_cpu_vs_cuda(dev)
    kernels = []
    # B4's plane-sweep order is B4's wrapper and source; its launches are
    # those of the 256^3 GI frame.
    rows = dict(KERNELS, jacobi_planewise=("B4", _JAC, "fluidx12_tpu/ops/pallas/jacobi.py:461"))
    for kname, (_, src, replaces) in rows.items():
        r = results[kname]
        # B17's path is the DIRECT plane of the 24^3 golden case (phase 4).
        path = (counts_2d if kname in KERNELS_2D
                else counts_gi if kname in KERNELS_256 + ("jacobi_planewise",)
                else counts_fused if kname in KERNELS_FUSED
                else counts_direct24 if kname == "composite"
                else counts_faithful if kname in KERNELS_FAITHFUL
                else counts_adjoint if kname in KERNELS_ADJOINT
                else counts_slab if kname in KERNELS_SLAB else counts)
        launches = path[kname]
        # B12 is on no path of the port (ROADMAP.md, queue B).
        check(launches > 0 or kname == "advect_z", f"{kname} launched on its path")
        kernels.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    check(all(math.isfinite(k["ms"]) for k in kernels), "kernel times")
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
