"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from fluidx12_tpu_torch/csrc (one nvcc per
source, in parallel), checks each against its plain PyTorch version on the
card at its path's shapes (the 128^3 frame's; B11 and B14 at the 2D
preset's 512^2; B13, B4's plane-sweep order, B16 and the fused projection
B18 at 256^3; B15 and B17 at the 256x256x60 GI frame's) and times both,
drives `FluidXEngine` for 60 frames of the main path (PRESETS["fluid3d"]
as it is: 128^3 grid, 800x800 viewport, the projection on kernels B3-B8),
20 frames of the pallas_jacobi=False path, 60 frames of PRESETS["fluid2d"]
(512x512x1 grid, 800x800 viewport, B11 and B14), 30 frames of the 256^3 GI
frame (bench.py's "FluidGI SH irradiance 256^3": the in-repo light probe,
B13 and B16), 20 of 256^3 without the probe, 20 of 256^3 with the fused
projection (mg_project_fused=True: B18) and 20 of the 256x256x60 GI frame
(the in-repo probe: B15 and B17), counting the kernel launches of each,
times the projection of the 128^3 paths and of the fused and unfused 256^3
ones, and compares the port on CUDA with the port on the CPU at six small
grids, one of them 2D and three with the probe.  Every phase prints its
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
WARMUP_FRAMES = 10
GRID_256 = (256, 256, 256)
# The 256x256x60 GI frame: a wide, shallow smoke layer.
GRID_SLAB = (256, 256, 60)
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
# B15 and B17, on the 256x256x60 GI frame only.
KERNELS_SLAB = ("gradient3", "composite")
# Each path's own kernels: launched on no other path of phase 3.
OWN = KERNELS_2D + KERNELS_256 + KERNELS_FUSED + KERNELS_SLAB


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


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| per channel (leading axis) in bf16 ulps at that
    channel's largest magnitude: one extra rounding of data at that scale."""
    a, b = a.float(), b.float()
    dims = tuple(range(1, a.ndim))
    mag = torch.maximum(a.abs().amax(dim=dims, keepdim=True),
                        b.abs().amax(dim=dims, keepdim=True)).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7.0)
    return float(((a - b).abs() / ulp).max())


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
            library=None, calls=1):
    """Times `kernel` and its plain version (and the library call, if any)
    and stores them with the error and the bound under `name`.  Where
    `kernel` and `plain` each make `calls` launches (n_bytes and flops are
    those of one), the times are per launch."""
    bound_ms, bound_by = bound(n_bytes, flops)
    results[name] = dict(
        max_abs_err=err, ms=time_ms(kernel, reps, what=name) / calls,
        plain_ms=time_ms(plain, plain_reps) / calls,
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None if library is None else time_ms(library, reps))


def print_times(results, names) -> None:
    for name in names:
        r = results[name]
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        kid = KERNELS[name][0] if name in KERNELS else "B4"
        print(f"  {kid} {name}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {lib}, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")


def phase2_kernels(dev):
    """Each kernel of the 3D paths against its plain version on the card,
    at 128^3 shapes (B6 at the 64^3 coarse level), with times and bounds."""
    phase("phase 2: kernels vs plain versions at 128^3")
    from fluidx12_tpu_torch.core.config import PRESETS
    from fluidx12_tpu_torch.core import math3d as m3
    from fluidx12_tpu_torch.core.camera import OrbitCamera
    from fluidx12_tpu_torch.ops.cuda import advect as A
    from fluidx12_tpu_torch.ops.cuda import composite as C
    from fluidx12_tpu_torch.ops.cuda import jacobi as J
    from fluidx12_tpu_torch.ops.cuda import stencil as ST
    from fluidx12_tpu_torch.ops.cuda import sweep as S
    from fluidx12_tpu_torch.render import lightmap_sweep as L
    from fluidx12_tpu_torch.render import slicecomp as SC
    from fluidx12_tpu_torch.render.raymarch_core import MAX_DIST

    cfg = PRESETS["fluid3d"]
    z, y, x = cfg.zyx
    n = z * y * x
    rng = np.random.default_rng(0)
    results = {}
    record = functools.partial(measure, results)

    # B1 / B2: a bf16 state with velocities up to +-1.5 (|d| <= 3 voxels)
    # and a faster patch (|d| up to the 12-voxel clip).
    f = rng.uniform(0.0, 1.0, (7, z, y, x)).astype(np.float32)
    f[:3] = (f[:3] - 0.5) * 3.0
    f[:3, 40:60, 40:60, 40:60] *= 8.0
    vol = torch.from_numpy(f).to(dev, torch.bfloat16)
    dt = torch.tensor(cfg.time_step, dtype=torch.float32, device=dev)
    scales = torch.stack([dt * x, dt * y])
    got = A.advect_xy(vol, scales)
    ref = A.advect_xy_plain(vol, scales)
    err = float((got - ref).abs().max())
    print(f"B1 advect_xy: max abs diff {err:.3e} (limit 1e-5: same f32 operations)")
    check(err <= 1e-5, "B1 advect_xy vs plain")
    # Per cell: two displacements and 7 channels x 2 two-tap lerps.
    record("advect_xy", err, lambda: A.advect_xy(vol, scales),
           lambda: A.advect_xy_plain(vol, scales), nbytes(vol, scales, got), 66 * n)

    table = torch.from_numpy(A.forces_table(cfg)).to(dev)
    consts = A.force_consts(cfg)
    scal = torch.stack([dt * z, dt])
    xy = got
    got = A.advect_z_forces(xy, scal, table, consts)
    ref = A.advect_z_forces_plain(xy, scal, table, consts)
    err = float((got.float() - ref.float()).abs().max())
    ulps = bf16_ulps(got, ref)
    print(f"B2 advect_z_forces: max abs diff {err:.3e}, {ulps:.2f} bf16 ulp at each "
          f"channel's scale (limit 1 ulp: expf may differ in its last f32 bit)")
    check(ulps <= 1.0, "B2 advect_z_forces vs plain")
    record("advect_z_forces", err, lambda: A.advect_z_forces(xy, scal, table, consts),
           lambda: A.advect_z_forces_plain(xy, scal, table, consts),
           nbytes(xy, scal, table, got), 110 * n)

    # B12: the same z pass without its forces epilogue.
    got = A.advect_z(xy, scal)
    ref = A.advect_z_forces_plain(xy, scal, None, None, forces=False)
    err = float((got.float() - ref.float()).abs().max())
    ulps = bf16_ulps(got, ref)
    print(f"B12 advect_z: max abs diff {err:.3e}, {ulps:.2f} bf16 ulp at each channel's "
          f"scale (limit 1 ulp, as B2)")
    check(ulps <= 1.0, "B12 advect_z vs plain")
    record("advect_z", err, lambda: A.advect_z(xy, scal),
           lambda: A.advect_z_forces_plain(xy, scal, None, None, forces=False),
           nbytes(xy, scal, got), 33 * n)

    # B3-B8 on the projection's operands: the advected bf16 state, a smooth
    # f32 pressure and its right-hand side, the 64^3 coarse level.
    fields = A.advect_z_forces(xy, scal, table, consts)
    q = torch.from_numpy(rng.uniform(-0.05, 0.05, (z, y, x)).astype(np.float32)).to(dev)
    for ax in range(3):
        q = (q.roll(1, ax) + q + q.roll(-1, ax)) / 3.0
    b = ST.divergence(fields)
    ref = ST.divergence_plain(fields)
    err = float((b - ref).abs().max())
    print(f"B3 divergence: max abs diff {err:.3e} (limit 0: same f32 operations)")
    check(err == 0.0, "B3 divergence vs plain")
    record("divergence", err, lambda: ST.divergence(fields),
           lambda: ST.divergence_plain(fields), nbytes(fields[:3], b), 6 * n)

    tuning = J.jacobi_tuning(cfg.zyx, 4)
    got = J.jacobi(q, b, 4, *tuning)
    ref = J.jacobi_plain(q, b, 4, *tuning)
    err = float((got - ref).abs().max())
    lim = 1e-5 * float(ref.abs().max())
    print(f"B4 jacobi (4 sweeps, TPU plan {tuning}): max abs diff {err:.3e} "
          f"(limit {lim:.2e}: 1e-5 of the scale)")
    check(err <= lim, "B4 jacobi vs plain")
    record("jacobi", err, lambda: J.jacobi(q, b, 4, *tuning),
           lambda: J.jacobi_plain(q, b, 4, *tuning), nbytes(q, b, got), 7 * 4 * n)

    r = ST.residual(q, b)
    ref = ST.residual_plain(q, b)
    err = float((r - ref).abs().max())
    print(f"B5 residual: max abs diff {err:.3e} (limit 0: same f32 operations)")
    check(err == 0.0, "B5 residual vs plain")
    record("residual", err, lambda: ST.residual(q, b), lambda: ST.residual_plain(q, b),
           nbytes(q, b, r), 8 * n)

    r_c = torch.from_numpy(rng.uniform(-0.1, 0.1, (z // 2, y // 2, x // 2))
                           .astype(np.float32)).to(dev)
    zero_c = torch.zeros_like(r_c)
    check(J.jacobi_packed_supported(r_c.shape), "the TPU packs the 64^3 coarse level")
    e_c = J.jacobi_packed(zero_c, r_c, 32)
    ref = J.jacobi_packed_plain(zero_c, r_c, 32)
    err = float((e_c - ref).abs().max())
    lim = 1e-5 * float(ref.abs().max())
    print(f"B6 jacobi_packed (32 sweeps at 64^3): max abs diff {err:.3e} "
          f"(limit {lim:.2e}: 1e-5 of the scale)")
    check(err <= lim, "B6 jacobi_packed vs plain")
    record("jacobi_packed", err, lambda: J.jacobi_packed(zero_c, r_c, 32),
           lambda: J.jacobi_packed_plain(zero_c, r_c, 32), nbytes(zero_c, r_c, e_c),
           7 * 32 * r_c.numel())

    got = ST.prolong_correct(q, e_c)
    ref = ST.prolong_correct_plain(q, e_c)
    err = float((got - ref).abs().max())
    print(f"B7 prolong_correct: max abs diff {err:.3e} (limit 0: same f32 operations)")
    check(err == 0.0, "B7 prolong_correct vs plain")

    def interpolate_add():
        up = torch.nn.functional.interpolate(e_c[None, None], scale_factor=2,
                                             mode="trilinear", align_corners=False)
        return q + up[0, 0]

    lib_err = float((interpolate_add() - ref).abs().max())
    print(f"  library yardstick q + F.interpolate(trilinear): max abs diff {lib_err:.3e}")
    # Per fine cell: up to two upsampled planes (9 operations each), the z
    # lerp and the add.
    record("prolong_correct", err, lambda: ST.prolong_correct(q, e_c),
           lambda: ST.prolong_correct_plain(q, e_c), nbytes(q, e_c, got), 22 * n,
           library=interpolate_add)

    # B8 with a pressure of spread 1, so that its gradient term is many
    # bf16 ulps of the velocity, held per value: within one bf16 ulp of each
    # plain result.
    rho = cfg.fluid_density_3d
    p = torch.from_numpy(rng.uniform(-1.0, 1.0, (z, y, x)).astype(np.float32)).to(dev)
    work = fields.clone()
    got = ST.grad_damp(fields.clone(), p, rho)
    ref = ST.grad_damp_plain(fields.clone(), p, rho)
    check(torch.equal(got[3:], fields[3:]), "B8 leaves channels 3.. untouched")
    diff = (got[:3].float() - ref[:3].float()).abs()
    err = float(diff.max())
    ulp = (ref[:3].float().abs() * 2.0 ** -7).clamp_min(2.0 ** -126)
    grad = torch.stack([ST._diff(p, ax) * ST.grad_scale(rho)
                        for ax in (ST._AX_X, ST._AX_Y, ST._AX_Z)]).abs()
    print(f"B8 grad_damp: max abs diff {err:.3e}, {float((diff / ulp).max()):.2f} bf16 ulp "
          f"of each value (limit 1 ulp per value); gradient term |(p+ - p-)*0.5/rho| "
          f"max {float(grad.max()):.3f}, median {float(grad.median()):.3f} against a "
          f"median limit of {float(ulp.median()):.2e}; channels 3.. untouched")
    check(bool((diff <= ulp).all()), "B8 grad_damp vs plain, per value")
    record("grad_damp", err, lambda: ST.grad_damp(work, p, rho),
           lambda: ST.grad_damp_plain(work, p, rho),
           2 * nbytes(fields[:3]) + nbytes(p), 39 * n)

    # B9: the light sweep's own arguments for a smooth 128^3 density.
    dens = torch.from_numpy(rng.uniform(0.0, 0.6, (z, y, x)).astype(np.float32)).to(dev)
    for ax in range(3):
        dens = (dens.roll(1, ax) + dens + dens.roll(-1, ax)) / 3.0
    world_i = torch.from_numpy(m3.inverse(m3.scaling(cfg.volume_scale))).to(dev)
    light = torch.tensor(cfg.light_pos, dtype=torch.float32, device=dev) @ world_i[:3, :3]
    light_dir = light / torch.linalg.vector_norm(light)
    major = int(np.argmax(np.abs(cfg.light_pos)))
    pool, _ = L._pool_mats(x, x, 1, cfg.light_pos[major] > 0, dev)
    dens_o = SC.mxu_einsum("zyx,xm->mzy", dens, pool)
    ref_step = MAX_DIST / torch.tensor(float(cfg.max_light_samples), device=dev)
    log_att, s = L.scan_args(dens_o, light_dir, major, (x, y, z), 1, ref_step,
                             cfg.absorption)
    got = S.shear_scan(log_att, s)
    ref = S.shear_scan_plain(log_att, s)
    err = float((got - ref).abs().max())
    lim = 1e-4 * max(1.0, float(ref.abs().max()))
    print(f"B9 shear_scan: max abs diff {err:.3e} (limit {lim:.2e}: same f32 sum order)")
    check(err <= lim, "B9 shear_scan vs plain")
    # Per output: four taps into the sheared carry and four out of it.
    record("shear_scan", err, lambda: S.shear_scan(log_att, s),
           lambda: S.shear_scan_plain(log_att, s), nbytes(log_att, s, got),
           40 * log_att.numel(), plain_reps=3)

    # B10: the +X face of the default camera's view of a lit volume.
    cam = OrbitCamera(width=cfg.viewport[0], height=cfg.viewport[1])
    eye = torch.from_numpy(np.append(cam.eye, 1.0).astype(np.float32)).to(dev)
    local_eye = (eye @ world_i)[:3]
    grid = torch.cat([dens[None].expand(3, -1, -1, -1) * 0.5, dens[None]])
    volf = SC._axis_volume(torch.cat([grid[3:4], grid[:3]]), 0, cfg)
    volf = volf.to(torch.bfloat16).contiguous()
    h_rows, h_cols, valid, n_steps, _ = SC.face_geometry(
        0, volf.shape[1], local_eye, torch.tensor(cfg.max_ray_samples, device=dev),
        cfg, torch.float32)
    args = (volf, h_rows, h_cols, valid, n_steps, cfg.absorption, False)
    got = C.composite_resample(*args)
    ref = C.composite_resample_plain(*args)
    err = float((got - ref).abs().max())
    print(f"B10 composite_resample: max abs diff {err:.3e} (limit 2e-3, the JAX "
          f"package's kernel-vs-twin tolerance)")
    check(err <= 2e-3, "B10 composite_resample vs plain")
    # Per slice and face texel: 4 channels x 2 two-tap lerps, then the
    # front-to-back step.
    record("composite_resample", err, lambda: C.composite_resample(*args),
           lambda: C.composite_resample_plain(*args),
           nbytes(volf, h_rows, h_cols, valid, n_steps, got),
           40 * volf.shape[1] * n_steps.numel(), plain_reps=3)
    print_times(results, results)
    return results


def phase2b_kernels_2d(dev, results):
    """B11 and B14 against their plain versions on the card at the 2D
    preset's shapes, (7, 1, 512, 512) bf16 and a 512^2 plane, with times
    and bounds; B11 also on every axis of a 128^3 volume (the z stride)."""
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
    tx = A.advect_axis(vol, sx, 2, 0)
    ty = A.advect_axis(tx, sy, 1, 1)
    err_x = float((tx.float() - A.advect_axis_plain(vol, sx, 2, 0).float()).abs().max())
    err_y = float((ty.float() - A.advect_axis_plain(tx, sy, 1, 1).float()).abs().max())
    print(f"B11 advect_axis at {tuple(vol.shape)} bf16: x pass max abs diff {err_x:.3e}, "
          f"y pass {err_y:.3e} (limit 0: same f32 operations, one rounding)")
    check(err_x == 0.0 and err_y == 0.0, "B11 advect_axis vs plain at 512^2")
    v3 = torch.from_numpy(rng.uniform(-1.5, 1.5, (7, 128, 128, 128)).astype(np.float32)
                          ).to(dev, torch.bfloat16)
    s3 = torch.tensor(4.0, device=dev)   # displacements up to 6 voxels
    err_3d = 0.0
    for axis, ch in ((2, 0), (1, 1), (0, 2)):
        diff = A.advect_axis(v3, s3, axis, ch).float() - A.advect_axis_plain(v3, s3, axis, ch)
        err_3d = max(err_3d, float(diff.abs().max()))
    print(f"B11 advect_axis on each axis of (7, 128, 128, 128) bf16: max abs diff "
          f"{err_3d:.3e} (limit 0)")
    check(err_3d == 0.0, "B11 advect_axis vs plain at 128^3")

    def both_passes(fn):
        return lambda: fn(fn(vol, sx, 2, 0), sy, 1, 1)

    # Per cell and pass: the displacement and its clamps, the two weights,
    # 7 channels x a two-tap lerp.
    record("advect_axis", max(err_x, err_y, err_3d), both_passes(A.advect_axis),
           both_passes(A.advect_axis_plain), nbytes(vol, sx, tx), 33 * n, calls=2)

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
    print(f"B14 jacobi2d ({iters} sweeps at {y}x{x}): max abs diff {err:.3e} (limit 0: "
          f"same sum order, exact division by 4)")
    check(err == 0.0, "B14 jacobi2d vs plain")
    # Per cell and sweep: three adds, a subtract and a division.  Each call
    # makes `iters` launches: few calls, so that the host queues them all
    # before the sleep kernel ends.
    record("jacobi2d", err, lambda: J.jacobi2d(q, b, iters),
           lambda: J.jacobi2d_plain(q, b, iters), nbytes(q, b, got), 5 * iters * n,
           reps=5, plain_reps=3)
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
           reps=10, plain_reps=3)

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
           7 * MG_POST * n, reps=10, plain_reps=3)

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


def slab_face_stack(dev, face: int = 0):
    """B17's operands on the 256x256x60 GI frame's path: the resampled
    (128, 256, 256) stack of cube face `face` (X+ by default) of a smooth
    smoke volume as the default camera sees it, at lod 0."""
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
    check(SC._takes_b17(*volf.shape[1:], h_rows.shape[1], cfg), "the face takes B17")
    dens_m, prod = SC.resampled_stack(volf, h_rows, h_cols, valid)
    return cfg, dens_m, prod, n_steps


def phase2d_kernels_fused_slab(dev, results):
    """B18's two halves at 256^3, and B15 and B17 at the 256x256x60 GI
    frame's shapes ((30, 128, 128), the AO's half field; a 128x256x256
    face stack), against their plain versions on the card, with times and
    bounds."""
    phase("phase 2d: B18 at 256^3, B15 and B17 at the 256x256x60 frame's shapes")
    from fluidx12_tpu_torch.ops.cuda import composite as C
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
           (6 + 7 * MG_PRE + 8 + 1) * n + 6 * got[2].numel(), reps=10, plain_reps=3)

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
           reps=10, plain_reps=3)

    # B15 on the AO's half field of the 256x256x60 frame.
    half = tuple(k // 2 for k in GRID_SLAB[::-1])
    check(ST.stencil_pallas_supported(half), "the TPU runs B15 on the half field")
    dens = smooth(half, 0.0, 0.6)
    got = ST.gradient3(dens)
    ref = ST.gradient3_plain(dens)
    err = float((got - ref).abs().max())

    def library():
        return torch.gradient(dens, dim=(0, 1, 2))

    lib_err = float((torch.stack(library()[::-1]) - ref).abs().max())
    print(f"B15 gradient3 at {half}: max abs diff {err:.3e} (limit 0: one difference and "
          f"one exact scale); library torch.gradient max abs diff {lib_err:.3e}")
    check(err == 0.0, "B15 gradient3 vs plain")
    # Per cell and axis: a difference and a scale.
    record("gradient3", err, lambda: ST.gradient3(dens), lambda: ST.gradient3_plain(dens),
           nbytes(dens, got), 6 * dens.numel(), library=library)

    # B17 on the X+ face's stack of the 256x256x60 frame, both directions.
    _, dens_m, prod, n_steps = slab_face_stack(dev)
    err = 0.0
    for flip in (False, True):
        got = C.composite(dens_m, prod, n_steps, 0.8, flip)
        ref = C.composite_plain(dens_m, prod, n_steps, 0.8, flip)
        scale = float(ref.abs().max())
        e = float((got - ref).abs().max())
        print(f"B17 composite on a {tuple(dens_m.shape)} stack, flip={flip}: max abs diff "
              f"{e:.3e} (limit {2e-6 * scale:.2e}: 2e-6 of the scale, expf and log1pf)")
        check(e <= 2e-6 * scale, f"B17 composite vs plain, flip={flip}")
        err = max(err, e)
    # Per stack element: the clips, the alpha (two transcendentals), the
    # weight, its rate and four accumulations.
    record("composite", err, lambda: C.composite(dens_m, prod, n_steps, 0.8, False),
           lambda: C.composite_plain(dens_m, prod, n_steps, 0.8, False),
           nbytes(dens_m, prod, n_steps, got), 20 * dens_m.numel(), plain_reps=3)
    print_times(results, KERNELS_FUSED + KERNELS_SLAB)


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


def run_frames(cfg, frames: int, dev, smi_line, label: str, radiance=None):
    """`frames` frames of FluidXEngine(cfg, radiance) with the launch counts
    set to 0 just before; returns (counts, visible faces, engine)."""
    from fluidx12_tpu_torch.core.state import unpack_scene_params
    from fluidx12_tpu_torch.engine.fluidx import FluidXEngine
    from fluidx12_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    engine = FluidXEngine(cfg, radiance=radiance, device=dev)
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
    steady = times[WARMUP_FRAMES:]
    med = statistics.median(steady)
    print(f"{label}: median ms/frame (frames {WARMUP_FRAMES + 1}-{frames}, host clock "
          f"around a synchronized step): {med:.3f} ms = {1e3 / med:.2f} steps/s; "
          f"min {min(steady):.3f}, max {max(steady):.3f}; first frame {times[0]:.1f} ms "
          f"[{smi_line}]")
    return counts, faces, engine


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

    counts, _, _ = run_frames(PRESETS["fluid2d"], FRAMES_2D, dev, smi_line, "fluid2d")
    expect = {name: 0 for name in KERNELS}
    expect.update(advect_axis=2 * FRAMES_2D, jacobi2d=FRAMES_2D, jacobi_planewise=0)
    check(counts == expect, f"launch counts {counts} != {expect}")
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
                         + KERNELS_2D + KERNELS_FUSED + KERNELS_SLAB})
        check(counts == expect, f"launch counts {counts} != {expect}")
        out[probe] = counts, engine
    return out[True][0], out[False][1]


def march_routes(cfg, vis_mask: int, lod: int):
    """(faces taking B17, faces taking B10) among the visible faces, by the
    port's copies of the JAX march gates (render/slicecomp._takes_b17)."""
    from fluidx12_tpu_torch.render import slicecomp as SC

    r = max(cfg.cube_map_size >> lod, 1)
    lateral = {0: (cfg.grid_size[2], cfg.grid_size[1]), 1: (cfg.grid_size[2], cfg.grid_size[0]),
               2: (cfg.grid_size[1], cfg.grid_size[0])}
    b17 = 0
    faces = [f for f in range(6) if (vis_mask >> f) & 1]
    for f in faces:
        axis = SC._FACES[f][0]
        n_m = cfg.grid_size[axis]
        n_s = n_m // max(-(-n_m // max(cfg.max_ray_samples >> lod, 1)), 1)
        b17 += SC._takes_b17(n_s, *lateral[axis], r, cfg)
    return b17, len(faces) - b17


def phase3d_fused_and_slab(dev, smi_line, engine_256):
    """FRAMES_FUSED frames of 256^3 with the fused projection
    (FluidConfig(grid_size=(256, 256, 256), mg_project_fused=True), 800x800
    viewport, no probe) and FRAMES_SLAB frames of the 256x256x60 GI frame
    (the in-repo probe), with their launch counts derived from the copied
    JAX gates; then the projection span of the fused 256^3 frame beside the
    unfused one of phase 3c (`engine_256`), in turns."""
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

    # Path B: the fine projection runs the twins (no plan for 4 sweeps at
    # nz = 60, no stencil gate), the 30x128x128 coarse level the
    # whole-window B4; the GI normals' gradient the twin, the AO's half
    # field B15; the faces B17 or B10 by the march gates.
    cfg = FluidConfig(grid_size=GRID_SLAB, has_light_probe=True)
    zyx = cfg.zyx
    coarse = half = tuple(n // 2 for n in zyx)
    check(not ST.stencil_pallas_supported(zyx) and J.jacobi_tuning(zyx, mg.MG_PRE) is None
          and not J.jacobi_rr_supported(zyx, mg.MG_PRE), "the fine level runs the twins")
    check(J.jacobi_tuning(coarse, mg.MG_COARSE_ITERS) is not None, "the coarse level takes B4")
    check(L._ao_levels(zyx) == 1 and ST.stencil_pallas_supported(half),
          "the AO's half field takes B15")
    frames = FRAMES_SLAB
    counts_b, faces, engine_b = run_frames(cfg, frames, dev, smi_line, "256x256x60 GI",
                                           radiance=np.load(PROBE)["radiance"])
    _, lod, vis_mask = engine_b.update_frame()
    b17, b10 = march_routes(cfg, vis_mask, lod)
    check((vis_mask, lod, b17, b10) == (0b11011, 0, 3, 1),
          f"the default camera: X+, X-, Y- take B17 and Z+ B10 ({vis_mask:#b}, lod {lod}, "
          f"{b17}, {b10})")
    expect = {name: 0 for name in KERNELS}
    expect.update(advect_xy=frames, advect_z_forces=frames, jacobi=frames, jacobi_planewise=0,
                  shear_scan=frames, gradient3=frames, composite=frames * b17,
                  composite_resample=frames * b10)
    check(counts_b == expect, f"launch counts {counts_b} != {expect}")

    spans = {}
    for label, engine in (("unfused", engine_256), ("fused", engine_a), ("fused", engine_a),
                          ("unfused", engine_256)):
        spans.setdefault(label, []).append(projection_span_ms(engine))
    for label, ms in spans.items():
        print(f"256^3 {label} projection span: {ms[0]:.3f}, {ms[1]:.3f} ms/call (CUDA events, "
              f"20 calls each, in turns) [{smi_line}]")
    return counts_a, counts_b


def phase4_cpu_vs_cuda(dev):
    """The port on CUDA against the port on the CPU, 3 frames at six small
    grids: the pallas_jacobi=False path at (128, 128, 16), the default
    projection kernels at (128, 128, 64), the 2D path with B11 and B14 at
    (128, 128, 1), and with the probe at (384, 384, 32), where the TPU runs
    B13, B4's plane-sweep order and B16 (and the AO at half resolution, 192
    lanes, no B15); at (256, 256, 32) with the fused projection, where it
    runs B18, B16 and B15 (the AO's (16, 128, 128) half field); and at
    (128, 128, 20), where it runs B15 on the full-resolution GI normals and
    B17 on the X and Y faces.  That grid takes a 256x256 viewport: at 96^2
    the cube map drops to lod 1, whose face stacks are below the size at
    which the TPU composites in a kernel."""
    phase("phase 4: port on CUDA vs port on CPU, 3 frames each")
    from fluidx12_tpu_torch.core.config import FluidConfig
    from fluidx12_tpu_torch.engine.fluidx import FluidXEngine
    from fluidx12_tpu_torch.utils.image import to_srgb_u8

    from fluidx12_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    radiance = np.load(PROBE)["radiance"]
    for kw in (dict(grid_size=(128, 128, 16), pallas_jacobi=False),
               dict(grid_size=(128, 128, 64), pallas_jacobi=True),
               dict(grid_size=(128, 128, 1), pallas_jacobi=True),
               dict(grid_size=(384, 384, 32), has_light_probe=True),
               dict(grid_size=(256, 256, 32), has_light_probe=True, mg_project_fused=True),
               dict(grid_size=(128, 128, 20), has_light_probe=True, viewport=(256, 256))):
        cfg = FluidConfig(**dict(dict(viewport=(96, 96)), **kw))
        engines = [FluidXEngine(cfg, radiance=radiance, device=d) for d in ("cpu", dev)]
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
        if cfg.grid_size == (128, 128, 20):
            _, lod, vis_mask = engines[1].update_frame()
            b17, b10 = march_routes(cfg, vis_mask, lod)
            check(b17 == 3 and counts["gradient3"] == 3 and counts["gi_light"] == 0
                  and counts["composite"] == 3 * b17 and counts["composite_resample"] == 3 * b10,
                  f"B15 and B17 ran on {kw}: {counts}")


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
    counts = phase3_main_path(dev, smi_line)
    counts_2d = phase3b_fluid2d(dev, smi_line)
    counts_gi, engine_256 = phase3c_256(dev, smi_line)
    counts_fused, counts_slab = phase3d_fused_and_slab(dev, smi_line, engine_256)
    del engine_256
    phase4_cpu_vs_cuda(dev)
    kernels = []
    # B4's plane-sweep order is B4's wrapper and source; its launches are
    # those of the 256^3 GI frame.
    rows = dict(KERNELS, jacobi_planewise=("B4", _JAC, "fluidx12_tpu/ops/pallas/jacobi.py:461"))
    for kname, (_, src, replaces) in rows.items():
        r = results[kname]
        path = (counts_2d if kname in KERNELS_2D
                else counts_gi if kname in KERNELS_256 + ("jacobi_planewise",)
                else counts_fused if kname in KERNELS_FUSED
                else counts_slab if kname in KERNELS_SLAB else counts)
        launches = path[kname]
        # B12 is on no path of the port yet (ROADMAP.md, queue B).
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
