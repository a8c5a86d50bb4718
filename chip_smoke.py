"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from fluidx12_tpu_torch/csrc (one nvcc per
source, in parallel), checks each against its plain PyTorch version on the
card at its path's shapes (the 128^3 frame's; B11 and B14 at the 2D
preset's 512^2; B13, B4's plane-sweep order and B16 at 256^3) and times
both, drives `FluidXEngine` for 60 frames of the main path
(PRESETS["fluid3d"] as it is: 128^3 grid, 800x800 viewport, the projection
on kernels B3-B8), 20 frames of the pallas_jacobi=False path, 60 frames of
PRESETS["fluid2d"] (512x512x1 grid, 800x800 viewport, B11 and B14), 30
frames of the 256^3 GI frame (bench.py's "FluidGI SH irradiance 256^3":
the in-repo light probe, B13 and B16) and 20 of 256^3 without the probe,
counting the kernel launches of each, times the projection of the 128^3
paths, and compares the port on CUDA with the port on the CPU at four
small grids, one of them 2D and one with the probe.  Every phase prints
its lines; any failure raises, so the exit code is non-zero and the final
JSON line is not printed.  The last line is {"ok": true, "device": {...}};
the line before it lists each kernel's launches (on its path), error,
time, plain and library times, and bound.
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
WARMUP_FRAMES = 10
GRID_256 = (256, 256, 256)
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
}
# The projection's kernels: launched on the default preset's path only.
PROJECTION = ("divergence", "jacobi", "residual", "jacobi_packed", "prolong_correct",
              "grad_damp")
# The 2D preset's kernels, launched on its path only.
KERNELS_2D = ("advect_axis", "jacobi2d")
# The 256^3 path's own kernels (B16 with the probe only).
KERNELS_256 = ("jacobi_rr", "gi_light")


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
                  jacobi_planewise=0, **{name: 0 for name in KERNELS_2D + KERNELS_256})
    check(counts == expect, f"launch counts {counts} != {expect}")
    span = projection_span_ms(engine)
    print(f"fluid3d: projection span {span:.3f} ms/call (CUDA events, 20 calls) "
          f"[{smi_line}]")

    slice_cfg = dataclasses.replace(cfg, pallas_jacobi=False)
    slice_counts, faces, engine = run_frames(slice_cfg, SLICE_FRAMES, dev, smi_line,
                                             "pallas_jacobi=False")
    expect = {name: SLICE_FRAMES for name in KERNELS}
    expect.update(composite_resample=SLICE_FRAMES * faces, advect_z=0, jacobi_planewise=0,
                  **{name: 0 for name in PROJECTION + KERNELS_2D + KERNELS_256})
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
    once with the probe; B5, B6, B11, B12 and B14 never."""
    phase(f"phase 3c: {FRAMES_GI} frames of the 256^3 GI frame, {FRAMES_256} without the "
          f"probe")
    from fluidx12_tpu_torch.core.config import FluidConfig

    radiance = np.load(PROBE)["radiance"]
    out = {}
    for probe, frames in ((True, FRAMES_GI), (False, FRAMES_256)):
        cfg = FluidConfig(grid_size=GRID_256, has_light_probe=probe)
        label = "256^3 GI" if probe else "256^3"
        counts, faces, _ = run_frames(cfg, frames, dev, smi_line, label,
                                      radiance=radiance if probe else None)
        expect = {name: frames for name in KERNELS}
        expect.update(jacobi=2 * frames, jacobi_planewise=frames,
                      composite_resample=frames * faces, gi_light=frames if probe else 0,
                      **{name: 0 for name in ("residual", "jacobi_packed", "advect_z")
                         + KERNELS_2D})
        check(counts == expect, f"launch counts {counts} != {expect}")
        out[probe] = counts
    return out[True]


def phase4_cpu_vs_cuda(dev):
    """The port on CUDA against the port on the CPU, 3 frames at four
    small grids: the pallas_jacobi=False path at (128, 128, 16), the
    default projection kernels at (128, 128, 64), the 2D path with B11
    and B14 at (128, 128, 1), and with the probe at (384, 384, 32), where
    the TPU runs B13, B4's plane-sweep order and B16 (and the AO at half
    resolution, 192 lanes, no B15)."""
    phase("phase 4: port on CUDA vs port on CPU, 3 frames each")
    from fluidx12_tpu_torch.core.config import FluidConfig
    from fluidx12_tpu_torch.engine.fluidx import FluidXEngine
    from fluidx12_tpu_torch.utils.image import to_srgb_u8

    from fluidx12_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    radiance = np.load(PROBE)["radiance"]
    for kw in (dict(grid_size=(128, 128, 16), pallas_jacobi=False),
               dict(grid_size=(128, 128, 64), pallas_jacobi=True),
               dict(grid_size=(128, 128, 1), pallas_jacobi=True),
               dict(grid_size=(384, 384, 32), has_light_probe=True)):
        cfg = FluidConfig(viewport=(96, 96), **kw)
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
        if cfg.has_light_probe:
            counts = launch_counts()
            check(counts["jacobi_rr"] == counts["jacobi_planewise"] == counts["gi_light"] == 3,
                  f"B13, plane-sweep B4 and B16 ran on {kw}: {counts}")


def main() -> int:
    name, smi_line = phase0_device()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase1_build()
    results = phase2_kernels(dev)
    phase2b_kernels_2d(dev, results)
    phase2c_kernels_256(dev, results)
    counts = phase3_main_path(dev, smi_line)
    counts_2d = phase3b_fluid2d(dev, smi_line)
    counts_gi = phase3c_256(dev, smi_line)
    phase4_cpu_vs_cuda(dev)
    kernels = []
    # B4's plane-sweep order is B4's wrapper and source; its launches are
    # those of the 256^3 GI frame.
    rows = dict(KERNELS, jacobi_planewise=("B4", _JAC, "fluidx12_tpu/ops/pallas/jacobi.py:461"))
    for kname, (_, src, replaces) in rows.items():
        r = results[kname]
        path = (counts_2d if kname in KERNELS_2D
                else counts_gi if kname in KERNELS_256 + ("jacobi_planewise",) else counts)
        launches = path[kname]
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
