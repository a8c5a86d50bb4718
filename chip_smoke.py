"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from fluidx12_tpu_torch/csrc, checks each
against its plain PyTorch version on the card at the 128^3 frame's shapes,
drives `FluidXEngine` for 60 frames of the main path (PRESETS["fluid3d"]
with pallas_jacobi=False: 128^3 grid, 800x800 viewport) while counting the
kernel launches, and compares the port on CUDA with the port on the CPU at
a small grid.  Every phase prints its lines; any failure raises, so the
exit code is non-zero and the final JSON line is not printed.  The last
line is {"ok": true, "device": {...}}; the line before it lists each
kernel's launches, error and time.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

FRAMES = 60
WARMUP_FRAMES = 10

KERNELS = {
    "advect_xy": ("fluidx12_tpu_torch/csrc/advect.cu",
                  "fluidx12_tpu/ops/pallas/advect.py:365"),
    "advect_z_forces": ("fluidx12_tpu_torch/csrc/advect.cu",
                        "fluidx12_tpu/ops/pallas/advect.py:712"),
    "shear_scan": ("fluidx12_tpu_torch/csrc/sweep.cu",
                   "fluidx12_tpu/ops/pallas/sweep.py:47"),
    "composite_resample": ("fluidx12_tpu_torch/csrc/composite.cu",
                           "fluidx12_tpu/ops/pallas/composite.py:125"),
}


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of `fn` over `reps` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
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


def phase2_kernels(dev):
    """Each kernel against its plain version on the card, at 128^3 shapes."""
    phase("phase 2: kernels vs plain versions at 128^3")
    from fluidx12_tpu_torch.core.config import PRESETS
    from fluidx12_tpu_torch.core import math3d as m3
    from fluidx12_tpu_torch.core.camera import OrbitCamera
    from fluidx12_tpu_torch.ops.cuda import advect as A
    from fluidx12_tpu_torch.ops.cuda import composite as C
    from fluidx12_tpu_torch.ops.cuda import sweep as S
    from fluidx12_tpu_torch.render import lightmap_sweep as L
    from fluidx12_tpu_torch.render import slicecomp as SC
    from fluidx12_tpu_torch.render.raymarch_core import MAX_DIST

    cfg = PRESETS["fluid3d"]
    z, y, x = cfg.zyx
    rng = np.random.default_rng(0)
    results = {}

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
    results["advect_xy"] = dict(
        max_abs_err=err, ms=time_ms(lambda: A.advect_xy(vol, scales), 20),
        plain_ms=time_ms(lambda: A.advect_xy_plain(vol, scales), 5))

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
    results["advect_z_forces"] = dict(
        max_abs_err=err, ms=time_ms(lambda: A.advect_z_forces(xy, scal, table, consts), 20),
        plain_ms=time_ms(lambda: A.advect_z_forces_plain(xy, scal, table, consts), 5))

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
    results["shear_scan"] = dict(
        max_abs_err=err, ms=time_ms(lambda: S.shear_scan(log_att, s), 20),
        plain_ms=time_ms(lambda: S.shear_scan_plain(log_att, s), 3))

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
    results["composite_resample"] = dict(
        max_abs_err=err, ms=time_ms(lambda: C.composite_resample(*args), 20),
        plain_ms=time_ms(lambda: C.composite_resample_plain(*args), 3))
    for name, r in results.items():
        print(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")
    return results


def phase3_slice(dev, smi_line):
    """The main path: FRAMES frames of the 128^3 / 800^2 separate-light frame."""
    phase(f"phase 3: main path, {FRAMES} frames at 128^3 / 800^2")
    from fluidx12_tpu_torch.core.config import PRESETS
    from fluidx12_tpu_torch.engine.fluidx import FluidXEngine
    from fluidx12_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    cfg = dataclasses.replace(PRESETS["fluid3d"], pallas_jacobi=False)
    engine = FluidXEngine(cfg, device=dev)
    _, _, vis_mask = engine.update_frame()
    faces = bin(vis_mask).count("1")
    reset_launch_counts()
    times = []
    image = None
    for _ in range(FRAMES):
        t0 = time.perf_counter()
        image = engine.step_frame()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = launch_counts()
    print(f"launches over {FRAMES} frames: {counts} (visible faces per frame: {faces})")
    expect = {"advect_xy": FRAMES, "advect_z_forces": FRAMES, "shear_scan": FRAMES,
              "composite_resample": FRAMES * faces}
    check(counts == expect, f"launch counts {counts} != {expect}")

    check(tuple(image.shape) == (cfg.viewport[1], cfg.viewport[0], 3), "image shape")
    check(bool(torch.isfinite(image).all()), "image finite")
    clear = torch.tensor(cfg.clear_color[:3], device=dev)
    smoke = int(((image - clear).abs().amax(-1) > 0.02).sum())
    print(f"image {tuple(image.shape)}: finite, {smoke} pixels differ from the clear colour")
    check(smoke > 1000, "smoke visible in the frame")
    steady = times[WARMUP_FRAMES:]
    med = statistics.median(steady)
    print(f"median ms/frame (frames {WARMUP_FRAMES + 1}-{FRAMES}, host clock around a "
          f"synchronized step): {med:.3f} ms = {1e3 / med:.2f} steps/s; "
          f"min {min(steady):.3f}, max {max(steady):.3f}; first frame {times[0]:.1f} ms "
          f"[{smi_line}]")
    return counts


def phase4_cpu_vs_cuda(dev):
    """The port on CUDA against the port on the CPU, 3 frames at a small grid."""
    phase("phase 4: port on CUDA vs port on CPU, 3 frames at grid (128, 128, 16)")
    from fluidx12_tpu_torch.core.config import FluidConfig
    from fluidx12_tpu_torch.engine.fluidx import FluidXEngine
    from fluidx12_tpu_torch.utils.image import to_srgb_u8

    cfg = FluidConfig(grid_size=(128, 128, 16), viewport=(96, 96), pallas_jacobi=False)
    engines = [FluidXEngine(cfg, device=d) for d in ("cpu", dev)]
    images = []
    for e in engines:
        for _ in range(3):
            img = e.step_frame()
        images.append(to_srgb_u8(img).astype(np.int32))
    fa, fb = (e.state.fields.float().cpu() for e in engines)
    field_err = float((fa - fb).abs().max())
    ulps = bf16_ulps(fa, fb)
    img_err = int(np.abs(images[0] - images[1]).max())
    print(f"fields max abs diff {field_err:.3e} ({ulps:.2f} bf16 ulp at each "
          f"channel's scale), image max u8 diff {img_err} (limits 1 ulp and 2: only "
          f"exp/log1p/log differ between the CPU and CUDA math libraries)")
    check(ulps <= 1.0 and img_err <= 2, "CUDA vs CPU port")


def main() -> int:
    name, smi_line = phase0_device()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase1_build()
    results = phase2_kernels(dev)
    counts = phase3_slice(dev, smi_line)
    phase4_cpu_vs_cuda(dev)
    kernels = []
    for kname, (src, replaces) in KERNELS.items():
        r = results[kname]
        kernels.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": counts[kname],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"]})
    check(all(math.isfinite(k["ms"]) for k in kernels), "kernel times")
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
