"""R1's and R2's launch plans (and, with --grad, R1b's and R2b's) against
forced variants, on one NVIDIA GPU.

    python3 tools/sweep_raymarch_plans.py
    python3 tools/sweep_raymarch_plans.py --grad

On the inputs `chip_smoke.py` phase 2h builds -- PRESETS["fluid3d"] after
WARM_FRAMES frames and its dense smoke (DENSE_FRAMES frames, or the
seeded synthetic field where too few view samples are dense there) --
checks each variant of `raymarch.view_plan` (the default camera's cube
rays with R2's light map, the 800^2 DIRECT rays separate and merged) and
of `raymarch.light_plan` (R2 at 128^3, and at PRESETS["fluidgi"]'s 150^3
with the probe) against the per-thread design it replaced
(`raymarch.view_march_perthread` / `light_march_perthread`, torch.equal)
and times each with CUDA events behind a sleep kernel
(chip_smoke.time_ms), in turns: the per-thread design first and last,
the plan second and second to last, each variant once between.  The
variants change one item of the plan: R1's tiles or 64-bit offsets; R2's
brick or 64-bit offsets.

With --grad, the adjoints instead, on the f32 grid `chip_smoke.py` phase
3j differentiates (PRESETS["fluid3d"] after WARM_FRAMES frames) and on
the seeded synthetic dense smoke, with seeded cotangents: each variant of
R2b (`light_grad_plan`'s bricks against other bricks) at 128^3 and of R1b
(`view_grad_plan`'s tiles against the other tile shape, the lanes'
atomics merged or not against `view_grad_merges`'s choice) on the
default camera's cube rays and the DIRECT rays at 800^2, and at
GRAD_VIEWPORTS' smaller screens (rays a voxel of the grid's largest face
between the cube faces' 1 and the 800^2 screen's 39: where merging starts
to pay, raymarch.MERGE_RAYS_PER_VOXEL), is
held to the per-thread design it replaced
(`raymarch.light_march_grad_perthread` / `view_march_grad_perthread`)
within 1e-4 of its largest magnitude and timed in turns as above; R2's
and R1's own time on the same inputs follow.
Prints the card's name and power limit first.  Needs a CUDA device;
exits non-zero without one.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402
from fluidx12_tpu_torch.core.config import PRESETS  # noqa: E402
from fluidx12_tpu_torch.core.constants import device_constant  # noqa: E402
from fluidx12_tpu_torch.core.state import unpack_scene_params  # noqa: E402
from fluidx12_tpu_torch.ops.cuda import raymarch as R  # noqa: E402
from fluidx12_tpu_torch.render import raymarch_core as RC  # noqa: E402
from fluidx12_tpu_torch.render.cubemap import cube_rays  # noqa: E402
from fluidx12_tpu_torch.render.raycast import direct_rays  # noqa: E402

REPS = 10
# The smaller DIRECT screens R1b's merging is also timed on (--grad): 2.25,
# 4.0, 9.8, 19.1 and 25 rays a voxel of 128^3's largest face.
GRAD_VIEWPORTS = ((192, 192), (256, 256), (400, 400), (560, 560), (640, 640))


def view_variants(plan):
    """R1's plan and its variants, by name."""
    out = {"plan": plan}
    if plan.rows >= 4:
        out["32 x 1 tiles"] = R.view_layout(plan.rows, plan.cols, 32, plan.wide)
    if not plan.wide:
        out["64-bit offsets"] = plan._replace(wide=True)
    return out


def light_variants(plan, zyx):
    """R2's plan and its variants, by name."""
    out = {"plan": plan}
    for by, bz in ((4, 4), (4, 2), (2, 2), (8, 4), (4, 8)):
        if (by, bz) != (plan.by, plan.bz):
            out[f"32 x {by} x {bz} bricks"] = R.light_layout(zyx, by, bz, plan.wide)
    if not plan.wide:
        out["64-bit offsets"] = plan._replace(wide=True)
    return out


def sweep(label, variants, run, yardstick):
    """Checks every variant against the yardstick and times them in turns."""
    ref = yardstick()
    for name, plan in variants.items():
        out, err = run(plan)
        CS.check(err == 0 and torch.equal(out, ref), f"{label}, {name}: equal to the per-thread "
                                                     "design bit for bit")
    order = list(variants)
    times = {name: [] for name in order}
    y = [CS.time_ms(yardstick, REPS)]
    times["plan"].append(CS.time_ms(lambda: run(variants["plan"]), REPS))
    for name in order[1:]:
        times[name].append(CS.time_ms(lambda p=variants[name]: run(p), REPS))
    times["plan"].append(CS.time_ms(lambda: run(variants["plan"]), REPS))
    y.append(CS.time_ms(yardstick, REPS))
    print(f"{label}: per-thread design {y[0]:.4f}, {y[1]:.4f} ms", flush=True)
    for name in order:
        print(f"  {name}: {', '.join(f'{t:.4f}' for t in times[name])} ms "
              f"({min(y) / min(times[name]):.2f}x the per-thread design)", flush=True)


def sweep_inputs(engine, grid, label, dev):
    cfg = engine.config
    packed, lod, _ = engine.update_frame()
    params = unpack_scene_params(packed)
    env = RC.make_light_env(params, engine.sh_coeffs, cfg)
    pk, fl = RC.pack_env(env), RC.env_flags(env, cfg)
    num_light = params.num_light_samples
    zyx = tuple(grid.shape[1:])
    sweep(f"R2 {label}", light_variants(R.light_plan(zyx, bool(fl & R.FLAG_PROBE)), zyx),
          lambda p: R._light_launch(p, grid, pk, fl, num_light, cfg),
          lambda: R.light_march_perthread(grid, pk, fl, num_light, cfg))
    if cfg.has_light_probe:
        return
    light_map = R.light_march(grid, pk, fl, num_light, cfg)
    origin, ray_dir, hit = direct_rays(params, cfg, dev)
    direct = (origin, ray_dir, torch.full(hit.shape, float("inf"), device=dev), hit)
    merged_num = device_constant(cfg.max_ray_samples, torch.int32, dev)
    for what, rays, num, lm in (("cube rays, separate", cube_rays(params, cfg, lod, dev),
                                 params.num_samples, light_map),
                                ("800^2 DIRECT, separate", direct, params.num_samples, light_map),
                                ("800^2 DIRECT, merged", direct, merged_num, None)):
        args = (grid, *rays, num, pk, fl, cfg)
        kw = dict(light_map=lm, num_light_samples=num_light)
        plan = R.view_plan(tuple(rays[3].shape), zyx, None if lm is None else zyx)
        sweep(f"R1 {what}, {label}", view_variants(plan),
              lambda p, a=args, k=kw: R._view_launch(p, *a, **k),
              lambda a=args, k=kw: R.view_march_perthread(*a, **k))


def grad_sweep(label, variants, run, yardstick):
    """Holds every variant to the yardstick within 1e-4 of its largest
    magnitude and times them in turns, as `sweep`."""
    ref = yardstick()
    scale = max(float(r.abs().max()) for r in ref)
    for name, kw in variants.items():
        out, err = run(**kw)
        diff = max(float((o - r).abs().max()) for o, r in zip(out, ref))
        CS.check(err == 0 and scale > 0.0 and diff <= 1e-4 * scale,
                 f"{label}, {name}: within 1e-4 of the per-thread design's scale")
    order = list(variants)
    times = {name: [] for name in order}
    y = [CS.time_ms(yardstick, REPS)]
    times["plan"].append(CS.time_ms(lambda: run(**variants["plan"]), REPS))
    for name in order[1:]:
        times[name].append(CS.time_ms(lambda k=variants[name]: run(**k), REPS))
    times["plan"].append(CS.time_ms(lambda: run(**variants["plan"]), REPS))
    y.append(CS.time_ms(yardstick, REPS))
    print(f"{label}: per-thread design {y[0]:.4f}, {y[1]:.4f} ms", flush=True)
    for name in order:
        print(f"  {name}: {', '.join(f'{t:.4f}' for t in times[name])} ms "
              f"({min(y) / min(times[name]):.2f}x the per-thread design)", flush=True)


def grad_inputs(grid, params, cfg, label, dev):
    """R2b's and R1b's variants on `grid` (f32, ADJOINT's)."""
    from fluidx12_tpu_torch.render.lightmap import render_light_map

    env = RC.make_light_env(params, None, cfg)
    pk, fl = RC.pack_env(env), RC.env_flags(env, cfg)
    zyx = tuple(grid.shape[1:])
    num_light = params.num_light_samples
    cot = torch.from_numpy(np.random.default_rng(20).standard_normal((3,) + zyx)
                           .astype(np.float32)).to(dev)
    plan = R.light_grad_plan(zyx)
    variants = {"plan": dict(plan=plan)}
    for by, bz in ((1, 1), (2, 1), (4, 1), (2, 2)):
        if (by, bz) != (plan.by, plan.bz):
            variants[f"32 x {by} x {bz} bricks"] = dict(plan=R.light_layout(zyx, by, bz,
                                                                            plan.wide))

    def light(plan, **kw):
        g, err = R._light_grad_launch(plan, grid, pk, fl, num_light, cfg, cot, **kw)
        return (g,), err

    grad_sweep(f"R2b {label}", variants, light,
               lambda: (R.light_march_grad_perthread(grid, pk, fl, num_light, cfg, cot),))
    print(f"  R2 (the forward) on this grid: "
          f"{CS.time_ms(lambda: R.light_march(grid, pk, fl, num_light, cfg), REPS):.4f} ms")
    light_map = render_light_map(grid, params, cfg).float().contiguous()

    def direct(viewport):
        origin, ray_dir, hit = direct_rays(params, dataclasses.replace(cfg, viewport=viewport),
                                           dev)
        return origin, ray_dir, torch.full(hit.shape, float("inf"), device=dev), hit

    ray_sets = [("cube rays", cube_rays(params, cfg, 0, dev)),
                ("800^2 DIRECT rays", direct((800, 800)))]
    ray_sets += [(f"{w}x{h} DIRECT rays", direct((w, h))) for w, h in GRAD_VIEWPORTS]
    for what, rays in ray_sets:
        lead = tuple(rays[3].shape)
        g_out = torch.from_numpy(np.random.default_rng(21).standard_normal(lead + (4,))
                                 .astype(np.float32)).to(dev)
        args = (grid, light_map, *rays, params.num_samples, pk, fl, cfg, g_out)
        plan = R.view_grad_plan(lead, zyx, zyx)
        variants = {"plan": dict(plan=plan)}
        for tile_w in (8, 32):
            if tile_w != plan.tile_w and plan.rows >= 32 // tile_w:
                variants[f"{tile_w} x {32 // tile_w} tiles"] = dict(
                    plan=R.view_layout(plan.rows, plan.cols, tile_w, plan.wide))
        merge = R.view_grad_merges(lead, zyx)
        variants["plan"]["merge"] = merge
        variants["plain atomics" if merge else "merged atomics"] = dict(plan=plan,
                                                                       merge=not merge)

        def view(plan, a=args, **kw):
            g_grid, g_lm, err = R._view_grad_launch(plan, *a, **kw)
            return (g_grid, g_lm), err

        grad_sweep(f"R1b {what}, {label}", variants, view,
                   lambda a=args: R.view_march_grad_perthread(*a))
        r1 = CS.time_ms(lambda r=rays: R.view_march(grid, *r, params.num_samples, pk, fl, cfg,
                                                    light_map=light_map), REPS)
        print(f"  R1 (the forward) on these rays: {r1:.4f} ms")


def grad_main(smi, dev) -> int:
    from fluidx12_tpu_torch.models.smoke import SmokeModel

    cfg = CS.adjoint_config()
    params = SmokeModel(cfg, device=dev).default_params()
    warm = CS.warm_engine(PRESETS["fluid3d"], dev)
    grid = warm.state.color.float().contiguous()
    del warm
    dense = CS.synthetic_smoke(cfg, dev).float().contiguous()
    inputs = ((grid, f"128^3 after {CS.WARM_FRAMES} frames"),
              (dense, f"128^3 synthetic smoke (seed {CS.DENSE_SEED})"))
    for g, label in inputs:
        grad_inputs(g, params, cfg, label, dev)
    print(smi)
    return 0


def main() -> int:
    _, smi = CS.phase0_device()
    print(smi)
    dev = torch.device("cuda", 0)
    if "--grad" in sys.argv[1:]:
        return grad_main(smi, dev)
    warm = CS.warm_engine(PRESETS["fluid3d"], dev)
    sweep_inputs(warm, warm.state.color, f"128^3 after {CS.WARM_FRAMES} frames", dev)
    dense = CS.warm_engine(PRESETS["fluid3d"], dev, frames=CS.DENSE_FRAMES)
    grid = dense.state.color
    params = unpack_scene_params(dense.update_frame()[0])
    env = RC.make_light_env(params, None, dense.config)
    pk, fl = RC.pack_env(env), RC.env_flags(env, dense.config)
    lm = R.light_march(grid, pk, fl, params.num_light_samples, dense.config)
    label = f"128^3 after {CS.DENSE_FRAMES} frames"
    cube = cube_rays(params, dense.config, 0, dev)
    s = torch.empty(cube[3].shape + (3,), dtype=torch.int32, device=dev)
    R.view_march(grid, *cube, params.num_samples, pk, fl, dense.config, light_map=lm, samples=s)
    if float(s[..., 1].sum()) < CS.DENSE_MIN * float(s[..., 0].sum()):
        grid = CS.synthetic_smoke(dense.config, dev)
        label = f"128^3 synthetic smoke (seed {CS.DENSE_SEED})"
    sweep_inputs(dense, grid, label, dev)
    del warm, dense
    gi = CS.warm_engine(PRESETS["fluidgi"], dev, radiance=np.load(CS.PROBE)["radiance"])
    sweep_inputs(gi, gi.state.color, "150^3 with the probe", dev)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
