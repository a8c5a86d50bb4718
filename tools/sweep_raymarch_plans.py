"""R1's and R2's launch plans against forced variants, on one NVIDIA GPU.

    python3 tools/sweep_raymarch_plans.py

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
Prints the card's name and power limit first.  Needs a CUDA device;
exits non-zero without one.
"""

from __future__ import annotations

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


def main() -> int:
    _, smi = CS.phase0_device()
    print(smi)
    dev = torch.device("cuda", 0)
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
