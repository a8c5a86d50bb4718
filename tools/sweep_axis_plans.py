"""B11's and B15's launch plans against other layouts, on one NVIDIA GPU.

    python3 tools/sweep_axis_plans.py

Times, with CUDA events behind a sleep kernel (chip_smoke.time_ms), each
layout in turns with the per-cell design it replaced, and checks each
against the plain version (torch.equal):
  - B11 on the 2D preset's (7, 1, 512, 512) bf16 state: the x pass of
    `advect.axis_plan` followed by the y pass under the plan and under
    forced layouts (`advect.axis_layout`: a column or a bf16 pair a lane,
    tiles of 16 to 64 rows, 8 or 16 warps), a pass averaged over the pair,
    L2-warm and L2-cold (`chip_smoke.measure_cold`'s rotation);
  - B11's y pass at 128^3 and 150^3 (rows of 300 bytes) under the plan and
    forced layouts;
  - B15 at (30, 128, 128) under `stencil.stencil_plan` and forced quads and
    chunks (`stencil.stencil_layout`).
Prints the card's name and power limit first.  Needs a CUDA device; exits
non-zero without one.
"""

from __future__ import annotations

import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as CS  # noqa: E402
from fluidx12_tpu_torch.ops.cuda import _build  # noqa: E402
from fluidx12_tpu_torch.ops.cuda import advect as A  # noqa: E402
from fluidx12_tpu_torch.ops.cuda import stencil as ST  # noqa: E402

REPS = 50
BF16 = torch.bfloat16


def cold(fn, operands):
    """Mean time of fn over copies of `operands` that rotate through four
    times the L2."""
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 50 << 20)
    sets = [tuple(t.clone() for t in operands)
            for _ in range(max(2, math.ceil(4 * l2 / CS.nbytes(*operands))))]
    turn = iter(range(1 << 30))
    return CS.time_ms(lambda: fn(*sets[next(turn) % len(sets)]), REPS)


def axis_pass(plan, scale, ch):
    """B11 with `plan` as given, through the C launch."""
    def run(vol):
        out = torch.empty_like(vol)
        _build.check(A._launch_axis(vol, out, scale, ch, plan), "fx_advect_axis")
        return out
    return run


def state(shape, seed):
    """Velocities in +-1.5 voxels a step, a corner patch eight times
    faster, past the 12-voxel clip."""
    f = np.random.default_rng(seed).uniform(-1.5, 1.5, shape).astype(np.float32)
    f[:3, :, : shape[2] // 4, : shape[3] // 4] *= 8.0
    return torch.from_numpy(f).to("cuda", BF16)


def sweep_2d(scale):
    vol = state((7, 1, 512, 512), 1)
    zyx = (1, 512, 512)
    x = axis_pass(A.axis_plan(zyx, BF16, 2), scale, 0)

    def per_voxel(v):
        v = A.perthread("axis", v, scale, axis=2, disp_ch=0)
        return A.perthread("axis", v, scale, axis=1, disp_ch=1)

    ref = A.advect_axis_plain(A.advect_axis_plain(vol, scale, 2, 0), scale, 1, 1)
    layouts = [("plan", A.axis_plan(zyx, BF16, 1))] + [
        (f"cols {c} tile {t} warps {w}", A.axis_layout(zyx, BF16, 1, 7, c, t, warps=w))
        for c, t, w in ((1, 32, 8), (1, 31, 16), (2, 32, 16), (2, 16, 8), (1, 64, 16))]
    print("B11 on (7, 1, 512, 512) bf16, x then y, ms a pass:")
    for name, plan in layouts:
        y = axis_pass(plan, scale, 1)

        def pair(v, y=y):
            return y(x(v))

        assert torch.equal(pair(vol), ref), name
        y0 = CS.time_ms(lambda: per_voxel(vol), REPS) / 2
        k0 = CS.time_ms(lambda: pair(vol), REPS) / 2
        k1 = CS.time_ms(lambda: pair(vol), REPS) / 2
        y1 = CS.time_ms(lambda: per_voxel(vol), REPS) / 2
        print(f"  y {name} ({math.prod(plan.grid)} CTAs): per-voxel {y0:.4f}, this {k0:.4f}, "
              f"{k1:.4f}, per-voxel {y1:.4f}; L2-cold this {cold(pair, (vol,)) / 2:.4f}, "
              f"per-voxel {cold(per_voxel, (vol,)) / 2:.4f}", flush=True)


def sweep_y(shape, scale):
    vol = state(shape, 2)
    zyx = shape[1:]
    n = zyx[1]
    ref = A.advect_axis_plain(vol, scale, 1, 1)
    layouts = [("plan", A.axis_plan(zyx, BF16, 1))]
    for cols in (1, 2):
        for tile in sorted({n, -(-n // 2), -(-n // 4)}):
            plan = A.axis_layout(zyx, BF16, 1, 7, cols, tile)
            if plan.smem <= A.SMEM_BUDGET:
                layouts.append((f"cols {cols} tile {tile} warps {plan.block[1]}", plan))
    per_voxel = CS.time_ms(lambda: A.perthread("axis", vol, scale, axis=1, disp_ch=1), REPS)
    print(f"B11 y pass on {shape} bf16, ms (per-voxel design {per_voxel:.4f}):")
    for name, plan in layouts:
        run = axis_pass(plan, scale, 1)
        assert torch.equal(run(vol), ref), name
        print(f"  {name} ({math.prod(plan.grid)} CTAs): {CS.time_ms(lambda: run(vol), REPS):.4f}",
              flush=True)


def sweep_gradient():
    zyx = (30, 128, 128)
    q = torch.from_numpy(np.random.default_rng(3).uniform(0.0, 0.6, zyx).astype(np.float32)
                         ).to("cuda")
    ref = ST.gradient3_plain(q)
    plan = ST.stencil_plan("gradient3", zyx)
    per_cell = CS.time_ms(lambda: ST.perthread("gradient3", q), REPS)
    print(f"B15 on {zyx}, ms (per-cell design {per_cell:.4f}; plan {plan}):")
    for quads in (32, 16, 8):
        for chunk in (1, 2, 5):
            layout = ST.stencil_layout("gradient3", zyx, quads, chunk)

            def run(u, layout=layout):
                z, y, x = u.shape
                out = torch.empty((3, z, y, x), dtype=torch.float32, device=u.device)
                _build.check(_build.lib().fx_gradient3(
                    u.data_ptr(), out.data_ptr(), z, y, x, layout.quads, layout.rows,
                    layout.chunk, _build.stream_ptr(u)), "fx_gradient3")
                return out

            assert torch.equal(run(q), ref)
            print(f"  quads {quads} chunk {chunk} ({math.prod(layout.grid)} CTAs): "
                  f"{CS.time_ms(lambda: run(q), REPS):.4f}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("sweep_axis_plans: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    scale = torch.tensor(1.0, device="cuda")
    sweep_2d(scale)
    for shape in ((7, 128, 128, 128), (7, 150, 150, 150)):
        sweep_y(shape, scale)
        torch.cuda.empty_cache()
    sweep_gradient()
    return 0


if __name__ == "__main__":
    sys.exit(main())
