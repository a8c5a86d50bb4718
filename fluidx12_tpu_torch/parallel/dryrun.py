"""The multi-device dry run (the port's counterpart of the JAX package's
`__graft_entry__.dryrun_multichip`): the full sharded frame, simulation and
render, held to the single-device frame, and with four ranks or more the
composed members x slabs mesh held to the 1D sharded run of each member.

    python -m fluidx12_tpu_torch.parallel.dryrun 1          # nccl, world size 1, one card
    python -m fluidx12_tpu_torch.parallel.dryrun 2 --cpu    # 2 gloo ranks on the CPU

It runs on the card unless the caller asks for the CPU.  On the card
`dryrun_multichip` runs world size 1 in this process (NCCL puts one rank
on a card) and raises for more; with `device="cpu"` it spawns n processes
that join a gloo group through a FileStore in a temporary directory.
Without a CUDA device the card's run raises, and the command exits 2.  The configs and
tolerances are the JAX dry run's: the state's colour within 2e-5 and the image
within 2e-4 of the single-device frame, and the composed mesh within one
bf16 state level and one u8 cube level of the 1D run.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import sys
import tempfile

import numpy as np
import torch

from fluidx12_tpu_torch.core.config import FluidConfig
from fluidx12_tpu_torch.core.state import FluidState, make_initial_state
from fluidx12_tpu_torch.models.smoke import SmokeModel
from fluidx12_tpu_torch.parallel.domain import gather_state, shard_state, sharded_simulate
from fluidx12_tpu_torch.parallel.ensemble import (
    make_ensemble_mesh,
    member_slabs,
    sharded_ensemble_render,
    sharded_ensemble_simulate,
)
from fluidx12_tpu_torch.parallel.mesh import all_gather_stacked, init_distributed, make_grid_mesh
from fluidx12_tpu_torch.parallel.render import sharded_render_frame
from fluidx12_tpu_torch.render.lightmap_sweep import render_light_map_fast
from fluidx12_tpu_torch.render.resolve import resolve_cube
from fluidx12_tpu_torch.render.slicecomp import ray_march_cube_fast
from fluidx12_tpu_torch.sim.advect import advect
from fluidx12_tpu_torch.sim.project import project
from fluidx12_tpu_torch.sim.step import simulate
from fluidx12_tpu_torch.utils.compare import bf16_ulps

# Seconds a spawned rank may take before the run counts as hung.
_RANK_TIMEOUT = 600


def single_device_step(state: FluidState, config: FluidConfig) -> FluidState:
    """The single-device twin of `domain.sharded_simulate`: the gather
    advect (sim/advect.py) composed with the projection the sharded step
    mirrors (the multigrid where `mg_supported` holds, else the Jacobi
    sweeps), f32, one rounding at the end (__graft_entry__.py:156-160)."""
    dt = torch.tensor(float(config.time_step), dtype=torch.float32, device=state.fields.device)
    vel, col = advect(state.fields[:3], state.fields[3:], dt, config)
    fields, q = project(torch.cat([vel, col]), state.pressure, config.time_step, config)
    return FluidState(fields=fields.to(state.fields.dtype), pressure=q)


def single_device_image(grid: torch.Tensor, params, config: FluidConfig, sh_coeffs=None):
    """The single-device fast render the sharded one mirrors: the light
    map, the cube march and the resolve, (H, W, 4) premultiplied."""
    lm = render_light_map_fast(grid, params, config, sh_coeffs)
    return resolve_cube(ray_march_cube_fast(grid, params, config, lm), params, config)


def domain_config(n_devices: int) -> FluidConfig:
    """The dry run's grid: 144 x 144 planes (the multigrid engages), z
    split evenly and at least 16, the light probe on (the sharded GI)."""
    z = max(2 * n_devices, 16)
    while z % n_devices:
        z += 1
    return FluidConfig(grid_size=(144, 144, z), viewport=(48, 48), num_pressure_iters=16,
                       max_ray_samples=8, max_light_samples=4, use_pallas=False,
                       has_light_probe=True)


def run_domain(mesh, config: FluidConfig, frames: int = 2, seed: int = 7,
               state0: FluidState = None) -> dict:
    """`frames` sharded frames (sharded_simulate, sharded_render_frame) from
    `state0` (a full state; rest by default) on every rank of `mesh`,
    against the single-device frames run on
    each rank; returns the largest differences of the state's colour (the
    JAX dry run's gate), velocity and pressure, and of the image, and the
    largest state difference in bf16 ulps at each channel's scale, and the
    exchange rounds the sharded frames took.  From
    a developed state the colour's last bf16 bit differs here and there
    (the f32 results round apart), which is what `state_ulps` bounds."""
    dev = mesh.device
    params = SmokeModel(config, device=dev).default_params()
    rng = np.random.default_rng(seed)
    sh = torch.from_numpy(rng.uniform(0.0, 0.5, (9, 3)).astype(np.float32)).to(dev)
    if state0 is None:
        state0 = make_initial_state(config, dev)
    rounds = mesh.exchanges
    state = shard_state(state0, mesh)
    for _ in range(frames):
        state = sharded_simulate(state, config.time_step, config, mesh)
        img = sharded_render_frame(state.color, params, config, mesh, sh)
    full = gather_state(state, mesh)
    ref = state0
    for _ in range(frames):
        ref = single_device_step(ref, config)
    ref_img = single_device_image(full.color, params, config, sh)
    if not (bool(torch.isfinite(img).all()) and bool(torch.isfinite(full.fields).all())):
        raise AssertionError("the sharded frame is not finite")
    return {"color": float((full.color.float() - ref.color.float()).abs().max()),
            "state_ulps": bf16_ulps(full.fields, ref.fields),
            "velocity": float((full.velocity.float() - ref.velocity.float()).abs().max()),
            "pressure": float((full.pressure - ref.pressure).abs().max()),
            "image": float((img - ref_img).abs().max()),
            "exchanges": mesh.exchanges - rounds}


def composed_config(n_slabs: int) -> FluidConfig:
    zc = max(4 * n_slabs, 16)  # the local z holds the render's slice stride
    return FluidConfig(grid_size=(32, 32, zc), viewport=(32, 32), num_pressure_iters=4,
                       max_ray_samples=8, max_light_samples=4, use_pallas=False)


def run_composed(n_members: int, n_slabs: int, device) -> dict:
    """The composed members x slabs frame against the 1D sharded frame of
    each member on its row (__graft_entry__.py:184-248): two members of
    different warm-up depths; returns the largest differences over all
    ranks and how far the members' images lie apart."""
    cfg = composed_config(n_slabs)
    dev = torch.device(device)
    params = SmokeModel(cfg, device=dev).default_params()
    s, members = make_initial_state(cfg, dev), []
    for i in range(2 + n_members):
        s = simulate(s, cfg.time_step, cfg)
        if i >= 2:
            members.append(s)
    mesh = make_ensemble_mesh(n_members, n_slabs, dev)
    stacked = FluidState(fields=torch.stack([m.fields for m in members]),
                         pressure=torch.stack([m.pressure for m in members]))
    local = FluidState(fields=member_slabs(stacked.fields, mesh, 1),
                       pressure=member_slabs(stacked.pressure, mesh, 0))
    params_b = type(params)(*(p.expand((local.fields.shape[0],) + tuple(p.shape))
                              for p in params))
    out = sharded_ensemble_simulate(local, cfg.time_step, cfg, mesh)
    imgs = sharded_ensemble_render(out.fields[:, 3:], params_b, cfg, mesh)
    per = len(members) // n_members
    d_state = d_img = 0.0
    for j in range(per):
        b = mesh.member_index * per + j
        r = sharded_simulate(shard_state(members[b], mesh.z), cfg.time_step, cfg, mesh.z)
        r_img = sharded_render_frame(r.color, params, cfg, mesh.z)
        d_state = max(d_state, float((out.fields[j].float() - r.fields.float()).abs().max()))
        d_img = max(d_img, float((imgs[j] - r_img).abs().max()))
    # The member groups: every rank gathers its column's first member image.
    col = all_gather_stacked(imgs[0], n_members, mesh.member_group)
    spread = float((col[0] - col[-1]).abs().max())
    worst = torch.tensor([d_state, d_img], dtype=torch.float64, device=dev)
    torch.distributed.all_reduce(worst, op=torch.distributed.ReduceOp.MAX)
    return {"state": float(worst[0]), "image": float(worst[1]), "members_apart": spread}


def check(results: dict, composed: dict = None) -> None:
    """Raise AssertionError where a result misses the JAX dry run's gates."""
    if results["color"] > 2e-5 or results["image"] > 2e-4:
        raise AssertionError(f"the sharded frame diverged from the single-device one: {results}")
    if composed is not None:
        if composed["state"] > 4e-3 or composed["image"] > 1.0 / 255.0 + 1e-4:
            raise AssertionError(f"the composed frame diverged from the 1D one: {composed}")
        if not composed["members_apart"] > 0.0:
            raise AssertionError(f"the members did not diverge: {composed}")


def rank_main(rank: int, world_size: int, device: str, store_path) -> dict:
    """One rank of the dry run: joins the process group, runs the domain
    frame and (four ranks or more, even) the composed one, and checks
    them."""
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    init_distributed(rank, world_size, device, store_path)
    try:
        mesh = make_grid_mesh(world_size, device)
        results = run_domain(mesh, domain_config(world_size))
        composed = None
        if world_size >= 4 and world_size % 2 == 0:
            composed = run_composed(2, world_size // 2, mesh.device)
        check(results, composed)
        return {"domain": results, "composed": composed}
    finally:
        torch.distributed.destroy_process_group()


def _spawned_rank(rank: int, world_size: int, store_path: str) -> None:
    results = rank_main(rank, world_size, "cpu", store_path)
    if rank == 0:
        print(f"dryrun rank 0 of {world_size}: {results}", flush=True)


def dryrun_multichip(world_size: int, device="cuda") -> dict:
    """Run the dry run on `world_size` ranks: world size 1 on the card, or
    gloo processes on the CPU.  Raises when a rank fails its checks;
    returns rank 0's results where it ran in this process."""
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the dry run asks for a CUDA device, and none is available; "
                               "pass device='cpu' to run gloo ranks on the CPU")
        if world_size != 1:
            raise ValueError("NCCL puts one rank on a card: one card runs world size 1")
        return rank_main(0, 1, device, None)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_spawned_rank, args=(r, world_size, store))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(_RANK_TIMEOUT)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"dry run ranks failed (rank, exit code): {bad}")
    return {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("world_size", type=int)
    ap.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA device: the dry run runs on the card; pass --cpu to run gloo ranks "
              "on the CPU", file=sys.stderr)
        return 2
    out = dryrun_multichip(args.world_size, "cpu" if args.cpu else "cuda")
    print("dryrun ok", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
