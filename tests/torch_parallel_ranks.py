"""The rank bodies of tests/test_torch_parallel.py: each rank of a gloo
group runs the port's sharded functions on its slab of the inputs that the
test wrote, and rank 0 writes the gathered results.

    python tests/torch_parallel_ranks.py RANK WORLD DIR

DIR holds `in.npz` and the FileStore; rank 0 writes `out.npz`.  With two
ranks it runs every 1D case, with four the composed members x slabs mesh
and the thin-slab multigrid.  It imports no jax (each rank is a fresh
interpreter); the test holds the results to the JAX package.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from fluidx12_tpu_torch.core.config import FluidConfig  # noqa: E402
from fluidx12_tpu_torch.core.state import FluidState, SceneParams  # noqa: E402

# The cases' configs (the JAX package's tests/test_parallel.py shapes).
SIM = dict(grid_size=(32, 32, 32), num_pressure_iters=16, fast_sim=False, use_pallas=False)
SWEEP_SHAPE = (64, 32, 128)
SWEEPS = 11  # a full round of _SWEEP_HALO = 8 and a remainder round
MG_SHAPE = (16, 144, 144)
COUNT_SHAPE = (64, 16, 128)
LIGHT_BASE = dict(grid_size=(32, 32, 32), viewport=(32, 32), use_pallas=False)
LIGHT_CASES = {
    "x_major": dict(light_pos=(75.0, 75.0, -75.0)),    # the all-to-all reshard
    "z_major": dict(light_pos=(10.0, 20.0, 75.0)),     # the slab prefix
    "x_pooled": dict(light_pos=(75.0, 75.0, -75.0)),   # half lateral resolution
    "z_pooled": dict(light_pos=(10.0, 20.0, 75.0)),
    "point_z": dict(point_light=True, light_pos=(10.0, 20.0, 75.0)),
    "point_x": dict(point_light=True, light_pos=(75.0, 20.0, 30.0)),
    "gi": dict(has_light_probe=True),
}
# The pooled cases lower the half-lateral-resolution threshold so that a
# 32^3 grid takes it, as the JAX package's test does.
POOL_MIN = 16
RENDER = dict(grid_size=(16, 16, 16), viewport=(32, 32), max_ray_samples=8,
              max_light_samples=4, num_pressure_iters=4, use_pallas=False)
# z = 20 on two ranks misaligns the slabs with the slice groups (stride 3).
GATHERED = dict(RENDER, grid_size=(16, 16, 20))


def params_of(inp, name) -> SceneParams:
    """The JAX package's SceneParams of case `name`, as the port's
    unpack_scene_params types them (the counts and the mask int32)."""
    leaves = [torch.from_numpy(inp[f"params/{name}/{i}"]) for i in range(14)]
    leaves[1] = leaves[1].to(torch.int64)
    leaves[11:] = [t.to(torch.int32) for t in leaves[11:]]
    return SceneParams(*leaves)


def run_1d(mesh, inp) -> dict:
    """Every 1D case on a mesh of two ranks; returns full arrays."""
    from fluidx12_tpu_torch.parallel import domain as D
    from fluidx12_tpu_torch.parallel.light import sharded_light_map
    from fluidx12_tpu_torch.parallel.render import sharded_render_frame
    from fluidx12_tpu_torch.render import lightmap_sweep

    out = {}
    # The halo exchange: planes tagged by their global z.
    z = torch.arange(4 * mesh.size, dtype=torch.float32).reshape(1, -1, 1, 1)
    tagged = D.slab_of(z.expand(2, -1, 3, 5) + torch.arange(5.0), mesh, 1)
    out["halo"] = mesh.all_gather(D._exchange_z_halo(tagged, 2, 1, mesh)).numpy()

    cfg = FluidConfig(**SIM)
    st = D.shard_state(FluidState(torch.from_numpy(inp["sim_fields"]).to(torch.bfloat16),
                                  torch.from_numpy(inp["sim_pressure"])), mesh)
    full = D.gather_state(D.sharded_simulate(st, cfg.time_step, cfg, mesh), mesh)
    out["sim_fields"] = full.fields.float().numpy()
    out["sim_pressure"] = full.pressure.numpy()

    q, b = (D.slab_of(inp[k], mesh, 0) for k in ("sweep_q", "sweep_b"))
    out["sweeps"] = D.gather_z(D._sharded_sweeps(q, b, SWEEPS, True, mesh), mesh, 0).numpy()
    mg_b = D.slab_of(inp["mg_b"], mesh, 0)
    out["mg"] = D.gather_z(D._sharded_mg(torch.zeros_like(mg_b), mg_b, mesh), mesh, 0).numpy()

    q, b = (D.slab_of(inp[k], mesh, 0) for k in ("count_q", "count_b"))
    mesh.exchanges = 0
    D._sharded_sweeps(q, b, 64, True, mesh)
    out["rounds_jacobi"] = np.array(mesh.exchanges)
    mesh.exchanges = 0
    D._sharded_mg(q, b, mesh)
    out["rounds_mg"] = np.array(mesh.exchanges)

    grid = D.slab_of(inp["light_grid"], mesh, 1)
    sh = torch.from_numpy(inp["light_sh"])
    for name, kw in LIGHT_CASES.items():
        pool_min = lightmap_sweep._LAT_POOL_MIN
        if name.endswith("pooled"):
            lightmap_sweep._LAT_POOL_MIN = POOL_MIN
        try:
            cfg = FluidConfig(**LIGHT_BASE, **kw)
            lm = sharded_light_map(grid, params_of(inp, name), cfg, mesh,
                                   sh if name == "gi" else None)
        finally:
            lightmap_sweep._LAT_POOL_MIN = pool_min
        out[f"light_{name}"] = D.gather_z(lm, mesh, 1).numpy()

    params = params_of(inp, "render")
    out["render"] = sharded_render_frame(D.slab_of(inp["render_grid"], mesh, 1), params,
                                         FluidConfig(**RENDER), mesh).numpy()
    out["gathered"] = sharded_render_frame(D.slab_of(inp["gathered_grid"], mesh, 1), params,
                                           FluidConfig(**GATHERED), mesh).numpy()
    return out


def run_4(mesh, inp) -> dict:
    """The composed 2 x 2 members x slabs frame against each member's 1D
    frame, and the multigrid on slabs thinner than its pre-smoother's halo."""
    from fluidx12_tpu_torch.parallel import domain as D
    from fluidx12_tpu_torch.parallel.dryrun import run_composed

    out = {f"composed_{k}": np.array(v) for k, v in run_composed(2, 2, "cpu").items()}
    mg_b = D.slab_of(inp["mg_b"], mesh, 0)
    out["mg_thin"] = D.gather_z(D._sharded_mg(torch.zeros_like(mg_b), mg_b, mesh),
                                mesh, 0).numpy()
    return out


def main(argv) -> int:
    from fluidx12_tpu_torch.parallel.mesh import init_distributed, make_grid_mesh

    rank, world, folder = int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    init_distributed(rank, world, "cpu", os.path.join(folder, "store"))
    try:
        mesh = make_grid_mesh(world, "cpu")
        with np.load(os.path.join(folder, "in.npz")) as f:
            inp = dict(f)
        out = run_1d(mesh, inp) if world == 2 else run_4(mesh, inp)
        if rank == 0:
            np.savez(os.path.join(folder, "out.npz"), **out)
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
