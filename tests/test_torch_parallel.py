"""The port's multi-device modes (fluidx12_tpu_torch/parallel/) on gloo,
against the JAX package's single-device functions on the CPU.

The JAX package holds its sharded functions equal to its single-device ones
(tests/test_parallel.py); the port's are held to those same single-device
functions, with that file's configs and tolerances.  One spawn of two gloo
ranks (tests/torch_parallel_ranks.py, which imports no jax) runs every 1D
case on inputs this module writes; one spawn of four runs the 2 x 2
members x slabs mesh.  The ensemble runs in this process.  No JAX
`shard_map` program is compiled here.
"""

import os
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluidx12_tpu.core.config import FluidConfig
from fluidx12_tpu.core.state import FluidState as JaxState
from fluidx12_tpu.models.smoke import SmokeModel as JaxModel
from fluidx12_tpu.parallel import light as jax_light
from fluidx12_tpu.parallel.ensemble import SmokeEnsemble as JaxEnsemble
from fluidx12_tpu.render import lightmap_sweep as jax_sweep
from fluidx12_tpu.render.resolve import resolve_cube
from fluidx12_tpu.render.slicecomp import ray_march_cube_fast
from fluidx12_tpu.sim.mg import mg_solve
from fluidx12_tpu.sim.project import jacobi_sweeps
from fluidx12_tpu.sim.step import simulate
from fluidx12_tpu_torch.core.config import FluidConfig as TorchConfig
from fluidx12_tpu_torch.core.state import FluidState, make_initial_state
from fluidx12_tpu_torch.parallel import light as torch_light
from fluidx12_tpu_torch.parallel.ensemble import SmokeEnsemble
from fluidx12_tpu_torch.parallel.render import slice_parallel_render_supported
from fluidx12_tpu_torch.sim.project import jacobi_sweeps as torch_jacobi_sweeps
from fluidx12_tpu_torch.sim.step import simulate as torch_simulate
from tests import torch_parallel_ranks as ranks
from tests.test_fastpath import _smoke_grid
from tests.test_render import scene

# Several pytest workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)

_RANKS = os.path.join(os.path.dirname(__file__), "torch_parallel_ranks.py")
ENSEMBLE = dict(grid_size=(16, 16, 16), viewport=(32, 32), max_ray_samples=8,
                max_light_samples=4, num_pressure_iters=4, use_pallas=False, fast_sim=False)


def _start(world: int, inputs: dict, folder):
    """Start the rank bodies on `world` gloo ranks over `inputs`."""
    np.savez(os.path.join(folder, "in.npz"), **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, _RANKS, str(r), str(world), str(folder)],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(world)], folder


def _finish(started) -> dict:
    """Wait for the ranks; returns rank 0's results."""
    procs, folder = started
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-6000:]
    with np.load(os.path.join(folder, "out.npz")) as f:
        return dict(f)


def _put_params(inputs: dict, name: str, params) -> None:
    for i, leaf in enumerate(params):
        inputs[f"params/{name}/{i}"] = np.array(leaf, dtype=np.float32)


def _mg_rhs():
    """A smooth, zero-mean right-hand side on MG_SHAPE."""
    b = np.random.default_rng(13).uniform(-1, 1, ranks.MG_SHAPE).astype(np.float32)
    for ax in range(3):
        b = (np.roll(b, 1, ax) + b + np.roll(b, -1, ax)) / 3.0
    return b - b.mean()


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The inputs and the JAX references, and the results of the two
    spawns: two gloo ranks on every 1D case, four on the composed mesh and
    the thin-slab multigrid.  The ranks run while this process compiles
    the JAX references, the ensemble's among them."""
    rng = np.random.default_rng(11)
    inp, ref = {}, {}
    # Five warm-up steps from rest by the port's single-device step (held to
    # JAX's in tests/test_torch_faithful.py); JAX steps the result once.
    tcfg = TorchConfig(**ranks.SIM)
    state = make_initial_state(tcfg, "cpu")
    for _ in range(5):
        state = torch_simulate(state, tcfg.time_step, tcfg)
    inp["sim_fields"] = state.fields.float().numpy()
    inp["sim_pressure"] = state.pressure.numpy()

    inp["sweep_q"] = rng.uniform(-1, 1, ranks.SWEEP_SHAPE).astype(np.float32)
    inp["sweep_b"] = rng.uniform(-1, 1, ranks.SWEEP_SHAPE).astype(np.float32)
    inp["mg_b"] = _mg_rhs()
    inp["count_q"] = rng.uniform(-1, 1, ranks.COUNT_SHAPE).astype(np.float32)
    inp["count_b"] = rng.uniform(-1, 1, ranks.COUNT_SHAPE).astype(np.float32)
    grid = _smoke_grid(32)
    inp["light_grid"] = grid
    inp["light_sh"] = np.random.default_rng(3).uniform(-0.2, 0.8, (9, 3)).astype(np.float32)
    light = {}
    for name, kw in ranks.LIGHT_CASES.items():
        lcfg = FluidConfig(**ranks.LIGHT_BASE, **kw)
        assert jax_light.sharded_light_supported(lcfg, 2), name
        light[name] = (lcfg, scene(lcfg))
        _put_params(inp, name, light[name][1])
    rcfg = FluidConfig(**ranks.RENDER)
    params = scene(rcfg)
    _put_params(inp, "render", params)
    inp["render_grid"] = _smoke_grid(16, seed=2)
    inp["gathered_grid"] = np.concatenate([_smoke_grid(16, seed=4)] * 2, axis=1)[:, :20]
    two = _start(2, inp, tmp_path_factory.mktemp("two"))
    four = _start(4, {"mg_b": inp["mg_b"]}, tmp_path_factory.mktemp("four"))

    cfg = FluidConfig(**ranks.SIM)
    out = jax.jit(lambda st: simulate(st, cfg.time_step, cfg))(JaxState(
        fields=jnp.asarray(inp["sim_fields"].astype(ml_dtypes.bfloat16)),
        pressure=jnp.asarray(inp["sim_pressure"])))
    ref["sim_fields"] = np.asarray(out.fields, np.float32)
    ref["sim_pressure"] = np.asarray(out.pressure)

    ref["sweeps"] = np.asarray(jax.jit(lambda q, b: jacobi_sweeps(q, b, ranks.SWEEPS, True))(
        inp["sweep_q"], inp["sweep_b"]))
    ref["mg"] = np.asarray(jax.jit(mg_solve)(jnp.zeros(ranks.MG_SHAPE), inp["mg_b"]))

    def light_maps(g, sh):
        # The pooled cases trace with the JAX package's half-lateral-
        # resolution threshold lowered to POOL_MIN, as its own test does.
        maps, pool_min = [], jax_sweep._LAT_POOL_MIN
        for n, (lcfg, lparams) in light.items():
            jax_sweep._LAT_POOL_MIN = ranks.POOL_MIN if n.endswith("pooled") else pool_min
            try:
                maps.append(jax_sweep.render_light_map_fast(g, lparams, lcfg,
                                                            sh if n == "gi" else None))
            finally:
                jax_sweep._LAT_POOL_MIN = pool_min
        return maps

    maps = jax.jit(light_maps)(grid, jnp.asarray(inp["light_sh"]))
    ref.update({f"light_{n}": np.asarray(m) for n, m in zip(light, maps)})

    def render(g, c):
        lm = jax_sweep.render_light_map_fast(g, params, c)
        return resolve_cube(ray_march_cube_fast(g, params, c, lm), params, c)

    gcfg = FluidConfig(**ranks.GATHERED)
    images = jax.jit(lambda g, gg: (render(g, rcfg), render(gg, gcfg)))(
        inp["render_grid"], inp["gathered_grid"])
    ref["render"], ref["gathered"] = (np.asarray(i) for i in images)

    # The ensemble's members: JAX's init(seed=3) and two SmokeModel.step.
    ecfg = FluidConfig(**ENSEMBLE)
    states0 = jax.jit(JaxEnsemble(ecfg, batch=2).init, static_argnums=0)(3)
    ref["ens_fields"] = np.asarray(states0.fields, np.float32)
    ref["ens_pressure"] = np.array(states0.pressure)
    model = JaxModel(ecfg)
    step = jax.jit(model.step)
    images = []
    for b in range(2):
        sb = JaxState(fields=jnp.asarray(ref["ens_fields"][b].astype(ml_dtypes.bfloat16)),
                      pressure=jnp.asarray(ref["ens_pressure"][b]))
        for _ in range(2):
            sb, img = step(sb, model.default_params())
        images.append(np.asarray(img))
    ref["ens_images"] = np.stack(images)
    return inp, ref, _finish(two), _finish(four)


@pytest.fixture
def one_d(spawned):
    inp, ref, got, _ = spawned
    return inp, ref, got


def test_halo_exchange_edges_and_seams(one_d):
    """`_exchange_z_halo` of two planes on two ranks: each slab gains its
    neighbour's two nearest planes, and the first and last rank repeat
    their own edge plane (the single-device stencils' clamp)."""
    _, _, got = one_d
    halo = got["halo"]                       # (rank, 2, zl + 4, 3, 5) of plane tags
    tags = halo[:, 0, :, 0, 0]
    np.testing.assert_array_equal(tags[0], [0, 0, 0, 1, 2, 3, 4, 5])
    np.testing.assert_array_equal(tags[1], [2, 3, 4, 5, 6, 7, 7, 7])
    np.testing.assert_array_equal(halo[..., 0, :], halo[..., 2, :])
    np.testing.assert_array_equal(halo[:, :, :, 0, :] - tags[:, None, :, None],
                                  np.broadcast_to(np.arange(5.0), (2, 2, 8, 5)))


def test_sharded_simulate_matches_single_device(one_d):
    """`sharded_simulate` on two Z-slabs against JAX's single-device
    `simulate` (fast_sim=False, 32^3, 16 sweeps; from five warm-up steps) with
    tests/test_parallel.py's tolerances: colour 2e-5, velocity and
    pressure 5e-4."""
    _, ref, got = one_d
    np.testing.assert_allclose(got["sim_fields"][3:], ref["sim_fields"][3:], atol=2e-5)
    np.testing.assert_allclose(got["sim_fields"][:3], ref["sim_fields"][:3], atol=5e-4)
    np.testing.assert_allclose(got["sim_pressure"], ref["sim_pressure"], atol=5e-4)


def test_sharded_batched_sweeps_match_single_device(one_d):
    """Halo-depth batched Jacobi (k sweeps an exchange) on (64, 32, 128):
    11 sweeps, a full round of 8 (the right-hand side riding its message)
    and a remainder round of 3, equal the port's single-device sweeps bit
    for bit, and JAX's within 1e-5."""
    inp, ref, got = one_d
    q, b = torch.from_numpy(inp["sweep_q"]), torch.from_numpy(inp["sweep_b"])
    np.testing.assert_array_equal(got["sweeps"],
                                  torch_jacobi_sweeps(q, b, ranks.SWEEPS, True).numpy())
    np.testing.assert_allclose(got["sweeps"], ref["sweeps"], atol=1e-5)


def test_sharded_mg_matches_single_device(one_d):
    """The Z-sharded V-cycle on (16, 144, 144) over two ranks (each slab
    deep enough for the fused pre-smoother + residual exchange) against
    JAX `mg_solve`, atol 2e-4."""
    _, ref, got = one_d
    np.testing.assert_allclose(got["mg"], ref["mg"], atol=2e-4)


def test_sharded_solve_exchange_counts(one_d):
    """Exchange rounds per solve (tests/test_parallel.py:478-505): a
    64-sweep Jacobi solve takes at most 8, the V-cycle at most 6."""
    _, _, got = one_d
    assert 0 < int(got["rounds_jacobi"]) <= 8
    assert 0 < int(got["rounds_mg"]) <= 6


@pytest.mark.parametrize("name", list(ranks.LIGHT_CASES))
def test_sharded_light_map_matches_single_device(one_d, name):
    """`sharded_light_map` on two slabs against the JAX package's
    single-device `render_light_map_fast`: the directional light x-major
    (all-to-all reshard) and z-major (slab prefix), both again at half
    lateral resolution (the threshold lowered to POOL_MIN on both sides;
    x-major, the unpool's z lerp crosses the seam), the point light both
    ways and the GI ambient; atol 2e-5, 1e-4 for the point light and 5e-5
    for GI, as tests/test_parallel.py."""
    _, ref, got = one_d
    atol = 1e-4 if name.startswith("point") else 5e-5 if name == "gi" else 2e-5
    np.testing.assert_allclose(got[f"light_{name}"], ref[f"light_{name}"], atol=atol)
    if name.endswith("pooled"):
        full = ref[f"light_{name[0]}_major"]
        assert float(np.abs(ref[f"light_{name}"] - full).max()) > 1e-3, "the pooling engaged"


def test_sharded_render_matches_single_device_image(one_d):
    """`sharded_render_frame` on two slabs (16^3, 32^2, 8 samples) against
    JAX's single-device light map, cube march and resolve, atol 2e-5; and
    on z = 20, where the slabs miss the slice groups, the gathered route
    against JAX's single-device render of that grid, atol 2e-5."""
    _, ref, got = one_d
    assert not slice_parallel_render_supported(TorchConfig(**ranks.GATHERED), 2)
    for case in ("render", "gathered"):
        np.testing.assert_allclose(got[case], ref[case], atol=2e-5, err_msg=case)
        assert float(np.abs(got[case]).max()) > 0.05, case


def test_sharded_light_gate_rejects_divergent_resolutions():
    """The gate rejects a slab layout on which the single-device light map's
    resolution choices cannot be reproduced (zg = 40 on 8 ranks: odd local
    z with the half-resolution AO), and agrees with the JAX package's on
    these configs over 1-8 ranks."""
    cfgs = [dict(grid_size=(32, 32, 40), has_light_probe=True, light_pos=(10.0, 20.0, 75.0)),
            dict(grid_size=(32, 32, 40), light_pos=(10.0, 20.0, 75.0)),
            dict(grid_size=(32, 32, 32), has_light_probe=True),
            dict(grid_size=(32, 32, 32), point_light=True, light_pos=(75.0, 20.0, 30.0)),
            dict(grid_size=(256, 256, 64), light_pos=(75.0, 75.0, -75.0))]
    assert not torch_light.sharded_light_supported(TorchConfig(**cfgs[0], viewport=(32, 32)), 8)
    assert torch_light.sharded_light_supported(TorchConfig(**cfgs[1], viewport=(32, 32)), 8)
    for kw in cfgs:
        for n in range(1, 9):
            assert (torch_light.sharded_light_supported(TorchConfig(**kw), n)
                    == jax_light.sharded_light_supported(FluidConfig(**kw), n)), (kw, n)


def test_smoke_ensemble_matches_independent_members(spawned):
    """`SmokeEnsemble` of two members from the JAX package's `init(seed=3)`
    states (carried as numpy), two steps, against JAX `SmokeModel.step` per
    member (16^3, use_pallas=False, the gather advect: its JAX program
    compiles in a third of the advect twin's time): the JAX test's gates
    (at most 0.1% of values off by more than 2e-5, none by more than one u8
    cube level); the members diverge.  The port's own `init` draws its
    noise from a torch.Generator: seeded alike, alike; seeded apart,
    apart."""
    _, ref, _, _ = spawned
    ens = SmokeEnsemble(TorchConfig(**ENSEMBLE), batch=2, device="cpu")
    states = FluidState(torch.from_numpy(ref["ens_fields"]).to(torch.bfloat16),
                        torch.from_numpy(ref["ens_pressure"]))
    params = ens.default_params()
    for _ in range(2):
        states, imgs = ens.step(states, params)
    for b in range(2):
        diff = np.abs(imgs[b].numpy() - ref["ens_images"][b])
        assert (diff > 2e-5).mean() < 1e-3, f"member {b}: {diff.max()}"
        assert diff.max() <= 1.0 / 255.0 + 2e-5, f"member {b}: {diff.max()}"
    assert float((imgs[0] - imgs[1]).abs().max()) > 1e-6
    a, b = (ens.init(seed=s) for s in (3, 3))
    assert torch.equal(a.fields, b.fields) and not torch.equal(a.fields[0], a.fields[1])


def test_composed_mesh_matches_1d_per_member(spawned):
    """Four gloo ranks as 2 members x 2 slabs (parallel/ensemble.py): each
    member's composed step and render against its 1D sharded step and
    render on its row, within one bf16 state level and one u8 cube level
    (the JAX dry run's gates), the member groups' gather showing two
    different members; and the V-cycle on (16, 144, 144) over four slabs,
    each too thin for the fused pre-smoother exchange, against JAX
    `mg_solve`, atol 2e-4."""
    _, ref, _, got = spawned
    assert float(got["composed_state"]) <= 4e-3
    assert float(got["composed_image"]) <= 1.0 / 255.0 + 1e-4
    assert float(got["composed_members_apart"]) > 0.0
    np.testing.assert_allclose(got["mg_thin"], ref["mg"], atol=2e-4)
