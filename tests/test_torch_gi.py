"""The port's 256^3 GI path on the CPU against the JAX package: kernel B13
(the fused pre-smoother + residual + restrict) and the multigrid around it,
kernel B16 (the fused GI light map) and the light map around it, the
half-resolution shadow sweep, the SH projection, the sky, and the GI frame
of the `fluidgi` golden's configuration.

The TPU takes B13, B4's plane-sweep order and B16 only on large planes;
each test picks the smallest grid where the JAX gates take the 256^3
route, and pins that route with asserts.  Pallas kernels run in interpret
mode, as tests/test_pallas.py runs them; each JAX reference is built once
per module.  Inputs are made with numpy from a seed.
"""

import functools
import importlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluidx12_tpu.core import math3d as m3
from fluidx12_tpu.core.camera import OrbitCamera
from fluidx12_tpu.core.config import FluidConfig
from fluidx12_tpu.core.state import default_scene_params
from fluidx12_tpu.gi import sh as jsh
from fluidx12_tpu.ops.pallas import jacobi as pj
from fluidx12_tpu.ops.pallas import stencil as ps
from fluidx12_tpu.ops.transform import transform_vector
from fluidx12_tpu.render import environment as jenv
from fluidx12_tpu.render import lightmap_sweep as jls
from fluidx12_tpu.render.raymarch_core import MAX_DIST
from fluidx12_tpu_torch.core.config import FluidConfig as TorchConfig
from fluidx12_tpu_torch.core.state import SceneParams
from fluidx12_tpu_torch.engine.fluidx import FluidXEngine
from fluidx12_tpu_torch.gi import sh as tsh
from fluidx12_tpu_torch.ops.cuda import jacobi as tj
from fluidx12_tpu_torch.ops.cuda import stencil as ts
from fluidx12_tpu_torch.render import environment as tenv
from fluidx12_tpu_torch.render import lightmap_sweep as tls
from fluidx12_tpu_torch.utils.image import to_srgb_u8
from fluidx12_tpu_torch.utils.png import read_png

jmg = importlib.import_module("fluidx12_tpu.sim.mg")
tmg = importlib.import_module("fluidx12_tpu_torch.sim.mg")

# Several pytest workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = os.path.join(ROOT, "assets", "rnl_cross.npz")

# The smallest volume on which the TPU's multigrid takes 256^3's route:
# B13 on windows of all three y-shifts, the plane-sweep B4 post-smoother,
# the whole-window B4 on the coarse level, B7.
MG_SHAPE = (24, 144, 256)


def _pair(rng, shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _to_torch(params) -> SceneParams:
    return SceneParams(*(torch.from_numpy(np.array(p, np.float32)) for p in params))


def _pin_mg_route(shape):
    coarse = tuple(n // 2 for n in shape)
    _, ytile, _ = pj._plan_planewise(shape, jmg.MG_PRE)
    assert pj.jacobi_rr_supported(shape, jmg.MG_PRE) and shape[1] // ytile >= 3
    assert pj.jacobi_tuning(shape, jmg.MG_POST) == (8, 4)
    assert tj.window_order(shape, 4) == tj.ORDER_PLANEWISE
    assert pj.jacobi_tuning(coarse, jmg.MG_COARSE_ITERS) == (32, 4)
    assert tj.window_order(coarse, 4) == tj.ORDER_WINDOW
    assert ps.prolong_pallas_supported(shape)


@pytest.fixture(scope="module")
def mg_case():
    """(q, b) at MG_SHAPE and the V-cycle as the TPU runs it there, composed
    from the Pallas kernels in interpret mode: B13, the whole-window B4 on
    the coarse level, B7, the plane-sweep B4; also B13's own outputs."""
    _pin_mg_route(MG_SHAPE)
    rng = np.random.default_rng(11)
    (jq, tq), (jb, tb) = _pair(rng, MG_SHAPE, 0.05), _pair(rng, MG_SHAPE)
    q1, r_c = pj.jacobi_pallas_rr(jq, jb, jmg.MG_PRE, scale=4.0)
    e_c = pj.jacobi_pallas(jnp.zeros_like(r_c), r_c, jmg.MG_COARSE_ITERS,
                           *pj.jacobi_tuning(r_c.shape, jmg.MG_COARSE_ITERS))
    q = ps.prolong_correct_pallas(q1, e_c)
    q = pj.jacobi_pallas(q, jb, jmg.MG_POST, *pj.jacobi_tuning(MG_SHAPE, jmg.MG_POST))
    return tq, tb, np.asarray(q1), np.asarray(r_c), np.asarray(q)


def test_jacobi_rr_matches_pallas(mg_case):
    """B13's plain version vs `jacobi_pallas_rr(q, b, 4, scale=4)` in
    interpret mode at MG_SHAPE.  q: swept with XLA's multiply by fl32(1/6)
    (its compile of `/ 6.0`) the plane-sweep order reproduces the kernel
    bit for bit; with the port's true division, within 2e-6 of the scale.
    r_c within 1e-6 of its scale: XLA contracts `b - (s - 6q)` into an FMA
    (the JAX test allows 1e-5 and 1e-4)."""
    from fluidx12_tpu_torch.ops.sampling import neighbor_shift

    tq, tb, ref_q, ref_rc, _ = mg_case
    got_q, got_rc = tj.jacobi_rr(tq, tb, 4, scale=4.0)
    assert got_rc.shape == (12, 72, 128)
    np.testing.assert_allclose(got_q.numpy(), ref_q, atol=2e-6 * np.abs(ref_q).max(), rtol=0)
    np.testing.assert_allclose(got_rc.numpy(), ref_rc, atol=1e-6 * np.abs(ref_rc).max(),
                               rtol=0)
    sixth = torch.tensor(np.float32(1.0) / np.float32(6.0))
    q = tq
    (ax0, off0), *rest = tj._ORDERS[tj.ORDER_PLANEWISE]
    for _ in range(4):
        s = neighbor_shift(q, ax0, off0)
        for ax, off in rest:
            s = s + neighbor_shift(q, ax, off)
        q = (s - tb) * sixth
    np.testing.assert_array_equal(q.numpy(), ref_q)


def test_mg_solve_matches_tpu_chain(mg_case, monkeypatch):
    """The port's `mg_solve` at MG_SHAPE against the TPU's V-cycle
    (`mg_case`), each kernel's plain version called once (B4 twice, one
    of each order) and B5/B6 not at all: within 2e-6 of the scale (true
    division against XLA's reciprocal multiply, over 4 + 32 + 4 sweeps)."""
    calls = []
    for mod, name in ((tj, "jacobi_rr_plain"), (tj, "jacobi_plain"),
                      (tj, "jacobi_packed_plain"), (ts, "residual_plain"),
                      (ts, "prolong_correct_plain")):
        def spy(*args, _fn=getattr(mod, name), _name=name, **kwargs):
            calls.append((_name, tj.window_order(args[0].shape, 4)
                          if _name == "jacobi_plain" else None))
            return _fn(*args, **kwargs)

        monkeypatch.setattr(mod, name, spy)
    tq, tb, _, _, ref = mg_case
    got = tmg.mg_solve(tq, tb).numpy()
    assert sorted(calls, key=str) == sorted(
        [("jacobi_rr_plain", None), ("jacobi_plain", tj.ORDER_WINDOW),
         ("jacobi_plain", tj.ORDER_PLANEWISE), ("prolong_correct_plain", None)], key=str)
    np.testing.assert_allclose(got, ref, atol=2e-6 * np.abs(ref).max(), rtol=0)


def _smooth_density(rng, shape, hi=0.6):
    dens = rng.uniform(0, hi, shape).astype(np.float32)
    for ax in range(3):
        dens = (np.roll(dens, 1, ax) + dens + np.roll(dens, -1, ax)) / 3
    return dens


def test_gi_light_matches_pallas():
    """B16's plain version vs `gi_light_pallas` in interpret mode at
    (8, 16, 128): a smooth density with an empty slab (degenerate
    gradients take the radial fallback, sparse voxels the zero ambient), a
    rotated and scaled world, random SH coefficients.  Within 5e-6, the
    JAX test's tolerance for the kernel against its XLA chain."""
    rng = np.random.default_rng(3)
    shape = (8, 16, 128)
    assert ps.stencil_pallas_supported(shape)
    dens = _smooth_density(rng, shape)
    dens[2:5] = 0.0
    shadow = rng.uniform(0.2, 1.0, shape).astype(np.float32)
    ao = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    sh = rng.uniform(-0.1, 0.3, (9, 3)).astype(np.float32)
    rot = m3.rotation_roll_pitch_yaw(-0.4, 0.7)[:3, :3] * 10.0
    world3 = np.asarray(rot, np.float32)
    env = np.array([3.0, 2.1, 0.9], np.float32)
    ref = np.asarray(ps.gi_light_pallas(*(jnp.asarray(a) for a in (dens, shadow, ao, sh,
                                                                   world3, env)), 0.01))
    got = ts.gi_light(*(torch.from_numpy(a) for a in (dens, shadow, ao, sh, world3, env)),
                      0.01)
    assert got.shape == (3,) + shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-6, rtol=0)


def _jax_params(cfg):
    cam = OrbitCamera(width=64, height=64)
    world = m3.scaling(cfg.volume_scale)
    return default_scene_params(cfg)._replace(
        eye_pt=jnp.asarray(cam.eye), world=jnp.asarray(world),
        world_i=jnp.asarray(m3.inverse(world)))


def test_light_map_takes_b16_and_matches_tpu(monkeypatch):
    """The port's `render_light_map_fast` with the probe at grid
    (128, 128, 32), where the TPU takes B16 (the AO at half resolution),
    against JAX's composed as tests/test_pallas.py composes it: the shadow
    sweep, the AO and `gi_light_pallas` in interpret mode.  Within 5e-6;
    B16's plain version ran once and the XLA chain never."""
    cfg = FluidConfig(grid_size=(128, 128, 32), has_light_probe=True)
    tcfg = TorchConfig(grid_size=(128, 128, 32), has_light_probe=True)
    assert ps.stencil_pallas_supported(cfg.zyx) and jls._ao_half_res(cfg.zyx)
    assert not ps.stencil_pallas_supported(tuple(n // 2 for n in cfg.zyx))
    rng = np.random.default_rng(0)
    dens = _smooth_density(rng, cfg.zyx)
    grid = np.zeros((4,) + cfg.zyx, np.float32)
    grid[3] = dens
    grid[:3] = dens * 0.5
    p = _jax_params(cfg)
    sh = rng.uniform(0, 0.3, (9, 3)).astype(np.float32)

    @jax.jit
    def tpu_light_map(dt, p, sh):
        lp = np.asarray(cfg.light_pos, np.float32)
        major = int(np.argmax(np.abs(lp)))
        local_light = transform_vector(p.light_pt, p.world_i)
        ld = (local_light / jnp.linalg.norm(local_light)).astype(jnp.float32)
        ref_step = MAX_DIST / p.num_light_samples.astype(jnp.float32)
        shadow = jls.directional_transmittance(dt, ld, major, ref_step, cfg.absorption,
                                               flip=bool(lp[major] > 0))
        shadow = jnp.where(dt >= cfg.zero_threshold, shadow, 1.0)
        ao = jls._ambient_occlusion(dt, None, None, None, ref_step, cfg)
        return ps.gi_light_pallas(dt, shadow, ao, sh, p.world[:3, :3],
                                  p.light_color[:3] * p.light_color[3], cfg.zero_threshold)

    ref = np.asarray(tpu_light_map(jnp.asarray(dens), p, jnp.asarray(sh)))

    calls = []
    plain = ts.gi_light_plain
    monkeypatch.setattr(ts, "gi_light_plain", lambda *a: calls.append(1) or plain(*a))
    monkeypatch.setattr(tls, "gi_ambient_from_parts", lambda *a: pytest.fail("chain ran"))
    got = tls.render_light_map_fast(torch.from_numpy(grid), _to_torch(p), tcfg,
                                    torch.from_numpy(sh))
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-6, rtol=0)


def test_light_map_chain_and_pooled_sweep_match_jax(monkeypatch):
    """Below the B16 gate (grid (32, 32, 32): 32 lanes) the GI ambient is
    the XLA chain: jnp.gradient, the radial fallback, the AO's six
    axis-aligned sweeps on the half-resolution field, the SH irradiance.
    With `_LAT_POOL_MIN` lowered to 16 in both packages the shadow also
    sweeps at half lateral resolution (`_pool2_lat` / `_unpool2_lat`).
    The port's light map against JAX's: within 5e-6 of the scale (f32
    summation order in the scan and the pooling)."""
    monkeypatch.setattr(jls, "_LAT_POOL_MIN", 16)
    monkeypatch.setattr(tls, "_LAT_POOL_MIN", 16)
    cfg = FluidConfig(grid_size=(32, 32, 32), has_light_probe=True)
    tcfg = TorchConfig(grid_size=(32, 32, 32), has_light_probe=True)
    assert not ps.stencil_pallas_supported(cfg.zyx)
    assert jls._lat_pooled_ok(cfg.zyx, 2) and tls._lat_pooled_ok(cfg.zyx, 2)
    assert jls._ao_levels(cfg.zyx) == tls._ao_levels(cfg.zyx) == 1
    rng = np.random.default_rng(5)
    dens = _smooth_density(rng, cfg.zyx)
    dens[:, :6] = 0.0
    grid = np.zeros((4,) + cfg.zyx, np.float32)
    grid[3] = dens
    grid[:3] = dens * 0.4
    p = _jax_params(cfg)
    sh = rng.uniform(0, 0.3, (9, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(functools.partial(jls.render_light_map_fast, config=cfg))(
        jnp.asarray(grid), p, sh_coeffs=jnp.asarray(sh)))
    got = tls.render_light_map_fast(torch.from_numpy(grid), _to_torch(p), tcfg,
                                    torch.from_numpy(sh))
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-6 * np.abs(ref).max(), rtol=0)


GI_GATE_GRIDS = [(256, 256, 256), (32, 128, 128), (16, 128, 128), (24, 24, 24),
                 (32, 384, 384), (32, 256, 256), (64, 64, 64), (256, 256, 128)]


@pytest.mark.parametrize("zyx", GI_GATE_GRIDS, ids=lambda z: "x".join(map(str, z)))
def test_gi_gates_match_jax(zyx):
    """The GI branch's copied gates give the JAX originals' answers."""
    assert tls._ao_half_res(zyx) == jls._ao_half_res(zyx)
    assert tls._ao_levels(zyx) == jls._ao_levels(zyx)
    for arr_axis in range(3):
        assert tls._lat_pooled_ok(zyx, arr_axis) == jls._lat_pooled_ok(zyx, arr_axis)


@pytest.fixture(scope="module")
def radiance():
    return np.load(PROBE)["radiance"].astype(np.float32)


@pytest.fixture(scope="module")
def jax_sh(radiance):
    """JAX's SH coefficients of the in-repo probe, (9, 3)."""
    return jax.jit(jsh.project_cubemap_sh, static_argnums=1)(jnp.asarray(radiance), 3)


def test_project_cubemap_sh_matches_jax(radiance, jax_sh):
    """`project_cubemap_sh` of the in-repo probe (6, 256, 256, 3): the nine
    coefficients within 2e-6 of their scale (a sum of 393,216 f32 products
    in another order), the basis and texel directions within 1e-6."""
    ref = np.asarray(jax_sh)
    got = tsh.project_cubemap_sh(torch.from_numpy(radiance), 3).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-6 * np.abs(ref).max(), rtol=0)
    dirs = np.asarray(jsh.cube_texel_directions(8))
    np.testing.assert_array_equal(tsh.cube_texel_directions(8).numpy(), dirs)
    unit = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    for order in (1, 3, 5):
        ref = jax.jit(jsh.sh_eval_basis, static_argnums=0)(order, jnp.asarray(unit))
        np.testing.assert_allclose(tsh.sh_eval_basis(order, torch.from_numpy(unit)).numpy(),
                                   np.asarray(ref), atol=1e-6, rtol=0)


def test_render_environment_matches_jax(radiance):
    """The sky at a 64^2 viewport from the default camera and from an
    orbited one, against JAX's `render_environment` compiled as its engine
    compiles it (`jax.jit`): within 1e-6 of the radiance's scale.  Both
    fetch the probe through bf16 texels with an f32 filter (run eagerly,
    JAX would round the two texel differences to bf16, up to 3.6e-3
    here)."""
    from fluidx12_tpu.core.state import pack_scene_params_host, unpack_scene_params
    from fluidx12_tpu_torch.core.state import unpack_scene_params as t_unpack

    cfg = FluidConfig(grid_size=(24, 24, 24), viewport=(64, 64), has_light_probe=True)
    tcfg = TorchConfig(grid_size=(24, 24, 24), viewport=(64, 64), has_light_probe=True)
    env = jax.jit(lambda rad, flat: jenv.render_environment(rad, unpack_scene_params(flat),
                                                             cfg))
    for dx, dy in ((0.0, 0.0), (180.0, 60.0)):
        cam = OrbitCamera(width=64, height=64)
        cam.orbit(dx, dy)
        world = m3.scaling(cfg.volume_scale)
        flat = pack_scene_params_host(
            0.0, 0, np.asarray(cam.eye, np.float32), np.array(cfg.light_pos, np.float32),
            np.array(cfg.light_color, np.float32), np.array(cfg.ambient, np.float32),
            world, m3.inverse(world), world @ cam.view_proj,
            m3.inverse(world @ cam.view_proj), m3.inverse(cam.view_proj),
            cfg.max_ray_samples, cfg.max_light_samples, 63)
        ref = np.asarray(env(jnp.asarray(radiance), jnp.asarray(flat)))
        got = tenv.render_environment(torch.from_numpy(radiance),
                                      t_unpack(torch.from_numpy(flat)), tcfg).numpy()
        assert got.shape == (64, 64, 3)
        np.testing.assert_allclose(got, ref, atol=1e-6 * np.abs(radiance).max(), rtol=0)


_GI_GOLDEN = dict(grid_size=(24, 24, 24), viewport=(64, 64), max_ray_samples=32,
                  max_light_samples=8, num_pressure_iters=16, has_light_probe=True)


@pytest.fixture(scope="module")
def fluidgi_run(radiance):
    """tests/test_golden.py's `fluidgi` case (24^3 grid, 64^2 viewport, 32
    ray / 8 light samples, 16 Jacobi sweeps, the in-repo probe) run for its
    35 frames by the port: (engine, last image)."""
    engine = FluidXEngine(TorchConfig(**_GI_GOLDEN), radiance=radiance, device="cpu")
    for _ in range(35):
        img = engine.step_frame()
    return engine, img


def test_fluidgi_golden_case_renders_as_jax(fluidgi_run, radiance, jax_sh):
    """The `fluidgi` case's last image against JAX's `render_frame`, jitted
    as the JAX engine runs it, of the same state with JAX's own SH
    coefficients and sky.  Within 1 u8 level, mean below 0.02: the GI
    render (light map with the SH ambient and AO, march, resolve, sky) is
    JAX's.  The port's 35th frame against the committed golden itself
    misses pytest's 1% gate (1.03% of channels off by more than 25, mean
    1.17): the simulation seams C1 and C2 of ROADMAP.md, not the render."""
    from fluidx12_tpu.core.config import RenderMethod as JaxMethod
    from fluidx12_tpu.core.state import unpack_scene_params
    from fluidx12_tpu.render.pipeline import render_frame

    cfg = FluidConfig(**_GI_GOLDEN)
    engine, img = fluidgi_run
    packed, lod, vis_mask = engine.update_frame()
    params = unpack_scene_params(jnp.asarray(packed.numpy()))
    sh = jax_sh[:9]
    sky = jax.jit(jenv.render_environment, static_argnums=2)(jnp.asarray(radiance), params,
                                                             cfg)
    render = jax.jit(functools.partial(
        render_frame, config=cfg, method=JaxMethod.RAY_MARCH_SEPARATE, lod=lod,
        vis_mask=vis_mask, rect=engine._screen_rect()))
    grid = jnp.asarray(engine.state.color.float().numpy()).astype(jnp.bfloat16)
    ref = np.asarray(render(grid, params, sh_coeffs=sh, env_bg=sky))
    diff = np.abs(to_srgb_u8(img).astype(np.int32) - to_srgb_u8(ref).astype(np.int32))
    assert diff.max() <= 1 and diff.mean() < 0.02, (diff.max(), diff.mean())


def test_golden_fluidgi_passes_the_device_gate(fluidgi_run):
    """The `fluidgi` case's last image against the committed golden under
    the gate the reference holds its own device output to (`bench.py
    --check`, bench.py:517): mean abs diff < 2.0 and fewer than 0.5% of
    pixel channels off by more than 60.  Not pytest's > 25 gate: the TPU's
    own route misses that one too (ROADMAP.md C1: its clamping kernels
    land at 1.35% of channels off by more than 25 when emulated here, and
    the chip's own check measured mean 1.376), and the port's render of a
    state is JAX's within 1 u8 level (the test above), so the gap is the
    simulation's edge addressing, which follows the TPU kernels."""
    golden = read_png(os.path.join(os.path.dirname(__file__), "goldens", "fluidgi.png"))
    diff = np.abs(to_srgb_u8(fluidgi_run[1]).astype(np.int32) - golden.astype(np.int32))
    assert diff.mean() < 2.0, diff.mean()
    assert (diff > 60).mean() < 0.005, (diff > 60).mean()
