"""The port's faithful stack against the JAX package on the CPU: the
trilinear sampler, the gather advect (`fast_sim=False`), the per-voxel
light map and the per-ray marches (render/lightmap.py, raycast.py,
cubemap.py: kernels R1 and R2's plain versions here), and whole engine
frames with `fast_render=False, fast_sim=False`, with the eye inside the
volume, with a point light inside it, and across `toggle_ez`.

Inputs are made with numpy from a seed; each JAX reference is jitted once.
The marches' f32 outputs agree within 1e-5 except where a sample lands so
near zero_threshold or the box's edge that the two sides take the other
branch (XLA contracts some products into FMAs, which the port and the
kernels do not): at most 0.1% of them, and each test prints that count.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluidx12_tpu.core.config import FaceCullMode, FluidConfig, RenderMethod
from fluidx12_tpu.core.state import FluidState as JaxState
from fluidx12_tpu.core.state import unpack_scene_params
from fluidx12_tpu.engine import fluidx as jax_fluidx
from fluidx12_tpu.ops import sampling as jax_sampling
from fluidx12_tpu.ops.pallas import jacobi as pallas_jacobi
from fluidx12_tpu.ops.pallas import stencil as pallas_stencil
from fluidx12_tpu.ops.pallas.advect import backtrace_pallas, zpass_forces_supported
from fluidx12_tpu.render import cubemap as jax_cubemap
from fluidx12_tpu.render import lightmap as jax_lightmap
from fluidx12_tpu.render import raycast as jax_raycast
from fluidx12_tpu.sim.project import project as jax_project
from fluidx12_tpu_torch.core.config import FaceCullMode as TorchCull
from fluidx12_tpu_torch.core.config import FluidConfig as TorchConfig
from fluidx12_tpu_torch.core.config import RenderMethod as TorchMethod
from fluidx12_tpu_torch.core.state import unpack_scene_params as torch_unpack
from fluidx12_tpu_torch.engine import fluidx as torch_fluidx
from fluidx12_tpu_torch.ops.cuda import jacobi as torch_jacobi
from fluidx12_tpu_torch.ops.cuda import stencil as torch_stencil
from fluidx12_tpu_torch.ops import sampling as torch_sampling
from fluidx12_tpu_torch.render import cubemap as torch_cubemap
from fluidx12_tpu_torch.render import lightmap as torch_lightmap
from fluidx12_tpu_torch.render import raycast as torch_raycast
from fluidx12_tpu_torch.sim import advect as torch_advect
from fluidx12_tpu_torch.utils.compare import few_off
from fluidx12_tpu_torch.utils.image import to_srgb_u8

jax_advect = importlib.import_module("fluidx12_tpu.sim.advect")
torch_project = importlib.import_module("fluidx12_tpu_torch.sim.project").project

# Several pytest workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)

# tests/test_golden.py's 24^3 case: 64^2 viewport, 32 ray and 8 light
# samples, 16 Jacobi sweeps.
GOLDEN = dict(grid_size=(24, 24, 24), viewport=(64, 64), max_ray_samples=32,
              max_light_samples=8, num_pressure_iters=16)
FAITHFUL = dict(GOLDEN, fast_render=False, fast_sim=False)
# A point light inside the volume (light_pos / volume_scale < 1.1).
INTERIOR_LIGHT = dict(point_light=True, light_pos=(5.0, 2.0, -3.0))
# Moves the default camera's eye inside the volume.
DOLLY_INSIDE = 15.5


def channel_ulps(a, b) -> float:
    """Largest |a - b| per channel (leading axis) in bf16 ulps at the
    channel's scale."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    axes = tuple(range(1, a.ndim))
    mag = np.maximum(np.abs(a).max(axis=axes, keepdims=True),
                     np.abs(b).max(axis=axes, keepdims=True))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7.0)
    return float((np.abs(a - b) / ulp).max())


def _color_grid(zyx, seed):
    """A (4, Z, Y, X) bf16 colour grid: a smooth smoke blob (density up to
    0.6, some of it below zero_threshold) with rgb below its density, zero
    in the lowest quarter of y."""
    rng = np.random.default_rng(seed)
    dens = rng.uniform(0.0, 0.6, zyx).astype(np.float32)
    for ax in range(3):
        dens = (np.roll(dens, 1, ax) + dens + np.roll(dens, -1, ax)) / 3
    dens = np.maximum(dens - 0.15, 0.0) * 2.0
    dens[:, : zyx[1] // 4] = 0.0
    rgb = dens[None] * np.array([0.9, 0.7, 0.5], np.float32)[:, None, None, None]
    return torch.from_numpy(np.concatenate([rgb, dens[None]])).to(torch.bfloat16)


def _jax_bf16(t: torch.Tensor):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _sh(seed=4):
    return np.random.default_rng(seed).uniform(-0.4, 1.2, (9, 3)).astype(np.float32)


def _pose(inside: bool = False, **kw):
    """(port config, JAX config, port params, JAX params) of the default
    camera, or with its eye moved inside the volume."""
    jkw = {k: FaceCullMode(int(v)) if k == "face_cull" else v for k, v in kw.items()}
    tcfg, cfg = TorchConfig(**dict(GOLDEN, **kw)), FluidConfig(**dict(GOLDEN, **jkw))
    port = torch_fluidx.FluidXEngine(tcfg, device="cpu")
    if inside:
        port.camera.dolly(DOLLY_INSIDE)
    packed = port.update_frame()[0]
    return tcfg, cfg, torch_unpack(packed), unpack_scene_params(jnp.asarray(packed.numpy()))


# ---------------------------------------------------------------------------
# Pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["clamp", "mirror"])
def test_trilinear_sample_matches_jax(mode):
    """`trilinear_sample` equals the JAX package's bit for bit, CLAMP and
    MIRROR, on a (3, 5, 6, 7) field at coordinates inside, on the texel
    centres and edges, and far outside (down to -3 and up to 4): JAX's
    function run op by op, as the port runs it (jitted, XLA contracts the
    lerps into FMAs: within 1e-6 of it)."""
    rng = np.random.default_rng(1)
    field = rng.standard_normal((3, 5, 6, 7)).astype(np.float32)
    uvw = np.concatenate([rng.uniform(-3.0, 4.0, (300, 3)),
                          rng.uniform(0.0, 1.0, (300, 3)),
                          np.array([[0.0, 0.5, 1.0], [1.0, 0.0, 0.5], [-0.5 / 7, 1.0 / 12, 0.1],
                                    [1.0 + 0.5 / 7, 11.0 / 12, 0.9], [2.0, -1.0, 3.0]])]
                         ).astype(np.float32).reshape(121, 5, 3)
    jmode = getattr(jax_sampling.AddressMode, mode.upper())
    ref = np.asarray(jax_sampling.trilinear_sample(jnp.asarray(field), jnp.asarray(uvw), jmode))
    got = torch_sampling.trilinear_sample(torch.from_numpy(field), torch.from_numpy(uvw),
                                          getattr(torch_sampling.AddressMode, mode.upper()))
    assert got.shape == (3, 121, 5)
    np.testing.assert_array_equal(got.numpy(), ref)
    jitted = jax.jit(functools.partial(jax_sampling.trilinear_sample, mode=jmode))
    np.testing.assert_allclose(got.numpy(), jitted(jnp.asarray(field), jnp.asarray(uvw)),
                               atol=2e-6, rtol=0)
    got1 = torch_sampling.trilinear_sample(torch.from_numpy(field[0]), torch.from_numpy(uvw),
                                           getattr(torch_sampling.AddressMode, mode.upper()))
    np.testing.assert_array_equal(got1.numpy(), ref[0])


@pytest.mark.parametrize("grid", [(24, 24, 24), (64, 64, 1)], ids=["24", "2d"])
def test_advect_matches_jax(grid):
    """The faithful gather advect (backtrace, one 7-channel MIRROR gather,
    the forces) on a bf16 state with velocities of a few voxels a step:
    f32 outputs within one bf16 ulp of JAX's at each channel's scale."""
    cfg, tcfg = FluidConfig(grid_size=grid), TorchConfig(grid_size=grid)
    rng = np.random.default_rng(2)
    z, y, x = cfg.zyx
    fields = rng.uniform(-1.0, 1.0, (7, z, y, x)).astype(np.float32)
    fields[:3] *= 3.0 / np.float32(cfg.time_step * max(x, y))
    fields[3:] = np.abs(fields[3:])
    state = torch.from_numpy(fields).to(torch.bfloat16)
    dt = np.float32(cfg.time_step)
    ref = jax.jit(functools.partial(jax_advect.advect, config=cfg))(
        _jax_bf16(state[:3]), _jax_bf16(state[3:]), jnp.float32(dt))
    got = torch_advect.advect(state[:3], state[3:], torch.tensor(dt), tcfg)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        assert channel_ulps(g.numpy(), np.asarray(r)) <= 1.0


def test_small_pieces_match_jax():
    """`face_texel_local_positions`, `transform_point`,
    `evaluate_sh_irradiance` and `sample_at_cells` equal the JAX package's
    functions run op by op bit for bit."""
    from fluidx12_tpu.gi.sh import evaluate_sh_irradiance
    from fluidx12_tpu.ops.cubemap import face_texel_local_positions
    from fluidx12_tpu.ops.transform import transform_point
    from fluidx12_tpu_torch.gi import sh as torch_sh
    from fluidx12_tpu_torch.ops import cubemap as torch_cubemap_ops
    from fluidx12_tpu_torch.ops import transform as torch_transform

    np.testing.assert_array_equal(torch_cubemap_ops.face_texel_local_positions(12).numpy(),
                                  np.asarray(face_texel_local_positions(12)))
    rng = np.random.default_rng(3)
    p = rng.standard_normal((40, 3)).astype(np.float32)
    m = rng.standard_normal((4, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        torch_transform.transform_point(torch.from_numpy(p), torch.from_numpy(m)).numpy(),
        np.asarray(transform_point(jnp.asarray(p), jnp.asarray(m))))
    n = p / np.linalg.norm(p, axis=-1, keepdims=True)
    np.testing.assert_array_equal(
        torch_sh.evaluate_sh_irradiance(torch.from_numpy(_sh()), torch.from_numpy(n)).numpy(),
        np.asarray(evaluate_sh_irradiance(jnp.asarray(_sh()), jnp.asarray(n))))
    field = rng.standard_normal((2, 5, 6, 7)).astype(np.float32)
    idx = [rng.integers(0, n, (9, 4)) for n in (5, 6, 7)]
    for f in (field, field[0]):
        np.testing.assert_array_equal(
            torch_sampling.sample_at_cells(torch.from_numpy(f),
                                           *map(torch.from_numpy, idx)).numpy(),
            np.asarray(jax_sampling.sample_at_cells(jnp.asarray(f), *map(jnp.asarray, idx))))


def test_faithful_projection_route_matches_tpu_chain(monkeypatch):
    """With `fast_sim=False` the projection takes no multigrid: at zyx
    (64, 128, 128), where the TPU runs its kernels, B3, B4 once for all the
    sweeps with `jacobi_tuning`'s plan and B8, on the f32 fields the gather
    advect hands it.  The port's `project` calls exactly those plain
    versions and agrees with the chain of Pallas kernels (interpret mode):
    velocity within one bf16 ulp at each channel's scale, colour equal,
    pressure within 1e-5 * max|p| (8 sweeps, to keep interpret mode short)."""
    kw = dict(grid_size=(128, 128, 64), fast_sim=False, num_pressure_iters=8)
    cfg, tcfg = FluidConfig(**kw), TorchConfig(**kw)
    zyx = cfg.zyx
    tuning = pallas_jacobi.jacobi_tuning(zyx, 8)
    assert pallas_stencil.stencil_pallas_supported(zyx) and tuning is not None
    calls = []
    for mod, name in ((torch_stencil, "divergence_plain"), (torch_jacobi, "jacobi_plain"),
                      (torch_stencil, "grad_damp_plain"), (torch_stencil, "residual_plain"),
                      (torch_jacobi, "jacobi_packed_plain")):
        monkeypatch.setattr(mod, name, lambda *a, _f=getattr(mod, name), _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    rng = np.random.default_rng(11)
    f = rng.uniform(0.0, 1.0, (7,) + zyx).astype(np.float32)
    f[:3] = (f[:3] - 0.5) * 1.5
    q = (rng.standard_normal(zyx) * 0.05).astype(np.float32)

    @jax.jit
    def chain(jf, jq):
        b = pallas_stencil.divergence_pallas(jf)
        jq = pallas_jacobi.jacobi_pallas(jq, b, 8, *tuning)
        return pallas_stencil.grad_damp_pallas(jf, jq, cfg.fluid_density_3d), jq

    ref_f, ref_q = (np.asarray(a) for a in chain(jnp.asarray(f), jnp.asarray(q)))
    got_f, got_q = torch_project(torch.from_numpy(f.copy()), torch.from_numpy(q.copy()),
                                 cfg.time_step, tcfg)
    assert calls == ["divergence_plain", "jacobi_plain", "grad_damp_plain"]
    assert got_f.dtype == torch.float32
    assert channel_ulps(got_f[:3].numpy(), ref_f[:3]) <= 1.0
    np.testing.assert_array_equal(got_f[3:].numpy(), ref_f[3:])
    np.testing.assert_allclose(got_q.numpy(), ref_q, atol=1e-5 * np.abs(ref_q).max(), rtol=0)


# ---------------------------------------------------------------------------
# The marches
# ---------------------------------------------------------------------------

LIGHT_CASES = {"directional": ({}, False), "probe": (dict(has_light_probe=True), True),
               "interior_point": (INTERIOR_LIGHT, False)}


@pytest.mark.parametrize("case", list(LIGHT_CASES))
def test_light_map_matches_jax(case):
    """`render_light_map` (R2's plain version): a directional light, the
    same with the probe's SH irradiance and AO rays, and a point light
    inside the volume, against JAX's per-voxel scans."""
    kw, probe = LIGHT_CASES[case]
    tcfg, cfg, tparams, params = _pose(**kw)
    grid = _color_grid(cfg.zyx, seed=5)
    sh = _sh() if probe else None
    ref = jax.jit(functools.partial(jax_lightmap.render_light_map, config=cfg))(
        _jax_bf16(grid), params, sh_coeffs=None if sh is None else jnp.asarray(sh))
    got = torch_lightmap.render_light_map(grid, tparams, tcfg,
                                          None if sh is None else torch.from_numpy(sh))
    assert got.shape == (3, 24, 24, 24)
    assert few_off(got, ref, f"light map, {case}")[0]


# (merged, probe, eye inside, a light map at half the grid's lateral size)
DIRECT_CASES = {"separate": (False, False, False, False), "merged": (True, False, False, False),
                "merged_probe_inside": (True, True, True, False),
                "separate_probe_inside": (False, True, True, False),
                "separate_half_map_inside": (False, False, True, True)}


@pytest.mark.parametrize("case", list(DIRECT_CASES))
def test_ray_cast_direct_matches_jax(case):
    """`ray_cast_direct` (R1's plain version at viewport resolution):
    separate (the light map given) and merged (shadow rays per sample),
    without the probe from the default camera, with it (SH and AO rays)
    from an eye inside the volume; and separate from inside on a light map
    of other dims than the grid's, (3, Z, Y/2, X/2): the march reads the
    map at its own dims."""
    merged, probe, inside, half = DIRECT_CASES[case]
    tcfg, cfg, tparams, params = _pose(inside=inside, has_light_probe=probe)
    grid = _color_grid(cfg.zyx, seed=6)
    sh = _sh() if probe else None
    light_map = None
    if not merged:
        light_map = torch_lightmap.render_light_map(
            grid, tparams, tcfg, None if sh is None else torch.from_numpy(sh))
    if half:
        z, y, x = cfg.zyx
        light_map = light_map.reshape(3, z, y // 2, 2, x // 2, 2).mean(dim=(3, 5))
    ref = jax.jit(functools.partial(jax_raycast.ray_cast_direct, config=cfg))(
        _jax_bf16(grid), params,
        light_map=None if light_map is None else jnp.asarray(light_map.numpy()),
        sh_coeffs=None if sh is None else jnp.asarray(sh))
    got = torch_raycast.ray_cast_direct(grid, tparams, tcfg, light_map=light_map,
                                        sh_coeffs=None if sh is None else torch.from_numpy(sh))
    assert got.shape == (64, 64, 4) and float(got[..., 3].max()) > 0.05
    assert few_off(got, ref, f"ray_cast_direct, {case}")[0]


@pytest.mark.parametrize("cull", ["mask", "none"])
def test_ray_march_cube_matches_jax(cull):
    """`ray_march_cube` (R1's plain version on the 6 x 24^2 cube texels):
    under FaceCullMode.MASK with the separate light map (the host mask's
    faces), and under FaceCullMode.NONE merged (the in-graph eye-side
    test), at lod 0; the cube map quantized to 8 bits on both sides."""
    none = cull == "none"
    tcfg, cfg, tparams, params = _pose(**dict(face_cull=TorchCull.NONE) if none else {})
    grid = _color_grid(cfg.zyx, seed=7)
    light_map = None if none else torch_lightmap.render_light_map(grid, tparams, tcfg)
    ref = jax.jit(functools.partial(jax_cubemap.ray_march_cube, config=cfg))(
        _jax_bf16(grid), params,
        light_map=None if light_map is None else jnp.asarray(light_map.numpy()))
    got = torch_cubemap.ray_march_cube(grid, tparams, tcfg, light_map=light_map)
    assert got.shape == (6, 24, 24, 4)
    visible = np.asarray(got).reshape(6, -1).max(-1) > 0
    assert 2 <= visible.sum() <= 4
    assert few_off(got, ref, f"ray_march_cube, {cull}")[0]


# ---------------------------------------------------------------------------
# Engine frames
# ---------------------------------------------------------------------------

def _jax_simulate(state, time_step, config):
    """The JAX step as the port computes it: the faithful gather advect,
    or with `fast_sim` the advect kernels as its TPU runs them (interpret
    mode; the port clamps at the walls as they do, ROADMAP.md C1); then
    the projection."""
    if not config.fast_sim:
        return _JAX_SIMULATE(state, time_step, config)
    if zpass_forces_supported(config):
        fields = backtrace_pallas(state.fields, time_step, config, forces_dt=time_step)
    else:
        bt = backtrace_pallas(state.fields, time_step, config)
        vel, col = jax_advect.apply_impulse_forces(bt[:3], bt[3:], time_step, config)
        fields = jnp.concatenate([vel, col])
    fields, pressure = jax_project(fields, state.pressure, time_step, config)
    return JaxState(fields=fields.astype(state.fields.dtype), pressure=pressure)


_JAX_SIMULATE = jax_fluidx.simulate

# name: (config fields, render method, eye inside the volume)
FRAMES = {
    "faithful_direct": (FAITHFUL, TorchMethod.RAY_MARCH_DIRECT_SEPARATE, False),
    # The fast render stack; the simulation is the faithful one on both
    # sides, so that the walls' addressing agrees.
    "eye_inside": (dict(GOLDEN, fast_sim=False), TorchMethod.RAY_MARCH_DIRECT_MERGED, True),
    "interior_point": (dict(GOLDEN, fast_sim=False, **INTERIOR_LIGHT),
                       TorchMethod.RAY_MARCH_SEPARATE, False),
}
WARMUP = 4
K = 2


def _engines(kw, method, inside):
    """A port engine after WARMUP frames from rest, and a JAX engine of
    the same config, pose, method and state."""
    port = torch_fluidx.FluidXEngine(TorchConfig(**kw), device="cpu")
    port.render_method = method
    if inside:
        port.camera.dolly(DOLLY_INSIDE)
    for _ in range(WARMUP):
        port.step_frame()
    jeng = jax_fluidx.FluidXEngine(FluidConfig(**kw))
    jeng.render_method = RenderMethod(int(method))
    jeng.camera.view, jeng.camera.eye = port.camera.view.copy(), port.camera.eye.copy()
    _sync(jeng, port)
    return port, jeng


def _sync(jeng, port):
    """The JAX engine's state and frame index set to the port's.  Copies:
    jnp.asarray may alias a numpy view of the port's buffers, which the
    port's frames write in place."""
    jeng.state = JaxState(fields=_jax_bf16(port.state.fields),
                          pressure=jnp.array(port.state.pressure.numpy().copy()))
    jeng.frame_index = port.frame_index


def _same_frame(port_img, jax_img, port, jeng, what):
    """The image within 2 u8 levels of JAX's (mean below 0.05) and the
    state within 3 bf16 ulps at each channel's scale, as the port's other
    engine tests hold them."""
    diff = np.abs(to_srgb_u8(port_img).astype(int) - to_srgb_u8(np.asarray(jax_img)).astype(int))
    ulps = channel_ulps(port.state.fields.float().numpy(),
                        np.asarray(jeng.state.fields.astype(jnp.float32)))
    print(f"{what}: image max u8 diff {diff.max()}, mean {diff.mean():.4f}; "
          f"fields {ulps:.2f} bf16 ulp")
    assert diff.max() <= 2 and diff.mean() < 0.05 and ulps <= 3.0


@pytest.mark.parametrize("name", list(FRAMES))
def test_engine_frames_match_jax(name, monkeypatch):
    """K engine frames of the faithful stack (`fast_render=False,
    fast_sim=False`) under a DIRECT method (a cube method's faithful frames:
    test_toggle_ez_matches_jax), of a DIRECT method with the eye inside the
    volume, and of a point light inside the volume (the cube path,
    faithful), against the JAX engine's frames from the same state.  None
    raises; the eye-inside pose has no base plane."""
    kw, method, inside = FRAMES[name]
    port, jeng = _engines(kw, method, inside)
    monkeypatch.setattr(jax_fluidx, "simulate", _jax_simulate)
    if inside:
        assert port._direct_plane_spec(0) is None and jeng._direct_plane_spec(0) is None
    for k in range(K):
        _same_frame(port.step_frame(), jeng.step_frame(), port, jeng, f"{name}, frame {k}")


def test_toggle_ez_matches_jax(monkeypatch):
    """`toggle_ez` flips `fast_render` and `fast_sim` together, drops the
    captured graphs and returns the new state, and the port's frames follow
    the JAX engine's frame for frame: one faithful frame of the separate
    cube method, toggle, one fast frame, each from the port's state (the
    fast frame's own seam, B2's expf, is test_torch_engine_program's to
    hold); toggling back restores the faithful stack, whose frames
    test_engine_frames_match_jax holds."""
    port, jeng = _engines(FAITHFUL, TorchMethod.RAY_MARCH_SEPARATE, False)
    monkeypatch.setattr(jax_fluidx, "simulate", _jax_simulate)
    for k in range(2):
        if k:
            port._graphs[("a key",)] = None
            assert port.toggle_ez() is True and jeng.toggle_ez() is True
            assert port.config.fast_render and port.config.fast_sim and port._graphs == {}
        _sync(jeng, port)
        _same_frame(port.step_frame(), jeng.step_frame(), port, jeng, f"toggle_ez, frame {k}")
    port._graphs[("a key",)] = None
    assert port.toggle_ez() is False and port._graphs == {}
    assert not port.config.fast_render and not port.config.fast_sim
    assert port.step_frame().shape == (64, 64, 3)
