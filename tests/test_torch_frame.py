"""The port's slice as a whole -- `FluidXEngine.step_frame` of the
separate-light cube path -- against the JAX package on the CPU."""

import dataclasses
import functools
import importlib
import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluidx12_tpu.core.config import FluidConfig, RenderMethod
from fluidx12_tpu.core.state import unpack_scene_params
from fluidx12_tpu.ops.pallas import composite as jax_composite
from fluidx12_tpu.ops.pallas.advect import backtrace_pallas, zpass_forces_supported
from fluidx12_tpu.render import slicecomp as jax_slicecomp
from fluidx12_tpu.render.pipeline import render_frame
from fluidx12_tpu_torch.core.config import FluidConfig as TorchConfig
from fluidx12_tpu_torch.engine import fluidx as torch_fluidx
from fluidx12_tpu_torch.utils.image import to_srgb_u8
from fluidx12_tpu_torch.utils.png import read_png

jax_project = importlib.import_module("fluidx12_tpu.sim.project").project

# Several pytest workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)

GOLDEN_2D = os.path.join(os.path.dirname(__file__), "goldens", "fluid2d.png")


def channel_ulps(a, b) -> float:
    """Largest |a - b| per channel in bf16 ulps at the channel's scale."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    axes = tuple(range(1, a.ndim))
    mag = np.maximum(np.abs(a).max(axis=axes, keepdims=True),
                     np.abs(b).max(axis=axes, keepdims=True))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7.0)
    return float((np.abs(a - b) / ulp).max())


def test_frame_matches_kernel_semantics_jax_frame(monkeypatch):
    """(a) Grid (128, 128, 16), 64^2 viewport, pallas_jacobi=False.  The
    port runs 6 frames from rest to raise a plume; from that state 2 frames
    of the port's `step_frame` run against the JAX frame composed from its
    kernels: `backtrace_pallas` (interpret) + `project` + `render_frame`
    at lod 0 with the fused march kernel forced on (`_FUSED_ON_CPU`, the
    package's own test hook), so the X and Y faces ride
    `composite_resample_pallas`; the Z face's 16-slice stack rides the
    einsum twin there, while the port's B10 marches every face.

    Tolerances: fields within 3 bf16 ulps at each channel's scale after 2
    frames (per frame one ulp from the port's f32 hand-off between B1 and
    B2 and one from the projection, tests/test_torch_sim.py); image within
    2 u8 levels, mean below 0.05 (the Z face's einsum twin agrees with the
    kernel within 2e-3, which can move a quantized cube texel one level).
    """
    kw = dict(grid_size=(128, 128, 16), viewport=(64, 64), pallas_jacobi=False)
    cfg, tcfg = FluidConfig(**kw), TorchConfig(**kw)
    assert zpass_forces_supported(cfg)
    monkeypatch.setattr(jax_slicecomp, "_FUSED_ON_CPU", True)
    traced_faces = []
    fused = jax_composite.composite_resample_pallas

    def spy(volf, *args, **kwargs):
        traced_faces.append(volf.shape)
        return fused(volf, *args, **kwargs)

    monkeypatch.setattr(jax_composite, "composite_resample_pallas", spy)
    monkeypatch.setattr(torch_fluidx, "estimate_cube_map_lod",
                        lambda *a, **k: (0, cfg.max_ray_samples))

    port = torch_fluidx.FluidXEngine(tcfg, device="cpu")
    for _ in range(6):
        port.step_frame()
    fields = jnp.asarray(port.state.fields.float().numpy()).astype(jnp.bfloat16)
    pressure = jnp.asarray(port.state.pressure.numpy())
    packed, lod, vis_mask = port.update_frame()
    assert lod == 0
    rect = port._screen_rect()
    params = unpack_scene_params(jnp.asarray(packed.numpy()))
    dt = cfg.time_step

    @jax.jit
    def jax_sim(f, q):
        f = backtrace_pallas(f, dt, cfg, forces_dt=dt)
        f, q = jax_project(f, q, jnp.float32(dt), cfg)
        return f.astype(jnp.bfloat16), q

    jax_render = jax.jit(functools.partial(
        render_frame, config=cfg, method=RenderMethod.RAY_MARCH_SEPARATE,
        lod=0, vis_mask=vis_mask, rect=rect))

    for _ in range(2):
        fields, pressure = jax_sim(fields, pressure)
        ref_img = jax_render(fields[3:], params)
        img = port.step_frame()

    # Pin JAX's path: the fused march kernel served the X and Y faces
    # (128 slices each); the Z face (16 slices) stayed on the einsum twin.
    assert sorted(shape[1] for shape in traced_faces) == [128, 128, 128]
    got_f = port.state.fields.float().numpy()
    assert channel_ulps(got_f, np.asarray(fields.astype(jnp.float32))) <= 3.0
    assert img.shape == (64, 64, 3)
    diff = np.abs(to_srgb_u8(img).astype(int) - to_srgb_u8(np.asarray(ref_img)).astype(int))
    assert diff.max() <= 2 and diff.mean() < 0.05, (diff.max(), diff.mean())


@pytest.fixture(scope="module")
def golden_3d():
    """tests/test_golden.py's 24^3 cube-map case (24^3 grid, 64^2 viewport,
    32 ray / 8 light samples, 16 Jacobi sweeps) run for its 35 frames by
    the port: (engine, last image).  The render method does not touch the
    simulation, so the separate and merged cases share the run."""
    cfg = TorchConfig(grid_size=(24, 24, 24), viewport=(64, 64), max_ray_samples=32,
                      max_light_samples=8, num_pressure_iters=16)
    engine = torch_fluidx.FluidXEngine(cfg, device="cpu")
    for _ in range(35):
        img = engine.step_frame()
    return engine, img


def _golden_diff(img, name):
    golden = read_png(os.path.join(os.path.dirname(__file__), "goldens", f"{name}.png"))
    return np.abs(to_srgb_u8(img).astype(np.int32) - golden.astype(np.int32))


def test_golden_fluid3d_separate(golden_3d):
    """(b) The port renders tests/test_golden.py's `fluid3d_separate` case
    and passes that test's gates against the committed golden: mean abs
    diff < 2.0 and fewer than 1% of pixel channels off by more than 25."""
    diff = _golden_diff(golden_3d[1], "fluid3d_separate")
    assert diff.mean() < 2.0, diff.mean()
    assert (diff > 25).mean() < 0.01, (diff > 25).mean()


def test_golden_fluid3d_merged(golden_3d):
    """tests/test_golden.py's `fluid3d_merged` case (RAY_MARCH_MERGED, the
    same grid and frames): the port renders the 35th frame's state with
    that method, as its step_frame would, and passes test_golden.py's gates
    (mean < 2.0, fewer than 1% of channels off by more than 25)."""
    from fluidx12_tpu_torch.core.config import RenderMethod as TorchMethod
    from fluidx12_tpu_torch.core.state import unpack_scene_params as torch_unpack
    from fluidx12_tpu_torch.render.pipeline import render_frame as torch_render

    engine = golden_3d[0]
    packed, lod, vis_mask = engine.update_frame()
    params = torch_unpack(packed)
    img = torch_render(engine.state.color, params, engine.config, TorchMethod.RAY_MARCH_MERGED,
                       engine.sh_coeffs, lod=lod, vis_mask=vis_mask,
                       rect=engine._screen_rect(), env_bg=engine._env_bg(params))
    diff = _golden_diff(img, "fluid3d_merged")
    assert diff.mean() < 2.0, diff.mean()
    assert (diff > 25).mean() < 0.01, (diff > 25).mean()


def test_golden_fluid3d_direct(golden_3d):
    """tests/test_golden.py's `fluid3d_direct` case (RAY_MARCH_DIRECT_MERGED,
    the same grid and frames): the port renders the 35th frame's state
    with that method through the engine's base plane (the (256, 256) plane
    of face Z+, resampled with zero-outside weights and composited by B17,
    as the TPU's gates route it) and passes test_golden.py's gates (mean <
    2.0, fewer than 1% of channels off by more than 25)."""
    from fluidx12_tpu_torch.core.config import RenderMethod as TorchMethod
    from fluidx12_tpu_torch.core.state import unpack_scene_params as torch_unpack
    from fluidx12_tpu_torch.render.pipeline import render_frame as torch_render
    from fluidx12_tpu_torch.render.slicecomp import plane_kernel

    engine = golden_3d[0]
    packed, lod, vis_mask = engine.update_frame()
    spec = engine._direct_plane_spec(lod)
    assert plane_kernel(engine.config, spec.face_id, spec.res) == "B17"
    img = torch_render(engine.state.color, torch_unpack(packed), engine.config,
                       TorchMethod.RAY_MARCH_DIRECT_MERGED, engine.sh_coeffs, lod=lod,
                       vis_mask=vis_mask, plane_spec=spec, rect=engine._screen_rect())
    diff = _golden_diff(img, "fluid3d_direct")
    assert diff.mean() < 2.0, diff.mean()
    assert (diff > 25).mean() < 0.01, (diff > 25).mean()


def test_golden_fluid2d():
    """(c) The port renders tests/test_golden.py's `fluid2d` case (64^2
    grid and viewport, 16 Jacobi sweeps, 40 frames) and passes that test's
    gates against the committed golden.  B11 advects it; B14's gate needs
    a multiple of 128 lanes, so the twin sweeps run, as on the TPU.  The
    JAX golden mirrors at the walls and the port clamps (ROADMAP.md C1)."""
    cfg = TorchConfig(grid_size=(64, 64, 1), viewport=(64, 64), num_pressure_iters=16)
    engine = torch_fluidx.FluidXEngine(cfg, device="cpu")
    for _ in range(40):
        img = engine.step_frame()
    diff = np.abs(to_srgb_u8(img).astype(np.int32) - read_png(GOLDEN_2D).astype(np.int32))
    assert diff.mean() < 2.0, diff.mean()
    assert (diff > 25).mean() < 0.01, (diff > 25).mean()


def test_unported_configs_raise():
    """What the port does not cover raises NotImplementedError naming its
    ROADMAP item, instead of running another path: `cube_cast_blocked`
    (`block_resolve=True`, 'Do not port'), at construction and again in
    `render_frame`.  Everything else runs: the switches that select the
    JAX package's XLA twins (`use_pallas=False`, `pallas_advect=False`: the
    mirror- and clamp-addressed advect twins, the einsum sweep and march;
    tests/test_torch_twins.py holds them to JAX) in the engine, in
    `simulate` and in `render_frame`, and the faithful simulation and
    render stacks, in 3D and 2D: `fast_render=False`, `fast_sim=False`, a
    point light inside the volume, and a DIRECT frame with the eye inside
    the volume (tests/test_torch_faithful.py holds them to JAX).  The
    default preset (pallas_jacobi=True), the 2D preset, GI and every kernel
    the JAX gates choose (B15 and B18 among them) are covered, and so are
    `advect_fuse_xy=False` (B11 twice, tests/test_torch_padded.py), a point
    light outside the volume and the fast DIRECT methods
    (tests/test_torch_direct.py)."""
    from fluidx12_tpu_torch.core.config import PRESETS
    from fluidx12_tpu_torch.core.state import make_initial_state, unpack_scene_params
    from fluidx12_tpu_torch.render.pipeline import render_frame as torch_render
    from fluidx12_tpu_torch.sim.step import simulate

    torch_fluidx.FluidXEngine(PRESETS["fluid3d"], device="cpu")
    torch_fluidx.FluidXEngine(dataclasses.replace(PRESETS["fluid3d"], advect_fuse_xy=False),
                              device="cpu")
    torch_fluidx.FluidXEngine(dataclasses.replace(PRESETS["fluid3d"], point_light=True),
                              device="cpu")
    base = TorchConfig(grid_size=(24, 24, 24), viewport=(32, 32), max_ray_samples=16,
                       max_light_samples=4, num_pressure_iters=4)
    for change in (dict(grid_size=(64, 64, 1), fast_sim=False), dict(fast_render=False),
                   dict(point_light=True, light_pos=(5.0, 2.0, -3.0)), dict(fast_sim=False),
                   dict(use_pallas=False), dict(pallas_advect=False),
                   dict(grid_size=(64, 64, 1), use_pallas=False),
                   dict(use_pallas=False, point_light=True)):
        engine = torch_fluidx.FluidXEngine(dataclasses.replace(base, **change), device="cpu")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            img = engine.step_frame()
        assert img.shape == (32, 32, 3) and bool(torch.isfinite(img).all()), change
        # Only the interior point light on the fast stack warns (once).
        assert len(caught) == int(change.get("light_pos") == (5.0, 2.0, -3.0)), (change, caught)
    with pytest.raises(NotImplementedError, match="ROADMAP.md, 'Do not port'"):
        torch_fluidx.FluidXEngine(dataclasses.replace(base, block_resolve=True), device="cpu")
    engine = torch_fluidx.FluidXEngine(base, device="cpu")
    state = make_initial_state(base, "cpu")
    params = unpack_scene_params(engine.update_frame()[0])
    for change in (dict(use_pallas=False), dict(pallas_advect=False)):
        out = simulate(state, base.time_step, dataclasses.replace(base, **change))
        assert out.fields.dtype == base.sim_dtype and bool(torch.isfinite(out.fields).all())
    img = torch_render(state.color, params, dataclasses.replace(base, use_pallas=False),
                       torch_fluidx.RenderMethod.RAY_MARCH_SEPARATE)
    assert img.shape == (32, 32, 3)
    with pytest.raises(NotImplementedError, match="ROADMAP.md, 'Do not port'"):
        torch_render(state.color, params, dataclasses.replace(base, block_resolve=True),
                     torch_fluidx.RenderMethod.RAY_MARCH_SEPARATE)
    # The DIRECT methods render; with the eye inside the volume (no base
    # plane) they take the faithful march, in the engine and in
    # render_frame.
    for method in (torch_fluidx.RenderMethod.RAY_MARCH_DIRECT_SEPARATE,
                   torch_fluidx.RenderMethod.RAY_MARCH_DIRECT_MERGED):
        engine.render_method = method
        assert engine.step_frame().shape == (32, 32, 3)
        pose = engine.camera.view, engine.camera.eye
        engine.camera.view, engine.camera.eye = pose[0].copy(), pose[1].copy()
        engine.camera.dolly(15.5)
        assert engine._direct_plane_spec(0) is None
        assert engine.step_frame().shape == (32, 32, 3)
        assert torch_render(state.color, params, base, method,
                            plane_spec=None).shape == (32, 32, 3)
        engine.camera.view, engine.camera.eye = pose
