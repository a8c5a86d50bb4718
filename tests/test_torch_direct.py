"""The port's fast DIRECT render methods (render/screencomp.py: the base
plane's geometry, the plane march with B10's zero-outside mode or the
zero-outside resample and B17, the warp) and the projective point-light
sweep (render/lightmap_sweep.point_transmittance) against the JAX package
on the CPU.  Inputs are made with numpy from a seed; each JAX reference is
jitted and built once.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluidx12_tpu.core import math3d as m3
from fluidx12_tpu.core.config import FluidConfig, RenderMethod
from fluidx12_tpu.core.state import unpack_scene_params
from fluidx12_tpu.ops.pallas import composite as jax_composite
from fluidx12_tpu.render import lightmap_sweep as jax_sweep
from fluidx12_tpu.render import screencomp as jax_screen
from fluidx12_tpu.render import slicecomp as jax_slicecomp
from fluidx12_tpu.render.pipeline import render_frame
from fluidx12_tpu_torch.core.camera import OrbitCamera
from fluidx12_tpu_torch.core.config import FluidConfig as TorchConfig
from fluidx12_tpu_torch.core.config import RenderMethod as TorchMethod
from fluidx12_tpu_torch.core.state import unpack_scene_params as torch_unpack
from fluidx12_tpu_torch.engine import fluidx as torch_fluidx
from fluidx12_tpu_torch.ops.transform import transform_point_h
from fluidx12_tpu_torch.render import lightmap_sweep as torch_sweep
from fluidx12_tpu_torch.render import screencomp as torch_screen
from fluidx12_tpu_torch.render import slicecomp as torch_slicecomp
from fluidx12_tpu_torch.render.pipeline import render_frame as torch_render
from fluidx12_tpu_torch.render.raymarch_core import MAX_DIST
from fluidx12_tpu_torch.utils.image import to_srgb_u8

# Several pytest workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)

SMALL = dict(viewport=(64, 64), max_ray_samples=32, max_light_samples=8)


def _color_grid(zyx, seed):
    """A (4, Z, Y, X) bf16 colour grid: a smooth smoke blob (density up to
    0.6) with rgb below its density, zero in the lowest quarter of y."""
    rng = np.random.default_rng(seed)
    dens = rng.uniform(0.0, 0.6, zyx).astype(np.float32)
    for ax in range(3):
        dens = (np.roll(dens, 1, ax) + dens + np.roll(dens, -1, ax)) / 3
    dens[:, : zyx[1] // 4] = 0.0
    grid = np.concatenate([dens[None] * np.array([0.9, 0.7, 0.5], np.float32)[:, None, None,
                                                                               None],
                           dens[None]])
    return torch.from_numpy(grid).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# Pieces: the zero-outside weights, the plane's geometry, the fetch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("zero_outside", [False, True])
def test_interp_weights_match_jax(zero_outside):
    """`_interp_weights` equals the JAX package's, bit for bit, on
    coordinates straddling -0.5 and n - 0.5 (and far outside)."""
    rng = np.random.default_rng(3)
    n = 24
    coords = np.concatenate([rng.uniform(-3.0, n + 2.0, (5, 40)),
                             np.array([[-0.5, -0.5001, n - 0.5, n - 0.4999, -40.0, 90.0] * 6
                                       + [0.0, n - 1.0, 11.5, 0.25]] * 5)], axis=1
                            ).astype(np.float32)
    ref = np.asarray(jax_slicecomp._interp_weights(jnp.asarray(coords), n,
                                                   zero_outside=zero_outside))
    got = torch_slicecomp._interp_weights(torch.from_numpy(coords), n, zero_outside).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got.sum(-1) == 0).any() == zero_outside


def _eye_pose(eye, viewport):
    """(local eye, world-view-projection) of a camera at world `eye`
    looking at the origin, volume scale 10."""
    cam = OrbitCamera(width=viewport[0], height=viewport[1],
                      eye=np.asarray(eye, np.float32))
    world = m3.scaling(10.0)
    local_eye = (np.append(np.asarray(cam.eye, np.float64), 1.0) @ m3.inverse(world))[:3]
    return local_eye, world @ cam.view_proj


# One eye per face: the dominant axis and its sign pick the far face.
EYES = {0: (-40.0, 6.0, 3.0), 1: (40.0, -5.0, 8.0), 2: (4.0, -40.0, 7.0),
        3: (-3.0, 40.0, 9.0), 4: (4.0, 16.0, -40.0), 5: (-6.0, 4.0, 40.0)}


@pytest.mark.parametrize("viewport", [(64, 64), (800, 800)], ids=["64", "800"])
def test_direct_plane_spec_matches_jax(viewport):
    """`direct_plane_spec` equals the JAX package's for eyes whose dominant
    axis picks each of the six faces, at lod 0-2 (the density scale
    1 / 2^lod), and is None for an eye inside the volume."""
    cfg = FluidConfig(viewport=viewport)
    tcfg = TorchConfig(viewport=viewport)
    for face, eye in EYES.items():
        local_eye, wvp = _eye_pose(eye, viewport)
        for lod in range(3):
            scale = 1.0 / (1 << lod)
            ref = jax_screen.direct_plane_spec(local_eye, wvp, viewport, cfg, scale)
            got = torch_screen.direct_plane_spec(local_eye, wvp, viewport, tcfg, scale)
            assert ref.face_id == face and tuple(got) == tuple(ref), (face, lod, got, ref)
    local_eye, wvp = _eye_pose((6.0, 4.0, -9.0), viewport)
    assert torch_screen.direct_plane_spec(local_eye, wvp, viewport, tcfg) is None
    assert jax_screen.direct_plane_spec(local_eye, wvp, viewport, cfg) is None


@pytest.mark.parametrize("shape", [(96, 80), (48, 40)], ids=["bf16", "f32"])
def test_plane_cast_matches_jax(shape):
    """`_plane_cast` on a rectangular (Rv, Ru, 4) plane image at texel
    coordinates reaching past every border (LINEAR_CLAMP), read through
    bf16 where both sides have 64+ texels: within 1e-6 of JAX's (f32
    lerps of the same texels)."""
    rng = np.random.default_rng(5)
    rv, ru = shape
    img = rng.uniform(0.0, 1.0, (rv, ru, 4)).astype(np.float32)
    ut = rng.uniform(-3.0, ru + 2.0, (33, 31)).astype(np.float32)
    vt = rng.uniform(-3.0, rv + 2.0, (33, 31)).astype(np.float32)
    ref = np.asarray(jax.jit(jax_screen._plane_cast)(*map(jnp.asarray, (img, ut, vt))))
    got = torch_screen._plane_cast(*map(torch.from_numpy, (img, ut, vt))).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def _engine(grid, **kw):
    """A port engine on the CPU (its camera, LOD and packed parameters),
    with the JAX package's config of the same fields."""
    kw = dict(SMALL, grid_size=grid, **kw)
    return torch_fluidx.FluidXEngine(TorchConfig(**kw), device="cpu"), FluidConfig(**kw)


def test_warp_plane_to_screen_matches_jax():
    """`_warp_plane_to_screen` of a (256, 384) plane image of noise at the
    default camera's base plane, whole screen and within the scissor rect,
    against JAX's jitted warp: within 2.5e-4 (the same ray, plane hit and
    fetch in f32, but XLA reorders and contracts the f32 chain that forms
    each pixel's plane coordinate, and on noise a coordinate's last bits
    move the lerp; the package's own eager and jitted warps differ by
    1.9e-3 here), the same pixels discarded."""
    port, cfg = _engine((24, 24, 24))
    packed, lod, _ = port.update_frame()
    spec = port._direct_plane_spec(lod)._replace(res=(384, 256))
    rect = port._screen_rect()
    rng = np.random.default_rng(8)
    img = rng.uniform(0.0, 1.0, (256, 384, 4)).astype(np.float32)
    img[..., 3] *= rng.uniform(0.0, 1.0, (256, 384)) > 0.3
    params = unpack_scene_params(jnp.asarray(packed.numpy()))
    tparams = torch_unpack(packed)
    jspec = jax_screen.DirectPlaneSpec(*spec)
    for r in (None, rect):
        warp = jax.jit(functools.partial(jax_screen._warp_plane_to_screen, spec=jspec,
                                         config=cfg, rect=r))
        ref = np.asarray(warp(jnp.asarray(img), params=params))
        got = torch_screen._warp_plane_to_screen(torch.from_numpy(img), spec, tparams,
                                                 port.config, rect=r).numpy()
        assert got.shape == ref.shape == (64, 64, 4) and (got[..., 3] > 0).mean() > 0.1
        np.testing.assert_array_equal(got[..., 3] > 0, ref[..., 3] > 0)
        np.testing.assert_allclose(got, ref, atol=2.5e-4, rtol=0)


# ---------------------------------------------------------------------------
# DIRECT frames
# ---------------------------------------------------------------------------

# grid -> (the route the TPU's gates give the 256^2 base plane, JAX's spy)
ROUTES = {(32, 32, 32): ("B10", "composite_resample_pallas"),
          (24, 24, 24): ("B17", "composite_pallas")}


@pytest.fixture(scope="module", params=list(ROUTES), ids=["32_b10", "24_b17"])
def direct_case(request):
    """The port's engine, a colour grid, and the JAX package's DIRECT image
    of that grid under both methods, rendered as its TPU runs them
    (`_FUSED_ON_CPU`: B10 in zero-outside mode at 32^3, the zero-outside
    resample and B17 at 24^3, both Pallas kernels in interpret mode).
    Returns (engine, grid, {method: image}, the kernel calls JAX traced)."""
    grid_size = request.param
    port, cfg = _engine(grid_size)
    packed, lod, vis_mask = port.update_frame()
    spec = port._direct_plane_spec(lod)
    local_eye = (np.append(np.asarray(port.camera.eye, np.float64), 1.0) @ port.world_i)[:3]
    jspec = jax_screen.direct_plane_spec(local_eye, port.world @ port.camera.view_proj,
                                         cfg.viewport, cfg, 1.0 / (1 << lod))
    assert tuple(jspec) == tuple(spec) and spec.face_id == 4
    grid = _color_grid(cfg.zyx, seed=sum(grid_size))
    params = unpack_scene_params(jnp.asarray(packed.numpy()))
    traced = []
    refs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_slicecomp, "_FUSED_ON_CPU", True)
        for name in ("composite_resample_pallas", "composite_pallas"):
            kernel = getattr(jax_composite, name)

            def spy(*args, _kernel=kernel, _name=name, **kwargs):
                traced.append((_name, kwargs.get("zero_outside")))
                return _kernel(*args, **kwargs)

            mp.setattr(jax_composite, name, spy)
        for method in (RenderMethod.RAY_MARCH_DIRECT_SEPARATE,
                       RenderMethod.RAY_MARCH_DIRECT_MERGED):
            render = jax.jit(functools.partial(
                render_frame, config=cfg, method=method, lod=lod, vis_mask=vis_mask,
                plane_spec=jspec, rect=port._screen_rect()))
            refs[int(method)] = np.asarray(render(jnp.asarray(grid.float().numpy())
                                                  .astype(jnp.bfloat16), params))
    return port, grid, refs, traced


@pytest.mark.parametrize("method", [TorchMethod.RAY_MARCH_DIRECT_SEPARATE,
                                    TorchMethod.RAY_MARCH_DIRECT_MERGED],
                         ids=["separate", "merged"])
def test_direct_frame_matches_jax(direct_case, method, monkeypatch):
    """A DIRECT frame of the port (`render_frame` with the engine's base
    plane, lod and scissor rect) against the JAX package's on the same
    colour grid, at 32^3, where the TPU's gates take B10 in its
    zero-outside mode on the (256, 256) plane, and at 24^3, where B10's
    gate fails (24 % 16) and the plane is resampled with zero-outside
    weights and composited by B17; the port's route is pinned to the same
    kernel, with zero_outside set.  Image within 2 u8 levels, mean below
    0.05 (only exp, log1p and the matmuls' summation order differ; B10's
    plain version composites serially where the interpret-mode kernel
    does too)."""
    port, grid, refs, traced = direct_case
    route, jax_name = ROUTES[port.config.grid_size]
    assert traced == [(jax_name, True if route == "B10" else None)] * 2
    calls = []
    for name in ("composite_resample", "composite"):
        wrapper = getattr(torch_slicecomp, name)

        def spy(*args, _fn=wrapper, _name=name, **kwargs):
            calls.append((_name, kwargs.get("zero_outside")))
            return _fn(*args, **kwargs)

        monkeypatch.setattr(torch_slicecomp, name, spy)
    resampled = torch_slicecomp.resampled_stack
    monkeypatch.setattr(torch_slicecomp, "resampled_stack",
                        lambda *a: calls.append(("resample", a[-1])) or resampled(*a))
    packed, lod, vis_mask = port.update_frame()
    img = torch_render(grid, torch_unpack(packed), port.config, method, lod=lod,
                       vis_mask=vis_mask, plane_spec=port._direct_plane_spec(lod),
                       rect=port._screen_rect())
    want = ([("composite_resample", True)] if route == "B10"
            else [("resample", True), ("composite", None)])
    assert calls == want
    ref = refs[int(method)]
    diff = np.abs(to_srgb_u8(img).astype(int) - to_srgb_u8(ref).astype(int))
    assert diff.max() <= 2 and diff.mean() < 0.05, (diff.max(), diff.mean())
    smoke = np.abs(ref - np.asarray(port.config.clear_color[:3], np.float32)).max(-1) > 0.02
    assert smoke.mean() > 0.05


def test_engine_steps_direct_methods():
    """`step_frame` renders both DIRECT methods through the engine's base
    plane (none falls back or raises) and `next_method` / `prev_method`
    cycle the four methods as the reference's hotkeys do."""
    port, _ = _engine((24, 24, 24), num_pressure_iters=4)
    assert port.render_method == TorchMethod.RAY_MARCH_SEPARATE
    port.next_method()
    assert port.render_method == TorchMethod.RAY_MARCH_DIRECT_MERGED
    img = port.step_frame()
    port.next_method()
    assert port.render_method == TorchMethod.RAY_MARCH_DIRECT_SEPARATE
    img2 = port.step_frame()
    assert img.shape == img2.shape == (64, 64, 3) and bool(torch.isfinite(img2).all())
    port.next_method()
    assert port.render_method == TorchMethod.RAY_MARCH_MERGED
    port.prev_method()
    port.prev_method()
    assert port.render_method == TorchMethod.RAY_MARCH_DIRECT_MERGED


# ---------------------------------------------------------------------------
# The point light
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def point_case():
    """A 24^3 port engine with the point light (at (75, 75, -75), outside
    the volume), a smooth density, and its parameters."""
    port, cfg = _engine((24, 24, 24), point_light=True)
    packed, _, _ = port.update_frame()
    grid = _color_grid(cfg.zyx, seed=11).float()
    return port, cfg, grid, packed


def test_point_transmittance_matches_jax(point_case):
    """`point_transmittance` (the projective sweep, light on the + side of
    x, its dominant axis) against JAX's on a 24^3 density: within 2e-6,
    a 64th of a bf16 ulp at the transmittance's scale of 1 (the same f32
    matmuls on the CPU; only their summation order and log/exp differ)."""
    port, cfg, grid, packed = point_case
    assert torch_sweep.point_sweep_supported(port.config)
    assert jax_sweep.point_sweep_supported(cfg)
    tparams = torch_unpack(packed)
    light = transform_point_h(tparams.light_pt, tparams.world_i)[:3]
    ref_step = MAX_DIST / tparams.num_light_samples.float()
    density = grid[3]
    ref = np.asarray(jax.jit(functools.partial(
        jax_sweep.point_transmittance, major_axis=0, absorption=cfg.absorption,
        flip=True))(jnp.asarray(density.numpy()), jnp.asarray(light.numpy()),
                    ref_step=jnp.asarray(ref_step.numpy())))
    got = torch_sweep.point_transmittance(density, light, 0, ref_step, cfg.absorption,
                                          True).numpy()
    assert 0.05 < ref.min() < 0.9 and ref.max() <= 1.0
    np.testing.assert_allclose(got, ref, atol=2e-6, rtol=0)


def test_point_light_map_matches_jax(point_case):
    """The point-light branch of `render_light_map_fast` (no B9) against
    JAX's, within 2e-6 of the light's scale."""
    port, cfg, grid, packed = point_case
    params = unpack_scene_params(jnp.asarray(packed.numpy()))
    ref = np.asarray(jax.jit(functools.partial(jax_sweep.render_light_map_fast, config=cfg))(
        jnp.asarray(grid.numpy()), params))
    got = torch_sweep.render_light_map_fast(grid, torch_unpack(packed), port.config).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-6 * np.abs(ref).max(), rtol=0)
