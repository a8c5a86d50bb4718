"""The port's slice as a whole -- `FluidXEngine.step_frame` of the
separate-light cube path -- against the JAX package on the CPU."""

import dataclasses
import functools
import importlib
import os

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

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "fluid3d_separate.png")
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


def test_golden_fluid3d_separate():
    """(b) The port renders tests/test_golden.py's `fluid3d_separate` case
    (24^3 grid, 64^2 viewport, 32 ray / 8 light samples, 16 Jacobi sweeps,
    35 frames) and passes that test's gates against the committed golden:
    mean abs diff < 2.0 and fewer than 1% of pixel channels off by more
    than 25."""
    cfg = TorchConfig(grid_size=(24, 24, 24), viewport=(64, 64), max_ray_samples=32,
                      max_light_samples=8, num_pressure_iters=16)
    engine = torch_fluidx.FluidXEngine(cfg, device="cpu")
    for _ in range(35):
        img = engine.step_frame()
    diff = np.abs(to_srgb_u8(img).astype(np.int32) - read_png(GOLDEN).astype(np.int32))
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
    """What the port does not cover yet raises NotImplementedError naming
    its ROADMAP item, instead of running another path: the faithful
    simulation and render stacks, the point light and the DIRECT methods.
    The default preset (pallas_jacobi=True), the 2D preset, GI and every
    kernel the JAX gates choose (B15 and B18 among them) are covered."""
    from fluidx12_tpu_torch.core.config import PRESETS

    torch_fluidx.FluidXEngine(PRESETS["fluid3d"], device="cpu")
    base = TorchConfig(grid_size=(24, 24, 24), viewport=(32, 32))
    for change in (dict(grid_size=(64, 64, 1), fast_sim=False), dict(fast_render=False),
                   dict(point_light=True), dict(fast_sim=False)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            torch_fluidx.FluidXEngine(dataclasses.replace(base, **change), device="cpu")
    engine = torch_fluidx.FluidXEngine(base, device="cpu")
    engine.render_method = torch_fluidx.RenderMethod.RAY_MARCH_DIRECT_SEPARATE
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        engine.step_frame()
