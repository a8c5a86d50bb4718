"""The 2D slice -- the path of PRESETS["fluid2d"] -- against the JAX package
on the CPU: kernel B11 (`advect_axis`, one-axis advection) and kernel B14
(`jacobi2d`, the 2D Jacobi sweeps) as plain versions against their Pallas
kernels in interpret mode, then one 2D `simulate` and one 2D `step_frame`
against the step and frame the TPU runs, composed from the JAX package's
functions (its own CPU path takes the mirror-addressed XLA twins instead).
Inputs are made with numpy from a seed.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluidx12_tpu.core.config import FluidConfig, RenderMethod
from fluidx12_tpu.core.state import unpack_scene_params
from fluidx12_tpu.ops.pallas import advect as pa
from fluidx12_tpu.ops.pallas import jacobi as pj
from fluidx12_tpu.render.pipeline import render_frame
from fluidx12_tpu.sim.advect import apply_impulse_forces as j_forces
from fluidx12_tpu_torch.core.config import FluidConfig as TorchConfig
from fluidx12_tpu_torch.core.state import state_from_numpy
from fluidx12_tpu_torch.engine.fluidx import FluidXEngine
from fluidx12_tpu_torch.ops.cuda import advect as ta
from fluidx12_tpu_torch.ops.cuda import jacobi as tj
from fluidx12_tpu_torch.sim.step import simulate
from fluidx12_tpu_torch.utils.image import to_srgb_u8

jp = importlib.import_module("fluidx12_tpu.sim.project")

# Several pytest workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)


def ulps(a, b, mantissa_bits: int = 7) -> float:
    """Largest |a - b| per channel (leading axis) in ulps of that channel's
    largest magnitude: bf16 by default, f32 with 23 mantissa bits."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    axes = tuple(range(1, a.ndim))
    mag = np.maximum(np.abs(a).max(axis=axes, keepdims=True),
                     np.abs(b).max(axis=axes, keepdims=True))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - mantissa_bits)
    return float((np.abs(a - b) / ulp).max())


def _state(rng, shape, umax, dtype):
    """(jax, torch) copies of one random (7, Z, Y, X) state in `dtype`."""
    f = rng.uniform(0.0, 1.0, (7,) + tuple(shape)).astype(np.float32)
    f[:3] = (f[:3] - 0.5) * (2.0 * umax)
    jv = jnp.asarray(f).astype(jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tv = torch.from_numpy(np.array(jv.astype(jnp.float32)))
    return jv, tv.to(torch.bfloat16 if dtype == "bf16" else torch.float32)


# ---------------------------------------------------------------------------
# B11 against `_run_pass_fused` and `_run_pass`
# ---------------------------------------------------------------------------

# (zyx, storage, tiling, umax).  With scale 8, umax 1.5 drives displacements
# past the 12-voxel clip (the heavy tap tier); umax 0.25 keeps every block
# within 2 voxels (the calm tier).  `per_channel` forces the one-channel
# blocks of `_pass_kernel_fused_d1`, as tests/test_pallas.py does.
B11_CASES = {
    "2d-bf16-all": ((1, 32, 128), "bf16", "all_channel", 1.5),
    "2d-f32-all": ((1, 32, 128), "f32", "all_channel", 1.5),
    "2d-bf16-per_channel": ((1, 32, 128), "bf16", "per_channel", 1.5),
    "2d-bf16-calm": ((1, 32, 128), "bf16", "all_channel", 0.25),
    "3d-bf16-all": ((4, 16, 128), "bf16", "all_channel", 1.5),
    "3d-f32-per_channel": ((4, 16, 128), "f32", "per_channel", 1.5),
}
AXES = {"x": (3, 2, 0), "y": (2, 1, 1)}  # (Pallas axis, port axis, displacement channel)
SCALE = 8.0


@pytest.mark.parametrize("case", list(B11_CASES))
@pytest.mark.parametrize("axis", list(AXES))
def test_advect_axis_matches_pallas_fused_pass(monkeypatch, axis, case):
    """B11's plain version (through the wrapper) against
    `_run_pass_fused(..., interpret=True)`, both axes, the walls included.
    bf16 storage: bit for bit.  f32 storage: within one f32 ulp at each
    channel's scale, because XLA on the CPU contracts the kernel's two tap
    products into an FMA where the port rounds each (on the card the kernel
    equals the plain version bit for bit, chip_smoke.py)."""
    zyx, storage, tiling, umax = B11_CASES[case]
    p_axis, t_axis, disp_ch = AXES[axis]
    jv, tv = _state(np.random.default_rng(20), zyx, umax, storage)
    if tiling == "per_channel":
        monkeypatch.setattr(pa, "_CBLOCK_BUDGET_ELEMS", 0)
    ref = pa._run_pass_fused(jv, axis=p_axis, interpret=True, disp_ch=disp_ch, scale=SCALE)
    assert ref is not None
    got = ta.advect_axis(tv, torch.tensor(SCALE), t_axis, disp_ch)
    assert got.dtype == tv.dtype
    ref = np.asarray(ref.astype(jnp.float32))
    got = got.float().numpy()
    if storage == "bf16":
        np.testing.assert_array_equal(got, ref)
    else:
        assert ulps(got, ref, mantissa_bits=23) <= 1.0


@pytest.mark.parametrize("axis", list(AXES))
def test_advect_axis_matches_pallas_legacy_pass(axis):
    """B11 against the legacy `_run_pass` (`_pass_kernel`, the displacement
    precomputed and clipped outside, edge selects per tap instead of the
    in-bounds clamp) on bf16 (7, 2, 32, 128): bit for bit."""
    p_axis, t_axis, disp_ch = AXES[axis]
    jv, tv = _state(np.random.default_rng(21), (2, 32, 128), 1.5, "bf16")
    disp = jnp.clip(-jv[disp_ch].astype(jnp.float32) * SCALE, -ta.MAX_DISP, ta.MAX_DISP)
    ref = pa._run_pass(jv, disp, p_axis, interpret=True)
    assert ref is not None
    got = ta.advect_axis(tv, torch.tensor(SCALE), t_axis, disp_ch)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("storage", ["bf16", "f32"])
def test_advect_axis_x_then_y_is_b1_rounded(storage):
    """B11 on x then on y equals B1 (`advect_xy`) rounded to storage, bit
    for bit, on a 3D volume: where the TPU takes B1 on a small plane and
    the port takes B11, the result is the same."""
    _, tv = _state(np.random.default_rng(22), (3, 24, 64), 1.5, storage)
    scales = torch.tensor([0.9, -0.6])
    got = ta.advect_axis(ta.advect_axis(tv, scales[0], 2, 0), scales[1], 1, 1)
    assert torch.equal(got, ta.advect_xy(tv, scales).to(tv.dtype))


def test_advect_axis_rejects_bad_arguments():
    """Shape, dtype, scale and axis are checked before dispatch."""
    vol = torch.zeros((7, 1, 8, 8))
    for args in ((vol.to(torch.float16), torch.tensor(1.0), 2, 0),
                 (vol, torch.tensor([1.0]), 2, 0),
                 (vol, torch.tensor(1.0), 3, 0),
                 (vol, torch.tensor(1.0), 2, 7)):
        with pytest.raises(ValueError):
            ta.advect_axis(*args)


# ---------------------------------------------------------------------------
# B14 against `jacobi2d_pallas`
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(128, 128), (8, 256)])
def test_jacobi2d_matches_pallas(shape):
    """B14's plain version (through the wrapper) against `jacobi2d_pallas`
    (interpret) for 16 sweeps: the kernel's sum order, and a division by 4
    that is exact: bit for bit."""
    rng = np.random.default_rng(23)
    q, b = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    assert tj.jacobi2d_pallas_supported(shape) == pj.jacobi2d_pallas_supported(shape)
    ref = np.asarray(pj.jacobi2d_pallas(jnp.asarray(q), jnp.asarray(b), 16))
    got = tj.jacobi2d(torch.from_numpy(q), torch.from_numpy(b), 16)
    np.testing.assert_array_equal(got.numpy(), ref)


# ---------------------------------------------------------------------------
# The 2D step and frame against the TPU's, composed from the JAX package
# ---------------------------------------------------------------------------

def _tpu_step_2d(cfg):
    """The 2D step as the JAX package runs it on its TPU, jitted: the
    advect kernels (`backtrace_pallas`, interpret mode), the forces, the
    twin divergence, B14 (`jacobi2d_pallas`) and the twin gradient and
    damp; the state rounded to bf16 at the end."""
    dt, rho = cfg.time_step, cfg.fluid_density_2d
    assert pj.jacobi2d_pallas_supported(cfg.zyx[1:])

    def step(f, q):
        f = pa.backtrace_pallas(f, dt, cfg)
        f = jnp.concatenate(j_forces(f[:3], f[3:], dt, cfg))
        b = jp.divergence(f, False).astype(jnp.float32)
        q = pj.jacobi2d_pallas(q[0], b[0], cfg.num_pressure_iters)[None]
        vel = jp.boundary_damp(jp.subtract_gradient(f, q, rho, False), cfg)
        return jnp.concatenate([vel.astype(f.dtype), f[3:]]).astype(jnp.bfloat16), q

    return jax.jit(step)


@pytest.fixture
def spies(monkeypatch):
    """Counts the calls of B11's and B14's plain versions in the port."""
    calls = {}
    for mod, name in ((ta, "advect_axis_plain"), (tj, "jacobi2d_plain")):
        def spy(*args, _fn=getattr(mod, name), _name=name, **kwargs):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(mod, name, spy)
    return calls


def test_simulate_2d_matches_tpu_step(spies):
    """One 2D `simulate` at zyx (1, 128, 256) against `_tpu_step_2d`.  The
    TPU takes B1 on this plane where the port takes B11 twice (the same
    bits, test_advect_axis_x_then_y_is_b1_rounded).  The forces may differ
    in exp's last bit: fields within one bf16 ulp at each channel's scale,
    pressure within 1e-6 of its scale."""
    kw = dict(grid_size=(256, 128, 1))
    cfg, tcfg = FluidConfig(**kw), TorchConfig(**kw)
    assert pa.fused_xy_supported(cfg.zyx)
    jf, tf = _state(np.random.default_rng(24), cfg.zyx, 0.75, "bf16")
    p = np.random.default_rng(25).uniform(-0.1, 0.1, cfg.zyx).astype(np.float32)
    ref_f, ref_q = _tpu_step_2d(cfg)(jf, jnp.asarray(p))
    out = simulate(state_from_numpy(tf.float().numpy(), p, "cpu"), cfg.time_step, tcfg)
    assert spies == {"advect_axis_plain": 2, "jacobi2d_plain": 1}
    assert out.fields.dtype == torch.bfloat16
    assert ulps(out.fields.float().numpy(), np.asarray(ref_f.astype(jnp.float32))) <= 1.0
    ref_q = np.asarray(ref_q)
    np.testing.assert_allclose(out.pressure.numpy(), ref_q,
                               atol=1e-6 * np.abs(ref_q).max(), rtol=0)


def test_step_frame_2d_matches_tpu_frame(spies):
    """The port raises a plume in 5 frames from rest at grid 128x128x1,
    64^2 viewport; then one `step_frame` runs against `_tpu_step_2d`
    followed by the JAX `render_frame` (`visualize_color_2d`, the clear
    colour behind).  State within one bf16 ulp at each channel's scale,
    image within 2 u8 levels."""
    kw = dict(grid_size=(128, 128, 1), viewport=(64, 64))
    cfg, tcfg = FluidConfig(**kw), TorchConfig(**kw)
    port = FluidXEngine(tcfg, device="cpu")
    for _ in range(5):
        port.step_frame()
    fields = jnp.asarray(port.state.fields.float().numpy()).astype(jnp.bfloat16)
    pressure = jnp.asarray(port.state.pressure.numpy())
    packed, lod, vis_mask = port.update_frame()
    assert lod == 0 and port._screen_rect() is None
    params = unpack_scene_params(jnp.asarray(packed.numpy()))
    ref_f, _ = _tpu_step_2d(cfg)(fields, pressure)
    ref_img = jax.jit(functools.partial(
        render_frame, params=params, config=cfg, method=RenderMethod.RAY_MARCH_SEPARATE,
        lod=lod, vis_mask=vis_mask, rect=None))(ref_f[3:])
    spies.clear()
    img = port.step_frame()
    assert spies == {"advect_axis_plain": 2, "jacobi2d_plain": 1}
    assert ulps(port.state.fields.float().numpy(), np.asarray(ref_f.astype(jnp.float32))) <= 1.0
    assert img.shape == (64, 64, 3)
    diff = np.abs(to_srgb_u8(img).astype(int) - to_srgb_u8(np.asarray(ref_img)).astype(int))
    assert diff.max() <= 2, diff.max()
