"""The port's simulation step against the JAX package's, on the CPU.

The JAX step is composed as its TPU runs it with pallas_jacobi=False: the
advect kernels (`backtrace_pallas`, interpret mode) followed by the XLA
projection (`project`).  Each test pins which advect, multigrid and Jacobi
path JAX took.  States cross over with `state_from_numpy`.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluidx12_tpu.core.config import FluidConfig
from fluidx12_tpu.ops.pallas.advect import (
    backtrace_pallas,
    fused_xy_supported,
    zpass_forces_supported,
)
from fluidx12_tpu.sim.advect import apply_impulse_forces as j_forces
from fluidx12_tpu_torch.core.config import FluidConfig as TorchConfig
from fluidx12_tpu_torch.core.state import state_from_numpy
from fluidx12_tpu_torch.sim.advect import apply_impulse_forces as t_forces
from fluidx12_tpu_torch.sim.step import simulate

jp = importlib.import_module("fluidx12_tpu.sim.project")
jmg = importlib.import_module("fluidx12_tpu.sim.mg")
tp = importlib.import_module("fluidx12_tpu_torch.sim.project")
tmg = importlib.import_module("fluidx12_tpu_torch.sim.mg")

# Several pytest workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)

CASES = {
    # The 64-sweep schedule's small-grid path (16 sweeps as in the goldens).
    "jacobi_24": dict(grid_size=(24, 24, 24), num_pressure_iters=16, pallas_jacobi=False),
    # Multigrid engages at Y*X >= 128^2 (core/config.py mg_min_plane).
    "mg_128x128x16": dict(grid_size=(128, 128, 16), pallas_jacobi=False),
}


def channel_ulps(a, b) -> float:
    """Largest |a - b| per channel in bf16 ulps at the channel's scale."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    axes = tuple(range(1, a.ndim))
    mag = np.maximum(np.abs(a).max(axis=axes, keepdims=True),
                     np.abs(b).max(axis=axes, keepdims=True))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7.0)
    return float((np.abs(a - b) / ulp).max())


def _state(cfg, seed):
    rng = np.random.default_rng(seed)
    f = rng.uniform(0.0, 1.0, (7,) + cfg.zyx).astype(np.float32)
    f[:3] = (f[:3] - 0.5) * 1.5
    p = rng.uniform(-0.1, 0.1, cfg.zyx).astype(np.float32)
    return jnp.asarray(f).astype(jnp.bfloat16), p


def _jax_advect(jf, cfg):
    dt = cfg.time_step
    if zpass_forces_supported(cfg):
        return backtrace_pallas(jf, dt, cfg, forces_dt=dt)
    bt = backtrace_pallas(jf, dt, cfg)
    vel, col = j_forces(bt[:3], bt[3:], dt, cfg)
    return jnp.concatenate([vel, col])


def _pin_paths(name, cfg):
    z, y, x = cfg.zyx
    mg = y * x >= cfg.mg_min_plane and jmg.mg_supported(cfg.zyx)
    if name == "mg_128x128x16":
        assert fused_xy_supported(cfg.zyx) and zpass_forces_supported(cfg) and mg
    else:
        assert not zpass_forces_supported(cfg) and not mg


@pytest.mark.parametrize("name", list(CASES))
def test_simulate_matches_jax_step(name):
    """One `simulate` against the composed JAX step.  The port hands B1's
    result to B2 in f32 where the TPU rounds it to bf16 (at 24^3 the JAX z
    pass, with no fused forces there, rounds once more before its force
    pass): one bf16 ulp at each channel's scale.  The projection then works
    on a right-hand side whose bf16 divergence differs by those ulps, which
    moves the pressure by up to 5e-3 of its scale and the projected
    velocity by one more ulp: fields within 2 ulps, pressure within
    5e-3 * max|p|."""
    cfg, tcfg = FluidConfig(**CASES[name]), TorchConfig(**CASES[name])
    _pin_paths(name, cfg)
    jf, p = _state(cfg, 1)
    ff, pp = jax.jit(lambda f, q: jp.project(_jax_advect(f, cfg), q,
                                             jnp.float32(cfg.time_step), cfg))(
        jf, jnp.asarray(p))
    ref_f = np.asarray(ff.astype(jnp.float32))
    out = simulate(state_from_numpy(np.asarray(jf.astype(jnp.float32)), p, "cpu"),
                   cfg.time_step, tcfg)
    assert out.fields.dtype == torch.bfloat16
    assert channel_ulps(out.fields.float().numpy(), ref_f) <= 2.0
    ref_p = np.asarray(pp)
    np.testing.assert_allclose(out.pressure.numpy(), ref_p,
                               atol=5e-3 * np.abs(ref_p).max(), rtol=0)


@pytest.mark.parametrize("name", list(CASES))
def test_project_matches_jax(name):
    """The projection alone, from the same bf16 fields: the bf16 rounding
    points follow what XLA compiles (see `divergence` in the port's
    sim/project.py), so fields agree within one bf16 ulp and pressure to
    1e-5 (the division by 6 may compile to a reciprocal multiply)."""
    cfg, tcfg = FluidConfig(**CASES[name]), TorchConfig(**CASES[name])
    jf, p = _state(cfg, 2)
    ff, pp = jax.jit(lambda f, q: jp.project(f, q, jnp.float32(cfg.time_step), cfg))(
        jf, jnp.asarray(p))
    st = state_from_numpy(np.asarray(jf.astype(jnp.float32)), p, "cpu")
    tf, tq = tp.project(st.fields, st.pressure, cfg.time_step, tcfg)
    assert channel_ulps(tf.float().numpy(), np.asarray(ff.astype(jnp.float32))) <= 1.0
    np.testing.assert_allclose(tq.numpy(), np.asarray(pp), atol=1e-5, rtol=0)


def test_project_is_identity_when_paused():
    tcfg = TorchConfig(**CASES["jacobi_24"])
    jf, p = _state(tcfg, 3)
    st = state_from_numpy(np.asarray(jf.astype(jnp.float32)), p, "cpu")
    f, q = tp.project(st.fields, st.pressure, 0.0, tcfg)
    assert f is st.fields and q is st.pressure


def test_divergence_matches_jax_bit_for_bit():
    """The divergence rounds where XLA's compiled `divergence(...).astype(f32)`
    rounds: every op in bf16 except the last."""
    cfg = FluidConfig(**CASES["jacobi_24"])
    jf, _ = _state(cfg, 4)
    ref = jax.jit(lambda v: jp.divergence(v, True).astype(jnp.float32))(jf)
    got = tp.divergence(torch.from_numpy(np.array(jf.astype(jnp.float32))).to(torch.bfloat16),
                        True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("piece", ["jacobi", "mg_solve", "restrict", "prolong"])
def test_poisson_pieces_match_jax(piece):
    """f32 solver pieces: atol 1e-6 (sums in the same order; XLA may turn
    the division by 6 into a reciprocal multiply)."""
    rng = np.random.default_rng(6)
    b = rng.uniform(-0.1, 0.1, (16, 32, 32)).astype(np.float32)
    q = rng.uniform(-0.1, 0.1, (16, 32, 32)).astype(np.float32)
    jb, jq, tb, tq = jnp.asarray(b), jnp.asarray(q), torch.from_numpy(b), torch.from_numpy(q)
    if piece == "jacobi":
        ref = jax.jit(lambda a, c: jp.jacobi_sweeps(a, c, 16, True))(jq, jb)
        got = tp.jacobi_sweeps(tq, tb, 16, True)
    elif piece == "mg_solve":
        ref = jax.jit(lambda a, c: jmg.mg_solve(a, c, use_pallas=False))(jq, jb)
        got = tmg.mg_solve(tq, tb)
    elif piece == "restrict":
        ref, got = jmg._restrict(jb), tmg._restrict(tb)
    else:
        ref, got = jmg._prolong(jb), tmg._prolong(tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def test_apply_impulse_forces_matches_jax():
    """The unfused force step (used after a non-fused z pass): f32 math,
    one rounding to bf16 -- within one bf16 ulp at each channel's scale."""
    cfg = FluidConfig(grid_size=(32, 32, 32))
    tcfg = TorchConfig(grid_size=(32, 32, 32))
    jf, _ = _state(cfg, 8)
    dt = cfg.time_step
    jv, jc = jax.jit(lambda f: j_forces(f[:3], f[3:], dt, cfg))(jf)
    tf = torch.from_numpy(np.array(jf.astype(jnp.float32))).to(torch.bfloat16)
    tv, tcol = t_forces(tf[:3], tf[3:], torch.tensor(dt), tcfg)
    assert channel_ulps(tv.float().numpy(), np.asarray(jv.astype(jnp.float32))) <= 1.0
    assert channel_ulps(tcol.float().numpy(), np.asarray(jc.astype(jnp.float32))) <= 1.0
