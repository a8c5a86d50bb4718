"""torch.autograd through the port's faithful stack against jax.grad of the
JAX package's (the port of tests/test_adjoint.py).

The JAX package documents reverse-mode differentiation of its faithful
stack (fast_sim=False, fast_render=False, use_pallas=False,
mg_pressure=False): `jax.grad` through `simulate` and through
`SmokeModel.step`.  The port's users call `.backward()` on the same entry
points with the same config; on the CPU its plain versions differentiate
(on the card R1 and R2 run as autograd Functions with the hand adjoints
R1b and R2b, held to these plain versions by tests/test_torch_cuda.py and
chip_smoke.py).  Here the same loss from the same state goes through both
packages and the gradients agree within 2e-5 of the JAX gradient's
largest magnitude:

- `simulate`, 2 steps at tests/test_adjoint.py:25-27's config, the dye in
  the +x half as the loss, from a state made with numpy from a seed;
- `SmokeModel.step` at tests/test_adjoint.py:85-89's config, the image's
  sum as the loss, under RAY_MARCH_SEPARATE, RAY_MARCH_DIRECT_SEPARATE
  and a point light inside the volume (32 light samples: at 4 the shadow
  rays of this smoke step clear of it and the light's direction changes
  nothing), from the JAX test's state (two steps from the initial state,
  tests/test_adjoint.py:93-95).  Measured on one CPU: from that state
  plus smooth seeded velocity noise (0.3 a voxel) the port's gradient
  equals JAX's unjitted jax.grad to 1.1e-8 of its scale (the separate
  method; 0 under DIRECT_SEPARATE), while the jitted one moves 5.3e-5 to
  7.5e-5 of its scale from JAX's own unjitted gradient (XLA's fused
  arithmetic), so the jitted reference is held at the JAX test's state;
  unjitted it takes 23 s a gradient.

Then a central finite difference of the port's image loss against its
autograd directional derivative, with the JAX test's tolerance, and the
port's `jacobi_sweeps` against a hand loop (tests/test_adjoint.py:123).
Each JAX gradient is jitted once."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluidx12_tpu.core.config import FluidConfig as JaxConfig
from fluidx12_tpu.core.config import RenderMethod as JaxMethod
from fluidx12_tpu.core.state import FluidState as JaxState
from fluidx12_tpu.models.smoke import SmokeModel as JaxModel
from fluidx12_tpu.sim.step import simulate as jax_simulate
from fluidx12_tpu_torch.core.config import FluidConfig
from fluidx12_tpu_torch.core.config import RenderMethod
from fluidx12_tpu_torch.core.state import FluidState
from fluidx12_tpu_torch.models.smoke import SmokeModel
from fluidx12_tpu_torch.ops.sampling import neighbor_shift
from fluidx12_tpu_torch.sim.project import jacobi_sweeps
from fluidx12_tpu_torch.sim.step import simulate

# Several pytest workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)

ZYX = (16, 16, 16)
# tests/test_adjoint.py:25-27 and :85-89.
SIM = dict(grid_size=(16, 16, 16), fast_sim=False, use_pallas=False, mg_pressure=False,
           num_pressure_iters=6)
RENDER = dict(grid_size=(16, 16, 16), viewport=(24, 24), fast_sim=False, fast_render=False,
              use_pallas=False, mg_pressure=False, num_pressure_iters=4, max_ray_samples=12,
              max_light_samples=4, quantize_cube_map=False)
# The render cases: (method, config changes).
CASES = {
    "separate": ("RAY_MARCH_SEPARATE", {}),
    "direct_separate": ("RAY_MARCH_DIRECT_SEPARATE", {}),
    "point_light": ("RAY_MARCH_SEPARATE",
                    dict(point_light=True, light_pos=(5.0, 2.0, -3.0), max_light_samples=32)),
}
TOL = 2e-5


def _configs(kw):
    return (FluidConfig(**kw, sim_dtype=torch.float32),
            JaxConfig(**kw, sim_dtype=jnp.float32))


def _smooth(rng, shape, passes=2):
    a = rng.standard_normal(shape).astype(np.float32)
    for ax in range(1, a.ndim):
        for _ in range(passes):
            a = (np.roll(a, 1, ax) + a + np.roll(a, -1, ax)) / 3
    return a


def _held(got, ref, what):
    err = float(np.abs(got - ref).max())
    scale = float(np.abs(ref).max())
    print(f"{what}: max |jax.grad| {scale:.4g}, max |autograd - jax.grad| {err:.3g} "
          f"({err / scale:.3g} of it)")
    assert np.all(np.isfinite(got)) and scale > 1e-6
    assert err <= TOL * scale


# ---------------------------------------------------------------------------
# simulate
# ---------------------------------------------------------------------------

def _sim_state():
    """A (7, Z, Y, X) f32 state from numpy's default_rng(0): smooth
    velocities of up to a few voxels a step, smooth dye, a small pressure."""
    rng = np.random.default_rng(0)
    fields = np.concatenate([2.0 * _smooth(rng, (3,) + ZYX),
                             np.clip(_smooth(rng, (4,) + ZYX) + 0.3, 0.0, 1.0)]).astype(np.float32)
    return fields, 0.01 * _smooth(rng, (1,) + ZYX)[0]


@functools.lru_cache(maxsize=None)
def _jax_sim_grad():
    _, cfg = _configs(SIM)
    fields, pressure = _sim_state()

    def loss(v):
        state = JaxState(fields=jnp.asarray(fields).at[:3].add(v), pressure=jnp.asarray(pressure))
        dt = jnp.asarray(cfg.time_step, jnp.float32)
        for _ in range(2):
            state = jax_simulate(state, dt, cfg)
        return jnp.sum(state.fields[6, :, :, 8:])

    return np.asarray(jax.jit(jax.grad(loss))(jnp.zeros((3,) + ZYX, jnp.float32)))


def test_simulate_grad_matches_jax():
    """2 faithful steps, the gather advect and 6 Jacobi sweeps each: the
    port's autograd gradient of the dye in the +x half with respect to an
    initial-velocity perturbation equals jax.grad's."""
    cfg, _ = _configs(SIM)
    fields, pressure = _sim_state()
    v = torch.zeros((3,) + ZYX, requires_grad=True)
    state = FluidState(fields=torch.cat([torch.from_numpy(fields[:3]) + v,
                                         torch.from_numpy(fields[3:])]),
                       pressure=torch.from_numpy(pressure))
    for _ in range(2):
        state = simulate(state, cfg.time_step, cfg)
    state.fields[6, :, :, 8:].sum().backward()
    _held(v.grad.numpy(), _jax_sim_grad(), "simulate, 2 steps")


# ---------------------------------------------------------------------------
# SmokeModel.step
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _render_state(case):
    """The JAX test's state: two steps of the port's model from the initial
    state, carried to both packages as numpy arrays."""
    cfg, _ = _configs(dict(RENDER, **CASES[case][1]))
    model = SmokeModel(cfg, method=RenderMethod[CASES[case][0]], device="cpu")
    state, params = model.init(), model.default_params()
    with torch.no_grad():
        for _ in range(2):
            state, _ = model.step(state, params)
    return state.fields.numpy().copy(), state.pressure.numpy().copy()


def _port_image_loss(case, v):
    cfg, _ = _configs(dict(RENDER, **CASES[case][1]))
    model = SmokeModel(cfg, method=RenderMethod[CASES[case][0]], device="cpu")
    fields, pressure = _render_state(case)
    state = FluidState(fields=torch.cat([torch.from_numpy(fields[:3]) + v,
                                         torch.from_numpy(fields[3:])]),
                       pressure=torch.from_numpy(pressure))
    return model.step(state, model.default_params())[1].sum()


@functools.lru_cache(maxsize=None)
def _jax_render_grad(case):
    _, cfg = _configs(dict(RENDER, **CASES[case][1]))
    model = JaxModel(cfg, method=JaxMethod[CASES[case][0]])
    params = model.default_params()
    fields, pressure = _render_state(case)

    def loss(v):
        state = JaxState(fields=jnp.asarray(fields).at[:3].add(v), pressure=jnp.asarray(pressure))
        return jnp.sum(model.step(state, params)[1])

    return np.asarray(jax.jit(jax.grad(loss))(jnp.zeros((3,) + ZYX, jnp.float32)))


@pytest.mark.parametrize("case", list(CASES))
def test_smoke_model_step_grad_matches_jax(case):
    """One faithful sim + render step: the port's autograd gradient of the
    image's sum with respect to a velocity perturbation equals jax.grad's,
    through the gather advect, the Jacobi sweeps, the light map, the view
    march (cube map and resolve, or the screen march) and the composite."""
    v = torch.zeros((3,) + ZYX, requires_grad=True)
    _port_image_loss(case, v).backward()
    _held(v.grad.numpy(), _jax_render_grad(case), f"SmokeModel.step, {case}")


def test_smoke_model_step_grad_matches_finite_differences():
    """The port's directional derivative of the image loss along a seeded
    direction against a central finite difference of the port's own loss,
    with tests/test_adjoint.py's step and tolerance (the march's branches
    make the image only piecewise smooth in the fields)."""
    v = torch.zeros((3,) + ZYX, requires_grad=True)
    _port_image_loss("separate", v).backward()
    d = np.random.default_rng(7).normal(size=(3,) + ZYX).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d))
    eps = 2e-2
    with torch.no_grad():
        fd = float(_port_image_loss("separate", eps * d) - _port_image_loss("separate", -eps * d))
    fd /= 2 * eps
    ad = float((v.grad * d).sum())
    print(f"directional derivative: autograd {ad:.6g}, central FD {fd:.6g}")
    assert np.isfinite(ad) and np.isfinite(fd) and abs(ad) > 1e-6
    np.testing.assert_allclose(ad, fd, rtol=8e-2, atol=1e-3)


def test_jacobi_sweeps_match_a_hand_loop():
    """The port's synchronous sweeps equal a hand-rolled loop of the same
    update (tests/test_adjoint.py:123)."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(8, 8, 8)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(8, 8, 8)).astype(np.float32))
    out = jacobi_sweeps(q, b, 5, True)
    ref = q
    for _ in range(5):
        s = sum(neighbor_shift(ref, ax, sg) for ax in (0, 1, 2) for sg in (+1, -1))
        ref = (s - b) / 6.0
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)
