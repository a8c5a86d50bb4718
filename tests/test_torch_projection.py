"""The port's projection kernels B3-B8 (plain versions on the CPU) against
the JAX package's Pallas kernels in interpret mode, as tests/test_pallas.py
runs them; the port's shape gates against the JAX originals; and the
projection, one `simulate` and one frame at grid (128, 128, 64) against the
TPU's chain composed from the JAX package's functions.

XLA on the CPU compiles the kernels' `/ 6.0` as a multiply by fl32(1/6) and
contracts products into FMAs (`b - (s - 6q)`, the prolongation's dots); the
port's kernels and plain versions divide and round every operation as the
kernel source is written.  The tolerances below say where that shows.
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
from fluidx12_tpu.ops.pallas import composite as jax_composite
from fluidx12_tpu.ops.pallas import jacobi as pj
from fluidx12_tpu.ops.pallas import stencil as ps
from fluidx12_tpu.ops.pallas.advect import backtrace_pallas
from fluidx12_tpu.render import slicecomp as jax_slicecomp
from fluidx12_tpu.render.pipeline import render_frame
from fluidx12_tpu_torch.core.config import FluidConfig as TorchConfig
from fluidx12_tpu_torch.core.state import state_from_numpy
from fluidx12_tpu_torch.engine import fluidx as torch_fluidx
from fluidx12_tpu_torch.ops.cuda import jacobi as tj
from fluidx12_tpu_torch.ops.cuda import stencil as ts
from fluidx12_tpu_torch.sim.step import simulate
from fluidx12_tpu_torch.utils.image import to_srgb_u8

jmg = importlib.import_module("fluidx12_tpu.sim.mg")
tmg = importlib.import_module("fluidx12_tpu_torch.sim.mg")
tp = importlib.import_module("fluidx12_tpu_torch.sim.project")

RHO = 0.48
# The smallest grid on which the TPU runs all six projection kernels, as
# at 128^3: zyx (64, 128, 128).
GRID = dict(grid_size=(128, 128, 64))

# Several pytest workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)


def bf16_ulps(a, b) -> float:
    """Largest |a - b| per channel (leading axis) in bf16 ulps at that
    channel's largest magnitude."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    axes = tuple(range(1, a.ndim))
    mag = np.maximum(np.abs(a).max(axis=axes, keepdims=True),
                     np.abs(b).max(axis=axes, keepdims=True))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7.0)
    return float((np.abs(a - b) / ulp).max())


def _fields(rng, shape, umax=1.5, dtype=jnp.bfloat16):
    """(jax, torch) copies of one random (7, Z, Y, X) state in `dtype`."""
    f = rng.uniform(0.0, 1.0, (7,) + tuple(shape)).astype(np.float32)
    f[:3] = (f[:3] - 0.5) * (2.0 * umax)
    jf = jnp.asarray(f).astype(dtype)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    return jf, torch.from_numpy(np.array(jf.astype(jnp.float32))).to(tdt)


def _pair(rng, shape, scale=1.0):
    q = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(q), torch.from_numpy(q)


# ---------------------------------------------------------------------------
# Each kernel's plain version against its Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_divergence_matches_pallas(dtype):
    """B3 vs `divergence_pallas` on (7, 16, 32, 128): f32 casts, the same
    sum order, one product: bit for bit."""
    jf, tf = _fields(np.random.default_rng(1), (16, 32, 128),
                     dtype=jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    ref = np.asarray(ps.divergence_pallas(jf))
    got = ts.divergence(tf)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("shape,iters,plan,order", [
    ((64, 32, 128), 4, (32, 4), tj.ORDER_WINDOW),
    ((32, 64, 128), 8, (16, 8), tj.ORDER_WINDOW),
    ((24, 136, 128), 8, (8, 8), tj.ORDER_PLANEWISE),
])
def test_jacobi_matches_pallas(shape, iters, plan, order):
    """B4 vs `jacobi_pallas` with the grid's own `jacobi_tuning` plan: the
    whole-window kernel, and the plane-sweep kernel for a plane above
    128x128, which sums z- before z+.  atol 2e-6 * max|ref|: XLA divides by
    6 as a multiply by fl32(1/6), the port truly divides."""
    rng = np.random.default_rng(2)
    (jq, tq), (jb, tb) = _pair(rng, shape), _pair(rng, shape)
    tuning = pj.jacobi_tuning(shape, iters)
    assert tuning == plan and tj.window_order(shape, plan[1]) == order
    ref = np.asarray(pj.jacobi_pallas(jq, jb, iters, *tuning))
    got = tj.jacobi(tq, tb, iters, *tuning).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-6 * np.abs(ref).max(), rtol=0)


SUM_ORDERS = {
    "window": ((64, 32, 128), 4, tj.ORDER_WINDOW,
               lambda q, b: pj.jacobi_pallas(q, b, 4, 32, 4)),
    "planewise": ((24, 136, 128), 8, tj.ORDER_PLANEWISE,
                  lambda q, b: pj.jacobi_pallas(q, b, 8, 8, 8)),
    "packed": ((16, 48, 64), 8, tj.ORDER_PACKED,
               lambda q, b: pj.jacobi_packed_pallas(q, b, 8)),
}


@pytest.mark.parametrize("kernel", list(SUM_ORDERS))
def test_jacobi_sum_orders_match_pallas_bit_for_bit(kernel):
    """Each neighbour order of ops/cuda/jacobi.py, swept with XLA's own
    division (a multiply by fl32(1/6)), reproduces its Pallas kernel bit
    for bit: the orders themselves are the kernels', which the tolerance of
    the tests above could not tell apart."""
    from fluidx12_tpu_torch.ops.sampling import neighbor_shift

    shape, iters, order, call = SUM_ORDERS[kernel]
    rng = np.random.default_rng(12)
    (jq, q), (jb, b) = _pair(rng, shape), _pair(rng, shape)
    ref = np.asarray(call(jq, jb))
    sixth = torch.tensor(np.float32(1.0) / np.float32(6.0))
    (ax0, off0), *rest = tj._ORDERS[order]
    for _ in range(iters):
        s = neighbor_shift(q, ax0, off0)
        for ax, off in rest:
            s = s + neighbor_shift(q, ax, off)
        q = (s - b) * sixth
    np.testing.assert_array_equal(q.numpy(), ref)


def test_residual_matches_pallas():
    """B5 vs `residual_pallas` at (16, 32, 128).  1e-6 * max|ref|: XLA
    fuses `s - 6q` into an FMA."""
    rng = np.random.default_rng(3)
    (jq, tq), (jb, tb) = _pair(rng, (16, 32, 128)), _pair(rng, (16, 32, 128))
    ref = np.asarray(ps.residual_pallas(jq, jb))
    got = ts.residual(tq, tb).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("shape", [(16, 48, 64), (32, 32, 64)])
def test_jacobi_packed_matches_pallas(shape):
    """B6 vs `jacobi_packed_pallas(q, b, 32)`.  atol 1e-5, as
    tests/test_pallas.py holds the kernel to its twin."""
    rng = np.random.default_rng(4)
    (jq, tq), (jb, tb) = _pair(rng, shape), _pair(rng, shape)
    assert pj.jacobi_packed_supported(shape)
    ref = np.asarray(pj.jacobi_packed_pallas(jq, jb, 32))
    got = tj.jacobi_packed(tq, tb, 32).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_prolong_correct_matches_pallas():
    """B7 vs `prolong_correct_pallas`, fine (16, 32, 128) / coarse
    (8, 16, 64).  atol 1e-6: XLA's dots may contract into FMAs."""
    rng = np.random.default_rng(5)
    (jq, tq), (je, te) = _pair(rng, (16, 32, 128)), _pair(rng, (8, 16, 64))
    ref = np.asarray(ps.prolong_correct_pallas(jq, je))
    got = ts.prolong_correct(tq, te).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_grad_damp_matches_pallas():
    """B8 vs `grad_damp_pallas(fields, p, 0.48)` on bf16 (7, 16, 32, 128):
    within one bf16 ulp at each channel's scale (XLA's reciprocal multiply
    for `/ 0.03` can flip the one rounding), in place, channels 3..6 bit
    equal to the input."""
    rng = np.random.default_rng(6)
    jf, tf = _fields(rng, (16, 32, 128))
    jp_, tp_ = _pair(rng, (16, 32, 128))
    before = tf.clone()
    ref = np.asarray(ps.grad_damp_pallas(jf, jp_, RHO).astype(jnp.float32))
    got = ts.grad_damp(tf, tp_, RHO)
    assert got is tf and got.dtype == torch.bfloat16
    assert bf16_ulps(got[:3].float().numpy(), ref[:3]) <= 1.0
    assert torch.equal(got[3:], before[3:])
    np.testing.assert_array_equal(got[3:].float().numpy(), ref[3:])


# ---------------------------------------------------------------------------
# The gates
# ---------------------------------------------------------------------------

GATE_GRIDS = [
    (128, 128, 128), (64, 128, 128), (16, 128, 128), (24, 24, 24), (256, 256, 256),
    (64, 64, 64), (32, 64, 64), (8, 64, 64), (128, 128, 64), (32, 144, 256),
    (16, 72, 128), (48, 1024, 1024), (512, 512, 512), (32, 256, 192), (16, 48, 64),
]


@pytest.mark.parametrize("zyx", GATE_GRIDS, ids=lambda z: "x".join(map(str, z)))
def test_gates_match_jax(zyx):
    """Every copied gate gives the JAX original's answer on the grid and on
    its multigrid coarse level."""
    coarse = tuple(max(n // 2, 1) for n in zyx)
    for shape in (zyx, coarse):
        assert ts.stencil_pallas_supported(shape) == ps.stencil_pallas_supported(shape)
        assert ts.prolong_pallas_supported(shape) == ps.prolong_pallas_supported(shape)
        assert tj.jacobi_packed_supported(shape) == pj.jacobi_packed_supported(shape)
        assert tmg.mg_fused_supported(shape) == jmg.mg_fused_supported(shape)
        for iters in (4, 8, 32, 64):
            assert tj.jacobi_tuning(shape, iters) == pj.jacobi_tuning(shape, iters)
            assert tj.jacobi_rr_supported(shape, iters) == pj.jacobi_rr_supported(shape, iters)
        for inner in (4, 8):
            assert tj._plan_planewise(shape, inner) == pj._plan_planewise(shape, inner)
            for slab in (16, 32):
                assert tj._plan(shape, slab, inner) == pj._plan(shape, slab, inner)
        for vb in (2, 4):
            assert (tj.jacobi_divrr_supported(shape, 4, vb)
                    == pj.jacobi_divrr_supported(shape, 4, vb))
            assert (tj.jacobi_grad_supported(shape, 4, vb)
                    == pj.jacobi_grad_supported(shape, 4, vb))
        assert (tj.jacobi2d_pallas_supported(shape[1:])
                == pj.jacobi2d_pallas_supported(shape[1:]))


# ---------------------------------------------------------------------------
# The projection, one simulate and one frame at zyx (64, 128, 128)
# ---------------------------------------------------------------------------

def _tpu_projection(jf, q, rho=RHO):
    """The projection as the JAX package runs it on its TPU at zyx
    (64, 128, 128), composed from its kernels (interpret mode) and
    `mg._restrict`."""
    tuning = pj.jacobi_tuning(q.shape, jmg.MG_PRE)
    b = ps.divergence_pallas(jf)
    q = pj.jacobi_pallas(q, b, jmg.MG_PRE, *tuning)
    r_c = jmg._restrict(ps.residual_pallas(q, b)) * 4.0
    e_c = pj.jacobi_packed_pallas(jnp.zeros_like(r_c), r_c, jmg.MG_COARSE_ITERS)
    q = ps.prolong_correct_pallas(q, e_c)
    q = pj.jacobi_pallas(q, b, jmg.MG_POST, *tuning)
    return ps.grad_damp_pallas(jf, q, rho), q


def _pin_tpu_path(cfg):
    """The TPU runs all six kernels at this grid: B3/B5/B8, B4 with a
    whole-window plan, B6 on the coarse level, B7; neither B13 nor B18."""
    zyx = cfg.zyx
    coarse = tuple(n // 2 for n in zyx)
    assert ps.stencil_pallas_supported(zyx) and ps.prolong_pallas_supported(zyx)
    assert pj.jacobi_tuning(zyx, jmg.MG_PRE) == (32, 4)
    assert pj.jacobi_tuning(coarse, jmg.MG_COARSE_ITERS) is None
    assert pj.jacobi_packed_supported(coarse)
    assert not pj.jacobi_rr_supported(zyx, jmg.MG_PRE)
    assert not cfg.mg_project_fused
    assert zyx[1] * zyx[2] >= cfg.mg_min_plane and jmg.mg_supported(zyx)


@pytest.fixture
def spies(monkeypatch):
    """Counts the calls of each kernel's plain version in the port."""
    calls = {}
    for mod, name in ((ts, "divergence_plain"), (tj, "jacobi_plain"),
                      (ts, "residual_plain"), (tj, "jacobi_packed_plain"),
                      (ts, "prolong_correct_plain"), (ts, "grad_damp_plain")):
        def spy(*args, _fn=getattr(mod, name), _name=name, **kwargs):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(mod, name, spy)
    return calls


EXPECTED_CALLS = {"divergence_plain": 1, "jacobi_plain": 2, "residual_plain": 1,
                  "jacobi_packed_plain": 1, "prolong_correct_plain": 1,
                  "grad_damp_plain": 1}


@pytest.fixture(scope="module")
def tpu_step():
    """The JAX step as the TPU runs it at GRID, compiled once for the
    module: `backtrace_pallas(..., forces_dt=dt)` then `_tpu_projection`,
    the state rounded to bf16 at the end."""
    cfg = FluidConfig(**GRID)
    _pin_tpu_path(cfg)
    dt = cfg.time_step

    @jax.jit
    def step(f, q):
        f, q = _tpu_projection(backtrace_pallas(f, dt, cfg, forces_dt=dt), q)
        return f.astype(jnp.bfloat16), q

    return step


def test_project_matches_tpu_chain(spies):
    """The port's `project` with pallas_jacobi=True against the TPU chain
    (`_tpu_projection`), from the same bf16 state: fields within one bf16
    ulp at each channel's scale, the colour channels bit equal, pressure
    within 1e-5 * max|p|; each of the six plain versions ran."""
    cfg, tcfg = FluidConfig(**GRID), TorchConfig(**GRID)
    _pin_tpu_path(cfg)
    rng = np.random.default_rng(10)
    jf, tf = _fields(rng, cfg.zyx, umax=0.75)
    jq, tq = _pair(rng, cfg.zyx, scale=0.05)
    ref_f, ref_q = jax.jit(_tpu_projection)(jf, jq)
    ref_f = np.asarray(ref_f.astype(jnp.float32))
    ref_q = np.asarray(ref_q)
    got_f, got_q = tp.project(tf, tq, cfg.time_step, tcfg)
    assert spies == EXPECTED_CALLS
    assert got_f is tf  # B8 updates the velocity channels in place
    got_f = got_f.float().numpy()
    assert bf16_ulps(got_f[:3], ref_f[:3]) <= 1.0
    np.testing.assert_array_equal(got_f[3:], ref_f[3:])
    np.testing.assert_allclose(got_q.numpy(), ref_q, atol=1e-5 * np.abs(ref_q).max(),
                               rtol=0)


def test_simulate_matches_tpu_step(spies, tpu_step):
    """One `simulate` against `backtrace_pallas(..., forces_dt=dt)` followed
    by the TPU's projection chain.  The port hands B1's result to B2 in f32
    where the TPU rounds it to bf16 (ROADMAP.md C2): one bf16 ulp, whose
    effect on the divergence moves the pressure by up to 5e-3 of its scale
    and the projected velocity by one more ulp, as in
    tests/test_torch_sim.py: fields within 2 ulps, pressure within
    5e-3 * max|p|."""
    cfg, tcfg = FluidConfig(**GRID), TorchConfig(**GRID)
    rng = np.random.default_rng(11)
    jf, tf = _fields(rng, cfg.zyx, umax=0.75)
    jq, tq = _pair(rng, cfg.zyx, scale=0.05)
    ref_f, ref_q = tpu_step(jf, jq)
    out = simulate(state_from_numpy(np.asarray(jf.astype(jnp.float32)), tq.numpy(), "cpu"),
                   cfg.time_step, tcfg)
    assert spies == EXPECTED_CALLS
    assert out.fields.dtype == torch.bfloat16
    assert bf16_ulps(out.fields.float().numpy(), np.asarray(ref_f.astype(jnp.float32))) <= 2.0
    ref_q = np.asarray(ref_q)
    np.testing.assert_allclose(out.pressure.numpy(), ref_q,
                               atol=5e-3 * np.abs(ref_q).max(), rtol=0)


def test_frame_matches_tpu_frame(monkeypatch, spies, tpu_step):
    """The port makes a state in 2 CPU frames from rest; then one port
    `step_frame` runs against the JAX frame composed as the TPU runs it:
    `backtrace_pallas` + the projection chain (`tpu_step`) + `render_frame`
    at lod 0 with the fused march kernel forced on for the faces it serves
    (`_FUSED_ON_CPU`).  Image within 2 u8 levels, mean below 0.05, as
    tests/test_torch_frame.py holds the pallas_jacobi=False frame."""
    kw = dict(GRID, viewport=(64, 64))
    cfg, tcfg = FluidConfig(**kw), TorchConfig(**kw)
    _pin_tpu_path(cfg)
    monkeypatch.setattr(jax_slicecomp, "_FUSED_ON_CPU", True)
    fused_faces = []
    fused = jax_composite.composite_resample_pallas

    def spy(volf, *args, **kwargs):
        fused_faces.append(volf.shape[1])
        return fused(volf, *args, **kwargs)

    monkeypatch.setattr(jax_composite, "composite_resample_pallas", spy)
    monkeypatch.setattr(torch_fluidx, "estimate_cube_map_lod",
                        lambda *a, **k: (0, cfg.max_ray_samples))

    port = torch_fluidx.FluidXEngine(tcfg, device="cpu")
    for _ in range(2):
        port.step_frame()
    fields = jnp.asarray(port.state.fields.float().numpy()).astype(jnp.bfloat16)
    pressure = jnp.asarray(port.state.pressure.numpy())
    packed, lod, vis_mask = port.update_frame()
    assert lod == 0
    params = unpack_scene_params(jnp.asarray(packed.numpy()))
    render = jax.jit(functools.partial(
        render_frame, params=params, config=cfg, method=RenderMethod.RAY_MARCH_SEPARATE,
        lod=0, vis_mask=vis_mask, rect=port._screen_rect()))

    ref_f, _ = tpu_step(fields, pressure)
    ref_img = render(ref_f[3:])
    spies.clear()
    img = port.step_frame()
    assert spies == EXPECTED_CALLS
    assert fused_faces, "the fused march kernel served no face"
    assert bf16_ulps(port.state.fields.float().numpy(),
                     np.asarray(ref_f.astype(jnp.float32))) <= 2.0
    assert img.shape == (64, 64, 3)
    diff = np.abs(to_srgb_u8(img).astype(int) - to_srgb_u8(np.asarray(ref_img)).astype(int))
    assert diff.max() <= 2 and diff.mean() < 0.05, (diff.max(), diff.mean())


BAD_CALLS = {
    "divergence": lambda: ts.divergence(torch.zeros((2, 4, 8, 8))),
    "residual": lambda: ts.residual(torch.zeros((4, 8, 8)), torch.zeros((4, 8, 4))),
    "prolong_correct": lambda: ts.prolong_correct(torch.zeros((4, 8, 8)),
                                                  torch.zeros((2, 4, 8))),
    "grad_damp": lambda: ts.grad_damp(torch.zeros((7, 4, 8, 8), dtype=torch.float16),
                                      torch.zeros((4, 8, 8)), RHO),
    "jacobi": lambda: tj.jacobi(torch.zeros((64, 8, 128)), torch.zeros((64, 8, 128)), 6, 32, 4),
    "jacobi_packed": lambda: tj.jacobi_packed(torch.zeros((4, 8, 8), dtype=torch.float64),
                                              torch.zeros((4, 8, 8)), 2),
}


@pytest.mark.parametrize("call", list(BAD_CALLS))
def test_wrappers_reject_bad_arguments(call):
    """Every wrapper checks dtype, shape and contiguity (B4 also that iters
    is a multiple of inner) before dispatch, and counts no launch on the
    CPU."""
    from fluidx12_tpu_torch.ops.cuda import launch_counts

    before = launch_counts()
    with pytest.raises(ValueError):
        BAD_CALLS[call]()
    assert launch_counts() == before
