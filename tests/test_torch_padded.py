"""Grids the TPU stores padded, and the config switches, on the CPU against
the JAX package.

On the TPU every 3D grid with x >= 96 whose dims are not roll-clean lives
in padded storage (fluidx12_tpu/core/padding.py), and its kernel gates see
the storage dims.  The port keeps compact storage and takes, on the
logical grid, the kernels the TPU takes on the storage dims: the copied
`storage_zyx` gate, the projection's padded route (`project_padded` /
`mg_solve_padded`) against the TPU's chain composed from the Pallas
functions with their logical clamps in interpret mode, run on the
zero-padded storage and cropped.  Then the switches: `advect_fuse_xy=False`
runs B11 twice as the TPU's single-axis kernels do, and the switches that
select code the port does not have raise.

XLA on the CPU compiles the kernels' `/ 6.0` as a multiply by fl32(1/6) and
contracts some products into FMAs; the port divides and rounds every
operation as the kernel source is written.  To hold the route to the last
bit, the chain test runs the port's plain versions with XLA's arithmetic
(`xla_arith`); everything else about the route is the port's own.  Inputs
are made with numpy from a seed; each JAX reference is jitted.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluidx12_tpu.core import padding as jpad
from fluidx12_tpu.core.config import FluidConfig
from fluidx12_tpu.ops.pallas import advect as pa
from fluidx12_tpu.ops.pallas import jacobi as pj
from fluidx12_tpu.ops.pallas import stencil as ps
from fluidx12_tpu_torch.core import padding as tpad
from fluidx12_tpu_torch.core.config import FluidConfig as TorchConfig
from fluidx12_tpu_torch.ops.cuda import jacobi as tj
from fluidx12_tpu_torch.ops.cuda import stencil as ts
from fluidx12_tpu_torch.ops.sampling import neighbor_shift
from fluidx12_tpu_torch.sim.advect_fast import advect_fields_fast

jmg = importlib.import_module("fluidx12_tpu.sim.mg")
jpd = importlib.import_module("fluidx12_tpu.sim.padded")
tmg = importlib.import_module("fluidx12_tpu_torch.sim.mg")
tp = importlib.import_module("fluidx12_tpu_torch.sim.project")

RHO = 0.48

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


# ---------------------------------------------------------------------------
# The gate
# ---------------------------------------------------------------------------

STORAGE_GRIDS = [(256, 256, 60), (150, 150, 150), (128, 128, 20), (150, 150, 72),
                 (128, 128, 128), (24, 24, 24), (512, 512, 1), (96, 96, 44),
                 (256, 256, 256), (100, 100, 100), (384, 384, 32), (256, 144, 24)]


@pytest.mark.parametrize("grid", STORAGE_GRIDS, ids=lambda g: "x".join(map(str, g)))
def test_storage_zyx_matches_jax(grid):
    """The port's copies of `padded_zyx` and `storage_zyx` give the JAX
    originals' dims."""
    cfg, tcfg = FluidConfig(grid_size=grid), TorchConfig(grid_size=grid)
    assert tpad.padded_zyx(tcfg) == jpad.padded_zyx(cfg)
    assert tpad.storage_zyx(tcfg) == jpad.storage_zyx(cfg)


# ---------------------------------------------------------------------------
# The padded projection
# ---------------------------------------------------------------------------

SIXTH = np.float32(1.0) / np.float32(6.0)


def _sweeps_times_sixth(q, b, iters, order):
    """Jacobi sweeps in `order` with XLA's compile of `/ 6.0`."""
    (ax0, off0), *rest = tj._ORDERS[order]
    for _ in range(iters):
        s = neighbor_shift(q, ax0, off0)
        for ax, off in rest:
            s = s + neighbor_shift(q, ax, off)
        q = (s - b) * torch.tensor(SIXTH)
    return q


def _residual_fma(q, b):
    """B5 as XLA compiles `b - (s - 6 q)`: s - 6 q is one FMA (the f64
    difference of f32 values, rounded once)."""
    s = neighbor_shift(q, 2, +1) + neighbor_shift(q, 2, -1)
    s = s + neighbor_shift(q, 1, +1) + neighbor_shift(q, 1, -1)
    s = s + neighbor_shift(q, 0, -1) + neighbor_shift(q, 0, +1)
    return b - (s.double() - 6.0 * q.double()).float()


def _prolong_fma(q, e_c):
    """B7 with logical clamps as XLA compiles it: each two-tap dot adds its
    second product by FMA, and so does the odd plane's z lerp."""
    def dot2(lo, hi, w_lo, w_hi):
        return ((w_lo * lo).double() + w_hi.double() * hi.double()).float()

    _, nyc, nxc = e_c.shape
    y_lo, y_hi, wy_lo, wy_hi = ts._prolong_taps(nyc, e_c.device)
    x_lo, x_hi, wx_lo, wx_hi = ts._prolong_taps(nxc, e_c.device)
    a = dot2(e_c[:, y_lo, :], e_c[:, y_hi, :], wy_lo[:, None], wy_hi[:, None])
    up = dot2(a[:, :, x_lo], a[:, :, x_hi], wx_lo, wx_hi)
    lo = torch.cat([up[:1], up[:-1]])
    hi = torch.cat([up[1:], up[-1:]])
    even = 0.25 * lo + 0.75 * up
    odd = (0.75 * up.double() + (0.25 * hi).double()).float()
    return q + torch.stack([even, odd], dim=1).reshape(q.shape)


@pytest.fixture
def xla_arith(monkeypatch):
    """The port's plain versions with XLA's CPU arithmetic, counting their
    calls: the sweeps (B4 and the twin) multiply by fl32(1/6), B5 and B7
    contract as above.  Their neighbour orders and taps stay the port's."""
    calls = {}

    def counted(name, fn):
        def spy(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return spy

    monkeypatch.setattr(tj, "sweeps_plain", _sweeps_times_sixth)
    monkeypatch.setattr(tj, "jacobi_plain",
                        counted("jacobi_plain", tj.jacobi_plain))
    monkeypatch.setattr(tp, "jacobi_sweeps", counted(
        "twin_sweeps", lambda q, b, iters, is_3d: _sweeps_times_sixth(
            q, b, iters, tj.ORDER_PACKED)))
    monkeypatch.setattr(ts, "residual_plain", counted("residual_plain", _residual_fma))
    monkeypatch.setattr(ts, "prolong_correct_plain",
                        counted("prolong_correct_plain", _prolong_fma))
    for mod, name in ((ts, "divergence_plain"), (ts, "grad_damp_plain"),
                      (tj, "jacobi_packed_plain"), (tj, "jacobi_rr_plain"),
                      (tmg, "_prolong")):
        monkeypatch.setattr(mod, name, counted(name, getattr(mod, name)))
    return calls


@functools.partial(jax.jit, static_argnums=(2, 3))
def _smooth_masked(q, b, iters, logical):
    """`sim/padded._smooth_masked` as the TPU takes it: B4 with the storage
    dims' tuning and logical clamps, else the masked twin.  Jitted, so the
    pre- and post-smoother share one lowering."""
    tuning = pj.jacobi_tuning(q.shape, iters)
    if tuning is not None:
        return pj.jacobi_pallas(q, b, iters, *tuning, logical_zyx=logical)
    return jpd.jacobi_sweeps_masked(q, b, iters, logical)


def _tpu_padded_projection(cfg):
    """`project_padded` as the TPU runs it on `cfg`'s storage, composed
    from the Pallas functions with logical clamps (`_stencil_kernels_ok`
    holds there; it is False off the TPU)."""
    zyx = cfg.zyx
    c_log = jpd._coarse_zyx(zyx)

    def run(fields, q):
        b = ps.divergence_pallas(fields, logical_zyx=zyx)
        q = _smooth_masked(q, b, jmg.MG_PRE, zyx)
        r_c = jpd._restrict_padded(ps.residual_pallas(q, b, logical_zyx=zyx)) * 4.0
        e_c = _smooth_masked(jnp.zeros_like(r_c), r_c, jmg.MG_COARSE_ITERS, c_log)
        q = ps.prolong_correct_pallas(q, e_c, logical_czyx=c_log)
        q = _smooth_masked(q, b, jmg.MG_POST, zyx)
        return ps.grad_damp_pallas(fields, q, RHO, logical_zyx=zyx), q, b

    return run


def _logical_state(cfg, seed):
    """A bf16-representable state and an f32 pressure on the logical grid,
    as numpy."""
    rng = np.random.default_rng(seed)
    f = rng.uniform(0.0, 1.0, (7,) + cfg.zyx).astype(np.float32)
    f[:3] = (f[:3] - 0.5) * 1.5
    f = torch.from_numpy(f).to(torch.bfloat16).float().numpy()
    q = (rng.standard_normal(cfg.zyx) * 0.05).astype(np.float32)
    return f, q


def _padded_state(cfg, seed):
    """`_logical_state` and its zero-padded storage copies for JAX."""
    f, q = _logical_state(cfg, seed)
    pad = [(0, s - n) for s, n in zip(jpad.storage_zyx(cfg), cfg.zyx)]
    return f, q, np.pad(f, [(0, 0)] + pad), np.pad(q, pad)


def test_padded_projection_matches_tpu_chain(xla_arith):
    """Grid (128, 128, 20), stored (32, 128, 128) on the TPU.  The port's
    `project` takes the padded route: B3, B4 with the storage dims' tuning
    (16, 4) in its whole-window order, B5, the restriction, the masked twin
    sweeps on the (16, 64, 64) coarse storage (no B4 plan, and the padded
    route never takes B6), B7, B4, B8; never B13 or B18.  Against the TPU's
    chain on the zero-padded storage, cropped: b bit for bit, q bit for bit
    under XLA's arithmetic, velocity within one bf16 ulp at each channel's
    scale (XLA's reciprocal multiply for `/ 0.03`, as tests/test_torch_fused.py
    holds B18), colour untouched."""
    cfg, tcfg = FluidConfig(grid_size=(128, 128, 20)), TorchConfig(grid_size=(128, 128, 20))
    zyx, storage = cfg.zyx, jpad.storage_zyx(cfg)
    coarse = tuple(n // 2 for n in storage)
    assert storage == (32, 128, 128) and ps.stencil_pallas_supported(storage)
    assert pj.jacobi_tuning(storage, 4) == (16, 4) and pj.jacobi_tuning(coarse, 32) is None
    assert ps.prolong_pallas_supported(storage) and tj.jacobi_packed_supported(
        tuple(n // 2 for n in zyx))
    f, q, f_pad, q_pad = _padded_state(cfg, 10)
    ref_f, ref_q, ref_b = (np.asarray(a.astype(jnp.float32))[..., :zyx[0], :zyx[1], :zyx[2]]
                           for a in jax.jit(_tpu_padded_projection(cfg))(
                               jnp.asarray(f_pad).astype(jnp.bfloat16), jnp.asarray(q_pad)))
    fields = torch.from_numpy(f).to(torch.bfloat16)
    np.testing.assert_array_equal(ts.divergence(fields).numpy(), ref_b)
    xla_arith.clear()
    got_f, got_q = tp.project(fields, torch.from_numpy(q), cfg.time_step, tcfg)
    assert xla_arith == {"divergence_plain": 1, "jacobi_plain": 2, "residual_plain": 1,
                         "twin_sweeps": 1, "prolong_correct_plain": 1,
                         "grad_damp_plain": 1}
    assert got_f is fields
    np.testing.assert_array_equal(got_q.numpy(), ref_q)
    got_f = got_f.float().numpy()
    assert bf16_ulps(got_f[:3], ref_f[:3]) <= 1.0
    np.testing.assert_array_equal(got_f[3:], ref_f[3:])


def test_padded_projection_takes_twin_prolongation_as_fluidgi(xla_arith):
    """Grid (150, 150, 72), stored (80, 160, 256) as 150^3 is stored
    (160, 160, 256): B7's gate fails on the storage dims, so the TPU
    prolongs with the twin over the logical coarse extent
    (`_prolong_padded`).  The port's `project` takes that route by the
    gates: B3, B4 with the storage dims' tuning in the plane-sweep order,
    B5, B4 on the coarse storage (40, 80, 128) in its whole-window order,
    the twin prolongation, B4, B8.  Its prolongation of a coarse
    correction with the TPU's ghosts (random) equals `_prolong_padded`'s
    on the logical grid within 1e-6 of the scale: the same two taps, but
    XLA's dot adds the second one by FMA where torch's contraction rounds
    both products."""
    cfg, tcfg = FluidConfig(grid_size=(150, 150, 72)), TorchConfig(grid_size=(150, 150, 72))
    zyx, storage = cfg.zyx, jpad.storage_zyx(cfg)
    coarse = tuple(n // 2 for n in storage)
    assert storage == (80, 160, 256) and ps.stencil_pallas_supported(storage)
    assert not ps.prolong_pallas_supported(storage)
    assert tj.window_order(storage, pj.jacobi_tuning(storage, 4)[1]) == tj.ORDER_PLANEWISE
    assert tj.window_order(coarse, pj.jacobi_tuning(coarse, 32)[1]) == tj.ORDER_WINDOW
    f, q = _logical_state(cfg, 11)
    orders = []
    plain = tj.window_order
    tj_spy = lambda shape, inner: orders.append(tuple(shape)) or plain(shape, inner)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tj, "window_order", tj_spy)
        got_f, got_q = tp.project(torch.from_numpy(f).to(torch.bfloat16), torch.from_numpy(q),
                                  cfg.time_step, tcfg)
    assert xla_arith == {"divergence_plain": 1, "jacobi_plain": 3, "residual_plain": 1,
                         "_prolong": 1, "grad_damp_plain": 1}
    assert orders.count(storage) >= 2 and coarse in orders
    assert bool(torch.isfinite(got_q).all()) and bool(torch.isfinite(got_f.float()).all())

    c_log = jpd._coarse_zyx(zyx)
    e_c = np.random.default_rng(12).standard_normal(coarse).astype(np.float32)
    ref = np.asarray(jax.jit(jpd._prolong_padded, static_argnums=1)(jnp.asarray(e_c), c_log))
    got = tmg._prolong(torch.from_numpy(e_c[:c_log[0], :c_log[1], :c_log[2]].copy()))
    ref = ref[:zyx[0], :zyx[1], :zyx[2]]
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6 * np.abs(ref).max(), rtol=0)


# ---------------------------------------------------------------------------
# The switches
# ---------------------------------------------------------------------------

def test_advect_unfused_xy_matches_tpu_single_axis_passes(monkeypatch):
    """`advect_fuse_xy=False` at grid (128, 16, 16): the TPU runs x and
    then y as single-axis kernels, each rounded to storage, then the z
    pass with the forces (`backtrace_pallas`, interpret mode); the port
    runs B11 twice and B2.  Bit for bit in bf16, B11 twice and B1 never."""
    kw = dict(grid_size=(128, 16, 16), advect_fuse_xy=False)
    cfg, tcfg = FluidConfig(**kw), TorchConfig(**kw)
    assert pa.zpass_forces_supported(cfg)
    jax_passes = []
    fused = pa._run_pass_fused
    monkeypatch.setattr(pa, "_run_pass_fused", lambda *a, **k: jax_passes.append(
        k["axis"]) or fused(*a, **k))
    rng = np.random.default_rng(13)
    f = rng.uniform(0.0, 1.0, (7,) + cfg.zyx).astype(np.float32)
    f[:3] = (f[:3] - 0.5) * 2.0
    jv = jnp.asarray(f).astype(jnp.bfloat16)
    dt = cfg.time_step
    ref = np.asarray(jax.jit(lambda v: pa.backtrace_pallas(v, dt, cfg, forces_dt=dt))(jv)
                     .astype(jnp.float32))
    assert jax_passes == [3, 2]

    from fluidx12_tpu_torch.ops.cuda import advect as ta

    calls = []
    for name in ("advect_axis_plain", "advect_xy_plain"):
        plain = getattr(ta, name)
        monkeypatch.setattr(ta, name, lambda *a, _fn=plain, _n=name: calls.append(_n) or _fn(*a))
    tv = torch.from_numpy(np.array(jv.astype(jnp.float32))).to(torch.bfloat16)
    got = advect_fields_fast(tv, torch.tensor(dt, dtype=torch.float32), tcfg)
    assert calls == ["advect_axis_plain"] * 2
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), ref)
