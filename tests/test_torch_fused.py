"""The port's fused projection, kernel B18, on the CPU: the plain versions
of its two halves (`jacobi_divrr`, `jacobi_grad`) against the JAX
package's Pallas kernels in interpret mode, and the port's `project` with
`mg_project_fused` against JAX's `mg_project_fused`, on bf16 storage at
zyx (32, 144, 256), as tests/test_pallas.py holds the kernels (ny = 144
gives the TPU windows of all three y-shifts; 5 channels check the velocity
addressing of the combined state); the copied gates against the JAX
originals.

XLA on the CPU compiles the kernels' `/ 6.0` as a multiply by fl32(1/6) and
contracts `b - (s - 6q)` into an FMA; the port divides and rounds every
operation as the kernel source is written.  The tolerances below say where
that shows.  Inputs are made with numpy from a seed; the JAX reference is
compiled and run once per module.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluidx12_tpu.ops.pallas import jacobi as pj
from fluidx12_tpu.ops.pallas import stencil as ps
from fluidx12_tpu_torch.core.config import FluidConfig as TorchConfig
from fluidx12_tpu_torch.ops.cuda import jacobi as tj
from fluidx12_tpu_torch.ops.cuda import stencil as ts
from fluidx12_tpu_torch.ops.sampling import neighbor_shift

jmg = importlib.import_module("fluidx12_tpu.sim.mg")
tmg = importlib.import_module("fluidx12_tpu_torch.sim.mg")
tp = importlib.import_module("fluidx12_tpu_torch.sim.project")

RHO = 0.48
SHAPE = (32, 144, 256)
GRID = dict(grid_size=(256, 144, 32))

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


def _pin_fused_route():
    """The TPU takes B18 at SHAPE on bf16 storage, and its coarse level
    (16, 72, 128) has neither a B4 plan nor B6's packing, so JAX's
    `mg_project_fused` on the CPU (whose coarse smoother is the twin) is
    the TPU's chain."""
    coarse = tuple(n // 2 for n in SHAPE)
    assert jmg.mg_fused_supported(SHAPE, vel_bytes=2)
    assert ps.stencil_pallas_supported(SHAPE)
    assert pj.jacobi_tuning(coarse, jmg.MG_COARSE_ITERS) is None
    assert not pj.jacobi_packed_supported(coarse)


@pytest.fixture(scope="module")
def chain():
    """A bf16 (5, 32, 144, 256) state and an f32 pressure, and JAX's
    `mg_project_fused` on them, jitted, with the inputs and outputs of its
    two B18 kernels (interpret mode) captured on the way."""
    _pin_fused_route()
    rng = np.random.default_rng(23)
    f = rng.uniform(-0.75, 0.75, (5,) + SHAPE).astype(np.float32)
    jf = jnp.asarray(f).astype(jnp.bfloat16)
    q = rng.standard_normal(SHAPE).astype(np.float32)
    seen = {}

    def capture(name, fn):
        def spy(*args, **kwargs):
            out = fn(*args, **kwargs)
            seen[name] = (args, out)
            return out
        return spy

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pj, "jacobi_pallas_divrr", capture("divrr", pj.jacobi_pallas_divrr))
        mp.setattr(pj, "jacobi_pallas_grad", capture("grad", pj.jacobi_pallas_grad))

        @jax.jit
        def run(jf, jq):
            fields, q_out = jmg.mg_project_fused(jf, jq, RHO)
            (_, _, iters), _ = seen["divrr"]
            assert iters == jmg.MG_PRE and seen["grad"][0][3] == jmg.MG_POST
            q_in, b_in, _, _, _ = seen["grad"][0]
            return fields, q_out, seen["divrr"][1], (q_in, b_in)

        fields, q_out, divrr, grad_in = run(jf, jnp.asarray(q))
    as_np = lambda a: np.array(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
    return dict(
        fields=torch.from_numpy(as_np(jf)).to(torch.bfloat16), q=torch.from_numpy(q),
        ref_fields=as_np(fields), ref_q=as_np(q_out),
        divrr=tuple(as_np(a) for a in divrr), grad_in=tuple(as_np(a) for a in grad_in))


def _sweeps_times_sixth(q, b, iters):
    """B4's plane-sweep sweeps with XLA's compile of `/ 6.0`, a multiply by
    fl32(1/6)."""
    sixth = torch.tensor(np.float32(1.0) / np.float32(6.0))
    (ax0, off0), *rest = tj._ORDERS[tj.ORDER_PLANEWISE]
    for _ in range(iters):
        s = neighbor_shift(q, ax0, off0)
        for ax, off in rest:
            s = s + neighbor_shift(q, ax, off)
        q = (s - b) * sixth
    return q


def test_jacobi_divrr_matches_pallas(chain):
    """B18's head, plain, vs `jacobi_pallas_divrr(fields, q, 4, scale=4)`:
    b bit for bit (the prologue sums as B3 does, one rounding each); q
    bit for bit when swept with XLA's multiply by fl32(1/6), within 2e-6
    of its scale with the port's true division; r_c within 1e-6 of its
    scale (XLA's FMA in `b - (s - 6q)`).  The JAX test allows 1e-5 on q
    and b and 1e-4 on r_c."""
    ref_q, ref_b, ref_rc = chain["divrr"]
    got_q, got_b, got_rc = tj.jacobi_divrr(chain["fields"], chain["q"], 4, scale=4.0)
    assert got_rc.shape == tuple(n // 2 for n in SHAPE)
    np.testing.assert_array_equal(got_b.numpy(), ref_b)
    np.testing.assert_array_equal(_sweeps_times_sixth(chain["q"], got_b, 4).numpy(), ref_q)
    np.testing.assert_allclose(got_q.numpy(), ref_q, atol=2e-6 * np.abs(ref_q).max(), rtol=0)
    np.testing.assert_allclose(got_rc.numpy(), ref_rc, atol=1e-6 * np.abs(ref_rc).max(),
                               rtol=0)


def test_jacobi_grad_matches_pallas(chain):
    """B18's tail, plain, vs `jacobi_pallas_grad(q, b, fields, 4, 0.48)` on
    the same (q, b) and bf16 state: q within 2e-6 of its scale (true
    division against XLA's reciprocal multiply), the velocity within one
    bf16 ulp at each channel's scale, updated in place, channels 3..4 bit
    equal.  The JAX test allows 1e-5 on q and 1e-4 on f32 velocity."""
    q_in, b_in = (torch.from_numpy(a) for a in chain["grad_in"])
    fields = chain["fields"].clone()
    got_q, got_f = tj.jacobi_grad(q_in, b_in, fields, 4, RHO)
    assert got_f is fields and got_f.dtype == torch.bfloat16
    ref_q = chain["ref_q"]
    np.testing.assert_allclose(got_q.numpy(), ref_q, atol=2e-6 * np.abs(ref_q).max(), rtol=0)
    got_f = got_f.float().numpy()
    assert bf16_ulps(got_f[:3], chain["ref_fields"][:3]) <= 1.0
    np.testing.assert_array_equal(got_f[3:], chain["ref_fields"][3:])


@pytest.fixture
def calls(monkeypatch):
    """Counts the calls of B18's plain versions and of the unfused chain's
    B3, B13 and B8 wrappers."""
    seen = {}
    for mod, name in ((tj, "jacobi_divrr_plain"), (tj, "jacobi_grad_plain"),
                      (ts, "divergence"), (tmg, "jacobi_rr"), (ts, "grad_damp")):
        def spy(*args, _fn=getattr(mod, name), _name=name, **kwargs):
            seen[_name] = seen.get(_name, 0) + 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(mod, name, spy)
    return seen


def test_project_fused_matches_jax(chain, calls):
    """The port's `project` with mg_project_fused=True against JAX's
    `mg_project_fused` (the TPU's chain at this grid, `_pin_fused_route`):
    each half of B18 ran once and none of B3, B13, B8; the state is updated
    in place; fields within one bf16 ulp at each channel's scale (the JAX
    test allows 0.03), the colour channels bit equal, pressure within
    1e-5 of its scale (the JAX test allows 1e-4 absolute)."""
    cfg = TorchConfig(mg_project_fused=True, **GRID)
    fields = chain["fields"].clone()
    got_f, got_q = tp.project(fields, chain["q"], cfg.time_step, cfg)
    assert calls == {"jacobi_divrr_plain": 1, "jacobi_grad_plain": 1}
    assert got_f is fields
    got_f = got_f.float().numpy()
    assert bf16_ulps(got_f[:3], chain["ref_fields"][:3]) <= 1.0
    np.testing.assert_array_equal(got_f[3:], chain["ref_fields"][3:])
    ref_q = chain["ref_q"]
    np.testing.assert_allclose(got_q.numpy(), ref_q, atol=1e-5 * np.abs(ref_q).max(), rtol=0)


def test_fused_projection_equals_unfused(chain, calls):
    """B18 computes what the unfused chain computes, in the same order: the
    divergence prologue sums as B3, the sweeps are B13's and B4's
    plane-sweep order, the epilogue is B8's arithmetic.  So the port's
    fused `project` equals its unfused one (B3 -> B13 -> B4 -> B7 -> B4 ->
    B8) bit for bit, as core/config.py:133 says of the TPU kernels."""
    fused = TorchConfig(mg_project_fused=True, **GRID)
    unfused = TorchConfig(**GRID)
    f_fused, q_fused = tp.project(chain["fields"].clone(), chain["q"], fused.time_step, fused)
    f_unfused, q_unfused = tp.project(chain["fields"].clone(), chain["q"], unfused.time_step,
                                      unfused)
    assert calls == {"jacobi_divrr_plain": 1, "jacobi_grad_plain": 1, "divergence": 1,
                     "jacobi_rr": 1, "grad_damp": 1}
    assert torch.equal(f_fused, f_unfused)
    assert torch.equal(q_fused, q_unfused)


FUSED_GATE_GRIDS = [(256, 256, 256), (60, 256, 256), (32, 256, 256), (20, 128, 128),
                    (32, 144, 256), (128, 128, 128), (64, 256, 256), (24, 256, 256),
                    (192, 256, 256), (16, 256, 256)]


@pytest.mark.parametrize("zyx", FUSED_GATE_GRIDS, ids=lambda z: "x".join(map(str, z)))
def test_fused_gates_match_jax(zyx):
    """`mg_fused_supported` and B18's two gates give the JAX originals'
    answers, for bf16 and f32 storage."""
    for vb in (2, 4):
        assert tmg.mg_fused_supported(zyx, vel_bytes=vb) == jmg.mg_fused_supported(
            zyx, vel_bytes=vb)
        for iters in (4, 8):
            assert (tj.jacobi_divrr_supported(zyx, iters, vb)
                    == pj.jacobi_divrr_supported(zyx, iters, vb))
            assert (tj.jacobi_grad_supported(zyx, iters, vb)
                    == pj.jacobi_grad_supported(zyx, iters, vb))


BAD_CALLS = {
    "divrr_odd": lambda: tj.jacobi_divrr(torch.zeros((7, 4, 8, 9)), torch.zeros((4, 8, 9)), 2),
    "divrr_fields": lambda: tj.jacobi_divrr(torch.zeros((7, 4, 8, 6)), torch.zeros((4, 8, 8)),
                                            2),
    "divrr_dtype": lambda: tj.jacobi_divrr(torch.zeros((7, 4, 8, 8), dtype=torch.float16),
                                           torch.zeros((4, 8, 8)), 2),
    "grad_b": lambda: tj.jacobi_grad(torch.zeros((4, 8, 8)), torch.zeros((4, 8, 4)),
                                     torch.zeros((7, 4, 8, 8)), 2, RHO),
    "grad_iters": lambda: tj.jacobi_grad(torch.zeros((4, 8, 8)), torch.zeros((4, 8, 8)),
                                         torch.zeros((7, 4, 8, 8)), -1, RHO),
}


@pytest.mark.parametrize("call", list(BAD_CALLS))
def test_b18_wrappers_reject_bad_arguments(call):
    """B18's wrappers check dtype, shape, even dims and iters before
    dispatch, and count no launch on the CPU."""
    from fluidx12_tpu_torch.ops.cuda import launch_counts

    before = launch_counts()
    with pytest.raises(ValueError):
        BAD_CALLS[call]()
    assert launch_counts() == before
