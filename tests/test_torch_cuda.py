"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked `cuda`: without a CUDA device every test here skips; on the
GPU machine run them with
`python -m pytest tests/test_torch_cuda.py -m cuda --noconftest` (that
machine has no JAX, which tests/conftest.py imports).  chip_smoke.py makes
the same comparison at the presets' full shapes."""

from pathlib import Path

import numpy as np
import pytest
import torch

from fluidx12_tpu_torch.core.config import FluidConfig
from fluidx12_tpu_torch.ops.cuda import advect as A
from fluidx12_tpu_torch.ops.cuda import composite as C
from fluidx12_tpu_torch.ops.cuda import jacobi as J
from fluidx12_tpu_torch.ops.cuda import stencil as ST
from fluidx12_tpu_torch.ops.cuda import sweep as S

pytestmark = pytest.mark.cuda

# Several pytest workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def test_advect_kernels_match_plain(dev):
    """B1 bit-exact (same f32 operations); B2 within one bf16 ulp (expf)."""
    cfg = FluidConfig(grid_size=(64, 64, 32))
    rng = np.random.default_rng(0)
    f = rng.uniform(0, 1, (7,) + cfg.zyx).astype(np.float32)
    f[:3] = (f[:3] - 0.5) * 6.0
    vol = torch.from_numpy(f).to(dev, torch.bfloat16)
    dt = torch.tensor(cfg.time_step, device=dev)
    z, y, x = cfg.zyx
    scales = torch.stack([dt * x, dt * y])
    xy = A.advect_xy(vol, scales)
    assert torch.equal(xy, A.advect_xy_plain(vol, scales))
    args = (torch.stack([dt * z, dt]), torch.from_numpy(A.forces_table(cfg)).to(dev),
            A.force_consts(cfg))
    got = A.advect_z_forces(xy, *args).float()
    ref = A.advect_z_forces_plain(xy, *args).float()
    assert float((got - ref).abs().max()) <= 2.0 ** -7
    # B12: the z pass alone, no transcendental: bit for bit.
    assert torch.equal(A.advect_z(xy, args[0]),
                       A.advect_z_forces_plain(xy, args[0], None, None, forces=False))


def test_shear_scan_matches_plain(dev):
    rng = np.random.default_rng(1)
    log_att = torch.from_numpy(-rng.uniform(0, 2, (32, 16, 128)).astype(np.float32)).to(dev)
    s = torch.tensor([0.4, -0.7, 0.0, 128.0], device=dev)
    torch.testing.assert_close(S.shear_scan(log_att, s), S.shear_scan_plain(log_att, s),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("flip", [False, True])
def test_composite_resample_matches_plain(dev, flip):
    rng = np.random.default_rng(2)
    ns, a, b, r1, r2 = 16, 64, 64, 48, 40
    volf = torch.from_numpy(rng.uniform(0, 1, (4, ns, a, b)).astype(np.float32)
                            ).to(dev, torch.bfloat16)
    h_rows = torch.from_numpy(rng.uniform(-3, a + 2, (ns, r1)).astype(np.float32)).to(dev)
    h_cols = torch.from_numpy(rng.uniform(-3, b + 2, (ns, r2)).astype(np.float32)).to(dev)
    valid = torch.ones(ns, device=dev)
    nst = torch.from_numpy(rng.uniform(0.5, 2, (r1, r2)).astype(np.float32)).to(dev)
    args = (volf, h_rows, h_cols, valid, nst, 0.8, flip)
    torch.testing.assert_close(C.composite_resample(*args), C.composite_resample_plain(*args),
                               atol=2e-3, rtol=0)


def _randn(dev, shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_projection_stencils_match_plain(dev, dtype):
    """B3, B5 and B7 bit for bit (the same f32 operations, each rounded);
    B8 within one bf16 ulp of each velocity value, in place, colour
    channels untouched."""
    shape = (16, 32, 128)
    fields = _randn(dev, (7,) + shape, 3).to(dtype)
    q, b = _randn(dev, shape, 4), _randn(dev, shape, 5)
    e_c = _randn(dev, tuple(n // 2 for n in shape), 6)
    assert torch.equal(ST.divergence(fields), ST.divergence_plain(fields))
    assert torch.equal(ST.residual(q, b), ST.residual_plain(q, b))
    assert torch.equal(ST.prolong_correct(q, e_c), ST.prolong_correct_plain(q, e_c))
    got = ST.grad_damp(fields.clone(), q, 0.48)
    ref = ST.grad_damp_plain(fields.clone(), q, 0.48)
    assert torch.equal(got[3:], fields[3:])
    ulp = (ref[:3].float().abs() * 2.0 ** -7).clamp_min(2.0 ** -126)
    assert bool(((got[:3].float() - ref[:3].float()).abs() <= ulp).all())


@pytest.mark.parametrize("shape,iters,plan", [((64, 32, 128), 4, (32, 4)),
                                              ((32, 64, 128), 8, (16, 8)),
                                              ((24, 136, 128), 8, (8, 8)),
                                              ((16, 48, 64), 32, None)])
def test_jacobi_kernels_match_plain(dev, shape, iters, plan):
    """B4 (whole-window and plane-sweep orders) and B6 (the twin's order)
    against their plain versions: the same neighbour order and true
    divisions on both sides, so bit for bit (chip_smoke.py allows 1e-5 of
    the scale)."""
    q, b = _randn(dev, shape, 7), _randn(dev, shape, 8)
    if plan is None:
        got, ref = J.jacobi_packed(q, b, iters), J.jacobi_packed_plain(q, b, iters)
    else:
        got, ref = J.jacobi(q, b, iters, *plan), J.jacobi_plain(q, b, iters, *plan)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("zyx", [(1, 64, 128), (8, 32, 64)])
def test_advect_axis_matches_plain(dev, zyx, dtype):
    """B11 on every axis of a 2D plane and a 3D volume (the z stride),
    displacements past the 12-voxel clip: bit for bit (the same f32
    operations, one rounding to storage)."""
    rng = np.random.default_rng(9)
    f = rng.uniform(0, 1, (7,) + zyx).astype(np.float32)
    f[:3] = (f[:3] - 0.5) * 3.0
    vol = torch.from_numpy(f).to(dev, dtype)
    scale = torch.tensor(8.0, device=dev)
    for axis, ch in ((2, 0), (1, 1), (0, 2)):
        got = A.advect_axis(vol, scale, axis, ch)
        assert got.dtype == dtype
        assert torch.equal(got, A.advect_axis_plain(vol, scale, axis, ch))


@pytest.mark.parametrize("shape", [(128, 128), (8, 256)])
def test_jacobi2d_matches_plain(dev, shape):
    """B14, 16 sweeps: the same sum order and an exact division by 4 on
    both sides, so bit for bit."""
    q, b = _randn(dev, shape, 10), _randn(dev, shape, 11)
    assert torch.equal(J.jacobi2d(q, b, 16), J.jacobi2d_plain(q, b, 16))


@pytest.mark.parametrize("shape", [(24, 144, 128), (16, 64, 128)])
def test_jacobi_rr_matches_plain(dev, shape):
    """B13, 4 sweeps in the plane-sweep order then the residual and its
    restriction x4: the same f32 operations in the same order on both
    sides, so q and r_c bit for bit."""
    q, b = _randn(dev, shape, 12, 0.05), _randn(dev, shape, 13)
    got_q, got_rc = J.jacobi_rr(q, b, 4, 4.0)
    ref_q, ref_rc = J.jacobi_rr_plain(q, b, 4, 4.0)
    assert got_rc.shape == tuple(n // 2 for n in shape)
    assert torch.equal(got_q, ref_q) and torch.equal(got_rc, ref_rc)


def test_gi_light_matches_plain(dev):
    """B16 on a smooth density with an empty slab (radial fallback, zero
    ambient) and a rotated world: within 1e-6 of the scale (both sides take
    a correctly rounded 1 / sqrt; chip_smoke.py holds it at 256^3)."""
    shape = (16, 32, 128)
    dens = _randn(dev, shape, 14).abs() * 0.3
    for ax in range(3):
        dens = (dens.roll(1, ax) + dens + dens.roll(-1, ax)) / 3.0
    dens[4:7] = 0.0
    shadow = _randn(dev, shape, 15).abs().clamp(max=1.0)
    ao = _randn(dev, shape, 16).abs().clamp(max=1.0)
    sh = _randn(dev, (9, 3), 17, 0.2)
    rot = torch.tensor([[0.8, 0.6, 0.0], [-0.6, 0.8, 0.0], [0.0, 0.0, 1.0]], device=dev) * 10.0
    env = torch.tensor([3.0, 2.1, 0.9], device=dev)
    got = ST.gi_light(dens, shadow, ao, sh, rot, env, 0.01)
    ref = ST.gi_light_plain(dens, shadow, ao, sh, rot, env, 0.01)
    assert got.shape == (3,) + shape
    assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_jacobi_divrr_and_grad_match_plain(dev, dtype):
    """B18's head: q, b and r_c bit for bit (B3's and B13's f32 operations
    in their order); its tail: q bit for bit, the velocity within one bf16
    ulp of each value as B8, in place, the colour channel untouched."""
    shape = (24, 144, 128)
    fields = _randn(dev, (4,) + shape, 18).to(dtype)
    q, b = _randn(dev, shape, 19, 0.05), _randn(dev, shape, 20)
    got = J.jacobi_divrr(fields, q, 4, 4.0)
    ref = J.jacobi_divrr_plain(fields, q, 4, 4.0)
    assert got[2].shape == tuple(n // 2 for n in shape)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    got_q, got_f = J.jacobi_grad(q, b, fields.clone(), 4, 0.48)
    ref_q, ref_f = J.jacobi_grad_plain(q, b, fields.clone(), 4, 0.48)
    assert torch.equal(got_q, ref_q) and torch.equal(got_f[3:], fields[3:])
    ulp = (ref_f[:3].float().abs() * 2.0 ** -7).clamp_min(2.0 ** -126)
    assert bool(((got_f[:3].float() - ref_f[:3].float()).abs() <= ulp).all())


def test_gradient3_matches_plain(dev):
    """B15 bit for bit: one difference and one exact scale per value."""
    q = _randn(dev, (30, 32, 128), 21)
    assert torch.equal(ST.gradient3(q), ST.gradient3_plain(q))


@pytest.mark.parametrize("flip", [False, True])
def test_composite_matches_plain(dev, flip):
    """B17 on a bf16 stack premasked with an empty slice: within 2e-6 of the
    scale (expf and log1pf)."""
    rng = np.random.default_rng(22)
    ns, r1, r2 = 24, 16, 256
    dens = torch.from_numpy(rng.uniform(-0.1, 1, (ns, r1, r2)).astype(np.float32))
    dens[5] = 0.0
    prod = torch.from_numpy(rng.uniform(0, 1, (3, ns, r1, r2)).astype(np.float32))
    nst = torch.from_numpy(rng.uniform(0.5, 2, (r1, r2)).astype(np.float32)).to(dev)
    args = (dens.to(dev, torch.bfloat16), prod.to(dev, torch.bfloat16), nst, 0.8, flip)
    got, ref = C.composite(*args), C.composite_plain(*args)
    assert float((got - ref).abs().max()) <= 2e-6 * float(ref.abs().max())


@pytest.mark.parametrize("path", ["fused", "slab"])
def test_new_paths_launch_their_kernels(dev, path):
    """One frame of the fused-projection 256^3 path (B18's two halves once,
    none of B3, B13, B8 or B4's plane-sweep order) and of the 256x256x60 GI
    frame (B15 once, B17 on the three X and Y faces the default camera
    sees, B10 on Z+, no B16 or B13)."""
    from fluidx12_tpu_torch.engine.fluidx import FluidXEngine
    from fluidx12_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    if path == "fused":
        engine = FluidXEngine(FluidConfig(grid_size=(256, 256, 256), mg_project_fused=True),
                              device=dev)
        want = dict(jacobi_divrr=1, jacobi_grad=1, jacobi=1, prolong_correct=1, divergence=0,
                    jacobi_rr=0, grad_damp=0, residual=0, jacobi_planewise=0)
    else:
        rad = np.load(Path(__file__).resolve().parents[1] / "assets" / "rnl_cross.npz")[
            "radiance"]
        engine = FluidXEngine(FluidConfig(grid_size=(256, 256, 60), has_light_probe=True),
                              radiance=rad, device=dev)
        want = dict(gradient3=1, composite=3, composite_resample=1, gi_light=0, jacobi_rr=0,
                    jacobi=1, jacobi_planewise=0)
    engine.update_frame()
    reset_launch_counts()
    image = engine.step_frame()
    torch.cuda.synchronize()
    counts = launch_counts()
    assert {k: counts[k] for k in want} == want
    assert bool(torch.isfinite(image).all())
