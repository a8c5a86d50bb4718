"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked `cuda`: without a CUDA device every test here skips; on the
GPU machine run them with
`python -m pytest tests/test_torch_cuda.py -m cuda --noconftest` (that
machine has no JAX, which tests/conftest.py imports).  chip_smoke.py makes
the same comparison at the presets' full shapes."""

import dataclasses
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
from fluidx12_tpu_torch.render.slicecomp import sample_face_inputs
from fluidx12_tpu_torch.utils.compare import bf16_ulps, few_off

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


def _advect_state(dev, zyx, seed):
    """A bf16 (7, Z, Y, X) state whose velocities carry half the volume
    (scale 8) past the 12-voxel clip, and its B1/B2 arguments."""
    rng = np.random.default_rng(seed)
    f = rng.uniform(0, 1, (7,) + zyx).astype(np.float32)
    f[:3] = (f[:3] - 0.5) * 6.0
    f[:3, :, : zyx[1] // 2] *= 0.25
    cfg = FluidConfig(grid_size=zyx[::-1])
    scal = torch.tensor([8.0, cfg.time_step], device=dev)
    return (torch.from_numpy(f).to(dev, torch.bfloat16), torch.tensor([8.0, 8.0], device=dev),
            scal, torch.from_numpy(A.forces_table(cfg)).to(dev), A.force_consts(cfg))


def _forced_plan(zyx, xy_tile, z_tile, warps):
    """`advect_plan`'s bf16 plan on zyx with its tiles and warps forced and
    the rest made to agree with them, as the C launches require."""
    nz, ny, _ = zyx
    halo = A.HALO_LO + A.HALO_HI
    return A.advect_plan(zyx, torch.bfloat16)._replace(
        xy_tile=xy_tile, xy_warps=warps, xy_smem=A.xy_smem(7, True, min(ny, xy_tile + halo)),
        xy_grid=(-(-zyx[2] // A.STRIP), -(-ny // xy_tile), nz), z_tile=z_tile, z_warps=warps,
        z_smem=A.z_smem(7, min(nz, z_tile + halo)),
        z_grid=(-(-zyx[2] // A.STRIP), ny, -(-nz // z_tile)))


def _launch_xy(vol, scales, plan):
    """fx_advect_xy on the bf16 vol with `plan` as given: (error, output)."""
    from fluidx12_tpu_torch.ops.cuda import _build

    out = torch.empty(vol.shape, dtype=torch.float32, device=vol.device)
    err = _build.lib().fx_advect_xy(vol.data_ptr(), out.data_ptr(), scales.data_ptr(), 1,
                                    *vol.shape, plan.xy_tile, plan.xy_warps, plan.xy_smem,
                                    _build.stream_ptr(vol))
    return err, out


def _launch_z(xy, scal, plan, table=None, consts=None):
    """fx_advect_z_forces into bf16 with `plan` as given, the forces on
    where a table is given: (error, output)."""
    from fluidx12_tpu_torch.ops.cuda import _build

    out = torch.empty(xy.shape, dtype=torch.bfloat16, device=xy.device)
    forces = table is not None
    err = _build.lib().fx_advect_z_forces(
        xy.data_ptr(), out.data_ptr(), scal.data_ptr(), table.data_ptr() if forces else None,
        *(consts if forces else (0.0,) * 5), int(forces), 1, *xy.shape, plan.z_tile,
        plan.z_warps, plan.z_smem, _build.stream_ptr(xy))
    return err, out


@pytest.mark.parametrize("zyx", [(32, 64, 64), (20, 38, 150)])
@pytest.mark.parametrize("forced", [False, True])
def test_advect_windows_match_plain(dev, zyx, forced):
    """B1 (one launch, the y taps from the x-pass tile) and B12 bit for
    bit, B2 within one bf16 ulp (expf), with velocities past the clip: at
    (32, 64, 64) and at a ragged (20, 38, 150), whose Z = 20 is shorter
    than the 26-plane window; through the wrappers with the plan's tiles,
    and through the C launches with small forced tiles of 3 warps whose
    windows end inside the volume."""
    vol, scales, scal, table, consts = _advect_state(dev, zyx, 21)
    want_xy = A.advect_xy_plain(vol, scales)
    if forced:
        plan = _forced_plan(zyx, 8, 7, 3)
        (e1, xy), (e2, got), (e12, z) = (_launch_xy(vol, scales, plan),
                                         _launch_z(want_xy, scal, plan, table, consts),
                                         _launch_z(want_xy, scal, plan))
        assert (e1, e2, e12) == (0, 0, 0)
    else:
        xy = A.advect_xy(vol, scales)
        got = A.advect_z_forces(want_xy, scal, table, consts)
        z = A.advect_z(want_xy, scal)
    assert torch.equal(xy, want_xy)
    assert bf16_ulps(got, A.advect_z_forces_plain(want_xy, scal, table, consts)) <= 1.0
    assert torch.equal(z, A.advect_z_forces_plain(want_xy, scal, None, None, forces=False))


def test_advect_perthread_yardsticks_match_plain(dev):
    """The designs B1 and B2 replaced (`advect.perthread`), kept as
    yardsticks, still compute their functions: B1's and B12's bit for bit,
    B2's within one bf16 ulp."""
    vol, scales, scal, table, consts = _advect_state(dev, (20, 38, 150), 22)
    xy = A.perthread("xy", vol, scales)
    assert torch.equal(xy, A.advect_xy_plain(vol, scales))
    assert bf16_ulps(A.perthread("z_forces", xy, scal, table, consts),
                 A.advect_z_forces_plain(xy, scal, table, consts)) <= 1.0
    assert torch.equal(A.perthread("z", xy, scal),
                       A.advect_z_forces_plain(xy, scal, None, None, forces=False))


def test_advect_refuses_a_plan_it_cannot_run(dev):
    """`fx_advect_xy` and `fx_advect_z_forces` refuse a plan whose shared
    memory is not its tile's, or one of more or fewer warps than they
    compile for, and launch the plan that `advect_plan` gives."""
    zyx = (20, 38, 150)
    vol, scales, scal, table, consts = _advect_state(dev, zyx, 23)
    plan = A.advect_plan(zyx, torch.bfloat16)
    err, xy = _launch_xy(vol, scales, plan)
    assert err == 0 and torch.equal(xy, A.advect_xy_plain(vol, scales))
    for bad in (plan._replace(xy_smem=plan.xy_smem - 4), plan._replace(xy_warps=17),
                plan._replace(xy_tile=4)):
        assert _launch_xy(vol, scales, bad)[0] != 0, bad
    assert _launch_z(xy, scal, plan, table, consts)[0] == 0
    for bad in (plan._replace(z_smem=plan.z_smem + 4), plan._replace(z_warps=0),
                plan._replace(z_warps=17)):
        assert _launch_z(xy, scal, bad, table, consts)[0] != 0, bad


def test_shear_scan_matches_plain(dev):
    """B9 bit for bit: the TPU's shifts and lerps, the carry summed slice
    by slice in order."""
    rng = np.random.default_rng(1)
    log_att = torch.from_numpy(-rng.uniform(0, 2, (32, 16, 128)).astype(np.float32)).to(dev)
    s = torch.tensor([0.4, -0.7, 0.0, 128.0], device=dev)
    assert torch.equal(S.shear_scan(log_att, s), S.shear_scan_plain(log_att, s))


def _shear_args(dev, shape, slope_a, slope_b, seed):
    """A stack of log attenuations in (-2, 0] and [slope_a, slope_b, pad_a,
    pad_b] with the light sweep's sign-dependent pads."""
    n_s, n_a, n_b = shape
    rng = np.random.default_rng(seed)
    log_att = torch.from_numpy(-rng.uniform(0, 2, shape).astype(np.float32)).to(dev)
    s = torch.tensor([slope_a, slope_b, float(n_a) if slope_a < 0 else 0.0,
                      float(n_b) if slope_b < 0 else 0.0], device=dev)
    return log_att, s


@pytest.mark.parametrize("shape", [(32, 16, 128), (128, 128, 128), (75, 150, 150),
                                   (2, 16, 128), (2, 3, 5)])
def test_shear_scan_one_launch_matches_plain(dev, shape):
    """B9's one launch under torch.equal on the main path's stack, the 150^3
    frame's, two slices and a stack smaller than one warp's tile: slopes of
    both signs and zero, integral and fractional shifts, and the steepest
    the light sweep makes (|slope| = n_lat / n_m, one lateral frame across
    the stack)."""
    n_s, n_a, n_b = shape
    slopes = [(0.4, -0.7), (-1.0, 1.0), (0.0, 0.0), (0.0, -2.5), (-0.46875, 2.0),
              (n_a / n_s, -n_b / n_s), (-n_a / n_s, n_b / n_s)]
    for i, (sa, sb) in enumerate(slopes):
        log_att, s = _shear_args(dev, shape, sa, sb, 40 + i)
        assert torch.equal(S.shear_scan(log_att, s), S.shear_scan_plain(log_att, s)), (sa, sb)


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
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("grid,face", [((128, 128, 128), 0), ((128, 128, 128), 4),
                                       ((256, 256, 256), 0), ((150, 150, 150), 0),
                                       ((150, 150, 150), 4)],
                         ids=["128_x", "128_z", "256_x", "150_x", "150_z"])
def test_composite_resample_faces_match_plain(dev, grid, face, flip):
    """B10 on the march's own faces, 128^3, 256^3 and 150-lateral (R =
    150): within 1e-4 of the serial plain version (the segments' OVER
    merge re-associates the composite; expf and log1pf)."""
    args = sample_face_inputs(grid, face, dev)
    got = C.composite_resample(*args, 0.8, flip)
    ref = C.composite_resample_plain(*args, 0.8, flip)
    err = float((got - ref).abs().max())
    print(f"B10 {grid} face {face} flip {flip}: max abs diff {err:.3e}")
    assert err <= 1e-4


@pytest.mark.parametrize("flip", [False, True])
def test_composite_resample_zero_outside_matches_plain(dev, flip):
    """B10's zero-outside mode (the DIRECT base plane's) against its plain
    version, within 1e-4 (the segments' OVER merge; expf and log1pf):
    random coordinates from -3 to n + 2, with rows and columns on -0.5 and
    n - 0.5 and one f32 step past each (the per-texel path: these columns
    span more than the staging window); whole warps of columns outside (the
    skip); and the default camera's (1024, 896) base plane of a 48^3
    volume (the staged path)."""
    from fluidx12_tpu_torch.render.screencomp import sample_plane_inputs

    rng = np.random.default_rng(12)
    ns, a, b, r1, r2 = 16, 64, 48, 40, 72
    volf = torch.from_numpy(rng.uniform(0, 1, (4, ns, a, b)).astype(np.float32)
                            ).to(dev, torch.bfloat16)
    h_rows = rng.uniform(-3, a + 2, (ns, r1)).astype(np.float32)
    h_cols = rng.uniform(-3, b + 2, (ns, r2)).astype(np.float32)
    edges = np.float32([-0.5, np.nextafter(np.float32(-0.5), np.float32(-1)),
                        np.float32(a - 0.5), np.nextafter(np.float32(a - 0.5), np.float32(a))])
    h_rows[:, :4] = edges
    h_cols[:, :4] = edges - a + b
    h_cols[::2, 32:64] = b + 5.0            # a warp whose 32 columns are all outside
    valid = torch.from_numpy((rng.uniform(0, 1, ns) > 0.2).astype(np.float32)).to(dev)
    nst = torch.from_numpy(rng.uniform(0.5, 2, (r1, r2)).astype(np.float32)).to(dev)
    args = (volf, torch.from_numpy(h_rows).to(dev), torch.from_numpy(h_cols).to(dev), valid,
            nst, 0.8, flip)
    got = C.composite_resample(*args, zero_outside=True)
    torch.testing.assert_close(got, C.composite_resample_plain(*args, zero_outside=True),
                               atol=1e-4, rtol=0)
    assert float((got - C.composite_resample(*args)).abs().max()) > 1e-2
    _, plane = sample_plane_inputs((48, 48, 48), dev)
    got = C.composite_resample(*plane, 0.8, flip, zero_outside=True)
    ref = C.composite_resample_plain(*plane, 0.8, flip, zero_outside=True)
    assert got.shape == (4, 1024, 896) and float(ref[0].max()) > 0.1
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)


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


def _launch_prolong(q, e_c, plan):
    """fx_prolong_correct with `plan` as given: (error, output)."""
    from fluidx12_tpu_torch.ops.cuda import _build

    z, y, x = q.shape
    out = torch.empty_like(q)
    err = _build.lib().fx_prolong_correct(q.data_ptr(), e_c.data_ptr(), out.data_ptr(), z, y, x,
                                          plan.quads, plan.rows, plan.chunk,
                                          _build.stream_ptr(q))
    torch.cuda.synchronize()
    return err, out


def _launch_grad_damp(fields, p, plan, rho=0.48):
    """fx_grad_damp in place on `fields` with `plan` as given: (error,
    fields)."""
    from fluidx12_tpu_torch.ops.cuda import _build

    _, z, y, x = fields.shape
    err = _build.lib().fx_grad_damp(fields.data_ptr(), p.data_ptr(), ST.grad_scale(rho),
                                    int(fields.dtype == torch.bfloat16), z, y, x, plan.quads,
                                    plan.rows, plan.chunk, _build.stream_ptr(fields))
    torch.cuda.synchronize()
    return err, fields


# The paths' shapes (B7 at 128^3, 256^3 and the 256x256x60 frame's compact
# (60, 256, 256); B8 also at 150^3), then ragged ones: X = 38 and 150, not
# multiples of 4, 7 coarse planes (an odd chunk count), odd dims (B8).
STENCIL_SHAPES = [(128, 128, 128), (256, 256, 256), (60, 256, 256), (150, 150, 150),
                  (14, 10, 38), (22, 30, 150), (5, 3, 7)]


@pytest.mark.parametrize("shape", STENCIL_SHAPES, ids=lambda v: "x".join(map(str, v)))
def test_prolong_and_grad_damp_marches_match(dev, shape):
    """The z-marches: B7 bit for bit against its plain version and B8 bit
    for bit against its per-cell design (and within one bf16 ulp of each
    plain value, colour untouched), bf16 and f32 storage, with the plan and
    with forced quads and chunks (ragged last chunks)."""
    q, e_c = _randn(dev, shape, 40, 0.05), None
    if all(n % 2 == 0 for n in shape):
        e_c = _randn(dev, tuple(n // 2 for n in shape), 41, 0.1)
        ref = ST.prolong_correct_plain(q, e_c)
        assert torch.equal(ST.prolong_correct(q, e_c), ref)
        assert torch.equal(ST.perthread("prolong_correct", q, e_c), ref)
        for quads, chunk in ((8, 1), (16, 3), (32, 5)):
            err, got = _launch_prolong(q, e_c, ST.stencil_layout("prolong", shape, quads, chunk))
            assert err == 0 and torch.equal(got, ref), (quads, chunk)
    p = _randn(dev, shape, 42)
    for dtype in (torch.bfloat16, torch.float32):
        fields = (_randn(dev, (7,) + shape, 43) * 0.5).to(dtype)
        got = ST.grad_damp(fields.clone(), p, 0.48)
        yard = ST.perthread("grad_damp", fields.clone(), p, 0.48)
        ref = ST.grad_damp_plain(fields.clone(), p, 0.48)
        assert torch.equal(got, yard) and torch.equal(got[3:], fields[3:])
        ulp = (ref[:3].float().abs() * 2.0 ** -7).clamp_min(2.0 ** -126)
        assert bool(((got[:3].float() - ref[:3].float()).abs() <= ulp).all())
        for quads, chunk in ((8, 1), (16, 3), (32, 5)):
            err, forced = _launch_grad_damp(fields.clone(), p,
                                            ST.stencil_layout("grad_damp", shape, quads, chunk))
            assert err == 0 and torch.equal(forced, yard), (dtype, quads, chunk)


def test_prolong_and_grad_damp_refuse_a_plan_they_cannot_run(dev):
    """`fx_prolong_correct` and `fx_grad_damp` launch the plan that
    `stencil_plan` gives and refuse quads their kernels do not take, a CTA
    of other than 256 threads, an empty chunk and odd fine dims (B7)."""
    zyx = (14, 10, 38)
    q, e_c = _randn(dev, zyx, 44, 0.05), _randn(dev, (7, 5, 19), 45, 0.1)
    plan = ST.stencil_plan("prolong", zyx)
    err, got = _launch_prolong(q, e_c, plan)
    assert err == 0 and torch.equal(got, ST.prolong_correct_plain(q, e_c))
    for bad in (plan._replace(quads=12, rows=21), plan._replace(quads=64, rows=4),
                plan._replace(rows=plan.rows // 2), plan._replace(chunk=0)):
        assert _launch_prolong(q, e_c, bad)[0] != 0, bad
    from fluidx12_tpu_torch.ops.cuda import _build

    odd = q[:, :, :37].contiguous()
    z, y, x = odd.shape
    assert _build.lib().fx_prolong_correct(odd.data_ptr(), e_c.data_ptr(), odd.data_ptr(),
                                           z, y, x, plan.quads, plan.rows, plan.chunk,
                                           _build.stream_ptr(odd)) != 0
    fields = _randn(dev, (7,) + zyx, 46).to(torch.bfloat16)
    p = _randn(dev, zyx, 47)
    plan = ST.stencil_plan("grad_damp", zyx)
    err, got = _launch_grad_damp(fields.clone(), p, plan)
    assert err == 0 and torch.equal(got, ST.perthread("grad_damp", fields.clone(), p, 0.48))
    for bad in (plan._replace(quads=64, rows=4), plan._replace(quads=12, rows=21),
                plan._replace(rows=plan.rows * 2), plan._replace(chunk=0)):
        assert _launch_grad_damp(fields.clone(), p, bad)[0] != 0, bad


def test_prolong_and_grad_damp_marches_at_2_30_cells(dev):
    """B7 and B8 on (4096, 512, 512), 2^30 cells, where B8's channel 2
    starts at 2^31 elements: both equal their per-cell designs (64-bit
    indices throughout), channel 3 untouched."""
    shape = (4096, 512, 512)
    g = torch.Generator(device=dev).manual_seed(48)
    p = torch.empty(shape, device=dev).uniform_(-1.0, 1.0, generator=g)
    fields = torch.empty((4,) + shape, dtype=torch.bfloat16, device=dev).uniform_(
        -0.75, 0.75, generator=g)
    colour = fields[3].clone()
    got = ST.grad_damp(fields.clone(), p, 0.48)
    assert torch.equal(got, ST.perthread("grad_damp", fields, p, 0.48))
    assert torch.equal(got[3], colour)
    del got, fields, colour
    e_c = p[::2, ::2, ::2].contiguous()
    assert torch.equal(ST.prolong_correct(p, e_c), ST.perthread("prolong_correct", p, e_c))


def _launch_divergence(fields, plan):
    """fx_divergence with `plan` as given: (error, output)."""
    from fluidx12_tpu_torch.ops.cuda import _build

    _, z, y, x = fields.shape
    out = torch.empty((z, y, x), dtype=torch.float32, device=fields.device)
    err = _build.lib().fx_divergence(fields.data_ptr(), out.data_ptr(),
                                     int(fields.dtype == torch.bfloat16), z, y, x, plan.quads,
                                     plan.rows, plan.chunk, _build.stream_ptr(fields))
    torch.cuda.synchronize()
    return err, out


def _launch_residual(q, b, plan):
    """fx_residual with `plan` as given: (error, output)."""
    from fluidx12_tpu_torch.ops.cuda import _build

    z, y, x = q.shape
    out = torch.empty_like(q)
    err = _build.lib().fx_residual(q.data_ptr(), b.data_ptr(), out.data_ptr(), z, y, x,
                                   plan.quads, plan.rows, plan.chunk, _build.stream_ptr(q))
    torch.cuda.synchronize()
    return err, out


@pytest.mark.parametrize("shape", STENCIL_SHAPES, ids=lambda v: "x".join(map(str, v)))
def test_divergence_and_residual_marches_match(dev, shape):
    """The z-marches B3 (bf16 and f32 state, channels 3.. NaN and never
    read) and B5 bit for bit against their plain versions and their
    per-cell designs, with the plan and with forced quads and chunks
    (ragged last chunks, chunks of one plane)."""
    q, b = _randn(dev, shape, 50, 0.05), _randn(dev, shape, 51)
    ref = ST.residual_plain(q, b)
    assert torch.equal(ST.residual(q, b), ref)
    assert torch.equal(ST.perthread("residual", q, b), ref)
    for quads, chunk in ((8, 1), (16, 3), (32, 5)):
        err, got = _launch_residual(q, b, ST.stencil_layout("residual", shape, quads, chunk))
        assert err == 0 and torch.equal(got, ref), (quads, chunk)
    for dtype in (torch.bfloat16, torch.float32):
        fields = (_randn(dev, (4,) + shape, 52) * 0.5).to(dtype)
        fields[3] = float("nan")
        ref = ST.divergence_plain(fields)
        assert bool(ref.isfinite().all())
        assert torch.equal(ST.divergence(fields), ref)
        assert torch.equal(ST.perthread("divergence", fields), ref)
        for quads, chunk in ((8, 1), (16, 3), (32, 5)):
            err, got = _launch_divergence(fields,
                                          ST.stencil_layout("divergence", shape, quads, chunk))
            assert err == 0 and torch.equal(got, ref), (dtype, quads, chunk)


def test_divergence_and_residual_refuse_a_plan_they_cannot_run(dev, monkeypatch):
    """`fx_divergence` and `fx_residual` launch the plan that `stencil_plan`
    gives and refuse quads their kernels do not take, a CTA of other than
    256 threads and an empty chunk; the wrappers raise on the refusal and
    never fall back."""
    zyx = (14, 10, 38)
    fields = _randn(dev, (4,) + zyx, 53).to(torch.bfloat16)
    q, b = _randn(dev, zyx, 54, 0.05), _randn(dev, zyx, 55)
    for kind in ("divergence", "residual"):
        plan = ST.stencil_plan(kind, zyx)
        launch = ((lambda pl: _launch_divergence(fields, pl)) if kind == "divergence"
                  else (lambda pl: _launch_residual(q, b, pl)))
        err, got = launch(plan)
        ref = ST.divergence_plain(fields) if kind == "divergence" else ST.residual_plain(q, b)
        assert err == 0 and torch.equal(got, ref)
        bad_plans = (plan._replace(quads=12, rows=21), plan._replace(quads=64, rows=4),
                     plan._replace(rows=plan.rows // 2), plan._replace(chunk=0))
        for bad in bad_plans:
            assert launch(bad)[0] != 0, (kind, bad)
        with monkeypatch.context() as m:
            m.setattr(ST, "stencil_plan", lambda k, z, bad=bad_plans[0]: bad)
            before = ST.divergence.launches + ST.residual.launches
            with pytest.raises(RuntimeError):
                if kind == "divergence":
                    ST.divergence(fields)
                else:
                    ST.residual(q, b)
            assert ST.divergence.launches + ST.residual.launches == before + 1


def test_divergence_march_at_2_30_cells(dev):
    """B3 on (4096, 512, 512), 2^30 cells, where channel 2 starts at 2^31
    elements: equal to its per-cell design (64-bit channel bases), channel
    3 (NaN) never read."""
    shape = (4096, 512, 512)
    g = torch.Generator(device=dev).manual_seed(56)
    fields = torch.empty((4,) + shape, dtype=torch.bfloat16, device=dev).uniform_(
        -0.75, 0.75, generator=g)
    fields[3] = float("nan")
    got = ST.divergence(fields)
    yard = ST.perthread("divergence", fields)
    assert torch.equal(got, yard) and bool(got.isfinite().all())


@pytest.mark.parametrize("shape,iters,plan", [((64, 32, 128), 4, (32, 4)),
                                              ((32, 64, 128), 8, (16, 8)),
                                              ((24, 136, 128), 8, (8, 8)),
                                              ((16, 48, 64), 32, None)])
def test_jacobi_kernels_match_plain(dev, shape, iters, plan):
    """B4 (whole-window and plane-sweep orders) and B6 (the twin's order)
    against their plain versions: the same neighbour order and correctly
    rounded divisions on both sides, so bit for bit (as chip_smoke.py
    holds them)."""
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


@pytest.mark.parametrize("shape", [(8, 128), (128, 128), (512, 512), (768, 512), (8, 49152)])
def test_jacobi2d_tiles_match_plain(dev, shape):
    """B14's tiled sweeps, ring sweeps a launch, bit for bit at 0, 1, K - 1,
    K, K + 1, 16 and 64 sweeps (one launch, or a chain of programmatic
    dependent launches) on the smallest plane B14's gate admits, the 2D
    preset's 512^2, the gate's largest and its thinnest."""
    q, b = _randn(dev, shape, 41, 0.05), _randn(dev, shape, 42)
    ring = J.J2D_RING
    for iters in (0, 1, ring - 1, ring, ring + 1, 16, 64):
        assert J.jacobi2d_plan(shape, iters)[1] <= ring
        assert torch.equal(J.jacobi2d(q, b, iters), J.jacobi2d_plain(q, b, iters)), iters


def test_jacobi2d_chain_writes_every_cell(dev):
    """A chained B14 call whose output and scratch buffers start as NaN:
    every launch writes every cell of its destination, so the result is
    the plain one bit for bit."""
    from fluidx12_tpu_torch.ops.cuda import _build

    shape = (512, 512)
    q, b = _randn(dev, shape, 43, 0.05), _randn(dev, shape, 44)
    out = torch.full_like(q, float("nan"))
    scratch = torch.full_like(q, float("nan"))
    (ty, tx), ring, smem = J.jacobi2d_plan(shape, 64)
    err = _build.lib().fx_jacobi2d(q.data_ptr(), b.data_ptr(), out.data_ptr(),
                                   scratch.data_ptr(), 64, ty, tx, ring, smem, *shape,
                                   _build.stream_ptr(q))
    assert err == 0
    assert torch.equal(out, J.jacobi2d_plain(q, b, 64))


def test_b14_and_b9_refuse_a_plan_their_kernels_cannot_run(dev):
    """fx_jacobi2d and fx_shear_scan launch with the plan they are given and
    refuse one their kernels cannot run: a tile or ring not in 4 x 4
    blocks, more blocks than 512 threads, less shared memory than the edge
    buffers, rows not 16-byte aligned; a warp tile other than the compiled
    1 x 30, threads not whole warps or more than 8 warps, less shared
    memory than the shifts and rings."""
    from fluidx12_tpu_torch.ops.cuda import _build

    lib, st = _build.lib(), _build.stream_ptr
    shape = (64, 128)
    q, b = _randn(dev, shape, 45), _randn(dev, shape, 46)
    out, scratch = torch.empty_like(q), torch.empty_like(q)
    (ty, tx), ring, smem = J.jacobi2d_plan(shape, 16)
    for plan in ((ty, tx - 2, ring, smem), (ty, tx, 6, smem), (ty, tx, ring, smem - 4),
                 (64, 128, 16, 2 * 4 * J.jacobi2d_threads((64, 128), 16) * 16)):
        assert lib.fx_jacobi2d(q.data_ptr(), b.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                               16, *plan, *shape, st(q)) != 0, plan
    assert lib.fx_jacobi2d(q.data_ptr() + 4, b.data_ptr(), out.data_ptr(),
                           scratch.data_ptr(), 16, ty, tx, ring, smem, 64, 124, st(q)) != 0
    with pytest.raises(ValueError):
        J.jacobi2d(_randn(dev, (6, 128), 47), _randn(dev, (6, 128), 48), 4)
    assert torch.equal(J.jacobi2d(q, b, 16), J.jacobi2d_plain(q, b, 16))

    log_att, s = _shear_args(dev, (16, 16, 128), 0.4, -0.7, 49)
    got = torch.empty_like(log_att)
    (ta, tb), threads, smem = S.shear_plan(log_att.shape)
    for plan in ((ta, tb + 1, threads, smem), (ta + 1, tb, threads, smem), (ta, tb, 40, smem),
                 (ta, tb, 9 * 32, S.shear_smem(9, 16)), (ta, tb, threads, smem - 4)):
        assert lib.fx_shear_scan(log_att.data_ptr(), s.data_ptr(), got.data_ptr(),
                                 *log_att.shape, *plan, st(log_att)) != 0, plan
    assert torch.equal(S.shear_scan(log_att, s), S.shear_scan_plain(log_att, s))


def test_b14_and_b9_yardsticks_match_plain(dev):
    """The designs chip_smoke.py times B14 and B9 against, the per-sweep
    launches (`sweepwise` in order 3) and the two-launch scan
    (`sweep.twopass`): bit for bit."""
    q, b = _randn(dev, (1, 64, 128), 50, 0.05), _randn(dev, (1, 64, 128), 51)
    for iters in (1, 9):
        got = J.sweepwise("sweeps", q, b, iters, order=J.ORDER_2D)
        assert torch.equal(got, J.sweeps_plain(q, b, iters, J.ORDER_2D)), iters
    log_att, s = _shear_args(dev, (32, 16, 128), -0.46875, 2.0, 52)
    assert torch.equal(S.twopass(log_att, s), S.shear_scan_plain(log_att, s))


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


@pytest.mark.parametrize("shape", [(60, 256, 256), (150, 150, 150), (5, 40, 33), (3, 130, 257)])
def test_planewise_march_matches_plain(dev, shape):
    """The blocked z-march of the plane-sweep order (fx_jacobi order 1,
    called directly: `jacobi` takes that order only where the TPU's plan
    does) at the padded frames' compact dims and odd ones, with 1, 3, 4, 5
    and 8 sweeps (one launch, or a chain of four-sweep launches): bit for
    bit, since each cell's sum order and true division are the plain
    version's."""
    q, b = _randn(dev, shape, 21), _randn(dev, shape, 22)
    for iters in (1, 3, 4, 5, 8):
        got = J._launch(q, b, iters, J.ORDER_PLANEWISE)
        assert torch.equal(got, J.sweeps_plain(q, b, iters, J.ORDER_PLANEWISE)), iters


@pytest.mark.parametrize("iters", [4, 5])
def test_march_epilogues_match_plain(dev, iters):
    """B13 and B18's two halves on an even shape that no tile divides:
    q, b and r_c bit for bit; the tail's velocity within one bf16 ulp of
    each value, in place, the colour channel untouched."""
    shape = (30, 130, 98)
    q, b = _randn(dev, shape, 23, 0.05), _randn(dev, shape, 24)
    got = J.jacobi_rr(q, b, iters, 4.0)
    assert all(torch.equal(g, r) for g, r in zip(got, J.jacobi_rr_plain(q, b, iters, 4.0)))
    fields = _randn(dev, (4,) + shape, 25).to(torch.bfloat16)
    got = J.jacobi_divrr(fields, q, iters, 4.0)
    ref = J.jacobi_divrr_plain(fields, q, iters, 4.0)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    got_q, got_f = J.jacobi_grad(q, b, fields.clone(), iters, 0.48)
    ref_q, ref_f = J.jacobi_grad_plain(q, b, fields.clone(), iters, 0.48)
    assert torch.equal(got_q, ref_q) and torch.equal(got_f[3:], fields[3:])
    ulp = (ref_f[:3].float().abs() * 2.0 ** -7).clamp_min(2.0 ** -126)
    assert bool(((got_f[:3].float() - ref_f[:3].float()).abs() <= ulp).all())


@pytest.mark.parametrize("shape", [(128, 128, 128), (30, 128, 128), (75, 75, 75), (3, 5, 7)])
def test_window_order_matches_plain(dev, shape):
    """B4's whole-window order, the z-sweep (fx_jacobi_window, called
    directly: `jacobi` admits only multiples of `inner`), at the main
    path's 128^3, the padded frames' compact coarse dims and a shape
    smaller than one tile, with 0 to 5, 8 and 32 sweeps (one launch, or a
    chain of programmatic dependent launches): bit for bit."""
    q, b = _randn(dev, shape, 29, 0.05), _randn(dev, shape, 30)
    for iters in (0, 1, 2, 3, 4, 5, 8, 32):
        got = J._launch(q, b, iters, J.ORDER_WINDOW)
        assert torch.equal(got, J.sweeps_plain(q, b, iters, J.ORDER_WINDOW)), iters


@pytest.mark.parametrize("shape", [(64, 64, 64), (2, 16, 64), (16, 48, 64), (17, 48, 64),
                                   (4, 1024, 64)])
def test_packed_cluster_matches_plain(dev, shape):
    """B6 in one cluster launch at the main path's 64^3 coarse level, the
    thinnest shape its gate admits, a middle one, one whose last CTA owns
    a partial range, and the largest (Z * Y = 4096, 16 CTAs), with 0, 1,
    31 and 32 sweeps: bit for bit."""
    q, b = _randn(dev, shape, 31, 0.05), _randn(dev, shape, 32)
    for iters in (0, 1, 31, 32):
        got = J.jacobi_packed(q, b, iters)
        assert torch.equal(got, J.jacobi_packed_plain(q, b, iters)), iters


def test_l2_sweeps_refuse_a_plan_their_kernels_cannot_run(dev):
    """fx_jacobi_window and fx_jacobi_packed launch with the plan they are
    given and refuse one their kernels cannot run: a tile other than the
    compiled (16, 32), less shared memory than the chunk stages, a row
    range not a power of two, fewer threads than whole warps."""
    from fluidx12_tpu_torch.ops.cuda import _build

    lib, st = _build.lib(), _build.stream_ptr
    q, b = _randn(dev, (16, 48, 64), 35), _randn(dev, (16, 48, 64), 36)
    out, scratch = torch.empty_like(q), torch.empty_like(q)
    (ty, tx), zchunk, smem = J.window_plan(q.shape)
    for plan in ((ty // 2, tx, zchunk, smem), (ty, tx, zchunk, smem - 4)):
        assert lib.fx_jacobi_window(q.data_ptr(), b.data_ptr(), out.data_ptr(),
                                    scratch.data_ptr(), 2, *plan, 16, 48, 64, st(q)) != 0
    cluster, rpc, threads, smem = J.packed_plan(q.shape)
    for plan in ((cluster, rpc, threads, smem - 4), (16, 48, 768, 2 * 48 * 64 * 4),
                 (cluster, rpc, 16, smem)):
        assert lib.fx_jacobi_packed(q.data_ptr(), b.data_ptr(), out.data_ptr(), 2, *plan,
                                    16, 48, 64, st(q)) != 0
    assert torch.equal(J.jacobi_packed(q, b, 2), J.jacobi_packed_plain(q, b, 2))


@pytest.mark.parametrize("order", [0, 2], ids=["window", "packed"])
def test_sweepwise_orders_match_plain(dev, order):
    """The per-sweep designs chip_smoke.py times B4's whole-window order
    and B6 against: bit for bit."""
    shape = (16, 48, 64)
    q, b = _randn(dev, shape, 33, 0.05), _randn(dev, shape, 34)
    for iters in (1, 4, 32):
        got = J.sweepwise("sweeps", q, b, iters, order=order)
        assert torch.equal(got, J.sweeps_plain(q, b, iters, order)), iters


def test_march_division_is_the_division(dev):
    """The branch-free quotient, in the march's form and in the z-sweep's
    and cluster kernel's, equals x / 6.0f for every f32 bit pattern x (NaN
    for NaN)."""
    assert J.div6_mismatches(dev) == 0


def test_sweepwise_yardstick_matches_plain(dev):
    """The per-sweep design chip_smoke.py times the march against computes
    the same functions: bit for bit (the velocity within one bf16 ulp)."""
    shape = (16, 64, 128)
    q, b = _randn(dev, shape, 26, 0.05), _randn(dev, shape, 27)
    fields = _randn(dev, (4,) + shape, 28).to(torch.bfloat16)
    assert torch.equal(J.sweepwise("sweeps", q, b, 4), J.sweeps_plain(q, b, 4, 1))
    got = J.sweepwise("rr", q, b, 4, scale=4.0)
    assert all(torch.equal(g, r) for g, r in zip(got, J.jacobi_rr_plain(q, b, 4, 4.0)))
    got = J.sweepwise("divrr", q, None, 4, fields, scale=4.0)
    assert all(torch.equal(g, r) for g, r in zip(got, J.jacobi_divrr_plain(fields, q, 4, 4.0)))
    got_q, got_f = J.sweepwise("grad", q, b, 4, fields.clone(), rho=0.48)
    ref_q, ref_f = J.jacobi_grad_plain(q, b, fields.clone(), 4, 0.48)
    ulp = (ref_f[:3].float().abs() * 2.0 ** -7).clamp_min(2.0 ** -126)
    assert torch.equal(got_q, ref_q)
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


@pytest.mark.parametrize("path", ["fused", "slab", "padded"])
def test_new_paths_launch_their_kernels(dev, path):
    """One frame of the fused-projection 256^3 path (B18's two halves once,
    none of B3, B13, B8 or B4's plane-sweep order), of the 256x256x60 GI
    frame, stored (64, 256, 256) on the TPU (B15 once; the padded
    projection: B3, B4 in its plane-sweep order twice and on the coarse
    level once, B5, B7, B8; B10 on the four faces the default camera sees,
    no B17, B16 or B13), and of grid (128, 128, 20), stored (32, 128, 128)
    (B4 in its whole-window order twice, the coarse level on the twin, no
    B6)."""
    from fluidx12_tpu_torch.engine.fluidx import FluidXEngine
    from fluidx12_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    if path == "fused":
        engine = FluidXEngine(FluidConfig(grid_size=(256, 256, 256), mg_project_fused=True),
                              device=dev)
        want = dict(jacobi_divrr=1, jacobi_grad=1, jacobi=1, prolong_correct=1, divergence=0,
                    jacobi_rr=0, grad_damp=0, residual=0, jacobi_planewise=0)
    elif path == "padded":
        engine = FluidXEngine(FluidConfig(grid_size=(128, 128, 20)), device=dev)
        want = dict(divergence=1, jacobi=2, jacobi_planewise=0, residual=1, jacobi_packed=0,
                    prolong_correct=1, grad_damp=1, composite=0, jacobi_rr=0)
    else:
        rad = np.load(Path(__file__).resolve().parents[1] / "assets" / "rnl_cross.npz")[
            "radiance"]
        engine = FluidXEngine(FluidConfig(grid_size=(256, 256, 60), has_light_probe=True),
                              radiance=rad, device=dev)
        want = dict(gradient3=1, composite=0, composite_resample=4, gi_light=0, jacobi_rr=0,
                    divergence=1, jacobi=3, jacobi_planewise=2, residual=1, jacobi_packed=0,
                    prolong_correct=1, grad_damp=1)
    engine.update_frame()
    reset_launch_counts()
    image = engine.step_frame()
    torch.cuda.synchronize()
    counts = launch_counts()
    assert {k: counts[k] for k in want} == want
    assert bool(torch.isfinite(image).all())


def _axis_state(dev, zyx, dtype, seed):
    """A (7, Z, Y, X) state whose velocities, at scale 8, carry most
    displacements past the 12-voxel clip, a quarter of the rows inside."""
    rng = np.random.default_rng(seed)
    f = rng.uniform(0, 1, (7,) + zyx).astype(np.float32)
    f[:3] = (f[:3] - 0.5) * 6.0
    f[:3, :, : zyx[1] // 4] *= 0.25
    return torch.from_numpy(f).to(dev, dtype)


def _launch_axis(vol, scale, disp_ch, plan):
    """fx_advect_axis with `plan` as given: (error, output)."""
    out = torch.empty_like(vol)
    err = A._launch_axis(vol, out, scale, disp_ch, plan)
    torch.cuda.synchronize()
    return err, out


# The 2D preset's plane, 128^3, then ragged ones: X = 150 (4-byte aligned
# bf16 rows, a ragged strip), Y = 20 and Z = 2 shorter than the window, Z =
# 1, odd X (one column a thread).
AXIS_SHAPES = [(1, 512, 512), (128, 128, 128), (20, 38, 150), (2, 20, 150), (1, 40, 33)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("zyx", AXIS_SHAPES, ids=lambda v: "x".join(map(str, v)))
def test_advect_axis_passes_match(dev, zyx, dtype):
    """B11 on every axis bit for bit against its plain version and its
    per-voxel design (`advect.perthread`), through the wrapper with the
    plan and through the C launch with forced plans: one column a thread,
    short tiles of 8 cells and 3 warps, and rows cut into spans of 64
    columns."""
    vol = _axis_state(dev, zyx, dtype, sum(zyx))
    scale = torch.tensor(8.0, device=dev)
    for axis, ch in ((2, 0), (1, 1), (0, 2)):
        ref = A.advect_axis_plain(vol, scale, axis, ch)
        assert torch.equal(A.advect_axis(vol, scale, axis, ch), ref), axis
        assert torch.equal(A.perthread("axis", vol, scale, axis=axis, disp_ch=ch), ref), axis
        plan = A.axis_plan(zyx, dtype, axis)
        if axis == 2:
            forced = [A.axis_layout(zyx, dtype, 2, 7, 1, plan.tile)]
            if zyx[2] > 64:
                forced.append(A.axis_layout(zyx, dtype, 2, 7, plan.cols, 2, 64))
        else:
            forced = [A.axis_layout(zyx, dtype, axis, 7, 1, 8, warps=3),
                      A.axis_layout(zyx, dtype, axis, 7, plan.cols, 8, warps=3)]
        for p in forced:
            err, got = _launch_axis(vol, scale, ch, p)
            assert err == 0 and torch.equal(got, ref), p


def test_advect_axis_refuses_a_plan_it_cannot_run(dev, monkeypatch):
    """`fx_advect_axis` launches the plan `axis_plan` gives and refuses
    shared memory other than its tile's, two columns a thread on rows of
    odd length, a strip other than 32 lanes of its columns, more warps
    than it compiles for, an empty tile, a span short of the row that is
    not a multiple of 64 and an x-pass CTA of more than 256 threads; the
    wrapper raises on a refusal, counts the launch and never falls back."""
    scale = torch.tensor(8.0, device=dev)
    for zyx in ((2, 20, 150), (1, 40, 33)):
        vol = _axis_state(dev, zyx, torch.bfloat16, 60)
        for axis in (2, 1, 0):
            plan = A.axis_plan(zyx, torch.bfloat16, axis)
            err, got = _launch_axis(vol, scale, 0, plan)
            assert err == 0 and torch.equal(got, A.advect_axis_plain(vol, scale, axis, 0))
            bad = [plan._replace(smem=plan.smem + 2), plan._replace(tile=0),
                   plan._replace(cols=3)]
            if zyx[2] % 2:
                bad.append(plan._replace(cols=2))
            if axis == 2:
                bad += [plan._replace(span=zyx[2] - 2), plan._replace(block=(200, 2))]
            else:
                bad += [plan._replace(span=plan.span * 2), plan._replace(block=(16, 2)),
                        plan._replace(block=(32, 17))]
            for b in bad:
                assert _launch_axis(vol, scale, 0, b)[0] != 0, (zyx, axis, b)
    vol = _axis_state(dev, (2, 20, 150), torch.bfloat16, 61)
    with monkeypatch.context() as m:
        m.setattr(A, "axis_plan", lambda *a: A.axis_layout((2, 20, 150), torch.bfloat16, 1, 7,
                                                           2, 8)._replace(smem=4))
        before = A.advect_axis.launches
        with pytest.raises(RuntimeError):
            A.advect_axis(vol, scale, 1, 1)
        assert A.advect_axis.launches == before + 1


def _launch_gradient(q, plan):
    """fx_gradient3 with `plan` as given: (error, output)."""
    from fluidx12_tpu_torch.ops.cuda import _build

    z, y, x = q.shape
    out = torch.empty((3, z, y, x), dtype=torch.float32, device=q.device)
    err = _build.lib().fx_gradient3(q.data_ptr(), out.data_ptr(), z, y, x, plan.quads,
                                    plan.rows, plan.chunk, _build.stream_ptr(q))
    torch.cuda.synchronize()
    return err, out


# The 256x256x60 GI frame's (30, 128, 128), then ragged ones: X = 150 (a
# last quad of two, 8-byte aligned rows), Y = 20, Z = 2 and two-cell dims,
# odd dims.
GRADIENT_SHAPES = [(30, 128, 128), (22, 30, 150), (2, 20, 38), (2, 2, 2), (5, 3, 7)]


@pytest.mark.parametrize("shape", GRADIENT_SHAPES, ids=lambda v: "x".join(map(str, v)))
def test_gradient3_march_matches(dev, shape):
    """B15's z-march bit for bit against its plain version and its per-cell
    design (`stencil.perthread`), with the plan and with forced quads and
    chunks (ragged last chunks, chunks of one plane)."""
    q = _randn(dev, shape, 70)
    ref = ST.gradient3_plain(q)
    assert torch.equal(ST.gradient3(q), ref)
    assert torch.equal(ST.perthread("gradient3", q), ref)
    for quads, chunk in ((8, 1), (16, 3), (32, 5)):
        err, got = _launch_gradient(q, ST.stencil_layout("gradient3", shape, quads, chunk))
        assert err == 0 and torch.equal(got, ref), (quads, chunk)


def test_gradient3_refuses_a_plan_it_cannot_run(dev, monkeypatch):
    """`fx_gradient3` launches the plan `stencil_plan` gives and refuses
    quads its kernel does not take, a CTA of other than 256 threads, an
    empty chunk and a dim under 2; the wrapper raises on a refusal, counts
    the launch and never falls back."""
    zyx = (14, 10, 38)
    q = _randn(dev, zyx, 71)
    plan = ST.stencil_plan("gradient3", zyx)
    err, got = _launch_gradient(q, plan)
    assert err == 0 and torch.equal(got, ST.gradient3_plain(q))
    for bad in (plan._replace(quads=12, rows=21), plan._replace(quads=64, rows=4),
                plan._replace(rows=plan.rows // 2), plan._replace(chunk=0)):
        assert _launch_gradient(q, bad)[0] != 0, bad
    flat = _randn(dev, (1, 10, 38), 72)
    assert _launch_gradient(flat, ST.stencil_layout("gradient3", (1, 10, 38), 16, 1))[0] != 0
    with monkeypatch.context() as m:
        m.setattr(ST, "stencil_plan", lambda k, z: plan._replace(chunk=0))
        before = ST.gradient3.launches
        with pytest.raises(RuntimeError):
            ST.gradient3(q)
        assert ST.gradient3.launches == before + 1


def test_gradient3_march_at_2_30_cells(dev):
    """B15 on (4096, 512, 512), 2^30 cells, where the output's channel 2
    starts at 2^31 elements: equal to its per-cell design (64-bit channel
    bases)."""
    shape = (4096, 512, 512)
    g = torch.Generator(device=dev).manual_seed(73)
    q = torch.empty(shape, device=dev).uniform_(-1.0, 1.0, generator=g)
    got = ST.gradient3(q)
    assert torch.equal(got, ST.perthread("gradient3", q)) and bool(got.isfinite().all())


def _composite_stack(dev, shape, seed):
    """A bf16 (n_s, R1, R2) density with an empty slice and empty rows, its
    (3, n_s, R1, R2) prod and (R1, R2) n_steps."""
    rng = np.random.default_rng(seed)
    n_s, r1, r2 = shape
    dens = torch.from_numpy(rng.uniform(-0.1, 1.0, shape).astype(np.float32))
    dens[n_s // 2] = 0.0
    dens[:, : r1 // 4] = 0.0
    prod = torch.from_numpy(rng.uniform(0.0, 1.0, (3,) + shape).astype(np.float32))
    nst = torch.from_numpy(rng.uniform(0.5, 2.0, (r1, r2)).astype(np.float32)).to(dev)
    return dens.to(dev, torch.bfloat16), prod.to(dev, torch.bfloat16), nst


def _launch_composite(args, flip, plan):
    """fx_composite with `plan` as given: (error, output)."""
    dens, prod, nst = args
    out = torch.full((4,) + tuple(nst.shape), float("nan"), device=dens.device)
    err = C._launch(dens, prod, nst, out, 0.8, flip, plan)
    torch.cuda.synchronize()
    return err, out


# Small versions of B17's stacks (the 24^3 DIRECT plane, the compact
# 256x256x60 X+ stack, a 512^3 DIRECT plane), then R1 ragged against the
# tile's rows and R2 ragged against its columns.
COMPOSITE_SHAPES = [(24, 64, 256), (128, 32, 256), (170, 24, 1024), (24, 18, 256),
                    (9, 13, 200)]


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("shape", COMPOSITE_SHAPES, ids=lambda v: "x".join(map(str, v)))
def test_composite_ring_matches_perthread(dev, shape, flip):
    """B17's ring equal to the one-thread-a-texel design it replaced
    (`composite_perthread`) and within 2e-6 of the scale of its plain
    version, with the plan and with each vec forced (tail groups part
    empty)."""
    args = _composite_stack(dev, shape, 80)
    yard = C.composite_perthread(*args, 0.8, flip)
    ref = C.composite_plain(*args, 0.8, flip)
    assert float((yard - ref).abs().max()) <= 2e-6 * float(ref.abs().max())
    assert torch.equal(C.composite(*args, 0.8, flip), yard)
    n_s, r1, r2 = shape
    for vec in C.VEC_CHOICES:
        if r2 % vec == 0:
            err, got = _launch_composite(args, flip, C.composite_layout(n_s, r1, r2, vec))
            assert err == 0 and torch.equal(got, yard), vec


def test_composite_refuses_a_plan_it_cannot_run(dev, monkeypatch):
    """`fx_composite` runs the plan `composite_plan` gives and refuses a
    vec it is not compiled for or that does not divide R2, threads
    along a row that are no power of two up to a warp, and a stack that
    does not start on its vectors; the wrapper raises on a refusal, counts
    the launch and never falls back."""
    shape = (12, 16, 256)
    args = _composite_stack(dev, shape, 81)
    plan = C.composite_plan(*shape)
    err, got = _launch_composite(args, False, plan)
    assert err == 0 and torch.equal(got, C.composite_perthread(*args, 0.8, False))
    for bad in (plan._replace(vec=1), plan._replace(vec=8), plan._replace(cols=3),
                plan._replace(cols=64)):
        assert _launch_composite(args, False, bad)[0] != 0, bad
    ragged = _composite_stack(dev, (12, 16, 250), 82)
    assert _launch_composite(ragged, False, C.composite_layout(12, 16, 250, 4))[0] != 0
    dens, prod, nst = args
    shifted = torch.empty(dens.numel() + 1, dtype=dens.dtype, device=dev)[1:].view(shape)
    shifted.copy_(dens)
    assert _launch_composite((shifted, prod, nst), False, plan)[0] != 0
    with pytest.raises(ValueError):
        C.composite(*_composite_stack(dev, (12, 16, 255), 83), 0.8, False)
    with monkeypatch.context() as m:
        m.setattr(C, "composite_plan", lambda *s: plan._replace(cols=3))
        before = C.composite.launches
        with pytest.raises(RuntimeError):
            C.composite(*args, 0.8, False)
        assert C.composite.launches == before + 1


def test_composite_division_is_the_division(dev):
    """B17's branch-free division equals the IEEE division on every
    divisor it can meet, each with four dividends."""
    assert C.div_fast_mismatches(dev) == 0


# ---------------------------------------------------------------------------
# The frame as one CUDA graph a key (engine/fluidx.py)
# ---------------------------------------------------------------------------

def _two_engines(dev, **kw):
    """Two engines of one config on the card, from the same initial state:
    (one that runs the frame op by op, one that replays its graphs)."""
    from fluidx12_tpu_torch.engine.fluidx import FluidXEngine

    cfg = FluidConfig(**dict(dict(viewport=(96, 96)), **kw))
    return FluidXEngine(cfg, device=dev), FluidXEngine(cfg, device=dev)


def _method(method_name):
    from fluidx12_tpu_torch.core.config import RenderMethod

    return lambda e: setattr(e, "render_method", RenderMethod[method_name])


# A point light inside the volume (light_pos / volume_scale < 1.1), and the
# dolly that moves the default camera's eye inside it.
INTERIOR_LIGHT = dict(point_light=True, light_pos=(5.0, 2.0, -3.0))
DOLLY_INSIDE = 15.5
# The faithful cases' sample counts.
MARCH = dict(max_ray_samples=48, max_light_samples=16)
# Each case of the replay test: (config fields, the action on both engines
# before each frame (None: none), whether each frame's key was captured
# before it, R1's and R2's launches a frame).  "fast_keys" walks the fast
# stack's keys: two frames of the default pose, an orbit (a new key), a
# small orbit (the same key, new packed parameters: a graph that read a
# stale parameter tensor would differ), the pause key (the state does not
# move), the DIRECT key, and back to the orbit's key.  The others are the
# faithful keys: toggle_ez under a cube and a DIRECT method, the eye
# inside the volume under both DIRECT methods, a point light inside it.
REPLAY_CASES = {
    "fast_keys": ({}, [None, None, lambda e: e.camera.orbit(60.0, 25.0),
                       lambda e: e.camera.orbit(1.0, 0.0), lambda e: e.toggle_pause(),
                       lambda e: (e.toggle_pause(), _method("RAY_MARCH_DIRECT_SEPARATE")(e)),
                       _method("RAY_MARCH_SEPARATE")],
                  [False, True, False, True, False, False, True], (0, 0)),
    "toggle_ez_separate": (MARCH, [lambda e: (e.toggle_ez(), _method("RAY_MARCH_SEPARATE")(e)),
                                None, None], [False, True, True], (1, 1)),
    "toggle_ez_direct_merged": (MARCH, [lambda e: (e.toggle_ez(),
                                                _method("RAY_MARCH_DIRECT_MERGED")(e)),
                                     None, None], [False, True, True], (1, 0)),
    "eye_inside_direct_merged": (MARCH, [lambda e: (e.camera.dolly(DOLLY_INSIDE),
                                                 _method("RAY_MARCH_DIRECT_MERGED")(e)),
                                      None, None], [False, True, True], (1, 0)),
    "eye_inside_direct_separate": (MARCH, [lambda e: (e.camera.dolly(DOLLY_INSIDE),
                                                   _method("RAY_MARCH_DIRECT_SEPARATE")(e)),
                                        None, None], [False, True, True], (1, 0)),
    "interior_point_light": (dict(MARCH, **INTERIOR_LIGHT), [None, None, None], [False, True, True], (1, 1)),
}


@pytest.mark.parametrize("case", list(REPLAY_CASES))
def test_replayed_frame_equals_the_frame_op_by_op(dev, case):
    """At 32^3, a 96^2 viewport: the frame
    `step_frame` replays from its graph equals `_frame_eager`'s, bit for
    bit (fields, pressure, image, launch counts), through each case's
    frames (REPLAY_CASES): a key's first frame runs op by op and is
    captured, its later frames replay; R1 and R2 launch as the path
    says."""
    from fluidx12_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    kw, actions, want_replayed, (r1, r2) = REPLAY_CASES[case]
    eager, graph = _two_engines(dev, grid_size=(32, 32, 32), **kw)
    keys, replayed = [], []
    for action in actions:
        if action is not None:
            action(eager)
            action(graph)
        key = graph._prepare()
        replayed.append(key in graph._graphs)
        keys.append(key)
        before = graph.state.fields.clone()
        reset_launch_counts()
        image_a = eager._frame_eager()
        counts_a = launch_counts()
        reset_launch_counts()
        image_b = graph.step_frame()
        assert launch_counts() == counts_a
        assert (counts_a["view_march"], counts_a["light_march"]) == (r1, r2)
        assert torch.equal(image_a, image_b)
        assert torch.equal(eager.state.fields, graph.state.fields)
        assert torch.equal(eager.state.pressure, graph.state.pressure)
        if graph.is_paused:
            assert torch.equal(graph.state.fields, before)
    assert replayed == want_replayed
    assert replayed == [key in keys[:i] for i, key in enumerate(keys)]
    assert len(graph._graphs) == len(set(keys))


def test_step_frames_replays_the_frame(dev):
    """`step_frames(4)` on the card equals four `step_frame` calls from the
    same state bit for bit (2D at 128^2, B11 and B14; the 32^3 cube path),
    and counts the launches of four frames."""
    from fluidx12_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    for grid in ((128, 128, 1), (32, 32, 32)):
        one, seq = _two_engines(dev, grid_size=grid)
        for e in (one, seq):
            e.step_frame()
        reset_launch_counts()
        images = one.step_frames(4)
        counts = launch_counts()
        reset_launch_counts()
        assert torch.equal(images, torch.stack([seq.step_frame() for _ in range(4)]))
        assert launch_counts() == counts and counts["advect_axis" if grid[2] == 1
                                                    else "advect_xy"] > 0
        assert torch.equal(one.state.fields, seq.state.fields)
        assert one.frame_index == seq.frame_index == 5


def test_failed_capture_raises(dev, monkeypatch):
    """A frame that copies host data to the card cannot be captured: the
    key's first frame runs op by op, its capture raises, and so does every
    later frame of the key; nothing falls back to launching op by op."""
    from fluidx12_tpu_torch.engine import fluidx as FX

    _, engine = _two_engines(dev, grid_size=(32, 32, 32))
    render = FX.render_frame

    def copying_render(grid, *args, **kwargs):
        torch.tensor(0.0, device=grid.device)  # a host-to-device copy
        return render(grid, *args, **kwargs)

    monkeypatch.setattr(FX, "render_frame", copying_render)
    for _ in range(2):
        with pytest.raises(RuntimeError):
            engine.step_frame()
        assert engine._graphs == {}


# ---------------------------------------------------------------------------
# The faithful stack: R1 (view_march) and R2 (light_march)
# ---------------------------------------------------------------------------

def _faithful_inputs(dev, probe=False, point=False, seed=0):
    """A config of 24^3 (32 ray and 8 light samples), a smoke grid in bf16
    on `dev` (density up to 0.6, some of it below zero_threshold) and the
    light environment of the engine's default pose."""
    from fluidx12_tpu_torch.core.state import unpack_scene_params
    from fluidx12_tpu_torch.engine.fluidx import FluidXEngine
    from fluidx12_tpu_torch.render.raymarch_core import make_light_env

    kw = dict(grid_size=(24, 24, 24), viewport=(48, 48), max_ray_samples=32,
              max_light_samples=8, has_light_probe=probe)
    if point:
        kw.update(INTERIOR_LIGHT)
    cfg = FluidConfig(**kw)
    rng = np.random.default_rng(seed)
    dens = rng.uniform(0.0, 0.6, cfg.zyx).astype(np.float32)
    for ax in range(3):
        dens = (np.roll(dens, 1, ax) + dens + np.roll(dens, -1, ax)) / 3
    dens = np.maximum(dens - 0.15, 0.0) * 2.0
    grid = np.concatenate([dens[None] * np.array([0.9, 0.7, 0.5], np.float32)[:, None, None, None],
                           dens[None]])
    grid = torch.from_numpy(grid).to(dev, torch.bfloat16)
    engine = FluidXEngine(cfg, device=dev)
    params = unpack_scene_params(engine.update_frame()[0])
    sh = torch.from_numpy(rng.uniform(-0.4, 1.2, (9, 3)).astype(np.float32)).to(dev)
    return cfg, grid, params, make_light_env(params, sh if probe else None, cfg)


@pytest.mark.parametrize("case", ["directional", "probe", "point"])
def test_light_march_matches_plain(dev, case):
    """R2 against its plain version (render/lightmap.light_map_plain) on
    the card: within 1e-5 except at most 0.1% of the values (a branch near
    zero_threshold), and its per-voxel sample counts zero where the voxel
    is empty (no ray leaves it)."""
    from fluidx12_tpu_torch.ops.cuda import raymarch as R
    from fluidx12_tpu_torch.render import raymarch_core as RC
    from fluidx12_tpu_torch.render.lightmap import light_map_plain

    cfg, grid, params, env = _faithful_inputs(dev, probe=case == "probe",
                                              point=case == "point")
    samples = torch.empty(cfg.zyx, dtype=torch.int32, device=dev)
    got = R.light_march(grid, RC.pack_env(env), RC.env_flags(env, cfg),
                        params.num_light_samples, cfg, samples=samples)
    ref = light_map_plain(grid.float(), env, params.num_light_samples, cfg)
    torch.cuda.synchronize()
    assert got.shape == (3, 24, 24, 24) and few_off(got, ref, f"R2, {case}")[0]
    dense = grid[3].float() >= cfg.zero_threshold
    assert int(samples[~dense].abs().sum()) == 0 and int(samples.sum()) > 0


@pytest.mark.parametrize("case", ["separate", "separate_half_map", "merged", "merged_probe",
                                  "merged_point"])
def test_view_march_matches_plain(dev, case):
    """R1 against its plain version (render/raymarch_core.view_march) on the
    card, on rays from points in and around the box with random
    directions, finite and infinite t_max and a random active mask:
    separate (the plain light map, and that map averaged to half the
    grid's lateral size, (3, Z, Y/2, X/2): R1 reads the map at its own
    dims) and merged, with the probe and with an interior point
    light; within 1e-5 except at most 0.1% of the values."""
    from fluidx12_tpu_torch.ops.cuda import raymarch as R
    from fluidx12_tpu_torch.render import raymarch_core as RC
    from fluidx12_tpu_torch.render.lightmap import light_map_plain

    cfg, grid, params, env = _faithful_inputs(dev, probe=case == "merged_probe",
                                              point=case == "merged_point")
    rng = np.random.default_rng(1)
    n = 3000
    o = rng.uniform(-1.6, 1.6, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(rng.uniform(size=n) < 0.3, rng.uniform(0.2, 2.0, n), np.inf)
    origin, ray_dir = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    origin, hit = RC.compute_ray_origin(origin, ray_dir)
    active = hit & torch.from_numpy(rng.uniform(size=n) < 0.9).to(dev)
    t_max = torch.from_numpy(t_max.astype(np.float32)).to(dev)
    separate = case.startswith("separate")
    light_map = (light_map_plain(grid.float(), env, params.num_light_samples, cfg)
                 if separate else None)
    if case == "separate_half_map":
        z, y, x = cfg.zyx
        light_map = light_map.reshape(3, z, y // 2, 2, x // 2, 2).mean(dim=(3, 5)).contiguous()
    samples = torch.empty((n, 3), dtype=torch.int32, device=dev)
    got = R.view_march(grid, origin, ray_dir, t_max, active, params.num_samples,
                       RC.pack_env(env), RC.env_flags(env, cfg), cfg, light_map=light_map,
                       num_light_samples=params.num_light_samples, samples=samples)
    ref = RC.view_march(grid.float(), origin, ray_dir, t_max, params.num_samples, env, cfg,
                        light_map=light_map, num_light_samples=params.num_light_samples,
                        active=active)
    torch.cuda.synchronize()
    assert got.shape == (n, 4) and float(ref[..., 3].max()) > 0.05
    assert few_off(got, ref, f"R1, {case}")[0]
    assert int(samples[~active].abs().sum()) == 0 and int(samples[:, 0].max()) > 1
    assert bool((samples[:, 1] <= samples[:, 0]).all()) and int(samples[:, 1].sum()) > 0
    assert (int(samples[:, 2].sum()) > 0) == (not separate)


# R1's and R2's designs (view_plan, light_plan) against the per-thread
# designs they replaced: (grid zyx, density fill, dtype, probe, point light).
R_CASES = {
    "empty": ((24, 24, 24), "empty", torch.bfloat16, False, False),
    "dense": ((24, 24, 24), "dense", torch.bfloat16, False, False),
    "ragged": ((22, 13, 20), "smoke", torch.bfloat16, False, False),
    "f32": ((24, 24, 24), "smoke", torch.float32, False, False),
    "probe": ((24, 24, 24), "smoke", torch.bfloat16, True, False),
    "point": ((24, 24, 24), "smoke", torch.bfloat16, False, True),
}


def _design_inputs(dev, case):
    """R_CASES[case]'s config (32 ray and 8 light samples), colour grid
    (density all 0, all at least 0.05, or smoke with about a third of the
    voxels dense), scene parameters and light environment."""
    from fluidx12_tpu_torch.core.state import unpack_scene_params
    from fluidx12_tpu_torch.engine.fluidx import FluidXEngine
    from fluidx12_tpu_torch.render.raymarch_core import make_light_env

    zyx, fill, dtype, probe, point = R_CASES[case]
    kw = dict(grid_size=zyx[::-1], viewport=(48, 48), max_ray_samples=32, max_light_samples=8,
              has_light_probe=probe)
    if point:
        kw.update(INTERIOR_LIGHT)
    # The engine (the scene parameters) takes x = y; the kernels any dims.
    cfg = FluidConfig(**dict(kw, grid_size=(24, 24, 24)))
    rng = np.random.default_rng(11)
    dens = rng.uniform(0.0, 0.6, zyx).astype(np.float32)
    for ax in range(3):
        dens = (np.roll(dens, 1, ax) + dens + np.roll(dens, -1, ax)) / 3
    dens = {"empty": 0.0 * dens, "dense": 0.05 + 0.5 * dens,
            "smoke": np.maximum(dens - 0.28, 0.0) * 3.0}[fill].astype(np.float32)
    grid = np.concatenate([dens[None] * np.array([0.9, 0.7, 0.5], np.float32)[:, None, None, None],
                           dens[None]])
    grid = torch.from_numpy(grid).to(dev, dtype).contiguous()
    engine = FluidXEngine(cfg, device=dev)
    params = unpack_scene_params(engine.update_frame()[0])
    sh = torch.from_numpy(rng.uniform(-0.4, 1.2, (9, 3)).astype(np.float32)).to(dev)
    cfg = dataclasses.replace(cfg, grid_size=zyx[::-1])
    return cfg, grid, params, make_light_env(params, sh if probe else None, cfg)


def _design_rays(dev, shape, seed=1):
    """Rays of leading `shape` from points in and around the box, at their
    box entries, random directions, finite and infinite t_max, an active
    mask (hit, and 90% of those)."""
    from fluidx12_tpu_torch.render import raymarch_core as RC

    rng = np.random.default_rng(seed)
    o = torch.from_numpy(rng.uniform(-1.6, 1.6, shape + (3,)).astype(np.float32)).to(dev)
    d = rng.standard_normal(shape + (3,)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=-1, keepdims=True)).to(dev)
    origin, hit = RC.compute_ray_origin(o, d)
    t_max = np.where(rng.uniform(size=shape) < 0.3, rng.uniform(0.2, 2.0, shape), np.inf)
    active = hit & torch.from_numpy(rng.uniform(size=shape) < 0.9).to(dev)
    return (origin.contiguous(), d.contiguous(),
            torch.from_numpy(t_max.astype(np.float32)).to(dev), active.contiguous())


@pytest.mark.parametrize("case", list(R_CASES))
def test_light_march_equals_its_perthread_design(dev, case):
    """R2 (`light_plan`'s bricks, queued dense voxels) equals the
    one-thread-a-voxel design it replaced bit for bit, light and samples,
    under its plan and forced ones: 1 x 1 and 2 x 8 bricks, 64-bit
    offsets."""
    from fluidx12_tpu_torch.ops.cuda import raymarch as R
    from fluidx12_tpu_torch.render import raymarch_core as RC

    cfg, grid, params, env = _design_inputs(dev, case)
    args = (grid, RC.pack_env(env), RC.env_flags(env, cfg), params.num_light_samples, cfg)
    s_new = torch.full(cfg.zyx, -1, dtype=torch.int32, device=dev)
    s_old = torch.full(cfg.zyx, -2, dtype=torch.int32, device=dev)
    got = R.light_march(*args, samples=s_new)
    old = R.light_march_perthread(*args, samples=s_old)
    assert torch.equal(got, old) and torch.equal(s_new, s_old)
    assert (int(s_new.sum()) > 0) == (R_CASES[case][1] != "empty")
    for plan in (R.light_layout(cfg.zyx, 1, 1), R.light_layout(cfg.zyx, 2, 8),
                 R.light_layout(cfg.zyx, 4, 4, wide=True)):
        out, err = R._light_launch(plan, *args)
        assert err == 0 and torch.equal(out, old)


@pytest.mark.parametrize("mode", ["separate", "half_map", "merged"])
@pytest.mark.parametrize("case", list(R_CASES))
def test_view_march_equals_its_perthread_design(dev, case, mode):
    """R1 (`view_plan`'s persistent warps fetching 8 x 4 tiles) equals the
    one-thread-a-ray design it replaced bit for bit, output and samples,
    on a (20, 28) plane and on 3000 rays in a row (32 x 1 tiles), separate
    (a light map of the grid's dims, and one of half its lateral dims) and
    merged; under its plan and forced ones: 32 x 1 tiles, 64-bit
    offsets."""
    from fluidx12_tpu_torch.ops.cuda import raymarch as R
    from fluidx12_tpu_torch.render import raymarch_core as RC
    from fluidx12_tpu_torch.render.lightmap import light_map_plain

    cfg, grid, params, env = _design_inputs(dev, case)
    light_map = None
    if mode != "merged":
        light_map = light_map_plain(grid.float(), env, params.num_light_samples, cfg)
    if mode == "half_map" and R_CASES[case][0] == (24, 24, 24):
        z, y, x = cfg.zyx
        light_map = light_map.reshape(3, z, y // 2, 2, x // 2, 2).mean(dim=(3, 5)).contiguous()
    kw = dict(light_map=light_map, num_light_samples=params.num_light_samples)
    for shape in ((20, 28), (3000,)):
        rays = _design_rays(dev, shape)
        args = (grid, *rays, params.num_samples, RC.pack_env(env), RC.env_flags(env, cfg), cfg)
        s_new = torch.full(shape + (3,), -1, dtype=torch.int32, device=dev)
        s_old = torch.full(shape + (3,), -2, dtype=torch.int32, device=dev)
        got = R.view_march(*args, samples=s_new, **kw)
        old = R.view_march_perthread(*args, samples=s_old, **kw)
        assert torch.equal(got, old) and torch.equal(s_new, s_old)
        assert int(s_new[..., 0].sum()) > 0
        rows, cols = R._lead_plane(shape)
        for plan in (R.view_layout(rows, cols, 32), R.view_layout(rows, cols, 8, wide=True)):
            out, err = R._view_launch(plan, *args, **kw)
            assert err == 0 and torch.equal(out, old)


def test_view_march_counter_resets_between_launches(dev):
    """R1's fetch counter is back at 0 after every launch: two launches in
    a row, and a CUDA graph of one launch replayed three times, give the
    first launch's output bit for bit (a counter left where a launch ended
    would start the next one past its last ray)."""
    from fluidx12_tpu_torch.ops.cuda import raymarch as R
    from fluidx12_tpu_torch.render import raymarch_core as RC
    from fluidx12_tpu_torch.render.lightmap import light_map_plain

    cfg, grid, params, env = _design_inputs(dev, "probe")
    light_map = light_map_plain(grid.float(), env, params.num_light_samples, cfg)
    args = (grid, *_design_rays(dev, (20, 28)), params.num_samples, RC.pack_env(env),
            RC.env_flags(env, cfg), cfg)
    first = R.view_march(*args, light_map=light_map)
    assert torch.equal(R.view_march(*args, light_map=light_map), first)
    assert float(first[..., 3].max()) > 0.05
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        R.view_march(*args, light_map=light_map)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = R.view_march(*args, light_map=light_map)
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first)
    assert torch.equal(R.view_march(*args, light_map=light_map), first)


def test_raymarch_plans_the_kernels_refuse_raise(dev):
    """fx_view_march refuses tiles other than 8 and 32 wide and a plane
    that is not the rays'; fx_light_march a brick of no rows or of more
    rows than a lane's word of dense bits; the wrappers' check raises on
    the refusal; nothing is launched."""
    from fluidx12_tpu_torch.ops.cuda import _build
    from fluidx12_tpu_torch.ops.cuda import raymarch as R
    from fluidx12_tpu_torch.render import raymarch_core as RC

    cfg, grid, params, env = _design_inputs(dev, "ragged")
    light = (grid, RC.pack_env(env), RC.env_flags(env, cfg), params.num_light_samples, cfg)
    for by, bz in ((0, 4), (3, 11), (4, 0)):
        _, err = R._light_launch(R.light_layout(cfg.zyx, by, bz), *light)
        assert err != 0
        with pytest.raises(RuntimeError):
            _build.check(err, "fx_light_march")
    args = (grid, *_design_rays(dev, (20, 28)), params.num_samples, *light[1:3], cfg)
    for plan in (R.view_layout(20, 28, 16), R.view_layout(20, 28, 4),
                 R.view_layout(21, 28, 8)):
        _, err = R._view_launch(plan, *args, num_light_samples=params.num_light_samples)
        assert err != 0
    torch.cuda.synchronize()


# The engine shell on the card (chip_smoke.py phase 3i runs it at full
# width).  SHELL: the golden case's 24^3 grid at a 64^2 viewport.
SHELL = ["--gridSize", "24", "24", "24", "--viewport", "64", "64", "--maxRaySamples", "32",
         "--maxLightSamples", "8", "--no-fps"]


def test_cli_batched_equals_per_frame_on_the_card(dev, monkeypatch, tmp_path):
    """cli.main on the card with batch 1 and 8: the same last frame, bit
    for bit, and its screenshot decodes to it."""
    from fluidx12_tpu_torch.engine import cli
    from fluidx12_tpu_torch.engine import frame_loop as FL
    from fluidx12_tpu_torch.utils.image import to_srgb_u8
    from fluidx12_tpu_torch.utils.png import read_png

    got = []
    finish = FL.FrameLoop._finish

    def keep(self, last, *args):
        got.append((last, self.engine.frame_index))
        return finish(self, last, *args)

    monkeypatch.setattr(FL.FrameLoop, "_finish", keep)
    for batch in (1, 8):
        shot = str(tmp_path / f"b{batch}.png")
        assert cli.main(SHELL + ["--frames", "20", "--batch", str(batch),
                                 "--screenshot", shot]) == 0
        last, frame_index = got[-1]
        assert last.is_cuda and frame_index == 20
        assert np.array_equal(read_png(shot), to_srgb_u8(last))
    assert torch.equal(got[0][0], got[1][0])


def test_frame_loop_keeps_at_most_frames_in_flight(dev, monkeypatch):
    from fluidx12_tpu_torch.engine import frame_loop as FL
    from fluidx12_tpu_torch.engine.fluidx import FluidXEngine

    loop = FL.FrameLoop(FluidXEngine(FluidConfig(grid_size=(32, 32, 32), viewport=(96, 96)),
                                     device=dev), show_fps=False)
    pace = FL.FrameLoop._pace
    outstanding = []

    def watched(self, image):
        pace(self, image)
        assert len(self._in_flight) <= self.FRAMES_IN_FLIGHT
        outstanding.append(sum(not e.query() for e in self._in_flight))

    monkeypatch.setattr(FL.FrameLoop, "_pace", watched)
    for batch in (1, 4):
        loop.run(12, batch=batch)
    assert len(outstanding) == 12 + 3
    assert max(outstanding) <= FL.FrameLoop.FRAMES_IN_FLIGHT
    assert not loop._in_flight  # the run's end leaves nothing outstanding


def test_profile_passes_times_on_the_card(dev):
    from fluidx12_tpu_torch.core.config import RenderMethod
    from fluidx12_tpu_torch.engine.fluidx import FluidXEngine
    from fluidx12_tpu_torch.engine.profiler import profile_passes

    eng = FluidXEngine(FluidConfig(grid_size=(32, 32, 32), viewport=(96, 96)), device=dev)
    eng.step_frame()
    before = eng.state.fields.clone()
    for method, keys in ((RenderMethod.RAY_MARCH_SEPARATE, ["cube_march", "resolve"]),
                         (RenderMethod.RAY_MARCH_DIRECT_MERGED, ["plane_march", "warp"])):
        eng.render_method = method
        out = profile_passes(eng)
        assert list(out) == ["advect", "project", "light_map"] + keys + ["total"]
        assert all(v > 0.0 for v in out.values())
    assert torch.equal(eng.state.fields, before)


def test_session_round_trip_on_the_card_is_bit_identical(dev, tmp_path):
    from fluidx12_tpu_torch.core.config import RenderMethod
    from fluidx12_tpu_torch.engine.checkpoint import load_session, save_session

    a, b = _two_engines(dev, grid_size=(32, 32, 32))
    a.render_method = RenderMethod.RAY_MARCH_DIRECT_SEPARATE
    a.camera.orbit(17.0, 9.0)
    for _ in range(4):
        a.step_frame()
    path = str(tmp_path / "sess.npz")
    save_session(path, a)
    load_session(path, b)
    assert b.frame_index == a.frame_index and b.render_method == a.render_method
    assert torch.equal(b.state.fields, a.state.fields)
    for _ in range(3):
        assert torch.equal(b.step_frame(), a.step_frame())


def test_watchdog_between_replays_keeps_them_right(dev, tmp_path):
    """The watchdog reads the state between replays and resets it through
    `engine.state`: the next replays equal an engine's that had no
    watchdog, and after a reset a fresh engine's frames."""
    from fluidx12_tpu_torch.engine.fluidx import FluidXEngine
    from fluidx12_tpu_torch.engine.frame_loop import FrameLoop

    a, b = _two_engines(dev, grid_size=(32, 32, 32))
    loop = FrameLoop(a, show_fps=False, metrics_path=str(tmp_path / "m.jsonl"))
    for _ in range(3):
        a.step_frame()
        b.step_frame()
    loop._watchdog()
    for _ in range(3):
        assert torch.equal(a.step_frame(), b.step_frame())
    a.state.fields[3, 0, 0, 0] = float("nan")
    loop._watchdog()
    assert loop.recoveries == 1
    fresh = FluidXEngine(a.config, device=dev)
    for _ in range(3):
        assert torch.equal(a.step_frame(), fresh.step_frame())


# ---------------------------------------------------------------------------
# The adjoint: R1b (view_march_grad), R2b (light_march_grad) and the guard
# ---------------------------------------------------------------------------

def _grad_close(got, ref, what):
    """The adjoints' tolerance: within 1e-4 of the autograd gradient's
    largest magnitude (the taps' cotangents are summed by atomics, and
    autograd's products associate otherwise), plus one bf16 rounding of
    each value where `got` is bf16 (the gradient of a bf16 grid)."""
    diff = (got.float() - ref.float()).abs()
    scale = float(ref.float().abs().max())
    slack = 2.0 ** -8 * ref.float().abs() if got.dtype == torch.bfloat16 else 0.0
    err = float(diff.max())
    print(f"{what}: max |autograd| {scale:.4g}, max |kernel - autograd| {err:.3g}")
    return scale > 0.0 and bool((diff <= 1e-4 * scale + slack).all())


@pytest.mark.parametrize("case", ["separate", "half_map", "f32", "straight", "ragged", "dense",
                                  "odd_rays", "wide", "merged"])
def test_view_march_grad_matches_autograd(dev, case):
    """R1b against autograd through the plain separate-light march on the
    card, for the grid and the light map, with a seeded cotangent on rays
    from points in and around the box (finite and infinite t_max, an
    active mask): a light map of the grid's dims and of half its lateral
    dims, an f32 grid, straight (not premultiplied) colour, ragged dims,
    an all-dense grid, 37 x 29 rays (1073, not a multiple of 32: tiles
    overhang the plane), a plan with 64-bit offsets and the lanes'
    atomics merged (`view_grad_merges` takes them on denser rays); against the
    per-thread design it replaced (the same samples walked, gradients
    within the same tolerance); and through the autograd Function: the
    same forward bit for bit, gradients within the tolerance, one R1b
    launch a backward."""
    from fluidx12_tpu_torch.ops.cuda import _build
    from fluidx12_tpu_torch.ops.cuda import raymarch as R
    from fluidx12_tpu_torch.render import raymarch_core as RC
    from fluidx12_tpu_torch.render.lightmap import light_map_plain

    cfg, grid, params, env = _design_inputs(dev, {"f32": "f32", "ragged": "ragged",
                                                  "dense": "dense"}.get(case, "probe"))
    if case == "straight":
        cfg = dataclasses.replace(cfg, pre_multiplied=False)
    light_map = light_map_plain(grid.float(), env, params.num_light_samples, cfg)
    if case == "half_map":
        z, y, x = cfg.zyx
        light_map = light_map.reshape(3, z, y // 2, 2, x // 2, 2).mean(dim=(3, 5)).contiguous()
    shape = (37, 29) if case == "odd_rays" else (20, 28)
    rays = _design_rays(dev, shape)
    packed, flags = RC.pack_env(env), RC.env_flags(env, cfg)
    cot = torch.from_numpy(np.random.default_rng(5).standard_normal(shape + (4,))
                           .astype(np.float32)).to(dev)
    g_ref = grid.to(torch.float32, copy=True).requires_grad_(True)
    lm_ref = light_map.clone().requires_grad_(True)
    ref = RC.view_march(g_ref, rays[0], rays[1], rays[2], params.num_samples, env, cfg,
                        light_map=lm_ref, active=rays[3])
    (ref * cot).sum().backward()
    samples = torch.full(shape + (2,), -1, dtype=torch.int32, device=dev)
    args = (grid, light_map, *rays, params.num_samples, packed, flags, cfg, cot)
    if case in ("wide", "merged"):
        plan = R.view_grad_plan(shape, cfg.zyx, tuple(light_map.shape[1:]))
        g_grid, g_lm, err = R._view_grad_launch(plan._replace(wide=case == "wide"), *args,
                                                samples=samples, merge=case == "merged")
        _build.check(err, "fx_view_march_grad")
    else:
        g_grid, g_lm = R.view_march_grad(*args, samples=samples)
    torch.cuda.synchronize()
    assert _grad_close(g_grid, g_ref.grad, f"R1b {case}, grid")
    assert _grad_close(g_lm, lm_ref.grad, f"R1b {case}, light map")
    assert int(samples[..., 1].sum()) > 0 and bool((samples[..., 1] <= samples[..., 0]).all())
    s_old = torch.full(shape + (2,), -2, dtype=torch.int32, device=dev)
    old = R.view_march_grad_perthread(*args, samples=s_old)
    torch.cuda.synchronize()
    assert torch.equal(samples, s_old)
    assert _grad_close(g_grid, old[0], f"R1b {case} vs its per-thread design, grid")
    assert _grad_close(g_lm, old[1], f"R1b {case} vs its per-thread design, light map")
    # Through the Function, as render/raymarch_core.march_view calls it.
    g_in = grid.clone().requires_grad_(True)
    lm_in = light_map.clone().requires_grad_(True)
    before = R.view_march_grad.launches
    out = R.view_march(g_in, *rays, params.num_samples, packed, flags, cfg, light_map=lm_in)
    with torch.no_grad():
        plain_out = R.view_march(grid, *rays, params.num_samples, packed, flags, cfg,
                                 light_map=light_map)
    assert out.requires_grad and torch.equal(out.detach(), plain_out)
    (out * cot).sum().backward()
    torch.cuda.synchronize()
    assert R.view_march_grad.launches == before + 1 and g_in.grad.dtype == grid.dtype
    assert _grad_close(g_in.grad, g_ref.grad, f"R1b {case} through autograd, grid")
    assert _grad_close(lm_in.grad, lm_ref.grad, f"R1b {case} through autograd, light map")


@pytest.mark.parametrize("case", ["smoke", "dense", "f32", "point", "ragged", "wide"])
def test_light_march_grad_matches_autograd(dev, case):
    """R2b against autograd through `light_map_plain` on the card (no
    probe), with a seeded cotangent on the map: smoke, an all-dense grid,
    an f32 grid, an interior point light, ragged dims and a plan with
    64-bit offsets; against the per-thread design it replaced
    (the same samples walked, the gradient within the same tolerance); and
    through the autograd Function, one R2b launch a backward."""
    from fluidx12_tpu_torch.ops.cuda import _build
    from fluidx12_tpu_torch.ops.cuda import raymarch as R
    from fluidx12_tpu_torch.render import raymarch_core as RC
    from fluidx12_tpu_torch.render.lightmap import light_map_plain

    design = {"smoke": "probe", "dense": "dense", "f32": "f32", "point": "point",
              "ragged": "ragged", "wide": "probe"}[case]
    cfg, grid, params, env = _design_inputs(dev, design)
    env = env._replace(has_probe=False)
    cfg = dataclasses.replace(cfg, has_light_probe=False)
    packed, flags = RC.pack_env(env), RC.env_flags(env, cfg)
    num = params.num_light_samples
    cot = torch.from_numpy(np.random.default_rng(6).standard_normal((3,) + cfg.zyx)
                           .astype(np.float32)).to(dev)
    g_ref = grid.to(torch.float32, copy=True).requires_grad_(True)
    (light_map_plain(g_ref, env, num, cfg) * cot).sum().backward()
    samples = torch.full(cfg.zyx, -1, dtype=torch.int32, device=dev)
    args = (grid, packed, flags, num, cfg, cot)
    if case == "wide":
        plan = R.light_grad_plan(cfg.zyx)._replace(wide=True)
        g_grid, err = R._light_grad_launch(plan, *args, samples=samples)
        _build.check(err, "fx_light_march_grad")
    else:
        g_grid = R.light_march_grad(*args, samples=samples)
    torch.cuda.synchronize()
    assert _grad_close(g_grid, g_ref.grad, f"R2b {case}")
    assert float(g_grid[:3].abs().max()) == 0.0 and int(samples.sum()) > 0
    s_old = torch.full(cfg.zyx, -2, dtype=torch.int32, device=dev)
    old = R.light_march_grad_perthread(*args, samples=s_old)
    torch.cuda.synchronize()
    assert torch.equal(samples, s_old)
    assert _grad_close(g_grid, old, f"R2b {case} vs its per-thread design")
    g_in = grid.clone().requires_grad_(True)
    before = R.light_march_grad.launches
    out = R.light_march(g_in, packed, flags, num, cfg)
    assert out.requires_grad and torch.equal(out.detach(),
                                             R.light_march(grid, packed, flags, num, cfg))
    (out * cot).sum().backward()
    torch.cuda.synchronize()
    assert R.light_march_grad.launches == before + 1
    assert _grad_close(g_in.grad, g_ref.grad, f"R2b {case} through autograd")


def test_grad_kernels_walk_nothing_on_an_empty_grid(dev):
    """On a grid whose density is 0 everywhere R2b queues no voxel and R1b
    walks no dense sample: both gradients are exactly 0, R2b's sample
    counts all 0, R1b's dense counts all 0, as the per-thread designs'."""
    from fluidx12_tpu_torch.ops.cuda import raymarch as R
    from fluidx12_tpu_torch.render import raymarch_core as RC
    from fluidx12_tpu_torch.render.lightmap import light_map_plain

    cfg, grid, params, env = _design_inputs(dev, "empty")
    packed, flags = RC.pack_env(env), RC.env_flags(env, cfg)
    cot = torch.from_numpy(np.random.default_rng(6).standard_normal((3,) + cfg.zyx)
                           .astype(np.float32)).to(dev)
    samples = torch.full(cfg.zyx, -1, dtype=torch.int32, device=dev)
    g_grid = R.light_march_grad(grid, packed, flags, params.num_light_samples, cfg, cot,
                                samples=samples)
    light_map = light_map_plain(grid.float(), env, params.num_light_samples, cfg)
    rays = _design_rays(dev, (20, 28))
    view_cot = torch.from_numpy(np.random.default_rng(5).standard_normal((20, 28, 4))
                                .astype(np.float32)).to(dev)
    view_samples = torch.full((20, 28, 2), -1, dtype=torch.int32, device=dev)
    v_grid, v_lm = R.view_march_grad(grid, light_map, *rays, params.num_samples, packed, flags,
                                     cfg, view_cot, samples=view_samples)
    torch.cuda.synchronize()
    assert not bool(g_grid.any()) and not bool(samples.any())
    assert not bool(v_grid.any()) and not bool(v_lm.any())
    assert not bool(view_samples[..., 1].any()) and int(view_samples[..., 0].sum()) > 0


def test_grad_kernels_refuse_a_tape_one_slot_short(dev):
    """R1b and R2b refuse a launch whose tape is one lane's slot (max
    samples entries) short of what the launch's resident lanes need; the
    wrappers' check raises on the refusal; the launch with the tape it
    needs runs."""
    from fluidx12_tpu_torch.ops.cuda import _build
    from fluidx12_tpu_torch.ops.cuda import raymarch as R
    from fluidx12_tpu_torch.render import raymarch_core as RC
    from fluidx12_tpu_torch.render.lightmap import light_map_plain

    cfg, grid, params, env = _design_inputs(dev, "ragged")
    packed, flags = RC.pack_env(env), RC.env_flags(env, cfg)
    num_light = params.num_light_samples
    cot = torch.zeros((3,) + cfg.zyx, device=dev)
    plan = R.light_grad_plan(cfg.zyx)
    need = R.light_grad_tape_floats(plan, grid, cfg.max_light_samples)
    slot = R.TAPE_FLOATS * cfg.max_light_samples
    _, err = R._light_grad_launch(plan, grid, packed, flags, num_light, cfg, cot,
                                  tape_floats=need - slot)
    assert err != 0
    with pytest.raises(RuntimeError):
        _build.check(err, "fx_light_march_grad")
    assert R._light_grad_launch(plan, grid, packed, flags, num_light, cfg, cot,
                                tape_floats=need)[1] == 0
    light_map = light_map_plain(grid.float(), env, num_light, cfg)
    rays = _design_rays(dev, (20, 28))
    view = R.view_grad_plan((20, 28), cfg.zyx, cfg.zyx)
    need = R.view_grad_tape_floats(view, grid, cfg.max_ray_samples)
    args = (grid, light_map, *rays, params.num_samples, packed, flags, cfg,
            torch.zeros((20, 28, 4), device=dev))
    assert R._view_grad_launch(view, *args, tape_floats=need - R.TAPE_FLOATS
                               * cfg.max_ray_samples)[2] != 0
    assert R._view_grad_launch(view, *args, tape_floats=need)[2] == 0
    torch.cuda.synchronize()


def test_view_march_and_its_adjoint_keep_their_counters_apart(dev):
    """R1 and R1b launched back to back on one stream, three times over: R1
    gives its first output bit for bit each time and R1b walks exactly the
    rays and samples the per-thread design walks, with gradients within
    the tolerance of its (a counter shared, or left where a launch ended,
    would start a launch past its first tiles)."""
    from fluidx12_tpu_torch.ops.cuda import raymarch as R
    from fluidx12_tpu_torch.render import raymarch_core as RC
    from fluidx12_tpu_torch.render.lightmap import light_map_plain

    cfg, grid, params, env = _design_inputs(dev, "probe")
    packed, flags = RC.pack_env(env), RC.env_flags(env, cfg)
    light_map = light_map_plain(grid.float(), env, params.num_light_samples, cfg)
    rays = _design_rays(dev, (20, 28))
    cot = torch.from_numpy(np.random.default_rng(5).standard_normal((20, 28, 4))
                           .astype(np.float32)).to(dev)
    fwd = (grid, *rays, params.num_samples, packed, flags, cfg)
    bwd = (grid, light_map, *rays, params.num_samples, packed, flags, cfg, cot)
    s_old = torch.empty((20, 28, 2), dtype=torch.int32, device=dev)
    old = R.view_march_grad_perthread(*bwd, samples=s_old)
    first = R.view_march(*fwd, light_map=light_map)
    for _ in range(3):
        out = R.view_march(*fwd, light_map=light_map)
        samples = torch.full((20, 28, 2), -1, dtype=torch.int32, device=dev)
        g_grid, g_lm = R.view_march_grad(*bwd, samples=samples)
        torch.cuda.synchronize()
        assert torch.equal(out, first) and torch.equal(samples, s_old)
        assert _grad_close(g_grid, old[0], "R1b after R1, grid")
        assert _grad_close(g_lm, old[1], "R1b after R1, light map")


@pytest.mark.parametrize("kernel", ["grad_damp", "jacobi", "advect_xy"])
def test_kernels_without_an_adjoint_refuse_grad(dev, kernel):
    """B8, B4 and B1 raise NotImplementedError under autograd on operands
    that require grad (B8 writes the velocity in place, which autograd
    would not see), and run as before under torch.no_grad() or on
    operands that do not require grad."""
    from fluidx12_tpu_torch.ops.cuda import launch_counts

    rng = np.random.default_rng(3)
    fields = torch.from_numpy(rng.standard_normal((7, 64, 128, 128)).astype(np.float32)).to(dev)
    q = torch.from_numpy(rng.standard_normal((64, 128, 128)).astype(np.float32)).to(dev)
    calls = {"grad_damp": lambda f, p: ST.grad_damp(f, p, 0.48),
             "jacobi": lambda f, p: J.jacobi(p, f[3].contiguous(), 4, *J.jacobi_tuning(
                 (64, 128, 128), 4)),
             "advect_xy": lambda f, p: A.advect_xy(
                 f.to(torch.bfloat16), torch.tensor([8.0, 8.0], device=dev))}
    call = calls[kernel]
    before = launch_counts()[kernel]
    # The operands each call reads: the fields (and, B8 and B4, the pressure).
    for which in range(1 if kernel == "advect_xy" else 2):
        args = [fields.clone(), q.clone()]
        args[which].requires_grad_(True)
        with pytest.raises(NotImplementedError, match="no adjoint"):
            call(*args)
    assert launch_counts()[kernel] == before
    with torch.no_grad():
        call(fields.clone().requires_grad_(True), q.clone())
    call(fields.clone(), q.clone())
    torch.cuda.synchronize()
    assert launch_counts()[kernel] == before + 2


def test_adjoint_refuses_the_merged_march_and_the_probe(dev):
    """Under autograd R1 in merged mode and R2 with the light probe raise
    NotImplementedError naming ROADMAP.md's item 6b, as do gradients asked
    of the rays; without grad both launch as before."""
    from fluidx12_tpu_torch.ops.cuda import raymarch as R
    from fluidx12_tpu_torch.render import raymarch_core as RC

    cfg, grid, params, env = _design_inputs(dev, "probe")
    packed, flags = RC.pack_env(env), RC.env_flags(env, cfg)
    rays = _design_rays(dev, (20, 28))
    g = grid.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="6b"):
        R.view_march(g, *rays, params.num_samples, packed, flags, cfg,
                     num_light_samples=params.num_light_samples)
    with pytest.raises(NotImplementedError, match="6b"):
        R.light_march(g, packed, flags, params.num_light_samples, cfg)
    light_map = R.light_march(grid, packed, flags, params.num_light_samples, cfg)
    origin = rays[0].clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="rays"):
        R.view_march(grid, origin, *rays[1:], params.num_samples, packed, flags, cfg,
                     light_map=light_map)
    with torch.no_grad():
        R.view_march(g, *rays, params.num_samples, packed, flags, cfg,
                     num_light_samples=params.num_light_samples)
        R.light_march(g, packed, flags, params.num_light_samples, cfg)


# ---------------------------------------------------------------------------
# The XLA twins, the ensemble, the world-size-1 sharded frame, C9
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("change", ["use_pallas", "pallas_advect"])
def test_twin_frames_match_cpu(dev, change):
    """Three frames of a 32^3 engine with `use_pallas=False` (the advect
    twin, the einsum sweep and march: no kernel) or `pallas_advect=False`
    (the twin advect, then B3-B10) on the card, replayed, against the same
    frames on the CPU: within 1 bf16 ulp at each channel's scale and 2 u8
    levels, chip_smoke.py phase 4's tolerance."""
    from fluidx12_tpu_torch.engine.fluidx import FluidXEngine
    from fluidx12_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from fluidx12_tpu_torch.utils.image import to_srgb_u8

    cfg = FluidConfig(grid_size=(32, 32, 32), viewport=(64, 64), **{change: False})
    engines = [FluidXEngine(cfg, device=d) for d in ("cpu", dev)]
    reset_launch_counts()
    images = []
    for e in engines:
        for _ in range(3):
            img = e.step_frame()
        images.append(to_srgb_u8(img).astype(np.int32))
    counts = launch_counts()
    assert counts["advect_xy"] == counts["advect_z_forces"] == 0
    assert (sum(counts.values()) == 0) == (change == "use_pallas")
    assert bf16_ulps(engines[0].state.fields, engines[1].state.fields.cpu()) <= 1.0
    assert int(np.abs(images[0] - images[1]).max()) <= 2


def test_ensemble_members_match_lone_runs(dev):
    """SmokeEnsemble of three 32^3 members on the card: each bit for bit
    with a lone SmokeModel.step from its state, and exactly three times one
    member's launches."""
    from fluidx12_tpu_torch.core.state import FluidState
    from fluidx12_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from fluidx12_tpu_torch.parallel.ensemble import SmokeEnsemble

    ens = SmokeEnsemble(FluidConfig(grid_size=(32, 32, 32), viewport=(64, 64)), batch=3,
                        device=dev)
    states, params = ens.init(seed=1), ens.default_params()
    reset_launch_counts()
    lone = ens.model.step(FluidState(states.fields[0].clone(), states.pressure[0].clone()),
                          ens.model.default_params())
    one = launch_counts()
    rest = [ens.model.step(FluidState(states.fields[b].clone(), states.pressure[b].clone()),
                           ens.model.default_params()) for b in (1, 2)]
    reset_launch_counts()
    out, images = ens.step(states, params)
    assert launch_counts() == {k: 3 * v for k, v in one.items()} and one["advect_xy"] == 1
    for b, (st, img) in enumerate([lone] + rest):
        assert torch.equal(st.fields, out.fields[b]) and torch.equal(img, images[b])


def test_sharded_frame_world_size_1_nccl(dev):
    """sharded_simulate + sharded_render_frame on one card (nccl, world
    size 1, from a HashStore) at 48^3 with and without the probe, against
    the single-device reference of the dry run: colour within 2e-5, image
    within 2e-4; no kernel launched."""
    import torch.distributed as dist

    from fluidx12_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from fluidx12_tpu_torch.parallel import dryrun
    from fluidx12_tpu_torch.parallel.mesh import init_distributed, make_grid_mesh

    init_distributed(0, 1, dev, None)
    try:
        mesh = make_grid_mesh(1, dev)
        for probe in (False, True):
            cfg = FluidConfig(grid_size=(48, 48, 48), viewport=(64, 64), use_pallas=False,
                              has_light_probe=probe)
            reset_launch_counts()
            res = dryrun.run_domain(mesh, cfg, frames=3)
            dryrun.check(res)
            assert sum(launch_counts().values()) == 0 and res["exchanges"] > 0
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kernel", ["view_march_grad", "light_march_grad"])
def test_adjoint_refuses_deterministic_mode(dev, kernel):
    """Under torch.use_deterministic_algorithms(True) the backward through
    R1 or R2 raises a RuntimeError naming R1b or R2b before launching it
    (they add cotangents by f32 atomics); with warn_only=True it warns and
    launches."""
    from fluidx12_tpu_torch.ops.cuda import raymarch as R
    from fluidx12_tpu_torch.render import raymarch_core as RC

    cfg, grid, params, env = _design_inputs(dev, "probe")
    env = env._replace(has_probe=False)
    cfg = dataclasses.replace(cfg, has_light_probe=False)
    packed, flags = RC.pack_env(env), RC.env_flags(env, cfg)
    rays = _design_rays(dev, (20, 28))
    fn = getattr(R, kernel)

    def backward():
        g = grid.clone().requires_grad_(True)
        if kernel == "view_march_grad":
            lm = R.light_march(grid, packed, flags, params.num_light_samples, cfg)
            out = R.view_march(g, *rays, params.num_samples, packed, flags, cfg, light_map=lm)
        else:
            out = R.light_march(g, packed, flags, params.num_light_samples, cfg)
        out.sum().backward()
        torch.cuda.synchronize()

    before = fn.launches
    try:
        torch.use_deterministic_algorithms(True)
        with pytest.raises(RuntimeError, match="R1b" if kernel == "view_march_grad" else "R2b"):
            backward()
        assert fn.launches == before
        torch.use_deterministic_algorithms(True, warn_only=True)
        with pytest.warns(UserWarning, match="deterministic"):
            backward()
        assert fn.launches == before + 1
    finally:
        torch.use_deterministic_algorithms(False)
