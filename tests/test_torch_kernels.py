"""The PyTorch port's kernel modules (fluidx12_tpu_torch/ops/cuda) against
the JAX package's Pallas kernels in interpret mode, as tests/test_pallas.py
runs them.  On the CPU each wrapper takes its plain PyTorch version, which
has the kernel's semantics (clamp addressing, bf16 rounding points, fused
forces); tests/test_torch_cuda.py checks the CUDA kernels against the same
plain versions on the card.  Inputs are made with numpy from a seed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluidx12_tpu.core.config import FluidConfig
from fluidx12_tpu.ops.pallas import advect as pa
from fluidx12_tpu.ops.pallas.composite import composite_resample_pallas
from fluidx12_tpu.ops.pallas.sweep import shear_scan_pallas
from fluidx12_tpu_torch.core.config import FluidConfig as TorchConfig
from fluidx12_tpu_torch.ops.cuda import advect as ta
from fluidx12_tpu_torch.ops.cuda import composite as tc
from fluidx12_tpu_torch.ops.cuda import sweep as ts

# Several pytest workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)


def bf16_ulps(a, b) -> float:
    """Largest |a - b| per channel (leading axis) in bf16 ulps at that
    channel's largest magnitude: the size of one extra bf16 rounding of data
    at that scale (values near zero that cancel carry the scale's error,
    not their own)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    axes = tuple(range(1, a.ndim))
    mag = np.maximum(np.abs(a).max(axis=axes, keepdims=True),
                     np.abs(b).max(axis=axes, keepdims=True))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7.0)
    return float((np.abs(a - b) / ulp).max())


def _state(rng, shape, umax):
    f = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    f[:3] = (f[:3] - 0.5) * (2.0 * umax)
    return f


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("umax", [0.8, 20.0], ids=["calm", "heavy"])
def test_advect_xy_matches_pallas_fused_xy(storage, umax):
    """B1 vs `_run_pass_fused_xy` on (7, 8, 16, 128).  `heavy` drives the
    displacement past the 12-voxel clip.  The port returns the y result in
    f32; rounded to the storage dtype it is the kernel's output.  f32: atol
    3e-5, test_pallas.py's advect tolerance (XLA may contract the two tap
    products into an FMA).  bf16: within one ulp at each channel's scale
    (that contraction can flip the final rounding)."""
    rng = np.random.default_rng(7)
    f = _state(rng, (7, 8, 16, 128), umax)
    jv, tv = jnp.asarray(f), torch.from_numpy(f)
    if storage == "bf16":
        jv, tv = jv.astype(jnp.bfloat16), tv.to(torch.bfloat16)
    ref = np.asarray(pa._run_pass_fused_xy(jv, True, 0.7, -0.45).astype(jnp.float32))
    got = ta.advect_xy(tv, torch.tensor([0.7, -0.45]))
    assert got.dtype == torch.float32
    got = got.to(tv.dtype).float().numpy()
    if storage == "f32":
        np.testing.assert_allclose(got, ref, atol=3e-5, rtol=0)
    else:
        assert bf16_ulps(got, ref) <= 1.0


def _z_inputs():
    cfg = FluidConfig(grid_size=(128, 128, 16))
    tcfg = TorchConfig(grid_size=(128, 128, 16))
    # Pin the TPU path: both lateral passes fused, forces fused into z.
    assert pa.fused_xy_supported(cfg.zyx) and pa.zpass_forces_supported(cfg)
    rng = np.random.default_rng(2)
    f = _state(rng, (7,) + cfg.zyx, 1.0)
    jv = jnp.asarray(f).astype(jnp.bfloat16)
    tv = torch.from_numpy(np.array(jv.astype(jnp.float32))).to(torch.bfloat16)
    dt = cfg.time_step
    ref = np.asarray(pa.backtrace_pallas(jv, dt, cfg, forces_dt=dt).astype(jnp.float32))
    dtt = torch.tensor(dt, dtype=torch.float32)
    z, y, x = tcfg.zyx
    xy = ta.advect_xy(tv, torch.stack([dtt * x, dtt * y]))
    args = (torch.stack([dtt * z, dtt]), torch.from_numpy(ta.forces_table(tcfg)),
            ta.force_consts(tcfg))
    return ref, xy, args


@pytest.mark.parametrize("handoff", ["tpu_bf16", "port_f32"])
def test_advect_z_forces_matches_pallas_backtrace(handoff):
    """B1 then B2 vs `backtrace_pallas(..., forces_dt=dt)` (interpret) at
    grid (128, 128, 16), whole volume including the walls.  With B1's
    result rounded to bf16 first, as the TPU stores it between its two
    kernels, the port matches bit for bit; with the port's own f32 handoff
    it rounds once instead of twice, so within one bf16 ulp at each
    channel's scale."""
    ref, xy, args = _z_inputs()
    if handoff == "tpu_bf16":
        xy = xy.to(torch.bfloat16).float()
    got = ta.advect_z_forces(xy, *args, store=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    if handoff == "tpu_bf16":
        np.testing.assert_array_equal(got, ref)
    else:
        assert bf16_ulps(got, ref) <= 1.0


def test_advect_z_without_forces_matches_pallas_zpass_kernel():
    """B12 (`advect_z`, B2's kernel with its forces epilogue off) against
    the TPU's plain z pass (`_zpass_kernel`, which `backtrace_pallas` runs
    without `forces_dt`), fed B1's result rounded to bf16 as the TPU stores
    it: bit for bit."""
    cfg = FluidConfig(grid_size=(128, 128, 16))
    tcfg = TorchConfig(grid_size=(128, 128, 16))
    rng = np.random.default_rng(3)
    jv = jnp.asarray(_state(rng, (7,) + cfg.zyx, 1.0)).astype(jnp.bfloat16)
    tv = torch.from_numpy(np.array(jv.astype(jnp.float32))).to(torch.bfloat16)
    dt = cfg.time_step
    ref = np.asarray(pa.backtrace_pallas(jv, dt, cfg).astype(jnp.float32))
    dtt = torch.tensor(dt, dtype=torch.float32)
    z, y, x = tcfg.zyx
    xy = ta.advect_xy(tv, torch.stack([dtt * x, dtt * y])).to(torch.bfloat16).float()
    got = ta.advect_z(xy, torch.stack([dtt * z, dtt]))
    np.testing.assert_array_equal(got.float().numpy(), ref)


@pytest.mark.parametrize("slopes", [(0.7, -0.9), (-0.6, 0.8)], ids=["pos_a", "neg_a"])
def test_shear_scan_matches_pallas(slopes):
    """B9 vs `shear_scan_pallas` (interpret) on (16, 16, 128), positive and
    negative slopes with fractional shifts and the sign-dependent pads.
    atol 5e-5 (test_pallas.py allows 5e-4 against the einsum form): the
    scan adds in the kernel's order; only FMA contraction can differ."""
    rng = np.random.default_rng(5)
    log_att = -rng.uniform(0.0, 2.0, (16, 16, 128)).astype(np.float32)
    pads = [16.0 if slopes[0] < 0 else 0.0, 128.0 if slopes[1] < 0 else 0.0]
    ref = np.asarray(shear_scan_pallas(jnp.asarray(log_att), slopes[0], slopes[1],
                                       pads[0], pads[1]))
    got = ts.shear_scan(torch.from_numpy(log_att),
                        torch.tensor([*slopes, *pads], dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=0)


@pytest.mark.parametrize("flip,zero_outside", [(False, False), (True, False),
                                               (False, True), (True, True)],
                         ids=["False", "True", "False-zero_outside", "True-zero_outside"])
def test_composite_resample_matches_pallas(flip, zero_outside):
    """B10 vs `composite_resample_pallas` (interpret) with ns=8, a=b=128,
    r1=16, r2=128, coordinates partly past the edges (clamp; with
    `zero_outside`, the DIRECT base plane's mode, those beyond -0.5 and
    n - 0.5 get zero weight), some slices masked.  atol 1e-5 (test_pallas.py
    allows 2e-3 against the einsum twin): the bf16 rounding points are the
    kernel's; only exp/log1p and FMA contraction can differ."""
    rng = np.random.default_rng(9)
    ns, a, b, r1, r2 = 8, 128, 128, 16, 128
    volf = rng.uniform(0, 1, (4, ns, a, b)).astype(np.float32)
    h_rows = rng.uniform(-4.0, a + 3.0, (ns, r1)).astype(np.float32)
    h_cols = rng.uniform(-4.0, b + 3.0, (ns, r2)).astype(np.float32)
    valid = (rng.uniform(0, 1, ns) > 0.2).astype(np.float32)
    nst = rng.uniform(0.5, 2, (r1, r2)).astype(np.float32)
    ref = np.asarray(composite_resample_pallas(
        jnp.asarray(volf), jnp.asarray(h_rows), jnp.asarray(h_cols),
        jnp.asarray(valid), jnp.asarray(nst), 0.8, flip, zero_outside=zero_outside))
    args = (torch.from_numpy(volf).to(torch.bfloat16),
            *(torch.from_numpy(t) for t in (h_rows, h_cols, valid, nst)), 0.8, flip)
    got = tc.composite_resample(*args, zero_outside=zero_outside).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    if zero_outside:
        # The mode changes what the texels see.
        assert np.abs(got - tc.composite_resample(*args).numpy()).max() > 1e-2


@pytest.mark.parametrize("call", ["advect_xy", "shear_scan", "composite_resample"])
def test_wrappers_reject_bad_arguments(call):
    """Every wrapper checks dtype, shape and contiguity before dispatch."""
    with pytest.raises(ValueError):
        if call == "advect_xy":
            ta.advect_xy(torch.zeros((7, 4, 8, 8), dtype=torch.float16),
                         torch.zeros(2))
        elif call == "shear_scan":
            ts.shear_scan(torch.zeros((4, 8, 8)).transpose(1, 2), torch.zeros(4))
        else:
            tc.composite_resample(torch.zeros((4, 2, 8, 8)), torch.zeros((2, 4)),
                                  torch.zeros((2, 4)), torch.zeros(2),
                                  torch.zeros((4, 4)), 0.8, False)


def test_cpu_wrappers_count_no_launches():
    """On CPU tensors the wrappers run their plain versions and launch
    nothing, so the launch counts stay where they were."""
    from fluidx12_tpu_torch.ops.cuda import launch_counts

    before = launch_counts()
    ts.shear_scan(torch.zeros((2, 8, 8)), torch.zeros(4))
    assert launch_counts() == before
