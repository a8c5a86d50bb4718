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
import re
from pathlib import Path

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
from fluidx12_tpu_torch.ops.cuda import _build
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


# ---------------------------------------------------------------------------
# The launch plans of B4's whole-window order and B6 (csrc/jacobi.cu)
# ---------------------------------------------------------------------------

# B4's whole-window order runs where `jacobi` admits it (the TPU's
# whole-window plan: 128^3, (64, 32, 128), (32, 64, 128), the 256^3
# frames' coarse 128^3) and, through `smooth_padded`, on the compact coarse
# dims of padded grids, which no tile divides: (30, 128, 128), (75, 75, 75).
WINDOW_SHAPES = [(128, 128, 128), (64, 32, 128), (32, 64, 128), (16, 128, 128),
                 (30, 128, 128), (75, 75, 75), (40, 80, 128), (3, 5, 7), (1, 1, 1)]


@pytest.mark.parametrize("zyx", WINDOW_SHAPES, ids=lambda z: "x".join(map(str, z)))
def test_window_plan_owns_every_cell_once(zyx):
    """zsweep_kernel's grid, as `window_plan` gives it: every cell of the
    volume is owned by exactly one CTA, within the shared memory a CTA may
    take, and the chunk the longest (of 16, 8 and 4 planes) at which the
    volume fills 0.9 CTAs an SM."""
    (ty, tx), zchunk, smem = tj.window_plan(zyx)
    nz, ny, nx = zyx
    assert smem == tj.window_smem(zchunk) <= _build.SMEM_PER_CTA
    grid = (-(-nz // zchunk), -(-ny // ty), -(-nx // tx))
    owners = np.zeros(zyx, np.int32)
    for k in range(grid[0]):
        for j in range(grid[1]):
            for i in range(grid[2]):
                owners[k * zchunk:(k + 1) * zchunk, j * ty:(j + 1) * ty,
                       i * tx:(i + 1) * tx] += 1
    assert (owners == 1).all()
    fills = [z for z in (16, 8, 4) if owners.size >= 0.9 * tj.H100_SMS * ty * tx * z]
    assert zchunk == (fills[0] if fills else 4)


def test_launch_plans_match_the_kernel_source():
    """The constants the plans copy are those csrc/jacobi.cu compiles:
    zsweep_kernel's tile (kSY = kSWarps * kSRows rows of kSX), which its
    launch refuses to change, and packed_kernel's row of kPChunks float4s,
    cluster, range and thread limits."""
    src = (Path(tj.__file__).parents[2] / "csrc" / "jacobi.cu").read_text()
    c = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    c = {k: int(v) for k, v in c.items()}
    assert tj.WINDOW_TILE == (c["kSWarps"] * c["kSRows"], c["kSX"])
    assert "kSY = kSWarps * kSRows;" in src
    assert tj.PACKED_ROW == 4 * c["kPChunks"]
    assert tj.PACKED_MAX_CLUSTER == c["kPMaxCluster"]
    assert tj.PACKED_MAX_ROWS == c["kPMaxRows"]
    assert max(tj.packed_plan(s)[2] for s in ((64, 64, 64), (2, 16, 64))) <= c["kPMaxThreads"]


PACKED_SHAPES = [(nz, ny, 64) for ny in range(16, 4096 // 2 + 1, 16)
                 for nz in range(2, 4096 // ny + 1)]


def test_packed_plan_covers_every_gated_shape():
    """B6's cluster plan on every (Z, Y, X) its gate admits (X = 64, Y a
    multiple of 16, Z >= 2, Z * Y <= 4096): at most 16 CTAs, each owning a
    non-empty range of rows, together every row exactly once, with its
    two q buffers within 227 KB of shared memory and one thread per float4
    of its range."""
    assert all(tj.jacobi_packed_supported(s) for s in PACKED_SHAPES)
    assert not tj.jacobi_packed_supported((2, 4096 // 2 + 16, 64))
    for shape in PACKED_SHAPES:
        cluster, rpc, threads, smem = tj.packed_plan(shape)
        rows = shape[0] * shape[1]
        assert 1 <= cluster <= tj.PACKED_MAX_CLUSTER and rpc & (rpc - 1) == 0
        assert (cluster - 1) * rpc < rows <= cluster * rpc, shape
        assert smem == 2 * rpc * 64 * 4 <= _build.SMEM_PER_CTA
        assert threads == min(1024, rpc * 16) and (rpc * 16) % threads == 0
    for bad in ((4, 16, 128), (2, 2064, 64)):
        with pytest.raises(ValueError):
            tj.packed_plan(bad)


def _packed_model(q: np.ndarray, b: np.ndarray, iters: int) -> np.ndarray:
    """packed_kernel's decomposition in numpy: each CTA's two q buffers and
    b buffer start as NaN and receive only the rows `packed_plan` gives
    it; each sweep reads every row's neighbours from whichever CTA owns
    them (the edge-clamped y+, y-, z+, z- rows; x within the row), sums
    x+, x-, y+, y-, z+, z- and writes the other buffer, the last sweep the
    output.  A row read from a CTA that does not own it stays NaN."""
    nz, ny, nx = q.shape
    cluster, rpc, _, _ = tj.packed_plan(q.shape)
    rows = nz * ny
    own = [range(r * rpc, min((r + 1) * rpc, rows)) for r in range(cluster)]
    buf = np.full((2, cluster, rpc, nx), np.nan, np.float32)
    bsm = np.full((cluster, rpc, nx), np.nan, np.float32)
    for r, rr in enumerate(own):
        buf[0, r, :len(rr)] = q.reshape(rows, nx)[rr]
        bsm[r, :len(rr)] = b.reshape(rows, nx)[rr]
    row = np.minimum(np.arange(cluster * rpc), rows - 1).reshape(cluster, rpc)
    z, y = row // ny, row % ny
    nbrs = (np.where(y < ny - 1, row + 1, row), np.where(y > 0, row - 1, row),
            np.where(z < nz - 1, row + ny, row), np.where(z > 0, row - ny, row))
    out = np.full((rows, nx), np.nan, np.float32)
    for k in range(iters):
        src = buf[k & 1]
        s = (np.concatenate([src[..., 1:], src[..., -1:]], -1)
             + np.concatenate([src[..., :1], src[..., :-1]], -1))
        for n in nbrs:
            s = s + src[n // rpc, n % rpc]
        new = (s - bsm) / np.float32(6.0)
        if k < iters - 1:
            buf[1 - (k & 1)] = new
        else:
            for r, rr in enumerate(own):
                out[rr] = new[r, :len(rr)]
    return out.reshape(q.shape)


@pytest.mark.parametrize("shape", [(2, 16, 64), (17, 48, 64), (4, 1024, 64), (64, 64, 64)])
def test_packed_row_exchange_matches_plain(shape):
    """The numpy model of B6's row exchange, NaN wherever a CTA would read
    a row it was not given, reproduces `jacobi_packed_plain` bit for bit:
    two CTAs, a partial last range, z neighbours four CTAs away, the
    default preset's 64^3 coarse level."""
    rng = np.random.default_rng(13)
    q = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    ref = tj.jacobi_packed_plain(torch.from_numpy(q), torch.from_numpy(b), 3).numpy()
    np.testing.assert_array_equal(_packed_model(q, b, 3), ref)


# ---------------------------------------------------------------------------
# B14's launch plan and tiled schedule (csrc/jacobi.cu jacobi2d_kernel)
# ---------------------------------------------------------------------------

# Every (Y, X) plane B14's gate admits: Y a multiple of 8, X of 128, at most
# 393216 cells, from (8, 128) up to (768, 512), (3072, 128) and (8, 49152).
J2D_PLANES = [(ny, nx) for nx in range(128, 49152 + 1, 128)
              for ny in range(8, 393216 // nx + 1, 8)]


@functools.lru_cache(maxsize=None)
def _j2_owners(n: int, t: int, ring: int) -> np.ndarray:
    """How many CTAs write each of an axis's n cells, by jacobi2d_kernel's
    rule along one axis: CTA j of ceil(n / t) holds region blocks b of 4
    cells from j * t - ring + 4b, and writes a block that lies in the plane
    and in [ring / 4, ring / 4 + t / 4) (`owned`; the tile grid is a
    product, so each axis stands alone)."""
    rb = ring // tj.J2D_BLOCK
    blk = np.arange((t + 2 * ring) // tj.J2D_BLOCK)
    g0 = np.arange(-(-n // t))[:, None] * t - ring + blk[None] * tj.J2D_BLOCK
    owned = (g0 >= 0) & (g0 < n) & (blk >= rb) & (blk < rb + t // tj.J2D_BLOCK)
    cells = (g0[owned][:, None] + np.arange(tj.J2D_BLOCK)).ravel()
    assert cells.max() < n
    return np.bincount(cells, minlength=n)


def test_jacobi2d_plan_covers_every_gated_plane():
    """B14's plan on every plane its gate admits, for the 2D preset's 64
    sweeps and for 1: tiles of whole 4 x 4 blocks whose CTAs, by the
    kernel's ownership rule, write every row and column of the plane
    exactly once, a ring of whole blocks no narrower than the sweeps of one
    launch, at most 512 threads (one a block of the tile and its ring) and
    their edge buffers within 227 KB of shared memory."""
    assert all(tj.jacobi2d_pallas_supported(p) for p in J2D_PLANES)
    assert len(J2D_PLANES) > 2000 and not tj.jacobi2d_pallas_supported((776, 512))
    for plane in J2D_PLANES:
        for iters in (64, 1):
            (ty, tx), ring, smem = tj.jacobi2d_plan(plane, iters)
            assert ty % 4 == tx % 4 == ring % 4 == 0 and ring >= min(iters, tj.J2D_RING)
            threads = tj.jacobi2d_threads((ty, tx), ring)
            assert threads <= tj.J2D_MAX_THREADS and smem == 2 * 4 * threads * 16
            assert smem <= _build.SMEM_PER_CTA
            for n, t in zip(plane, (ty, tx)):
                assert (_j2_owners(n, t, ring) == 1).all()
    for bad in ((6, 128), (8, 126)):
        with pytest.raises(ValueError):
            tj.jacobi2d_plan(bad, 64)


def test_jacobi2d_plan_matches_the_kernel_source():
    """The constants `jacobi2d_plan` uses are those csrc/jacobi.cu compiles:
    a thread's block of kJ2Block x kJ2Block cells, at most kJ2MaxThreads
    region blocks a CTA, and the thread and shared-memory counts."""
    src = (Path(tj.__file__).parents[2] / "csrc" / "jacobi.cu").read_text()
    c = {k: int(v) for k, v in re.findall(r"constexpr int (kJ2\w+) = (\d+);", src)}
    assert (tj.J2D_BLOCK, tj.J2D_MAX_THREADS) == (c["kJ2Block"], c["kJ2MaxThreads"])
    assert "return ((ty + 2 * ring) / kJ2Block) * ((tx + 2 * ring) / kJ2Block);" in src
    assert "return 2 * 4 * threads * (int)sizeof(float4);" in src


def _jacobi2d_model(q: np.ndarray, b: np.ndarray, iters: int) -> np.ndarray:
    """jacobi2d_kernel's schedule in numpy: ceil(iters / ring) launches,
    each writing a buffer that starts as NaN; per tile of the plan, a
    region of the tile and its ring holding q and b where it lies in the
    plane and NaN elsewhere, swept up to `ring` times in the y+, y-, x+, x-
    order -- a neighbour past the plane's edge clamps to the cell, one past
    the region's rim is NaN -- and only the tile written."""
    ny, nx = q.shape
    (ty, tx), ring, _ = tj.jacobi2d_plan(q.shape, iters)
    cur, four = q, np.float32(4.0)
    for k in range(-(-iters // ring)):
        nxt = np.full_like(q, np.nan)
        for y0 in range(0, ny, ty):
            for x0 in range(0, nx, tx):
                gy, gx = y0 - ring + np.arange(ty + 2 * ring), x0 - ring + np.arange(tx + 2 * ring)
                iy, ix = (gy >= 0) & (gy < ny), (gx >= 0) & (gx < nx)
                inside = iy[:, None] & ix[None]
                reg = np.full(inside.shape, np.nan, np.float32)
                breg = reg.copy()
                reg[inside], breg[inside] = cur[np.ix_(gy[iy], gx[ix])].ravel(), \
                    b[np.ix_(gy[iy], gx[ix])].ravel()
                rim_r = np.full((1, gx.size), np.nan, np.float32)
                rim_c = np.full((gy.size, 1), np.nan, np.float32)
                for _ in range(min(ring, iters - k * ring)):
                    yp = np.where((gy == ny - 1)[:, None], reg, np.concatenate([reg[1:], rim_r]))
                    ym = np.where((gy == 0)[:, None], reg, np.concatenate([rim_r, reg[:-1]]))
                    xp = np.where(gx == nx - 1, reg, np.concatenate([reg[:, 1:], rim_c], 1))
                    xm = np.where(gx == 0, reg, np.concatenate([rim_c, reg[:, :-1]], 1))
                    reg = np.where(inside, (((yp + ym) + xp) + xm - breg) / four, np.nan)
                tile = (slice(ring, ring + ty), slice(ring, ring + tx))
                ty_in, tx_in = iy[tile[0]], ix[tile[1]]
                nxt[np.ix_(gy[tile[0]][ty_in], gx[tile[1]][tx_in])] = \
                    reg[tile][np.ix_(ty_in, tx_in)]
        cur = nxt
    return cur


@pytest.mark.parametrize("shape", [(8, 128), (40, 128), (24, 256)])
def test_jacobi2d_tiled_schedule_matches_plain(shape):
    """The numpy model of B14's tiled schedule, NaN wherever a tile would
    read what its region was not given or write nothing, reproduces
    `jacobi2d_plain` bit for bit for one launch, a full one, a remainder
    and chains: a plane thinner than a tile, one whose last tile is
    partial, one two tiles wide."""
    rng = np.random.default_rng(14)
    q = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    for iters in (0, 1, 3, 8, 9, 17):
        ref = tj.jacobi2d_plain(torch.from_numpy(q), torch.from_numpy(b), iters).numpy()
        np.testing.assert_array_equal(_jacobi2d_model(q, b, iters), ref)


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
