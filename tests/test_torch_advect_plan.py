"""B1's and B2's launch plan and schedules (fluidx12_tpu_torch/csrc/advect.cu
advect_xy_kernel, advect_z_kernel) on the CPU: `advect_plan` owns every
output voxel exactly once and stages every row and plane an owned output's
taps can reach at the 12-voxel clip, its constants are those the kernel
source compiles, and a torch model of each schedule -- each CTA's x-pass
tile or z-window, NaN wherever it does not hold a cell -- gives
`advect_xy_plain` and `advect_z_forces_plain` bit for bit, on ragged
strips, axes shorter than the window and velocities past the clip.  A
window one row or plane short is caught.  The plain versions themselves are
held to the Pallas kernels in interpret mode by tests/test_torch_kernels.py."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fluidx12_tpu_torch.core.config import FluidConfig
from fluidx12_tpu_torch.ops.cuda import _build
from fluidx12_tpu_torch.ops.cuda import advect as A

# Several pytest workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)

NAN = float("nan")


def _state(zyx, dtype=torch.bfloat16, seed=0):
    """A (7, Z, Y, X) state whose velocities in [-3, 3) carry most
    displacements (scale 8) past the 12-voxel clip, the rest inside it."""
    rng = np.random.default_rng(seed)
    f = rng.uniform(0.0, 1.0, (7,) + tuple(zyx)).astype(np.float32)
    f[:3] = (f[:3] - 0.5) * 6.0
    f[:3, :, : zyx[1] // 4] *= 0.25  # a quarter of the rows inside the clip
    return torch.from_numpy(f).to(dtype)


def _taps(u, scale, ids, n):
    """(w0, w1, i0, i1) of the plain version's clamped 2-tap lerp along an
    axis of n cells, from the displacement channel u at cells `ids`."""
    d = torch.clamp(-u * scale, -A.MAX_DISP, A.MAX_DISP)
    d = torch.minimum(torch.maximum(d, -ids), (n - 1.0) - ids)
    a0 = torch.floor(d)
    w0 = (1.0 - (d - a0).abs()).clamp_min(0.0)
    w1 = (1.0 - (d - (a0 + 1.0)).abs()).clamp_min(0.0)
    i0 = (ids + a0).to(torch.int64)
    return w0, w1, i0, (i0 + 1).clamp_max(n - 1)


def _held(buf, idx, lo, axis):
    """buf gathered along `axis` at cells idx, read from a buffer holding
    cells [lo, lo + buf.shape[axis]); NaN where it holds no such cell."""
    k = idx - lo
    held = (k >= 0) & (k < buf.shape[axis])
    k = k.clamp(0, buf.shape[axis] - 1).unsqueeze(0).expand(buf.shape[:1] + k.shape)
    return torch.where(held.unsqueeze(0), torch.gather(buf, axis, k), NAN)


def _xy_model(vol, scales, plan):
    """advect_xy_kernel's schedule: CTA (i, j) (every plane alike) stages
    rows `window(j * tile, tile, Y)` of each channel's input window, the
    WIN_COLS columns from WIN_LEAD before its strip inside the volume; runs
    the x pass of its strip's lanes from that window alone, rounded to
    storage; and forms the y pass of its owned rows from those results
    alone.  Returns (out, writes), out NaN where no CTA writes."""
    c, nz, ny, nx = vol.shape
    q = vol.float()
    out = torch.full((c, nz, ny, nx), NAN)
    writes = torch.zeros((nz, ny, nx), dtype=torch.int32)
    for i in range(plan.xy_grid[0]):
        x0, x1 = i * plan.strip, min((i + 1) * plan.strip, nx)
        first = x0 - A.WIN_LEAD  # the windows' first column
        lo, hi = max(first, 0), min(first + A.WIN_COLS, nx)
        xs = torch.arange(x0, x1, dtype=torch.float32)
        for j in range(plan.xy_grid[1]):
            y0, yend = j * plan.xy_tile, min((j + 1) * plan.xy_tile, ny)
            ylo, yhi = A.window(y0, plan.xy_tile, ny)
            win = torch.full((c, nz, yhi - ylo, A.WIN_COLS), NAN)
            win[..., lo - first:hi - first] = q[:, :, ylo:yhi, lo:hi]
            w0, w1, i0, i1 = _taps(win[0][..., x0 - first:x1 - first], scales[0], xs, nx)
            tile = (w0 * _held(win, i0, first, 3) + w1 * _held(win, i1, first, 3)).to(
                vol.dtype).float()
            ids = torch.arange(y0, yend, dtype=torch.float32)[None, :, None]
            w0, w1, i0, i1 = _taps(tile[1][:, y0 - ylo:yend - ylo], scales[1], ids, ny)
            out[:, :, y0:yend, x0:x1] = (w0 * _held(tile, i0, ylo, 2)
                                         + w1 * _held(tile, i1, ylo, 2))
            writes[:, y0:yend, x0:x1] += 1
    return out, writes


def _z_model(vol, scal, plan):
    """advect_z_kernel's schedule without its epilogue: CTA (i, y, k)
    stages planes `window(k * z_tile, z_tile, Z)` of its strip of row y,
    one channel window at a time (the order does not change a value), and
    forms the z pass of its owned planes from those windows alone."""
    c, nz, ny, nx = vol.shape
    out = torch.full((c, nz, ny, nx), NAN)
    writes = torch.zeros((nz, ny, nx), dtype=torch.int32)
    for i in range(plan.z_grid[0]):
        x0, x1 = i * plan.strip, min((i + 1) * plan.strip, nx)
        for k in range(plan.z_grid[2]):
            z0, zend = k * plan.z_tile, min((k + 1) * plan.z_tile, nz)
            zlo, zhi = A.window(z0, plan.z_tile, nz)
            win = vol[:, zlo:zhi, :, x0:x1]  # every row y's CTA alike
            ids = torch.arange(z0, zend, dtype=torch.float32)[:, None, None]
            w0, w1, i0, i1 = _taps(win[2, z0 - zlo:zend - zlo], scal[0], ids, nz)
            out[:, z0:zend, :, x0:x1] = (w0 * _held(win, i0, zlo, 1)
                                         + w1 * _held(win, i1, zlo, 1))
            writes[z0:zend, :, x0:x1] += 1
    return out, writes


def _forced(zyx, dtype, xy_tile=None, z_tile=None):
    """`advect_plan`'s plan on zyx with B1's row tile or B2's plane tile
    forced, its grid and shared memory made to agree (the C launches take
    such a plan whole)."""
    nz, ny, nx = zyx
    bf16, halo = dtype == torch.bfloat16, A.HALO_LO + A.HALO_HI
    plan = A.advect_plan(zyx, dtype)
    if xy_tile is not None:
        plan = plan._replace(xy_tile=xy_tile, xy_smem=A.xy_smem(7, bf16, min(ny, xy_tile + halo)),
                             xy_grid=(plan.xy_grid[0], -(-ny // xy_tile), nz))
    if z_tile is not None:
        plan = plan._replace(z_tile=z_tile, z_smem=A.z_smem(7, min(nz, z_tile + halo)),
                             z_grid=(plan.z_grid[0], ny, -(-nz // z_tile)))
    return plan


def _z_args(zyx):
    cfg = FluidConfig(grid_size=tuple(zyx[::-1]))
    scal = torch.tensor([8.0, cfg.time_step], dtype=torch.float32)
    return scal, torch.from_numpy(A.forces_table(cfg)), A.force_consts(cfg)


# The 3D paths' grids (128^3, 256^3, the 256x256x60 and 150^3 GI frames),
# then small ones: a ragged X of 38, Y and Z shorter than the window (16,
# 20), Y tiled in f32 (100), Z tiled with a ragged last chunk (131), and
# odd dims.
PLANS = [(128, 128, 128), (256, 256, 256), (60, 256, 256), (150, 150, 150), (20, 38, 150),
         (16, 20, 38), (40, 100, 70), (131, 9, 33)]


@pytest.mark.parametrize("zyx", PLANS, ids=lambda v: "x".join(map(str, v)))
def test_advect_plan_owns_every_voxel_once(zyx):
    """Each axis's owned ranges partition it (B1: strips x tiles x planes;
    B2: strips x rows x plane chunks), and each CTA's window holds every
    row or plane within [-12, +13] of one it owns, clipped to the volume:
    the reach of both taps at the clip.  The shared memory is the window's
    at its largest and leaves room for two CTAs an SM; a tile is the whole
    axis where that fits, else one of the fewest tiles that fit, a multiple
    of WARPS where it can be; eight warps where four CTAs fit an SM."""
    nz, ny, nx = zyx
    for dtype in (torch.bfloat16, torch.float32):
        plan = A.advect_plan(zyx, dtype)
        assert plan.strip == A.STRIP
        strips = np.arange(nx) // plan.strip
        assert plan.xy_grid == (strips[-1] + 1, -(-ny // plan.xy_tile), nz)
        assert plan.z_grid == (strips[-1] + 1, ny, -(-nz // plan.z_tile))
        for tile, n, count in ((plan.xy_tile, ny, plan.xy_grid[1]),
                               (plan.z_tile, nz, plan.z_grid[2])):
            owner = np.full(n, -1)
            for j in range(count):
                lo, end = j * tile, min((j + 1) * tile, n)
                assert (owner[lo:end] == -1).all()
                owner[lo:end] = j
                first, last = A.window(lo, tile, n)
                reach = np.arange(lo, end)
                assert first <= max(reach[0] - 12, 0) and last >= min(reach[-1] + 14, n)
            assert (owner >= 0).all()
        bf16 = dtype == torch.bfloat16
        assert plan.xy_smem == A.xy_smem(7, bf16, min(ny, plan.xy_tile + 25))
        assert plan.z_smem == A.z_smem(7, min(nz, plan.z_tile + 25))
        assert max(plan.xy_smem, plan.z_smem) <= A.SMEM_BUDGET <= _build.SMEM_PER_CTA
        for tile, n, per_cell in ((plan.xy_tile, ny, A.xy_smem(7, bf16, 1)),
                                  (plan.z_tile, nz, A.z_smem(7, 1))):
            most = A.SMEM_BUDGET // per_cell - 25
            assert (tile >= n) == (n * per_cell <= A.SMEM_BUDGET)
            if tile < n:
                assert tile <= most and -(-n // tile) == -(-n // most)
                assert tile % A.WARPS == 0 or tile == -(-n // -(-n // most))
        for warps, smem in ((plan.xy_warps, plan.xy_smem), (plan.z_warps, plan.z_smem)):
            four = A.SMEM_PER_SM // (smem + A.CTA_RESERVED) >= 4
            assert warps == (A.FEW_WARPS if four else A.WARPS)


def test_advect_plan_matches_the_kernel_source():
    """The constants `advect_plan` uses are those csrc/advect.cu compiles:
    32 lanes a strip, a reach of 12 below and 13 above, 8 channels and 16
    warps at most, B1's input window, the shared-memory formulas; the C
    launches check the plan against them.
    The plan refuses what the kernels cannot run."""
    src = (Path(A.__file__).parents[2] / "csrc" / "advect.cu").read_text()
    c = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (A.STRIP, A.HALO_LO, A.HALO_HI, A.MAX_CHANNELS, A.MAX_WARPS) == (
        c["kLanes"], c["kHaloLo"], c["kHaloHi"], c["kMaxC"], c["kMaxWarps"])
    assert c["kSmemMax"] == _build.SMEM_PER_CTA
    assert float(re.search(r"kMaxDisp = ([\d.]+)f;", src).group(1)) == A.MAX_DISP
    assert (A.WIN_COLS, A.WIN_LEAD) == (c["kWinCols"], c["kWinLead"])
    assert A.WIN_LEAD >= A.HALO_LO and A.WIN_COLS - A.WIN_LEAD >= A.STRIP + A.HALO_HI
    assert "return rows * C * kWinCols * (bf16 ? 2 : 4);" in src
    assert "return C * planes * kLanes * (int)sizeof(float);" in src
    assert "smem != xy_smem(C, is_bf16 != 0, min(Y, tile_y + kHaloLo + kHaloHi))" in src
    assert "smem != z_smem(C, min(Z, tile_z + kHaloLo + kHaloHi))" in src
    assert A.FEW_WARPS < A.WARPS <= A.MAX_WARPS
    assert 2 * (A.SMEM_BUDGET + A.CTA_RESERVED) <= A.SMEM_PER_SM  # an SM's shared memory
    for zyx, kw in (((0, 8, 8), {}), ((4, 8, 8), dict(channels=9)),
                    ((70000, 8, 8), {}), ((4, 65536, 32768), {}), ((1300, 1300, 1300), {}),
                    ((4, 8, 8), dict(channels=1)), ((4, 8, -3), {}),
                    ((4, 70000, 8), {}), ((4, 8, 8), dict(dtype=torch.float16))):
        kw = dict(dict(dtype=torch.bfloat16), **kw)
        with pytest.raises(ValueError):
            A.advect_plan(zyx, **kw)


XY_CASES = [((2, 20, 38), torch.bfloat16, None), ((2, 16, 70), torch.bfloat16, 5),
            ((1, 41, 38), torch.bfloat16, 8), ((2, 30, 33), torch.float32, 7)]


@pytest.mark.parametrize("zyx,dtype,tile", XY_CASES, ids=[f"{i}" for i in range(len(XY_CASES))])
def test_xy_schedule_matches_plain(zyx, dtype, tile):
    """B1's schedule writes every voxel once and equals `advect_xy_plain`
    bit for bit: a whole column of 20 rows (shorter than the window) on a
    ragged X of 38, tiles of 5, 7 and 8 rows whose windows end inside the
    column, bf16 and f32 storage."""
    vol = _state(zyx, dtype, seed=sum(zyx))
    scales = torch.tensor([8.0, 8.0])
    out, writes = _xy_model(vol, scales, _forced(zyx, dtype, xy_tile=tile))
    assert (writes == 1).all()
    assert torch.equal(out, A.advect_xy_plain(vol, scales))


Z_CASES = [((20, 2, 38), None), ((40, 3, 38), 8), ((16, 4, 40), 5)]


@pytest.mark.parametrize("zyx,tile", Z_CASES, ids=[f"{i}" for i in range(len(Z_CASES))])
def test_z_schedule_matches_plain(zyx, tile):
    """B2's schedule, then the forces epilogue, equals
    `advect_z_forces_plain` bit for bit, and without the epilogue B12's
    plain version: Z = 20 and 16, shorter than the window, and 40 and 16
    in chunks of 8 and 5 planes, on ragged strips."""
    vol = _state(zyx, torch.float32, seed=sum(zyx) + 1)
    scal, table, consts = _z_args(zyx)
    out, writes = _z_model(vol, scal, _forced(zyx, torch.bfloat16, z_tile=tile))
    assert (writes == 1).all()
    assert torch.equal(out.to(torch.bfloat16),
                       A.advect_z_forces_plain(vol, scal, None, None, forces=False))
    assert torch.equal(A.forces_epilogue(out, scal, table, consts).to(torch.bfloat16),
                       A.advect_z_forces_plain(vol, scal, table, consts))


@pytest.mark.parametrize("halo", ["HALO_LO", "HALO_HI"])
def test_a_window_one_row_short_is_caught(monkeypatch, halo):
    """With the window's reach one row and plane short on either side, the
    models read a cell no CTA holds (NaN) and disagree with the plain
    versions: the schedule tests can see a short halo."""
    zyx = (24, 40, 38)
    vol = _state(zyx, seed=3)
    scal, _, _ = _z_args(zyx)
    plan = _forced(zyx, torch.bfloat16, xy_tile=8, z_tile=8)
    monkeypatch.setattr(A, halo, getattr(A, halo) - 1)
    xy, _ = _xy_model(vol, torch.tensor([8.0, 8.0]), plan)
    assert not torch.equal(xy, A.advect_xy_plain(vol, torch.tensor([8.0, 8.0])))
    z, _ = _z_model(vol.float(), scal, plan)
    assert not torch.equal(z.to(torch.bfloat16),
                           A.advect_z_forces_plain(vol.float(), scal, None, None, False))


def test_forces_table_is_built_once_per_config_and_device():
    """The 3D advection builds B2's forces table, and copies it to the
    fields' device, once per (config, device), not once a step: a second
    step of the same config finds it cached, bit for bit the table of
    `forces_table`."""
    from fluidx12_tpu_torch.sim import advect_fast as AF

    cfg = FluidConfig(grid_size=(8, 8, 8))
    fields = _state((8, 8, 8), seed=4)
    dt = torch.tensor(cfg.time_step, dtype=torch.float32)
    AF._forces_table_on.cache_clear()
    first = AF.advect_fields_fast(fields, dt, cfg)
    assert torch.equal(AF.advect_fields_fast(fields, dt, cfg), first)
    info = AF._forces_table_on.cache_info()
    assert (info.misses, info.hits) == (1, 1)
    assert torch.equal(AF._forces_table_on(cfg, fields.device),
                       torch.from_numpy(A.forces_table(cfg)))


# ---------------------------------------------------------------------------
# B11 (advect_row_kernel, advect_strip_kernel): `axis_plan`
# ---------------------------------------------------------------------------

def _row_model(vol, scale, disp_ch, plan, lead=None):
    """advect_row_kernel's schedule: CTA (i, j) stages, of each of its rows,
    every channel's columns [x0 - lead, xend + lead) clipped to the row
    (lead = ROW_LEAD; NaN wherever it holds nothing) and forms its columns
    [x0, xend) of those rows from that alone, rounded to storage.  Returns
    (out, writes)."""
    lead = A.ROW_LEAD if lead is None else lead
    c, nz, ny, nx = vol.shape
    q = vol.float().reshape(c, nz * ny, nx)
    out = torch.full(q.shape, NAN)
    writes = torch.zeros((nz * ny, nx), dtype=torch.int32)
    esize = vol.element_size()
    for j in range(plan.grid[1]):
        x0, xend = j * plan.span, min((j + 1) * plan.span, nx)
        wlo, whi = max(x0 - lead, 0), min(xend + lead, nx)
        assert (whi - wlo) * esize <= A.row_pitch(esize, plan.span, nx)
        win = q[:, :, wlo:whi]  # every row alike: a row reads only itself
        xs = torch.arange(x0, xend, dtype=torch.float32)
        w0, w1, i0, i1 = _taps(win[disp_ch][:, x0 - wlo:xend - wlo], scale, xs, nx)
        out[:, :, x0:xend] = (w0 * _held(win, i0, wlo, 2)
                              + w1 * _held(win, i1, wlo, 2)).to(vol.dtype).float()
        for i in range(plan.grid[0]):
            writes[i * plan.tile:(i + 1) * plan.tile, x0:xend] += 1
    return out.reshape(vol.shape), writes.reshape(nz, ny, nx)


def _strip_model(vol, scale, disp_ch, plan):
    """advect_strip_kernel's schedule: CTA (i, o, k) stages, of its strip's
    columns of line o (every line alike), every channel's cells `window(k
    tile, tile, n)` of the pass's axis (NaN wherever it holds nothing) and
    forms its cells [k tile, (k + 1) tile) from that alone, rounded to
    storage.  Returns (out, writes)."""
    c, nz, ny, nx = vol.shape
    dim = plan.axis + 1
    n = vol.shape[dim]
    q = vol.float()
    out = torch.full(q.shape, NAN)
    writes = torch.zeros((1,) + tuple(q.shape[1:]), dtype=torch.int32)
    shape = [1, 1, 1]
    for i in range(plan.grid[0]):
        xs, xe = i * plan.span, min((i + 1) * plan.span, nx)
        for k in range(plan.grid[2]):
            i0, iend = k * plan.tile, min((k + 1) * plan.tile, n)
            lo, hi = A.window(i0, plan.tile, n)
            win = q.narrow(dim, lo, hi - lo)[..., xs:xe]
            shape[plan.axis] = iend - i0
            ids = torch.arange(i0, iend, dtype=torch.float32).reshape(shape)
            u = win[disp_ch].narrow(plan.axis, i0 - lo, iend - i0)
            w0, w1, t0, t1 = _taps(u, scale, ids, n)
            res = w0 * _held(win, t0, lo, dim) + w1 * _held(win, t1, lo, dim)
            out[..., xs:xe].narrow(dim, i0, iend - i0).copy_(res.to(vol.dtype).float())
            writes[..., xs:xe].narrow(dim, i0, iend - i0).add_(1)
    return out, writes[0]


def _axis_model(vol, scale, disp_ch, plan):
    model = _row_model if plan.axis == 2 else _strip_model
    return model(vol, scale, disp_ch, plan)


# The 2D preset's plane, the 3D paths' grids, then ragged and small ones:
# X = 150 (4-byte aligned bf16 rows), odd X, Y and Z shorter than the
# window, Z = 1 and 2, an odd channel count.
AXIS_PLANS = [(1, 512, 512), (128, 128, 128), (60, 256, 256), (150, 150, 150),
              (20, 38, 150), (1, 20, 33), (2, 5, 7), (16, 1, 4096)]


@pytest.mark.parametrize("zyx", AXIS_PLANS, ids=lambda v: "x".join(map(str, v)))
def test_axis_plan_owns_every_voxel_once(zyx):
    """Along each axis and in either storage type, B11's CTAs' owned ranges
    partition the volume (x: row tiles x spans; y and z: strips x lines x
    tiles), every window holds each cell within [-12, +13] of one its CTA
    owns, clipped, and the shared memory is the tile's and fits two CTAs an
    SM.  The x pass stages whole rows where a row of every channel fits,
    with a row's threads on its column pairs and the rest of the CTA's 256
    on further rows.  The y and z passes take a column a lane, or a bf16
    pair where the rows are not 16-byte aligned; their tiles are the whole
    axis or at least MIN_TILE cells, give at least two CTAs an SM wherever
    tiles of MIN_TILE would, and a warp works two cells of its tile."""
    nz, ny, nx = zyx
    for dtype in (torch.bfloat16, torch.float32):
        esize = 2 if dtype == torch.bfloat16 else 4
        for axis in (2, 1, 0):
            plan = A.axis_plan(zyx, dtype, axis, 7)
            assert plan.axis == axis and plan.smem <= A.SMEM_BUDGET
            assert plan == A.axis_layout(zyx, dtype, axis, 7, plan.cols, plan.tile, plan.span)
            if axis == 2:
                assert plan.cols == (2 if nx % 2 == 0 else 1)
                assert plan.span == nx  # every grid here fits whole rows
                assert plan.smem == A.row_smem(7, esize, plan.tile, nx, nx)
                bx, by = plan.block
                assert bx == min(-(-nx // plan.cols), A.ROW_THREADS) and bx * by <= A.ROW_THREADS
                assert plan.tile == by == min(A.ROW_THREADS // bx, nz * ny)
                owned = [(i * plan.tile, min((i + 1) * plan.tile, nz * ny))
                         for i in range(plan.grid[0])]
                n = nz * ny
            else:
                n, outer = (ny, nz) if axis == 1 else (nz, ny)
                pair = esize == 2 and nx % 2 == 0 and (nx * esize) % 16 != 0
                assert plan.cols == (2 if pair else 1)
                assert plan.span == A.STRIP * plan.cols and plan.block[0] == A.STRIP
                assert plan.grid[:2] == (-(-nx // plan.span), outer)
                assert plan.smem == A.strip_smem(7, esize, plan.cols,
                                                 min(n, plan.tile + A.HALO_LO + A.HALO_HI))
                assert plan.block[1] == min(A.MAX_WARPS, max(plan.tile // 2, 1))
                assert plan.tile >= min(A.MIN_TILE, n)
                if plan.grid[0] * outer * -(-n // A.MIN_TILE) >= 2 * A.SMS:
                    assert int(np.prod(plan.grid)) >= 2 * A.SMS
                owned = [(k * plan.tile, min((k + 1) * plan.tile, n))
                         for k in range(plan.grid[2])]
                for lo, end in owned:
                    first, last = A.window(lo, plan.tile, n)
                    assert first <= max(lo - 12, 0) and last >= min(end - 1 + 14, n)
            owner = np.full(n, -1)
            for j, (lo, end) in enumerate(owned):
                assert lo < end and (owner[lo:end] == -1).all()
                owner[lo:end] = j
            assert (owner >= 0).all()


def test_axis_plan_fills_the_card_at_512():
    """Along y at the 2D preset's (1, 512, 512), the plan puts at least two
    CTAs on each SM (B2's fewest-tiles rule would give 48): 32 tiles of
    16 rows on 16 strips, 512 CTAs of 8 warps; the x pass one CTA a row
    with a thread on each column pair."""
    y = A.axis_plan((1, 512, 512), torch.bfloat16, 1)
    assert np.prod(y.grid) >= 264 == 2 * A.SMS
    assert (y.cols, y.tile, y.grid, y.block) == (1, 16, (16, 1, 32), (32, 8))
    b2_tile = A._tile(512, lambda rows: A.strip_smem(7, 2, 1, rows))  # B2's rule, in bf16
    assert 16 * -(-512 // b2_tile) == 48
    x = A.axis_plan((1, 512, 512), torch.bfloat16, 2)
    assert x.grid == (512, 1) and x.block == (256, 1) and x.smem == 7 * 1024


def test_axis_plan_matches_the_kernel_source():
    """The constants and formulas `axis_plan` uses are those csrc/advect.cu
    compiles and checks (a lead of 16 columns, 16-byte row pitches, CTAs of
    at most 256 threads in the x pass, spans of 64 columns, the shared-
    memory formulas, one or two columns a thread); the lead covers the
    taps' reach, and the C entry takes the plan whole.  The plan cuts rows
    too long for the budget into spans and refuses what the kernels cannot
    run."""
    src = (Path(A.__file__).parents[2] / "csrc" / "advect.cu").read_text()
    c = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (A.ROW_LEAD, A.ROW_ALIGN, A.ROW_THREADS, A.ROW_SPAN_ALIGN) == (
        c["kRowLead"], c["kRowAlign"], c["kRowThreads"], c["kRowSpanAlign"])
    assert A.ROW_LEAD >= max(A.HALO_LO, A.HALO_HI) and A.ROW_LEAD % 8 == 0
    assert A.ROW_SPAN_ALIGN % A.ROW_LEAD == 0 and A.ROW_ALIGN == 16
    for formula in ("return (min(span + 2 * kRowLead, X) * esize + kRowAlign - 1) / kRowAlign "
                    "* kRowAlign;",
                    "return tile * C * row_pitch(esize, span, X);",
                    "return C * cells * kLanes * cols * esize;",
                    "p.smem == row_smem(C, esize, p.tile, p.span, X)",
                    "p.smem == strip_smem(C, esize, p.cols, min(n, p.tile + kHaloLo + kHaloHi))",
                    "!(p.cols == 1 || (p.cols == 2 && X % 2 == 0))",
                    "p.span == kLanes * p.cols && p.bx == kLanes"):
        assert formula in src, formula
    assert _build._SIGNATURES["fx_advect_axis"][-7:-1] == [_build._I] * 6
    assert "fx_advect_axis_perthread" in _build._SIGNATURES
    long = A.axis_plan((2, 3, 20000), torch.bfloat16, 2)
    assert long.span < 20000 and long.span % A.ROW_SPAN_ALIGN == 0 and long.tile == 1
    assert long.smem == A.row_smem(7, 2, 1, long.span, 20000) <= A.SMEM_BUDGET
    assert A.row_smem(7, 2, 1, long.span + A.ROW_SPAN_ALIGN, 20000) > A.SMEM_BUDGET
    for zyx, kw in (((0, 8, 8), {}), ((4, 8, 8), dict(channels=9)), ((4, 8, 8), dict(axis=3)),
                    ((1300, 1300, 1300), {}), ((8, 70000, 8), dict(axis=0)),
                    ((4, 8, 8), dict(dtype=torch.float16)), ((4, 8, -3), {})):
        kw = dict(dict(dtype=torch.bfloat16, axis=1), **kw)
        with pytest.raises(ValueError):
            A.axis_plan(zyx, kw["dtype"], kw["axis"], kw.get("channels", 7))


# (zyx, dtype, axis, forced (tile, span) or None): whole rows of X = 150,
# 33 (odd: one column a thread) and 38, spans of 64 columns cutting a row
# of 150 and 200 into windows that end inside it; y over Y = 20 (shorter
# than the window) and Y = 40 in tiles of 8 and 13, z over Z = 2 and Z =
# 40 in tiles of 8, bf16 and f32, ragged strips.
AXIS_CASES = [((2, 6, 150), torch.bfloat16, 2, None), ((1, 5, 33), torch.bfloat16, 2, None),
              ((2, 3, 38), torch.float32, 2, None), ((1, 4, 150), torch.bfloat16, 2, (3, 64)),
              ((1, 3, 200), torch.float32, 2, (2, 64)), ((2, 20, 70), torch.bfloat16, 1, None),
              ((1, 40, 150), torch.bfloat16, 1, (8, None)), ((2, 40, 33), torch.float32, 1, (13, None)),
              ((2, 6, 38), torch.bfloat16, 0, None), ((40, 3, 70), torch.bfloat16, 0, (8, None)),
              ((20, 2, 38), torch.float32, 0, None)]


@pytest.mark.parametrize("zyx,dtype,axis,forced", AXIS_CASES,
                         ids=[str(i) for i in range(len(AXIS_CASES))])
def test_axis_schedule_matches_plain(zyx, dtype, axis, forced):
    """B11's schedule writes every voxel once and equals
    `advect_axis_plain` bit for bit, its displacement from the pass's own
    velocity channel, most displacements past the 12-voxel clip."""
    vol = _state(zyx, dtype, seed=sum(zyx) + axis)
    plan = A.axis_plan(zyx, dtype, axis)
    if forced is not None:
        tile, span = forced
        plan = A.axis_layout(zyx, dtype, axis, 7, plan.cols, tile, span)
    scale = torch.tensor(8.0)
    disp_ch = 2 - axis
    out, writes = _axis_model(vol, scale, disp_ch, plan)
    assert (writes == 1).all()
    assert torch.equal(out.to(dtype), A.advect_axis_plain(vol, scale, axis, disp_ch))


def test_an_axis_window_one_cell_short_is_caught(monkeypatch):
    """With the x pass's lead cut to one column short of the taps' reach,
    or the y window one row short on either side, the models read a cell
    no CTA holds (NaN) and disagree with the plain version."""
    scale = torch.tensor(8.0)
    vol = _state((1, 4, 150), seed=5)
    plan = A.axis_layout((1, 4, 150), torch.bfloat16, 2, 7, 2, 4, 64)
    ref = A.advect_axis_plain(vol, scale, 2, 0)
    assert torch.equal(_row_model(vol, scale, 0, plan)[0].to(torch.bfloat16), ref)
    short, _ = _row_model(vol, scale, 0, plan, lead=A.HALO_HI - 1)
    assert not torch.equal(short.to(torch.bfloat16), ref)
    vol = _state((1, 40, 70), seed=6)
    plan = A.axis_layout((1, 40, 70), torch.bfloat16, 1, 7, 2, 8)
    ref = A.advect_axis_plain(vol, scale, 1, 1)
    for halo in ("HALO_LO", "HALO_HI"):
        with monkeypatch.context() as m:
            m.setattr(A, halo, getattr(A, halo) - 1)
            short, _ = _strip_model(vol, scale, 1, plan)
        assert not torch.equal(short.to(torch.bfloat16), ref), halo
