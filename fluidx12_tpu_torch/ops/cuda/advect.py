"""Advection kernels B1 (x then y), B11 (one axis) and B2 (z + fused
forces), with their plain PyTorch versions.

B1 `advect_xy` replaces fluidx12_tpu/ops/pallas/advect.py
`_pass_kernel_fused_xy` (via `_run_pass_fused_xy`); B11 `advect_axis`
replaces the single-axis passes `_pass_kernel_fused_d`/`_pass_kernel_fused_d1`
(via `_run_pass_fused`) and `_pass_kernel` (via `_run_pass`), which the TPU
runs where a plane is too large for B1 (the 2D preset's x then y passes);
B2 `advect_z_forces` replaces `_zpass_forces_kernel` (via `_run_zpass`),
and B12 `advect_z`, the same kernel without its forces epilogue, the plain
`_zpass_kernel`.  All
follow the TPU kernels' semantics, not the mirror-addressed XLA twin's: clamp addressing folded into the displacement,
the x-pass result rounded to the storage dtype before the y pass, and the
forces epilogue in the per-channel table form of `_forces_table`.  One
difference: B1 returns its y-pass result in f32 and B2 reads it so, where
the TPU rounds it to bf16 in HBM between the two kernels (csrc/advect.cu
says why); rounding B1's output to the storage dtype gives the TPU kernel's
output bit for bit.  Sources, the Hopper designs (B1 one launch whose y
taps come from a shared-memory tile, B2 a staged z-window, both laid out
by `advect_plan`; B11 whole rows staged for x and B2's window along y or
z, in the storage dtype, laid out by `axis_plan`) and what bounds them:
fluidx12_tpu_torch/csrc/advect.cu.  `perthread` keeps the designs they
replaced as yardsticks.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
(or raises).  The plain versions also run on the card, where chip_smoke.py
compares each kernel with its plain version.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from fluidx12_tpu_torch.ops.cuda import _build

MAX_DISP = 12.0  # voxels (fluidx12_tpu/ops/pallas/advect.py MAX_DISP)

# advect_xy_kernel and advect_z_kernel, compiled for these: a strip of
# STRIP x-columns, one lane each; a tap reaches HALO_LO cells below its
# output and HALO_HI above (floor(d) >= -MAX_DISP, the second tap at
# floor(d) + 1 <= MAX_DISP + 1); at most MAX_CHANNELS channels and
# MAX_WARPS warps a CTA.
STRIP = 32
HALO_LO = 12
HALO_HI = 13
MAX_CHANNELS = 8
MAX_WARPS = 16
# B1's x-pass input window of a row: WIN_COLS columns from WIN_LEAD before
# its strip, which hold every tap of the strip's lanes.
WIN_COLS = 64
WIN_LEAD = 16
# The launch plan's choices, B1's and B2's alike: warps a CTA (FEW_WARPS
# where four or more CTAs fit an SM), and the shared memory a CTA may take
# while two still fit an SM (SMEM_PER_SM, less CTA_RESERVED a CTA).
WARPS = 16
FEW_WARPS = 8
SMEM_BUDGET = 113 * 1024
SMEM_PER_SM = 233472
CTA_RESERVED = 1024
# B11 (advect_row_kernel, advect_strip_kernel), compiled for these: the x
# pass stages ROW_LEAD columns either side of the ones a CTA owns, each
# channel's row ROW_ALIGN-byte aligned, in CTAs of at most ROW_THREADS
# threads; a CTA's columns short of a whole row are a multiple of
# ROW_SPAN_ALIGN.  The y and z passes take a strip of STRIP lanes, each
# owning 1 or 2 adjacent columns.  The plan's choice: about
# AXIS_CTAS_PER_SM CTAs on each of an H100's SMS SMs, with tiles of at
# least MIN_TILE cells (a window then stages at most about four times the
# cells its CTA owns).
ROW_LEAD = 16
ROW_ALIGN = 16
ROW_THREADS = 256
ROW_SPAN_ALIGN = 64
AXIS_CTAS_PER_SM = 4
SMS = 132
MIN_TILE = 8

_STORAGE = (torch.bfloat16, torch.float32)


def forces_table(config) -> np.ndarray:
    """(7, 5) per-channel [A_basis, B_negdz, B_dx, clip_lo, clip_hi]
    (Impulse.hlsli / CSAdvect.hlsl:57-68 constants; the table of
    ops/pallas/advect.py `_forces_table`)."""
    big = 3.0e38
    fc = np.zeros((7, 5), np.float32)
    fs = config.force_scale_3d
    f = np.asarray(config.ext_force, np.float32)
    fc[0] = [f[0] * fs, config.vort_scale, 0.0, -big, big]
    fc[1] = [f[1] * fs, 0.0, 0.0, -big, big]
    fc[2] = [f[2] * fs, 0.0, config.vort_scale, -big, big]
    rgba = np.asarray((*config.impulse_color, 1.0), np.float32) * config.impulse_density
    for j in range(4):
        fc[3 + j] = [rgba[j], 0.0, 0.0, 0.0, 1.0]
    return fc


def force_consts(config):
    """(ip_x, ip_y, ip_z, radius^2, dissipation) as the f32 values the
    kernel's arithmetic sees."""
    ip = config.impulse_pos
    vals = (ip[0], ip[1], ip[2], config.impulse_radius * config.impulse_radius,
            config.dissipation)
    return tuple(float(np.float32(v)) for v in vals)


def _check_vol(vol: torch.Tensor, name: str) -> None:
    if vol.ndim != 4 or vol.dtype not in _STORAGE or not vol.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous (C, Z, Y, X) bf16/f32 "
                         f"tensor, got {tuple(vol.shape)} {vol.dtype}")


def _check_f32(t: torch.Tensor, shape, ref: torch.Tensor, name: str) -> None:
    if (tuple(t.shape) != tuple(shape) or t.dtype != torch.float32
            or t.device != ref.device or not t.is_contiguous()):
        raise ValueError(f"{name}: expected contiguous f32 {tuple(shape)} on "
                         f"{ref.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def _on_cuda(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


# ---------------------------------------------------------------------------
# Launch plan
# ---------------------------------------------------------------------------

class AdvectPlan(NamedTuple):
    """How B1 and B2 cut a (Z, Y, X) volume (`advect_plan`)."""
    strip: int       # x-columns a CTA owns, one lane each
    xy_tile: int     # B1: rows of one plane a CTA owns
    xy_warps: int
    xy_smem: int     # B1: bytes of its staged input windows
    xy_grid: tuple   # B1: (strips, row tiles, planes)
    z_tile: int      # B2: planes of one row a CTA owns
    z_warps: int
    z_smem: int      # B2: bytes of its staged window
    z_grid: tuple    # B2: (strips, rows, plane chunks)


def window(lo: int, n_own: int, n: int):
    """[first, end) of the rows or planes a CTA stages to own [lo, lo +
    n_own) of an axis of n cells: its taps' reach, clipped to the axis
    (csrc/advect.cu ylo/yhi and zlo/zhi)."""
    end = min(lo + n_own, n)
    return max(lo - HALO_LO, 0), min(end + HALO_HI, n)


def xy_smem(channels: int, bf16: bool, rows: int) -> int:
    """Bytes of B1's shared memory for `rows` rows (csrc/advect.cu
    xy_smem): each row's x-pass input window of every channel, WIN_COLS
    columns around the strip, which the x pass overwrites with its
    result."""
    return rows * channels * WIN_COLS * (2 if bf16 else 4)


def z_smem(channels: int, planes: int) -> int:
    """Bytes of B2's staged window, every channel's `planes` planes of a
    strip (csrc/advect.cu z_smem)."""
    return channels * planes * STRIP * 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _tile(n: int, smem_of) -> int:
    """Cells of an axis of n a CTA owns: all n where the window of the
    whole axis fits SMEM_BUDGET, else the fewest tiles whose window (the
    tile and HALO_LO + HALO_HI cells) does, evened out and rounded up to a
    multiple of WARPS where the window still fits: fewer tiles stage fewer
    halo cells twice, and the warps, one row or plane each a step, then all
    work in a tile's last step."""
    if smem_of(n) <= SMEM_BUDGET:
        return n
    most = max(SMEM_BUDGET // smem_of(1) - HALO_LO - HALO_HI, 1)
    even = _cdiv(n, _cdiv(n, most))
    rounded = _cdiv(even, WARPS) * WARPS
    return rounded if rounded <= most else even


def _warps(smem: int) -> int:
    """Warps a CTA of `smem` bytes: WARPS, or FEW_WARPS where four or more
    such CTAs share an SM, which keeps 32 warps an SM resident either way
    (fewer, longer warps then run the short axis faster)."""
    return FEW_WARPS if SMEM_PER_SM // (smem + CTA_RESERVED) >= 4 else WARPS


@functools.lru_cache(maxsize=None)
def advect_plan(zyx: tuple, dtype, channels: int = 7) -> AdvectPlan:
    """B1's and B2's launch plan on a (Z, Y, X) volume of `channels`
    channels stored in `dtype` (B1's input; B2 reads f32 whatever it
    stores).  B1's CTA (i, j, z) owns x-columns [32 i, 32 i + 32) and rows
    [j * xy_tile, (j + 1) * xy_tile) of plane z and stages rows
    `window(j * xy_tile, xy_tile, Y)` of each channel's input window.
    B2's CTA (i, y, k) owns the same columns of row y in planes [k *
    z_tile, (k + 1) * z_tile) and stages planes `window(k * z_tile, z_tile,
    Z)` of every channel.  Everything is clipped to the volume.  Each tile
    is the whole axis where its window leaves room for two CTAs an SM
    (SMEM_BUDGET), else `_tile`'s; the warps follow the shared memory
    (`_warps`).  Cached: the wrappers ask for it on every call.
    `fx_advect_xy` and `fx_advect_z_forces` launch with the plan and refuse
    one whose shared memory is not its tile's.  Raises ValueError where no
    plan fits: a channel count the kernels do not take, a channel of 2^31
    cells or more, or more than 65535 planes or rows."""
    nz, ny, nx = (int(v) for v in zyx)
    bf16 = dtype == torch.bfloat16
    if (dtype not in _STORAGE or not 2 <= channels <= MAX_CHANNELS or min(nz, ny, nx) < 1
            or nz * ny * nx >= 2 ** 31 or max(nz, ny) > 65535):
        raise ValueError(f"advect_plan: no plan for {channels} channels of {tuple(zyx)} "
                         f"{dtype}")
    halo = HALO_LO + HALO_HI
    xy_tile = _tile(ny, lambda rows: xy_smem(channels, bf16, rows))
    z_tile = _tile(nz, lambda planes: z_smem(channels, planes))
    xy_bytes = xy_smem(channels, bf16, min(ny, xy_tile + halo))
    z_bytes = z_smem(channels, min(nz, z_tile + halo))
    return AdvectPlan(
        STRIP, xy_tile, _warps(xy_bytes), xy_bytes, (_cdiv(nx, STRIP), _cdiv(ny, xy_tile), nz),
        z_tile, _warps(z_bytes), z_bytes, (_cdiv(nx, STRIP), ny, _cdiv(nz, z_tile)))


class AxisPlan(NamedTuple):
    """How B11 cuts a (Z, Y, X) volume along one axis (`axis_plan`)."""
    axis: int    # 0 z, 1 y, 2 x
    cols: int    # adjacent columns a thread forms and stores as one word
    tile: int    # x: rows a CTA owns (of the Z * Y rows); y, z: cells of the axis
    span: int    # x: columns a CTA owns of each row (X: the whole row); y, z:
                 # columns of its strip, STRIP * cols
    block: tuple  # x: (threads along a row, rows at a time); y, z: (STRIP, warps)
    smem: int    # bytes of staged input
    grid: tuple  # x: (row tiles, spans); y: (strips, planes, tiles); z: (strips, rows, tiles)


def row_pitch(esize: int, span: int, nx: int) -> int:
    """Bytes between two staged rows of B11's x pass: a span of columns
    and ROW_LEAD either side, clipped to the row, rounded up to ROW_ALIGN
    (csrc/advect.cu row_pitch)."""
    return _cdiv(min(span + 2 * ROW_LEAD, nx) * esize, ROW_ALIGN) * ROW_ALIGN


def row_smem(channels: int, esize: int, tile: int, span: int, nx: int) -> int:
    """Bytes of B11's x pass: every channel of `tile` staged rows
    (csrc/advect.cu row_smem)."""
    return tile * channels * row_pitch(esize, span, nx)


def strip_smem(channels: int, esize: int, cols: int, cells: int) -> int:
    """Bytes of B11's y or z window: every channel's `cells` cells of a
    strip of STRIP * cols columns (csrc/advect.cu strip_smem)."""
    return channels * cells * STRIP * cols * esize


def axis_layout(zyx: tuple, dtype, axis: int, channels: int, cols: int, tile: int,
                span: int | None = None, warps: int | None = None) -> AxisPlan:
    """B11's plan along `axis` with the given choices, the rest derived from
    them: `axis_plan`'s own, or one forced to other columns, tiles, spans or
    warps.  Nothing is checked here; `fx_advect_axis` refuses a plan its
    kernels do not take."""
    nz, ny, nx = (int(v) for v in zyx)
    esize = 2 if dtype == torch.bfloat16 else 4
    if axis == 2:
        span = nx if span is None else span
        bx = min(_cdiv(span, cols), ROW_THREADS)
        by = max(1, min(ROW_THREADS // bx, tile))
        return AxisPlan(axis, cols, tile, span, (bx, by), row_smem(channels, esize, tile, span, nx),
                        (_cdiv(nz * ny, tile), _cdiv(nx, span)))
    n, outer = (ny, nz) if axis == 1 else (nz, ny)
    smem = strip_smem(channels, esize, cols, min(n, tile + HALO_LO + HALO_HI))
    warps = min(MAX_WARPS, max(tile // 2, 1)) if warps is None else warps
    return AxisPlan(axis, cols, tile, STRIP * cols, (STRIP, warps), smem,
                    (_cdiv(nx, STRIP * cols), outer, _cdiv(n, tile)))


@functools.lru_cache(maxsize=None)
def axis_plan(zyx: tuple, dtype, axis: int, channels: int = 7) -> AxisPlan:
    """B11's launch plan along `axis` (0 z, 1 y, 2 x) of a (Z, Y, X) volume
    of `channels` channels stored in `dtype`.
      - x: CTA (i, j) owns rows [i tile, (i + 1) tile) of the Z * Y rows and
        columns [j span, (j + 1) span) and stages their columns ROW_LEAD
        either side, clipped to the row.  The span is the whole row where
        every channel of one row fits SMEM_BUDGET (no column staged
        twice), else the widest multiple of ROW_SPAN_ALIGN that fits.  A
        thread forms `cols` = 2 adjacent columns where X is even (one
        4-byte bf16 or 8-byte f32 store), else 1; a row's threads
        `ceil(span / cols)` up to ROW_THREADS, and the tile as many rows
        as the rest of ROW_THREADS threads take, one each.
      - y, z: CTA (i, o, k) owns a strip of STRIP * cols columns of plane o
        (y) or row o (z) and cells [k tile, (k + 1) tile) of the axis, and
        stages their `window`.  A lane owns one column, or a bf16 pair
        where the rows are not 16-byte aligned (X = 150: there a 32-column
        strip's 64-byte row straddles three 32-byte sectors, and pairs ran
        faster; PERF.md, the PR 13 finding).  The axis
        is cut into the fewest even tiles that give AXIS_CTAS_PER_SM CTAs
        an SM (the whole axis where the strips and lines alone do), of at
        least MIN_TILE cells, and never more than the fewest tiles whose
        window fits SMEM_BUDGET allow (`_tile`); a warp per two cells of
        the tile, at most MAX_WARPS.
    Cached: the wrapper asks for it on every call.  `fx_advect_axis`
    launches with the plan and refuses one that is not a layout its kernels
    take with the shared memory of its tile.  Raises ValueError where no
    plan fits: an axis other than 0..2, a channel count the kernels do not
    take, a channel of 2^31 cells or more, more than 65535 planes or rows
    outside the pass, or a row whose every channel does not fit one span
    of ROW_SPAN_ALIGN columns."""
    nz, ny, nx = (int(v) for v in zyx)
    if (dtype not in _STORAGE or axis not in (0, 1, 2) or not 1 <= channels <= MAX_CHANNELS
            or min(nz, ny, nx) < 1 or nz * ny * nx >= 2 ** 31):
        raise ValueError(f"axis_plan: no plan for {channels} channels of {tuple(zyx)} "
                         f"{dtype} along axis {axis}")
    esize = 2 if dtype == torch.bfloat16 else 4
    if axis == 2:
        cols = 2 if nx % 2 == 0 else 1
        span = nx
        if channels * row_pitch(esize, nx, nx) > SMEM_BUDGET:
            span = (SMEM_BUDGET // (channels * esize) - 2 * ROW_LEAD) // ROW_SPAN_ALIGN
            span *= ROW_SPAN_ALIGN
            if span < ROW_SPAN_ALIGN or _cdiv(nx, span) > 65535:
                raise ValueError(f"axis_plan: no x plan for {tuple(zyx)} {dtype}")
        rows = max(ROW_THREADS // min(_cdiv(span, cols), ROW_THREADS), 1)
        tile = min(rows, nz * ny, SMEM_BUDGET // row_smem(channels, esize, 1, span, nx))
        return axis_layout((nz, ny, nx), dtype, 2, channels, cols, tile, span)
    n, outer = (ny, nz) if axis == 1 else (nz, ny)
    if outer > 65535:
        raise ValueError(f"axis_plan: no plan for {tuple(zyx)} along axis {axis}")
    cols = 2 if esize == 2 and nx % 2 == 0 and nx * esize % 16 else 1
    tiles = _cdiv(AXIS_CTAS_PER_SM * SMS, _cdiv(nx, STRIP * cols) * outer)
    tile = n if tiles <= 1 else max(_cdiv(n, tiles), min(MIN_TILE, n))
    tile = min(tile, _tile(n, lambda cells: strip_smem(channels, esize, cols, cells)))
    plan = axis_layout((nz, ny, nx), dtype, axis, channels, cols, tile)
    if plan.grid[2] > 65535:
        raise ValueError(f"axis_plan: no plan for {tuple(zyx)} along axis {axis}")
    return plan


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _axis_ids(n: int, axis: int, ndim: int, device) -> torch.Tensor:
    shape = [1] * ndim
    shape[axis] = n
    return torch.arange(n, dtype=torch.float32, device=device).reshape(shape)


def _clamp_disp(u: torch.Tensor, scale: torch.Tensor, axis: int) -> torch.Tensor:
    """clip(-u * scale, +-MAX_DISP), then into [-i, n-1-i] along `axis` of
    the (Z, Y, X) displacement."""
    n = u.shape[axis]
    ids = _axis_ids(n, axis, u.ndim, u.device)
    d = torch.clamp(-u * scale, -MAX_DISP, MAX_DISP)
    return torch.minimum(torch.maximum(d, -ids), (n - 1.0) - ids)


def _lerp_axis(q: torch.Tensor, d: torch.Tensor, axis: int) -> torch.Tensor:
    """2-tap lerp of f32 q (C, Z, Y, X) at i + d along spatial `axis` (0..2
    of d); d is in bounds, so floor(d) is always a valid offset."""
    n = d.shape[axis]
    a0 = torch.floor(d)
    w0 = (1.0 - (d - a0).abs()).clamp_min(0.0)
    w1 = (1.0 - (d - (a0 + 1.0)).abs()).clamp_min(0.0)
    i0 = (_axis_ids(n, axis, d.ndim, d.device) + a0).to(torch.int64)
    i1 = (i0 + 1).clamp_max(n - 1)
    g0 = torch.gather(q, axis + 1, i0.unsqueeze(0).expand_as(q))
    g1 = torch.gather(q, axis + 1, i1.unsqueeze(0).expand_as(q))
    return w0 * g0 + w1 * g1


def advect_axis_plain(vol: torch.Tensor, scale: torch.Tensor, axis: int,
                      disp_ch: int) -> torch.Tensor:
    """Plain version of B11.  `axis` 0..2 of the (Z, Y, X) volume; scale =
    dt * N (f32, on vol's device); returns vol's storage dtype."""
    q = vol.float()
    d = _clamp_disp(q[disp_ch], scale, axis)
    return _lerp_axis(q, d, axis).to(vol.dtype)


def advect_xy_plain(vol: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Plain version of B1: B11's x pass, then its y pass kept in f32.
    scales = [dt * X, dt * Y] (f32, on vol's device); returns f32."""
    tx = advect_axis_plain(vol, scales[0], 2, 0).float()
    dy = _clamp_disp(tx[1], scales[1], axis=1)
    return _lerp_axis(tx, dy, axis=1)


def advect_z_forces_plain(vol: torch.Tensor, scal: torch.Tensor,
                          table: torch.Tensor, consts, forces: bool = True,
                          store: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain version of B2 on the f32 `vol`.  scal = [dt_sub * Z, dt];
    table (C, 5) f32; consts from `force_consts`; returns `store`."""
    q = vol
    dz = _clamp_disp(q[2], scal[0], axis=0)
    out = _lerp_axis(q, dz, axis=0)
    if not forces:
        return out.to(store)
    return forces_epilogue(out, scal, table, consts).to(store)


def forces_epilogue(out: torch.Tensor, scal: torch.Tensor, table: torch.Tensor,
                    consts) -> torch.Tensor:
    """B2's forces epilogue on the f32 z-pass result `out` (C, Z, Y, X),
    in f32: the impulse, buoyancy and vorticity terms, the clip and the
    dissipation, per cell from its (z, y, x) alone."""
    ip_x, ip_y, ip_z, radius_sq, dissipation = consts
    _, nz, ny, nx = out.shape
    dev = out.device
    dt = scal[1]
    atten = (1.0 - dissipation * dt).clamp_min(0.0)
    cz = (_axis_ids(nz, 0, 3, dev) + 0.5) / nz
    cy = (_axis_ids(ny, 1, 3, dev) + 0.5) / ny
    cx = (_axis_ids(nx, 2, 3, dev) + 0.5) / nx
    dx = cx - ip_x
    dy = cy - ip_y
    dzc = cz - ip_z
    d2 = dx * dx + dy * dy + dzc * dzc
    basis = torch.exp(-4.0 * d2 / radius_sq)
    in_imp = (basis >= 0.01831563889245799).float()
    ndz = -dzc
    chans = []
    for c in range(out.shape[0]):
        f = table[c]
        ext = f[0] * basis + f[1] * ndz + f[2] * dx
        v = torch.minimum(torch.maximum(out[c] + in_imp * ext * dt, f[3]), f[4])
        chans.append(v * atten)
    return torch.stack(chans)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def advect_xy(vol: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """B1: x then y split backtrace of every channel of vol (C, Z, Y, X)
    in the storage dtype; the y displacement derives from the x-advected,
    storage-rounded channel 1.  Returns f32.  One launch, laid out by
    `advect_plan`."""
    _check_vol(vol, "advect_xy")
    _check_f32(scales, (2,), vol, "advect_xy scales")
    if vol.shape[0] < 2:
        raise ValueError("advect_xy: needs velocity channels 0 and 1")
    if not _on_cuda(vol, "advect_xy"):
        return advect_xy_plain(vol, scales)
    _build.refuse_grad("advect_xy", vol, scales)
    c, z, y, x = vol.shape
    plan = advect_plan((z, y, x), vol.dtype, c)
    out = torch.empty(vol.shape, dtype=torch.float32, device=vol.device)
    err = _build.lib().fx_advect_xy(
        vol.data_ptr(), out.data_ptr(), scales.data_ptr(), int(vol.dtype == torch.bfloat16),
        c, z, y, x, plan.xy_tile, plan.xy_warps, plan.xy_smem, _build.stream_ptr(vol))
    _build.check(err, "fx_advect_xy")
    advect_xy.launches += 1
    return out


advect_xy.launches = 0


def advect_axis(vol: torch.Tensor, scale: torch.Tensor, axis: int,
                disp_ch: int) -> torch.Tensor:
    """B11: backtrace of every channel of vol (C, Z, Y, X) along `axis`
    (0 z, 1 y, 2 x), the displacement clip(-vol[disp_ch] * scale) from the
    input itself; one rounding to vol's storage dtype.  scale = dt * N, a
    0-d f32 tensor on vol's device.  One launch, laid out by
    `axis_plan`."""
    _check_vol(vol, "advect_axis")
    _check_f32(scale, (), vol, "advect_axis scale")
    if axis not in (0, 1, 2) or not 0 <= disp_ch < vol.shape[0]:
        raise ValueError(f"advect_axis: axis {axis} / displacement channel {disp_ch} "
                         f"out of range for {tuple(vol.shape)}")
    if not _on_cuda(vol, "advect_axis"):
        return advect_axis_plain(vol, scale, axis, disp_ch)
    _build.refuse_grad("advect_axis", vol, scale)
    c, z, y, x = vol.shape
    out = torch.empty_like(vol)
    err = _launch_axis(vol, out, scale, disp_ch, axis_plan((z, y, x), vol.dtype, axis, c))
    advect_axis.launches += 1
    _build.check(err, "fx_advect_axis")
    return out


advect_axis.launches = 0


def _launch_axis(vol, out, scale, disp_ch: int, plan: AxisPlan) -> int:
    """fx_advect_axis with `plan` as given; returns its error code."""
    c, z, y, x = vol.shape
    return _build.lib().fx_advect_axis(
        vol.data_ptr(), out.data_ptr(), scale.data_ptr(), disp_ch, plan.axis,
        int(vol.dtype == torch.bfloat16), c, z, y, x, plan.cols, plan.tile, plan.span,
        *plan.block, plan.smem, _build.stream_ptr(vol))


def advect_z_forces(vol: torch.Tensor, scal: torch.Tensor, table: torch.Tensor,
                    consts, store: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """B2: z backtrace of the f32 vol (C, Z, Y, X) from B1 (dz from
    channel 2), then the impulse/forces/clip/dissipation epilogue; one
    rounding to `store`.  One launch, laid out by `advect_plan`."""
    _check_z(vol, scal, store, "advect_z_forces")
    _check_f32(table, (vol.shape[0], 5), vol, "advect_z_forces table")
    if not _on_cuda(vol, "advect_z_forces"):
        return advect_z_forces_plain(vol, scal, table, consts, True, store)
    _build.refuse_grad("advect_z_forces", vol, scal, table)
    out = _launch_z(vol, scal, table.data_ptr(), consts, True, store)
    advect_z_forces.launches += 1
    return out


advect_z_forces.launches = 0


def advect_z(vol: torch.Tensor, scal: torch.Tensor,
             store: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """B12: the z backtrace alone, replacing `_zpass_kernel` (the TPU's z
    pass when colour is not premultiplied, or between advect sub-steps):
    B2's kernel with its forces epilogue off.  scal = [dt_sub * Z, dt]."""
    _check_z(vol, scal, store, "advect_z")
    if not _on_cuda(vol, "advect_z"):
        return advect_z_forces_plain(vol, scal, None, None, False, store)
    _build.refuse_grad("advect_z", vol, scal)
    out = _launch_z(vol, scal, None, (0.0,) * 5, False, store)
    advect_z.launches += 1
    return out


advect_z.launches = 0


def _check_z(vol: torch.Tensor, scal: torch.Tensor, store: torch.dtype, name: str) -> None:
    _check_vol(vol, name)
    if vol.dtype != torch.float32 or store not in _STORAGE:
        raise ValueError(f"{name}: expected f32 input and a bf16/f32 "
                         f"output dtype, got {vol.dtype} -> {store}")
    _check_f32(scal, (2,), vol, f"{name} scal")
    if vol.shape[0] < 3:
        raise ValueError(f"{name}: needs velocity channel 2")


def _launch_z(vol, scal, table_ptr, consts, forces: bool, store) -> torch.Tensor:
    c, z, y, x = vol.shape
    plan = advect_plan((z, y, x), store, c)
    out = torch.empty(vol.shape, dtype=store, device=vol.device)
    err = _build.lib().fx_advect_z_forces(
        vol.data_ptr(), out.data_ptr(), scal.data_ptr(), table_ptr,
        *consts, int(forces), int(store == torch.bfloat16), c, z, y, x,
        plan.z_tile, plan.z_warps, plan.z_smem, _build.stream_ptr(vol))
    _build.check(err, "fx_advect_z_forces")
    return out


def perthread(kind: str, vol: torch.Tensor, scales: torch.Tensor, table=None, consts=None,
              store: torch.dtype = torch.bfloat16, axis: int = 2,
              disp_ch: int = 0) -> torch.Tensor:
    """The designs B1, B2 and B11 replaced, kept only as yardsticks to time
    them against: `kind` "xy" is B1 as two launches of the per-voxel axis
    kernel through a storage-dtype scratch (`fx_advect_xy_perthread`),
    "z_forces" B2 and "z" B12 as one thread a voxel with its taps gathered
    from device memory (`fx_advect_z_forces_perthread`), "axis" B11 as one
    launch of the per-voxel axis kernel (`fx_advect_axis_perthread`, with
    `axis` and `disp_ch`, `scales` the 0-d scale).  Arguments as
    `advect_xy`, `advect_z_forces`, `advect_z` and `advect_axis` take them.
    No path of the port calls it, and it counts no launch.  Card tensors
    only."""
    if kind not in ("xy", "z_forces", "z", "axis"):
        raise ValueError(f"perthread: unknown kind {kind!r}")
    if kind in ("xy", "axis"):
        _check_vol(vol, "perthread")
        _check_f32(scales, (2,) if kind == "xy" else (), vol, "perthread scales")
    else:
        _check_z(vol, scales, store, "perthread")
    if kind == "axis" and (axis not in (0, 1, 2) or not 0 <= disp_ch < vol.shape[0]):
        raise ValueError(f"perthread: axis {axis} / displacement channel {disp_ch} "
                         f"out of range for {tuple(vol.shape)}")
    if not _on_cuda(vol, "perthread"):
        raise ValueError("perthread: the per-voxel designs run on card tensors only")
    _build.refuse_grad("perthread", vol, scales, table)
    c, z, y, x = vol.shape
    lib = _build.lib()
    if kind == "axis":
        out = torch.empty_like(vol)
        err = lib.fx_advect_axis_perthread(
            vol.data_ptr(), out.data_ptr(), scales.data_ptr(), disp_ch, axis,
            int(vol.dtype == torch.bfloat16), c, z, y, x, _build.stream_ptr(vol))
    elif kind == "xy":
        tmp = torch.empty_like(vol)
        out = torch.empty(vol.shape, dtype=torch.float32, device=vol.device)
        err = lib.fx_advect_xy_perthread(
            vol.data_ptr(), tmp.data_ptr(), out.data_ptr(), scales.data_ptr(),
            int(vol.dtype == torch.bfloat16), c, z, y, x, _build.stream_ptr(vol))
    else:
        forces = kind == "z_forces"
        if forces:
            _check_f32(table, (c, 5), vol, "perthread table")
        out = torch.empty(vol.shape, dtype=store, device=vol.device)
        err = lib.fx_advect_z_forces_perthread(
            vol.data_ptr(), out.data_ptr(), scales.data_ptr(),
            table.data_ptr() if forces else None, *(consts if forces else (0.0,) * 5),
            int(forces), int(store == torch.bfloat16), c, z, y, x, _build.stream_ptr(vol))
    _build.check(err, f"perthread {kind}")
    return out
