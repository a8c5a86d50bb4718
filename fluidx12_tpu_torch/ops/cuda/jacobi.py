"""Jacobi pressure sweeps, kernels B4, B6, B13, B14 and B18, with their
plain PyTorch versions and the JAX package's shape gates.

B4 `jacobi` replaces fluidx12_tpu/ops/pallas/jacobi.py
`_jacobi_fused_kernel` / `_window_sweeps` and, for planes above 128x128,
`_planewise_fused_kernel` (B4's plane-sweep order; via `jacobi_pallas`);
B6 `jacobi_packed` replaces `_jacobi_packed_kernel` (via
`jacobi_packed_pallas`); B13 `jacobi_rr` replaces `_planewise_rr_kernel`
(via `jacobi_pallas_rr`): plane-sweep sweeps with the multigrid's residual
and 2x restriction fused in; B14 `jacobi2d` replaces `_jacobi2d_kernel` (via
`jacobi2d_pallas`); B18, the fused projection, is `jacobi_divrr` (replaces
`_planewise_divrr_kernel`, via `jacobi_pallas_divrr`: B3's divergence, then
B13) and `jacobi_grad` (`_planewise_grad_kernel`, via `jacobi_pallas_grad`:
B4's plane-sweep sweeps, then B8's gradient and damp).  Each is `iters` synchronous sweeps of
q <- (sum of the 6 edge-clamped neighbours - b) / 6 in f32 (B14: the 4 of a
(Y, X) plane, over 4).  Their halo'd VMEM windows, 64-lane packing and
resident plane are TPU layouts with no effect on the result; what differs
between them is the order of the neighbour sum, which each plain version
and the kernel keep:

- B4, whole-window plan (`_window_sweeps`): y+, y-, x+, x-, z+, z-;
- B4, plane-sweep plan (`_planewise_window`): y+, y-, x+, x-, z-, z+;
- B6 (`_jacobi_packed_kernel`): x+, x-, y+, y-, z+, z-, the twin's order;
- B14 (`_jacobi2d_kernel`): y+, y-, x+, x-, where the 2D twin
  (sim/project.jacobi_sweeps) adds x first.

Source and what bounds it: fluidx12_tpu_torch/csrc/jacobi.cu, where the
plane-sweep order (B4's, B13's and B18's sweeps) is one temporally blocked
z-march that makes up to four sweeps a launch and fuses the epilogues, B4's
whole-window order one L2-fed z-sweep a launch (`window_plan`), B6 all
its sweeps in one thread-block cluster's shared memory (`packed_plan`) and
B14 eight sweeps a launch over tiles with a ring of eight cells
(`jacobi2d_plan`).  `sweepwise` keeps the design they replaced, one launch
a sweep, as a yardstick for timing.  The gates are pure-Python copies of
the TPU's planners, kept because they decide which numerics the JAX
package runs on a grid (ROADMAP.md C5).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
(or raises).
"""

from __future__ import annotations

import numpy as np
import torch

from fluidx12_tpu_torch.ops.cuda import _build
from fluidx12_tpu_torch.ops.cuda.stencil import (
    _check_fields,
    divergence_plain,
    grad_damp_plain,
    grad_scale,
)
from fluidx12_tpu_torch.ops.sampling import neighbor_shift

_AX_Z, _AX_Y, _AX_X = 0, 1, 2

# Neighbour orders, as (axis, offset) in summation order; the index is the
# kernel's `order` argument.
ORDER_WINDOW, ORDER_PLANEWISE, ORDER_PACKED, ORDER_2D = 0, 1, 2, 3
_ORDERS = (
    ((_AX_Y, 1), (_AX_Y, -1), (_AX_X, 1), (_AX_X, -1), (_AX_Z, 1), (_AX_Z, -1)),
    ((_AX_Y, 1), (_AX_Y, -1), (_AX_X, 1), (_AX_X, -1), (_AX_Z, -1), (_AX_Z, 1)),
    ((_AX_X, 1), (_AX_X, -1), (_AX_Y, 1), (_AX_Y, -1), (_AX_Z, 1), (_AX_Z, -1)),
    ((_AX_Y, 1), (_AX_Y, -1), (_AX_X, 1), (_AX_X, -1)),
)


# ---------------------------------------------------------------------------
# Gates (copies of fluidx12_tpu/ops/pallas/jacobi.py)
# ---------------------------------------------------------------------------

def _plan(shape, slab: int, inner: int):
    """(slab, ytile) of the whole-window kernel, or None (jacobi.py:880)."""
    nz, ny, nx = shape
    halo = inner
    while slab > 1 and nz % slab:
        slab //= 2
    if nz % slab or nz < slab + 2 * halo:
        return None
    if ny * nx <= 128 * 128:
        return slab, ny
    if halo % 8:
        return None
    ytile = 32
    while ytile > 8 and ny % ytile:
        ytile //= 2
    if ny % ytile or ny < ytile + 2 * halo:
        return None
    if (slab + 2 * halo) * (ytile + 2 * halo) * nx * 4 > 2 * 1024 * 1024:
        slab = max(slab // 2, 1)
        if nz % slab or nz < slab + 2 * halo:
            return None
    return slab, ytile


_CHUNK = 8


def _plan_planewise(shape, inner: int, extra_window: float = 0.0,
                    extra_center: float = 0.0):
    """(slab, ytile, halo) of the plane-sweep kernel, or None
    (jacobi.py:912)."""
    nz, ny, nx = shape
    halo = -(-max(inner, 8) // 8) * 8
    budget = 15 * 1024 * 1024
    best = None
    for slab in (64, 32, 16, 8):
        size_z = slab + 2 * halo
        if nz % slab or nz < size_z or size_z % _CHUNK:
            continue
        for ytile in (256, 128, 64, 32, 16, 8):
            if ny % ytile or (ytile != ny and ny < ytile + 2 * halo):
                continue
            size_y = min(ytile + 2 * halo, ny)
            size = int((size_z * (3 + extra_window) + slab * extra_center
                        + _CHUNK * 8) * size_y * nx * 4)
            if size > budget:
                continue
            y_red = 1.0 if ytile == ny else 1 + 2 * halo / ytile
            key = (round((1 + 2 * halo / slab) * y_red, 4), -ytile)
            if best is None or key < best[0]:
                best = (key, slab, ytile, halo)
    if best is None:
        return None
    return best[1], best[2], best[3]


def jacobi_tuning(shape, iters: int):
    """(slab, inner) the TPU runs B4 with on this volume, or None, where
    it runs the twin sweeps (jacobi.py:952)."""
    nz, ny, nx = shape
    if nx % 128:
        return None
    if ny * nx <= 128 * 128:
        for slab, inner in ((32, 4), (16, 8)):
            if iters % inner == 0 and _plan(shape, slab, inner) is not None:
                return slab, inner
    for inner in (8, 4):
        if iters % inner == 0 and _plan_planewise(shape, inner) is not None:
            return _plan_planewise(shape, inner)[0], inner
    for slab, inner in ((32, 4), (16, 8)):
        if iters % inner == 0 and _plan(shape, slab, inner) is not None:
            return slab, inner
    return None


def jacobi_packed_supported(shape) -> bool:
    """True where the TPU runs B6: (Z, Y, 64) volumes that pack into
    128 lanes and fit VMEM (jacobi.py:847)."""
    nz, ny, nx = shape
    return (nx == 64 and ny % 16 == 0 and nz >= 2
            and nz * ny * nx * 4 * 12 <= 12 * 1024 * 1024)


def jacobi_rr_supported(shape, iters: int) -> bool:
    """True where the TPU's multigrid fuses residual + restrict into the
    pre-smoother, kernel B13 (jacobi.py:497)."""
    nz, ny, nx = shape
    if nx % 128 or nz % 2 or ny % 2 or nx % 2:
        return False
    if ny * nx <= 128 * 128:
        return False
    pw = _plan_planewise(shape, iters)
    if pw is None:
        return False
    _, ytile, halo = pw
    return ytile >= 16 and ytile >= halo and halo > iters


def _fuse_extra(vel_bytes: int) -> float:
    return 3.0 * vel_bytes / 4.0


def jacobi_divrr_supported(shape, iters: int, vel_bytes: int = 2) -> bool:
    """Gate of the fused divergence pre-smoother, kernel B18
    (jacobi.py:601)."""
    nz, ny, nx = shape
    if nx % 128 or nz % 2 or ny % 2 or nx % 2:
        return False
    if ny * nx <= 128 * 128:
        return False
    pw = _plan_planewise(shape, iters, extra_window=_fuse_extra(vel_bytes))
    if pw is None:
        return False
    _, ytile, halo = pw
    return ytile >= 16 and ytile >= halo and halo > iters


def jacobi_grad_supported(shape, iters: int, vel_bytes: int = 2) -> bool:
    """Gate of the fused grad+damp post-smoother, kernel B18
    (jacobi.py:621)."""
    nz, ny, nx = shape
    if nx % 128 or nz % 2 or ny % 2 or nx % 2:
        return False
    if ny * nx <= 128 * 128:
        return False
    pw = _plan_planewise(shape, iters, extra_center=_fuse_extra(vel_bytes))
    if pw is None:
        return False
    _, ytile, halo = pw
    return ytile >= 8 and ytile >= halo and halo > iters


def jacobi2d_pallas_supported(shape) -> bool:
    """True where the TPU runs the 2D sweeps as kernel B14
    (jacobi.py:781)."""
    ny, nx = shape
    return (nx % 128 == 0 and ny % 8 == 0
            and ny * nx * 4 * 8 <= 12 * 1024 * 1024)


# ---------------------------------------------------------------------------
# Launch plans of the L2-resident sweeps (what csrc/jacobi.cu receives)
# ---------------------------------------------------------------------------

# An H100's SM count.
H100_SMS = 132

# B4's whole-window order, zsweep_kernel: a (16, 32) (y, x) tile a CTA (the
# kernel is compiled for it: kSY, kSX) and a chunk of at most 16 planes,
# staged whole in shared memory: q with the tile's halo ring on the chunk
# and a plane either side, b on the chunk.
WINDOW_TILE = (16, 32)
WINDOW_MAX_CHUNK = 16


def window_smem(zchunk: int) -> int:
    """Bytes of shared memory a zsweep CTA stages for a chunk of `zchunk`
    planes (csrc/jacobi.cu zsweep_smem)."""
    ty, tx = WINDOW_TILE
    return ((zchunk + 2) * (ty + 2) * (tx + 2) + zchunk * ty * tx) * 4


def window_plan(shape):
    """(tile, zchunk, smem) of B4's whole-window order, one sweep a launch,
    on a (Z, Y, X) volume of any dims: the (y, x) tile and the planes a CTA
    owns, and the shared memory it stages; `fx_jacobi_window` launches
    with them.  CTA (k, j, i) owns planes
    [k * zchunk, (k + 1) * zchunk), rows [j * 16, (j + 1) * 16) and columns
    [i * 32, (i + 1) * 32), clipped to the volume.  The chunk is the longest
    of 16, 8 and 4 planes whose full tiles the volume still fills for 0.9
    CTAs an SM: a sweep of an L2-resident volume is bound by the L2's rate
    where the card is full (a longer chunk re-reads fewer halo planes: 16
    planes at 128^3) and by the latency of a CTA's loads where it is not (8
    planes at (30, 128, 128), 4 at (75, 75, 75))."""
    nz, ny, nx = shape
    ty, tx = WINDOW_TILE
    zchunk = WINDOW_MAX_CHUNK
    while zchunk > 4 and nz * ny * nx < 0.9 * H100_SMS * ty * tx * zchunk:
        zchunk //= 2
    return WINDOW_TILE, zchunk, window_smem(zchunk)


# B6, packed_kernel: rows of 64 floats, at most 16 CTAs a cluster (16 is
# non-portable), at most 256 rows and 1024 threads a CTA.
PACKED_ROW = 64
PACKED_MAX_CLUSTER = 16
PACKED_MAX_ROWS = 256


def packed_plan(shape):
    """(cluster, rows_per_cta, threads, smem) of B6 on a (Z, Y, 64) volume:
    its Z * Y rows of 64 floats split into contiguous ranges of
    rows_per_cta rows (a power of two, at least 16), one a CTA, at most 16
    CTAs; each CTA keeps its rows of q twice (ping-pong) in shared memory,
    `smem` bytes, and runs one thread per float4 of a range, at most 1024,
    each holding its float4s of q and b in registers; `fx_jacobi_packed`
    launches with them.  CTA r owns rows
    [r * rows_per_cta, (r + 1) * rows_per_cta) clipped to the volume; every
    CTA owns at least one.
    Raises ValueError where no plan fits: X other than 64, or more than
    4096 rows (B6's gate, `jacobi_packed_supported`, admits up to 4096)."""
    nz, ny, nx = shape
    rows = nz * ny
    if nx != PACKED_ROW or rows < 1 or rows > PACKED_MAX_CLUSTER * PACKED_MAX_ROWS:
        raise ValueError(f"jacobi_packed: no cluster plan for a {tuple(shape)} volume "
                         f"(X must be {PACKED_ROW}, Z * Y at most "
                         f"{PACKED_MAX_CLUSTER * PACKED_MAX_ROWS})")
    rpc = 16
    while rpc * PACKED_MAX_CLUSTER < rows:
        rpc *= 2
    cluster = -(-rows // rpc)
    threads = min(1024, rpc * PACKED_ROW // 4)
    return cluster, rpc, threads, 2 * rpc * PACKED_ROW * 4


# B14, jacobi2d_kernel: a thread holds a 4 x 4 block of cells (kJ2Block),
# a CTA the blocks of its tile and ring, at most 512 (kJ2MaxThreads).
J2D_BLOCK = 4
J2D_MAX_THREADS = 512
J2D_TILE = (32, 64)
J2D_RING = 8


def jacobi2d_threads(tile, ring: int) -> int:
    """Threads of a jacobi2d_kernel CTA: one a 4 x 4 block of its tile and
    ring (csrc/jacobi.cu jacobi2d_threads)."""
    ty, tx = tile
    return ((ty + 2 * ring) // J2D_BLOCK) * ((tx + 2 * ring) // J2D_BLOCK)


def jacobi2d_plan(shape, iters: int):
    """(tile, ring, smem) of B14 on a (Y, X) plane: each CTA owns a (ty, tx)
    tile, tile (j, i) rows [j * ty, (j + 1) * ty) and columns [i * tx,
    (i + 1) * tx) clipped to the plane, and runs up to `ring` sweeps a
    launch over it and a ring of `ring` cells around it, `smem` bytes of
    shared memory for its blocks' edges; `fx_jacobi2d` launches ceil(iters
    / ring) times with them.  The tile is 32 x 64 (32 rows where the plane
    has fewer); the ring 8 cells, or `iters` rounded up to whole 4-cell
    blocks where that is less.  Raises ValueError on a plane that is not
    in whole 4 x 4 blocks (B14's gate, `jacobi2d_pallas_supported`, admits
    only planes of 8-row, 128-column multiples)."""
    ny, nx = shape
    if ny < 1 or nx < 1 or ny % J2D_BLOCK or nx % J2D_BLOCK:
        raise ValueError(f"jacobi2d: no plan for a {tuple(shape)} plane (Y and X must be "
                         f"multiples of {J2D_BLOCK})")
    ty, tx = J2D_TILE
    tile = (min(ty, ny), tx)
    ring = J2D_RING if iters < 1 else min(J2D_RING, -(-iters // J2D_BLOCK) * J2D_BLOCK)
    return tile, ring, 2 * 4 * jacobi2d_threads(tile, ring) * 16


def window_order(shape, inner: int) -> int:
    """The neighbour order of B4 on this volume: `jacobi_pallas` takes the
    plane-sweep kernel for planes above 128x128 where its plan fits, else
    the whole-window kernel, which needs a plan (jacobi.py:1009-1022)."""
    nz, ny, nx = shape
    if ny * nx > 128 * 128 and _plan_planewise(shape, inner) is not None:
        return ORDER_PLANEWISE
    return ORDER_WINDOW


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def sweeps_plain(q: torch.Tensor, b: torch.Tensor, iters: int, order: int) -> torch.Tensor:
    """`iters` sweeps of (sum of the neighbours in `order` - b) / their
    count (6, or 4 in 2D); the division is a true f32 division on q's
    device, as in the kernel."""
    (ax0, off0), *rest = _ORDERS[order]
    count = torch.tensor(float(len(rest) + 1), dtype=torch.float32, device=q.device)
    for _ in range(iters):
        s = neighbor_shift(q, ax0, off0)
        for ax, off in rest:
            s = s + neighbor_shift(q, ax, off)
        q = (s - b) / count
    return q


def jacobi_plain(q: torch.Tensor, b: torch.Tensor, iters: int, slab: int = 16,
                 inner: int = 8, storage=None) -> torch.Tensor:
    """Plain version of B4.  Of the TPU's tuning only `inner` matters: with
    the dims the TPU tiles (`storage`, default q's) it picks the kernel,
    and so the neighbour order."""
    del slab
    return sweeps_plain(q, b, iters, window_order(storage or q.shape, inner))


def jacobi_packed_plain(q: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain version of B6."""
    return sweeps_plain(q, b, iters, ORDER_PACKED)


def jacobi2d_plain(q: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain version of B14 on a (Y, X) plane."""
    return sweeps_plain(q[None], b[None], iters, ORDER_2D)[0]


def rr_weight(scale: float) -> float:
    """The f32 weight of B13's x pooling, 0.5 * scale (jacobi.py:540)."""
    return float(np.float32(0.5 * scale))


def jacobi_rr_plain(q: torch.Tensor, b: torch.Tensor, iters: int,
                    scale: float = 1.0):
    """Plain version of B13: (q', r_c) with q' the plane-sweep sweeps and
    r_c = restrict(b - A q') * scale, the residual summed y+, y-, x+, x-,
    z-, z+ and pooled as the TPU epilogue pools it: the z pair, then x with
    weights 0.5 * scale and a factor 0.5, then the y pair at 0.5
    (jacobi.py:321-351)."""
    q = sweeps_plain(q, b, iters, ORDER_PLANEWISE)
    (ax0, off0), *rest = _ORDERS[ORDER_PLANEWISE]
    s = neighbor_shift(q, ax0, off0)
    for ax, off in rest:
        s = s + neighbor_shift(q, ax, off)
    r = b - (s - 6.0 * q)
    r = r[0::2] + r[1::2]
    w = rr_weight(scale)
    xz = (r[..., 0::2] * w + r[..., 1::2] * w) * 0.5
    return q, 0.5 * xz[:, 0::2] + 0.5 * xz[:, 1::2]


def jacobi_divrr_plain(fields: torch.Tensor, q: torch.Tensor, iters: int,
                       scale: float = 1.0):
    """Plain version of B18's head: b = B3's divergence of channels 0..2
    (the Pallas prologue's `0.5 * (dx + dy + (zp - zm))`, jacobi.py:249, is
    B3's order), then B13 on (q, b).  Returns (q', b, r_c)."""
    b = divergence_plain(fields)
    q, r_c = jacobi_rr_plain(q, b, iters, scale)
    return q, b, r_c


def jacobi_grad_plain(q: torch.Tensor, b: torch.Tensor, fields: torch.Tensor,
                      iters: int, rho: float):
    """Plain version of B18's tail: B4's plane-sweep sweeps, then B8 on
    the final q, in place on channels 0..2 of `fields` (the Pallas
    epilogue's arithmetic is B8's, jacobi.py:364-431).  Returns (q',
    fields)."""
    q = sweeps_plain(q, b, iters, ORDER_PLANEWISE)
    return q, grad_damp_plain(fields, q, rho)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(q: torch.Tensor, b: torch.Tensor, iters: int, name: str, ndim: int = 3) -> bool:
    """Checks the arguments; True when they lie on the card."""
    dims = "(Z, Y, X)" if ndim == 3 else "(Y, X)"
    for t, what in ((q, "q"), (b, "b")):
        if (t.ndim != ndim or t.dtype != torch.float32 or not t.is_contiguous()
                or t.shape != q.shape or t.device != q.device):
            raise ValueError(f"{name}: expected contiguous f32 {dims} q and b of one "
                             f"shape and device, got {what} {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    if iters < 0:
        raise ValueError(f"{name}: iters must be >= 0, got {iters}")
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    return True


def _check_even(q: torch.Tensor, name: str) -> None:
    if any(n % 2 for n in q.shape):
        raise ValueError(f"{name}: dims must be even, got {tuple(q.shape)}")


def _check_velocity(fields: torch.Tensor, q: torch.Tensor, name: str) -> None:
    _check_fields(fields, name)
    if tuple(fields.shape[1:]) != tuple(q.shape) or fields.device != q.device:
        raise ValueError(f"{name}: fields {tuple(fields.shape)} on {fields.device} do not "
                         f"match the pressure {tuple(q.shape)} on {q.device}")


def _launch(q: torch.Tensor, b: torch.Tensor, iters: int, order: int) -> torch.Tensor:
    """`iters` sweeps of card tensors in `order`: order 0 by its
    `window_plan`, order 2 by its `packed_plan`, order 3 (one (1, Y, X)
    plane) by its `jacobi2d_plan`, order 1 as `fx_jacobi` does."""
    z, y, x = q.shape
    out = torch.empty_like(q)
    stream = _build.stream_ptr(q)
    if order == ORDER_2D:
        (ty, tx), ring, smem = jacobi2d_plan((y, x), iters)
        scratch = torch.empty_like(q) if iters > ring else out
        err = _build.lib().fx_jacobi2d(q.data_ptr(), b.data_ptr(), out.data_ptr(),
                                       scratch.data_ptr(), iters, ty, tx, ring, smem, y, x,
                                       stream)
        _build.check(err, "fx_jacobi2d")
        return out
    if order == ORDER_PACKED:
        plan = packed_plan(q.shape)
        err = _build.lib().fx_jacobi_packed(q.data_ptr(), b.data_ptr(), out.data_ptr(), iters,
                                            *plan, z, y, x, stream)
        _build.check(err, "fx_jacobi_packed")
        return out
    scratch = torch.empty_like(q) if iters > 1 else out
    if order == ORDER_WINDOW:
        (ty, tx), zchunk, smem = window_plan(q.shape)
        err = _build.lib().fx_jacobi_window(q.data_ptr(), b.data_ptr(), out.data_ptr(),
                                            scratch.data_ptr(), iters, ty, tx, zchunk, smem,
                                            z, y, x, stream)
        _build.check(err, "fx_jacobi_window")
        return out
    err = _build.lib().fx_jacobi(q.data_ptr(), b.data_ptr(), out.data_ptr(),
                                 scratch.data_ptr(), iters, order, z, y, x, stream)
    _build.check(err, "fx_jacobi")
    return out


def jacobi(q: torch.Tensor, b: torch.Tensor, iters: int, slab: int = 16,
           inner: int = 8, storage=None) -> torch.Tensor:
    """B4: `iters` Jacobi sweeps of the (Z, Y, X) f32 pressure q against b,
    with `jacobi_pallas`'s arguments: `(slab, inner)` is the TPU's tuning
    (`jacobi_tuning`), which fixes the neighbour order; iters must be a
    multiple of inner, and the dims the TPU tiles must have a TPU plan.
    Those are q's own dims, or `storage` where the TPU runs q's grid on
    padded storage (core/padding.py): q is then the compact logical
    volume, of any dims."""
    on_card = _check(q, b, iters, "jacobi")
    if iters % inner:
        raise ValueError("jacobi: iters must be a multiple of inner")
    plan_zyx = tuple(storage or q.shape)
    order = window_order(plan_zyx, inner)
    if order == ORDER_WINDOW and _plan(plan_zyx, slab, inner) is None:
        raise ValueError(f"jacobi: unsupported volume shape {plan_zyx}")
    if not on_card:
        return jacobi_plain(q, b, iters, slab, inner, plan_zyx)
    _build.refuse_grad("jacobi", q, b)
    out = _launch(q, b, iters, order)
    jacobi.launches += 1
    jacobi.planewise_launches += order == ORDER_PLANEWISE
    return out


# Launches of either order, and of the plane-sweep order alone.
jacobi.launches = 0
jacobi.planewise_launches = 0


def jacobi_packed(q: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """B6: `iters` Jacobi sweeps of a (Z, Y, X) f32 volume in the twin's
    neighbour order (the TPU runs it on the multigrid's 64-wide coarse
    level, `jacobi_packed_supported`).  On the card all of them run in one
    cluster launch, which needs a `packed_plan`: X = 64 and Z * Y <= 4096."""
    if not _check(q, b, iters, "jacobi_packed"):
        return jacobi_packed_plain(q, b, iters)
    _build.refuse_grad("jacobi_packed", q, b)
    out = _launch(q, b, iters, ORDER_PACKED)
    jacobi_packed.launches += 1
    return out


jacobi_packed.launches = 0


def jacobi_rr(q: torch.Tensor, b: torch.Tensor, iters: int, scale: float = 1.0):
    """B13: `iters` Jacobi sweeps of the (Z, Y, X) f32 pressure q against b
    in the plane-sweep order, with the multigrid's next two passes fused
    in: returns (q', r_c), r_c = restrict(b - A q') * scale at half
    resolution, f32 (`jacobi_pallas_rr`; the TPU runs it where
    `jacobi_rr_supported` holds).  Every dim must be even."""
    on_card = _check(q, b, iters, "jacobi_rr")
    _check_even(q, "jacobi_rr")
    if not on_card:
        return jacobi_rr_plain(q, b, iters, scale)
    _build.refuse_grad("jacobi_rr", q, b)
    z, y, x = q.shape
    out = torch.empty_like(q)
    scratch = torch.empty_like(q) if iters > 1 else out
    r_c = torch.empty((z // 2, y // 2, x // 2), dtype=torch.float32, device=q.device)
    err = _build.lib().fx_jacobi_rr(q.data_ptr(), b.data_ptr(), out.data_ptr(),
                                    scratch.data_ptr(), r_c.data_ptr(), iters,
                                    rr_weight(scale), z, y, x, _build.stream_ptr(q))
    _build.check(err, "fx_jacobi_rr")
    jacobi_rr.launches += 1
    return out, r_c


jacobi_rr.launches = 0


def jacobi_divrr(fields: torch.Tensor, q: torch.Tensor, iters: int, scale: float = 1.0):
    """B18's head: b = the divergence of channels 0..2 of the combined
    (C, Z, Y, X) bf16/f32 state, read in place, then B13: `iters` sweeps of
    the f32 pressure q against b in the plane-sweep order and r_c =
    restrict(b - A q') * scale.  Returns (q', b, r_c), f32 (the TPU runs it
    where `jacobi_divrr_supported` holds).  Every dim must be even."""
    on_card = _check(q, q, iters, "jacobi_divrr")
    _check_velocity(fields, q, "jacobi_divrr")
    _check_even(q, "jacobi_divrr")
    if not on_card:
        return jacobi_divrr_plain(fields, q, iters, scale)
    _build.refuse_grad("jacobi_divrr", fields, q)
    z, y, x = q.shape
    out = torch.empty_like(q)
    scratch = torch.empty_like(q) if iters > 1 else out
    b = torch.empty_like(q)
    r_c = torch.empty((z // 2, y // 2, x // 2), dtype=torch.float32, device=q.device)
    err = _build.lib().fx_jacobi_divrr(
        fields.data_ptr(), int(fields.dtype == torch.bfloat16), q.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), b.data_ptr(), r_c.data_ptr(), iters, rr_weight(scale), z, y, x,
        _build.stream_ptr(q))
    _build.check(err, "fx_jacobi_divrr")
    jacobi_divrr.launches += 1
    return out, b, r_c


jacobi_divrr.launches = 0


def jacobi_grad(q: torch.Tensor, b: torch.Tensor, fields: torch.Tensor, iters: int,
                rho: float):
    """B18's tail: `iters` sweeps of the f32 pressure q against b in the
    plane-sweep order, then velocity -= 0.5 * grad(q') / rho with the 3%
    wall-band damp IN PLACE on channels 0..2 of the combined (C, Z, Y, X)
    state, as the TPU kernel aliases it; channels 3.. are not touched.
    Returns (q', fields)."""
    on_card = _check(q, b, iters, "jacobi_grad")
    _check_velocity(fields, q, "jacobi_grad")
    if not on_card:
        return jacobi_grad_plain(q, b, fields, iters, rho)
    _build.refuse_grad("jacobi_grad", q, b, fields)
    z, y, x = q.shape
    out = torch.empty_like(q)
    scratch = torch.empty_like(q) if iters > 1 else out
    err = _build.lib().fx_jacobi_grad(
        q.data_ptr(), b.data_ptr(), out.data_ptr(), scratch.data_ptr(), fields.data_ptr(),
        int(fields.dtype == torch.bfloat16), grad_scale(rho), iters, z, y, x,
        _build.stream_ptr(q))
    _build.check(err, "fx_jacobi_grad")
    jacobi_grad.launches += 1
    return out, fields


jacobi_grad.launches = 0


_SWEEPWISE_MODES = {"rr": 1, "divrr": 2, "grad": 3}
_SWEEPWISE_ORDERS = {ORDER_PLANEWISE: 0, ORDER_WINDOW: 4, ORDER_PACKED: 5, ORDER_2D: 6}


def sweepwise(kind: str, q: torch.Tensor, b: torch.Tensor | None, iters: int,
              fields: torch.Tensor | None = None, scale: float = 1.0, rho: float = 1.0,
              order: int = ORDER_PLANEWISE):
    """The Jacobi kernels as one launch per sweep, with the epilogues as
    passes of their own (`fx_jacobi_sweepwise`): the design the blocked
    march, B4's whole-window zsweep, B6's cluster kernel and B14's tiles
    replaced, kept only as a yardstick to time them against.  No path of
    the port calls it, and it counts no launch.  `kind` "sweeps" returns q'
    (`jacobi` in the plane-sweep order, or in `order` ORDER_WINDOW,
    ORDER_PACKED or ORDER_2D, the last on a (1, Y, X) q),
    "rr" (q', r_c) (`jacobi_rr`), "divrr" (q', b, r_c) from `fields` and q
    (`jacobi_divrr`), "grad" (q', fields) with `fields` updated in place
    (`jacobi_grad`).  Card tensors only."""
    mode = _SWEEPWISE_ORDERS[order] if kind == "sweeps" else _SWEEPWISE_MODES[kind]
    if not _check(q, q if b is None else b, iters, "sweepwise"):
        raise ValueError("sweepwise: the per-sweep design runs on card tensors only")
    _build.refuse_grad("sweepwise", q, b, fields)
    if fields is not None:
        _check_velocity(fields, q, "sweepwise")
    if kind in ("rr", "divrr"):
        _check_even(q, "sweepwise")
    z, y, x = q.shape
    out = torch.empty_like(q)
    scratch = torch.empty_like(q)
    if b is None:
        b = torch.empty_like(q)
    r_c = torch.empty((z // 2, y // 2, x // 2), dtype=torch.float32, device=q.device)
    f = q if fields is None else fields
    err = _build.lib().fx_jacobi_sweepwise(
        mode, f.data_ptr(), int(f.dtype == torch.bfloat16), q.data_ptr(), b.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), r_c.data_ptr(), rr_weight(scale), grad_scale(rho),
        iters, z, y, x, _build.stream_ptr(q))
    _build.check(err, "fx_jacobi_sweepwise")
    return {"sweeps": out, "rr": (out, r_c), "divrr": (out, b, r_c),
            "grad": (out, fields)}[kind]


def div6_mismatches(device) -> int:
    """How many of the 2^32 f32 bit patterns x give another result than
    x / 6.0f on the card in the branch-free division, in the march's form
    or in the z-sweep's and cluster kernel's, the two counted together
    (NaN results count as equal)."""
    count = torch.zeros(1, dtype=torch.int64, device=device)
    _build.check(_build.lib().fx_div6_mismatches(count.data_ptr(), _build.stream_ptr(count)),
                 "fx_div6_mismatches")
    return int(count.item())


def jacobi2d(q: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """B14: `iters` 2D Jacobi sweeps of the (Y, X) f32 pressure q against b,
    q <- (q[y+1] + q[y-1] + q[x+1] + q[x-1] - b) / 4 with clamped edges (the
    TPU runs it where `jacobi2d_pallas_supported` holds).  On the card they
    run as ceil(iters / ring) launches of `jacobi2d_plan`'s tiles, which
    needs Y and X in multiples of 4 and 16-byte aligned rows."""
    if not _check(q, b, iters, "jacobi2d", ndim=2):
        return jacobi2d_plain(q, b, iters)
    _build.refuse_grad("jacobi2d", q, b)
    out = _launch(q[None], b[None], iters, ORDER_2D)[0]
    jacobi2d.launches += 1
    return out


jacobi2d.launches = 0
