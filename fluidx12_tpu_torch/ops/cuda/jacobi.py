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

Source and what bounds it: fluidx12_tpu_torch/csrc/jacobi.cu.  The gates
are pure-Python copies of the TPU's planners, kept because they decide
which numerics the JAX package runs on a grid (ROADMAP.md C5).

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
                 inner: int = 8) -> torch.Tensor:
    """Plain version of B4.  Of the TPU's tuning only `inner` matters: it
    picks the kernel, and so the neighbour order."""
    del slab
    return sweeps_plain(q, b, iters, window_order(q.shape, inner))


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
    z, y, x = q.shape
    out = torch.empty_like(q)
    scratch = torch.empty_like(q) if iters > 1 else out
    err = _build.lib().fx_jacobi(q.data_ptr(), b.data_ptr(), out.data_ptr(),
                                 scratch.data_ptr(), iters, order, z, y, x,
                                 _build.stream_ptr(q))
    _build.check(err, "fx_jacobi")
    return out


def jacobi(q: torch.Tensor, b: torch.Tensor, iters: int, slab: int = 16,
           inner: int = 8) -> torch.Tensor:
    """B4: `iters` Jacobi sweeps of the (Z, Y, X) f32 pressure q against b,
    with `jacobi_pallas`'s arguments: `(slab, inner)` is the TPU's tuning
    (`jacobi_tuning`), which fixes the neighbour order; iters must be a
    multiple of inner, and the volume must have a TPU plan."""
    on_card = _check(q, b, iters, "jacobi")
    if iters % inner:
        raise ValueError("jacobi: iters must be a multiple of inner")
    order = window_order(q.shape, inner)
    if order == ORDER_WINDOW and _plan(q.shape, slab, inner) is None:
        raise ValueError(f"jacobi: unsupported volume shape {tuple(q.shape)}")
    if not on_card:
        return jacobi_plain(q, b, iters, slab, inner)
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
    level, `jacobi_packed_supported`)."""
    if not _check(q, b, iters, "jacobi_packed"):
        return jacobi_packed_plain(q, b, iters)
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


def jacobi2d(q: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """B14: `iters` 2D Jacobi sweeps of the (Y, X) f32 pressure q against b,
    q <- (q[y+1] + q[y-1] + q[x+1] + q[x-1] - b) / 4 with clamped edges (the
    TPU runs it where `jacobi2d_pallas_supported` holds)."""
    if not _check(q, b, iters, "jacobi2d", ndim=2):
        return jacobi2d_plain(q, b, iters)
    out = _launch(q[None], b[None], iters, ORDER_2D)[0]
    jacobi2d.launches += 1
    return out


jacobi2d.launches = 0
