"""The streaming stencils, kernels B3, B5, B7, B8 (the projection's), B15
(the GI gradient) and B16 (the GI light map), with their plain PyTorch
versions and the JAX package's shape gates.

B3 `divergence` replaces fluidx12_tpu/ops/pallas/stencil.py `_div_kernel`
(via `divergence_pallas`), B5 `residual` `_residual_kernel` (via
`residual_pallas`), B7 `prolong_correct` `_prolong_correct_kernel` (via
`prolong_correct_pallas`), B8 `grad_damp` `_grad_damp_kernel` (via
`grad_damp_pallas`), B15 `gradient3` `_gradient_kernel` (via
`gradient3_pallas`) and B16 `gi_light` `_gi_light_kernel` (via
`gi_light_pallas`).  They follow the kernels, not the XLA twins of
sim/project.py and render/lightmap_sweep.py: the velocity is cast to f32
before any arithmetic, the gradient, the wall positions and the 3% band
are f32 with one rounding to the storage dtype, and each sum runs in the
kernel's order.  Sources and what bounds them:
fluidx12_tpu_torch/csrc/stencil.cu.  B3, B5, B7, B8 and B15 are z-marches
laid out by `stencil_plan`; `perthread` keeps the one-thread-a-cell designs
they replaced as yardsticks.

The gates are pure-Python copies of the TPU's VMEM planners.  They decide
nothing about the CUDA kernels' feasibility; they are kept because they
decide which numerics the JAX package runs on a grid (ROADMAP.md C5).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
(or raises).  Divisions in the plain versions divide by a tensor on the
operand's device, so on the card they are true divisions as in the
kernels (PyTorch multiplies by the reciprocal of a host scalar there).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from fluidx12_tpu_torch.ops.cuda import _build
from fluidx12_tpu_torch.ops.sampling import neighbor_shift

_STORAGE = (torch.bfloat16, torch.float32)
_AX_Z, _AX_Y, _AX_X = 0, 1, 2


# ---------------------------------------------------------------------------
# Gates (copies of fluidx12_tpu/ops/pallas/stencil.py :337-385)
# ---------------------------------------------------------------------------

def _bz_fits(bz: int, plane_elems: int, budget_bytes: int) -> bool:
    return bz * plane_elems * budget_bytes * 2 <= 12 * 1024 * 1024


def _odd_core(nz: int) -> int:
    while nz % 2 == 0:
        nz //= 2
    return nz


def stencil_pallas_supported(zyx, budget_bytes: int = 24) -> bool:
    """True where the TPU runs B3, B5 and B8: a 128-multiple lane dim, an
    even Z split, and the odd core of nz within the VMEM model."""
    nz, ny, nx = zyx
    if not (nx % 128 == 0 and ny % 8 == 0 and nz % 2 == 0 and nz >= 4):
        return False
    return _bz_fits(_odd_core(nz), ny * nx, budget_bytes)


def prolong_pallas_supported(zyx) -> bool:
    """True where the TPU runs B7: the stencil gate at 16 B per element
    and an even z-block of 2 * odd_core(nz) within it."""
    nz, ny, nx = zyx
    if not stencil_pallas_supported(zyx, budget_bytes=16):
        return False
    return _bz_fits(2 * _odd_core(nz), ny * nx, 16)


# ---------------------------------------------------------------------------
# The z-marches' launch plan (B3, B5, B7, B8, B15)
# ---------------------------------------------------------------------------

# divergence_march_kernel, residual_march_kernel, prolong_march_kernel,
# grad_damp_march_kernel and gradient_march_kernel, compiled for these: QUAD consecutive x a thread,
# CTA_THREADS threads a CTA; B8's and B5's ring of RING planes, each the
# CTA's rows and columns with a halo of HALO cells, a row PAD floats either
# side of its columns; B3's uy ring of RING planes, each the CTA's rows with
# a halo of HALO rows.
QUAD = 4
CTA_THREADS = 256
RING = 3
HALO = 1
PAD = 4
# The plan's choices: x-quads a CTA row, the one of QUAD_CHOICES that
# leaves the fewest idle lanes at the ragged x edge (the widest of equals),
# and the chunk of planes that comes nearest to CTAS_PER_SM CTAs on each of
# an H100's SMS SMs (the kernels take up to 64 registers a thread: four of
# their CTAs fill an SM's registers).
QUAD_CHOICES = (32, 16, 8)
SMS = 132
CTAS_PER_SM = 4


class StencilPlan(NamedTuple):
    """How B3, B5, B7, B8 or B15 cuts a volume (`stencil_plan`)."""
    quads: int   # x-quads a CTA row: QUAD * quads columns
    rows: int    # rows a CTA owns, CTA_THREADS // quads
    chunk: int   # planes a CTA walks: coarse planes (B7), planes (the others)
    grid: tuple  # (x tiles, row tiles, chunks), as the C launches form it


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _planes(kind: str, nz: int) -> int:
    return nz // 2 if kind == "prolong" else nz


def stencil_layout(kind: str, zyx: tuple, quads: int, chunk: int) -> StencilPlan:
    """The plan of `kind` on the fine (Z, Y, X) volume with `quads` x-quads
    a CTA row and `chunk` planes a CTA, its rows and grid derived from
    them: `stencil_plan`'s own, or one forced to other quads or chunks.
    The quads and chunk are not checked here; the C launches refuse those
    their kernels do not take."""
    nz, ny, nx = (int(v) for v in zyx)
    rows = CTA_THREADS // quads
    grid = (_cdiv(_cdiv(nx, QUAD), quads), _cdiv(ny, rows), _cdiv(_planes(kind, nz), chunk))
    return StencilPlan(quads, rows, chunk, grid)


@functools.lru_cache(maxsize=None)
def stencil_plan(kind: str, zyx: tuple) -> StencilPlan:
    """The launch plan of B3 ("divergence"), B5 ("residual"), B7
    ("prolong"), B8 ("grad_damp") or B15 ("gradient3") on the fine (Z, Y,
    X) volume.  CTA (i,
    j, k) is `quads` x `rows` threads; thread (t, r) owns x [QUAD (i quads
    + t), + QUAD) of row j rows + r, clipped to the volume, and walks
    planes [k chunk, (k + 1) chunk) clipped to their count: B7's coarse
    planes (Z / 2; each gives fine planes 2m, 2m + 1), the others' planes.
    B8's and B5's CTA stages each plane of its rows and columns with a halo
    of one cell into a ring of RING planes; B3's each uy plane of its rows
    with a halo row either side into a ring of RING planes; B15 stages
    nothing.  Cached: the wrappers ask for it on every call.
    `fx_divergence`, `fx_residual`, `fx_prolong_correct`, `fx_grad_damp` and
    `fx_gradient3` launch with the plan and refuse one that is not a shape
    their kernels take.  Raises ValueError where no
    plan fits: B7 on odd dims, a volume of 2^31 cells or more, more than
    65535 row tiles or chunks."""
    nz, ny, nx = (int(v) for v in zyx)
    prolong = kind == "prolong"
    if (kind not in ("divergence", "residual", "prolong", "grad_damp", "gradient3")
            or min(nz, ny, nx) < 1
            or nz * ny * nx >= 2 ** 31 or (prolong and (nz % 2 or ny % 2 or nx % 2))):
        raise ValueError(f"stencil_plan: no {kind} plan for {tuple(zyx)}")
    planes = _planes(kind, nz)
    nq = _cdiv(nx, QUAD)
    quads = min(QUAD_CHOICES, key=lambda w: _cdiv(nq, w) * w)
    tiles = _cdiv(nq, quads) * _cdiv(ny, CTA_THREADS // quads)
    target = SMS * CTAS_PER_SM
    chunk = max(1, (2 * planes * tiles + target) // (2 * target))
    plan = stencil_layout(kind, (nz, ny, nx), quads, chunk)
    if max(plan.grid[1:]) > 65535:
        raise ValueError(f"stencil_plan: no {kind} plan for {tuple(zyx)}")
    return plan


# ---------------------------------------------------------------------------
# Argument checks
# ---------------------------------------------------------------------------

def _check_fields(fields: torch.Tensor, name: str) -> None:
    if (fields.ndim != 4 or fields.shape[0] < 3 or fields.dtype not in _STORAGE
            or not fields.is_contiguous()):
        raise ValueError(f"{name}: expected a contiguous (C >= 3, Z, Y, X) bf16/f32 "
                         f"tensor, got {tuple(fields.shape)} {fields.dtype}")


def _check_f32(t: torch.Tensor, shape, ref: torch.Tensor, name: str) -> None:
    if (t.ndim != 3 or (shape is not None and tuple(t.shape) != tuple(shape))
            or t.dtype != torch.float32 or t.device != ref.device
            or not t.is_contiguous()):
        want = "(Z, Y, X)" if shape is None else str(tuple(shape))
        raise ValueError(f"{name}: expected a contiguous f32 {want} tensor on "
                         f"{ref.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def _on_cuda(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d as a true f32 division on x's device (the divisor is filled
    there: a tensor made from a host value would be a synchronising copy)."""
    return x / torch.full((), d, dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _diff(q: torch.Tensor, axis: int) -> torch.Tensor:
    return neighbor_shift(q, axis, +1) - neighbor_shift(q, axis, -1)


def divergence_plain(fields: torch.Tensor) -> torch.Tensor:
    """Plain version of B3: 0.5 * (dx + dy + (zp - zm)) on f32 casts of
    channels 0..2, edges clamped (stencil.py:69-75)."""
    u = fields[:3].float()
    dx = _diff(u[0], _AX_X)
    dy = _diff(u[1], _AX_Y)
    dz = _diff(u[2], _AX_Z)
    return 0.5 * ((dx + dy) + dz)


def residual_plain(q: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of B5: b - (((x+ + x- + y+ + y-) + z- + z+) - 6 q)
    in that order (stencil.py:329-334)."""
    s = neighbor_shift(q, _AX_X, +1) + neighbor_shift(q, _AX_X, -1)
    s = s + neighbor_shift(q, _AX_Y, +1) + neighbor_shift(q, _AX_Y, -1)
    s = s + neighbor_shift(q, _AX_Z, -1) + neighbor_shift(q, _AX_Z, +1)
    return b - (s - 6.0 * q)


def _prolong_taps(n_c: int, device):
    """The two non-zero entries of each column of the cell-centred
    prolongation matrix (fluidx12_tpu/sim/mg.py _prolong_matrix), in
    ascending coarse index: fine 2m mixes (m-1, m) at (0.25, 0.75), fine
    2m+1 mixes (m, m+1) at (0.75, 0.25); at a clamped edge both land on one
    coarse cell, whose weight is then 1 (and the second tap's 0)."""
    i = np.arange(2 * n_c)
    m = i // 2
    even = i % 2 == 0
    lo = np.where(even, m - 1, m)
    hi = lo + 1
    w_lo = np.where(even, 0.25, 0.75).astype(np.float32)
    w_hi = (1.0 - w_lo).astype(np.float32)
    edge = (lo < 0) | (hi > n_c - 1)
    lo = np.clip(lo, 0, n_c - 1)
    hi = np.where(edge, lo, hi)
    w_lo = np.where(edge, np.float32(1.0), w_lo)
    w_hi = np.where(edge, np.float32(0.0), w_hi)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return as_t(lo), as_t(hi), as_t(w_lo), as_t(w_hi)


def prolong_correct_plain(q: torch.Tensor, e_c: torch.Tensor) -> torch.Tensor:
    """Plain version of B7: q + prolong(e_c), the lateral upsample of each
    coarse plane as the kernel's two dots (y, then x), then the z lerp of
    the upsampled planes with clamped neighbours (stencil.py:252-267)."""
    nzc, nyc, nxc = e_c.shape
    y_lo, y_hi, wy_lo, wy_hi = _prolong_taps(nyc, e_c.device)
    x_lo, x_hi, wx_lo, wx_hi = _prolong_taps(nxc, e_c.device)
    a = wy_lo[:, None] * e_c[:, y_lo, :] + wy_hi[:, None] * e_c[:, y_hi, :]
    up = wx_lo * a[:, :, x_lo] + wx_hi * a[:, :, x_hi]          # (Zc, Y, X)
    lo = torch.cat([up[:1], up[:-1]])
    hi = torch.cat([up[1:], up[-1:]])
    even = 0.25 * lo + 0.75 * up
    odd = 0.75 * up + 0.25 * hi
    return q + torch.stack([even, odd], dim=1).reshape(q.shape)


def grad_scale(rho: float) -> float:
    """0.5 / rho as the f32 the kernel multiplies by (stencil.py:95)."""
    return float(np.float32(0.5 / rho))


def grad_damp_plain(fields: torch.Tensor, pressure: torch.Tensor,
                    rho: float) -> torch.Tensor:
    """Plain version of B8, in place on channels 0..2 of `fields`: per
    component v = u - (p+ - p-) * fl32(0.5/rho), then where v * pos > 0,
    v *= clip((0.97 - |pos|) / 0.03, -1, 1) with pos = ((i + 0.5)/n)*2 - 1,
    all f32, one rounding to the storage dtype (stencil.py:94-135).
    Returns `fields`."""
    s = grad_scale(rho)
    dev = fields.device
    for c, axis in enumerate((_AX_X, _AX_Y, _AX_Z)):
        n = pressure.shape[axis]
        shape = [1, 1, 1]
        shape[axis] = n
        pos = _div(torch.arange(n, dtype=torch.float32, device=dev) + 0.5, float(n))
        pos = (pos * 2.0 - 1.0).reshape(shape)
        scale = torch.clamp(_div(0.97 - pos.abs(), 0.03), -1.0, 1.0)
        v = fields[c].float() - _diff(pressure, axis) * s
        fields[c] = torch.where(v * pos > 0.0, v * scale, v).to(fields.dtype)
    return fields


# Ramamoorthi's irradiance constants as the kernel multiplies by them:
# C1, C3, C4, and 2 * C1 and 2 * C2 formed in double (stencil.py:212-229).
_C1 = 0.42904276540489171563379376569857
_C3 = 0.24770795610037568833406429782001
_C4 = 0.88622692545275801364908374167057
_C1X2 = 2.0 * _C1
_C2X2 = 2.0 * 0.51166335397324424423977581244463


def gradient_axis(q: torch.Tensor, axis: int) -> torch.Tensor:
    """jnp.gradient of a (Z, Y, X) volume along `axis`: (q+ - q-) with
    clamped neighbours, times 0.5 inside and 1 at the two boundary cells,
    where it is the one-sided difference (stencil.py:146-150)."""
    n = q.shape[axis]
    i = torch.arange(n, device=q.device)
    scale = torch.where((i == 0) | (i == n - 1), 1.0, 0.5).to(q.dtype)
    shape = [1, 1, 1]
    shape[axis] = n
    return _diff(q, axis) * scale.reshape(shape)


def gradient3_plain(q: torch.Tensor) -> torch.Tensor:
    """Plain version of B15: (gx, gy, gz) of a (Z, Y, X) f32 volume as
    jnp.gradient computes them; (3, Z, Y, X)."""
    return torch.stack([gradient_axis(q, ax) for ax in (_AX_X, _AX_Y, _AX_Z)])


def fallback_normal_dirs(gx: torch.Tensor, gy: torch.Tensor, gz: torch.Tensor):
    """-(gx, gy, gz), with the voxel centre (i + 0.5) / n * 2 - 1 per axis
    where its squared length is below 1e-16: the reference's radial
    fallback for a degenerate gradient (RayMarch.hlsli:279)."""
    n1, n2, n3 = -gx, -gy, -gz
    degenerate = n1 * n1 + n2 * n2 + n3 * n3 < 1e-16

    def centres(axis):
        n = gx.shape[axis]
        shape = [1, 1, 1]
        shape[axis] = n
        i = torch.arange(n, dtype=gx.dtype, device=gx.device) + 0.5
        return (_div(i, float(n)) * 2.0 - 1.0).reshape(shape)

    return (torch.where(degenerate, centres(_AX_X), n1),
            torch.where(degenerate, centres(_AX_Y), n2),
            torch.where(degenerate, centres(_AX_Z), n3))


def gi_light_plain(density: torch.Tensor, shadow: torch.Tensor, ao: torch.Tensor,
                   sh_coeffs: torch.Tensor, world3: torch.Tensor, env: torch.Tensor,
                   zero_threshold: float) -> torch.Tensor:
    """Plain version of B16 on f32 (Z, Y, X) inputs: the kernel's
    expressions in its order, one rounding per operation
    (stencil.py:175-231).  Returns (3, Z, Y, X) f32."""
    n1, n2, n3 = fallback_normal_dirs(*(gradient_axis(density, ax)
                                        for ax in (_AX_X, _AX_Y, _AX_Z)))
    c, w = sh_coeffs.to(torch.float32), world3.to(torch.float32)
    env = env.to(torch.float32)
    wx = n1 * w[0, 0] + n2 * w[1, 0] + n3 * w[2, 0]
    wy = n1 * w[0, 1] + n2 * w[1, 1] + n3 * w[2, 1]
    wz = n1 * w[0, 2] + n2 * w[1, 2] + n3 * w[2, 2]
    inv = 1.0 / torch.sqrt(torch.clamp_min(wx * wx + wy * wy + wz * wz, 1e-24))
    x = -wx * inv
    y = -wy * inv
    z = wz * inv
    b8 = _C1 * (x * x - y * y)
    b6 = _C3 * (3.0 * z * z - 1.0)
    bxy = _C1X2 * (x * y)
    bxz = _C1X2 * (x * z)
    byz = _C1X2 * (y * z)
    dense = density >= zero_threshold
    out = []
    for ch in range(3):
        irr = (b8 * c[8, ch] + b6 * c[6, ch] + _C4 * c[0, ch] + bxy * c[4, ch]
               + bxz * c[7, ch] + byz * c[5, ch]
               + _C2X2 * (x * c[3, ch] + y * c[1, ch] + z * c[2, ch]))
        ambient = torch.where(dense, torch.clamp_min(irr, 0.0) * ao, torch.zeros_like(irr))
        out.append(env[ch] * shadow + ambient)
    return torch.stack(out)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def divergence(fields: torch.Tensor) -> torch.Tensor:
    """B3: the edge-clamped divergence of channels 0..2 of the combined
    (C, Z, Y, X) state, read in place.  Returns (Z, Y, X) f32.  One
    launch, laid out by `stencil_plan`."""
    _check_fields(fields, "divergence")
    if not _on_cuda(fields, "divergence"):
        return divergence_plain(fields)
    _, z, y, x = fields.shape
    plan = stencil_plan("divergence", (z, y, x))
    out = torch.empty((z, y, x), dtype=torch.float32, device=fields.device)
    err = _build.lib().fx_divergence(
        fields.data_ptr(), out.data_ptr(), int(fields.dtype == torch.bfloat16),
        z, y, x, plan.quads, plan.rows, plan.chunk, _build.stream_ptr(fields))
    divergence.launches += 1
    _build.check(err, "fx_divergence")
    return out


divergence.launches = 0


def _check_residual(q: torch.Tensor, b: torch.Tensor, name: str) -> None:
    _check_f32(q, None, q, f"{name} q")
    _check_f32(b, q.shape, q, f"{name} b")


def residual(q: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """B5: the Poisson residual b - A q of a (Z, Y, X) f32 pair.  One
    launch, laid out by `stencil_plan`."""
    _check_residual(q, b, "residual")
    if not _on_cuda(q, "residual"):
        return residual_plain(q, b)
    z, y, x = q.shape
    plan = stencil_plan("residual", (z, y, x))
    out = torch.empty_like(q)
    err = _build.lib().fx_residual(q.data_ptr(), b.data_ptr(), out.data_ptr(),
                                   z, y, x, plan.quads, plan.rows, plan.chunk,
                                   _build.stream_ptr(q))
    residual.launches += 1
    _build.check(err, "fx_residual")
    return out


residual.launches = 0


def _check_prolong(q: torch.Tensor, e_c: torch.Tensor, name: str) -> None:
    _check_f32(q, None, q, f"{name} q")
    if any(n % 2 for n in q.shape):
        raise ValueError(f"{name}: fine dims must be even, got {tuple(q.shape)}")
    _check_f32(e_c, tuple(n // 2 for n in q.shape), q, f"{name} e_c")


def prolong_correct(q: torch.Tensor, e_c: torch.Tensor) -> torch.Tensor:
    """B7: q + prolong(e_c); q (Z, Y, X) f32, e_c (Z/2, Y/2, X/2) f32.  One
    launch, laid out by `stencil_plan`."""
    _check_prolong(q, e_c, "prolong_correct")
    if not _on_cuda(q, "prolong_correct"):
        return prolong_correct_plain(q, e_c)
    z, y, x = q.shape
    plan = stencil_plan("prolong", (z, y, x))
    out = torch.empty_like(q)
    err = _build.lib().fx_prolong_correct(q.data_ptr(), e_c.data_ptr(), out.data_ptr(),
                                          z, y, x, plan.quads, plan.rows, plan.chunk,
                                          _build.stream_ptr(q))
    prolong_correct.launches += 1
    _build.check(err, "fx_prolong_correct")
    return out


prolong_correct.launches = 0


def _check_grad_damp(fields: torch.Tensor, pressure: torch.Tensor, name: str) -> None:
    _check_fields(fields, name)
    _check_f32(pressure, fields.shape[1:], fields, f"{name} pressure")


def grad_damp(fields: torch.Tensor, pressure: torch.Tensor, rho: float) -> torch.Tensor:
    """B8: velocity -= 0.5 * grad(p) / rho, then the 3% wall-band damp,
    IN PLACE on channels 0..2 of the combined (C, Z, Y, X) state, as the
    TPU kernel aliases its input; channels 3.. are not touched.  Returns
    `fields`.  One launch, laid out by `stencil_plan`."""
    _check_grad_damp(fields, pressure, "grad_damp")
    if not _on_cuda(fields, "grad_damp"):
        return grad_damp_plain(fields, pressure, rho)
    _, z, y, x = fields.shape
    plan = stencil_plan("grad_damp", (z, y, x))
    err = _build.lib().fx_grad_damp(
        fields.data_ptr(), pressure.data_ptr(), grad_scale(rho),
        int(fields.dtype == torch.bfloat16), z, y, x, plan.quads, plan.rows, plan.chunk,
        _build.stream_ptr(fields))
    grad_damp.launches += 1
    _build.check(err, "fx_grad_damp")
    return fields


grad_damp.launches = 0


def perthread(kind: str, a: torch.Tensor, b: torch.Tensor | None = None,
              rho: float = 1.0) -> torch.Tensor:
    """The designs B3, B5, B7, B8 and B15 replaced, one thread a cell, kept
    only as yardsticks to time them against: `kind` "divergence" is B3 on
    (fields,) (`fx_divergence_perthread`), "residual" B5 on (q, b)
    (`fx_residual_perthread`), "prolong_correct" B7 on (q, e_c)
    (`fx_prolong_correct_perthread`), "grad_damp" B8 on (fields, pressure)
    with `rho`, in place (`fx_grad_damp_perthread`), "gradient3" B15 on (q,)
    (`fx_gradient3_perthread`).  Arguments as `divergence`, `residual`,
    `prolong_correct`, `grad_damp` and `gradient3` take them.  No path of
    the port calls it, and it counts no launch.  Card tensors only."""
    if kind == "gradient3":
        _check_gradient3(a, "perthread")
    elif kind == "divergence":
        _check_fields(a, "perthread")
    elif kind == "residual":
        _check_residual(a, b, "perthread")
    elif kind == "prolong_correct":
        _check_prolong(a, b, "perthread")
    elif kind == "grad_damp":
        _check_grad_damp(a, b, "perthread")
    else:
        raise ValueError(f"perthread: unknown kind {kind!r}")
    if not _on_cuda(a, "perthread"):
        raise ValueError("perthread: the per-cell designs run on card tensors only")
    z, y, x = a.shape[-3:]
    lib = _build.lib()
    if kind == "gradient3":
        out = torch.empty((3, z, y, x), dtype=torch.float32, device=a.device)
        err = lib.fx_gradient3_perthread(a.data_ptr(), out.data_ptr(), z, y, x,
                                         _build.stream_ptr(a))
    elif kind == "divergence":
        out = torch.empty((z, y, x), dtype=torch.float32, device=a.device)
        err = lib.fx_divergence_perthread(a.data_ptr(), out.data_ptr(),
                                          int(a.dtype == torch.bfloat16), z, y, x,
                                          _build.stream_ptr(a))
    elif kind == "residual":
        out = torch.empty_like(a)
        err = lib.fx_residual_perthread(a.data_ptr(), b.data_ptr(), out.data_ptr(), z, y, x,
                                        _build.stream_ptr(a))
    elif kind == "prolong_correct":
        out = torch.empty_like(a)
        err = lib.fx_prolong_correct_perthread(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                               z, y, x, _build.stream_ptr(a))
    else:
        out = a
        err = lib.fx_grad_damp_perthread(a.data_ptr(), b.data_ptr(), grad_scale(rho),
                                         int(a.dtype == torch.bfloat16), z, y, x,
                                         _build.stream_ptr(a))
    _build.check(err, f"perthread {kind}")
    return out


def _check_gradient3(q: torch.Tensor, name: str) -> None:
    _check_f32(q, None, q, name)
    if min(q.shape) < 2:
        raise ValueError(f"{name}: every dim must be >= 2, got {tuple(q.shape)}")


def gradient3(q: torch.Tensor) -> torch.Tensor:
    """B15: the (gx, gy, gz) gradient of a (Z, Y, X) f32 volume, central
    differences inside and one-sided ones at the boundary cells, as
    jnp.gradient; every dim must be at least 2.  Returns (3, Z, Y, X) f32.
    One launch, laid out by `stencil_plan`."""
    _check_gradient3(q, "gradient3")
    if not _on_cuda(q, "gradient3"):
        return gradient3_plain(q)
    z, y, x = q.shape
    plan = stencil_plan("gradient3", (z, y, x))
    out = torch.empty((3, z, y, x), dtype=torch.float32, device=q.device)
    err = _build.lib().fx_gradient3(q.data_ptr(), out.data_ptr(), z, y, x, plan.quads,
                                    plan.rows, plan.chunk, _build.stream_ptr(q))
    gradient3.launches += 1
    _build.check(err, "fx_gradient3")
    return out


gradient3.launches = 0


def gi_light(density: torch.Tensor, shadow: torch.Tensor, ao: torch.Tensor,
             sh_coeffs: torch.Tensor, world3: torch.Tensor, env: torch.Tensor,
             zero_threshold: float) -> torch.Tensor:
    """B16: the GI light map env * shadow + (dense ? max(SH irradiance
    along -grad density, 0) * ao : 0) from f32 (Z, Y, X) density, shadow
    and ao, the (9, 3) SH coefficients, the (3, 3) world rotation and the
    (3,) env light.  Returns (3, Z, Y, X) f32."""
    _check_f32(density, None, density, "gi_light density")
    _check_f32(shadow, density.shape, density, "gi_light shadow")
    _check_f32(ao, density.shape, density, "gi_light ao")
    if (tuple(sh_coeffs.shape) != (9, 3) or tuple(world3.shape) != (3, 3)
            or tuple(env.shape) != (3,)):
        raise ValueError(f"gi_light: expected sh_coeffs (9, 3), world3 (3, 3), env (3,), "
                         f"got {tuple(sh_coeffs.shape)}, {tuple(world3.shape)}, "
                         f"{tuple(env.shape)}")
    if not _on_cuda(density, "gi_light"):
        return gi_light_plain(density, shadow, ao, sh_coeffs, world3, env, zero_threshold)
    # The 39 constants row-major in one f32 tensor on the card: no copy to
    # the host.
    consts = torch.cat([sh_coeffs.reshape(-1), world3.reshape(-1), env.reshape(-1)]
                       ).to(device=density.device, dtype=torch.float32).contiguous()
    z, y, x = density.shape
    out = torch.empty((3, z, y, x), dtype=torch.float32, device=density.device)
    err = _build.lib().fx_gi_light(density.data_ptr(), shadow.data_ptr(), ao.data_ptr(),
                                   consts.data_ptr(), out.data_ptr(), float(zero_threshold),
                                   z, y, x, _build.stream_ptr(density))
    gi_light.launches += 1
    _build.check(err, "fx_gi_light")
    return out


gi_light.launches = 0
