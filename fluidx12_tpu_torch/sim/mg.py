"""Two-level geometric multigrid for the pressure Poisson solve (mirror of
fluidx12_tpu/sim/mg.py).

One V(MG_PRE, MG_POST) cycle with MG_COARSE_ITERS half-grid sweeps.  With
`use_pallas` each piece takes the kernel the JAX package runs there on its
TPU, by the same shape gates (ROADMAP.md C5): the pre-smoother with the
residual and restriction fused in, B13 (`jacobi_rr_supported`: planes above
128x128, 256^3 among them); else the smoothers B4 (`jacobi_tuning` gives a
plan) or B6 (`jacobi_packed_supported`) and the residual B5 (the stencil
gate); the prolongation B7.  Elsewhere, and with use_pallas=False, the
twins run: the plain Jacobi sweeps of sim/project.py and the pooling /
interpolation matrices as f32 einsums (TF32 off).  Outside B13 the
restriction is two f32 einsums plus a z reshape-mean, which JAX computes
outside any kernel too.  `mg_project_fused` is the whole projection as one
V-cycle with kernel B18 at both ends (the opt-in `mg_project_fused`).
`mg_solve_padded` is the V-cycle the TPU runs where it stores the grid
padded (core/padding.py): its pieces follow fluidx12_tpu/sim/padded.py,
on the port's compact volumes, with every gate on the storage dims.
"""

from __future__ import annotations

import numpy as np
import torch

from fluidx12_tpu_torch.ops.cuda.jacobi import (
    jacobi,
    jacobi_divrr,
    jacobi_divrr_supported,
    jacobi_grad,
    jacobi_grad_supported,
    jacobi_packed,
    jacobi_packed_supported,
    jacobi_rr,
    jacobi_rr_supported,
    jacobi_tuning,
)
from fluidx12_tpu_torch.ops.cuda.stencil import (
    prolong_correct,
    prolong_pallas_supported,
    residual,
    stencil_pallas_supported,
)
from fluidx12_tpu_torch.ops.sampling import neighbor_shift

MG_PRE = 4
MG_POST = 4
MG_COARSE_ITERS = 32


def _restrict_matrix(n: int) -> np.ndarray:
    """(n, n/2) box-average restriction along one trailing dim."""
    m = np.zeros((n, n // 2), np.float32)
    m[np.arange(n), np.arange(n) // 2] = 0.5
    return m


def _prolong_matrix(n_c: int) -> np.ndarray:
    """(n_c, 2*n_c) cell-centred trilinear prolongation along one dim:
    even fine cells mix (0.25, 0.75) of coarse (m-1, m), odd (0.75, 0.25)
    of (m, m+1); edges clamp."""
    n_f = 2 * n_c
    cols = np.arange(n_f)
    c = cols / 2.0 - 0.25
    c0 = np.floor(c)
    f = (c - c0).astype(np.float32)
    c0 = c0.astype(np.int64)
    m = np.zeros((n_c, n_f), np.float32)
    # Built on every call of `_prolong`, so in one vectorised pass; at a
    # clamped edge both taps add into one cell.
    np.add.at(m, (np.clip(c0, 0, n_c - 1), cols), 1.0 - f)
    np.add.at(m, (np.clip(c0 + 1, 0, n_c - 1), cols), f)
    return m


def _mat(m: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(m).to(device=like.device, dtype=like.dtype)


def _restrict(r: torch.Tensor) -> torch.Tensor:
    """(Z, Y, X) -> (Z/2, Y/2, X/2) box average."""
    nz, ny, nx = r.shape
    r = torch.einsum("zyx,xm->zym", r, _mat(_restrict_matrix(nx), r))
    r = torch.einsum("zym,yn->znm", r, _mat(_restrict_matrix(ny), r))
    return r.reshape(nz // 2, 2, ny // 2, nx // 2).mean(dim=1)


def _prolong(e: torch.Tensor) -> torch.Tensor:
    """(Zc, Yc, Xc) -> (2Zc, 2Yc, 2Xc) trilinear interpolation."""
    nz, ny, nx = e.shape
    e = torch.einsum("zyx,xm->zym", e, _mat(_prolong_matrix(nx), e))
    e = torch.einsum("zym,yn->znm", e, _mat(_prolong_matrix(ny), e))
    lo = torch.cat([e[:1], e])      # clamp
    hi = torch.cat([e, e[-1:]])
    even = 0.25 * lo[:-1] + 0.75 * e
    odd = 0.75 * e + 0.25 * hi[1:]
    return torch.stack([even, odd], dim=1).reshape(2 * nz, 2 * ny, 2 * nx)


def _smooth(q: torch.Tensor, b: torch.Tensor, iters: int,
            use_pallas: bool = True) -> torch.Tensor:
    """Jacobi sweeps: B4 where the TPU has a plan, else B6 where it packs
    the volume, else the twin sweeps (fluidx12_tpu/sim/mg.py:87-107)."""
    from fluidx12_tpu_torch.sim.project import jacobi_sweeps

    tuning = jacobi_tuning(q.shape, iters) if use_pallas else None
    if tuning is not None:
        return jacobi(q, b, iters, *tuning)
    if use_pallas and jacobi_packed_supported(q.shape):
        return jacobi_packed(q, b, iters)
    return jacobi_sweeps(q, b, iters, is_3d=True)


def smooth_padded(q: torch.Tensor, b: torch.Tensor, iters: int, storage,
                  use_pallas: bool = True) -> torch.Tensor:
    """Jacobi sweeps of a compact volume whose grid the TPU stores with the
    dims `storage` (fluidx12_tpu/sim/padded.py:71-84, `_smooth_masked`):
    B4 with the tuning, and so the neighbour order, of those dims, else
    the twin sweeps; never B6."""
    from fluidx12_tpu_torch.sim.project import jacobi_sweeps

    tuning = jacobi_tuning(storage, iters) if use_pallas else None
    if tuning is not None:
        return jacobi(q, b, iters, *tuning, storage=storage)
    return jacobi_sweeps(q, b, iters, is_3d=True)


def _residual(q: torch.Tensor, b: torch.Tensor, use_pallas: bool = True) -> torch.Tensor:
    """b - (sum of 6 edge-clamped neighbours - 6q): B5 where the stencil
    gate holds, else the twin."""
    if use_pallas and stencil_pallas_supported(q.shape):
        return residual(q, b)
    s = (neighbor_shift(q, 2, +1) + neighbor_shift(q, 2, -1)
         + neighbor_shift(q, 1, +1) + neighbor_shift(q, 1, -1)
         + neighbor_shift(q, 0, +1) + neighbor_shift(q, 0, -1))
    return b - (s - 6.0 * q)


def mg_supported(zyx) -> bool:
    """2-level V-cycle needs even dims and a coarse level >= 8 per axis."""
    return all(n % 2 == 0 and n >= 16 for n in zyx)


def mg_fused_supported(zyx, vel_bytes: int = 2) -> bool:
    """True where the TPU runs the fully fused projection, kernel B18
    (fluidx12_tpu/sim/mg.py:140-153)."""
    return (mg_supported(zyx)
            and jacobi_divrr_supported(zyx, MG_PRE, vel_bytes)
            and jacobi_grad_supported(zyx, MG_POST, vel_bytes)
            and prolong_pallas_supported(zyx))


def mg_project_fused(fields: torch.Tensor, q: torch.Tensor, rho: float):
    """The whole projection as one V-cycle (fluidx12_tpu/sim/mg.py:156-176):
    B18's head computes the divergence in the pre-smoother's first launch
    and fuses in the residual and restriction, the coarse sweeps and B7 run
    as in `mg_solve`, and B18's tail subtracts the gradient and damps the
    velocity after the post-smoother, in place on channels 0..2 of
    `fields`.  Returns (fields, q')."""
    q, b, r_c = jacobi_divrr(fields, q, MG_PRE, scale=4.0)
    e_c = _smooth(torch.zeros_like(r_c), r_c, MG_COARSE_ITERS, use_pallas=True)
    q = prolong_correct(q, e_c)
    q, fields = jacobi_grad(q, b, fields, MG_POST, rho)
    return fields, q


def mg_solve(q: torch.Tensor, b: torch.Tensor, pre: int = MG_PRE,
             post: int = MG_POST, coarse_iters: int = MG_COARSE_ITERS,
             use_pallas: bool = True) -> torch.Tensor:
    """One V(pre, post) cycle; the restricted residual scales by 4 to keep
    the unit-coefficient 6-point form on the coarse grid.  use_pallas=False
    forces the twins throughout (fluidx12_tpu/sim/mg.py:179-216)."""
    if use_pallas and jacobi_rr_supported(q.shape, pre):
        # B13: the pre-smoother with the residual and the 2x restriction
        # fused in, as the TPU runs planes above 128x128.
        q, r_c = jacobi_rr(q, b, pre, scale=4.0)
    else:
        q = _smooth(q, b, pre, use_pallas)
        r_c = _restrict(_residual(q, b, use_pallas)) * 4.0
    e_c = _smooth(torch.zeros_like(r_c), r_c, coarse_iters, use_pallas)
    if use_pallas and prolong_pallas_supported(q.shape):
        q = prolong_correct(q, e_c)
    else:
        q = q + _prolong(e_c)
    return _smooth(q, b, post, use_pallas)


def mg_solve_padded(q: torch.Tensor, b: torch.Tensor, storage, pre: int = MG_PRE,
                    post: int = MG_POST, coarse_iters: int = MG_COARSE_ITERS,
                    use_pallas: bool = True) -> torch.Tensor:
    """One V(pre, post) cycle of a compact (Z, Y, X) volume whose grid the
    TPU stores with the dims `storage`, as it runs `mg_solve_padded`
    (fluidx12_tpu/sim/padded.py:222-257): the smoothers of
    `smooth_padded` at the fine and at the coarse storage dims; where the
    stencil gate holds on the storage dims, B5 and, where B7's gate holds
    there too, B7 (else the twin prolongation over the logical coarse
    extent); the restriction as two einsums and a mean.  Never B13.  Each
    kernel clamps at the compact volume's edges, which are the logical
    edges the TPU's kernels clamp at."""
    q = smooth_padded(q, b, pre, storage, use_pallas)
    kernels = use_pallas and stencil_pallas_supported(storage)
    r_c = _restrict(residual(q, b) if kernels else _residual(q, b, False)) * 4.0
    coarse = tuple(n // 2 for n in storage)
    e_c = smooth_padded(torch.zeros_like(r_c), r_c, coarse_iters, coarse, use_pallas)
    if kernels and prolong_pallas_supported(storage):
        q = prolong_correct(q, e_c)
    else:
        q = q + _prolong(e_c)
    return smooth_padded(q, b, post, storage, use_pallas)
