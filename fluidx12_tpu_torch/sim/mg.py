"""Two-level geometric multigrid for the pressure Poisson solve (mirror of
fluidx12_tpu/sim/mg.py with use_pallas=False).

One V(MG_PRE, MG_POST) cycle with MG_COARSE_ITERS half-grid sweeps.  The
smoothers are the plain Jacobi sweeps of sim/project.py; the grid transfers
are the same pooling / interpolation matrices, applied as f32 einsums (TF32
off), with the z axis by reshape-mean and plane lerps as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

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
    m = np.zeros((n_c, n_f), np.float32)
    for i in range(n_f):
        c = i / 2.0 - 0.25
        c0 = int(np.floor(c))
        f = c - c0
        m[np.clip(c0, 0, n_c - 1), i] += 1.0 - f
        m[np.clip(c0 + 1, 0, n_c - 1), i] += f
    return m


def _mat(m: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(m).to(like.device)


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


def _residual(q: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """b - (sum of 6 edge-clamped neighbours - 6q)."""
    from fluidx12_tpu_torch.ops.sampling import neighbor_shift

    s = (neighbor_shift(q, 2, +1) + neighbor_shift(q, 2, -1)
         + neighbor_shift(q, 1, +1) + neighbor_shift(q, 1, -1)
         + neighbor_shift(q, 0, +1) + neighbor_shift(q, 0, -1))
    return b - (s - 6.0 * q)


def mg_supported(zyx) -> bool:
    """2-level V-cycle needs even dims and a coarse level >= 8 per axis."""
    return all(n % 2 == 0 and n >= 16 for n in zyx)


def mg_solve(q: torch.Tensor, b: torch.Tensor, pre: int = MG_PRE,
             post: int = MG_POST, coarse_iters: int = MG_COARSE_ITERS) -> torch.Tensor:
    """One V(pre, post) cycle; the restricted residual scales by 4 to keep
    the unit-coefficient 6-point form on the coarse grid."""
    from fluidx12_tpu_torch.sim.project import jacobi_sweeps

    q = jacobi_sweeps(q, b, pre, is_3d=True)
    r_c = _restrict(_residual(q, b)) * 4.0
    e_c = jacobi_sweeps(torch.zeros_like(r_c), r_c, coarse_iters, is_3d=True)
    q = q + _prolong(e_c)
    return jacobi_sweeps(q, b, post, is_3d=True)
