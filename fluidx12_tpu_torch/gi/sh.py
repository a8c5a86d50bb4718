"""Spherical-harmonics light probe: projection of a radiance cube map and
irradiance evaluation (mirror of fluidx12_tpu/gi/sh.py).

The basis is the D3DX real SH basis with the Condon-Shortley phase folded
into the constants (SHMath.hlsli's `sh_eval_basis_*`); the projection
weights each texel by its differential solid angle and normalises by
4 pi / sum(weight) (CSSHCubeMap.hlsl, CSSHNormalize.hlsl); the irradiance
is Ramamoorthi's order-2 formula with x and y negated
(SHIrradianceTypeless.hlsli:16-37).  Everything is f32; the projection
runs once, when the engine starts.
"""

from __future__ import annotations

import math

import torch


def _factorial_ratio(a: int, b: int) -> float:
    """a! / b! for a <= b."""
    r = 1.0
    for i in range(a + 1, b + 1):
        r /= i
    return r


def sh_eval_basis(order: int, dirs: torch.Tensor) -> torch.Tensor:
    """The real SH basis of unit directions (..., 3): (..., order**2),
    laid out as l*(l+1)+m, for order 1..6."""
    if not 1 <= order <= 6:
        raise ValueError("order must be in 1..6")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    b = [None] * (order * order)

    # Zonal (m = 0): Legendre recurrence, K(l, 0) = sqrt((2l+1)/(4 pi)).
    p_prev = torch.ones_like(z)
    p_curr = z
    b[0] = 0.2820947917738781 * p_prev
    for l in range(1, order):
        b[l * (l + 1)] = math.sqrt((2 * l + 1) / (4 * math.pi)) * p_curr
        p_next = ((2 * l + 1) * z * p_curr - l * p_prev) / (l + 1)
        p_prev, p_curr = p_curr, p_next

    # m > 0: s_m, c_m = sin^m(theta) {sin, cos}(m phi) by the Chebyshev
    # recurrence (SHMath.hlsli:24-27), A_l^m(z) by the associated-Legendre
    # recurrence with the Condon-Shortley phase.
    s_m, c_m = y, x
    for m in range(1, order):
        amm = (-1) ** m * math.prod(range(1, 2 * m, 2))
        a_prev = None
        a_curr = float(amm) * torch.ones_like(z)
        for l in range(m, order):
            k = math.sqrt((2 * l + 1) / (2 * math.pi) * _factorial_ratio(l - m, l + m))
            base = l * (l + 1)
            b[base - m] = k * a_curr * s_m
            b[base + m] = k * a_curr * c_m
            a_next = ((2 * l + 1) * z * a_curr
                      - ((l + m) * a_prev if a_prev is not None else 0.0)) / (l - m + 1)
            a_prev, a_curr = a_curr, a_next
        s_m, c_m = x * s_m + y * c_m, x * c_m - y * s_m
    return torch.stack(b, dim=-1)


def cube_texel_directions(size: int, device="cpu") -> torch.Tensor:
    """Un-normalised direction of each cube-map texel, (6, size, size, 3)
    (GetCubeTexcoord, CubeMap.hlsli:37-48)."""
    half = size * 0.5
    ramp = torch.arange(size, dtype=torch.float32, device=device) - half + 0.5
    vv, uu = torch.meshgrid(-ramp, ramp, indexing="ij")
    rr = torch.full_like(uu, half)
    faces = [
        torch.stack([rr, vv, -uu], dim=-1),   # +X
        torch.stack([-rr, vv, uu], dim=-1),   # -X
        torch.stack([uu, rr, -vv], dim=-1),   # +Y
        torch.stack([uu, -rr, vv], dim=-1),   # -Y
        torch.stack([uu, vv, rr], dim=-1),    # +Z
        torch.stack([-uu, vv, -rr], dim=-1),  # -Z
    ]
    return torch.stack(faces, dim=0)


def project_cubemap_sh(cube: torch.Tensor, order: int = 3) -> torch.Tensor:
    """Project a (6, size, size, 3) radiance cube map onto SH coefficients,
    (order**2, 3), with the reference's differential-solid-angle weights
    (CSSHCubeMap.hlsl:48-58) and 4 pi / sum(weight) normalisation."""
    cube = cube.to(torch.float32)
    size = cube.shape[1]
    dirs = cube_texel_directions(size, cube.device)
    unit = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    b = 1.0 / size - 1.0
    s = 2.0 * (1.0 - 1.0 / size) / (size - 1.0) if size > 1 else 0.0
    ax = torch.arange(size, dtype=torch.float32, device=cube.device) * s + b
    v, u = torch.meshgrid(ax, ax, indexing="ij")  # u along axis 1, v along axis 0
    diff = 1.0 + u * u + v * v
    d_solid = (4.0 / (diff * torch.sqrt(diff))).expand(6, size, size)
    basis = sh_eval_basis(order, unit)                     # (6, size, size, n2)
    weighted = cube * d_solid[..., None]                   # (6, size, size, 3)
    coeffs = torch.einsum("fijn,fijc->nc", basis, weighted)
    total_weight = torch.sum(d_solid)
    return coeffs * (4.0 * math.pi / total_weight)


# Ramamoorthi irradiance constants (SHIrradianceTypeless.hlsli:18-21).
C1 = 0.42904276540489171563379376569857
C2 = 0.51166335397324424423977581244463
C3 = 0.24770795610037568833406429782001
C4 = 0.88622692545275801364908374167057


def evaluate_sh_irradiance(coeffs: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Irradiance (..., 3) from the (9, 3) coefficients along unit normals
    (..., 3), clamped at 0; x and y are negated first, as in the reference
    (SHIrradianceTypeless.hlsli:16-37)."""
    x = -normal[..., 0:1]
    y = -normal[..., 1:2]
    z = normal[..., 2:3]
    c = coeffs
    irr = ((C1 * (x * x - y * y)) * c[8]
           + (C3 * (3.0 * z * z - 1.0)) * c[6]
           + C4 * c[0]
           + (2.0 * C1) * (c[4] * x * y + c[7] * x * z + c[5] * y * z)
           + (2.0 * C2) * (c[3] * x + c[1] * y + c[2] * z))
    return torch.clamp_min(irr, 0.0)


def evaluate_sh_irradiance_planar(coeffs: torch.Tensor, nx: torch.Tensor,
                                  ny: torch.Tensor, nz: torch.Tensor) -> torch.Tensor:
    """Irradiance (3, ...) from the (9, 3) coefficients along unit
    directions given as three (...) fields, clamped at 0; x and y are
    negated first, as in the reference."""
    x, y, z = -nx, -ny, nz
    lead = (3,) + (1,) * x.ndim

    def ch(l):
        return coeffs[l].reshape(lead)

    irr = ((C1 * (x * x - y * y))[None] * ch(8)
           + (C3 * (3.0 * z * z - 1.0))[None] * ch(6)
           + C4 * ch(0)
           + (2.0 * C1) * ((x * y)[None] * ch(4) + (x * z)[None] * ch(7)
                           + (y * z)[None] * ch(5))
           + (2.0 * C2) * (x[None] * ch(3) + y[None] * ch(1) + z[None] * ch(2)))
    return torch.clamp_min(irr, 0.0)
