"""Texture-style sampling of grid fields (mirror of
fluidx12_tpu/ops/sampling.py).

The reference's `SampleLevel(g_smpLinear, uvw, 0)` calls (CSAdvect.hlsl:50-54,
RayMarch.hlsli:63-67) become explicit 8-corner gathers with software
address modes:

- CLAMP  == D3D12 LINEAR_CLAMP  (render-path sampler, Fluid.cpp:475)
- MIRROR == D3D12 LINEAR_MIRROR (advection sampler, Fluid.cpp:452)

Fields are channel-leading (C, Z, Y, X); uvw follows the D3D texture
convention, u along X, v along Y, w along Z, texel centres at
(i + 0.5) / size.  The lerps run in the JAX package's order (x, then y,
then z), so both agree to the last bit on the same inputs.
"""

from __future__ import annotations

import enum

import torch

from fluidx12_tpu_torch.core.constants import device_constant


class AddressMode(enum.Enum):
    CLAMP = "clamp"
    MIRROR = "mirror"


def texel_centres(n: int, dtype, device) -> torch.Tensor:
    """(i + 0.5) / n for i < n: texel centres in [0, 1].  The divisor is a
    tensor, so every device divides (PyTorch's CUDA kernels multiply by the
    reciprocal of a Python-number divisor, which can round differently)."""
    return torch.div(torch.arange(n, dtype=dtype, device=device) + 0.5,
                     device_constant(float(n), dtype, device))


def _resolve_axis(idx: torch.Tensor, size: int, mode: AddressMode) -> torch.Tensor:
    """Map (possibly out-of-range) integer texel indices into [0, size)."""
    if mode == AddressMode.CLAMP:
        return torch.clamp(idx, 0, size - 1)
    # Mirror-repeat with period 2 * size: 0..size-1, then size-1..0, ...
    m = torch.remainder(idx, 2 * size)
    return torch.where(m >= size, 2 * size - 1 - m, m)


def sample_at_cells(field: torch.Tensor, iz: torch.Tensor, iy: torch.Tensor,
                    ix: torch.Tensor) -> torch.Tensor:
    """Point-fetch field[..., iz, iy, ix] for in-range integer index
    tensors of one shape.  field (C, Z, Y, X) or (Z, Y, X); returns
    (C, *idx.shape) or idx.shape."""
    squeeze = field.ndim == 3
    if squeeze:
        field = field[None]
    c, z, y, x = field.shape
    lin = (iz.long() * y + iy) * x + ix
    out = field.reshape(c, z * y * x)[:, lin.reshape(-1)].reshape((c,) + tuple(lin.shape))
    return out[0] if squeeze else out


def trilinear_sample(field: torch.Tensor, uvw: torch.Tensor,
                     mode: AddressMode = AddressMode.CLAMP) -> torch.Tensor:
    """Trilinearly sample `field` (C, Z, Y, X) or (Z, Y, X) at texture
    coordinates `uvw` (..., 3); returns (C, ...) or (...).  D3D linear
    filtering: CLAMP repeats the edge texels, MIRROR reflects."""
    squeeze = field.ndim == 3
    if squeeze:
        field = field[None]
    c, z, y, x = field.shape
    sizes = device_constant((float(x), float(y), float(z)), uvw.dtype, uvw.device)
    # Texel-space coordinates, texel centres at integers.
    t = uvw * sizes - 0.5
    t0 = torch.floor(t)
    frac = t - t0
    t0 = t0.to(torch.int64)
    i0 = [_resolve_axis(t0[..., a], n, mode) for a, n in enumerate((x, y, z))]
    i1 = [_resolve_axis(t0[..., a] + 1, n, mode) for a, n in enumerate((x, y, z))]
    (ix0, iy0, iz0), (ix1, iy1, iz1) = i0, i1
    # The eight corners in one gather: (z, y, x) bits 000, 001, ..., 111.
    lin = torch.stack([(iz * y + iy) * x + ix for iz in (iz0, iz1) for iy in (iy0, iy1)
                       for ix in (ix0, ix1)])
    corners = field.reshape(c, z * y * x)[:, lin.reshape(-1)].reshape((c,) + tuple(lin.shape))
    c000, c001, c010, c011, c100, c101, c110, c111 = corners.unbind(1)
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    c00 = c000 + (c001 - c000) * fx
    c01 = c010 + (c011 - c010) * fx
    c10 = c100 + (c101 - c100) * fx
    c11 = c110 + (c111 - c110) * fx
    c0 = c00 + (c01 - c00) * fy
    c1 = c10 + (c11 - c10) * fy
    out = c0 + (c1 - c0) * fz
    return out[0] if squeeze else out


def neighbor_shift(field: torch.Tensor, axis: int, offset: int) -> torch.Tensor:
    """out[i] = field[clamp(i + offset)] along `axis` -- the reference's
    `max(DTid, 1) - 1` / `min(DTid + 1, size - 1)` neighbour indexing
    (CSProject3D.hlsl:80-88)."""
    size = field.shape[axis]
    if offset == 0:
        return field
    if offset > 0:
        body = field.narrow(axis, offset, size - offset)
        edge = field.narrow(axis, size - 1, 1)
        return torch.cat([body] + [edge] * offset, dim=axis)
    body = field.narrow(axis, 0, size + offset)
    edge = field.narrow(axis, 0, 1)
    return torch.cat([edge] * (-offset) + [body], dim=axis)
