"""Homogeneous point/vector transforms as explicit elementwise f32
arithmetic (mirror of fluidx12_tpu/ops/transform.py).

Never a matmul: a reduced-precision product cancels the tiny homogeneous w of
far-plane unprojections into inf/NaN rays, so the products are written out as
broadcast multiply-adds that stay in full f32 on every device.
"""

from __future__ import annotations

import torch


def transform_point_h(p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(p, 1) @ M without perspective divide. p: (..., 3), m: (4, 4) -> (..., 4)."""
    return p[..., 0:1] * m[0] + p[..., 1:2] * m[1] + p[..., 2:3] * m[2] + m[3]


def transform_point(p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(p, 1) @ M with perspective divide -> (..., 3)."""
    h = transform_point_h(p, m)
    return h[..., :3] / h[..., 3:4]


def transform_ndc(ndc: torch.Tensor, z: float, m: torch.Tensor) -> torch.Tensor:
    """(x, y, z, 1) @ M for 2-component ndc and scalar z -> (..., 3) after divide."""
    zz = torch.full(ndc.shape[:-1] + (1,), float(z), dtype=ndc.dtype, device=ndc.device)
    h = ndc[..., 0:1] * m[0] + ndc[..., 1:2] * m[1] + zz * m[2] + m[3]
    return h[..., :3] / h[..., 3:4]


def transform_vector(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """v @ upper3x3(M). v: (..., 3)."""
    return v[..., 0:1] * m[0, :3] + v[..., 1:2] * m[1, :3] + v[..., 2:3] * m[2, :3]
