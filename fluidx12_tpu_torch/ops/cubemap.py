"""Cube-map addressing: direction -> face and uv (the part of
fluidx12_tpu/ops/cubemap.py that the environment sky uses).

D3D cube-map layout: faces +X, -X, +Y, -Y, +Z, -Z; face f covers axis
f >> 1, on its positive side when f is even; v runs top-down.
"""

from __future__ import annotations

import torch


def direction_to_face_uv(d: torch.Tensor):
    """Directions (..., 3) -> (face, u, v), u and v in [0, 1]: the major
    axis selects the face and the other two coordinates divide by its
    magnitude (the D3D TextureCube lookup rule)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = ~is_x & (ay >= az)

    def pick(cond, a, b):
        return torch.where(cond, torch.full_like(x, a, dtype=torch.int32),
                           torch.full_like(x, b, dtype=torch.int32))

    face = torch.where(is_x, pick(x >= 0, 0, 1),
                       torch.where(is_y, pick(y >= 0, 2, 3), pick(z >= 0, 4, 5)))
    major = torch.clamp_min(torch.where(is_x, ax, torch.where(is_y, ay, az)), 1e-20)
    u = torch.where(is_x, torch.where(x >= 0, -z, z),
                    torch.where(is_y, x, torch.where(z >= 0, x, -x)))
    vv = torch.where(is_y, torch.where(y >= 0, -z, z), y)
    u = u / major
    vv = vv / major
    return face, (u + 1.0) * 0.5, (1.0 - vv) * 0.5
