"""Cube-map addressing: direction <-> face and uv, and the texels' positions
on the volume box (the parts of fluidx12_tpu/ops/cubemap.py that the sky
and the faithful cube march use).

D3D cube-map layout: faces +X, -X, +Y, -Y, +Z, -Z; face f covers axis
f >> 1, on its positive side when f is even; v runs top-down.
"""

from __future__ import annotations

import torch

from fluidx12_tpu_torch.ops.sampling import texel_centres


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


def face_uv_to_direction(face: int, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """In-face coordinates u, v in [-1, 1] (v already flipped to y-up) ->
    the un-normalised direction (..., 3) (GetCubeTexcoord(slice, pos))."""
    one = torch.ones_like(u)
    table = {
        0: (one, v, -u),
        1: (-one, v, u),
        2: (u, one, -v),
        3: (u, -one, v),
        4: (u, v, one),
        5: (-u, v, -one),
    }
    return torch.stack(table[face], dim=-1)


def face_texel_local_positions(size: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Local-space positions of all cube-map texels on the [-1, 1]^3 box
    surface, (6, size, size, 3); row 0 of a face is its top (GetLocalPos,
    CSRayMarch.hlsl:39-64)."""
    t = texel_centres(size, dtype, device) * 2.0 - 1.0
    pv, pu = torch.meshgrid(-t, t, indexing="ij")  # pv = -pos.y convention flip
    return torch.stack([face_uv_to_direction(f, pu, pv) for f in range(6)])
