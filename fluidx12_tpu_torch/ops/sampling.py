"""Edge-clamped neighbour fetch (the part of fluidx12_tpu/ops/sampling.py
that the fast stack uses)."""

from __future__ import annotations

import torch


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
