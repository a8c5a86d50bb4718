"""Shared ray-march constants and the in-graph face-visibility test (the
part of fluidx12_tpu/render/raymarch_core.py that the fast stack uses)."""

from __future__ import annotations

import math

import torch

from fluidx12_tpu_torch.core.constants import device_constant

# Local-space box diagonal (RayMarch.hlsli:29).
MAX_DIST = 2.0 * math.sqrt(3.0)


def face_visibility_in_graph(local_eye: torch.Tensor) -> torch.Tensor:
    """(6,) bool: face f is visible iff the local eye is on its outward side
    (IsVisible, CSRayMarch.hlsl:69-74)."""
    comps = torch.stack([local_eye[0], local_eye[0], local_eye[1],
                         local_eye[1], local_eye[2], local_eye[2]])
    odd = device_constant((False, True) * 3, torch.bool, local_eye.device)
    return torch.where(odd, comps > -1.0, comps < 1.0)
