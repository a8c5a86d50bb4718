"""Host-side per-frame controllers: cube-map LOD estimation and face culling.

These are the reference's tiny CPU-per-frame computations that feed the GPU
work (SURVEY.md section 3.2):

- EstimateCubeMapLOD (Fluid.cpp:141-166): project the volume's 8 corners to
  the viewport, take the longest projected cube edge in pixels, derive an
  ideal ray-sample count and cube-map mip level from it.  This is the
  reference's adaptive-resolution scale axis (SURVEY.md section 5.7).
- GenVisibilityMask (Fluid.cpp:48-61): a cube face is visible iff the
  local-space eye lies on its outward side.

They stay on the host here too (scalar math feeding the jitted step), exactly
mirroring the reference's CPU/GPU split.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from fluidx12_tpu_torch.core import math3d as m3

_CUBE_CORNERS = np.array(
    [
        [1.0, 1.0, 1.0],
        [-1.0, 1.0, 1.0],
        [1.0, -1.0, 1.0],
        [-1.0, -1.0, 1.0],
        [-1.0, 1.0, -1.0],
        [1.0, 1.0, -1.0],
        [-1.0, -1.0, -1.0],
        [1.0, -1.0, -1.0],
    ],
    dtype=np.float32,
)

# Cube edges as corner-index pairs (ref: EstimateCubeEdgePixelSize, Fluid.cpp:108-131).
_CUBE_EDGES = np.array(
    [
        [0, 1], [3, 2], [1, 3], [2, 0],
        [4, 5], [7, 6], [5, 7], [6, 4],
        [1, 4], [6, 3], [5, 0], [2, 7],
    ],
    dtype=np.int32,
)


def project_corners_to_viewport(world_view_proj: np.ndarray, viewport: Tuple[int, int]) -> np.ndarray:
    """Project the 8 local-space cube corners to pixel coordinates."""
    p = m3.transform_point(_CUBE_CORNERS, world_view_proj)  # (8, 3) ndc
    xy = p[:, :2] * np.array([0.5, -0.5], np.float32) + 0.5
    return xy * np.array(viewport, np.float32)


def estimate_cube_map_lod(
    max_ray_samples: int,
    num_mips: int,
    cube_map_size: float,
    world_view_proj: np.ndarray,
    viewport: Tuple[int, int],
    upscale: float = 2.0,
    ray_sample_count_scale: float = 2.0,
) -> Tuple[int, int]:
    """Return (lod, ray_sample_count); mirrors EstimateCubeMapLOD (Fluid.cpp:141-166)."""
    px = project_corners_to_viewport(world_view_proj, viewport)  # (8, 2)
    edges = px[_CUBE_EDGES[:, 1]] - px[_CUBE_EDGES[:, 0]]
    s = float(np.max(np.linalg.norm(edges, axis=1))) / upscale

    ray_sample_amt = ray_sample_count_scale * s / np.sqrt(3.0)
    ray_sample_count = min(int(np.ceil(ray_sample_amt)), int(max_ray_samples))
    ray_sample_amt = min(ray_sample_amt, float(ray_sample_count))
    s = ray_sample_amt / ray_sample_count_scale * np.sqrt(3.0)

    level = int(max(np.log2(cube_map_size / s), 0.0)) if s > 0 else num_mips - 1
    return min(level, num_mips - 1), ray_sample_count


def screen_bbox(world_view_proj: np.ndarray, viewport: Tuple[int, int],
                quant: int = 32, pad: int = 2):
    """Host-static pixel AABB (x0, y0, w, h) of the volume's screen
    silhouette, or None when it cannot be bounded (a corner at/behind the
    near plane) or would not shrink the viewport.

    Only pixels inside the box's projection can hit it, so the resolve /
    direct-warp gathers -- whose cost is per pixel ROW (CLAUDE.md layout
    notes) -- need only run inside this rect; everything outside is the
    zero discard the reference gets from rasterizing the cube's faces
    (VSCube + front-face culling, Fluid.cpp:929).  The perspective image of
    a convex polytope with all vertices in front of the eye is the convex
    hull of the vertex images, so the corner bbox bounds the silhouette.
    Rounded OUTWARD to `quant`-pixel multiples so an orbiting camera
    retraces only at coarse thresholds (same idea as direct_plane_spec's
    quantization); `pad` guards float rounding at the silhouette edge.
    """
    h4 = m3.transform_point_h(_CUBE_CORNERS, world_view_proj)  # (8, 4)
    if np.any(h4[:, 3] <= 1e-6):
        return None
    ndc = h4[:, :2] / h4[:, 3:4]
    xy = (ndc * np.array([0.5, -0.5], np.float32) + 0.5) * np.array(
        viewport, np.float32)
    w, h = int(viewport[0]), int(viewport[1])
    x0 = int(np.clip(np.floor((xy[:, 0].min() - pad) / quant) * quant, 0, w))
    y0 = int(np.clip(np.floor((xy[:, 1].min() - pad) / quant) * quant, 0, h))
    x1 = int(np.clip(np.ceil((xy[:, 0].max() + pad) / quant) * quant, 0, w))
    y1 = int(np.clip(np.ceil((xy[:, 1].max() + pad) / quant) * quant, 0, h))
    if x1 <= x0 or y1 <= y0:
        return None  # fully off-screen: keep the trivial full-frame path
    if (x1 - x0) * (y1 - y0) >= w * h:
        return None
    return (x0, y0, x1 - x0, y1 - y0)


def is_cube_face_visible(face: int, local_eye: np.ndarray) -> bool:
    """Face f axis = f>>1, positive side when (f & 1) == 0 (ref: Fluid.cpp:39-45)."""
    comp = float(local_eye[face >> 1])
    return comp > -1.0 if (face & 1) else comp < 1.0

def gen_visibility_mask(world_i: np.ndarray, eye_pt: np.ndarray) -> int:
    """Bitmask of visible faces from the world-space eye (ref: Fluid.cpp:48-61)."""
    local_eye = m3.transform_point_h(np.asarray(eye_pt, np.float32), world_i)[:3]
    mask = 0
    for f in range(6):
        if is_cube_face_visible(f, local_eye):
            mask |= 1 << f
    return mask


def gen_visible_face_list(world_i: np.ndarray, eye_pt: np.ndarray) -> list:
    """Packed visible-face list (ref mode 2, Fluid.cpp:63-84)."""
    mask = gen_visibility_mask(world_i, eye_pt)
    return [f for f in range(6) if mask & (1 << f)]
