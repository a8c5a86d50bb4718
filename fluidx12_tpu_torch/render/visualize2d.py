"""2D colour visualization (mirror of fluidx12_tpu/render/visualize2d.py;
ref PSVisualizeColor.hlsl + Fluid::visualizeColor).

Samples the colour slice at z = 0.5, resizes it to the viewport with the
shader's LINEAR_CLAMP sampler and v flip, and applies the tone map
`c / (c + 0.5)`.  The resize is two constant bilinear matrices applied as
f32 matmuls, which the JAX package leaves to XLA outside any Pallas
kernel; TF32 stays off (ROADMAP.md C3).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fluidx12_tpu_torch.core.config import FluidConfig


def _resize_weights(n_out: int, n_src: int, flip: bool) -> np.ndarray:
    """(n_out, n_src) bilinear weights from texel centres, edge-clamped."""
    u = (np.arange(n_out) + 0.5) / n_out
    if flip:
        u = 1.0 - u
    t = u * n_src - 0.5
    i0 = np.floor(t).astype(np.int64)
    frac = t - i0
    i0c = np.clip(i0, 0, n_src - 1)
    i1c = np.clip(i0 + 1, 0, n_src - 1)
    w = np.zeros((n_out, n_src), np.float32)
    w[np.arange(n_out), i0c] += (1.0 - frac).astype(np.float32)
    w[np.arange(n_out), i1c] += frac.astype(np.float32)
    return w


@functools.lru_cache(maxsize=None)
def _weights(n_out: int, n_src: int, flip: bool, device: torch.device) -> torch.Tensor:
    """`_resize_weights` on `device`, made once per shape and kept: a
    captured frame reads it by address (core/constants.py)."""
    return torch.from_numpy(_resize_weights(n_out, n_src, flip)).to(device)


def visualize_color_2d(grid: torch.Tensor, config: FluidConfig) -> torch.Tensor:
    """grid (4, Z, Y, X) -> viewport (H, W, 4) premultiplied RGBA."""
    h, w = config.viewport[1], config.viewport[0]
    z, y, x = config.zyx
    slice_rgba = grid[:, z // 2].to(config.render_dtype)                  # (4, Y, X)
    wu = _weights(w, x, False, grid.device).to(config.render_dtype)      # (W, X)
    wv = _weights(h, y, True, grid.device).to(config.render_dtype)       # (H, Y), v flip
    resized = torch.matmul(torch.matmul(wv, slice_rgba), wu.T).permute(1, 2, 0)
    rgb = resized[..., :3]
    rgb = rgb / (rgb + 0.5)
    return torch.cat([rgb, resized[..., 3:4]], dim=-1)
