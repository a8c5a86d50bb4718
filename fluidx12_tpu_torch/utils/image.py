"""Image helpers: premultiplied compositing and 8-bit conversion (mirror of
fluidx12_tpu/utils/image.py)."""

from __future__ import annotations

import numpy as np
import torch


def composite_premultiplied(src_rgba: torch.Tensor, dst_rgb: torch.Tensor) -> torch.Tensor:
    """out = src.rgb + dst.rgb * (1 - src.a); returns rgb."""
    a = src_rgba[..., 3:4]
    return src_rgba[..., :3] + dst_rgb * (1.0 - a)


def to_srgb_u8(rgb) -> np.ndarray:
    """Clamp linear [0,1] to uint8 (the reference's UNORM swap chain)."""
    if isinstance(rgb, torch.Tensor):
        rgb = rgb.detach().cpu().numpy()
    arr = np.asarray(rgb)
    return (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def quantize_unorm8(x: torch.Tensor) -> torch.Tensor:
    """Round-trip through 8-bit UNORM storage (cube-map RGBA8 emulation)."""
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0) / 255.0
