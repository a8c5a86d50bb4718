"""Terminal live preview: render frames as ANSI half-block art (a copy of
fluidx12_tpu/utils/termview.py, which is numpy only).

The reference presents frames to a Win32 window (Win32Application.cpp:82-220
creates it; Win32Application.cpp:205-211 pumps the message loop around
Render/Present).  A display surface does not exist in this environment, so
the shell analog is the terminal itself: each character cell shows TWO
vertically stacked pixels via the upper-half-block glyph (U+2580) with a
24-bit ANSI foreground (top pixel) and background (bottom pixel).  At a
typical 80x40 terminal that is an 80x80 preview -- plenty to watch the plume
evolve and steer the camera with the live hotkeys (engine/frame_loop.py).

Pure NumPy + ANSI: no terminal library, nothing platform-specific beyond
escape codes every modern emulator supports.
"""

from __future__ import annotations

import numpy as np

# Escape sequences the frame loop uses around a preview session.
ENTER_ALT_SCREEN = "\x1b[?1049h\x1b[?25l"   # alt buffer + hide cursor
LEAVE_ALT_SCREEN = "\x1b[?25h\x1b[?1049l"   # show cursor + main buffer
CURSOR_HOME = "\x1b[H"
_RESET = "\x1b[0m"


def _box_average(img: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Area-average (H, W, 3) u8 -> (rows, cols, 3) u8.

    Bins are the integer edges of a uniform partition; np.add.reduceat
    sums each bin in one vectorized pass per axis.  Averaging (not nearest
    sampling) keeps thin smoke filaments visible at preview scale.
    """
    h, w = img.shape[:2]
    acc = img.astype(np.float32)
    ye = (np.arange(rows) * h) // rows
    xe = (np.arange(cols) * w) // cols
    ycnt = np.diff(np.append(ye, h)).astype(np.float32)
    xcnt = np.diff(np.append(xe, w)).astype(np.float32)
    acc = np.add.reduceat(acc, ye, axis=0) / ycnt[:, None, None]
    acc = np.add.reduceat(acc, xe, axis=1) / xcnt[None, :, None]
    return np.clip(acc + 0.5, 0.0, 255.0).astype(np.uint8)


def render_halfblocks(img: np.ndarray, max_cols: int = 80,
                      max_rows: int = 40) -> str:
    """Render an (H, W, 3) uint8 image as half-block ANSI text.

    Each text row carries two pixel rows (fg = top, bg = bottom).  The
    image is area-averaged down to fit (max_cols, 2 * max_rows) while
    preserving aspect ratio under the ~1:2 character-cell geometry (one
    cell is one pixel wide and two tall, so pixels stay square on screen).
    Rows end with a color reset so the stats line below renders normally.
    """
    img = np.asarray(img)
    if img.ndim != 3 or img.shape[2] < 3:
        raise ValueError(f"expected (H, W, 3) image, got {img.shape}")
    if img.shape[0] == 1:
        # A 1-pixel-tall image cannot fill a half-block cell (top+bottom);
        # duplicating the row keeps _box_average's bins non-empty.
        img = np.repeat(img, 2, axis=0)
    h, w = img.shape[:2]
    # Never upscale: a frame smaller than the cell budget draws 1:1
    # (and bins of zero pixels would divide by zero in _box_average).
    scale = max(w / max_cols, h / (2 * max_rows), 1.0)
    cols = max(int(round(w / scale)), 1)
    rows2 = max(int(round(h / scale)) & ~1, 2)  # even pixel-row count
    small = _box_average(img[..., :3], rows2, cols)
    top, bot = small[0::2], small[1::2]
    lines = []
    for tr, br in zip(top, bot):
        parts = []
        prev = None
        for (fr, fg_, fb), (br_, bg_, bb) in zip(tr, br):
            code = (int(fr), int(fg_), int(fb), int(br_), int(bg_), int(bb))
            if code != prev:  # run-length the escapes: most cells repeat
                parts.append(f"\x1b[38;2;{code[0]};{code[1]};{code[2]}m"
                             f"\x1b[48;2;{code[3]};{code[4]};{code[5]}m")
                prev = code
            parts.append("▀")
        parts.append(_RESET)
        lines.append("".join(parts))
    return "\n".join(lines)
