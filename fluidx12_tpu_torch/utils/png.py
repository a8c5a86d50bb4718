"""Minimal PNG reader (numpy + zlib), for comparing frames with the golden
images under tests/goldens/ (mirror of fluidx12_tpu/utils/png.read_png)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader for round-trip tests (8-bit RGB/RGBA, filter types 0-4)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    idat = b""
    w = h = c = None
    while pos < len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, depth, color_type = struct.unpack_from(">IIBB", payload)
            if depth != 8:
                raise ValueError(f"{path}: only 8-bit PNGs are supported")
            c = {2: 3, 6: 4, 0: 1}[color_type]
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w * c + 1)
    out = np.zeros((h, w, c), np.int32)
    stride = w * c
    prev = np.zeros(stride, np.int32)
    for row in range(h):
        ftype = raw[row, 0]
        line = raw[row, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:
            cur = line.copy()
            for i in range(c, stride):
                cur[i] = (cur[i] + cur[i - c]) & 0xFF
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype == 3:
            cur = line.copy()
            for i in range(stride):
                left = cur[i - c] if i >= c else 0
                cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ftype == 4:
            cur = line.copy()
            for i in range(stride):
                a = cur[i - c] if i >= c else 0
                b = prev[i]
                cc = prev[i - c] if i >= c else 0
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                cur[i] = (cur[i] + pred) & 0xFF
        else:
            raise ValueError(f"bad filter {ftype}")
        out[row] = cur.reshape(w, c)
        prev = cur
    return out.astype(np.uint8)
