"""PNG output for screenshots and a minimal reader (mirror of
fluidx12_tpu/utils/png.py; ref: stb_image_write + FluidX::SaveImage,
FluidX12.cpp:640-660).

`write_png` prefers the native encoder (native/libfxnative.so through
utils/native.py, where it is built); the numpy + zlib encoder writes a
valid PNG with filter-0 rows.  Both run on the host.  `read_png` reads
what either writes and the golden images under tests/goldens/.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, image: np.ndarray) -> None:
    """Write an (H, W, 3|4) uint8 image to `path`."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8:
        raise ValueError("write_png expects uint8")
    if image.ndim != 3 or image.shape[2] not in (3, 4):
        raise ValueError(f"expected (H, W, 3|4), got {image.shape}")

    from fluidx12_tpu_torch.utils.native import get_native_lib

    lib = get_native_lib()
    if lib is not None:
        import ctypes

        h, w, c = image.shape
        ok = lib.fx_write_png(
            path.encode(), image.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int(w), ctypes.c_int(h), ctypes.c_int(c), ctypes.c_int(w * c),
        )
        if ok:
            return
        # fall through to the numpy encoder on failure

    _write_png_numpy(path, image)


def _write_png_numpy(path: str, image: np.ndarray) -> None:
    h, w, c = image.shape
    color_type = 2 if c == 3 else 6

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, w * c)], axis=1)
    idat = zlib.compress(raw.tobytes(), 6)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", idat))
        f.write(chunk(b"IEND", b""))


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
