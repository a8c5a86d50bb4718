"""DDS texture loading (cube maps for the light probe; mirror of
fluidx12_tpu/gi/dds.py).  `load_dds_cubemap` returns the (6, S, S, 3) f32
numpy cube that `FluidXEngine(radiance=...)` takes; decoding runs on the
host.

Replaces the reference's binary DDS loader (XUSGDDSLoader.h:22-39, impl in
XUSG.dll): parses the DDS container (incl. the DX10 extension header) in
Python and decodes the payload to a float32 (6, H, W, 3) cube map.

Supported formats:
- uncompressed float16/float32 RGBA and legacy RGBA8,
- BC6H_UF16 (the format of the reference's Assets/rnl_cross.dds) via the
  native C++ decoder in native/src/fxnative.cpp (loaded through ctypes), with a
  pure-NumPy fallback decoder for environments without the built library.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List

import numpy as np

_DDS_MAGIC = b"DDS "
_FOURCC_DX10 = b"DX10"

# DXGI formats we understand.
DXGI_R32G32B32A32_FLOAT = 2
DXGI_R32G32B32_FLOAT = 6
DXGI_R16G16B16A16_FLOAT = 10
DXGI_R8G8B8A8_UNORM = 28
DXGI_R8G8B8A8_UNORM_SRGB = 29
DXGI_BC6H_UF16 = 95
DXGI_BC6H_SF16 = 96

_DDSCAPS2_CUBEMAP = 0x200


@dataclass
class DDSHeader:
    width: int
    height: int
    mip_count: int
    array_size: int
    dxgi_format: int
    is_cube: bool
    data_offset: int


def parse_header(data: bytes) -> DDSHeader:
    if data[:4] != _DDS_MAGIC:
        raise ValueError("not a DDS file")
    (size, flags, height, width, _pitch, _depth, mips) = struct.unpack_from("<7I", data, 4)
    if size != 124:
        raise ValueError(f"bad DDS header size {size}")
    mips = max(mips, 1)
    pf_flags, fourcc = struct.unpack_from("<II", data, 4 + 76 + 4)[0], data[4 + 80 : 4 + 84]
    caps2 = struct.unpack_from("<I", data, 4 + 108 + 4)[0]
    is_cube = bool(caps2 & _DDSCAPS2_CUBEMAP)

    offset = 128
    if pf_flags & 0x4 and fourcc == _FOURCC_DX10:
        dxgi_format, _dim, misc, array_size, _misc2 = struct.unpack_from("<5I", data, 128)
        offset = 148
        is_cube = is_cube or bool(misc & 0x4)
    else:
        # Legacy FourCC / mask formats.
        if pf_flags & 0x4:
            code = struct.unpack("<I", fourcc)[0]
            legacy = {113: DXGI_R16G16B16A16_FLOAT, 116: DXGI_R32G32B32A32_FLOAT}
            if code not in legacy:
                raise ValueError(f"unsupported legacy FourCC {fourcc!r}")
            dxgi_format = legacy[code]
        else:
            dxgi_format = DXGI_R8G8B8A8_UNORM  # assume masked RGBA8
        array_size = 1
    return DDSHeader(width, height, mips, array_size, dxgi_format, is_cube, offset)


def _bytes_per_texel(fmt: int) -> int:
    return {
        DXGI_R32G32B32A32_FLOAT: 16,
        DXGI_R32G32B32_FLOAT: 12,
        DXGI_R16G16B16A16_FLOAT: 8,
        DXGI_R8G8B8A8_UNORM: 4,
        DXGI_R8G8B8A8_UNORM_SRGB: 4,
    }[fmt]


def _decode_surface(data: bytes, offset: int, w: int, h: int, fmt: int):
    """Decode one mip surface; returns (array (h, w, >=3) float32, bytes consumed)."""
    if fmt in (DXGI_BC6H_UF16, DXGI_BC6H_SF16):
        bw, bh = (w + 3) // 4, (h + 3) // 4
        nbytes = bw * bh * 16
        blocks = np.frombuffer(data, np.uint8, nbytes, offset)
        rgb = decode_bc6h(blocks, w, h, signed=(fmt == DXGI_BC6H_SF16))
        return rgb, nbytes
    bpt = _bytes_per_texel(fmt)
    nbytes = w * h * bpt
    if fmt == DXGI_R32G32B32A32_FLOAT:
        a = np.frombuffer(data, np.float32, w * h * 4, offset).reshape(h, w, 4)
    elif fmt == DXGI_R32G32B32_FLOAT:
        a = np.frombuffer(data, np.float32, w * h * 3, offset).reshape(h, w, 3)
    elif fmt == DXGI_R16G16B16A16_FLOAT:
        a = np.frombuffer(data, np.float16, w * h * 4, offset).reshape(h, w, 4).astype(np.float32)
    else:
        a = np.frombuffer(data, np.uint8, w * h * 4, offset).reshape(h, w, 4).astype(np.float32) / 255.0
    return np.ascontiguousarray(a[..., :3].astype(np.float32)), nbytes


def load_dds_cubemap(path: str) -> np.ndarray:
    """Load a DDS cube map; returns mip 0 as (6, H, W, 3) float32 (+X,-X,+Y,-Y,+Z,-Z)."""
    with open(path, "rb") as f:
        data = f.read()
    hdr = parse_header(data)
    if not hdr.is_cube:
        raise ValueError("expected a cube map DDS")
    faces: List[np.ndarray] = []
    off = hdr.data_offset
    for _face in range(6):
        for mip in range(hdr.mip_count):
            w = max(hdr.width >> mip, 1)
            h = max(hdr.height >> mip, 1)
            surf, consumed = _decode_surface(data, off, w, h, hdr.dxgi_format)
            if mip == 0:
                faces.append(surf)
            off += consumed
    return np.stack(faces, axis=0)


def decode_bc6h(blocks: np.ndarray, width: int, height: int, signed: bool = False) -> np.ndarray:
    """Decode BC6H blocks to (height, width, 3) float32.

    Prefers the native C++ decoder (native/libfxnative.so); falls back to the
    NumPy implementation in gi/bc6h_np.py.
    """
    from fluidx12_tpu_torch.utils.native import get_native_lib

    lib = get_native_lib()
    if lib is not None:
        import ctypes

        bw, bh = (width + 3) // 4, (height + 3) // 4
        out = np.empty((bh * 4, bw * 4, 3), np.float32)
        blocks = np.ascontiguousarray(blocks, np.uint8)
        lib.fx_decode_bc6h(
            blocks.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int(bw),
            ctypes.c_int(bh),
            ctypes.c_int(1 if signed else 0),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return np.ascontiguousarray(out[:height, :width])

    from fluidx12_tpu_torch.gi.bc6h_np import decode_bc6h_numpy

    return decode_bc6h_numpy(blocks, width, height, signed)
