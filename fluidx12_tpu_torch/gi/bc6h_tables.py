"""BC6H mode descriptors, partition and weight tables (shared data).

A copy of fluidx12_tpu/gi/bc6h_tables.py, kept as data so that the port
imports nothing of the JAX package.  Transcribed from the public D3D11
functional spec for BC6H (the same data backs the reference's XUSG DDS
loader for its BC6H probe textures); `native/gen_tables.py` emits the C++
decoder's copy from the JAX package's file, and tests/test_torch_shell.py
holds this copy's decoder to that one bit for bit.

Field naming follows the spec: endpoints (w, x) = subset 0 (base, delta/end),
(y, z) = subset 1; channels r/g/b; `d` = partition index.  Each mode is a
list of (field, bit_index_within_field) in *stream order* (LSB-first bit
stream over the 128-bit little-endian block, starting after the mode bits).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

FieldBit = Tuple[str, int]


def _seq(field: str, lo: int, hi: int) -> List[FieldBit]:
    """Ascending bit run field[lo..hi]."""
    return [(field, i) for i in range(lo, hi + 1)]


def _rseq(field: str, hi: int, lo: int) -> List[FieldBit]:
    """Descending (reversed) bit run field[hi..lo] -- MSB first in stream."""
    return [(field, i) for i in range(hi, lo - 1, -1)]


def _bits(*parts) -> List[FieldBit]:
    out: List[FieldBit] = []
    for p in parts:
        if isinstance(p, tuple):
            out.append(p)
        else:
            out.extend(p)
    return out


class ModeInfo:
    def __init__(self, mode_value, two_region, transformed, epb, delta_bits, layout):
        self.mode_value = mode_value          # value of the 2- or 5-bit mode field
        self.two_region = two_region
        self.transformed = transformed        # delta-coded endpoints
        self.epb = epb                        # endpoint precision (bits) of the base
        self.delta_bits = delta_bits          # (r, g, b) delta precisions
        self.layout = layout                  # [(field, bit)] stream order


# Two-region modes ----------------------------------------------------------
MODES: Dict[int, ModeInfo] = {}

MODES[0x00] = ModeInfo(0x00, True, True, 10, (5, 5, 5), _bits(
    ("gy", 4), ("by", 4), ("bz", 4),
    _seq("rw", 0, 9), _seq("gw", 0, 9), _seq("bw", 0, 9),
    _seq("rx", 0, 4), ("gz", 4), _seq("gy", 0, 3),
    _seq("gx", 0, 4), ("bz", 0), _seq("gz", 0, 3),
    _seq("bx", 0, 4), ("bz", 1), _seq("by", 0, 3),
    _seq("ry", 0, 4), ("bz", 2),
    _seq("rz", 0, 4), ("bz", 3),
    _seq("d", 0, 4),
))

MODES[0x01] = ModeInfo(0x01, True, True, 7, (6, 6, 6), _bits(
    ("gy", 5), ("gz", 4), ("gz", 5),
    _seq("rw", 0, 6), ("bz", 0), ("bz", 1), ("by", 4),
    _seq("gw", 0, 6), ("by", 5), ("bz", 2), ("gy", 4),
    _seq("bw", 0, 6), ("bz", 3), ("bz", 5), ("bz", 4),
    _seq("rx", 0, 5), _seq("gy", 0, 3),
    _seq("gx", 0, 5), _seq("gz", 0, 3),
    _seq("bx", 0, 5), _seq("by", 0, 3),
    _seq("ry", 0, 5), _seq("rz", 0, 5),
    _seq("d", 0, 4),
))

MODES[0x02] = ModeInfo(0x02, True, True, 11, (5, 4, 4), _bits(
    _seq("rw", 0, 9), _seq("gw", 0, 9), _seq("bw", 0, 9),
    _seq("rx", 0, 4), ("rw", 10), _seq("gy", 0, 3),
    _seq("gx", 0, 3), ("gw", 10), ("bz", 0), _seq("gz", 0, 3),
    _seq("bx", 0, 3), ("bw", 10), ("bz", 1), _seq("by", 0, 3),
    _seq("ry", 0, 4), ("bz", 2),
    _seq("rz", 0, 4), ("bz", 3),
    _seq("d", 0, 4),
))

MODES[0x06] = ModeInfo(0x06, True, True, 11, (4, 5, 4), _bits(
    _seq("rw", 0, 9), _seq("gw", 0, 9), _seq("bw", 0, 9),
    _seq("rx", 0, 3), ("rw", 10), ("gz", 4), _seq("gy", 0, 3),
    _seq("gx", 0, 4), ("gw", 10), _seq("gz", 0, 3),
    _seq("bx", 0, 3), ("bw", 10), ("bz", 1), _seq("by", 0, 3),
    _seq("ry", 0, 3), ("bz", 0), ("bz", 2),
    _seq("rz", 0, 3), ("gy", 4), ("bz", 3),
    _seq("d", 0, 4),
))

MODES[0x0A] = ModeInfo(0x0A, True, True, 11, (4, 4, 5), _bits(
    _seq("rw", 0, 9), _seq("gw", 0, 9), _seq("bw", 0, 9),
    _seq("rx", 0, 3), ("rw", 10), ("by", 4), _seq("gy", 0, 3),
    _seq("gx", 0, 3), ("gw", 10), ("bz", 0), _seq("gz", 0, 3),
    _seq("bx", 0, 4), ("bw", 10), _seq("by", 0, 3),
    _seq("ry", 0, 3), ("bz", 1), ("bz", 2),
    _seq("rz", 0, 3), ("bz", 4), ("bz", 3),
    _seq("d", 0, 4),
))

MODES[0x0E] = ModeInfo(0x0E, True, True, 9, (5, 5, 5), _bits(
    _seq("rw", 0, 8), ("by", 4),
    _seq("gw", 0, 8), ("gy", 4),
    _seq("bw", 0, 8), ("bz", 4),
    _seq("rx", 0, 4), ("gz", 4), _seq("gy", 0, 3),
    _seq("gx", 0, 4), ("bz", 0), _seq("gz", 0, 3),
    _seq("bx", 0, 4), ("bz", 1), _seq("by", 0, 3),
    _seq("ry", 0, 4), ("bz", 2),
    _seq("rz", 0, 4), ("bz", 3),
    _seq("d", 0, 4),
))

MODES[0x12] = ModeInfo(0x12, True, True, 8, (6, 5, 5), _bits(
    _seq("rw", 0, 7), ("gz", 4), ("by", 4),
    _seq("gw", 0, 7), ("bz", 2), ("gy", 4),
    _seq("bw", 0, 7), ("bz", 3), ("bz", 4),
    _seq("rx", 0, 5), _seq("gy", 0, 3),
    _seq("gx", 0, 4), ("bz", 0), _seq("gz", 0, 3),
    _seq("bx", 0, 4), ("bz", 1), _seq("by", 0, 3),
    _seq("ry", 0, 5),
    _seq("rz", 0, 5),
    _seq("d", 0, 4),
))

MODES[0x16] = ModeInfo(0x16, True, True, 8, (5, 6, 5), _bits(
    _seq("rw", 0, 7), ("bz", 0), ("by", 4),
    _seq("gw", 0, 7), ("gy", 5), ("gy", 4),
    _seq("bw", 0, 7), ("gz", 5), ("bz", 4),
    _seq("rx", 0, 4), ("gz", 4), _seq("gy", 0, 3),
    _seq("gx", 0, 5), _seq("gz", 0, 3),
    _seq("bx", 0, 4), ("bz", 1), _seq("by", 0, 3),
    _seq("ry", 0, 4), ("bz", 2),
    _seq("rz", 0, 4), ("bz", 3),
    _seq("d", 0, 4),
))

MODES[0x1A] = ModeInfo(0x1A, True, True, 8, (5, 5, 6), _bits(
    _seq("rw", 0, 7), ("bz", 1), ("by", 4),
    _seq("gw", 0, 7), ("by", 5), ("gy", 4),
    _seq("bw", 0, 7), ("bz", 5), ("bz", 4),
    _seq("rx", 0, 4), ("gz", 4), _seq("gy", 0, 3),
    _seq("gx", 0, 4), ("bz", 0), _seq("gz", 0, 3),
    _seq("bx", 0, 5), _seq("by", 0, 3),
    _seq("ry", 0, 4), ("bz", 2),
    _seq("rz", 0, 4), ("bz", 3),
    _seq("d", 0, 4),
))

MODES[0x1E] = ModeInfo(0x1E, True, False, 6, (6, 6, 6), _bits(
    _seq("rw", 0, 5), ("gz", 4), ("bz", 0), ("bz", 1), ("by", 4),
    _seq("gw", 0, 5), ("gy", 5), ("by", 5), ("bz", 2), ("gy", 4),
    _seq("bw", 0, 5), ("gz", 5), ("bz", 3), ("bz", 5), ("bz", 4),
    _seq("rx", 0, 5), _seq("gy", 0, 3),
    _seq("gx", 0, 5), _seq("gz", 0, 3),
    _seq("bx", 0, 5), _seq("by", 0, 3),
    _seq("ry", 0, 5),
    _seq("rz", 0, 5),
    _seq("d", 0, 4),
))

# One-region modes ----------------------------------------------------------
MODES[0x03] = ModeInfo(0x03, False, False, 10, (10, 10, 10), _bits(
    _seq("rw", 0, 9), _seq("gw", 0, 9), _seq("bw", 0, 9),
    _seq("rx", 0, 9), _seq("gx", 0, 9), _seq("bx", 0, 9),
))

MODES[0x07] = ModeInfo(0x07, False, True, 11, (9, 9, 9), _bits(
    _seq("rw", 0, 9), _seq("gw", 0, 9), _seq("bw", 0, 9),
    _seq("rx", 0, 8), ("rw", 10),
    _seq("gx", 0, 8), ("gw", 10),
    _seq("bx", 0, 8), ("bw", 10),
))

MODES[0x0B] = ModeInfo(0x0B, False, True, 12, (8, 8, 8), _bits(
    _seq("rw", 0, 9), _seq("gw", 0, 9), _seq("bw", 0, 9),
    _seq("rx", 0, 7), _rseq("rw", 11, 10),
    _seq("gx", 0, 7), _rseq("gw", 11, 10),
    _seq("bx", 0, 7), _rseq("bw", 11, 10),
))

MODES[0x0F] = ModeInfo(0x0F, False, True, 16, (4, 4, 4), _bits(
    _seq("rw", 0, 9), _seq("gw", 0, 9), _seq("bw", 0, 9),
    _seq("rx", 0, 3), _rseq("rw", 15, 10),
    _seq("gx", 0, 3), _rseq("gw", 15, 10),
    _seq("bx", 0, 3), _rseq("bw", 15, 10),
))

# 2-subset partition table (same as BC7; 32 partitions x 16 texels).
PARTITIONS_2 = [
    [0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1],
    [0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1],
    [0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1],
    [0, 0, 0, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 1, 1, 1],
    [0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 1, 1],
    [0, 0, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1],
    [0, 0, 0, 1, 0, 0, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1],
    [0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 1, 1, 0, 1, 1, 1],
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 1, 1],
    [0, 0, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
    [0, 0, 0, 0, 0, 0, 0, 1, 0, 1, 1, 1, 1, 1, 1, 1],
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 1, 1, 1],
    [0, 0, 0, 1, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1],
    [0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1],
    [0, 0, 0, 0, 1, 0, 0, 0, 1, 1, 1, 0, 1, 1, 1, 1],
    [0, 1, 1, 1, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1, 1, 1, 0],
    [0, 1, 1, 1, 0, 0, 1, 1, 0, 0, 0, 1, 0, 0, 0, 0],
    [0, 0, 1, 1, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 1, 0, 0, 0, 1, 1, 0, 0, 1, 1, 1, 0],
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1, 1, 0, 0],
    [0, 1, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 0, 1],
    [0, 0, 1, 1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 0],
    [0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1, 1, 0, 0],
    [0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0],
    [0, 0, 1, 1, 0, 1, 1, 0, 0, 1, 1, 0, 1, 1, 0, 0],
    [0, 0, 0, 1, 0, 1, 1, 1, 1, 1, 1, 0, 1, 0, 0, 0],
    [0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0],
    [0, 1, 1, 1, 0, 0, 0, 1, 1, 0, 0, 0, 1, 1, 1, 0],
    [0, 0, 1, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 1, 0, 0],
]

# Anchor (fix-up) index of subset 1 per partition.
ANCHOR_2 = [
    15, 15, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 15, 15, 15, 15,
    15, 2, 8, 2, 2, 8, 8, 15,
    2, 8, 2, 2, 8, 8, 2, 2,
]

WEIGHT3 = [0, 9, 18, 27, 37, 46, 55, 64]
WEIGHT4 = [0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64]
