"""Vectorized NumPy BC6H decoder (fallback when the native library is
absent; mirror of fluidx12_tpu/gi/bc6h_np.py).

Decodes per-mode batches with vectorized bit extraction; bit layouts come
from gi/bc6h_tables.py (the port's copy of the tables the native C++
decoder is generated from).
"""

from __future__ import annotations

import numpy as np

from fluidx12_tpu_torch.gi.bc6h_tables import (
    ANCHOR_2,
    MODES,
    PARTITIONS_2,
    WEIGHT3,
    WEIGHT4,
)

_FIELDS = ["rw", "gw", "bw", "rx", "gx", "bx", "ry", "gy", "by", "rz", "gz", "bz", "d"]


def _extract_bits(blocks_u8: np.ndarray, positions) -> np.ndarray:
    """blocks_u8 (N, 16); positions: list of global bit indices (LSB-first).
    Returns (N,) ints assembled with positions[i] -> output bit i."""
    n = blocks_u8.shape[0]
    out = np.zeros(n, np.int64)
    for i, p in enumerate(positions):
        bit = (blocks_u8[:, p >> 3] >> (p & 7)) & 1
        out |= bit.astype(np.int64) << i
    return out


def _sign_extend(v: np.ndarray, bits: int) -> np.ndarray:
    sign = 1 << (bits - 1)
    return (v ^ sign) - sign


def _unquantize_unsigned(x: np.ndarray, prec: int) -> np.ndarray:
    if prec >= 15:
        return x
    out = ((x.astype(np.int64) << 16) + 0x8000) >> prec
    out = np.where(x == 0, 0, out)
    out = np.where(x == (1 << prec) - 1, 0xFFFF, out)
    return out


def _unquantize_signed(x: np.ndarray, prec: int) -> np.ndarray:
    if prec >= 16:
        return x
    s = x < 0
    ax = np.abs(x)
    out = np.where(
        ax == 0, 0,
        np.where(ax >= (1 << (prec - 1)) - 1, 0x7FFF,
                 ((ax.astype(np.int64) << 15) + 0x4000) >> (prec - 1)),
    )
    return np.where(s, -out, out)


def decode_bc6h_numpy(blocks: np.ndarray, width: int, height: int, signed: bool = False) -> np.ndarray:
    """blocks: flat uint8 of 16-byte BC6H blocks; returns (bh*4, bw*4, 3) f32."""
    bw, bh = (width + 3) // 4, (height + 3) // 4
    nblk = bw * bh
    b = np.ascontiguousarray(blocks[: nblk * 16]).reshape(nblk, 16)

    # Mode field: 2 bits; values >= 2 extend to 5 bits.
    m2 = _extract_bits(b, [0, 1])
    m5 = _extract_bits(b, [0, 1, 2, 3, 4])
    mode_val = np.where(m2 < 2, m2, m5)

    # Output half-floats per texel channel.
    out16 = np.zeros((nblk, 16, 3), np.uint16)

    part2 = np.array(PARTITIONS_2, np.int32)       # (32, 16)
    anchor2 = np.array(ANCHOR_2, np.int32)
    w3 = np.array(WEIGHT3, np.int64)
    w4 = np.array(WEIGHT4, np.int64)

    for mv, info in MODES.items():
        sel = np.nonzero(mode_val == mv)[0]
        if sel.size == 0:
            continue
        blk = b[sel]
        base = 2 if mv < 2 else 5

        # Gather endpoint fields.
        fields = {f: [] for f in _FIELDS}
        for i, (f, bitidx) in enumerate(info.layout):
            fields[f].append((bitidx, base + i))
        vals = {}
        for f, pairs in fields.items():
            if not pairs:
                vals[f] = np.zeros(sel.size, np.int64)
                continue
            pairs.sort()
            positions = [p for _, p in pairs]
            vals[f] = _extract_bits(blk, positions)

        epb = info.epb
        dbits = info.delta_bits
        ep = {}
        for ch, (w_f, x_f, y_f, z_f, db) in enumerate(
            [("rw", "rx", "ry", "rz", dbits[0]),
             ("gw", "gx", "gy", "gz", dbits[1]),
             ("bw", "bx", "by", "bz", dbits[2])]
        ):
            w = vals[w_f]
            x, y, z = vals[x_f], vals[y_f], vals[z_f]
            if signed:
                w = _sign_extend(w, epb)
            if info.transformed:
                x = _sign_extend(x, db) + w
                y = _sign_extend(y, db) + w
                z = _sign_extend(z, db) + w
                mask = (1 << epb) - 1
                if signed:
                    x = _sign_extend(x & mask, epb)
                    y = _sign_extend(y & mask, epb)
                    z = _sign_extend(z & mask, epb)
                else:
                    x &= mask
                    y &= mask
                    z &= mask
            elif signed:
                x = _sign_extend(x, dbits[ch])
                y = _sign_extend(y, dbits[ch])
                z = _sign_extend(z, dbits[ch])
            unq = _unquantize_signed if signed else _unquantize_unsigned
            ep[ch] = (unq(w, epb), unq(x, epb), unq(y, epb), unq(z, epb))

        # Index bits.
        hdr = base + len(info.layout)
        if info.two_region:
            d = vals["d"]
            parts = part2[d]              # (n, 16)
            anchors = anchor2[d]          # (n,)
            ibits = np.full((sel.size, 16), 3, np.int32)
            ibits[:, 0] = 2
            ibits[np.arange(sel.size), anchors] = 2
            weights = w3
        else:
            parts = np.zeros((sel.size, 16), np.int32)
            ibits = np.full((sel.size, 16), 4, np.int32)
            ibits[:, 0] = 3
            weights = w4

        # Sequential per-texel positions differ per block only through the
        # anchor position, which depends on d; handle by computing cumulative
        # offsets per block row.
        offs = hdr + np.concatenate(
            [np.zeros((sel.size, 1), np.int32), np.cumsum(ibits[:, :-1], axis=1)], axis=1
        )  # (n, 16) start bit of each texel's index

        idx = np.zeros((sel.size, 16), np.int64)
        for t in range(16):
            v = np.zeros(sel.size, np.int64)
            for k in range(4):
                p = offs[:, t] + k
                valid = k < ibits[:, t]
                byte = b[sel, np.clip(p >> 3, 0, 15)]
                bit = ((byte >> (p & 7)) & 1).astype(np.int64)
                v |= np.where(valid, bit << k, 0)
            idx[:, t] = v

        # Interpolate and finish.
        wsel = weights[idx]  # (n, 16)
        texel = np.zeros((sel.size, 16, 3), np.uint16)
        for ch in range(3):
            w_, x_, y_, z_ = ep[ch]
            a = np.where(parts == 0, w_[:, None], y_[:, None])
            bb = np.where(parts == 0, x_[:, None], z_[:, None])
            interp = (a * (64 - wsel) + bb * wsel + 32) >> 6
            if signed:
                final = (np.abs(interp) * 31) >> 5
                final = np.where(interp < 0, final | 0x8000, final)
            else:
                final = (interp * 31) >> 6
            texel[:, :, ch] = final.astype(np.uint16)
        out16[sel] = texel

    halfs = out16.view(np.float16).astype(np.float32)  # (nblk, 16, 3)
    t = halfs.reshape(bh, bw, 4, 4, 3)
    img = t.transpose(0, 2, 1, 3, 4).reshape(bh * 4, bw * 4, 3)
    return img
