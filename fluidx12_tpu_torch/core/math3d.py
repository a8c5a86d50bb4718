"""Row-vector, left-handed 3D math mirroring the reference's DirectXMath usage.

The reference transforms points as `mul(float4(p, 1), M)` with row-vector
matrices (XMMATRIX convention; transposed on upload, un-transposed here).
All functions are plain NumPy and run host-side (per-frame camera math,
ref: FluidX12.cpp:240-254).  A copy of fluidx12_tpu/core/math3d.py, which
cannot be imported without jax.

Reference call sites: XMMatrixLookAtLH / XMMatrixPerspectiveFovLH
(FluidX12.cpp:243-252), XMMatrixScaling (Fluid.cpp:184), world/view/proj
composition in Fluid::UpdateFrame (Fluid.cpp:299-321).
"""

from __future__ import annotations

import numpy as np


def normalize(v):
    v = np.asarray(v, dtype=np.float32)
    return v / np.linalg.norm(v)


def look_at_lh(eye, focus, up) -> np.ndarray:
    """Left-handed look-at view matrix (row-vector convention)."""
    eye = np.asarray(eye, dtype=np.float32)
    zaxis = normalize(np.asarray(focus, dtype=np.float32) - eye)
    xaxis = normalize(np.cross(np.asarray(up, dtype=np.float32), zaxis))
    yaxis = np.cross(zaxis, xaxis)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = [xaxis[0], yaxis[0], zaxis[0]]
    m[1, :3] = [xaxis[1], yaxis[1], zaxis[1]]
    m[2, :3] = [xaxis[2], yaxis[2], zaxis[2]]
    m[3, :3] = [-xaxis @ eye, -yaxis @ eye, -zaxis @ eye]
    return m


def perspective_fov_lh(fov_y: float, aspect: float, zn: float, zf: float) -> np.ndarray:
    """Left-handed perspective projection (depth 0 at near, 1 at far)."""
    h = 1.0 / np.tan(fov_y * 0.5)
    w = h / aspect
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = w
    m[1, 1] = h
    m[2, 2] = zf / (zf - zn)
    m[2, 3] = 1.0
    m[3, 2] = -zn * zf / (zf - zn)
    return m


def scaling(sx: float, sy: float = None, sz: float = None) -> np.ndarray:
    sy = sx if sy is None else sy
    sz = sx if sz is None else sz
    return np.diag([sx, sy, sz, 1.0]).astype(np.float32)


def translation(tx: float, ty: float, tz: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[3, :3] = [tx, ty, tz]
    return m


def rotation_roll_pitch_yaw(pitch: float, yaw: float, roll: float = 0.0) -> np.ndarray:
    """XMMatrixRotationRollPitchYaw equivalent (intrinsic Z*X*Y order, row-vector)."""
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    cr, sr = np.cos(roll), np.sin(roll)
    rx = np.array([[1, 0, 0, 0], [0, cp, sp, 0], [0, -sp, cp, 0], [0, 0, 0, 1]], np.float32)
    ry = np.array([[cy, 0, -sy, 0], [0, 1, 0, 0], [sy, 0, cy, 0], [0, 0, 0, 1]], np.float32)
    rz = np.array([[cr, sr, 0, 0], [-sr, cr, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    return rz @ rx @ ry


def inverse(m) -> np.ndarray:
    return np.linalg.inv(np.asarray(m, dtype=np.float32)).astype(np.float32)


def transform_point(p, m):
    """Row-vector point transform with perspective divide: (p,1) @ M, / w."""
    p = np.asarray(p)
    h = np.concatenate([p, np.ones_like(p[..., :1])], axis=-1) @ m
    return h[..., :3] / h[..., 3:4]


def transform_point_h(p, m):
    """Row-vector point transform without perspective divide: (p,1) @ M."""
    p = np.asarray(p)
    return np.concatenate([p, np.ones_like(p[..., :1])], axis=-1) @ m


def transform_vector(v, m):
    """Row-vector direction transform: v @ upper3x3(M)."""
    v = np.asarray(v)
    return v @ np.asarray(m)[:3, :3]
