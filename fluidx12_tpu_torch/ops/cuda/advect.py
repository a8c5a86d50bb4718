"""Advection kernels B1 (x then y), B11 (one axis) and B2 (z + fused
forces), with their plain PyTorch versions.

B1 `advect_xy` replaces fluidx12_tpu/ops/pallas/advect.py
`_pass_kernel_fused_xy` (via `_run_pass_fused_xy`); B11 `advect_axis`
replaces the single-axis passes `_pass_kernel_fused_d`/`_pass_kernel_fused_d1`
(via `_run_pass_fused`) and `_pass_kernel` (via `_run_pass`), which the TPU
runs where a plane is too large for B1 (the 2D preset's x then y passes);
B2 `advect_z_forces` replaces `_zpass_forces_kernel` (via `_run_zpass`),
and B12 `advect_z`, the same kernel without its forces epilogue, the plain
`_zpass_kernel`.  All
follow the TPU kernels' semantics, not the mirror-addressed XLA twin's: clamp addressing folded into the displacement,
the x-pass result rounded to the storage dtype before the y pass, and the
forces epilogue in the per-channel table form of `_forces_table`.  One
difference: B1 returns its y-pass result in f32 and B2 reads it so, where
the TPU rounds it to bf16 in HBM between the two kernels (csrc/advect.cu
says why); rounding B1's output to the storage dtype gives the TPU kernel's
output bit for bit.  Sources
and what bounds them: fluidx12_tpu_torch/csrc/advect.cu.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
(or raises).  The plain versions also run on the card, where chip_smoke.py
compares each kernel with its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from fluidx12_tpu_torch.ops.cuda import _build

MAX_DISP = 12.0  # voxels (fluidx12_tpu/ops/pallas/advect.py MAX_DISP)

_STORAGE = (torch.bfloat16, torch.float32)


def forces_table(config) -> np.ndarray:
    """(7, 5) per-channel [A_basis, B_negdz, B_dx, clip_lo, clip_hi]
    (Impulse.hlsli / CSAdvect.hlsl:57-68 constants; the table of
    ops/pallas/advect.py `_forces_table`)."""
    big = 3.0e38
    fc = np.zeros((7, 5), np.float32)
    fs = config.force_scale_3d
    f = np.asarray(config.ext_force, np.float32)
    fc[0] = [f[0] * fs, config.vort_scale, 0.0, -big, big]
    fc[1] = [f[1] * fs, 0.0, 0.0, -big, big]
    fc[2] = [f[2] * fs, 0.0, config.vort_scale, -big, big]
    rgba = np.asarray((*config.impulse_color, 1.0), np.float32) * config.impulse_density
    for j in range(4):
        fc[3 + j] = [rgba[j], 0.0, 0.0, 0.0, 1.0]
    return fc


def force_consts(config):
    """(ip_x, ip_y, ip_z, radius^2, dissipation) as the f32 values the
    kernel's arithmetic sees."""
    ip = config.impulse_pos
    vals = (ip[0], ip[1], ip[2], config.impulse_radius * config.impulse_radius,
            config.dissipation)
    return tuple(float(np.float32(v)) for v in vals)


def _check_vol(vol: torch.Tensor, name: str) -> None:
    if vol.ndim != 4 or vol.dtype not in _STORAGE or not vol.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous (C, Z, Y, X) bf16/f32 "
                         f"tensor, got {tuple(vol.shape)} {vol.dtype}")


def _check_f32(t: torch.Tensor, shape, ref: torch.Tensor, name: str) -> None:
    if (tuple(t.shape) != tuple(shape) or t.dtype != torch.float32
            or t.device != ref.device or not t.is_contiguous()):
        raise ValueError(f"{name}: expected contiguous f32 {tuple(shape)} on "
                         f"{ref.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def _on_cuda(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _axis_ids(n: int, axis: int, ndim: int, device) -> torch.Tensor:
    shape = [1] * ndim
    shape[axis] = n
    return torch.arange(n, dtype=torch.float32, device=device).reshape(shape)


def _clamp_disp(u: torch.Tensor, scale: torch.Tensor, axis: int) -> torch.Tensor:
    """clip(-u * scale, +-MAX_DISP), then into [-i, n-1-i] along `axis` of
    the (Z, Y, X) displacement."""
    n = u.shape[axis]
    ids = _axis_ids(n, axis, u.ndim, u.device)
    d = torch.clamp(-u * scale, -MAX_DISP, MAX_DISP)
    return torch.minimum(torch.maximum(d, -ids), (n - 1.0) - ids)


def _lerp_axis(q: torch.Tensor, d: torch.Tensor, axis: int) -> torch.Tensor:
    """2-tap lerp of f32 q (C, Z, Y, X) at i + d along spatial `axis` (0..2
    of d); d is in bounds, so floor(d) is always a valid offset."""
    n = d.shape[axis]
    a0 = torch.floor(d)
    w0 = (1.0 - (d - a0).abs()).clamp_min(0.0)
    w1 = (1.0 - (d - (a0 + 1.0)).abs()).clamp_min(0.0)
    i0 = (_axis_ids(n, axis, d.ndim, d.device) + a0).to(torch.int64)
    i1 = (i0 + 1).clamp_max(n - 1)
    g0 = torch.gather(q, axis + 1, i0.unsqueeze(0).expand_as(q))
    g1 = torch.gather(q, axis + 1, i1.unsqueeze(0).expand_as(q))
    return w0 * g0 + w1 * g1


def advect_axis_plain(vol: torch.Tensor, scale: torch.Tensor, axis: int,
                      disp_ch: int) -> torch.Tensor:
    """Plain version of B11.  `axis` 0..2 of the (Z, Y, X) volume; scale =
    dt * N (f32, on vol's device); returns vol's storage dtype."""
    q = vol.float()
    d = _clamp_disp(q[disp_ch], scale, axis)
    return _lerp_axis(q, d, axis).to(vol.dtype)


def advect_xy_plain(vol: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Plain version of B1: B11's x pass, then its y pass kept in f32.
    scales = [dt * X, dt * Y] (f32, on vol's device); returns f32."""
    tx = advect_axis_plain(vol, scales[0], 2, 0).float()
    dy = _clamp_disp(tx[1], scales[1], axis=1)
    return _lerp_axis(tx, dy, axis=1)


def advect_z_forces_plain(vol: torch.Tensor, scal: torch.Tensor,
                          table: torch.Tensor, consts, forces: bool = True,
                          store: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain version of B2 on the f32 `vol`.  scal = [dt_sub * Z, dt];
    table (C, 5) f32; consts from `force_consts`; returns `store`."""
    q = vol
    dz = _clamp_disp(q[2], scal[0], axis=0)
    out = _lerp_axis(q, dz, axis=0)
    if not forces:
        return out.to(store)
    ip_x, ip_y, ip_z, radius_sq, dissipation = consts
    _, nz, ny, nx = vol.shape
    dev = vol.device
    dt = scal[1]
    atten = (1.0 - dissipation * dt).clamp_min(0.0)
    cz = (_axis_ids(nz, 0, 3, dev) + 0.5) / nz
    cy = (_axis_ids(ny, 1, 3, dev) + 0.5) / ny
    cx = (_axis_ids(nx, 2, 3, dev) + 0.5) / nx
    dx = cx - ip_x
    dy = cy - ip_y
    dzc = cz - ip_z
    d2 = dx * dx + dy * dy + dzc * dzc
    basis = torch.exp(-4.0 * d2 / radius_sq)
    in_imp = (basis >= 0.01831563889245799).float()
    ndz = -dzc
    chans = []
    for c in range(vol.shape[0]):
        f = table[c]
        ext = f[0] * basis + f[1] * ndz + f[2] * dx
        v = torch.minimum(torch.maximum(out[c] + in_imp * ext * dt, f[3]), f[4])
        chans.append(v * atten)
    return torch.stack(chans).to(store)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def advect_xy(vol: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """B1: x then y split backtrace of every channel of vol (C, Z, Y, X)
    in the storage dtype; the y displacement derives from the x-advected,
    storage-rounded channel 1.  Returns f32."""
    _check_vol(vol, "advect_xy")
    _check_f32(scales, (2,), vol, "advect_xy scales")
    if vol.shape[0] < 2:
        raise ValueError("advect_xy: needs velocity channels 0 and 1")
    if not _on_cuda(vol, "advect_xy"):
        return advect_xy_plain(vol, scales)
    c, z, y, x = vol.shape
    tmp = torch.empty_like(vol)
    out = torch.empty(vol.shape, dtype=torch.float32, device=vol.device)
    err = _build.lib().fx_advect_xy(
        vol.data_ptr(), tmp.data_ptr(), out.data_ptr(), scales.data_ptr(),
        int(vol.dtype == torch.bfloat16), c, z, y, x, _build.stream_ptr(vol))
    advect_xy.launches += 1
    _build.check(err, "fx_advect_xy")
    return out


advect_xy.launches = 0


def advect_axis(vol: torch.Tensor, scale: torch.Tensor, axis: int,
                disp_ch: int) -> torch.Tensor:
    """B11: backtrace of every channel of vol (C, Z, Y, X) along `axis`
    (0 z, 1 y, 2 x), the displacement clip(-vol[disp_ch] * scale) from the
    input itself; one rounding to vol's storage dtype.  scale = dt * N, a
    0-d f32 tensor on vol's device."""
    _check_vol(vol, "advect_axis")
    _check_f32(scale, (), vol, "advect_axis scale")
    if axis not in (0, 1, 2) or not 0 <= disp_ch < vol.shape[0]:
        raise ValueError(f"advect_axis: axis {axis} / displacement channel {disp_ch} "
                         f"out of range for {tuple(vol.shape)}")
    if not _on_cuda(vol, "advect_axis"):
        return advect_axis_plain(vol, scale, axis, disp_ch)
    c, z, y, x = vol.shape
    out = torch.empty_like(vol)
    err = _build.lib().fx_advect_axis(
        vol.data_ptr(), out.data_ptr(), scale.data_ptr(), disp_ch, axis,
        int(vol.dtype == torch.bfloat16), c, z, y, x, _build.stream_ptr(vol))
    advect_axis.launches += 1
    _build.check(err, "fx_advect_axis")
    return out


advect_axis.launches = 0


def advect_z_forces(vol: torch.Tensor, scal: torch.Tensor, table: torch.Tensor,
                    consts, store: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """B2: z backtrace of the f32 vol (C, Z, Y, X) from B1 (dz from
    channel 2), then the impulse/forces/clip/dissipation epilogue; one
    rounding to `store`."""
    _check_z(vol, scal, store, "advect_z_forces")
    _check_f32(table, (vol.shape[0], 5), vol, "advect_z_forces table")
    if not _on_cuda(vol, "advect_z_forces"):
        return advect_z_forces_plain(vol, scal, table, consts, True, store)
    out = _launch_z(vol, scal, table.data_ptr(), consts, True, store)
    advect_z_forces.launches += 1
    return out


advect_z_forces.launches = 0


def advect_z(vol: torch.Tensor, scal: torch.Tensor,
             store: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """B12: the z backtrace alone, replacing `_zpass_kernel` (the TPU's z
    pass when colour is not premultiplied, or between advect sub-steps):
    B2's kernel with its forces epilogue off.  scal = [dt_sub * Z, dt]."""
    _check_z(vol, scal, store, "advect_z")
    if not _on_cuda(vol, "advect_z"):
        return advect_z_forces_plain(vol, scal, None, None, False, store)
    out = _launch_z(vol, scal, None, (0.0,) * 5, False, store)
    advect_z.launches += 1
    return out


advect_z.launches = 0


def _check_z(vol: torch.Tensor, scal: torch.Tensor, store: torch.dtype, name: str) -> None:
    _check_vol(vol, name)
    if vol.dtype != torch.float32 or store not in _STORAGE:
        raise ValueError(f"{name}: expected f32 input and a bf16/f32 "
                         f"output dtype, got {vol.dtype} -> {store}")
    _check_f32(scal, (2,), vol, f"{name} scal")
    if vol.shape[0] < 3:
        raise ValueError(f"{name}: needs velocity channel 2")


def _launch_z(vol, scal, table_ptr, consts, forces: bool, store) -> torch.Tensor:
    c, z, y, x = vol.shape
    out = torch.empty(vol.shape, dtype=store, device=vol.device)
    err = _build.lib().fx_advect_z_forces(
        vol.data_ptr(), out.data_ptr(), scal.data_ptr(), table_ptr,
        *consts, int(forces), int(store == torch.bfloat16), c, z, y, x,
        _build.stream_ptr(vol))
    _build.check(err, "fx_advect_z_forces")
    return out
