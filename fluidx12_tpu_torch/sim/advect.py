"""Impulse injection, forces, saturation and dissipation (the unfused form
of fluidx12_tpu/sim/advect.py `apply_impulse_forces`; CSAdvect.hlsl:57-78,
Impulse.hlsli).

The fast path fuses this step into kernel B2's epilogue
(ops/cuda/advect.py); this form runs after an advect whose z pass did not
fuse it (more than one sub-step, or un-premultiplied colour) and after
every 2D advect, which has no z pass.
"""

from __future__ import annotations

from typing import Tuple

import torch

from fluidx12_tpu_torch.core.config import FluidConfig
from fluidx12_tpu_torch.core.constants import device_constant

# The impulse's edge, exp(-4) as the f32 PyTorch computes, compared as a
# Python float (an f32 value, so the comparison is exact in f32).
_IMPULSE_EDGE = float(torch.exp(torch.tensor(-4.0, dtype=torch.float32)))


def apply_impulse_forces(
    u_new: torch.Tensor,  # (3, Z, Y, X)
    c_new: torch.Tensor,  # (4, Z, Y, X)
    time_step: torch.Tensor,
    config: FluidConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (velocity, color) attenuated, in the input dtype; arithmetic
    in f32 with one rounding at the end.  `time_step` is an f32 scalar
    tensor; the config's constants come from `device_constant`, so a
    frame copies nothing from the host."""
    store = c_new.dtype
    f32 = torch.float32
    dev = c_new.device
    u_new = u_new.to(f32)
    c_new = c_new.to(f32)
    dt = time_step.to(device=dev, dtype=f32)
    z, y, x = config.zyx
    zp, yp, xp = c_new.shape[-3:]
    cx = ((torch.arange(xp, dtype=f32, device=dev) + 0.5) / x).reshape(1, 1, xp)
    cy = ((torch.arange(yp, dtype=f32, device=dev) + 0.5) / y).reshape(1, yp, 1)
    cz = ((torch.arange(zp, dtype=f32, device=dev) + 0.5) / z).reshape(zp, 1, 1)
    ip = device_constant(tuple(config.impulse_pos), f32, dev)
    dx, dy, dz = cx - ip[0], cy - ip[1], cz - ip[2]

    radius = config.impulse_radius if config.is_3d else config.impulse_radius * 0.5
    d2 = dx * dx + dy * dy + dz * dz
    basis = torch.exp(-4.0 * d2 / (radius * radius))
    in_impulse = basis >= _IMPULSE_EDGE

    force = device_constant(tuple(config.ext_force), f32, dev)
    if config.is_3d:
        fs = config.force_scale_3d
        ext = [
            force[0] * fs * basis + (-dz) * config.vort_scale,
            force[1] * fs * basis,
            force[2] * fs * basis + dx * config.vort_scale,
        ]
    else:
        ext = [force[0] * basis, force[1] * basis, force[2] * basis]
    zero = torch.zeros((), dtype=f32, device=dev)
    u_new = torch.stack(
        [u_new[i] + torch.where(in_impulse, ext[i] * dt, zero) for i in range(3)])

    impulse_rgba = device_constant((*config.impulse_color, 1.0), f32,
                                   dev) * config.impulse_density
    dye_t = torch.where(in_impulse, basis * dt, zero)
    c_new = torch.clamp(c_new + impulse_rgba[:, None, None, None] * dye_t[None],
                        0.0, 1.0)

    if not config.pre_multiplied:
        # Un-premultiplied storage (ref: CSAdvect.hlsl:70-72).
        a = c_new[3:4]
        c_new = torch.cat([torch.where(a > 0.0, c_new[:3] / a, c_new[:3]), a])

    atten = torch.clamp_min(1.0 - config.dissipation * dt, 0.0)
    return (u_new * atten).to(store), (c_new * atten).to(store)
