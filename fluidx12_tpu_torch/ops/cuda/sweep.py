"""Light-map shear scan, kernel B9, with its plain PyTorch version.

Replaces fluidx12_tpu/ops/pallas/sweep.py `_sweep_kernel` (via
`shear_scan_pallas`): the exclusive sheared optical-depth prefix
    D[k, p] = sum_{j<k} log_att[j, p + (k - j) * slope]
of an (n_s, n_a, n_b) slice stack in light-to-far order, with a 2-tap lerp
per lateral axis, shifts clip(pad + k*slope, 0, n) and an f32 carry.  The
Hopper design (two launches through a (n_s, 2n_a, 2n_b) scratch) and what
bounds it: fluidx12_tpu_torch/csrc/sweep.cu.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
(or raises).
"""

from __future__ import annotations

import torch

from fluidx12_tpu_torch.ops.cuda import _build


def _shift(pad, slope, k: int, n: int):
    sh = torch.clamp(pad + float(k) * slope, 0.0, float(n))
    fl = torch.floor(sh)
    return int(fl.item()), sh - fl


def shear_scan_plain(log_att: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Plain version of B9, step for step the TPU kernel's sequential grid:
    the carry is the (2n_a, 2n_b) sheared plane, the shears are rolls of the
    zero-padded slice.  s = [slope_a, slope_b, pad_a, pad_b]."""
    n_s, n_a, n_b = log_att.shape
    w_a, w_b = 2 * n_a, 2 * n_b
    s = s.cpu()  # the shifts are host scalars: one copy, not one per slice
    carry = torch.zeros((w_a, w_b), dtype=torch.float32, device=log_att.device)
    out = torch.empty_like(log_att)
    for k in range(n_s):
        sa, fa = _shift(s[2], s[0], k, n_a)
        sb, fb = _shift(s[3], s[1], k, n_b)
        # Exclusive output: D[k, p] = carry[p + shift].
        ea = (1.0 - fa) * torch.roll(carry, -sa, 0) + fa * torch.roll(carry, -sa - 1, 0)
        eb = (1.0 - fb) * torch.roll(ea, -sb, 1) + fb * torch.roll(ea, -sb - 1, 1)
        out[k] = eb[:n_a, :n_b]
        # carry += G with G[w] = x[w - shift].
        xp = torch.nn.functional.pad(log_att[k], (0, n_b, 0, n_a))
        ga = (1.0 - fa) * torch.roll(xp, sa, 0) + fa * torch.roll(xp, sa + 1, 0)
        gb = (1.0 - fb) * torch.roll(ga, sb, 1) + fb * torch.roll(ga, sb + 1, 1)
        carry = carry + gb
    return out


def shear_scan(log_att: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """B9.  log_att (n_s, n_a, n_b) f32; s (4,) f32 [slope_a, slope_b,
    pad_a, pad_b] per slice step.  Returns (n_s, n_a, n_b) f32 log
    transmittance sums."""
    if (log_att.ndim != 3 or log_att.dtype != torch.float32
            or not log_att.is_contiguous()):
        raise ValueError(f"shear_scan: expected contiguous f32 (n_s, n_a, n_b), "
                         f"got {tuple(log_att.shape)} {log_att.dtype}")
    if (tuple(s.shape) != (4,) or s.dtype != torch.float32
            or s.device != log_att.device or not s.is_contiguous()):
        raise ValueError("shear_scan: s must be a contiguous f32 (4,) tensor "
                         "on log_att's device")
    if log_att.device.type == "cpu":
        return shear_scan_plain(log_att, s)
    if log_att.device.type != "cuda":
        raise ValueError(f"shear_scan: unsupported device {log_att.device}")
    n_s, n_a, n_b = log_att.shape
    scratch = torch.empty((n_s, 2 * n_a, 2 * n_b), dtype=torch.float32,
                          device=log_att.device)
    out = torch.empty_like(log_att)
    err = _build.lib().fx_shear_scan(
        log_att.data_ptr(), s.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        n_s, n_a, n_b, _build.stream_ptr(log_att))
    shear_scan.launches += 1
    _build.check(err, "fx_shear_scan")
    return out


shear_scan.launches = 0
