"""Fused slice resample + front-to-back composite, kernel B10, with its
plain PyTorch version.

Replaces fluidx12_tpu/ops/pallas/composite.py `_composite_resample_kernel`
(via `composite_resample_pallas`), with its arguments: volf (4, n_s, A, B)
bf16 slice-major volume, h_rows (n_s, R1) / h_cols (n_s, R2) f32 source
coordinates, valid (n_s,) f32 mask, n_steps (R1, R2) f32.  Returns
(4, R1, R2) f32: accumulated alpha, then rgb (before the 1/2pi scatter
normalisation).  Only the compact layout is served (no a_log/b_log), and
zero_outside -- which only the DIRECT base-plane march uses -- is not
ported.  The Hopper design and what bounds it:
fluidx12_tpu_torch/csrc/composite.cu.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
(or raises).
"""

from __future__ import annotations

import torch

from fluidx12_tpu_torch.ops.cuda import _build

_EPS_ALPHA = 1e-6


def _taps(h: torch.Tensor, n: int):
    """Row/column taps as the TPU kernel builds its one-hot weights:
    (i0, i1, bf16(1 - frac), bf16(frac))."""
    lim = float(n - 1)
    c = torch.clamp(h, 0.0, lim)
    i0 = torch.floor(c)
    frac = c - i0
    i1 = torch.clamp_max(i0 + 1.0, lim)
    bf = torch.bfloat16
    return (i0.long(), i1.long(), (1.0 - frac).to(bf).float(), frac.to(bf).float())


def composite_resample_plain(volf, h_rows, h_cols, valid, n_steps,
                             absorption: float, flip: bool) -> torch.Tensor:
    """Plain version of B10, slice by slice in march order."""
    _, n_s, a_dim, b_dim = volf.shape
    r1, r2 = h_rows.shape[1], h_cols.shape[1]
    bf = torch.bfloat16
    vol = volf.float()
    absorption = float(torch.tensor(absorption, dtype=torch.float32))
    t = torch.ones((r1, r2), dtype=torch.float32, device=volf.device)
    acc_a = torch.zeros_like(t)
    rgb = torch.zeros((3, r1, r2), dtype=torch.float32, device=volf.device)
    ri0, ri1, rw0, rw1 = _taps(h_rows, a_dim)   # (n_s, R1)
    ci0, ci1, cw0, cw1 = _taps(h_cols, b_dim)   # (n_s, R2)
    for k in range(n_s):
        sl = n_s - 1 - k if flip else k
        v = vol[:, sl]                                           # (4, A, B)
        rows0, rows1 = v[:, ri0[sl]], v[:, ri1[sl]]              # (4, R1, B)
        t1 = (rw0[sl][None, :, None] * rows0
              + rw1[sl][None, :, None] * rows1).to(bf).float()  # (4, R1, B)
        res = (t1[:, :, ci0[sl]] * cw0[sl]
               + t1[:, :, ci1[sl]] * cw1[sl]).to(bf).float()     # (4, R1, R2)
        dens = torch.clamp(res[0], 0.0, 1.0)
        a_ref = torch.clamp(dens * absorption, 0.0, 0.999)
        alpha = 1.0 - torch.exp(n_steps * torch.log1p(-a_ref))
        alpha = torch.clamp(alpha, 0.0, 1.0 - _EPS_ALPHA) * valid[sl]
        w = alpha * t
        w_rate = torch.where(dens > 0.0, w / torch.clamp_min(dens, 1e-6),
                             torch.zeros_like(w))
        rgb = rgb + res[1:] * w_rate
        acc_a = acc_a + w
        t = t * (1.0 - alpha)
    return torch.cat([acc_a[None], rgb], dim=0)


def _check(volf, h_rows, h_cols, valid, n_steps) -> None:
    if (volf.ndim != 4 or volf.shape[0] != 4 or volf.dtype != torch.bfloat16
            or not volf.is_contiguous()):
        raise ValueError(f"composite_resample: volf must be contiguous bf16 "
                         f"(4, n_s, A, B), got {tuple(volf.shape)} {volf.dtype}")
    n_s = volf.shape[1]
    r1 = h_rows.shape[-1]
    r2 = h_cols.shape[-1]
    for t, shape, name in ((h_rows, (n_s, r1), "h_rows"),
                           (h_cols, (n_s, r2), "h_cols"),
                           (valid, (n_s,), "valid"),
                           (n_steps, (r1, r2), "n_steps")):
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or t.device != volf.device or not t.is_contiguous()):
            raise ValueError(f"composite_resample: {name} must be contiguous f32 "
                             f"{shape} on {volf.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")


def composite_resample(volf, h_rows, h_cols, valid, n_steps,
                       absorption: float, flip: bool) -> torch.Tensor:
    """B10: march one face; see the module docstring for the arguments."""
    _check(volf, h_rows, h_cols, valid, n_steps)
    if volf.device.type == "cpu":
        return composite_resample_plain(volf, h_rows, h_cols, valid, n_steps,
                                        absorption, flip)
    if volf.device.type != "cuda":
        raise ValueError(f"composite_resample: unsupported device {volf.device}")
    _, n_s, a_dim, b_dim = volf.shape
    r1, r2 = n_steps.shape
    out = torch.empty((4, r1, r2), dtype=torch.float32, device=volf.device)
    err = _build.lib().fx_composite_resample(
        volf.data_ptr(), h_rows.data_ptr(), h_cols.data_ptr(), valid.data_ptr(),
        n_steps.data_ptr(), out.data_ptr(), float(absorption), int(flip),
        n_s, a_dim, b_dim, r1, r2, _build.stream_ptr(volf))
    composite_resample.launches += 1
    _build.check(err, "fx_composite_resample")
    return out


composite_resample.launches = 0
