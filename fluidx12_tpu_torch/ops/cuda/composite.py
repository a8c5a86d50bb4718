"""Slice compositing of a cube face: kernels B10 (fused slice resample +
front-to-back composite) and B17 (the composite alone, over a
pre-resampled stack), with their plain PyTorch versions and the JAX
package's shape gates.

B10 `composite_resample` replaces fluidx12_tpu/ops/pallas/composite.py
`_composite_resample_kernel` (via `composite_resample_pallas`), with its
arguments: volf (4, n_s, A, B) bf16 slice-major volume, h_rows (n_s, R1) /
h_cols (n_s, R2) f32 source coordinates, valid (n_s,) f32 mask, n_steps
(R1, R2) f32, and `zero_outside` (the DIRECT base-plane march's: both tap
weights of an axis are 0 where its unclamped coordinate lies outside
[-0.5, n - 0.5]).  Only the compact layout is served (no a_log/b_log: on
the logical grid the padded kernel's clamp and inside test at the
logical extent are the compact ones).  B17 `composite` replaces `_composite_kernel` (via
`composite_pallas`): dens (n_s, R1, R2) premasked density and prod
(3, n_s, R1, R2) premultiplied rgb * light, in the march's matmul dtype
(bf16 on the card, which is what the kernel takes; f32 on the CPU), and
n_steps (R1, R2) f32.  Both return (4, R1, R2)
f32: accumulated alpha, then rgb (before the 1/2pi scatter normalisation).
The Hopper designs and what bounds them:
fluidx12_tpu_torch/csrc/composite.cu.

The gates are pure-Python copies of the TPU's VMEM planners
(composite.py:70-95, 190-240).  They decide nothing about the CUDA
kernels; they say which route the JAX package takes on a face
(render/slicecomp.py).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
(or raises).
"""

from __future__ import annotations

import torch

from fluidx12_tpu_torch.ops.cuda import _build

_EPS_ALPHA = 1e-6


# ---------------------------------------------------------------------------
# Gates (copies of fluidx12_tpu/ops/pallas/composite.py)
# ---------------------------------------------------------------------------

def _pick_bs(n_s: int) -> int:
    bs = 16
    while bs > 1 and n_s % bs:
        bs //= 2
    return bs


def composite_supported(n_s: int, r_rows: int, r_cols: int) -> bool:
    """True where the TPU can run B17 on an (n_s, R1, R2) stack
    (composite.py:70)."""
    return (r_cols % 128 == 0 and r_rows % 8 == 0
            and n_s % _pick_bs(n_s) == 0 and n_s >= 8)


def _pick_tile(r_rows: int, r_cols: int, bs: int):
    """B17's lateral VMEM tile, or None (composite.py:84)."""
    tr, tc = r_rows, r_cols
    while tr * tc * (16 * bs + 20) > 8 * 1024 * 1024 and tr % 16 == 0 and tr > 8:
        tr //= 2
    while tr * tc * (16 * bs + 20) > 8 * 1024 * 1024 and tc % 256 == 0 and tc > 128:
        tc //= 2
    if r_rows % tr or r_cols % tc:
        return None
    return tr, tc


def _pick_rows_tile(r1: int, r2: int, a: int, b: int, n_s: int):
    """B10's row tile, or None where no tile fits VMEM (composite.py:190)."""

    def budget(tr):
        fixed = r2 * b * 6 + r2 * n_s * 4 + 2 * 4 * a * b * 2
        per_row = (a * 6 + n_s * 4 + 4 * (b * 6 + r2 * 6) + 4 * r2 * 4 + 5 * r2 * 4
                   + 2 * r2 * 4)
        return fixed + tr * per_row

    tr = r1
    while tr > 8:
        if budget(tr) <= 10 * 1024 * 1024:
            break
        if r1 % (tr // 2) or (tr // 2) % 8:
            break
        tr //= 2
    if budget(tr) > 12 * 1024 * 1024:
        return None
    if tr != r1 and tr % 8:
        return None
    return tr


def composite_resample_supported(n_s: int, a: int, b: int, r1: int, r2: int) -> bool:
    """True where the TPU runs B10 on a face: lateral dims A % 8 and B % 16
    and a row tile within VMEM (composite.py:225)."""
    if a % 8 or b % 16 or n_s < 2:
        return False
    return _pick_rows_tile(r1, r2, a, b, n_s) is not None


# ---------------------------------------------------------------------------
# B10
# ---------------------------------------------------------------------------


def _taps(h: torch.Tensor, n: int, zero_outside: bool = False):
    """Row/column taps as the TPU kernel builds its one-hot weights:
    (i0, i1, bf16(1 - frac), bf16(frac)), both weights 0 where
    `zero_outside` and h lies outside [-0.5, n - 0.5] (composite.py:
    109-122)."""
    lim = float(n - 1)
    c = torch.clamp(h, 0.0, lim)
    i0 = torch.floor(c)
    frac = c - i0
    i1 = torch.clamp_max(i0 + 1.0, lim)
    bf = torch.bfloat16
    w0, w1 = (1.0 - frac).to(bf).float(), frac.to(bf).float()
    if zero_outside:
        inside = ((h >= -0.5) & (h <= lim + 0.5)).float()
        w0, w1 = w0 * inside, w1 * inside
    return i0.long(), i1.long(), w0, w1


def composite_resample_plain(volf, h_rows, h_cols, valid, n_steps, absorption: float,
                             flip: bool, zero_outside: bool = False) -> torch.Tensor:
    """Plain version of B10, slice by slice in march order."""
    _, n_s, a_dim, b_dim = volf.shape
    r1, r2 = h_rows.shape[1], h_cols.shape[1]
    bf = torch.bfloat16
    vol = volf.float()
    absorption = float(torch.tensor(absorption, dtype=torch.float32))
    t = torch.ones((r1, r2), dtype=torch.float32, device=volf.device)
    acc_a = torch.zeros_like(t)
    rgb = torch.zeros((3, r1, r2), dtype=torch.float32, device=volf.device)
    ri0, ri1, rw0, rw1 = _taps(h_rows, a_dim, zero_outside)   # (n_s, R1)
    ci0, ci1, cw0, cw1 = _taps(h_cols, b_dim, zero_outside)   # (n_s, R2)
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


def composite_resample(volf, h_rows, h_cols, valid, n_steps, absorption: float,
                       flip: bool, zero_outside: bool = False) -> torch.Tensor:
    """B10: march one face; see the module docstring for the arguments."""
    _check(volf, h_rows, h_cols, valid, n_steps)
    if volf.device.type == "cpu":
        return composite_resample_plain(volf, h_rows, h_cols, valid, n_steps,
                                        absorption, flip, zero_outside)
    if volf.device.type != "cuda":
        raise ValueError(f"composite_resample: unsupported device {volf.device}")
    _, n_s, a_dim, b_dim = volf.shape
    r1, r2 = n_steps.shape
    out = torch.empty((4, r1, r2), dtype=torch.float32, device=volf.device)
    err = _build.lib().fx_composite_resample(
        volf.data_ptr(), h_rows.data_ptr(), h_cols.data_ptr(), valid.data_ptr(),
        n_steps.data_ptr(), out.data_ptr(), float(absorption), int(flip),
        int(zero_outside), n_s, a_dim, b_dim, r1, r2, _build.stream_ptr(volf))
    composite_resample.launches += 1
    _build.check(err, "fx_composite_resample")
    return out


composite_resample.launches = 0


# ---------------------------------------------------------------------------
# B17
# ---------------------------------------------------------------------------

def composite_plain(dens, prod, n_steps, absorption: float, flip: bool) -> torch.Tensor:
    """Plain version of B17, slice by slice in march order (composite.py:
    49-67): the composite of B10 without its resample and valid mask."""
    n_s = dens.shape[0]
    absorption = float(torch.tensor(absorption, dtype=torch.float32))
    t = torch.ones(n_steps.shape, dtype=torch.float32, device=dens.device)
    acc_a = torch.zeros_like(t)
    rgb = torch.zeros((3,) + tuple(n_steps.shape), dtype=torch.float32, device=dens.device)
    for k in range(n_s):
        sl = n_s - 1 - k if flip else k
        d = torch.clamp(dens[sl].float(), 0.0, 1.0)
        a_ref = torch.clamp(d * absorption, 0.0, 0.999)
        alpha = 1.0 - torch.exp(n_steps * torch.log1p(-a_ref))
        alpha = torch.clamp(alpha, 0.0, 1.0 - _EPS_ALPHA)
        w = alpha * t
        w_rate = torch.where(d > 0.0, w / torch.clamp_min(d, 1e-6), torch.zeros_like(w))
        rgb = rgb + prod[:, sl].float() * w_rate
        acc_a = acc_a + w
        t = t * (1.0 - alpha)
    return torch.cat([acc_a[None], rgb], dim=0)


def composite(dens, prod, n_steps, absorption: float, flip: bool) -> torch.Tensor:
    """B17: front-to-back composite of a pre-resampled (n_s, R1, R2) stack;
    see the module docstring for the arguments."""
    if (dens.ndim != 3 or dens.dtype not in (torch.bfloat16, torch.float32)
            or not dens.is_contiguous()):
        raise ValueError(f"composite: dens must be contiguous bf16/f32 (n_s, R1, R2), "
                         f"got {tuple(dens.shape)} {dens.dtype}")
    n_s, r1, r2 = dens.shape
    for t, shape, dtype, name in ((prod, (3, n_s, r1, r2), dens.dtype, "prod"),
                                  (n_steps, (r1, r2), torch.float32, "n_steps")):
        if (tuple(t.shape) != shape or t.dtype != dtype or t.device != dens.device
                or not t.is_contiguous()):
            raise ValueError(f"composite: {name} must be contiguous {dtype} {shape} on "
                             f"{dens.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    if dens.device.type == "cpu":
        return composite_plain(dens, prod, n_steps, absorption, flip)
    if dens.device.type != "cuda" or dens.dtype != torch.bfloat16:
        raise ValueError(f"composite: the kernel takes bf16 stacks on a CUDA device, got "
                         f"{dens.dtype} on {dens.device}")
    out = torch.empty((4, r1, r2), dtype=torch.float32, device=dens.device)
    err = _build.lib().fx_composite(
        dens.data_ptr(), prod.data_ptr(), n_steps.data_ptr(), out.data_ptr(),
        float(absorption), int(flip), n_s, r1, r2, _build.stream_ptr(dens))
    composite.launches += 1
    _build.check(err, "fx_composite")
    return out


composite.launches = 0
