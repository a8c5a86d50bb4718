"""Light-map shear scan, kernel B9, with its plain PyTorch version.

Replaces fluidx12_tpu/ops/pallas/sweep.py `_sweep_kernel` (via
`shear_scan_pallas`): the exclusive sheared optical-depth prefix
    D[k, p] = sum_{j<k} log_att[j, p + (k - j) * slope]
of an (n_s, n_a, n_b) slice stack in light-to-far order, with a 2-tap lerp
per lateral axis, shifts clip(pad + k*slope, 0, n) and an f32 carry.  The
Hopper design (one launch, each warp carrying a strip of the sheared
frame's columns in registers, `shear_plan`) and what bounds it:
fluidx12_tpu_torch/csrc/sweep.cu.  `twopass` keeps the design it replaced,
two launches through an (n_s, 2n_a, 2n_b) scratch, as a yardstick.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
(or raises).
"""

from __future__ import annotations

import torch

from fluidx12_tpu_torch.ops.cuda import _build


# shear_scan_kernel, compiled for these: a warp of 32 lanes along w_b owns
# the columns of lanes 1 .. 30 (lanes 0 and 31 are halo), each thread
# SHEAR_ROWS rows along w_a plus a halo row; a ring of 4 slices of taps a
# warp; at most 8 warps a CTA.
SHEAR_LANES = 32
SHEAR_OWN_B = SHEAR_LANES - 2
SHEAR_STAGES = 4
SHEAR_MAX_WARPS = 8
SHEAR_ROWS = 1
SHEAR_WARPS = 4


def shear_smem(warps: int, n_s: int) -> int:
    """Bytes of a CTA's shared memory (csrc/sweep.cu shear_smem): every
    slice's shifts, 16 bytes each, and per warp a ring of slots of its
    rows + 2 tap rows."""
    return (4 * n_s + warps * SHEAR_STAGES * (SHEAR_ROWS + 2) * SHEAR_LANES) * 4


def shear_plan(shape):
    """(tile, threads, smem) of B9 on an (n_s, n_a, n_b) stack: each warp
    owns a (tile_a, tile_b) = (SHEAR_ROWS, 30) tile of the (2n_a, 2n_b)
    sheared frame's columns and emits every output (k, p) whose column p +
    shift_k it owns; warp w of CTA (i, j) takes columns [i * 30, (i + 1) *
    30) and row strip s = j * W + w, rows [s * tile_a, (s + 1) * tile_a),
    both clipped to the frame, for W = threads / 32 warps a CTA; `smem`
    bytes of shared memory a CTA.  `fx_shear_scan` launches once with
    them.  Raises ValueError on an empty stack, or one of more slices than
    a CTA's shared memory holds the shifts of (about 14000; the light
    sweep makes at most 128)."""
    n_s, n_a, n_b = shape
    smem = shear_smem(SHEAR_WARPS, n_s)
    if min(shape) < 1 or smem > _build.SMEM_PER_CTA:
        raise ValueError(f"shear_scan: no plan for an {tuple(shape)} stack")
    return (SHEAR_ROWS, SHEAR_OWN_B), SHEAR_WARPS * SHEAR_LANES, smem


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
    _build.refuse_grad("shear_scan", log_att, s)
    (tile_a, tile_b), threads, smem = shear_plan(log_att.shape)
    out = torch.empty_like(log_att)
    err = _build.lib().fx_shear_scan(
        log_att.data_ptr(), s.data_ptr(), out.data_ptr(), *log_att.shape, tile_a, tile_b,
        threads, smem, _build.stream_ptr(log_att))
    _build.check(err, "fx_shear_scan")
    shear_scan.launches += 1
    return out


shear_scan.launches = 0


def twopass(log_att: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """B9 as two launches through an (n_s, 2n_a, 2n_b) f32 scratch
    (`fx_shear_scan_twopass`): the design `shear_scan` replaced, kept only
    as a yardstick to time it against.  No path of the port calls it, and
    it counts no launch.  Card tensors only, as `shear_scan` takes them."""
    if log_att.device.type != "cuda":
        raise ValueError("twopass: the two-launch design runs on card tensors only")
    _build.refuse_grad("twopass", log_att, s)
    n_s, n_a, n_b = log_att.shape
    scratch = torch.empty((n_s, 2 * n_a, 2 * n_b), dtype=torch.float32,
                          device=log_att.device)
    out = torch.empty_like(log_att)
    _build.check(_build.lib().fx_shear_scan_twopass(
        log_att.data_ptr(), s.data_ptr(), scratch.data_ptr(), out.data_ptr(), n_s, n_a, n_b,
        _build.stream_ptr(log_att)), "fx_shear_scan_twopass")
    return out
