"""B9's launch plan and schedule (fluidx12_tpu_torch/csrc/sweep.cu
shear_scan_kernel) on the CPU: the plan owns every output of the light
sweep's stacks exactly once and runs every slice an owned output needs,
its constants are those the kernel source compiles, and a torch model of
the schedule -- each warp's carried columns, its slice range and its halo
lanes and row, NaN wherever a warp would read what it does not carry --
gives `shear_scan_plain` bit for bit.  The plain version itself is held
to the Pallas kernel in interpret mode by tests/test_torch_kernels.py."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fluidx12_tpu_torch.ops.cuda import _build
from fluidx12_tpu_torch.ops.cuda import sweep as ts

# Several pytest workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)


def _args(shape, slope_a, slope_b, seed=0):
    """A stack of log attenuations in (-2, 0] and [slope_a, slope_b, pad_a,
    pad_b] with the light sweep's sign-dependent pads
    (render/lightmap_sweep.scan_args)."""
    n_s, n_a, n_b = shape
    rng = np.random.default_rng(seed)
    x = -torch.from_numpy(rng.uniform(0, 2, shape).astype(np.float32))
    s = torch.tensor([slope_a, slope_b, float(n_a) if slope_a < 0 else 0.0,
                      float(n_b) if slope_b < 0 else 0.0], dtype=torch.float32)
    return x, s


def _shifts(s, shape):
    """Each slice's (sa, fa, sb, fb), as the plain version computes them."""
    n_s, n_a, n_b = shape
    return [ts._shift(s[2], s[0], k, n_a) + ts._shift(s[3], s[1], k, n_b) for k in range(n_s)]


def _meets(a0, la, s, ls, w):
    """Whether the cyclic ranges {a0 + i mod w : i < la} and {s + j mod w :
    j < ls} meet (csrc/sweep.cu meets), for each s."""
    return ((s - a0) % w < la) | ((a0 - s) % w < ls)


def _warps(shape, sa, sb):
    """(ta0, tb0, cb0, k0, k1) of every warp that runs: warp w of CTA
    (i, j) carries rows ta0 .. ta0 + R (ta0 = R * (j * W + w)) and lanes
    cb0 .. cb0 + 31 (cb0 = tb0 - 1 modulo W_b, tb0 = 30 * i), and runs the
    slices k0 .. k1 whose windows [shift, shift + n] meet its columns."""
    n_s, n_a, n_b = shape
    (rows, cols), threads, _ = ts.shear_plan(shape)
    warps = threads // ts.SHEAR_LANES
    w_a, w_b = 2 * n_a, 2 * n_b
    strips = -(-w_a // rows)
    out = []
    for j in range(-(-strips // warps)):
        for w in range(warps):
            ta0 = rows * (j * warps + w)
            if ta0 >= w_a:
                continue
            for tb0 in range(0, w_b, cols):
                cb0 = (tb0 - 1) % w_b
                hit = (_meets(ta0, rows + 1, sa, n_a + 1, w_a)
                       & _meets(cb0, ts.SHEAR_LANES, sb, n_b + 1, w_b))
                if hit.any():
                    k = np.nonzero(hit)[0]
                    out.append((ta0, tb0, cb0, k[0], k[-1]))
    return out


# The light sweep's stacks: the 128^3 and 256^3 frames' (128, 128, 128), the
# 256x256x60 frame's (128, 60, 256) and PRESETS["fluidgi"]'s (75, 150, 150),
# with their slopes; then a thin stack with fractional slopes.
PATH_STACKS = [((128, 128, 128), -1.0, 1.0), ((128, 60, 256), -0.46875, 2.0),
               ((75, 150, 150), -2.0, 2.0), ((32, 16, 128), 0.4, -0.7)]


@pytest.mark.parametrize("shape,slope_a,slope_b", PATH_STACKS,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else None)
def test_shear_plan_owns_every_output_once(shape, slope_a, slope_b):
    """The warps' owned rows partition [0, 2n_a) and their owned columns
    [0, 2n_b), so every base column p + shift_k of an output (k, p) has
    exactly one owner warp, and that warp runs slice k; the plan's shift
    table and rings fit a CTA."""
    n_s, n_a, n_b = shape
    (rows, cols), threads, smem = ts.shear_plan(shape)
    assert cols == ts.SHEAR_OWN_B == 30 and threads % 32 == 0
    assert smem == ts.shear_smem(threads // 32, n_s) <= _build.SMEM_PER_CTA
    _, s = _args(shape, slope_a, slope_b)
    sh = _shifts(s, shape)
    sa = np.array([v[0] for v in sh])
    sb = np.array([v[2] for v in sh])
    w_a, w_b = 2 * n_a, 2 * n_b
    strip_of = np.arange(w_a) // rows
    tile_of = np.arange(w_b) // cols
    k0 = np.full((strip_of[-1] + 1, tile_of[-1] + 1), n_s)
    k1 = np.full_like(k0, -1)
    for ta0, tb0, _, first, last in _warps(shape, sa, sb):
        assert k1[ta0 // rows, tb0 // cols] == -1
        k0[ta0 // rows, tb0 // cols], k1[ta0 // rows, tb0 // cols] = first, last
    assert np.array_equal(np.bincount(strip_of), np.diff(np.append(
        np.arange(0, w_a, rows), w_a)))
    k = np.arange(n_s)[:, None, None]
    ia = strip_of[np.arange(n_a)[None, :, None] + sa[:, None, None]]
    ib = tile_of[np.arange(n_b)[None, None, :] + sb[:, None, None]]
    assert ((k0[ia, ib] <= k) & (k <= k1[ia, ib])).all()


def _shear_model(x, s):
    """shear_scan_kernel's schedule in torch, f32 as the plain version:
    each warp from `_warps` carries (R + 1, 32) columns from a zero carry
    at k0 through k1; at each slice its owned outputs take the lerp along
    a from its rows and along b from the next lane's, and its sample the
    taps at w - shift and, from the previous lane, w - shift - 1; lane
    31's right neighbour and lane 0's left one are NaN.  Returns (out,
    writes), out NaN where no warp writes."""
    n_s, n_a, n_b = x.shape
    rows = ts.shear_plan(x.shape)[0][0]
    w_a, w_b = 2 * n_a, 2 * n_b
    sh = _shifts(s, x.shape)
    sa = np.array([v[0] for v in sh])
    sb = np.array([v[2] for v in sh])
    out = torch.full_like(x, float("nan"))
    writes = torch.zeros(x.shape, dtype=torch.int32)
    xp = torch.nn.functional.pad(x, (0, n_b, 0, n_a))
    lanes, r_own = torch.arange(32), torch.arange(rows)
    nan_col = torch.full((rows + 2, 1), float("nan"))
    for ta0, tb0, cb0, k0, k1 in _warps(x.shape, sa, sb):
        carry = torch.zeros((rows + 1, 32))
        for k in range(k0, k1 + 1):
            sak, fa, sbk, fb = sh[k]
            ua, ub = 1.0 - fa, 1.0 - fb
            ea0 = ua * carry[:rows] + fa * carry[1:]
            ea1 = torch.cat([ea0[:, 1:], nan_col[:rows]], 1)
            pa, pb = ta0 + r_own - sak, tb0 + lanes - 1 - sb[k]
            own = (((ta0 + r_own < w_a) & (pa >= 0) & (pa < n_a))[:, None]
                   & ((lanes >= 1) & (lanes <= 30) & (tb0 + lanes - 1 < w_b)
                      & (pb >= 0) & (pb < n_b))[None])
            i, j = own.nonzero(as_tuple=True)
            out[k, pa[i], pb[j]] = (ub * ea0 + fb * ea1)[i, j]
            writes[k, pa[i], pb[j]] += 1
            t = xp[k][(ta0 + torch.arange(-1, rows + 1) - sak) % w_a][:, (cb0 + lanes - sbk) % w_b]
            ga0 = ua * t[1:] + fa * t[:-1]
            left = torch.cat([nan_col, t[:, :-1]], 1)
            ga1 = ua * left[1:] + fa * left[:-1]
            carry = carry + (ub * ga0 + fb * ga1)
    return out, writes


@pytest.mark.parametrize("shape,slope_a,slope_b", [
    ((7, 8, 12), 0.4, -0.7), ((5, 6, 10), -1.2, 2.0), ((6, 8, 16), 0.0, 0.0),
    ((2, 9, 40), 4.5, -20.0), ((9, 3, 5), 1 / 3, -5 / 9), ((4, 1, 1), 0.2, -0.1),
    ((6, 20, 8), 1.0, -1.0)])
def test_shear_schedule_matches_plain(shape, slope_a, slope_b):
    """The model of B9's schedule writes every output once and equals the
    plain version bit for bit: fractional and integral slopes of both
    signs, zero, the steepest (one lateral frame across the stack), two
    slices, a frame smaller than a warp and one of several row strips."""
    x, s = _args(shape, slope_a, slope_b, seed=sum(shape))
    out, writes = _shear_model(x, s)
    assert (writes == 1).all()
    assert torch.equal(out, ts.shear_scan_plain(x, s))


def test_shear_plan_matches_the_kernel_source():
    """The constants `shear_plan` uses are those csrc/sweep.cu compiles: 32
    lanes, 30 owned columns a warp, the rows a thread, the ring's depth,
    the warps a CTA, the shared memory of the shift table and the rings;
    and the plan refuses an empty stack or one whose shifts do not fit a
    CTA."""
    src = (Path(ts.__file__).parents[2] / "csrc" / "sweep.cu").read_text()
    c = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (ts.SHEAR_LANES, ts.SHEAR_STAGES, ts.SHEAR_MAX_WARPS, ts.SHEAR_ROWS) == (
        c["kLanes"], c["kStages"], c["kMaxWarps"], c["kRows"])
    assert "constexpr int kOwnB = kLanes - 2;" in src and ts.SHEAR_OWN_B == ts.SHEAR_LANES - 2
    assert "return (4 * ns + warps * kStages * (kRows + 2) * kLanes) * (int)sizeof(float);" in src
    assert ts.SHEAR_WARPS <= ts.SHEAR_MAX_WARPS
    for bad in ((0, 8, 8), (20000, 8, 8)):
        with pytest.raises(ValueError):
            ts.shear_plan(bad)
