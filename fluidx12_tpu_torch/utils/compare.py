"""The tolerance the faithful stack is held to, against its plain versions
(chip_smoke.py) and against the JAX package (tests/test_torch_faithful.py).

A march takes a branch per sample (a density above zero_threshold, a
position inside the box); where a sample lies within rounding of such an
edge the two sides may take different branches, and that ray's values
differ by more than rounding.  So a few values may be off: `few_off`
allows `frac` of them beyond `atol`.

`bf16_ulps` measures a bf16 state against another in units of one extra
rounding at each channel's scale.
"""

from __future__ import annotations

import numpy as np
import torch


def few_off(got, ref, what: str, atol: float = 1e-5, frac: float = 1e-3):
    """Whether `got` (a tensor or an array) is finite, of `ref`'s shape,
    and within `atol` of `ref` except on at most `frac` of the values;
    prints how many are beyond.  Returns (ok, max abs difference)."""
    got, ref = (v.detach().float() if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.array(v, np.float32)) for v in (got, ref))
    if got.shape != ref.shape:
        print(f"{what}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
        return False, float("inf")
    diff = (got - ref.to(got.device)).abs()
    off = int((diff > atol).sum())
    err = float(diff.max())
    print(f"{what}: {off} of {diff.numel()} values beyond {atol}, max abs diff {err:.3e}")
    return bool(torch.isfinite(got).all()) and off <= frac * diff.numel(), err


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| per channel (leading axis) in bf16 ulps at that
    channel's largest magnitude: one extra rounding of data at that scale."""
    a, b = a.float(), b.float()
    dims = tuple(range(1, a.ndim))
    mag = torch.maximum(a.abs().amax(dim=dims, keepdim=True),
                        b.abs().amax(dim=dims, keepdim=True)).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7.0)
    return float(((a - b).abs() / ulp).max())
