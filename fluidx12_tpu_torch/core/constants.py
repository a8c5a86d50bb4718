"""Constant tensors of a frame, made once per (value, dtype, device).

A frame must not copy host data to the card: each copy synchronises, and
a CUDA graph cannot capture one.  So the constants a frame reads (the
damp band, the impulse's position and colour, a face's sign, the clear
colour) are made here at their first use and kept for the life of the
process.  A captured graph reads them by address, so nothing evicts them.
Callers only read them.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def device_constant(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """`torch.tensor(values, dtype=dtype, device=device)` for a float, a
    bool or a tuple of them, made once per (values, dtype, device)."""
    return torch.tensor(values, dtype=dtype, device=torch.device(device))
