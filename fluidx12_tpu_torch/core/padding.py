"""Which grids the TPU stores padded (copies of padded_zyx / storage_zyx of
fluidx12_tpu/core/padding.py).

On the TPU every 3D grid with x >= 96 whose dims are not roll-clean lives
in a padded (Zp, Yp, Xp) storage array, and the JAX package's kernel gates
see those storage dims.  The port keeps compact storage and uses these two
functions as a gate only: where a grid pads, the projection and the march
take the kernels the TPU runs on the storage dims (sim/project.py,
render/slicecomp.py), as their compact forms.  On the logical grid that is
exact: a clamp at the logical edge is the compact clamp, and ghost cells
carry zero weight.  No padded layout is ported (ROADMAP.md, "Do not
port").
"""

from __future__ import annotations

from typing import Optional, Tuple


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def padded_zyx(config) -> Optional[Tuple[int, int, int]]:
    """The TPU's storage dims (Zp, Yp, Xp) where it pads this grid, else
    None: 3D, x >= 96, and not already x % 128, y % 8 and z % 16 clean; Z
    and Y round up to 16, X to 128."""
    if not config.is_3d:
        return None
    z, y, x = config.zyx
    if x % 128 == 0 and y % 8 == 0 and z % 16 == 0:
        return None
    if x < 96:
        return None
    return (_round_up(z, 16), _round_up(y, 16), _round_up(x, 128))


def storage_zyx(config) -> Tuple[int, int, int]:
    """The (Z, Y, X) dims the TPU allocates the state with."""
    return padded_zyx(config) or config.zyx
