"""One full simulation step: advect then project (mirror of
fluidx12_tpu/sim/step.py on the fast stack)."""

from __future__ import annotations

from typing import Optional

import torch

from fluidx12_tpu_torch.core.config import FluidConfig
from fluidx12_tpu_torch.core.constants import device_constant
from fluidx12_tpu_torch.core.state import FluidState
from fluidx12_tpu_torch.sim.project import project


def unported_sim(config: FluidConfig):
    """The ROADMAP item a simulation config still needs, or None.  The
    JAX package runs other code for each of these switches; the port runs
    none in its place."""
    if not config.fast_sim:
        return ("the faithful gather advect, fast_sim=False (ROADMAP.md queue A, "
                "'The faithful simulation')")
    if not (config.use_pallas and config.pallas_advect):
        return ("the mirror-addressed advect twin, use_pallas=False or "
                "pallas_advect=False (ROADMAP.md queue A, 'The XLA twins')")
    return None


def simulate(state: FluidState, time_step: float, config: FluidConfig,
             dt: Optional[torch.Tensor] = None) -> FluidState:
    """Advect + project the combined (7, Z, Y, X) state.  Arithmetic runs
    in f32 and the result rounds to the storage dtype once, at the end.
    `time_step` is the host value of dt (0 when paused), which picks the
    projection's branch; `dt` the same value as an f32 scalar on the
    state's device (the engine passes the packed parameters' `time_step`),
    by default a constant made once per value."""
    missing = unported_sim(config)
    if missing is not None:
        raise NotImplementedError(f"not ported yet: {missing}")
    from fluidx12_tpu_torch.sim.advect_fast import advect_fields_fast

    store = state.fields.dtype
    if dt is None:
        dt = device_constant(float(time_step), torch.float32, state.fields.device)
    fields = advect_fields_fast(state.fields, dt, config)
    fields, pressure = project(fields, state.pressure, time_step, config)
    return FluidState(fields=fields.to(store), pressure=pressure)
