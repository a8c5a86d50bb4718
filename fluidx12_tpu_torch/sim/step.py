"""One full simulation step: advect then project (mirror of
fluidx12_tpu/sim/step.py on the fast stack)."""

from __future__ import annotations

import torch

from fluidx12_tpu_torch.core.config import FluidConfig
from fluidx12_tpu_torch.core.state import FluidState
from fluidx12_tpu_torch.sim.project import project


def simulate(state: FluidState, time_step: float, config: FluidConfig) -> FluidState:
    """Advect + project the combined (7, Z, Y, X) state.  Arithmetic runs
    in f32 and the result rounds to the storage dtype once, at the end.
    `time_step` is the host value of dt (0 when paused)."""
    if not config.fast_sim:
        raise NotImplementedError(
            "the faithful gather advect (fast_sim=False) is not ported yet "
            "(ROADMAP.md queue A, 'The faithful simulation')")
    from fluidx12_tpu_torch.sim.advect_fast import advect_fields_fast

    store = state.fields.dtype
    dt = torch.tensor(float(time_step), dtype=torch.float32, device=state.fields.device)
    fields = advect_fields_fast(state.fields, dt, config)
    fields, pressure = project(fields, state.pressure, time_step, config)
    return FluidState(fields=fields.to(store), pressure=pressure)
