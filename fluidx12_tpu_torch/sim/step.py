"""One full simulation step: advect then project (mirror of
fluidx12_tpu/sim/step.py): the fast advect (kernels B1 and B2, or B11, or
with `use_pallas=False` or `pallas_advect=False` its f32 XLA twin) or,
with `fast_sim=False`, the faithful gather advect of sim/advect.py; then
the projection, which reads `fast_sim` itself (no multigrid when off)."""

from __future__ import annotations

from typing import Optional

import torch

from fluidx12_tpu_torch.core.config import FluidConfig
from fluidx12_tpu_torch.core.constants import device_constant
from fluidx12_tpu_torch.core.state import FluidState
from fluidx12_tpu_torch.sim.project import project


def simulate(state: FluidState, time_step: float, config: FluidConfig,
             dt: Optional[torch.Tensor] = None) -> FluidState:
    """Advect + project the combined (7, Z, Y, X) state.  Arithmetic runs
    in f32 and the result rounds to the storage dtype once, at the end.
    `time_step` is the host value of dt (0 when paused), which picks the
    projection's branch; `dt` the same value as an f32 scalar on the
    state's device (the engine passes the packed parameters' `time_step`),
    by default a constant made once per value."""
    store = state.fields.dtype
    if dt is None:
        dt = device_constant(float(time_step), torch.float32, state.fields.device)
    if config.fast_sim:
        from fluidx12_tpu_torch.sim.advect_fast import advect_fields_fast

        fields = advect_fields_fast(state.fields, dt, config)
    else:
        # The gather advect returns f32 (so does the fast advect's twin):
        # the projection runs on f32 fields and the state rounds once,
        # below (sim/step.py:44-51).
        from fluidx12_tpu_torch.sim.advect import advect

        velocity, color = advect(state.fields[:3], state.fields[3:], dt, config)
        fields = torch.cat([velocity, color])
    fields, pressure = project(fields, state.pressure, time_step, config)
    return FluidState(fields=fields.to(store), pressure=pressure)
