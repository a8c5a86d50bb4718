"""Simulation state and per-frame scene parameters (torch mirror of
fluidx12_tpu/core/state.py).

Layout is the JAX package's: one combined (7, Z, Y, X) `fields` tensor in the
storage dtype ([0:3] velocity xyz, [3:7] premultiplied RGBA) and an f32
(Z, Y, X) `pressure` kept across frames for the Jacobi warm start.  Only the
compact layout exists here; the JAX package's padded storage
(core/padding.py) is a TPU tiling device and is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fluidx12_tpu_torch.core.config import FluidConfig


class FluidState(NamedTuple):
    """Persistent simulation state (everything that survives a frame)."""

    fields: torch.Tensor    # (7, Z, Y, X): [0:3] velocity xyz, [3:7] premult RGBA
    pressure: torch.Tensor  # (Z, Y, X) f32 Poisson scratch, warm start

    @property
    def velocity(self) -> torch.Tensor:
        return self.fields[:3]

    @property
    def color(self) -> torch.Tensor:
        return self.fields[3:]


class SceneParams(NamedTuple):
    """Per-frame dynamic inputs (row-vector matrices, as in the JAX package)."""

    time_step: torch.Tensor          # () f32, 0 when paused
    base_seed: torch.Tensor          # () int (parity only)
    eye_pt: torch.Tensor             # (3,)
    light_pt: torch.Tensor           # (3,)
    light_color: torch.Tensor        # (4,)
    ambient: torch.Tensor            # (4,)
    world: torch.Tensor              # (4, 4)
    world_i: torch.Tensor            # (4, 4)
    world_view_proj: torch.Tensor    # (4, 4)
    world_view_proj_i: torch.Tensor  # (4, 4)
    screen_to_world: torch.Tensor    # (4, 4)
    num_samples: torch.Tensor        # () int
    num_light_samples: torch.Tensor  # () int
    visibility_mask: torch.Tensor    # () int


def make_initial_state(config: FluidConfig, device) -> FluidState:
    """All-zero fields on `device` (compact layout)."""
    z, y, x = config.zyx
    return FluidState(
        fields=torch.zeros((7, z, y, x), dtype=config.sim_dtype, device=device),
        pressure=torch.zeros((z, y, x), dtype=torch.float32, device=device),
    )


def state_from_numpy(fields: np.ndarray, pressure: np.ndarray, device,
                     dtype: torch.dtype = torch.bfloat16) -> FluidState:
    """Carry a state across from the JAX package (or a checkpoint): `fields`
    (7, Z, Y, X) and `pressure` (Z, Y, X) as numpy arrays.  bf16 arrays
    (ml_dtypes) arrive bit-exact through an f32 widening, which bf16 -> f32
    -> bf16 round-trips exactly."""
    f = torch.from_numpy(np.array(fields, np.float32))
    p = torch.from_numpy(np.array(pressure, np.float32))
    if f.ndim != 4 or f.shape[0] != 7 or tuple(p.shape) != tuple(f.shape[1:]):
        raise ValueError(f"expected fields (7, Z, Y, X) and pressure (Z, Y, X), "
                         f"got {tuple(f.shape)} and {tuple(p.shape)}")
    return FluidState(fields=f.to(device=device, dtype=dtype),
                      pressure=p.to(device=device))


_PACKED_SIZE = 99


def pack_scene_params_host(
    time_step, base_seed, eye_pt, light_pt, light_color, ambient,
    world, world_i, world_view_proj, world_view_proj_i, screen_to_world,
    num_samples, num_light_samples, visibility_mask,
) -> np.ndarray:
    """Flatten all per-frame scalars/matrices into ONE f32 array (host side),
    so the per-frame upload is a single copy.  Integer fields ride as exact
    small floats."""
    out = np.empty(_PACKED_SIZE, np.float32)
    out[0] = time_step
    out[1] = float(int(base_seed) % (1 << 24))
    out[2:5] = eye_pt
    out[5:8] = light_pt
    out[8:12] = light_color
    out[12:16] = ambient
    out[16:32] = np.asarray(world, np.float32).ravel()
    out[32:48] = np.asarray(world_i, np.float32).ravel()
    out[48:64] = np.asarray(world_view_proj, np.float32).ravel()
    out[64:80] = np.asarray(world_view_proj_i, np.float32).ravel()
    out[80:96] = np.asarray(screen_to_world, np.float32).ravel()
    out[96] = float(num_samples)
    out[97] = float(num_light_samples)
    out[98] = float(visibility_mask)
    return out


def unpack_scene_params(flat: torch.Tensor) -> SceneParams:
    """Inverse of pack_scene_params_host on a (99,) f32 tensor (views into
    it, on its device)."""
    return SceneParams(
        time_step=flat[0],
        base_seed=flat[1].to(torch.int64),
        eye_pt=flat[2:5],
        light_pt=flat[5:8],
        light_color=flat[8:12],
        ambient=flat[12:16],
        world=flat[16:32].reshape(4, 4),
        world_i=flat[32:48].reshape(4, 4),
        world_view_proj=flat[48:64].reshape(4, 4),
        world_view_proj_i=flat[64:80].reshape(4, 4),
        screen_to_world=flat[80:96].reshape(4, 4),
        num_samples=flat[96].to(torch.int32),
        num_light_samples=flat[97].to(torch.int32),
        visibility_mask=flat[98].to(torch.int32),
    )
