"""The flagship "model": the full FluidX12 smoke pipeline as one callable
(mirror of fluidx12_tpu/models/smoke.py).

`FluidXEngine` (engine/fluidx.py) is the interactive application, which
on the card replays one CUDA graph a frame key; SmokeModel is the library
form, run op by op on an explicit device:

    model = SmokeModel(FluidConfig(), device="cuda")
    state = model.init()
    state, image = model.step(state, model.default_params())

The render dispatch is render/pipeline.render_frame, the same site the
engine runs, so the library renders what the app does
(tests/test_torch_shell.py holds the two equal per method).  The engine's
host-static per-pose extras (the DIRECT base plane, the scissor rect, the
face visibility mask) are computed here for the model's camera; pass
`camera=` for another pose.

`step` is differentiable with torch.autograd on the faithful stack, the
config the JAX package differentiates with jax.grad (README.md,
tests/test_adjoint.py): fast_sim=False, fast_render=False,
use_pallas=False, mg_pressure=False, quantize_cube_map=False (its u8
rounding has zero gradient), f32 `sim_dtype` for clean gradients:

    v = torch.zeros((3,) + cfg.zyx, device="cuda", requires_grad=True)
    st = FluidState(torch.cat([state.fields[:3] + v, state.fields[3:]]), state.pressure)
    model.step(st, params)[1].sum().backward()      # v.grad

On the CPU the plain versions differentiate; on the card R1 and R2 run as
autograd Functions whose backward kernels are R1b and R2b
(ops/cuda/raymarch.py).  The merged methods, the light probe and the fast
stack's kernels raise NotImplementedError under grad on the card
(ROADMAP.md queue A, item 6b; `ops/cuda/_build.refuse_grad`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from fluidx12_tpu_torch.core import math3d as m3
from fluidx12_tpu_torch.core.camera import OrbitCamera
from fluidx12_tpu_torch.core.config import FaceCullMode, FluidConfig, RenderMethod
from fluidx12_tpu_torch.core.state import (
    FluidState,
    SceneParams,
    make_initial_state,
    pack_scene_params_host,
    unpack_scene_params,
)
from fluidx12_tpu_torch.render.pipeline import point_light_ok, render_frame
from fluidx12_tpu_torch.sim.step import simulate


class SmokeModel:
    """Functional sim+render pipeline for one configuration on one device."""

    def __init__(
        self,
        config: FluidConfig,
        method: RenderMethod = RenderMethod.RAY_MARCH_SEPARATE,
        sh_coeffs: Optional[torch.Tensor] = None,
        lod: int = 0,
        camera: Optional[OrbitCamera] = None,
        device="cuda",
    ):
        self.config = config.validate()
        self.method = method
        self.sh_coeffs = sh_coeffs
        self.lod = lod
        self.device = torch.device(device)
        cfg = self.config
        self.camera = camera or OrbitCamera(
            width=cfg.viewport[0], height=cfg.viewport[1],
            fov_y=cfg.fov_y, z_near=cfg.z_near, z_far=cfg.z_far)
        self.world = m3.scaling(cfg.volume_scale)
        self.world_i = m3.inverse(self.world)

        # Host-static per-pose extras, as the engine's caches make them
        # (engine/fluidx.py: _screen_rect, _direct_plane_spec, update_frame),
        # valid for this camera.
        self.rect = None
        self.vis_mask = None
        self.plane_spec = None
        if cfg.is_3d:
            from fluidx12_tpu_torch.core.lod import gen_visibility_mask, screen_bbox

            wvp = self.world @ self.camera.view_proj
            self.rect = screen_bbox(wvp, cfg.viewport)
            if cfg.face_cull != FaceCullMode.NONE:
                self.vis_mask = gen_visibility_mask(self.world_i, self.camera.eye)
            if cfg.fast_render and point_light_ok(cfg) and not method.uses_cube_map:
                from fluidx12_tpu_torch.render.screencomp import direct_plane_spec

                local_eye = (np.append(
                    np.asarray(self.camera.eye, np.float64), 1.0) @ self.world_i)[:3]
                self.plane_spec = direct_plane_spec(
                    local_eye, wvp, cfg.viewport, cfg, density_scale=1.0 / (1 << lod))

    def init(self) -> FluidState:
        return make_initial_state(self.config, self.device)

    def default_params(self) -> SceneParams:
        """SceneParams for the model's camera (the app's startup view): the
        JAX package's defaults (all faces visible, max_ray_samples) with
        the camera's matrices, packed as the engine packs them."""
        cfg = self.config
        wvp = self.world @ self.camera.view_proj
        flat = pack_scene_params_host(
            cfg.time_step, 0, np.asarray(self.camera.eye, np.float32),
            np.array(cfg.light_pos, np.float32), np.array(cfg.light_color, np.float32),
            np.array(cfg.ambient, np.float32), self.world, self.world_i, wvp,
            m3.inverse(wvp), m3.inverse(self.camera.view_proj),
            cfg.max_ray_samples, cfg.max_light_samples, 0b111111)
        return unpack_scene_params(torch.from_numpy(flat).to(self.device))

    def step(self, state: FluidState, params: SceneParams) -> Tuple[FluidState, torch.Tensor]:
        """One sim+render step; returns (state, (H, W, 3) image).  The
        projection's branch reads dt on the host (one fetch a step).  The
        entry point the adjoint differentiates (module docstring)."""
        cfg = self.config
        state = simulate(state, float(params.time_step), cfg, dt=params.time_step)
        image = render_frame(state.color, params, cfg, self.method, self.sh_coeffs,
                             lod=self.lod, vis_mask=self.vis_mask,
                             plane_spec=self.plane_spec, rect=self.rect)
        return state, image
