"""The application engine: per-frame host math + simulate + render (mirror
of fluidx12_tpu/engine/fluidx.py).

`FluidXEngine(config, radiance=None, device="cuda")` owns the camera,
the state on `device` (the card unless the caller names another), the
light probe and the per-frame parameters; `step_frame()` advances the
simulation one step and returns the (H, W, 3) f32 image on the same device,
rendered by `render_method` (`next_method` / `prev_method` cycle the four,
as the reference's hotkeys do).
`radiance` is the probe's (6, S, S, 3) cube map as a numpy array (the JAX
package's `assets/rnl_cross.npz` holds one); with a config that has a
light probe it lights the smoke with SH GI and draws the sky.  PyTorch runs
eagerly, so there is no program cache: what the JAX engine keys its jit
cache on (render method, LOD, face mask, DIRECT base plane, scissor rect)
are plain arguments here.  Configurations the port does not cover yet
raise NotImplementedError at construction (a DIRECT frame with the eye
inside the volume, in `step_frame`), naming their ROADMAP.md item; nothing
falls back to another path.  The config's kernel switches are read as the JAX package
reads them on its TPU: `pallas_jacobi` and `mg_project_fused` choose the
projection's kernels (sim/project.py; a grid the TPU stores padded reads
`use_pallas` alone there), `advect_fuse_xy` B1 or B11 twice
(sim/advect_fast.py); `use_pallas=False`, `pallas_advect=False` and
`block_resolve=True` select code the port does not have, and raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from fluidx12_tpu_torch.core import math3d as m3
from fluidx12_tpu_torch.core.camera import OrbitCamera
from fluidx12_tpu_torch.core.config import FaceCullMode, FluidConfig, RenderMethod
from fluidx12_tpu_torch.core.lod import estimate_cube_map_lod, gen_visibility_mask
from fluidx12_tpu_torch.core.state import (
    make_initial_state,
    pack_scene_params_host,
    unpack_scene_params,
)
from fluidx12_tpu_torch.gi.sh import project_cubemap_sh
from fluidx12_tpu_torch.render.environment import render_environment
from fluidx12_tpu_torch.render.pipeline import render_frame, unported_render
from fluidx12_tpu_torch.render.screencomp import direct_plane_spec
from fluidx12_tpu_torch.sim.step import simulate, unported_sim


def unported(config: FluidConfig) -> Optional[str]:
    """The ROADMAP item this config still needs, or None (on the CPU and on
    the card alike)."""
    return unported_sim(config) or unported_render(config, None)


class FluidXEngine:
    """Owns config, camera and state; one `step_frame` per frame."""

    def __init__(self, config: FluidConfig, radiance: Optional[np.ndarray] = None,
                 device="cuda"):
        self.config = config.validate()
        self.device = torch.device(device)
        missing = unported(self.config)
        if missing is not None:
            raise NotImplementedError(f"not ported yet: {missing}")
        # Full f32 matmuls and convolutions: TF32 keeps ~3 decimal digits.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.camera = OrbitCamera(width=config.viewport[0], height=config.viewport[1],
                                  fov_y=config.fov_y, z_near=config.z_near,
                                  z_far=config.z_far)
        self.world = m3.scaling(config.volume_scale)
        self.world_i = m3.inverse(self.world)
        self.state = make_initial_state(self.config, self.device)
        self.render_method = RenderMethod.RAY_MARCH_SEPARATE
        self.is_paused = False
        self.frame_index = 0
        # Per-pose caches of the packed parameters and the scissor rect (the
        # packed upload freezes BaseSeed on a static camera, as in the JAX
        # engine; no kernel reads it).
        self._frame_key = None
        self._frame_cache: Optional[Tuple[torch.Tensor, int, Optional[int]]] = None
        self._rect_key = None
        self._rect_cache = None
        self._plane_key = None
        self._plane_cache = None
        # The light probe: SH coefficients once, at start-up (ref: TransformSH
        # on the first frame, FluidX12.cpp:455-461); the sky per camera pose.
        self.radiance = None
        self.sh_coeffs = None
        if radiance is not None and self.config.has_light_probe:
            self.radiance = torch.from_numpy(np.asarray(radiance, np.float32)).to(self.device)
            self.sh_coeffs = project_cubemap_sh(self.radiance, order=3)[:9]
        self._env_key = None
        self._env_cache = None

    def _time_step(self) -> float:
        return 0.0 if self.is_paused else self.config.time_step

    def update_frame(self) -> Tuple[torch.Tensor, int, Optional[int]]:
        """(packed params on the device, cube-map LOD, static face mask or
        None under FaceCullMode.NONE); ref Fluid::UpdateFrame."""
        cfg = self.config
        dt = self._time_step()
        pose = (dt, self.camera.view.tobytes(), self.camera.proj.tobytes())
        if pose == self._frame_key and self._frame_cache is not None:
            return self._frame_cache
        wvp = self.world @ self.camera.view_proj
        wvp_i = m3.inverse(wvp)
        screen_to_world = m3.inverse(self.camera.view_proj)
        lod, ray_samples = 0, cfg.max_ray_samples
        mask = 0b111111
        if cfg.is_3d:
            lod, ray_samples = estimate_cube_map_lod(
                cfg.max_ray_samples, cfg.num_cube_mips, float(cfg.cube_map_size),
                wvp, cfg.viewport)
            mask = gen_visibility_mask(self.world_i, self.camera.eye)
        flat = pack_scene_params_host(
            dt, (self.frame_index * 2654435761) % (1 << 24),
            np.asarray(self.camera.eye, np.float32),
            np.array(cfg.light_pos, np.float32),
            np.array(cfg.light_color, np.float32),
            np.array(cfg.ambient, np.float32),
            self.world, self.world_i, wvp, wvp_i, screen_to_world,
            ray_samples, cfg.max_light_samples, mask)
        vis_mask = None if cfg.face_cull == FaceCullMode.NONE else mask
        self._frame_key = pose
        self._frame_cache = (torch.from_numpy(flat).to(self.device), lod, vis_mask)
        return self._frame_cache

    def _screen_rect(self):
        """Host-static screen bbox of the volume (core.lod.screen_bbox),
        cached on the camera pose; None in 2D."""
        if not self.config.is_3d:
            return None
        pose = (self.camera.view.tobytes(), self.camera.proj.tobytes())
        if pose == self._rect_key:
            return self._rect_cache
        from fluidx12_tpu_torch.core.lod import screen_bbox

        self._rect_key = pose
        self._rect_cache = screen_bbox(self.world @ self.camera.view_proj,
                                       self.config.viewport)
        return self._rect_cache

    def _direct_plane_spec(self, lod: int = 0):
        """The DIRECT methods' base plane (render/screencomp.DirectPlaneSpec)
        for the camera pose, or None with the eye inside the volume; host
        math, cached on the pose and `lod`.  Each LOD level halves the
        plane's texel density (ref: the LOD-clamped sample count binding,
        Fluid.cpp:968; engine/fluidx.py:222-249)."""
        if not self.config.is_3d:
            return None
        pose = (self.camera.view.tobytes(), self.camera.proj.tobytes(), lod)
        if pose == self._plane_key:
            return self._plane_cache
        local_eye = (np.append(np.asarray(self.camera.eye, np.float64), 1.0)
                     @ self.world_i)[:3]
        self._plane_key = pose
        self._plane_cache = direct_plane_spec(
            local_eye, self.world @ self.camera.view_proj, self.config.viewport,
            self.config, density_scale=1.0 / (1 << lod))
        return self._plane_cache

    def _env_bg(self, params) -> Optional[torch.Tensor]:
        """The sky behind the volume, rendered once per camera pose (it
        depends on the pose and the probe, not on the state); None without
        a probe or in 2D."""
        if self.radiance is None or not self.config.is_3d:
            return None
        pose = (self.camera.view.tobytes(), self.camera.proj.tobytes())
        if pose != self._env_key:
            self._env_key = pose
            self._env_cache = render_environment(self.radiance, params, self.config)
        return self._env_cache

    def step_frame(self) -> torch.Tensor:
        """One full frame; returns the (H, W, 3) f32 image on the device."""
        packed, lod, vis_mask = self.update_frame()
        params = unpack_scene_params(packed)
        plane_spec = (None if self.render_method.uses_cube_map
                      else self._direct_plane_spec(lod))
        self.state = simulate(self.state, self._time_step(), self.config)
        image = render_frame(self.state.color, params, self.config, self.render_method,
                             self.sh_coeffs, lod=lod, vis_mask=vis_mask,
                             plane_spec=plane_spec, rect=self._screen_rect(),
                             env_bg=self._env_bg(params))
        self.frame_index += 1
        return image

    # The render-method hotkeys (ref: FluidX12.cpp:311-334).
    def next_method(self):
        self.render_method = self.render_method.next()

    def prev_method(self):
        self.render_method = self.render_method.prev()
