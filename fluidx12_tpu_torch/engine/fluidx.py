"""The application engine: per-frame host math + simulate + render (mirror
of fluidx12_tpu/engine/fluidx.py).

`FluidXEngine(config, radiance=None, device="cuda")` owns the camera,
the state on `device` (the card unless the caller names another), the
light probe and the per-frame parameters; `step_frame()` advances the
simulation one step and returns the (H, W, 3) f32 image on the same device,
rendered by `render_method` (`next_method` / `prev_method` cycle the four,
as the reference's hotkeys do; `toggle_pause` is the pause key).
`step_frames(k)` runs k frames and returns their (k, H, W, 3) images.
`radiance` is the probe's (6, S, S, 3) cube map as a numpy array (the JAX
package's `assets/rnl_cross.npz` holds one); with a config that has a
light probe it lights the smoke with SH GI and draws the sky.

The frame as one program.  The JAX engine jits a frame once per key
(render method, LOD, face mask, DIRECT base plane, scissor rect) and runs
it as one donated program.  On the card this engine captures a frame as
one CUDA graph per key, the JAX key plus the pause state (the projection
branches on the host dt): a key's first frame runs op by op and is then
captured, and its later frames replay the graph.  The graph reads the
state, the packed parameters, the SH coefficients and the sky from
tensors that live as long as the engine, and writes the new state back
into them; the host work between frames (the parameters, the sky, the
base plane and the rect, each refreshed only when the pose changes) copies
into those tensors outside the graph.  All of an engine's graphs share
one memory pool and replay one at a time on one stream.  A replay runs no
kernel wrapper, so it adds the launches its capture counted to
`ops/cuda.launch_counts()`.  A capture or a replay that fails raises;
nothing falls back to launching op by op.  On the CPU there is no graph:
every frame runs op by op (`_frame_eager`, which is also what a graph
captures).

The fast and faithful stacks.  `fast_sim` and `fast_render` choose the
simulation's advect and the render stack as in the JAX package;
`toggle_ez()` flips both (the reference's 'X' hotkey) and drops every
captured graph, since the key does not hold the config.  The faithful
render stack (kernels R1 and R2) also serves what the fast one cannot: a
DIRECT frame with the eye inside the volume (no base plane) and a point
light inside the volume (which warns once).

A configuration the port does not cover (`block_resolve=True`, ROADMAP.md
'Do not port') raises NotImplementedError at construction, naming its
ROADMAP.md item; nothing falls back to another path.  The config's kernel
switches are read as the JAX package reads them on its TPU:
`pallas_jacobi` and `mg_project_fused` choose the projection's kernels
(sim/project.py; a grid the TPU stores padded reads `use_pallas` alone
there), `advect_fuse_xy` B1 or B11 twice (sim/advect_fast.py), and
`use_pallas=False` or `pallas_advect=False` the JAX package's XLA twins
in plain torch, the f32 advect twin and (`use_pallas=False`) the einsum
sweep and march (render/lightmap_sweep.py, render/slicecomp.py).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from fluidx12_tpu_torch.core import math3d as m3
from fluidx12_tpu_torch.core.camera import OrbitCamera
from fluidx12_tpu_torch.core.config import FaceCullMode, FluidConfig, RenderMethod
from fluidx12_tpu_torch.core.lod import estimate_cube_map_lod, gen_visibility_mask
from fluidx12_tpu_torch.core.state import (
    FluidState,
    make_initial_state,
    pack_scene_params_host,
    unpack_scene_params,
)
from fluidx12_tpu_torch.gi.sh import project_cubemap_sh
from fluidx12_tpu_torch.render.environment import render_environment
from fluidx12_tpu_torch.render.pipeline import point_light_ok, render_frame, unported_render
from fluidx12_tpu_torch.render.screencomp import direct_plane_spec
from fluidx12_tpu_torch.sim.step import simulate


def unported(config: FluidConfig) -> Optional[str]:
    """The ROADMAP item this config still needs, or None (on the CPU and on
    the card alike)."""
    return unported_render(config)


class _FrameGraph(NamedTuple):
    """One key's captured frame."""

    graph: "torch.cuda.CUDAGraph"
    image: torch.Tensor  # the graph's output, overwritten by every replay
    launches: dict       # kernel launches of one replay, by wrapper


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
        # The state's buffers: every frame reads and writes these tensors.
        self._state = make_initial_state(self.config, self.device)
        self.render_method = RenderMethod.RAY_MARCH_SEPARATE
        self.is_paused = False
        self.frame_index = 0
        # Per-pose caches of the packed parameters and the scissor rect (the
        # packed upload freezes BaseSeed on a static camera, as in the JAX
        # engine; no kernel reads it).  The packed parameters and the sky
        # are copied into one tensor each, made at their first upload.
        self._params_key = None
        self._params_cache: Optional[Tuple[torch.Tensor, int, Optional[int]]] = None
        self._packed: Optional[torch.Tensor] = None
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
        self._env: Optional[torch.Tensor] = None
        # The card's captured frames by key (`_prepare`), in one pool.
        self._graphs = {}
        self._pool = None
        self._warned_point_light = False

    @property
    def state(self) -> FluidState:
        """The simulation state, in buffers that live as long as the engine."""
        return self._state

    @state.setter
    def state(self, state: FluidState) -> None:
        """Copy `state` (fields and pressure of this config's shapes) into
        the engine's buffers, which a captured frame reads by address."""
        for dst, src in zip(self._state, state):
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"state: expected {tuple(dst.shape)}, got {tuple(src.shape)}")
        self._store(state)

    def _store(self, state: FluidState) -> None:
        for dst, src in zip(self._state, state):
            if src is not dst:
                dst.copy_(src)

    def _time_step(self) -> float:
        return 0.0 if self.is_paused else self.config.time_step

    def update_frame(self) -> Tuple[torch.Tensor, int, Optional[int]]:
        """(packed params on the device, cube-map LOD, static face mask or
        None under FaceCullMode.NONE); ref Fluid::UpdateFrame."""
        cfg = self.config
        dt = self._time_step()
        pose = (dt, self.camera.view.tobytes(), self.camera.proj.tobytes())
        if pose == self._params_key and self._params_cache is not None:
            return self._params_cache
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
        if self._packed is None:
            self._packed = torch.from_numpy(flat).to(self.device)
        else:
            self._packed.copy_(torch.from_numpy(flat))
        self._params_key = pose
        self._params_cache = (self._packed, lod, vis_mask)
        return self._params_cache

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
        for the camera pose, or None: off the fast stack, for a point light
        inside the volume, and with the eye inside the volume (the faithful
        march then renders the frame); host math, cached on the pose and
        `lod`.  Each LOD level halves the plane's texel density (ref: the
        LOD-clamped sample count binding, Fluid.cpp:968;
        engine/fluidx.py:222-249)."""
        cfg = self.config
        if not (cfg.fast_render and cfg.is_3d) or not point_light_ok(cfg):
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
        depends on the pose and the probe, not on the state) into the
        engine's one sky tensor; None without a probe or in 2D."""
        if self.radiance is None or not self.config.is_3d:
            return None
        pose = (self.camera.view.tobytes(), self.camera.proj.tobytes())
        if pose != self._env_key:
            self._env_key = pose
            sky = render_environment(self.radiance, params, self.config)
            if self._env is None:
                self._env = sky
            else:
                self._env.copy_(sky)
        return self._env

    def _prepare(self) -> tuple:
        """A frame's host work: the packed parameters, the base plane, the
        scissor rect and the sky, each refreshed where the pose changed.
        Returns the frame's key (method, LOD, face mask, plane spec, rect,
        paused), the JAX engine's program key with the pause state added."""
        cfg = self.config
        if cfg.fast_render and not point_light_ok(cfg) and not self._warned_point_light:
            self._warned_point_light = True
            warnings.warn("point_light with the light inside the volume: the projective "
                          "sweep needs an exterior light; using the faithful per-ray "
                          "paths.", stacklevel=3)
        packed, lod, vis_mask = self.update_frame()
        method = self.render_method
        plane_spec = None if method.uses_cube_map else self._direct_plane_spec(lod)
        self._env_bg(unpack_scene_params(packed))
        return (method, lod, vis_mask, plane_spec, self._screen_rect(), self.is_paused)

    def _device_frame(self, key: tuple) -> torch.Tensor:
        """A frame's device work on the engine's tensors: simulate, write
        the state back into its buffers, render; returns the image."""
        method, lod, vis_mask, plane_spec, rect, paused = key
        cfg = self.config
        params = unpack_scene_params(self._packed)
        self._store(simulate(self._state, 0.0 if paused else cfg.time_step, cfg,
                             dt=params.time_step))
        return render_frame(self._state.color, params, cfg, method, self.sh_coeffs,
                            lod=lod, vis_mask=vis_mask, plane_spec=plane_spec, rect=rect,
                            env_bg=self._env)

    def _frame_eager(self) -> torch.Tensor:
        """One frame launched op by op: the CPU's frame, and on the card the
        frame a graph captures."""
        image = self._device_frame(self._prepare())
        self.frame_index += 1
        return image

    def _capture(self, key: tuple) -> _FrameGraph:
        """Capture the frame of `key` as a CUDA graph in the engine's pool.
        Capture records the launches without running them, so the state
        does not advance; the launches the wrappers counted are taken back
        out of the counts."""
        from fluidx12_tpu_torch.ops.cuda import add_launch_counts, launch_counts

        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                image = self._device_frame(key)
        finally:
            launches = {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}
            add_launch_counts(launches, -1)
        return _FrameGraph(graph, image, launches)

    def _run(self, key: tuple) -> torch.Tensor:
        """One frame of `key` on the card: its graph's replay, or on the
        key's first frame the frame op by op followed by its capture.  The
        image returned by a replay is the graph's output, which the next
        replay overwrites."""
        from fluidx12_tpu_torch.ops.cuda import add_launch_counts

        frame = self._graphs.get(key)
        if frame is None:
            image = self._device_frame(key)
            self._graphs[key] = self._capture(key)
            return image
        frame.graph.replay()
        add_launch_counts(frame.launches)
        return frame.image

    def step_frame(self) -> torch.Tensor:
        """One full frame; returns the (H, W, 3) f32 image on the device (on
        the card, a copy out of the key's graph)."""
        if self.device.type != "cuda":
            return self._frame_eager()
        image = self._run(self._prepare()).clone()
        self.frame_index += 1
        return image

    def step_frames(self, k: int) -> torch.Tensor:
        """`k` frames; returns their (k, H, W, 3) images.  The frames are
        those of `k` step_frame calls, as the JAX engine's scan of `k`
        frames is (fluidx12_tpu/engine/fluidx.py:291-308).  On the card
        the key's graph replays `k` times, each image copied into its
        slot: `k` graph launches, not one graph of `k` frames, which would
        take `k` times a frame's capture time and memory."""
        if k <= 1:
            return self.step_frame()[None]
        key = self._prepare()
        run = self._run if self.device.type == "cuda" else self._device_frame
        images = None
        for i in range(k):
            image = run(key)
            if images is None:
                images = torch.empty((k,) + tuple(image.shape), dtype=image.dtype,
                                     device=image.device)
            images[i].copy_(image)
        self.frame_index += k
        return images

    # The hotkeys (ref: FluidX12.cpp:311-334).
    def toggle_pause(self):
        self.is_paused = not self.is_paused

    def next_method(self):
        self.render_method = self.render_method.next()

    def prev_method(self):
        self.render_method = self.render_method.prev()

    def toggle_ez(self) -> bool:
        """Switch between the fast and the faithful stacks: flips
        `fast_render` and `fast_sim` together (the reference's 'X' hotkey,
        FluidX12.cpp:330-332; engine/fluidx.py:320-335) and drops every
        captured frame graph, whose key does not hold the config.  Returns
        the new fast-stack state."""
        fast = not self.config.fast_render
        self.config = dataclasses.replace(self.config, fast_render=fast, fast_sim=fast)
        self._graphs.clear()
        return fast
