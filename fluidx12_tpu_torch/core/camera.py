"""Orbit camera matching the reference app's view controls.

Reference: view init (FluidX12.cpp:246-254: eye (4, 16, -40), focus origin,
up +Y), mouse orbit (OnMouseMove, FluidX12.cpp:355-383: rotate the view matrix
about the focus point) and wheel dolly (OnMouseWheel, FluidX12.cpp:385-398).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from fluidx12_tpu_torch.core import math3d as m3


@dataclasses.dataclass
class OrbitCamera:
    width: int = 800
    height: int = 800
    fov_y: float = np.pi / 4
    z_near: float = 1.0
    z_far: float = 1000.0
    eye: np.ndarray = dataclasses.field(default_factory=lambda: np.array([4.0, 16.0, -40.0], np.float32))
    focus: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))

    def __post_init__(self):
        self.view = m3.look_at_lh(self.eye, self.focus, [0.0, 1.0, 0.0])
        aspect = self.width / float(self.height)
        self.proj = m3.perspective_fov_lh(self.fov_y, aspect, self.z_near, self.z_far)

    # -- interactions ---------------------------------------------------
    def orbit(self, dx_pixels: float, dy_pixels: float) -> None:
        """Rotate about the focus point; (dx, dy) is the mouse delta in pixels."""
        rad_x = 2.0 * np.pi * dy_pixels / self.height
        rad_y = 2.0 * np.pi * dx_pixels / self.width
        length = float(np.linalg.norm(self.focus - self.eye))
        t = m3.translation(0.0, 0.0, -length)
        t = t @ m3.rotation_roll_pitch_yaw(rad_x, rad_y, 0.0)
        t = t @ m3.translation(0.0, 0.0, length)
        self.view = self.view @ t
        self.eye = m3.inverse(self.view)[3, :3].copy()

    def dolly(self, wheel_delta: float) -> None:
        """Move along the view axis; positive delta moves toward the focus."""
        length = float(np.linalg.norm(self.focus - self.eye))
        t = m3.translation(0.0, 0.0, -length * wheel_delta / 16.0)
        self.view = self.view @ t
        self.eye = m3.inverse(self.view)[3, :3].copy()

    # -- derived matrices ----------------------------------------------
    @property
    def view_proj(self) -> np.ndarray:
        return self.view @ self.proj
