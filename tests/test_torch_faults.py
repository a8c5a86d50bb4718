"""Two of ROADMAP.md's queue C items, on the CPU: C9, the adjoint kernels'
refusal of deterministic mode (`ops/cuda/raymarch.check_deterministic`, which
R1b's and R2b's autograd backwards call before launching), and C8, a point
light inside the volume on the fast stack, which takes the faithful light
map (render/lightmap.py, kernel R2 on the card), as
render/lightmap_sweep.py's docstring says."""

import warnings

import pytest
import torch

from fluidx12_tpu_torch.core.config import FluidConfig, RenderMethod
from fluidx12_tpu_torch.engine.fluidx import FluidXEngine
from fluidx12_tpu_torch.ops.cuda import raymarch as R
from fluidx12_tpu_torch.render import pipeline

# Several pytest workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)


def test_check_deterministic_raises_or_warns():
    """Off: nothing.  `use_deterministic_algorithms(True)`: a RuntimeError
    naming the kernel, as torch's atomic CUDA backwards raise.
    `warn_only=True`: a UserWarning naming it, and no error."""
    assert not torch.are_deterministic_algorithms_enabled()
    R.check_deterministic("view_march_grad (R1b)")
    try:
        torch.use_deterministic_algorithms(True)
        with pytest.raises(RuntimeError, match=r"view_march_grad \(R1b\) does not have a "
                                               "deterministic implementation"):
            R.check_deterministic("view_march_grad (R1b)")
        torch.use_deterministic_algorithms(True, warn_only=True)
        with pytest.warns(UserWarning, match=r"light_march_grad \(R2b\)"):
            R.check_deterministic("light_march_grad (R2b)")
    finally:
        torch.use_deterministic_algorithms(False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        R.check_deterministic("light_march_grad (R2b)")


def test_interior_point_light_takes_the_faithful_light_map(monkeypatch):
    """A point light inside the volume on the fast stack (fast_render on,
    `point_sweep_supported` false) renders with the faithful per-ray light
    map, and the projective sweep does not run."""
    taken = []
    for name in ("render_light_map", "render_light_map_fast"):
        def spy(*a, _f=getattr(pipeline, name), _n=name, **k):
            taken.append(_n)
            return _f(*a, **k)
        monkeypatch.setattr(pipeline, name, spy)
    cfg = FluidConfig(grid_size=(16, 16, 16), viewport=(32, 32), max_ray_samples=16,
                      max_light_samples=4, num_pressure_iters=4, point_light=True,
                      light_pos=(5.0, 2.0, -3.0))
    engine = FluidXEngine(cfg, device="cpu")
    engine.render_method = RenderMethod.RAY_MARCH_SEPARATE
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        img = engine.step_frame()
    assert img.shape == (32, 32, 3) and taken == ["render_light_map"]
