"""The port's frame program against the JAX engine's, on the CPU:
`step_frames(k)`, `toggle_pause`, and a steady frame that makes no tensor
from host data.  On the CPU the port's engine runs every frame op by op
(`_frame_eager`); on the card it replays one CUDA graph a key, which
tests/test_torch_cuda.py and chip_smoke.py hold to the eager frame.

The JAX engine runs its own program (its jit of a frame, its scan of k
frames), with its `simulate` composed as its TPU runs it: the advect
kernels (`backtrace_pallas`, interpret mode) and the projection, so that
both sides clamp at the walls (ROADMAP.md C1).  Both engines start from
one state that the port makes, and the JAX program is compiled once.
"""

import importlib
import traceback

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluidx12_tpu.core.config import FluidConfig
from fluidx12_tpu.core.state import FluidState as JaxState
from fluidx12_tpu.engine import fluidx as jax_fluidx
from fluidx12_tpu.ops.pallas.advect import backtrace_pallas, zpass_forces_supported
from fluidx12_tpu.sim.advect import apply_impulse_forces as jax_forces
from fluidx12_tpu_torch.core.config import FluidConfig as TorchConfig
from fluidx12_tpu_torch.core.config import RenderMethod as TorchMethod
from fluidx12_tpu_torch.engine import fluidx as torch_fluidx
from fluidx12_tpu_torch.utils.image import to_srgb_u8

jax_project = importlib.import_module("fluidx12_tpu.sim.project").project

# Several pytest workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)

# tests/test_golden.py's 24^3 case: 64^2 viewport, 32 ray and 8 light
# samples, 16 Jacobi sweeps.
GOLDEN = dict(grid_size=(24, 24, 24), viewport=(64, 64), max_ray_samples=32,
              max_light_samples=8, num_pressure_iters=16)
# tests/test_torch_frame.py's grid: the multigrid projection's twins, the
# forces fused into the z pass on both sides.
FRAME = dict(grid_size=(128, 128, 16), viewport=(64, 64), pallas_jacobi=False)
WARMUP = 4
K = 4


def channel_ulps(a, b) -> float:
    """Largest |a - b| per channel in bf16 ulps at the channel's scale."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    axes = tuple(range(1, a.ndim))
    mag = np.maximum(np.abs(a).max(axis=axes, keepdims=True),
                     np.abs(b).max(axis=axes, keepdims=True))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7.0)
    return float((np.abs(a - b) / ulp).max())


def _u8(images) -> np.ndarray:
    return to_srgb_u8(np.asarray(images)).astype(np.int32)


def _tpu_simulate(state, time_step, config):
    """The JAX step as its TPU runs it at this grid: the advect kernels,
    the forces as their own pass where the z pass does not fuse them, then
    the projection (tests/test_torch_sim.py)."""
    if zpass_forces_supported(config):
        fields = backtrace_pallas(state.fields, time_step, config, forces_dt=time_step)
    else:
        bt = backtrace_pallas(state.fields, time_step, config)
        vel, col = jax_forces(bt[:3], bt[3:], time_step, config)
        fields = jnp.concatenate([vel, col])
    fields, pressure = jax_project(fields, state.pressure, time_step, config)
    return JaxState(fields=fields.astype(state.fields.dtype), pressure=pressure)


@pytest.fixture(scope="module")
def runs():
    """The port and the JAX engine from the port's state after WARMUP
    frames: K frames by `step_frames(K)`; then `toggle_pause` and K more
    frames of the JAX engine (its compiled scan again) and one of the
    port.  A second port engine runs the first K frames as `step_frame`
    calls from the same state.  Returns a dict of images and states."""
    cfg, tcfg = FluidConfig(**FRAME), TorchConfig(**FRAME)
    port = torch_fluidx.FluidXEngine(tcfg, device="cpu")
    for _ in range(WARMUP):
        port.step_frame()
    seq = torch_fluidx.FluidXEngine(tcfg, device="cpu")
    seq.state = port.state
    seq.frame_index = port.frame_index

    saved = jax_fluidx.simulate
    jax_fluidx.simulate = _tpu_simulate
    try:
        jeng = jax_fluidx.FluidXEngine(cfg)
        jeng.state = JaxState(
            fields=jnp.asarray(port.state.fields.float().numpy()).astype(jnp.bfloat16),
            pressure=jnp.asarray(port.state.pressure.numpy()))
        jeng.frame_index = port.frame_index
        out = {"jax_run": np.asarray(jeng.step_frames(K))}
        out["jax_run_fields"] = np.asarray(jeng.state.fields.astype(jnp.float32))
        jeng.toggle_pause()
        out["jax_paused"] = np.asarray(jeng.step_frames(K))
        out["jax_paused_fields"] = np.asarray(jeng.state.fields.astype(jnp.float32))
    finally:
        jax_fluidx.simulate = saved

    out["run"] = port.step_frames(K)
    out["run_fields"] = port.state.fields.clone()
    out["seq_run"] = torch.stack([seq.step_frame() for _ in range(K)])
    out["seq_fields"] = seq.state.fields.clone()
    out["frame_index"] = (port.frame_index, seq.frame_index)
    port.toggle_pause()
    out["paused"] = port.step_frame()
    out["paused_fields"] = port.state.fields.clone()
    return out


def test_step_frames_matches_step_frame_and_the_jax_engine(runs):
    """`step_frames(4)` returns the (4, H, W, 3) images of four `step_frame`
    calls from the same state, bit for bit, and advances `frame_index` by
    4; against the JAX engine's `step_frames(4)` (its scan of four jitted
    frames) the images are within tests/test_torch_frame.py's tolerance,
    2 u8 levels with a mean below 0.05, and so are the fields after the
    four frames, within 3 bf16 ulps at each channel's scale (the port's
    f32 hand-off between B1 and B2 is one ulp a frame, ROADMAP.md C2)."""
    assert runs["run"].shape == (K, 64, 64, 3)
    assert torch.equal(runs["run"], runs["seq_run"])
    assert torch.equal(runs["run_fields"], runs["seq_fields"])
    assert runs["frame_index"] == (WARMUP + K, WARMUP + K)
    diff = np.abs(_u8(runs["run"].numpy()) - _u8(runs["jax_run"]))
    assert diff.max() <= 2 and diff.mean() < 0.05, (diff.max(), diff.mean())
    assert channel_ulps(runs["run_fields"].float().numpy(), runs["jax_run_fields"]) <= 3.0


def test_paused_frame_matches_the_jax_engine(runs):
    """After `toggle_pause` a frame leaves the state as it was (dt = 0: the
    advect moves nothing, the projection is the identity) and renders it,
    as the JAX engine's paused frames do: the port's paused frame is within
    2 u8 levels of each of the JAX engine's four, mean below 0.05, and
    neither engine's state moves."""
    assert torch.equal(runs["paused_fields"], runs["run_fields"])
    np.testing.assert_array_equal(runs["jax_paused_fields"], runs["jax_run_fields"])
    diff = np.abs(_u8(runs["paused"].numpy())[None] - _u8(runs["jax_paused"]))
    assert diff.max() <= 2 and diff.mean() < 0.05, (diff.max(), diff.mean())


# The frame paths: the cube map, a DIRECT method, 2D and the point light
# (the projective sweep); the faithful stack after `toggle_ez`, a DIRECT
# method with the eye inside the volume (the faithful march) and a point
# light inside the volume (the faithful stack).
PATHS = {
    "fluid3d": (GOLDEN, None),
    "direct": (GOLDEN, TorchMethod.RAY_MARCH_DIRECT_SEPARATE),
    "fluid2d": (dict(grid_size=(64, 64, 1), viewport=(64, 64), num_pressure_iters=16), None),
    "point_light": (dict(GOLDEN, point_light=True), None),
    "toggled": (GOLDEN, TorchMethod.RAY_MARCH_MERGED),
    "direct_eye_inside": (GOLDEN, TorchMethod.RAY_MARCH_DIRECT_MERGED),
    "interior_point_light": (dict(GOLDEN, point_light=True, light_pos=(5.0, 2.0, -3.0)), None),
}
# What each of those paths does to the engine before its frames.
SETUP = {"toggled": lambda e: e.toggle_ez(), "direct_eye_inside": lambda e: e.camera.dolly(15.5)}


@pytest.mark.parametrize("path", list(PATHS))
def test_steady_frame_makes_no_tensor_from_host_data(path, monkeypatch):
    """After two warm-up frames, a steady frame calls none of
    `torch.tensor`, `torch.as_tensor` and `torch.from_numpy` outside the
    kernels' plain versions in ops/cuda/ (which run on the CPU only): on
    the card each would be a host-to-device copy, which syncs and which a
    CUDA graph cannot capture.  The frame's constants are made once
    (core/constants.py) and its parameters copied only when the pose
    changes.  The warm-up frames make some (the parameters, the cached
    constants), which the spies must see; on every path a new pose
    uploads its parameters again."""
    kw, method = PATHS[path]
    engine = torch_fluidx.FluidXEngine(TorchConfig(**kw), device="cpu")
    if method is not None:
        engine.render_method = method
    SETUP.get(path, lambda e: None)(engine)
    callers = []

    def spy(fn):
        def wrapped(*args, **kwargs):
            # (the port's file and line that called, whether a plain
            # version of a kernel in ops/cuda/ is on the stack)
            port = [(f.filename.replace("\\", "/").split("/fluidx12_tpu_torch/")[1], f.lineno,
                     f.name) for f in traceback.extract_stack()[:-1]
                    if "/fluidx12_tpu_torch/" in f.filename.replace("\\", "/")]
            if port:
                plain = any(p.startswith("ops/cuda/") and name.endswith("_plain")
                            for p, _, name in port)
                callers.append((port[-1][0], port[-1][1], plain))
            return fn(*args, **kwargs)
        return wrapped

    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, spy(getattr(torch, name)))
    engine.update_frame()
    assert callers, "the spies see the packed parameters' upload"
    for _ in range(2):
        engine.step_frame()
    callers.clear()
    image = engine.step_frame()
    assert image.shape == (64, 64, 3)
    outside = [c for c in callers if not c[2]]
    assert outside == [], outside
    if path == "direct_eye_inside":
        assert engine._direct_plane_spec(0) is None
    # A new pose uploads its parameters again, once.
    engine.camera.orbit(5.0, 0.0)
    callers.clear()
    engine.step_frame()
    assert [c for c in callers if c[0] == "engine/fluidx.py"], callers
