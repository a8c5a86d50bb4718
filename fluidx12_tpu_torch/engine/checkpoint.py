"""Checkpoint / resume of the simulation state and the session around it
(mirror of fluidx12_tpu/engine/checkpoint.py).

The archive is the JAX package's `.npz`, so that a session saved by either
package resumes in the other: velocity, colour and pressure widened to f32
(bf16 has no stable `.npz` form; the widening is exact), `store_dtype`,
and for a session the frame index, the camera's view and eye, the render
method, the pause flag and a config fingerprint.

Two things keep the archives interchangeable.  The fingerprint is the JAX
string, byte for byte: its dtype reads as the JAX package writes it
(`"<class 'jax.numpy.bfloat16'>"`), never as torch does.  And on grids the
TPU stores padded (core/padding.py) the JAX archive holds storage-sized
arrays: the port pads its compact state with zeros to those dims on save
and crops an archive to the logical grid on load.
"""

from __future__ import annotations

import numpy as np
import torch

from fluidx12_tpu_torch.core.padding import storage_zyx
from fluidx12_tpu_torch.core.state import FluidState

# Each storage dtype by the names the JAX package writes: `store_dtype`
# (str of a numpy dtype) and the fingerprint's `str(config.sim_dtype)`.
_STORE_NAME = {torch.bfloat16: "bfloat16", torch.float32: "float32",
               torch.float16: "float16"}
_FINGERPRINT_NAME = {dt: f"<class 'jax.numpy.{name}'>" for dt, name in _STORE_NAME.items()}
_STORE_DTYPE = {name: dt for dt, name in _STORE_NAME.items()}


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    """bf16 has no stable .npz round-trip; widen losslessly."""
    x = x.detach()
    if x.dtype in (torch.bfloat16, torch.float16):
        x = x.float()
    return x.cpu().numpy()


def _pad(a: np.ndarray, zyx) -> np.ndarray:
    """(..., Z, Y, X) -> (..., Zp, Yp, Xp), origin-anchored, ghosts zero
    (fluidx12_tpu/core/padding.pad_to_storage)."""
    if tuple(a.shape[-3:]) == tuple(zyx):
        return a
    pad = [(0, 0)] * (a.ndim - 3) + [(0, n - m) for n, m in zip(zyx, a.shape[-3:])]
    return np.pad(a, pad)


def _arrays(state: FluidState, zyx) -> dict:
    return dict(velocity=_pad(_to_numpy(state.velocity), zyx),
                color=_pad(_to_numpy(state.color), zyx),
                pressure=_pad(_to_numpy(state.pressure), zyx),
                store_dtype=np.str_(_STORE_NAME[state.fields.dtype]))


def save_state(path: str, state: FluidState) -> None:
    """The state alone, as it is stored."""
    np.savez_compressed(path, **_arrays(state, tuple(state.pressure.shape)))


def load_state(path: str, device="cpu", config=None) -> FluidState:
    """Load a checkpoint onto `device` in its stored dtype.  With `config`,
    an archive of the logical grid or of the dims the JAX package stores
    it with (cropped to the logical grid) is taken, and any other grid
    fails with a clear message."""
    with np.load(path) as data:
        store = (_STORE_DTYPE[str(data["store_dtype"])] if "store_dtype" in data
                 else torch.float32)
        vel, col, pres = data["velocity"], data["color"], data["pressure"]
    if config is not None:
        got = tuple(pres.shape)
        if got not in (tuple(config.zyx), tuple(storage_zyx(config))):
            raise ValueError(
                f"checkpoint grid {got} (Z, Y, X) does not match configured grid "
                f"{tuple(config.zyx)}; pass a matching --gridSize or a different "
                f"--restore file")
        z, y, x = config.zyx
        vel, col, pres = vel[..., :z, :y, :x], col[..., :z, :y, :x], pres[:z, :y, :x]
    fields = torch.from_numpy(np.concatenate([vel, col]).astype(np.float32))
    return FluidState(fields=fields.to(device=device, dtype=store),
                      pressure=torch.from_numpy(np.array(pres, np.float32)).to(device))


def _config_fingerprint(config) -> str:
    """The config fields a resumed session must agree on to continue the
    same trajectory (grid/dtype/solver schedule), as the JAX package
    writes them; rendering knobs like the viewport may differ."""
    return "|".join(str(v) for v in (
        config.grid_size, _FINGERPRINT_NAME[config.sim_dtype], config.advect_substeps,
        config.num_pressure_iters, config.mg_pressure, config.mg_min_plane,
        config.fast_sim, config.dissipation, config.impulse_pos,
        config.impulse_radius,
    ))


def save_session(path: str, engine) -> None:
    """FluidState + frame index, camera pose, render method, pause flag and
    config fingerprint: everything needed to resume the session."""
    np.savez_compressed(
        path,
        **_arrays(engine.state, storage_zyx(engine.config)),
        frame_index=np.int64(engine.frame_index),
        camera_view=np.asarray(engine.camera.view, np.float64),
        camera_eye=np.asarray(engine.camera.eye, np.float64),
        render_method=np.int32(int(engine.render_method.value)),
        is_paused=np.bool_(engine.is_paused),
        config_fp=np.str_(_config_fingerprint(engine.config)),
    )


def load_session(path: str, engine) -> None:
    """Restore a session checkpoint into `engine` (in place).  The state is
    assigned through `engine.state`, which copies it into the buffers that
    captured frames read.  State-only archives restore the fluid and leave
    the session fields as they are.  A grid or fingerprint mismatch raises
    before anything changes."""
    from fluidx12_tpu_torch.core.config import RenderMethod

    cfg = engine.config
    state = load_state(path, engine.device, cfg)
    if state.fields.dtype != cfg.sim_dtype:
        raise ValueError(f"checkpoint stores {state.fields.dtype}, this session "
                         f"{cfg.sim_dtype}")
    with np.load(path) as data:
        extras = {k: data[k] for k in data.files if k not in ("velocity", "color", "pressure")}
    if "config_fp" in extras:
        fp_saved = str(extras["config_fp"])
        fp_here = _config_fingerprint(cfg)
        if fp_saved != fp_here:
            raise ValueError(
                "checkpoint config fingerprint does not match this "
                f"session:\n  saved: {fp_saved}\n  here:  {fp_here}\n"
                "pass the matching sim flags (grid/dtype/solver) or a "
                "different --restore file")
    engine.state = state
    if "frame_index" in extras:
        engine.frame_index = int(extras["frame_index"])
    if "camera_view" in extras:
        # Restore in the camera's own dtype (float32): the f64 archive
        # round-trip is lossless, but f64 matrices would shift the host
        # matrix math by an ulp and break a bit-identical resume.
        vdt = engine.camera.view.dtype
        engine.camera.view = np.asarray(extras["camera_view"], vdt)
        engine.camera.eye = np.asarray(extras["camera_eye"], vdt)
    if "render_method" in extras:
        engine.render_method = RenderMethod(int(extras["render_method"]))
    if "is_paused" in extras:
        engine.is_paused = bool(extras["is_paused"])
