"""The port's engine shell against the JAX package's, on the CPU: the PNG
writer, the DDS probe and BC6H decoder, the terminal preview, the config
fingerprint, the CLI's parser, the CFL guard, the hotkey camera, and
session archives that cross between the two packages (both ways, on a
compact and on a padded-storage grid).  Then the shell within the port:
a bit-identical resume, `FrameLoop` batched and not, the watchdog, the
hotkeys, `cli.main`, `profile_passes` and `SmokeModel`.

No JAX frame is compiled here: the JAX side is numpy functions and JAX
engines that are constructed, given a state and never stepped.  The port's
engine is held to the JAX engine frame by frame in
tests/test_torch_frame.py; tests/test_torch_cuda.py runs the shell on the
card.
"""

import dataclasses
import json
import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluidx12_tpu.core.config import PRESETS as JAX_PRESETS
from fluidx12_tpu.core.config import FluidConfig as JaxConfig
from fluidx12_tpu.core.config import RenderMethod as JaxMethod
from fluidx12_tpu.core.state import FluidState as JaxState
from fluidx12_tpu.engine import checkpoint as jax_ckpt
from fluidx12_tpu.engine import cli as jax_cli
from fluidx12_tpu.engine.fluidx import FluidXEngine as JaxEngine
from fluidx12_tpu.engine.frame_loop import FrameLoop as JaxLoop
from fluidx12_tpu.gi import bc6h_np as jax_bc6h
from fluidx12_tpu.gi import dds as jax_dds
from fluidx12_tpu.sim.advect_fast import max_backtrace_disp as jax_disp
from fluidx12_tpu.utils import png as jax_png
from fluidx12_tpu.utils import termview as jax_termview
from fluidx12_tpu_torch.core.config import PRESETS, FluidConfig, RenderMethod
from fluidx12_tpu_torch.core.state import FluidState
from fluidx12_tpu_torch.engine import checkpoint, cli
from fluidx12_tpu_torch.engine.fluidx import FluidXEngine
from fluidx12_tpu_torch.engine.frame_loop import FrameLoop
from fluidx12_tpu_torch.engine.profiler import profile_passes
from fluidx12_tpu_torch.gi import bc6h_np, dds
from fluidx12_tpu_torch.models import SmokeModel
from fluidx12_tpu_torch.sim.advect_fast import MAX_DISP, max_backtrace_disp
from fluidx12_tpu_torch.utils import png, termview

# Several pytest workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)

SMALL = dict(grid_size=(16, 16, 16), viewport=(24, 24), max_ray_samples=8,
             max_light_samples=4, num_pressure_iters=4)
# A grid the TPU stores padded: the JAX engine holds (32, 112, 128), the
# port (24, 100, 100).
PADDED = dict(grid_size=(100, 100, 24), viewport=(32, 32))


def test_write_png_reads_back_in_both_packages(tmp_path):
    rng = np.random.default_rng(0)
    for c in (3, 4):
        img = rng.integers(0, 256, (33, 47, c), dtype=np.uint8)
        ours, theirs = str(tmp_path / f"p{c}.png"), str(tmp_path / f"j{c}.png")
        png.write_png(ours, img)
        jax_png.write_png(theirs, img)
        for path in (ours, theirs):
            np.testing.assert_array_equal(png.read_png(path), img)
            np.testing.assert_array_equal(jax_png.read_png(path), img)
    with pytest.raises(ValueError):
        png.write_png(str(tmp_path / "bad.png"), img.astype(np.float32))


def _float_cube_dds(path, size=8):
    """A DX10 RGBA32F cube-map DDS (the recipe of tests/test_io.py)."""
    rng = np.random.default_rng(1)
    faces = rng.uniform(0, 4, (6, size, size, 4)).astype(np.float32)
    header = bytearray(148)
    header[0:4] = b"DDS "
    struct.pack_into("<7I", header, 4, 124, 0x1007, size, size, 0, 1, 1)
    struct.pack_into("<II", header, 4 + 72, 32, 0x4)
    header[4 + 80: 4 + 84] = b"DX10"
    struct.pack_into("<I", header, 4 + 108, 0x1000 | 0x8)
    struct.pack_into("<I", header, 4 + 112, 0x200 | 0xFE00)
    struct.pack_into("<5I", header, 128, 2, 3, 0x4, 1, 0)
    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(faces.tobytes())
    return faces


def test_dds_cube_and_bc6h_match_the_jax_package(tmp_path):
    path = str(tmp_path / "c.dds")
    faces = _float_cube_dds(path)
    cube = dds.load_dds_cubemap(path)
    assert cube.shape == (6, 8, 8, 3) and cube.dtype == np.float32
    np.testing.assert_array_equal(cube, jax_dds.load_dds_cubemap(path))
    np.testing.assert_array_equal(cube, faces[..., :3])
    # Seeded random blocks reach every mode the tables hold.
    rng = np.random.default_rng(2)
    blocks = rng.integers(0, 256, 16 * 16 * 12, dtype=np.uint8)
    for signed in (False, True):
        got = bc6h_np.decode_bc6h_numpy(blocks, 64, 48, signed)
        ref = jax_bc6h.decode_bc6h_numpy(blocks, 64, 48, signed)
        assert got.shape == (48, 64, 3)
        np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_halfblocks_match_the_jax_package():
    rng = np.random.default_rng(3)
    for shape in ((37, 53, 3), (1, 9, 3), (120, 200, 3)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        assert (termview.render_halfblocks(img, 40, 20)
                == jax_termview.render_halfblocks(img, 40, 20))
    assert termview.ENTER_ALT_SCREEN == jax_termview.ENTER_ALT_SCREEN


def _jax_twin(cfg: FluidConfig) -> JaxConfig:
    """The JAX config with the port config's fields (dtypes by name)."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for k in ("sim_dtype", "render_dtype"):
        fields[k] = getattr(jnp, str(fields[k]).split(".")[-1])
    return JaxConfig(**fields)


@pytest.mark.parametrize("name", ["fluid3d", "fluid2d", "fluidgi", "f32"])
def test_config_fingerprint_is_the_jax_string(name):
    if name == "f32":
        cfg = FluidConfig(grid_size=(24, 24, 24), sim_dtype=torch.float32,
                          num_pressure_iters=8, fast_sim=False)
        ref = JaxConfig(grid_size=(24, 24, 24), sim_dtype=jnp.float32,
                        num_pressure_iters=8, fast_sim=False)
    else:
        cfg, ref = PRESETS[name], JAX_PRESETS[name]
    assert _jax_twin(cfg) == ref
    assert checkpoint._config_fingerprint(cfg) == jax_ckpt._config_fingerprint(ref)


ARGVS = ([], ["--preset", "fluid2d", "--frames", "7"],
         ["--preset", "fluidgi", "--gridSize", "64", "64", "32", "--maxRaySamples", "48",
          "--maxLightSamples", "16", "--viewport", "320", "200", "--radiance", "x.dds"])


def test_parser_and_config_mirror_the_jax_cli():
    ours, theirs = cli.build_parser(), jax_cli.build_parser()

    def options(p):
        return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.nargs, a.const,
                         a.type) for a in p._actions}

    assert options(ours) == options(theirs)
    for argv in ARGVS:
        a, b = ours.parse_args(argv), theirs.parse_args(argv)
        assert vars(a) == vars(b)
        assert _jax_twin(cli.config_from_args(a)) == jax_cli.config_from_args(b)


@pytest.mark.parametrize("grid", [(24, 24, 16), (32, 32, 1)])
def test_max_backtrace_disp_matches(grid):
    cfg = FluidConfig(grid_size=grid, advect_substeps=2)
    rng = np.random.default_rng(4)
    vel = rng.normal(0.0, 3.0, (3,) + cfg.zyx).astype(np.float32)
    got = float(max_backtrace_disp(torch.from_numpy(vel), cfg.time_step, cfg))
    ref = float(jax_disp(jnp.asarray(vel), cfg.time_step, _jax_twin(cfg)))
    assert abs(got - ref) <= 2e-7 * abs(ref)
    assert MAX_DISP == 12


def test_hotkey_camera_moves_match():
    ours = FrameLoop(FluidXEngine(FluidConfig(**SMALL), device="cpu"), show_fps=False)
    theirs = JaxLoop(JaxEngine(JaxConfig(**SMALL)), show_fps=False)
    for key in "adwz+-da":
        ours._handle_key(key, None, None)
        theirs._handle_key(key, None, None)
        np.testing.assert_array_equal(ours.engine.camera.view, theirs.engine.camera.view)
        np.testing.assert_array_equal(ours.engine.camera.eye, theirs.engine.camera.eye)


def _seeded_fields(zyx, seed):
    """A bf16-exact (7, Z, Y, X) state, non-zero in 2% of its values (the
    archives are zlib-compressed, which is slow on dense bf16 data), and
    an f32 pressure."""
    rng = np.random.default_rng(seed)
    values = torch.from_numpy(rng.normal(0.0, 1.0, (7,) + zyx).astype(np.float32))
    values = values.to(torch.bfloat16).float().numpy()
    fields = np.where(rng.random((7,) + zyx) < 0.02, values, np.float32(0.0))
    return fields, rng.normal(0.0, 1.0, zyx).astype(np.float32)


def _pose(engine, method):
    engine.camera.orbit(17.0, 9.0)
    engine.camera.dolly(0.5)
    engine.render_method = method
    engine.is_paused = True
    engine.frame_index = 37


@pytest.mark.parametrize("grid", ["compact", "padded"])
def test_session_from_jax_loads_into_the_port(tmp_path, grid):
    kw = SMALL if grid == "compact" else PADDED
    jax_eng = JaxEngine(JaxConfig(**kw))
    storage = tuple(jax_eng.state.pressure.shape)
    fields, pressure = _seeded_fields(storage, 5)
    jax_eng.state = JaxState(fields=jnp.asarray(fields, jnp.bfloat16),
                             pressure=jnp.asarray(pressure))
    _pose(jax_eng, JaxMethod.RAY_MARCH_DIRECT_MERGED)
    path = str(tmp_path / "jax.npz")
    jax_ckpt.save_session(path, jax_eng)

    eng = FluidXEngine(FluidConfig(**kw), device="cpu")
    checkpoint.load_session(path, eng)
    z, y, x = eng.config.zyx
    assert (grid == "padded") == (storage != (z, y, x))
    assert eng.state.fields.dtype == torch.bfloat16
    np.testing.assert_array_equal(eng.state.fields.float().numpy(),
                                  fields[:, :z, :y, :x])
    np.testing.assert_array_equal(eng.state.pressure.numpy(), pressure[:z, :y, :x])
    np.testing.assert_array_equal(eng.camera.view, jax_eng.camera.view)
    np.testing.assert_array_equal(eng.camera.eye, jax_eng.camera.eye)
    assert eng.camera.view.dtype == np.float32
    assert eng.render_method == RenderMethod.RAY_MARCH_DIRECT_MERGED
    assert eng.is_paused and eng.frame_index == 37


@pytest.mark.parametrize("grid", ["compact", "padded"])
def test_session_from_the_port_loads_into_jax(tmp_path, grid):
    kw = SMALL if grid == "compact" else PADDED
    eng = FluidXEngine(FluidConfig(**kw), device="cpu")
    fields, pressure = _seeded_fields(eng.config.zyx, 6)
    eng.state = FluidState(torch.from_numpy(fields).to(torch.bfloat16),
                           torch.from_numpy(pressure))
    _pose(eng, RenderMethod.RAY_MARCH_MERGED)
    path = str(tmp_path / "port.npz")
    checkpoint.save_session(path, eng)

    jax_eng = JaxEngine(JaxConfig(**kw))
    jax_ckpt.load_session(path, jax_eng)
    z, y, x = eng.config.zyx
    got = np.asarray(jax_eng.state.fields, np.float32)
    assert jax_eng.state.fields.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got[:, :z, :y, :x], fields)
    np.testing.assert_array_equal(np.asarray(jax_eng.state.pressure)[:z, :y, :x], pressure)
    # Ghost cells (padded storage) are zero.
    got[:, :z, :y, :x] = 0.0
    assert not got.any()
    np.testing.assert_array_equal(jax_eng.camera.view, eng.camera.view)
    np.testing.assert_array_equal(jax_eng.camera.eye, eng.camera.eye)
    assert jax_eng.render_method == JaxMethod.RAY_MARCH_MERGED
    assert jax_eng.is_paused and jax_eng.frame_index == 37


def test_fingerprint_mismatch_raises_and_state_only_loads(tmp_path):
    cfg = FluidConfig(**SMALL)
    eng = FluidXEngine(cfg, device="cpu")
    fields, pressure = _seeded_fields(cfg.zyx, 7)
    eng.state = FluidState(torch.from_numpy(fields).to(torch.bfloat16),
                           torch.from_numpy(pressure))
    path = str(tmp_path / "sess.npz")
    checkpoint.save_session(path, eng)
    other = FluidXEngine(dataclasses.replace(cfg, num_pressure_iters=8), device="cpu")
    with pytest.raises(ValueError, match="fingerprint"):
        checkpoint.load_session(path, other)
    assert not other.state.fields.any()  # nothing changed before the raise
    with pytest.raises(ValueError, match="does not match configured grid"):
        checkpoint.load_session(path, FluidXEngine(dataclasses.replace(
            cfg, grid_size=(24, 24, 16)), device="cpu"))
    # State-only archives, from either package, load through the session path.
    for save in (lambda p: checkpoint.save_state(p, eng.state),
                 lambda p: jax_ckpt.save_state(p, JaxState(
                     fields=jnp.asarray(fields, jnp.bfloat16),
                     pressure=jnp.asarray(pressure)))):
        state_only = str(tmp_path / "state.npz")
        save(state_only)
        c = FluidXEngine(cfg, device="cpu")
        checkpoint.load_session(state_only, c)
        assert torch.equal(c.state.fields, eng.state.fields)
        assert c.frame_index == 0


def test_resumed_session_continues_bit_identical(tmp_path):
    cfg = dataclasses.replace(FluidConfig(**SMALL), sim_dtype=torch.float32)
    a = FluidXEngine(cfg, device="cpu")
    a.render_method = RenderMethod.RAY_MARCH_DIRECT_SEPARATE
    a.camera.orbit(17.0, 9.0)
    for _ in range(3):
        a.step_frame()
    path = str(tmp_path / "sess.npz")
    checkpoint.save_session(path, a)
    b = FluidXEngine(cfg, device="cpu")
    checkpoint.load_session(path, b)
    assert b.frame_index == a.frame_index and b.render_method == a.render_method
    for _ in range(2):
        assert torch.equal(b.step_frame(), a.step_frame())


def test_frame_loop_batched_equals_per_frame(tmp_path):
    cfg = FluidConfig(**SMALL)
    last = {}
    for batch in (1, 4):
        eng = FluidXEngine(cfg, device="cpu")
        loop = FrameLoop(eng, show_fps=False)
        shot = str(tmp_path / f"b{batch}_{{frame}}.png")
        last[batch] = loop.run(6, screenshot_path=shot, screenshot_every=3, batch=batch)
        assert eng.frame_index == 6 and last[batch].shape == (24, 24, 3)
        np.testing.assert_array_equal(png.read_png(shot.format(frame=6)), last[batch])
        assert (tmp_path / f"b{batch}_3.png").exists()
    np.testing.assert_array_equal(last[1], last[4])


def test_watchdog_resets_nan_and_trips_the_cfl_guard(tmp_path):
    cfg = FluidConfig(**SMALL)
    eng = FluidXEngine(cfg, device="cpu")
    metrics = str(tmp_path / "metrics.jsonl")
    loop = FrameLoop(eng, show_fps=False, watchdog_every=2, metrics_path=metrics)
    loop.run(2)
    assert loop.cfl_warnings == 0 and loop.recoveries == 0
    buffers = eng.state.fields
    eng.state.fields[3, 0, 0, 0] = float("nan")
    loop._watchdog()
    assert loop.recoveries == 1 and eng.state.fields is buffers
    assert not eng.state.fields.any()
    # Strong forcing: the per-substep displacement passes the warn fraction.
    u = 1.5 * MAX_DISP / (cfg.time_step * cfg.grid_size[0])
    eng.state.fields[:3] = u
    loop._watchdog()
    assert loop.cfl_warnings == 1
    lines = [json.loads(line) for line in open(metrics)]
    assert [set(r) for r in lines] == [{"frame", "fps", "healthy", "density_max", "speed_max",
                                        "recoveries", "cfl_disp", "cfl_warnings"}] * 3
    assert [r["healthy"] for r in lines] == [True, False, True]
    assert lines[0]["cfl_disp"] < MAX_DISP and lines[1]["cfl_disp"] is None
    assert lines[2]["cfl_disp"] > loop.CFL_WARN_FRACTION * MAX_DISP


def test_hotkeys_drive_the_engine(tmp_path, capsys):
    eng = FluidXEngine(FluidConfig(**SMALL), device="cpu")
    loop = FrameLoop(eng, show_fps=False)
    img = eng.step_frame()
    loop._handle_key("space", img, None)
    assert eng.is_paused
    loop._handle_key("space", img, None)
    m0 = eng.render_method
    loop._handle_key("right", img, None)
    assert eng.render_method == m0.next()
    loop._handle_key("left", img, None)
    assert eng.render_method == m0
    loop._handle_key("x", img, None)
    assert not eng.config.fast_render and not eng.config.fast_sim
    loop._handle_key("x", img, None)
    assert eng.config.fast_render and eng.config.fast_sim
    shot = str(tmp_path / "live_{frame}.png")
    loop._handle_key("s", img, shot)
    assert (tmp_path / f"live_{eng.frame_index}.png").exists()
    assert loop._handle_key(None, img, None) is False
    assert loop._handle_key("q", img, None) is True
    assert "screenshot ->" in capsys.readouterr().out


def test_cli_runs_on_the_cpu(tmp_path):
    shot = str(tmp_path / "f_{frame}.png")
    ckpt = str(tmp_path / "s.npz")
    argv = ["--cpu", "--gridSize", "16", "16", "16", "--viewport", "24", "24",
            "--maxRaySamples", "8", "--maxLightSamples", "4", "--frames", "3", "--no-fps",
            "--screenshot", shot, "--checkpoint", ckpt]
    assert cli.main(argv) == 0
    img = png.read_png(shot.format(frame=3))
    assert img.shape == (24, 24, 3)
    with np.load(ckpt) as data:
        assert int(data["frame_index"]) == 3


def test_cli_without_cuda_or_cpu_exits_nonzero(monkeypatch, capsys):
    import fluidx12_tpu_torch.engine.fluidx as engine_module

    def refuse(*args, **kwargs):
        raise AssertionError("an engine was built")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(engine_module, "FluidXEngine", refuse)
    assert cli.main(["--frames", "1"]) != 0
    assert "no CUDA device" in capsys.readouterr().err


def test_profile_passes_returns_the_jax_keys():
    eng = FluidXEngine(FluidConfig(**SMALL), device="cpu")
    eng.step_frame()
    before = eng.state.fields.clone()
    out = profile_passes(eng, reps=1)
    assert list(out) == ["advect", "project", "light_map", "cube_march", "resolve", "total"]
    assert all(v > 0.0 for v in out.values())
    assert torch.equal(eng.state.fields, before)
    eng.render_method = RenderMethod.RAY_MARCH_DIRECT_SEPARATE
    assert list(profile_passes(eng, reps=1)) == ["advect", "project", "light_map",
                                                 "plane_march", "warp", "total"]


@pytest.mark.parametrize("method", list(RenderMethod))
def test_smoke_model_step_equals_the_engine_frame(method):
    # tests/test_models.py's config: the engine's LOD is 0 at this pose.
    cfg = FluidConfig(grid_size=(24, 24, 24), viewport=(48, 48), max_ray_samples=16,
                      max_light_samples=4, num_pressure_iters=4)
    eng = FluidXEngine(cfg, device="cpu")
    eng.render_method = method
    model = SmokeModel(cfg, method=method, device="cpu")
    state, params = model.init(), model.default_params()
    for _ in range(2):
        state, image = model.step(state, params)
        assert torch.equal(image, eng.step_frame())
    assert torch.equal(state.fields, eng.state.fields)
