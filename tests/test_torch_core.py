"""The port's core modules (config, state, host math, transforms) against
the JAX package's, on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluidx12_tpu.core import camera as jcam
from fluidx12_tpu.core import config as jcfg
from fluidx12_tpu.core import lod as jlod
from fluidx12_tpu.core import math3d as jm3
from fluidx12_tpu.core import state as jstate
from fluidx12_tpu.ops import sampling as jsampling
from fluidx12_tpu.ops import transform as jtransform
from fluidx12_tpu_torch.core import camera as tcam
from fluidx12_tpu_torch.core import config as tcfg
from fluidx12_tpu_torch.core import lod as tlod
from fluidx12_tpu_torch.core import math3d as tm3
from fluidx12_tpu_torch.core import state as tstate
from fluidx12_tpu_torch.ops import sampling as tsampling
from fluidx12_tpu_torch.ops import transform as ttransform

# Several pytest workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)

_DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def _same_value(jv, tv) -> bool:
    if jv in _DTYPES:
        return _DTYPES[jv] == tv
    return jv == tv


@pytest.mark.parametrize("preset", ["default", "fluid3d", "fluid2d", "fluidgi"])
def test_config_mirrors_jax_field_for_field(preset):
    """Same field names in the same order, same defaults (jnp dtypes map to
    torch dtypes), same derived properties, for the defaults and each preset."""
    j = jcfg.FluidConfig() if preset == "default" else jcfg.PRESETS[preset]
    t = tcfg.FluidConfig() if preset == "default" else tcfg.PRESETS[preset]
    jf = [f.name for f in dataclasses.fields(j)]
    assert jf == [f.name for f in dataclasses.fields(t)]
    for name in jf:
        assert _same_value(getattr(j, name), getattr(t, name)), name
    for prop in ("is_3d", "time_step", "cube_map_size", "zyx"):
        assert getattr(j, prop) == getattr(t, prop)
    assert set(jcfg.PRESETS) == set(tcfg.PRESETS)


def test_enums_mirror_jax():
    for je, te in ((jcfg.RenderMethod, tcfg.RenderMethod),
                   (jcfg.FaceCullMode, tcfg.FaceCullMode)):
        assert [(m.name, int(m)) for m in je] == [(m.name, int(m)) for m in te]
    for m in jcfg.RenderMethod:
        tm = tcfg.RenderMethod(int(m))
        assert (m.uses_cube_map, m.separate_light_pass, int(m.next()), int(m.prev())) == \
            (tm.uses_cube_map, tm.separate_light_pass, int(tm.next()), int(tm.prev()))


@pytest.mark.parametrize("bad", [(128, 64, 128), (4, 4, 4)])
def test_config_validate_rejects_like_jax(bad):
    with pytest.raises(ValueError):
        jcfg.FluidConfig(grid_size=bad).validate()
    with pytest.raises(ValueError):
        tcfg.FluidConfig(grid_size=bad).validate()


def test_math3d_outputs_identical():
    rng = np.random.default_rng(0)
    p = rng.uniform(-2, 2, (5, 3)).astype(np.float32)
    m = rng.uniform(-1, 1, (4, 4)).astype(np.float32) + 3 * np.eye(4, dtype=np.float32)
    pairs = [
        (jm3.look_at_lh([4, 16, -40], [0, 0, 0], [0, 1, 0]),
         tm3.look_at_lh([4, 16, -40], [0, 0, 0], [0, 1, 0])),
        (jm3.perspective_fov_lh(0.8, 1.3, 1.0, 1000.0),
         tm3.perspective_fov_lh(0.8, 1.3, 1.0, 1000.0)),
        (jm3.scaling(10.0), tm3.scaling(10.0)),
        (jm3.translation(1, 2, 3), tm3.translation(1, 2, 3)),
        (jm3.rotation_roll_pitch_yaw(0.3, -0.7, 0.1), tm3.rotation_roll_pitch_yaw(0.3, -0.7, 0.1)),
        (jm3.inverse(m), tm3.inverse(m)),
        (jm3.transform_point(p, m), tm3.transform_point(p, m)),
        (jm3.transform_point_h(p, m), tm3.transform_point_h(p, m)),
        (jm3.transform_vector(p, m), tm3.transform_vector(p, m)),
    ]
    for a, b in pairs:
        np.testing.assert_array_equal(a, b)


def test_camera_and_lod_outputs_identical():
    """An orbit/dolly sequence gives the same matrices, LOD, visibility
    masks and scissor rects in both packages."""
    jc, tc = jcam.OrbitCamera(), tcam.OrbitCamera()
    world = jm3.scaling(10.0)
    world_i = jm3.inverse(world)
    for dx, dy, wheel in ((0, 0, 0), (40, -25, 0), (0, 0, 3), (-120, 60, -2)):
        for c in (jc, tc):
            c.orbit(dx, dy)
            c.dolly(wheel)
        np.testing.assert_array_equal(jc.view, tc.view)
        np.testing.assert_array_equal(jc.eye, tc.eye)
        wvp = world @ jc.view_proj
        assert jlod.estimate_cube_map_lod(192, 5, 128.0, wvp, (800, 800)) == \
            tlod.estimate_cube_map_lod(192, 5, 128.0, wvp, (800, 800))
        assert jlod.gen_visibility_mask(world_i, jc.eye) == \
            tlod.gen_visibility_mask(world_i, tc.eye)
        assert jlod.screen_bbox(wvp, (800, 800)) == tlod.screen_bbox(wvp, (800, 800))


def _packed(seed):
    rng = np.random.default_rng(seed)
    mats = [rng.uniform(-3, 3, (4, 4)).astype(np.float32) for _ in range(5)]
    args = (0.015625, 123456789, rng.uniform(-9, 9, 3), rng.uniform(-9, 9, 3),
            rng.uniform(0, 9, 4), rng.uniform(0, 9, 4), *mats, 97, 64, 27)
    return args, jstate.pack_scene_params_host(*args), tstate.pack_scene_params_host(*args)


def test_packed_params_round_trip():
    """Host packing is identical; unpacking on a tensor gives back every
    field exactly as the JAX unpacker does."""
    _, jflat, tflat = _packed(1)
    np.testing.assert_array_equal(jflat, tflat)
    jp = jstate.unpack_scene_params(jnp.asarray(jflat))
    tp = tstate.unpack_scene_params(torch.from_numpy(tflat))
    for name in jstate.SceneParams._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jp, name)),
                                      getattr(tp, name).numpy(), err_msg=name)


def test_state_from_numpy_carries_jax_state_bit_exact():
    rng = np.random.default_rng(3)
    cfg = jcfg.FluidConfig(grid_size=(16, 16, 8))
    js = jstate.FluidState(
        fields=jnp.asarray(rng.normal(0, 1, (7,) + cfg.zyx).astype(np.float32)
                           ).astype(jnp.bfloat16),
        pressure=jnp.asarray(rng.normal(0, 1, cfg.zyx).astype(np.float32)))
    ts = tstate.state_from_numpy(np.asarray(js.fields), np.asarray(js.pressure), "cpu")
    assert ts.fields.dtype == torch.bfloat16 and ts.pressure.dtype == torch.float32
    np.testing.assert_array_equal(ts.fields.float().numpy(),
                                  np.asarray(js.fields.astype(jnp.float32)))
    np.testing.assert_array_equal(ts.pressure.numpy(), np.asarray(js.pressure))
    np.testing.assert_array_equal(ts.velocity.float().numpy(),
                                  np.asarray(js.velocity.astype(jnp.float32)))
    with pytest.raises(ValueError):
        tstate.state_from_numpy(np.zeros((4, 8, 8, 8)), np.zeros((8, 8, 8)), "cpu")


def test_initial_state_matches_jax_compact_layout():
    cfg = tcfg.FluidConfig(grid_size=(32, 32, 16))
    s = tstate.make_initial_state(cfg, "cpu")
    j = jstate.make_initial_state(jcfg.FluidConfig(grid_size=(32, 32, 16)), pad=False)
    assert tuple(s.fields.shape) == j.fields.shape and s.fields.dtype == torch.bfloat16
    assert tuple(s.pressure.shape) == j.pressure.shape
    assert not s.fields.any() and not s.pressure.any()


@pytest.mark.parametrize("fn", ["transform_point_h", "transform_vector", "transform_ndc"])
def test_transforms_match_jax(fn):
    """Elementwise f32 transforms: bit-identical to the JAX package's."""
    rng = np.random.default_rng(2)
    m = (rng.uniform(-1, 1, (4, 4)) + 2 * np.eye(4)).astype(np.float32)
    if fn == "transform_ndc":
        p = rng.uniform(-1, 1, (6, 5, 2)).astype(np.float32)
        ref = jtransform.transform_ndc(jnp.asarray(p), 0.0, jnp.asarray(m))
        got = ttransform.transform_ndc(torch.from_numpy(p), 0.0, torch.from_numpy(m))
    else:
        p = rng.uniform(-1, 1, (6, 5, 3)).astype(np.float32)
        ref = getattr(jtransform, fn)(jnp.asarray(p), jnp.asarray(m))
        got = getattr(ttransform, fn)(torch.from_numpy(p), torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("axis,offset", [(0, 1), (1, -1), (2, 2), (2, -3)])
def test_neighbor_shift_matches_jax(axis, offset):
    rng = np.random.default_rng(axis + 10)
    f = rng.normal(size=(5, 6, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        tsampling.neighbor_shift(torch.from_numpy(f), axis, offset).numpy(),
        np.asarray(jsampling.neighbor_shift(jnp.asarray(f), axis, offset)))
