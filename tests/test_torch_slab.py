"""The port's B15 (the GI gradient) and B17 (the compositor over a
pre-resampled stack) on the CPU against the JAX package: each plain
version against its Pallas kernel in interpret mode, the copied march
gates and the march's route against the JAX originals, the GI light map at
grid (128, 128, 20) with a light probe, where the TPU's gates take B15
(the full-resolution GI normals: 20 slices are too few for the
half-resolution AO), and the cube march there.

On the TPU such a grid (z % 16 != 0) is stored padded
(fluidx12_tpu/core/padding.py): the march re-pads its volume and takes
B10 on every face, and so does the port (render/slicecomp.padded_march).
With x = y, B17 then serves only grids whose lateral plane is 768^2 or
more; its route is traced there, and its numerics are held on one face
with B10's gate closed.  Inputs are made with numpy from a seed; every
JAX reference is jitted and built once.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluidx12_tpu.core import math3d as m3
from fluidx12_tpu.core.camera import OrbitCamera
from fluidx12_tpu.core.config import FluidConfig
from fluidx12_tpu.core.state import default_scene_params
from fluidx12_tpu.ops.pallas import composite as pc
from fluidx12_tpu.ops.pallas import stencil as ps
from fluidx12_tpu.render import lightmap_sweep as jls
from fluidx12_tpu.render import slicecomp as jsc
from fluidx12_tpu_torch.core.config import FluidConfig as TorchConfig
from fluidx12_tpu_torch.core.state import SceneParams
from fluidx12_tpu_torch.ops.cuda import composite as tc
from fluidx12_tpu_torch.ops.cuda import stencil as ts
from fluidx12_tpu_torch.ops.transform import transform_point_h
from fluidx12_tpu_torch.render import lightmap_sweep as tls
from fluidx12_tpu_torch.render import slicecomp as tsc

# Several pytest workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)

SLAB = dict(grid_size=(128, 128, 20), has_light_probe=True, quantize_cube_map=False)
# The default camera sees faces X+, X-, Y- and Z+.
MASK = 0b11011


# ---------------------------------------------------------------------------
# Each kernel's plain version against its Pallas kernel
# ---------------------------------------------------------------------------

def test_gradient3_matches_pallas_and_jnp_gradient():
    """B15's plain version vs `gradient3_pallas` in interpret mode and
    `jnp.gradient`, bit for bit (one difference and one exact scale per
    value), at (30, 128, 128), the AO's half field of the 256x256x60 frame,
    which the TPU kernel takes in two z-blocks: their edges are checked
    too."""
    shape = (30, 128, 128)
    assert ps.stencil_pallas_supported(shape)
    q = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    refs = jax.jit(lambda q: (ps.gradient3_pallas(q), jnp.stack(jnp.gradient(q)[::-1])))(
        jnp.asarray(q))
    got = ts.gradient3(torch.from_numpy(q))
    assert got.shape == (3,) + shape and got.dtype == torch.float32
    for ref in refs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.fixture(scope="module")
def stack():
    """A bf16 (24, 16, 128) stack (three slice blocks of 8 on the TPU)
    premasked with an empty slice, and `composite_pallas` on it in both
    march directions, in interpret mode, compiled once."""
    rng = np.random.default_rng(3)
    ns, r1, r2 = 24, 16, 128
    assert pc.composite_supported(ns, r1, r2) and pc._pick_bs(ns) == 8
    dens = rng.uniform(0, 1, (ns, r1, r2)).astype(np.float32)
    dens[5] = 0.0
    dens[:, :, :7] = -0.1
    prod = rng.uniform(0, 1, (3, ns, r1, r2)).astype(np.float32)
    nst = rng.uniform(0.5, 2, (r1, r2)).astype(np.float32)
    jd, jp = (jnp.asarray(a).astype(jnp.bfloat16) for a in (dens, prod))
    refs = jax.jit(lambda d, p, n: [pc.composite_pallas(d, p, n, 0.8, flip)
                                    for flip in (False, True)])(jd, jp, jnp.asarray(nst))
    td, tp_ = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
               for a in (jd, jp))
    return td, tp_, torch.from_numpy(nst), [np.asarray(r) for r in refs]


@pytest.mark.parametrize("flip", [False, True])
def test_composite_matches_pallas(stack, flip):
    """B17's plain version vs `composite_pallas` in interpret mode, both
    march directions: within 1e-4, exp and log1p being XLA's and torch's
    (the JAX test holds the kernel to its XLA chain within 5e-4)."""
    dens, prod, nst, refs = stack
    assert tc.composite_supported(*dens.shape)
    got = tc.composite(dens, prod, nst, 0.8, flip)
    assert got.shape == (4,) + tuple(nst.shape) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), refs[flip], atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# The march gates
# ---------------------------------------------------------------------------

MARCH_GRIDS = [(256, 256, 60), (128, 128, 20), (256, 256, 256), (128, 128, 128),
               (24, 24, 24), (150, 150, 150), (256, 256, 36), (128, 128, 28),
               (384, 384, 32), (96, 96, 44)]


@pytest.mark.parametrize("grid", MARCH_GRIDS, ids=lambda g: "x".join(map(str, g)))
def test_march_gates_match_jax(grid):
    """The copied B10 and B17 gates (`composite_resample_supported`,
    `_pick_rows_tile`, `composite_supported`, `_pick_bs`, `_pick_tile`) give
    the JAX originals' answers on every face stack of the grid at LODs 0-2,
    and the port's route (`_takes_b17`) is the JAX march's choice on the
    compact layout."""
    cfg = TorchConfig(grid_size=grid)
    sizes = grid
    for lod in range(3):
        r = max(cfg.cube_map_size >> lod, 1)
        for axis in range(3):
            n_m = sizes[axis]
            n_s = n_m // max(-(-n_m // max(cfg.max_ray_samples >> lod, 1)), 1)
            lateral = {0: (grid[2], grid[1]), 1: (grid[2], grid[0]), 2: (grid[1], grid[0])}
            a, b = lateral[axis]
            assert (tc.composite_resample_supported(n_s, a, b, r, r)
                    == pc.composite_resample_supported(n_s, a, b, r, r))
            assert tc._pick_rows_tile(r, r, a, b, n_s) == pc._pick_rows_tile(r, r, a, b, n_s)
            assert tc.composite_supported(n_s, r, r) == pc.composite_supported(n_s, r, r)
            assert tc._pick_bs(n_s) == pc._pick_bs(n_s)
            assert tc._pick_tile(r, r, tc._pick_bs(n_s)) == pc._pick_tile(r, r, pc._pick_bs(n_s))
            big = n_s * r * r >= jsc._FUSE_MIN_STACK
            jax_b17 = (big and not pc.composite_resample_supported(n_s, a, b, r, r)
                       and pc.composite_supported(n_s, r, r))
            assert tsc._takes_b17(n_s, a, b, r, cfg) == jax_b17
    assert tsc._FUSE_MIN_STACK == jsc._FUSE_MIN_STACK


def test_slab_grids_take_b17_on_x_and_y_faces():
    """At lod 0 the X and Y faces of 256x256x60 (128 slices of 256^2, the
    lateral Z = 60) and of 128x128x20 would take B17 on the compact layout
    (`_takes_b17`); the Z faces would not.  Both grids are stored padded on
    the TPU, (64, 256, 256) and (32, 128, 128), where every face passes
    B10's gate, so the march takes B10 on all six (`march_kernels`)."""
    for grid, n_xy in (((256, 256, 60), 128), ((128, 128, 20), 128)):
        cfg = TorchConfig(grid_size=grid)
        r, z = cfg.cube_map_size, grid[2]
        assert tsc._takes_b17(n_xy, z, grid[1], r, cfg)      # X faces: lateral (Z, Y)
        assert tsc._takes_b17(n_xy, z, grid[0], r, cfg)      # Y faces: lateral (Z, X)
        assert not tsc._takes_b17(z, grid[1], grid[0], r, cfg)
        assert tsc.padded_march(cfg, 0, range(6))
        assert tsc.march_kernels(cfg, 0, range(6)) == {f: "B10" for f in range(6)}


def _jax_route(cfg, lod, monkeypatch):
    """{face: "B10" | "B17" | "chain"}: the kernel JAX's march takes on each
    of the six faces on its TPU (`_FUSED_ON_CPU`), traced with
    `jax.eval_shape`, nothing computed.  The spies stand in for the two
    Pallas calls with their (4, R1, R2) result, so no kernel is traced."""
    monkeypatch.setattr(jsc, "_FUSED_ON_CPU", True)
    route, face = {}, []
    march_face = jsc._march_face

    def face_spy(face_id, *args, **kwargs):
        face.append(face_id)
        route[face_id] = "chain"
        return march_face(face_id, *args, **kwargs)

    for name, kind, steps in (("composite_resample_pallas", "B10", 4),
                              ("composite_pallas", "B17", 2)):
        monkeypatch.setattr(pc, name, lambda *a, _kind=kind, _steps=steps, **k: (
            route.__setitem__(face[-1], _kind),
            jnp.zeros((4,) + a[_steps].shape, jnp.float32))[1])
    monkeypatch.setattr(jsc, "_march_face", face_spy)
    x, y, z = cfg.grid_size
    jax.eval_shape(functools.partial(jsc.ray_march_cube_fast, config=cfg, lod=lod),
                   jax.ShapeDtypeStruct((4, z, y, x), jnp.float32), _jax_params(cfg),
                   light_map=jax.ShapeDtypeStruct((3, z, y, x), jnp.float32))
    return route


# (128, 128, 20)'s route is run, not traced, below.
ROUTE_GRIDS = [(256, 256, 60), (150, 150, 150), (96, 96, 44)]


@pytest.mark.parametrize("grid", ROUTE_GRIDS, ids=lambda g: "x".join(map(str, g)))
def test_march_route_matches_jax(grid, monkeypatch):
    """The port's route for each face (`march_kernels`) at lod 0 is the JAX
    march's on its TPU, traced without the padded layout patched away: B10 on
    every face of a grid stored padded, B10 or B17 by the compact gates
    elsewhere.  Where JAX composites a small stack with its einsum chain
    (below `_FUSE_MIN_STACK`), the port takes B10 (ROADMAP.md C4)."""
    cfg, tcfg = FluidConfig(grid_size=grid), TorchConfig(grid_size=grid)
    want = _jax_route(cfg, 0, monkeypatch)
    got = tsc.march_kernels(tcfg, 0, range(6))
    r = tcfg.cube_map_size
    for f in range(6):
        small = tsc._n_slices(tcfg, tsc._FACES[f][0], 0) * r * r < tsc._FUSE_MIN_STACK
        assert got[f] == want[f] or (want[f] == "chain" and got[f] == "B10" and small), (
            f, got[f], want[f])


# ---------------------------------------------------------------------------
# The light map and the march at grid (128, 128, 20)
# ---------------------------------------------------------------------------

def _smooth_density(rng, shape, hi=0.6):
    dens = rng.uniform(0, hi, shape).astype(np.float32)
    for ax in range(3):
        dens = (np.roll(dens, 1, ax) + dens + np.roll(dens, -1, ax)) / 3
    return dens


def _jax_params(cfg):
    cam = OrbitCamera(width=64, height=64)
    world = m3.scaling(cfg.volume_scale)
    return default_scene_params(cfg)._replace(
        eye_pt=jnp.asarray(cam.eye), world=jnp.asarray(world),
        world_i=jnp.asarray(m3.inverse(world)), visibility_mask=jnp.asarray(MASK, jnp.int32))


def _to_torch(params) -> SceneParams:
    """The port's parameters: f32 tensors, the three counts int32."""
    out = [torch.from_numpy(np.array(p, np.float32)) for p in params]
    return SceneParams(*out[:-3], *(t.to(torch.int32) for t in out[-3:]))


@pytest.fixture(scope="module")
def slab():
    """A smoke layer in the (4, 20, 128, 128) colour grid, an incident
    light map, random SH coefficients standing in for the probe's, and the
    scene parameters of the default camera."""
    cfg = FluidConfig(**SLAB)
    rng = np.random.default_rng(7)
    dens = _smooth_density(rng, cfg.zyx)
    dens[:, :20] = 0.0
    grid = np.zeros((4,) + cfg.zyx, np.float32)
    grid[3] = dens
    grid[:3] = dens * np.array([0.5, 0.4, 0.3], np.float32)[:, None, None, None]
    light = rng.uniform(0.2, 1.5, (3,) + cfg.zyx).astype(np.float32)
    sh = rng.uniform(0, 0.3, (9, 3)).astype(np.float32)
    return cfg, grid, light, sh, _jax_params(cfg)


def test_light_map_takes_b15_and_matches_tpu(slab, monkeypatch):
    """The port's `render_light_map_fast` at grid (128, 128, 20) with the
    probe, where the stencil gate holds and the half-resolution AO does not
    (so no B16): the GI normals' gradient is B15.  Against JAX's, whose
    `_gradient` takes `gradient3_pallas` in interpret mode as on its TPU:
    within 5e-6 of the scale (f32 sums in the shadow scan and the AO's
    pooling); B15's plain version ran once, on the full (20, 128, 128)
    density."""
    cfg, grid, _, sh, p = slab
    tcfg = TorchConfig(**SLAB)
    assert ps.stencil_pallas_supported(cfg.zyx) and not jls._ao_half_res(cfg.zyx)
    assert jls._ao_levels(cfg.zyx) == 0
    jax_calls = []

    def tpu_gradient(density, use_pallas=True):
        if use_pallas and ps.stencil_pallas_supported(density.shape):
            jax_calls.append(density.shape)
            g = ps.gradient3_pallas(density.astype(jnp.float32)).astype(density.dtype)
            return g[2], g[1], g[0]
        return jnp.gradient(density)

    monkeypatch.setattr(jls, "_gradient", tpu_gradient)
    ref = np.asarray(jax.jit(functools.partial(jls.render_light_map_fast, config=cfg))(
        jnp.asarray(grid), p, sh_coeffs=jnp.asarray(sh)))
    assert jax_calls == [cfg.zyx]

    calls = []
    plain = ts.gradient3_plain
    monkeypatch.setattr(ts, "gradient3_plain", lambda q: calls.append(q.shape) or plain(q))
    got = tls.render_light_map_fast(torch.from_numpy(grid), _to_torch(p), tcfg,
                                    torch.from_numpy(sh))
    assert calls == [cfg.zyx]
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-6 * np.abs(ref).max(), rtol=0)


def test_march_takes_b17_and_matches_tpu(slab, monkeypatch):
    """B17's route and numerics.  With x = y, a face takes B17 only where
    B10's VMEM plan fails on a big stack of an unpadded grid: a lateral
    plane of 768^2 or more.  At (768, 768, 16), lod 0, the port's route
    takes B17 on the Z faces and B10 on the others, as JAX's march does
    (traced).  Its numerics on one face: grid (128, 128, 20)'s X+ face,
    128 slices resampled by the two matmuls, with B10's gate closed in the
    JAX package so that its march takes B17 there too (on the compact
    layout), against the port's B17 branch of `_march_face`: within 1e-6
    (the same f32 chain on the CPU, where the matmul dtype is f32; only
    exp, log1p and the matmuls' summation differ)."""
    big = (768, 768, 16)
    with pytest.MonkeyPatch.context() as mp:
        route = _jax_route(FluidConfig(grid_size=big), 0, mp)
    assert route == {0: "B10", 1: "B10", 2: "B10", 3: "B10", 4: "B17", 5: "B17"}
    assert tsc.march_kernels(TorchConfig(grid_size=big), 0, range(6)) == route

    cfg, grid, light, _, p = slab
    tcfg = TorchConfig(**SLAB)
    monkeypatch.setattr(jsc, "_FUSED_ON_CPU", True)
    monkeypatch.setattr(pc, "composite_resample_supported", lambda *a: False)
    stacks = []
    fused = pc.composite_pallas
    monkeypatch.setattr(pc, "composite_pallas",
                        lambda dens, *a, **k: stacks.append(dens.shape) or fused(dens, *a, **k))
    march = jax.jit(functools.partial(jsc.ray_march_cube_fast, config=cfg, lod=0,
                                      static_mask=0b1))
    ref = np.asarray(march(jnp.asarray(grid), p, light_map=jnp.asarray(light)))[0]
    assert stacks == [(128, 128, 128)]

    calls = []
    plain = tc.composite_plain
    monkeypatch.setattr(tc, "composite_plain", lambda *a: calls.append(1) or plain(*a))
    tp_ = _to_torch(p)
    local_eye = transform_point_h(tp_.eye_pt, tp_.world_i)[:3]
    tgrid, tlight = torch.from_numpy(grid), torch.from_numpy(light)
    vol = torch.cat([tgrid[3:4], tgrid[:3] * tlight])
    volf = tsc._axis_volume(vol, 0, tcfg)
    got = tsc._march_face(0, volf, local_eye, tp_.num_samples, tcfg, torch.float32, 0,
                          b17=True).numpy()
    assert calls == [1] and got.shape == ref.shape == (128, 128, 4)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    assert got[..., 3].max() > 0.1


def test_march_takes_b10_on_padded_grid_and_matches_tpu(slab, monkeypatch):
    """The port's `ray_march_cube_fast` at grid (128, 128, 20), stored
    (32, 128, 128) on the TPU, lod 0, the default camera's faces: B10 on
    X+, X-, Y- and Z+.  Against JAX's march as its TPU runs it
    (`_FUSED_ON_CPU`, the layout not patched) on X+, Y- and Z+ (X- is X+'s
    layout marched the other way; one interpret-mode face less keeps the
    test inside its budget): it re-pads the volume and takes B10
    (interpret mode) on X+ and Y-, whose lateral Z = 20 pads to 32 with
    zero-weight ghosts; within 1e-6 (exp and log1p).  On Z+,
    whose stack (20 x 128 x 128) is below `_FUSE_MIN_STACK` and does not
    pad, the TPU takes its XLA chain while the port takes B10 (ROADMAP.md
    C4): within 2e-3, the JAX package's kernel-against-chain tolerance."""
    cfg, grid, light, _, p = slab
    tcfg = TorchConfig(**SLAB)
    monkeypatch.setattr(jsc, "_FUSED_ON_CPU", True)
    lateral = []
    fused = pc.composite_resample_pallas

    def spy(volf, *args, **kwargs):
        lateral.append(volf.shape[2:])
        return fused(volf, *args, **kwargs)

    monkeypatch.setattr(pc, "composite_resample_pallas", spy)
    monkeypatch.setattr(pc, "composite_pallas",
                        lambda *a, **k: pytest.fail("B17 is not the TPU's route here"))
    march = jax.jit(functools.partial(jsc.ray_march_cube_fast, config=cfg, lod=0,
                                      static_mask=MASK & ~0b10))
    ref = np.asarray(march(jnp.asarray(grid), p, light_map=jnp.asarray(light)))
    assert sorted(lateral) == [(32, 128), (32, 128)]

    routes = []
    for name in ("composite_plain", "composite_resample_plain"):
        plain = getattr(tc, name)

        def count(*args, _fn=plain, _name=name):
            routes.append(_name)
            return _fn(*args)

        monkeypatch.setattr(tc, name, count)
    got = tsc.ray_march_cube_fast(torch.from_numpy(grid), _to_torch(p), tcfg,
                                  torch.from_numpy(light), lod=0, static_mask=MASK).numpy()
    assert routes == ["composite_resample_plain"] * 4
    assert got.shape == ref.shape == (6, 128, 128, 4)
    np.testing.assert_allclose(got[[0, 3]], ref[[0, 3]], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[4], ref[4], atol=2e-3, rtol=0)
    assert not got[[2, 5]].any() and not ref[[1, 2, 5]].any()
    assert got[0, ..., 3].max() > 0.1 and got[3, ..., 3].max() > 0.1
    assert got[1, ..., 3].max() > 0.1


BAD_CALLS = {
    "gradient3_dtype": lambda: ts.gradient3(torch.zeros((4, 8, 8), dtype=torch.float64)),
    "gradient3_thin": lambda: ts.gradient3(torch.zeros((1, 8, 8))),
    "composite_prod": lambda: tc.composite(torch.zeros((8, 8, 128)), torch.zeros((3, 8, 8, 64)),
                                           torch.zeros((8, 128)), 0.8, False),
    "composite_dtype": lambda: tc.composite(torch.zeros((8, 8, 128)),
                                            torch.zeros((3, 8, 8, 128), dtype=torch.bfloat16),
                                            torch.zeros((8, 128)), 0.8, False),
}


@pytest.mark.parametrize("call", list(BAD_CALLS))
def test_b15_b17_wrappers_reject_bad_arguments(call):
    """B15's and B17's wrappers check dtype and shape before dispatch, and
    count no launch on the CPU."""
    from fluidx12_tpu_torch.ops.cuda import launch_counts

    before = launch_counts()
    with pytest.raises(ValueError):
        BAD_CALLS[call]()
    assert launch_counts() == before
