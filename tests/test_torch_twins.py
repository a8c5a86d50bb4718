"""The XLA twins in the port -- the paths the JAX package runs with
`use_pallas=False` or `pallas_advect=False` on the fast stack -- against the
JAX package on the CPU: the mirror- and clamp-addressed advect twins
(sim/advect_fast.py), the einsum shear sweep with and without the sharding
hooks (render/lightmap_sweep._sweep_pooled), the einsum + cumprod march with
`partial`, `slice_start` and `row_start` (render/slicecomp._march_face_einsum),
and the frames of the cube and DIRECT methods.
Inputs are made with numpy from a seed; each JAX reference is jitted.
"""

import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluidx12_tpu.core.config import FluidConfig, RenderMethod
from fluidx12_tpu.core.padding import crop_to_logical, pad_to_storage
from fluidx12_tpu.core.state import unpack_scene_params
from fluidx12_tpu.render import lightmap_sweep as jax_sweep
from fluidx12_tpu.render import screencomp as jax_screen
from fluidx12_tpu.render import slicecomp as jax_slicecomp
from fluidx12_tpu.render.pipeline import render_frame
from fluidx12_tpu.sim import advect_fast as jax_advect
from fluidx12_tpu_torch.core.config import FluidConfig as TorchConfig
from fluidx12_tpu_torch.core.config import RenderMethod as TorchMethod
from fluidx12_tpu_torch.core.padding import padded_zyx
from fluidx12_tpu_torch.engine.fluidx import FluidXEngine
from fluidx12_tpu_torch.render import lightmap_sweep as torch_sweep
from fluidx12_tpu_torch.render import slicecomp as torch_slicecomp
from fluidx12_tpu_torch.sim import advect_fast as torch_advect
from fluidx12_tpu_torch.utils.image import to_srgb_u8

# Several pytest workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)


def _smooth(rng, shape, lo, hi):
    a = rng.uniform(lo, hi, shape).astype(np.float32)
    for ax in range(-3, 0):
        if a.shape[ax] > 2:
            a = (np.roll(a, 1, ax) + a + np.roll(a, -1, ax)) / 3.0
    return a


def _fields(zyx, seed):
    """(7, Z, Y, X) f32: a smooth velocity of up to about 3 sim units (the
    reference forcing keeps |u| of order 1; a backtrace of up to 3 voxels
    at these sizes) and smooth colour."""
    rng = np.random.default_rng(seed)
    return np.concatenate([_smooth(rng, (3,) + zyx, -3.0, 3.0),
                           _smooth(rng, (4,) + zyx, 0.0, 1.0)])


def _jax_advect(cfg):
    return jax.jit(lambda f, dt: jax_advect.advect_fields_fast(f, dt, cfg))


# ---------------------------------------------------------------------------
# The advect twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", [(24, 24, 24), (64, 64, 1)], ids=["24^3", "64^2"])
def test_mirror_twin_matches_jax(grid):
    """`advect_fields_fast` with use_pallas=False is the mirror-addressed
    f32 twin in both packages (a compact grid), held to the jitted JAX
    function within 1e-5 plus 1e-5 of each value: the impulse adds up to 6
    to the velocity in one step, and XLA's fused program rounds the force
    terms 4e-6 of that apart from the same ops run one at a time, which the
    port equals (tests/test_torch_sim.py holds the forces themselves)."""
    kw = dict(grid_size=grid, use_pallas=False)
    cfg, tcfg = FluidConfig(**kw), TorchConfig(**kw)
    assert padded_zyx(tcfg) is None
    f = _fields(cfg.zyx, 0)
    ref = np.asarray(_jax_advect(cfg)(jnp.asarray(f), jnp.float32(cfg.time_step)))
    got = torch_advect.advect_fields_fast(torch.from_numpy(f),
                                          torch.tensor(cfg.time_step), tcfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
    assert np.abs(got.numpy() - ref)[3:].max() <= 1e-5


def test_clamped_twin_on_padded_grid(monkeypatch):
    """On a grid the JAX package stores padded, (96, 16, 16) in (16, 16,
    128) storage, its twin is the clamped one (pinned by spies) on the
    padded array; the port runs the same clamp on its compact state, and
    the logical cells agree as in `test_mirror_twin_matches_jax`.
    `pallas_advect=False` alone takes the same twin."""
    kw = dict(grid_size=(96, 16, 16), use_pallas=False)
    cfg, tcfg = FluidConfig(**kw), TorchConfig(**kw)
    assert padded_zyx(tcfg) == (16, 16, 128)
    taken = []
    for mod, log in ((jax_advect, taken), (torch_advect, taken)):
        for name in ("_backtrace_split", "_backtrace_split_clamped"):
            def spy(*a, _f=getattr(mod, name), _n=f"{mod.__name__}.{name}", _log=log):
                _log.append(_n)
                return _f(*a)
            monkeypatch.setattr(mod, name, spy)
    f = _fields(cfg.zyx, 1)
    storage = pad_to_storage(jnp.asarray(f), cfg)
    ref = crop_to_logical(_jax_advect(cfg)(storage, jnp.float32(cfg.time_step)), cfg)
    got = torch_advect.advect_fields_fast(torch.from_numpy(f), torch.tensor(cfg.time_step),
                                          tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    alone = torch_advect.advect_fields_fast(
        torch.from_numpy(f), torch.tensor(cfg.time_step),
        dataclasses.replace(tcfg, use_pallas=True, pallas_advect=False))
    assert torch.equal(alone, got)
    assert set(taken) == {"fluidx12_tpu.sim.advect_fast._backtrace_split_clamped",
                          "fluidx12_tpu_torch.sim.advect_fast._backtrace_split_clamped"}


# ---------------------------------------------------------------------------
# The einsum shear sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hooks", [False, True], ids=["single", "sharded"])
def test_einsum_sweep_matches_jax(hooks):
    """`_sweep_pooled` with use_pallas=False on a pooled (m, n_a, n_b)
    stack under an oblique light, against the JAX package's einsum form:
    with k_ids = arange, and with the sharding hooks (the global slice ids
    of a later rank's block and a `prefix_fn` standing for the earlier
    ranks' optical depth) on both sides; within 2e-6."""
    rng = np.random.default_rng(4)
    dens = _smooth(rng, (16, 24, 20), 0.0, 0.6)
    light = np.array([0.45, -0.3, 0.84], np.float32)
    light /= np.linalg.norm(light)
    sizes, stride, ref_step, absorption = (20, 24, 32), 2, np.float32(0.43), 0.8
    k_ids = (np.arange(16) + (8 if hooks else 0)).astype(np.float32)
    plane = rng.uniform(-2.0, 0.0, (48, 40)).astype(np.float32) if hooks else None

    def jfn(d, ld, k, rs):
        return jax_sweep._sweep_pooled(d, ld, 2, sizes, stride, rs, absorption, k_ids=k,
                                       prefix_fn=(lambda s: jnp.asarray(plane) + 0.5 * s)
                                       if hooks else None, use_pallas=False)

    ref = np.asarray(jax.jit(jfn)(jnp.asarray(dens), jnp.asarray(light), jnp.asarray(k_ids),
                                  jnp.float32(ref_step)))
    got = torch_sweep._sweep_pooled(
        torch.from_numpy(dens), torch.from_numpy(light), 2, sizes, stride,
        torch.tensor(ref_step), absorption,
        k_ids=torch.from_numpy(k_ids) if hooks else None,
        prefix_fn=(lambda s: torch.from_numpy(plane) + 0.5 * s) if hooks else None,
        use_pallas=False)
    assert ref.min() < 0.9
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-6, rtol=0)


# ---------------------------------------------------------------------------
# The einsum + cumprod march
# ---------------------------------------------------------------------------

def _march_inputs(face, seed=5):
    cfg = FluidConfig(grid_size=(24, 20, 16), max_ray_samples=16, viewport=(32, 32),
                      use_pallas=False)
    rng = np.random.default_rng(seed)
    dens = _smooth(rng, cfg.zyx, 0.0, 0.7)
    vol = np.concatenate([dens[None], dens[None] * np.array([0.4, 0.3, 0.2], np.float32)[
        :, None, None, None]])
    volf = np.asarray(jax_slicecomp._axis_volume(jnp.asarray(vol), jax_slicecomp._FACES[face][0],
                                                 cfg))
    # An eye outside the volume on the side the face looks back at.
    axis, sign = jax_slicecomp._FACES[face][:2]
    eye = np.array([0.3, -0.2, 0.4], np.float32)
    eye[axis] = -2.5 * sign
    return cfg, volf, eye


@pytest.mark.parametrize("case", ["faces", "partial", "rows"])
def test_einsum_march_matches_jax(case):
    """`_march_face_einsum` against JAX `_march_face` with use_pallas=False,
    each face seen by an eye outside the volume opposite it: a face of each
    axis whole ("faces"); the Z faces' second half of the slices with
    `slice_start` and `partial`, which also returns the block's
    transmittance; and an X and a Y face over a block of z rows with
    `row_start` (no reduction).  The cases cover all six faces; within
    2e-6.  One jitted JAX program a case."""
    faces = {"faces": (1, 2, 4), "partial": (4, 5), "rows": (0, 3)}[case]
    inputs = [_march_inputs(f) for f in faces]
    cfg = inputs[0][0]
    tcfg = TorchConfig(grid_size=cfg.grid_size, max_ray_samples=16, viewport=(32, 32),
                       use_pallas=False)
    kw, cut = {}, (lambda v: v)
    if case == "partial":
        half = inputs[0][1].shape[1] // 2
        kw, cut = dict(slice_start=half, partial=True), (lambda v: v[:, half:])
    elif case == "rows":
        kw, cut = dict(row_start=8), (lambda v: v[:, :, 8:])
    vols = [cut(v) for _, v, _ in inputs]
    eyes = [e for _, _, e in inputs]
    refs = jax.jit(lambda vs, es: [jax_slicecomp._march_face(
        f, v, e, jnp.int32(16), cfg, jnp.float32, **kw) for f, v, e in zip(faces, vs, es)])(
        [jnp.asarray(v) for v in vols], [jnp.asarray(e) for e in eyes])
    for f, v, e, ref in zip(faces, vols, eyes, refs):
        got = torch_slicecomp._march_face_einsum(
            f, torch.from_numpy(v.copy()), torch.from_numpy(e), torch.tensor(16), tcfg,
            torch.float32, **kw)
        if case == "partial":
            np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=2e-6, rtol=0)
            ref, got = ref[0], got[0]
        assert float(np.asarray(ref)[..., 3].max()) > 0.05, f
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-6, rtol=0,
                                   err_msg=f"face {f}")


# ---------------------------------------------------------------------------
# Whole frames
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["RAY_MARCH_SEPARATE", "RAY_MARCH_DIRECT_MERGED"])
def test_use_pallas_false_frames_match_jax(method):
    """The port's engine with use_pallas=False at the golden cases' config
    (24^3, 64^2) runs 12 frames from rest and a 13th, whose simulation
    takes the advect twin and whose render the einsum sweep and the einsum
    march (the cube faces, or the DIRECT method's base plane).  The JAX
    package's `render_frame`, jitted, renders the 21st frame's state with
    the engine's parameters, LOD, face mask, base plane and scissor: the
    images stay within the golden gates (mean below 2 u8 levels, under 1%
    of channels off by more than 25) and in fact within 1 level.  Whole
    runs from rest part ways chaotically after some ten frames (the bf16
    state rounds the two programs' last-bit differences apart), so the
    frames are compared from one state; the advect twin is held to JAX
    above and the projection's twins in tests/test_torch_sim.py."""
    kw = dict(grid_size=(24, 24, 24), viewport=(64, 64), max_ray_samples=32,
              max_light_samples=8, num_pressure_iters=16, use_pallas=False)
    cfg = FluidConfig(**kw)
    port = FluidXEngine(TorchConfig(**kw), device="cpu")
    port.render_method = TorchMethod[method]
    for _ in range(12):
        port.step_frame()
    key = port._prepare()
    got = to_srgb_u8(port._device_frame(key).numpy()).astype(int)
    _, lod, vis_mask, plane, rect, _ = key
    params = unpack_scene_params(jnp.asarray(port._packed.numpy()))
    grid = jnp.asarray(port.state.color.float().numpy().astype(ml_dtypes.bfloat16))
    spec = None if plane is None else jax_screen.DirectPlaneSpec(*plane)
    assert (spec is None) == (method == "RAY_MARCH_SEPARATE")
    want = jax.jit(lambda g, p: render_frame(g, p, cfg, RenderMethod[method], lod=lod,
                                             vis_mask=vis_mask, plane_spec=spec,
                                             rect=rect))(grid, params)
    d = np.abs(got - to_srgb_u8(np.asarray(want)).astype(int))
    assert d.mean() < 2.0 and (d > 25).mean() < 0.01 and d.max() <= 1, (d.mean(), d.max())
