"""R1's and R2's launch plans and schedules (fluidx12_tpu_torch/csrc/raymarch.cu
view_fetch_kernel and light_brick_kernel) on the CPU.

`view_plan` and `light_plan` own every ray and every voxel exactly once,
on a 24^3 grid, on ragged dims that fill no brick or tile and on the
800^2 screen against its 8 x 4 tiles; their constants and formulas are
those the kernel source compiles.  Two numpy models of the schedules
write into NaN-filled outputs what the kernels' threads write, where they
write it: R2's bricks (each voxel's density tested by its row's warp, the
empty voxels' light written at once, the dense ones queued by ballot and
prefix and marched) and R1's persistent warps (a warp whose lanes are all
idle fetches slots from a counter, slots map to rays by tiles, inactive
rays are written as zeros and drawn again, the counter reset after each
launch).  They give `light_map_plain` and the plain
`view_march` bit for bit at 24^3, and a dense voxel left out of the
queue, an empty voxel marched, a ray fetched twice, the counter not reset
between two launches and a tile's lanes one row off are each caught.  The
plain versions themselves are held to the JAX package by
tests/test_torch_faithful.py."""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fluidx12_tpu_torch.core.config import FluidConfig
from fluidx12_tpu_torch.ops.cuda import _build
from fluidx12_tpu_torch.ops.cuda import raymarch as R
from fluidx12_tpu_torch.ops.sampling import texel_centres, trilinear_sample
from fluidx12_tpu_torch.render import raymarch_core as RC
from fluidx12_tpu_torch.render.lightmap import light_map_plain

# Several pytest workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)

# R1 and R2 (raymarch.cu) and the layouts they share with R1b and R2b
# (raymarch.cuh).
SRC = [Path(R.__file__).parents[2] / "csrc" / name for name in ("raymarch.cu", "raymarch.cuh")]
GOLDEN = (24, 24, 24)
RAGGED = (22, 13, 20)


def _voxels_of(plan, zyx):
    """(z, y, x) of every voxel light_brick_kernel's lanes test, in CTA,
    warp, row, lane order: CTA c = (bx, by, bz) x fastest, warp w takes
    rows w, w + LIGHT_WARPS, ..., row k at y = y0 + k % by, z = z0 + k // by,
    lane l at x = BRICK_X bx + l; kept where inside the grid."""
    z, y, x = zyx
    nbx, nby, nbz = plan.bricks
    rows = plan.by * plan.bz
    out = []
    for c in range(nbx * nby * nbz):
        bx, byz = c % nbx, c // nbx
        y0, z0 = (byz % nby) * plan.by, (byz // nby) * plan.bz
        for w in range(R.LIGHT_WARPS):
            for k in range(w, rows, R.LIGHT_WARPS):
                yy, zz = y0 + k % plan.by, z0 + k // plan.by
                for xx in range(bx * R.BRICK_X, bx * R.BRICK_X + R.BRICK_X):
                    if xx < x and yy < y and zz < z:
                        out.append((zz, yy, xx))
    return np.array(out)


def _ray_of_slot(s, plan, row_shift=0):
    """view_fetch_kernel's ray_of_slot: ray l = s % 32 of tile s // 32,
    tiles row-major; -1 where the tile overhangs the plane."""
    tile, l = divmod(s, R.TILE_RAYS)
    ty, tx = divmod(tile, plan.tiles_x)
    row = ty * (R.TILE_RAYS // plan.tile_w) + l // plan.tile_w + row_shift
    col = tx * plan.tile_w + l % plan.tile_w
    return row * plan.cols + col if row < plan.rows and col < plan.cols else -1


@pytest.mark.parametrize("probe", [False, True], ids=["directional", "probe"])
@pytest.mark.parametrize("zyx", [GOLDEN, RAGGED, (128, 128, 128), (150, 150, 150)],
                         ids=lambda s: "x".join(map(str, s)))
def test_light_plan_owns_every_voxel_once(zyx, probe):
    """R2's bricks partition the grid: each voxel is one lane's of one
    row of one CTA; a lane's rows fit its word of dense bits; half-height
    bricks with the probe; 32-bit offsets wherever they reach."""
    plan = R.light_plan(zyx, probe)
    assert plan == R.light_layout(zyx, *(R.BRICK_YZ_PROBE if probe else R.BRICK_YZ))
    assert plan.by * plan.bz <= R.MAX_BRICK_ROWS
    if zyx[0] > 32:   # the full-size grids: the per-voxel count alone
        z, y, x = zyx
        nbx, nby, nbz = plan.bricks
        assert (nbx * R.BRICK_X >= x > (nbx - 1) * R.BRICK_X and nby * plan.by >= y
                > (nby - 1) * plan.by and nbz * plan.bz >= z > (nbz - 1) * plan.bz)
        return
    vox = _voxels_of(plan, zyx)
    owned = np.zeros(zyx, dtype=np.int32)
    np.add.at(owned, tuple(vox.T), 1)
    assert (owned == 1).all()


@pytest.mark.parametrize("lead", [(800, 800), (6, 24, 24), (20, 28), (3000,), (3, 7)],
                         ids=lambda s: "x".join(map(str, s)))
def test_view_plan_owns_every_ray_once(lead):
    """R1's slots cover each ray exactly once, a tile's 32 rays inside a
    tile_w x 32 / tile_w block of the (rows, cols) plane: 8 x 4 tiles
    where the plane has 4 rows or more (the 800^2 screen's 100 x 200
    tiles), 32 x 1 below."""
    plan = R.view_plan(lead, GOLDEN)
    rows, cols = plan.rows, plan.cols
    assert rows * cols == int(np.prod(lead)) and not plan.wide
    assert plan.tile_w == (8 if rows >= 4 else 32)
    if lead == (800, 800):
        assert (plan.tiles_x, plan.tiles_y) == (100, 200)
    slots = np.arange(plan.slots)
    tile, lane = np.divmod(slots, R.TILE_RAYS)
    ty, tx = np.divmod(tile, plan.tiles_x)
    row = ty * (R.TILE_RAYS // plan.tile_w) + lane // plan.tile_w
    col = tx * plan.tile_w + lane % plan.tile_w
    keep = (row < rows) & (col < cols)
    ray = (row * cols + col)[keep]
    assert np.array_equal(np.sort(ray), np.arange(rows * cols))
    if lead in ((20, 28), (3, 7)):  # the scalar mapping the models use agrees
        assert [_ray_of_slot(int(s), plan) for s in slots] == list(np.where(keep, row * cols
                                                                            + col, -1))


def test_plans_refuse_what_no_launch_takes():
    """No plan for no rays or an empty grid; 64-bit offsets exactly where
    a channel set's 32-bit offsets would not reach."""
    with pytest.raises(ValueError):
        R.view_plan((0, 8), GOLDEN)
    with pytest.raises(ValueError):
        R.light_plan((0, 8, 8))
    assert R.view_plan((8, 8), (512, 1024, 1024)).wide          # 4 Z Y X = 2^31
    assert not R.view_plan((8, 8), (511, 1024, 1024)).wide
    assert R.view_plan((8, 8), (8, 8, 8), (683, 1024, 1024)).wide   # 3 Z' Y' X' >= 2^31
    assert R.light_plan((512, 1024, 1024)).wide and not R.light_plan((511, 1024, 1024)).wide


def test_plans_match_the_kernel_source():
    """The constants and formulas the plans and the models below use are
    those csrc/raymarch.cu (with csrc/raymarch.cuh) compiles, and its entry points take the plans
    whole and refuse what their kernels cannot run."""
    src = "".join(path.read_text() for path in SRC)
    c = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (c["kViewThreads"], c["kTileRays"], c["kLightWarps"], c["kBrickX"],
            c["kMaxBrickRows"]) == (R.VIEW_THREADS, R.TILE_RAYS, R.LIGHT_WARPS, R.BRICK_X,
                                    R.MAX_BRICK_ROWS)
    # R1: slots to rays, the fetch, inactive rays, the march, the reset.
    assert "const int tile = s / kTileRays, l = s % kTileRays;" in src
    assert "const int ty = tile / p.tiles_x, tx = tile - ty * p.tiles_x;" in src
    assert "const int row = ty * (kTileRays / p.tile_w) + l / p.tile_w;" in src
    assert "const int col = tx * p.tile_w + l % p.tile_w;" in src
    assert "if (row >= p.rows || col >= p.cols) return -1;" in src
    assert "const unsigned idle = __ballot_sync(kFull, r < 0);" in src
    assert "if (base >= (unsigned long long)p.slots) break;" in src
    assert "if (__ballot_sync(kFull, r >= 0) == 0) break;" in src
    assert "if (r >= 0) march_ray<T, I, kMerged>(a, m, num, step_scale, r);" in src
    assert ("if (lane == 0) base = atomicAdd(&g_view_fetch[0], (unsigned long long)"
            "__popc(idle));") in src
    assert "const unsigned long long slot = base + __popc(idle & below);" in src
    assert "if (r < 0 && slot < (unsigned long long)p.slots) {" in src
    assert "put_ray(a, q, make_float4(0.0f, 0.0f, 0.0f, 0.0f), 0, 0, 0);" in src
    assert ("if (atomicAdd(&g_view_fetch[1], 1ull) == (unsigned long long)gridDim.x - 1) {\n"
            "      atomicExch(&g_view_fetch[0], 0ull);\n"
            "      atomicExch(&g_view_fetch[1], 0ull);") in src
    assert "const int64_t tiles_x = (cols + tile_w - 1) / tile_w;" in src
    assert "(int64_t)rows * cols != n || (tile_w != 8 && tile_w != 32)) {" in src
    assert "(!wide && !(fits32(a.g, 4) && fits32(a.lm, 3)))" in src
    # R2: bricks, rows, the test, the queue, the march.
    assert ("const int x = bx * kBrickX + lane, y0 = (byz % b.nby) * b.by, "
            "z0 = (byz / b.nby) * b.bz;") in src
    assert src.count("for (int k = warp; k < rows; k += kLightWarps) {") == 2
    assert "const int y = y0 + k % b.by, z = z0 + k / b.by;" in src
    assert "if (d_here >= m.zero) {\n        bits |= 1u << (k / kLightWarps);" in src
    assert "put_light<T, I>(a, dens, x, y, z, false, m);" in src
    assert ("if (dense) queue[base + __popc(mask & ((1u << lane) - 1u))] = k * kBrickX + lane;"
            in src)
    assert "for (int e = warp * 32 + lane; e - lane < n; e += kLightWarps * 32) {" in src
    assert ("put_light<T, I>(a, dens, bx * kBrickX + q % kBrickX, y0 + k % b.by, z0 + k / b.by, "
            "true,") in src
    assert "if (by < 1 || bz < 1 || by * bz > kMaxBrickRows) return false;" in src
    assert "!bricks(a.g, by, bz, b) || (!wide && !fits32(a.g, 4))) {" in src
    assert "light_brick_kernel<T, I><<<b.nbx * b.nby * b.nbz, kLightWarps * 32, 0, s>>>" in src
    sig = _build._SIGNATURES
    assert sig["fx_view_march"][:-1] == sig["fx_view_march_perthread"][:-1] + [_build._I] * 4
    assert sig["fx_light_march"][:-1] == sig["fx_light_march_perthread"][:-1] + [_build._I] * 3


# ---------------------------------------------------------------------------
# The schedule models
# ---------------------------------------------------------------------------

def _scene(zyx=GOLDEN, seed=2):
    """A config of `zyx` (32 ray and 8 light samples), a smoke grid (4, Z,
    Y, X) f32 of bf16 values (about a third of the voxels dense) and a
    light environment made of tensors (a directional light, no probe)."""
    z, y, x = zyx
    cfg = FluidConfig(grid_size=(x, y, z), max_ray_samples=32, max_light_samples=8)
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.0, 0.6, zyx).astype(np.float32)
    for ax in range(3):
        d = (np.roll(d, 1, ax) + d + np.roll(d, -1, ax)) / 3
    d = np.maximum(d - 0.3, 0.0) * 4.0
    grid = np.concatenate([d[None] * np.array([0.9, 0.7, 0.5], np.float32)[:, None, None, None],
                           d[None]])
    grid = torch.from_numpy(grid).to(torch.bfloat16).float()
    f32 = torch.float32
    light = torch.tensor([0.4, 0.8, -0.3], dtype=f32)
    env = RC.LightEnv(light_dir=light / RC.norm3(light), light_pos=torch.zeros(3),
                      light_color=torch.tensor([1.0, 0.7, 0.3]),
                      ambient=torch.tensor([0.1, 0.1, 0.12]), world3x3=torch.eye(3),
                      sh_coeffs=torch.zeros(9, 3), has_probe=False, point_light=False)
    return cfg, grid, env


def _voxel_lights(cfg, grid, env, num_light):
    """Per voxel: the light R2 writes for it as an empty voxel and as a
    dense one (its shadow ray marched), and whether it is dense."""
    z, y, x = grid.shape[1:]
    cz, cy, cx = torch.meshgrid(*(texel_centres(n, torch.float32, "cpu") * 2.0 - 1.0
                                  for n in (z, y, x)), indexing="ij")
    pos = torch.stack([cx, cy, cz], dim=-1)
    density = grid[-1:]
    dense = trilinear_sample(density, RC.local_to_tex(pos))[0] >= cfg.zero_threshold
    ones = torch.ones(pos.shape[:-1])
    shadow = RC.cast_light_ray(density, ones, pos, RC.light_direction_at(env, pos),
                               RC.step_size(num_light), cfg.max_light_samples, num_light, cfg)
    empty = (env.light_color * ones[..., None] + env.ambient).movedim(-1, 0)
    marched = (env.light_color * shadow[..., None] + env.ambient).movedim(-1, 0)
    return empty.numpy(), marched.numpy(), dense.numpy()


def _brick_model(plan, empty, marched, dense, drop_first=False, march_empty=False):
    """What light_brick_kernel writes under `plan`: (3, Z, Y, X), NaN where
    nothing was written, and the writes per voxel.  A CTA's warps test
    their rows, write each empty voxel's light and keep the dense ones'
    bits; each warp's rows are queued by ballot and prefix, then the queue
    is marched 32 entries a warp.  The mutations: `drop_first` leaves each
    row's first dense lane out of the queue, `march_empty` queues the
    empty voxels too."""
    z, y, x = dense.shape
    out = np.full((3, z, y, x), np.nan, dtype=np.float32)
    writes = np.zeros((z, y, x), dtype=np.int32)
    nbx, nby, nbz = plan.bricks
    rows = plan.by * plan.bz
    for c in range(nbx * nby * nbz):
        bx, byz = c % nbx, c // nbx
        y0, z0 = (byz % nby) * plan.by, (byz // nby) * plan.bz
        xs = bx * R.BRICK_X + np.arange(R.BRICK_X)
        bits = {}
        for w in range(R.LIGHT_WARPS):
            for k in range(w, rows, R.LIGHT_WARPS):
                yy, zz = y0 + k % plan.by, z0 + k // plan.by
                lanes = np.flatnonzero((xs < x) & (yy < y) & (zz < z))
                bits[k] = lanes
                if not len(lanes):
                    continue
                d = dense[zz, yy, xs[lanes]]
                bits[k] = lanes[d]
                empty_lanes = lanes[~d]
                out[:, zz, yy, xs[empty_lanes]] = empty[:, zz, yy, xs[empty_lanes]]
                writes[zz, yy, xs[empty_lanes]] += 1
                if march_empty:
                    bits[k] = lanes
        queue = []
        for w in range(R.LIGHT_WARPS):
            for k in range(w, rows, R.LIGHT_WARPS):
                lanes = bits[k][1:] if drop_first else bits[k]
                queue.extend(k * R.BRICK_X + lanes)
        for e in range(len(queue)):   # warp (e // 32) % LIGHT_WARPS, lane e % 32
            k, lane = divmod(queue[e], R.BRICK_X)
            vz, vy, vx = z0 + k // plan.by, y0 + k % plan.by, bx * R.BRICK_X + lane
            out[:, vz, vy, vx] = marched[:, vz, vy, vx]
            writes[vz, vy, vx] += 1
    return out, writes


@functools.lru_cache(maxsize=None)
def _r2_case(zyx=GOLDEN):
    cfg, grid, env = _scene(zyx)
    num = torch.tensor(8, dtype=torch.int32)
    ref = light_map_plain(grid, env, num, cfg)
    empty, marched, dense = _voxel_lights(cfg, grid, env, num)
    return ref, empty, marched, dense


@pytest.mark.parametrize("zyx", [GOLDEN, RAGGED], ids=lambda s: "x".join(map(str, s)))
def test_brick_model_gives_plain_bit_for_bit(zyx):
    """The bricks' writes, each voxel once, are `light_map_plain` exactly:
    the empty voxels' light written on the test, the dense voxels' on
    the march of the queue."""
    ref, empty, marched, dense = _r2_case(zyx)
    assert 0.1 < dense.mean() < 0.6 and not np.array_equal(empty, marched)
    out, writes = _brick_model(R.light_plan(zyx), empty, marched, dense)
    assert (writes == 1).all()
    assert torch.equal(torch.from_numpy(out), ref)


@pytest.mark.parametrize("mutant", ["drop_first", "march_empty"])
def test_brick_model_catches_mutants(mutant):
    """A dense voxel left out of the queue (NaN where it should be lit)
    and an empty voxel marched (its shadow ray dims it) break the match."""
    ref, empty, marched, dense = _r2_case()
    out, writes = _brick_model(R.light_plan(GOLDEN), empty, marched, dense, **{mutant: True})
    assert not torch.equal(torch.from_numpy(out), ref)


def _rays(cfg, shape=(20, 28), seed=4):
    """A (rows, cols) plane of rays from points in and around the box, at
    their box entries, with random directions, finite and infinite t_max,
    and an active mask (hit, and 80% of those)."""
    rng = np.random.default_rng(seed)
    o = torch.from_numpy(rng.uniform(-1.6, 1.6, shape + (3,)).astype(np.float32))
    d = rng.standard_normal(shape + (3,)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=-1, keepdims=True))
    origin, hit = RC.compute_ray_origin(o, d)
    t_max = torch.from_numpy(np.where(rng.uniform(size=shape) < 0.3,
                                      rng.uniform(0.2, 2.0, shape), np.inf).astype(np.float32))
    active = hit & torch.from_numpy(rng.uniform(size=shape) < 0.8)
    return origin, d, t_max, active


def _fetch_model(plan, active, cost, marched, warps=3, launches=1, reset=True,
                 duplicate=False, row_shift=0):
    """What the last of `launches` launches of view_fetch_kernel writes
    under `plan` into a fresh output: (n, 4), NaN where nothing was
    written, and the writes per ray.  `warps` warps take turns (one
    interleaving of the card's): a warp whose lanes are all idle fetches,
    as often as it takes, for its lanes without a ray from a counter shared
    by the launch: lane of rank j among them takes slot base + j, writes
    zeros for an inactive ray and draws again; then each lane marches its
    ray for `cost` steps and writes `marched`.  After a launch the counter
    is reset.  The mutations: `reset=False`; `duplicate` hands rank 0 the
    previous fetch's last slot again; `row_shift` moves a tile's lanes that
    many rows."""
    n = plan.rows * plan.cols
    counter = 0

    def write(r, value):
        out[r] = value
        writes[r] += 1

    for _ in range(launches):
        out = np.full((n, 4), np.nan, dtype=np.float32)
        writes = np.zeros(n, dtype=np.int32)
        ray = np.full((warps, 32), -1)
        left = np.zeros((warps, 32), dtype=np.int64)
        done = np.zeros(warps, dtype=bool)
        while not done.all():
            for w in range(warps):
                if done[w] or (ray[w] >= 0).any():
                    continue
                while (ray[w] < 0).any():
                    idle = np.flatnonzero(ray[w] < 0)
                    base = counter
                    counter += len(idle)
                    if base >= plan.slots:
                        break
                    for j, lane in enumerate(idle):
                        s = base + j - (1 if duplicate and j == 0 and base > 0 else 0)
                        r = _ray_of_slot(s, plan, row_shift) if s < plan.slots else -1
                        if r < 0:
                            continue
                        if active[r]:
                            ray[w, lane], left[w, lane] = r, cost[r]
                        else:
                            write(r, 0.0)
                done[w] = (ray[w] < 0).all()
            busy = ray >= 0
            left[busy] -= 1
            for w, lane in zip(*np.nonzero(busy & (left <= 0))):
                write(ray[w, lane], marched[ray[w, lane]])
                ray[w, lane] = -1
        if reset:
            counter = 0
    return out, writes


@functools.lru_cache(maxsize=None)
def _r1_case():
    cfg, grid, env = _scene()
    num, num_light = torch.tensor(32, dtype=torch.int32), torch.tensor(8, dtype=torch.int32)
    light_map = light_map_plain(grid, env, num_light, cfg)
    origin, ray_dir, t_max, active = _rays(cfg)
    kw = dict(light_map=light_map, num_light_samples=num_light)
    ref = RC.view_march(grid, origin, ray_dir, t_max, num, env, cfg, active=active, **kw)
    marched = RC.view_march(grid, origin, ray_dir, t_max, num, env, cfg, **kw)
    plan = R.view_plan(tuple(active.shape), GOLDEN, GOLDEN)
    cost = np.random.default_rng(7).integers(1, 12, active.numel())
    return plan, active.reshape(-1).numpy(), cost, marched.reshape(-1, 4).numpy(), ref.reshape(-1, 4)


@pytest.mark.parametrize("warps", [1, 3, 8])
def test_fetch_model_gives_plain_bit_for_bit(warps):
    """The persistent warps' writes, each ray once (a 20 x 28 plane, ragged
    against the 8 x 4 tiles), are the plain `view_march` exactly, zeros on
    the inactive rays; so are the second launch's, the counter reset."""
    plan, active, cost, marched, ref = _r1_case()
    assert plan.tile_w == 8 and 0.2 < active.mean() < 0.8 and float(ref[:, 3].max()) > 0.05
    for launches in (1, 2):
        out, writes = _fetch_model(plan, active, cost, marched, warps=warps, launches=launches)
        assert (writes == 1).all()
        assert torch.equal(torch.from_numpy(out), ref)


@pytest.mark.parametrize("mutant", ["duplicate", "no_reset", "row_shift"])
def test_fetch_model_catches_mutants(mutant):
    """A ray fetched twice (and so another skipped), a counter left where
    the last launch ended (the second of two launches writes nothing: its
    output stays NaN) and a tile's lanes one row off each break the match
    or write a ray other than once."""
    plan, active, cost, marched, ref = _r1_case()
    kw = {"duplicate": dict(duplicate=True), "no_reset": dict(reset=False, launches=2),
          "row_shift": dict(row_shift=1)}[mutant]
    out, writes = _fetch_model(plan, active, cost, marched, **kw)
    assert not ((writes == 1).all() and torch.equal(torch.from_numpy(out), ref))
