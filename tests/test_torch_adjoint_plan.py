"""R1b's and R2b's schedules and tapes (fluidx12_tpu_torch/csrc/raymarch_grad.cu
view_grad_fetch_kernel and light_grad_brick_kernel) as CPU models.

The card's kernels cannot run here, so what their lanes do, and when, is
modelled in numpy, and what they compute in torch, with the arithmetic of
tests/test_torch_adjoint_walk.py's walks.  R2b's persistent warps take
bricks of voxels (`light_grad_plan`) in a stride of the launch's warps,
test each voxel's shadow cotangent and then its density, queue by ballot
the dense voxels whose cotangent is not 0 in a queue of their own and
walk it 32 entries at a time; R1b's persistent warps fetch tiles of rays
(`view_grad_plan`) from a counter of their own, skip inactive rays and
rays whose four cotangents are 0 at the fetch (writing their sample
counts as 0) and walk the rays they hold.  A lane owns one tape slot: it
runs its ray again into the slot (an entry (t, opacity or transmittance,
prev) a sample that counts) and walks it back, and only then takes its
next ray.  Warps run at different speeds; a walk reads its slot as it
stands when the walk ends, in a tape filled with NaN where no lane
wrote.  The order of the atomics (and the lanes' merging of them) is not
modelled: it moves sums by rounding only.

The models show that every dense voxel with a non-zero cotangent, and
every active ray with a non-zero cotangent, is walked exactly once; that
no slot is taken while another ray's walk in it still runs; that the
sample counts are written once for every ray and voxel and the tape only
in slots that lanes own; and that the gradients equal autograd through
`render/lightmap.light_map_plain` and `render/raymarch_core.view_march` to
rounding.  Each catches four mutants: the first queued voxel (or fetched
ray) dropped, a slot taken one ray early, a ray or voxel whose cotangent
is non-zero in only one channel skipped, and an empty voxel (or inactive
ray) walked.  tests/test_torch_adjoint.py holds the port to jax.grad."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fluidx12_tpu_torch.core.config import FluidConfig
from fluidx12_tpu_torch.ops.cuda import _build
from fluidx12_tpu_torch.ops.cuda import raymarch as R
from fluidx12_tpu_torch.ops.sampling import texel_centres
from fluidx12_tpu_torch.render import raymarch_core as RC
from fluidx12_tpu_torch.render.lightmap import light_map_plain
from tests.test_torch_adjoint_walk import (
    F32,
    INV_2PI,
    MAX_DIST,
    _corners,
    _env,
    _get_step,
    _get_step_grad,
    _inside,
    _lerp,
    _lerp_grad,
    _rays,
    _sizes,
    _smoke,
)
from tests.test_torch_raymarch_plan import _ray_of_slot

# Several pytest workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)

SRC = Path(R.__file__).parents[2] / "csrc" / "raymarch_grad.cu"
ZYX = (24, 24, 24)
# Warp w steps at 1 + w % 3 time units: warps drift out of step.
SPEED = (1, 2, 3)
LIGHT_MUTANTS = ("drop_first", "early_slot", "one_channel", "march_empty")
VIEW_MUTANTS = ("drop_first", "early_slot", "one_channel", "walk_inactive")


def _cotangent(shape, channels_axis, seed):
    """A seeded normal cotangent of `shape` where a third of the rays or
    voxels have all channels, a third exactly one (at random) and a third
    none non-zero."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(shape).astype(np.float32)
    g = np.moveaxis(g, channels_axis, -1)
    kind = rng.integers(0, 3, g.shape[:-1])
    one = np.eye(g.shape[-1], dtype=np.float32)[rng.integers(0, g.shape[-1], g.shape[:-1])]
    g = g * np.where((kind == 0)[..., None], 1.0, np.where((kind == 1)[..., None], one, 0.0))
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(g, -1, channels_axis)))


def _play(events, taken, entries, slots, max_entries):
    """Runs the lanes' tape traffic in time order: event (start, end, item,
    slot) writes item's entries into the slot at `start` and reads the
    slot back when its walk ends at `end` (reads before writes at one
    time).  Returns each event's tape as read, the slots' owners' clashes
    (a slot written while another item's walk in it still ran) and the
    tape at the end (NaN where no lane wrote)."""
    tape = np.full((slots, max_entries, 3), np.nan, dtype=np.float32)
    order = sorted([(e[1], 0, i) for i, e in enumerate(events)]
                   + [(e[0], 1, i) for i, e in enumerate(events)])
    owner = {}
    clashes = 0
    read = np.full((len(events), max_entries, 3), np.nan, dtype=np.float32)
    for time, writes, i in order:
        start, end, item, slot = events[i]
        if writes:
            if slot in owner and owner[slot][1] > time:
                clashes += 1
            owner[slot] = (i, end)
            tape[slot, :taken[item]] = entries[item, :taken[item]]
        else:
            read[i] = tape[slot]
    return read, clashes, tape


# ---------------------------------------------------------------------------
# R2b
# ---------------------------------------------------------------------------

def _light_replay(grid, env, num, cfg):
    """Every voxel's shadow ray as R2b runs it again (put_light's forward,
    no density test): the voxels' centres, light directions, entries (n,
    max_light, 3) of (t, transmittance, prev) and their counts; and which
    voxels R2 finds dense."""
    zyx = tuple(grid.shape[1:])
    dens = grid[3].reshape(-1)
    zero, absorb = cfg.zero_threshold, cfg.absorption
    cz, cy, cx = torch.meshgrid(*(texel_centres(m, F32, "cpu") * 2.0 - 1.0 for m in zyx),
                                indexing="ij")
    pos = torch.stack([cx, cy, cz], dim=-1).reshape(-1, 3)
    if env.point_light:
        dv = env.light_pos - pos
        dirs = dv / torch.clamp_min(RC.norm3(dv), 1e-12)
    else:
        dirs = env.light_dir.expand(pos.shape)
    lin, f = _corners(pos * 0.5 + 0.5, zyx)
    dense = _lerp(dens[lin], f) >= zero
    n = pos.shape[0]
    scale = torch.div(MAX_DIST, num.to(F32))
    t = scale.expand(n).clone()
    transm, prev = torch.ones(n, dtype=F32), torch.zeros(n, dtype=F32)
    entries = torch.full((n, cfg.max_light_samples, 3), float("nan"), dtype=F32)
    taken = torch.zeros(n, dtype=torch.long)
    alive = transm >= zero
    for i in range(min(cfg.max_light_samples, int(num))):
        q = pos + dirs * t[:, None]
        alive = alive & _inside(q)
        entries[alive, taken[alive]] = torch.stack([t, transm, prev], dim=1)[alive]
        taken[alive] += 1
        lin, f = _corners(q * 0.5 + 0.5, zyx)
        d = _lerp(dens[lin], f)
        step = _get_step(d - prev, transm, d, scale)
        transm = torch.where(alive, transm * (1.0 - d * absorb), transm)
        alive = alive & (transm >= zero)
        t = torch.where(alive, t + step, t)
        prev = torch.where(alive, d, prev)
    return pos, dirs, entries.numpy(), taken.numpy(), dense.numpy()


def _light_back(grid, pos, dirs, tapes, taken, g_shadow, num, cfg):
    """R2b's walk back of each row's tape (m, max_light, 3): the density's
    cotangent (Z * Y * X,)."""
    zyx = tuple(grid.shape[1:])
    dens = grid[3].reshape(-1)
    absorb, sizes = cfg.absorption, _sizes(zyx)
    scale = torch.div(MAX_DIST, num.to(F32))
    tapes, taken = torch.from_numpy(tapes), torch.from_numpy(taken)
    g_dens = torch.zeros_like(dens)
    m = len(taken)
    a_T, a_t, a_prev = g_shadow.clone(), torch.zeros(m, dtype=F32), torch.zeros(m, dtype=F32)

    def sample(r, j):
        lin, f = _corners((pos[r] + dirs[r] * tapes[r, j, 0:1]) * 0.5 + 0.5, zyx)
        return lin, f, dens[lin]

    for j in range((int(taken.max()) if len(taken) else 0) - 1, -1, -1):
        r = (taken > j).nonzero()[:, 0]
        transm, prev = tapes[r, j, 1], tapes[r, j, 2]
        lin, f, taps = sample(r, j)
        s = _lerp(taps, f)
        g_transm = a_T[r] * (1.0 - s * absorb)
        g_s = -(a_T[r] * transm) * absorb + a_prev[r]
        g_dd, g_tr, g_sd = _get_step_grad(s - prev, transm, s, scale, a_t[r])
        g_s = g_s + g_sd + g_dd
        w, gf = _lerp_grad(taps, f, g_s)
        g_dens.index_add_(0, lin.reshape(-1), w.reshape(-1))
        gp = gf * sizes * 0.5
        d = dirs[r]
        a_t[r] = a_t[r] + ((gp[:, 0] * d[:, 0] + gp[:, 1] * d[:, 1]) + gp[:, 2] * d[:, 2])
        a_T[r] = g_transm + g_tr
        a_prev[r] = -g_dd
    return g_dens


def _brick_schedule(plan, queued, taken, warps, mutant=None):
    """What light_grad_brick_kernel's `warps` resident warps do under
    `plan`: warp w takes bricks w, w + warps, ... while its queue holds
    fewer than 32 voxels, tests each row by row (one voxel a lane) and
    queues its voxels that `queued` (Z, Y, X) marks, in row and lane
    order; then it walks the last 32 of its
    queue (or what is left once the bricks have run out), each lane in the
    slot of its own (warp, lane), replaying and walking for 2 x its
    voxel's entries at the warp's speed.  Returns the walks (start, end,
    voxel, slot), the lanes and the voxels' sample counts as written (-1
    where none, -2 where written twice; 0 for a voxel not walked).
    Mutations: `drop_first` leaves each brick's first queued voxel out;
    `early_slot` gives each lane's next voxel the slot after its last."""
    z, y, x = queued.shape
    nbx, nby, nbz = plan.bricks
    bricks, rows = nbx * nby * nbz, plan.by * plan.bz
    events = []
    written = np.full(z * y * x, -1, dtype=np.int64)
    walked = np.zeros(warps * 32, dtype=np.int64)
    queues = [[] for _ in range(warps)]
    next_brick = list(range(warps))
    clock = np.zeros(warps)
    done = np.zeros(warps, dtype=bool)

    def write(v, value):
        written[v] = value if written[v] == -1 else -2

    while not done.all():
        w = int(np.argmin(np.where(done, np.inf, clock)))
        q = queues[w]
        while len(q) < 32 and next_brick[w] < bricks:
            brick = next_brick[w]
            next_brick[w] += warps
            bx, byz = brick % nbx, brick // nbx
            y0, z0 = (byz % nby) * plan.by, (byz // nby) * plan.bz
            first = True
            for k in range(rows):
                yy, zz = y0 + k % plan.by, z0 + k // plan.by
                for xx in range(bx * R.BRICK_X, min(bx * R.BRICK_X + R.BRICK_X, x)):
                    if yy >= y or zz >= z:
                        continue
                    v = (zz * y + yy) * x + xx
                    if not queued[zz, yy, xx]:
                        write(v, 0)
                    elif not (mutant == "drop_first" and first):
                        q.append(v)
                    first = first and not queued[zz, yy, xx]
            clock[w] += rows
        if not q:
            done[w] = True
            continue
        batch = q[-32:]
        del q[-32:]
        for lane, v in enumerate(batch):
            lane_id = w * 32 + lane
            slot = lane_id
            if mutant == "early_slot":
                slot = (lane_id + walked[lane_id]) % (warps * 32)
            walked[lane_id] += 1
            events.append((clock[w], clock[w] + 2 * taken[v] * SPEED[w % 3], v, slot))
            write(v, taken[v])
        clock[w] += 2 * max(taken[v] for v in batch) * SPEED[w % 3] + 1
    return events, warps * 32, written


def _light_case(point=False):
    cfg = FluidConfig(grid_size=ZYX[::-1], max_light_samples=8)
    grid, env = _smoke(3, ZYX), _env(point)
    num = torch.tensor(8, dtype=torch.int32)
    g_out = _cotangent((3,) + ZYX, 0, seed=5)
    g_ref = grid.clone().requires_grad_(True)
    (light_map_plain(g_ref, env, num, cfg) * g_out).sum().backward()
    return cfg, grid, env, num, g_out, g_ref.grad


def _light_model(cfg, grid, env, num, g_out, mutant=None, warps=6):
    """The brick schedule run on the replayed tapes: the grid's cotangent,
    the walks per voxel, the expected walks, the slot clashes, the sample
    counts written and expected, and whether the tape holds anything in
    slots no lane owns."""
    pos, dirs, entries, taken, dense = _light_replay(grid, env, num, cfg)
    g = g_out.reshape(3, -1)
    c = env.light_color
    g_shadow = (g[0] * c[0] + g[1] * c[1]) + g[2] * c[2]
    want = dense & (g_shadow != 0.0).numpy()
    test = (g[0] * c[0] != 0.0).numpy() if mutant == "one_channel" else (g_shadow != 0.0).numpy()
    queued = test & (np.ones_like(dense) if mutant == "march_empty" else dense)
    plan = R.light_grad_plan(ZYX)
    events, slots, written = _brick_schedule(plan, queued.reshape(ZYX), taken, warps, mutant)
    read, clashes, tape = _play(events, taken, entries, slots, cfg.max_light_samples)
    vox = np.array([e[2] for e in events], dtype=np.int64)
    g_dens = _light_back(grid, pos[vox], dirs[vox], read, taken[vox], g_shadow[vox], num, cfg)
    g_grid = torch.zeros_like(grid)
    g_grid[3] = g_dens.reshape(ZYX)
    walks = np.bincount(vox, minlength=want.size)
    expect = np.where(want, taken, 0)
    owned = np.zeros(slots, dtype=bool)
    owned[[e[3] for e in events]] = True
    stray = bool(np.isfinite(tape[~owned]).any())
    return g_grid, walks, want, clashes, written, expect, stray


def _close(got, ref):
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    return bool(torch.isfinite(got).all()) and scale > 0.0 and err <= 2e-6 * scale


@pytest.mark.parametrize("point,warps", [(False, 6), (True, 16)],
                         ids=["directional-6-warps", "point-16-warps"])
def test_light_grad_schedule_walks_each_voxel_once(point, warps):
    """R2b's bricks: every dense voxel with a non-zero shadow cotangent is
    walked exactly once and no other, no slot is taken while another walk
    in it runs, every voxel's sample count is written (the walked ones'
    shadow samples, 0 elsewhere), the tape only in owned slots, and the
    gradient is autograd's through `light_map_plain` to rounding; 6 and
    16 resident warps."""
    cfg, grid, env, num, g_out, ref = _light_case(point)
    g_grid, walks, want, clashes, written, expect, stray = _light_model(cfg, grid, env, num,
                                                                        g_out, warps=warps)
    assert 0.1 < want.mean() < 0.6 and (want & (g_out[0] == 0).reshape(-1).numpy()).any()
    assert np.array_equal(walks, want.astype(np.int64))
    assert clashes == 0 and not stray
    assert np.array_equal(written, expect)
    assert float(g_grid[:3].abs().max()) == 0.0
    assert _close(g_grid, ref)


@pytest.mark.parametrize("mutant", LIGHT_MUTANTS)
def test_light_grad_schedule_catches_mutants(mutant):
    """The first queued voxel of each brick dropped, a lane's next voxel in
    the slot after its last (taken while another lane's walk may run), a
    voxel whose cotangent is non-zero in channel 1 or 2 only skipped, and
    the empty voxels walked: each breaks the walks, the slots or the
    gradient."""
    cfg, grid, env, num, g_out, ref = _light_case()
    g_grid, walks, want, clashes, written, expect, _ = _light_model(cfg, grid, env, num, g_out,
                                                                    mutant)
    assert not (np.array_equal(walks, want.astype(np.int64)) and clashes == 0
                and np.array_equal(written, expect) and _close(g_grid, ref))


# ---------------------------------------------------------------------------
# R1b
# ---------------------------------------------------------------------------

def _view_replay(grid, origin, ray_dir, t_max, num, cfg):
    """Every ray as R1b runs it again (march_ray's forward, separate mode;
    inactive rays too): its entries (n, max_ray, 3) of (t, opacity, prev)
    at its dense samples, their counts and its view samples."""
    zyx = tuple(grid.shape[1:])
    dens = grid[3].reshape(-1)
    zero, absorb = cfg.zero_threshold, cfg.absorption
    n = origin.shape[0]
    scale = torch.div(MAX_DIST, num.to(F32))
    t, sa, prev = (torch.zeros(n, dtype=F32) for _ in range(3))
    entries = torch.full((n, cfg.max_ray_samples, 3), float("nan"), dtype=F32)
    hits = torch.zeros(n, dtype=torch.long)
    views = torch.zeros(n, dtype=torch.long)
    alive = torch.ones(n, dtype=torch.bool)
    for _ in range(min(cfg.max_ray_samples, int(num))):
        p = origin + ray_dir * t[:, None]
        alive = alive & _inside(p)
        views += alive
        lin, f = _corners(p * 0.5 + 0.5, zyx)
        ca = _lerp(dens[lin], f)
        hit = alive & (ca > zero)
        entries[hit, hits[hit]] = torch.stack([t, sa, prev], dim=1)[hit]
        hits[hit] += 1
        transm = 1.0 - sa
        step = torch.where(hit, _get_step(ca - prev, transm, ca, scale), scale)
        sa = torch.where(hit, sa + ca * (absorb * transm), sa)
        alive = alive & ~(hit & (1.0 - sa < zero))
        prev = torch.where(hit, ca, prev)
        t_new = t + step
        alive = alive & (t_new <= t_max)
        t = torch.where(alive, t_new, t)
    return entries.numpy(), hits.numpy(), views.numpy()


def _view_back(grid, light_map, origin, ray_dir, tapes, hits, g_out, num, cfg):
    """R1b's walk back of each row's tape (m, max_ray, 3): the cotangents
    of the grid and the light map."""
    zyx, lzyx = tuple(grid.shape[1:]), tuple(light_map.shape[1:])
    chans, lchans = grid.reshape(4, -1), light_map.reshape(3, -1)
    absorb = cfg.absorption
    scale = torch.div(MAX_DIST, num.to(F32))
    sizes, lsizes = _sizes(zyx), _sizes(lzyx)
    tapes, hits = torch.from_numpy(tapes), torch.from_numpy(hits)
    g_grid, g_lm = torch.zeros_like(chans), torch.zeros_like(lchans)
    m = len(hits)
    gs = g_out[:, :3] * INV_2PI
    a_t, a_prev, a_sa = torch.zeros(m, dtype=F32), torch.zeros(m, dtype=F32), g_out[:, 3].clone()

    def uvw(r, j):
        return (origin[r] + ray_dir[r] * tapes[r, j, 0:1]) * 0.5 + 0.5

    for j in range((int(hits.max()) if len(hits) else 0) - 1, -1, -1):
        r = (hits > j).nonzero()[:, 0]
        sa_j, prev = tapes[r, j, 1], tapes[r, j, 2]
        lin, f = _corners(uvw(r, j), zyx)
        llin, lf = _corners(uvw(r, j), lzyx)
        dtaps = chans[3][lin]
        ca = _lerp(dtaps, f)
        k = absorb * (1.0 - sa_j)
        g_k = torch.zeros_like(k)
        g_ca = a_sa[r] * k + a_prev[r]
        gf, lgf = torch.zeros((len(r), 3), dtype=F32), torch.zeros((len(r), 3), dtype=F32)
        for c in range(3):
            taps, ltaps = chans[c][lin], lchans[c][llin]
            col, light = _lerp(taps, f), _lerp(ltaps, lf)
            e = col if cfg.pre_multiplied else col * ca
            gp = gs[r, c] * k
            g_e = gp * light
            g_k = g_k + gs[r, c] * (e * light)
            if not cfg.pre_multiplied:
                g_ca = g_ca + g_e * col
            w, gfc = _lerp_grad(taps, f, g_e if cfg.pre_multiplied else g_e * ca)
            g_grid[c].index_add_(0, lin.reshape(-1), w.reshape(-1))
            gf = gf + gfc
            w, gfc = _lerp_grad(ltaps, lf, gp * e)
            g_lm[c].index_add_(0, llin.reshape(-1), w.reshape(-1))
            lgf = lgf + gfc
        g_k = g_k + a_sa[r] * ca
        g_dd, g_transm, g_dens = _get_step_grad(ca - prev, 1.0 - sa_j, ca, scale, a_t[r])
        g_transm = g_transm + g_k * absorb
        g_ca = g_ca + g_dens + g_dd
        w, gfc = _lerp_grad(dtaps, f, g_ca)
        g_grid[3].index_add_(0, lin.reshape(-1), w.reshape(-1))
        gf = gf + gfc
        gp = (gf * sizes + lgf * lsizes) * 0.5
        d = ray_dir[r]
        a_t[r] = a_t[r] + ((gp[:, 0] * d[:, 0] + gp[:, 1] * d[:, 1]) + gp[:, 2] * d[:, 2])
        a_sa[r] = a_sa[r] - g_transm
        a_prev[r] = -g_dd
    return g_grid.reshape(grid.shape), g_lm.reshape(light_map.shape)


def _fetch_schedule(plan, walkable, views, hits, warps, mutant=None):
    """What view_grad_fetch_kernel's `warps` resident warps do under `plan`:
    the warp with the least work done fetches for its idle lanes from the
    counter (lane of rank j among them slot base + j); a lane that draws a
    ray it does not walk (`walkable` false) writes its counts as 0 and
    draws again; then each lane runs its ray again into the slot of its
    own (warp, lane) and walks it back, for its view and dense samples at
    the warp's speed, and writes its counts; the warp fetches when its last
    lane is done.  Returns the walks (start, end, ray, slot), the lanes,
    the rays run again and the rays' counts as written ((views, hits), or
    (-1, -1) where none, (-2, -2) where written twice).  Mutations:
    `drop_first` loses the ray of each fetch's first lane; `early_slot`
    gives each lane's next ray the slot after its last."""
    n = plan.rows * plan.cols
    counter, events = 0, []
    written = np.full((n, 2), -1, dtype=np.int64)
    replayed = np.zeros(n, dtype=np.int64)
    clock = np.zeros(warps)
    done = np.zeros(warps, dtype=bool)
    walked = np.zeros(warps * 32, dtype=np.int64)

    def write(r, v, h):
        written[r] = (v, h) if written[r, 0] == -1 else (-2, -2)

    while not done.all():
        w = int(np.argmin(np.where(done, np.inf, clock)))
        ray = np.full(32, -1)
        while (ray == -1).any() and counter < plan.slots:
            idle = np.flatnonzero(ray == -1)
            base, counter = counter, counter + len(idle)
            for j, lane in enumerate(idle):
                r = _ray_of_slot(base + j, plan) if base + j < plan.slots else -1
                if r < 0:
                    continue
                if not walkable[r]:
                    write(r, 0, 0)
                else:
                    ray[lane] = -2 if mutant == "drop_first" and j == 0 else r
        lanes = np.flatnonzero(ray >= 0)
        if not len(lanes):
            done[w] = counter >= plan.slots
            continue
        for lane in lanes:
            r = ray[lane]
            lane_id = w * 32 + lane
            slot = lane_id
            if mutant == "early_slot":
                slot = (lane_id + walked[lane_id]) % (warps * 32)
            walked[lane_id] += 1
            replayed[r] += 1
            events.append((clock[w], clock[w] + (views[r] + hits[r]) * SPEED[w % 3], r, slot))
            write(r, views[r], hits[r])
        clock[w] += max(views[ray[lane]] + hits[ray[lane]] for lane in lanes) * SPEED[w % 3] + 1
    return events, warps * 32, replayed, written


def _view_case():
    cfg = FluidConfig(grid_size=ZYX[::-1], max_ray_samples=32)
    grid = _smoke(0, ZYX)
    light_map = light_map_plain(grid, _env(False), torch.tensor(8, dtype=torch.int32),
                                FluidConfig(grid_size=ZYX[::-1], max_light_samples=8))
    origin, ray_dir, t_max, active = _rays(1, n=20 * 28)
    num = torch.tensor(32, dtype=torch.int32)
    g_out = _cotangent((len(active), 4), 1, seed=2)
    g_ref = grid.clone().requires_grad_(True)
    lm_ref = light_map.clone().requires_grad_(True)
    out = RC.view_march(g_ref, origin, ray_dir, t_max, num, _env(False), cfg, light_map=lm_ref,
                        active=active)
    (out * g_out).sum().backward()
    return cfg, grid, light_map, (origin, ray_dir, t_max, active), num, g_out, (g_ref.grad,
                                                                              lm_ref.grad)


def _view_model(cfg, grid, light_map, rays, num, g_out, mutant=None, warps=4):
    """The fetch schedule run on the replayed tapes over the rays as a (20,
    28) plane: the cotangents of the grid and the light map, the runs and
    walks per ray and the expected ones, the slot clashes, the counts
    written and expected, and whether the tape holds anything in slots no
    lane owns."""
    origin, ray_dir, t_max, active = rays
    entries, hits, views = _view_replay(grid, origin, ray_dir, t_max, num, cfg)
    act = active.numpy()
    want = act & (g_out != 0.0).any(dim=1).numpy()
    test = (g_out[:, 3] != 0.0).numpy() if mutant == "one_channel" else (g_out != 0.0).any(
        dim=1).numpy()
    walkable = test & (np.ones_like(act) if mutant == "walk_inactive" else act)
    plan = R.view_grad_plan((20, 28), ZYX, ZYX)
    events, slots, replayed, written = _fetch_schedule(plan, walkable, views, hits, warps, mutant)
    read, clashes, tape = _play(events, hits, entries, slots, cfg.max_ray_samples)
    ray = np.array([e[2] for e in events], dtype=np.int64)
    g_grid, g_lm = _view_back(grid, light_map, origin[ray], ray_dir[ray], read, hits[ray],
                              g_out[ray], num, cfg)
    runs = (replayed, np.bincount(ray, minlength=want.size))
    expect_runs = (want.astype(np.int64), want.astype(np.int64))
    expect = np.where(want[:, None], np.stack([views, hits], axis=1), 0)
    owned = np.zeros(slots, dtype=bool)
    owned[[e[3] for e in events]] = True
    stray = bool(np.isfinite(tape[~owned]).any())
    return (g_grid, g_lm), runs, expect_runs, clashes, written, expect, stray


def _runs_ok(runs, expect):
    return all(np.array_equal(a, b) for a, b in zip(runs, expect))


def test_view_grad_schedule_walks_each_ray_once():
    """R1b's persistent warps on `view_grad_plan`'s tiles: every active ray
    with a non-zero cotangent is run again and walked exactly once, no
    other ray is, no slot is taken while another walk in it runs, every
    ray's counts are written once (0 where skipped), the tape only in owned
    slots, and the gradients are autograd's through the plain `view_march`
    to rounding."""
    cfg, grid, light_map, rays, num, g_out, refs = _view_case()
    grads, runs, expect_runs, clashes, written, expect, stray = _view_model(
        cfg, grid, light_map, rays, num, g_out)
    want = expect_runs[0]
    assert 0.2 < want.mean() < 0.8 and rays[3].numpy()[want == 0].any()
    assert _runs_ok(runs, expect_runs)
    assert clashes == 0 and not stray
    assert np.array_equal(written, expect)
    assert all(_close(g, ref) for g, ref in zip(grads, refs))


@pytest.mark.parametrize("mutant", VIEW_MUTANTS)
def test_view_grad_schedule_catches_mutants(mutant):
    """The ray of each fetch's first lane lost, a lane's next ray in the
    slot after its last, a ray whose cotangent is non-zero in a colour
    channel only skipped, and the inactive rays walked: each breaks the
    walks, the slots or the gradients."""
    cfg, grid, light_map, rays, num, g_out, refs = _view_case()
    grads, runs, expect_runs, clashes, written, expect, _ = _view_model(
        cfg, grid, light_map, rays, num, g_out, mutant)
    assert not (_runs_ok(runs, expect_runs) and clashes == 0 and np.array_equal(written, expect)
                and all(_close(g, ref) for g, ref in zip(grads, refs)))


# ---------------------------------------------------------------------------
# The scratch and the source
# ---------------------------------------------------------------------------

def test_grad_scratch_matches_the_kernel_source():
    """`grad_tape_floats` is the formula and the constants that
    csrc/raymarch_grad.cu's launches check the tape against, with the work
    each launch reckons (R1b: CTAs of tiles' slots; R2b: a brick a warp);
    the lanes' tape is laid out as the models read it; and at ADJOINT's
    shapes (128^3, 64 light samples; 6 x 128^2 and 800^2 rays, 192 view
    samples) on 132 SMs, each launch's scratch stays under 256 MB at the
    CTAs an SM the launch bounds ask for (chip_smoke.py checks the card's
    own count)."""
    src = SRC.read_text()
    c = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (c["kViewGradThreads"], c["kViewGradCtas"], c["kLightGradWarps"], c["kLightGradCtas"],
            c["kMaxWarpRows"], c["kTapeFloats"]) == (
        R.VIEW_GRAD_THREADS, R.VIEW_GRAD_CTAS, R.LIGHT_GRAD_WARPS, R.LIGHT_GRAD_CTAS,
        R.MAX_WARP_ROWS, R.TAPE_FLOATS)
    assert ("return (resident < work ? resident : work) * threads * (int64_t)max_samples * "
            "kTapeFloats;") in src
    assert "if (tape_size < tape_floats(resident, kViewGradThreads, work, max_ray)) {" in src
    assert "const int64_t work = cdiv(p.slots, kViewGradThreads);" in src
    assert "if (tape_size < tape_floats(resident, threads, work, max_light)) {" in src
    assert "const int64_t work = cdiv((int64_t)br.nbx * br.nby * br.nbz, kLightGradWarps);" in src
    assert "constexpr int threads = kLightGradWarps * 32;" in src
    assert src.count("const int blocks = (int)(resident < work ? resident : work);") == 2
    assert "b.tape = Tape{(float*)tape, (int64_t)blocks * kViewGradThreads};" in src
    assert "b.tape = Tape{(float*)tape, (int64_t)blocks * threads};" in src
    assert "float* q = p + (int64_t)3 * j * n + r;" in src
    assert "__launch_bounds__(kViewGradThreads, kViewGradCtas)" in src
    assert "__launch_bounds__(kLightGradWarps * 32, kLightGradCtas)" in src
    assert "int64_t brick = (int64_t)blockIdx.x * warps + warp;" in src
    assert "const int64_t stride = (int64_t)gridDim.x * warps;" in src
    assert "const int64_t slot = (int64_t)blockIdx.x * kViewGradThreads + threadIdx.x;" in src
    assert "const int64_t slot = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;" in src
    assert "by * bz > kMaxWarpRows" in src
    assert R.grad_tape_floats(5, 128, 3, 10) == 3 * 128 * 10 * R.TAPE_FLOATS
    assert R.light_grad_plan((128, 128, 128)) == R.light_layout((128, 128, 128),
                                                                *R.LIGHT_GRAD_BRICK)
    assert R.LIGHT_GRAD_BRICK[0] * R.LIGHT_GRAD_BRICK[1] <= R.MAX_WARP_ROWS
    for lead in ((6, 128, 128), (800, 800)):
        plan = R.view_grad_plan(lead, (128, 128, 128), (128, 128, 128))
        assert 4 * R.grad_tape_floats(132 * R.VIEW_GRAD_CTAS, R.VIEW_GRAD_THREADS,
                                      -(-plan.slots // R.VIEW_GRAD_THREADS), 192) <= 256e6
    bricks = int(np.prod(R.light_grad_plan((128, 128, 128)).bricks))
    assert 4 * R.grad_tape_floats(132 * R.LIGHT_GRAD_CTAS, 32 * R.LIGHT_GRAD_WARPS,
                                  -(-bricks // R.LIGHT_GRAD_WARPS), 64) <= 256e6
    sig = _build._SIGNATURES
    assert sig["fx_view_march_grad"][:19] == sig["fx_view_march_grad_perthread"][:19]
    assert sig["fx_light_march_grad"][:10] == sig["fx_light_march_grad_perthread"][:10]
