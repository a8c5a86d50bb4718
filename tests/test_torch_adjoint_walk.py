"""The reverse walks of R1b and R2b (fluidx12_tpu_torch/csrc/raymarch_grad.cu)
as CPU models, against torch.autograd through the plain marches.

The card's backward kernels cannot run here, so their arithmetic is
modelled in torch, ray by ray in lock step, with the kernels' own tape and
recurrence: each ray's forward is run again and records, where it takes a
sample that counts (R1: a dense view sample; R2: every light sample), its
position t, its opacity or transmittance before the sample and the density
of the sample before (prev); the walk then takes those entries in reverse
and carries the adjoints of t, of the opacity or transmittance and of prev,
recomputing each sample's 8 CLAMP taps and scattering the taps' cotangents
(atomicAdd on the card, `index_add_` here).  Both models follow torch's own
derivative rules, as autograd applies them to the plain versions: a
`clamp_min` or `clamp_max` passes the gradient where its input equals the
bound, `abs` has derivative 0 at 0, `torch.where` sends it down the branch
taken, and `floor` none.

They are held to autograd through `render/raymarch_core.view_march`
(separate light) and `render/lightmap.light_map_plain` (no probe) at 16^3
on grids made from a seed with numpy, with branches taken both ways and
counted: view rays that die on opacity, leave the box, reach t_max or run
out of samples, light rays that die on transmittance, leave the box or run
out of samples, and rays that pass taps of +0 and -0 density."""

import math

import numpy as np
import pytest
import torch

from fluidx12_tpu_torch.core.config import FluidConfig
from fluidx12_tpu_torch.render import raymarch_core as RC
from fluidx12_tpu_torch.render.lightmap import light_map_plain
from fluidx12_tpu_torch.ops.sampling import texel_centres

# Several pytest workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)

F32 = torch.float32
ZYX = (16, 16, 16)
# kMaxDist and kInv2Pi of csrc/raymarch.cuh, as f32.
MAX_DIST = torch.tensor(2.0 * math.sqrt(3.0), dtype=F32)
INV_2PI = float(torch.tensor(1.0 / (2.0 * math.pi), dtype=F32))


# ---------------------------------------------------------------------------
# The kernels' pieces (csrc/raymarch.cuh, csrc/raymarch_grad.cu)
# ---------------------------------------------------------------------------

def _corners(uvw, zyx):
    """corners(): the 8 CLAMP taps' flat offsets (n, 8), bits (z, y, x) 000
    to 111, and the fractions (n, 3) of uvw (n, 3) on a (Z, Y, X) grid."""
    z, y, x = zyx
    sizes = torch.tensor([float(x), float(y), float(z)], dtype=F32)
    t = uvw * sizes - 0.5
    t0 = torch.floor(t)
    frac = t - t0
    hi = torch.tensor([x - 1, y - 1, z - 1])
    i = t0.long()
    i0 = torch.minimum(torch.clamp_min(i, 0), hi)
    i1 = torch.minimum(torch.clamp_min(i + 1, 0), hi)
    lin = torch.stack([(iz * y + iy) * x + ix for iz in (i0[:, 2], i1[:, 2])
                       for iy in (i0[:, 1], i1[:, 1]) for ix in (i0[:, 0], i1[:, 0])], dim=1)
    return lin, frac


def _sizes(zyx):
    z, y, x = zyx
    return torch.tensor([float(x), float(y), float(z)], dtype=F32)


def _lerp(v, f):
    """lerp_taps(): the trilinear value of taps v (n, 8), x, then y, then z."""
    fx, fy, fz = f.unbind(1)
    c00 = v[:, 0] + (v[:, 1] - v[:, 0]) * fx
    c01 = v[:, 2] + (v[:, 3] - v[:, 2]) * fx
    c10 = v[:, 4] + (v[:, 5] - v[:, 4]) * fx
    c11 = v[:, 6] + (v[:, 7] - v[:, 6]) * fx
    c0 = c00 + (c01 - c00) * fy
    c1 = c10 + (c11 - c10) * fy
    return c0 + (c1 - c0) * fz


def _lerp_grad(v, f, g):
    """lerp_taps_grad(): for the value's cotangent g (n,), the taps'
    cotangents (n, 8) and the fractions' (n, 3)."""
    fx, fy, fz = f.unbind(1)
    c00 = v[:, 0] + (v[:, 1] - v[:, 0]) * fx
    c01 = v[:, 2] + (v[:, 3] - v[:, 2]) * fx
    c10 = v[:, 4] + (v[:, 5] - v[:, 4]) * fx
    c11 = v[:, 6] + (v[:, 7] - v[:, 6]) * fx
    c0 = c00 + (c01 - c00) * fy
    c1 = c10 + (c11 - c10) * fy
    gfz = g * (c1 - c0)
    g1 = g * fz
    g0 = g - g1
    gfy = g0 * (c01 - c00) + g1 * (c11 - c10)
    g01 = g0 * fy
    g00 = g0 - g01
    g11 = g1 * fy
    g10 = g1 - g11
    gfx = ((g00 * (v[:, 1] - v[:, 0]) + g01 * (v[:, 3] - v[:, 2]))
           + g10 * (v[:, 5] - v[:, 4])) + g11 * (v[:, 7] - v[:, 6])
    w = []
    for gc in (g00, g01, g10, g11):
        hi = gc * fx
        w += [gc - hi, hi]
    return torch.stack(w, dim=1), torch.stack([gfx, gfy, gfz], dim=1)


def _get_step(dd, transm, density, scale):
    """get_step(): the adaptive step."""
    fe = (1.0 / 256.0) / torch.clamp_min(dd.abs(), 1.0 / 512.0)
    fu = torch.clamp_max(1.0 - density, 1.0)
    ft = 1.0 - transm
    return scale * torch.clamp_min(1.5 * fe * fu * ft, 1.0)


def _get_step_grad(dd, transm, density, scale, g):
    """get_step_grad(): for the step's cotangent g, the cotangents of dd,
    transm and density."""
    ad = dd.abs()
    den = torch.clamp_min(ad, 1.0 / 512.0)
    fe = (1.0 / 256.0) / den
    fu = torch.clamp_max(1.0 - density, 1.0)
    ft = 1.0 - transm
    p1 = 1.5 * fe
    p2 = p1 * fu
    gx = torch.where(p2 * ft >= 1.0, g * scale, 0.0)
    g_ft = gx * p2
    g_p2 = gx * ft
    g_fu = g_p2 * p1
    g_fe = (g_p2 * fu) * 1.5
    g_density = torch.where(1.0 - density <= 1.0, -g_fu, 0.0)
    g_ad = torch.where(ad >= 1.0 / 512.0, -g_fe * (fe / den), 0.0)
    return g_ad * torch.sign(dd), -g_ft, g_density


def _inside(p):
    return (p.abs() <= 1.0).all(dim=1)


def _put(tape, count, rows, *values):
    """Append an entry (values at `rows`) to those rows' tapes."""
    tape[rows, count[rows]] = torch.stack(values, dim=1)[rows]
    count[rows] += 1


# ---------------------------------------------------------------------------
# The models
# ---------------------------------------------------------------------------

def view_walk(grid, light_map, origin, ray_dir, t_max, active, num, cfg, g_out):
    """R1b: the cotangents of the (4, Z, Y, X) grid and the (3, Z', Y', X')
    light map from those of R1's separate-light output (n, 4); and how many
    rays stopped on opacity, at t_max, at the box's edge or on their sample
    count.  Rays whose cotangent is 0 or that are inactive are skipped."""
    zyx, lzyx = tuple(grid.shape[1:]), tuple(light_map.shape[1:])
    chans, lchans = grid.reshape(4, -1), light_map.reshape(3, -1)
    n = origin.shape[0]
    zero, absorb = cfg.zero_threshold, cfg.absorption
    scale = torch.div(MAX_DIST, num.to(F32))
    alive = active & (g_out != 0.0).any(dim=1)
    t, sa, prev = (torch.zeros(n, dtype=F32) for _ in range(3))
    tape = torch.zeros((n, cfg.max_ray_samples, 3), dtype=F32)
    hits = torch.zeros(n, dtype=torch.long)
    stops = dict(opacity=0, t_max=0, box=0, samples=0)
    for i in range(cfg.max_ray_samples):
        if i >= int(num):
            break
        p = origin + ray_dir * t[:, None]
        stops["box"] += int((alive & ~_inside(p)).sum())
        alive = alive & _inside(p)
        if not bool(alive.any()):
            break
        lin, f = _corners(p * 0.5 + 0.5, zyx)
        ca = _lerp(chans[3][lin], f)
        hit = alive & (ca > zero)
        _put(tape, hits, hit, t, sa, prev)
        transm = 1.0 - sa
        step = torch.where(hit, _get_step(ca - prev, transm, ca, scale), scale)
        sa = torch.where(hit, sa + ca * (absorb * transm), sa)
        opaque = hit & (1.0 - sa < zero)
        stops["opacity"] += int(opaque.sum())
        alive = alive & ~opaque
        prev = torch.where(hit, ca, prev)
        t_new = t + step
        stops["t_max"] += int((alive & ~(t_new <= t_max)).sum())
        alive = alive & (t_new <= t_max)
        t = torch.where(alive, t_new, t)
    stops["samples"] = int(alive.sum())

    g_grid = torch.zeros_like(chans)
    g_lm = torch.zeros_like(lchans)
    gs = g_out[:, :3] * INV_2PI
    a_t, a_prev = torch.zeros(n, dtype=F32), torch.zeros(n, dtype=F32)
    a_sa = g_out[:, 3].clone()
    sizes, lsizes = _sizes(zyx), _sizes(lzyx)
    for j in range(int(hits.max()) - 1, -1, -1):
        r = (hits > j).nonzero()[:, 0]
        t, sa_i, prev_i = tape[r, j].unbind(1)
        d = ray_dir[r]
        uvw = (origin[r] + d * t[:, None]) * 0.5 + 0.5
        lin, f = _corners(uvw, zyx)
        llin, lf = _corners(uvw, lzyx)
        taps, ltaps = chans[:, lin], lchans[:, llin]
        ca = _lerp(taps[3], f)
        col = [_lerp(taps[c], f) for c in range(3)]
        light = [_lerp(ltaps[c], lf) for c in range(3)]
        transm = 1.0 - sa_i
        k = absorb * transm
        e = col if cfg.pre_multiplied else [c * ca for c in col]
        g_e, g_l = [], []
        g_k = torch.zeros_like(k)
        for c in range(3):
            gp = gs[r, c] * k
            g_e.append(gp * light[c])
            g_l.append(gp * e[c])
            g_k = g_k + gs[r, c] * (e[c] * light[c])
        g_k = g_k + a_sa[r] * ca
        g_ca = a_sa[r] * k + a_prev[r]
        if cfg.pre_multiplied:
            g_col = g_e
        else:
            g_col = [g * ca for g in g_e]
            for c in range(3):
                g_ca = g_ca + g_e[c] * col[c]
        g_dd, g_transm, g_dens = _get_step_grad(ca - prev_i, transm, ca, scale, a_t[r])
        g_transm = g_transm + g_k * absorb
        g_ca = g_ca + g_dens + g_dd
        gf = torch.zeros((len(r), 3), dtype=F32)
        for c, g in ((3, g_ca), (0, g_col[0]), (1, g_col[1]), (2, g_col[2])):
            w, gfc = _lerp_grad(taps[c], f, g)
            g_grid[c].index_add_(0, lin.reshape(-1), w.reshape(-1))
            gf = gf + gfc
        lgf = torch.zeros((len(r), 3), dtype=F32)
        for c in range(3):
            w, gfc = _lerp_grad(ltaps[c], lf, g_l[c])
            g_lm[c].index_add_(0, llin.reshape(-1), w.reshape(-1))
            lgf = lgf + gfc
        gp = (gf * sizes + lgf * lsizes) * 0.5
        a_t[r] = a_t[r] + ((gp[:, 0] * d[:, 0] + gp[:, 1] * d[:, 1]) + gp[:, 2] * d[:, 2])
        a_sa[r] = a_sa[r] - g_transm
        a_prev[r] = -g_dd
    return g_grid.reshape(grid.shape), g_lm.reshape(light_map.shape), stops


def light_walk(grid, env, num, cfg, g_out):
    """R2b: the cotangent of the (4, Z, Y, X) grid (its density channel)
    from that of R2's (3, Z, Y, X) light map (no probe); and how many light
    rays died on transmittance, left the box or ran out of samples, and how
    many of their samples had 8 taps of +-0.  Empty voxels, and dense ones
    whose shadow's cotangent is 0, are skipped."""
    zyx = tuple(grid.shape[1:])
    dens = grid[3].reshape(-1)
    zero, absorb = cfg.zero_threshold, cfg.absorption
    cz, cy, cx = torch.meshgrid(*(texel_centres(m, F32, "cpu") * 2.0 - 1.0 for m in zyx),
                                indexing="ij")
    pos = torch.stack([cx, cy, cz], dim=-1).reshape(-1, 3)
    lc = env.light_color
    g = g_out.reshape(3, -1)
    g_shadow = (g[0] * lc[0] + g[1] * lc[1]) + g[2] * lc[2]
    lin, f = _corners(pos * 0.5 + 0.5, zyx)
    alive = (_lerp(dens[lin], f) >= zero) & (g_shadow != 0.0)
    if env.point_light:
        dv = env.light_pos - pos
        dirs = dv / torch.clamp_min(RC.norm3(dv), 1e-12)
    else:
        dirs = env.light_dir.expand(pos.shape)
    n = pos.shape[0]
    scale = torch.div(MAX_DIST, num.to(F32))
    t = scale.expand(n).clone()
    transm, prev = torch.ones(n, dtype=F32), torch.zeros(n, dtype=F32)
    tape = torch.zeros((n, cfg.max_light_samples, 3), dtype=F32)
    taken = torch.zeros(n, dtype=torch.long)
    stops = dict(transmittance=0, box=0, samples=0, zero_taps=0)
    for i in range(cfg.max_light_samples):
        if i >= int(num):
            break
        q = pos + dirs * t[:, None]
        stops["box"] += int((alive & ~_inside(q)).sum())
        alive = alive & _inside(q)
        if not bool(alive.any()):
            break
        _put(tape, taken, alive, t, transm, prev)
        lin, f = _corners(q * 0.5 + 0.5, zyx)
        taps = dens[lin]
        stops["zero_taps"] += int((alive & (taps == 0.0).all(dim=1)).sum())
        d = _lerp(taps, f)
        step = _get_step(d - prev, transm, d, scale)
        transm = torch.where(alive, transm * (1.0 - d * absorb), transm)
        dark = alive & ~(transm >= zero)
        stops["transmittance"] += int(dark.sum())
        alive = alive & ~dark
        t = torch.where(alive, t + step, t)
        prev = torch.where(alive, d, prev)
    stops["samples"] = int(alive.sum())

    g_dens = torch.zeros_like(dens)
    sizes = _sizes(zyx)
    a_transm, a_t, a_prev = g_shadow.clone(), torch.zeros(n, dtype=F32), torch.zeros(n, dtype=F32)
    for j in range(int(taken.max()) - 1, -1, -1):
        r = (taken > j).nonzero()[:, 0]
        t, transm_i, prev_i = tape[r, j].unbind(1)
        d = dirs[r]
        lin, f = _corners((pos[r] + d * t[:, None]) * 0.5 + 0.5, zyx)
        taps = dens[lin]
        s = _lerp(taps, f)
        g_transm = a_transm[r] * (1.0 - s * absorb)
        g_s = -(a_transm[r] * transm_i) * absorb + a_prev[r]
        g_dd, g_tr, g_sd = _get_step_grad(s - prev_i, transm_i, s, scale, a_t[r])
        g_transm = g_transm + g_tr
        g_s = g_s + g_sd + g_dd
        w, gf = _lerp_grad(taps, f, g_s)
        g_dens.index_add_(0, lin.reshape(-1), w.reshape(-1))
        gp = gf * sizes * 0.5
        a_t[r] = a_t[r] + ((gp[:, 0] * d[:, 0] + gp[:, 1] * d[:, 1]) + gp[:, 2] * d[:, 2])
        a_transm[r] = g_transm
        a_prev[r] = -g_dd
    g_grid = torch.zeros_like(grid)
    g_grid[3] = g_dens.reshape(zyx)
    return g_grid, stops


# ---------------------------------------------------------------------------
# Inputs made from a seed
# ---------------------------------------------------------------------------

def _smoke(seed, zyx=ZYX):
    """A (4, Z, Y, X) f32 colour grid: smooth smoke (density up to about
    0.6), a dense core of 0.95 that rays die in, an empty slab above it
    (light rays toward +y cross it) whose zeros are half of them -0.0, and
    rgb below the density."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.0, 0.8, zyx).astype(np.float32)
    for ax in range(3):
        d = (np.roll(d, 1, ax) + d + np.roll(d, -1, ax)) / 3
    d = np.maximum(d - 0.3, 0.0) * 3.0
    z, y, x = zyx
    d[z // 2 - 3:z // 2 + 3, y // 2 - 3:y // 2 + 1, x // 2 - 3:x // 2 + 3] = 0.95
    d[:, y // 2 + 2:y * 3 // 4 + 1] = 0.0
    d[:, y // 2 + 2:y * 3 // 4 + 1, : x // 2] = -0.0
    rgb = d[None] * rng.uniform(0.3, 1.0, (3, 1, 1, 1)).astype(np.float32)
    return torch.from_numpy(np.concatenate([rgb, d[None]]).astype(np.float32))


def _env(point: bool):
    """A light environment of a directional light toward +x +y -z, or of a
    point light inside the volume."""
    return RC.LightEnv(
        light_dir=torch.nn.functional.normalize(torch.tensor([0.6, 0.7, -0.4]), dim=0),
        light_pos=torch.tensor([0.5, 0.2, -0.3]),
        light_color=torch.tensor([3.1, 2.2, 0.9]), ambient=torch.tensor([4.7, 4.7, 4.7]),
        world3x3=torch.eye(3), sh_coeffs=torch.zeros(9, 3), has_probe=False, point_light=point)


def _rays(seed, n=600):
    """Rays from points in and around the box toward random directions and
    toward the dense core, entered into the box; t_max finite on a third;
    a tenth inactive."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.6, 1.6, (n, 3)).astype(np.float32)
    aim = np.where(rng.uniform(size=(n, 1)) < 0.5,
                   rng.standard_normal((n, 3)), rng.uniform(-0.2, 0.2, (n, 3)) - o)
    d = (aim / np.linalg.norm(aim, axis=-1, keepdims=True)).astype(np.float32)
    origin, ray_dir = torch.from_numpy(o), torch.from_numpy(d)
    origin, hit = RC.compute_ray_origin(origin, ray_dir)
    t_max = torch.from_numpy(np.where(rng.uniform(size=n) < 0.33, rng.uniform(0.1, 1.5, n),
                                      np.inf).astype(np.float32))
    return origin, ray_dir, t_max, hit & torch.from_numpy(rng.uniform(size=n) < 0.9)


# (max samples, the count the frame binds): max below the count ends rays
# on the max.
SAMPLES = {"max": (24, 24), "max_below_count": (6, 24)}


def _close(got, ref, what):
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    print(f"{what}: max |autograd| {scale:.4g}, max |model - autograd| {err:.3g}")
    assert scale > 0.0 and err <= 2e-6 * scale


@pytest.mark.parametrize("samples", list(SAMPLES))
@pytest.mark.parametrize("premultiplied", [True, False], ids=["premultiplied", "straight"])
def test_view_walk_equals_autograd(samples, premultiplied):
    """R1b's model against autograd through the plain separate-light march,
    for the grid and the light map, with a seeded cotangent on every ray;
    every way a ray stops is taken."""
    max_ray, count = SAMPLES[samples]
    cfg = FluidConfig(grid_size=ZYX[::-1], max_ray_samples=max_ray,
                      pre_multiplied=premultiplied)
    grid = _smoke(0)
    light_map = light_map_plain(grid, _env(False), torch.tensor(8, dtype=torch.int32),
                                FluidConfig(grid_size=ZYX[::-1], max_light_samples=8))
    origin, ray_dir, t_max, active = _rays(1)
    num = torch.tensor(count, dtype=torch.int32)
    g_out = torch.from_numpy(np.random.default_rng(2).standard_normal((len(active), 4))
                             .astype(np.float32))
    g_ref = grid.clone().requires_grad_(True)
    lm_ref = light_map.clone().requires_grad_(True)
    out = RC.view_march(g_ref, origin, ray_dir, t_max, num, _env(False), cfg, light_map=lm_ref,
                        active=active)
    (out * g_out).sum().backward()
    g_grid, g_lm, stops = view_walk(grid, light_map, origin, ray_dir, t_max, active, num, cfg,
                                    g_out)
    print(f"view rays stopped: {stops}")
    assert all(v > 0 for k, v in stops.items() if k != "samples" or samples != "max")
    _close(g_grid, g_ref.grad, "R1b model, grid")
    _close(g_lm, lm_ref.grad, "R1b model, light map")


@pytest.mark.parametrize("samples", list(SAMPLES))
@pytest.mark.parametrize("point", [False, True], ids=["directional", "point"])
def test_light_walk_equals_autograd(samples, point):
    """R2b's model against autograd through `light_map_plain` (no probe),
    directional and point light, with a seeded cotangent on the map;
    every way a light ray stops is taken, and samples with 8 taps of +-0
    pass their cotangent to the taps."""
    max_light, count = SAMPLES[samples]
    cfg = FluidConfig(grid_size=ZYX[::-1], max_light_samples=max_light)
    grid = _smoke(3)
    env = _env(point)
    num = torch.tensor(count, dtype=torch.int32)
    g_out = torch.from_numpy(np.random.default_rng(4).standard_normal((3,) + ZYX)
                             .astype(np.float32))
    g_ref = grid.clone().requires_grad_(True)
    (light_map_plain(g_ref, env, num, cfg) * g_out).sum().backward()
    g_grid, stops = light_walk(grid, env, num, cfg, g_out)
    print(f"light rays stopped: {stops}")
    assert all(v > 0 for k, v in stops.items() if k != "samples" or samples != "max")
    assert float(g_ref.grad[:3].abs().max()) == 0.0
    _close(g_grid, g_ref.grad, "R2b model, grid")
    zeros = grid[3] == 0.0
    assert float(g_ref.grad[3][zeros].abs().max()) > 0.0
