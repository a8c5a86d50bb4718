"""The z-marches' launch plan and schedules (fluidx12_tpu_torch/csrc/stencil.cu
divergence_march_kernel, residual_march_kernel, prolong_march_kernel,
grad_damp_march_kernel, gradient_march_kernel: B3, B5, B7, B8, B15) on the
CPU: `stencil_plan` owns every fine cell exactly once, its chunks tile z
(ragged last chunk included), its constants are those the kernel source
compiles, and a torch model of each schedule -- what each CTA reads of the
velocity, q, the density or the coarse correction, or stages of uy, q or
the pressure, NaN wherever it reads or holds nothing -- gives
`divergence_plain`, `residual_plain`, `prolong_correct_plain`,
`grad_damp_plain` and `gradient3_plain` bit for bit on small ragged shapes.
A window one cell short is caught.  The plain versions themselves are held
to the Pallas kernels in interpret mode by tests/test_torch_projection.py
(B15's by tests/test_torch_slab.py and tests/test_torch_gi.py)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fluidx12_tpu_torch.ops.cuda import _build
from fluidx12_tpu_torch.ops.cuda import stencil as ST

# Several pytest workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)

NAN = float("nan")
RHO = 0.48


def _rand(shape, seed, lo=-1.0, hi=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32))


def _forced(kind, zyx, quads=None, chunk=None):
    """`stencil_plan`'s plan on zyx with its quads or chunk forced."""
    plan = ST.stencil_plan(kind, zyx)
    return ST.stencil_layout(kind, zyx, quads or plan.quads, chunk or plan.chunk)


def _ring_bytes(quads, rows, c):
    """B8's ring for a CTA of `quads` x `rows` threads, by csrc/stencil.cu
    ring_smem with its constants `c`."""
    return c["kRing"] * (rows + 2) * (c["kQuad"] * quads + 2 * c["kPad"]) * 4


def _ctas(plan, zyx, kind):
    """Each CTA's owned (fine) ranges [x0, xe), [y0, ye), and its planes
    [p0, p1): coarse planes for B7, planes for B8."""
    nz, ny, nx = zyx
    planes = ST._planes(kind, nz)
    for i in range(plan.grid[0]):
        x0 = i * plan.quads * ST.QUAD
        for j in range(plan.grid[1]):
            y0 = j * plan.rows
            for k in range(plan.grid[2]):
                p0 = k * plan.chunk
                yield (x0, min(x0 + plan.quads * ST.QUAD, nx), y0, min(y0 + plan.rows, ny),
                       p0, min(p0 + plan.chunk, planes))


# The 3D paths' grids (128^3, 256^3, the 256x256x60 and 150^3 frames), then
# small ones: a ragged X of 38 (not a multiple of 4), odd chunk counts, and
# odd dims (B8 only).
PLANS = [(128, 128, 128), (256, 256, 256), (60, 256, 256), (150, 150, 150), (22, 30, 38),
         (14, 10, 38), (5, 3, 7)]


def _zyx_id(zyx):
    return "x".join(map(str, zyx))


# B7 and B8 on every grid (one case a grid), then B3, B5 and B15 (one case
# a kind and grid).
PLAN_CASES = ([pytest.param(("prolong", "grad_damp"), zyx, id=_zyx_id(zyx)) for zyx in PLANS]
              + [pytest.param((kind,), zyx, id=f"{kind}-{_zyx_id(zyx)}")
                 for kind in ("divergence", "residual", "gradient3") for zyx in PLANS])


@pytest.mark.parametrize("kinds,zyx", PLAN_CASES)
def test_stencil_plan_owns_every_cell_once(kinds, zyx):
    """The CTAs' owned x, y and plane ranges partition the volume (B7's
    coarse plane m owning fine planes 2m and 2m + 1) and each CTA's chunk
    is the plan's, the last one ragged where the chunk does not divide;
    the CTA is CTA_THREADS threads, its ring the formula's; the quads are
    the choice that leaves the fewest lanes idle at the x edge; at 128^3
    every kernel launches at least two CTAs an SM."""
    nz, ny, nx = zyx
    for kind in kinds:
        if kind == "prolong" and any(n % 2 for n in zyx):
            continue
        plan = ST.stencil_plan(kind, zyx)
        assert plan.quads in ST.QUAD_CHOICES and plan.quads * plan.rows == ST.CTA_THREADS
        nq = -(-nx // ST.QUAD)
        assert all(-(-nq // plan.quads) * plan.quads <= -(-nq // w) * w
                   for w in ST.QUAD_CHOICES)
        assert plan == ST.stencil_layout(kind, zyx, plan.quads, plan.chunk)
        writes = np.zeros(zyx, dtype=np.int32)
        planes = ST._planes(kind, nz)
        for x0, xe, y0, ye, p0, p1 in _ctas(plan, zyx, kind):
            assert x0 < xe and y0 < ye and p0 < p1
            assert p1 - p0 == plan.chunk or p1 == planes
            z0, z1 = (2 * p0, 2 * p1) if kind == "prolong" else (p0, p1)
            writes[z0:z1, y0:ye, x0:xe] += 1
        assert (writes == 1).all()
        if zyx == (128, 128, 128):
            assert np.prod(plan.grid) >= 2 * ST.SMS


def test_stencil_plan_matches_the_kernel_source():
    """The constants `stencil_plan` uses are those csrc/stencil.cu compiles
    (a quad of 4, CTAs of 256 threads, a ring of 3 planes, rows padded by 4
    floats) with its ring formula and the quads its launches take, and the
    ring fits without raising the shared-memory limit; the plan refuses
    what the kernels cannot run."""
    src = (Path(ST.__file__).parents[2] / "csrc" / "stencil.cu").read_text()
    c = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (ST.QUAD, ST.CTA_THREADS, ST.RING, ST.PAD) == (
        c["kQuad"], c["kCtaThreads"], c["kRing"], c["kPad"])
    assert ST.HALO == 1 and ST.PAD >= ST.HALO and ST.PAD % 4 == 0
    assert ("return kRing * (rows + 2) * (kQuad * quads + 2 * kPad) * (int)sizeof(float);"
            in src)
    assert "(quads == 8 || quads == 16 || quads == 32) && quads * rows == kCtaThreads" in src
    assert set(ST.QUAD_CHOICES) == {8, 16, 32}
    assert "ring_smem(quads, rows), cs>>>" in src
    assert max(_ring_bytes(q, ST.CTA_THREADS // q, c) for q in ST.QUAD_CHOICES) <= 48 * 1024
    assert 48 * 1024 <= _build.SMEM_PER_CTA
    # The plan admits volumes whose three velocity channels span 2^31
    # elements or more: B8 forms each channel's base in 64 bits.
    assert ST.stencil_plan("grad_damp", (4096, 512, 512)).grid[2] >= 1
    assert "T* const fc[3] = {f, f + (int64_t)n, f + 2 * (int64_t)n};" in src
    for kind, zyx in (("prolong", (3, 8, 8)), ("prolong", (4, 8, 6 + 1)), ("grad_damp", (0, 8, 8)),
                      ("grad_damp", (1300, 1300, 1300)), ("grad_damp", (4, 70000 * 32, 1)),
                      ("other", (4, 8, 8)), ("grad_damp", (4, 8, -3))):
        with pytest.raises(ValueError):
            ST.stencil_plan(kind, zyx)


def _uy_bytes(quads, rows, esize, c):
    """B3's uy ring for a CTA of `quads` x `rows` threads, by
    csrc/stencil.cu uy_smem with its constants `c`: kRing planes of its
    rows and HALO rows either side."""
    return c["kRing"] * (rows + 2 * ST.HALO) * c["kQuad"] * quads * esize


@pytest.mark.parametrize("kind", ["divergence", "residual"])
def test_march_kind_matches_the_kernel_source(kind):
    """B3's and B5's launches take the plan whole (quads, rows, chunk), the
    C launch refuses what `march_ok` refuses as B7's and B8's do, their
    shared memory fits without raising the limit (B5: B8's ring, staged as
    B8 stages it; B3: a ring of uy planes), B3 forms its channels' bases in 64
    bits and exchanges ux within a CTA row (`quads` lanes, a power of two
    at most a warp), and the plan refuses what the kernels cannot run."""
    src = (Path(ST.__file__).parents[2] / "csrc" / "stencil.cu").read_text()
    c = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert _build._SIGNATURES[f"fx_{kind}"][-4:-1] == [_build._I] * 3
    assert f"fx_{kind}_perthread" in _build._SIGNATURES
    entry = src[src.index(f"int fx_{kind}("):]
    assert "!march_ok(quads, rows, chunk, nz, ny, nx)" in entry[:entry.index("}")]
    assert "(int64_t)nz * ny * nx >= (1LL << 31)" in entry[:entry.index("}")]
    if kind == "residual":
        assert ("residual_march_kernel<kVec><<<grid, dim3(quads, rows), "
                "ring_smem(quads, rows), cs>>>") in src
        assert "cp_async<4 * kVec>(drow + k * kVec, srow + x0 + k * kVec);" in src
        assert max(_ring_bytes(q, ST.CTA_THREADS // q, c) for q in ST.QUAD_CHOICES) <= 48 * 1024
    else:
        assert "return kRing * (rows + 2) * kQuad * quads * esize;" in src
        assert "<<<grid, dim3(quads, rows), uy_smem(quads, rows, (int)sizeof(T)), cs>>>" in src
        assert max(_uy_bytes(q, ST.CTA_THREADS // q, 4, c) for q in ST.QUAD_CHOICES) <= 15 * 1024
        assert "const T* const uz = f + 2 * (int64_t)n;" in src
        assert "__shfl_up_sync(0xffffffffu, cur.ux[kQuad - 1], 1, quads)" in src
        assert "__shfl_down_sync(0xffffffffu, cur.ux[0], 1, quads)" in src
        assert all(q <= 32 and q & (q - 1) == 0 for q in ST.QUAD_CHOICES)
        # The gate admits 2^30 cells, where channel 2 starts at 2^31 elements.
        assert ST.stencil_plan(kind, (4096, 512, 512)).grid[2] >= 1
    for zyx in ((0, 8, 8), (1300, 1300, 1300), (4, 70000 * 32, 1), (4, 8, -3)):
        with pytest.raises(ValueError):
            ST.stencil_plan(kind, zyx)
    assert ST.stencil_plan(kind, (3, 5, 7)).grid == ST.stencil_plan("grad_damp", (3, 5, 7)).grid


def _prolong_model(q, e_c, plan, halo=None):
    """prolong_march_kernel's schedule: CTA (i, j, k) reads the coarse
    planes [m0 - HALO, m1 - 1 + HALO], rows and columns its fine rows and
    columns reach by HALO either side (all clipped), and nothing else (NaN
    elsewhere).  Each thread upsamples a coarse plane on the columns 2k - 1
    .. 2k + 2 of its quad (clamped), fine x 4k + i taking columns (0, 1),
    (1, 2), (1, 2), (2, 3) with the plain version's weights, and lerps U(m
    - 1), U(m), U(m + 1) (clamped) in z.  Returns (out, writes)."""
    halo = ST.HALO if halo is None else halo
    nz, ny, nx = q.shape
    nzc, nyc, nxc = e_c.shape
    y_lo, y_hi, wy_lo, wy_hi = ST._prolong_taps(nyc, "cpu")
    _, _, wx_lo, wx_hi = ST._prolong_taps(nxc, "cpu")
    out = torch.full(q.shape, NAN)
    writes = torch.zeros(q.shape, dtype=torch.int32)
    for x0, xe, y0, ye, m0, m1 in _ctas(plan, q.shape, "prolong"):
        view = torch.full(e_c.shape, NAN)
        zs = slice(max(m0 - halo, 0), min(m1 - 1 + halo, nzc - 1) + 1)
        ys = slice(max((y0 >> 1) - halo, 0), min(((ye - 1) >> 1) + halo, nyc - 1) + 1)
        xs = slice(max((x0 >> 1) - halo, 0), min(((xe - 1) >> 1) + halo, nxc - 1) + 1)
        view[zs, ys, xs] = e_c[zs, ys, xs]
        xq = torch.arange(x0, xe, ST.QUAD)                                   # quad starts
        cols = ((xq >> 1)[:, None] - 1 + torch.arange(4)).clamp(0, nxc - 1)  # (quads, 4)
        fx = torch.arange(x0, xe)
        quad = (fx - x0) // ST.QUAD
        first = torch.tensor([0, 1, 1, 2])[(fx - x0) % ST.QUAD]  # each fine x's first column
        yy = torch.arange(y0, ye)

        def upsample(m):
            m = min(max(m, 0), nzc - 1)
            a = (wy_lo[yy][:, None, None] * view[m][y_lo[yy]][:, cols]
                 + wy_hi[yy][:, None, None] * view[m][y_hi[yy]][:, cols])   # (rows, quads, 4)
            return (wx_lo[fx] * a[:, quad, first] + wx_hi[fx] * a[:, quad, first + 1])

        um, uc = upsample(m0 - 1), upsample(m0)
        for m in range(m0, m1):
            up = upsample(m + 1)
            for z, e in ((2 * m, 0.25 * um + 0.75 * uc), (2 * m + 1, 0.75 * uc + 0.25 * up)):
                out[z, y0:ye, x0:xe] = q[z, y0:ye, x0:xe] + e
                writes[z, y0:ye, x0:xe] += 1
            um, uc = uc, up
    return out, writes


def _ring_view(vol, cta, halo):
    """What a CTA of B8 (or B5) holds of the f32 volume `vol`, in
    coordinates offset by 1 (cell (z, y, x) at [z + 1, y + 1, x + 1]): its
    ring's planes [z0, ze - 1 + halo] (plane Z is plane Z - 1 again) of
    rows [y0 - halo, ye - 1 + halo] and columns [x0 - halo, xe - 1 + halo],
    each cell holding `vol` at its coordinates clamped to the volume, and
    plane z0 - halo of its own cells (clamped), read from device memory;
    NaN elsewhere."""
    x0, xe, y0, ye, z0, ze = cta
    nz, ny, nx = vol.shape

    def clamped(zr, yr, xr):
        return vol[zr.clamp(0, nz - 1)][:, yr.clamp(0, ny - 1)][:, :, xr.clamp(0, nx - 1)]

    view = torch.full((nz + 2, ny + 2, nx + 2), NAN)
    zr = torch.arange(z0, ze + halo)
    yr = torch.arange(y0 - halo, ye + halo)
    xr = torch.arange(x0 - halo, xe + halo)
    view[zr[:, None, None] + 1, yr[:, None] + 1, xr + 1] = clamped(zr, yr, xr)
    own_y, own_x = torch.arange(y0, ye), torch.arange(x0, xe)
    zm = torch.tensor([z0 - halo])
    view[z0 - halo + 1, y0 + 1:ye + 1, x0 + 1:xe + 1] = clamped(zm, own_y, own_x)[0]
    return view


def _grad_model(pressure, plan, halo=None):
    """grad_damp_march_kernel's schedule, as the pressure differences each
    cell sees: CTA (i, j, k) stages planes [z0, ze - 1 + HALO] (plane Z is
    plane Z - 1 again) of rows [y0 - HALO, ye - 1 + HALO] and columns [x0
    - HALO, xe - 1 + HALO], each cell holding p at its coordinates clamped
    to the volume, and reads plane z0 - HALO of its own cells (clamped)
    from device memory; NaN wherever it holds nothing.  gx and gy come from
    plane z, gz from planes z + 1 and z - 1, as plain reads at the
    unclamped neighbours.  Returns ([dx, dy, dz], writes)."""
    halo = ST.HALO if halo is None else halo
    diffs = [torch.full(pressure.shape, NAN) for _ in range(3)]
    writes = torch.zeros(pressure.shape, dtype=torch.int32)

    for cta in _ctas(plan, pressure.shape, "grad_damp"):
        x0, xe, y0, ye, z0, ze = cta
        view = _ring_view(pressure, cta, halo)
        region = (slice(z0, ze), slice(y0, ye), slice(x0, xe))
        diffs[0][region] = view[z0 + 1:ze + 1, y0 + 1:ye + 1, x0 + 2:xe + 2] - view[
            z0 + 1:ze + 1, y0 + 1:ye + 1, x0:xe]
        diffs[1][region] = view[z0 + 1:ze + 1, y0 + 2:ye + 2, x0 + 1:xe + 1] - view[
            z0 + 1:ze + 1, y0:ye, x0 + 1:xe + 1]
        diffs[2][region] = view[z0 + 2:ze + 2, y0 + 1:ye + 1, x0 + 1:xe + 1] - view[
            z0:ze, y0 + 1:ye + 1, x0 + 1:xe + 1]
        writes[region] += 1
    return diffs, writes


def _grad_damp_scheduled(monkeypatch, fields, pressure, plan, halo=None):
    """`grad_damp_plain` with its pressure differences taken from the
    schedule model: the damp is per cell and the same arithmetic."""
    diffs, writes = _grad_model(pressure, plan, halo)
    by_axis = {ST._AX_X: diffs[0], ST._AX_Y: diffs[1], ST._AX_Z: diffs[2]}
    with monkeypatch.context() as m:
        m.setattr(ST, "_diff", lambda q, axis: by_axis[axis])
        out = ST.grad_damp_plain(fields, pressure, RHO)
    return out, writes


# Shapes with a ragged X of 38 (quads over the edge), 6 and 7 coarse planes
# in chunks of 2 (a ragged last chunk), several row tiles, and odd
# coarse dims.
PROLONG_CASES = [((14, 10, 38), None, 2), ((12, 34, 38), 8, 2), ((6, 18, 70), 16, 4),
                 ((10, 6, 6), None, 3)]


@pytest.mark.parametrize("zyx,quads,chunk", PROLONG_CASES,
                         ids=[str(i) for i in range(len(PROLONG_CASES))])
def test_prolong_schedule_matches_plain(zyx, quads, chunk):
    """B7's schedule writes every fine cell once and equals
    `prolong_correct_plain` bit for bit."""
    q = _rand(zyx, sum(zyx), -0.05, 0.05)
    e_c = _rand(tuple(n // 2 for n in zyx), sum(zyx) + 1, -0.1, 0.1)
    out, writes = _prolong_model(q, e_c, _forced("prolong", zyx, quads, chunk))
    assert (writes == 1).all()
    assert torch.equal(out, ST.prolong_correct_plain(q, e_c))


GRAD_CASES = [((7, 10, 38), torch.bfloat16, None, 2), ((9, 34, 38), torch.float32, 8, 4),
              ((5, 3, 7), torch.bfloat16, None, 3), ((6, 18, 70), torch.bfloat16, 16, 1)]


@pytest.mark.parametrize("zyx,dtype,quads,chunk", GRAD_CASES,
                         ids=[str(i) for i in range(len(GRAD_CASES))])
def test_grad_damp_schedule_matches_plain(monkeypatch, zyx, dtype, quads, chunk):
    """B8's schedule writes every cell once and gives `grad_damp_plain` bit
    for bit, bf16 and f32 storage, on ragged and odd shapes and chunks."""
    fields = _rand((4,) + zyx, sum(zyx), -0.75, 0.75).to(dtype)
    p = _rand(zyx, sum(zyx) + 1)
    got, writes = _grad_damp_scheduled(monkeypatch, fields.clone(), p,
                                       _forced("grad_damp", zyx, quads, chunk))
    assert (writes == 1).all()
    assert torch.equal(got, ST.grad_damp_plain(fields.clone(), p, RHO))


def test_a_window_one_cell_short_is_caught(monkeypatch):
    """With the reach one cell short (HALO 0), the models read cells no CTA
    reads or holds (NaN) and disagree with the plain versions: the schedule
    tests can see a short halo."""
    zyx = (12, 34, 38)
    q = _rand(zyx, 5, -0.05, 0.05)
    e_c = _rand(tuple(n // 2 for n in zyx), 6, -0.1, 0.1)
    plan = _forced("prolong", zyx, 8, 2)
    out, _ = _prolong_model(q, e_c, plan, halo=0)
    assert not torch.equal(out, ST.prolong_correct_plain(q, e_c))
    fields = _rand((4,) + zyx, 7, -0.75, 0.75).to(torch.bfloat16)
    p = _rand(zyx, 8)
    got, _ = _grad_damp_scheduled(monkeypatch, fields.clone(), p,
                                  _forced("grad_damp", zyx, 8, 4), halo=0)
    assert not torch.equal(got, ST.grad_damp_plain(fields.clone(), p, RHO))


def _residual_model(q, b, plan, halo=None):
    """residual_march_kernel's schedule: each CTA holds q as B8's ring holds
    the pressure (`_ring_view`) and b at its own cells; x+-, y+- and the
    centre from plane z, z+ from plane z + 1, z- from plane z - 1, as plain
    reads at the unclamped neighbours, summed in the kernel's order.
    Returns (r, writes)."""
    halo = ST.HALO if halo is None else halo
    out = torch.full(q.shape, NAN)
    writes = torch.zeros(q.shape, dtype=torch.int32)
    for cta in _ctas(plan, q.shape, "residual"):
        x0, xe, y0, ye, z0, ze = cta
        v = _ring_view(q, cta, halo)
        zs, ys, xs = slice(z0 + 1, ze + 1), slice(y0 + 1, ye + 1), slice(x0 + 1, xe + 1)
        s = v[zs, ys, x0 + 2:xe + 2] + v[zs, ys, x0:xe]
        s = s + v[zs, y0 + 2:ye + 2, xs]
        s = s + v[zs, y0:ye, xs]
        s = s + v[z0:ze, ys, xs]
        s = s + v[z0 + 2:ze + 2, ys, xs]
        region = (slice(z0, ze), slice(y0, ye), slice(x0, xe))
        out[region] = b[region] - (s - 6.0 * v[zs, ys, xs])
        writes[region] += 1
    return out, writes


def _div_model(fields, plan, halo=None):
    """divergence_march_kernel's schedule: CTA (i, j, k) holds, of planes
    [z0, ze), ux at its own rows and columns and the lane exchange's two
    ends (columns x0 - halo .. xe - 1 + halo), uy at rows y0 - halo .. ye -
    1 + halo of its columns (the staged buffer), and uz at planes z0 - halo
    .. ze - 1 + halo of its own cells (the registers), all clipped to the
    volume; NaN elsewhere.  Each channel's neighbours along its axis are
    read at the clamped coordinates, cast to f32, and summed as
    0.5 * ((dx + dy) + dz).  Returns (div, writes)."""
    halo = ST.HALO if halo is None else halo
    nz, ny, nx = fields.shape[1:]
    u = fields[:3].float()
    out = torch.full((nz, ny, nx), NAN)
    writes = torch.zeros((nz, ny, nx), dtype=torch.int32)
    for x0, xe, y0, ye, z0, ze in _ctas(plan, (nz, ny, nx), "divergence"):
        held = torch.full((3, nz, ny, nx), NAN)
        xs = slice(max(x0 - halo, 0), min(xe + halo, nx))
        ys = slice(max(y0 - halo, 0), min(ye + halo, ny))
        zs = slice(max(z0 - halo, 0), min(ze + halo, nz))
        held[0, z0:ze, y0:ye, xs] = u[0, z0:ze, y0:ye, xs]
        held[1, z0:ze, ys, x0:xe] = u[1, z0:ze, ys, x0:xe]
        held[2, zs, y0:ye, x0:xe] = u[2, zs, y0:ye, x0:xe]
        zr, yr, xr = torch.arange(z0, ze), torch.arange(y0, ye), torch.arange(x0, xe)
        own = held[:, z0:ze, y0:ye]
        dx = (own[0][:, :, (xr + 1).clamp(max=nx - 1)] - own[0][:, :, (xr - 1).clamp(min=0)])
        hy = held[1, z0:ze, :, x0:xe]
        dy = hy[:, (yr + 1).clamp(max=ny - 1)] - hy[:, (yr - 1).clamp(min=0)]
        hz = held[2, :, y0:ye, x0:xe]
        dz = hz[(zr + 1).clamp(max=nz - 1)] - hz[(zr - 1).clamp(min=0)]
        out[z0:ze, y0:ye, x0:xe] = 0.5 * ((dx + dy) + dz)
        writes[z0:ze, y0:ye, x0:xe] += 1
    return out, writes


# Shapes with a ragged X of 38 and X = 150 (a last quad of two columns, rows
# only 4- or 8-byte aligned), several x and row tiles, ragged last chunks,
# chunks of one plane, and odd dims.
DIV_CASES = [((7, 10, 38), torch.bfloat16, None, 2), ((9, 34, 38), torch.float32, 8, 4),
             ((5, 3, 7), torch.bfloat16, None, 3), ((6, 18, 70), torch.bfloat16, 16, 1),
             ((3, 5, 150), torch.float32, None, 2)]


@pytest.mark.parametrize("zyx,dtype,quads,chunk", DIV_CASES,
                         ids=[str(i) for i in range(len(DIV_CASES))])
def test_divergence_schedule_matches_plain(zyx, dtype, quads, chunk):
    """B3's schedule writes every cell once and equals `divergence_plain`
    bit for bit, bf16 and f32 storage, reading channels 0..2 only."""
    fields = _rand((4,) + zyx, sum(zyx), -0.75, 0.75).to(dtype)
    fields[3] = NAN
    out, writes = _div_model(fields, _forced("divergence", zyx, quads, chunk))
    assert (writes == 1).all()
    assert torch.equal(out, ST.divergence_plain(fields))


RESIDUAL_CASES = [((7, 10, 38), None, 2), ((9, 34, 38), 8, 4), ((5, 3, 7), None, 3),
                  ((6, 18, 70), 16, 1), ((3, 5, 150), None, 2)]


@pytest.mark.parametrize("zyx,quads,chunk", RESIDUAL_CASES,
                         ids=[str(i) for i in range(len(RESIDUAL_CASES))])
def test_residual_schedule_matches_plain(zyx, quads, chunk):
    """B5's schedule writes every cell once and equals `residual_plain` bit
    for bit on ragged and odd shapes and chunks."""
    q, b = _rand(zyx, sum(zyx), -0.05, 0.05), _rand(zyx, sum(zyx) + 1)
    out, writes = _residual_model(q, b, _forced("residual", zyx, quads, chunk))
    assert (writes == 1).all()
    assert torch.equal(out, ST.residual_plain(q, b))


@pytest.mark.parametrize("kind", ["divergence", "residual"])
def test_a_march_window_one_cell_short_is_caught(kind):
    """With the reach one cell short (HALO 0: no uy halo rows, no ux
    exchange ends, no uz planes beyond the chunk for B3; no ring halo for
    B5), the models read cells no CTA holds (NaN) and disagree with the
    plain versions."""
    zyx = (12, 34, 38)
    plan = _forced(kind, zyx, 8, 2)
    assert plan.grid[0] > 1 and plan.grid[1] > 1 and plan.grid[2] > 1
    if kind == "divergence":
        fields = _rand((3,) + zyx, 9, -0.75, 0.75).to(torch.bfloat16)
        ref = ST.divergence_plain(fields)
        out, _ = _div_model(fields, plan, halo=0)
        assert torch.equal(_div_model(fields, plan)[0], ref)
    else:
        q, b = _rand(zyx, 10, -0.05, 0.05), _rand(zyx, 11)
        ref = ST.residual_plain(q, b)
        out, _ = _residual_model(q, b, plan, halo=0)
        assert torch.equal(_residual_model(q, b, plan)[0], ref)
    assert not torch.equal(out, ref)


def _gradient_model(q, plan, halo=None):
    """gradient_march_kernel's schedule: CTA (i, j, k) reads, of planes [z0,
    ze), q at its own rows and columns and the lane exchange's two ends
    (columns x0 - halo .. xe - 1 + halo) for gx, at rows y0 - halo .. ye - 1
    + halo of its columns for gy (the two row loads), and at planes z0 -
    halo .. ze - 1 + halo of its own cells for gz (the registers), all
    clipped to the volume; NaN elsewhere.  Each difference is taken at the
    clamped neighbours and scaled by 1 at the axis's two ends, 0.5 inside.
    Returns ((gx, gy, gz), writes)."""
    halo = ST.HALO if halo is None else halo
    nz, ny, nx = q.shape
    out = torch.full((3, nz, ny, nx), NAN)
    writes = torch.zeros((nz, ny, nx), dtype=torch.int32)

    def scale(n):
        s = torch.full((n,), 0.5)
        s[0] = s[n - 1] = 1.0
        return s

    sz, sy, sx = scale(nz)[:, None, None], scale(ny)[:, None], scale(nx)
    for x0, xe, y0, ye, z0, ze in _ctas(plan, (nz, ny, nx), "gradient3"):
        held = torch.full((3, nz, ny, nx), NAN)
        xs = slice(max(x0 - halo, 0), min(xe + halo, nx))
        ys = slice(max(y0 - halo, 0), min(ye + halo, ny))
        zs = slice(max(z0 - halo, 0), min(ze + halo, nz))
        held[0, z0:ze, y0:ye, xs] = q[z0:ze, y0:ye, xs]
        held[1, z0:ze, ys, x0:xe] = q[z0:ze, ys, x0:xe]
        held[2, zs, y0:ye, x0:xe] = q[zs, y0:ye, x0:xe]
        zr, yr, xr = torch.arange(z0, ze), torch.arange(y0, ye), torch.arange(x0, xe)
        hx = held[0, z0:ze, y0:ye]
        gx = hx[:, :, (xr + 1).clamp(max=nx - 1)] - hx[:, :, (xr - 1).clamp(min=0)]
        hy = held[1, z0:ze, :, x0:xe]
        gy = hy[:, (yr + 1).clamp(max=ny - 1)] - hy[:, (yr - 1).clamp(min=0)]
        hz = held[2, :, y0:ye, x0:xe]
        gz = hz[(zr + 1).clamp(max=nz - 1)] - hz[(zr - 1).clamp(min=0)]
        region = (slice(z0, ze), slice(y0, ye), slice(x0, xe))
        out[(0,) + region] = gx * sx[x0:xe]
        out[(1,) + region] = gy * sy[y0:ye]
        out[(2,) + region] = gz * sz[z0:ze]
        writes[region] += 1
    return out, writes


# X = 150 (a last quad of two columns, rows only 8-byte aligned) and a
# ragged 38, several x and row tiles, ragged last chunks, chunks of one
# plane, two-cell dims (every cell a boundary cell) and odd ones.
GRADIENT_CASES = [((7, 10, 38), None, 2), ((9, 34, 38), 8, 4), ((5, 3, 7), None, 3),
                  ((6, 18, 70), 16, 1), ((3, 5, 150), None, 2), ((2, 2, 2), None, 1),
                  ((30, 32, 128), None, None)]


@pytest.mark.parametrize("zyx,quads,chunk", GRADIENT_CASES,
                         ids=[str(i) for i in range(len(GRADIENT_CASES))])
def test_gradient_schedule_matches_plain(zyx, quads, chunk):
    """B15's schedule writes every cell once and equals `gradient3_plain`
    bit for bit on ragged, odd and two-cell shapes, forced quads and
    chunks, and the plan's own at a (30, 32, 128) cut of the path's
    (30, 128, 128)."""
    q = _rand(zyx, sum(zyx), 0.0, 0.6)
    out, writes = _gradient_model(q, _forced("gradient3", zyx, quads, chunk))
    assert (writes == 1).all()
    assert torch.equal(out, ST.gradient3_plain(q))


def test_gradient_plan_matches_the_kernel_source():
    """B15's launch takes the plan whole (quads, rows, chunk), refuses what
    `march_ok` refuses and dims under 2 as the wrapper does, stages
    nothing, forms its three output channels' bases in 64 bits and
    exchanges q within a CTA row; at the 256x256x60 GI frame's (30, 128,
    128) the plan is one plane a CTA, 480 CTAs; the plan admits 2^30
    cells, where channel 2 starts at 2^31 elements."""
    src = (Path(ST.__file__).parents[2] / "csrc" / "stencil.cu").read_text()
    assert _build._SIGNATURES["fx_gradient3"][-4:-1] == [_build._I] * 3
    assert "fx_gradient3_perthread" in _build._SIGNATURES
    entry = src[src.index("int fx_gradient3("):]
    entry = entry[:entry.index("switch")]
    assert "!march_ok(quads, rows, chunk, nz, ny, nx)" in entry
    assert "nz < 2 || ny < 2 || nx < 2 || (int64_t)nz * ny * nx >= (1LL << 31)" in entry
    kernel = src[src.index("gradient_march_kernel(const float*"):src.index("int fx_gradient3(")]
    assert "float* const g[3] = {out, out + (int64_t)n, out + 2 * (int64_t)n};" in kernel
    assert "__shfl_up_sync(0xffffffffu, qc[kQuad - 1], 1, quads)" in kernel
    assert "__shfl_down_sync(0xffffffffu, qc[0], 1, quads)" in kernel
    assert "<<<grid, dim3(quads, rows), 0, cs>>>(q, out, nz, ny, nx, chunk)" in src
    assert "__syncthreads" not in kernel[:kernel.index("// B15 as it ran before")]
    plan = ST.stencil_plan("gradient3", (30, 128, 128))
    assert plan == ST.StencilPlan(32, 8, 1, (1, 16, 30))
    assert ST.stencil_plan("gradient3", (4096, 512, 512)).grid[2] >= 1
    for zyx in ((0, 8, 8), (1300, 1300, 1300), (4, 8, -3)):
        with pytest.raises(ValueError):
            ST.stencil_plan("gradient3", zyx)


def test_a_gradient_window_one_cell_short_is_caught():
    """With the reach one cell short (HALO 0: no exchange ends, no
    neighbouring rows, no planes beyond the chunk), the model reads cells
    no CTA holds (NaN) and disagrees with the plain version."""
    zyx = (12, 34, 38)
    plan = _forced("gradient3", zyx, 8, 2)
    assert plan.grid[0] > 1 and plan.grid[1] > 1 and plan.grid[2] > 1
    q = _rand(zyx, 12, 0.0, 0.6)
    ref = ST.gradient3_plain(q)
    assert torch.equal(_gradient_model(q, plan)[0], ref)
    for axis in range(3):
        assert not torch.equal(_gradient_model(q, plan, halo=0)[0][axis], ref[axis]), axis
