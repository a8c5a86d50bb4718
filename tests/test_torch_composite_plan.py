"""B17's launch plan and ring schedule (fluidx12_tpu_torch/csrc/composite.cu
composite_kernel) on the CPU: `composite_plan` owns every texel exactly
once, fits the shared memory and fills every SM where the stack allows,
its constants are those the kernel source compiles, and a numpy model of
the rings -- each thread's copies of its columns, a group of slices of the
densities or of prod a commit group, landing in their places only when
the kernel's wait lets them, prod copied only for the slices where one of
the thread's landed densities is above 0, zeros past the last slice and
for prod not copied, every place NaN until a copy lands -- read in march
order and composited by `composite_plain` gives `composite_plain` of the
stack bit for bit, in both directions.  A refill one group off, a wait one
short, a flip that composites back to front over unflipped staging,
copies one column short, a tail staged without its zeros and prod's test
made before its densities land are each caught.  `composite_plain` itself
is held to the Pallas kernel in interpret mode by
tests/test_torch_slab.py."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fluidx12_tpu_torch.ops.cuda import _build
from fluidx12_tpu_torch.ops.cuda import composite as C

# Several pytest workers share the machine's cores: one torch thread each.
torch.set_num_threads(1)

ABSORPTION = 0.8
SRC = Path(C.__file__).parents[2] / "csrc" / "composite.cu"

# B17's stacks: the 24^3 golden case's DIRECT plane, the compact X+ stack
# of 256x256x60, a 512^3 grid's DIRECT plane; then R1 ragged against the
# tile's rows, and R2 ragged against its columns.
PLANS = [(24, 256, 256), (128, 256, 256), (170, 896, 1024), (24, 18, 256), (9, 13, 200)]


def _threads(plan, r1, r2):
    """(rows, first columns) of the threads of `plan` that own texels, as
    two flat arrays: CTA (i, j), thread t -> row j rows + t // cols,
    column (i cols + t % cols) vec."""
    i, j, t = np.meshgrid(np.arange(plan.grid[0]), np.arange(plan.grid[1]),
                          np.arange(C.CTA_THREADS), indexing="ij")
    r = (j * plan.rows + t // plan.cols).ravel()
    s0 = ((i * plan.cols + t % plan.cols) * plan.vec).ravel()
    keep = (r < r1) & (s0 < r2)
    return r[keep], s0[keep]


@pytest.mark.parametrize("shape", PLANS, ids=lambda s: "x".join(map(str, s)))
def test_composite_plan_owns_every_texel_once(shape):
    """The threads' column vectors partition the (R1, R2) plane, each
    whole inside it; the rings fit the shared memory without the opt-in; the vec is the widest that puts a CTA on every SM, or the
    narrowest where none does."""
    n_s, r1, r2 = shape
    plan = C.composite_plan(*shape)
    assert plan == C.composite_layout(n_s, r1, r2, plan.vec)
    assert plan.cols * plan.rows == C.CTA_THREADS and plan.cols <= 32
    assert plan.smem <= 48 * 1024 <= _build.SMEM_PER_CTA
    owned = np.zeros((r1, r2), dtype=np.int32)
    rows, firsts = _threads(plan, r1, r2)
    assert (firsts + plan.vec <= r2).all()
    for c in range(plan.vec):
        np.add.at(owned, (rows, firsts + c), 1)
    assert (owned == 1).all()

    def ctas(vec):
        return int(np.prod(C.composite_layout(n_s, r1, r2, vec).grid))

    wider = [v for v in C.VEC_CHOICES if v > plan.vec and r2 % v == 0]
    assert all(ctas(v) < C.SMS for v in wider)
    assert ctas(plan.vec) >= C.SMS or plan.vec == min(C.VEC_CHOICES)
    if shape in PLANS[:3]:
        assert ctas(plan.vec) >= C.SMS


def test_composite_plan_matches_the_kernel_source():
    """The constants and formulas `composite_plan` uses are those
    csrc/composite.cu compiles, fx_composite takes the plan whole, its
    refusal covers what the kernel cannot run, the schedule the model below
    mirrors is the kernel's, and the plan refuses what no launch takes."""
    src = SRC.read_text()
    c = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (C.CTA_THREADS, C.GROUP, C.DENS_GROUPS, C.PROD_GROUPS) == (
        c["kCompositeThreads"], c["kGroup"], c["kDensGroups"], c["kProdGroups"])
    assert ("return (kDensGroups + 3 * kProdGroups) * kGroup * kCompositeThreads * vec *\n"
            "         (int)sizeof(__nv_bfloat16);") in src
    for vec in C.VEC_CHOICES:
        assert C.composite_layout(8, 8, 8, vec).smem == (
            (C.DENS_GROUPS + 3 * C.PROD_GROUPS) * C.GROUP * C.CTA_THREADS * vec * 2)
    assert "<<<grid, kCompositeThreads, composite_smem(kVec), cs>>>" in src
    assert _build._SIGNATURES["fx_composite"][-3:-1] == [_build._I] * 2
    assert "fx_composite_perthread" in _build._SIGNATURES
    entry = src[src.index("int fx_composite("):]
    assert "!composite_ok(dens, prod, n_steps, out, ns, R1, R2, vec, cols)" in entry
    assert "(vec == 4 || vec == 2) && ns >= 1 && R1 >= 1 && R2 >= 1 && R2 % vec == 0" in src
    # The schedule: the prologue stages group 0's densities, its prod whole
    # and group 1's densities; group g stages group g + 2's densities, waits
    # until one group is pending, stages group g + 1's prod where one of the
    # thread's densities of a slice (landed) is above 0, and reads dens
    # place g % kDensGroups and prod place g % kProdGroups; a group's slice
    # u sits at place u of its group; steps past the last slice, and prod
    # not copied, copy nothing and zero their place.
    assert "stage_dens(0);\n  stage_prod(0, false);\n  stage_dens(1);" in src
    assert ("    stage_dens(g + 2);\n" in src and "    cp_async_wait_pending<1>();\n"
            "    stage_prod(g + 1, true);\n" in src)
    assert "__nv_bfloat16* const dst = dring + (g % kDensGroups) * kGroup * kChan;" in src
    assert "__nv_bfloat16* const dst = pring + (g % kProdGroups) * kGroup * 3 * kChan;" in src
    assert ("const __nv_bfloat16* const dsrc = dring + (g % kDensGroups) * kGroup * kChan;"
            in src)
    assert ("const bool keep = g * kGroup + u < ns && (!test || any_above_zero<kVec>(dsrc + u "
            "* kChan));") in src
    assert "for (int j = 0; j < kVec; ++j) any = any || v[j] > 0.0f;" in src
    assert ("const __nv_bfloat16* const dbase = dring + (g % kDensGroups) * kGroup * kChan;"
            in src)
    assert ("const __nv_bfloat16* const pbase = pring + (g % kProdGroups) * kGroup * 3 * kChan;"
            in src)
    assert "__nv_bfloat16* const pring = dring + kDensGroups * kGroup * kChan;" in src
    assert ("const int64_t step = flip ? -texels : texels, first = flip ? (ns - 1) * texels : 0;"
            in src)
    assert src.count("int64_t e = first + (int64_t)(g * kGroup) * step;") == 2
    assert src.count("for (int u = 0; u < kGroup; ++u, e += step) {") == 2
    assert "const bool keep = g * kGroup + u < ns;" in src
    assert "const int n = keep ? kBytes : 0;" in src
    assert src.count("asm volatile(\"cp.async.commit_group;\\n\" ::: \"memory\");") == 2
    assert "const __nv_bfloat16* const chan0[4] = {dens + idx, prod + idx," in src
    for shape in ((24, 16, 255), (0, 8, 256), (4, 0, 256), (1, 4 * 65535 + 1, 2048)):
        with pytest.raises(ValueError):
            C.composite_plan(*shape)


def _stack(n_s=24, r1=16, r2=256, seed=5):
    """bf16-valued f32 dens (n_s, R1, R2) with an empty slice and a
    quarter of the rows empty, prod (3, n_s, R1, R2), n_steps (R1, R2)."""
    rng = np.random.default_rng(seed)
    bf = torch.bfloat16
    dens = torch.from_numpy(rng.uniform(-0.1, 1.0, (n_s, r1, r2)).astype(np.float32))
    dens[3] = 0.0
    dens[:, : r1 // 4] = 0.0
    prod = torch.from_numpy(rng.uniform(0.0, 1.0, (3, n_s, r1, r2)).astype(np.float32))
    nst = torch.from_numpy(rng.uniform(0.5, 2.0, (r1, r2)).astype(np.float32))
    return dens.to(bf).float().numpy(), prod.to(bf).float().numpy(), nst


def _ring_model(dens, prod, plan, flip, group_shift=0, wait_slack=0, stage_flip=True,
                lanes=None, zfill=True, test_early=False):
    """What composite_kernel's threads read at each march step under
    `plan`, the tail group's steps past the last slice included: (steps,
    4, R1, R2) f32.  Each thread copies `lanes` (default vec) columns from
    the first of its columns, GROUP steps of the densities or of the three
    prod channels a commit group; a group lands in its places only when a
    wait leaves fewer groups pending than it; a place is NaN until a copy
    lands; a step past the last slice, and a slice's prod where none of the
    thread's densities of it in its place is above 0 when prod is staged,
    land zeros.  The mutations: `group_shift` moves the places each group
    refills, `wait_slack` leaves that many more groups pending,
    `stage_flip=False` stages slice k at step k whatever `flip`, `lanes`
    copies fewer columns, `zfill=False` lands nothing for a copy of no
    bytes, `test_early` stages prod before the wait."""
    n_s, r1, r2 = dens.shape
    lanes = plan.vec if lanes is None else lanes
    seen = np.zeros((r1, r2), dtype=bool)   # texels whose copy holds their column
    rows, firsts = _threads(plan, r1, r2)
    for c in range(plan.vec):
        seen[rows, firsts + c] = c < lanes
    n_groups, g_d, g_p = -(-n_s // C.GROUP), C.DENS_GROUPS, C.PROD_GROUPS
    dplaces = np.full((g_d * C.GROUP, r1, r2), np.nan, dtype=np.float32)
    pplaces = np.full((g_p * C.GROUP, 3, r1, r2), np.nan, dtype=np.float32)
    pending = []                                     # (commit group, copy)
    committed = 0

    def slice_at(k):
        return n_s - 1 - k if flip and stage_flip else k

    def commit(copies):
        nonlocal committed
        pending.extend((committed, copy) for copy in copies)
        committed += 1

    def stage_dens(g):
        copies = []
        for u in range(C.GROUP):
            k, place = g * C.GROUP + u, ((g + group_shift) % g_d) * C.GROUP + u
            copies.append((dplaces[place], dens[slice_at(k)] if k < n_s else None, seen))
        commit(copies)

    def stage_prod(g, test):
        copies = []
        for u in range(C.GROUP):
            k, place = g * C.GROUP + u, ((g + group_shift) % g_p) * C.GROUP + u
            keep = np.full((r1, r2), k < n_s)
            if test:
                d = dplaces[(g % g_d) * C.GROUP + u]
                above = (d > 0).reshape(r1, r2 // plan.vec, plan.vec).any(-1)
                keep &= np.repeat(above, plan.vec, axis=1)
            src = prod[:, slice_at(k)] if k < n_s else np.zeros((3, r1, r2), np.float32)
            copies.append((pplaces[place], np.where(keep, src, 0.0).astype(np.float32),
                           seen & keep))
            if zfill:
                copies.append((pplaces[place], np.zeros((3, r1, r2), np.float32), seen & ~keep))
        commit(copies)

    def wait(n):
        for grp, (dst, src, mask) in pending:
            if grp < committed - n:
                if src is not None:
                    dst[..., mask] = src[..., mask]
                elif zfill:
                    dst[..., mask] = 0.0
        pending[:] = [p for p in pending if p[0] >= committed - n]

    stage_dens(0)
    stage_prod(0, False)
    stage_dens(1)
    reads = np.empty((n_groups * C.GROUP, 4, r1, r2), dtype=np.float32)
    for g in range(n_groups):
        stage_dens(g + 2)
        if test_early:
            stage_prod(g + 1, True)
        wait(1 + wait_slack)
        if not test_early:
            stage_prod(g + 1, True)
        for u in range(C.GROUP):
            reads[g * C.GROUP + u, 0] = dplaces[(g % g_d) * C.GROUP + u]
            reads[g * C.GROUP + u, 1:] = pplaces[(g % g_p) * C.GROUP + u]
    return reads


def _composite(reads, nst):
    """`composite_plain` over the reads, in the order they were read."""
    r = torch.from_numpy(reads)
    return C.composite_plain(r[:, 0], r[:, 1:].transpose(0, 1).contiguous(), nst,
                             ABSORPTION, False)


def _back_to_front(reads, nst):
    """The same composite taken back to front over slices read in
    ascending order: equal in exact arithmetic to the front-to-back march
    in descending order, rounded differently."""
    r = torch.from_numpy(reads)
    absorption = float(torch.tensor(ABSORPTION, dtype=torch.float32))
    acc = torch.zeros(nst.shape)
    rgb = torch.zeros((3,) + tuple(nst.shape))
    for k in range(r.shape[0]):
        d = torch.clamp(r[k, 0], 0.0, 1.0)
        a_ref = torch.clamp(d * absorption, 0.0, 0.999)
        alpha = torch.clamp(1.0 - torch.exp(nst * torch.log1p(-a_ref)), 0.0, 1.0 - 1e-6)
        rate = torch.where(d > 0.0, alpha / torch.clamp_min(d, 1e-6), torch.zeros_like(d))
        rgb = r[k, 1:] * rate + (1.0 - alpha) * rgb
        acc = alpha + (1.0 - alpha) * acc
    return torch.cat([acc[None], rgb])


# The plan's own layout of the small stack, then each vec forced.
MODEL_PLANS = [None, 4, 2]


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("forced", MODEL_PLANS, ids=lambda f: "plan" if f is None
                         else f"vec{f}")
@pytest.mark.parametrize("shape", [(24, 16, 256), (22, 13, 200)],
                         ids=lambda s: "x".join(map(str, s)))
def test_ring_model_gives_plain_bit_for_bit(shape, forced, flip):
    """The rings' reads, composited in march order (the tail group's zeros
    included), are `composite_plain` of the stack exactly, on a stack that
    fills its tiles and on one ragged in slices, rows and columns: every
    texel's slices reach it in march order, and the zeros past the last
    slice and in place of the prod not copied add nothing.  The empty rows'
    prod is not copied after group 0."""
    dens, prod, nst = _stack(*shape)
    n_s, r1, r2 = dens.shape
    plan = (C.composite_plan(n_s, r1, r2) if forced is None
            else C.composite_layout(n_s, r1, r2, forced))
    reads = _ring_model(dens, prod, plan, flip)
    assert (reads[C.GROUP:n_s, 1:, : r1 // 4] == 0).all() and (prod[:, :, : r1 // 4] > 0).any()
    got = _composite(reads, nst)
    ref = C.composite_plain(torch.from_numpy(dens), torch.from_numpy(prod), nst,
                            ABSORPTION, flip)
    assert float(ref[0].max()) > 0.5 and float(ref[0, 0].max()) == 0.0
    assert torch.equal(got, ref)


@pytest.mark.parametrize("mutant", ["group", "wait", "flip", "lanes", "zfill", "test"])
def test_ring_model_catches_mutants(mutant):
    """A refill one group off, a wait that leaves one more group pending, a
    flip that stages ascending and composites back to front (within 1e-5
    of the truth, yet not it), copies one column short, copies of no bytes
    that land no zeros and prod's test made before its densities land each
    break the bit-for-bit match, on a stack whose slices do not fill the
    last group."""
    dens, prod, nst = _stack(n_s=22)
    plan = C.composite_plan(*dens.shape)
    ref = C.composite_plain(torch.from_numpy(dens), torch.from_numpy(prod), nst,
                            ABSORPTION, True)
    assert torch.equal(_composite(_ring_model(dens, prod, plan, True), nst), ref)
    if mutant == "flip":
        reads = _ring_model(dens, prod, plan, True, stage_flip=False)[: dens.shape[0]]
        got = _back_to_front(reads, nst)
        assert float((got - ref).abs().max()) <= 1e-5
    else:
        kw = {"group": dict(group_shift=1), "wait": dict(wait_slack=1),
              "lanes": dict(lanes=plan.vec - 1), "zfill": dict(zfill=False),
              "test": dict(test_early=True)}[mutant]
        got = _composite(_ring_model(dens, prod, plan, True, **kw), nst)
    assert not torch.equal(got, ref)
