// Jacobi pressure sweeps for Hopper: B4, B6, B13, B14 and B18.
//
// fx_jacobi_window replaces fluidx12_tpu/ops/pallas/jacobi.py
// _jacobi_fused_kernel / _window_sweeps (B4's whole-window plan, via
// jacobi_pallas; order 0), fx_jacobi its plane-sweep plan _planewise_window
// / _planewise_fused_kernel (order 1), fx_jacobi2d _jacobi2d_kernel (B14,
// via jacobi2d_pallas; order 3, on one (Y, X) plane), fx_jacobi_packed
// _jacobi_packed_kernel (B6, via jacobi_packed_pallas; order 2).
// fx_jacobi_rr replaces _planewise_rr_kernel (B13, via
// jacobi_pallas_rr): the order-1 sweeps with the multigrid's residual and
// 2x restriction fused in.  Each is `iters` synchronous sweeps of
//     q <- (sum of the 6 edge-clamped neighbours - b) / 6
// in f32 (in 2D the 4 neighbours, over 4).  The TPU kernels' halo'd VMEM
// windows (recomputed halos, exact in the centre), 64-lane packing and
// resident 2D plane are layouts with no effect on the result; what they fix
// is the order of the neighbour sum, which each kernel here keeps:
//   order 0 (B4, whole window): y+, y-, x+, x-, z+, z-   (jacobi.py:88)
//   order 1 (B4, plane sweep):  y+, y-, x+, x-, z-, z+   (jacobi.py:285-287)
//   order 2 (B6, packed):       x+, x-, y+, y-, z+, z-   (jacobi.py:833-842)
//   order 3 (B14, 2D):          y+, y-, x+, x-           (jacobi.py:773-774)
// Every kernel rounds each sum as the Pallas code does (the file builds
// with --fmad=false) and divides by 6 with the correctly rounded quotient
// (x / 6.0f, or div6 below, checked on all 2^32 inputs), so each matches
// its plain version bit for bit; B14's division by 4 is exact.
//
// Orders 0 and 2 sweep volumes that sit in the 50 MB L2: 128^3 (25 MB of
// q, b and the output) and the padded frames' compact coarse levels (30,
// 128, 128) and (75, 75, 75) for order 0, at most 4096 rows of 64 floats
// (64^3: 3 MB) for order 2.  Bound: a call moves 12 B per cell, 7.5 us at
// 128^3 and 3.35 TB/s; what holds the sweeps back is the L2's rate, the
// latency of each launch, and for order 2 the shared memory of the 16 SMs
// one cluster spans.
//   - Order 0 (zsweep_kernel, B4's whole-window order): one launch a sweep
//     over (16, 32) (y, x) tiles and chunks of 4-16 planes
//     (ops/cuda/jacobi.window_plan).  A CTA stages its chunk whole with
//     cp.async -- b, then q of the chunk and a plane either side with the
//     tile's halo ring, edge-clamped -- and walks z with its column strip
//     in registers.  Launches after the first of a call are programmatic
//     dependent launches: each is scheduled while the sweep before it
//     finishes and stages its b then, so the launch gap and most of the
//     staging's latency hide behind the previous sweep.  Two or four
//     sweeps a launch (the blocked march below, in order 0) or two with a
//     level-1 ring in shared memory measured no faster at these shapes.
//   - Order 2 (packed_kernel, B6): all sweeps in one launch of one cluster
//     of up to 16 CTAs (ops/cuda/jacobi.packed_plan), the volume split into
//     contiguous row ranges kept in shared memory, neighbour rows of other
//     CTAs read through distributed shared memory, one cluster barrier a
//     sweep; q and b of a thread's cells stay in registers.
//   - Order 3 (jacobi2d_kernel, B14, on one (Y, X) plane of at most
//     393216 cells, 1.5 MB): the plane's sweeps temporally blocked, K = 8
//     a launch (ops/cuda/jacobi.jacobi2d_plan).  A CTA holds a (32, 64)
//     tile and a ring of K cells around it in registers, a 4 x 4 block of
//     cells a thread, and runs K sweeps there; blocks trade only their
//     edges through shared memory, one __syncthreads a sweep.  Sweep l is
//     exact l cells inside the ring's rim, so the tile is exact after K.
//     The ring costs (48 * 80) / (32 * 64) = 1.9 times the cell updates.
//     A call is ceil(iters / K) launches chained by programmatic dependent
//     launch, each staging its b before the wait.  B14 at 512^2 does 64
//     sweeps of 5 operations per cell, 83.9 MFLOP, 1.25 us at 67 TFLOP/s;
//     what holds it back is the launches (about 3.8 us each) more than the
//     1.9x issue.
//   - The per-sweep designs orders 0, 2 and 3 replaced (fx_jacobi_sweepwise,
//     the yardstick): one thread per cell per sweep (jacobi_sweep_kernel),
//     the sweeps ping-ponging between the output and one scratch buffer,
//     launched `iters` times from one C call.
//
// Order 1 -- B4's plane-sweep order, B13 and both halves of B18 -- runs on
// 256^3 and the padded frames' volumes, which do not fit L2 (67 MB at
// 256^3): one launch per sweep there streamed q, b and its output through
// HBM each sweep (201 MB, 0.117 ms a sweep), and the epilogues re-read q and
// b.  So order 1 is one temporally blocked z-march (march_kernel), the
// TPU's halo'd window turned on its side:
//   - A CTA owns a (y, x) tile of the plane plus a lateral halo of `halo`
//     cells -- the window, 32 wide (a warp a row) and 32 high (8 warps, two
//     CTAs an SM) for the sweeps alone, 64 high (16 warps, one CTA an SM)
//     with an epilogue or the divergence, whose extra halo ring and
//     per-cell work cost more in a narrow window -- and a z-chunk plus
//     `halo` planes either side, and walks z through it.  `halo` = K, the
//     sweeps of the launch (at most kMaxK = 4, so MG_PRE = MG_POST = 4 is
//     one launch; K is a template argument), plus one ring for an
//     epilogue.  The chunk (64, 32 or 16 planes) is the one with the
//     fewest steps per resident CTA slot on the grid at hand.
//   - Level l (after l sweeps) of plane z - l is formed at step z, as soon
//     as level l - 1 holds planes z - l - 1 .. z - l + 1.  A thread owns 4
//     consecutive rows of one column; each level keeps its three newest
//     planes of that strip in registers (the cell, its z neighbours and
//     the strip's inner y neighbours), and its newest plane in shared
//     memory for the x neighbours and the strip's edge rows (two buffers a
//     level, written one step and read the next: one __syncthreads a
//     step).  Halo cells are recomputed: level l is exact l cells inside
//     the window and the chunk, and everywhere at the volume's own edges,
//     where each neighbour clamps to the cell.  Windows that reach a
//     lateral edge of the volume take a copy of the loop with those
//     clamps; the others read every neighbour at a fixed offset.  Only the
//     last level is written, for the tile's interior.
//   - q and b are staged plane by plane with cp.async, kAhead planes ahead
//     of the step that needs them, into rings in shared memory (b's ring is
//     deep enough for every level's read of b at its own cell).  So q and b
//     are read from device memory once per window; the halos' share of the
//     reads mostly hits L2, where neighbouring CTAs read the same rows.
//   - The division is the correctly rounded quotient without the IEEE
//     division's slow-path branch (div6): an FMA residual step, and the
//     rounding of subnormal ties only in warps where one may occur.
//     fx_div6_mismatches checks it against x / 6.0f on all 2^32 inputs.
//   - Indices are 2D thread coordinates; the only 64-bit product is a
//     plane's offset.  Calls with iters > 4 chain launches of 4 sweeps,
//     ping-ponging between the output and the scratch buffer; the last
//     launch takes the remainder and the epilogue.
// Epilogues, on the last level of the last launch, from planes the CTA
// holds (the TPU's "the final window already holds q AND b in VMEM with
// one valid halo ring", jacobi.py:305-318):
//   - B13 and B18's head (residual_restrict): the residual
//       r = b - (y+ + y- + x+ + x- + z- + z+ - 6 q), edges clamped,
//     the z pair summed in a register (planes 2zc, 2zc+1), then the x and
//     y pools through a shared plane in the TPU epilogue's order
//     (jacobi.py:321-351; the two dots have exactly these non-zero terms):
//       s    = r[2zc] + r[2zc+1]
//       xz   = (s[x=2xc] * w + s[x=2xc+1] * w) * 0.5, w = fl32(0.5 * scale)
//       r_c  = 0.5 * xz[y=2yc] + 0.5 * xz[y=2yc+1]
//   - B18's tail: B8's gradient and wall-band damp (stencil.cuh damp) of
//     the velocity, read once and written once, in place on channels 0..2.
// B18's head (fx_jacobi_divrr, replaces _planewise_divrr_kernel via
// jacobi_pallas_divrr) forms b as B3 does (0.5 * ((dx + dy) + dz) of the
// f32 casts; the Pallas prologue's order) for each window cell of each
// plane as the march reaches it, writes it once and keeps it in the ring.
// B18's tail (fx_jacobi_grad) replaces _planewise_grad_kernel via
// jacobi_pallas_grad.  So B18 gives the port's unfused chain B3 -> B13 ->
// ... -> B4 -> B8 bit for bit, as the TPU kernels give theirs
// (core/config.py:133).
//
// Bound at 256^3 (each input read once, each output written once, 3.35
// TB/s): B4's plane-sweep order 201 MB, 60.1 us; B13 210 MB (+ the coarse
// r_c), 62.6 us; the head reads q and the three bf16 velocity channels and
// writes q, b and r_c, 310 MB, 92.7 us; the tail reads q, b and the
// velocity and writes q and the velocity, 403 MB, 120.2 us.  What keeps
// the march above them is not memory: per output cell it makes about 8
// cell updates for 4 sweeps (each level runs over the whole window, 1.78
// window cells per tile cell at 32 x 32, and 1.125 planes per owned plane
// at a 64-plane chunk), each about 15 instructions at a fixed offset (5
// for the division), with the levels of a step a chain (level l needs
// level l - 1's newest plane), so a step is bound by instruction
// throughput and latency.
//
// fx_jacobi_sweepwise keeps the per-sweep design of orders 0, 1, 2 and 3
// (one launch per sweep, the epilogues as separate passes) as a yardstick
// for timing; no wrapper calls it.

#include <cooperative_groups.h>

#include <type_traits>

#include "stencil.cuh"

namespace {

template <int kOrder>
__global__ void jacobi_sweep_kernel(const float* __restrict__ q, const float* __restrict__ b,
                                    float* __restrict__ out, int nz, int ny, int nx) {
  const int64_t plane = (int64_t)ny * nx;
  const int64_t n = (int64_t)nz * plane;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int x = (int)(idx % nx);
  const int y = (int)((idx / nx) % ny);
  const int z = (int)(idx / plane);
  const float xp = q[x < nx - 1 ? idx + 1 : idx];
  const float xm = q[x > 0 ? idx - 1 : idx];
  const float yp = q[y < ny - 1 ? idx + nx : idx];
  const float ym = q[y > 0 ? idx - nx : idx];
  if (kOrder == 3) {  // 2D: one plane, four neighbours
    float s = yp + ym;
    s = s + xp;
    s = s + xm;
    out[idx] = (s - b[idx]) / 4.0f;
    return;
  }
  const float zp = q[z < nz - 1 ? idx + plane : idx];
  const float zm = q[z > 0 ? idx - plane : idx];
  float s;
  if (kOrder == 2) {
    s = xp + xm;
    s = s + yp;
    s = s + ym;
  } else {
    s = yp + ym;
    s = s + xp;
    s = s + xm;
  }
  if (kOrder == 1) {
    s = s + zm;
    s = s + zp;
  } else {
    s = s + zp;
    s = s + zm;
  }
  out[idx] = (s - b[idx]) / 6.0f;
}

// Where sweep k of `iters` writes: the last one writes `out`; count back
// from it, alternating with `scratch`.
inline float* sweep_dst(int k, int iters, float* out, float* scratch) {
  return ((iters - 1 - k) % 2 == 0) ? out : scratch;
}

// Sweeps k0 .. iters - 1 of q (the result of sweep k0 - 1, or the input).
template <int kOrder>
cudaError_t sweeps(const float* q, const float* b, float* out, float* scratch, int k0,
                   int iters, int nz, int ny, int nx, cudaStream_t st) {
  const unsigned blocks = blocks_for((int64_t)nz * ny * nx);
  const float* src = q;
  for (int k = k0; k < iters; ++k) {
    float* dst = sweep_dst(k, iters, out, scratch);
    jacobi_sweep_kernel<kOrder><<<blocks, kThreads, 0, st>>>(src, b, dst, nz, ny, nx);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// Order 1: the temporally blocked z-march
// ---------------------------------------------------------------------------

constexpr int kWX = 32;             // window width: one warp a row
constexpr int kRows = 4;            // consecutive window rows a thread
constexpr int kMaxK = 4;            // sweeps a launch
constexpr int kAhead = 2;           // planes staged ahead of the step
constexpr int kQRing = 4;           // level 0's planes z - 1, z, and kAhead more
constexpr int kBRing = 8;           // b of planes z - kMaxK - 1 .. z + kAhead
constexpr int kPad = kWX + 1;       // the window's edge cells read garbage here
static_assert(kQRing >= 2 + kAhead && (kQRing & (kQRing - 1)) == 0, "q ring");
static_assert(kBRing >= kMaxK + 2 + kAhead && (kBRing & (kBRing - 1)) == 0, "b ring");

enum Epilogue { kNone = 0, kResidualRestrict = 1, kGradDamp = 2 };

// The window of a launch: kBY warps of kRows rows each.  The sweeps alone
// take 32 x 32 (two CTAs an SM); with an epilogue or the divergence,
// whose extra halo ring and per-cell work cost more in a narrow window,
// 32 x 64 (one CTA of 16 warps an SM).
template <int kEpi, bool kDiv>
struct Window {
  static constexpr bool kSweepsOnly = kEpi == kNone && !kDiv;
  static constexpr int kBY = kSweepsOnly ? 8 : 16;
  static constexpr int kWY = kBY * kRows;
  static constexpr int kWin = kWX * kWY;
  static constexpr int kCtasPerSm = kSweepsOnly ? 2 : 1;
  // Levels held in shared memory: 1 .. K - 1, and K for an epilogue.
  static constexpr int kLevBufs = kEpi == kNone ? kMaxK - 1 : kMaxK;
  static constexpr int kPoolPlane = kEpi == kResidualRestrict ? kWin : 1;
  // The wall bands of the window's rows and columns (kGradDamp).
  static constexpr int kBands = kEpi == kGradDamp ? kWY + kWX : 1;
};

template <typename W>
struct MarchShared {
  float pad0[kPad];
  float lev[W::kLevBufs][2][W::kWin];  // two planes a level
  float q[kQRing][W::kWin];            // level 0: the staged q planes
  float b[kBRing][W::kWin];            // the staged (or formed) b planes
  float s[W::kPoolPlane];              // the z-paired residual, for the x and y pools
  Band band[W::kBands];                // rows, then columns
  float pad1[kPad];
};

struct MarchArgs {
  const float* q;      // level 0
  const float* b;      // read where the launch does not form it
  float* out;          // the last level, on the tile interiors
  const void* div_f;   // velocity whose divergence is b (kDiv), (C, nz, ny, nx)
  float* b_out;        // b as formed (kDiv)
  float* rc;           // (nz/2, ny/2, nx/2) coarse residual (kResidualRestrict)
  void* f;             // velocity updated in place (kGradDamp), (C, nz, ny, nx)
  float w;             // fl32(0.5 * scale) of the x pool
  float s;             // fl32(0.5 / rho) of the gradient
  int nz, ny, nx;
  int zchunk;          // planes a CTA owns (even)
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// x / 6.0f, the correctly rounded f32 quotient, without the division's
// branch: q0 = RN(x * RN(1/6)) corrected by one residual step, which is
// exact for every quotient but a tie between two subnormals, and q0 itself
// where the residual is 0 or not a number (zeros of either sign, exact
// quotients, infinities, NaN).  div6 also rounds that tie to even;
// div6_near does not, and is taken only where no x of the warp may be
// such a tie (0 < |x| < 2^-120).  fx_div6_mismatches counts the f32 bit
// patterns where the march's choice differs from x / 6.0f.
__device__ __forceinline__ float div6_near(float x, float& q, float& r) {
  const float c = 0.16666667163372039794921875f;
  const float q0 = x * c;
  r = __fmaf_rn(-q0, 6.0f, x);
  q = __fmaf_rn(r, c, q0);
  return fabsf(r) > 0.0f ? q : q0;
}

__device__ __forceinline__ float div6_near(float x) {
  float q, r;
  return div6_near(x, q, r);
}

__device__ __forceinline__ float div6(float x) {
  float q, r;
  const float near = div6_near(x, q, r);
  const float r2 = __fmaf_rn(-q, 6.0f, x);
  if (fabsf(r2) == 0x1.8p-148f && (__float_as_uint(q) & 1u)) q = q + copysignf(0x1p-149f, r2);
  return fabsf(r) > 0.0f ? q : near;
}

__device__ __forceinline__ bool div6_tie_possible(float x) {
  const unsigned a = __float_as_uint(x) << 1;  // |x|'s bits, shifted
  return a - 1u < (0x03800000u << 1) - 1u;     // 0 < |x| < 2^-120
}

// div6_near without its select, for 2^-120 <= |x| < inf: there the
// quotient is normal, so a zero residual leaves q0 as it is.  div6_slow(x)
// says where it may not hold -- |x| < 2^-120 (zeros too), infinities and
// NaN, exponent fields 0..6 and 255 -- with one shift-add and one compare.
__device__ __forceinline__ float div6_fast(float x) {
  const float c = 0.16666667163372039794921875f;
  const float q0 = x * c;
  return __fmaf_rn(__fmaf_rn(-q0, 6.0f, x), c, q0);
}

__device__ __forceinline__ bool div6_slow(float x) {
  return (__float_as_uint(x) << 1) + 0x01000000u < 0x08000000u;
}

// At the volume's first and last plane a level's z neighbour clamps to the
// cell: there the column's plane below (lo) or above (fresh) is replaced by
// the cell's own (mid), once for the strip.  Both are overwritten when the
// step ends (lo) or describe a plane past the volume (fresh), so no exact
// cell reads the replaced value.
__device__ __forceinline__ void clamp_z(int p, int nz, float (&lo)[kRows],
                                        const float (&mid)[kRows], float (&fresh)[kRows]) {
  if (p <= 0) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) lo[r] = mid[r];
  }
  if (p >= nz - 1) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) fresh[r] = mid[r];
  }
}

// A thread's view of its window: column wx, rows kRows * ty + r.
struct Cells {
  int i0;                      // own cell of row 0 in a window plane
  int gx, cx;                  // the column, and it clamped to the volume
  int gy[kRows];
  int off[kRows];              // clamped (y, x) offset in a volume plane
  bool interior[kRows];        // in the tile and the volume
  bool cxp, cxm, cyp[kRows], cym[kRows];  // the neighbour clamps to the cell
};

// The four lateral neighbours of level-(l-1) cell (row r) at the plane
// `cin` holds, whose own column the thread keeps in `m` (rows r +- 1 come
// from there, the strip's edges and x from shared memory), clamped at the
// volume's edges (kEdge).
template <bool kEdge>
__device__ __forceinline__ void lateral(const float* cin, const float (&m)[kRows], int r,
                                        const Cells& c, float& yp, float& ym, float& xp,
                                        float& xm) {
  const int i = c.i0 + r * kWX;
  yp = r < kRows - 1 ? m[r + 1] : cin[i + kWX];
  ym = r > 0 ? m[r - 1] : cin[i - kWX];
  xp = cin[i + 1];
  xm = cin[i - 1];
  if (kEdge) {
    if (c.cyp[r]) yp = m[r];
    if (c.cym[r]) ym = m[r];
    if (c.cxp) xp = m[r];
    if (c.cxm) xm = m[r];
  }
}

// K order-1 sweeps of a.q against b (kDiv: b formed from a.div_f) over one
// window, tile and z-chunk, then the epilogue; kEdge where the window
// reaches a lateral edge of the volume.  Steps t = zs .. ze + halo - 1:
// level l forms plane t - l, the epilogue plane t - K - 1.
template <int K, int kEpi, bool kDiv, bool kEdge, typename T, typename W>
__device__ __forceinline__ void march_window(const MarchArgs& a, MarchShared<W>& sm,
                                             const Cells& c) {
  constexpr int kWY = W::kWY;
  constexpr int kHalo = K + (kEpi != kNone ? 1 : 0);
  constexpr int kTileX = kWX - 2 * kHalo, kTileY = kWY - 2 * kHalo;
  const int nz = a.nz, ny = a.ny, nx = a.nx;
  const int z0 = (int)blockIdx.z * a.zchunk, z1 = min(z0 + a.zchunk, nz);
  const int zs = max(z0 - kHalo, 0), ze = min(z1 + kHalo, nz);
  const int64_t plane = (int64_t)ny * nx;
  const int64_t n = (int64_t)nz * plane;
  const T* div_f = (const T*)a.div_f;
  T* f = (T*)a.f;

  auto stage = [&](int z) {
    if (z < ze) {
      const int64_t zb = (int64_t)z * plane;
      float* dq = sm.q[(z - zs) & (kQRing - 1)];
      float* db = sm.b[(z - zs) & (kBRing - 1)];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        cp_async4(&dq[c.i0 + r * kWX], a.q + zb + c.off[r]);
        if (!kDiv) cp_async4(&db[c.i0 + r * kWX], a.b + zb + c.off[r]);
      }
    }
    cp_async_commit();
  };

  // Level l's own column at the plane it reached this step (fresh), the
  // one before (mid) and the one before that (lo); levels 0 .. K.
  float fresh[K + 1][kRows], mid[K + 1][kRows], lo[K + 1][kRows];
#pragma unroll
  for (int l = 0; l <= K; ++l) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) fresh[l][r] = mid[l][r] = lo[l][r] = 0.0f;
  }
  // The wall bands of the window's rows and columns (kGradDamp), formed
  // once; the first step's barrier publishes them.
  if (kEpi == kGradDamp) {
    const int tid = threadIdx.y * kWX + threadIdx.x;
    const int gy0 = c.gy[0] - kRows * (int)threadIdx.y, gx0 = c.gx - (int)threadIdx.x;
    if (tid < kWY) sm.band[tid] = band_at(gy0 + tid, ny);
    if (tid < kWX) sm.band[kWY + tid] = band_at(gx0 + tid, nx);
  }
  float rz[kRows];    // the residual of the even plane of the z pair
  // Velocity values.  kDiv: the cell's x and y components, z above and
  // below, and y of the rows either side of the strip; kGradDamp: the
  // cell's three components.
  float u[6][kRows];

  // One step; kPhase = (t - zs) & 1 picks the level buffers.
  auto step = [&](int t, auto phase) {
    constexpr int kPhase = decltype(phase)::value;
    cp_async_wait<kAhead - 1>();
    __syncthreads();
    stage(t + kAhead);

    // The velocity this step needs, loaded first so that the loads overlap
    // the sweeps: the divergence's six neighbours at plane t (kDiv), or the
    // cell's three components at the epilogue's plane (kGradDamp).
    const int pe = t - K - 1;
    if (kDiv && t < ze) {
      // Each window cell loads its clamped cell, so the neighbours' loads
      // are the clamped neighbours: x from the adjacent lanes, y from the
      // adjacent rows (the strip's two edge rows loaded once more).
      const int64_t zb = (int64_t)t * plane;
      const int64_t zp = (int64_t)(t < nz - 1 ? t + 1 : t) * plane;
      const int64_t zm = (int64_t)(t > 0 ? t - 1 : t) * plane;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        u[0][r] = ld(div_f, zb + c.off[r]);
        u[1][r] = ld(div_f, n + zb + c.off[r]);
        u[2][r] = ld(div_f, 2 * n + zp + c.off[r]);
        u[3][r] = ld(div_f, 2 * n + zm + c.off[r]);
      }
      u[4][0] = ld(div_f, n + zb + min(max(c.gy[0] - 1, 0), ny - 1) * nx + c.cx);
      u[5][0] = ld(div_f, n + zb + min(max(c.gy[kRows - 1] + 1, 0), ny - 1) * nx + c.cx);
    }
    if (kEpi == kGradDamp && pe >= z0 && pe < z1) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (c.interior[r]) {
          const int64_t g = (int64_t)pe * plane + c.off[r];
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) u[ch][r] = ld(f, ch * n + g);
        }
      }
    }

    // Level 0 at plane t.
    const float* q_t = sm.q[(t - zs) & (kQRing - 1)];
#pragma unroll
    for (int r = 0; r < kRows; ++r) fresh[0][r] = q_t[c.i0 + r * kWX];
    if (K == 0 && t >= z0 && t < z1) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (c.interior[r]) a.out[(int64_t)t * plane + c.off[r]] = fresh[0][r];
      }
    }

    // Level l at plane p = t - l from level l - 1 (written last step).
#pragma unroll
    for (int l = 1; l <= K; ++l) {
      const int p = t - l;
      const float* cin = l == 1 ? sm.q[(p - zs) & (kQRing - 1)]
                                : sm.lev[l - 2][(kPhase - l) & 1];
      float* keep = sm.lev[l - 1 < W::kLevBufs ? l - 1 : 0][(kPhase - l) & 1];
      const float* bp = sm.b[(p - zs) & (kBRing - 1)];
      clamp_z(p, nz, lo[l - 1], mid[l - 1], fresh[l - 1]);
      float x[kRows];
      bool tie = false;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float yp, ym, xp, xm;
        lateral<kEdge>(cin, mid[l - 1], r, c, yp, ym, xp, xm);
        float s = yp + ym;
        s = s + xp;
        s = s + xm;
        s = s + lo[l - 1][r];
        s = s + fresh[l - 1][r];
        x[r] = s - bp[c.i0 + r * kWX];
        tie |= div6_tie_possible(x[r]);
      }
      if (__any_sync(0xffffffffu, tie)) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) fresh[l][r] = div6(x[r]);
      } else {
#pragma unroll
        for (int r = 0; r < kRows; ++r) fresh[l][r] = div6_near(x[r]);
      }
      if (l < K || kEpi != kNone) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) keep[c.i0 + r * kWX] = fresh[l][r];
      }
      if (l == K && p >= z0 && p < z1) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (c.interior[r]) a.out[(int64_t)p * plane + c.off[r]] = fresh[l][r];
        }
      }
    }

    // The epilogue on level K at plane pe (written last step).
    if (kEpi != kNone && pe >= z0 && pe < z1) {
      const float* cin = K == 0 ? sm.q[(pe - zs) & (kQRing - 1)]
                                : sm.lev[K > 0 ? K - 1 : 0][(kPhase - K - 1) & 1];
      clamp_z(pe, nz, lo[K], mid[K], fresh[K]);
      if (kEpi == kResidualRestrict) {
        const float* bp = sm.b[(pe - zs) & (kBRing - 1)];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float own = mid[K][r];
          float yp, ym, xp, xm;
          lateral<kEdge>(cin, mid[K], r, c, yp, ym, xp, xm);
          float s = yp + ym;
          s = s + xp;
          s = s + xm;
          s = s + lo[K][r];
          s = s + fresh[K][r];
          const float res = bp[c.i0 + r * kWX] - (s - 6.0f * own);
          if (pe & 1) {
            sm.s[c.i0 + r * kWX] = rz[r] + res;
          } else {
            rz[r] = res;
          }
        }
        if (pe & 1) {
          __syncthreads();
          // One thread per coarse cell of the tile interior (even origin).
          constexpr int kNxc = kTileX / 2, kNyc = kTileY / 2;
          const int tid = threadIdx.y * kWX + threadIdx.x;
          if (tid < kNxc * kNyc) {
            const int xl = tid % kNxc, yl = tid / kNxc;
            const int xc = (int)blockIdx.x * kNxc + xl, yc = (int)blockIdx.y * kNyc + yl;
            if (xc < nx / 2 && yc < ny / 2) {
              const float* s0 = &sm.s[(kHalo + 2 * yl) * kWX + kHalo + 2 * xl];
              const float xz0 = (s0[0] * a.w + s0[1] * a.w) * 0.5f;
              const float xz1 = (s0[kWX] * a.w + s0[kWX + 1] * a.w) * 0.5f;
              a.rc[((int64_t)(pe / 2) * (ny / 2) + yc) * (nx / 2) + xc] =
                  0.5f * xz0 + 0.5f * xz1;
            }
          }
        }
      } else {
        const Band band_z = band_at(pe, nz);
        const Band band_x = sm.band[kWY + threadIdx.x];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float yp, ym, xp, xm;
          lateral<kEdge>(cin, mid[K], r, c, yp, ym, xp, xm);
          const float zp = fresh[K][r], zm = lo[K][r];
          if (c.interior[r]) {
            const int64_t g = (int64_t)pe * plane + c.off[r];
            st(f, g, damp(u[0][r], (xp - xm) * a.s, band_x));
            st(f, n + g, damp(u[1][r], (yp - ym) * a.s, sm.band[kRows * threadIdx.y + r]));
            st(f, 2 * n + g, damp(u[2][r], (zp - zm) * a.s, band_z));
          }
        }
      }
    }

    // b at plane t, formed from the velocity (kDiv): kept in the ring for
    // the levels and written once, on the tile interior.
    if (kDiv && t < ze) {
      float* bp = sm.b[(t - zs) & (kBRing - 1)];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float dx = __shfl_down_sync(0xffffffffu, u[0][r], 1) -
                         __shfl_up_sync(0xffffffffu, u[0][r], 1);
        const float dy = (r < kRows - 1 ? u[1][r + 1] : u[5][0]) - (r > 0 ? u[1][r - 1] : u[4][0]);
        const float dz = u[2][r] - u[3][r];
        const float bv = 0.5f * ((dx + dy) + dz);
        bp[c.i0 + r * kWX] = bv;
        if (c.interior[r] && t >= z0 && t < z1) a.b_out[(int64_t)t * plane + c.off[r]] = bv;
      }
    }

#pragma unroll
    for (int l = 0; l <= K; ++l) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        lo[l][r] = mid[l][r];
        mid[l][r] = fresh[l][r];
      }
    }
  };

#pragma unroll
  for (int j = 0; j < kAhead; ++j) stage(zs + j);
  const int t_end = ze + kHalo;
  for (int t = zs; t < t_end; t += 2) {
    step(t, std::integral_constant<int, 0>());
    if (t + 1 < t_end) step(t + 1, std::integral_constant<int, 1>());
  }
  cp_async_wait<0>();
}

// Grid: (x tiles, y tiles, z-chunks) of (kWX - 2 halo, kWY - 2 halo,
// a.zchunk), halo = K (+ 1 with an epilogue); block (kWX, kBY).
template <int K, int kEpi, bool kDiv, typename T, typename W = Window<kEpi, kDiv>>
__global__ void __launch_bounds__(kWX* W::kBY, W::kCtasPerSm) march_kernel(const MarchArgs a) {
  constexpr int kWY = W::kWY;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  MarchShared<W>& sm = *reinterpret_cast<MarchShared<W>*>(smem_raw);
  constexpr int kHalo = K + (kEpi != kNone ? 1 : 0);
  constexpr int kTileX = kWX - 2 * kHalo, kTileY = kWY - 2 * kHalo;
  const int nx = a.nx, ny = a.ny;
  const int gx0 = (int)blockIdx.x * kTileX - kHalo, gy0 = (int)blockIdx.y * kTileY - kHalo;
  Cells c;
  const int wx = threadIdx.x, wy0 = kRows * (int)threadIdx.y;
  c.i0 = wy0 * kWX + wx;
  c.gx = gx0 + wx;
  const int cx = min(max(c.gx, 0), nx - 1);
  c.cx = cx;
  c.cxp = c.gx >= nx - 1;
  c.cxm = c.gx <= 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int wy = wy0 + r;
    c.gy[r] = gy0 + wy;
    c.off[r] = min(max(c.gy[r], 0), ny - 1) * nx + cx;
    c.cyp[r] = c.gy[r] >= ny - 1;
    c.cym[r] = c.gy[r] <= 0;
    c.interior[r] = wx >= kHalo && wx < kWX - kHalo && wy >= kHalo && wy < kWY - kHalo &&
                    c.gx >= 0 && c.gx < nx && c.gy[r] >= 0 && c.gy[r] < ny;
  }
  // Clamps matter only where the window holds the volume's edge cells
  // inside its outer ring (the ring itself is never exact).
  if (gx0 < 0 || gy0 < 0 || gx0 + kWX > nx || gy0 + kWY > ny) {
    march_window<K, kEpi, kDiv, true, T, W>(a, sm, c);
  } else {
    march_window<K, kEpi, kDiv, false, T, W>(a, sm, c);
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 1;
  }
  return count;
}

template <int K, int kEpi, bool kDiv, typename T>
cudaError_t launch_march(MarchArgs a, cudaStream_t st) {
  using W = Window<kEpi, kDiv>;
  if ((int64_t)a.ny * a.nx > INT32_MAX) return cudaErrorInvalidValue;  // plane offsets are int
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(march_kernel<K, kEpi, kDiv, T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)sizeof(MarchShared<W>));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  constexpr int kHalo = K + (kEpi != kNone ? 1 : 0);
  constexpr int tx = kWX - 2 * kHalo, ty = W::kWY - 2 * kHalo;
  const int lateral = ((a.nx + tx - 1) / tx) * ((a.ny + ty - 1) / ty);
  // The z-chunk with the fewest steps per CTA slot: rounds of resident
  // CTAs times the steps a CTA makes.
  const int slots = W::kCtasPerSm * sm_count();
  long best = -1;
  for (int zc = 64; zc >= 16; zc /= 2) {
    const long ctas = (long)lateral * ((a.nz + zc - 1) / zc);
    const long cost = ((ctas + slots - 1) / slots) * (min(zc, a.nz) + 2 * kHalo);
    if (best < 0 || cost < best) {
      best = cost;
      a.zchunk = zc;
    }
  }
  const dim3 grid((a.nx + tx - 1) / tx, (a.ny + ty - 1) / ty,
                  (a.nz + a.zchunk - 1) / a.zchunk);
  march_kernel<K, kEpi, kDiv, T>
      <<<grid, dim3(kWX, W::kBY), sizeof(MarchShared<W>), st>>>(a);
  return cudaGetLastError();
}

// One launch of k (0 .. kMaxK) sweeps; none only ahead of an epilogue or
// the divergence (fx_jacobi copies q for iters == 0).
template <int kEpi, bool kDiv, typename T>
cudaError_t launch_k(const MarchArgs& a, int k, cudaStream_t st) {
  switch (k) {
    case 0:
      if constexpr (kEpi != kNone || kDiv) return launch_march<0, kEpi, kDiv, T>(a, st);
      return cudaErrorInvalidValue;
    case 1: return launch_march<1, kEpi, kDiv, T>(a, st);
    case 2: return launch_march<2, kEpi, kDiv, T>(a, st);
    case 3: return launch_march<3, kEpi, kDiv, T>(a, st);
    case 4: return launch_march<4, kEpi, kDiv, T>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

// `iters` order-1 sweeps of q into out as ceil(iters / kMaxK) launches (one
// with no sweeps where iters == 0: the epilogue alone), ping-ponging between
// out and scratch so that the last ends at out.  With a.div_f the first
// launch forms b (into a.b_out) and later ones read it; the last launch runs
// the epilogue.  T is the velocity's type.
template <int kEpi, typename T>
cudaError_t march(MarchArgs a, const float* q, float* out, float* scratch, int iters,
                  cudaStream_t st) {
  const int launches = iters == 0 ? 1 : (iters + kMaxK - 1) / kMaxK;
  const bool div = a.div_f != nullptr;
  a.q = q;
  for (int i = 0; i < launches; ++i) {
    const bool last = i == launches - 1;
    const int k = last ? iters - kMaxK * (launches - 1) : kMaxK;
    a.out = (launches - 1 - i) % 2 == 0 ? out : scratch;
    cudaError_t err;
    if (div && i == 0) {
      err = last ? launch_k<kEpi, true, T>(a, k, st)
                 : launch_march<kMaxK, kNone, true, T>(a, st);
      a.b = a.b_out;
    } else if (last) {
      err = kEpi == kNone ? launch_k<kNone, false, float>(a, k, st)
                          : launch_k<kEpi, false, std::conditional_t<kEpi == kGradDamp, T, float>>(a, k, st);
    } else {
      err = launch_march<kMaxK, kNone, false, float>(a, st);
    }
    if (err != cudaSuccess) return err;
    a.q = a.out;
  }
  return cudaSuccess;
}

MarchArgs march_args(const float* b, int nz, int ny, int nx) {
  MarchArgs a = {};
  a.b = b;
  a.nz = nz;
  a.ny = ny;
  a.nx = nx;
  return a;
}

// Counts, over a grid-stride range of all 2^32 bit patterns, those where
// a branch-free quotient and the division differ (NaN results count as
// equal): the march's (div6_near unless div6_tie_possible) and the
// L2-resident kernels' (div6_fast unless div6_slow), each counted.
__global__ void div6_check_kernel(unsigned long long* bad) {
  unsigned long long local = 0;
  for (uint64_t i = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x; i < (1ull << 32);
       i += (uint64_t)gridDim.x * blockDim.x) {
    const float x = __uint_as_float((unsigned)i);
    const float a = x / 6.0f, b = div6_tie_possible(x) ? div6(x) : div6_near(x);
    const float c = div6_slow(x) ? div6(x) : div6_fast(x);
    local += !(__float_as_uint(a) == __float_as_uint(b) || (isnan(a) && isnan(b)));
    local += !(__float_as_uint(a) == __float_as_uint(c) || (isnan(a) && isnan(c)));
  }
  if (local) atomicAdd(bad, local);
}

// ---------------------------------------------------------------------------
// Order 0 (B4's whole-window order): one sweep a launch, a z-march from L2
// ---------------------------------------------------------------------------

constexpr int kSX = 32;                  // tile width: a warp a row
constexpr int kSWarps = 8;               // warps a CTA
constexpr int kSRows = 2;                // consecutive rows a thread
constexpr int kSY = kSWarps * kSRows;    // tile height
constexpr int kSRing = 2 * (kSX + kSY);  // the tile's halo ring, corners left out
constexpr int kSPX = kSX + 2, kSPlane = (kSY + 2) * kSPX;  // a staged plane with its ring
static_assert(kSRing <= kSX * kSWarps, "a ring cell a thread at most");

__host__ __device__ constexpr int zsweep_smem(int zchunk) {
  return ((zchunk + 2) * kSPlane + zchunk * kSY * kSX) * (int)sizeof(float);
}

// Programmatic dependent launch: a chained sweep waits here for the sweep
// before it to finish (a no-op in a launch without the attribute), and
// lets the next one be scheduled once its own loads are issued.
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void griddep_launch() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// One order-0 sweep of q into out over a (kSY, kSX) tile and `zchunk`
// planes.  The whole chunk is staged at once with cp.async: b of its planes
// first (a chained launch does that while the sweep before it still runs:
// no sweep writes b), then, past griddepcontrol.wait, q of planes z0 - 1 ..
// z1 with the tile's halo ring; one wait, one __syncthreads.  Then a
// thread walks z through its column strip, planes z - 1, z and z + 1 of its
// cells in registers, the x and y neighbours from the staged plane.  A
// staged cell is the edge-clamped one, so a neighbour past the volume is
// the cell itself, as the clamp wants; slots beyond the first past the far
// edges are not staged (only cells outside the volume read them, and many
// lanes on one clamped address slow cp.async down).
__global__ void __launch_bounds__(kSX* kSWarps) zsweep_kernel(const float* __restrict__ q,
                                                              const float* __restrict__ b,
                                                              float* __restrict__ out, int nz,
                                                              int ny, int nx, int zchunk) {
  extern __shared__ __align__(16) float zsm[];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kSX + tx;
  const int bx0 = (int)blockIdx.x * kSX, by0 = (int)blockIdx.y * kSY;
  const int x = bx0 + tx, cx = min(x, nx - 1);
  int off[kSRows];
  bool own[kSRows], stage[kSRows];
#pragma unroll
  for (int r = 0; r < kSRows; ++r) {
    const int y = by0 + ty * kSRows + r;
    off[r] = min(y, ny - 1) * nx + cx;
    own[r] = x < nx && y < ny;
    stage[r] = x <= nx && y <= ny;
  }
  // The ring slot this thread stages: the rows above and below, then the
  // columns left and right.
  bool ring = tid < kSRing;
  int ring_at = 0, ring_off = 0;
  if (ring) {
    int py, px;
    if (tid < 2 * kSX) {
      py = tid < kSX ? 0 : kSY + 1;
      px = tid % kSX + 1;
    } else {
      const int k = tid - 2 * kSX;
      py = k % kSY + 1;
      px = k < kSY ? 0 : kSX + 1;
    }
    ring_at = py * kSPX + px;
    ring_off = min(max(by0 + py - 1, 0), ny - 1) * nx + min(max(bx0 + px - 1, 0), nx - 1);
    ring = by0 + py - 1 <= ny && bx0 + px - 1 <= nx;
  }
  const int64_t plane = (int64_t)ny * nx;
  const int z0 = (int)blockIdx.z * zchunk, np = min(zchunk, nz - z0);
  auto zb = [&](int z) { return (int64_t)min(max(z, 0), nz - 1) * plane; };
  float* const qs = zsm;                           // planes z0 - 1 .. z0 + np, with the ring
  float* const bs = zsm + (zchunk + 2) * kSPlane;  // b of planes z0 .. z0 + np - 1
  const int at0 = (ty * kSRows + 1) * kSPX + tx + 1;
  const int bat0 = ty * kSRows * kSX + tx;
  for (int p = 0; p < np; ++p) {
    const int64_t z = zb(z0 + p);
#pragma unroll
    for (int r = 0; r < kSRows; ++r) {
      if (own[r]) cp_async4(&bs[p * kSY * kSX + bat0 + r * kSX], b + z + off[r]);
    }
  }
  griddep_wait();
  for (int p = 0; p < np + 2; ++p) {
    const int64_t z = zb(z0 - 1 + p);
    float* const d = qs + p * kSPlane;
#pragma unroll
    for (int r = 0; r < kSRows; ++r) {
      if (stage[r]) cp_async4(&d[at0 + r * kSPX], q + z + off[r]);
    }
    if (ring) cp_async4(&d[ring_at], q + z + ring_off);
  }
  cp_async_commit();
  griddep_launch();
  cp_async_wait<0>();
  __syncthreads();

  float lo[kSRows], mid[kSRows], hi[kSRows];
#pragma unroll
  for (int r = 0; r < kSRows; ++r) {
    lo[r] = qs[at0 + r * kSPX];
    mid[r] = qs[kSPlane + at0 + r * kSPX];
  }
  for (int p = 0; p < np; ++p) {
    const float* const c = qs + (p + 1) * kSPlane + at0;
#pragma unroll
    for (int r = 0; r < kSRows; ++r) hi[r] = c[kSPlane + r * kSPX];
    // Plane z0 + p: y+, y-, x+, x-, z+, z-.
    float v[kSRows];
    bool slow = false;
#pragma unroll
    for (int r = 0; r < kSRows; ++r) {
      const float* const k = c + r * kSPX;
      float s = (r < kSRows - 1 ? mid[r + 1] : k[kSPX]) + (r > 0 ? mid[r - 1] : k[-kSPX]);
      s = s + k[1];
      s = s + k[-1];
      s = s + hi[r];
      s = s + lo[r];
      v[r] = s - bs[p * kSY * kSX + bat0 + r * kSX];
      slow |= own[r] & div6_slow(v[r]);
    }
    if (__any_sync(0xffffffffu, slow)) {
#pragma unroll
      for (int r = 0; r < kSRows; ++r) v[r] = div6(v[r]);
    } else {
#pragma unroll
      for (int r = 0; r < kSRows; ++r) v[r] = div6_fast(v[r]);
    }
    const int64_t zo = (int64_t)(z0 + p) * plane;
#pragma unroll
    for (int r = 0; r < kSRows; ++r) {
      if (own[r]) out[zo + off[r]] = v[r];
      lo[r] = mid[r];
      mid[r] = hi[r];
    }
  }
}

// One zsweep launch with the plan ops/cuda/jacobi.window_plan gives: a
// (ty, tx) tile and `zchunk` planes a CTA, `smem` bytes of shared memory.
// The kernel is compiled for one tile, so another is refused, as is less
// shared memory than the chunk stages.  `chained` where a sweep of the same
// chain came before it, which lets it start while that one finishes
// (programmatic stream serialization).  The first launch of a chain is an
// ordinary one: the work before it may still be writing b.
cudaError_t launch_zsweep(const float* q, const float* b, float* out, int nz, int ny, int nx,
                          int ty, int tx, int zchunk, int smem, bool chained, cudaStream_t st) {
  if ((int64_t)ny * nx > INT32_MAX || ty != kSY || tx != kSX || zchunk < 1 ||
      smem < zsweep_smem(zchunk)) {
    return cudaErrorInvalidValue;
  }
  static int smem_allowed = 0;
  if (smem > smem_allowed) {
    cudaError_t err =
        cudaFuncSetAttribute(zsweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_allowed = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((nx + tx - 1) / tx, (ny + ty - 1) / ty, (nz + zchunk - 1) / zchunk);
  cfg.blockDim = dim3(tx, ty / kSRows);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = chained ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, zsweep_kernel, q, b, out, nz, ny, nx, zchunk);
}

// `iters` order-0 sweeps of q into out, one zsweep launch a sweep,
// ping-ponging between out and scratch so that the last ends at out.
cudaError_t window_sweeps(const float* q, const float* b, float* out, float* scratch, int iters,
                          int ty, int tx, int zchunk, int smem, int nz, int ny, int nx,
                          cudaStream_t st) {
  if (iters == 0) {
    return cudaMemcpyAsync(out, q, (size_t)nz * ny * nx * sizeof(float),
                           cudaMemcpyDeviceToDevice, st);
  }
  const float* src = q;
  for (int k = 0; k < iters; ++k) {
    float* dst = sweep_dst(k, iters, out, scratch);
    cudaError_t err = launch_zsweep(src, b, dst, nz, ny, nx, ty, tx, zchunk, smem, k > 0, st);
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// Order 3 (B14): K sweeps a launch over a tile and a ring of K cells
// ---------------------------------------------------------------------------

constexpr int kJ2Block = 4;           // a thread's cells: 4 x 4, one float4 a row
constexpr int kJ2MaxThreads = 512;    // a CTA's region blocks at most

__host__ __device__ constexpr int jacobi2d_threads(int ty, int tx, int ring) {
  return ((ty + 2 * ring) / kJ2Block) * ((tx + 2 * ring) / kJ2Block);
}

// Two buffers of the four edges (top and bottom rows, left and right
// columns) of every thread's block.
__host__ __device__ constexpr int jacobi2d_smem(int threads) {
  return 2 * 4 * threads * (int)sizeof(float4);
}

// (y+ + y- + x+ + x- - b) / 4 in order 3's order; * 0.25f is the division.
__device__ __forceinline__ float j2_cell(float yp, float ym, float xp, float xm, float b) {
  float s = yp + ym;
  s = s + xp;
  s = s + xm;
  return (s - b) * 0.25f;
}

// `levels` (at most `ring`) order-3 sweeps of the (ny, nx) plane q into out
// over a (ty, tx) tile.  The CTA holds the tile and a ring of `ring` cells
// around it, one 4 x 4 block of cells a thread, in registers, with the
// block's b: read before griddepcontrol.wait (no sweep writes b), q after
// it.  A sweep publishes each block's four edges to shared memory, one
// __syncthreads, and reads the four neighbouring blocks' edges that face
// it; everything else a cell needs is in the thread's registers.  A block
// at the plane's edge reads its own edge in place of the neighbour's, so
// each neighbour past the plane clamps to the cell and the plane's edge is
// exact at every level; a block at the region's rim does the same, which
// is not exact, but sweep l is exact l cells inside the rim, and the tile
// is `ring` cells inside.  Blocks past the plane's edge hold nothing (the
// gate's ny % 8 == 0 and nx % 128 == 0 and the tile's and ring's multiples
// of 4 keep every block wholly inside or outside).  Only the tile is written.
__global__ void __launch_bounds__(kJ2MaxThreads)
    jacobi2d_kernel(const float* __restrict__ q, const float* __restrict__ b,
                    float* __restrict__ out, int ny, int nx, int ty, int tx, int ring,
                    int levels) {
  extern __shared__ __align__(16) float4 j2sm[];
  const int t = threadIdx.x, n = blockDim.x;
  const int rbx = (tx + 2 * ring) / kJ2Block, rby = (ty + 2 * ring) / kJ2Block;
  const int by = t / rbx, bx = t % rbx;
  const int gy0 = (int)blockIdx.y * ty - ring + by * kJ2Block;
  const int gx0 = (int)blockIdx.x * tx - ring + bx * kJ2Block;
  const bool live = gy0 >= 0 && gy0 < ny && gx0 >= 0 && gx0 < nx;
  const int rb = ring / kJ2Block;
  const bool owned = live && by >= rb && by < rb + ty / kJ2Block && bx >= rb &&
                     bx < rb + tx / kJ2Block;
  // Edge entries: [0, n) top rows, [n, 2n) bottom rows, [2n, 3n) left
  // columns, [3n, 4n) right columns.  The entry facing each side of this
  // block: the neighbour's, or this block's own at the plane's edge and the
  // region's rim.
  const int above = by > 0 && gy0 > 0 ? n + t - rbx : t;
  const int below = by < rby - 1 && gy0 + kJ2Block < ny ? t + rbx : n + t;
  const int left = bx > 0 && gx0 > 0 ? 3 * n + t - 1 : 2 * n + t;
  const int right = bx < rbx - 1 && gx0 + kJ2Block < nx ? 2 * n + t + 1 : 3 * n + t;
  const int64_t at = live ? (int64_t)gy0 * nx + gx0 : 0;
  float4 bv[kJ2Block], qv[kJ2Block];
#pragma unroll
  for (int r = 0; r < kJ2Block; ++r) {
    bv[r] = live ? __ldg((const float4*)(b + at + (int64_t)r * nx)) : make_float4(0, 0, 0, 0);
  }
  griddep_wait();
#pragma unroll
  for (int r = 0; r < kJ2Block; ++r) {
    qv[r] = live ? *(const float4*)(q + at + (int64_t)r * nx) : make_float4(0, 0, 0, 0);
  }
  griddep_launch();
  for (int l = 0; l < levels; ++l) {
    float4* const e = j2sm + (l & 1) * 4 * n;
    e[t] = qv[0];
    e[n + t] = qv[kJ2Block - 1];
    e[2 * n + t] = make_float4(qv[0].x, qv[1].x, qv[2].x, qv[3].x);
    e[3 * n + t] = make_float4(qv[0].w, qv[1].w, qv[2].w, qv[3].w);
    __syncthreads();
    const float4 up = e[above], down = e[below], lf = e[left], rt = e[right];
    const float xl[kJ2Block] = {lf.x, lf.y, lf.z, lf.w};
    const float xr[kJ2Block] = {rt.x, rt.y, rt.z, rt.w};
    float4 nq[kJ2Block];
#pragma unroll
    for (int r = 0; r < kJ2Block; ++r) {
      const float4 yp = r < kJ2Block - 1 ? qv[r + 1] : down;
      const float4 ym = r > 0 ? qv[r - 1] : up;
      const float4 c = qv[r], bc = bv[r];
      nq[r] = make_float4(j2_cell(yp.x, ym.x, c.y, xl[r], bc.x),
                          j2_cell(yp.y, ym.y, c.z, c.x, bc.y),
                          j2_cell(yp.z, ym.z, c.w, c.y, bc.z),
                          j2_cell(yp.w, ym.w, xr[r], c.z, bc.w));
    }
#pragma unroll
    for (int r = 0; r < kJ2Block; ++r) qv[r] = nq[r];
  }
  if (owned) {
#pragma unroll
    for (int r = 0; r < kJ2Block; ++r) *(float4*)(out + at + (int64_t)r * nx) = qv[r];
  }
}

// `iters` order-3 sweeps of the (ny, nx) plane q into out with the plan
// ops/cuda/jacobi.jacobi2d_plan gives: a (ty, tx) tile and a ring of `ring`
// cells a CTA, `smem` bytes of shared memory.  ceil(iters / ring) launches,
// each of `ring` sweeps but the last, which takes the rest, ping-ponging
// between out and scratch so that the last ends at out; launches after the
// first are programmatic dependent launches.  Refuses a plan the kernel
// cannot run: a tile, ring or plane not in whole 4 x 4 blocks, more region
// blocks than kJ2MaxThreads, less shared memory than the edge buffers, or
// rows that are not 16-byte aligned.
cudaError_t jacobi2d_sweeps(const float* q, const float* b, float* out, float* scratch,
                            int iters, int ty, int tx, int ring, int smem, int ny, int nx,
                            cudaStream_t st) {
  const int threads = ty > 0 && tx > 0 && ring > 0 ? jacobi2d_threads(ty, tx, ring) : 0;
  const auto misaligned = [](const void* p) { return ((uintptr_t)p & 15) != 0; };
  if ((int64_t)ny * nx > INT32_MAX || ny < 1 || nx < 1 || ny % kJ2Block ||
      nx % kJ2Block || ty < 1 || tx < 1 || ring < 1 || ty % kJ2Block || tx % kJ2Block ||
      ring % kJ2Block || threads > kJ2MaxThreads || smem < jacobi2d_smem(threads) ||
      misaligned(q) || misaligned(b) || misaligned(out) || (iters > ring && misaligned(scratch))) {
    return cudaErrorInvalidValue;
  }
  if (iters == 0) {
    return cudaMemcpyAsync(out, q, (size_t)ny * nx * sizeof(float), cudaMemcpyDeviceToDevice, st);
  }
  static int smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    cudaError_t err =
        cudaFuncSetAttribute(jacobi2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_allowed = smem;
  }
  const int launches = (iters + ring - 1) / ring;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((nx + tx - 1) / tx, (ny + ty - 1) / ty);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  const float* src = q;
  for (int k = 0; k < launches; ++k) {
    float* dst = sweep_dst(k, launches, out, scratch);
    cfg.numAttrs = k > 0 ? 1 : 0;
    const int levels = iters - k * ring < ring ? iters - k * ring : ring;
    cudaError_t err =
        cudaLaunchKernelEx(&cfg, jacobi2d_kernel, src, b, dst, ny, nx, ty, tx, ring, levels);
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// Order 2 (B6): every sweep in the shared memory of one thread-block cluster
// ---------------------------------------------------------------------------

constexpr int kPChunks = 16;      // float4s in a row of 64 floats
constexpr int kPMaxCluster = 16;  // CTAs a cluster (16 is non-portable)
constexpr int kPMaxRows = 256;    // rows a CTA: 3 * 64 KiB of shared memory
constexpr int kPMaxThreads = 1024;

__device__ __forceinline__ uint32_t cluster_addr(uint32_t cta_addr, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(cta_addr), "r"(rank));
  return a;
}

// A float4 of any CTA's shared memory in the cluster.  Volatile, so it stays
// between the cluster barriers that bracket its sweep.
__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

// The cluster barrier: every CTA's shared-memory writes before it are seen
// by every CTA's reads after it; a compiler barrier for every memory access
// and volatile asm.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// (x+ + x- + y+ + y- + z+ + z-) - b, order 2's sum.
__device__ __forceinline__ float packed_cell(float xp, float xm, float yp, float ym, float zp,
                                             float zm, float bq) {
  float s = xp + xm;
  s = s + yp;
  s = s + ym;
  s = s + zp;
  s = s + zm;
  return s - bq;
}

// All `iters` order-2 sweeps of a (nz, ny, 64) volume in one launch of one
// cluster.  The volume is nz * ny rows of 64 floats; CTA `rank` owns rows
// [rank * rpc, (rank + 1) * rpc) (rpc = 2^lg_rpc; the last CTA's tail past
// the volume is computed from clamped rows and never written) and keeps
// them in shared memory, twice (ping-pong), for the other threads and
// CTAs.  A thread takes kItems (row, chunk) items, chunk = 4 consecutive
// x, rows blockDim / 16 apart, and keeps each item's q and b in registers
// across the sweeps: a sweep reads from shared memory only the y and z
// neighbour rows (edge-clamped; through distributed shared memory at
// cluster addresses formed once with mapa, the own CTA's rows too) and the
// x neighbours come from the float4 and the 16-lane shuffle of the row.
// One cluster barrier a sweep: a sweep reads one buffer and writes the
// other, the last writes global memory, and the last barrier keeps every
// CTA's buffers alive until the others' reads are done.
template <int kItems>
__global__ void __launch_bounds__(kPMaxThreads, 1)
    packed_kernel(const float* __restrict__ q, const float* __restrict__ b, float* __restrict__ out,
                  int iters, int nz, int ny, int lg_rpc) {
  extern __shared__ __align__(16) float4 psm[];
  const int rank = (int)cooperative_groups::this_cluster().block_rank();
  const int rpc = 1 << lg_rpc, rows = nz * ny, row0 = rank * rpc;
  const int nrow = min(rpc, rows - row0);
  const int cells = rpc * kPChunks;  // float4s a buffer
  const int c = threadIdx.x & (kPChunks - 1);
  const int rstep = blockDim.x / kPChunks;
  auto lrow = [&](int j) { return (int)(threadIdx.x / kPChunks) + j * rstep; };

  // The items' q and b, all loads first.
  float4 qv[kItems], bv[kItems];
  {
    const float4* q4 = reinterpret_cast<const float4*>(q) + (int64_t)row0 * kPChunks;
    const float4* b4 = reinterpret_cast<const float4*>(b) + (int64_t)row0 * kPChunks;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = lrow(j) * kPChunks + c;
      if (lrow(j) < nrow) {
        qv[j] = q4[i];
        bv[j] = b4[i];
      } else {
        qv[j] = bv[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
  }
  // The cluster addresses of each item's y+, y-, z+ and z- neighbours in
  // their owners' first buffer.
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(psm);
  uint32_t nb[kItems][4];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int row = min(row0 + lrow(j), rows - 1);
    const int z = row / ny, y = row - z * ny;
    const int nbr[4] = {y < ny - 1 ? row + 1 : row, y > 0 ? row - 1 : row,
                        z < nz - 1 ? row + ny : row, z > 0 ? row - ny : row};
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const uint32_t idx = (uint32_t)((nbr[n] & (rpc - 1)) * kPChunks + c);
      nb[j][n] = cluster_addr(base + idx * (uint32_t)sizeof(float4), nbr[n] >> lg_rpc);
    }
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) psm[lrow(j) * kPChunks + c] = qv[j];
  cluster_barrier();

  float4* const o4 = reinterpret_cast<float4*>(out);
  for (int k = 0; k < iters; ++k) {
    const int src = (k & 1) * cells, dst = cells - src;
    const uint32_t src_bytes = (uint32_t)src * (uint32_t)sizeof(float4);
    const bool last = k == iters - 1;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const float4 me = qv[j], bq = bv[j];
      float xpn = __shfl_down_sync(0xffffffffu, me.x, 1, kPChunks);
      float xmn = __shfl_up_sync(0xffffffffu, me.w, 1, kPChunks);
      if (c == kPChunks - 1) xpn = me.w;
      if (c == 0) xmn = me.x;
      float4 v[4];
#pragma unroll
      for (int n = 0; n < 4; ++n) v[n] = ld_cluster4(nb[j][n] + src_bytes);
      float4 o;
      o.x = packed_cell(me.y, xmn, v[0].x, v[1].x, v[2].x, v[3].x, bq.x);
      o.y = packed_cell(me.z, me.x, v[0].y, v[1].y, v[2].y, v[3].y, bq.y);
      o.z = packed_cell(me.w, me.y, v[0].z, v[1].z, v[2].z, v[3].z, bq.z);
      o.w = packed_cell(xpn, me.z, v[0].w, v[1].w, v[2].w, v[3].w, bq.w);
      const bool slow = div6_slow(o.x) | div6_slow(o.y) | div6_slow(o.z) | div6_slow(o.w);
      if (__any_sync(0xffffffffu, slow)) {
        o = make_float4(div6(o.x), div6(o.y), div6(o.z), div6(o.w));
      } else {
        o = make_float4(div6_fast(o.x), div6_fast(o.y), div6_fast(o.z), div6_fast(o.w));
      }
      qv[j] = o;
      if (!last) {
        psm[dst + lrow(j) * kPChunks + c] = o;
      } else if (lrow(j) < nrow) {
        o4[(int64_t)(row0 + lrow(j)) * kPChunks + c] = o;
      }
    }
    cluster_barrier();
  }
}

template <int kItems>
cudaError_t launch_packed_items(cudaLaunchConfig_t& cfg, int lg, const float* q, const float* b,
                                float* out, int iters, int nz, int ny) {
  static int smem_allowed = 0;
  if (smem_allowed == 0) {
    cudaError_t err = cudaFuncSetAttribute(packed_kernel<kItems>,
                                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  if ((int)cfg.dynamicSmemBytes > smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        packed_kernel<kItems>, cudaFuncAttributeMaxDynamicSharedMemorySize, cfg.dynamicSmemBytes);
    if (err != cudaSuccess) return err;
    smem_allowed = (int)cfg.dynamicSmemBytes;
  }
  // Residency, checked once per (cluster, rows a CTA, shared memory).
  static int resident[kPMaxCluster + 1][9] = {};
  if (resident[cfg.gridDim.x][lg] != (int)cfg.dynamicSmemBytes) {
    int active = 0;
    cudaError_t err = cudaOccupancyMaxActiveClusters(&active, packed_kernel<kItems>, &cfg);
    if (err != cudaSuccess) return err;
    if (active < 1) return cudaErrorLaunchOutOfResources;
    resident[cfg.gridDim.x][lg] = (int)cfg.dynamicSmemBytes;
  }
  return cudaLaunchKernelEx(&cfg, packed_kernel<kItems>, q, b, out, iters, nz, ny, lg);
}

// One launch of packed_kernel with the plan ops/cuda/jacobi.packed_plan
// gives: `cluster` CTAs of `threads` threads, `rpc` rows and `smem` bytes
// each.  Refuses a plan the kernel cannot run -- one that does not cover
// the volume's rows once, a range that is not a power of two, threads
// that are not whole warps or not 1, 2 or 4 float4s of the range each,
// less shared memory than the two buffers -- and raises
// cudaErrorLaunchOutOfResources where the card cannot hold such a cluster
// (cudaOccupancyMaxActiveClusters: none) -- never a fallback.
cudaError_t launch_packed(const float* q, const float* b, float* out, int iters, int cluster,
                          int rpc, int threads, int smem, int nz, int ny, int nx,
                          cudaStream_t st) {
  const int64_t rows = (int64_t)nz * ny;
  int lg = 0;
  while ((1 << lg) < rpc) ++lg;
  if (nx != kPChunks * 4 || rows < 1 || cluster < 1 || cluster > kPMaxCluster || rpc < 1 ||
      rpc > kPMaxRows || (1 << lg) != rpc || (int64_t)cluster * rpc < rows ||
      (int64_t)(cluster - 1) * rpc >= rows || threads < 32 || threads > kPMaxThreads ||
      threads % 32 || (rpc * kPChunks) % threads ||
      smem < 2 * rpc * kPChunks * (int)sizeof(float4)) {
    return cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  switch (rpc * kPChunks / threads) {
    case 1: return launch_packed_items<1>(cfg, lg, q, b, out, iters, nz, ny);
    case 2: return launch_packed_items<2>(cfg, lg, q, b, out, iters, nz, ny);
    case 4: return launch_packed_items<4>(cfg, lg, q, b, out, iters, nz, ny);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Order 1, one launch per sweep: the yardstick fx_jacobi_sweepwise times
// ---------------------------------------------------------------------------

// The neighbour sum of cell k in the plane-sweep order y+, y-, x+, x-,
// z-, z+ (jacobi_sweep_kernel<1>'s).
__device__ __forceinline__ float planewise_sum(const float* __restrict__ q, const Cell& k) {
  float s = q[k.yp] + q[k.ym];
  s = s + q[k.xp];
  s = s + q[k.xm];
  s = s + q[k.zm];
  return s + q[k.zp];
}

// The residual b - A q of fine cell (z, y, x), summed in the plane-sweep
// order.
__device__ __forceinline__ float planewise_residual(const float* __restrict__ q,
                                                    const float* __restrict__ b, int z, int y,
                                                    int x, int nz, int ny, int nx) {
  const int64_t plane = (int64_t)ny * nx;
  const int64_t idx = (int64_t)z * plane + (int64_t)y * nx + x;
  float s = q[y < ny - 1 ? idx + nx : idx] + q[y > 0 ? idx - nx : idx];
  s = s + q[x < nx - 1 ? idx + 1 : idx];
  s = s + q[x > 0 ? idx - 1 : idx];
  s = s + q[z > 0 ? idx - plane : idx];
  s = s + q[z < nz - 1 ? idx + plane : idx];
  return b[idx] - (s - 6.0f * q[idx]);
}

// b = the divergence of channels 0..2 of f at each cell, written to b, and
// (with out non-null) the first order-1 sweep of q against it, written to
// out.
template <typename T>
__global__ void divergence_sweep_kernel(const T* __restrict__ f, const float* __restrict__ q,
                                        float* __restrict__ b, float* __restrict__ out, int nz,
                                        int ny, int nx) {
  const int64_t n = (int64_t)nz * ny * nx;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const Cell k = cell_at(idx, nz, ny, nx);
  const float bv = divergence_at(f, k, n);
  b[idx] = bv;
  if (out != nullptr) out[idx] = (planewise_sum(q, k) - bv) / 6.0f;
}

// One thread per coarse cell (nz/2, ny/2, nx/2); w = fl32(0.5 * scale).
__global__ void residual_restrict_kernel(const float* __restrict__ q,
                                         const float* __restrict__ b,
                                         float* __restrict__ rc, float w, int nz, int ny,
                                         int nx) {
  const int nzc = nz / 2, nyc = ny / 2, nxc = nx / 2;
  const int64_t n = (int64_t)nzc * nyc * nxc;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int xc = (int)(idx % nxc);
  const int yc = (int)((idx / nxc) % nyc);
  const int zc = (int)(idx / ((int64_t)nyc * nxc));
  float xz[2];
  for (int j = 0; j < 2; ++j) {
    const int y = 2 * yc + j;
    float s[2];
    for (int i = 0; i < 2; ++i) {
      const int x = 2 * xc + i;
      s[i] = planewise_residual(q, b, 2 * zc, y, x, nz, ny, nx) +
             planewise_residual(q, b, 2 * zc + 1, y, x, nz, ny, nx);
    }
    xz[j] = (s[0] * w + s[1] * w) * 0.5f;
  }
  rc[idx] = 0.5f * xz[0] + 0.5f * xz[1];
}

cudaError_t launch_residual_restrict(const float* q, const float* b, float* rc, float w, int nz,
                                     int ny, int nx, cudaStream_t st) {
  residual_restrict_kernel<<<blocks_for((int64_t)(nz / 2) * (ny / 2) * (nx / 2)), kThreads, 0,
                             st>>>(q, b, rc, w, nz, ny, nx);
  return cudaGetLastError();
}

template <typename T>
cudaError_t sweepwise_divrr(const T* f, const float* q, float* out, float* scratch, float* b,
                            float* rc, int iters, float w, int nz, int ny, int nx,
                            cudaStream_t st) {
  float* first = iters > 0 ? sweep_dst(0, iters, out, scratch) : nullptr;
  divergence_sweep_kernel<<<blocks_for((int64_t)nz * ny * nx), kThreads, 0, st>>>(
      f, q, b, first, nz, ny, nx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (iters == 0) {
    err = cudaMemcpyAsync(out, q, (size_t)nz * ny * nx * sizeof(float),
                          cudaMemcpyDeviceToDevice, st);
  } else {
    err = sweeps<1>(first, b, out, scratch, 1, iters, nz, ny, nx, st);
  }
  if (err != cudaSuccess) return err;
  return launch_residual_restrict(out, b, rc, w, nz, ny, nx, st);
}

cudaError_t copy_or_sweeps(const float* q, const float* b, float* out, float* scratch, int iters,
                           int order, int nz, int ny, int nx, cudaStream_t st) {
  if (iters == 0) {
    return cudaMemcpyAsync(out, q, (size_t)nz * ny * nx * sizeof(float),
                           cudaMemcpyDeviceToDevice, st);
  }
  switch (order) {
    case 0: return sweeps<0>(q, b, out, scratch, 0, iters, nz, ny, nx, st);
    case 1: return sweeps<1>(q, b, out, scratch, 0, iters, nz, ny, nx, st);
    case 2: return sweeps<2>(q, b, out, scratch, 0, iters, nz, ny, nx, st);
    case 3: return sweeps<3>(q, b, out, scratch, 0, iters, nz, ny, nx, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, b, out, scratch (nz, ny, nx) f32; q is read only.  Order 1 (the
// blocked march); orders 0, 2 and 3 are fx_jacobi_window, fx_jacobi_packed
// and fx_jacobi2d.
int fx_jacobi(const void* q, const void* b, void* out, void* scratch, int iters, int order,
              int nz, int ny, int nx, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (order != 1) return (int)cudaErrorInvalidValue;
  if (iters > 0) {
    return (int)march<kNone, float>(march_args((const float*)b, nz, ny, nx), (const float*)q,
                             (float*)out, (float*)scratch, iters, st);
  }
  return (int)copy_or_sweeps((const float*)q, (const float*)b, (float*)out, (float*)scratch,
                             iters, order, nz, ny, nx, st);
}

// B14 (order 3): `iters` sweeps of the (ny, nx) plane q into out (with
// scratch as fx_jacobi), ring sweeps a launch, with the plan
// ops/cuda/jacobi.jacobi2d_plan gives (a (ty, tx) tile and a ring of `ring`
// cells a CTA, smem bytes each).
int fx_jacobi2d(const void* q, const void* b, void* out, void* scratch, int iters, int ty,
                int tx, int ring, int smem, int ny, int nx, void* stream) {
  return (int)jacobi2d_sweeps((const float*)q, (const float*)b, (float*)out, (float*)scratch,
                              iters, ty, tx, ring, smem, ny, nx, (cudaStream_t)stream);
}

// B4's whole-window order (order 0): `iters` sweeps of q into out (with
// scratch as fx_jacobi), one zsweep launch a sweep with the plan
// ops/cuda/jacobi.window_plan gives (a (ty, tx) tile and zchunk planes a
// CTA, smem bytes each).
int fx_jacobi_window(const void* q, const void* b, void* out, void* scratch, int iters, int ty,
                     int tx, int zchunk, int smem, int nz, int ny, int nx, void* stream) {
  return (int)window_sweeps((const float*)q, (const float*)b, (float*)out, (float*)scratch, iters,
                            ty, tx, zchunk, smem, nz, ny, nx, (cudaStream_t)stream);
}

// B6 (order 2): `iters` sweeps of a (nz, ny, 64) q into out in one cluster
// launch with the plan ops/cuda/jacobi.packed_plan gives (cluster CTAs,
// rpc rows, threads and smem bytes each).
int fx_jacobi_packed(const void* q, const void* b, void* out, int iters, int cluster, int rpc,
                     int threads, int smem, int nz, int ny, int nx, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (iters == 0) {
    return (int)cudaMemcpyAsync(out, q, (size_t)nz * ny * nx * sizeof(float),
                                cudaMemcpyDeviceToDevice, st);
  }
  return (int)launch_packed((const float*)q, (const float*)b, (float*)out, iters, cluster, rpc,
                            threads, smem, nz, ny, nx, st);
}

// B13: `iters` order-1 sweeps of q (out_q, with scratch as fx_jacobi), then
// rc (nz/2, ny/2, nx/2) = restrict(b - A out_q) * scale, w = fl32(0.5 * scale).
// All dims even.
int fx_jacobi_rr(const void* q, const void* b, void* out_q, void* scratch, void* rc,
                 int iters, float w, int nz, int ny, int nx, void* stream) {
  MarchArgs a = march_args((const float*)b, nz, ny, nx);
  a.rc = (float*)rc;
  a.w = w;
  return (int)march<kResidualRestrict, float>(a, (const float*)q, (float*)out_q,
                                              (float*)scratch, iters, (cudaStream_t)stream);
}

// B18 head: b (nz, ny, nx) f32 = the divergence of channels 0..2 of fields
// (C >= 3, nz, ny, nx) bf16 (is_bf16) or f32; then as fx_jacobi_rr: `iters`
// order-1 sweeps of q against b into out_q (with scratch), and rc =
// restrict(b - A out_q) * scale, w = fl32(0.5 * scale).  All dims even.
int fx_jacobi_divrr(const void* fields, int is_bf16, const void* q, void* out_q, void* scratch,
                    void* b, void* rc, int iters, float w, int nz, int ny, int nx,
                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    MarchArgs a = march_args((const float*)b, nz, ny, nx);
    a.div_f = fields;
    a.b_out = (float*)b;
    a.rc = (float*)rc;
    a.w = w;
    return (int)march<kResidualRestrict, __nv_bfloat16>(a, (const float*)q, (float*)out_q,
                                                        (float*)scratch, iters, st);
  }
  MarchArgs a = march_args((const float*)b, nz, ny, nx);
  a.div_f = fields;
  a.b_out = (float*)b;
  a.rc = (float*)rc;
  a.w = w;
  return (int)march<kResidualRestrict, float>(a, (const float*)q, (float*)out_q, (float*)scratch,
                                              iters, st);
}

// B18 tail: `iters` order-1 sweeps of q against b into out_q (with
// scratch, as fx_jacobi), then channels 0..2 of fields (C >= 3, nz, ny, nx)
// bf16 (is_bf16) or f32 -= the gradient of out_q times s = fl32(0.5 / rho),
// with the wall-band damp, in place.
int fx_jacobi_grad(const void* q, const void* b, void* out_q, void* scratch, void* fields,
                   int is_bf16, float s, int iters, int nz, int ny, int nx, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    MarchArgs a = march_args((const float*)b, nz, ny, nx);
    a.f = fields;
    a.s = s;
    return (int)march<kGradDamp, __nv_bfloat16>(a, (const float*)q, (float*)out_q,
                                                (float*)scratch, iters, st);
  }
  MarchArgs a = march_args((const float*)b, nz, ny, nx);
  a.f = fields;
  a.s = s;
  return (int)march<kGradDamp, float>(a, (const float*)q, (float*)out_q, (float*)scratch, iters,
                                      st);
}

// The per-sweep designs, kept to time the redesigned kernels against: one
// launch per sweep (the head's first also forms b), the epilogues as
// separate passes.  mode 0: fx_jacobi order 1 (q, b -> out_q); 1:
// fx_jacobi_rr (q, b -> out_q, rc); 2: fx_jacobi_divrr (fields, q -> out_q,
// b, rc); 3: fx_jacobi_grad (q, b -> out_q, fields in place); 4: order 0
// (fx_jacobi_window); 5: order 2 (fx_jacobi_packed); 6: order 3 on one
// (ny, nx) plane, nz = 1 (fx_jacobi2d).  Arguments a mode does not read may
// be null.
int fx_jacobi_sweepwise(int mode, const void* fields, int is_bf16, const void* q, void* b,
                        void* out_q, void* scratch, void* rc, float w, float s, int iters,
                        int nz, int ny, int nx, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* qf = (const float*)q;
  float* bf = (float*)b;
  float* of = (float*)out_q;
  float* sf = (float*)scratch;
  cudaError_t err;
  switch (mode) {
    case 0: return (int)copy_or_sweeps(qf, bf, of, sf, iters, 1, nz, ny, nx, st);
    case 1:
      err = copy_or_sweeps(qf, bf, of, sf, iters, 1, nz, ny, nx, st);
      return (int)(err != cudaSuccess ? err
                                      : launch_residual_restrict(of, bf, (float*)rc, w, nz, ny,
                                                                 nx, st));
    case 2:
      return is_bf16 ? (int)sweepwise_divrr((const __nv_bfloat16*)fields, qf, of, sf, bf,
                                            (float*)rc, iters, w, nz, ny, nx, st)
                     : (int)sweepwise_divrr((const float*)fields, qf, of, sf, bf, (float*)rc,
                                            iters, w, nz, ny, nx, st);
    case 3:
      err = copy_or_sweeps(qf, bf, of, sf, iters, 1, nz, ny, nx, st);
      return (int)(err != cudaSuccess
                       ? err
                       : launch_grad_damp((void*)fields, of, s, is_bf16, nz, ny, nx, st));
    case 4: return (int)copy_or_sweeps(qf, bf, of, sf, iters, 0, nz, ny, nx, st);
    case 5: return (int)copy_or_sweeps(qf, bf, of, sf, iters, 2, nz, ny, nx, st);
    case 6: return (int)copy_or_sweeps(qf, bf, of, sf, iters, 3, nz, ny, nx, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Counts into *count (a zeroed u64 on the device) the f32 bit patterns x
// for which the branch-free division differs from x / 6.0f, in either of
// its two forms (the march's, and the z-sweep's and cluster kernel's).
int fx_div6_mismatches(void* count, void* stream) {
  div6_check_kernel<<<132 * 16, 256, 0, (cudaStream_t)stream>>>((unsigned long long*)count);
  return (int)cudaGetLastError();
}

}  // extern "C"
