// The streaming stencils for Hopper: the projection's B3, B5, B7 and B8,
// and the GI light map's B15 and B16.
//
// B3 (fx_divergence) replaces fluidx12_tpu/ops/pallas/stencil.py _div_kernel
// (via divergence_pallas), B5 (fx_residual) _residual_kernel (via
// residual_pallas), B7 (fx_prolong_correct) _prolong_correct_kernel (via
// prolong_correct_pallas), B8 (fx_grad_damp) _grad_damp_kernel (via
// grad_damp_pallas), B15 (fx_gradient3) _gradient_kernel (via
// gradient3_pallas; see gradient3_kernel below) and B16 (fx_gi_light)
// _gi_light_kernel (via gi_light_pallas; see gi_light_kernel below).
// Semantics are the kernels', not the XLA twins':
//   - B3 casts channels 0..2 to f32 and returns 0.5 * ((dx + dy) + dz);
//   - B5 sums the neighbours x+, x-, y+, y-, z-, z+ in that order;
//   - B7 upsamples each coarse plane as the kernel's two dots, y then x
//     (each column of the prolongation matrix has at most two non-zero
//     taps, summed in ascending order, so the dot is exact to reproduce),
//     then lerps the upsampled planes in z at 0.25 / 0.75 with clamped
//     neighbours and adds q;
//   - B8 forms the gradient with the f32 scale fl32(0.5 / rho), the wall
//     position ((i + 0.5) / n) * 2 - 1 and the band clip((0.97 - |pos|) /
//     0.03, -1, 1) in f32 and rounds once to the storage type, in place on
//     channels 0..2 (the TPU kernel aliases its input); channels 3.. are
//     never read or written.
// The per-cell B3's and B8's device code lives in stencil.cuh, which B18
// (jacobi.cu) shares.  Every edge is clamped.  Built with --fmad=false, so
// every product and sum rounds as in the Pallas code and the plain PyTorch
// versions.
//
// Bound: memory (a few operations per byte).  At 128^3: B3 reads 3 bf16
// channels and writes f32 (10 B per cell, 21.0 MB, 6.3 us at 3.35 TB/s;
// 50.1 us at 256^3); B5 reads q and b and writes r (12 B, 25.2 MB, 7.5 us);
// B7 reads q and the coarse e_c and writes f32 (8.5 B, 17.8 MB, 5.3 us;
// 42.6 us at 256^3); B8 reads p and 3 bf16 channels and writes them back
// (16 B, 33.6 MB, 10.0 us; 80.1 us at 256^3).
// All four, and B15, are z-marches (ops/cuda/stencil.stencil_plan lays
// them out: a thread a quad of 4 x of one row, CTAs of 256 threads, a
// chunk of planes each, about four CTAs an SM; B15 is described at
// gradient_march_kernel).  They replaced one thread per cell, which
// spent its issue slots on 64-bit divisions for (z, y, x), on scattered
// neighbour loads that re-read every cell from L1/L2 six times, in B7 on
// two upsampled coarse planes per fine cell and in B8 on six IEEE
// divisions for the bands:
//   - B3 (divergence_march_kernel) needs each channel's neighbours along one
//     axis only.  uz(z - 1), uz(z), uz(z + 1) of the quad stay in
//     registers, one new plane a step; ux moves as a vector, its x +- 1
//     from the adjacent lanes of the CTA row (__shfl_*), loaded only at
//     the row's two ends; uy, which needs rows y +- 1 and never y, is
//     staged a plane of the CTA's rows and a halo row either side at a
//     time into a ring of 3 planes by cp.async, two planes ahead; the
//     march is unrolled by two so that ux and uz are loaded a plane ahead
//     into registers.  out moves as float4.
//   - B5 (residual_march_kernel) reads q at all six neighbours, as B8 reads
//     p: it stages q into B8's ring (below) and streams b in and r out as
//     vectors.
//   - B7 (prolong_march_kernel) keeps the laterally upsampled coarse planes
//     U(m - 1), U(m), U(m + 1) of its quad in registers and forms one a
//     coarse plane: 8 coarse loads (2 rows x 4 columns, through L1; the
//     coarse field is an eighth of the bytes and L2-resident) for 8 fine
//     cells.  q and out move as float4 (float2 where a row is not 16-byte
//     aligned).
//   - B8 (grad_damp_march_kernel) stages each pressure plane of its tile
//     and a one-cell halo into a ring of 3 planes with cp.async, a plane
//     ahead; gx and gy read the ring, gz the next ring plane and the last
//     centre in registers.  The velocity moves as 8-byte vectors of 4 bf16
//     (16-byte of f32; narrower on rows like X = 150's), in place on
//     channels 0..2.  The bands are formed once a thread (x), once (y) and
//     once a plane (z), with band_at's arithmetic.
// What holds them back: B7 streams q and out and little else (its coarse
// reads hit L1); B3, B5 and B8 also stage their tile's halo (two rows of
// every CTA's rows, and for B5 and B8 two columns a row), wait at a
// barrier a plane, and on rows whose alignment allows only narrower
// vectors (X = 150: 4-byte bf16 pairs, 8-byte f32 pairs) issue more
// accesses a byte.  PERF.md has their times against the bound.  The
// one-thread-a-cell designs stay as yardsticks
// (fx_divergence_perthread, fx_residual_perthread,
// fx_prolong_correct_perthread, fx_grad_damp_perthread,
// fx_gradient3_perthread; launch_grad_damp is also B18's per-sweep
// yardstick's epilogue).

#include "stencil.cuh"

namespace {

template <typename T>
__global__ void divergence_kernel(const T* __restrict__ f, float* __restrict__ out,
                                  int nz, int ny, int nx) {
  const int64_t n = (int64_t)nz * ny * nx;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  out[idx] = divergence_at(f, cell_at(idx, nz, ny, nx), n);
}

__global__ void residual_kernel(const float* __restrict__ q, const float* __restrict__ b,
                                float* __restrict__ r, int nz, int ny, int nx) {
  const int64_t n = (int64_t)nz * ny * nx;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const Cell k = cell_at(idx, nz, ny, nx);
  float s = q[k.xp] + q[k.xm];
  s = s + q[k.yp];
  s = s + q[k.ym];
  s = s + q[k.zm];
  s = s + q[k.zp];
  r[idx] = b[idx] - (s - 6.0f * q[idx]);
}

// The two non-zero taps of column i of the (n_c, 2 n_c) prolongation
// matrix, in ascending coarse index; at a clamped edge one tap of weight 1.
struct Taps {
  int lo, hi;
  float wlo, whi;
};

__device__ __forceinline__ Taps prolong_taps(int i, int nc) {
  const int m = i >> 1;
  Taps t;
  if ((i & 1) == 0) {
    t.lo = m - 1; t.hi = m; t.wlo = 0.25f; t.whi = 0.75f;
  } else {
    t.lo = m; t.hi = m + 1; t.wlo = 0.75f; t.whi = 0.25f;
  }
  if (t.lo < 0 || t.hi > nc - 1) {
    t.lo = max(t.lo, 0);
    t.hi = t.lo;
    t.wlo = 1.0f;
    t.whi = 0.0f;
  }
  return t;
}

// Coarse plane j upsampled to fine (y, x): the y dot, then the x dot.
__device__ __forceinline__ float upsample(const float* __restrict__ ec, int j, const Taps& ty,
                                          const Taps& tx, int nyc, int nxc) {
  const float* p = ec + (int64_t)j * nyc * nxc;
  const float a_lo = ty.wlo * p[(int64_t)ty.lo * nxc + tx.lo] + ty.whi * p[(int64_t)ty.hi * nxc + tx.lo];
  const float a_hi = ty.wlo * p[(int64_t)ty.lo * nxc + tx.hi] + ty.whi * p[(int64_t)ty.hi * nxc + tx.hi];
  return tx.wlo * a_lo + tx.whi * a_hi;
}

__global__ void prolong_correct_kernel(const float* __restrict__ q, const float* __restrict__ ec,
                                       float* __restrict__ out, int nz, int ny, int nx) {
  const int64_t n = (int64_t)nz * ny * nx;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int x = (int)(idx % nx);
  const int y = (int)((idx / nx) % ny);
  const int z = (int)(idx / ((int64_t)ny * nx));
  const int nzc = nz / 2, nyc = ny / 2, nxc = nx / 2;
  const Taps ty = prolong_taps(y, nyc);
  const Taps tx = prolong_taps(x, nxc);
  const int m = z >> 1;
  const float c = upsample(ec, m, ty, tx, nyc, nxc);
  float e;
  if ((z & 1) == 0) {
    e = 0.25f * upsample(ec, max(m - 1, 0), ty, tx, nyc, nxc) + 0.75f * c;
  } else {
    e = 0.75f * c + 0.25f * upsample(ec, min(m + 1, nzc - 1), ty, tx, nyc, nxc);
  }
  out[idx] = q[idx] + e;
}

// ---------------------------------------------------------------------------
// B3, B5, B7 and B8 as z-marches (ops/cuda/stencil.stencil_plan lays them
// out).
// ---------------------------------------------------------------------------

// A thread owns kQuad consecutive x of one row; a CTA kCtaThreads threads,
// `quads` of them along x and 256 / quads rows.  B8 stages its pressure
// (B5 its q) in a ring of kRing planes, each the CTA's rows and columns with a halo of
// one cell, a row kPad floats either side of its kQuad * quads columns (so
// the first owned column is 16-byte aligned).
constexpr int kQuad = 4;
constexpr int kCtaThreads = 256;
constexpr int kRing = 3;
constexpr int kPad = 4;

// Bytes of B8's (and B5's) ring for a CTA of `quads` x `rows` threads (at most
// 48 KiB for the plans march_ok admits, so no opt-in is needed).
int ring_smem(int quads, int rows) {
  return kRing * (rows + 2) * (kQuad * quads + 2 * kPad) * (int)sizeof(float);
}

// What every B3/B5/B7/B8 plan must satisfy: 8, 16 or 32 quads a row of the CTA,
// kCtaThreads threads, a chunk of at least one plane, a grid CUDA takes.
bool march_ok(int quads, int rows, int chunk, int planes, int Y, int X) {
  return (quads == 8 || quads == 16 || quads == 32) && quads * rows == kCtaThreads &&
         chunk >= 1 && (Y + rows - 1) / rows <= 65535 && (planes + chunk - 1) / chunk <= 65535 &&
         X >= 1;
}

// The widest vector (elements of `esize` bytes, at most 4) that every row of
// n elements from `base` is aligned to.
int vec_elems(const void* base, int n, int esize) {
  int v = 4;
  while (v > 1 && (((uintptr_t)base % (v * esize)) != 0 || n % v != 0)) v /= 2;
  return v;
}

// kVec consecutive elements (kVec in 1, 2, 4) of T as f32, and back with one
// rounding each.
template <int kVec>
__device__ __forceinline__ void ld_vec(const float* p, float* v) {
  if constexpr (kVec == 4) {
    const float4 a = *(const float4*)p;
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else if constexpr (kVec == 2) {
    const float2 a = *(const float2*)p;
    v[0] = a.x; v[1] = a.y;
  } else {
    v[0] = *p;
  }
}
template <int kVec>
__device__ __forceinline__ void st_vec(float* p, const float* v) {
  if constexpr (kVec == 4) {
    *(float4*)p = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (kVec == 2) {
    *(float2*)p = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}
template <int kVec>
__device__ __forceinline__ void ld_vec(const __nv_bfloat16* p, float* v) {
  if constexpr (kVec == 4) {
    const uint2 a = *(const uint2*)p;
    v[0] = bf16_lo(a.x); v[1] = bf16_hi(a.x); v[2] = bf16_lo(a.y); v[3] = bf16_hi(a.y);
  } else if constexpr (kVec == 2) {
    const uint32_t a = *(const uint32_t*)p;
    v[0] = bf16_lo(a); v[1] = bf16_hi(a);
  } else {
    v[0] = __bfloat162float(*p);
  }
}
template <int kVec>
__device__ __forceinline__ void st_vec(__nv_bfloat16* p, const float* v) {
  if constexpr (kVec == 4) {
    *(uint2*)p = make_uint2(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]));
  } else if constexpr (kVec == 2) {
    *(uint32_t*)p = bf16_pair(v[0], v[1]);
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

// The quad's kQuad elements from p (its first x at p[0]), as vectors of
// kVec; only those below `valid` (X - x) are touched.
template <int kVec, typename T>
__device__ __forceinline__ void ld_quad(const T* p, int valid, float* v) {
#pragma unroll
  for (int j = 0; j < kQuad; j += kVec) {
    if (j < valid) ld_vec<kVec>(p + j, v + j);
  }
}
template <int kVec, typename T>
__device__ __forceinline__ void st_quad(T* p, int valid, const float* v) {
#pragma unroll
  for (int j = 0; j < kQuad; j += kVec) {
    if (j < valid) st_vec<kVec>(p + j, v + j);
  }
}

// B7: coarse plane j upsampled at the quad's four fine x of one fine row,
// as `upsample` forms it: the y dot on coarse columns col[0..3] (2k - 1 ..
// 2k + 2 for fine x 4k .. 4k + 3, clamped), then each fine x's x dot.  Fine
// 4k takes columns (0, 1) of the four, 4k + 1 and 4k + 2 (1, 2), 4k + 3
// (2, 3); where prolong_taps clamps a fine x to one coarse column (weight
// 1, then 0), both of its columns are that column, clamped, so the dot is
// upsample's to the bit.
__device__ __forceinline__ void upsample_quad(const float* __restrict__ row_lo,
                                              const float* __restrict__ row_hi,
                                              const int* col, const Taps& ty, const Taps* tx,
                                              float* u) {
  float a[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j] = ty.wlo * __ldg(row_lo + col[j]) + ty.whi * __ldg(row_hi + col[j]);
  }
  u[0] = tx[0].wlo * a[0] + tx[0].whi * a[1];
  u[1] = tx[1].wlo * a[1] + tx[1].whi * a[2];
  u[2] = tx[2].wlo * a[1] + tx[2].whi * a[2];
  u[3] = tx[3].wlo * a[2] + tx[3].whi * a[3];
}

// B7 as a z-march: thread (quad, row) of CTA (i, j, k) owns fine x [4 q,
// 4 q + 4) of fine row y and walks the coarse planes [k chunk, (k + 1)
// chunk) clipped to Zc.  It keeps the upsampled planes U(m - 1), U(m),
// U(m + 1) of its quad in registers (clamped to [0, Zc - 1]), one new plane
// a step, and writes fine planes 2m (0.25 U(m-1) + 0.75 U(m)) and 2m + 1
// (0.75 U(m) + 0.25 U(m+1)) as q + e, q read and out written as vectors
// of kVec.  32-bit offsets: Z * Y * X < 2^31 (the launch checks).
template <int kVec>
__global__ void __launch_bounds__(kCtaThreads)
    prolong_march_kernel(const float* __restrict__ q, const float* __restrict__ ec,
                         float* __restrict__ out, int Z, int Y, int X, int chunk) {
  const int x = (blockIdx.x * blockDim.x + threadIdx.x) * kQuad;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= X || y >= Y) return;
  const int Zc = Z >> 1, Yc = Y >> 1, Xc = X >> 1;
  const int m0 = blockIdx.z * chunk;
  const int m1 = min(m0 + chunk, Zc);
  const int valid = X - x;
  const Taps ty = prolong_taps(y, Yc);
  Taps tx[kQuad];
  int col[4];
#pragma unroll
  for (int j = 0; j < kQuad; ++j) {
    tx[j] = prolong_taps(x + j, Xc);
    col[j] = min(max((x >> 1) - 1 + j, 0), Xc - 1);
  }
  const int cplane = Yc * Xc;
  const float* lo = ec + ty.lo * Xc;
  const float* hi = ec + ty.hi * Xc;
  float um[kQuad], uc[kQuad], up[kQuad];
  upsample_quad(lo + max(m0 - 1, 0) * cplane, hi + max(m0 - 1, 0) * cplane, col, ty, tx, um);
  upsample_quad(lo + m0 * cplane, hi + m0 * cplane, col, ty, tx, uc);
  const int plane = Y * X;
  int off = 2 * m0 * plane + y * X + x;
  for (int m = m0; m < m1; ++m, off += 2 * plane) {
    float qe[kQuad], qo[kQuad];
    ld_quad<kVec>(q + off, valid, qe);
    ld_quad<kVec>(q + off + plane, valid, qo);
    const int mp = min(m + 1, Zc - 1);
    upsample_quad(lo + mp * cplane, hi + mp * cplane, col, ty, tx, up);
#pragma unroll
    for (int j = 0; j < kQuad; ++j) {
      qe[j] = qe[j] + (0.25f * um[j] + 0.75f * uc[j]);
      qo[j] = qo[j] + (0.75f * uc[j] + 0.25f * up[j]);
      um[j] = uc[j];
      uc[j] = up[j];
    }
    st_quad<kVec>(out + off, valid, qe);
    st_quad<kVec>(out + off + plane, valid, qo);
  }
}

// Copies kBytes (4, 8 or 16) from device to shared memory with cp.async.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  } else if constexpr (kBytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// B8 as a staged z-march: thread (quad, row) of CTA (i, j, k) owns x [4 q,
// 4 q + 4) of row y and walks planes [k chunk, (k + 1) chunk) clipped to Z.
// The CTA stages plane z of its rows y0 - 1 .. ye and columns x0 - 1 .. xe
// (ye, xe one past its last row and column in the volume) into ring slot
// z % kRing, each cell holding p at its coordinates clamped to the volume,
// so the edge-clamped neighbours are plain reads; plane z + 2 is in flight
// while plane z is computed.  gx and gy come from slot z, gz from slot
// z + 1 and p(z - 1) in registers (the centre of the step before; the
// first from device memory).  The x bands are formed once a thread, the y
// band once, the z band once a plane.  The velocity of channels 0..2 moves
// and p is staged as vectors of kVec elements; rows whose alignment allows
// less take narrower ones.  32-bit offsets within a channel (Z * Y * X <
// 2^31, the launch checks), the channels' bases in 64 bits (3 Z Y X may
// reach 2^31).
template <typename T, int kVec>
__global__ void __launch_bounds__(kCtaThreads)
    grad_damp_march_kernel(T* __restrict__ f, const float* __restrict__ p, float s, int Z, int Y,
                           int X, int chunk) {
  extern __shared__ __align__(16) float ring[];  // [slot][row - y0 + 1][kPad + col - x0]
  constexpr int kPer = kVec;  // floats a copy of p
  const int quads = blockDim.x, rows = blockDim.y;
  const int pitch = kQuad * quads + 2 * kPad;
  const int slot = (rows + 2) * pitch;
  const int x0 = blockIdx.x * quads * kQuad;
  const int y0 = blockIdx.y * rows;
  const int z0 = blockIdx.z * chunk;
  const int ze = min(z0 + chunk, Z);
  const int xe = min(x0 + kQuad * quads, X);
  const int ye = min(y0 + rows, Y);
  const int plane = Y * X;
  const int n = Z * plane;
  const int staged_rows = ye - y0 + 2;
  const int copies = (xe - x0) / kPer;  // X % kPer == 0: no copy crosses X
  T* const fc[3] = {f, f + (int64_t)n, f + 2 * (int64_t)n};

  // Plane zz (zz <= Z: plane Z is plane Z - 1 again) into slot zz % kRing.
  auto stage = [&](int zz) {
    float* dst = ring + (zz % kRing) * slot + kPad;
    const float* src = p + min(zz, Z - 1) * plane;
    for (int r = threadIdx.y; r < staged_rows; r += rows) {
      const float* srow = src + min(max(y0 - 1 + r, 0), Y - 1) * X;
      float* drow = dst + r * pitch;
      for (int k = threadIdx.x; k < copies; k += quads) {
        cp_async<4 * kPer>(drow + k * kPer, srow + x0 + k * kPer);
      }
      if (threadIdx.x == 0) cp_async<4>(drow - 1, srow + max(x0 - 1, 0));
      if (threadIdx.x == 1) cp_async<4>(drow + (xe - x0), srow + min(xe, X - 1));
    }
    cp_async_commit();
  };

  const int x = x0 + kQuad * threadIdx.x;
  const int y = y0 + threadIdx.y;
  const bool live = x < X && y < Y;
  const int valid = X - x;
  Band bx[kQuad];
#pragma unroll
  for (int j = 0; j < kQuad; ++j) bx[j] = band_at(x + j, X);
  const Band by = band_at(y, Y);
  const int c = (threadIdx.y + 1) * pitch + kPad + kQuad * threadIdx.x;  // (y, x) in a slot
  int off = z0 * plane + y * X + x;

  stage(z0);
  stage(z0 + 1);
  float pm[kQuad];
  if (live) ld_quad<kPer>(p + max(z0 - 1, 0) * plane + y * X + x, valid, pm);
  for (int z = z0; z < ze; ++z, off += plane) {
    float u[3][kQuad];
    if (live) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) ld_quad<kVec>(fc[ch] + off, valid, u[ch]);
    }
    cp_async_wait_all();
    __syncthreads();  // planes z and z + 1 landed; slot (z + 2) % kRing is free
    if (z + 2 <= ze) stage(z + 2);
    if (!live) continue;
    const Band bz = band_at(z, Z);
    const float* pc = ring + (z % kRing) * slot + c;
    const float* pp = ring + ((z + 1) % kRing) * slot + c;
#pragma unroll
    for (int j = 0; j < kQuad; ++j) {
      u[0][j] = damp(u[0][j], (pc[j + 1] - pc[j - 1]) * s, bx[j]);
      u[1][j] = damp(u[1][j], (pc[j + pitch] - pc[j - pitch]) * s, by);
      u[2][j] = damp(u[2][j], (pp[j] - pm[j]) * s, bz);
      pm[j] = pc[j];
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) st_quad<kVec>(fc[ch] + off, valid, u[ch]);
  }
}

// B5 as a staged z-march, on B8's plan and ring: thread (quad, row) of CTA
// (i, j, k) owns x [4 q, 4 q + 4) of row y and walks planes [k chunk, (k +
// 1) chunk) clipped to Z.  The CTA stages plane z of q, its rows and
// columns with a one-cell halo clamped to the volume, into ring slot z %
// kRing, plane z + 2 in flight while plane z is computed.  x+-
// and y+- come from slot z, z+ from slot z + 1, z- from q(z - 1) in
// registers (the centre of the step before; the first from device memory),
// the centre from the slot; b and r move as vectors of kVec.  The sum is
// the per-cell kernel's: ((((x+ + x-) + y+) + y-) + z-) + z+, then b - (s -
// 6 q).  32-bit offsets: Z * Y * X < 2^31 (the launch checks).
template <int kVec>
__global__ void __launch_bounds__(kCtaThreads)
    residual_march_kernel(const float* __restrict__ q, const float* __restrict__ b,
                          float* __restrict__ r, int Z, int Y, int X, int chunk) {
  extern __shared__ __align__(16) float ring[];  // [slot][row - y0 + 1][kPad + col - x0]
  const int quads = blockDim.x, rows = blockDim.y;
  const int pitch = kQuad * quads + 2 * kPad;
  const int slot = (rows + 2) * pitch;
  const int x0 = blockIdx.x * quads * kQuad;
  const int y0 = blockIdx.y * rows;
  const int z0 = blockIdx.z * chunk;
  const int ze = min(z0 + chunk, Z);
  const int xe = min(x0 + kQuad * quads, X);
  const int ye = min(y0 + rows, Y);
  const int plane = Y * X;
  const int staged_rows = ye - y0 + 2;
  const int copies = (xe - x0) / kVec;  // X % kVec == 0: no copy crosses X

  // Plane zz of q (zz <= Z: plane Z is plane Z - 1 again), rows y0 - 1 ..
  // ye and columns x0 - 1 .. xe clamped, into slot zz % kRing, as B8 stages
  // p.  Its own copy: one function shared with B8 slowed B8 by a tenth at
  // 150^3 (H100 80GB HBM3, 700 W).
  auto stage = [&](int zz) {
    float* dst = ring + (zz % kRing) * slot + kPad;
    const float* src = q + min(zz, Z - 1) * plane;
    for (int r = threadIdx.y; r < staged_rows; r += rows) {
      const float* srow = src + min(max(y0 - 1 + r, 0), Y - 1) * X;
      float* drow = dst + r * pitch;
      for (int k = threadIdx.x; k < copies; k += quads) {
        cp_async<4 * kVec>(drow + k * kVec, srow + x0 + k * kVec);
      }
      if (threadIdx.x == 0) cp_async<4>(drow - 1, srow + max(x0 - 1, 0));
      if (threadIdx.x == 1) cp_async<4>(drow + (xe - x0), srow + min(xe, X - 1));
    }
    cp_async_commit();
  };

  const int x = x0 + kQuad * threadIdx.x;
  const int y = y0 + threadIdx.y;
  const bool live = x < X && y < Y;
  const int valid = X - x;
  const int c = (threadIdx.y + 1) * pitch + kPad + kQuad * threadIdx.x;  // (y, x) in a slot
  int off = z0 * plane + y * X + x;

  stage(z0);
  stage(z0 + 1);
  float qm[kQuad];
  if (live) ld_quad<kVec>(q + max(z0 - 1, 0) * plane + y * X + x, valid, qm);
  for (int z = z0; z < ze; ++z, off += plane) {
    float bv[kQuad];
    if (live) ld_quad<kVec>(b + off, valid, bv);
    cp_async_wait_all();
    __syncthreads();  // planes z and z + 1 landed; slot (z + 2) % kRing is free
    if (z + 2 <= ze) stage(z + 2);
    if (!live) continue;
    const float* qc = ring + (z % kRing) * slot + c;
    const float* qp = ring + ((z + 1) % kRing) * slot + c;
    float rv[kQuad];
#pragma unroll
    for (int j = 0; j < kQuad; ++j) {
      float sum = qc[j + 1] + qc[j - 1];
      sum = sum + qc[j + pitch];
      sum = sum + qc[j - pitch];
      sum = sum + qm[j];
      sum = sum + qp[j];
      rv[j] = bv[j] - (sum - 6.0f * qc[j]);
      qm[j] = qc[j];
    }
    st_quad<kVec>(r + off, valid, rv);
  }
}

// Bytes of B3's uy ring for a CTA of `quads` x `rows` threads: kRing
// planes of its rows and a halo row either side, kQuad * quads columns of
// `esize` bytes (at most 15 KiB).
int uy_smem(int quads, int rows, int esize) {
  return kRing * (rows + 2) * kQuad * quads * esize;
}

__device__ __forceinline__ void cp_async_wait_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// kVec elements of T from device to shared memory: cp.async where they are
// 4 bytes or more, else a plain copy (one bf16), seen after the barrier.
template <int kVec, typename T>
__device__ __forceinline__ void stage_vec(T* dst, const T* src) {
  if constexpr (kVec * sizeof(T) >= 4) {
    cp_async<(int)(kVec * sizeof(T))>(dst, src);
  } else {
    *dst = *src;
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// A quad's kQuad elements of T as loaded, cast to f32 only where read, so
// that a load issued a plane ahead is waited for only then.  Elements at or
// past `valid` (X - x) are not loaded and read as 0.
template <typename T, int kVec>
struct RawQuad {
  float v[kQuad];
  __device__ __forceinline__ void load(const float* p, int valid) {
#pragma unroll
    for (int j = 0; j < kQuad; ++j) v[j] = 0.0f;
    ld_quad<kVec>(p, valid, v);
  }
  __device__ __forceinline__ float operator[](int j) const { return v[j]; }
};
template <int kVec>
struct RawQuad<__nv_bfloat16, kVec> {
  uint32_t w[kQuad / 2];  // elements 2 i (low half) and 2 i + 1 (high half)
  __device__ __forceinline__ void load(const __nv_bfloat16* p, int valid) {
    w[0] = w[1] = 0u;
    if constexpr (kVec == 4) {
      const uint2 a = *(const uint2*)p;
      w[0] = a.x;
      w[1] = a.y;
    } else if constexpr (kVec == 2) {
      w[0] = *(const uint32_t*)p;
      if (valid > 2) w[1] = *(const uint32_t*)(p + 2);
    } else {
      const unsigned short* h = (const unsigned short*)p;
#pragma unroll
      for (int j = 0; j < kQuad; ++j) {
        if (j < valid) w[j >> 1] |= (uint32_t)h[j] << (16 * (j & 1));
      }
    }
  }
  __device__ __forceinline__ float operator[](int j) const {
    return (j & 1) ? bf16_hi(w[j >> 1]) : bf16_lo(w[j >> 1]);
  }
};

// B3 as a z-march, laid out by stencil_plan as B8: thread (quad, row) of
// CTA (i, j, k) owns x [4 q, 4 q + 4) of row y and walks planes [k chunk,
// (k + 1) chunk) clipped to Z.  Each channel needs its neighbours along one
// axis only:
//   - uz(z - 1), uz(z) of the quad stay in registers and uz(z + 1) is read,
//     one plane a step (clamped);
//   - ux is read as the quad's vector; x - 1 of its first element and x + 1
//     of its last come from the adjacent lanes of the CTA row
//     (__shfl_up/down_sync within segments of `quads` lanes), and from
//     device memory only at the row's two ends (x0 - 1, x0 + 4 quads);
//     clamped at the volume's edges;
//   - uy, needed at rows y +- 1 only, is staged a plane at a time: rows y0 -
//     1 .. ye of the CTA's columns (clamped rows) into ring slot z % kRing.
// Two planes are in flight while plane z is computed: plane z + 1's ux, uz
// and row ends in registers (RawQuad, cast when read), planes z + 1 and z +
// 2 of uy in the ring.  Channels 0..2 of the (C, Z, Y, X) state are read,
// cast to f32, as vectors of kVec; channels 3.. never.  out is written as
// vectors of kVec.  32-bit offsets within a channel (Z * Y * X < 2^31, the
// launch checks), the channels' bases in 64 bits (2 Z Y X may reach 2^31).
template <typename T, int kVec>
__global__ void __launch_bounds__(kCtaThreads, 4)
    divergence_march_kernel(const T* __restrict__ f, float* __restrict__ out, int Z, int Y,
                            int X, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* const ring = (T*)smem;  // [slot][row - y0 + 1][col - x0]
  const int quads = blockDim.x, rows = blockDim.y;
  const int pitch = kQuad * quads;
  const int slot = (rows + 2) * pitch;
  const int x0 = blockIdx.x * quads * kQuad;
  const int y0 = blockIdx.y * rows;
  const int z0 = blockIdx.z * chunk;
  const int ze = min(z0 + chunk, Z);
  const int xe = min(x0 + kQuad * quads, X);
  const int ye = min(y0 + rows, Y);
  const int plane = Y * X;
  const int n = Z * plane;
  const T* const ux = f;
  const T* const uy = f + (int64_t)n;
  const T* const uz = f + 2 * (int64_t)n;
  const int staged_rows = ye - y0 + 2;
  const int copies = (xe - x0) / kVec;  // X % kVec == 0: no copy crosses X

  // uy's plane zz, rows y0 - 1 .. ye clamped, into ring slot `into`; then
  // one commit, staged or not, so that each plane is one cp.async group.
  auto stage = [&](int zz, int into) {
    if (zz < ze) {
      T* dst = ring + into * slot;
      const T* src = uy + zz * plane + x0;
      for (int r = threadIdx.y; r < staged_rows; r += rows) {
        const T* srow = src + min(max(y0 - 1 + r, 0), Y - 1) * X;
        T* drow = dst + r * pitch;
        for (int k = threadIdx.x; k < copies; k += quads) {
          stage_vec<kVec>(drow + k * kVec, srow + k * kVec);
        }
      }
    }
    cp_async_commit();
  };

  const int x = x0 + kQuad * threadIdx.x;
  const int y = y0 + threadIdx.y;
  const bool live = x < X && y < Y;
  const int valid = X - x;
  const bool first = threadIdx.x == 0, last = threadIdx.x == quads - 1;
  const bool load_l = live && first && x > 0;           // ux(x - 1) from device memory
  const bool load_r = live && last && x + kQuad < X;    // ux(x + 4) from device memory
  const T* const ym = ring + threadIdx.y * pitch + kQuad * threadIdx.x;  // row y - 1, slot 0

  // A plane's ux, uz(z + 1) and ux row ends, loaded a plane ahead into one
  // of two register sets (a for planes z0, z0 + 2, ..., b for the others:
  // the march is unrolled by two, so no copy waits for a load).
  struct Ahead {
    RawQuad<T, kVec> ux, uz;
    T l, r;
  };
  auto load = [&](Ahead& h, int o, int zz) {
    h.ux.load(ux + o, valid);
    h.uz.load(uz + (zz < Z - 1 ? o + plane : o), valid);
    if (load_l) h.l = ux[o - 1];
    if (load_r) h.r = ux[o + kQuad];
  };
  float um[kQuad] = {}, uc[kQuad] = {};  // uz(z - 1), uz(z)
  int s = 0;                             // ring slot of plane z
  // Plane z at offset o from `cur`, loading plane z + 1 into `next`.
  auto step = [&](int z, int o, const Ahead& cur, Ahead& next) {
    if (live && z + 1 < ze) load(next, o + plane, z + 1);
    cp_async_wait_but_one();
    __syncthreads();  // uy's plane z landed; slot (z + 2) % kRing is free
    stage(z + 2, s == 0 ? kRing - 1 : s - 1);
    const float from_left = __shfl_up_sync(0xffffffffu, cur.ux[kQuad - 1], 1, quads);
    const float from_right = __shfl_down_sync(0xffffffffu, cur.ux[0], 1, quads);
    if (live) {
      const float xl = first ? to_f32(cur.l) : from_left;   // ux(x - 1), where x > 0
      const float xr = last ? to_f32(cur.r) : from_right;   // ux(x + 4), where x + 4 < X
      float ym_v[kQuad], yp_v[kQuad], d[kQuad];
      ld_quad<kVec>(ym + s * slot, valid, ym_v);
      ld_quad<kVec>(ym + s * slot + 2 * pitch, valid, yp_v);
#pragma unroll
      for (int j = 0; j < kQuad; ++j) {
        const float xp = x + j + 1 < X ? (j + 1 < kQuad ? cur.ux[j + 1] : xr) : cur.ux[j];
        const float xm = x + j > 0 ? (j > 0 ? cur.ux[j - 1] : xl) : cur.ux[j];
        const float dx = xp - xm;
        const float dy = yp_v[j] - ym_v[j];
        const float up = cur.uz[j];
        const float dz = up - um[j];
        d[j] = 0.5f * ((dx + dy) + dz);
        um[j] = uc[j];
        uc[j] = up;
      }
      st_quad<kVec>(out + o, valid, d);
    }
    s = s == kRing - 1 ? 0 : s + 1;
  };

  int off = z0 * plane + y * X + x;
  Ahead a{}, b{};
  stage(z0, 0);
  stage(z0 + 1, 1);
  if (live) {
    ld_quad<kVec>(uz + (off - (z0 > 0 ? plane : 0)), valid, um);
    ld_quad<kVec>(uz + off, valid, uc);
    load(a, off, z0);
  }
  for (int z = z0; z < ze; z += 2, off += 2 * plane) {
    step(z, off, a, b);
    if (z + 1 < ze) step(z + 1, off + plane, b, a);
  }
}

// B15: (gx, gy, gz) of an f32 (Z, Y, X) field as jnp.gradient computes it
// (stencil.py:138-159): the clamped central difference times 0.5 inside,
// the full one-sided difference at each boundary cell; out (3, Z, Y, X)
// f32, channel-leading.  Bound: memory, 4 B in and 12 B out per cell (the
// AO's (30, 128, 128) half field of the 256x256x60 GI frame: 7.9 MB, 2.3 us
// at 3.35 TB/s; q is 2 MB and stays in L2, the 5.9 MB of output is what
// costs).  gradient_march_kernel is a z-march on stencil_plan's layout, as
// B3: a thread owns a quad of 4 x of one row and walks its chunk of planes
// with q(z - 1), q(z) of the quad in registers and q(z + 1) read as one
// vector a step; x +- 1 come from the adjacent lanes of the CTA row
// (__shfl_up/down_sync in segments of `quads` lanes) and from device
// memory only at the row's two ends; rows y +- 1 of plane z are two more
// vector loads (clamped).  No shared memory and no barrier: at (30, 128,
// 128) the plan gives one plane a CTA (480 CTAs), where a ring would have
// nothing to reuse.  The three outputs move as float4 (float2 or float
// where a row is not 16-byte aligned).  32-bit offsets within a channel
// (Z * Y * X < 2^31, the launch checks), the channels' bases in 64 bits
// (channel 2 starts at 2 Z Y X, past 2^31 at 2^30 cells).  The design it
// replaced, one thread a cell (cell_at's 64-bit divisions, six scalar
// neighbour loads that re-read every cell from L1/L2, three scalar
// stores), stays as the yardstick fx_gradient3_perthread.
template <int kVec>
__global__ void __launch_bounds__(kCtaThreads)
    gradient_march_kernel(const float* __restrict__ q, float* __restrict__ out, int Z, int Y,
                          int X, int chunk) {
  const int quads = blockDim.x;
  const int x = (blockIdx.x * quads + threadIdx.x) * kQuad;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int z0 = blockIdx.z * chunk;
  const int ze = min(z0 + chunk, Z);
  const int plane = Y * X;
  const int n = Z * plane;
  float* const g[3] = {out, out + (int64_t)n, out + 2 * (int64_t)n};
  const bool live = x < X && y < Y;
  const int valid = X - x;
  const bool first = threadIdx.x == 0, last = threadIdx.x == quads - 1;
  const bool load_l = live && first && x > 0;         // q(x - 1) from device memory
  const bool load_r = live && last && x + kQuad < X;  // q(x + 4) from device memory
  float sx[kQuad];
#pragma unroll
  for (int j = 0; j < kQuad; ++j) sx[j] = (x + j == 0 || x + j == X - 1) ? 1.0f : 0.5f;
  const float sy = (y == 0 || y == Y - 1) ? 1.0f : 0.5f;
  const int row = y * X + x;
  const int dm = y > 0 ? -X : 0, dp = y < Y - 1 ? X : 0;  // rows y -+ 1, clamped
  float qm[kQuad] = {}, qc[kQuad] = {};                   // q(z - 1), q(z)
  if (live) {
    ld_quad<kVec>(q + max(z0 - 1, 0) * plane + row, valid, qm);
    ld_quad<kVec>(q + z0 * plane + row, valid, qc);
  }
  for (int z = z0; z < ze; ++z) {
    const int o = z * plane + row;
    float qp[kQuad] = {}, ym[kQuad] = {}, yp[kQuad] = {};
    float l = 0.0f, r = 0.0f;
    if (live) {
      ld_quad<kVec>(q + (z < Z - 1 ? o + plane : o), valid, qp);
      ld_quad<kVec>(q + o + dm, valid, ym);
      ld_quad<kVec>(q + o + dp, valid, yp);
      if (load_l) l = q[o - 1];
      if (load_r) r = q[o + kQuad];
    }
    const float from_left = __shfl_up_sync(0xffffffffu, qc[kQuad - 1], 1, quads);
    const float from_right = __shfl_down_sync(0xffffffffu, qc[0], 1, quads);
    if (live) {
      const float xl = first ? l : from_left;   // q(x - 1), where x > 0
      const float xr = last ? r : from_right;   // q(x + 4), where x + 4 < X
      const float sz = (z == 0 || z == Z - 1) ? 1.0f : 0.5f;
      float gx[kQuad], gy[kQuad], gz[kQuad];
#pragma unroll
      for (int j = 0; j < kQuad; ++j) {
        const float xp = x + j + 1 < X ? (j + 1 < kQuad ? qc[j + 1] : xr) : qc[j];
        const float xm = x + j > 0 ? (j > 0 ? qc[j - 1] : xl) : qc[j];
        gx[j] = (xp - xm) * sx[j];
        gy[j] = (yp[j] - ym[j]) * sy;
        gz[j] = (qp[j] - qm[j]) * sz;
      }
      // Rolled only now: gx of element j + 1 reads q(z) of element j.
#pragma unroll
      for (int j = 0; j < kQuad; ++j) {
        qm[j] = qc[j];
        qc[j] = qp[j];
      }
      st_quad<kVec>(g[0] + o, valid, gx);
      st_quad<kVec>(g[1] + o, valid, gy);
      st_quad<kVec>(g[2] + o, valid, gz);
    }
  }
}

// B15 as it ran before, one thread a cell.  A yardstick only
// (fx_gradient3_perthread).
__global__ void gradient3_kernel(const float* __restrict__ q, float* __restrict__ out, int nz,
                                 int ny, int nx) {
  const int64_t n = (int64_t)nz * ny * nx;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const Cell k = cell_at(idx, nz, ny, nx);
  const float sx = (k.x == 0 || k.x == nx - 1) ? 1.0f : 0.5f;
  const float sy = (k.y == 0 || k.y == ny - 1) ? 1.0f : 0.5f;
  const float sz = (k.z == 0 || k.z == nz - 1) ? 1.0f : 0.5f;
  out[idx] = (q[k.xp] - q[k.xm]) * sx;
  out[n + idx] = (q[k.yp] - q[k.ym]) * sy;
  out[2 * n + idx] = (q[k.zp] - q[k.zm]) * sz;
}

// B16: the fused GI light map (stencil.py:162-231), one thread per voxel:
//   g    = jnp.gradient(density): clamped central difference times 0.5
//          inside, the full one-sided difference at each boundary;
//   n    = -g, or the voxel centre ((i + 0.5) / n * 2 - 1 per axis) where
//          |n|^2 < 1e-16;
//   w    = n @ W (row vector, W the world's 3x3), then w * rsqrt(max(|w|^2,
//          1e-24)), the rsqrt as 1 / sqrtf: correctly rounded, where
//          CUDA's rsqrtf is approximate;
//   (x, y, z) = (-w.x, -w.y, w.z); the order-2 SH irradiance in the Pallas
//          kernel's term order;
//   out[c] = env[c] * shadow + (density >= zero_thr ? max(irr_c, 0) * ao : 0).
// consts holds the (9, 3) SH coefficients, W and env, row-major, 39 f32
// values that every thread reads (a broadcast from L1); they stay on the
// card, so the frame needs no copy to the host.
//
// Bound: memory.  At 256^3 it reads density, shadow and ao (f32) and writes
// the (3, Z, Y, X) f32 light map: 24 B per voxel, 402.7 MB, 120.2 us at
// 3.35 TB/s, for ~90 operations per voxel (1.5 GFLOP, 22 us at 67 TFLOP/s).
// Design: one thread per voxel, consecutive threads on consecutive x; the
// neighbour re-reads of the density hit L1/L2.
constexpr float kC1 = 0.42904276540489171563379376569857f;
constexpr float kC3 = 0.24770795610037568833406429782001f;
constexpr float kC4 = 0.88622692545275801364908374167057f;
constexpr float kC1x2 = (float)(2.0 * 0.42904276540489171563379376569857);
constexpr float kC2x2 = (float)(2.0 * 0.51166335397324424423977581244463);

__device__ __forceinline__ float centre(int i, int n) {
  return ((float)i + 0.5f) / (float)n * 2.0f - 1.0f;
}

__global__ void gi_light_kernel(const float* __restrict__ density,
                                const float* __restrict__ shadow,
                                const float* __restrict__ ao,
                                const float* __restrict__ consts, float* __restrict__ out,
                                float zero_thr, int nz, int ny, int nx) {
  const int64_t n = (int64_t)nz * ny * nx;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const Cell k = cell_at(idx, nz, ny, nx);
  const float sx = (k.x == 0 || k.x == nx - 1) ? 1.0f : 0.5f;
  const float sy = (k.y == 0 || k.y == ny - 1) ? 1.0f : 0.5f;
  const float sz = (k.z == 0 || k.z == nz - 1) ? 1.0f : 0.5f;
  float n1 = -((density[k.xp] - density[k.xm]) * sx);
  float n2 = -((density[k.yp] - density[k.ym]) * sy);
  float n3 = -((density[k.zp] - density[k.zm]) * sz);
  if (n1 * n1 + n2 * n2 + n3 * n3 < 1e-16f) {
    n1 = centre(k.x, nx);
    n2 = centre(k.y, ny);
    n3 = centre(k.z, nz);
  }
  const float* w = consts + 27;
  const float wx = n1 * w[0] + n2 * w[3] + n3 * w[6];
  const float wy = n1 * w[1] + n2 * w[4] + n3 * w[7];
  const float wz = n1 * w[2] + n2 * w[5] + n3 * w[8];
  const float inv = 1.0f / sqrtf(fmaxf(wx * wx + wy * wy + wz * wz, 1e-24f));
  const float x = -wx * inv;
  const float y = -wy * inv;
  const float z = wz * inv;
  const float b8 = kC1 * (x * x - y * y);
  const float b6 = kC3 * (3.0f * z * z - 1.0f);
  const float bxy = kC1x2 * (x * y);
  const float bxz = kC1x2 * (x * z);
  const float byz = kC1x2 * (y * z);
  const bool dense = density[idx] >= zero_thr;
  const float ao_v = ao[idx];
  const float sh_v = shadow[idx];
  for (int ch = 0; ch < 3; ++ch) {
    const float* c = consts + ch;  // coefficient l of channel ch is c[3 * l]
    const float irr = b8 * c[24] + b6 * c[18] + kC4 * c[0] + bxy * c[12] + bxz * c[21] +
                      byz * c[15] + kC2x2 * (x * c[9] + y * c[3] + z * c[6]);
    const float ambient = dense ? fmaxf(irr, 0.0f) * ao_v : 0.0f;
    out[ch * n + idx] = consts[36 + ch] * sh_v + ambient;
  }
}

template <int kVec>
cudaError_t launch_prolong(const float* q, const float* ec, float* out, int nz, int ny, int nx,
                           int quads, int rows, int chunk, cudaStream_t cs) {
  const dim3 grid((nx + kQuad * quads - 1) / (kQuad * quads), (ny + rows - 1) / rows,
                  (nz / 2 + chunk - 1) / chunk);
  prolong_march_kernel<kVec><<<grid, dim3(quads, rows), 0, cs>>>(q, ec, out, nz, ny, nx, chunk);
  return cudaGetLastError();
}

// B8's launch with the widest vectors that both the velocity's rows and
// the pressure's allow: kVec elements of each a velocity access, kVec
// floats a copy of p.
template <typename T, int kVec>
cudaError_t launch_grad_march(void* fields, const float* p, float s, int nz, int ny, int nx,
                              int quads, int rows, int chunk, cudaStream_t cs) {
  const dim3 grid((nx + kQuad * quads - 1) / (kQuad * quads), (ny + rows - 1) / rows,
                  (nz + chunk - 1) / chunk);
  grad_damp_march_kernel<T, kVec><<<grid, dim3(quads, rows), ring_smem(quads, rows), cs>>>(
      (T*)fields, p, s, nz, ny, nx, chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_grad(void* fields, const float* p, float s, int nz, int ny, int nx,
                        int quads, int rows, int chunk, cudaStream_t cs) {
  switch (min(vec_elems(fields, nx, (int)sizeof(T)), vec_elems(p, nx, 4))) {
    case 4: return launch_grad_march<T, 4>(fields, p, s, nz, ny, nx, quads, rows, chunk, cs);
    case 2: return launch_grad_march<T, 2>(fields, p, s, nz, ny, nx, quads, rows, chunk, cs);
    default: return launch_grad_march<T, 1>(fields, p, s, nz, ny, nx, quads, rows, chunk, cs);
  }
}

// B5's launch with the widest vectors that q's, b's and r's rows allow.
template <int kVec>
cudaError_t launch_residual_march(const float* q, const float* b, float* r, int nz, int ny,
                                  int nx, int quads, int rows, int chunk, cudaStream_t cs) {
  const dim3 grid((nx + kQuad * quads - 1) / (kQuad * quads), (ny + rows - 1) / rows,
                  (nz + chunk - 1) / chunk);
  residual_march_kernel<kVec><<<grid, dim3(quads, rows), ring_smem(quads, rows), cs>>>(
      q, b, r, nz, ny, nx, chunk);
  return cudaGetLastError();
}

// B15's launch, kVec floats a vector of q and of each output channel.
template <int kVec>
cudaError_t launch_gradient(const float* q, float* out, int nz, int ny, int nx, int quads,
                            int rows, int chunk, cudaStream_t cs) {
  const dim3 grid((nx + kQuad * quads - 1) / (kQuad * quads), (ny + rows - 1) / rows,
                  (nz + chunk - 1) / chunk);
  gradient_march_kernel<kVec><<<grid, dim3(quads, rows), 0, cs>>>(q, out, nz, ny, nx, chunk);
  return cudaGetLastError();
}

// B3's launch with the widest vectors that both the state's rows and out's
// allow.
template <typename T, int kVec>
cudaError_t launch_div_march(const void* fields, float* out, int nz, int ny, int nx, int quads,
                             int rows, int chunk, cudaStream_t cs) {
  const dim3 grid((nx + kQuad * quads - 1) / (kQuad * quads), (ny + rows - 1) / rows,
                  (nz + chunk - 1) / chunk);
  divergence_march_kernel<T, kVec>
      <<<grid, dim3(quads, rows), uy_smem(quads, rows, (int)sizeof(T)), cs>>>(
          (const T*)fields, out, nz, ny, nx, chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_div(const void* fields, float* out, int nz, int ny, int nx, int quads,
                       int rows, int chunk, cudaStream_t cs) {
  switch (min(vec_elems(fields, nx, (int)sizeof(T)), vec_elems(out, nx, 4))) {
    case 4: return launch_div_march<T, 4>(fields, out, nz, ny, nx, quads, rows, chunk, cs);
    case 2: return launch_div_march<T, 2>(fields, out, nz, ny, nx, quads, rows, chunk, cs);
    default: return launch_div_march<T, 1>(fields, out, nz, ny, nx, quads, rows, chunk, cs);
  }
}

}  // namespace

extern "C" {

// B3: fields (C >= 3, nz, ny, nx) bf16 (is_bf16) or f32, channels 0..2
// read; out (nz, ny, nx) f32.  The plan (ops/cuda/stencil.stencil_plan):
// CTAs of `quads` x `rows` threads, each walking `chunk` planes, with
// uy_smem's bytes of uy buffer.
int fx_divergence(const void* fields, void* out, int is_bf16, int nz, int ny, int nx, int quads,
                  int rows, int chunk, void* stream) {
  if (nz < 1 || ny < 1 || (int64_t)nz * ny * nx >= (1LL << 31) ||
      !march_ok(quads, rows, chunk, nz, ny, nx)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t cs = (cudaStream_t)stream;
  float* of = (float*)out;
  return (int)(is_bf16
                   ? launch_div<__nv_bfloat16>(fields, of, nz, ny, nx, quads, rows, chunk, cs)
                   : launch_div<float>(fields, of, nz, ny, nx, quads, rows, chunk, cs));
}

// B3 as it ran before, one thread a cell.  A yardstick only.
int fx_divergence_perthread(const void* fields, void* out, int is_bf16, int nz, int ny, int nx,
                            void* stream) {
  cudaStream_t cs = (cudaStream_t)stream;
  const unsigned blocks = blocks_for((int64_t)nz * ny * nx);
  if (is_bf16) {
    divergence_kernel<<<blocks, kThreads, 0, cs>>>((const __nv_bfloat16*)fields,
                                                   (float*)out, nz, ny, nx);
  } else {
    divergence_kernel<<<blocks, kThreads, 0, cs>>>((const float*)fields, (float*)out,
                                                   nz, ny, nx);
  }
  return (int)cudaGetLastError();
}

// B5: r = b - A q; q, b, r (nz, ny, nx) f32.  The plan
// (ops/cuda/stencil.stencil_plan): CTAs of `quads` x `rows` threads, each
// walking `chunk` planes, with ring_smem's bytes of ring.
int fx_residual(const void* q, const void* b, void* r, int nz, int ny, int nx, int quads,
                int rows, int chunk, void* stream) {
  if (nz < 1 || ny < 1 || (int64_t)nz * ny * nx >= (1LL << 31) ||
      !march_ok(quads, rows, chunk, nz, ny, nx)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t cs = (cudaStream_t)stream;
  const float* qf = (const float*)q;
  const float* bf = (const float*)b;
  float* rf = (float*)r;
  switch (min(min(vec_elems(q, nx, 4), vec_elems(b, nx, 4)), vec_elems(r, nx, 4))) {
    case 4: return (int)launch_residual_march<4>(qf, bf, rf, nz, ny, nx, quads, rows, chunk, cs);
    case 2: return (int)launch_residual_march<2>(qf, bf, rf, nz, ny, nx, quads, rows, chunk, cs);
    default: return (int)launch_residual_march<1>(qf, bf, rf, nz, ny, nx, quads, rows, chunk, cs);
  }
}

// B5 as it ran before, one thread a cell.  A yardstick only.
int fx_residual_perthread(const void* q, const void* b, void* r, int nz, int ny, int nx,
                          void* stream) {
  residual_kernel<<<blocks_for((int64_t)nz * ny * nx), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)b, (float*)r, nz, ny, nx);
  return (int)cudaGetLastError();
}

// B7: out = q + prolong(e_c); q, out (nz, ny, nx) f32 with even dims, e_c
// (nz/2, ny/2, nx/2) f32.  The plan (ops/cuda/stencil.stencil_plan): CTAs
// of `quads` x `rows` threads, each walking `chunk` coarse planes.
int fx_prolong_correct(const void* q, const void* e_c, void* out, int nz, int ny, int nx,
                       int quads, int rows, int chunk, void* stream) {
  if (nz < 2 || ny < 2 || nx < 2 || ((nz | ny | nx) & 1) ||
      (int64_t)nz * ny * nx >= (1LL << 31) || !march_ok(quads, rows, chunk, nz / 2, ny, nx)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t cs = (cudaStream_t)stream;
  const float* qf = (const float*)q;
  const float* ef = (const float*)e_c;
  float* of = (float*)out;
  switch (min(vec_elems(q, nx, 4), vec_elems(out, nx, 4))) {
    case 4: return (int)launch_prolong<4>(qf, ef, of, nz, ny, nx, quads, rows, chunk, cs);
    case 2: return (int)launch_prolong<2>(qf, ef, of, nz, ny, nx, quads, rows, chunk, cs);
    default: return (int)launch_prolong<1>(qf, ef, of, nz, ny, nx, quads, rows, chunk, cs);
  }
}

// B7 as it ran before, one thread a fine cell.  A yardstick only.
int fx_prolong_correct_perthread(const void* q, const void* e_c, void* out, int nz, int ny,
                                 int nx, void* stream) {
  prolong_correct_kernel<<<blocks_for((int64_t)nz * ny * nx), kThreads, 0,
                           (cudaStream_t)stream>>>((const float*)q, (const float*)e_c,
                                                   (float*)out, nz, ny, nx);
  return (int)cudaGetLastError();
}

// B8: fields (C >= 3, nz, ny, nx) bf16 (is_bf16) or f32, updated in place on
// channels 0..2; p (nz, ny, nx) f32; s = fl32(0.5 / rho).  The plan
// (ops/cuda/stencil.stencil_plan): CTAs of `quads` x `rows` threads, each
// walking `chunk` planes, with ring_smem's bytes of ring.
int fx_grad_damp(void* fields, const void* p, float s, int is_bf16, int nz, int ny, int nx,
                 int quads, int rows, int chunk, void* stream) {
  if (nz < 1 || ny < 1 || (int64_t)nz * ny * nx >= (1LL << 31) ||
      !march_ok(quads, rows, chunk, nz, ny, nx)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t cs = (cudaStream_t)stream;
  const float* pf = (const float*)p;
  return (int)(is_bf16 ? launch_grad<__nv_bfloat16>(fields, pf, s, nz, ny, nx, quads, rows,
                                                    chunk, cs)
                       : launch_grad<float>(fields, pf, s, nz, ny, nx, quads, rows, chunk,
                                            cs));
}

// B8 as it ran before, one thread a cell (launch_grad_damp, which B18's
// per-sweep yardstick also runs).  A yardstick only.
int fx_grad_damp_perthread(void* fields, const void* p, float s, int is_bf16, int nz, int ny,
                           int nx, void* stream) {
  return (int)launch_grad_damp(fields, (const float*)p, s, is_bf16, nz, ny, nx,
                               (cudaStream_t)stream);
}

// B15: q (nz, ny, nx) f32, every dim at least 2; out (3, nz, ny, nx) f32 =
// (gx, gy, gz).  The plan (ops/cuda/stencil.stencil_plan): CTAs of
// `quads` x `rows` threads, each walking `chunk` planes.
int fx_gradient3(const void* q, void* out, int nz, int ny, int nx, int quads, int rows,
                 int chunk, void* stream) {
  if (nz < 2 || ny < 2 || nx < 2 || (int64_t)nz * ny * nx >= (1LL << 31) ||
      !march_ok(quads, rows, chunk, nz, ny, nx)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t cs = (cudaStream_t)stream;
  const float* qf = (const float*)q;
  float* of = (float*)out;
  switch (min(vec_elems(q, nx, 4), vec_elems(out, nx, 4))) {
    case 4: return (int)launch_gradient<4>(qf, of, nz, ny, nx, quads, rows, chunk, cs);
    case 2: return (int)launch_gradient<2>(qf, of, nz, ny, nx, quads, rows, chunk, cs);
    default: return (int)launch_gradient<1>(qf, of, nz, ny, nx, quads, rows, chunk, cs);
  }
}

// B15 as it ran before, one thread a cell.  A yardstick only.
int fx_gradient3_perthread(const void* q, void* out, int nz, int ny, int nx, void* stream) {
  gradient3_kernel<<<blocks_for((int64_t)nz * ny * nx), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)q, (float*)out, nz, ny, nx);
  return (int)cudaGetLastError();
}

// density, shadow, ao (nz, ny, nx) f32; consts (39,) f32 as above; out
// (3, nz, ny, nx) f32.
int fx_gi_light(const void* density, const void* shadow, const void* ao, const void* consts,
                void* out, float zero_thr, int nz, int ny, int nx, void* stream) {
  gi_light_kernel<<<blocks_for((int64_t)nz * ny * nx), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)density, (const float*)shadow, (const float*)ao, (const float*)consts,
      (float*)out, zero_thr, nz, ny, nx);
  return (int)cudaGetLastError();
}

}  // extern "C"
