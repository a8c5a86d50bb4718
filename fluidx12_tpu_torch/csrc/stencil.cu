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
// B3's and B8's device code lives in stencil.cuh, which B18 (jacobi.cu)
// shares.  Every edge is clamped.  Built with --fmad=false, so every
// product and sum rounds as in the Pallas code and the plain PyTorch
// versions.
//
// Bound: memory (a few operations per byte).  At 128^3: B3 reads 3 bf16
// channels and writes f32 (10 B per cell, 21.0 MB, 6.3 us at 3.35 TB/s); B5
// reads q and b and writes r (12 B, 25.2 MB, 7.5 us); B7 reads q and the
// coarse e_c and writes f32 (8.5 B, 17.8 MB, 5.3 us); B8 reads p and 3 bf16
// channels and writes them back (16 B, 33.6 MB, 10.0 us).  Design: one
// thread per cell, consecutive threads on consecutive x, so the centre
// stream and the x/y/z neighbours are coalesced; the neighbour re-reads
// (y +-1 rows, z +-1 planes) hit L1/L2, not HBM.  No shared-memory tiling
// yet: a simple kernel that is right first.

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

// B15: (gx, gy, gz) of an f32 (Z, Y, X) field as jnp.gradient computes it
// (stencil.py:138-159): the clamped central difference times 0.5 inside,
// the full one-sided difference at each boundary cell; out (3, Z, Y, X)
// f32, channel-leading.  Bound: memory, 4 B in and 12 B out per cell (the
// AO's (30, 128, 128) half field of the 256x256x60 GI frame: 7.9 MB, 2.3 us
// at 3.35 TB/s).  Design: one thread per cell, consecutive threads on
// consecutive x; the neighbour re-reads hit L1/L2.
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

}  // namespace

extern "C" {

// fields (C >= 3, nz, ny, nx) bf16 (is_bf16) or f32; out (nz, ny, nx) f32.
int fx_divergence(const void* fields, void* out, int is_bf16, int nz, int ny, int nx,
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

// q, b, r (nz, ny, nx) f32.
int fx_residual(const void* q, const void* b, void* r, int nz, int ny, int nx, void* stream) {
  residual_kernel<<<blocks_for((int64_t)nz * ny * nx), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)b, (float*)r, nz, ny, nx);
  return (int)cudaGetLastError();
}

// q, out (nz, ny, nx) f32 with even dims; e_c (nz/2, ny/2, nx/2) f32.
int fx_prolong_correct(const void* q, const void* e_c, void* out, int nz, int ny, int nx,
                       void* stream) {
  prolong_correct_kernel<<<blocks_for((int64_t)nz * ny * nx), kThreads, 0,
                           (cudaStream_t)stream>>>((const float*)q, (const float*)e_c,
                                                   (float*)out, nz, ny, nx);
  return (int)cudaGetLastError();
}

// fields (C >= 3, nz, ny, nx) bf16 (is_bf16) or f32, updated in place on
// channels 0..2; p (nz, ny, nx) f32; s = fl32(0.5 / rho).
int fx_grad_damp(void* fields, const void* p, float s, int is_bf16, int nz, int ny, int nx,
                 void* stream) {
  return (int)launch_grad_damp(fields, (const float*)p, s, is_bf16, nz, ny, nx,
                               (cudaStream_t)stream);
}

// q (nz, ny, nx) f32; out (3, nz, ny, nx) f32 = (gx, gy, gz).
int fx_gradient3(const void* q, void* out, int nz, int ny, int nx, void* stream) {
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
