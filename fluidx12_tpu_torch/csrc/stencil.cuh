// Device code shared by stencil.cu (B3, B8, B15, B16) and jacobi.cu (B18):
// storage-type loads and stores, a cell's edge-clamped neighbours, the
// divergence of the velocity channels and B8's gradient + wall-band damp.
// Every edge is clamped: the neighbour index is min(i + 1, n - 1) /
// max(i - 1, 0).  Both files build with --fmad=false, so every product and
// sum here rounds as in the Pallas code and the plain PyTorch versions.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

inline unsigned blocks_for(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

__device__ __forceinline__ float ld(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// A cell and the linear indices of its six edge-clamped neighbours.
struct Cell {
  int z, y, x;
  int64_t xp, xm, yp, ym, zp, zm;
};

__device__ __forceinline__ Cell cell_at(int64_t idx, int nz, int ny, int nx) {
  Cell k;
  const int64_t plane = (int64_t)ny * nx;
  k.x = (int)(idx % nx);
  k.y = (int)((idx / nx) % ny);
  k.z = (int)(idx / plane);
  k.xp = k.x < nx - 1 ? idx + 1 : idx;
  k.xm = k.x > 0 ? idx - 1 : idx;
  k.yp = k.y < ny - 1 ? idx + nx : idx;
  k.ym = k.y > 0 ? idx - nx : idx;
  k.zp = k.z < nz - 1 ? idx + plane : idx;
  k.zm = k.z > 0 ? idx - plane : idx;
  return k;
}

// 0.5 * ((dx + dy) + dz) of channels 0..2 of the (C, Z, Y, X) state at cell
// k, each channel cast to f32 first; n = Z * Y * X.  B3's _div_kernel and
// B18's divergence prologue (jacobi.py:229-249) both sum in this order.
template <typename T>
__device__ __forceinline__ float divergence_at(const T* __restrict__ f, const Cell& k,
                                               int64_t n) {
  const T* ux = f;
  const T* uy = f + n;
  const T* uz = f + 2 * n;
  const float dx = ld(ux, k.xp) - ld(ux, k.xm);
  const float dy = ld(uy, k.yp) - ld(uy, k.ym);
  const float dz = ld(uz, k.zp) - ld(uz, k.zm);
  return 0.5f * ((dx + dy) + dz);
}

// The wall band at index i of n along an axis: the cell's position in
// [-1, 1] and the factor a velocity pointing at the nearer wall is scaled by.
struct Band {
  float pos, scale;
};

__device__ __forceinline__ Band band_at(int i, int n) {
  const float pos = (((float)i + 0.5f) / (float)n) * 2.0f - 1.0f;
  return Band{pos, fminf(fmaxf((0.97f - fabsf(pos)) / 0.03f, -1.0f), 1.0f)};
}

// One velocity component: v = u - g, then the wall-band damp along its axis.
__device__ __forceinline__ float damp(float u, float g, const Band& band) {
  const float v = u - g;
  return v * band.pos > 0.0f ? v * band.scale : v;
}

__device__ __forceinline__ float damp(float u, float g, int i, int n) {
  return damp(u, g, band_at(i, n));
}

// B8, and B18's gradient epilogue (the same arithmetic: jacobi.py:364-431
// forms gy as q[y+1] - q[y-1] through a one-hot dot with two non-zero
// terms, and its wall positions as B8's): channels 0..2 of f in place.
template <typename T>
__global__ void grad_damp_kernel(T* __restrict__ f, const float* __restrict__ p, float s,
                                 int nz, int ny, int nx) {
  const int64_t n = (int64_t)nz * ny * nx;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const Cell k = cell_at(idx, nz, ny, nx);
  st(f, idx, damp(ld(f, idx), (p[k.xp] - p[k.xm]) * s, k.x, nx));
  st(f, n + idx, damp(ld(f, n + idx), (p[k.yp] - p[k.ym]) * s, k.y, ny));
  st(f, 2 * n + idx, damp(ld(f, 2 * n + idx), (p[k.zp] - p[k.zm]) * s, k.z, nz));
}

// fields (C >= 3, nz, ny, nx) bf16 (is_bf16) or f32, updated in place on
// channels 0..2 from the f32 pressure p; s = fl32(0.5 / rho).
inline cudaError_t launch_grad_damp(void* fields, const float* p, float s, int is_bf16,
                                    int nz, int ny, int nx, cudaStream_t stream) {
  const unsigned blocks = blocks_for((int64_t)nz * ny * nx);
  if (is_bf16) {
    grad_damp_kernel<<<blocks, kThreads, 0, stream>>>((__nv_bfloat16*)fields, p, s, nz, ny, nx);
  } else {
    grad_damp_kernel<<<blocks, kThreads, 0, stream>>>((float*)fields, p, s, nz, ny, nx);
  }
  return cudaGetLastError();
}

}  // namespace
