// Split semi-Lagrangian advection of the (C, Z, Y, X) state for Hopper.
//
// B1 (fx_advect_xy) replaces fluidx12_tpu/ops/pallas/advect.py
// _pass_kernel_fused_xy (via _run_pass_fused_xy); B2 (fx_advect_z_forces)
// replaces _zpass_forces_kernel (via _run_zpass); B11 (fx_advect_axis)
// replaces the single-axis passes _pass_kernel_fused_d and
// _pass_kernel_fused_d1 (via _run_pass_fused: one function under two
// tilings) and _pass_kernel (via _run_pass, the same function fed a
// precomputed displacement), which the TPU runs on planes too large for
// B1, the 2D preset's 512^2 among them.  B11 is B1's per-axis half with
// its result rounded to storage.  Semantics are the TPU kernels', not the
// mirror-addressed XLA twin's:
//   - the displacement d = -u * dt * N is clipped to +-MAX_DISP voxels and
//     then into [-i, n-1-i] (clamp addressing absorbed into d), after which
//     the TPU's 26-tap dense sum is exactly this 2-tap lerp at floor(d);
//   - the x-pass result is rounded to the storage type before the y pass
//     derives its displacement from channel 1 (the TPU's channel reorder);
//   - the z pass derives dz from the xy-advected u_z and applies the
//     impulse/forces/dissipation epilogue with one rounding to storage.
// One deliberate difference: B1 hands its y-pass result to B2 in f32, where
// the TPU stores it in bf16 to halve that HBM round trip.  The extra
// rounding moved the 24^3 golden frame from 0.73% to 1.22% of pixels off
// by more than 25 (gate: 1%); keeping f32 costs 14 B per voxel each way.
// Weights are formed exactly as the Pallas code forms them
// (max(1 - |d - a|, 0) for a = floor(d), floor(d) + 1), and the file is
// built with --fmad=false, so each f32 operation rounds as it does there.
//
// Bound: memory.  The x pass reads the 7-channel bf16 state and writes a
// bf16 scratch (14 + 14 B per voxel), the y pass reads it and writes f32
// (14 + 28 B), the z pass reads f32 and writes bf16 (28 + 14 B); B11 reads
// and writes the storage type (14 + 14 B at bf16: 7.3 MB, 2.2 us, at the 2D
// preset's 512^2).  The two taps per channel stay within one or two cache
// lines of the output row (x), or in rows the neighbouring threads also
// read (y, z).  One thread per voxel, consecutive threads on consecutive x,
// so every read and write is coalesced.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMaxDisp = 12.0f;
constexpr int kThreads = 256;

__device__ __forceinline__ float ld(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// Clipped, in-bounds displacement of cell i on an axis of n cells.
__device__ __forceinline__ float clamp_disp(float u, float scale, int i, int n) {
  float d = fminf(fmaxf(-u * scale, -kMaxDisp), kMaxDisp);
  float fi = (float)i;
  return fminf(fmaxf(d, -fi), ((float)n - 1.0f) - fi);
}

struct Taps {
  int i0, i1;
  float w0, w1;
};

// The two non-zero taps of the dense lerp.  i1 is clamped where its weight
// is exactly zero (d == n-1-i), so every read stays in bounds.
__device__ __forceinline__ Taps lerp_taps(float d, int i, int n) {
  float a0 = floorf(d);
  Taps t;
  t.w0 = fmaxf(1.0f - fabsf(d - a0), 0.0f);
  t.w1 = fmaxf(1.0f - fabsf(d - (a0 + 1.0f)), 0.0f);
  t.i0 = i + (int)a0;
  t.i1 = min(t.i0 + 1, n - 1);
  return t;
}

// One-axis resample of every channel, the displacement from channel
// `disp_ch` of the input itself, one rounding to Tout.  The axis is given by
// its element stride and extent, so x, y and z share the code: B11 is one
// launch (Tout = Tin), B1 two (x into Tin, then y into f32).
template <typename Tin, typename Tout>
__global__ void advect_axis_kernel(const Tin* __restrict__ vol, Tout* __restrict__ out,
                                   const float* __restrict__ scale, int disp_ch, int C,
                                   int64_t vox, int64_t stride, int n) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= vox) return;
  const int i = (int)((idx / stride) % n);
  const int64_t line = idx - (int64_t)i * stride;  // the cell at i = 0
  const float d = clamp_disp(ld(vol, disp_ch * vox + idx), scale[0], i, n);
  const Taps t = lerp_taps(d, i, n);
  for (int c = 0; c < C; ++c) {
    const int64_t base = c * vox + line;
    st(out, c * vox + idx,
       t.w0 * ld(vol, base + (int64_t)t.i0 * stride) +
           t.w1 * ld(vol, base + (int64_t)t.i1 * stride));
  }
}

struct ForceConsts {
  float ip_x, ip_y, ip_z, radius_sq, dissipation;
};

template <typename T>
__global__ void advect_z_forces_kernel(const float* __restrict__ vol, T* __restrict__ out,
                                       const float* __restrict__ scal,
                                       const float* __restrict__ table, ForceConsts fc,
                                       int forces, int C, int Z, int Y, int X) {
  const int64_t vox = (int64_t)Z * Y * X;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= vox) return;
  const int64_t plane = (int64_t)Y * X;
  const int x = (int)(idx % X);
  const int y = (int)((idx / X) % Y);
  const int z = (int)(idx / plane);
  const int64_t col = idx - (int64_t)z * plane;  // (0, y, x)
  const float d = clamp_disp(ld(vol, 2 * vox + idx), scal[0], z, Z);
  const Taps t = lerp_taps(d, z, Z);

  float in_imp = 0.0f, basis = 0.0f, dx = 0.0f, ndz = 0.0f, dt = 0.0f, atten = 1.0f;
  if (forces) {
    dt = scal[1];
    atten = fmaxf(1.0f - fc.dissipation * dt, 0.0f);
    // Simulation-space voxel centres (GridToSimulationSpace).
    const float cz = ((float)z + 0.5f) / (float)Z;
    const float cy = ((float)y + 0.5f) / (float)Y;
    const float cx = ((float)x + 0.5f) / (float)X;
    dx = cx - fc.ip_x;
    const float dy = cy - fc.ip_y;
    const float dz = cz - fc.ip_z;
    const float d2 = dx * dx + dy * dy + dz * dz;
    basis = expf(-4.0f * d2 / fc.radius_sq);
    in_imp = basis >= 0.01831563889245799f ? 1.0f : 0.0f;  // exp(-4)
    ndz = -dz;
  }
  for (int c = 0; c < C; ++c) {
    const int64_t base = c * vox + col;
    float v = t.w0 * ld(vol, base + (int64_t)t.i0 * plane) +
              t.w1 * ld(vol, base + (int64_t)t.i1 * plane);
    if (forces) {
      const float* f = table + 5 * c;  // [A_basis, B_negdz, B_dx, lo, hi]
      const float ext = f[0] * basis + f[1] * ndz + f[2] * dx;
      v = fminf(fmaxf(v + in_imp * ext * dt, f[3]), f[4]) * atten;
    }
    st(out, c * vox + idx, v);
  }
}

inline unsigned blocks_for(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

template <typename Tin, typename Tout>
cudaError_t launch_axis(const void* vol, void* out, const float* scale, int disp_ch, int C,
                        int64_t vox, int64_t stride, int n, cudaStream_t s) {
  advect_axis_kernel<<<blocks_for(vox), kThreads, 0, s>>>(
      (const Tin*)vol, (Tout*)out, scale, disp_ch, C, vox, stride, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// B1: x pass into `tmp` (storage type), then y pass into `out` (f32), its
// displacement from the x-advected, storage-rounded u_y (channel 1).
// scales = device [dt*X, dt*Y].
int fx_advect_xy(const void* vol, void* tmp, void* out, const void* scales, int is_bf16,
                 int C, int Z, int Y, int X, void* stream) {
  const int64_t vox = (int64_t)Z * Y * X;
  cudaStream_t s = (cudaStream_t)stream;
  const float* sc = (const float*)scales;
  cudaError_t err =
      is_bf16 ? launch_axis<__nv_bfloat16, __nv_bfloat16>(vol, tmp, sc, 0, C, vox, 1, X, s)
              : launch_axis<float, float>(vol, tmp, sc, 0, C, vox, 1, X, s);
  if (err != cudaSuccess) return (int)err;
  err = is_bf16 ? launch_axis<__nv_bfloat16, float>(tmp, out, sc + 1, 1, C, vox, X, Y, s)
                : launch_axis<float, float>(tmp, out, sc + 1, 1, C, vox, X, Y, s);
  return (int)err;
}

// B11: resample along `axis` (0 z, 1 y, 2 x of the (Z, Y, X) volume) with
// the displacement from channel `disp_ch`, into `out` of vol's storage
// type.  scale = device [dt * N].
int fx_advect_axis(const void* vol, void* out, const void* scale, int disp_ch, int axis,
                   int is_bf16, int C, int Z, int Y, int X, void* stream) {
  if (axis < 0 || axis > 2 || disp_ch < 0 || disp_ch >= C) return (int)cudaErrorInvalidValue;
  const int64_t vox = (int64_t)Z * Y * X;
  const int64_t stride = axis == 2 ? 1 : axis == 1 ? (int64_t)X : (int64_t)Y * X;
  const int n = axis == 2 ? X : axis == 1 ? Y : Z;
  cudaStream_t s = (cudaStream_t)stream;
  const float* sc = (const float*)scale;
  return (int)(is_bf16
                   ? launch_axis<__nv_bfloat16, __nv_bfloat16>(vol, out, sc, disp_ch, C, vox,
                                                              stride, n, s)
                   : launch_axis<float, float>(vol, out, sc, disp_ch, C, vox, stride, n, s));
}

// B2: z pass of the f32 `vol` (+ fused forces epilogue when `forces`) into
// `out` of the storage type.  scal = device [dt_sub*Z, dt]; table = device
// (C, 5) f32 per-channel force coefficients, never read (and may be null)
// without `forces`: that is B12, replacing _zpass_kernel.
int fx_advect_z_forces(const void* vol, void* out, const void* scal, const void* table,
                       float ip_x, float ip_y, float ip_z, float radius_sq,
                       float dissipation, int forces, int is_bf16, int C, int Z, int Y,
                       int X, void* stream) {
  const int64_t vox = (int64_t)Z * Y * X;
  cudaStream_t s = (cudaStream_t)stream;
  ForceConsts fc{ip_x, ip_y, ip_z, radius_sq, dissipation};
  if (is_bf16) {
    advect_z_forces_kernel<<<blocks_for(vox), kThreads, 0, s>>>(
        (const float*)vol, (__nv_bfloat16*)out, (const float*)scal,
        (const float*)table, fc, forces, C, Z, Y, X);
  } else {
    advect_z_forces_kernel<<<blocks_for(vox), kThreads, 0, s>>>(
        (const float*)vol, (float*)out, (const float*)scal, (const float*)table, fc, forces,
        C, Z, Y, X);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
