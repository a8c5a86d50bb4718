// Directional light-map shear scan for Hopper (B9).
//
// Replaces fluidx12_tpu/ops/pallas/sweep.py _sweep_kernel (via
// shear_scan_pallas): the exclusive sheared prefix of log attenuation
//     D[k, p] = sum_{j<k} log_att[j, p + (k - j) * slope]
// with a 2-tap lerp per lateral axis and shifts clamp(pad + k*slope, 0, n).
//
// The TPU kernel walks the slices as a sequential grid and carries the
// sheared (2n_a, 2n_b) plane in VMEM.  Blocks on Hopper run in no order, so
// the scan is split in two launches:
//   1. one thread per sheared-frame column (w_a, w_b) loops over k, writes
//      the running EXCLUSIVE sum E[k, w] (before adding slice k) and adds
//      slice k's sheared sample; the f32 carry lives in a register and sums
//      in the TPU kernel's order (carry = carry + sample);
//   2. one thread per (k, p) lerp-samples E[k] at p + shift_k.
// The TPU's cyclic rolls are reproduced exactly with modular indices: the
// zero-padded W = 2n frame keeps every non-zero-weight tap inside it, and
// the few wrapped taps carry weight zero, as there.
//
// Bound: memory.  Launch 1 reads the (n_s, n_a, n_b) f32 input four times
// (mostly from L2) and writes the (n_s, 2n_a, 2n_b) scratch (32 MiB at
// 128^3); launch 2 reads it back with four taps per output.  Consecutive
// threads take consecutive w_b / p_b, so both sweeps are coalesced.
// Built with --fmad=false so the lerps round as the Pallas code does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Shift {
  int s;    // floor of the clamped shift
  float f;  // its fraction
};

// shift = clip(pad + k * slope, 0, n) (sweep.py:58-66).
__device__ __forceinline__ Shift shift_at(float pad, float slope, int k, int n) {
  const float sh = fminf(fmaxf(pad + (float)k * slope, 0.0f), (float)n);
  const float fl = floorf(sh);
  return Shift{(int)fl, sh - fl};
}

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// Zero-padded input plane: x[k] inside [0, n_a) x [0, n_b), 0 elsewhere.
__device__ __forceinline__ float padded(const float* xk, int r, int c, int na, int nb) {
  return (r < na && c < nb) ? xk[(int64_t)r * nb + c] : 0.0f;
}

__global__ void shear_accumulate_kernel(const float* __restrict__ x, float* __restrict__ E,
                                        const float* __restrict__ s, int ns, int na, int nb) {
  const int Wa = 2 * na, Wb = 2 * nb;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)Wa * Wb) return;
  const int wa = (int)(idx / Wb);
  const int wb = (int)(idx % Wb);
  const float slope_a = s[0], slope_b = s[1], pad_a = s[2], pad_b = s[3];
  float carry = 0.0f;
  for (int k = 0; k < ns; ++k) {
    const Shift a = shift_at(pad_a, slope_a, k, na);
    const Shift b = shift_at(pad_b, slope_b, k, nb);
    E[((int64_t)k * Wa + wa) * Wb + wb] = carry;
    // G[w] = x[w - shift]: roll by s and s + 1 along each axis.
    const float* xk = x + (int64_t)k * na * nb;
    const int r0 = wrap(wa - a.s, Wa), r1 = wrap(wa - a.s - 1, Wa);
    const int c0 = wrap(wb - b.s, Wb), c1 = wrap(wb - b.s - 1, Wb);
    const float ga0 = (1.0f - a.f) * padded(xk, r0, c0, na, nb) + a.f * padded(xk, r1, c0, na, nb);
    const float ga1 = (1.0f - a.f) * padded(xk, r0, c1, na, nb) + a.f * padded(xk, r1, c1, na, nb);
    carry = carry + ((1.0f - b.f) * ga0 + b.f * ga1);
  }
}

__global__ void shear_unshear_kernel(const float* __restrict__ E, float* __restrict__ out,
                                     const float* __restrict__ s, int ns, int na, int nb) {
  const int Wa = 2 * na, Wb = 2 * nb;
  const int64_t plane = (int64_t)na * nb;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)ns * plane) return;
  const int k = (int)(idx / plane);
  const int pa = (int)((idx / nb) % na);
  const int pb = (int)(idx % nb);
  const Shift a = shift_at(s[2], s[0], k, na);
  const Shift b = shift_at(s[3], s[1], k, nb);
  // D[k, p] = E[k, p + shift]: roll by W - s and W - 1 - s along each axis.
  const float* ek = E + (int64_t)k * Wa * Wb;
  const int64_t r0 = (int64_t)((pa + a.s) % Wa) * Wb, r1 = (int64_t)((pa + a.s + 1) % Wa) * Wb;
  const int c0 = (pb + b.s) % Wb, c1 = (pb + b.s + 1) % Wb;
  const float ea0 = (1.0f - a.f) * ek[r0 + c0] + a.f * ek[r1 + c0];
  const float ea1 = (1.0f - a.f) * ek[r0 + c1] + a.f * ek[r1 + c1];
  out[idx] = (1.0f - b.f) * ea0 + b.f * ea1;
}

inline unsigned blocks_for(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// log_att (ns, na, nb) f32; s = device [slope_a, slope_b, pad_a, pad_b];
// scratch (ns, 2na, 2nb) f32; out (ns, na, nb) f32.
int fx_shear_scan(const void* log_att, const void* s, void* scratch, void* out, int ns,
                  int na, int nb, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  shear_accumulate_kernel<<<blocks_for((int64_t)4 * na * nb), kThreads, 0, st>>>(
      (const float*)log_att, (float*)scratch, (const float*)s, ns, na, nb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  shear_unshear_kernel<<<blocks_for((int64_t)ns * na * nb), kThreads, 0, st>>>(
      (const float*)scratch, (float*)out, (const float*)s, ns, na, nb);
  return (int)cudaGetLastError();
}

}  // extern "C"
