// Directional light-map shear scan for Hopper (B9).
//
// Replaces fluidx12_tpu/ops/pallas/sweep.py _sweep_kernel (via
// shear_scan_pallas): the exclusive sheared prefix of log attenuation
//     D[k, p] = sum_{j<k} log_att[j, p + (k - j) * slope]
// with a 2-tap lerp per lateral axis and shifts clamp(pad + k*slope, 0, n).
//
// The TPU kernel walks the slices as a sequential grid and carries the
// sheared (W_a, W_b) = (2n_a, 2n_b) plane E in VMEM: at slice k it reads
// D[k, p] = E[p + shift_k] (a lerp along a, then along b), then adds slice
// k sheared, E[w] += G_k[w] = x_k[w - shift_k] (the same lerps).  The TPU's
// cyclic rolls are reproduced exactly with indices modulo W: the
// zero-padded W = 2n frame keeps every non-zero-weight tap inside it, and
// the few wrapped taps carry weight zero, as there.
//
// Here (shear_scan_kernel) a warp owns a strip of sheared-frame columns and
// keeps each column's f32 carry E in a register, adding in the TPU kernel's
// order (carry = carry + sample), so nothing of E leaves the chip:
//   - Lanes run along w_b: lane j holds column tb0 - 1 + j, and each thread
//     kRows + 1 consecutive w_a rows ta0 .. ta0 + kRows.  The warp emits the
//     outputs whose base column p + shift_k lies in its kRows x 30 owned
//     columns (rows ta0 .. ta0 + kRows - 1, lanes 1 .. 30).  Row kRows and lane 31
//     are the halo the lerps' second taps read, from the thread's own
//     registers and from the next lane by a shuffle; the sample's tap left
//     of a column is the previous lane's, by a shuffle too, so lane 0 is a
//     halo whose carry is never read.  Each output is written by exactly
//     one warp, and warps never wait on each other.
//   - Only the columns in [shift_k, shift_k + n] (modulo W, per axis) are
//     read at slice k, and only they receive a non-zero sample: G_k is
//     exactly +0 elsewhere, and carry + 0 = carry (the carry starts at +0
//     and a sum is -0 only if both terms are).  So a warp runs only the
//     slices from the first to the last one whose window meets its columns
//     (found with a ballot over the slices), starting from a zero carry;
//     a warp whose columns meet no window exits at once.
//   - A CTA first tabulates every slice's shifts in shared memory.  Slice
//     k's taps x_k[w - shift_k] are staged with cp.async into a per-warp
//     ring of kStages slices (zero-filled past the slice, which is the zero
//     padding), kStages - 1 slices ahead of the one being summed.
// The shift formula is the TPU's (shift_at), so are the lerps (the file
// builds with --fmad=false), and the sum runs slice by slice in order: the
// kernel matches the plain version bit for bit.
//
// Bound: memory, 16.8 MB in and out at 128^3 (5.0 us at 3.35 TB/s).  What
// holds the kernel back is instruction issue: about 120 instructions a
// warp-slice (ops/cuda/sweep.shear_plan), of which half stage the taps, and
// 1.4 warp-slices for each 30 x 1 block of outputs the scan needs (the halo
// row doubles the carried columns at one row a thread; a warp runs the
// slices of its widest column).  More rows a thread carry fewer halo
// columns but leave too few warps to hide each slice's latency.
//
// fx_shear_scan_twopass keeps the design this replaced, two launches
// through an (n_s, 2n_a, 2n_b) scratch in device memory, as a yardstick.
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

// The two-launch design fx_shear_scan_twopass keeps as a yardstick:
//   1. one thread per sheared-frame column (w_a, w_b) loops over k, writes
//      the running exclusive sum E[k, w] to an (n_s, 2n_a, 2n_b) scratch and
//      adds slice k's sheared sample (32 MiB written at 128^3);
//   2. one thread per (k, p) lerp-samples E[k] at p + shift_k.
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

// ---------------------------------------------------------------------------
// One launch, each column's carry in a register
// ---------------------------------------------------------------------------

constexpr int kLanes = 32;          // a warp along w_b
constexpr int kOwnB = kLanes - 2;   // lanes 1 .. 30 own columns; lanes 0 and 31 are halo
constexpr int kStages = 4;          // slices of taps in a warp's ring
constexpr int kMaxWarps = 8;        // warps a CTA
constexpr int kRows = 1;            // owned w_a rows a thread, plus one halo row

// Shared memory of a CTA: the shifts of every slice (sa, fa, sb, fb; a
// float4 each), then each warp's ring of kStages slots of its rows + 2 tap
// rows, a tap a lane.
__host__ __device__ constexpr int shear_smem(int warps, int ns) {
  return (4 * ns + warps * kStages * (kRows + 2) * kLanes) * (int)sizeof(float);
}

// i in [-n, 2n) modulo n.
__device__ __forceinline__ int wrap1(int i, int n) { return i < 0 ? i + n : i >= n ? i - n : i; }

// Whether the cyclic ranges {a0 + i mod W : i < la} and {s + j mod W : j < ls}
// meet, a0 and s in [0, W).
__device__ __forceinline__ bool meets(int a0, int la, int s, int ls, int W) {
  return wrap1(s - a0, W) < la || wrap1(a0 - s, W) < ls;
}

// A 4-byte cp.async that writes 0 in place of the load where !valid.
__device__ __forceinline__ void cp_async4_zfill(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// *p = v where `store`, without a branch.
__device__ __forceinline__ void store_if(float* p, float v, bool store) {
  asm volatile("{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n @q st.global.f32 [%0], %1;\n}\n"
               ::"l"(p), "f"(v), "r"((int)store) : "memory");
}

// Warp `warp` of CTA (bx, by) carries the columns of rows ta0 .. ta0 + kRows
// (modulo W_a), ta0 = kRows * (by * warps + warp), and of lanes tb0 - 1 ..
// tb0 + 30 (modulo W_b), tb0 = bx * 30.  It owns rows ta0 .. ta0 + kRows - 1
// and the columns of lanes 1 .. 30 that lie in the frame.  Lane 0's sample
// lacks the lane left of it: its carry is never read.
__global__ void __launch_bounds__(kMaxWarps* kLanes)
    shear_scan_kernel(const float* __restrict__ x, const float* __restrict__ s,
                      float* __restrict__ out, int ns, int na, int nb) {
  extern __shared__ __align__(16) float shsm[];
  float4* const shifts = (float4*)shsm;
  const float slope_a = s[0], slope_b = s[1], pad_a = s[2], pad_b = s[3];
  for (int k = threadIdx.x; k < ns; k += blockDim.x) {
    const Shift a = shift_at(pad_a, slope_a, k, na), b = shift_at(pad_b, slope_b, k, nb);
    shifts[k] = make_float4(__int_as_float(a.s), a.f, __int_as_float(b.s), b.f);
  }
  __syncthreads();
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int wa_n = 2 * na, wb_n = 2 * nb;
  const int ta0 = kRows * ((int)blockIdx.y * (int)(blockDim.x / kLanes) + warp);
  const int tb0 = (int)blockIdx.x * kOwnB;
  if (ta0 >= wa_n) return;
  const int64_t plane = (int64_t)na * nb;
  const int row_bytes = nb * (int)sizeof(float);
  const int cb0 = tb0 == 0 ? wb_n - 1 : tb0 - 1;  // lane 0's column
  const int wb = (cb0 + lane) % wb_n;

  // The first and last slice whose window [shift_k, shift_k + n] meets the
  // warp's columns on both axes.
  int k0 = ns, k1 = -1;
  for (int base = 0; base < ns; base += kLanes) {
    const int k = base + lane;
    bool hit = false;
    if (k < ns) {
      const float4 h = shifts[k];
      hit = meets(ta0, kRows + 1, __float_as_int(h.x), na + 1, wa_n) &&
            meets(cb0, kLanes, __float_as_int(h.z), nb + 1, wb_n);
    }
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (mask) {
      k0 = min(k0, base + __ffs(mask) - 1);
      k1 = base + 31 - __clz(mask);
    }
  }
  if (k1 < k0) return;

  float* const ring = shsm + 4 * ns + warp * kStages * (kRows + 2) * kLanes;
  // Slice k's taps into ring slot `slot`: rows ta0 - 1 - sa .. ta0 + kRows - sa
  // (modulo W_a) at column wb - sb, a tap a lane, zero past the slice.  One
  // commit group a call.
  auto stage = [&](int k, int slot) {
    if (k <= k1) {
      const float4 h = shifts[k];
      const int c = wrap1(wb - __float_as_int(h.z), wb_n);
      int r = wrap1(ta0 - 1 - __float_as_int(h.x), wa_n);
      const char* const xc = (const char*)(x + (int64_t)k * plane + (c < nb ? c : 0));
      float* const d = ring + slot * (kRows + 2) * kLanes + lane;
#pragma unroll
      for (int j = 0; j < kRows + 2; ++j) {
        const bool ok = c < nb && r < na;
        cp_async4_zfill(d + j * kLanes, (const float*)(xc + (int64_t)(ok ? r : 0) * row_bytes),
                        ok);
        r = r + 1 == wa_n ? 0 : r + 1;
      }
    }
    cp_async_commit();
  };

  float carry[kRows + 1];
#pragma unroll
  for (int r = 0; r <= kRows; ++r) carry[r] = 0.0f;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) stage(k0 + i, i);
  const bool own_lane = lane >= 1 && lane <= kOwnB && tb0 + lane - 1 < wb_n;
  float* out_k = out + (int64_t)k0 * plane;
  int slot = 0;
  for (int k = k0; k <= k1; ++k, out_k += plane) {
    __syncwarp();  // every lane is done with the slot slice k - 1 used
    stage(k + kStages - 1, slot == 0 ? kStages - 1 : slot - 1);
    cp_async_wait<kStages - 1>();
    __syncwarp();  // slice k's taps, staged by every lane, are visible
    const float4 h = shifts[k];
    const int sa = __float_as_int(h.x), sb = __float_as_int(h.z);
    const float fa = h.y, fb = h.w, ua = 1.0f - fa, ub = 1.0f - fb;
    // The exclusive output D[k, p] = E[p + shift_k]: the lerp along a from
    // this thread's rows, then along b with the next lane's.
    const int pa = ta0 - sa, pb = tb0 + lane - 1 - sb;
    const bool own_b = own_lane && pb >= 0 && pb < nb;
    float* const o = out_k + pa * nb + pb;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float ea0 = ua * carry[r] + fa * carry[r + 1];
      const float ea1 = __shfl_down_sync(0xffffffffu, ea0, 1);
      store_if(o + r * nb, ub * ea0 + fb * ea1,
               own_b && ta0 + r < wa_n && pa + r >= 0 && pa + r < na);
    }
    // carry += G_k, G_k[w] = x_k[w - shift_k] with the same lerps: along a
    // from this lane's taps, then along b with the previous lane's.
    const float* const t = ring + slot * (kRows + 2) * kLanes + lane;
    float t0[kRows + 2];
#pragma unroll
    for (int j = 0; j < kRows + 2; ++j) t0[j] = t[j * kLanes];
#pragma unroll
    for (int r = 0; r <= kRows; ++r) {
      const float ga0 = ua * t0[r + 1] + fa * t0[r];
      const float ga1 = __shfl_up_sync(0xffffffffu, ga0, 1);
      carry[r] = carry[r] + (ub * ga0 + fb * ga1);
    }
    slot = slot == kStages - 1 ? 0 : slot + 1;
  }
  cp_async_wait<0>();
}

// Warps of kRows rows each take the ceil(2n_a / kRows) row strips of the
// frame, a strip a warp, `threads` / 32 consecutive strips a CTA.
cudaError_t launch_shear(const float* x, const float* s, float* out, int ns, int na, int nb,
                         int threads, int smem, cudaStream_t st) {
  static int smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(shear_scan_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_allowed = smem;
  }
  const int strips = (2 * na + kRows - 1) / kRows, warps = threads / kLanes;
  const dim3 grid((2 * nb + kOwnB - 1) / kOwnB, (strips + warps - 1) / warps);
  shear_scan_kernel<<<grid, threads, smem, st>>>(x, s, out, ns, na, nb);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// log_att (ns, na, nb) f32; s = device [slope_a, slope_b, pad_a, pad_b];
// out (ns, na, nb) f32.  One launch of shear_scan_kernel with the plan
// ops/cuda/sweep.shear_plan gives: warps that own tile_a x tile_b
// sheared-frame columns each (the compiled kRows x kOwnB, 1 x 30), CTAs of
// `threads` threads (whole warps, at most kMaxWarps), `smem` bytes of
// shared memory (the slices' shifts and the warps' rings).  Refuses a plan
// the kernel cannot run.
int fx_shear_scan(const void* log_att, const void* s, void* out, int ns, int na, int nb,
                  int tile_a, int tile_b, int threads, int smem, void* stream) {
  const int warps = threads / kLanes;
  if (ns < 1 || na < 1 || nb < 1 || (int64_t)2 * na * nb > INT32_MAX || ns > (1 << 20) ||
      threads % kLanes || warps < 1 || warps > kMaxWarps || tile_a != kRows ||
      tile_b != kOwnB || smem < shear_smem(warps, ns)) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)launch_shear((const float*)log_att, (const float*)s, (float*)out, ns, na, nb,
                           threads, smem, (cudaStream_t)stream);
}

// The two-launch design B9 had before, kept as a yardstick to time
// fx_shear_scan against: scratch (ns, 2na, 2nb) f32, the other arguments as
// fx_shear_scan's.
int fx_shear_scan_twopass(const void* log_att, const void* s, void* scratch, void* out, int ns,
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
