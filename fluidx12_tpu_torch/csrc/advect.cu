// Split semi-Lagrangian advection of the (C, Z, Y, X) state for Hopper.
//
// B1 (fx_advect_xy) replaces fluidx12_tpu/ops/pallas/advect.py
// _pass_kernel_fused_xy (via _run_pass_fused_xy); B2 (fx_advect_z_forces)
// replaces _zpass_forces_kernel (via _run_zpass), and with its forces
// epilogue off is B12, replacing _zpass_kernel; B11 (fx_advect_axis)
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
// Bound: memory.  B1 reads the 7-channel bf16 state and writes f32 (14 +
// 28 B a voxel), B2 reads f32 and writes bf16 (28 + 14 B): 26.3 us each at
// 128^3 over 3.35 TB/s.  B11 reads and writes the storage type (14 + 14 B
// at bf16: 7.3 MB, 2.2 us, at the 2D preset's 512^2, where the state stays
// in the 50 MB L2 from one pass to the next).
//
// The clip bounds every tap to kHaloLo cells below its output and kHaloHi
// above (the second tap), so a strip of kLanes x-columns, one lane each,
// needs only a window of rows or planes around the ones it owns, which a
// CTA stages in shared memory with cp.async (16-byte copies where the
// rows' alignment allows, else 8, 4 or, for a bf16 row of odd length, 2
// bytes by plain loads): the loads are in flight together, where taps read
// from device memory per lane keep each warp waiting on two dependent loads
// a row or plane (PERF.md, the B1 and B2 findings).
//   - B1 (advect_xy_kernel) is one launch.  CTA (i, j, z) owns x-columns
//     [32 i, 32 i + 32) and rows [j tile_y, (j + 1) tile_y) of plane z.  It
//     stages, for those rows and their halo, every channel's input window
//     of kWinCols columns around the strip; runs the x pass from it, one
//     warp a row, and writes the storage-rounded results over the row it
//     read (two bf16 channels, or one f32, a 32-bit word a lane); then,
//     after one barrier, runs the y pass from those results and writes f32,
//     coalesced.  The x-pass result never goes to device memory, as it
//     never leaves VMEM on the TPU.  With tile_y >= Y the window is the
//     whole Y column and nothing is recomputed.
//   - B2 (advect_z_kernel) owns tile_z planes of one row's strip.  It
//     stages every channel's f32 planes [z0 - kHaloLo, z0 + tile_z +
//     kHaloHi) of the strip, then forms each output from two
//     shared-memory reads a channel, one warp a plane.  With tile_z >= Z
//     the window is the whole column and no plane is staged twice.  The
//     forces epilogue runs on 32-bit (z, y, x) from blockIdx and
//     threadIdx, and forms exp only near the impulse.
//   - A lane's reads fall in bank `lane` (a row of the x-pass results is a
//     multiple of 32 words; a window plane is 32 floats), so the lanes of a
//     warp, each at its own row or plane, never conflict.
//   - Lanes past X (a ragged strip) compute nothing; no lane reads another
//     lane's results.  Rows and planes are clamped to the volume, so an axis
//     shorter than the window (Z = 20) stages all of it.
// ops/cuda/advect.advect_plan chooses the tiles; the C launches check them.
// B11 (fx_advect_axis) stages in the storage type, on the plan of
// ops/cuda/advect.axis_plan, which its launch takes whole and checks:
//   - the x pass (advect_row_kernel) owns whole rows: a CTA stages every
//     channel of its rows with cp.async in one batch (7 KB a row at 512
//     bf16 columns; a row too long for the budget is cut into spans of
//     columns, each staged with kRowLead columns either side), then each
//     thread forms a pair of adjacent columns (one where X is odd) from
//     shared memory and writes it as one 4-byte (bf16) or 8-byte (f32)
//     word.  No column is staged twice.
//   - the y and z passes (advect_strip_kernel) are B2's staged window
//     taken along the pass's axis (stride X or Y * X), staged in the
//     storage type, the displacement from channel disp_ch of the window,
//     no epilogue.  A lane owns one column (32-column strips), or a bf16
//     pair (64-column strips) where the rows are not 16-byte aligned (X =
//     150: a 64-byte strip row there straddles three 32-byte sectors).
//     The plan cuts the axis into even tiles, enough for about four CTAs
//     an SM (at 512^2 along y: 32 tiles of 16 rows, 512 CTAs, each
//     re-reading the 25-row halo from L2), where the fewest tiles that fit
//     shared memory would give 48 CTAs.
//   - both are programmatic dependent launches (griddep_wait): the y pass
//     is scheduled as the x pass drains, which hides most of the launch
//     gap between the 2D frame's two passes (PERF.md, the PR 13 finding).
// The designs they replaced stay as yardsticks: fx_advect_xy_perthread
// (two launches of advect_axis_kernel through a storage-type scratch),
// fx_advect_z_forces_perthread (one thread a voxel, the taps gathered
// from device memory across planes) and fx_advect_axis_perthread (B11 as
// one thread a voxel: a 64-bit division for its index, then 2 x C
// dependent 2-byte gathers, one 32-byte sector each along y or z).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kMaxDisp = 12.0f;
constexpr int kThreads = 256;
// B1 and B2: a warp's lanes along x, the window's reach below and above an
// owned row or plane, the channels a kernel unrolls, the warps a CTA.
constexpr int kLanes = 32;
constexpr int kHaloLo = 12;
constexpr int kHaloHi = 13;
constexpr int kMaxC = 8;
constexpr int kMaxWarps = 16;
constexpr int kSmemMax = 232448;

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
// its element stride and extent, so x, y and z share the code.  The design
// B11 replaced, kept as its yardstick (one launch, Tout = Tin), and the
// body of B1's yardstick (two: x into Tin, then y into f32).
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

// ---------------------------------------------------------------------------
// B1: the x pass in shared memory, then the y pass out of it.
// ---------------------------------------------------------------------------

// A row's x-pass input window: kWinCols columns [x0 - kWinLead, x0 + 48) of
// each channel, around a strip's columns [x0, x0 + 32): they hold both taps
// of every lane (x0 + lane + a, a in [-12, 13]).
constexpr int kWinCols = 64;
constexpr int kWinLead = 16;

// Bytes of B1's shared memory for `rows` rows: each row's input window of
// every channel (csrc and ops/cuda/advect.xy_smem agree on this formula).
int xy_smem(int C, bool bf16, int rows) { return rows * C * kWinCols * (bf16 ? 2 : 4); }

// Bytes of B2's staged window: every channel's `planes` planes of a strip.
int z_smem(int C, int planes) { return C * planes * kLanes * (int)sizeof(float); }

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float lo_half(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_half(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// Copies kBytes from device to shared memory: cp.async for 4, 8 or 16
// bytes, a plain load and store for 2 (a bf16 row of odd length).
template <int kBytes>
__device__ __forceinline__ void stage(void* dst, const void* src) {
  if constexpr (kBytes == 2) {
    *(unsigned short*)dst = __ldg((const unsigned short*)src);
  } else {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    if constexpr (kBytes == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
    } else if constexpr (kBytes == 8) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
    }
  }
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// kCopy: bytes a staging copy, the widest the rows' alignment allows.
template <typename Tin, int kCopy>
__global__ void __launch_bounds__(kLanes* kMaxWarps)
    advect_xy_kernel(const Tin* __restrict__ vol, float* __restrict__ out,
                     const float* __restrict__ scales, int C, int Z, int Y, int X, int tile_y) {
  extern __shared__ __align__(16) unsigned char smem[];  // [row - ylo][channel][column]
  constexpr bool kPair = std::is_same<Tin, __nv_bfloat16>::value;
  constexpr int kPer = kCopy / (int)sizeof(Tin) > 0 ? kCopy / (int)sizeof(Tin) : 1;
  constexpr int kCopies = kWinCols / kPer;  // copies a channel's row
  const int lane = threadIdx.x, warp = threadIdx.y, nw = blockDim.y;
  const int tid = warp * kLanes + lane, nt = nw * kLanes;
  const int xs = blockIdx.x * kLanes;
  const int x = xs + lane;
  const int w0 = xs - kWinLead;  // the windows' first column
  const int y0 = blockIdx.y * tile_y;
  const int yend = min(y0 + tile_y, Y);
  const int ylo = max(y0 - kHaloLo, 0);
  const int yhi = min(yend + kHaloHi, Y);
  const int rows = yhi - ylo;
  const int chan_bytes = kWinCols * (int)sizeof(Tin);
  const int row_bytes = C * chan_bytes;
  const bool live = x < X;  // lanes past X stage, but compute nothing
  const int64_t vox = (int64_t)Z * Y * X;
  const int64_t zoff = (int64_t)blockIdx.z * Y * X;
  const float sx = scales[0], sy = scales[1];

  // Stage rows [ylo, yhi) of every channel's window; copies past the
  // volume's x edges are skipped, as no tap reaches them.
  for (int c = 0; c < C; ++c) {
    const Tin* src = vol + c * vox + zoff + ylo * X;
    unsigned char* dst = smem + c * chan_bytes;
    for (int j = tid; j < rows * kCopies; j += nt) {
      const int r = j / kCopies, col = w0 + (j % kCopies) * kPer;
      if (col >= 0 && col + kPer <= X) {
        stage<kCopy>(dst + r * row_bytes + (col - w0) * (int)sizeof(Tin), src + r * X + col);
      }
    }
  }
  stage_wait();
  __syncthreads();

  // x pass, one warp a row, in place: every lane reads its taps before any
  // lane of the warp overwrites the row with its storage-rounded result.
  for (int r = warp; r < rows; r += nw) {
    unsigned char* row = smem + r * row_bytes;
    float v[kMaxC];
    if (live) {
      const Tin* in = (const Tin*)row;
      const Taps t = lerp_taps(clamp_disp(ld(in, lane + kWinLead), sx, x, X), x, X);
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) {
        v[c] = 0.0f;
        if (c < C) {
          const Tin* p = in + c * kWinCols;
          const float s = t.w0 * ld(p, t.i0 - w0) + t.w1 * ld(p, t.i1 - w0);
          v[c] = kPair ? __bfloat162float(__float2bfloat16_rn(s)) : s;
        }
      }
    }
    __syncwarp();
    if (live) {
      uint32_t* cell = (uint32_t*)row + lane;
#pragma unroll
      for (int k = 0; k < kMaxC; ++k) {
        if (kPair && 2 * k < C) {
          cell[k * kLanes] = bf16_bits(v[2 * k]) | (bf16_bits(v[2 * k + 1]) << 16);
        } else if (!kPair && k < C) {
          cell[k * kLanes] = __float_as_uint(v[k]);
        }
      }
    }
  }
  __syncthreads();

  // y pass of the owned rows [y0, yend), in f32.  A row is row_bytes / 4
  // words, a multiple of 32: a lane's word k of any row lies in bank `lane`.
  const int row_words = row_bytes / 4;
  const uint32_t* xr = (const uint32_t*)smem + lane;
  for (int y = y0 + warp; live && y < yend; y += nw) {
    const uint32_t u1 = xr[(y - ylo) * row_words + (kPair ? 0 : kLanes)];
    const Taps t = lerp_taps(clamp_disp(kPair ? hi_half(u1) : __uint_as_float(u1), sy, y, Y),
                             y, Y);
    const uint32_t* g0 = xr + (t.i0 - ylo) * row_words;
    const uint32_t* g1 = xr + (t.i1 - ylo) * row_words;
    float* o = out + zoff + y * X + x;
#pragma unroll
    for (int k = 0; k < kMaxC; ++k) {
      if (kPair && 2 * k < C) {
        const uint32_t a = g0[k * kLanes], b = g1[k * kLanes];
        o[(2 * k) * vox] = t.w0 * lo_half(a) + t.w1 * lo_half(b);
        if (2 * k + 1 < C) o[(2 * k + 1) * vox] = t.w0 * hi_half(a) + t.w1 * hi_half(b);
      } else if (!kPair && k < C) {
        o[k * vox] = t.w0 * __uint_as_float(g0[k * kLanes]) +
                     t.w1 * __uint_as_float(g1[k * kLanes]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// B2 / B12: a staged z-window.
// ---------------------------------------------------------------------------

struct ForceConsts {
  float ip_x, ip_y, ip_z, radius_sq, dissipation;
};

// Past this multiple of radius^2 from the impulse, expf(-4 d2 / radius^2)
// is below exp(-4) by a margin no f32 rounding closes: the impulse term is
// off, and its exp need not be formed.
constexpr float kImpulseFar = 1.01f;

template <typename T, int kCopy>
__global__ void __launch_bounds__(kLanes* kMaxWarps)
    advect_z_kernel(const float* __restrict__ vol, T* __restrict__ out,
                    const float* __restrict__ scal, const float* __restrict__ table,
                    ForceConsts fc, int forces, int C, int Z, int Y, int X, int tile_z) {
  extern __shared__ __align__(16) float win[];  // [c][z - zlo][lane]
  constexpr int kPer = kCopy / (int)sizeof(float);
  constexpr int kCopies = kLanes / kPer;  // copies a plane's row of the strip
  const int lane = threadIdx.x, warp = threadIdx.y, nw = blockDim.y;
  const int tid = warp * kLanes + lane, nt = nw * kLanes;
  const int xs = blockIdx.x * kLanes;
  const int x = xs + lane;
  const int y = blockIdx.y;
  const int z0 = blockIdx.z * tile_z;
  const int zend = min(z0 + tile_z, Z);
  const int zlo = max(z0 - kHaloLo, 0);
  const int zhi = min(zend + kHaloHi, Z);
  const int planes = zhi - zlo;
  const int plane = Y * X;
  const int vox = Z * plane;  // a channel has < 2^31 cells (window_ok)

  // Stage every channel's planes [zlo, zhi) of the strip's row; the rows'
  // alignment puts a copy wholly inside X or wholly past it.
  const float* src = vol + zlo * plane + y * X + xs;
  for (int c = 0; c < C; ++c) {
    float* dst = win + c * planes * kLanes;
    const float* sc = src + (int64_t)c * vox;
    for (int j = tid; j < planes * kCopies; j += nt) {
      const int s = j / kCopies, k = (j % kCopies) * kPer;
      if (xs + k + kPer <= X) stage<kCopy>(dst + s * kLanes + k, sc + s * plane + k);
    }
  }
  stage_wait();
  __syncthreads();
  if (x >= X) return;  // no barrier follows

  // The forces epilogue's per-thread constants: the clip bounds, and x's
  // and y's offsets from the impulse.
  float lo[kMaxC], hi[kMaxC];
  float dt = 0.0f, atten = 1.0f, fdx = 0.0f, dxy2 = 0.0f;
  if (forces) {
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      lo[c] = table[5 * (c < C ? c : 0) + 3];
      hi[c] = table[5 * (c < C ? c : 0) + 4];
    }
    dt = scal[1];
    atten = fmaxf(1.0f - fc.dissipation * dt, 0.0f);
    fdx = ((float)x + 0.5f) / (float)X - fc.ip_x;
    const float dy = ((float)y + 0.5f) / (float)Y - fc.ip_y;
    dxy2 = fdx * fdx + dy * dy;
  }
  const float sz = scal[0];
  const float* cell = win + lane;  // [c * planes + z - zlo] * kLanes
  T* o = out + y * X + x;          // [c * vox + z * plane]
  for (int z = z0 + warp; z < zend; z += nw) {
    const Taps t =
        lerp_taps(clamp_disp(cell[(2 * planes + z - zlo) * kLanes], sz, z, Z), z, Z);
    const float* g0 = cell + (t.i0 - zlo) * kLanes;
    const float* g1 = cell + (t.i1 - zlo) * kLanes;
    float basis = 0.0f, ndz = 0.0f;
    if (forces) {
      const float dz = ((float)z + 0.5f) / (float)Z - fc.ip_z;
      const float d2 = dxy2 + dz * dz;
      if (!(d2 > kImpulseFar * fc.radius_sq)) basis = expf(-4.0f * d2 / fc.radius_sq);
      ndz = -dz;
    }
    const bool imp = basis >= 0.01831563889245799f;  // exp(-4)
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c < C) {
        float v = t.w0 * g0[c * planes * kLanes] + t.w1 * g1[c * planes * kLanes];
        if (forces) {
          // in_imp * ext * dt with in_imp in {0, 1}: the term, or nothing.
          if (imp) {
            const float* f = table + 5 * c;  // [A_basis, B_negdz, B_dx, lo, hi]
            v = v + (f[0] * basis + f[1] * ndz + f[2] * fdx) * dt;
          }
          v = fminf(fmaxf(v, lo[c]), hi[c]) * atten;
        }
        st(o, (int64_t)c * vox + z * plane, v);
      }
    }
  }
}

// The per-voxel design B2 replaced, kept as a yardstick
// (fx_advect_z_forces_perthread): one thread a voxel, its two taps read
// from device memory in planes of their own.
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

// ---------------------------------------------------------------------------
// B11: one axis, staged in the storage type.
// ---------------------------------------------------------------------------

// The x pass stages kRowLead columns either side of the ones a CTA owns (a
// multiple of every copy's elements, and at least the taps' reach), each
// channel's row at a pitch that is a multiple of kRowAlign bytes; a CTA is
// at most kRowThreads threads.  A span of columns short of the row is a
// multiple of kRowSpanAlign.
constexpr int kRowLead = 16;
constexpr int kRowAlign = 16;
constexpr int kRowThreads = 256;
constexpr int kRowSpanAlign = 64;

// Bytes between two staged rows of the x pass: the span and its lead
// either side, clipped to the row, rounded up to kRowAlign (csrc and
// ops/cuda/advect.row_pitch agree on this formula).
int row_pitch(int esize, int span, int X) {
  return (min(span + 2 * kRowLead, X) * esize + kRowAlign - 1) / kRowAlign * kRowAlign;
}

// Bytes of the x pass's shared memory: every channel of `tile` rows.
int row_smem(int C, int esize, int tile, int span, int X) {
  return tile * C * row_pitch(esize, span, X);
}

// Bytes of the y or z pass's window: every channel's `cells` cells of a
// strip of kLanes * cols columns.
int strip_smem(int C, int esize, int cols, int cells) { return C * cells * kLanes * cols * esize; }

// B11's launches are programmatic dependent launches: one may be scheduled
// as the CTAs of the kernel before it on the stream exit, before that
// kernel's memory is flushed, and waits here, before its first access to
// device memory, until it is.  The 2D frame's y pass so follows its x pass
// (and the next frame's x pass the kernel before it) without a launch
// gap.  No kernel triggers its dependents early: y-pass CTAs scheduled
// while the x pass still ran landed unevenly on the SMs and were slower.
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// kCols adjacent results at p, rounded to T, as one store.
template <int kCols>
__device__ __forceinline__ void st_cols(__nv_bfloat16* p, const float* v) {
  if constexpr (kCols == 2) {
    *(uint32_t*)p = bf16_bits(v[0]) | (bf16_bits(v[1]) << 16);
  } else {
    st(p, 0, v[0]);
  }
}
template <int kCols>
__device__ __forceinline__ void st_cols(float* p, const float* v) {
  if constexpr (kCols == 2) {
    *(float2*)p = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// The x pass.  CTA (i, j) owns rows [i tile, (i + 1) tile) of the Z * Y
// rows and columns [j span, (j + 1) span) of each, clipped.  It stages
// every channel's columns [x0 - kRowLead, xend + kRowLead) of its rows,
// clipped to the row (the whole row where span = X), with copies of kCopy
// bytes in one batch (thread (t, r) issues copies t, t + blockDim.x, ...
// of channels r, r + blockDim.y, ... of each row: no division); then
// thread (t, r) forms columns x .. x + kCols - 1 of rows r, r +
// blockDim.y, ... from shared memory alone, x = x0 + kCols t, x0 + kCols
// (t + blockDim.x), ....  The scale is loaded before the staging, so its
// latency hides behind it.  32-bit offsets within a channel (Z * Y * X <
// 2^31, the launch checks), the channels' bases in 64 bits.
template <typename T, int kCopy, int kCols>
__global__ void __launch_bounds__(kRowThreads)
    advect_row_kernel(const T* __restrict__ vol, T* __restrict__ out,
                      const float* __restrict__ scale, int disp_ch, int C, int rows_all, int X,
                      int tile, int span, int pitch) {
  extern __shared__ __align__(16) unsigned char smem[];  // [row - r0][channel][column - wlo]
  constexpr int kPer = kCopy / (int)sizeof(T) > 0 ? kCopy / (int)sizeof(T) : 1;
  const int r0 = blockIdx.x * tile;
  const int rows = min(tile, rows_all - r0);
  const int x0 = blockIdx.y * span;
  const int xend = min(x0 + span, X);
  const int wlo = max(x0 - kRowLead, 0);
  const int copies = (min(xend + kRowLead, X) - wlo) / kPer;  // both ends multiples of kPer
  const int vox = rows_all * X;
  griddep_wait();
  const float s = __ldg(scale);  // in flight with the staging, not after it
  for (int r = 0; r < rows; ++r) {
    const T* src = vol + (r0 + r) * X + wlo;
    for (int c = threadIdx.y; c < C; c += blockDim.y) {
      for (int k = threadIdx.x; k < copies; k += blockDim.x) {
        stage<kCopy>(smem + (r * C + c) * pitch + k * kCopy, src + c * (int64_t)vox + k * kPer);
      }
    }
  }
  stage_wait();
  __syncthreads();

  for (int r = threadIdx.y; r < rows; r += blockDim.y) {
    const unsigned char* row = smem + r * C * pitch;
    const T* u = (const T*)(row + disp_ch * pitch);
    T* o = out + (r0 + r) * X;
    for (int x = x0 + kCols * threadIdx.x; x < xend; x += kCols * blockDim.x) {
      Taps t[kCols];
#pragma unroll
      for (int e = 0; e < kCols; ++e) {
        t[e] = lerp_taps(clamp_disp(ld(u, x + e - wlo), s, x + e, X), x + e, X);
      }
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) {
        if (c < C) {
          const T* p = (const T*)(row + c * pitch);
          float v[kCols];
#pragma unroll
          for (int e = 0; e < kCols; ++e) {
            v[e] = t[e].w0 * ld(p, t[e].i0 - wlo) + t[e].w1 * ld(p, t[e].i1 - wlo);
          }
          st_cols<kCols>(o + c * (int64_t)vox + x, v);
        }
      }
    }
  }
}

// The y and z passes: B2's window along the pass's axis, in the storage
// type.  CTA (i, o, k) owns columns [i kStrip, (i + 1) kStrip) of line o
// of the other axis (plane z for the y pass, row y for the z pass; lines
// `outer_stride` elements apart) and cells [k tile, (k + 1) tile) of the
// pass's axis of n cells, `stride` elements apart.  It stages every
// channel's cells [i0 - kHaloLo, iend + kHaloHi) of the strip, clipped to
// the axis, then forms each output from two shared-memory reads a channel,
// one warp a cell of the axis, a lane kCols adjacent columns written as
// one store.  A lane reads only its own columns, which lie in bank `lane`
// of every staged row where a row is 32 words (kCols = 2 at bf16, 1 at
// f32).  Lanes past X compute nothing; copies past X are skipped (the
// rows' alignment puts a copy wholly inside X or wholly past it).
template <typename T, int kCopy, int kCols>
__global__ void __launch_bounds__(kLanes* kMaxWarps)
    advect_strip_kernel(const T* __restrict__ vol, T* __restrict__ out,
                        const float* __restrict__ scale, int disp_ch, int C, int vox, int X,
                        int n, int stride, int outer_stride, int tile) {
  extern __shared__ __align__(16) unsigned char smem[];  // [channel][cell - lo][column - xs]
  constexpr int kStrip = kLanes * kCols;
  constexpr int kRowBytes = kStrip * (int)sizeof(T);
  constexpr int kPer = kCopy / (int)sizeof(T) > 0 ? kCopy / (int)sizeof(T) : 1;
  constexpr int kCopies = kStrip / kPer;  // copies a staged row of a channel
  const int lane = threadIdx.x, warp = threadIdx.y, nw = blockDim.y;
  const int tid = warp * kLanes + lane, nt = nw * kLanes;
  const int xs = blockIdx.x * kStrip;
  const int line = blockIdx.y * outer_stride + xs;  // cell 0 of the strip's first column
  const int i0 = blockIdx.z * tile;
  const int iend = min(i0 + tile, n);
  const int lo = max(i0 - kHaloLo, 0);
  const int cells = min(iend + kHaloHi, n) - lo;
  griddep_wait();
  const float sc = __ldg(scale);  // in flight with the staging, not after it
  for (int c = 0; c < C; ++c) {
    const T* src = vol + c * (int64_t)vox + line + lo * stride;
    unsigned char* dst = smem + c * cells * kRowBytes;
    for (int j = tid; j < cells * kCopies; j += nt) {
      const int s = j / kCopies, k = (j % kCopies) * kPer;
      if (xs + k + kPer <= X) {
        stage<kCopy>(dst + s * kRowBytes + k * (int)sizeof(T), src + s * stride + k);
      }
    }
  }
  stage_wait();
  __syncthreads();
  if (xs + kCols * lane >= X) return;  // no barrier follows

  const unsigned char* col = smem + kCols * lane * (int)sizeof(T);  // [c cells + cell - lo] rows
  T* o = out + line + kCols * lane;
  for (int i = i0 + warp; i < iend; i += nw) {
    const T* u = (const T*)(col + (disp_ch * cells + i - lo) * kRowBytes);
    Taps t[kCols];
#pragma unroll
    for (int e = 0; e < kCols; ++e) t[e] = lerp_taps(clamp_disp(ld(u, e), sc, i, n), i, n);
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c < C) {
        const unsigned char* cc = col + c * cells * kRowBytes;
        float v[kCols];
#pragma unroll
        for (int e = 0; e < kCols; ++e) {
          v[e] = t[e].w0 * ld((const T*)(cc + (t[e].i0 - lo) * kRowBytes), e) +
                 t[e].w1 * ld((const T*)(cc + (t[e].i1 - lo) * kRowBytes), e);
        }
        st_cols<kCols>(o + c * (int64_t)vox + i * stride, v);
      }
    }
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

// Raises a kernel's dynamic shared-memory limit to `smem` where needed.
template <typename K>
cudaError_t allow_smem(K kernel, int smem, int* allowed) {
  if (smem <= *allowed) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) *allowed = smem;
  return err;
}

// What every B1/B2 plan must satisfy: a volume whose offsets within a
// channel fit 32 bits, a CTA of 1..kMaxWarps warps, shared memory a CTA
// can have.
bool window_ok(int C, int Z, int Y, int X, int warps, int smem) {
  return C >= 1 && C <= kMaxC && Z >= 1 && Y >= 1 && X >= 1 &&
         (int64_t)Z * Y * X < (1LL << 31) && warps >= 1 && warps <= kMaxWarps &&
         smem <= kSmemMax;
}

// The widest copy (bytes) every row of an axis of rows `n` elements of
// `esize` bytes from `base` is aligned to, at most 16.
int copy_bytes(const void* base, int n, int esize) {
  int b = 16;
  while (b > esize && (((uintptr_t)base % b) != 0 || ((int64_t)n * esize) % b != 0)) b /= 2;
  return b;
}

template <typename Tin, int kCopy>
cudaError_t launch_xy(const void* vol, void* out, const float* sc, int C, int Z, int Y, int X,
                      int tile_y, int warps, int smem, cudaStream_t s) {
  static int allowed = 48 * 1024;
  cudaError_t err = allow_smem(advect_xy_kernel<Tin, kCopy>, smem, &allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((X + kLanes - 1) / kLanes, (Y + tile_y - 1) / tile_y, Z);
  advect_xy_kernel<Tin, kCopy><<<grid, dim3(kLanes, warps), smem, s>>>(
      (const Tin*)vol, (float*)out, sc, C, Z, Y, X, tile_y);
  return cudaGetLastError();
}

template <typename T, int kCopy>
cudaError_t launch_z(const float* vol, void* out, const float* scal, const float* table,
                     ForceConsts fc, int forces, int C, int Z, int Y, int X, int tile_z,
                     int warps, int smem, cudaStream_t s) {
  static int allowed = 48 * 1024;
  cudaError_t err = allow_smem(advect_z_kernel<T, kCopy>, smem, &allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((X + kLanes - 1) / kLanes, Y, (Z + tile_z - 1) / tile_z);
  advect_z_kernel<T, kCopy><<<grid, dim3(kLanes, warps), smem, s>>>(vol, (T*)out, scal, table,
                                                                     fc, forces, C, Z, Y, X,
                                                                     tile_z);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_z_any(const float* vol, void* out, const float* scal, const float* table,
                         ForceConsts fc, int forces, int C, int Z, int Y, int X, int tile_z,
                         int warps, int smem, cudaStream_t s) {
  switch (copy_bytes(vol, X, 4)) {
    case 16:
      return launch_z<T, 16>(vol, out, scal, table, fc, forces, C, Z, Y, X, tile_z, warps,
                             smem, s);
    case 8:
      return launch_z<T, 8>(vol, out, scal, table, fc, forces, C, Z, Y, X, tile_z, warps, smem,
                            s);
    default:
      return launch_z<T, 4>(vol, out, scal, table, fc, forces, C, Z, Y, X, tile_z, warps, smem,
                            s);
  }
}

// B11's plan as fx_advect_axis takes it (ops/cuda/advect.AxisPlan).
struct AxisPlan {
  int cols, tile, span, bx, by, smem;
};

// `kernel` on `grid` x `block` with `smem` bytes, as a programmatic
// dependent launch (see griddep_wait).
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, dim3 block, int smem,
                             cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename T, int kCopy, int kCols>
cudaError_t launch_axis_pass(const void* vol, void* out, const float* sc, int disp_ch, int axis,
                             int C, int Z, int Y, int X, const AxisPlan& p, cudaStream_t s) {
  const int vox = Z * Y * X;
  if (axis == 2) {
    static int allowed = 48 * 1024;
    cudaError_t err = allow_smem(advect_row_kernel<T, kCopy, kCols>, p.smem, &allowed);
    if (err != cudaSuccess) return err;
    const dim3 grid((Z * Y + p.tile - 1) / p.tile, (X + p.span - 1) / p.span);
    return launch_dependent(advect_row_kernel<T, kCopy, kCols>, grid, dim3(p.bx, p.by), p.smem,
                            s, (const T*)vol, (T*)out, sc, disp_ch, C, Z * Y, X, p.tile, p.span,
                            row_pitch((int)sizeof(T), p.span, X));
  }
  static int allowed = 48 * 1024;
  cudaError_t err = allow_smem(advect_strip_kernel<T, kCopy, kCols>, p.smem, &allowed);
  if (err != cudaSuccess) return err;
  const int n = axis == 1 ? Y : Z;
  const dim3 grid((X + p.span - 1) / p.span, axis == 1 ? Z : Y, (n + p.tile - 1) / p.tile);
  return launch_dependent(advect_strip_kernel<T, kCopy, kCols>, grid, dim3(kLanes, p.by), p.smem,
                          s, (const T*)vol, (T*)out, sc, disp_ch, C, vox, X, n,
                          axis == 1 ? X : Y * X, axis == 1 ? Y * X : X, p.tile);
}

template <typename T, int kCopy>
cudaError_t launch_axis_cols(const void* vol, void* out, const float* sc, int disp_ch, int axis,
                             int C, int Z, int Y, int X, const AxisPlan& p, cudaStream_t s) {
  return p.cols == 2
             ? launch_axis_pass<T, kCopy, 2>(vol, out, sc, disp_ch, axis, C, Z, Y, X, p, s)
             : launch_axis_pass<T, kCopy, 1>(vol, out, sc, disp_ch, axis, C, Z, Y, X, p, s);
}

// What every B11 plan must satisfy: the volume and channels window_ok
// admits, a lane's columns 1 or 2 (2 only on rows of even length), and the
// layout its pass's kernel takes with the shared memory of its tile.
bool axis_ok(int axis, int disp_ch, int C, int Z, int Y, int X, int esize, const AxisPlan& p) {
  if (axis < 0 || axis > 2 || disp_ch < 0 || disp_ch >= C || p.tile < 1 ||
      !(p.cols == 1 || (p.cols == 2 && X % 2 == 0)) || !window_ok(C, Z, Y, X, 1, p.smem)) {
    return false;
  }
  if (axis == 2) {
    return (p.span == X || (p.span > 0 && p.span < X && p.span % kRowSpanAlign == 0)) &&
           (X + p.span - 1) / p.span <= 65535 && p.bx >= 1 && p.by >= 1 &&
           p.bx * p.by <= kRowThreads && p.smem == row_smem(C, esize, p.tile, p.span, X);
  }
  const int n = axis == 1 ? Y : Z;
  return p.span == kLanes * p.cols && p.bx == kLanes && p.by >= 1 && p.by <= kMaxWarps &&
         (axis == 1 ? Z : Y) <= 65535 && (n + p.tile - 1) / p.tile <= 65535 &&
         p.smem == strip_smem(C, esize, p.cols, min(n, p.tile + kHaloLo + kHaloHi));
}

}  // namespace

extern "C" {

// B1, one launch: the x pass of `vol` (storage type) rounded to storage in
// shared memory, then the y pass, its displacement from the x-advected,
// storage-rounded u_y (channel 1), into `out` (f32).  scales = device
// [dt*X, dt*Y].  The plan (ops/cuda/advect.advect_plan): CTAs own tile_y
// rows of a 32-column strip of a plane, `warps` warps each, `smem` bytes of
// tile, which must be the x-pass tile of tile_y rows and their halo.
int fx_advect_xy(const void* vol, void* out, const void* scales, int is_bf16, int C, int Z,
                 int Y, int X, int tile_y, int warps, int smem, void* stream) {
  if (C < 2 || tile_y < 1 || !window_ok(C, Z, Y, X, warps, smem) || Z > 65535 ||
      (Y + tile_y - 1) / tile_y > 65535 ||
      smem != xy_smem(C, is_bf16 != 0, min(Y, tile_y + kHaloLo + kHaloHi))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const float* sc = (const float*)scales;
  if (is_bf16) {
    switch (copy_bytes(vol, X, 2)) {
      case 16:
        return (int)launch_xy<__nv_bfloat16, 16>(vol, out, sc, C, Z, Y, X, tile_y, warps, smem,
                                                 s);
      case 8:
      case 4:
        return (int)launch_xy<__nv_bfloat16, 4>(vol, out, sc, C, Z, Y, X, tile_y, warps, smem,
                                                s);
      default:
        return (int)launch_xy<__nv_bfloat16, 2>(vol, out, sc, C, Z, Y, X, tile_y, warps, smem,
                                                s);
    }
  }
  return copy_bytes(vol, X, 4) == 16
             ? (int)launch_xy<float, 16>(vol, out, sc, C, Z, Y, X, tile_y, warps, smem, s)
             : (int)launch_xy<float, 4>(vol, out, sc, C, Z, Y, X, tile_y, warps, smem, s);
}

// B1 as it ran before: x pass into `tmp` (storage type), then y pass into
// `out` (f32), two launches of advect_axis_kernel.  A yardstick only.
int fx_advect_xy_perthread(const void* vol, void* tmp, void* out, const void* scales,
                           int is_bf16, int C, int Z, int Y, int X, void* stream) {
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
// type.  scale = device [dt * N].  The plan (ops/cuda/advect.axis_plan):
// `cols` columns a thread; the x pass CTAs of bx x by threads owning
// `tile` rows and `span` columns of each; the y and z passes CTAs of by
// warps owning a strip of `span` = 32 cols columns and `tile` cells of the
// axis; `smem` bytes, which must be the tile's.
int fx_advect_axis(const void* vol, void* out, const void* scale, int disp_ch, int axis,
                   int is_bf16, int C, int Z, int Y, int X, int cols, int tile, int span,
                   int bx, int by, int smem, void* stream) {
  const AxisPlan p{cols, tile, span, bx, by, smem};
  if (!axis_ok(axis, disp_ch, C, Z, Y, X, is_bf16 ? 2 : 4, p)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const float* sc = (const float*)scale;
  if (is_bf16) {
    switch (copy_bytes(vol, X, 2)) {
      case 16:
        return (int)launch_axis_cols<__nv_bfloat16, 16>(vol, out, sc, disp_ch, axis, C, Z, Y, X,
                                                        p, s);
      case 8:
      case 4:
        return (int)launch_axis_cols<__nv_bfloat16, 4>(vol, out, sc, disp_ch, axis, C, Z, Y, X,
                                                       p, s);
      default:
        return (int)launch_axis_cols<__nv_bfloat16, 2>(vol, out, sc, disp_ch, axis, C, Z, Y, X,
                                                       p, s);
    }
  }
  return copy_bytes(vol, X, 4) == 16
             ? (int)launch_axis_cols<float, 16>(vol, out, sc, disp_ch, axis, C, Z, Y, X, p, s)
             : (int)launch_axis_cols<float, 4>(vol, out, sc, disp_ch, axis, C, Z, Y, X, p, s);
}

// B11 as it ran before, one thread a voxel (advect_axis_kernel).  A
// yardstick only.
int fx_advect_axis_perthread(const void* vol, void* out, const void* scale, int disp_ch,
                             int axis, int is_bf16, int C, int Z, int Y, int X, void* stream) {
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
// without `forces`: that is B12, replacing _zpass_kernel.  The plan
// (ops/cuda/advect.advect_plan): CTAs own tile_z planes of a 32-column
// strip of one row, `warps` warps each, and `smem` bytes, which must be
// every channel's window of those planes and their halo.
int fx_advect_z_forces(const void* vol, void* out, const void* scal, const void* table,
                       float ip_x, float ip_y, float ip_z, float radius_sq,
                       float dissipation, int forces, int is_bf16, int C, int Z, int Y,
                       int X, int tile_z, int warps, int smem, void* stream) {
  if (C < 3 || tile_z < 1 || !window_ok(C, Z, Y, X, warps, smem) ||
      (forces && table == nullptr) || Y > 65535 || (Z + tile_z - 1) / tile_z > 65535 ||
      smem != z_smem(C, min(Z, tile_z + kHaloLo + kHaloHi))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const ForceConsts fc{ip_x, ip_y, ip_z, radius_sq, dissipation};
  const float* v = (const float*)vol;
  const float* sc = (const float*)scal;
  const float* tb = (const float*)table;
  return (int)(is_bf16 ? launch_z_any<__nv_bfloat16>(v, out, sc, tb, fc, forces, C, Z, Y, X,
                                                     tile_z, warps, smem, s)
                       : launch_z_any<float>(v, out, sc, tb, fc, forces, C, Z, Y, X, tile_z,
                                             warps, smem, s));
}

// B2 as it ran before, one thread a voxel.  A yardstick only.
int fx_advect_z_forces_perthread(const void* vol, void* out, const void* scal,
                                 const void* table, float ip_x, float ip_y, float ip_z,
                                 float radius_sq, float dissipation, int forces, int is_bf16,
                                 int C, int Z, int Y, int X, void* stream) {
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
