// The adjoints of the faithful stack's marches for Hopper: R1b (R1 in
// separate-light mode) and R2b (R2 without the light probe), the backward
// kernels of ops/cuda/raymarch.py's autograd Functions.
//
// These replace no TPU kernel.  The JAX package differentiates the faithful
// stack with jax.grad, which transposes the XLA scans that R1 and R2
// replace: raymarch_core.view_march (:337) and lightmap.render_light_map
// (:36).  As plain PyTorch autograd the same walk keeps every step's
// tensors of every ray (some 450 bytes a ray a step: about 55 GB at 800^2
// rays and 192 steps).
//
//   fx_view_march_grad (R1b): from the cotangent of R1's (N, 4) output, the
//     cotangents of the (4, Z, Y, X) colour grid and of the (3, Z', Y', X')
//     light map, through the sampled values and through the sample
//     positions, which the densities move by the adaptive step.
//   fx_light_march_grad (R2b): from the cotangent of R2's (3, Z, Y, X) light
//     map, the cotangent of the grid's density channel: each dense voxel's
//     shadow ray, light colour * shadow + ambient, shadow its transmittance.
//
// A ray (R1b) or a dense voxel's shadow ray (R2b) is run again with R1's or
// R2's own code (raymarch.cuh, both files built with --fmad=false), so
// every branch it takes is the forward's: the +-0 skip, the threshold
// tests, the opacity or transmittance early-out, t_max, the box's edge and
// the sample count.  At each sample that counts (R1: a dense view sample;
// R2: every light sample) it appends to its tape slot the sample's t, the
// opacity (R1) or transmittance (R2) before it and the density of the
// counted sample before (prev).  Then it walks the entries in reverse,
// carrying the adjoints of t, of the opacity or transmittance and of prev,
// loads the sample's 8 CLAMP taps again, forms the lerps' adjoints and adds
// each tap's cotangent to the output by f32 atomicAdd (their order varies
// from run to run, so results agree with autograd to rounding, not bit for
// bit).  Samples that do not count pass the adjoints on unchanged.
//
// The derivative rules are torch's, as autograd applies them to the plain
// versions (render/raymarch_core.view_march, render/lightmap.light_map_plain)
// that these kernels are held to: clamp_min and clamp_max pass the gradient
// where their input equals the bound, abs has derivative 0 at 0, a where()
// sends it down the branch taken, floor passes none (the corners carry no
// gradient; the fractions carry it to t).  tests/test_torch_adjoint_walk.py
// models both walks in torch, tests/test_torch_adjoint_plan.py these
// kernels' schedules and tape slots.
//
// Bound: a sample's work is a chain of dependent gathers and some hundreds
// of f32 operations (the 7 or 1 channels' lerps, their adjoints, the step's
// adjoint), and 56 or 8 f32 atomics; at ADJOINT's shapes the atomics, not
// the grid's bytes, set much of the pace (PERF.md).  What the first design
// (one thread a ray or voxel in storage order, a tape slot of max samples
// for every ray or voxel; kept as fx_view_march_grad_perthread and
// fx_light_march_grad_perthread, the yardsticks, sharing replay_view,
// walk_view and walk_light, with kFirst's walk, with the new kernels) left,
// and what this design does about it:
//
//   - Tapes for every ray: 1.47 GB at 800^2 rays, 1.61 GB for R2b at 128^3.
//     A tape slot now belongs to a resident lane of a persistent launch: a
//     lane runs its ray again into its slot, walks it back and only then
//     takes the next, so the scratch is max samples x the lanes the launch
//     runs (tape_floats; the wrapper sizes it with the same formula,
//     raymarch.grad_tape_floats, and the launch refuses less), about 100 MB.
//   - No compaction.  light_grad_brick_kernel's warps take R2's bricks (32 x
//     by x bz voxels, `light_grad_plan`) in a stride of the launch's warps,
//     test each voxel's shadow cotangent and density as R2 does, queue by
//     ballot the dense voxels whose cotangent is not 0 in a queue of their
//     own and walk it 32 voxels at a time, with no barrier between warps.
//     view_grad_fetch_kernel's persistent warps fetch tiles of rays
//     (`view_grad_plan`: 32 x 1, whose lanes' atomics meet less than 8 x
//     4's) from a counter of their own (R1 and R1b on one stream never
//     share one; the CTA that finishes last resets it, as R1's does) and
//     skip inactive rays and rays whose cotangent is 0 at the fetch.
//   - Atomics and latency.  The new kernels' lanes walk in step by entry
//     (kLined), loading each entry one ahead; R2b's lanes (x-neighbouring
//     voxels' parallel shadow rays, one voxel apart at one t) and, where
//     rays are dense on the grid (raymarch.view_grad_merges), R1b's merge
//     what they add to one offset before the atomics (Scatter).
//   - Registers: launch bounds of 4 CTAs an SM for both; R1b's walk keeps a
//     sample's 56 taps in flight at once (loading them channel by channel,
//     to save registers, serialised their latencies and lost).
//   - A per-sample shadow ray (the merged march's adjoint) would nest in the
//     view walk as a second region of the lane's slot, run again and walked
//     back inside the sample's adjoint.
#include <type_traits>

#include "raymarch.cuh"

namespace {

constexpr int kGradThreads = 128;      // the per-thread designs' CTA
constexpr int kViewGradThreads = 128;  // R1b's CTA
constexpr int kLightGradWarps = 8;     // R2b's CTA at most
constexpr int kViewGradCtas = 4;       // R1b's CTAs an SM at least: its registers' cap
constexpr int kLightGradCtas = 4;      // R2b's CTAs an SM at least: its registers' cap
constexpr int kMaxWarpRows = 8;        // R2b's brick: by * bz at most, a warp's
constexpr int kWarpQueue = 32 * (kMaxWarpRows + 1);  // a warp's queue: 31 + a brick
constexpr int kTapeFloats = 3;         // a tape entry: t, the opacity or transmittance, prev

// R1b's next slot and its CTAs finished, reset by the CTA that finishes
// last.
__device__ unsigned long long g_view_grad_fetch[2];

// A tape of n slots: slot r's entry j holds its three values, (t, opacity
// or transmittance, prev), at p[(3 j + k) n + r], so a warp's entries are
// coalesced.  The per-thread designs take a slot a ray or voxel, the new
// ones a slot a resident lane.
struct Tape {
  float* p;
  int64_t n;

  __device__ __forceinline__ void put(int64_t r, int j, float a, float b, float c) const {
    float* q = p + (int64_t)3 * j * n + r;
    q[0] = a;
    q[n] = b;
    q[2 * n] = c;
  }
  __device__ __forceinline__ void get(int64_t r, int j, float& a, float& b, float& c) const {
    const float* q = p + (int64_t)3 * j * n + r;
    a = q[0];
    b = q[n];
    c = q[2 * n];
  }
};

// The adjoint of lerp_taps for the value's cotangent g: each tap's cotangent
// into w, the fractions' (x, y, z) added to gf.
__device__ __forceinline__ void lerp_taps_grad(const float v[8], float fx, float fy, float fz,
                                               float g, float w[8], float gf[3]) {
  const float c00 = v[0] + (v[1] - v[0]) * fx;
  const float c01 = v[2] + (v[3] - v[2]) * fx;
  const float c10 = v[4] + (v[5] - v[4]) * fx;
  const float c11 = v[6] + (v[7] - v[6]) * fx;
  const float c0 = c00 + (c01 - c00) * fy;
  const float c1 = c10 + (c11 - c10) * fy;
  gf[2] = gf[2] + g * (c1 - c0);
  const float g1 = g * fz, g0 = g - g1;
  gf[1] = gf[1] + (g0 * (c01 - c00) + g1 * (c11 - c10));
  const float g01 = g0 * fy, g00 = g0 - g01, g11 = g1 * fy, g10 = g1 - g11;
  gf[0] = gf[0] + (((g00 * (v[1] - v[0]) + g01 * (v[3] - v[2])) + g10 * (v[5] - v[4])) +
                   g11 * (v[7] - v[6]));
  const float gc[4] = {g00, g01, g10, g11};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w[2 * k + 1] = gc[k] * fx;
    w[2 * k] = gc[k] - w[2 * k + 1];
  }
}

// How a walk adds its taps' cotangents (scatter8): one atomicAdd a tap
// (kAtomics); or the lanes of `act` (those at this entry, all of which
// call it) first merge what they add to one offset, so fewer atomics reach
// L2 with the same sums: a lane takes in, at each of its +x
// corners, the -x corner of the lane after it (kShiftX: R2b, the rays of
// x-neighbouring voxels one voxel apart at one t), or, in two rounds, lane
// 2 i takes in lane 2 i + 1's corners at the same offset and lane 4 i lane
// 4 i + 2's (kTree: R1b, neighbouring rays through one cell).  The lanes
// that give leave those out.
enum Scatter { kAtomics = 0, kShiftX = 1, kTree = 2 };

template <int kScatter = kAtomics, typename I>
__device__ __forceinline__ void scatter8(float* ch, const Corners<I>& c, const float w[8],
                                         unsigned act) {
  if constexpr (kScatter == kShiftX) {
    const int lane = threadIdx.x % 32;
    const bool right = lane < 31 && ((act >> (lane + 1)) & 1);
    const bool left = lane > 0 && ((act >> (lane - 1)) & 1);
    unsigned took = 0;  // bit m: this lane took in the next lane's corner 2 m
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const I o2 = __shfl_down_sync(act, c.o[2 * m], 1);
      const float w2 = __shfl_down_sync(act, w[2 * m], 1);
      float v = w[2 * m + 1];
      if (right && o2 == c.o[2 * m + 1]) {
        v = v + w2;
        took |= 1u << m;
      }
      atomicAdd(ch + c.o[2 * m + 1], v);
    }
    const unsigned given = __shfl_up_sync(act, took, 1);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (!(left && ((given >> m) & 1))) atomicAdd(ch + c.o[2 * m], w[2 * m]);
    }
  } else if constexpr (kScatter == kTree) {
    const int lane = threadIdx.x % 32;
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = w[k];
    unsigned gone = 0;  // the corners this lane gave away
#pragma unroll
    for (int d = 1; d <= 2; d <<= 1) {
      const bool takes = (lane & (2 * d - 1)) == 0 && lane + d < 32 && ((act >> (lane + d)) & 1);
      const bool gives = (lane & (2 * d - 1)) == d && ((act >> (lane - d)) & 1);
      unsigned took = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const I o2 = __shfl_down_sync(act, c.o[k], d);
        const float w2 = __shfl_down_sync(act, v[k], d);
        if (takes && o2 == c.o[k]) {
          v[k] = v[k] + w2;
          took |= 1u << k;
        }
      }
      const unsigned given = __shfl_up_sync(act, took, d);
      if (gives) gone = given;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (!((gone >> k) & 1)) atomicAdd(ch + c.o[k], v[k]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) atomicAdd(ch + c.o[k], w[k]);
  }
}

// The walks: the first design's (kFirst), or the new kernels' (kLined,
// kMerged), whose lanes walk in step by entry, a lane starting at its
// last, so neighbouring rays sit at one t where their steps agree, with
// the next entry loaded ahead; kMerged merges the atomics (Scatter).  The
// lanes that walk in step are named by the caller (`walking`, a ballot
// taken before the walk), not read from __activemask(): after the replay's
// early exits the warp need not have converged.
enum Walk { kFirst = 0, kLined = 1, kMerged = 2 };

// The adjoint of get_step for the step's cotangent g: adds to the cotangents
// of dd, transm and density.  The step is scale * clamp_min(((1.5 fe) fu) ft,
// 1), fe = (1/256) / clamp_min(|dd|, 1/512), fu = clamp_max(1 - density, 1),
// ft = 1 - transm (raymarch_core.get_step).
__device__ __forceinline__ void get_step_grad(float dd, float transm, float density, float scale,
                                              float g, float& g_dd, float& g_transm,
                                              float& g_density) {
  const float ad = fabsf(dd);
  const float den = fmaxf(ad, 1.0f / 512.0f);
  const float fe = (1.0f / 256.0f) / den;
  const float fu = fminf(1.0f - density, 1.0f);
  const float ft = 1.0f - transm;
  const float p1 = 1.5f * fe, p2 = p1 * fu;
  if (!(p2 * ft >= 1.0f) || g == 0.0f) return;
  const float gx = g * scale;
  const float g_p2 = gx * ft;
  g_transm = g_transm - gx * p2;
  if (1.0f - density <= 1.0f) g_density = g_density - g_p2 * p1;
  if (ad >= 1.0f / 512.0f) {
    const float g_ad = -((g_p2 * fu) * 1.5f) * (fe / den);
    g_dd = g_dd + (dd > 0.0f ? g_ad : (dd < 0.0f ? -g_ad : 0.0f));
  }
}

// ---------------------------------------------------------------------------
// A view ray and a shadow ray, run again and walked back
// ---------------------------------------------------------------------------

struct ViewGrad {
  ViewArgs a;          // R1's arguments (separate mode; its out unused)
  const float* g_out;  // (N, 4) the cotangent of R1's output
  float* g_chan[4];    // the grid's cotangent, f32 (4, Z, Y, X), by channel
  float* g_lm[3];      // the light map's, f32 (3, Z', Y', X'), by channel
  Tape tape;           // max_ray entries a slot
  int* samples;        // (N, 2) view samples run again and dense ones walked, or null
};

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ Ray ray_of(const ViewArgs& a, int64_t r) {
  const int64_t r3 = 3 * r;
  return Ray{a.origin[r3], a.origin[r3 + 1], a.origin[r3 + 2],
             a.dir[r3],    a.dir[r3 + 1],    a.dir[r3 + 2]};
}

// Ray r's march again (march_ray's, separate mode) into tape slot `slot`,
// an entry (t, opacity, prev) per dense sample; returns the dense samples
// and adds the view samples to `views`.
template <typename T, typename I>
__device__ __forceinline__ int replay_view(const ViewGrad& b, int64_t r, int64_t slot, int num,
                                           float step_scale, int& views) {
  const T* const dens = (const T*)b.a.chan[3];
  const float absorb = b.a.m.absorb, zero = b.a.m.zero;
  const Ray q = ray_of(b.a, r);
  const float t_max = b.a.t_max[r];
  int hits = 0;
  float t = 0.0f, prev = 0.0f, sa = 0.0f;
  for (int i = 0; i < b.a.max_ray && i < num; ++i) {
    const float px = q.ox + q.dx * t, py = q.oy + q.dy * t, pz = q.oz + q.dz * t;
    if (!inside(px, py, pz)) break;
    ++views;
    const Corners<I> c = corners<I, true>(to_tex(px), to_tex(py), to_tex(pz), b.a.g);
    const float ca = lerp8_or_zero(dens, c);
    float step = step_scale;
    if (ca > zero) {
      b.tape.put(slot, hits++, t, sa, prev);
      const float transm = 1.0f - sa;
      step = get_step(ca - prev, transm, ca, step_scale);
      sa = sa + ca * (absorb * transm);
      if (1.0f - sa < zero) break;
      prev = ca;
    }
    const float t_new = t + step;
    if (!(t_new <= t_max)) break;
    t = t_new;
  }
  return hits;
}

// Ray r's `hits` entries in tape slot `slot` walked back with the
// cotangent go of its output: a_t, a_sa and a_prev are the adjoints of t,
// the opacity and prev after the entry; the rgb sums' are constant.  A
// sample's 56 taps are loaded at once.  A per-sample shadow ray (the merged
// march's adjoint) would nest here: run again into a second region of the
// slot and walked back inside the sample's adjoint.  `walking`: the warp's
// lanes that call this (kLined, kMerged).
template <typename T, typename I, int kWalk>
__device__ __forceinline__ void walk_view(const ViewGrad& b, int64_t r, int64_t slot, int hits,
                                          float4 go, float step_scale, unsigned walking = kFull) {
  constexpr int kScatter = kWalk == kMerged ? kTree : kAtomics;
  const T* const ch[4] = {(const T*)b.a.chan[0], (const T*)b.a.chan[1], (const T*)b.a.chan[2],
                          (const T*)b.a.chan[3]};
  const float absorb = b.a.m.absorb;
  const bool premultiplied = b.a.m.flags & kPremultiplied;
  const Ray q = ray_of(b.a, r);
  const float gs[3] = {go.x * kInv2Pi, go.y * kInv2Pi, go.z * kInv2Pi};
  float a_t = 0.0f, a_sa = go.w, a_prev = 0.0f;
  if (kWalk != kFirst) __syncwarp(walking);
  const int top = kWalk == kFirst ? hits : (int)__reduce_max_sync(walking, (unsigned)hits);
  float tj = 0.0f, sa_j = 0.0f, prev_j = 0.0f;
  if (kWalk != kFirst && hits > 0) b.tape.get(slot, hits - 1, tj, sa_j, prev_j);
  for (int j = top - 1; j >= 0; --j) {
    const unsigned act = kWalk == kFirst ? 0u : __ballot_sync(walking, j < hits);
    if (j >= hits) continue;
    float tn = 0.0f, sa_n = 0.0f, prev_n = 0.0f;  // the entry before, loaded ahead
    if (kWalk == kFirst) {
      b.tape.get(slot, j, tj, sa_j, prev_j);
    } else if (j > 0) {
      b.tape.get(slot, j - 1, tn, sa_n, prev_n);
    }
    const float u = to_tex(q.ox + q.dx * tj), v = to_tex(q.oy + q.dy * tj);
    const float w = to_tex(q.oz + q.dz * tj);
    const Corners<I> c = corners<I, true>(u, v, w, b.a.g);
    const Corners<I> lc = corners<I, true>(u, v, w, b.a.lm);
    float tap[4][8], lt[3][8];
#pragma unroll
    for (int k = 0; k < 4; ++k) load8(tap[k], ch[k], c);
#pragma unroll
    for (int k = 0; k < 3; ++k) load8(lt[k], b.a.lm_chan[k], lc);
    const float ca = lerp_taps(tap[3], c.fx, c.fy, c.fz);
    float col[3], light[3], e[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      col[k] = lerp_taps(tap[k], c.fx, c.fy, c.fz);
      light[k] = lerp_taps(lt[k], lc.fx, lc.fy, lc.fz);
      e[k] = premultiplied ? col[k] : col[k] * ca;
    }
    const float transm = 1.0f - sa_j;
    const float kk = absorb * transm;
    // s_rgb += (e * light) * kk; sa += ca * kk; prev = ca.
    float g_e[3], g_l[3], g_k = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float gp = gs[k] * kk;
      g_e[k] = gp * light[k];
      g_l[k] = gp * e[k];
      g_k = g_k + gs[k] * (e[k] * light[k]);
    }
    g_k = g_k + a_sa * ca;
    float g_ca = a_sa * kk + a_prev;
    float g_col[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (premultiplied) {
        g_col[k] = g_e[k];
      } else {
        g_col[k] = g_e[k] * ca;
        g_ca = g_ca + g_e[k] * col[k];
      }
    }
    // The step reaches the next t: its cotangent is a_t.
    float g_dd = 0.0f, g_transm = 0.0f, g_dens = 0.0f;
    get_step_grad(ca - prev_j, transm, ca, step_scale, a_t, g_dd, g_transm, g_dens);
    g_transm = g_transm + g_k * absorb;
    g_ca = g_ca + g_dens + g_dd;
    float gf[3] = {0.0f, 0.0f, 0.0f}, lf[3] = {0.0f, 0.0f, 0.0f}, wt[8];
    lerp_taps_grad(tap[3], c.fx, c.fy, c.fz, g_ca, wt, gf);
    scatter8<kScatter>(b.g_chan[3], c, wt, act);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      lerp_taps_grad(tap[k], c.fx, c.fy, c.fz, g_col[k], wt, gf);
      scatter8<kScatter>(b.g_chan[k], c, wt, act);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      lerp_taps_grad(lt[k], lc.fx, lc.fy, lc.fz, g_l[k], wt, lf);
      scatter8<kScatter>(b.g_lm[k], lc, wt, act);
    }
    // t moves uvw = (o + d t) / 2 + 1/2, and uvw the fractions by the extents.
    const float gpx = (gf[0] * b.a.g.fx + lf[0] * b.a.lm.fx) * 0.5f;
    const float gpy = (gf[1] * b.a.g.fy + lf[1] * b.a.lm.fy) * 0.5f;
    const float gpz = (gf[2] * b.a.g.fz + lf[2] * b.a.lm.fz) * 0.5f;
    a_t = a_t + ((gpx * q.dx + gpy * q.dy) + gpz * q.dz);
    a_sa = a_sa - g_transm;
    a_prev = -g_dd;
    tj = tn;
    sa_j = sa_n;
    prev_j = prev_n;
  }
}

struct LightGrad {
  LightArgs a;         // R2's arguments (no probe; its out unused)
  const float* g_out;  // (3, Z, Y, X) the cotangent of R2's light map
  float* g_dens;       // the density channel's cotangent, f32 (Z, Y, X)
  Tape tape;           // max_light entries a slot
  int* samples;        // (Z * Y * X,) light samples walked, or null
};

// The shadow's cotangent of voxel i: light = light_color * shadow + ambient.
__device__ __forceinline__ float shadow_cotangent(const LightGrad& b, int64_t i) {
  const float* env = b.a.m.env;
  const int64_t plane = b.a.g.plane;
  return (b.g_out[i] * env[kColor] + b.g_out[plane + i] * env[kColor + 1]) +
         b.g_out[2 * plane + i] * env[kColor + 2];
}

// The shadow ray of dense voxel (x, y, z) with the shadow's cotangent
// g_shadow (put_light's forward: cast_light_ray with kLean) run again into
// tape slot `slot`, an entry (t, transmittance, prev) per sample, and
// walked back: a_T, a_t and a_prev are the adjoints of the transmittance, t
// and prev after the entry.  Returns the samples.  `walking`: the warp's
// lanes that call this (kLined, kMerged).
template <typename T, typename I, int kWalk>
__device__ __forceinline__ int walk_light(const LightGrad& b, int x, int y, int z, float g_shadow,
                                          int64_t slot, int num, float light_step,
                                          unsigned walking = kFull) {
  const T* const dens = (const T*)b.a.chan[3];
  const float* env = b.a.m.env;
  const float absorb = b.a.m.absorb, zero = b.a.m.zero;
  float px, py, pz;
  centre(x, y, z, b.a.g, px, py, pz);
  float lx = env[kDir], ly = env[kDir + 1], lz = env[kDir + 2];
  if (b.a.m.flags & kPointLight) {
    const float ex = env[kPos] - px, ey = env[kPos + 1] - py, ez = env[kPos + 2] - pz;
    const float n = fmaxf(norm3(ex, ey, ez), 1e-12f);
    lx = ex / n; ly = ey / n; lz = ez / n;
  }
  int taken = 0;
  float t = light_step, transm = 1.0f, prev = 0.0f;
  if (transm >= zero) {
    for (int s = 0; s < b.a.m.max_light && s < num; ++s) {
      const float qx = px + lx * t, qy = py + ly * t, qz = pz + lz * t;
      if (!inside(qx, qy, qz)) break;
      b.tape.put(slot, taken++, t, transm, prev);
      const Corners<I> c = corners<I, true>(to_tex(qx), to_tex(qy), to_tex(qz), b.a.g);
      const float d = lerp8_or_zero(dens, c);
      const float step = get_step(d - prev, transm, d, light_step);
      transm = transm * (1.0f - d * absorb);
      if (!(transm >= zero)) break;
      t = t + step;
      prev = d;
    }
  }
  constexpr int kScatter = kWalk == kMerged ? kShiftX : kAtomics;
  float a_T = g_shadow, a_t = 0.0f, a_prev = 0.0f;
  if (kWalk != kFirst) __syncwarp(walking);
  const int top = kWalk == kFirst ? taken : (int)__reduce_max_sync(walking, (unsigned)taken);
  float tj = 0.0f, transm_j = 0.0f, prev_j = 0.0f;
  if (kWalk != kFirst && taken > 0) b.tape.get(slot, taken - 1, tj, transm_j, prev_j);
  for (int j = top - 1; j >= 0; --j) {
    const unsigned act = kWalk == kFirst ? 0u : __ballot_sync(walking, j < taken);
    if (j >= taken) continue;
    float tn = 0.0f, transm_n = 0.0f, prev_n = 0.0f;  // the entry before, loaded ahead
    if (kWalk == kFirst) {
      b.tape.get(slot, j, tj, transm_j, prev_j);
    } else if (j > 0) {
      b.tape.get(slot, j - 1, tn, transm_n, prev_n);
    }
    const Corners<I> c =
        corners<I, true>(to_tex(px + lx * tj), to_tex(py + ly * tj), to_tex(pz + lz * tj), b.a.g);
    float v[8];
    load8(v, dens, c);
    const float s = lerp_taps(v, c.fx, c.fy, c.fz);
    // transm' = transm * (1 - s absorb); t' = t + step; prev' = s.
    float g_T = a_T * (1.0f - s * absorb);
    float g_s = -(a_T * transm_j) * absorb + a_prev;
    float g_dd = 0.0f, g_tr = 0.0f, g_sd = 0.0f;
    get_step_grad(s - prev_j, transm_j, s, light_step, a_t, g_dd, g_tr, g_sd);
    g_T = g_T + g_tr;
    g_s = g_s + g_sd + g_dd;
    float gf[3] = {0.0f, 0.0f, 0.0f}, wt[8];
    lerp_taps_grad(v, c.fx, c.fy, c.fz, g_s, wt, gf);
    scatter8<kScatter>(b.g_dens, c, wt, act);
    const float gpx = (gf[0] * b.a.g.fx) * 0.5f, gpy = (gf[1] * b.a.g.fy) * 0.5f;
    const float gpz = (gf[2] * b.a.g.fz) * 0.5f;
    a_t = a_t + ((gpx * lx + gpy * ly) + gpz * lz);
    a_T = g_T;
    a_prev = -g_dd;
    tj = tn;
    transm_j = transm_n;
    prev_j = prev_n;
  }
  return taken;
}

// ---------------------------------------------------------------------------
// The first design, one thread a ray or a voxel: the yardsticks
// ---------------------------------------------------------------------------

// R1b's first design: a thread a ray in storage order, its own tape slot.
template <typename T, typename I>
__global__ void __launch_bounds__(kGradThreads) view_grad_perthread_kernel(ViewGrad b) {
  const int64_t r = (int64_t)blockIdx.x * kGradThreads + threadIdx.x;
  if (r >= b.a.n) return;
  const int num = *b.a.num_samples;
  const float step_scale = kMaxDist / (float)num;
  int views = 0, hits = 0;
  const float4 go = reinterpret_cast<const float4*>(b.g_out)[r];
  if (b.a.active[r] && (go.x != 0.0f || go.y != 0.0f || go.z != 0.0f || go.w != 0.0f)) {
    hits = replay_view<T, I>(b, r, r, num, step_scale, views);
    walk_view<T, I, kFirst>(b, r, r, hits, go, step_scale);
  }
  if (b.samples != nullptr) {
    b.samples[2 * r] = views;
    b.samples[2 * r + 1] = hits;
  }
}

// R2b's first design: a thread a voxel, its own tape slot.
template <typename T, typename I>
__global__ void __launch_bounds__(kGradThreads) light_grad_perthread_kernel(LightGrad b) {
  const int64_t i = (int64_t)blockIdx.x * kGradThreads + threadIdx.x;
  if (i >= b.a.g.plane) return;
  const T* const dens = (const T*)b.a.chan[3];
  const int num = *b.a.num_light_samples;
  const float light_step = kMaxDist / (float)num;
  int taken = 0;
  const float g_shadow = shadow_cotangent(b, i);
  if (g_shadow != 0.0f) {
    const int x = (int)(i % b.a.g.nx), y = (int)((i / b.a.g.nx) % b.a.g.ny);
    const int z = (int)(i / ((int64_t)b.a.g.nx * b.a.g.ny));
    float px, py, pz;
    centre(x, y, z, b.a.g, px, py, pz);
    if (lerp8_or_zero(dens, corners<I, true>(to_tex(px), to_tex(py), to_tex(pz), b.a.g)) >=
        b.a.m.zero) {
      taken = walk_light<T, I, kFirst>(b, x, y, z, g_shadow, i, num, light_step);
    }
  }
  if (b.samples != nullptr) b.samples[i] = taken;
}

// ---------------------------------------------------------------------------
// R1b: persistent warps on R1's tiles, a tape slot a lane
// ---------------------------------------------------------------------------

// R1b: persistent warps that fetch rays by tiles, as view_fetch_kernel
// does, from a counter of their own; a lane skips, at the fetch, rays that
// are inactive or whose cotangent is 0 (writing their sample counts as 0)
// and draws again; then each lane runs its ray again into its tape slot
// and walks it back (kMerge: kMerged's walk, else kLined's).
template <typename T, typename I, bool kMerge>
__global__ void __launch_bounds__(kViewGradThreads, kViewGradCtas)
    view_grad_fetch_kernel(ViewGrad b, Tiles p) {
  const int lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;
  const int64_t slot = (int64_t)blockIdx.x * kViewGradThreads + threadIdx.x;
  const int num = *b.a.num_samples;
  const float step_scale = kMaxDist / (float)num;
  for (;;) {
    int r = -1;
    float4 go = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (;;) {
      const unsigned idle = __ballot_sync(kFull, r < 0);
      if (idle == 0) break;
      unsigned long long base = 0;
      if (lane == 0) base = atomicAdd(&g_view_grad_fetch[0], (unsigned long long)__popc(idle));
      base = __shfl_sync(kFull, base, 0);
      if (base >= (unsigned long long)p.slots) break;
      const unsigned long long s = base + __popc(idle & below);
      if (r < 0 && s < (unsigned long long)p.slots) {
        const int q = ray_of_slot((int)s, p);
        if (q >= 0) {
          const float4 g = reinterpret_cast<const float4*>(b.g_out)[q];
          if (b.a.active[q] && (g.x != 0.0f || g.y != 0.0f || g.z != 0.0f || g.w != 0.0f)) {
            r = q;
            go = g;
          } else if (b.samples != nullptr) {
            b.samples[2 * (int64_t)q] = 0;
            b.samples[2 * (int64_t)q + 1] = 0;
          }
        }
      }
    }
    const unsigned walking = __ballot_sync(kFull, r >= 0);
    if (walking == 0) break;
    if (r >= 0) {
      int views = 0;
      const int hits = replay_view<T, I>(b, r, slot, num, step_scale, views);
      walk_view<T, I, kMerge ? kMerged : kLined>(b, r, slot, hits, go, step_scale, walking);
      if (b.samples != nullptr) {
        b.samples[2 * (int64_t)r] = views;
        b.samples[2 * (int64_t)r + 1] = hits;
      }
    }
  }
  // Every warp of this CTA is past its last fetch; the last CTA to get here
  // resets the counter for the next launch.
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(&g_view_grad_fetch[1], 1ull) == (unsigned long long)gridDim.x - 1) {
      atomicExch(&g_view_grad_fetch[0], 0ull);
      atomicExch(&g_view_grad_fetch[1], 0ull);
    }
  }
}

// ---------------------------------------------------------------------------
// R2b: persistent warps on bricks, a queue of dense voxels a warp, a tape
// slot a lane
// ---------------------------------------------------------------------------

// R2b: persistent warps, each taking bricks of 32 x by x bz voxels (by *
// bz at most kMaxWarpRows) in a stride of the launch's warps.  A warp tests
// its brick row by row (one voxel a lane): the voxel's shadow cotangent,
// then, where that is not 0, its density as put_light tests it; the dense
// ones join the warp's queue in shared memory with their cotangent (a
// ballot and a prefix).  Once the queue holds 32 voxels or the warp's
// bricks have run out, the warp walks the last 32 of them, one a lane,
// each in the lane's tape slot: no lane is spent on an empty voxel beyond
// its test, and no barrier holds a warp for another.
template <typename T, typename I>
__global__ void __launch_bounds__(kLightGradWarps * 32, kLightGradCtas)
    light_grad_brick_kernel(LightGrad b, Bricks br) {
  __shared__ int64_t queue[kLightGradWarps][kWarpQueue];
  __shared__ float g_queue[kLightGradWarps][kWarpQueue];
  constexpr int warps = kLightGradWarps;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;
  const int64_t slot = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int rows = br.by * br.bz;
  const int64_t bricks = (int64_t)br.nbx * br.nby * br.nbz;
  const int64_t stride = (int64_t)gridDim.x * warps;
  const T* const dens = (const T*)b.a.chan[3];
  const int num = *b.a.num_light_samples;
  const float light_step = kMaxDist / (float)num;
  const Vol& g = b.a.g;
  int queued = 0;
  int64_t brick = (int64_t)blockIdx.x * warps + warp;
  for (;;) {
    for (; queued < 32 && brick < bricks; brick += stride) {
      const int bx = (int)(brick % br.nbx), byz = (int)(brick / br.nbx);
      const int x = bx * kBrickX + lane, y0 = (byz % br.nby) * br.by, z0 = (byz / br.nby) * br.bz;
      for (int k = 0; k < rows; ++k) {
        const int y = y0 + k % br.by, z = z0 + k / br.by;
        const int64_t i = ((int64_t)z * g.ny + y) * g.nx + x;
        bool dense = false;
        float gs = 0.0f;
        if (x < g.nx && y < g.ny && z < g.nz) {
          gs = shadow_cotangent(b, i);
          if (gs != 0.0f) {
            float px, py, pz;
            centre(x, y, z, g, px, py, pz);
            dense = lerp8_or_zero(dens, corners<I, true>(to_tex(px), to_tex(py), to_tex(pz),
                                                         g)) >= b.a.m.zero;
          }
          if (!dense && b.samples != nullptr) b.samples[i] = 0;
        }
        const unsigned mask = __ballot_sync(kFull, dense);
        if (dense) {
          const int e = queued + __popc(mask & below);
          queue[warp][e] = i;
          g_queue[warp][e] = gs;
        }
        queued += __popc(mask);
      }
    }
    if (queued == 0) break;
    __syncwarp();
    const int take = queued < 32 ? queued : 32;
    queued -= take;
    int64_t i = -1;
    float gs = 0.0f;
    if (lane < take) {
      i = queue[warp][queued + lane];
      gs = g_queue[warp][queued + lane];
    }
    __syncwarp();
    const unsigned walking = __ballot_sync(kFull, i >= 0);
    if (i >= 0) {
      const int x = (int)(i % g.nx), y = (int)((i / g.nx) % g.ny);
      const int z = (int)(i / ((int64_t)g.nx * g.ny));
      const int taken =
          walk_light<T, I, kMerged>(b, x, y, z, gs, slot, num, light_step, walking);
      if (b.samples != nullptr) b.samples[i] = taken;
    }
  }
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

template <typename X>
struct Tag {
  using type = X;
};

// f(Tag<T>, Tag<I>, kMerge) for the grid's storage type, the tap offsets'
// type and the merging of lanes' atomics (scatter8).
template <typename F>
int dispatch(int grid_bf16, int wide, int merge, F f) {
  auto with_merge = [&](auto t, auto i) {
    return merge ? f(t, i, std::true_type{}) : f(t, i, std::false_type{});
  };
  auto with_i = [&](auto t) {
    return wide ? with_merge(t, Tag<int64_t>{}) : with_merge(t, Tag<int32_t>{});
  };
  return grid_bf16 ? with_i(Tag<__nv_bfloat16>{}) : with_i(Tag<float>{});
}

// The tape's floats for a launch of min(resident, work) CTAs of `threads`
// lanes: a slot of max_samples entries a lane (ops/cuda/raymarch.py's
// grad_tape_floats).
int64_t tape_floats(int64_t resident, int threads, int64_t work, int max_samples) {
  return (resident < work ? resident : work) * threads * (int64_t)max_samples * kTapeFloats;
}

// The occupancy of `kernel` in CTAs of `threads`: out[0] CTAs an SM, out[1]
// threads a CTA, out[2] registers a thread, out[3] local (spilled) bytes a
// thread, out[4] the card's SMs.
template <typename K>
void occupancy(K kernel, int threads, int* out) {
  cudaFuncAttributes attr{};
  cudaFuncGetAttributes(&attr, (const void*)kernel);
  out[0] = ctas_per_sm(kernel, threads);
  out[1] = threads;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = sm_count();
}

bool too_many(int64_t n) { return (n + kGradThreads - 1) / kGradThreads >= (1ll << 31); }

}  // namespace

extern "C" {

// R1b.  grid, light_map (required: separate mode), env, origin, dir, t_max,
// active, num_samples, n, max_ray, absorb, zero and flags as fx_view_march's;
// g_out (n, 4) f32, the cotangent of R1's output; g_grid (4, gz, gy, gx) and
// g_lm (3, lz, ly, lx) f32, zeroed by the caller, receive the cotangents;
// tape f32 scratch of tape_size values, at least tape_floats of the launch
// (raymarch.view_march_grad); samples (n, 2) int32 or null.  The plan as
// fx_view_march's (rows, cols, tile_w, wide) and `merge` (the walk's
// atomics merged by kTree: raymarch.view_grad_merges).  Launches on one device must not
// overlap: they share the fetch counter (R1's is another).
int fx_view_march_grad(const void* grid, int grid_bf16, int gz, int gy, int gx,
                       const void* light_map, int lz, int ly, int lx, const void* env,
                       const void* origin, const void* dir, const void* t_max, const void* active,
                       const void* num_samples, const void* g_out, void* g_grid, void* g_lm,
                       void* tape, int64_t tape_size, void* samples, int64_t n, int max_ray,
                       float absorb, float zero, int flags, int rows, int cols, int tile_w,
                       int wide, int merge, void* stream) {
  ViewGrad b{};
  Tiles p;
  if (light_map == nullptr || g_out == nullptr || g_grid == nullptr || g_lm == nullptr ||
      tape == nullptr ||
      !view_args(b.a, grid, gz, gy, gx, light_map, lz, ly, lx, env, origin, dir, t_max, active,
                 num_samples, nullptr, nullptr, nullptr, n, max_ray, 1, absorb, zero, flags) ||
      !tiles(n, rows, cols, tile_w, p) || (!wide && !(fits32(b.a.g, 4) && fits32(b.a.lm, 3)))) {
    return (int)cudaErrorInvalidValue;
  }
  channels(b.a.chan, 4, grid, b.a.g.plane, grid_bf16 ? 2 : 4);
  channels(b.a.lm_chan, 3, light_map, b.a.lm.plane, 4);
  channels(b.g_chan, 4, g_grid, b.a.g.plane, 4);
  channels(b.g_lm, 3, g_lm, b.a.lm.plane, 4);
  b.g_out = (const float*)g_out;
  b.samples = (int*)samples;
  cudaStream_t s = (cudaStream_t)stream;
  return dispatch(grid_bf16, wide, merge, [&](auto t, auto i, auto kmerge) {
    const auto kernel = view_grad_fetch_kernel<typename decltype(t)::type,
                                               typename decltype(i)::type, decltype(kmerge)::value>;
    const int64_t resident = (int64_t)sm_count() * ctas_per_sm(kernel, kViewGradThreads);
    const int64_t work = cdiv(p.slots, kViewGradThreads);
    if (tape_size < tape_floats(resident, kViewGradThreads, work, max_ray)) {
      return (int)cudaErrorInvalidValue;
    }
    const int blocks = (int)(resident < work ? resident : work);
    b.tape = Tape{(float*)tape, (int64_t)blocks * kViewGradThreads};
    kernel<<<blocks, kViewGradThreads, 0, s>>>(b, p);
    return (int)cudaGetLastError();
  });
}

// R2b.  grid, env, num_light_samples, max_light, absorb, zero and flags as
// fx_light_march's (no probe: flags without 2); g_out (3, gz, gy, gx) f32,
// the cotangent of R2's light map; g_dens (gz, gy, gx) f32, zeroed by the
// caller, receives the density channel's cotangent; tape f32 scratch of
// tape_size values, at least tape_floats of the launch
// (raymarch.light_march_grad); samples (gz * gy * gx,) int32 or null.  The
// plan (raymarch.light_grad_plan): bricks of 32 x by x bz voxels, by * bz
// in [1, 8], wide.
int fx_light_march_grad(const void* grid, int grid_bf16, int gz, int gy, int gx, const void* env,
                        const void* num_light_samples, const void* g_out, void* g_dens,
                        void* tape, int64_t tape_size, void* samples, int max_light,
                        float absorb, float zero, int flags, int by, int bz, int wide,
                        void* stream) {
  LightGrad b{};
  Bricks br;
  if (grid == nullptr || g_out == nullptr || g_dens == nullptr || tape == nullptr ||
      (flags & kProbe) ||
      !light_args(b.a, gz, gy, gx, env, num_light_samples, nullptr, nullptr, max_light, absorb,
                  zero, flags) ||
      !bricks(b.a.g, by, bz, br) || by * bz > kMaxWarpRows || (!wide && !fits32(b.a.g, 4))) {
    return (int)cudaErrorInvalidValue;
  }
  channels(b.a.chan, 4, grid, b.a.g.plane, grid_bf16 ? 2 : 4);
  b.g_out = (const float*)g_out;
  b.g_dens = (float*)g_dens;
  b.samples = (int*)samples;
  cudaStream_t s = (cudaStream_t)stream;
  constexpr int threads = kLightGradWarps * 32;
  return dispatch(grid_bf16, wide, 0, [&](auto t, auto i, auto) {
    const auto kernel =
        light_grad_brick_kernel<typename decltype(t)::type, typename decltype(i)::type>;
    const int64_t resident = (int64_t)sm_count() * ctas_per_sm(kernel, threads);
    const int64_t work = cdiv((int64_t)br.nbx * br.nby * br.nbz, kLightGradWarps);
    if (tape_size < tape_floats(resident, threads, work, max_light)) {
      return (int)cudaErrorInvalidValue;
    }
    const int blocks = (int)(resident < work ? resident : work);
    b.tape = Tape{(float*)tape, (int64_t)blocks * threads};
    kernel<<<blocks, threads, 0, s>>>(b, br);
    return (int)cudaGetLastError();
  });
}

// The occupancy of a kernel as `occupancy` gives it (out: 5 ints) for a
// grid of this storage type and offsets: kernel 0 R1b (merge as
// fx_view_march_grad's), 1 R2b, 2 and 3 their per-thread designs.
int fx_raymarch_grad_occupancy(int kernel, int grid_bf16, int wide, int merge, void* out) {
  if (kernel < 0 || kernel > 3 || out == nullptr) return (int)cudaErrorInvalidValue;
  int* o = (int*)out;
  dispatch(grid_bf16, wide, merge, [&](auto t, auto i, auto kmerge) {
    using T = typename decltype(t)::type;
    using I = typename decltype(i)::type;
    if (kernel == 0) {
      occupancy(view_grad_fetch_kernel<T, I, decltype(kmerge)::value>, kViewGradThreads, o);
    }
    if (kernel == 1) occupancy(light_grad_brick_kernel<T, I>, kLightGradWarps * 32, o);
    if (kernel == 2) occupancy(view_grad_perthread_kernel<T, I>, kGradThreads, o);
    if (kernel == 3) occupancy(light_grad_perthread_kernel<T, I>, kGradThreads, o);
    return 0;
  });
  return (int)cudaGetLastError();
}

// R1b's first design, one thread a ray: arguments as fx_view_march_grad's
// without the plan, with tape f32 scratch of 3 * max_ray * n values.
int fx_view_march_grad_perthread(const void* grid, int grid_bf16, int gz, int gy, int gx,
                                 const void* light_map, int lz, int ly, int lx, const void* env,
                                 const void* origin, const void* dir, const void* t_max,
                                 const void* active, const void* num_samples, const void* g_out,
                                 void* g_grid, void* g_lm, void* tape, void* samples, int64_t n,
                                 int max_ray, float absorb, float zero, int flags, int wide,
                                 void* stream) {
  ViewGrad b{};
  if (light_map == nullptr || g_out == nullptr || g_grid == nullptr || g_lm == nullptr ||
      tape == nullptr ||
      !view_args(b.a, grid, gz, gy, gx, light_map, lz, ly, lx, env, origin, dir, t_max, active,
                 num_samples, nullptr, nullptr, nullptr, n, max_ray, 1, absorb, zero, flags) ||
      too_many(n) || (!wide && !(fits32(b.a.g, 4) && fits32(b.a.lm, 3)))) {
    return (int)cudaErrorInvalidValue;
  }
  channels(b.a.chan, 4, grid, b.a.g.plane, grid_bf16 ? 2 : 4);
  channels(b.a.lm_chan, 3, light_map, b.a.lm.plane, 4);
  channels(b.g_chan, 4, g_grid, b.a.g.plane, 4);
  channels(b.g_lm, 3, g_lm, b.a.lm.plane, 4);
  b.g_out = (const float*)g_out;
  b.tape = Tape{(float*)tape, n};
  b.samples = (int*)samples;
  cudaStream_t s = (cudaStream_t)stream;
  return dispatch(grid_bf16, wide, 0, [&](auto t, auto i, auto) {
    view_grad_perthread_kernel<typename decltype(t)::type, typename decltype(i)::type>
        <<<cdiv(n, kGradThreads), kGradThreads, 0, s>>>(b);
    return (int)cudaGetLastError();
  });
}

// R2b's first design, one thread a voxel: arguments as fx_light_march_grad's
// without the plan, with tape f32 scratch of 3 * max_light * gz * gy * gx
// values.
int fx_light_march_grad_perthread(const void* grid, int grid_bf16, int gz, int gy, int gx,
                                  const void* env, const void* num_light_samples,
                                  const void* g_out, void* g_dens, void* tape, void* samples,
                                  int max_light, float absorb, float zero, int flags, int wide,
                                  void* stream) {
  LightGrad b{};
  if (grid == nullptr || g_out == nullptr || g_dens == nullptr || tape == nullptr ||
      (flags & kProbe) ||
      !light_args(b.a, gz, gy, gx, env, num_light_samples, nullptr, nullptr, max_light, absorb,
                  zero, flags) ||
      too_many(b.a.g.plane) || (!wide && !fits32(b.a.g, 4))) {
    return (int)cudaErrorInvalidValue;
  }
  channels(b.a.chan, 4, grid, b.a.g.plane, grid_bf16 ? 2 : 4);
  b.g_out = (const float*)g_out;
  b.g_dens = (float*)g_dens;
  b.tape = Tape{(float*)tape, b.a.g.plane};
  b.samples = (int*)samples;
  cudaStream_t s = (cudaStream_t)stream;
  return dispatch(grid_bf16, wide, 0, [&](auto t, auto i, auto) {
    light_grad_perthread_kernel<typename decltype(t)::type, typename decltype(i)::type>
        <<<cdiv(b.a.g.plane, kGradThreads), kGradThreads, 0, s>>>(b);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
