// The adjoints of the faithful stack's marches for Hopper: R1b (R1 in
// separate-light mode) and R2b (R2 without the light probe), the backward
// kernels of ops/cuda/raymarch.py's autograd Functions.
//
// These replace no TPU kernel.  The JAX package differentiates the faithful
// stack with jax.grad, which transposes the XLA scans that R1 and R2
// replace: raymarch_core.view_march (:337) and lightmap.render_light_map
// (:36).  As plain PyTorch autograd the same walk keeps every step's
// tensors of every ray (some 450 bytes a ray a step: about 55 GB at 800^2
// rays and 192 steps); these kernels keep a tape of 12 bytes a sample that
// counts: 3 * 4 * max_ray_samples bytes a ray (2.4 KB at 192 samples, 1.5 GB
// at 800^2 rays), 3 * 4 * max_light_samples a voxel (1.6 GB at 128^3 and 64
// samples).
//
//   fx_view_march_grad (R1b): from the cotangent of R1's (N, 4) output, the
//     cotangents of the (4, Z, Y, X) colour grid and of the (3, Z', Y', X')
//     light map, through the sampled values and through the sample
//     positions, which the densities move by the adaptive step.
//   fx_light_march_grad (R2b): from the cotangent of R2's (3, Z, Y, X) light
//     map, the cotangent of the grid's density channel: each dense voxel's
//     shadow ray, light colour * shadow + ambient, shadow its transmittance.
//
// Design (simple; making it fast is later work): one thread a ray (R1b)
// or a voxel (R2b), each with its own slot of the tape.  A thread runs its
// ray's forward again, with R1's or R2's own code (raymarch.cuh, both built with
// --fmad=false), so every branch it takes is the forward's: the +-0 skip,
// the threshold tests, the opacity or transmittance early-out, t_max, the
// box's edge and the sample count.  At each sample that counts (R1: a dense
// view sample; R2: every light sample) it appends to its slot of the tape
// the sample's t, the opacity (R1) or transmittance (R2) before it and the
// density of the counted sample before (prev); the tape is [entry][3][ray]
// in device memory, so a warp's entries are coalesced.  Then it walks the
// entries in reverse, carrying the adjoints of t, of the opacity or
// transmittance and of prev; at each it loads the sample's 8 CLAMP taps
// again, forms the lerps' adjoints and adds each tap's cotangent to the
// output by f32 atomicAdd (their order varies from run to run, so results
// agree with autograd to rounding, not bit for bit).  Samples that do not
// count pass the adjoints on unchanged.  Rays and voxels whose cotangent is
// 0 are skipped, as are inactive rays and empty voxels: their cotangents
// are 0.
//
// The derivative rules are torch's, as autograd applies them to the plain
// versions (render/raymarch_core.view_march, render/lightmap.light_map_plain)
// that these kernels are held to: clamp_min and clamp_max pass the gradient
// where their input equals the bound, abs has derivative 0 at 0, a where()
// sends it down the branch taken, floor passes none (the corners carry no
// gradient; the fractions carry it to t).  tests/test_torch_adjoint_walk.py
// models both walks in torch with this tape and recurrence.
//
// Bound: like R1 and R2, a sample's work is a chain of dependent gathers
// and some hundreds of f32 operations (the 7 or 1 channels' lerps, their
// adjoints, the step's adjoint and 56 or 8 atomics), so these kernels are
// bound by operations and by latency, not by the grid's bytes.
#include "raymarch.cuh"

namespace {

constexpr int kGradThreads = 128;

// The threads' tape: thread r's entry j holds its three values at
// p[(3 j + k) n + r], n the rays or voxels.
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

// Each tap's cotangent w added to channel ch at the corners' offsets.
template <typename I>
__device__ __forceinline__ void scatter8(float* ch, const Corners<I>& c, const float w[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) atomicAdd(ch + c.o[k], w[k]);
}

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

struct ViewGrad {
  ViewArgs a;          // R1's arguments (separate mode; its out unused)
  const float* g_out;  // (N, 4) the cotangent of R1's output
  float* g_chan[4];    // the grid's cotangent, f32 (4, Z, Y, X), by channel
  float* g_lm[3];      // the light map's, f32 (3, Z', Y', X'), by channel
  Tape tape;           // max_ray entries a ray
  int* samples;        // (N, 2) view samples run again and dense ones walked, or null
};

// R1b: a thread a ray; the forward is march_ray's (separate mode).
template <typename T, typename I>
__global__ void __launch_bounds__(kGradThreads) view_grad_kernel(ViewGrad b) {
  const int64_t r = (int64_t)blockIdx.x * kGradThreads + threadIdx.x;
  if (r >= b.a.n) return;
  const T* const ch[4] = {(const T*)b.a.chan[0], (const T*)b.a.chan[1], (const T*)b.a.chan[2],
                          (const T*)b.a.chan[3]};
  const int num = *b.a.num_samples;
  const float step_scale = kMaxDist / (float)num;
  const float absorb = b.a.m.absorb, zero = b.a.m.zero;
  const bool premultiplied = b.a.m.flags & kPremultiplied;
  int views = 0, hits = 0;
  const float4 go = reinterpret_cast<const float4*>(b.g_out)[r];
  if (b.a.active[r] && (go.x != 0.0f || go.y != 0.0f || go.z != 0.0f || go.w != 0.0f)) {
    const int64_t r3 = 3 * r;
    const float ox = b.a.origin[r3], oy = b.a.origin[r3 + 1], oz = b.a.origin[r3 + 2];
    const float dx = b.a.dir[r3], dy = b.a.dir[r3 + 1], dz = b.a.dir[r3 + 2];
    const float t_max = b.a.t_max[r];
    // R1's march again, a tape entry (t, opacity, prev) per dense sample.
    float t = 0.0f, prev = 0.0f, sa = 0.0f;
    for (int i = 0; i < b.a.max_ray && i < num; ++i) {
      const float px = ox + dx * t, py = oy + dy * t, pz = oz + dz * t;
      if (!inside(px, py, pz)) break;
      ++views;
      const Corners<I> c = corners<I, true>(to_tex(px), to_tex(py), to_tex(pz), b.a.g);
      const float ca = lerp8_or_zero(ch[3], c);
      float step = step_scale;
      if (ca > zero) {
        b.tape.put(r, hits++, t, sa, prev);
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
    // The walk back: a_t, a_sa and a_prev are the adjoints of t, the
    // opacity and prev after the entry; the rgb sums' are constant.
    const float gs[3] = {go.x * kInv2Pi, go.y * kInv2Pi, go.z * kInv2Pi};
    float a_t = 0.0f, a_sa = go.w, a_prev = 0.0f;
    for (int j = hits - 1; j >= 0; --j) {
      float tj, sa_j, prev_j;
      b.tape.get(r, j, tj, sa_j, prev_j);
      const float u = to_tex(ox + dx * tj), v = to_tex(oy + dy * tj), w = to_tex(oz + dz * tj);
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
      scatter8(b.g_chan[3], c, wt);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        lerp_taps_grad(tap[k], c.fx, c.fy, c.fz, g_col[k], wt, gf);
        scatter8(b.g_chan[k], c, wt);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        lerp_taps_grad(lt[k], lc.fx, lc.fy, lc.fz, g_l[k], wt, lf);
        scatter8(b.g_lm[k], lc, wt);
      }
      // t moves uvw = (o + d t) / 2 + 1/2, and uvw the fractions by the extents.
      const float gpx = (gf[0] * b.a.g.fx + lf[0] * b.a.lm.fx) * 0.5f;
      const float gpy = (gf[1] * b.a.g.fy + lf[1] * b.a.lm.fy) * 0.5f;
      const float gpz = (gf[2] * b.a.g.fz + lf[2] * b.a.lm.fz) * 0.5f;
      a_t = a_t + ((gpx * dx + gpy * dy) + gpz * dz);
      a_sa = a_sa - g_transm;
      a_prev = -g_dd;
    }
  }
  if (b.samples != nullptr) {
    b.samples[2 * r] = views;
    b.samples[2 * r + 1] = hits;
  }
}

struct LightGrad {
  LightArgs a;         // R2's arguments (no probe; its out unused)
  const float* g_out;  // (3, Z, Y, X) the cotangent of R2's light map
  float* g_dens;       // the density channel's cotangent, f32 (Z, Y, X)
  Tape tape;           // max_light entries a voxel
  int* samples;        // (Z * Y * X,) light samples walked, or null
};

// R2b: a thread a voxel; the forward is put_light's (light_at and
// cast_light_ray with kLean).
template <typename T, typename I>
__global__ void __launch_bounds__(kGradThreads) light_grad_kernel(LightGrad b) {
  const int64_t i = (int64_t)blockIdx.x * kGradThreads + threadIdx.x;
  if (i >= b.a.g.plane) return;
  const T* const dens = (const T*)b.a.chan[3];
  const float* env = b.a.m.env;
  const int num = *b.a.num_light_samples;
  const float light_step = kMaxDist / (float)num;
  const float absorb = b.a.m.absorb, zero = b.a.m.zero;
  const int64_t plane = b.a.g.plane;
  int taken = 0;
  // light = light_color * shadow + ambient: the shadow's cotangent.
  const float g_shadow = (b.g_out[i] * env[kColor] + b.g_out[plane + i] * env[kColor + 1]) +
                         b.g_out[2 * plane + i] * env[kColor + 2];
  float px = 0.0f, py = 0.0f, pz = 0.0f;
  bool dense = false;
  if (g_shadow != 0.0f) {
    const int x = (int)(i % b.a.g.nx), y = (int)((i / b.a.g.nx) % b.a.g.ny);
    const int z = (int)(i / ((int64_t)b.a.g.nx * b.a.g.ny));
    centre(x, y, z, b.a.g, px, py, pz);
    dense = lerp8_or_zero(dens, corners<I, true>(to_tex(px), to_tex(py), to_tex(pz), b.a.g)) >=
            zero;
  }
  if (dense) {
    float lx = env[kDir], ly = env[kDir + 1], lz = env[kDir + 2];
    if (b.a.m.flags & kPointLight) {
      const float ex = env[kPos] - px, ey = env[kPos + 1] - py, ez = env[kPos + 2] - pz;
      const float n = fmaxf(norm3(ex, ey, ez), 1e-12f);
      lx = ex / n; ly = ey / n; lz = ez / n;
    }
    // R2's shadow ray again, a tape entry (t, transmittance, prev) per sample.
    float t = light_step, transm = 1.0f, prev = 0.0f;
    if (transm >= zero) {
      for (int s = 0; s < b.a.m.max_light && s < num; ++s) {
        const float qx = px + lx * t, qy = py + ly * t, qz = pz + lz * t;
        if (!inside(qx, qy, qz)) break;
        b.tape.put(i, taken++, t, transm, prev);
        const Corners<I> c = corners<I, true>(to_tex(qx), to_tex(qy), to_tex(qz), b.a.g);
        const float d = lerp8_or_zero(dens, c);
        const float step = get_step(d - prev, transm, d, light_step);
        transm = transm * (1.0f - d * absorb);
        if (!(transm >= zero)) break;
        t = t + step;
        prev = d;
      }
    }
    // The walk back: a_T, a_t and a_prev are the adjoints of the
    // transmittance, t and prev after the entry.
    float a_T = g_shadow, a_t = 0.0f, a_prev = 0.0f;
    for (int j = taken - 1; j >= 0; --j) {
      float tj, transm_j, prev_j;
      b.tape.get(i, j, tj, transm_j, prev_j);
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
      scatter8(b.g_dens, c, wt);
      const float gpx = (gf[0] * b.a.g.fx) * 0.5f, gpy = (gf[1] * b.a.g.fy) * 0.5f;
      const float gpz = (gf[2] * b.a.g.fz) * 0.5f;
      a_t = a_t + ((gpx * lx + gpy * ly) + gpz * lz);
      a_T = g_T;
      a_prev = -g_dd;
    }
  }
  if (b.samples != nullptr) b.samples[i] = taken;
}

// A thread a ray or a voxel.
bool too_many(int64_t n) { return (n + kGradThreads - 1) / kGradThreads >= (1ll << 31); }

template <typename T, typename I>
void launch_view_grad(const ViewGrad& b, cudaStream_t s) {
  view_grad_kernel<T, I><<<cdiv(b.a.n, kGradThreads), kGradThreads, 0, s>>>(b);
}

template <typename T, typename I>
void launch_light_grad(const LightGrad& b, cudaStream_t s) {
  light_grad_kernel<T, I><<<cdiv(b.a.g.plane, kGradThreads), kGradThreads, 0, s>>>(b);
}

}  // namespace

extern "C" {

// R1b.  grid, light_map (required: separate mode), env, origin, dir, t_max,
// active, num_samples, n, max_ray, absorb, zero and flags as fx_view_march's;
// g_out (n, 4) f32, the cotangent of R1's output; g_grid (4, gz, gy, gx) and
// g_lm (3, lz, ly, lx) f32, zeroed by the caller, receive the cotangents;
// tape f32 scratch of 3 * max_ray * n values; samples (n, 2) int32 or null; wide: 64-bit tap
// offsets (required where 32-bit ones do not reach).
int fx_view_march_grad(const void* grid, int grid_bf16, int gz, int gy, int gx,
                       const void* light_map, int lz, int ly, int lx, const void* env,
                       const void* origin, const void* dir, const void* t_max, const void* active,
                       const void* num_samples, const void* g_out, void* g_grid, void* g_lm,
                       void* tape, void* samples, int64_t n, int max_ray,
                       float absorb, float zero, int flags, int wide, void* stream) {
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
  if (grid_bf16) {
    wide ? launch_view_grad<__nv_bfloat16, int64_t>(b, s)
         : launch_view_grad<__nv_bfloat16, int32_t>(b, s);
  } else {
    wide ? launch_view_grad<float, int64_t>(b, s) : launch_view_grad<float, int32_t>(b, s);
  }
  return (int)cudaGetLastError();
}

// R2b.  grid, env, num_light_samples, max_light, absorb, zero and flags as
// fx_light_march's (no probe: flags without 2); g_out (3, gz, gy, gx) f32,
// the cotangent of R2's light map; g_dens (gz, gy, gx) f32, zeroed by the
// caller, receives the density channel's cotangent; tape f32 scratch of
// 3 * max_light * gz * gy * gx values; samples (gz * gy * gx,) int32 or
// null; wide as fx_view_march_grad's.
int fx_light_march_grad(const void* grid, int grid_bf16, int gz, int gy, int gx, const void* env,
                        const void* num_light_samples, const void* g_out, void* g_dens,
                        void* tape, void* samples, int max_light, float absorb,
                        float zero, int flags, int wide, void* stream) {
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
  if (grid_bf16) {
    wide ? launch_light_grad<__nv_bfloat16, int64_t>(b, s)
         : launch_light_grad<__nv_bfloat16, int32_t>(b, s);
  } else {
    wide ? launch_light_grad<float, int64_t>(b, s) : launch_light_grad<float, int32_t>(b, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
