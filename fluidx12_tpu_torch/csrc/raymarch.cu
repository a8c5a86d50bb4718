// The faithful stack's per-ray marches for Hopper: R1 (view rays) and R2
// (the light map).
//
// These replace no TPU kernel.  The JAX package runs these marches as XLA
// scans over all rays in lock step: raymarch_core.view_march (its scan over
// the view samples, in merged mode nesting a shadow scan and, with the light
// probe, an AO scan per sample) and lightmap.render_light_map (the shadow
// and AO scans over every voxel).  As plain PyTorch a merged frame would be
// some 300 000 launches; the reference itself runs one GPU thread per ray
// with early-outs (CSRayMarch.hlsl, PSRayCast.hlsl, CSRayMarchL.hlsl).
//
//   fx_view_march (R1) marches raymarch_core.view_march per ray: CLAMP
//     trilinear samples of the (4, Z, Y, X) colour grid, read in its storage
//     type (bf16 -> f32 is exact), the adaptive step, front-to-back
//     accumulation with the opacity early-out, and per dense sample either
//     the light map's trilinear sample (separate mode; the map has its own
//     dims) or, in merged mode, cast_light_ray toward the light and, with the
//     probe, the 6-tap density gradient, the SH irradiance and the AO ray.
//     The sample counts (num_samples, num_light_samples) are read from device
//     memory, so the frame makes no host copy.  Output (N, 4) f32, rgb /
//     (2 pi), zero where the ray is inactive.
//   fx_light_march (R2) is lightmap.render_light_map per voxel: the voxel's
//     density, the shadow ray only where it is at least zero_threshold (else
//     transmittance 1), and with the probe the SH irradiance (0 where empty)
//     times the AO ray (1 where empty).  Output (3, Z, Y, X) f32.
//
// A ray stops where it dies, where the plain versions (lock step, masks)
// keep the ray's values unchanged, so the results are the same.  The
// arithmetic is the plain versions' op for op: the file builds with
// --fmad=false and IEEE division and square root, and a norm is
// sqrt((x*x + y*y) + z*z) on both sides, so a kernel agrees with its plain
// version to the last bit wherever the branches agree.
//
// Bound: the work depends on the data (where rays die), so it is counted
// from this run's samples: each kernel can write, per ray, the samples it
// took (`samples`, null in the frame): R1 its view samples, the dense ones
// among them and its light-ray samples, R2 its light-ray samples.  A sample
// is a trilinear gather (8 taps a channel) and some 20 to 100 f32
// operations, so the marches are bound by operations and by the chain of
// gathers along a ray (a sample's position waits on the step its density
// sets); the grid, read once, is a few microseconds of the card's memory
// rate.  What held the first design (one thread a ray or voxel, in storage
// order; kept as fx_view_march_perthread / fx_light_march_perthread, the
// yardsticks) back, and what this design does about it:
//
//   - R2's dense voxels (1.5-30% of a developed plume) were scattered over
//     warps of x-neighbours, each warp marching for its longest ray with a
//     few live lanes.  light_brick_kernel gives a CTA of kLightWarps warps a
//     brick of 32 x by x bz voxels (`light_plan`): every lane tests its
//     voxels' densities and writes the empty ones' light at once; the dense
//     ones go to a queue in shared memory (a warp ballot and a prefix),
//     which the CTA's warps then march as full warps.
//   - R1's warps were rows of texels in storage order: hidden faces, misses
//     and the screen outside the box held lanes, and a row's rays part
//     quickly.  view_fetch_kernel runs as many CTAs as the card holds at
//     once (fewer where the rays are fewer); a warp whose lanes are all idle takes the
//     next rays from a per-launch counter in tile order (32 rays of an 8 x 4
//     tile of the ray plane, or 32 x 1 where it has fewer than 4 rows:
//     `view_plan`), a lane that draws an inactive ray writes its zeros and
//     draws again, and each lane then marches its ray to its end (persistent
//     warps, "while-while", Aila and Laine, HPG 2009).  The CTA that finishes
//     last resets the counter, so every launch, a CUDA graph's replays
//     included, starts it from 0.  Fetching for a lane as soon as its ray
//     ended, and loading the next sample's taps ahead, were measured and
//     lost (PERF.md); merged mode is a kernel of its own.
//   - Fewer instructions a sample: tap offsets are 32-bit where 4 Z Y X
//     (and 3 Z' Y' X' of the light map) < 2^31 (the plans' `wide`); each
//     channel's base is formed in 64 bits on the host and passed in, so a
//     tap's address is one multiply-add; the extents arrive as floats; and
//     a density whose 8 taps are all +-0 skips its conversions and lerps
//     (lerp8_or_zero); a dense view sample issues all its gathers (rgb, and
//     the light map's) before its first lerp.
#include "raymarch.cuh"

namespace {

constexpr int kThreads = 128;       // the per-thread designs' CTA
constexpr int kViewThreads = 128;   // R1's CTA
constexpr int kLightWarps = 8;      // R2's CTA: warps sharing a brick's queue
// Ramamoorthi's irradiance constants (SHIrradianceTypeless.hlsli:18-21).
constexpr double kC1 = 0.42904276540489171563379376569857;
constexpr double kC2 = 0.51166335397324424423977581244463;
constexpr double kC3 = 0.24770795610037568833406429782001;
constexpr double kC4 = 0.88622692545275801364908374167057;

// R1's next slot and its CTAs finished, reset by the CTA that finishes last.
__device__ unsigned long long g_view_fetch[2];

// CastLightRay (RayMarch.hlsli:215-247; raymarch_core.cast_light_ray) with
// transm0 = 1, counting its samples into *taken; tap offsets of type I;
// kLean: a sample's density by lerp8_or_zero.
template <typename T, typename I = int64_t, bool kLean = false>
__device__ float cast_light_ray(const T* dens, const Vol& g, float ox, float oy, float oz,
                                float dx, float dy, float dz, const March& m, int& taken) {
  float t = m.light_step, transm = 1.0f, prev = 0.0f;
  if (!(transm >= m.zero)) return transm;
  for (int i = 0; i < m.max_light && i < m.num_light; ++i) {
    const float px = ox + dx * t, py = oy + dy * t, pz = oz + dz * t;
    if (!inside(px, py, pz)) break;
    ++taken;
    const Corners<I> c = corners<I, kLean>(to_tex(px), to_tex(py), to_tex(pz), g);
    const float d = kLean ? lerp8_or_zero(dens, c) : lerp8(dens, c);
    const float step = get_step(d - prev, transm, d, m.light_step);
    transm = transm * (1.0f - d * m.absorb);
    if (!(transm >= m.zero)) break;
    t = t + step;
    prev = d;
  }
  return transm;
}

// Irradiance of one channel from the 9 SH coefficients (x and y already
// negated; gi/sh.evaluate_sh_irradiance).
__device__ __forceinline__ float sh_channel(const float* sh, int c, float x, float y, float z) {
  const float s0 = sh[0 * 3 + c], s1 = sh[1 * 3 + c], s2 = sh[2 * 3 + c];
  const float s3 = sh[3 * 3 + c], s4 = sh[4 * 3 + c], s5 = sh[5 * 3 + c];
  const float s6 = sh[6 * 3 + c], s7 = sh[7 * 3 + c], s8 = sh[8 * 3 + c];
  const float irr = ((float)kC1 * (x * x - y * y)) * s8
                    + ((float)kC3 * (3.0f * z * z - 1.0f)) * s6
                    + (float)kC4 * s0
                    + (float)(2.0 * kC1) * (s4 * x * y + s7 * x * z + s5 * y * z)
                    + (float)(2.0 * kC2) * (s3 * x + s1 * y + s2 * z);
  return fmaxf(irr, 0.0f);
}

// The light at local point (px, py, pz): light colour * shadow and, with
// the probe, the SH irradiance along the negated density gradient times the
// AO ray along it (GetLight, RayMarch.hlsli:252-295), else the flat ambient.
// `dense` false (R2's empty voxel) skips the rays: shadow 1, irradiance 0,
// AO 1 (CSRayMarchL.hlsl:43).  Tap offsets of type I; kLean as
// cast_light_ray's.
template <typename T, typename I, bool kLean>
__device__ void light_at(const T* dens, const Vol& g, float px, float py, float pz, bool dense,
                         const March& m, float out[3], int& taken) {
  const float* env = m.env;
  float shadow = 1.0f;
  if (dense) {
    float lx = env[kDir], ly = env[kDir + 1], lz = env[kDir + 2];
    if (m.flags & kPointLight) {
      const float dx = env[kPos] - px, dy = env[kPos + 1] - py, dz = env[kPos + 2] - pz;
      const float n = fmaxf(norm3(dx, dy, dz), 1e-12f);
      lx = dx / n; ly = dy / n; lz = dz / n;
    }
    shadow = cast_light_ray<T, I, kLean>(dens, g, px, py, pz, lx, ly, lz, m, taken);
  }
  float amb[3] = {env[kAmbient], env[kAmbient + 1], env[kAmbient + 2]};
  if (m.flags & kProbe) {
    float irr[3] = {0.0f, 0.0f, 0.0f}, ao = 1.0f;
    if (dense) {
      // The 6-tap gradient of the density (RayMarch.hlsli:73-95), negated.
      const float u = to_tex(px), v = to_tex(py), w = to_tex(pz);
      const float tx = (float)(1.0 / g.nx), ty = (float)(1.0 / g.ny), tz = (float)(1.0 / g.nz);
      float gx = -(lerp8(dens, corners<I, kLean>(u + tx, v, w, g)) -
                   lerp8(dens, corners<I, kLean>(u - tx, v, w, g)));
      float gy = -(lerp8(dens, corners<I, kLean>(u, v + ty, w, g)) -
                   lerp8(dens, corners<I, kLean>(u, v - ty, w, g)));
      float gz = -(lerp8(dens, corners<I, kLean>(u, v, w + tz, g)) -
                   lerp8(dens, corners<I, kLean>(u, v, w - tz, g)));
      if (gx == 0.0f && gy == 0.0f && gz == 0.0f) {  // RayMarch.hlsli:279
        gx = px; gy = py; gz = pz;
      }
      const float* wm = env + kWorld;
      float wx = (gx * wm[0] + gy * wm[3]) + gz * wm[6];
      float wy = (gx * wm[1] + gy * wm[4]) + gz * wm[7];
      float wz = (gx * wm[2] + gy * wm[5]) + gz * wm[8];
      const float wn = fmaxf(norm3(wx, wy, wz), 1e-12f);
      wx = wx / wn; wy = wy / wn; wz = wz / wn;
#pragma unroll
      for (int c = 0; c < 3; ++c) irr[c] = sh_channel(env + kSh, c, -wx, -wy, wz);
      const float gn = fmaxf(norm3(gx, gy, gz), 1e-12f);
      ao = cast_light_ray<T, I, kLean>(dens, g, px, py, pz, gx / gn, gy / gn, gz / gn, m, taken);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) amb[c] = irr[c] * ao;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = env[kColor + c] * shadow + amb[c];
}

// R1's first design, one thread a ray in storage order: the
// yardstick of view_fetch_kernel.
template <typename T>
__global__ void __launch_bounds__(kThreads) view_march_perthread_kernel(ViewArgs a,
                                                                        const T* grid) {
  const int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= a.n) return;
  float sr = 0.0f, sg = 0.0f, sb = 0.0f, sa = 0.0f;
  int views = 0, dense = 0, lights = 0;
  if (a.active[r]) {
    March m = a.m;
    const int num = *a.num_samples;
    const float step_scale = kMaxDist / (float)num;
    if (a.light_map == nullptr) {
      m.num_light = *a.num_light_samples;
      m.light_step = kMaxDist / (float)m.num_light;
    }
    const float ox = a.origin[3 * r], oy = a.origin[3 * r + 1], oz = a.origin[3 * r + 2];
    const float dx = a.dir[3 * r], dy = a.dir[3 * r + 1], dz = a.dir[3 * r + 2];
    const float t_max = a.t_max[r];
    float t = 0.0f, prev = 0.0f;
    for (int i = 0; i < a.max_ray && i < num; ++i) {
      const float px = ox + dx * t, py = oy + dy * t, pz = oz + dz * t;
      if (!inside(px, py, pz)) break;
      ++views;
      const float u = to_tex(px), v = to_tex(py), w = to_tex(pz);
      const Corners<int64_t> c = corners(u, v, w, a.g);
      const float ca = lerp8(grid + 3 * a.g.plane, c);
      float step = step_scale;
      if (ca > m.zero) {
        ++dense;
        float cr = lerp8(grid, c), cg = lerp8(grid + a.g.plane, c);
        float cb = lerp8(grid + 2 * a.g.plane, c);
        float light[3];
        if (a.light_map != nullptr) {
          const Corners<int64_t> lc = corners(u, v, w, a.lm);
#pragma unroll
          for (int k = 0; k < 3; ++k) light[k] = lerp8(a.light_map + k * a.lm.plane, lc);
        } else {
          light_at<T, int64_t, false>(grid + 3 * a.g.plane, a.g, px, py, pz, true, m, light,
                                      lights);
        }
        const float transm = 1.0f - sa;
        step = get_step(ca - prev, transm, ca, step_scale);
        if (!(m.flags & kPremultiplied)) {
          cr = cr * ca; cg = cg * ca; cb = cb * ca;
        }
        const float k = m.absorb * transm;
        sr = sr + (cr * light[0]) * k;
        sg = sg + (cg * light[1]) * k;
        sb = sb + (cb * light[2]) * k;
        sa = sa + ca * k;
        // The opacity early-out, on dense samples only (CSRayMarch.hlsl:186).
        if (1.0f - sa < m.zero) break;
        prev = ca;
      }
      const float t_new = t + step;
      if (!(t_new <= t_max)) break;
      t = t_new;
    }
    sr = sr * kInv2Pi; sg = sg * kInv2Pi; sb = sb * kInv2Pi;
  }
  reinterpret_cast<float4*>(a.out)[r] = make_float4(sr, sg, sb, sa);
  if (a.samples != nullptr) {
    a.samples[3 * r] = views;
    a.samples[3 * r + 1] = dense;
    a.samples[3 * r + 2] = lights;
  }
}

__device__ __forceinline__ void put_ray(const ViewArgs& a, int r, float4 v, int views,
                                        int dense, int lights) {
  reinterpret_cast<float4*>(a.out)[r] = v;
  if (a.samples != nullptr) {
    const int64_t r3 = 3 * (int64_t)r;
    a.samples[r3] = views;
    a.samples[r3 + 1] = dense;
    a.samples[r3 + 2] = lights;
  }
}

// One ray of R1, marched to its end and written: the per-thread design's
// loop, its tap offsets of type I, merged mode (kMerged) or separate.
template <typename T, typename I, bool kMerged>
__device__ __forceinline__ void march_ray(const ViewArgs& a, const March& m, int num,
                                          float step_scale, int r) {
  const T* const ch[4] = {(const T*)a.chan[0], (const T*)a.chan[1], (const T*)a.chan[2],
                          (const T*)a.chan[3]};
  const int64_t r3 = 3 * (int64_t)r;
  const float ox = a.origin[r3], oy = a.origin[r3 + 1], oz = a.origin[r3 + 2];
  const float dx = a.dir[r3], dy = a.dir[r3 + 1], dz = a.dir[r3 + 2];
  const float t_max = a.t_max[r];
  float sr = 0.0f, sg = 0.0f, sb = 0.0f, sa = 0.0f;
  int views = 0, dense = 0, lights = 0;
  float t = 0.0f, prev = 0.0f;
  for (int i = 0; i < a.max_ray && i < num; ++i) {
    const float px = ox + dx * t, py = oy + dy * t, pz = oz + dz * t;
    if (!inside(px, py, pz)) break;
    ++views;
    const float u = to_tex(px), v = to_tex(py), w = to_tex(pz);
    const Corners<I> c = corners<I, true>(u, v, w, a.g);
    const float ca = lerp8_or_zero(ch[3], c);
    float step = step_scale;
    if (ca > m.zero) {
      ++dense;
      // Every gather of the sample in flight before the first lerp.
      float rgb[3][8], light[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) load8(rgb[k], ch[k], c);
      if constexpr (kMerged) {
        light_at<T, I, true>(ch[3], a.g, px, py, pz, true, m, light, lights);
      } else {
        const Corners<I> lc = corners<I, true>(u, v, w, a.lm);
        float lt[3][8];
#pragma unroll
        for (int k = 0; k < 3; ++k) load8(lt[k], a.lm_chan[k], lc);
#pragma unroll
        for (int k = 0; k < 3; ++k) light[k] = lerp_taps(lt[k], lc.fx, lc.fy, lc.fz);
      }
      float cr = lerp_taps(rgb[0], c.fx, c.fy, c.fz), cg = lerp_taps(rgb[1], c.fx, c.fy, c.fz);
      float cb = lerp_taps(rgb[2], c.fx, c.fy, c.fz);
      const float transm = 1.0f - sa;
      step = get_step(ca - prev, transm, ca, step_scale);
      if (!(m.flags & kPremultiplied)) {
        cr = cr * ca; cg = cg * ca; cb = cb * ca;
      }
      const float k = m.absorb * transm;
      sr = sr + (cr * light[0]) * k;
      sg = sg + (cg * light[1]) * k;
      sb = sb + (cb * light[2]) * k;
      sa = sa + ca * k;
      // The opacity early-out, on dense samples only (CSRayMarch.hlsl:186).
      if (1.0f - sa < m.zero) break;
      prev = ca;
    }
    const float t_new = t + step;
    if (!(t_new <= t_max)) break;
    t = t_new;
  }
  put_ray(a, r, make_float4(sr * kInv2Pi, sg * kInv2Pi, sb * kInv2Pi, sa), views, dense, lights);
}

// R1 (raymarch_core.view_march): persistent warps that fetch rays by tiles
// ("while-while": a warp fetches once all its lanes are idle, then each
// lane marches its ray to its end).  Merged mode is its own kernel:
// separate mode's lanes then hold only what their march needs, and more of
// them fit an SM.
template <typename T, typename I, bool kMerged>
__global__ void __launch_bounds__(kViewThreads) view_fetch_kernel(ViewArgs a, Tiles p) {
  const int lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;
  March m = a.m;
  const int num = *a.num_samples;
  const float step_scale = kMaxDist / (float)num;
  if (kMerged) {
    m.num_light = *a.num_light_samples;
    m.light_step = kMaxDist / (float)m.num_light;
  }
  for (;;) {
    // Each lane draws slots until it holds an active ray or they run out;
    // an inactive ray is written as zeros.
    int r = -1;
    for (;;) {
      const unsigned idle = __ballot_sync(kFull, r < 0);
      if (idle == 0) break;
      unsigned long long base = 0;
      if (lane == 0) base = atomicAdd(&g_view_fetch[0], (unsigned long long)__popc(idle));
      base = __shfl_sync(kFull, base, 0);
      if (base >= (unsigned long long)p.slots) break;
      const unsigned long long slot = base + __popc(idle & below);
      if (r < 0 && slot < (unsigned long long)p.slots) {
        const int q = ray_of_slot((int)slot, p);
        if (q >= 0) {
          if (a.active[q]) {
            r = q;
          } else {
            put_ray(a, q, make_float4(0.0f, 0.0f, 0.0f, 0.0f), 0, 0, 0);
          }
        }
      }
    }
    if (__ballot_sync(kFull, r >= 0) == 0) break;
    if (r >= 0) march_ray<T, I, kMerged>(a, m, num, step_scale, r);
  }
  // Every warp of this CTA is past its last fetch; the last CTA to get here
  // resets the counter for the next launch.
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(&g_view_fetch[1], 1ull) == (unsigned long long)gridDim.x - 1) {
      atomicExch(&g_view_fetch[0], 0ull);
      atomicExch(&g_view_fetch[1], 0ull);
    }
  }
}

// R2's first design, one thread a voxel: the yardstick of
// light_brick_kernel.
template <typename T>
__global__ void __launch_bounds__(kThreads) light_march_perthread_kernel(LightArgs a,
                                                                         const T* grid) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.g.plane) return;
  const int x = (int)(i % a.g.nx), y = (int)((i / a.g.nx) % a.g.ny);
  const int z = (int)(i / ((int64_t)a.g.nx * a.g.ny));
  March m = a.m;
  m.num_light = *a.num_light_samples;
  m.light_step = kMaxDist / (float)m.num_light;
  float px, py, pz;
  centre(x, y, z, a.g, px, py, pz);
  const float d_here =
      lerp8(grid + 3 * a.g.plane, corners(to_tex(px), to_tex(py), to_tex(pz), a.g));
  float light[3];
  int taken = 0;
  light_at<T, int64_t, false>(grid + 3 * a.g.plane, a.g, px, py, pz, d_here >= m.zero, m, light,
                              taken);
#pragma unroll
  for (int c = 0; c < 3; ++c) a.out[c * a.g.plane + i] = light[c];
  if (a.samples != nullptr) a.samples[i] = taken;
}

template <typename T, typename I>
__device__ __forceinline__ void put_light(const LightArgs& a, const T* dens, int x, int y, int z,
                                          bool dense, const March& m) {
  float px, py, pz;
  centre(x, y, z, a.g, px, py, pz);
  float light[3];
  int taken = 0;
  light_at<T, I, true>(dens, a.g, px, py, pz, dense, m, light, taken);
  const int64_t i = ((int64_t)z * a.g.ny + y) * a.g.nx + x;
#pragma unroll
  for (int c = 0; c < 3; ++c) a.out[c * a.g.plane + i] = light[c];
  if (a.samples != nullptr) a.samples[i] = taken;
}

// R2 (lightmap.render_light_map): a CTA a brick.  Row k of the brick (y0 +
// k % by, z0 + k / by; x along the lanes) is tested by warp k % kLightWarps;
// its dense voxels join the CTA's queue, which the warps march 32 at a time.
template <typename T, typename I>
__global__ void __launch_bounds__(kLightWarps * 32) light_brick_kernel(LightArgs a, Bricks b) {
  __shared__ int queue[kMaxBrickRows * kBrickX];
  __shared__ int queued;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int brick = blockIdx.x;
  const int bx = brick % b.nbx, byz = brick / b.nbx;
  const int x = bx * kBrickX + lane, y0 = (byz % b.nby) * b.by, z0 = (byz / b.nby) * b.bz;
  const int rows = b.by * b.bz;
  March m = a.m;
  m.num_light = *a.num_light_samples;
  m.light_step = kMaxDist / (float)m.num_light;
  const T* const dens = (const T*)a.chan[3];
  if (threadIdx.x == 0) queued = 0;
  // Every voxel's density; the empty ones' light at once, the dense ones'
  // bits kept (bit j: row warp + j kLightWarps).
  unsigned bits = 0;
#pragma unroll 4
  for (int k = warp; k < rows; k += kLightWarps) {
    const int y = y0 + k % b.by, z = z0 + k / b.by;
    if (x < a.g.nx && y < a.g.ny && z < a.g.nz) {
      float px, py, pz;
      centre(x, y, z, a.g, px, py, pz);
      const float d_here =
          lerp8_or_zero(dens, corners<I, true>(to_tex(px), to_tex(py), to_tex(pz), a.g));
      if (d_here >= m.zero) {
        bits |= 1u << (k / kLightWarps);
      } else {
        put_light<T, I>(a, dens, x, y, z, false, m);
      }
    }
  }
  __syncthreads();
  for (int k = warp; k < rows; k += kLightWarps) {
    const bool dense = (bits >> (k / kLightWarps)) & 1u;
    const unsigned mask = __ballot_sync(kFull, dense);
    int base = 0;
    if (lane == 0 && mask != 0) base = atomicAdd(&queued, __popc(mask));
    base = __shfl_sync(kFull, base, 0);
    if (dense) queue[base + __popc(mask & ((1u << lane) - 1u))] = k * kBrickX + lane;
  }
  __syncthreads();
  const int n = queued;
  for (int e = warp * 32 + lane; e - lane < n; e += kLightWarps * 32) {
    if (e < n) {
      const int q = queue[e], k = q / kBrickX;
      put_light<T, I>(a, dens, bx * kBrickX + q % kBrickX, y0 + k % b.by, z0 + k / b.by, true,
                      m);
    }
  }
}

template <typename T, typename I, bool kMerged>
void launch_view_mode(const ViewArgs& a, const Tiles& p, cudaStream_t s) {
  static const int resident =
      sm_count() * ctas_per_sm(view_fetch_kernel<T, I, kMerged>, kViewThreads);
  const int blocks = min(resident, cdiv(p.slots, kViewThreads));
  view_fetch_kernel<T, I, kMerged><<<blocks, kViewThreads, 0, s>>>(a, p);
}

template <typename T, typename I>
void launch_view(const ViewArgs& a, const Tiles& p, cudaStream_t s) {
  a.light_map == nullptr ? launch_view_mode<T, I, true>(a, p, s)
                         : launch_view_mode<T, I, false>(a, p, s);
}

template <typename T, typename I>
void launch_light(const LightArgs& a, const Bricks& b, cudaStream_t s) {
  light_brick_kernel<T, I><<<b.nbx * b.nby * b.nbz, kLightWarps * 32, 0, s>>>(a, b);
}

}  // namespace

extern "C" {

// R1.  grid (4, gz, gy, gx), bf16 when grid_bf16 else f32; light_map
// (3, lz, ly, lx) f32 (separate mode) or null (merged); env the packed
// light environment (48 f32); origin and dir (n, 3), t_max (n,) f32, active
// (n,) bool; num_samples and num_light_samples device int32 scalars; out
// (n, 4) f32; samples (n, 3) int32 or null.  flags: 1 premultiplied colour,
// 2 light probe, 4 point light.  The plan (ops/cuda/raymarch.view_plan):
// the rays as (rows, cols), tile_w 8 or 32, wide (64-bit tap offsets;
// required where 32-bit ones do not reach).
// Launches on one device must not overlap: they share the fetch counter.
int fx_view_march(const void* grid, int grid_bf16, int gz, int gy, int gx, const void* light_map,
                  int lz, int ly, int lx, const void* env, const void* origin, const void* dir,
                  const void* t_max, const void* active, const void* num_samples,
                  const void* num_light_samples, void* out, void* samples, int64_t n,
                  int max_ray, int max_light, float absorb, float zero, int flags, int rows,
                  int cols, int tile_w, int wide, void* stream) {
  ViewArgs a;
  Tiles p;
  if (!view_args(a, grid, gz, gy, gx, light_map, lz, ly, lx, env, origin, dir, t_max, active,
                 num_samples, num_light_samples, out, samples, n, max_ray, max_light, absorb,
                 zero, flags) ||
      !tiles(n, rows, cols, tile_w, p) || (!wide && !(fits32(a.g, 4) && fits32(a.lm, 3)))) {
    return (int)cudaErrorInvalidValue;
  }
  channels(a.chan, 4, grid, a.g.plane, grid_bf16 ? 2 : 4);
  if (light_map != nullptr) channels(a.lm_chan, 3, light_map, a.lm.plane, 4);
  cudaStream_t s = (cudaStream_t)stream;
  if (grid_bf16) {
    wide ? launch_view<__nv_bfloat16, int64_t>(a, p, s)
         : launch_view<__nv_bfloat16, int32_t>(a, p, s);
  } else {
    wide ? launch_view<float, int64_t>(a, p, s) : launch_view<float, int32_t>(a, p, s);
  }
  return (int)cudaGetLastError();
}

// R1's per-thread design, arguments as fx_view_march's without the plan.
int fx_view_march_perthread(const void* grid, int grid_bf16, int gz, int gy, int gx,
                            const void* light_map, int lz, int ly, int lx, const void* env,
                            const void* origin, const void* dir, const void* t_max,
                            const void* active, const void* num_samples,
                            const void* num_light_samples, void* out, void* samples, int64_t n,
                            int max_ray, int max_light, float absorb, float zero, int flags,
                            void* stream) {
  ViewArgs a;
  if (!view_args(a, grid, gz, gy, gx, light_map, lz, ly, lx, env, origin, dir, t_max, active,
                 num_samples, num_light_samples, out, samples, n, max_ray, max_light, absorb,
                 zero, flags)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 blocks((unsigned)((n + kThreads - 1) / kThreads));
  cudaStream_t s = (cudaStream_t)stream;
  if (grid_bf16) {
    view_march_perthread_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        a, (const __nv_bfloat16*)grid);
  } else {
    view_march_perthread_kernel<float><<<blocks, kThreads, 0, s>>>(a, (const float*)grid);
  }
  return (int)cudaGetLastError();
}

// R2.  grid (4, gz, gy, gx) as fx_view_march's; env, num_light_samples,
// absorb, zero and flags as there; out (3, gz, gy, gx) f32; samples
// (gz * gy * gx,) int32 or null.  The plan (ops/cuda/raymarch.light_plan):
// bricks of 32 x by x bz voxels, by * bz in [1, 32], wide.
int fx_light_march(const void* grid, int grid_bf16, int gz, int gy, int gx, const void* env,
                   const void* num_light_samples, void* out, void* samples, int max_light,
                   float absorb, float zero, int flags, int by, int bz, int wide,
                   void* stream) {
  LightArgs a;
  Bricks b;
  if (grid == nullptr ||
      !light_args(a, gz, gy, gx, env, num_light_samples, out, samples, max_light, absorb, zero,
                  flags) ||
      !bricks(a.g, by, bz, b) || (!wide && !fits32(a.g, 4))) {
    return (int)cudaErrorInvalidValue;
  }
  channels(a.chan, 4, grid, a.g.plane, grid_bf16 ? 2 : 4);
  cudaStream_t s = (cudaStream_t)stream;
  if (grid_bf16) {
    wide ? launch_light<__nv_bfloat16, int64_t>(a, b, s)
         : launch_light<__nv_bfloat16, int32_t>(a, b, s);
  } else {
    wide ? launch_light<float, int64_t>(a, b, s) : launch_light<float, int32_t>(a, b, s);
  }
  return (int)cudaGetLastError();
}

// R2's per-thread design, arguments as fx_light_march's without the plan.
int fx_light_march_perthread(const void* grid, int grid_bf16, int gz, int gy, int gx,
                             const void* env, const void* num_light_samples, void* out,
                             void* samples, int max_light, float absorb, float zero, int flags,
                             void* stream) {
  LightArgs a;
  if (grid == nullptr || !light_args(a, gz, gy, gx, env, num_light_samples, out, samples,
                                     max_light, absorb, zero, flags)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 blocks((unsigned)((a.g.plane + kThreads - 1) / kThreads));
  cudaStream_t s = (cudaStream_t)stream;
  if (grid_bf16) {
    light_march_perthread_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        a, (const __nv_bfloat16*)grid);
  } else {
    light_march_perthread_kernel<float><<<blocks, kThreads, 0, s>>>(a, (const float*)grid);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
