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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;       // the per-thread designs' CTA
constexpr int kViewThreads = 128;   // R1's CTA
constexpr int kLightWarps = 8;      // R2's CTA: warps sharing a brick's queue
constexpr int kBrickX = 32;         // R2's brick: one voxel a lane along x
constexpr int kMaxBrickRows = 32;   // by * bz at most: a lane's dense bits in one word
constexpr int kTileRays = 32;       // R1's tile: a warp's rays
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMaxDist = 3.4641016151377544f;  // 2 sqrt(3), RayMarch.hlsli:29
constexpr float kInv2Pi = (float)(1.0 / (2.0 * 3.14159265358979323846));
// Ramamoorthi's irradiance constants (SHIrradianceTypeless.hlsli:18-21).
constexpr double kC1 = 0.42904276540489171563379376569857;
constexpr double kC2 = 0.51166335397324424423977581244463;
constexpr double kC3 = 0.24770795610037568833406429782001;
constexpr double kC4 = 0.88622692545275801364908374167057;

// The packed light environment (render/raymarch_core.pack_env): light_dir,
// light_pos, light_color, ambient (3 each), world3x3 row-major (9), SH (9, 3).
enum EnvSlot { kDir = 0, kPos = 3, kColor = 6, kAmbient = 9, kWorld = 12, kSh = 21,
               kEnvSize = 48 };

enum Flags { kPremultiplied = 1, kProbe = 2, kPointLight = 4 };

// R1's next slot and its CTAs finished, reset by the CTA that finishes last.
__device__ unsigned long long g_view_fetch[2];

template <typename I>
__device__ __forceinline__ float load(const float* p, I i) { return __ldg(p + i); }
template <typename I>
__device__ __forceinline__ float load(const __nv_bfloat16* p, I i) {
  return __bfloat162float(p[i]);
}

struct Vol {
  int nx, ny, nz;
  int64_t plane;          // nx * ny * nz: the channel stride
  float fx, fy, fz;       // the extents as floats,
  float fx1, fy1, fz1;    // and plus one (what axis computes; the new designs read them)
};

// The 8 corners of a CLAMP trilinear sample and its fractions
// (ops/sampling.trilinear_sample): t = uvw * n - 0.5, floor, clamp.  I is
// the offsets' type: int64_t, or int32_t where a channel's offsets fit.
template <typename I>
struct Corners {
  I o[8];  // (z, y, x) bits 000 .. 111
  float fx, fy, fz;
};

// fn = (float)n and fn1 = (float)n + 1.0f.
__device__ __forceinline__ void axis(float uvw, int n, float fn, float fn1, int& i0, int& i1,
                                     float& f) {
  const float t = uvw * fn - 0.5f;
  const float t0 = floorf(t);
  f = t - t0;
  // Clamping t0 first keeps the int conversion in range and changes no index.
  const int i = (int)fminf(fmaxf(t0, -2.0f), fn1);
  i0 = min(max(i, 0), n - 1);
  i1 = min(max(i + 1, 0), n - 1);
}

// kLean: the extents' floats from the Vol (the same values), else
// converted here, as the per-thread designs do.
template <typename I = int64_t, bool kLean = false>
__device__ __forceinline__ Corners<I> corners(float u, float v, float w, const Vol& g) {
  int x0, x1, y0, y1, z0, z1;
  Corners<I> c;
  if constexpr (kLean) {
    axis(u, g.nx, g.fx, g.fx1, x0, x1, c.fx);
    axis(v, g.ny, g.fy, g.fy1, y0, y1, c.fy);
    axis(w, g.nz, g.fz, g.fz1, z0, z1, c.fz);
  } else {
    axis(u, g.nx, (float)g.nx, (float)g.nx + 1.0f, x0, x1, c.fx);
    axis(v, g.ny, (float)g.ny, (float)g.ny + 1.0f, y0, y1, c.fy);
    axis(w, g.nz, (float)g.nz, (float)g.nz + 1.0f, z0, z1, c.fz);
  }
  const I r00 = ((I)z0 * g.ny + y0) * g.nx, r01 = ((I)z0 * g.ny + y1) * g.nx;
  const I r10 = ((I)z1 * g.ny + y0) * g.nx, r11 = ((I)z1 * g.ny + y1) * g.nx;
  c.o[0] = r00 + x0; c.o[1] = r00 + x1; c.o[2] = r01 + x0; c.o[3] = r01 + x1;
  c.o[4] = r10 + x0; c.o[5] = r10 + x1; c.o[6] = r11 + x0; c.o[7] = r11 + x1;
  return c;
}

template <typename T, typename I>
__device__ __forceinline__ void load8(float v[8], const T* ch, const Corners<I>& c) {
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = load(ch, c.o[k]);
}

// The trilinear value of 8 taps, lerps along x, then y, then z.
__device__ __forceinline__ float lerp_taps(const float v[8], float fx, float fy, float fz) {
  const float c00 = v[0] + (v[1] - v[0]) * fx;
  const float c01 = v[2] + (v[3] - v[2]) * fx;
  const float c10 = v[4] + (v[5] - v[4]) * fx;
  const float c11 = v[6] + (v[7] - v[6]) * fx;
  const float c0 = c00 + (c01 - c00) * fy;
  const float c1 = c10 + (c11 - c10) * fy;
  return c0 + (c1 - c0) * fz;
}

// One channel's trilinear value.
template <typename T, typename I>
__device__ __forceinline__ float lerp8(const T* ch, const Corners<I>& c) {
  float v[8];
  load8(v, ch, c);
  return lerp_taps(v, c.fx, c.fy, c.fz);
}

// The same value where a tap is not +-0, else +0: the lerps of +-0 taps
// give +-0, which every use here (a threshold test, a difference under
// fabsf, a product added to a sum, 1 - d) treats as +0.  The taps' bits are
// OR'd, sign off, and their conversions and lerps skipped where that is 0.
template <typename I>
__device__ __forceinline__ float lerp8_or_zero(const __nv_bfloat16* ch, const Corners<I>& c) {
  const unsigned short* raw = reinterpret_cast<const unsigned short*>(ch);
  unsigned b[8], any = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    b[k] = raw[c.o[k]];
    any |= b[k];
  }
  if ((any & 0x7fffu) == 0) return 0.0f;
  float v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = __uint_as_float(b[k] << 16);  // __bfloat162float
  return lerp_taps(v, c.fx, c.fy, c.fz);
}

template <typename I>
__device__ __forceinline__ float lerp8_or_zero(const float* ch, const Corners<I>& c) {
  float v[8];
  unsigned any = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    v[k] = __ldg(ch + c.o[k]);
    any |= __float_as_uint(v[k]);
  }
  if ((any & 0x7fffffffu) == 0) return 0.0f;
  return lerp_taps(v, c.fx, c.fy, c.fz);
}

__device__ __forceinline__ float to_tex(float p) { return p * 0.5f + 0.5f; }

__device__ __forceinline__ bool inside(float x, float y, float z) {
  return fabsf(x) <= 1.0f && fabsf(y) <= 1.0f && fabsf(z) <= 1.0f;
}

__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrtf((x * x + y * y) + z * z);
}

// GetStep (RayMarch.hlsli:200-210; raymarch_core.get_step).
__device__ __forceinline__ float get_step(float dd, float transm, float density, float scale) {
  const float fe = (1.0f / 256.0f) / fmaxf(fabsf(dd), 1.0f / 512.0f);
  const float fu = fminf(1.0f - density, 1.0f);
  const float ft = 1.0f - transm;
  return scale * fmaxf(1.5f * fe * fu * ft, 1.0f);
}

struct March {
  const float* env;
  float absorb, zero, light_step;
  int max_light, num_light, flags;
};

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

struct ViewArgs {
  Vol g, lm;
  const void* chan[4];     // the grid's channels (r, g, b, density), of its storage type
  const float* lm_chan[3]; // the light map's
  const float* light_map;  // null: merged
  const float* origin;     // (N, 3)
  const float* dir;        // (N, 3)
  const float* t_max;      // (N,)
  const uint8_t* active;   // (N,) bool
  const int* num_samples;
  const int* num_light_samples;
  float* out;              // (N, 4)
  int* samples;            // (N, 3) view, dense view and light samples taken, or null
  int64_t n;
  int max_ray;
  March m;
};

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

// R1's work: the rays as a (rows, cols) plane, row-major, cut into tiles of
// tile_w x (32 / tile_w) rays; slot s is ray l = s % 32 of tile s / 32,
// tiles row-major (view_plan).
struct Tiles {
  int rows, cols, tile_w, tiles_x;
  int slots;  // 32 x the tiles
};

// The ray of slot s, or -1 where the tile overhangs the plane.
__device__ __forceinline__ int ray_of_slot(int s, const Tiles& p) {
  const int tile = s / kTileRays, l = s % kTileRays;
  const int ty = tile / p.tiles_x, tx = tile - ty * p.tiles_x;
  const int row = ty * (kTileRays / p.tile_w) + l / p.tile_w;
  const int col = tx * p.tile_w + l % p.tile_w;
  if (row >= p.rows || col >= p.cols) return -1;
  return row * p.cols + col;
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

struct LightArgs {
  Vol g;
  const void* chan[4];  // the grid's channels, of its storage type (the new design reads them)
  const int* num_light_samples;
  float* out;    // (3, Z, Y, X)
  int* samples;  // (Z * Y * X,) light samples taken, or null
  March m;
};

// Voxel centres in local space [-1, 1] (CSRayMarchL.hlsl:20-22).
__device__ __forceinline__ void centre(int x, int y, int z, const Vol& g, float& px, float& py,
                                       float& pz) {
  px = (((float)x + 0.5f) / (float)g.nx) * 2.0f - 1.0f;
  py = (((float)y + 0.5f) / (float)g.ny) * 2.0f - 1.0f;
  pz = (((float)z + 0.5f) / (float)g.nz) * 2.0f - 1.0f;
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

// R2's bricks: 32 x by x bz voxels, nbx x nby x nbz of them, x fastest
// (light_plan).
struct Bricks {
  int by, bz, nbx, nby, nbz;
};

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

Vol vol(int nz, int ny, int nx) {
  return Vol{nx, ny, nz, (int64_t)nx * ny * nz, (float)nx, (float)ny, (float)nz,
             (float)nx + 1.0f, (float)ny + 1.0f, (float)nz + 1.0f};
}

// The channels of a (channels, ...) tensor at `base`, `size`-byte values.
template <typename P>
void channels(P* out, int n, const void* base, int64_t plane, int size) {
  for (int c = 0; c < n; ++c) out[c] = (P)((const char*)base + c * plane * size);
}

bool bad_vol(int nz, int ny, int nx) {
  return nz < 1 || ny < 1 || nx < 1 || (int64_t)nz * ny * nx > ((int64_t)1 << 40);
}

// 32-bit offsets reach every tap of `channels` channels of v.
bool fits32(const Vol& v, int channels) { return channels * v.plane < ((int64_t)1 << 31); }

int cdiv(int64_t a, int64_t b) { return (int)((a + b - 1) / b); }

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// CTAs of `kernel` (`threads` threads) an SM runs at once.
template <typename K>
int ctas_per_sm(K kernel, int threads) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  return per_sm > 0 ? per_sm : 1;
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

bool view_args(ViewArgs& a, const void* grid, int gz, int gy, int gx, const void* light_map,
               int lz, int ly, int lx, const void* env, const void* origin, const void* dir,
               const void* t_max, const void* active, const void* num_samples,
               const void* num_light_samples, void* out, void* samples, int64_t n, int max_ray,
               int max_light, float absorb, float zero, int flags) {
  if (n < 1 || max_ray < 1 || max_light < 1 || bad_vol(gz, gy, gx) ||
      (light_map != nullptr && bad_vol(lz, ly, lx)) || env == nullptr || grid == nullptr ||
      (light_map == nullptr && num_light_samples == nullptr)) {
    return false;
  }
  a = ViewArgs{};
  a.g = vol(gz, gy, gx);
  a.lm = light_map != nullptr ? vol(lz, ly, lx) : a.g;
  a.light_map = (const float*)light_map;
  a.origin = (const float*)origin;
  a.dir = (const float*)dir;
  a.t_max = (const float*)t_max;
  a.active = (const uint8_t*)active;
  a.num_samples = (const int*)num_samples;
  a.num_light_samples = (const int*)num_light_samples;
  a.out = (float*)out;
  a.samples = (int*)samples;
  a.n = n;
  a.max_ray = max_ray;
  a.m = March{(const float*)env, absorb, zero, 0.0f, max_light, 0, flags};
  return true;
}

bool light_args(LightArgs& a, int gz, int gy, int gx, const void* env,
                const void* num_light_samples, void* out, void* samples, int max_light,
                float absorb, float zero, int flags) {
  if (max_light < 1 || bad_vol(gz, gy, gx) || env == nullptr || num_light_samples == nullptr) {
    return false;
  }
  a = LightArgs{};
  a.g = vol(gz, gy, gx);
  a.num_light_samples = (const int*)num_light_samples;
  a.out = (float*)out;
  a.samples = (int*)samples;
  a.m = March{(const float*)env, absorb, zero, 0.0f, max_light, 0, flags};
  return true;
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
  if (!view_args(a, grid, gz, gy, gx, light_map, lz, ly, lx, env, origin, dir, t_max, active,
                 num_samples, num_light_samples, out, samples, n, max_ray, max_light, absorb,
                 zero, flags) ||
      rows < 1 || cols < 1 || (int64_t)rows * cols != n || (tile_w != 8 && tile_w != 32)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t tiles_x = (cols + tile_w - 1) / tile_w;
  const int64_t tiles_y = (rows + kTileRays / tile_w - 1) / (kTileRays / tile_w);
  if (kTileRays * tiles_x * tiles_y >= ((int64_t)1 << 31) ||
      (!wide && !(fits32(a.g, 4) && fits32(a.lm, 3)))) {
    return (int)cudaErrorInvalidValue;
  }
  const Tiles p{rows, cols, tile_w, (int)tiles_x, (int)(kTileRays * tiles_x * tiles_y)};
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
  if (grid == nullptr ||
      !light_args(a, gz, gy, gx, env, num_light_samples, out, samples, max_light, absorb, zero,
                  flags) ||
      by < 1 || bz < 1 || by * bz > kMaxBrickRows || (!wide && !fits32(a.g, 4))) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t nbx = (gx + kBrickX - 1) / kBrickX, nby = (gy + by - 1) / by,
                nbz = (gz + bz - 1) / bz;
  if (nbx * nby * nbz >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  const Bricks b{by, bz, (int)nbx, (int)nby, (int)nbz};
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
