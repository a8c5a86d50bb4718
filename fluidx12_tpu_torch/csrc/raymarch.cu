// The faithful stack's per-ray marches for Hopper: R1 (view rays) and R2
// (the light map).
//
// These replace no TPU kernel.  The JAX package runs these marches as XLA
// scans over all rays in lock step: raymarch_core.view_march (its scan over
// the view samples, in merged mode nesting a shadow scan and, with the light
// probe, an AO scan per sample) and lightmap.render_light_map (the shadow
// and AO scans over every voxel).  As plain PyTorch a merged frame would be
// some 300 000 launches; the reference itself runs one GPU thread per ray
// with early-outs (CSRayMarch.hlsl, PSRayCast.hlsl, CSRayMarchL.hlsl), and
// so do these kernels:
//
//   fx_view_march (R1): one thread per view ray.  It marches
//     raymarch_core.view_march: CLAMP trilinear samples of the (4, Z, Y, X)
//     colour grid, read in its storage type (bf16 -> f32 is exact), the
//     adaptive step, front-to-back accumulation with the opacity early-out,
//     and per dense sample either the light map's trilinear sample
//     (separate mode; the map has its own dims) or, in merged mode,
//     cast_light_ray toward the light and, with the probe, the 6-tap
//     density gradient, the SH irradiance and the AO ray.  The sample
//     counts (num_samples, num_light_samples) are read from device memory,
//     so the frame makes no host copy.  Output (N, 4) f32, rgb / (2 pi),
//     zero where the ray is inactive.
//   fx_light_march (R2): one thread per voxel of lightmap.render_light_map:
//     the voxel's density, the shadow ray only where it is at least
//     zero_threshold (else transmittance 1), and with the probe the SH
//     irradiance (0 where empty) times the AO ray (1 where empty).  Output
//     (3, Z, Y, X) f32.
//
// A thread stops where its ray dies, where the plain versions (lock step,
// masks) keep the ray's values unchanged, so the results are the same.  The
// arithmetic is the plain versions' op for op: the file builds with
// --fmad=false and IEEE division and square root, and a norm is
// sqrt((x*x + y*y) + z*z) on both sides, so a kernel agrees with its plain
// version to the last bit wherever the branches agree.
//
// Bound: the work depends on the data (where rays die), so it is counted
// from this run's samples: each kernel can write, per ray, the samples it
// took (`samples`, null in the frame): R1 its view samples, the dense ones
// among them and its light-ray samples, R2 its light-ray samples.  A sample is a
// trilinear gather (8 taps a channel) and some 20 to 100 f32 operations, so
// the marches are bound by operations and by the gathers' latency; the
// grid, read once, is a few microseconds of the card's memory rate.  This
// first design keeps one thread a ray and takes the taps through the L1;
// the design that would come near the bound (rays of a warp kept coherent,
// the grid's neighbourhood staged in shared memory) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
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

__device__ __forceinline__ float load(const float* p, int64_t i) { return __ldg(p + i); }
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}

struct Vol {
  int nx, ny, nz;
  int64_t plane;  // nx * ny * nz: the channel stride
};

// The 8 corners of a CLAMP trilinear sample and its fractions
// (ops/sampling.trilinear_sample): t = uvw * n - 0.5, floor, clamp.
struct Corners {
  int64_t o[8];  // (z, y, x) bits 000 .. 111
  float fx, fy, fz;
};

__device__ __forceinline__ void axis(float uvw, int n, int& i0, int& i1, float& f) {
  const float t = uvw * (float)n - 0.5f;
  const float t0 = floorf(t);
  f = t - t0;
  // Clamping t0 first keeps the int conversion in range and changes no index.
  const int i = (int)fminf(fmaxf(t0, -2.0f), (float)n + 1.0f);
  i0 = min(max(i, 0), n - 1);
  i1 = min(max(i + 1, 0), n - 1);
}

__device__ __forceinline__ Corners corners(float u, float v, float w, const Vol& g) {
  int x0, x1, y0, y1, z0, z1;
  Corners c;
  axis(u, g.nx, x0, x1, c.fx);
  axis(v, g.ny, y0, y1, c.fy);
  axis(w, g.nz, z0, z1, c.fz);
  const int64_t r00 = ((int64_t)z0 * g.ny + y0) * g.nx, r01 = ((int64_t)z0 * g.ny + y1) * g.nx;
  const int64_t r10 = ((int64_t)z1 * g.ny + y0) * g.nx, r11 = ((int64_t)z1 * g.ny + y1) * g.nx;
  c.o[0] = r00 + x0; c.o[1] = r00 + x1; c.o[2] = r01 + x0; c.o[3] = r01 + x1;
  c.o[4] = r10 + x0; c.o[5] = r10 + x1; c.o[6] = r11 + x0; c.o[7] = r11 + x1;
  return c;
}

// One channel's trilinear value, lerps along x, then y, then z.
template <typename T>
__device__ __forceinline__ float lerp8(const T* ch, const Corners& c) {
  float v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = load(ch, c.o[k]);
  const float c00 = v[0] + (v[1] - v[0]) * c.fx;
  const float c01 = v[2] + (v[3] - v[2]) * c.fx;
  const float c10 = v[4] + (v[5] - v[4]) * c.fx;
  const float c11 = v[6] + (v[7] - v[6]) * c.fx;
  const float c0 = c00 + (c01 - c00) * c.fy;
  const float c1 = c10 + (c11 - c10) * c.fy;
  return c0 + (c1 - c0) * c.fz;
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
// transm0 = 1, counting its samples into *taken.
template <typename T>
__device__ float cast_light_ray(const T* dens, const Vol& g, float ox, float oy, float oz,
                                float dx, float dy, float dz, const March& m, int& taken) {
  float t = m.light_step, transm = 1.0f, prev = 0.0f;
  if (!(transm >= m.zero)) return transm;
  for (int i = 0; i < m.max_light && i < m.num_light; ++i) {
    const float px = ox + dx * t, py = oy + dy * t, pz = oz + dz * t;
    if (!inside(px, py, pz)) break;
    ++taken;
    const float d = lerp8(dens, corners(to_tex(px), to_tex(py), to_tex(pz), g));
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
// AO 1 (CSRayMarchL.hlsl:43).
template <typename T>
__device__ void light_at(const T* grid, const Vol& g, float px, float py, float pz, bool dense,
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
    shadow = cast_light_ray(grid + 3 * g.plane, g, px, py, pz, lx, ly, lz, m, taken);
  }
  float amb[3] = {env[kAmbient], env[kAmbient + 1], env[kAmbient + 2]};
  if (m.flags & kProbe) {
    float irr[3] = {0.0f, 0.0f, 0.0f}, ao = 1.0f;
    if (dense) {
      // The 6-tap gradient of the density (RayMarch.hlsli:73-95), negated.
      const T* dens = grid + 3 * g.plane;
      const float u = to_tex(px), v = to_tex(py), w = to_tex(pz);
      const float tx = (float)(1.0 / g.nx), ty = (float)(1.0 / g.ny), tz = (float)(1.0 / g.nz);
      float gx = -(lerp8(dens, corners(u + tx, v, w, g)) - lerp8(dens, corners(u - tx, v, w, g)));
      float gy = -(lerp8(dens, corners(u, v + ty, w, g)) - lerp8(dens, corners(u, v - ty, w, g)));
      float gz = -(lerp8(dens, corners(u, v, w + tz, g)) - lerp8(dens, corners(u, v, w - tz, g)));
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
      ao = cast_light_ray(dens, g, px, py, pz, gx / gn, gy / gn, gz / gn, m, taken);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) amb[c] = irr[c] * ao;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = env[kColor + c] * shadow + amb[c];
}

struct ViewArgs {
  Vol g, lm;
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

// R1 (raymarch_core.view_march), one thread a ray.
template <typename T>
__global__ void __launch_bounds__(kThreads) view_march_kernel(ViewArgs a, const T* grid) {
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
      const Corners c = corners(u, v, w, a.g);
      const float ca = lerp8(grid + 3 * a.g.plane, c);
      float step = step_scale;
      if (ca > m.zero) {
        ++dense;
        float cr = lerp8(grid, c), cg = lerp8(grid + a.g.plane, c);
        float cb = lerp8(grid + 2 * a.g.plane, c);
        float light[3];
        if (a.light_map != nullptr) {
          const Corners lc = corners(u, v, w, a.lm);
#pragma unroll
          for (int k = 0; k < 3; ++k) light[k] = lerp8(a.light_map + k * a.lm.plane, lc);
        } else {
          light_at(grid, a.g, px, py, pz, true, m, light, lights);
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

struct LightArgs {
  Vol g;
  const int* num_light_samples;
  float* out;    // (3, Z, Y, X)
  int* samples;  // (Z * Y * X,) light samples taken, or null
  March m;
};

// R2 (lightmap.render_light_map), one thread a voxel.
template <typename T>
__global__ void __launch_bounds__(kThreads) light_march_kernel(LightArgs a, const T* grid) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.g.plane) return;
  const int x = (int)(i % a.g.nx), y = (int)((i / a.g.nx) % a.g.ny);
  const int z = (int)(i / ((int64_t)a.g.nx * a.g.ny));
  March m = a.m;
  m.num_light = *a.num_light_samples;
  m.light_step = kMaxDist / (float)m.num_light;
  // Voxel centres in local space [-1, 1] (CSRayMarchL.hlsl:20-22).
  const float px = (((float)x + 0.5f) / (float)a.g.nx) * 2.0f - 1.0f;
  const float py = (((float)y + 0.5f) / (float)a.g.ny) * 2.0f - 1.0f;
  const float pz = (((float)z + 0.5f) / (float)a.g.nz) * 2.0f - 1.0f;
  const float d_here =
      lerp8(grid + 3 * a.g.plane, corners(to_tex(px), to_tex(py), to_tex(pz), a.g));
  float light[3];
  int taken = 0;
  light_at(grid, a.g, px, py, pz, d_here >= m.zero, m, light, taken);
#pragma unroll
  for (int c = 0; c < 3; ++c) a.out[c * a.g.plane + i] = light[c];
  if (a.samples != nullptr) a.samples[i] = taken;
}

Vol vol(int nz, int ny, int nx) { return Vol{nx, ny, nz, (int64_t)nx * ny * nz}; }

bool bad_vol(int nz, int ny, int nx) {
  return nz < 1 || ny < 1 || nx < 1 || (int64_t)nz * ny * nx > ((int64_t)1 << 40);
}

}  // namespace

extern "C" {

// R1.  grid (4, gz, gy, gx), bf16 when grid_bf16 else f32; light_map
// (3, lz, ly, lx) f32 (separate mode) or null (merged); env the packed
// light environment (48 f32); origin and dir (n, 3), t_max (n,) f32, active
// (n,) bool; num_samples and num_light_samples device int32 scalars; out
// (n, 4) f32; samples (n, 3) int32 or null.  flags: 1 premultiplied colour,
// 2 light probe, 4 point light.
int fx_view_march(const void* grid, int grid_bf16, int gz, int gy, int gx, const void* light_map,
                  int lz, int ly, int lx, const void* env, const void* origin, const void* dir,
                  const void* t_max, const void* active, const void* num_samples,
                  const void* num_light_samples, void* out, void* samples, int64_t n,
                  int max_ray, int max_light, float absorb, float zero, int flags,
                  void* stream) {
  if (n < 1 || max_ray < 1 || max_light < 1 || bad_vol(gz, gy, gx) ||
      (light_map != nullptr && bad_vol(lz, ly, lx)) || env == nullptr ||
      (light_map == nullptr && num_light_samples == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  ViewArgs a;
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
  const dim3 blocks((unsigned)((n + kThreads - 1) / kThreads));
  cudaStream_t s = (cudaStream_t)stream;
  if (grid_bf16) {
    view_march_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        a, (const __nv_bfloat16*)grid);
  } else {
    view_march_kernel<float><<<blocks, kThreads, 0, s>>>(a, (const float*)grid);
  }
  return (int)cudaGetLastError();
}

// R2.  grid (4, gz, gy, gx) as fx_view_march's; env, num_light_samples,
// absorb, zero and flags as there; out (3, gz, gy, gx) f32; samples
// (gz * gy * gx,) int32 or null.
int fx_light_march(const void* grid, int grid_bf16, int gz, int gy, int gx, const void* env,
                   const void* num_light_samples, void* out, void* samples, int max_light,
                   float absorb, float zero, int flags, void* stream) {
  if (max_light < 1 || bad_vol(gz, gy, gx) || env == nullptr || num_light_samples == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  LightArgs a;
  a.g = vol(gz, gy, gx);
  a.num_light_samples = (const int*)num_light_samples;
  a.out = (float*)out;
  a.samples = (int*)samples;
  a.m = March{(const float*)env, absorb, zero, 0.0f, max_light, 0, flags};
  const dim3 blocks((unsigned)((a.g.plane + kThreads - 1) / kThreads));
  cudaStream_t s = (cudaStream_t)stream;
  if (grid_bf16) {
    light_march_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        a, (const __nv_bfloat16*)grid);
  } else {
    light_march_kernel<float><<<blocks, kThreads, 0, s>>>(a, (const float*)grid);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
