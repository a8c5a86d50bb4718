// Device and host pieces shared by the faithful stack's marches (raymarch.cu:
// R1 and R2) and their adjoints (raymarch_grad.cu: R1b and R2b): the packed
// light environment's layout, CLAMP trilinear taps and their lerps, the
// adaptive step, the kernels' argument blocks, the work layouts (R1's tiles
// of rays, R2's bricks of voxels) and the launch helpers.  Both
// files build with --fmad=false, so a sample recomputed in R1b or R2b equals
// the one R1 or R2 took, to the last bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMaxDist = 3.4641016151377544f;  // 2 sqrt(3), RayMarch.hlsli:29
constexpr float kInv2Pi = (float)(1.0 / (2.0 * 3.14159265358979323846));

// The packed light environment (render/raymarch_core.pack_env): light_dir,
// light_pos, light_color, ambient (3 each), world3x3 row-major (9), SH (9, 3).
enum EnvSlot { kDir = 0, kPos = 3, kColor = 6, kAmbient = 9, kWorld = 12, kSh = 21,
               kEnvSize = 48 };

enum Flags { kPremultiplied = 1, kProbe = 2, kPointLight = 4 };

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

// The work layouts R1 and R1b (tiles of rays), R2 and R2b (bricks of
// voxels) share.
constexpr int kBrickX = 32;         // a brick's voxels along x: one a lane
constexpr int kMaxBrickRows = 32;   // by * bz at most: a lane's dense bits in one word
constexpr int kTileRays = 32;       // a tile: a warp's rays
constexpr unsigned kFull = 0xffffffffu;

// The rays as a (rows, cols) plane, row-major, cut into tiles of tile_w x
// (32 / tile_w) rays; slot s is ray l = s % 32 of tile s / 32, tiles
// row-major (view_plan).
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

// The tiles of n rays as (rows, cols), or false where no kernel takes
// that plan.
bool tiles(int64_t n, int rows, int cols, int tile_w, Tiles& p) {
  if (rows < 1 || cols < 1 || (int64_t)rows * cols != n || (tile_w != 8 && tile_w != 32)) {
    return false;
  }
  const int64_t tiles_x = (cols + tile_w - 1) / tile_w;
  const int64_t tiles_y = (rows + kTileRays / tile_w - 1) / (kTileRays / tile_w);
  if (kTileRays * tiles_x * tiles_y >= ((int64_t)1 << 31)) return false;
  p = Tiles{rows, cols, tile_w, (int)tiles_x, (int)(kTileRays * tiles_x * tiles_y)};
  return true;
}

// Bricks of 32 x by x bz voxels, nbx x nby x nbz of them, x fastest
// (light_plan).
struct Bricks {
  int by, bz, nbx, nby, nbz;
};

// The bricks of grid g, or false where no kernel takes that plan.
bool bricks(const Vol& g, int by, int bz, Bricks& b) {
  if (by < 1 || bz < 1 || by * bz > kMaxBrickRows) return false;
  const int64_t nbx = (g.nx + kBrickX - 1) / kBrickX, nby = (g.ny + by - 1) / by,
                nbz = (g.nz + bz - 1) / bz;
  if (nbx * nby * nbz >= ((int64_t)1 << 31)) return false;
  b = Bricks{by, bz, (int)nbx, (int)nby, (int)nbz};
  return true;
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
