// Jacobi pressure sweeps for Hopper: B4, B6, B13, B14 and B18.
//
// fx_jacobi replaces fluidx12_tpu/ops/pallas/jacobi.py _jacobi_fused_kernel /
// _window_sweeps (B4, via jacobi_pallas; order 0, and order 1 for the
// plane-sweep plan _planewise_window / _planewise_fused_kernel),
// _jacobi_packed_kernel (B6, via jacobi_packed_pallas; order 2) and
// _jacobi2d_kernel (B14, via jacobi2d_pallas; order 3, on one (Y, X)
// plane).  fx_jacobi_rr replaces _planewise_rr_kernel (B13, via
// jacobi_pallas_rr): the order-1 sweeps, then the multigrid's residual and
// 2x restriction in one more launch (see residual_restrict_kernel).  Each is `iters`
// synchronous sweeps of
//     q <- (sum of the 6 edge-clamped neighbours - b) / 6
// in f32 (in 2D the 4 neighbours, over 4).  The TPU kernels' halo'd VMEM
// windows (recomputed halos, exact in the centre), 64-lane packing and
// resident 2D plane are layouts with no effect on the result; what they fix
// is the order of the neighbour sum, which the template argument keeps:
//   order 0 (B4, whole window): y+, y-, x+, x-, z+, z-   (jacobi.py:88)
//   order 1 (B4, plane sweep):  y+, y-, x+, x-, z-, z+   (jacobi.py:285-287)
//   order 2 (B6, packed):       x+, x-, y+, y-, z+, z-   (jacobi.py:833-842)
//   order 3 (B14, 2D):          y+, y-, x+, x-           (jacobi.py:773-774)
// The division is a true f32 division and the file builds with
// --fmad=false, so each sweep rounds as the Pallas code does (B14's
// division by 4 is exact, so it matches interpret mode bit for bit).
//
// Bound: memory.  Counted once in and once out, a call moves q, b in and q
// out (12 B per cell): 25.2 MB at 128^3 (7.5 us at 3.35 TB/s) and 3.1 MB at
// the 64^3 coarse level (0.94 us; its 32 sweeps' 58.7 MFLOP take 0.88 us at
// 67 TFLOP/s).  B14 at the 2D preset's 512^2 moves 3.1 MB (0.94 us) and
// does 64 sweeps of 5 operations per cell, 83.9 MFLOP (1.25 us): bound by
// operations.  The TPU keeps the 1 MiB plane in VMEM for all 64 sweeps; it
// is larger than one SM's shared memory, so here each sweep is a launch
// over the plane, which stays in L2 between sweeps.  Design: one thread per
// cell per sweep, consecutive threads on consecutive x; the sweeps ping-pong
// between the output and one scratch buffer, launched `iters` times from
// this one C entry point, so a call costs one Python call however many
// sweeps it runs.  Each sweep re-streams
// q and b: 25 MB at 128^3 and 3 MB at 64^3 fit the 50 MB L2, so the re-reads
// are L2 traffic.  Temporal blocking in shared memory (several sweeps per
// launch) is later work.
//
// B13 at 256^3 moves q, b in and q out (201 MB) plus the (128^3) f32 coarse
// residual out (8.4 MB): 62.6 us at 3.35 TB/s, bound by bytes.  There each
// volume is 67 MB, more than L2, so each of its 4 sweeps streams q, b and
// the result through HBM, and the epilogue reads q and b once more.  The TPU
// keeps the window in VMEM and writes only the coarse residual; here the
// epilogue is a second launch, one thread per coarse cell, that forms the
// eight fine residuals of its 2x2x2 block from q and b (the full residual is
// never stored) and pools them in the TPU epilogue's order
// (jacobi.py:321-351):
//   r    = b - (y+ + y- + x+ + x- + z- + z+ - 6 q), edges clamped;
//   s    = r[2zc] + r[2zc+1]                   (the z pair first)
//   xz   = (s[x=2xc] * w + s[x=2xc+1] * w) * 0.5, w = fl32(0.5 * scale)
//   r_c  = 0.5 * xz[y=2yc] + 0.5 * xz[y=2yc+1]
// The two dots of the TPU code have exactly these two non-zero terms each.
//
// B18, the fused projection (sim/mg.py mg_project_fused), is two entry
// points.  fx_jacobi_divrr replaces _planewise_divrr_kernel (via
// jacobi_pallas_divrr): b = divergence of the velocity channels, computed
// as B3 computes it (stencil.cuh divergence_at; the Pallas prologue sums
// 0.5 * (dx + dy + (zp - zm)), the same order), then B13's sweeps and
// epilogue; it returns q, b and r_c.  A sweep reads b only at its own
// cell, so the first launch computes b per cell, writes it and makes the
// first sweep in the same pass (divergence_sweep_kernel): exact, and one
// velocity read, b's re-read and one launch fewer than B3 then B13.
// fx_jacobi_grad replaces _planewise_grad_kernel (via jacobi_pallas_grad):
// the order-1 sweeps, then B8's gradient + wall-band damp (stencil.cuh
// grad_damp_kernel) on the final q, in place on channels 0..2 of the
// state; the Pallas epilogue's arithmetic is B8's (gy through a one-hot
// dot with two non-zero terms, the same wall positions and band).  So B18
// gives the port's unfused chain B3 -> B13 -> ... -> B4 -> B8 bit for bit,
// as the TPU kernels give theirs (core/config.py:133).
// Bound at 256^3: the head reads q and the three bf16 velocity channels
// and writes q, b and the coarse r_c, 18.5 B per cell, 310.4 MB, 92.7 us at
// 3.35 TB/s; the tail reads q, b and the velocity and writes q and the
// velocity, 24 B per cell, 402.7 MB, 120.2 us.  Each of their sweeps
// streams 201 MB through HBM as B13's do; holding several sweeps of a
// z-slab in shared memory (the TPU's windows), and the last sweep inside
// the gradient epilogue, is later work.

#include "stencil.cuh"

namespace {

template <int kOrder>
__global__ void jacobi_sweep_kernel(const float* __restrict__ q, const float* __restrict__ b,
                                    float* __restrict__ out, int nz, int ny, int nx) {
  const int64_t plane = (int64_t)ny * nx;
  const int64_t n = (int64_t)nz * plane;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int x = (int)(idx % nx);
  const int y = (int)((idx / nx) % ny);
  const int z = (int)(idx / plane);
  const float xp = q[x < nx - 1 ? idx + 1 : idx];
  const float xm = q[x > 0 ? idx - 1 : idx];
  const float yp = q[y < ny - 1 ? idx + nx : idx];
  const float ym = q[y > 0 ? idx - nx : idx];
  if (kOrder == 3) {  // 2D: one plane, four neighbours
    float s = yp + ym;
    s = s + xp;
    s = s + xm;
    out[idx] = (s - b[idx]) / 4.0f;
    return;
  }
  const float zp = q[z < nz - 1 ? idx + plane : idx];
  const float zm = q[z > 0 ? idx - plane : idx];
  float s;
  if (kOrder == 2) {
    s = xp + xm;
    s = s + yp;
    s = s + ym;
  } else {
    s = yp + ym;
    s = s + xp;
    s = s + xm;
  }
  if (kOrder == 1) {
    s = s + zm;
    s = s + zp;
  } else {
    s = s + zp;
    s = s + zm;
  }
  out[idx] = (s - b[idx]) / 6.0f;
}

// Where sweep k of `iters` writes: the last one writes `out`; count back
// from it, alternating with `scratch`.
inline float* sweep_dst(int k, int iters, float* out, float* scratch) {
  return ((iters - 1 - k) % 2 == 0) ? out : scratch;
}

// Sweeps k0 .. iters - 1 of q (the result of sweep k0 - 1, or the input).
template <int kOrder>
cudaError_t sweeps(const float* q, const float* b, float* out, float* scratch, int k0,
                   int iters, int nz, int ny, int nx, cudaStream_t st) {
  const unsigned blocks = blocks_for((int64_t)nz * ny * nx);
  const float* src = q;
  for (int k = k0; k < iters; ++k) {
    float* dst = sweep_dst(k, iters, out, scratch);
    jacobi_sweep_kernel<kOrder><<<blocks, kThreads, 0, st>>>(src, b, dst, nz, ny, nx);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return cudaSuccess;
}

// The neighbour sum of cell k in the plane-sweep order y+, y-, x+, x-,
// z-, z+ (jacobi_sweep_kernel<1>'s).
__device__ __forceinline__ float planewise_sum(const float* __restrict__ q, const Cell& k) {
  float s = q[k.yp] + q[k.ym];
  s = s + q[k.xp];
  s = s + q[k.xm];
  s = s + q[k.zm];
  return s + q[k.zp];
}

// The residual b - A q of fine cell (z, y, x), summed in the plane-sweep
// order.
__device__ __forceinline__ float planewise_residual(const float* __restrict__ q,
                                                    const float* __restrict__ b, int z, int y,
                                                    int x, int nz, int ny, int nx) {
  const int64_t plane = (int64_t)ny * nx;
  const int64_t idx = (int64_t)z * plane + (int64_t)y * nx + x;
  float s = q[y < ny - 1 ? idx + nx : idx] + q[y > 0 ? idx - nx : idx];
  s = s + q[x < nx - 1 ? idx + 1 : idx];
  s = s + q[x > 0 ? idx - 1 : idx];
  s = s + q[z > 0 ? idx - plane : idx];
  s = s + q[z < nz - 1 ? idx + plane : idx];
  return b[idx] - (s - 6.0f * q[idx]);
}

// B18's first launch: b = the divergence of channels 0..2 of f at each cell,
// written to b, and (with out non-null) the first order-1 sweep of q
// against it, written to out.
template <typename T>
__global__ void divergence_sweep_kernel(const T* __restrict__ f, const float* __restrict__ q,
                                        float* __restrict__ b, float* __restrict__ out, int nz,
                                        int ny, int nx) {
  const int64_t n = (int64_t)nz * ny * nx;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const Cell k = cell_at(idx, nz, ny, nx);
  const float bv = divergence_at(f, k, n);
  b[idx] = bv;
  if (out != nullptr) out[idx] = (planewise_sum(q, k) - bv) / 6.0f;
}

// One thread per coarse cell (nz/2, ny/2, nx/2); w = fl32(0.5 * scale).
__global__ void residual_restrict_kernel(const float* __restrict__ q,
                                         const float* __restrict__ b,
                                         float* __restrict__ rc, float w, int nz, int ny,
                                         int nx) {
  const int nzc = nz / 2, nyc = ny / 2, nxc = nx / 2;
  const int64_t n = (int64_t)nzc * nyc * nxc;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int xc = (int)(idx % nxc);
  const int yc = (int)((idx / nxc) % nyc);
  const int zc = (int)(idx / ((int64_t)nyc * nxc));
  float xz[2];
  for (int j = 0; j < 2; ++j) {
    const int y = 2 * yc + j;
    float s[2];
    for (int i = 0; i < 2; ++i) {
      const int x = 2 * xc + i;
      s[i] = planewise_residual(q, b, 2 * zc, y, x, nz, ny, nx) +
             planewise_residual(q, b, 2 * zc + 1, y, x, nz, ny, nx);
    }
    xz[j] = (s[0] * w + s[1] * w) * 0.5f;
  }
  rc[idx] = 0.5f * xz[0] + 0.5f * xz[1];
}

}  // namespace

extern "C" {

// q, b, out, scratch (nz, ny, nx) f32; q is read only.  order 0..3 as above.
int fx_jacobi(const void* q, const void* b, void* out, void* scratch, int iters, int order,
              int nz, int ny, int nx, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* qf = (const float*)q;
  const float* bf = (const float*)b;
  float* of = (float*)out;
  float* sf = (float*)scratch;
  if (iters == 0) {
    return (int)cudaMemcpyAsync(of, qf, (size_t)nz * ny * nx * sizeof(float),
                                cudaMemcpyDeviceToDevice, st);
  }
  switch (order) {
    case 0: return (int)sweeps<0>(qf, bf, of, sf, 0, iters, nz, ny, nx, st);
    case 1: return (int)sweeps<1>(qf, bf, of, sf, 0, iters, nz, ny, nx, st);
    case 2: return (int)sweeps<2>(qf, bf, of, sf, 0, iters, nz, ny, nx, st);
    case 3: return (int)sweeps<3>(qf, bf, of, sf, 0, iters, nz, ny, nx, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// B13: `iters` order-1 sweeps of q (out_q, with scratch as fx_jacobi), then
// rc (nz/2, ny/2, nx/2) = restrict(b - A out_q) * scale, w = fl32(0.5 * scale).
// All dims even.
int fx_jacobi_rr(const void* q, const void* b, void* out_q, void* scratch, void* rc,
                 int iters, float w, int nz, int ny, int nx, void* stream) {
  int err = fx_jacobi(q, b, out_q, scratch, iters, 1, nz, ny, nx, stream);
  if (err != 0) return err;
  residual_restrict_kernel<<<blocks_for((int64_t)(nz / 2) * (ny / 2) * (nx / 2)), kThreads, 0,
                             (cudaStream_t)stream>>>((const float*)out_q, (const float*)b,
                                                     (float*)rc, w, nz, ny, nx);
  return (int)cudaGetLastError();
}

// B18 head: b (nz, ny, nx) f32 = the divergence of channels 0..2 of fields
// (C >= 3, nz, ny, nx) bf16 (is_bf16) or f32; then as fx_jacobi_rr: `iters`
// order-1 sweeps of q against b into out_q (with scratch), and rc =
// restrict(b - A out_q) * scale, w = fl32(0.5 * scale).  All dims even.
int fx_jacobi_divrr(const void* fields, int is_bf16, const void* q, void* out_q, void* scratch,
                    void* b, void* rc, int iters, float w, int nz, int ny, int nx,
                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned blocks = blocks_for((int64_t)nz * ny * nx);
  const float* qf = (const float*)q;
  float* bf = (float*)b;
  float* first = iters > 0 ? sweep_dst(0, iters, (float*)out_q, (float*)scratch) : nullptr;
  if (is_bf16) {
    divergence_sweep_kernel<<<blocks, kThreads, 0, st>>>((const __nv_bfloat16*)fields, qf, bf,
                                                         first, nz, ny, nx);
  } else {
    divergence_sweep_kernel<<<blocks, kThreads, 0, st>>>((const float*)fields, qf, bf, first,
                                                         nz, ny, nx);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (iters == 0) {
    err = cudaMemcpyAsync(out_q, q, (size_t)nz * ny * nx * sizeof(float),
                          cudaMemcpyDeviceToDevice, st);
  } else {
    err = sweeps<1>(first, bf, (float*)out_q, (float*)scratch, 1, iters, nz, ny, nx, st);
  }
  if (err != cudaSuccess) return (int)err;
  residual_restrict_kernel<<<blocks_for((int64_t)(nz / 2) * (ny / 2) * (nx / 2)), kThreads, 0,
                             st>>>((const float*)out_q, bf, (float*)rc, w, nz, ny, nx);
  return (int)cudaGetLastError();
}

// B18 tail: `iters` order-1 sweeps of q against b into out_q (with
// scratch, as fx_jacobi), then channels 0..2 of fields (C >= 3, nz, ny, nx)
// bf16 (is_bf16) or f32 -= the gradient of out_q times s = fl32(0.5 / rho),
// with the wall-band damp, in place.
int fx_jacobi_grad(const void* q, const void* b, void* out_q, void* scratch, void* fields,
                   int is_bf16, float s, int iters, int nz, int ny, int nx, void* stream) {
  int err = fx_jacobi(q, b, out_q, scratch, iters, 1, nz, ny, nx, stream);
  if (err != 0) return err;
  return (int)launch_grad_damp(fields, (const float*)out_q, s, is_bf16, nz, ny, nx,
                               (cudaStream_t)stream);
}

}  // extern "C"
