// K5 cprinner: CPR's inner pressure solve in one launch.
//
// Replaces the TPU kernel opm_autodiff_tpu/ops/pallas_cprinner.py
// (inner_solve_bands / _make_kernel): a fixed number of Jacobi-
// preconditioned BiCGStab iterations on the scalar 7-point pressure
// system, zero initial guess, breakdown guards at 1e-30, float32. It
// computes what the Pallas kernel computes, iteration for iteration.
//
// Design. On the TPU the whole system sits in VMEM. On Hopper it does
// not fit on chip at the sizes the port runs (1.12M cells: 8 input arrays
// and 8 Krylov vectors of 4.5 MB each), so the vectors live in a
// workspace in device memory and the solve is ONE persistent cooperative
// launch: every block loops over its cells (grid-stride), and a grid-wide
// barrier (cooperative_groups grid sync) separates the phases where a
// matvec reads its neighbours' values or a scalar of a dot product is
// needed. Five phases per iteration:
//   1. beta; p = r + beta (p - omega v); phat = p / d
//   2. v = A phat;  partial <b, v>
//   3. alpha; s = r - alpha v; shat = s / d
//   4. t = A shat;  partials <t, t>, <t, s>
//   5. omega; x += alpha phat + omega shat; r = s - omega t; partial <b, r>
// (rhat = r0 = b, so b stands in for rhat.)
//
// Deterministic dot products: each thread sums its cells in float, the
// block reduces warp by warp (shuffles) and across warps in double in a
// fixed order into partials[block][slot]; after the barrier EVERY block
// sums all blocks' partials in the same fixed order, so every block holds
// bit-identical scalars and takes the same branch at every guard. Each
// dot product has its own slot, so a slot is never rewritten before all
// blocks have read it (a barrier always lies in between).
//
// Bound: bytes. The function reads 8 arrays and writes one; the
// iterations move ~39 floats per cell each through device memory (the
// working set exceeds the 50 MB L2 at the SPE10 grid), against ~48 flops
// per cell.
//
// Layouts: p_diag / b / x [nz,ny,nx]; px_* [nz,ny,nx-1]; py_* [nz,ny-1,nx];
// pz_* [nz-1,ny,nx]; x fastest. Band presence is decided from the cell's
// grid position, so singleton axes (zero-width bands) need no padding.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// partial-sum slots per block: <b,r>, <b,v>, <t,t>, <t,s>
constexpr int SLOTS = 4;
constexpr int S_RHO = 0, S_DEN = 1, S_TT = 2, S_TS = 3;

struct Args {
  const float* __restrict__ d;
  const float* __restrict__ pxl;
  const float* __restrict__ pxr;
  const float* __restrict__ pyl;
  const float* __restrict__ pyr;
  const float* __restrict__ pzl;
  const float* __restrict__ pzr;
  const float* __restrict__ b;
  // written inside the launch: no __restrict__/const, so no load of them
  // goes through the non-coherent read-only path
  float* x;
  float* r;
  float* p;
  float* v;
  float* phat;
  float* s;
  float* shat;
  float* t;
  double* partials;  // [gridDim.x][SLOTS]
  int nx, ny, nz, iters;
};

__device__ __forceinline__ float inv_diag(float d) {
  return 1.f / (fabsf(d) > 0.f ? d : 1.f);
}

// y_c = (A u)_c in the reference's order: diagonal, x+, x-, y+, y-, z+, z-
__device__ __forceinline__ float matvec(const Args& a, const float* u,
                                        long long c) {
  const int nx = a.nx, ny = a.ny, nz = a.nz;
  const long long nxy = (long long)nx * ny;
  const int i = (int)(c % nx);
  const int j = (int)((c / nx) % ny);
  const int k = (int)(c / nxy);
  float y = a.d[c] * u[c];
  if (i < nx - 1) y += a.pxl[((long long)k * ny + j) * (nx - 1) + i] * u[c + 1];
  if (i > 0) y += a.pxr[((long long)k * ny + j) * (nx - 1) + i - 1] * u[c - 1];
  if (j < ny - 1) y += a.pyl[((long long)k * (ny - 1) + j) * nx + i] * u[c + nx];
  if (j > 0) y += a.pyr[((long long)k * (ny - 1) + j - 1) * nx + i] * u[c - nx];
  if (k < nz - 1) y += a.pzl[c] * u[c + nxy];
  if (k > 0) y += a.pzr[c - nxy] * u[c - nxy];
  return y;
}

// block sum of NV per-thread values into partials[blockIdx.x][slot0..]
template <int NV>
__device__ void block_partials(const float (&val)[NV], double* partials,
                               int slot0, double (*smem)[WARPS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    double s = (double)val[q];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) smem[q][warp] = s;
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    double s = 0.0;
    for (int w = 0; w < WARPS; ++w) s += smem[threadIdx.x][w];
    partials[(long long)blockIdx.x * SLOTS + slot0 + threadIdx.x] = s;
  }
  __syncthreads();
}

// sum of every block's partials in one fixed order (the same in every
// block): each thread a strided subset, then the block tree
template <int NV>
__device__ void grid_sums(const double* partials, int slot0, float (&out)[NV],
                          double (*smem)[WARPS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double acc[NV];
#pragma unroll
  for (int q = 0; q < NV; ++q) acc[q] = 0.0;
  for (int g = threadIdx.x; g < (int)gridDim.x; g += THREADS) {
#pragma unroll
    for (int q = 0; q < NV; ++q)
      acc[q] += partials[(long long)g * SLOTS + slot0 + q];
  }
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    double s = acc[q];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) smem[q][warp] = s;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    double s = 0.0;
    for (int w = 0; w < WARPS; ++w) s += smem[q][w];
    out[q] = (float)s;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
cprinner_kernel(Args a) {
  __shared__ double smem[2][WARPS];
  cg::grid_group grid = cg::this_grid();
  const long long n = (long long)a.nx * a.ny * a.nz;
  const long long stride = (long long)gridDim.x * THREADS;
  const long long c0 = (long long)blockIdx.x * THREADS + threadIdx.x;

  // x = 0, r = b, p = v = 0; partial <b, r>
  float part[1] = {0.f};
  for (long long c = c0; c < n; c += stride) {
    const float bc = a.b[c];
    a.x[c] = 0.f;
    a.r[c] = bc;
    a.p[c] = 0.f;
    a.v[c] = 0.f;
    part[0] += bc * bc;
  }
  block_partials<1>(part, a.partials, S_RHO, smem);
  grid.sync();

  float rho = 1.f, alpha = 1.f, omega = 1.f;
  for (int it = 0; it < a.iters; ++it) {
    // 1. beta; p; phat
    float rs[1];
    grid_sums<1>(a.partials, S_RHO, rs, smem);
    const float rho_new = rs[0];
    const bool safe = fabsf(rho * omega) > 1e-30f;
    const float beta = safe ? (rho_new / rho) * (alpha / omega) : 0.f;
    for (long long c = c0; c < n; c += stride) {
      const float pc = a.r[c] + beta * (a.p[c] - omega * a.v[c]);
      a.p[c] = pc;
      a.phat[c] = inv_diag(a.d[c]) * pc;
    }
    grid.sync();

    // 2. v = A phat; partial <b, v>
    float pd[1] = {0.f};
    for (long long c = c0; c < n; c += stride) {
      const float vc = matvec(a, a.phat, c);
      a.v[c] = vc;
      pd[0] += a.b[c] * vc;
    }
    block_partials<1>(pd, a.partials, S_DEN, smem);
    grid.sync();

    // 3. alpha; s; shat
    float ds[1];
    grid_sums<1>(a.partials, S_DEN, ds, smem);
    const float den = ds[0];
    const float alpha_new = fabsf(den) > 1e-30f ? rho_new / den : 0.f;
    for (long long c = c0; c < n; c += stride) {
      const float sc = a.r[c] - alpha_new * a.v[c];
      a.s[c] = sc;
      a.shat[c] = inv_diag(a.d[c]) * sc;
    }
    grid.sync();

    // 4. t = A shat; partials <t, t>, <t, s>
    float pt[2] = {0.f, 0.f};
    for (long long c = c0; c < n; c += stride) {
      const float tc = matvec(a, a.shat, c);
      a.t[c] = tc;
      pt[0] += tc * tc;
      pt[1] += tc * a.s[c];
    }
    block_partials<2>(pt, a.partials, S_TT, smem);
    grid.sync();

    // 5. omega; x; r; partial <b, r> for the next iteration
    float ts[2];
    grid_sums<2>(a.partials, S_TT, ts, smem);
    const float omega_new = ts[0] > 0.f ? ts[1] / ts[0] : 0.f;
    const bool last = it == a.iters - 1;
    float pr[1] = {0.f};
    for (long long c = c0; c < n; c += stride) {
      a.x[c] = (a.x[c] + alpha_new * a.phat[c]) + omega_new * a.shat[c];
      const float rc = a.s[c] - omega_new * a.t[c];
      a.r[c] = rc;
      pr[0] += a.b[c] * rc;
    }
    rho = rho_new;
    alpha = alpha_new;
    omega = omega_new;
    if (last) break;
    block_partials<1>(pr, a.partials, S_RHO, smem);
    grid.sync();
  }
}

int g_blocks_per_sm = -1;
int g_sms = 0;

// co-resident blocks of the kernel on the current device (0 when the
// device cannot launch cooperatively)
int max_blocks() {
  if (g_blocks_per_sm < 0) {
    int dev = 0, coop = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 0;
    cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cprinner_kernel,
                                                  THREADS, 0);
    g_blocks_per_sm = coop ? per_sm : 0;
  }
  return g_blocks_per_sm * g_sms;
}

}  // namespace

// Number of blocks the launch for n cells uses (the partials buffer holds
// blocks * 4 doubles); 0 when the device cannot launch it cooperatively.
OPM_API int opm_cprinner_blocks(long long n) {
  const long long want = (n + THREADS - 1) / THREADS;
  const long long cap = max_blocks();
  if (cap <= 0) return 0;
  return (int)(want < 1 ? 1 : (want < cap ? want : cap));
}

// x = BiCGStab_iters(A, b) from x0 = 0. work holds 7 float vectors of n
// (r, p, v, phat, s, shat, t); partials holds blocks * 4 doubles.
OPM_API int opm_cprinner(const float* d, const float* pxl, const float* pxr,
                         const float* pyl, const float* pyr, const float* pzl,
                         const float* pzr, const float* b, float* x,
                         float* work, double* partials, int blocks, int nx,
                         int ny, int nz, int iters, void* stream) {
  const long long n = (long long)nx * ny * nz;
  if (n <= 0) return 0;
  if (blocks <= 0 || blocks > max_blocks())
    return (int)cudaErrorCooperativeLaunchTooLarge;
  Args a{d, pxl, pxr, pyl, pyr, pzl, pzr, b, x,
         work, work + n, work + 2 * n, work + 3 * n, work + 4 * n,
         work + 5 * n, work + 6 * n, partials, nx, ny, nz, iters};
  void* params[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)cprinner_kernel, dim3(blocks), dim3(THREADS), params, 0,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
