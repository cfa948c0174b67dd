// K3 spmv: y = A x for the 7-point block-banded Jacobian.
//
// Replaces the TPU kernel opm_autodiff_tpu/ops/pallas_spmv.py
// (banded_spmv_pallas / _kernel, with prepare_banded's relayout). One
// thread per cell computes its block row: the diagonal block times its own
// x, plus each present band block times the neighbour's x. Band presence
// is decided from the cell's grid position, so edge planes and singleton
// dimensions (a zero-width band) need no padding or masks in memory.
//
// Layouts (the assembly's own, no relayout): diag [N,NB,NB], x_lr/x_rl
// [nz,ny,nx-1,NB,NB], y_* [nz,ny-1,nx,NB,NB], z_* [nz-1,ny,nx,NB,NB],
// x and y [N,NB]; cells k-major, x fastest, so neighbouring threads read
// neighbouring blocks.
//
// Bound: bytes (7 NB^2 + 2 NB floats per cell against 14 NB^2 flops).

#include "common.cuh"

namespace {

template <int NB>
__device__ __forceinline__ void acc_block(const float* __restrict__ blk,
                                          const float* __restrict__ xv,
                                          float* y) {
#pragma unroll
  for (int r = 0; r < NB; ++r) {
    float s = 0.f;
#pragma unroll
    for (int cc = 0; cc < NB; ++cc) s += blk[r * NB + cc] * xv[cc];
    y[r] += s;
  }
}

template <int NB>
__global__ void spmv_kernel(const float* __restrict__ diag,
                            const float* __restrict__ x_lr,
                            const float* __restrict__ x_rl,
                            const float* __restrict__ y_lr,
                            const float* __restrict__ y_rl,
                            const float* __restrict__ z_lr,
                            const float* __restrict__ z_rl,
                            const float* __restrict__ x,
                            float* __restrict__ y, int nx, int ny, int nz) {
  const long long nxy = (long long)nx * ny;
  const long long n = nxy * nz;
  long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (c >= n) return;
  const int i = (int)(c % nx);
  const int j = (int)((c / nx) % ny);
  const int k = (int)(c / nxy);
  constexpr int B2 = NB * NB;
  float acc[NB];
#pragma unroll
  for (int r = 0; r < NB; ++r) acc[r] = 0.f;
  acc_block<NB>(diag + B2 * c, x + NB * c, acc);
  if (i < nx - 1)
    acc_block<NB>(x_lr + B2 * (((long long)k * ny + j) * (nx - 1) + i),
                  x + NB * (c + 1), acc);
  if (i > 0)
    acc_block<NB>(x_rl + B2 * (((long long)k * ny + j) * (nx - 1) + i - 1),
                  x + NB * (c - 1), acc);
  if (j < ny - 1)
    acc_block<NB>(y_lr + B2 * (((long long)k * (ny - 1) + j) * nx + i),
                  x + NB * (c + nx), acc);
  if (j > 0)
    acc_block<NB>(y_rl + B2 * (((long long)k * (ny - 1) + j - 1) * nx + i),
                  x + NB * (c - nx), acc);
  if (k < nz - 1)
    acc_block<NB>(z_lr + B2 * c, x + NB * (c + nxy), acc);
  if (k > 0)
    acc_block<NB>(z_rl + B2 * (c - nxy), x + NB * (c - nxy), acc);
#pragma unroll
  for (int r = 0; r < NB; ++r) y[NB * c + r] = acc[r];
}

}  // namespace

OPM_API int opm_spmv(int nb, const float* diag, const float* x_lr,
                     const float* x_rl, const float* y_lr, const float* y_rl,
                     const float* z_lr, const float* z_rl, const float* x,
                     float* y, int nx, int ny, int nz, void* stream) {
  const long long n = (long long)nx * ny * nz;
  if (n <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (nb == 3)
    spmv_kernel<3><<<blocks, threads, 0, s>>>(diag, x_lr, x_rl, y_lr, y_rl,
                                              z_lr, z_rl, x, y, nx, ny, nz);
  else if (nb == 4)
    spmv_kernel<4><<<blocks, threads, 0, s>>>(diag, x_lr, x_rl, y_lr, y_rl,
                                              z_lr, z_rl, x, y, nx, ny, nz);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
