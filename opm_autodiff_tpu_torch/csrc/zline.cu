// K4 zline: exact block-Thomas solve down every vertical column.
//
// Replaces the TPU kernels opm_autodiff_tpu/ops/pallas_zline.py
// (prepare_zline / _factor_kernel, zline_apply_pallas / _fwd_kernel and
// _bwd_kernel). The TPU walks z as a sequential grid axis with a VMEM
// carry; here one thread owns one (y, x) column and loops over z with the
// carry in registers (columns are independent; neighbouring threads are
// neighbouring columns, so block loads stay close together).
//
//   factor:  inv[k] = (D[k] - L[k] C[k-1])^-1,  C[k] = inv[k] U[k]
//   apply:   forward  y[k] = inv[k] (r[k] - L[k] y[k-1])
//            backward x[k] = y[k] - C[k] x[k+1]
// with U[k] = z_lr[k] (row k, column k+1) and L[k] = z_rl[k-1] (row k,
// column k-1). Inverses are branch-free cofactor forms (3x3; 4x4 in the
// bordered Schur form of solvers/linear.invert_blocks). The forward and
// backward sweeps are fused in one kernel: the forward pass writes y into
// the output, the backward pass updates it in place.
//
// Bound: bytes (factor: reads D, L, U and writes inv, C once; apply:
// reads inv, L, C and r once, writes x once and re-reads it in the
// backward sweep from L2).

#include "common.cuh"

namespace {

template <int NB>
__device__ __forceinline__ void mm(const float* a, const float* b, float* o) {
#pragma unroll
  for (int r = 0; r < NB; ++r)
#pragma unroll
    for (int cc = 0; cc < NB; ++cc) {
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < NB; ++t) s += a[r * NB + t] * b[t * NB + cc];
      o[r * NB + cc] = s;
    }
}

template <int NB>
__device__ __forceinline__ void mv(const float* a, const float* x, float* o) {
#pragma unroll
  for (int r = 0; r < NB; ++r) {
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < NB; ++t) s += a[r * NB + t] * x[t];
    o[r] = s;
  }
}

template <int NB>
__global__ void factor_kernel(const float* __restrict__ diag,
                              const float* __restrict__ z_lr,
                              const float* __restrict__ z_rl,
                              float* __restrict__ inv, float* __restrict__ cc,
                              long long nxy, int nz) {
  long long col = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (col >= nxy) return;
  constexpr int B2 = NB * NB;
  float cprev[B2], den[B2], iv[B2], lc[B2], blk[B2];
#pragma unroll
  for (int t = 0; t < B2; ++t) cprev[t] = 0.f;
  for (int k = 0; k < nz; ++k) {
    const long long c = (long long)k * nxy + col;
#pragma unroll
    for (int t = 0; t < B2; ++t) den[t] = diag[B2 * c + t];
    if (k > 0) {
#pragma unroll
      for (int t = 0; t < B2; ++t) blk[t] = z_rl[B2 * (c - nxy) + t];
      mm<NB>(blk, cprev, lc);
#pragma unroll
      for (int t = 0; t < B2; ++t) den[t] -= lc[t];
    }
    inv_block<NB>(den, iv);
    if (k < nz - 1) {
#pragma unroll
      for (int t = 0; t < B2; ++t) blk[t] = z_lr[B2 * c + t];
      mm<NB>(iv, blk, cprev);
    } else {
#pragma unroll
      for (int t = 0; t < B2; ++t) cprev[t] = 0.f;
    }
#pragma unroll
    for (int t = 0; t < B2; ++t) {
      inv[B2 * c + t] = iv[t];
      cc[B2 * c + t] = cprev[t];
    }
  }
}

template <int NB>
__global__ void apply_kernel(const float* __restrict__ inv,
                             const float* __restrict__ cc,
                             const float* __restrict__ z_rl,
                             const float* __restrict__ r,
                             float* __restrict__ x, long long nxy, int nz) {
  long long col = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (col >= nxy) return;
  constexpr int B2 = NB * NB;
  float prev[NB], rhs[NB], t1[NB], blk[B2];
#pragma unroll
  for (int t = 0; t < NB; ++t) prev[t] = 0.f;
  for (int k = 0; k < nz; ++k) {
    const long long c = (long long)k * nxy + col;
#pragma unroll
    for (int t = 0; t < NB; ++t) rhs[t] = r[NB * c + t];
    if (k > 0) {
#pragma unroll
      for (int t = 0; t < B2; ++t) blk[t] = z_rl[B2 * (c - nxy) + t];
      mv<NB>(blk, prev, t1);
#pragma unroll
      for (int t = 0; t < NB; ++t) rhs[t] -= t1[t];
    }
#pragma unroll
    for (int t = 0; t < B2; ++t) blk[t] = inv[B2 * c + t];
    mv<NB>(blk, rhs, prev);
#pragma unroll
    for (int t = 0; t < NB; ++t) x[NB * c + t] = prev[t];
  }
  // backward: prev holds x[nz-1] = y[nz-1]
  for (int k = nz - 2; k >= 0; --k) {
    const long long c = (long long)k * nxy + col;
#pragma unroll
    for (int t = 0; t < B2; ++t) blk[t] = cc[B2 * c + t];
    mv<NB>(blk, prev, t1);
#pragma unroll
    for (int t = 0; t < NB; ++t) {
      prev[t] = x[NB * c + t] - t1[t];
      x[NB * c + t] = prev[t];
    }
  }
}

}  // namespace

OPM_API int opm_zline_factor(int nb, const float* diag, const float* z_lr,
                             const float* z_rl, float* inv, float* cc,
                             long long nxy, int nz, void* stream) {
  if (nxy <= 0 || nz <= 0) return 0;
  const int threads = 128;
  const unsigned blocks = (unsigned)((nxy + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (nb == 3)
    factor_kernel<3><<<blocks, threads, 0, s>>>(diag, z_lr, z_rl, inv, cc,
                                                nxy, nz);
  else if (nb == 4)
    factor_kernel<4><<<blocks, threads, 0, s>>>(diag, z_lr, z_rl, inv, cc,
                                                nxy, nz);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

OPM_API int opm_zline_apply(int nb, const float* inv, const float* cc,
                            const float* z_rl, const float* r, float* x,
                            long long nxy, int nz, void* stream) {
  if (nxy <= 0 || nz <= 0) return 0;
  const int threads = 128;
  const unsigned blocks = (unsigned)((nxy + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (nb == 3)
    apply_kernel<3><<<blocks, threads, 0, s>>>(inv, cc, z_rl, r, x, nxy, nz);
  else if (nb == 4)
    apply_kernel<4><<<blocks, threads, 0, s>>>(inv, cc, z_rl, r, x, nxy, nz);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
