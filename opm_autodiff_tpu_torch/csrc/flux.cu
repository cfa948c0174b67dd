// K2 flux: TPFA upwind flux, residual, diagonal blocks and the six
// directed off-diagonal bands of the 7-point block Jacobian.
//
// Replaces the TPU kernels opm_autodiff_tpu/ops/pallas_flux.py
// (flux_bands_arrays / _flux_kernel and the y-blocked
// _flux_bands_yblocked / _flux_kernel_yb, a VMEM guard with no Hopper
// counterpart). One thread per cell reads the packed planes of K1 for
// itself and its six neighbours and evaluates each of its faces: the
// potential dphi = dp - 0.5 (rhoL + rhoR) g dz, upwind on dphi >= 0,
// T mob_up (1/B)_up dphi with the rs_up / rv_up cross terms, and the
// chain rule to both sides (models/structured.flux_and_jac_slab). Every
// interior face is evaluated from both of its cells, so each thread
// writes only its own cell's rows (residual, diag, and the band rows
// whose row is this cell): no atomics, no second pass.
//
// Layouts: q [nz,17,nxy], dq [nz,17,3,nxy] (planes); acc0 [N,3];
// trans/gdz per axis [nz,ny,nx-1] / [nz,ny-1,nx] / [nz-1,ny,nx];
// residual [N,3], diag [N,3,3], bands [face,3,3] (row-major blocks).
//
// Bound: bytes. Each cell's 17+51 plane values are read by itself and
// its six neighbours (the neighbour reads are coalesced along x and mostly
// served by L2); the outputs are written once.

#include "common.cuh"

namespace {

struct Cell {
  float p[3], ib[3], mob[3], rho[3], rs, rv;
  float dp[3][3], dib[3][3], dmob[3][3], drho[3][3], drs[3], drv[3];
};

__device__ __forceinline__ void load_cell(const float* q, const float* dq,
                                          long long c, long long nxy,
                                          Cell& o) {
  const long long k = c / nxy, p = c % nxy;
  const float* qb = q + (k * 17) * nxy + p;
  const float* db = dq + (k * 51) * nxy + p;
  for (int i = 0; i < 3; ++i) {
    o.p[i] = qb[(0 + i) * nxy];
    o.ib[i] = qb[(3 + i) * nxy];
    o.mob[i] = qb[(6 + i) * nxy];
    o.rho[i] = qb[(9 + i) * nxy];
    for (int t = 0; t < 3; ++t) {
      o.dp[i][t] = db[((0 + i) * 3 + t) * nxy];
      o.dib[i][t] = db[((3 + i) * 3 + t) * nxy];
      o.dmob[i][t] = db[((6 + i) * 3 + t) * nxy];
      o.drho[i][t] = db[((9 + i) * 3 + t) * nxy];
    }
  }
  o.rs = qb[12 * nxy];
  o.rv = qb[13 * nxy];
  for (int t = 0; t < 3; ++t) {
    o.drs[t] = db[(12 * 3 + t) * nxy];
    o.drv[t] = db[(13 * 3 + t) * nxy];
  }
}

// flux (positive L -> R) and its Jacobians wrt the left and right cells
__device__ void face(const Cell& L, const Cell& R, float t, float g,
                     float flux[3], float jl[3][3], float jr[3][3]) {
  float base[3], dbL[3][3], dbR[3][3];
  bool up[3];
  for (int ph = 0; ph < 3; ++ph) {
    float dphi = (L.p[ph] - R.p[ph]) - 0.5f * (L.rho[ph] + R.rho[ph]) * g;
    up[ph] = dphi >= 0.f;
    float m = up[ph] ? L.mob[ph] : R.mob[ph];
    float b = up[ph] ? L.ib[ph] : R.ib[ph];
    base[ph] = t * m * b * dphi;
    float mb = m * b, mdphi = m * dphi, bdphi = b * dphi;
    for (int k = 0; k < 3; ++k) {
      float ddl = L.dp[ph][k] - 0.5f * g * L.drho[ph][k];
      float ddr = -R.dp[ph][k] - 0.5f * g * R.drho[ph][k];
      float upl = up[ph] ? (L.dmob[ph][k] * bdphi + L.dib[ph][k] * mdphi) : 0.f;
      float upr = up[ph] ? 0.f : (R.dmob[ph][k] * bdphi + R.dib[ph][k] * mdphi);
      dbL[ph][k] = t * (upl + mb * ddl);
      dbR[ph][k] = t * (upr + mb * ddr);
    }
  }
  float rs_up = up[1] ? L.rs : R.rs;
  float rv_up = up[2] ? L.rv : R.rv;
  flux[0] = base[0];
  flux[1] = base[1] + rv_up * base[2];
  flux[2] = base[2] + rs_up * base[1];
  for (int k = 0; k < 3; ++k) {
    float drsL = up[1] ? L.drs[k] : 0.f, drsR = up[1] ? 0.f : R.drs[k];
    float drvL = up[2] ? L.drv[k] : 0.f, drvR = up[2] ? 0.f : R.drv[k];
    jl[0][k] = dbL[0][k];
    jl[1][k] = dbL[1][k] + rv_up * dbL[2][k] + drvL * base[2];
    jl[2][k] = dbL[2][k] + rs_up * dbL[1][k] + drsL * base[1];
    jr[0][k] = dbR[0][k];
    jr[1][k] = dbR[1][k] + rv_up * dbR[2][k] + drvR * base[2];
    jr[2][k] = dbR[2][k] + rs_up * dbR[1][k] + drsR * base[1];
  }
}

__device__ __forceinline__ void store33(float* dst, const float a[3][3],
                                        float sign) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) dst[i * 3 + j] = sign * a[i][j];
}

__global__ void flux_kernel(const float* __restrict__ q,
                            const float* __restrict__ dq,
                            const float* __restrict__ acc0, float dt,
                            const float* __restrict__ tx,
                            const float* __restrict__ ty,
                            const float* __restrict__ tz,
                            const float* __restrict__ gx,
                            const float* __restrict__ gy,
                            const float* __restrict__ gz,
                            float* __restrict__ res, float* __restrict__ diag,
                            float* __restrict__ x_lr, float* __restrict__ x_rl,
                            float* __restrict__ y_lr, float* __restrict__ y_rl,
                            float* __restrict__ z_lr, float* __restrict__ z_rl,
                            int nx, int ny, int nz) {
  const long long nxy = (long long)nx * ny;
  const long long n = nxy * nz;
  long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (c >= n) return;
  const int i = (int)(c % nx);
  const int j = (int)((c / nx) % ny);
  const int k = (int)(c / nxy);

  Cell me;
  load_cell(q, dq, c, nxy, me);
  const long long kk = c / nxy, pp = c % nxy;
  float r[3], d[3][3];
  for (int e = 0; e < 3; ++e) {
    r[e] = (q[(kk * 17 + 14 + e) * nxy + pp] - acc0[3 * c + e]) / dt;
    for (int t = 0; t < 3; ++t)
      d[e][t] = dq[((kk * 17 + 14 + e) * 3 + t) * nxy + pp] / dt;
  }

  float fl[3], jl[3][3], jr[3][3];
  Cell nb;
  // the six faces in the reference's accumulation order: per axis, the
  // face where this cell is left (+flux, +jl), then where it is right
  // (-flux, -jr)
  for (int axis = 0; axis < 3; ++axis) {
    int pos = axis == 0 ? i : (axis == 1 ? j : k);
    int len = axis == 0 ? nx : (axis == 1 ? ny : nz);
    long long stride = axis == 0 ? 1 : (axis == 1 ? nx : nxy);
    const float* T = axis == 0 ? tx : (axis == 1 ? ty : tz);
    const float* G = axis == 0 ? gx : (axis == 1 ? gy : gz);
    float* B_lr = axis == 0 ? x_lr : (axis == 1 ? y_lr : z_lr);
    float* B_rl = axis == 0 ? x_rl : (axis == 1 ? y_rl : z_rl);
    if (pos < len - 1) {
      long long f = axis == 0 ? ((long long)k * ny + j) * (nx - 1) + i
                  : axis == 1 ? ((long long)k * (ny - 1) + j) * nx + i
                              : c;
      load_cell(q, dq, c + stride, nxy, nb);
      face(me, nb, T[f], G[f], fl, jl, jr);
      for (int e = 0; e < 3; ++e) {
        r[e] += fl[e];
        for (int t = 0; t < 3; ++t) d[e][t] += jl[e][t];
      }
      store33(B_lr + 9 * f, jr, 1.f);   // row = this (left) cell
    }
    if (pos > 0) {
      long long f = axis == 0 ? ((long long)k * ny + j) * (nx - 1) + (i - 1)
                  : axis == 1 ? ((long long)k * (ny - 1) + (j - 1)) * nx + i
                              : c - nxy;
      load_cell(q, dq, c - stride, nxy, nb);
      face(nb, me, T[f], G[f], fl, jl, jr);
      for (int e = 0; e < 3; ++e) {
        r[e] -= fl[e];
        for (int t = 0; t < 3; ++t) d[e][t] -= jr[e][t];
      }
      store33(B_rl + 9 * f, jl, -1.f);  // row = this (right) cell
    }
  }
  for (int e = 0; e < 3; ++e) {
    res[3 * c + e] = r[e];
    for (int t = 0; t < 3; ++t) diag[9 * c + 3 * e + t] = d[e][t];
  }
}

}  // namespace

OPM_API int opm_flux(const float* q, const float* dq, const float* acc0,
                     float dt, const float* tx, const float* ty,
                     const float* tz, const float* gx, const float* gy,
                     const float* gz, float* res, float* diag, float* x_lr,
                     float* x_rl, float* y_lr, float* y_rl, float* z_lr,
                     float* z_rl, int nx, int ny, int nz, void* stream) {
  const long long n = (long long)nx * ny * nz;
  if (n <= 0) return 0;
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  flux_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      q, dq, acc0, dt, tx, ty, tz, gx, gy, gz, res, diag, x_lr, x_rl,
      y_lr, y_rl, z_lr, z_rl, nx, ny, nz);
  return (int)cudaGetLastError();
}
