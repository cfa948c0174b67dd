// Shared helpers for the port's hand-written kernels: a C ABI error
// accessor, a forward-mode jet type (value + 3 tangents), the table
// segment search and the cofactor block inverses.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define OPM_API extern "C" __attribute__((visibility("default")))

// ---------------------------------------------------------------------------
// jets: value + derivative with respect to the 3 primaries (po, sw, x3)
// ---------------------------------------------------------------------------
struct J {
  float v, d0, d1, d2;
};

__device__ __forceinline__ J jc(float v) { return J{v, 0.f, 0.f, 0.f}; }
__device__ __forceinline__ J jadd(J a, J b) {
  return J{a.v + b.v, a.d0 + b.d0, a.d1 + b.d1, a.d2 + b.d2};
}
__device__ __forceinline__ J jsub(J a, J b) {
  return J{a.v - b.v, a.d0 - b.d0, a.d1 - b.d1, a.d2 - b.d2};
}
__device__ __forceinline__ J jmul(J a, J b) {
  return J{a.v * b.v, a.d0 * b.v + a.v * b.d0, a.d1 * b.v + a.v * b.d1,
           a.d2 * b.v + a.v * b.d2};
}
__device__ __forceinline__ J jdiv(J a, J b) {
  float inv = 1.f / b.v;
  float q = a.v * inv;
  return J{q, (a.d0 - q * b.d0) * inv, (a.d1 - q * b.d1) * inv,
           (a.d2 - q * b.d2) * inv};
}
__device__ __forceinline__ J jscale(float s, J a) {
  return J{s * a.v, s * a.d0, s * a.d1, s * a.d2};
}
__device__ __forceinline__ J jaddc(J a, float c) {
  return J{a.v + c, a.d0, a.d1, a.d2};
}
__device__ __forceinline__ J jwhere(bool m, J a, J b) { return m ? a : b; }
// max/min with the reference's tie rule: at a tie the derivative is the
// mean of both sides (jnp.maximum / jnp.minimum semantics)
__device__ __forceinline__ J jmax(J a, J b) {
  if (a.v > b.v) return a;
  if (a.v < b.v) return b;
  return J{a.v, 0.5f * (a.d0 + b.d0), 0.5f * (a.d1 + b.d1),
           0.5f * (a.d2 + b.d2)};
}
__device__ __forceinline__ J jmin(J a, J b) {
  if (a.v < b.v) return a;
  if (a.v > b.v) return b;
  return J{a.v, 0.5f * (a.d0 + b.d0), 0.5f * (a.d1 + b.d1),
           0.5f * (a.d2 + b.d2)};
}

// segment index clip(searchsorted(xp[0:n], x, side="right") - 1, 0, hi):
// a point exactly on a node belongs to the segment on its RIGHT
__device__ __forceinline__ int seg_right(const float* xp, int n, float x,
                                         int hi) {
  int lo = 0, h = n;
  while (lo < h) {
    int mid = (lo + h) >> 1;
    if (xp[mid] <= x) lo = mid + 1; else h = mid;
  }
  int i = lo - 1;
  if (i > hi) i = hi;
  if (i < 0) i = 0;
  return i;
}

// piecewise-linear jet through nodes (xp, fp) of length n; extrap=false
// clips the value to the segment's end values (props/tables.interp1d)
__device__ __forceinline__ J jinterp(J x, const float* xp, const float* fp,
                                     int n, bool extrap) {
  int i = seg_right(xp, n, x.v, n - 2);
  float x0 = xp[i], x1 = xp[i + 1], f0 = fp[i], f1 = fp[i + 1];
  float s = (f1 - f0) / (x1 - x0);
  J y = J{f0 + s * (x.v - x0), s * x.d0, s * x.d1, s * x.d2};
  if (!extrap) y = jmin(jmax(y, jc(fminf(f0, f1))), jc(fmaxf(f0, f1)));
  return y;
}

// ---------------------------------------------------------------------------
// small dense blocks (row-major NB x NB)
// ---------------------------------------------------------------------------
// cofactor inverse of a 3x3 block (solvers/linear.invert_blocks)
__device__ __forceinline__ void inv3(const float* a, float* o) {
  float c00 = a[4] * a[8] - a[5] * a[7];
  float c01 = a[5] * a[6] - a[3] * a[8];
  float c02 = a[3] * a[7] - a[4] * a[6];
  float c10 = a[2] * a[7] - a[1] * a[8];
  float c11 = a[0] * a[8] - a[2] * a[6];
  float c12 = a[1] * a[6] - a[0] * a[7];
  float c20 = a[1] * a[5] - a[2] * a[4];
  float c21 = a[2] * a[3] - a[0] * a[5];
  float c22 = a[0] * a[4] - a[1] * a[3];
  float det = a[0] * c00 + a[1] * c01 + a[2] * c02;
  float id = 1.f / det;
  o[0] = c00 * id; o[1] = c10 * id; o[2] = c20 * id;
  o[3] = c01 * id; o[4] = c11 * id; o[5] = c21 * id;
  o[6] = c02 * id; o[7] = c12 * id; o[8] = c22 * id;
}

// 4x4 inverse in the bordered form of solvers/linear.invert_blocks: the
// leading 3x3 block by cofactors, the 4th row/column by its scalar Schur
// complement (branch-free, no pivoting)
__device__ __forceinline__ void inv4(const float* a, float* o) {
  float A[9] = {a[0], a[1], a[2], a[4], a[5], a[6], a[8], a[9], a[10]};
  float Ai[9];
  inv3(A, Ai);
  float b[3] = {a[3], a[7], a[11]};      // column 3, rows 0..2
  float c[3] = {a[12], a[13], a[14]};    // row 3, columns 0..2
  float d = a[15];
  float aib[3], cai[3];
  for (int i = 0; i < 3; ++i) {
    aib[i] = Ai[i * 3 + 0] * b[0] + Ai[i * 3 + 1] * b[1] + Ai[i * 3 + 2] * b[2];
    cai[i] = c[0] * Ai[0 * 3 + i] + c[1] * Ai[1 * 3 + i] + c[2] * Ai[2 * 3 + i];
  }
  float s = d - (c[0] * aib[0] + c[1] * aib[1] + c[2] * aib[2]);
  float si = 1.f / s;
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) o[i * 4 + j] = Ai[i * 3 + j] + aib[i] * si * cai[j];
    o[i * 4 + 3] = -aib[i] * si;
    o[12 + i] = -si * cai[i];
  }
  o[15] = si;
}

template <int NB>
__device__ __forceinline__ void inv_block(const float* a, float* o) {
  if constexpr (NB == 3) inv3(a, o); else inv4(a, o);
}

// each kernel library is one translation unit, so the C accessor for
// the error text lives here
OPM_API const char* opm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
