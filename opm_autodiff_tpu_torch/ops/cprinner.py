"""K5 cprinner: CPR's inner pressure solve, one launch.

Replaces opm_autodiff_tpu/ops/pallas_cprinner.py (``inner_solve_bands``):
``iters`` Jacobi-preconditioned BiCGStab iterations on the scalar
7-point pressure system of a solvers/cpr.CprBandedData (``p_diag``
[nz,ny,nx], ``px_*`` [nz,ny,nx-1], ``py_*`` [nz,ny-1,nx], ``pz_*``
[nz-1,ny,nx]) from a zero initial guess. The fault/NNC extras are not in
this operator: the caller keeps them by defect correction.

* ``inner_solve_bands_cuda`` launches ``csrc/cprinner.cu`` (float32, one
  persistent cooperative launch; breakdown guards at 1e-30 as the TPU
  kernel's).
* ``inner_solve_bands_plain`` is the reference's
  ``_pressure_inner_solve_generic`` over ``_pressure_matvec_banded``
  (dtype-generic; its guards are the generic path's 1e-300, which in
  float32 amounts to ``> 0``).
"""

from __future__ import annotations

import ctypes

import torch

from opm_autodiff_tpu_torch import ops
from opm_autodiff_tpu_torch.ops import build

_FIELDS = ("p_diag", "px_lr", "px_rl", "py_lr", "py_rl", "pz_lr", "pz_rl")
_WORK_VECTORS = 7   # r, p, v, phat, s, shat, t
_SLOTS = 4          # partial sums per block


def inner_solve_bands_plain(c, b3, iters: int):
    from opm_autodiff_tpu_torch.solvers.cpr import (
        _pressure_inner_solve_generic, _pressure_matvec_banded)

    return _pressure_inner_solve_generic(
        lambda v: _pressure_matvec_banded(c, v), c.p_diag, b3, iters)


def inner_solve_bands_cuda(c, b3, iters: int):
    arrs = [getattr(c, f) for f in _FIELDS] + [b3]
    for name, a in zip(_FIELDS + ("b3",), arrs):
        if a.dtype != torch.float32 or not a.is_contiguous():
            raise TypeError(f"cprinner kernel: {name} must be contiguous "
                            "float32")
    build.require_device(b3.device, *arrs)
    nz, ny, nx = b3.shape
    n = nz * ny * nx
    lib = build.lib("cprinner")
    blocks = lib.opm_cprinner_blocks(ctypes.c_longlong(n))
    if blocks <= 0:
        raise RuntimeError("cprinner kernel: the device cannot launch it "
                           "cooperatively")
    x = torch.empty_like(b3)
    work = torch.empty((_WORK_VECTORS, n), dtype=torch.float32,
                       device=b3.device)
    partials = torch.empty(blocks * _SLOTS, dtype=torch.float64,
                           device=b3.device)
    P = build.ptr
    err = lib.opm_cprinner(*[P(a) for a in arrs], P(x), P(work), P(partials),
                           ctypes.c_int(blocks), ctypes.c_int(nx),
                           ctypes.c_int(ny), ctypes.c_int(nz),
                           ctypes.c_int(iters), build.stream_ptr(b3.device))
    ops.LAUNCHES["cprinner"] += 1
    build.check("cprinner", err, "cprinner launch")
    return x


def inner_solve_bands(c, b3, iters: int):
    """K5 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if b3.is_cuda:
        return inner_solve_bands_cuda(c, b3, iters)
    return inner_solve_bands_plain(c, b3, iters)
