"""K2 flux: TPFA flux, residual, diagonal blocks and the six bands.

Replaces opm_autodiff_tpu/ops/pallas_flux.py (``flux_bands`` with its
two kernels). Input: the K1 planes ``q [nz,17,ny,nx]``, ``dq
[nz,17,3,ny,nx]``, ``acc0 [N,3]``, the per-axis transmissibility and
g*dz arrays of a StructuredTopology, and ``dt``. Output: (residual [N,3],
diag [N,3,3], x_lr, x_rl, y_lr, y_rl, z_lr, z_rl) with the band shapes of
models/structured.StructuredSystem.

* ``flux_bands_cuda`` launches ``csrc/flux.cu`` (float32).
* ``flux_bands_plain`` follows the reference's vmap(jacfwd) assembly
  branch (models/structured.py of the JAX package, the slab loop after
  the per-cell pack) in the input dtype.
"""

from __future__ import annotations

import ctypes

import torch

from opm_autodiff_tpu_torch import ops
from opm_autodiff_tpu_torch.ops import build


def flux_bands_plain(q, dq, acc0, topo, dt):
    from opm_autodiff_tpu_torch.models.structured import (axis_pairs,
                                                          flux_and_jac_slab)

    nz, _, ny, nx = q.shape
    dt = torch.as_tensor(dt, dtype=q.dtype, device=q.device)
    Q3 = q.permute(0, 2, 3, 1)              # [nz,ny,nx,17]
    dQ3 = dq.permute(0, 3, 4, 1, 2)         # [nz,ny,nx,17,3]
    res3 = ((Q3[..., 14:17] - acc0.to(q.dtype).reshape(nz, ny, nx, 3))
            / dt).clone()
    diag3 = (dQ3[..., 14:17, :] / dt).clone()
    bands = []
    for axis, (trans, gdz) in enumerate(
            ((topo.trans_x, topo.gdz_x), (topo.trans_y, topo.gdz_y),
             (topo.trans_z, topo.gdz_z))):
        QL, QR = axis_pairs(Q3, axis)
        dQL, dQR = axis_pairs(dQ3, axis)
        flux, jl, jr = flux_and_jac_slab(QL, QR, dQL, dQR,
                                         trans.to(q.dtype), gdz.to(q.dtype))
        rL, rR = axis_pairs(res3, axis)
        dL, dR = axis_pairs(diag3, axis)
        rL += flux
        rR -= flux
        dL += jl
        dR -= jr
        bands += [jr, -jl]
    return (res3.reshape(-1, 3), diag3.reshape(-1, 3, 3), *bands)


def flux_bands_cuda(q, dq, acc0, topo, dt):
    nz, _, ny, nx = q.shape
    n = nz * ny * nx
    dev = q.device
    f32 = torch.float32
    if q.dtype != f32 or dq.dtype != f32:
        raise TypeError("flux kernel takes float32 planes")
    q = q.contiguous()
    dq = dq.contiguous()
    acc0 = acc0.to(f32).contiguous()
    t = [a.to(f32).contiguous() for a in
         (topo.trans_x, topo.trans_y, topo.trans_z,
          topo.gdz_x, topo.gdz_y, topo.gdz_z)]
    build.require_device(dev, dq, acc0, *t)
    res = torch.empty((n, 3), dtype=f32, device=dev)
    diag = torch.empty((n, 3, 3), dtype=f32, device=dev)
    bands = [torch.empty(s + (3, 3), dtype=f32, device=dev) for s in
             ((nz, ny, nx - 1), (nz, ny, nx - 1), (nz, ny - 1, nx),
              (nz, ny - 1, nx), (nz - 1, ny, nx), (nz - 1, ny, nx))]
    lib = build.lib("flux")
    P = build.ptr
    err = lib.opm_flux(P(q), P(dq), P(acc0), ctypes.c_float(float(dt)),
                       *[P(a) for a in t], P(res), P(diag),
                       *[P(b) for b in bands], ctypes.c_int(nx),
                       ctypes.c_int(ny), ctypes.c_int(nz),
                       build.stream_ptr(dev))
    ops.LAUNCHES["flux"] += 1
    build.check("flux", err, "flux launch")
    return (res, diag, *bands)


def flux_bands(q, dq, acc0, topo, dt):
    """K2 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if q.is_cuda:
        return flux_bands_cuda(q, dq, acc0, topo, dt)
    return flux_bands_plain(q, dq, acc0, topo, dt)
