"""K4 zline: block-Thomas factor + solve down every z column.

Replaces opm_autodiff_tpu/ops/pallas_zline.py (``prepare_zline`` and
``zline_apply_pallas``). The factorization is (inv [nz,ny,nx,nb,nb],
c [nz,ny,nx,nb,nb], z_rl): inv[k] = (D[k] - L[k] c[k-1])^-1,
c[k] = inv[k] U[k] with U = z_lr, L = z_rl shifted down one layer.

* ``build_zline_cuda`` / ``zline_apply_cuda`` launch ``csrc/zline.cu``
  (float32; forward and backward sweeps fused in one kernel).
* ``build_zline_plain`` / ``zline_apply_plain`` are the reference's
  ``build_zline`` / ``zline_apply`` (solvers/linear.py).
"""

from __future__ import annotations

import ctypes

import torch

from opm_autodiff_tpu_torch import ops
from opm_autodiff_tpu_torch.ops import build
from opm_autodiff_tpu_torch.ops.spmv import check_system


class ZlineFactor(tuple):
    """(inv, c, z_rl)."""


def build_zline_plain(sys):
    from opm_autodiff_tpu_torch.solvers.linear import invert_blocks

    nz, ny, nx = sys.grid
    nb = sys.diag.shape[-1]
    D = sys.diag.reshape(nz, ny, nx, nb, nb)
    zero = torch.zeros((1, ny, nx, nb, nb), dtype=D.dtype, device=D.device)
    U = torch.cat([sys.z_lr, zero], dim=0)
    L = torch.cat([zero, sys.z_rl], dim=0)
    cprev = torch.zeros((ny, nx, nb, nb), dtype=D.dtype, device=D.device)
    invs, cs = [], []
    for k in range(nz):
        denom = D[k] - torch.einsum("...ij,...jk->...ik", L[k], cprev)
        inv = invert_blocks(denom)
        cprev = torch.einsum("...ij,...jk->...ik", inv, U[k])
        invs.append(inv)
        cs.append(cprev)
    return ZlineFactor((torch.stack(invs), torch.stack(cs), sys.z_rl))


def zline_apply_plain(fact, r):
    inv, c, z_rl = fact
    nz, ny, nx, nb = inv.shape[:4]
    r3 = r.reshape(nz, ny, nx, nb)
    mv = lambda a, b: torch.einsum("...ij,...j->...i", a, b)  # noqa: E731
    d = []
    prev = torch.zeros((ny, nx, nb), dtype=r.dtype, device=r.device)
    for k in range(nz):
        rk = r3[k] if k == 0 else r3[k] - mv(z_rl[k - 1], prev)
        prev = mv(inv[k], rk)
        d.append(prev)
    x = [None] * nz
    nxt = torch.zeros((ny, nx, nb), dtype=r.dtype, device=r.device)
    for k in range(nz - 1, -1, -1):
        nxt = d[k] - mv(c[k], nxt)
        x[k] = nxt
    return torch.stack(x).reshape(-1, nb)


def build_zline_cuda(sys):
    nb = check_system(sys)
    nz, ny, nx = sys.grid
    dev = sys.diag.device
    build.require_device(dev, sys.z_lr, sys.z_rl)
    inv = torch.empty((nz, ny, nx, nb, nb), dtype=torch.float32, device=dev)
    c = torch.empty_like(inv)
    lib = build.lib("zline")
    P = build.ptr
    err = lib.opm_zline_factor(ctypes.c_int(nb), P(sys.diag), P(sys.z_lr),
                               P(sys.z_rl), P(inv), P(c),
                               ctypes.c_longlong(ny * nx), ctypes.c_int(nz),
                               build.stream_ptr(dev))
    ops.LAUNCHES["zline_factor"] += 1
    build.check("zline", err, "zline factor launch")
    return ZlineFactor((inv, c, sys.z_rl))


def zline_apply_cuda(fact, r):
    inv, c, z_rl = fact
    nz, ny, nx, nb = inv.shape[:4]
    if r.dtype != torch.float32:
        raise TypeError("zline kernel takes float32 vectors")
    r = r.contiguous()
    build.require_device(r.device, inv, c, z_rl)
    x = torch.empty_like(r)
    lib = build.lib("zline")
    P = build.ptr
    err = lib.opm_zline_apply(ctypes.c_int(nb), P(inv), P(c), P(z_rl), P(r),
                              P(x), ctypes.c_longlong(ny * nx),
                              ctypes.c_int(nz), build.stream_ptr(r.device))
    ops.LAUNCHES["zline_apply"] += 1
    build.check("zline", err, "zline apply launch")
    return x


def build_zline(sys):
    """K4 factor wrapper (kernel for CUDA tensors, plain for CPU)."""
    if sys.diag.is_cuda:
        return build_zline_cuda(sys)
    return build_zline_plain(sys)


def zline_apply(fact, r):
    """K4 apply wrapper (kernel for CUDA tensors, plain for CPU)."""
    if r.is_cuda:
        return zline_apply_cuda(fact, r)
    return zline_apply_plain(fact, r)
