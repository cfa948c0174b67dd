"""K3 spmv: y = A x for the 7-point block-banded Jacobian.

Replaces opm_autodiff_tpu/ops/pallas_spmv.py (``banded_spmv_pallas``).
Works on a models/structured.StructuredSystem as assembled (diag
[N,nb,nb], per-axis bands [..,nb,nb]) and x [N,nb], nb in {3, 4}.

* ``banded_spmv_cuda`` launches ``csrc/spmv.cu`` (float32).
* ``banded_spmv_plain`` is the reference's ``structured_matvec``.
"""

from __future__ import annotations

import ctypes

import torch

from opm_autodiff_tpu_torch import ops
from opm_autodiff_tpu_torch.ops import build

_BANDS = ("x_lr", "x_rl", "y_lr", "y_rl", "z_lr", "z_rl")


def banded_spmv_plain(sys, x):
    n = sys.num_cells
    nb = sys.diag.shape[-1]
    nz, ny, nx = sys.grid
    x3 = x.reshape(nz, ny, nx, nb)
    y = torch.einsum("nij,nj->ni", sys.diag, x).reshape(nz, ny, nx, nb)
    mv = lambda a, b: torch.einsum("...ij,...j->...i", a, b)  # noqa: E731
    y[:, :, :-1] += mv(sys.x_lr, x3[:, :, 1:])
    y[:, :, 1:] += mv(sys.x_rl, x3[:, :, :-1])
    y[:, :-1, :] += mv(sys.y_lr, x3[:, 1:, :])
    y[:, 1:, :] += mv(sys.y_rl, x3[:, :-1, :])
    y[:-1] += mv(sys.z_lr, x3[1:])
    y[1:] += mv(sys.z_rl, x3[:-1])
    return y.reshape(n, nb)


def check_system(sys, dtype=torch.float32):
    """Kernel preconditions: float32, contiguous, nb in {3, 4}."""
    nb = sys.diag.shape[-1]
    if nb not in (3, 4):
        raise ValueError(f"block size {nb} not in (3, 4)")
    for name in ("diag",) + _BANDS:
        a = getattr(sys, name)
        if a.dtype != dtype or not a.is_contiguous():
            raise TypeError(f"{name} must be contiguous {dtype}")
    return nb


def banded_spmv_cuda(sys, x):
    nb = check_system(sys)
    nz, ny, nx = sys.grid
    if x.dtype != torch.float32:
        raise TypeError("spmv kernel takes float32 vectors")
    x = x.contiguous()
    build.require_device(x.device, *[getattr(sys, k)
                                     for k in ("diag",) + _BANDS])
    y = torch.empty_like(x)
    lib = build.lib("spmv")
    P = build.ptr
    err = lib.opm_spmv(ctypes.c_int(nb), P(sys.diag),
                       *[P(getattr(sys, b)) for b in _BANDS], P(x), P(y),
                       ctypes.c_int(nx), ctypes.c_int(ny), ctypes.c_int(nz),
                       build.stream_ptr(x.device))
    ops.LAUNCHES["spmv"] += 1
    build.check("spmv", err, "spmv launch")
    return y


def banded_spmv(sys, x):
    """K3 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if x.is_cuda:
        return banded_spmv_cuda(sys, x)
    return banded_spmv_plain(sys, x)
