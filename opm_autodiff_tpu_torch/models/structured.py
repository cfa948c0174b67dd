"""Structured-grid banded assembly and matvec (main-path subset).

Port of opm_autodiff_tpu/models/structured.py for fully active cartesian
grids. The Jacobian is stored as banded blocks: diag [N,3,3] plus two
directed bands per axis, ``x_lr [nz,ny,nx-1,3,3]`` (row = left cell,
column = right cell) and ``x_rl`` (row = right, column = left), likewise
for y and z. Cells are k-major, i fastest.

Assembly is two kernels (ops/cellpack.py -> ops/flux.py): a per-cell
property pack with 3-tangent jets in plane layout, then the TPFA flux
and all Jacobian blocks. ``pack_cell`` and ``flux_and_jac_slab`` here are
the per-cell and per-face math that the kernels' plain PyTorch versions
are built from.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from opm_autodiff_tpu_torch import units as U
from opm_autodiff_tpu_torch.models.blackoil import (CellStatic, PrimaryState,
                                                    _regs, intensive)
from opm_autodiff_tpu_torch.props.fluid import FluidSystem


class StructuredTopology(NamedTuple):
    """Per-axis face transmissibilities/gravity on the full grid.

    Shapes (nz, ny, nx-1) / (nz, ny-1, nx) / (nz-1, ny, nx)."""

    trans_x: torch.Tensor
    trans_y: torch.Tensor
    trans_z: torch.Tensor
    gdz_x: torch.Tensor
    gdz_y: torch.Tensor
    gdz_z: torch.Tensor

    @property
    def dims(self):
        nz, ny, nxm = self.trans_x.shape
        return (nxm + 1, ny, nz)


class StructuredSystem(NamedTuple):
    residual: torch.Tensor  # [N,nb]
    diag: torch.Tensor      # [N,nb,nb]
    x_lr: torch.Tensor      # [nz, ny, nx-1, nb, nb]
    x_rl: torch.Tensor
    y_lr: torch.Tensor
    y_rl: torch.Tensor
    z_lr: torch.Tensor
    z_rl: torch.Tensor
    # per-cell inverse FVFs from the same packed evaluation (convergence)
    inv_b: torch.Tensor | None = None

    @property
    def num_cells(self) -> int:
        return self.residual.shape[0]

    @property
    def grid(self):
        """(nz, ny, nx)."""
        nz, ny, nxm = self.x_lr.shape[:3]
        return nz, ny, nxm + 1


def structured_ok(geo) -> bool:
    nx, ny, nz = geo.cartdims
    has_nnc = bool((np.asarray(geo.faces.axis) == 3).any())
    thp = getattr(geo.faces, "thpres", None)
    has_thpres = thp is not None and bool((np.asarray(thp) != 0).any())
    return (geo.num_active == nx * ny * nz and not has_nnc
            and not has_thpres)


def topology_from_geometry(geo, device=None) -> StructuredTopology:
    """Per-axis banded trans/gravity arrays from the face list."""
    assert structured_ok(geo), "structured path requires all-active grids"
    nx, ny, nz = geo.cartdims
    f = geo.faces
    depth = np.asarray(geo.depth)

    def band(axis, shape):
        t = np.zeros(shape)
        g = np.zeros(shape)
        sel = np.asarray(f.axis) == axis
        left = np.asarray(f.left)[sel]
        tr = np.asarray(f.trans)[sel]
        right = np.asarray(f.right)[sel]
        k = left // (nx * ny)
        j = (left // nx) % ny
        i = left % nx
        if axis == 0:
            idx = (k * ny + j) * (nx - 1) + i
        elif axis == 1:
            idx = (k * (ny - 1) + j) * nx + i
        else:
            idx = (k * ny + j) * nx + i
        t.reshape(-1)[idx] = tr
        g.reshape(-1)[idx] = U.GRAVITY * (depth[left] - depth[right])
        return (torch.as_tensor(t, device=device),
                torch.as_tensor(g, device=device))

    tx, gx = band(0, (nz, ny, nx - 1))
    ty, gy = band(1, (nz, ny - 1, nx))
    tz, gz = band(2, (nz - 1, ny, nx))
    return StructuredTopology(trans_x=tx, trans_y=ty, trans_z=tz,
                              gdz_x=gx, gdz_y=gy, gdz_z=gz)


def pack_cell(fs: FluidSystem, u, flag, pv_ref, regs, mob, eps):
    """The 17 packed per-cell quantities
    [p(3), inv_b(3), mob(3), rho(3), rs, rv, acc(3)] (broadcasting)."""
    q = intensive(fs, u, flag, regs, mob, eps)
    pv = pv_ref * fs.rock.mult(u[..., 0], _regs(regs)[1])
    sw, so, sg = q.sat[..., 0], q.sat[..., 1], q.sat[..., 2]
    aw = pv * sw * q.inv_b[..., 0]
    ao = pv * (so * q.inv_b[..., 1] + q.rv * sg * q.inv_b[..., 2])
    ag = pv * (sg * q.inv_b[..., 2] + q.rs * so * q.inv_b[..., 1])
    return torch.cat([q.p, q.inv_b, q.mob, q.rho,
                      torch.stack([q.rs, q.rv, aw, ao, ag], dim=-1)], dim=-1)


def flux_and_jac_slab(QL, QR, dQL, dQR, trans, gdz):
    """TPFA upwinded flux + chain-rule Jacobians on packed quantities.

    Inputs: Q* [..., 17], dQ* [..., 17, 3], trans/gdz [...]. Returns
    (flux [...,3], jl [...,3,3], jr [...,3,3]); upwind ties go left."""
    pL, ibL, mobL, rhoL = (QL[..., 0:3], QL[..., 3:6], QL[..., 6:9],
                           QL[..., 9:12])
    pR, ibR, mobR, rhoR = (QR[..., 0:3], QR[..., 3:6], QR[..., 6:9],
                           QR[..., 9:12])
    rsL, rvL = QL[..., 12], QL[..., 13]
    rsR, rvR = QR[..., 12], QR[..., 13]
    dpL, dibL, dmobL, drhoL = (dQL[..., 0:3, :], dQL[..., 3:6, :],
                               dQL[..., 6:9, :], dQL[..., 9:12, :])
    dpR, dibR, dmobR, drhoR = (dQR[..., 0:3, :], dQR[..., 3:6, :],
                               dQR[..., 6:9, :], dQR[..., 9:12, :])
    drsL, drvL = dQL[..., 12, :], dQL[..., 13, :]
    drsR, drvR = dQR[..., 12, :], dQR[..., 13, :]

    t = trans[..., None]
    g = gdz[..., None]
    dphi = (pL - pR) - 0.5 * (rhoL + rhoR) * g
    up = dphi >= 0.0
    m = torch.where(up, mobL, mobR)
    b = torch.where(up, ibL, ibR)
    base = t * m * b * dphi

    upj = up[..., :, None]
    gj = g[..., :, None]
    tj = t[..., :, None]
    zero = torch.zeros((), dtype=QL.dtype, device=QL.device)
    ddphi_L = dpL - 0.5 * gj * drhoL
    ddphi_R = -dpR - 0.5 * gj * drhoR
    mb = (m * b)[..., :, None]
    mdphi = (m * dphi)[..., :, None]
    bdphi = (b * dphi)[..., :, None]
    dbase_L = tj * (torch.where(upj, dmobL * bdphi + dibL * mdphi, zero)
                    + mb * ddphi_L)
    dbase_R = tj * (torch.where(upj, zero, dmobR * bdphi + dibR * mdphi)
                    + mb * ddphi_R)

    rs_up = torch.where(up[..., 1], rsL, rsR)
    rv_up = torch.where(up[..., 2], rvL, rvR)
    drs_L = torch.where(up[..., 1, None], drsL, zero)
    drs_R = torch.where(up[..., 1, None], zero, drsR)
    drv_L = torch.where(up[..., 2, None], drvL, zero)
    drv_R = torch.where(up[..., 2, None], zero, drvR)

    flux = torch.stack([base[..., 0],
                        base[..., 1] + rv_up * base[..., 2],
                        base[..., 2] + rs_up * base[..., 1]], dim=-1)

    def rows(dbase, drs, drv):
        rw = dbase[..., 0, :]
        ro = (dbase[..., 1, :] + rv_up[..., None] * dbase[..., 2, :]
              + drv * base[..., 2, None])
        rg = (dbase[..., 2, :] + rs_up[..., None] * dbase[..., 1, :]
              + drs * base[..., 1, None])
        return torch.stack([rw, ro, rg], dim=-2)

    return flux, rows(dbase_L, drs_L, drv_L), rows(dbase_R, drs_R, drv_R)


def axis_pairs(a3, axis):
    """(aL, aR) slabs for faces along a grid axis of a3 [nz,ny,nx,...]."""
    if axis == 0:
        return a3[:, :, :-1], a3[:, :, 1:]
    if axis == 1:
        return a3[:, :-1, :], a3[:, 1:, :]
    return a3[:-1], a3[1:]


def assemble_structured(fs: FluidSystem, cells: CellStatic,
                        topo: StructuredTopology, state: PrimaryState,
                        acc0, dt, out_dtype=None):
    """Banded 3-equation assembly through K1 (cellpack) and K2 (flux).

    Returns (system, (q, dq)): the packed planes feed the well model.
    On CUDA tensors both kernels compute in float32; on CPU tensors
    their plain versions compute in ``u``'s dtype. ``out_dtype`` sets the
    system's storage dtype (default ``u.dtype``)."""
    from opm_autodiff_tpu_torch.ops import cellpack, flux

    nx, ny, nz = topo.dims
    q, dq = cellpack.cellpack(fs, cells, state.u, state.flag, (nz, ny, nx))
    (res, diag, x_lr, x_rl, y_lr, y_rl, z_lr, z_rl) = flux.flux_bands(
        q, dq, acc0, topo, dt)
    od = state.u.dtype if out_dtype is None else out_dtype
    inv_b = q[:, 3:6].permute(0, 2, 3, 1).reshape(nz * ny * nx, 3)
    sys = StructuredSystem(
        residual=res.to(od), diag=diag.to(od),
        x_lr=x_lr.to(od), x_rl=x_rl.to(od), y_lr=y_lr.to(od),
        y_rl=y_rl.to(od), z_lr=z_lr.to(od), z_rl=z_rl.to(od),
        inv_b=inv_b.to(state.u.dtype))
    return sys, (q, dq)
