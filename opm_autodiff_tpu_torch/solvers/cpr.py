"""CPR: two-stage constrained-pressure-residual preconditioner, banded.

Port of the banded half of opm_autodiff_tpu/solvers/cpr.py (reference:
OwningTwoLevelPreconditioner + PressureTransferPolicy):

  1. quasi-IMPES weights w_i = D_i^-T e_p (getQuasiImpesWeights.hpp:48-78),
     or true-IMPES weights from the storage Jacobian (:89);
  2. restrict: r_p = w . r; scalar pressure matrix A_p = w . J[:, p-col]
     in the 7-point banded layout;
  3. coarse solve: a fixed number of Jacobi-preconditioned BiCGStab
     iterations on the scalar system, one launch of K5 (ops/cprinner.py);
  4. prolong + fine smoothing with the caller's smoother (solve_linear
     passes the z-line block-Thomas apply, K4).

The apply is mildly nonlinear in r (the inner Krylov), so the outer
solver is FGMRES (solvers/fgmres.py). The fault/NNC extras of the
embedded layout (ROADMAP.md Queue 1 item 9) and the multigrid pressure
stage (item 10b) are not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from opm_autodiff_tpu_torch.ops import cprinner, spmv

P = 0                   # the pressure unknown's column in a block
TRUEIMPES_P_SCALE = 50e5  # the pressure column's scale, 50 bar
# inner pressure-stage iterations of each apply (the reference's default
# NewtonParams.linear_cpr_inner)
CPR_INNER_ITERS = 12


def _solve_transpose_3x3(diag, e_idx: int):
    """w = D^-T e: per-cell transposed block solves (closed form)."""
    from opm_autodiff_tpu_torch.solvers.linear import invert_blocks

    return invert_blocks(diag)[..., e_idx, :]


def trueimpes_weights(acc_jac):
    """True-IMPES weights from the storage-term Jacobian (reference:
    getQuasiImpesWeights.hpp:89 getTrueImpesWeights — block = d storage/du
    with the pressure column scaled by 50 bar, w = block^-T e_p, /1000)."""
    scale = torch.ones(acc_jac.shape[-1], dtype=acc_jac.dtype,
                       device=acc_jac.device)
    scale[P] = TRUEIMPES_P_SCALE
    w = _solve_transpose_3x3(acc_jac * scale, P) / 1000.0
    return torch.where(torch.isfinite(w), w, torch.zeros_like(w))


def _weights(sys, mode: str):
    """quasiimpes: D^-T e_p from the full diagonal; trueimpes: from the
    storage Jacobian (quasi when the system carries none)."""
    if mode == "trueimpes" and sys.acc_jac is not None:
        return trueimpes_weights(sys.acc_jac)
    w = _solve_transpose_3x3(sys.diag, P)
    return torch.where(torch.isfinite(w), w, torch.zeros_like(w))


def _pressure_inner_solve_generic(mv, diag, b, iters: int):
    """Fixed-iteration Jacobi-preconditioned BiCGStab from x0 = 0 (the
    plain version of K5). Guards as the reference's generic path."""
    inv_d = 1.0 / torch.where(torch.abs(diag) > 0, diag,
                              torch.ones_like(diag))
    one = torch.ones((), dtype=b.dtype, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)

    def vdot(a, c):
        return torch.dot(a.reshape(-1), c.reshape(-1))

    x = torch.zeros_like(b)
    r = b
    rhat = r
    rho = alpha = omega = one
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    for _ in range(iters):
        rho_new = vdot(rhat, r)
        safe = torch.abs(rho * omega) > 1e-300
        beta = torch.where(safe, (rho_new / torch.where(safe, rho, one))
                           * (alpha / torch.where(safe, omega, one)), zero)
        p = r + beta * (p - omega * v)
        phat = inv_d * p
        v = mv(phat)
        den = vdot(rhat, v)
        ok = torch.abs(den) > 1e-300
        alpha = torch.where(ok, rho_new / torch.where(ok, den, one), zero)
        s = r - alpha * v
        shat = inv_d * s
        t = mv(shat)
        tt = vdot(t, t)
        omega = torch.where(tt > 0, vdot(t, s) / torch.where(tt > 0, tt, one),
                            zero)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
    return x


class CprBandedData(NamedTuple):
    """Scalar pressure system in banded form (structured grids)."""

    weights: torch.Tensor   # [N,nb]
    p_diag: torch.Tensor    # [nz, ny, nx]
    px_lr: torch.Tensor     # [nz, ny, nx-1]
    px_rl: torch.Tensor
    py_lr: torch.Tensor     # [nz, ny-1, nx]
    py_rl: torch.Tensor
    pz_lr: torch.Tensor     # [nz-1, ny, nx]
    pz_rl: torch.Tensor
    # de-similarity map [nz,ny,nx]: the Krylov-level row+column
    # equilibration turns the pressure operator into G^-1 A_p G with G the
    # pressure-column factors; the bands store the de-scaled entries and
    # the pressure stage solves A_p y = G r_p, dp = y / G
    gamma: torch.Tensor | None = None
    # fault/NNC scalar couplings of the embedded layout, COO over flat
    # cell indices (ROADMAP.md Queue 1 item 9; never set on the grids the
    # port runs)
    ex_left: torch.Tensor | None = None
    ex_right: torch.Tensor | None = None
    p_ex_lr: torch.Tensor | None = None
    p_ex_rl: torch.Tensor | None = None


def build_cpr_banded(sys, weights: str = "quasiimpes",
                     col_p=None) -> CprBandedData:
    """Quasi/true-IMPES CPR on the StructuredSystem banded layout.
    ``col_p`` [N]: the pressure-column equilibration factors of a
    row+column-scaled ``sys`` (see CprBandedData.gamma)."""
    w = _weights(sys, weights)
    nz, ny, nx = sys.grid
    w3 = w.reshape(nz, ny, nx, w.shape[-1])
    p_diag = (w * sys.diag[:, :, P]).sum(-1).reshape(nz, ny, nx)

    def contract(band, w_row):
        # row-weighted pressure column: w_row . band[..., :, p]
        return (w_row * band[..., :, P]).sum(-1)

    bands = dict(
        px_lr=contract(sys.x_lr, w3[:, :, :-1]),
        px_rl=contract(sys.x_rl, w3[:, :, 1:]),
        py_lr=contract(sys.y_lr, w3[:, :-1, :]),
        py_rl=contract(sys.y_rl, w3[:, 1:, :]),
        pz_lr=contract(sys.z_lr, w3[:-1]),
        pz_rl=contract(sys.z_rl, w3[1:]),
    )
    g = None
    if col_p is not None:
        # undo the similarity: raw_ij = (g_i / g_j) scaled_ij
        g = col_p.reshape(nz, ny, nx)
        bands["px_lr"] = bands["px_lr"] * (g[:, :, :-1] / g[:, :, 1:])
        bands["px_rl"] = bands["px_rl"] * (g[:, :, 1:] / g[:, :, :-1])
        bands["py_lr"] = bands["py_lr"] * (g[:, :-1, :] / g[:, 1:, :])
        bands["py_rl"] = bands["py_rl"] * (g[:, 1:, :] / g[:, :-1, :])
        bands["pz_lr"] = bands["pz_lr"] * (g[:-1] / g[1:])
        bands["pz_rl"] = bands["pz_rl"] * (g[1:] / g[:-1])
    return CprBandedData(weights=w, p_diag=p_diag, gamma=g,
                         **{k: v.contiguous() for k, v in bands.items()})


def _pressure_matvec_banded(c: CprBandedData, x3):
    y = c.p_diag * x3
    y[:, :, :-1] += c.px_lr * x3[:, :, 1:]
    y[:, :, 1:] += c.px_rl * x3[:, :, :-1]
    y[:, :-1, :] += c.py_lr * x3[:, 1:, :]
    y[:, 1:, :] += c.py_rl * x3[:, :-1, :]
    y[:-1] += c.pz_lr * x3[1:]
    y[1:] += c.pz_rl * x3[:-1]
    return y


def _pressure_inner_solve_banded(c: CprBandedData, b3, iters: int):
    """Inner pressure solve on the banded layout: one K5 launch (its plain
    version on CPU tensors). The reference keeps fault/NNC extras in the
    operator by one defect-correction pass (solve, residual with the
    extras, solve the correction); extras come with the embedded layout,
    which is not ported."""
    if c.ex_left is not None:
        raise NotImplementedError(
            "CPR defect correction for fault/NNC extras is not ported yet: "
            "ROADMAP.md Queue 1 item 9 (embedded banded layout)")
    return cprinner.inner_solve_bands(c, b3, iters)


def cpr_banded_apply(c: CprBandedData, sys, r, inner_iters: int, smooth):
    """Two-stage apply on the banded layout: pressure stage, then
    ``smooth(r2) -> x2`` on the remaining residual (solve_linear passes
    the z-line block-Thomas apply, the banded analog of the reference's
    ILU0 fine smoother)."""
    nz, ny, nx = c.p_diag.shape
    r_p = (c.weights * r).sum(-1).reshape(nz, ny, nx)
    if c.gamma is not None:
        r_p = r_p * c.gamma
    dp = _pressure_inner_solve_banded(c, r_p, inner_iters)
    if c.gamma is not None:
        dp = dp / c.gamma
    x1 = torch.zeros_like(r)
    x1[:, P] = dp.reshape(-1)
    r2 = r - spmv.banded_spmv(sys, x1)
    return x1 + smooth(r2)
