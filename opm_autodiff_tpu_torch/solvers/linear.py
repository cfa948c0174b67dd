"""Linear solver: equilibrated f32 BiCGStab with the z-line preconditioner.

Port of the main-path subset of opm_autodiff_tpu/solvers/linear.py
(reference: ISTLSolverEbos.hpp:243 ``solve``; FlexibleSolver bicgstab).
The banded system is row- and column-equilibrated and cast to float32;
the Krylov loop runs on the device with the matvec (K3, ops/spmv.py) and
the z-line block-Thomas preconditioner (K4, ops/zline.py); the well
Schur complement rides in the operator.

Host syncs: the reference runs the whole loop in one ``lax.while_loop``.
Here the loop is a fixed-trip Python loop with masked updates — every
iteration computes the continue flag on the device and freezes the
iterate once it is false, exactly the while-loop semantics — and the
host reads the flag only every ``SYNC_EVERY`` iterations, so a solve
pays one host sync per ``SYNC_EVERY`` iterations instead of one each.

Defaults mirror FlowLinearSolverParameters.hpp: reduction 1e-2,
maxiter 200. Preconditioners: "zline" (default) and "jacobi"; the CPR
family is not ported yet (ROADMAP.md Queue 1 item 10).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from opm_autodiff_tpu_torch.models.structured import StructuredSystem
from opm_autodiff_tpu_torch.ops import spmv, zline

SYNC_EVERY = 8


class LinearSolveResult(NamedTuple):
    x: torch.Tensor            # [N,nb]
    iterations: torch.Tensor   # int64 0-dim
    rel_residual: torch.Tensor
    converged: torch.Tensor    # bool 0-dim


def _dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def invert_blocks(diag):
    """Batched 3x3 block inversion by the cofactor (adjugate) formula; 4x4
    blocks by the bordered form (3x3 cofactors + scalar Schur)."""
    a = diag
    if a.shape[-1] == 4:
        ainv = invert_blocks(a[..., :3, :3])
        bcol = a[..., :3, 3:]
        crow = a[..., 3:, :3]
        d = a[..., 3:, 3:]
        aib = ainv @ bcol
        cai = crow @ ainv
        s = d - crow @ aib
        s_inv = 1.0 / s
        top = torch.cat([ainv + aib * s_inv * cai, -aib * s_inv], dim=-1)
        bot = torch.cat([-s_inv * cai, s_inv], dim=-1)
        return torch.cat([top, bot], dim=-2)
    if a.shape[-1] != 3:
        return torch.linalg.inv(a)
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    det = a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02
    inv_det = 1.0 / det
    adj = torch.stack([
        torch.stack([c00, c10, c20], dim=-1),
        torch.stack([c01, c11, c21], dim=-1),
        torch.stack([c02, c12, c22], dim=-1),
    ], dim=-2)
    return adj * inv_det[..., None, None]


def block_jacobi_apply(inv_diag, r):
    return torch.einsum("nij,nj->ni", inv_diag, r)


def scale_system(sys: StructuredSystem, row, col, dtype) -> StructuredSystem:
    """Row/column-equilibrated cast of the banded system."""
    nz, ny, nx = sys.grid
    nb = sys.diag.shape[-1]
    r3 = row.reshape(nz, ny, nx, nb)
    c3 = col.reshape(nz, ny, nx, nb)

    def sc(band, rsl, csl):
        return (band * rsl[..., :, None] * csl[..., None, :]).to(dtype)

    return sys._replace(
        diag=(sys.diag * row[:, :, None] * col[:, None, :]).to(dtype),
        x_lr=sc(sys.x_lr, r3[:, :, :-1], c3[:, :, 1:]),
        x_rl=sc(sys.x_rl, r3[:, :, 1:], c3[:, :, :-1]),
        y_lr=sc(sys.y_lr, r3[:, :-1, :], c3[:, 1:, :]),
        y_rl=sc(sys.y_rl, r3[:, 1:, :], c3[:, :-1, :]),
        z_lr=sc(sys.z_lr, r3[:-1], c3[1:]),
        z_rl=sc(sys.z_rl, r3[1:], c3[:-1]))


def bicgstab(matvec: Callable, precond: Callable, b, tol: float = 1e-2,
             maxiter: int = 200) -> LinearSolveResult:
    """Right-preconditioned BiCGStab from x0 = 0; ``tol`` is the relative
    residual reduction. Breakdowns end the loop as status flags."""
    dev, dt = b.device, b.dtype
    x = torch.zeros_like(b)
    r = b
    bnorm = torch.sqrt(_dot(b, b))
    bnorm = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
    # an (equilibrated) rhs this small means the Newton iterate is
    # converged already: dx = 0 is the right step
    target = torch.maximum(tol * bnorm, torch.tensor(1e-25, dtype=dt,
                                                     device=dev))
    eps_breakdown = 1e-140
    one = torch.ones((), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    rhat = r
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    rho, alpha, omega = one, one, one
    k = torch.zeros((), dtype=torch.int64, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)

    def safediv(a, d):
        good = torch.abs(d) > eps_breakdown
        return torch.where(good, a / torch.where(good, d, one), zero), good

    for it in range(maxiter):
        rnorm = torch.sqrt(_dot(r, r))
        cont = (rnorm > target) & (k < maxiter) & ok
        if it % SYNC_EVERY == 0 and not bool(cont):
            break
        rho_new = _dot(rhat, r)
        f1, _ = safediv(rho_new, rho)
        f2, _ = safediv(alpha, omega)
        beta = f1 * f2
        p_n = r + beta * (p - omega * v)
        phat = precond(p_n)
        v_n = matvec(phat)
        alpha_n, alpha_ok = safediv(rho_new, _dot(rhat, v_n))
        s = r - alpha_n * v_n
        shat = precond(s)
        t = matvec(shat)
        omega_n, _ = safediv(_dot(t, s), _dot(t, t))
        x_n = x + alpha_n * phat + omega_n * shat
        r_n = s - omega_n * t
        ok_n = (torch.abs(rho_new) > eps_breakdown) & alpha_ok
        ok_n = ok_n & torch.isfinite(r_n).all()
        # masked update: a finished solve keeps its iterate
        x = torch.where(cont, x_n, x)
        r = torch.where(cont, r_n, r)
        p = torch.where(cont, p_n, p)
        v = torch.where(cont, v_n, v)
        rho = torch.where(cont, rho_new, rho)
        alpha = torch.where(cont, alpha_n, alpha)
        omega = torch.where(cont, omega_n, omega)
        ok = torch.where(cont, ok_n, ok)
        k = k + cont.to(torch.int64)
    rel = torch.sqrt(_dot(r, r)) / bnorm
    return LinearSolveResult(x=x, iterations=k, rel_residual=rel,
                             converged=rel <= tol)


def solve_linear(sys: StructuredSystem, b=None,
                 extra_matvec: Callable | None = None, tol: float = 1e-2,
                 maxiter: int = 200, precond: str = "zline"):
    """Solve J dx = b (default b = -residual) with equilibrated f32
    BiCGStab. ``extra_matvec(x)`` adds the well Schur complement to the
    operator. Mixed precision: the Krylov iteration runs in float32 for
    loose reductions (tol >= 1e-5), on a row+column-equilibrated copy of
    the system so entries and unknowns are O(1)."""
    if precond not in ("zline", "jacobi"):
        raise NotImplementedError(
            f"preconditioner {precond!r} is not ported yet (ROADMAP.md "
            "Queue 1 item 10: CPR); use 'zline' or 'jacobi'")
    if b is None:
        b = -sys.residual
    f64 = sys.residual.dtype
    dtype = torch.float32 if tol >= 1e-5 else f64
    tiny = torch.finfo(sys.diag.dtype).tiny
    row = 1.0 / torch.clamp(torch.abs(sys.diag).amax(dim=2), min=tiny)
    dscaled = sys.diag * row[:, :, None]
    col = 1.0 / torch.clamp(torch.abs(dscaled).amax(dim=1), min=tiny)
    scaled = scale_system(sys, row, col, dtype)
    b_s = (b * row).to(dtype)
    row32 = row.to(dtype)
    col32 = col.to(dtype)

    def matvec(y):
        z = spmv.banded_spmv(scaled, y)
        if extra_matvec is not None:
            z = z + extra_matvec(y * col32).to(dtype) * row32
        return z

    if precond == "zline":
        fact = zline.build_zline(scaled)

        def prec(r):
            return zline.zline_apply(fact, r)
    else:
        inv_diag = invert_blocks(scaled.diag)

        def prec(r):
            return block_jacobi_apply(inv_diag, r)

    res = bicgstab(matvec, prec, b_s, tol=tol, maxiter=maxiter)
    return LinearSolveResult(x=res.x.to(f64) * col,
                             iterations=res.iterations,
                             rel_residual=res.rel_residual.to(f64),
                             converged=res.converged)
