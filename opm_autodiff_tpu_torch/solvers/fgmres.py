"""FGMRES: flexible restarted GMRES (right-preconditioned).

Port of opm_autodiff_tpu/solvers/fgmres.py. The CPR pressure stage runs
a fixed-iteration inner Krylov solve, a mildly nonlinear operator;
FGMRES (Saad 1993) stores the preconditioned vectors Z_j, so any
preconditioner is admissible (the reference's RestartedGMRes option of
FlexibleSolver).

Host syncs: the reference leaves a cycle early through a while loop.
Here every cycle runs its ``restart`` Arnoldi steps as masked steps — a
step freezes once the residual estimate |g[j]| clears the target, and a
frozen step writes nothing, exactly the while-loop semantics — and the
host reads the restart decision (the true residual against the target)
once per cycle. Every loop has a fixed trip count.
"""

from __future__ import annotations

from typing import Callable

import torch

from opm_autodiff_tpu_torch.solvers.linear import LinearSolveResult


def fgmres(matvec: Callable, precond: Callable, b, tol: float,
           max_cycles: int, restart: int) -> LinearSolveResult:
    shape = b.shape
    dt, dev = b.dtype, b.device
    bf = b.reshape(-1)
    n = bf.numel()
    m = restart
    one = torch.ones((), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    bnorm = torch.linalg.vector_norm(bf)
    bsafe = torch.where(bnorm > 0, bnorm, one)
    # absolute floor: a ~zero equilibrated rhs means dx = 0 is the
    # converged answer; iterating would underflow float32
    target = torch.clamp(tol * bsafe, min=1e-25)

    def mv(x):
        return matvec(x.reshape(shape)).reshape(-1)

    def pc(x):
        return precond(x.reshape(shape)).reshape(-1)

    def safe_inv(a):
        return torch.where(a > 0, 1.0 / torch.where(a > 0, a, one), zero)

    x = torch.zeros_like(bf)
    nit = torch.zeros((), dtype=torch.int64, device=dev)
    res = torch.full((), float("inf"), dtype=dt, device=dev)
    rows = torch.arange(m + 1, device=dev)
    for _cycle in range(max_cycles):
        if not bool(res > target):   # the one host read per cycle
            break
        r = bf - mv(x)
        beta = torch.linalg.vector_norm(r)
        V = torch.zeros((m + 1, n), dtype=dt, device=dev)
        V[0] = r * safe_inv(beta)
        Z = torch.zeros((m, n), dtype=dt, device=dev)
        R = torch.zeros((m + 1, m), dtype=dt, device=dev)  # rotated H
        cs, sn = [], []
        g = [beta] + [zero] * m
        active = torch.ones((), dtype=torch.bool, device=dev)
        for j in range(m):
            active = active & (torch.abs(g[j]) > target)
            z = pc(V[j])
            w = mv(z)
            # classical Gram-Schmidt, twice (CGS2), as two products with
            # the basis masked to its filled rows
            mask = (rows <= j).to(dt)
            hcol = mask * (V @ w)
            w = w - hcol @ V
            corr = mask * (V @ w)
            w = w - corr @ V
            hcol = hcol + corr
            hj1 = torch.linalg.vector_norm(w)
            V[j + 1] = torch.where(active, w * safe_inv(hj1), zero)
            Z[j] = torch.where(active, z, zero)
            h = list(hcol[:j + 1].unbind()) + [hj1]
            # the previous Givens rotations, then this step's
            for i in range(j):
                h[i], h[i + 1] = (cs[i] * h[i] + sn[i] * h[i + 1],
                                  -sn[i] * h[i] + cs[i] * h[i + 1])
            denom = torch.sqrt(h[j] ** 2 + h[j + 1] ** 2)
            ok = denom > 0
            dsafe = torch.where(ok, denom, one)
            cj = torch.where(ok, h[j] / dsafe, one)
            sj = torch.where(ok, h[j + 1] / dsafe, zero)
            h[j] = denom
            cs.append(torch.where(active, cj, one))
            sn.append(torch.where(active, sj, zero))
            gj = g[j]
            g[j] = torch.where(active, cj * gj, gj)
            g[j + 1] = torch.where(active, -sj * gj, g[j + 1])
            R[:j + 1, j] = torch.where(active, torch.stack(h[:j + 1]), zero)
            nit = nit + active.to(torch.int64)
        # back-substitution R[:m,:m] y = g[:m] with breakdown guards (a
        # frozen step left its column zero)
        Rm = R[:m, :m]
        bad = torch.abs(torch.diagonal(Rm)) < 1e-30
        Rm = Rm + torch.diag(bad.to(dt))
        gm = torch.where(bad, zero, torch.stack(g[:m]))
        y = torch.linalg.solve_triangular(Rm, gm[:, None], upper=True)[:, 0]
        x = x + Z.T @ y
        # the TRUE residual decides the restart, not the Givens estimate
        # |g[m]| (float32 Arnoldi loses orthogonality and the estimate
        # drifts optimistic)
        res = torch.linalg.vector_norm(bf - mv(x))
    rel = res / bsafe
    return LinearSolveResult(x=x.reshape(shape), iterations=nit,
                             rel_residual=rel, converged=rel <= tol)
