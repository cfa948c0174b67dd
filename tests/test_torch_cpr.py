"""Banded CPR (K5's plain version, the CPR build and apply, FGMRES) of the
PyTorch/CUDA port against the JAX package, on the CPU; and the slice as a
whole, one Newton iteration with ``linear_precond="cpr"``.

The port's kernels run only on the card; on CPU tensors their wrappers
run the plain PyTorch versions, which are what is compared here. The
port follows the JAX package's TPU path on both devices (z-line fine
smoother, single-solve inner pressure stage), so the JAX side is composed
explicitly: ``cpr_banded_apply(..., smooth=partial(zline_apply,
build_zline(sys)))`` over ``_pressure_inner_solve_generic``. No Pallas
kernel runs here, not even in interpret mode.

Tolerances:

* (a)-(b) float64 on both sides: max|port - ref| <= 1e-10 max|ref|;
* (c) FGMRES in float32 on both sides: iteration counts within 1,
  ``converged`` equal, x within 1e-4 of max|x|;
* the Newton iteration: as tests/test_torch_entry.py, with the updates
  within 1e-3 of each variable's largest update (the JAX CPU side smooths
  with block-Jacobi and solves the pressure stage with the generic
  BiCGStab, the port with z-line and K5's plain version, so the two f32
  Krylov solves differ by their tolerance, not by rounding; measured:
  5e-6 of the largest update).
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-10


def _close(got, ref, what, rtol=RTOL):
    got = np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if not got.size:
        return
    err = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-300)
    assert err <= rtol, f"{what}: {err:.3e} > {rtol}"
    assert np.isfinite(got).all(), what


def _pressure_system(shape, rng, diag_only=False):
    """Diagonally dominant scalar 7-point system (tests/test_pallas_cpr.py
    toy), as numpy arrays keyed like CprBandedData."""
    nz, ny, nx = shape

    def band(*s):
        return -rng.uniform(0.1, 1.0, s) * (0.0 if diag_only else 1.0)

    d = rng.uniform(6.0, 8.0, shape)
    if diag_only:
        # powers of two: p / d * d == p exactly, so the residual is exactly
        # zero after one iteration and every breakdown guard fires
        d = 2.0 ** rng.integers(1, 4, shape)
    return dict(p_diag=d, px_lr=band(nz, ny, nx - 1), px_rl=band(nz, ny, nx - 1),
                py_lr=band(nz, ny - 1, nx), py_rl=band(nz, ny - 1, nx),
                pz_lr=band(nz - 1, ny, nx), pz_rl=band(nz - 1, ny, nx))


def _block_system(dims, rng, off=0.1):
    """Random diagonally dominant 3x3 banded system with a storage
    Jacobian (tests/test_torch_linear.py's systems)."""
    nx, ny, nz = dims
    n = nx * ny * nz

    def r(*s):
        return off * rng.standard_normal(s)

    return dict(residual=r(n, 3), diag=r(n, 3, 3) + 4.0 * np.eye(3),
                x_lr=r(nz, ny, nx - 1, 3, 3), x_rl=r(nz, ny, nx - 1, 3, 3),
                y_lr=r(nz, ny - 1, nx, 3, 3), y_rl=r(nz, ny - 1, nx, 3, 3),
                z_lr=r(nz - 1, ny, nx, 3, 3), z_rl=r(nz - 1, ny, nx, 3, 3),
                acc_jac=0.5 * rng.standard_normal((n, 3, 3))
                + np.diag([1e-8, 2.0, 3.0]))


def test_inner_solve_plain_matches_reference():
    """(a) K5's plain version against the reference's generic inner solve
    over its banded pressure matvec: toy systems, singleton axes, iters 6
    and 12, b = 0 and the diagonal-only case where the guards fire."""
    import jax
    import jax.numpy as jnp
    import torch

    torch.set_num_threads(1)
    from opm_autodiff_tpu.solvers.cpr import (CprBandedData,
                                              _pressure_inner_solve_generic,
                                              _pressure_matvec_banded)
    from opm_autodiff_tpu_torch.ops import cprinner
    from opm_autodiff_tpu_torch.solvers import cpr as tcpr

    @jax.jit
    def reference(arrs, b):
        c = CprBandedData(weights=None, inv_diag=None, **arrs)
        mv = lambda v: _pressure_matvec_banded(c, v)  # noqa: E731
        return (_pressure_inner_solve_generic(mv, c.p_diag, b, 6),
                _pressure_inner_solve_generic(mv, c.p_diag, b, 12))

    rng = np.random.default_rng(7)
    # (shape, diagonal only, b = 0); one compile of the reference per shape
    cases = [((4, 6, 8), False, False), ((4, 6, 8), False, True),
             ((4, 6, 8), True, False), ((5, 1, 1), False, False),
             ((1, 4, 5), False, False)]
    for shape, diag_only, zero_rhs in cases:
        arrs = _pressure_system(shape, rng, diag_only)
        b = np.zeros(shape) if zero_rhs else rng.standard_normal(shape)
        refs = reference({k: jnp.asarray(v) for k, v in arrs.items()},
                         jnp.asarray(b))
        c = tcpr.CprBandedData(weights=None, **{
            k: torch.as_tensor(v) for k, v in arrs.items()})
        for iters, ref in zip((6, 12), refs):
            got = cprinner.inner_solve_bands(c, torch.as_tensor(b), iters)
            tag = f"{shape} iters={iters} diag_only={diag_only} b0={zero_rhs}"
            if zero_rhs:
                assert not np.asarray(ref).any()
                assert not got.numpy().any(), tag
            else:
                _close(got.numpy(), ref, tag)
        if diag_only:
            # the residual is exactly zero after one iteration: x = b / d
            np.testing.assert_array_equal(got.numpy(), b / arrs["p_diag"])


def test_cpr_build_and_apply_match_reference():
    """(b) build_cpr_banded (quasi- and true-IMPES, with col_p) and
    cpr_banded_apply with the z-line smoother against the reference."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    import torch

    torch.set_num_threads(1)
    from opm_autodiff_tpu.models.structured import StructuredSystem
    from opm_autodiff_tpu.solvers import linear as jlin
    from opm_autodiff_tpu.solvers.cpr import build_cpr_banded, cpr_banded_apply
    from opm_autodiff_tpu_torch.models.structured import (
        StructuredSystem as TSystem)
    from opm_autodiff_tpu_torch.ops import zline
    from opm_autodiff_tpu_torch.solvers import cpr as tcpr

    fields = ("weights", "p_diag", "px_lr", "px_rl", "py_lr", "py_rl",
              "pz_lr", "pz_rl", "gamma")

    @jax.jit
    def reference(sys, r, col_p):
        smooth = partial(jlin.zline_apply, jlin.build_zline(sys))
        out = []
        for mode in ("quasiimpes", "trueimpes"):
            c = build_cpr_banded(sys, None, weights=mode, col_p=col_p)
            out.append(([getattr(c, f) for f in fields],
                        cpr_banded_apply(c, sys, r, 12, smooth=smooth)))
        return out

    rng = np.random.default_rng(11)
    for dims in ((5, 4, 3), (1, 3, 4)):
        arrs = _block_system(dims, rng)
        n = int(np.prod(dims))
        r = rng.standard_normal((n, 3))
        col_p = rng.uniform(0.5, 2.0, n)
        jsys = StructuredSystem(**{k: jnp.asarray(v) for k, v in arrs.items()})
        refs = reference(jsys, jnp.asarray(r), jnp.asarray(col_p))
        tsys = TSystem(**{k: torch.as_tensor(v) for k, v in arrs.items()})
        fact = zline.build_zline(tsys)
        for mode, (cref, xref) in zip(("quasiimpes", "trueimpes"), refs):
            c = tcpr.build_cpr_banded(tsys, weights=mode,
                                      col_p=torch.as_tensor(col_p))
            for f, ref in zip(fields, cref):
                _close(getattr(c, f).numpy(), ref, f"{dims} {mode} {f}")
            x = tcpr.cpr_banded_apply(
                c, tsys, torch.as_tensor(r), 12,
                smooth=lambda v: zline.zline_apply(fact, v))
            _close(x.numpy(), xref, f"{dims} {mode} apply")


def test_fgmres_matches_reference():
    """(c) FGMRES with the CPR apply, float32 on both sides, on a 4x6x8
    system over several restart cycles: iteration count within 1,
    converged equal, x within 1e-4 of max|x|."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    import torch

    torch.set_num_threads(1)
    from opm_autodiff_tpu.models.structured import (StructuredSystem,
                                                    structured_matvec)
    from opm_autodiff_tpu.solvers import linear as jlin
    from opm_autodiff_tpu.solvers.cpr import build_cpr_banded, cpr_banded_apply
    from opm_autodiff_tpu.solvers.fgmres import fgmres as jfgmres
    from opm_autodiff_tpu_torch.models.structured import (
        StructuredSystem as TSystem)
    from opm_autodiff_tpu_torch.ops import spmv, zline
    from opm_autodiff_tpu_torch.solvers import cpr as tcpr
    from opm_autodiff_tpu_torch.solvers.fgmres import fgmres

    tol, max_cycles = 1e-5, 6
    rng = np.random.default_rng(5)
    arrs = {k: v.astype(np.float32) for k, v in
            _block_system((8, 6, 4), rng, off=0.6).items()}
    b = arrs["residual"]

    @jax.jit
    def reference(sys, b):
        smooth = partial(jlin.zline_apply, jlin.build_zline(sys))
        c = build_cpr_banded(sys, None)
        res = jfgmres(partial(structured_matvec, sys),
                      lambda r: cpr_banded_apply(c, sys, r, 6, smooth=smooth),
                      b, tol=tol, max_cycles=max_cycles, restart=8)
        return res.x, res.iterations, res.converged

    x_ref, it_ref, conv_ref = reference(
        StructuredSystem(**{k: jnp.asarray(v) for k, v in arrs.items()}),
        jnp.asarray(b))
    tsys = TSystem(**{k: torch.as_tensor(v) for k, v in arrs.items()})
    fact = zline.build_zline(tsys)
    c = tcpr.build_cpr_banded(tsys)
    res = fgmres(lambda v: spmv.banded_spmv(tsys, v),
                 lambda r: tcpr.cpr_banded_apply(
                     c, tsys, r, 6, smooth=lambda v: zline.zline_apply(fact, v)),
                 torch.as_tensor(b), tol=tol, max_cycles=max_cycles, restart=8)
    it_ref = int(it_ref)
    assert it_ref > 8, it_ref          # more than one restart cycle
    assert abs(int(res.iterations) - it_ref) <= 1, (int(res.iterations), it_ref)
    assert bool(res.converged) == bool(conv_ref)
    _close(res.x.numpy(), x_ref, "fgmres x", rtol=1e-4)


def test_one_newton_step_with_cpr_matches_reference():
    """The slice as a whole: one Newton iteration on the 10x10x3 SPE1
    problem of ``__graft_entry__.entry()`` with ``linear_precond="cpr"``
    and ``linear_tol=1e-5`` (the tightest tolerance that keeps both sides
    on the float32 equilibrated Krylov branch), through the port's
    ``newton_iteration`` and the reference's ``newton_iteration_impl``."""
    import jax
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    import __graft_entry__ as ge
    from opm_autodiff_tpu.solvers.newton import NewtonParams, NewtonState
    from opm_autodiff_tpu.solvers.newton import newton_iteration_impl
    from opm_autodiff_tpu.wells import standard4 as s4
    from opm_autodiff_tpu_torch.entry import build_problem
    from opm_autodiff_tpu_torch.solvers import newton as tnewton

    lin = dict(linear_precond="cpr", linear_tol=1e-5)
    (_s, _g, fs, cells, faces, init, ws, acc0, pbh) = ge._build_problem()
    params = NewtonParams(**lin)
    xw0 = s4.init_xw(fs, init.u, init.flag, ws, pbh=pbh)
    dt = 86400.0

    @jax.jit
    def reference(u, flag, xw, mode, acc0):
        st = NewtonState(u=u, flag=flag, pbh=xw[:, 3], active_mode=mode,
                         xw=xw)
        new_st, info, (q_tot, _q_perf, _q_msw, _res), _q_aq = (
            newton_iteration_impl(params, fs, cells, faces, st, ws, acc0, dt))
        return (new_st.u, new_st.flag, new_st.xw, info.cnv, q_tot,
                info.linear_ok)

    out_j = [np.asarray(o) for o in reference(init.u, init.flag, xw0,
                                              ws.ctrl_mode, acc0)]

    (_s, _g, tfs, tcells, topo, tinit, tws, tacc0, tpbh) = build_problem(
        device="cpu")
    np.testing.assert_array_equal(tinit.u.numpy(), np.asarray(init.u))
    np.testing.assert_array_equal(tacc0.numpy(), np.asarray(acc0))
    txw0 = tnewton.s4.init_xw(tinit.u, tws, pbh=tpbh)
    np.testing.assert_array_equal(txw0.numpy(), np.asarray(xw0))
    st = tnewton.NewtonState(u=tinit.u, flag=tinit.flag, pbh=txw0[:, 3],
                             active_mode=tws.ctrl_mode, xw=txw0)
    new_st, info, (q_tot, _q_perf, _res) = tnewton.newton_iteration(
        tnewton.NewtonParams(**lin), tfs, tcells, topo, st, tws, tacc0, dt)
    out_t = [new_st.u.numpy(), new_st.flag.numpy(), new_st.xw.numpy(),
             info.cnv.numpy(), q_tot.numpy(), info.linear_ok.numpy()]
    u_j, flag_j, xw_j, cnv_j, q_j, ok_j = out_j
    u_t, flag_t, xw_t, cnv_t, q_t, ok_t = out_t

    assert bool(ok_j) and bool(ok_t), (ok_j, ok_t)
    np.testing.assert_array_equal(flag_t, flag_j)
    np.testing.assert_array_equal(q_t, q_j)
    np.testing.assert_allclose(cnv_t, cnv_j, rtol=1e-6, atol=1e-9)
    for got, ref, x0, name in ((u_t, u_j, np.asarray(init.u), "u"),
                               (xw_t, xw_j, np.asarray(xw0), "xw")):
        step = np.abs(ref - x0).max(axis=0)
        err = np.abs(got - ref).max(axis=0)
        assert (err <= 1e-3 * step + 1e-300).all(), (name, err / step)
        assert np.isfinite(got).all()
