"""Newton nonlinear solver: assemble -> converge-check -> solve -> update.

Port of the main-path subset of opm_autodiff_tpu/solvers/newton.py
(reference: NonlinearSolverEbos::step + BlackoilModelEbos::
nonlinearIteration and opm-models' Appleyard chopping + primary-variable
switching): the 3-equation black-oil model on a fully active structured
grid, the 4-DOF StandardWell under BHP/rate control, the equilibrated f32
Krylov solve (BiCGStab with the z-line preconditioner, or FGMRES with
banded CPR), and a host-driven iteration loop. Tolerances/defaults mirror
BlackoilModelParametersEbos.hpp:178-196.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from opm_autodiff_tpu_torch.models.blackoil import (FLAG_RS, FLAG_RV,
                                                    FLAG_SG, PrimaryState)
from opm_autodiff_tpu_torch.models.structured import assemble_structured
from opm_autodiff_tpu_torch.solvers.linear import check_precond, solve_linear
from opm_autodiff_tpu_torch.wells import standard as wells_mod
from opm_autodiff_tpu_torch.wells import standard4 as s4
from opm_autodiff_tpu_torch.wells.standard import CTRL_BHP, WellSet


@dataclasses.dataclass(frozen=True)
class NewtonParams:
    max_iter: int = 20
    min_iter: int = 1
    tol_mb: float = 1e-6
    tol_cnv: float = 1e-2
    tol_cnv_relaxed: float = 1.0
    relaxed_pv_fraction: float = 0.03
    tol_wells: float = 1e-4
    max_residual_allowed: float = 1e7
    ds_max: float = 0.2
    dp_max_rel: float = 0.3
    drs_max_rel: float = 0.2
    linear_tol: float = 1e-2
    linear_maxiter: int = 200
    linear_precond: str = "zline"   # "zline" | "jacobi" | "cpr" | "cprt"
    has_water: bool = True
    has_gas: bool = True
    has_oil: bool = True


class NewtonState(NamedTuple):
    u: torch.Tensor           # [N,3] float64
    flag: torch.Tensor        # [N] int32
    pbh: torch.Tensor         # [W]
    active_mode: torch.Tensor  # [W]
    xw: torch.Tensor          # [W,4] 4-DOF StandardWell unknowns


class IterationInfo(NamedTuple):
    cnv: torch.Tensor
    mb: torch.Tensor
    well_err: torch.Tensor
    relaxed_ok: torch.Tensor
    converged: torch.Tensor
    failed: torch.Tensor
    linear_iters: torch.Tensor
    linear_ok: torch.Tensor
    well_err_by_well: torch.Tensor | None = None


def check_params(params: NewtonParams) -> None:
    if not (params.has_water and params.has_gas and params.has_oil):
        raise NotImplementedError(
            "two-phase and single-phase variants are not ported yet: "
            "ROADMAP.md Queue 1 item 14")
    check_precond(params.linear_precond)


def _convergence(params: NewtonParams, cells, residual, inv_b, dt,
                 well_err):
    """CNV / MB metrics (BlackoilModelEbos.hpp:628-904)."""
    pv = cells.pore_vol_ref
    f64 = pv.dtype
    pv_sum = pv.sum()
    if residual.dtype == torch.float32:
        # float32-stored system: elementwise scaling in f32, the MB sum
        # accumulates in f64
        inv_b32 = inv_b.to(torch.float32)
        pv32 = pv.to(torch.float32)
        r_scaled = residual / inv_b32
        dt32 = torch.as_tensor(dt, dtype=torch.float32, device=pv.device)
        cnv_cell = torch.abs(r_scaled) * dt32 / pv32[:, None]
        cnv = cnv_cell.amax(dim=0).to(f64)
        mb = torch.abs(r_scaled.to(f64).sum(dim=0)) * dt / pv_sum
        viol = (cnv_cell > params.tol_cnv).any(dim=1)
        pv_frac_viol = (torch.where(viol, pv32, torch.zeros_like(pv32)).sum()
                        / pv32.sum()).to(f64)
        max_res = torch.abs(r_scaled).max().to(f64)
    else:
        r_scaled = ((1.0 / inv_b) * residual).to(f64)
        cnv_cell = torch.abs(r_scaled) * dt / pv[:, None]
        cnv = cnv_cell.amax(dim=0)
        mb = torch.abs(r_scaled.sum(dim=0)) * dt / pv_sum
        viol = (cnv_cell > params.tol_cnv).any(dim=1)
        pv_frac_viol = torch.where(viol, pv, torch.zeros_like(pv)).sum() \
            / pv_sum
        max_res = torch.abs(r_scaled).max()
    relaxed_ok = (pv_frac_viol < params.relaxed_pv_fraction) & \
        (cnv < params.tol_cnv_relaxed).all()
    cnv_ok = (cnv < params.tol_cnv).all() | relaxed_ok
    mb_ok = (mb < params.tol_mb).all()
    wells_ok = well_err < params.tol_wells
    converged = cnv_ok & mb_ok & wells_ok
    failed = (~torch.isfinite(max_res)) | \
        (max_res > params.max_residual_allowed * pv_sum)
    return cnv, mb, relaxed_ok, converged, failed


def _chop_and_update(params: NewtonParams, fs, u, flag, dx, pvtnum=None):
    """Appleyard-chopped update + primary-variable switching
    (opm-models BlackOilNewtonMethod::update_ semantics)."""
    po, sw, x3 = u[:, 0], u[:, 1], u[:, 2]
    # the saturation chop runs in the update's own dtype (its bounds are
    # that dtype's nearest values), the others against float64 limits
    dsw = torch.clamp(dx[:, 1], -params.ds_max, params.ds_max).to(u.dtype)
    dx = dx.to(u.dtype)
    dpo, dx3 = dx[:, 0], dx[:, 2]

    dp_lim = torch.clamp(params.dp_max_rel * torch.abs(po), min=1e5)
    dpo = torch.minimum(torch.maximum(dpo, -dp_lim), dp_lim)

    is_sg = flag == FLAG_SG
    is_rs = flag == FLAG_RS
    is_rv = flag == FLAG_RV
    x3_lim = torch.where(
        is_sg, torch.full_like(x3, params.ds_max),
        torch.where(is_rs,
                    torch.clamp(params.drs_max_rel * torch.abs(x3), min=1.0),
                    torch.clamp(params.drs_max_rel * torch.abs(x3),
                                min=1e-3)))
    dx3 = torch.minimum(torch.maximum(dx3, -x3_lim), x3_lim)

    po_new = torch.clamp(po + dpo, 1e4, 2e9)
    sw_new = torch.clamp(sw + dsw, 0.0, 1.0)
    x3_new = x3 + dx3

    # switching thresholds evaluated in float32 (values are compared,
    # not accumulated)
    po32 = po_new.to(torch.float32)
    rs_sat_new = fs.rs_sat_vec(po32, pvtnum).to(u.dtype)
    rv_sat_new = fs.rv_sat_vec(po32, pvtnum).to(u.dtype)
    gas_on = params.has_gas
    oil_on = params.has_oil
    to_rs = is_sg & (x3_new < 0.0) & gas_on & oil_on & (1.0 - sw_new > 1e-6)
    to_rv = is_sg & ~to_rs & (1.0 - sw_new - x3_new < 0.0) & gas_on \
        & (fs.wet_gas or not oil_on) & (1.0 - sw_new > 1e-6)
    to_sg_rs = is_rs & ((x3_new > rs_sat_new) | (1.0 - sw_new <= 1e-6)) \
        & gas_on
    to_sg_rv = is_rv & ((x3_new > rv_sat_new) | (1.0 - sw_new <= 1e-6)) \
        & gas_on & oil_on

    flag_new = torch.where(
        to_rs, FLAG_RS,
        torch.where(to_rv, FLAG_RV,
                    torch.where(to_sg_rs | to_sg_rv, FLAG_SG,
                                flag.to(torch.int64)))).to(flag.dtype)
    x3_stay = torch.where(
        is_sg,
        torch.minimum(torch.clamp(x3_new, min=0.0), 1.0 - sw_new + 1e-3),
        torch.clamp(x3_new, min=0.0))
    x3_new = torch.where(
        to_rs, rs_sat_new,
        torch.where(to_rv, rv_sat_new,
                    torch.where(to_sg_rs, torch.zeros_like(x3_new),
                                torch.where(to_sg_rv,
                                            torch.clamp(1.0 - sw_new - 1e-4,
                                                        min=0.0),
                                            x3_stay))))
    return torch.stack([po_new, sw_new, x3_new], dim=1), flag_new


def update_well_controls(ws: WellSet, active_mode, pbh, q_tot):
    """Control switching (WellInterface_impl.hpp:155 updateWellControl),
    BHP and rate limits."""
    prod = -q_tot
    sched = ws.ctrl_mode
    prod_to_bhp = (~ws.is_injector) & (active_mode != CTRL_BHP) & \
        (pbh < ws.bhp_limit)
    resv_prod = (ws.voidage_coeff * prod).sum(dim=1)
    sched_rate = s4._select(
        [sched == wells_mod.CTRL_ORAT, sched == wells_mod.CTRL_WRAT,
         sched == wells_mod.CTRL_GRAT, sched == wells_mod.CTRL_LRAT,
         sched == wells_mod.CTRL_RESV],
        [prod[:, 1] - ws.orat, prod[:, 0] - ws.wrat, prod[:, 2] - ws.grat,
         prod[:, 0] + prod[:, 1] - ws.lrat, resv_prod - ws.resv_rate],
        torch.full_like(pbh, -1.0))
    limit_active = (active_mode == CTRL_BHP) | \
        (active_mode == wells_mod.CTRL_THP)
    prod_to_rate = (~ws.is_injector) & limit_active & \
        (sched != active_mode) & (sched_rate > 0.0)
    inj_rate_now = q_tot.sum(dim=1)
    inj_resv_now = (ws.voidage_coeff * q_tot).sum(dim=1)
    inj_target_exceeded = torch.where(sched == wells_mod.CTRL_RESV,
                                      inj_resv_now > ws.resv_rate,
                                      inj_rate_now > ws.inj_rate)
    inj_to_bhp = ws.is_injector & (active_mode != CTRL_BHP) & \
        (pbh > ws.bhp_limit)
    inj_to_rate = ws.is_injector & (active_mode == CTRL_BHP) & \
        (sched != CTRL_BHP) & inj_target_exceeded
    new_mode = torch.where(prod_to_bhp | inj_to_bhp, CTRL_BHP, active_mode)
    new_mode = torch.where(prod_to_rate | inj_to_rate, sched, new_mode)
    return torch.where(sched == wells_mod.CTRL_STOP, wells_mod.CTRL_STOP,
                       new_mode)


def newton_iteration(params: NewtonParams, fs, cells, topo,
                     st: NewtonState, ws: WellSet, acc0, dt, relax=1.0,
                     rho_conn=None, drift_vol=None, well_f0=None):
    """One full Newton iteration. Returns (new_state, info,
    (q_tot, q_perf, residual))."""
    u, flag = st.u, st.flag

    # control switching on the primary-variable rates, then ONE assembly
    q_tot_pv = s4.xw_surface_rates(st.xw, ws)
    mode = update_well_controls(ws, st.active_mode, st.xw[:, 3], q_tot_pv)
    q_tot = torch.where(ws.open_mask[:, None], q_tot_pv,
                        torch.zeros_like(q_tot_pv))

    # the system is stored in float32, the kernels' precision: the Krylov
    # solve runs equilibrated float32 either way
    sys, packed = assemble_structured(fs, cells, topo, PrimaryState(u, flag),
                                      acc0, dt, out_dtype=torch.float32)
    inv_b_cells = sys.inv_b
    if rho_conn is not None:
        wr = s4.well4_contributions_packed(packed, st.xw, ws, mode, rho_conn,
                                           well_f0, dt)
    else:
        wr = s4.well4_contributions(fs, u, flag, st.xw, ws, mode, cells.regs,
                                    cells.mob_mult, cells.eps, None,
                                    well_f0, dt)
    residual = s4.apply_to_residual(sys.residual, wr, ws)
    diag = s4.apply_to_diag(sys.diag, wr, ws)

    # drift compensation: the previous substep's leftover residual (x dt)
    # re-enters as a source, capped at 10x the CNV tolerance
    # (eclproblem.hh:1848-1874)
    if drift_vol is not None:
        rate = torch.minimum(drift_vol.to(acc0.dtype) / dt, acc0 / dt)
        vols = torch.abs(rate) * dt
        comp_total = (vols / cells.pore_vol_ref[:, None]).sum(dim=1)
        cap = 10.0 * params.tol_cnv
        comp_scale = torch.where(
            comp_total > cap, cap / torch.clamp(comp_total, min=1e-300),
            torch.ones_like(comp_total))
        residual = residual + (rate * comp_scale[:, None]).to(residual.dtype)
    sys = sys._replace(residual=residual, diag=diag)

    b_avg = (1.0 / torch.clamp(inv_b_cells, min=1e-6)).mean(dim=0)
    well_err_vec = s4.well_convergence(wr, ws, mode, b_avg)
    well_err = well_err_vec.max()
    cnv, mb, relaxed_ok, converged, failed = _convergence(
        params, cells, residual, inv_b_cells, dt, well_err)

    rhs = -residual + s4.schur_rhs(residual, wr, ws)
    lin = solve_linear(sys, rhs,
                       extra_matvec=lambda x: s4.schur_matvec(wr, ws, x),
                       tol=params.linear_tol, maxiter=params.linear_maxiter,
                       precond=params.linear_precond)
    dx = lin.x
    dx_ok = torch.isfinite(dx).all()
    failed = failed | ~dx_ok
    dx = torch.where(dx_ok, dx, torch.zeros_like(dx))
    dx = dx * torch.as_tensor(relax, dtype=dx.dtype, device=dx.device)
    dxw = s4.recover_xw_update(wr, ws, dx)
    dxw = torch.where(torch.isfinite(dxw), dxw, torch.zeros_like(dxw))
    xw_new = s4.chop_xw_update(st.xw, dxw, ws)

    u_new, flag_new = _chop_and_update(params, fs, u, flag, dx,
                                       cells.regs[:, 1])
    info = IterationInfo(cnv=cnv, mb=mb, well_err=well_err,
                         relaxed_ok=relaxed_ok, converged=converged,
                         failed=failed, linear_iters=lin.iterations,
                         linear_ok=lin.converged,
                         well_err_by_well=well_err_vec)
    new_st = NewtonState(u=u_new, flag=flag_new, pbh=xw_new[:, 3],
                         active_mode=mode, xw=xw_new)
    return new_st, info, (q_tot, wr.q_perf, residual)


@dataclasses.dataclass
class NewtonReport:
    converged: bool
    iterations: int
    linear_iterations: int
    failed: bool
    cnv: np.ndarray = None
    mb: np.ndarray = None
    well_err: float = 0.0
    # [N,3] residual of the last assembled iteration (drift capture)
    residual: object = None
    well_errors: np.ndarray = None


def newton_solve(params: NewtonParams, fs, cells, topo, st: NewtonState,
                 ws: WellSet, acc0, dt, verbose: bool = False,
                 drift_vol=None):
    """Host-driven Newton loop (NonlinearSolverEbos::step). Returns
    (final_state, report, (q_tot, q_perf)). Convergence is judged on the
    assembled (pre-update) residual, so the state BEFORE the final update
    is returned on convergence."""
    check_params(params)
    s4.check_controls(ws)
    total_lin = 0
    hist: list[np.ndarray] = []
    relax = 1.0
    rho_conn = wells_mod.connection_densities(fs, st.u, st.flag, ws,
                                              cells.regs)
    # inner well solve with the reservoir frozen (prepareTimeStep)
    xw0 = s4.solve_well_eq(fs, st.u, st.flag, st.xw, ws, st.active_mode,
                           cells.regs, cells.mob_mult, cells.eps, rho_conn,
                           dt)
    st = st._replace(xw=xw0, pbh=xw0[:, 3])
    well_f0 = s4._surface_fractions(xw0[:, 1], xw0[:, 2])
    last = None
    for it in range(params.max_iter + 1):
        new_st, info, (q_tot, q_perf, res) = newton_iteration(
            params, fs, cells, topo, st, ws, acc0, dt, relax, rho_conn,
            drift_vol, well_f0)
        last = (q_tot, q_perf)
        # one host read per iteration: the flags and the MB history
        flags = torch.stack([info.converged, info.failed]).cpu()
        mb_h = info.mb.cpu().numpy()
        n_lin = int(info.linear_iters)
        # oscillation detection (NonlinearSolverEbos.hpp:278-309)
        hist.append(mb_h)
        if len(hist) >= 3:
            f0, f1, f2 = hist[-1], hist[-2], hist[-3]
            denom = np.where(f0 != 0.0, f0, 1.0)
            d1 = np.abs((f0 - f2) / denom)
            d2 = np.abs((f0 - f1) / denom)
            osc = int(((d1 < 0.2) & (d2 > 0.2)).sum()) >= 2
            relax = max(relax - 0.1, 0.5) if osc else min(relax + 0.1, 1.0)
        failed = bool(flags[1])
        conv = bool(flags[0]) and it >= params.min_iter
        total_lin += n_lin
        if verbose:
            print(f"  newton {it}: cnv={info.cnv.cpu().numpy()} mb={mb_h} "
                  f"well={float(info.well_err):.2e} lin={n_lin}")
        if conv or failed:
            if conv:
                st = st._replace(active_mode=new_st.active_mode)
            return st, NewtonReport(
                conv, it, total_lin, failed and not conv,
                info.cnv.cpu().numpy(), mb_h, float(info.well_err), res,
                info.well_err_by_well.cpu().numpy()), last
        st = new_st
    return st, NewtonReport(False, params.max_iter, total_lin, False,
                            info.cnv.cpu().numpy(), mb_h,
                            float(info.well_err), res,
                            info.well_err_by_well.cpu().numpy()), last
