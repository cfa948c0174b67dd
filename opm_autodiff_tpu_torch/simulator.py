"""Top-level simulator driver: the report-step loop (main-path subset).

Port of opm_autodiff_tpu/simulator.py (reference:
SimulatorFullyImplicitBlackoilEbos.hpp:147 ``run``): parse deck -> build
geometry/fluid/wells -> equilibrate -> loop report steps with adaptive
sub-stepping -> summary vectors. The device holds the state, the
assembled system and the Krylov vectors; schedule handling, control
bookkeeping and output stay on the host.

Scope of this slice: three-phase black oil on a fully active cartesian
grid, 4-DOF StandardWells under BHP/rate control, the z-line or Jacobi
preconditioner, drift compensation, EQUIL (+ SWATINIT) or explicit
initialization, end-point scaling. Anything else raises
NotImplementedError naming its ROADMAP.md item — it is never silently
approximated.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from opm_autodiff_tpu_torch.device import resolve_device
from opm_autodiff_tpu_torch.grid import build_geometry
from opm_autodiff_tpu_torch.io.state import EclState
from opm_autodiff_tpu_torch.io.summary import SummaryWriter
from opm_autodiff_tpu_torch.models.blackoil import (accumulation,
                                                    statics_from_geometry)
from opm_autodiff_tpu_torch.models.init import apply_swatinit, equilibrate
from opm_autodiff_tpu_torch.ops.cellpack import require_support
from opm_autodiff_tpu_torch.props.eps import build_eps
from opm_autodiff_tpu_torch.props.fluid import FluidSystem
from opm_autodiff_tpu_torch.solvers.newton import (NewtonParams, NewtonState,
                                                   check_params, newton_solve)
from opm_autodiff_tpu_torch.solvers.timestepper import (TimeStepParams,
                                                        _PidState,
                                                        run_report_step)
from opm_autodiff_tpu_torch.utils.report import SimulatorReport
from opm_autodiff_tpu_torch.wells import build_wellset
from opm_autodiff_tpu_torch.wells import standard4 as s4


def _pressure_average(p, pv, sw):
    """HCPV-weighted mean pressure with a PV-weighted fallback."""
    hcpv = pv * (1.0 - sw)
    denom = hcpv.sum()
    if denom > 0.0:
        return float((p * hcpv).sum() / denom)
    return float((p * pv).sum() / max(pv.sum(), 1e-300))


def _unported(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md Queue 1 item {item}")


def check_deck_scope(state: EclState) -> None:
    """Raise NotImplementedError for deck features outside this slice."""
    rs = state.runspec
    if rs.phases != frozenset({"OIL", "WATER", "GAS"}):
        raise _unported("two-phase / single-phase decks", 14)
    if rs.extensions:
        raise _unported(f"extended black-oil components "
                        f"{sorted(rs.extensions)}", 14)
    if state.solution.restart is not None:
        raise _unported("RESTART initialization", 15)
    if getattr(state, "aquifers", None):
        raise _unported("aquifers", 13)
    if getattr(state, "tracers", None):
        raise _unported("tracers", 13)
    if state.udq_keywords or state.action_keywords:
        raise _unported("UDQ / ACTIONX", 13)
    if "EHYSTR" in getattr(state, "flags", ()) or \
            state.regions.get("IMBNUM") is not None:
        raise _unported("Killough hysteresis", 13)
    if state.vfp_prod_records or state.vfp_inj_records:
        raise _unported("VFP tables / THP control", 12)
    for step in state.schedule.steps:
        if step.tuning.get("drsdt") is not None or \
                step.tuning.get("drvdt") is not None:
            raise _unported("DRSDT / DRVDT", 13)
        if step.liftopt:
            raise _unported("gas lift", 12)
        for w in step.wells:
            if getattr(w, "segments", None):
                raise _unported("multisegment wells", 12)
            if w.control_mode in ("GRUP", "THP", "RESV") or \
                    w.resv_rate is not None or w.vfp_table is not None:
                raise _unported(f"{w.control_mode} well control", 12)
            if w.welpi_target or w.glift_on:
                raise _unported("WELPI / gas lift", 12)
            if any(getattr(w, f"econ_{k}") is not None for k in
                   ("min_oil", "min_gas", "max_wct", "max_gor",
                    "max_wgr")) or w.wtest_interval:
                raise _unported("WECON / WTEST", 12)


@dataclasses.dataclass
class SimulatorOptions:
    newton: NewtonParams = dataclasses.field(default_factory=NewtonParams)
    tstep: TimeStepParams = dataclasses.field(default_factory=TimeStepParams)
    verbose: int = 0  # 0 quiet, 1 report-step lines, 2 + newton lines


class Simulator:
    """Step-by-step controllable simulator on ``device`` (default
    ``"cuda"``; raises without a GPU unless ``device="cpu"``)."""

    def __init__(self, ecl_state: EclState,
                 options: SimulatorOptions | None = None, device=None):
        self.device = resolve_device(device)
        check_deck_scope(ecl_state)
        self.state = ecl_state
        self.opts = options or SimulatorOptions()
        check_params(self.opts.newton)
        self.geo = build_geometry(ecl_state)
        fs_host = FluidSystem.from_state(ecl_state)
        self.cells, self.topo = statics_from_geometry(self.geo, self.device)
        eps_host = build_eps(ecl_state, self.geo, fs_host)
        if "SWATINIT" in ecl_state.eps_arrays:
            ps, pc_eq = equilibrate(ecl_state, self.geo, fs_host,
                                    return_pc=True)
            ps, eps_host = apply_swatinit(ecl_state, self.geo, fs_host, ps,
                                          eps_host, pc_eq=pc_eq)
        else:
            ps = equilibrate(ecl_state, self.geo, fs_host)
        if eps_host is not None:
            self.cells = self.cells._replace(eps=torch.as_tensor(
                np.asarray(eps_host, np.float64), device=self.device))
        self.fs = fs_host.to(self.device)
        require_support(self.fs, self.cells)
        self.u = ps.u.to(self.device)
        self.flag = ps.flag.to(self.device)
        self.acc0 = self._compute_acc0(self.u, self.flag)
        self.report = SimulatorReport()
        self.summary = SummaryWriter(ecl_state)
        self._step_index = 0
        # Newton iterations executed, failed substep attempts included
        # (each is a full assemble + solve + update pipeline)
        self.newton_executed = 0
        self._suggested_dt = self.opts.tstep.initial_dt_days
        self._pid = _PidState()
        self._shut_wells: dict = {}
        self.pbh = None
        self.xw = None
        self.active_mode = None
        # drift compensation: the previous substep's leftover residual
        # re-enters as a source so relaxed tolerances don't accumulate
        # mass-balance drift (eclproblem.hh:1127/:1848)
        self._drift_vol = torch.zeros((self.geo.num_active, 3),
                                      dtype=torch.float64, device=self.device)
        self.cum = {"FOPT": 0.0, "FGPT": 0.0, "FWPT": 0.0, "FGIT": 0.0,
                    "FWIT": 0.0}

    # ------------------------------------------------------------------
    def _compute_acc0(self, u, flag):
        """Conserved surface volumes per cell (the reference's
        vmap(accumulation) sweep with the SATNUM/PVTNUM regions)."""
        return accumulation(self.fs, u, flag, self.cells.pore_vol_ref,
                            self.cells.regs)

    def step(self) -> list:
        """Run one report step; returns the substep reports."""
        sched = self.state.schedule
        if self._step_index >= len(sched.steps):
            raise IndexError("schedule exhausted")
        rstep = sched.steps[self._step_index]
        std_wells = list(rstep.wells)
        for w in std_wells:
            if w.name in self._shut_wells:
                w.status = "SHUT"
        self._std_well_names = [w.name for w in std_wells]
        ws = build_wellset(self.geo, std_wells, device=self.device)

        nwells = ws.num_wells
        if self.pbh is None or len(self.pbh) != nwells:
            self.pbh = self.u[ws.cell[:, 0], 0] + torch.where(
                ws.is_injector, 1e5, -1e5)
            self.active_mode = ws.ctrl_mode
            self.xw = None
        if self.xw is None or self.xw.shape[0] != nwells:
            last_q = getattr(self, "_last_q", None)
            q_prev = (torch.as_tensor(last_q, device=self.device)
                      if last_q is not None and len(last_q) == nwells
                      else None)
            self.xw = s4.init_xw(self.u, ws, pbh=self.pbh, q_rates=q_prev)

        t0 = time.perf_counter()
        committed = {"st": NewtonState(self.u, self.flag, self.pbh,
                                       self.active_mode, self.xw),
                     "acc0": self.acc0, "ws": ws}
        fail_history: list[set] = []

        def shut_problem_wells() -> bool:
            """Force-shut wells that failed the last 3 attempts
            (AdaptiveTimeSteppingEbos.hpp:549-586)."""
            if len(fail_history) < 3:
                return False
            names = set.intersection(*fail_history[-3:])
            idxs = [i for i, w in enumerate(std_wells)
                    if w.name in names and w.status == "OPEN"]
            if not idxs:
                return False
            for i in idxs:
                std_wells[i].status = "SHUT"
                self._shut_wells[std_wells[i].name] = rstep.start_days
            om = committed["ws"].open_mask.clone()
            om[idxs] = False
            committed["ws"] = committed["ws"]._replace(open_mask=om)
            fail_history.clear()
            return True

        def solve_fn(dt_seconds):
            st0 = committed["st"]
            ws_c = committed["ws"]
            st, rep, (q_tot, _q_perf) = newton_solve(
                self.opts.newton, self.fs, self.cells, self.topo, st0, ws_c,
                committed["acc0"], dt_seconds,
                verbose=int(self.opts.verbose) >= 2,
                drift_vol=self._drift_vol)
            self.newton_executed += rep.iterations + 1
            if rep.converged:
                fail_history.clear()
            elif rep.well_errors is not None:
                tol = self.opts.newton.tol_wells
                fail_history.append({
                    std_wells[i].name
                    for i in np.nonzero(rep.well_errors > tol)[0]
                    if i < len(std_wells)})

            def commit():
                p_old = committed["st"].u[:, 0]
                committed["st"] = st
                # drift = leftover residual x dt (eclproblem.hh:1127)
                self._drift_vol = rep.residual * dt_seconds
                committed["acc0"] = self._compute_acc0(st.u, st.flag)
                self._collect_summary(ws_c, q_tot, dt_seconds)
                p_new = st.u[:, 0]
                num = float(torch.linalg.norm(p_new - p_old))
                den = float(torch.linalg.norm(p_new))
                return num / max(den, 1e-300)

            return rep.converged, rep.iterations, rep.linear_iterations, commit

        step_days = rstep.end_days - rstep.start_days
        tstep_params = self.opts.tstep
        if rstep.tuning:
            fields = {f.name for f in dataclasses.fields(tstep_params)}
            overrides = {k: v for k, v in rstep.tuning.items()
                         if k in fields}
            if overrides:
                tstep_params = dataclasses.replace(tstep_params, **overrides)
            if "initial_dt_days" in rstep.tuning:
                self._suggested_dt = min(self._suggested_dt,
                                         rstep.tuning["initial_dt_days"])
        reports, self._suggested_dt = run_report_step(
            step_days, self._suggested_dt, solve_fn, tstep_params,
            pid_state=self._pid, shut_problem_wells=shut_problem_wells)

        st = committed["st"]
        self.u, self.flag = st.u, st.flag
        self.pbh, self.active_mode = st.pbh, st.active_mode
        self.xw = st.xw
        self.acc0 = committed["acc0"]
        self.report.add_step(
            wall_time=time.perf_counter() - t0,
            newton_iterations=sum(r.newton_iterations for r in reports),
            linear_iterations=sum(r.linear_iterations for r in reports),
            substeps=len(reports))
        self.summary.end_report_step(rstep.end_days,
                                     self._field_state(committed["ws"]))
        self._step_index += 1
        return reports

    def run(self, max_steps: int | None = None) -> SimulatorReport:
        """Run the schedule (or its first ``max_steps`` report steps)."""
        if self.state.runspec.nosim:
            return self.report
        nsteps = len(self.state.schedule.steps)
        if max_steps is not None:
            nsteps = min(nsteps, self._step_index + max_steps)
        while self._step_index < nsteps:
            reports = self.step()
            if self.opts.verbose:
                r = self.summary.rows[-1]
                print(f"step {self._step_index}/{nsteps} "
                      f"t={r['TIME']:.1f}d FOPR={r.get('FOPR', 0):.1f} "
                      f"FPR={r.get('FPR', 0):.1f} "
                      f"substeps={len(reports)}")
        return self.report

    # ------------------------------------------------------------------
    def _collect_summary(self, ws, q_tot, dt_seconds):
        """Accumulate cumulative volumes from converged substep rates
        (WEFAC efficiency factors scale the reported volumes)."""
        q = q_tot.cpu().numpy() * ws.efac.cpu().numpy()[:, None]
        prod = np.maximum(-q, 0.0).sum(axis=0)
        inj = np.maximum(q, 0.0).sum(axis=0)
        self.cum["FWPT"] += prod[0] * dt_seconds
        self.cum["FOPT"] += prod[1] * dt_seconds
        self.cum["FGPT"] += prod[2] * dt_seconds
        self.cum["FWIT"] += inj[0] * dt_seconds
        self.cum["FGIT"] += inj[2] * dt_seconds
        self._last_q = q

    def _fip(self):
        acc = self._compute_acc0(self.u, self.flag).cpu().numpy()
        return {"FWIP": float(acc[:, 0].sum()),
                "FOIP": float(acc[:, 1].sum()),
                "FGIP": float(acc[:, 2].sum())}

    def _field_state(self, ws):
        """Field + well quantities for the summary at report time."""
        u = self.u.cpu().numpy()
        pv = self.cells.pore_vol_ref.cpu().numpy()
        out = self._fip()
        out.update({"FPR": _pressure_average(u[:, 0], pv, u[:, 1]),
                    "FOPT": self.cum["FOPT"], "FGPT": self.cum["FGPT"],
                    "FWPT": self.cum["FWPT"], "FGIT": self.cum["FGIT"],
                    "FWIT": self.cum["FWIT"]})
        q = getattr(self, "_last_q", None)
        if q is None:
            return out
        prod_all = np.maximum(-q, 0.0)
        out["FWPR"] = prod_all[:, 0].sum()
        out["FOPR"] = prod_all[:, 1].sum()
        out["FGPR"] = prod_all[:, 2].sum()
        out["FGOR"] = out["FGPR"] / max(out["FOPR"], 1e-30)
        inj_all = np.maximum(q, 0.0)
        out["FWIR"] = inj_all[:, 0].sum()
        out["FGIR"] = inj_all[:, 2].sum()
        out["FWCT"] = out["FWPR"] / max(out["FWPR"] + out["FOPR"], 1e-30)
        pbh = self.pbh.cpu().numpy()
        cells_w = ws.cell.cpu().numpy()
        pmask_w = ws.perf_mask.cpu().numpy()
        nx_c, ny_c, _nz_c = self.geo.cartdims

        def _wbp(iw, ring):
            """Pore-volume-weighted pressure of the perf cells (ring 0) or
            their 3x3 areal neighbourhood (ring 1): WBP / WBP9."""
            ps, wts = [], []
            for c in cells_w[iw][pmask_w[iw]]:
                i, j, k = self.geo.ijk(int(c))
                for dj in range(-ring, ring + 1):
                    for di in range(-ring, ring + 1):
                        ii, jj = i + di, j + dj
                        if 0 <= ii < nx_c and 0 <= jj < ny_c:
                            a = self.geo.act_index(ii, jj, k)
                            if a >= 0:
                                ps.append(u[a, 0])
                                wts.append(pv[a])
            return float(np.average(ps, weights=wts)) if ps else 0.0

        for iw, name in enumerate(self._std_well_names):
            out[f"WBHP:{name}"] = float(pbh[iw])
            out[f"WBP:{name}"] = _wbp(iw, 0)
            out[f"WBP9:{name}"] = _wbp(iw, 1)
            out[f"WOPR:{name}"] = float(prod_all[iw, 1])
            out[f"WGPR:{name}"] = float(prod_all[iw, 2])
            out[f"WWPR:{name}"] = float(prod_all[iw, 0])
            out[f"WGIR:{name}"] = float(max(q[iw, 2], 0.0))
            out[f"WWIR:{name}"] = float(max(q[iw, 0], 0.0))
            liq = prod_all[iw, 0] + prod_all[iw, 1]
            out[f"WWCT:{name}"] = float(prod_all[iw, 0] / max(liq, 1e-30))
            out[f"WGOR:{name}"] = float(prod_all[iw, 2]
                                        / max(prod_all[iw, 1], 1e-30))
        return out

