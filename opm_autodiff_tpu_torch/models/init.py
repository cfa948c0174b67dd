"""Initial state: hydrostatic equilibration (EQUIL) or explicit arrays.

Port of opm_autodiff_tpu/models/init.py (reference: ebos/equil/
initstateequil.hh:288 ``PressureTable``, :816 ``PhaseSaturations``):
per-region ODE integration of phase pressure vs depth from the datum and
contacts, capillary inversion for saturations, RSVD/PBVD (RVVD/PDVD)
tables for the dissolved-gas (vaporized-oil) profile, SWATINIT. Host-side
numpy, run once at setup; the per-cell saturation and meaning-flag
assignment is vectorized over the cells of each SATNUM region (same
arithmetic as the reference's per-cell loop), so field-size grids
equilibrate in seconds. Returns a PrimaryState of CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from opm_autodiff_tpu_torch import units as U
from opm_autodiff_tpu_torch.grid.geometry import Geometry
from opm_autodiff_tpu_torch.io.state import EclState
from opm_autodiff_tpu_torch.models.blackoil import (FLAG_RS, FLAG_RV,
                                                    FLAG_SG, PrimaryState)
from opm_autodiff_tpu_torch.props.fluid import FluidSystem


def _state(u, flag) -> PrimaryState:
    return PrimaryState(u=torch.as_tensor(np.asarray(u, np.float64)),
                        flag=torch.as_tensor(np.asarray(flag, np.int32)))


def _interp_extrap_v(x, xp, fp):
    """Vectorized ``_HostProps._interp_extrap``: np.interp with linear
    extrapolation beyond both ends (same arithmetic, element-wise)."""
    x = np.asarray(x, float)
    y = np.interp(x, xp, fp)
    hi = fp[-1] + (fp[-1] - fp[-2]) / (xp[-1] - xp[-2]) * (x - xp[-1])
    lo = fp[0] + (fp[1] - fp[0]) / (xp[1] - xp[0]) * (x - xp[0])
    return np.where(x > xp[-1], hi, np.where(x < xp[0], lo, y))


def _integrate_pressure(depths, d0, p0, rho_fn, step: float = 0.5):
    """March dp/dd = rho(p, d) * g along a sorted depth grid from (d0, p0).

    RK2 (midpoint) with ~``step``-meter increments (reference uses RK4 over
    2000 nodes, initstateequil.hh:80 RK4IVP; midpoint at 0.5 m matches to
    well below equilibration tolerance).
    """
    g = U.GRAVITY
    depths = np.atleast_1d(np.asarray(depths, float))
    lo = min(depths.min(), d0)
    hi = max(depths.max(), d0)
    n_nodes = min(max(int((hi - lo) / step) + 2, 16), 20_000)
    span = np.linspace(lo, hi, n_nodes)

    def march(seq, p_start):
        """RK4 along a sequence of depth nodes starting at seq[0]
        (reference: RK4IVP, initstateequil.hh:80)."""
        ps = np.empty(len(seq))
        p = p_start
        ps[0] = p
        for i in range(1, len(seq)):
            d0 = seq[i - 1]
            dd = seq[i] - d0
            k1 = rho_fn(p, d0) * g
            k2 = rho_fn(p + 0.5 * dd * k1, d0 + 0.5 * dd) * g
            k3 = rho_fn(p + 0.5 * dd * k2, d0 + 0.5 * dd) * g
            k4 = rho_fn(p + dd * k3, d0 + dd) * g
            p = p + dd * (k1 + 2 * k2 + 2 * k3 + k4) / 6.0
            ps[i] = p
        return ps

    # split at the anchor depth and integrate both directions
    below = span[span >= d0]
    above = span[span < d0][::-1]
    p_tab = np.empty(n_nodes)
    if len(below):
        p_tab[span >= d0] = march(np.concatenate([[d0], below]), p0)[1:]
    if len(above):
        p_tab[span < d0] = march(np.concatenate([[d0], above]), p0)[1:][::-1]
    return np.interp(depths, span, p_tab)


def _invert_pc(pc_target, s_nodes, pc_nodes, increasing: bool):
    """Invert a monotone capillary table; returns saturation."""
    s = np.asarray(s_nodes, float)
    pc = np.asarray(pc_nodes, float)
    if np.allclose(pc, pc[0]):
        return None  # degenerate (zero-capillary) table: sharp contact
    if not increasing:
        s, pc = s[::-1], pc[::-1]
    return float(np.interp(pc_target, pc, s))


class _HostProps:
    """Numpy mirrors of the FluidSystem tables — the ODE integration runs
    thousands of pointwise evaluations on the host; per-op tensor dispatch
    would dominate, so evaluate with np.interp instead."""

    def __init__(self, fs: FluidSystem, reg: int = 0):
        # PVT banks are [R, ...] per PVTNUM region; the hydrostatic
        # integration uses one region's tables (the reference integrates
        # per EQLNUM region with that region's PVT — `reg` hooks in here)
        r = min(reg, fs.num_pvt_regions - 1)
        self.rho_surf = np.asarray(fs.rho_surf[r])
        o = fs.oil
        self.live = hasattr(o, "rs_tab")
        if self.live:
            self.o_p = np.asarray(o.p_sat[r])
            self.o_rs = np.asarray(o.rs_tab[r])
            self.o_invb = np.asarray(o.inv_b_sat[r])
            self.o_slope = np.asarray(o.slope_inv_b[r])
            self.o_up = np.asarray(o.usat_p[r])        # [nb, m]
            self.o_ub = np.asarray(o.usat_inv_b[r])    # [nb, m]
            # real (non-padded) branch count: Rs extrapolation must use
            # the last two REAL branches (cf. LiveOilPvt._usat)
            self.o_nb = (int(o.usat_nb[r]) if o.usat_nb is not None
                         else self.o_up.shape[0])
        else:
            self.o_p = np.asarray(o.p[r])
            self.o_invb = np.asarray(o.inv_b_tab[r])
        self.wet_gas = fs.wet_gas
        self.g_p = np.asarray(fs.gas.p[r])
        if self.wet_gas:
            # wet gas (PVTG): saturated curve + the full undersaturated
            # banks (exact 2-D eval, like WetGasPvt._usat); the per-line
            # slope stays as the fallback for hand-built tables
            self.g_invb = np.asarray(fs.gas.inv_b_sat[r])
            self.g_rv = np.asarray(fs.gas.rv_tab[r])
            self.g_slope = np.asarray(fs.gas.slope_inv_b[r])
            g = fs.gas
            if g.usat_rv is not None:
                self.g_usat_rv = np.asarray(g.usat_rv[r])      # [np, m]
                self.g_usat_invb = np.asarray(g.usat_inv_b[r])
                self.g_np = (int(g.usat_np[r]) if g.usat_np is not None
                             else self.g_usat_rv.shape[0])
            else:
                self.g_usat_rv = None
        else:
            self.g_invb = np.asarray(fs.gas.inv_b_tab[r])
            self.g_rv = np.zeros_like(self.g_p)
            self.g_slope = np.zeros_like(self.g_p)
        w = fs.water
        self.w_pref = float(w.p_ref[r])
        self.w_invb = float(w.inv_b_ref[r])
        self.w_comp = float(w.comp[r])

    @staticmethod
    def _interp_extrap(x, xp, fp):
        y = np.interp(x, xp, fp)
        # linear extrapolation beyond both ends
        if np.ndim(x) == 0:
            if x > xp[-1]:
                y = fp[-1] + (fp[-1] - fp[-2]) / (xp[-1] - xp[-2]) * (x - xp[-1])
            elif x < xp[0]:
                y = fp[0] + (fp[1] - fp[0]) / (xp[1] - xp[0]) * (x - xp[0])
        return y

    def rs_sat_v(self, p):
        if not self.live:
            return np.zeros_like(np.asarray(p, float))
        return np.maximum(_interp_extrap_v(p, self.o_p, self.o_rs), 0.0)

    def rv_sat_v(self, p):
        if not self.wet_gas:
            return np.zeros_like(np.asarray(p, float))
        return np.maximum(_interp_extrap_v(p, self.g_p, self.g_rv), 0.0)

    def rs_sat(self, p):
        if not self.live:
            return 0.0
        return max(self._interp_extrap(p, self.o_p, self.o_rs), 0.0)

    def oil_inv_b(self, p, rs):
        if not self.live:
            return self._interp_extrap(p, self.o_p, self.o_invb)
        # same 2-D-always semantics as props/pvt.LiveOilPvt.inv_b: the
        # branches at constant p blended in Rs, with rs clamped to RsSat
        # (keeps the equilibrated state an exact no-flow state of the
        # assembly's property evaluation)
        rs = min(rs, self.rs_sat(p))
        nb = self.o_nb
        bvals = np.array([self._interp_extrap(p, self.o_up[i], self.o_ub[i])
                          for i in range(nb)])
        return self._interp_extrap(rs, self.o_rs[:nb], bvals)

    def oil_density(self, p, rs):
        return (self.rho_surf[1] + rs * self.rho_surf[2]) * self.oil_inv_b(p, rs)

    def rv_sat(self, p):
        if not self.wet_gas:
            return 0.0
        return max(self._interp_extrap(p, self.g_p, self.g_rv), 0.0)

    def gas_density(self, p, rv=None):
        """Gas density at (p, rv); rv defaults to saturated. Below the
        saturated curve the 1/Bg uses the per-line dRv linearization
        (reference: PhasePressODE::Gas::density,
        initstateequil.hh:266-280 — undersaturated inv B at the rv the
        evaporation calculator returns)."""
        if rv is None:
            rv = self.rv_sat(p)
        b = self._interp_extrap(p, self.g_p, self.g_invb)
        if self.wet_gas and rv < self.rv_sat(p):
            if getattr(self, "g_usat_rv", None) is not None:
                # exact 2-D eval: every pressure line at this rv, then
                # blend in p (WetGasPvt._usat semantics)
                npl = self.g_np
                lvals = np.array([
                    self._interp_extrap(rv, self.g_usat_rv[i],
                                        self.g_usat_invb[i])
                    for i in range(npl)])
                b = self._interp_extrap(p, self.g_p[:npl], lvals)
            else:
                b = b + self._interp_extrap(p, self.g_p, self.g_slope) \
                    * (rv - self.rv_sat(p))
        return (self.rho_surf[2] + rv * self.rho_surf[1]) * b

    def water_density(self, p):
        x = self.w_comp * (p - self.w_pref)
        return self.rho_surf[0] * self.w_invb * (1 + x + 0.5 * x * x)


def equilibrate(state: EclState, geo: Geometry, fs: FluidSystem,
                return_pc: bool = False) -> PrimaryState:
    """Hydrostatic equilibration, one EQUIL record per EQLNUM region.

    ``return_pc=True`` also returns the per-cell equilibrium water
    capillary pressure po - pw from the hydrostatic curves."""
    fs = fs.to("cpu")
    sol = state.solution
    if sol.restart is not None:
        raise NotImplementedError(
            "RESTART initialization is not ported yet: ROADMAP.md Queue 1 "
            "item 15")
    eqs = sol.equil_regions or ([sol.equil] if sol.equil else [])
    if not eqs:
        ps = explicit_init(state, geo, fs)
        return (ps, None) if return_pc else ps

    eqlnum = state.regions.get("EQLNUM")
    if eqlnum is not None:
        reg_cells = np.maximum(
            np.asarray(eqlnum)[geo.act_to_glob] - 1, 0).astype(np.int32)
    else:
        reg_cells = np.zeros(geo.num_active, np.int32)
    reg_cells = np.minimum(reg_cells, len(eqs) - 1)
    pvtnum = (np.asarray(geo.pvtnum) if geo.pvtnum is not None
              else np.zeros(geo.num_active, np.int32))

    n = geo.num_active
    u_out = np.empty((n, 3))
    flag_out = np.empty(n, np.int32)
    pc_out = np.empty(n)
    for ireg, eq in enumerate(eqs):
        mask = reg_cells == ireg
        if not mask.any():
            continue

        def pick(lst):
            return (lst[ireg] if ireg < len(lst)
                    else (lst[-1] if lst else None))

        pvt_r = int(np.bincount(pvtnum[mask]).argmax())
        idx = np.nonzero(mask)[0]
        po, sw, x3, flag, pc_eq = _equilibrate_region(
            state, geo, fs, eq, pick(sol.rsvd_regions), pvt_r, idx,
            rvvd=pick(getattr(sol, "rvvd_regions", [])),
            pbvd=pick(getattr(sol, "pbvd_regions", [])),
            pdvd=pick(getattr(sol, "pdvd_regions", [])))
        u_out[idx, 0] = po
        u_out[idx, 1] = sw
        u_out[idx, 2] = x3
        flag_out[idx] = flag
        pc_out[idx] = pc_eq
    ps = _state(u_out, flag_out)
    return (ps, pc_out) if return_pc else ps


def _equilibrate_region(state, geo, fs, eq, rsvd, pvt_reg, idx,
                        rvvd=None, pbvd=None, pdvd=None):
    """Equilibrate the cells in ``idx`` against one EQUIL record.
    Returns (po, sw, x3, flag, pc_eq) arrays over idx."""
    depths = np.asarray(geo.depth)[idx]
    order = np.argsort(depths)
    d_sorted = depths[order]
    hp = _HostProps(fs, pvt_reg)

    rs_cap = rv_cap = None
    if (hp.live or hp.wet_gas) and not (rsvd is not None
                                        and rvvd is not None):
        if abs(eq.goc_depth - eq.datum_depth) < 1e-9:
            p_goc = eq.datum_pressure
        else:
            p_goc = _integrate_pressure(
                [eq.goc_depth], eq.datum_depth, eq.datum_pressure,
                lambda p, d: hp.oil_density(p, hp.rs_sat(p)))[0]
        if hp.live and rsvd is None and pbvd is None:
            rs_cap = hp.rs_sat(p_goc)
        if hp.wet_gas and rvvd is None and pdvd is None:
            rv_cap = hp.rv_sat(p_goc + eq.goc_pc)

    def rs_at(p, d):
        rs_sat = hp.rs_sat(p)
        if rsvd is not None:
            return min(rs_sat, float(np.interp(d, rsvd[:, 0], rsvd[:, 1])))
        if pbvd is not None:
            pb = float(np.interp(d, pbvd[:, 0], pbvd[:, 1]))
            return min(rs_sat, hp.rs_sat(pb))
        if rs_cap is not None:
            return min(rs_sat, rs_cap)
        return rs_sat

    def rs_at_v(p, d):
        rs_sat = hp.rs_sat_v(p)
        if rsvd is not None:
            return np.minimum(rs_sat, np.interp(d, rsvd[:, 0], rsvd[:, 1]))
        if pbvd is not None:
            pb = np.interp(d, pbvd[:, 0], pbvd[:, 1])
            return np.minimum(rs_sat, hp.rs_sat_v(pb))
        if rs_cap is not None:
            return np.minimum(rs_sat, rs_cap)
        return rs_sat

    def rv_at(pg_i, d):
        rv_sat = hp.rv_sat(pg_i)
        if rvvd is not None:
            return min(rv_sat, float(np.interp(d, rvvd[:, 0], rvvd[:, 1])))
        if pdvd is not None:
            pd = float(np.interp(d, pdvd[:, 0], pdvd[:, 1]))
            return min(rv_sat, hp.rv_sat(pd))
        if rv_cap is not None:
            return min(rv_sat, rv_cap)
        return rv_sat

    def rv_at_v(pg_v, d):
        rv_sat = hp.rv_sat_v(pg_v)
        if rvvd is not None:
            return np.minimum(rv_sat, np.interp(d, rvvd[:, 0], rvvd[:, 1]))
        if pdvd is not None:
            pd = np.interp(d, pdvd[:, 0], pdvd[:, 1])
            return np.minimum(rv_sat, hp.rv_sat_v(pd))
        if rv_cap is not None:
            return np.minimum(rv_sat, rv_cap)
        return rv_sat

    def rho_oil(p, d):
        return hp.oil_density(p, rs_at(p, d))

    def rho_wat(p, d):
        return hp.water_density(p)

    def rho_gas(p, d):
        return hp.gas_density(p, rv_at(p, d))

    po = _integrate_pressure(d_sorted, eq.datum_depth, eq.datum_pressure,
                             rho_oil)
    po_at_woc = _integrate_pressure([eq.woc_depth], eq.datum_depth,
                                    eq.datum_pressure, rho_oil)[0]
    pw = _integrate_pressure(d_sorted, eq.woc_depth, po_at_woc - eq.woc_pc,
                             rho_wat)
    po_at_goc = _integrate_pressure([eq.goc_depth], eq.datum_depth,
                                    eq.datum_pressure, rho_oil)[0]
    pg = _integrate_pressure(d_sorted, eq.goc_depth, po_at_goc + eq.goc_pc,
                             rho_gas)

    sat = fs.sat
    sw_bank = np.asarray(sat.sw)
    pcow_bank = np.asarray(sat.pcow_tab)
    sg_bank = np.asarray(sat.sg)
    pcog_bank = np.asarray(sat.pcog_tab)
    swco_bank = np.asarray(sat.swco)
    regs = (np.asarray(geo.satnum)[idx]
            if getattr(geo, "satnum", None) is not None
            else np.zeros(len(idx), np.int32))
    regs_sorted = regs[order]

    n = len(d_sorted)
    sw = np.empty(n)
    sg = np.empty(n)
    x3 = np.empty(n)
    flag = np.empty(n, np.int32)
    po_out = np.empty(n)

    for r in np.unique(regs_sorted):
        sel = np.nonzero(regs_sorted == r)[0]
        d = d_sorted[sel]
        real = np.isfinite(sw_bank[r])
        sw_nodes = sw_bank[r][real]
        pcow_nodes = pcow_bank[r][real]
        sg_real = np.isfinite(sg_bank[r])
        sg_nodes = sg_bank[r][sg_real]
        pcog_nodes = pcog_bank[r][sg_real]
        swco = float(swco_bank[r])
        sg_max = float(sg_nodes[-1])
        # water saturation from Pcow = po - pw (decreasing in sw)
        s = _invert_pc_v(po[sel] - pw[sel], sw_nodes, pcow_nodes,
                         increasing=False)
        if s is None:
            s = np.where(d >= eq.woc_depth, 1.0, swco)
        sw_i = np.minimum(np.maximum(s, swco), 1.0)
        # gas saturation from Pcog = pg - po (increasing in sg)
        s = _invert_pc_v(pg[sel] - po[sel], sg_nodes, pcog_nodes,
                         increasing=True)
        if s is None:
            s = np.where(d <= eq.goc_depth, 1.0 - swco, 0.0)
        sg_raw = np.minimum(np.maximum(s, 0.0), sg_max)
        po_i = po[sel].copy()
        # overlapping transition zones (fixUnphysicalTransition,
        # initstateequil.hh:1217): per cell, on the few cells affected
        if len(sg_nodes) > 1 and len(sw_nodes) > 1:
            for m in np.nonzero(sw_i + sg_raw > 1.0)[0]:
                i = sel[m]
                s_u = np.union1d(sw_nodes, 1.0 - sg_nodes)
                s_u = s_u[(s_u >= sw_nodes[0]) & (s_u <= sw_nodes[-1])]
                pcgw = (np.interp(s_u, sw_nodes, pcow_nodes)
                        + np.interp(1.0 - s_u, sg_nodes, pcog_nodes))
                s2 = _invert_pc(pg[i] - pw[i], s_u, pcgw, increasing=False)
                if s2 is not None:
                    sw_i[m] = min(max(s2, swco), 1.0)
                    sg_raw[m] = 1.0 - sw_i[m]
                    po_i[m] = pg[i] - float(np.interp(sg_raw[m], sg_nodes,
                                                      pcog_nodes))
        sg_i = np.minimum(sg_raw, 1.0 - sw_i)
        sg_i = np.where(sw_i >= 1.0 - 1e-12, 0.0, sg_i)
        # saturation-corrected oil pressure (accountForScaledSaturations)
        swu = float(sw_nodes[-1])
        at_swu = sw_i + 1e-6 > swu
        at_sgu = (~at_swu) & (len(sg_nodes) > 1) & (sg_i + 1e-6 > sg_max)
        po_i = np.where(at_swu, pw[sel] + float(pcow_nodes[-1]), po_i)
        po_i = np.where(at_sgu, pg[sel] - float(pcog_nodes[-1]), po_i)
        so_i = 1.0 - sw_i - sg_i
        is_rv = (sg_i > 0.0) & (so_i <= 1e-9) & hp.wet_gas
        is_sg = ~is_rv & ((sg_i > 0.0) | (so_i <= 1e-9))
        is_rs = ~is_rv & ~is_sg
        x3_r = sg_i.copy()
        if is_rv.any():
            x3_r[is_rv] = rv_at_v(pg[sel][is_rv], d[is_rv])
        if is_rs.any():
            x3_r[is_rs] = rs_at_v(po_i[is_rs], d[is_rs])
        sw[sel] = sw_i
        sg[sel] = sg_i
        po_out[sel] = po_i
        x3[sel] = x3_r
        flag[sel] = np.where(is_rv, FLAG_RV,
                             np.where(is_sg, FLAG_SG, FLAG_RS))

    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    pc_eq = (po - pw)[inv]
    return po_out[inv], sw[inv], x3[inv], flag[inv], pc_eq


def _invert_pc_v(pc_target, s_nodes, pc_nodes, increasing: bool):
    """Vectorized ``_invert_pc`` (None for a zero-capillary table)."""
    s = np.asarray(s_nodes, float)
    pc = np.asarray(pc_nodes, float)
    if np.allclose(pc, pc[0]):
        return None
    if not increasing:
        s, pc = s[::-1], pc[::-1]
    return np.interp(pc_target, pc, s)


def apply_swatinit(state: EclState, geo: Geometry, fs: FluidSystem,
                   ps: PrimaryState, eps, pc_eq=None):
    """SWATINIT: override the equilibrated water saturation and scale the
    cell's water capillary curve (EPS channel 10) so the scaled Pc
    reproduces the equilibrium Pc at the requested saturation
    (reference: equil/initstateequil SWATINIT handling via PCW scaling;
    frozen truth in test_equil.cc:1007 DeckWithSwatinit).

    ``pc_eq`` [N] is the true equilibrium po - pw from the hydrostatic
    curves (``equilibrate(..., return_pc=True)``). Where it is <= 0 —
    at/below the water contact — SWATINIT is IGNORED and the cell keeps
    its equilibrium saturation ("sw forced to swu since
    P_oil - P_wat < 0", test_equil.cc:1031). Without it the unscaled
    Pc(sw_equil) is used as a proxy numerator and no cells are skipped
    (explicit-init decks have no hydrostatic curves).

    Returns (new PrimaryState, new eps [N,12]).
    """
    arr = state.eps_arrays.get("SWATINIT")
    if arr is None:
        return ps, eps
    swinit = np.asarray(arr, float)[geo.act_to_glob]
    n = len(swinit)
    if eps is None:
        eps = np.full((n, 12), np.nan)
    else:
        eps = np.asarray(eps).copy()

    sat = fs.sat
    sw_bank = np.asarray(sat.sw)
    pcow_bank = np.asarray(sat.pcow_tab)
    satnum = (np.asarray(geo.satnum) if geo.satnum is not None
              else np.zeros(n, np.int32))
    u = np.asarray(ps.u).copy()
    for i in range(n):
        r = int(satnum[i])
        real = np.isfinite(sw_bank[r])
        nodes = sw_bank[r][real]
        pc = pcow_bank[r][real]
        if pc_eq is not None:
            pe = float(pc_eq[i])
            if pe <= 0.0:
                continue  # water zone: SWATINIT ignored (reference)
        else:
            # proxy: Pc(sw_equil) on the unscaled curve
            pe = float(np.interp(
                u[i, 1], nodes[::-1] if nodes[0] > nodes[-1] else nodes,
                pc[::-1] if nodes[0] > nodes[-1] else pc))
        pc_at_init = float(np.interp(swinit[i], nodes, pc))
        sw_new = float(np.clip(swinit[i], nodes[0], nodes[-1]))
        u[i, 1] = sw_new
        if abs(pc_at_init) > 1e-30 and pe > 0:
            eps[i, 10] = pe / pc_at_init
    return PrimaryState(u=torch.as_tensor(u), flag=ps.flag), eps


def explicit_init(state: EclState, geo: Geometry,
                  fs: FluidSystem | None = None) -> PrimaryState:
    sol = state.solution
    if sol.pressure is None or sol.swat is None:
        raise ValueError("need EQUIL or explicit PRESSURE/SWAT[/SGAS/RS]")
    act = geo.act_to_glob
    po = np.asarray(sol.pressure)[act]
    sw = np.asarray(sol.swat)[act]
    sg = (np.asarray(sol.sgas)[act] if sol.sgas is not None
          else np.zeros_like(po))
    rs = (np.asarray(sol.rs)[act] if sol.rs is not None
          else np.zeros_like(po))
    if "OIL" not in state.runspec.phases:
        # gas-water run (flow_gaswater analog): every cell lives in the
        # RV state — sg = 1 - sw structurally, x3 = Rv (0 for dry gas),
        # the oil equation pinned by NewtonParams.has_oil
        rv = (np.asarray(sol.rv)[act] if sol.rv is not None
              else np.zeros_like(po))
        u = np.stack([po, sw, rv], axis=1)
        flag = np.full(po.shape, FLAG_RV, np.int32)
        return _state(u, flag)
    water_only = (1.0 - sw - sg <= 1e-9) & ~(sg > 0.0)
    flag = np.where((sg > 0.0) | water_only, FLAG_SG, FLAG_RS).astype(np.int32)
    x3 = np.where((sg > 0.0) | water_only, sg, rs)
    # VAPOIL: cells with gas and no oil live in the Rv state
    if fs is not None and getattr(fs, "wet_gas", False):
        so = 1.0 - sw - sg
        no_oil = (sg > 0.0) & (so <= 1e-9)
        if sol.rv is not None:
            rv = np.asarray(sol.rv)[act]
        else:
            rv = fs.rv_sat(torch.as_tensor(po)).numpy()
        flag = np.where(no_oil, FLAG_RV, flag).astype(np.int32)
        x3 = np.where(no_oil, rv, x3)
    u = np.stack([po, sw, x3], axis=1)
    return _state(u, flag)
