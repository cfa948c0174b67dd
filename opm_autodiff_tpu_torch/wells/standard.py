"""Well set, control modes and connection densities.

Port of the part of opm_autodiff_tpu/wells/standard.py that the 4-DOF
StandardWell (wells/standard4.py) needs: the padded ``WellSet``, the
control-mode constants, ``build_wellset`` (host numpy) and the explicit
connection densities. Sign convention: q > 0 is surface volume flowing
INTO the cell (injection); the cell residual is R_c = acc + div - q.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from opm_autodiff_tpu_torch import units as U
from opm_autodiff_tpu_torch.grid.geometry import Geometry, peaceman_well_index

# control modes (per well, int)
(CTRL_BHP, CTRL_ORAT, CTRL_WRAT, CTRL_GRAT, CTRL_LRAT, CTRL_RATE,
 CTRL_THP, CTRL_RESV) = range(8)
# STOP: no surface flow (WQTotal pinned to 0) but a live wellbore
CTRL_STOP = 8

_PHASE_IDX = {"WATER": 0, "WAT": 0, "OIL": 1, "GAS": 2}
_MODE_IDX = {"BHP": CTRL_BHP, "ORAT": CTRL_ORAT, "WRAT": CTRL_WRAT,
             "GRAT": CTRL_GRAT, "LRAT": CTRL_LRAT, "RATE": CTRL_RATE,
             "RESV": CTRL_RESV, "THP": CTRL_THP}


class WellSet(NamedTuple):
    """Padded static + control data for all wells."""

    cell: torch.Tensor        # [W,P] int64 perf cell (0 where padded)
    wi: torch.Tensor          # [W,P] connection trans factor (0 padded)
    perf_depth: torch.Tensor  # [W,P]
    perf_mask: torch.Tensor   # [W,P] bool
    ref_depth: torch.Tensor   # [W]
    is_injector: torch.Tensor  # [W] bool
    inj_phase: torch.Tensor   # [W] int64 (phase index)
    ctrl_mode: torch.Tensor   # [W] int64
    orat: torch.Tensor        # [W] targets (SI rates; inf where absent)
    wrat: torch.Tensor
    grat: torch.Tensor
    lrat: torch.Tensor
    inj_rate: torch.Tensor
    bhp_target: torch.Tensor
    bhp_limit: torch.Tensor
    open_mask: torch.Tensor   # [W] bool
    thp_target: torch.Tensor
    vfp_idx: torch.Tensor     # [W] (-1 = none)
    resv_rate: torch.Tensor
    voidage_coeff: torch.Tensor  # [W,3]
    alq: torch.Tensor
    efac: torch.Tensor        # [W] WEFAC efficiency factor

    @property
    def num_wells(self) -> int:
        return self.cell.shape[0]

    def to(self, device) -> "WellSet":
        return WellSet(*[a.to(device) for a in self])


def _t(a):
    a = np.asarray(a)
    if a.dtype.kind == "f":
        return torch.as_tensor(a.astype(np.float64))
    if a.dtype.kind in "iu":
        return torch.as_tensor(a.astype(np.int64))
    return torch.as_tensor(a)


def build_wellset(geo: Geometry, wells: list, max_perfs: int | None = None,
                  vfp_numbering: dict | None = None,
                  vfp_inj_numbering: dict | None = None,
                  device=None) -> WellSet:
    """Host-side construction from schedule WellConfig list (padded),
    moved to ``device`` (default CPU)."""
    nw = max(len(wells), 1)
    np_max = max_perfs or max((len(w.completions) for w in wells), default=1)
    np_max = max(np_max, 1)

    cell = np.zeros((nw, np_max), np.int32)
    wi = np.zeros((nw, np_max))
    pdepth = np.zeros((nw, np_max))
    pmask = np.zeros((nw, np_max), bool)
    ref_depth = np.zeros(nw)
    is_inj = np.zeros(nw, bool)
    inj_phase = np.zeros(nw, np.int32)
    mode = np.zeros(nw, np.int32)
    inf = np.inf
    orat = np.full(nw, inf)
    wrat = np.full(nw, inf)
    grat = np.full(nw, inf)
    lrat = np.full(nw, inf)
    inj_rate = np.full(nw, inf)
    bhp_t = np.zeros(nw)
    bhp_l = np.zeros(nw)
    open_m = np.zeros(nw, bool)
    thp_t = np.zeros(nw)
    vfp_i = np.full(nw, -1, np.int32)
    resv = np.full(nw, inf)
    # lagged voidage coefficients; the simulator refreshes these per
    # substep from FIPNUM-region average PVT (wells/rate_converter.py)
    voidage = np.ones((nw, 3))
    alq = np.zeros(nw)
    efac = np.ones(nw)

    for iw, w in enumerate(wells):
        comps = [c for c in w.completions if c.open]
        for ip, c in enumerate(comps[:np_max]):
            ci = geo.act_index(c.i, c.j, c.k)
            if ci < 0:
                continue
            cell[iw, ip] = ci
            wi[iw, ip] = (c.cf if c.cf is not None
                          else peaceman_well_index(
                              geo, ci, c.diameter, c.skin, c.direction,
                              c.kh)) * getattr(c, "pi_mult", 1.0)
            pdepth[iw, ip] = geo.depth[ci]
            pmask[iw, ip] = True
        efac[iw] = getattr(w, "efac", 1.0)
        ref_depth[iw] = (w.ref_depth if w.ref_depth is not None
                         else (pdepth[iw, pmask[iw]].min()
                               if pmask[iw].any() else 0.0))
        is_inj[iw] = w.is_injector
        stopped = (w.status == "STOP") and pmask[iw].any()
        open_m[iw] = (w.status == "OPEN" and pmask[iw].any()) or stopped
        if w.is_injector:
            inj_phase[iw] = _PHASE_IDX.get(w.inj_phase or "GAS", 2)
            # unknown modes (e.g. GRUP before the group manager assigns a
            # share) fall back to BHP, never to RATE with an inf target
            mode[iw] = _MODE_IDX.get(w.control_mode, CTRL_BHP)
            if w.inj_rate is not None:
                inj_rate[iw] = w.inj_rate
            bhp_l[iw] = w.bhp_limit if w.bhp_limit is not None else 6.9e8
        else:
            mode[iw] = _MODE_IDX.get(w.control_mode, CTRL_BHP)
            if w.oil_rate is not None:
                orat[iw] = w.oil_rate
            if w.water_rate is not None:
                wrat[iw] = w.water_rate
            if w.gas_rate is not None:
                grat[iw] = w.gas_rate
            if w.liquid_rate is not None:
                lrat[iw] = w.liquid_rate
            bhp_l[iw] = w.bhp_limit if w.bhp_limit is not None else U.ATM
        bhp_t[iw] = bhp_l[iw]
        if stopped:
            mode[iw] = CTRL_STOP
        if getattr(w, "resv_rate", None) is not None:
            resv[iw] = w.resv_rate
        if getattr(w, "thp_limit", None):
            thp_t[iw] = w.thp_limit
        if getattr(w, "vfp_table", None) is not None:
            numbering = (vfp_inj_numbering if w.is_injector
                         else vfp_numbering) or {}
            vfp_i[iw] = numbering.get(w.vfp_table, -1)

    ws = WellSet(
        cell=_t(cell), wi=_t(wi),
        perf_depth=_t(pdepth), perf_mask=_t(pmask),
        ref_depth=_t(ref_depth), is_injector=_t(is_inj),
        inj_phase=_t(inj_phase), ctrl_mode=_t(mode),
        orat=_t(orat), wrat=_t(wrat),
        grat=_t(grat), lrat=_t(lrat),
        inj_rate=_t(inj_rate), bhp_target=_t(bhp_t),
        bhp_limit=_t(bhp_l), open_mask=_t(open_m),
        thp_target=_t(thp_t), vfp_idx=_t(vfp_i),
        resv_rate=_t(resv), voidage_coeff=_t(voidage),
        alq=_t(alq), efac=_t(efac),
    )
    return ws if device is None else ws.to(device)


def perf_channels(fs, u, flag, regs, cell, mob_mult=None, eps=None):
    """K1 packed channels (q [W,P,17], dq [W,P,17,3]) of the perforated
    cells: the cells are gathered into one flat [1,1,W*P] plane and run
    through the cellpack kernel (its plain version on CPU tensors)."""
    from opm_autodiff_tpu_torch.models.blackoil import CellStatic
    from opm_autodiff_tpu_torch.ops.cellpack import cellpack

    w, p = cell.shape
    flat = cell.reshape(-1)
    m = flat.shape[0]
    if mob_mult is None:
        mob = torch.tensor([1.0, 1.0, 1.0, float("inf"), float("inf")],
                           dtype=u.dtype, device=u.device).expand(m, 5)
    else:
        mob = mob_mult[flat]
    sub = CellStatic(pore_vol_ref=torch.ones(m, dtype=u.dtype,
                                             device=u.device),
                     depth=torch.zeros(m, dtype=u.dtype, device=u.device),
                     regs=regs[flat], mob_mult=mob.contiguous(),
                     eps=None if eps is None else eps[flat])
    q, dq = cellpack(fs, sub, u[flat], flag[flat], (1, 1, m))
    ch = q.reshape(17, m).T.reshape(w, p, 17)
    dch = dq.reshape(17, 3, m).permute(2, 0, 1).reshape(w, p, 17, 3)
    return ch, dch


def connection_densities(fs, u, flag, ws: WellSet, regs):
    """Explicit (lagged) connection mixture densities [W,P]: producers
    the mobility-weighted cell fluid density, injectors the injected
    phase's density (reference: calculateExplicitQuantities,
    BlackoilWellModel_impl.hpp:824). No multipliers or end-point scaling
    enter, as in the reference."""
    ch, _ = perf_channels(fs, u.detach(), flag, regs, ws.cell)
    mob = ch[..., 6:9].to(u.dtype)
    rho = ch[..., 9:12].to(u.dtype)
    mob_sum = mob[..., 0] + mob[..., 1] + mob[..., 2]
    w = mob / torch.clamp(mob_sum, min=1e-30)[..., None]
    rho_mix = (w * rho).sum(-1)
    phase = ws.inj_phase[:, None, None].expand(ws.cell.shape + (1,))
    rho_inj = torch.take_along_dim(rho, phase, -1)[..., 0]
    return torch.where(ws.is_injector[:, None], rho_inj, rho_mix)
