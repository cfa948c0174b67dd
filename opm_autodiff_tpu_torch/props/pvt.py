"""Black-oil PVT: water / dry gas / dead oil / live oil / wet gas.

Port of opm_autodiff_tpu/props/pvt.py. Each phase PVT is a NamedTuple of
float64 tensors ([R, ...] banks, one row per PVTNUM region) plus pure
functions of pressure (and Rs / Rv) written with broadcasting, so the same
code evaluates one cell (under ``torch.func.vmap``/``jacfwd``) or a batch
with a per-cell region index. All SI.

Conventions (matching the reference):
  * b = 1/B, the *inverse* formation volume factor — tables store and
    interpolate b, not B.
  * Viscosity interpolates the 1/(B mu) bank and divides (the reference's
    inverseOilBMuTable_ convention), floored so far-off-table
    extrapolation gives a huge positive viscosity.
  * Live oil / wet gas evaluate the full 2-D undersaturated table with
    Rs (Rv) clamped to its saturated value, so properties are continuous
    through the primary-variable switch. Beyond-table Rs (p) extrapolates
    from the last two REAL deck branches (lines), not the padding.

The bank construction is host-side numpy, identical to the reference
package's; ``_t`` turns each bank into a float64 tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from opm_autodiff_tpu_torch.io.state import PropsSection
from opm_autodiff_tpu_torch.props.tables import (interp1d, rows, segment,
                                                 take, vmax)


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def row(bank, reg):
    """Region row of a [R, ...] bank; the single-region bank ignores
    ``reg`` (a per-cell index tensor or an int)."""
    if bank.shape[0] == 1:
        return bank[0]
    if torch.is_tensor(reg):
        return rows(bank, reg)
    return bank[reg]


def _mu_from_inv_b_mu(invb, ibmu):
    """Viscosity from the 1/B and 1/(B mu) interpolants."""
    return invb / vmax(ibmu, 1e-12)


def _blend(x, nodes, v0, v1, idx):
    """Linear blend between the bracketing lines ``idx``/``idx+1`` of a
    2-D table (values ``v0``/``v1`` already evaluated on those lines)."""
    x0 = take(nodes, idx)
    x1 = take(nodes, idx + 1)
    return v0 + (v1 - v0) / (x1 - x0) * (x - x0)


def _line(bank, idx):
    """Rows ``idx`` ([...]) of a per-region 2-D bank ([nb, m] or
    [..., nb, m]) -> [..., m]."""
    if bank.dim() == 2:
        return rows(bank, idx)
    return torch.take_along_dim(bank, idx[..., None, None], -2)[..., 0, :]


def _real_count(counts, reg):
    """Per-region REAL line count (an int, or a per-cell tensor)."""
    if len(counts) == 1 or not torch.is_tensor(reg):
        return counts[0] if len(counts) == 1 else counts[reg]
    return rows(torch.as_tensor(counts, device=reg.device), reg)


def _pad_bank_linear(cols: list[list[np.ndarray]]) -> list[np.ndarray]:
    """Pad per-region 1D node/value arrays to a common length.

    ``cols[r]`` is the list of column arrays for region r (column 0 is the
    strictly-increasing node axis). Padding continues the last segment's
    slope in every column, so interpolation AND linear extrapolation are
    unchanged by the padding.
    """
    nreg = len(cols)
    ncol = len(cols[0])
    m = max(len(c[0]) for c in cols)
    out = [np.empty((nreg, m)) for _ in range(ncol)]
    for r, c in enumerate(cols):
        n = len(c[0])
        x = np.asarray(c[0], float)
        dx = (x[-1] - x[-2]) if n > 1 else max(abs(x[-1]), 1.0)
        ext = dx * np.arange(1, m - n + 1)
        for j in range(ncol):
            y = np.asarray(c[j], float)
            out[j][r, :n] = y
            if n < m:
                slope = (y[-1] - y[-2]) / dx if n > 1 else 0.0
                out[j][r, n:] = y[-1] + slope * ext
    return out


def _pad_rows(x, *ys, m=None):
    """Pad a branch's (x, y...) rows to length m by continuing the last
    segment's slope (same semantics as _pad_bank_linear, row-wise)."""
    if m is None:
        raise TypeError("m required")
    n = len(x)
    x = np.asarray(x, float)
    out_x = np.empty(m)
    out_x[:n] = x
    dx = (x[-1] - x[-2]) if n > 1 else max(abs(x[-1]), 1.0)
    ext = dx * np.arange(1, m - n + 1)
    if n < m:
        out_x[n:] = x[-1] + ext
    outs = [out_x]
    for y in ys:
        y = np.asarray(y, float)
        oy = np.empty(m)
        oy[:n] = y
        if n < m:
            slope = (y[-1] - y[-2]) / dx if n > 1 else 0.0
            oy[n:] = y[-1] + slope * ext
        outs.append(oy)
    return outs


class WaterPvt(NamedTuple):
    """PVTW per region: fields are [R] tensors."""

    p_ref: torch.Tensor
    inv_b_ref: torch.Tensor
    comp: torch.Tensor
    mu_ref: torch.Tensor
    viscosibility: torch.Tensor

    def inv_b(self, p, reg=0):
        x = row(self.comp, reg) * (p - row(self.p_ref, reg))
        return row(self.inv_b_ref, reg) * (1.0 + x + 0.5 * x * x)

    def viscosity(self, p, reg=0):
        y = -row(self.viscosibility, reg) * (p - row(self.p_ref, reg))
        return row(self.mu_ref, reg) / (1.0 + y + 0.5 * y * y)


class DryGasPvt(NamedTuple):
    """PVDG, banked per PVTNUM region: [R, n] tensors."""

    p: torch.Tensor
    inv_b_tab: torch.Tensor
    mu_tab: torch.Tensor
    inv_b_mu_tab: torch.Tensor | None = None

    def inv_b(self, pres, reg=0):
        return interp1d(pres, row(self.p, reg), row(self.inv_b_tab, reg))

    def viscosity(self, pres, reg=0):
        if self.inv_b_mu_tab is None:
            return interp1d(pres, row(self.p, reg), row(self.mu_tab, reg),
                            extrapolate=False)
        return _mu_from_inv_b_mu(
            self.inv_b(pres, reg),
            interp1d(pres, row(self.p, reg), row(self.inv_b_mu_tab, reg)))

    @staticmethod
    def from_tables(tables: list) -> "DryGasPvt":
        cols = [[t[:, 0], 1.0 / t[:, 1], t[:, 2],
                 1.0 / (t[:, 1] * t[:, 2])] for t in tables]
        p, invb, mu, ibmu = _pad_bank_linear(cols)
        return DryGasPvt(p=_t(p), inv_b_tab=_t(invb), mu_tab=_t(mu),
                         inv_b_mu_tab=_t(ibmu))


class DeadOilPvt(NamedTuple):
    """PVDO, banked per PVTNUM region: [R, n] tensors (1/(B mu)
    convention like DryGasPvt)."""

    p: torch.Tensor
    inv_b_tab: torch.Tensor
    mu_tab: torch.Tensor
    inv_b_mu_tab: torch.Tensor | None = None

    def inv_b(self, pres, reg=0):
        return interp1d(pres, row(self.p, reg), row(self.inv_b_tab, reg))

    def viscosity(self, pres, reg=0):
        if self.inv_b_mu_tab is None:
            return interp1d(pres, row(self.p, reg), row(self.mu_tab, reg),
                            extrapolate=False)
        return _mu_from_inv_b_mu(
            self.inv_b(pres, reg),
            interp1d(pres, row(self.p, reg), row(self.inv_b_mu_tab, reg)))

    @staticmethod
    def from_tables(tables: list) -> "DeadOilPvt":
        cols = [[t[:, 0], 1.0 / t[:, 1], t[:, 2],
                 1.0 / (t[:, 1] * t[:, 2])] for t in tables]
        p, invb, mu, ibmu = _pad_bank_linear(cols)
        return DeadOilPvt(p=_t(p), inv_b_tab=_t(invb), mu_tab=_t(mu),
                          inv_b_mu_tab=_t(ibmu))


class LiveOilPvt(NamedTuple):
    """PVTO live oil, banked per PVTNUM region: the saturated curve at
    the deck's branch heads ([R, nb]) and the full 2-D undersaturated
    table ([R, nb, m] per-branch pressure rows, padded by continuing the
    last segment's slope). ``usat_nb`` holds the REAL branch count per
    region (a tuple of ints)."""

    p_sat: torch.Tensor
    rs_tab: torch.Tensor
    inv_b_sat: torch.Tensor
    mu_sat: torch.Tensor
    slope_inv_b: torch.Tensor
    slope_mu: torch.Tensor
    usat_p: torch.Tensor
    usat_inv_b: torch.Tensor
    usat_mu: torch.Tensor
    inv_b_mu_sat: torch.Tensor | None = None
    usat_inv_b_mu: torch.Tensor | None = None
    usat_nb: tuple | None = None

    def rs_sat(self, p, reg=0):
        """Saturated (maximum) dissolved GOR at pressure p."""
        return vmax(interp1d(p, row(self.p_sat, reg), row(self.rs_tab, reg)),
                    0.0)

    def _usat(self, p, rs, reg, vals_bank):
        """2-D undersaturated eval: the two branches bracketing ``rs``
        interpolated at pressure p (linear extrapolation beyond their
        rows), blended linearly in Rs (linear extrapolation beyond the
        real branch range)."""
        nodes = row(self.usat_p, reg)      # [nb, m] or [..., nb, m]
        vals = row(vals_bank, reg)
        rsn = row(self.rs_tab, reg)
        hi = (None if self.usat_nb is None
              else _real_count(self.usat_nb, reg) - 2)
        idx = segment(rs, rsn, 0, hi)
        v0 = interp1d(p, _line(nodes, idx), _line(vals, idx))
        v1 = interp1d(p, _line(nodes, idx + 1), _line(vals, idx + 1))
        return _blend(rs, rsn, v0, v1, idx)

    def inv_b(self, p, rs, reg=0):
        rs_eff = torch.minimum(rs, self.rs_sat(p, reg))
        return self._usat(p, rs_eff, reg, self.usat_inv_b)

    def viscosity(self, p, rs, reg=0):
        rs_eff = torch.minimum(rs, self.rs_sat(p, reg))
        if self.inv_b_mu_sat is None:
            return self._usat(p, rs_eff, reg, self.usat_mu)
        invb = self._usat(p, rs_eff, reg, self.usat_inv_b)
        ibmu = self._usat(p, rs_eff, reg, self.usat_inv_b_mu)
        return _mu_from_inv_b_mu(invb, ibmu)

    @staticmethod
    def from_tables(pvtos: list) -> "LiveOilPvt":
        cols = []
        usats = []
        m_max = max(max(len(b[0]) for b in pvto.branches)
                    for pvto in pvtos)
        nb_max = max(len(pvto.rs) for pvto in pvtos)
        for pvto in pvtos:
            nb = len(pvto.rs)
            p_sat = np.empty(nb)
            inv_b_sat = np.empty(nb)
            mu_sat = np.empty(nb)
            ibmu_sat = np.empty(nb)
            slope_b = np.full(nb, np.nan)
            slope_m = np.full(nb, np.nan)
            up = np.empty((nb, m_max))
            ub = np.empty((nb, m_max))
            um = np.empty((nb, m_max))
            ubm = np.empty((nb, m_max))
            need_fill = []
            for i, (p, bo, mu) in enumerate(pvto.branches):
                p_sat[i] = p[0]
                inv_b_sat[i] = 1.0 / bo[0]
                mu_sat[i] = mu[0]
                ibmu_sat[i] = 1.0 / (bo[0] * mu[0])
                if len(p) > 1:
                    # least-squares linear slope through the branch points
                    dp = p - p[0]
                    db = 1.0 / bo - 1.0 / bo[0]
                    dm = mu - mu[0]
                    denom = np.sum(dp * dp)
                    slope_b[i] = np.sum(dp * db) / denom
                    slope_m[i] = np.sum(dp * dm) / denom
                    up[i], ub[i], um[i], ubm[i] = _pad_rows(
                        p, 1.0 / bo, mu, 1.0 / (bo * mu), m=m_max)
                else:
                    need_fill.append(i)
            # enforce strictly increasing saturated-pressure nodes: the
            # bank's node axis is p_sat, and decks MAY repeat a bubble
            # pressure across Rs branches (reference fixture
            # SUMMARY_DECK_NON_CONSTANT_POROSITY.DATA: heads at
            # pb=1 bar for both Rs=0 and Rs=1) — a zero-width segment
            # NaNs every interpolation evaluated exactly AT the node
            for i in range(1, nb):
                if p_sat[i] <= p_sat[i - 1]:
                    p_sat[i] = p_sat[i - 1] + max(
                        1e-9 * max(abs(p_sat[i - 1]), 1.0), 1e-7)
            # fill missing slopes from the nearest branch that has data
            # (ECLIPSE extrapolates undersaturated data between branches)
            have = ~np.isnan(slope_b)
            idx = np.arange(nb)
            if have.any():
                slope_b = np.interp(idx, idx[have], slope_b[have])
                slope_m = np.interp(idx, idx[have], slope_m[have])
            else:
                slope_b[:] = 0.0
                slope_m[:] = 0.0
            # single-row branches borrow the nearest data branch's
            # pressure offsets and value deltas (the reference's PVTO
            # table "filling" of incomplete undersaturated data)
            for i in need_fill:
                if have.any():
                    j = idx[have][np.argmin(np.abs(idx[have] - i))]
                    up[i] = p_sat[i] + (up[j] - p_sat[j])
                    ub[i] = inv_b_sat[i] + (ub[j] - inv_b_sat[j])
                    um[i] = mu_sat[i] + (um[j] - mu_sat[j])
                    ubm[i] = ibmu_sat[i] + (ubm[j] - ibmu_sat[j])
                else:
                    up[i] = p_sat[i] + np.arange(m_max) * 1e6
                    ub[i] = inv_b_sat[i]
                    um[i] = mu_sat[i]
                    ubm[i] = ibmu_sat[i]
            # node axis for the bank is p_sat (strictly increasing); rs
            # rides along as a data column and keeps increasing under the
            # slope-extension padding
            cols.append([p_sat, np.asarray(pvto.rs), inv_b_sat, mu_sat,
                         slope_b, slope_m, ibmu_sat])
            # pad the branch axis to nb_max by continuing the last branch
            # shifted to the extrapolated saturated heads
            if nb < nb_max:
                next_rows = []
                for arr, head in ((up, p_sat), (ub, inv_b_sat),
                                  (um, mu_sat), (ubm, ibmu_sat)):
                    d = (head[-1] - head[-2]) if nb > 1 else (
                        1e6 if arr is up else 0.0)
                    ext = np.stack([arr[nb - 1] + d * (k + 1)
                                    for k in range(nb_max - nb)])
                    next_rows.append(np.concatenate([arr, ext]))
                up, ub, um, ubm = next_rows
            usats.append((up, ub, um, ubm))
        p_sat, rs, invb, mu, sb, sm, ibmu = _pad_bank_linear(cols)
        return LiveOilPvt(
            p_sat=_t(p_sat), rs_tab=_t(rs),
            inv_b_sat=_t(invb), mu_sat=_t(mu),
            slope_inv_b=_t(sb), slope_mu=_t(sm),
            usat_p=_t(np.stack([u[0] for u in usats])),
            usat_inv_b=_t(np.stack([u[1] for u in usats])),
            usat_mu=_t(np.stack([u[2] for u in usats])),
            inv_b_mu_sat=_t(ibmu),
            usat_inv_b_mu=_t(np.stack([u[3] for u in usats])),
            usat_nb=tuple(len(pvto.rs) for pvto in pvtos))


class WetGasPvt(NamedTuple):
    """PVTG wet gas with vaporized oil, banked per PVTNUM region: the
    LiveOilPvt structure with the roles of p and Rv swapped (lines at the
    deck's pressure nodes, rows ascending in Rv, blended in p).
    ``usat_np`` holds the REAL line count per region."""

    p: torch.Tensor
    rv_tab: torch.Tensor
    inv_b_sat: torch.Tensor
    mu_sat: torch.Tensor
    slope_inv_b: torch.Tensor
    slope_mu: torch.Tensor
    usat_rv: torch.Tensor | None = None
    usat_inv_b: torch.Tensor | None = None
    inv_b_mu_sat: torch.Tensor | None = None
    usat_inv_b_mu: torch.Tensor | None = None
    usat_np: tuple | None = None

    def rv_sat(self, pres, reg=0):
        """Saturated (maximum) vaporized OGR at pressure p."""
        return vmax(interp1d(pres, row(self.p, reg), row(self.rv_tab, reg)),
                    0.0)

    def _usat(self, pres, rv, reg, vals_bank):
        nodes = row(self.usat_rv, reg)
        vals = row(vals_bank, reg)
        pn = row(self.p, reg)
        hi = (None if self.usat_np is None
              else _real_count(self.usat_np, reg) - 2)
        idx = segment(pres, pn, 0, hi)
        v0 = interp1d(rv, _line(nodes, idx), _line(vals, idx))
        v1 = interp1d(rv, _line(nodes, idx + 1), _line(vals, idx + 1))
        return _blend(pres, pn, v0, v1, idx)

    def _check_2d(self):
        if self.usat_rv is None:
            raise NotImplementedError(
                "hand-built PVTG tables without undersaturated banks are "
                "not ported (ROADMAP.md Queue 1 item 13)")

    def inv_b(self, pres, rv, reg=0):
        self._check_2d()
        rv_eff = torch.minimum(rv, self.rv_sat(pres, reg))
        return self._usat(pres, rv_eff, reg, self.usat_inv_b)

    def viscosity(self, pres, rv, reg=0):
        self._check_2d()
        rv_eff = torch.minimum(rv, self.rv_sat(pres, reg))
        invb = self._usat(pres, rv_eff, reg, self.usat_inv_b)
        ibmu = self._usat(pres, rv_eff, reg, self.usat_inv_b_mu)
        return _mu_from_inv_b_mu(invb, ibmu)

    @staticmethod
    def from_tables(pvtgs: list) -> "WetGasPvt":
        cols = []
        usats = []
        m_max = max(max(len(b[0]) for b in pvtg.branches)
                    for pvtg in pvtgs)
        np_max = max(len(pvtg.p) for pvtg in pvtgs)
        for pvtg in pvtgs:
            npn = len(pvtg.p)
            rv_sat = np.empty(npn)
            inv_b_sat = np.empty(npn)
            mu_sat = np.empty(npn)
            ibmu_sat = np.empty(npn)
            slope_b = np.full(npn, np.nan)
            slope_m = np.full(npn, np.nan)
            urv = np.empty((npn, m_max))
            ub = np.empty((npn, m_max))
            ubm = np.empty((npn, m_max))
            need_fill = []
            for i, (rv, bg, mu) in enumerate(pvtg.branches):
                rv_sat[i] = rv[0]
                inv_b_sat[i] = 1.0 / bg[0]
                mu_sat[i] = mu[0]
                ibmu_sat[i] = 1.0 / (bg[0] * mu[0])
                if len(rv) > 1:
                    drv = rv - rv[0]
                    db = 1.0 / bg - 1.0 / bg[0]
                    dm = mu - mu[0]
                    denom = np.sum(drv * drv)
                    if denom > 0:
                        slope_b[i] = np.sum(drv * db) / denom
                        slope_m[i] = np.sum(drv * dm) / denom
                    # PVTG rows run from rv_sat DOWN toward dry gas;
                    # store ascending in rv for the interpolation
                    order = np.argsort(np.asarray(rv, float))
                    rv_a = np.asarray(rv, float)[order]
                    ib_a = (1.0 / np.asarray(bg, float))[order]
                    ibm_a = (1.0 / (np.asarray(bg, float)
                                    * np.asarray(mu, float)))[order]
                    if len(np.unique(rv_a)) < len(rv_a):
                        need_fill.append(i)
                    else:
                        urv[i], ub[i], ubm[i] = _pad_rows(
                            rv_a, ib_a, ibm_a, m=m_max)
                else:
                    need_fill.append(i)
            have = ~np.isnan(slope_b)
            idx = np.arange(npn)
            if have.any():
                slope_b = np.interp(idx, idx[have], slope_b[have])
                slope_m = np.interp(idx, idx[have], slope_m[have])
            else:
                slope_b[:] = 0.0
                slope_m[:] = 0.0
            filled = np.asarray([i not in need_fill for i in range(npn)])
            for i in need_fill:
                if filled.any():
                    j = idx[filled][np.argmin(np.abs(idx[filled] - i))]
                    urv[i] = rv_sat[i] + (urv[j] - rv_sat[j])
                    ub[i] = inv_b_sat[i] + (ub[j] - inv_b_sat[j])
                    ubm[i] = ibmu_sat[i] + (ubm[j] - ibmu_sat[j])
                else:
                    urv[i] = rv_sat[i] + np.arange(m_max) * 1e-3
                    ub[i] = inv_b_sat[i]
                    ubm[i] = ibmu_sat[i]
            cols.append([pvtg.p, rv_sat, inv_b_sat, mu_sat, slope_b,
                         slope_m, ibmu_sat])
            if npn < np_max:
                next_rows = []
                for arr, head in ((urv, rv_sat), (ub, inv_b_sat),
                                  (ubm, ibmu_sat)):
                    d = (head[-1] - head[-2]) if npn > 1 else 0.0
                    ext = np.stack([arr[npn - 1] + d * (k + 1)
                                    for k in range(np_max - npn)])
                    next_rows.append(np.concatenate([arr, ext]))
                urv, ub, ubm = next_rows
            usats.append((urv, ub, ubm))
        p, rv, invb, mu, sb, sm, ibmu = _pad_bank_linear(cols)
        return WetGasPvt(
            p=_t(p), rv_tab=_t(rv),
            inv_b_sat=_t(invb), mu_sat=_t(mu),
            slope_inv_b=_t(sb), slope_mu=_t(sm),
            usat_rv=_t(np.stack([u[0] for u in usats])),
            usat_inv_b=_t(np.stack([u[1] for u in usats])),
            inv_b_mu_sat=_t(ibmu),
            usat_inv_b_mu=_t(np.stack([u[2] for u in usats])),
            usat_np=tuple(len(pvtg.p) for pvtg in pvtgs))


def water_pvt_from_props(props: PropsSection) -> WaterPvt:
    recs = props.pvtw_regions or [props.pvtw]
    return WaterPvt(
        p_ref=_t([w.p_ref for w in recs]),
        inv_b_ref=_t([1.0 / w.b_ref for w in recs]),
        comp=_t([w.comp for w in recs]),
        mu_ref=_t([w.visc for w in recs]),
        viscosibility=_t([w.viscosibility for w in recs]),
    )
