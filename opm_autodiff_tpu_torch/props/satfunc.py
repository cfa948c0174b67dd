"""Saturation functions: relative permeability and capillary pressure.

Port of opm_autodiff_tpu/props/satfunc.py (SWOF/SGOF family tables, the
ECLIPSE default three-phase oil relperm, two-point horizontal end-point
scaling and KRW/KRO/KRG/PCW/PCG vertical scaling). Banks are [R, n]
float64 tensors per SATNUM region padded with +inf saturation nodes and
edge values, so interpolation past the last real node clamps.

Killough hysteresis (EPS channels beyond 12, EHYSTR) is not ported yet:
ROADMAP.md Queue 1 item 13.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from opm_autodiff_tpu_torch.io.state import PropsSection
from opm_autodiff_tpu_torch.props.pvt import row
from opm_autodiff_tpu_torch.props.tables import interp1d, vmax


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _pad_bank(tables: list, col: int) -> np.ndarray:
    """Stack column `col` of per-region tables, padded to max rows."""
    m = max(t.shape[0] for t in tables)
    out = np.empty((len(tables), m))
    for i, t in enumerate(tables):
        n = t.shape[0]
        out[i, :n] = t[:, col]
        out[i, n:] = np.inf if col == 0 else t[-1, col]
    return out


def _hysteresis_unported():
    return NotImplementedError(
        "Killough hysteresis (EHYSTR/IMBNUM) is not ported yet: "
        "ROADMAP.md Queue 1 item 13")


class SatFunc(NamedTuple):
    sw: torch.Tensor
    krw_tab: torch.Tensor
    krow_tab: torch.Tensor
    pcow_tab: torch.Tensor
    sg: torch.Tensor
    krg_tab: torch.Tensor
    krog_tab: torch.Tensor
    pcog_tab: torch.Tensor
    swco: torch.Tensor
    t_swl: torch.Tensor
    t_swcr: torch.Tensor
    t_swu: torch.Tensor
    t_sw0w: torch.Tensor
    t_sgcr: torch.Tensor
    t_sgu: torch.Tensor
    t_sg0g: torch.Tensor
    t_krw_mx: torch.Tensor
    t_kro_mx: torch.Tensor
    t_krg_mx: torch.Tensor
    hyst_pc_curv: torch.Tensor | None = None

    def _row(self, bank, reg):
        return row(bank, reg)

    @staticmethod
    def _remap(s, a_c, b_c, a_t, b_t):
        """Two-point horizontal EPS: cell interval [a_c,b_c] -> table
        interval [a_t,b_t]."""
        den = vmax(b_c - a_c, 1e-12)
        return a_t + (s - a_c) * (b_t - a_t) / den

    @staticmethod
    def _e(eps, idx, default):
        """EPS channel with table default (NaN in the channel = default)."""
        v = eps[..., idx]
        if not torch.is_tensor(default):
            default = torch.as_tensor(default, dtype=v.dtype,
                                      device=v.device)
        return torch.where(torch.isnan(v), default, v)

    @staticmethod
    def _check_eps(eps):
        if eps is not None and eps.shape[-1] > 12:
            raise _hysteresis_unported()

    def krw(self, sw, reg=0, eps=None):
        self._check_eps(eps)
        scale = 1.0
        if eps is not None:
            swcr_t = self._row(self.t_swcr, reg)
            swu_t = self._row(self.t_swu, reg)
            kmx_t = self._row(self.t_krw_mx, reg)
            sw = self._remap(sw, self._e(eps, 1, swcr_t),
                             self._e(eps, 2, swu_t), swcr_t, swu_t)
            scale = self._e(eps, 7, kmx_t) / vmax(kmx_t, 1e-12)
        return scale * vmax(interp1d(sw, self._row(self.sw, reg),
                                     self._row(self.krw_tab, reg),
                                     extrapolate=False), 0.0)

    def krow(self, sw, reg=0, eps=None):
        self._check_eps(eps)
        scale = 1.0
        if eps is not None:
            swl_t = self._row(self.t_swl, reg)
            sw0_t = self._row(self.t_sw0w, reg)
            kmx_t = self._row(self.t_kro_mx, reg)
            sw = self._remap(sw, self._e(eps, 0, swl_t),
                             self._e(eps, 3, sw0_t), swl_t, sw0_t)
            scale = self._e(eps, 8, kmx_t) / vmax(kmx_t, 1e-12)
        return scale * vmax(interp1d(sw, self._row(self.sw, reg),
                                     self._row(self.krow_tab, reg),
                                     extrapolate=False), 0.0)

    def pcow(self, sw, reg=0, eps=None):
        """Capillary pressure Po - Pw."""
        self._check_eps(eps)
        mult = 1.0
        if eps is not None:
            swl_t = self._row(self.t_swl, reg)
            swu_t = self._row(self.t_swu, reg)
            sw = self._remap(sw, self._e(eps, 0, swl_t),
                             self._e(eps, 2, swu_t), swl_t, swu_t)
            mult = self._e(eps, 10, 1.0)
        return mult * interp1d(sw, self._row(self.sw, reg),
                               self._row(self.pcow_tab, reg),
                               extrapolate=False)

    def krg(self, sg, reg=0, eps=None):
        self._check_eps(eps)
        scale = 1.0
        if eps is not None:
            sgcr_t = self._row(self.t_sgcr, reg)
            sgu_t = self._row(self.t_sgu, reg)
            kmx_t = self._row(self.t_krg_mx, reg)
            sg = self._remap(sg, self._e(eps, 4, sgcr_t),
                             self._e(eps, 5, sgu_t), sgcr_t, sgu_t)
            scale = self._e(eps, 9, kmx_t) / vmax(kmx_t, 1e-12)
        return scale * vmax(interp1d(sg, self._row(self.sg, reg),
                                     self._row(self.krg_tab, reg),
                                     extrapolate=False), 0.0)

    def krog(self, sg, reg=0, eps=None):
        self._check_eps(eps)
        scale = 1.0
        if eps is not None:
            sg0_t = self._row(self.t_sg0g, reg)
            kmx_t = self._row(self.t_kro_mx, reg)
            zero = torch.zeros_like(sg0_t)
            sg = self._remap(sg, zero, self._e(eps, 6, sg0_t), zero, sg0_t)
            scale = self._e(eps, 8, kmx_t) / vmax(kmx_t, 1e-12)
        return scale * vmax(interp1d(sg, self._row(self.sg, reg),
                                     self._row(self.krog_tab, reg),
                                     extrapolate=False), 0.0)

    def pcog(self, sg, reg=0, eps=None):
        """Capillary pressure Pg - Po."""
        self._check_eps(eps)
        mult = self._e(eps, 11, 1.0) if eps is not None else 1.0
        return mult * interp1d(sg, self._row(self.sg, reg),
                               self._row(self.pcog_tab, reg),
                               extrapolate=False)

    def kro(self, sw, sg, reg=0, eps=None):
        """Three-phase oil relperm, ECLIPSE default model:

        kro = (sg * krog + (sw - swco) * krow) / (sg + sw - swco)

        with the denominator guarded: as sg + (sw - swco) -> 0 the oil is
        the only mobile phase and kro -> krow(swco).
        """
        krow = self.krow(sw, reg, eps)
        krog = self.krog(sg, reg, eps)
        swco = self._row(self.swco, reg)
        if eps is not None:
            swco = self._e(eps, 0, swco)
        swn = vmax(sw - swco, 0.0)
        den = sg + swn
        ok = den > 1e-12
        safe_den = torch.where(ok, den, torch.ones_like(den))
        mixed = (sg * krog + swn * krow) / safe_den
        return torch.where(ok, mixed, self.krow(swco, reg, eps))

    @staticmethod
    def from_props(props: PropsSection, phases=None,
                   ehystr=None) -> "SatFunc":
        phases = phases or frozenset({"OIL", "WATER", "GAS"})
        swof_regions = list(props.swof_regions)
        sgof_regions = list(props.sgof_regions)
        inert = np.asarray([[0.0, 0.0, 1.0, 0.0], [1.0, 0.0, 0.0, 0.0]])
        # single-phase decks carry no saturation functions at all
        # (reference: flow_onephase.cpp / flow_onephase_energy.cpp);
        # the lone phase is fully mobile at its saturation
        mobile = np.asarray([[0.0, 0.0, 1.0, 0.0], [1.0, 1.0, 0.0, 0.0]])
        if not swof_regions and "WATER" not in phases:
            swof_regions = [inert]
        if not sgof_regions and "GAS" not in phases:
            sgof_regions = [inert]
        if len(phases) == 1:
            if not swof_regions:
                swof_regions = [mobile]
            if not sgof_regions:
                sgof_regions = [mobile]
        if not swof_regions or not sgof_regions:
            raise NotImplementedError(
                "only SWOF/SGOF family supported in this round")
        # both banks must have the same region count: recycle the last
        # table (ECL defaults a missing region table to the previous one)
        nr = max(len(swof_regions), len(sgof_regions))
        while len(swof_regions) < nr:
            swof_regions.append(swof_regions[-1])
        while len(sgof_regions) < nr:
            sgof_regions.append(sgof_regions[-1])
        # unscaled table end points per region (the EPS reference frame)
        def endpoints(t, kr_col):
            s_nodes = t[:, 0]
            kr = t[:, kr_col]
            nz = np.nonzero(kr > 0)[0]
            scr = s_nodes[nz[0] - 1] if len(nz) and nz[0] > 0 else s_nodes[0]
            return scr

        t_swl = [t[0, 0] for t in swof_regions]
        t_swcr = [endpoints(t, 1) for t in swof_regions]
        t_swu = [t[-1, 0] for t in swof_regions]
        t_krw_mx = [t[-1, 1] for t in swof_regions]
        t_kro_mx = [t[0, 2] for t in swof_regions]

        def zero_point(t, col):
            # smallest s where the (decreasing) curve reaches zero
            z = np.nonzero(t[:, col] <= 0)[0]
            return t[z[0], 0] if len(z) else t[-1, 0]

        t_sw0w = [zero_point(t, 2) for t in swof_regions]
        t_sgcr = [endpoints(t, 1) for t in sgof_regions]
        t_sgu = [t[-1, 0] for t in sgof_regions]
        t_krg_mx = [t[-1, 1] for t in sgof_regions]
        t_sg0g = [zero_point(t, 2) for t in sgof_regions]

        return SatFunc(
            sw=_t(_pad_bank(swof_regions, 0)),
            krw_tab=_t(_pad_bank(swof_regions, 1)),
            krow_tab=_t(_pad_bank(swof_regions, 2)),
            pcow_tab=_t(_pad_bank(swof_regions, 3)),
            sg=_t(_pad_bank(sgof_regions, 0)),
            krg_tab=_t(_pad_bank(sgof_regions, 1)),
            krog_tab=_t(_pad_bank(sgof_regions, 2)),
            pcog_tab=_t(_pad_bank(sgof_regions, 3)),
            swco=_t([t[0, 0] for t in swof_regions]),
            t_swl=_t(t_swl), t_swcr=_t(t_swcr),
            t_swu=_t(t_swu), t_sw0w=_t(t_sw0w),
            t_sgcr=_t(t_sgcr), t_sgu=_t(t_sgu),
            t_sg0g=_t(t_sg0g), t_krw_mx=_t(t_krw_mx),
            t_kro_mx=_t(t_kro_mx), t_krg_mx=_t(t_krg_mx),
            # Killough Pc scanning only for EHYSTR model flag 1
            hyst_pc_curv=(_t(float(ehystr[0]))
                          if ehystr is not None and int(ehystr[1]) == 1
                          else None),
        )
