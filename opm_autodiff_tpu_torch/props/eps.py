"""Per-cell end-point-scaling vectors (EPS).

Builds the [N, 12] EPS channel array consumed by SatFunc's scaled
evaluators (reference: opm-material ``EclEpsScalingPoints`` "scaled
points" built from the SWL/SWCR/SWU/SGL/SGCR/SGU/SOWCR/SOGCR/KRW/KRO/
KRG/PCW/PCG grid arrays). NaN in a channel means "use the unscaled table
end point of the cell's SATNUM region".

Channel layout (matches SatFunc._e usage):
  0 SWL   1 SWCR  2 SWU   3 SW0W (sw where krow->0 = 1-SOWCR-SGL)
  4 SGCR  5 SGU   6 SG0G (sg where krog->0 = 1-SOGCR-SWL)
  7 KRW max  8 KRO max  9 KRG max  10 PCW multiplier  11 PCG multiplier

SWATINIT handling lives in models/init.py (it solves for the PCW
multiplier that reproduces the requested initial water saturation —
reference: equil/initstateequil SWATINIT scaling).
"""

from __future__ import annotations

import numpy as np


def build_eps(state, geo, fs):
    """[N,12] float array or None when the deck has no EPS keywords."""
    arrs = state.eps_arrays
    if not arrs or all(k == "SWATINIT" for k in arrs):
        has_swatinit = "SWATINIT" in arrs
        if not has_swatinit:
            return None
    u = state.runspec.unit_system
    n = geo.num_active
    act = geo.act_to_glob
    eps = np.full((n, 12), np.nan)

    # Depth-interpolated end points first (ENPTVD/ENKRVD — reference:
    # satfuncEPS_B.DATA, EclEpsGridProperties); grid arrays below
    # override them cell-wise (ECLIPSE precedence). A fully-defaulted
    # (NaN) table column leaves its channel unscaled.
    _depth_iv = {}

    def _interp_depth(tab, col):
        d = tab[:, 0]
        v = tab[:, col]
        if not np.isfinite(v).all():
            return None
        return np.interp(geo.depth, d, v)

    enptvd = arrs.get("ENPTVD")
    if enptvd is not None:
        for col, name in ((1, "SWL"), (2, "SWCR"), (3, "SWU"),
                          (4, "SGL"), (5, "SGCR"), (6, "SGU"),
                          (7, "SOWCR"), (8, "SOGCR")):
            iv = _interp_depth(enptvd, col)
            if iv is not None:
                _depth_iv[name] = iv
    enkrvd = arrs.get("ENKRVD")
    if enkrvd is not None:
        for col, name in ((1, "KRW"), (2, "KRG"), (3, "KRO")):
            iv = _interp_depth(enkrvd, col)
            if iv is not None:
                _depth_iv[name] = iv

    def get(name):
        a = arrs.get(name)
        if a is None:
            return _depth_iv.get(name)
        return np.asarray(a, float)[act]

    swl = get("SWL")
    sgl = get("SGL")
    if swl is not None:
        eps[:, 0] = swl
    if get("SWCR") is not None:
        eps[:, 1] = get("SWCR")
    if get("SWU") is not None:
        eps[:, 2] = get("SWU")
    sowcr = get("SOWCR")
    if sowcr is not None:
        sgl_v = sgl if sgl is not None else 0.0
        eps[:, 3] = 1.0 - sowcr - sgl_v
    if get("SGCR") is not None:
        eps[:, 4] = get("SGCR")
    if get("SGU") is not None:
        eps[:, 5] = get("SGU")
    sogcr = get("SOGCR")
    if sogcr is not None:
        # krog -> 0 where so reaches sogcr with connate water present
        swl_v = swl if swl is not None else np.asarray(fs.sat.t_swl)[
            np.asarray(geo.satnum) if geo.satnum is not None else 0]
        eps[:, 6] = 1.0 - sogcr - swl_v
    if get("KRW") is not None:
        eps[:, 7] = get("KRW")
    if get("KRO") is not None:
        eps[:, 8] = get("KRO")
    if get("KRG") is not None:
        eps[:, 9] = get("KRG")
    # PCW/PCG: max capillary pressure at the connate end -> multiplier
    # against the unscaled table's value at its first node
    satnum = (np.asarray(geo.satnum) if geo.satnum is not None
              else np.zeros(n, np.int32))
    pcw = get("PCW")
    if pcw is not None:
        pcw_t = np.asarray(fs.sat.pcow_tab)[satnum, 0]
        ok = np.abs(pcw_t) > 1e-30
        eps[:, 10] = np.where(ok, pcw * u.pressure
                              / np.where(ok, pcw_t, 1.0), np.nan)
    pcg = get("PCG")
    if pcg is not None:
        # pcog table max is at the LAST real sg node
        sg_bank = np.asarray(fs.sat.sg)
        pcog_bank = np.asarray(fs.sat.pcog_tab)
        pcg_t = np.empty(n)
        for i in range(n):
            row = satnum[i]
            real = np.isfinite(sg_bank[row])
            pcg_t[i] = pcog_bank[row][real][-1]
        ok = np.abs(pcg_t) > 1e-30
        eps[:, 11] = np.where(ok, pcg * u.pressure
                              / np.where(ok, pcg_t, 1.0), np.nan)
    return eps


def extend_with_hysteresis(eps, state, geo, sg_init, sw_init=None):
    """Append the Killough hysteresis channels [12]=sg_max, [13]=IMBNUM
    (zero-based), [14]=sw_min (historical minimum water saturation —
    drives the oil-phase scanning curve of the oil/water system) to the
    EPS array; activates when the deck has EHYSTR + IMBNUM (reference:
    EclHysteresisConfig)."""
    imb = state.regions.get("IMBNUM")
    if imb is None:
        return eps
    n = geo.num_active
    if eps is None:
        eps = np.full((n, 12), np.nan)
    imb_c = np.maximum(np.asarray(imb)[geo.act_to_glob] - 1, 0)
    if sw_init is None:
        sw_min = np.full(n, np.nan)
    else:
        sw_min = np.asarray(sw_init, float)
    out = np.concatenate(
        [np.asarray(eps),
         np.asarray(sg_init, float)[:, None],
         imb_c[:, None].astype(float),
         sw_min[:, None]], axis=1)
    return out
