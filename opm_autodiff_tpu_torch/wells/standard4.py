"""Batched 4-DOF StandardWell: WQTotal / WFrac / GFrac / Bhp per well.

Port of opm_autodiff_tpu/wells/standard4.py (reference:
StandardWell.hpp:126-133 primary variables; StandardWell_impl.hpp:188-297
assembly; StandardWellEval.cpp:965 computePerfRate), BHP and rate
controls. All wells are batched into padded [W, ...] tensors; the
per-perforation rates are computed from the K1 packed channels of the
perforated cells (p, 1/B, mob, rho, rs, rv) and differentiated with
``torch.func.jacfwd`` through the channels; d q / d u follows by the chain
rule through K1's Jacobian planes. The B/C/D blocks are tiny dense
tensors with an explicitly inverted D [W,4,4], and the Schur complement
``y -= C D^-1 B x`` rides in the Krylov operator.

Primary variables ``xw [W,4]``:
  xw[:,0] = q_t   total rate (producers: scaled total surface rate,
                  negative = production; injectors: injected-phase rate)
  xw[:,1] = f_w   scaled water volume fraction
  xw[:,2] = f_g   scaled gas volume fraction
  xw[:,3] = bhp   bottom-hole pressure
Sign convention: q > 0 is surface volume flowing INTO the cell.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from opm_autodiff_tpu_torch import units as U
from opm_autodiff_tpu_torch.wells.standard import (CTRL_BHP, CTRL_GRAT,
                                                   CTRL_LRAT, CTRL_ORAT,
                                                   CTRL_RATE, CTRL_RESV,
                                                   CTRL_STOP, CTRL_THP,
                                                   CTRL_WRAT, WellSet,
                                                   connection_densities,
                                                   perf_channels)

# component scaling factors (water, oil, gas): WellInterfaceIndices.cpp:99
SCAL = (1.0, 1.0, 0.01)
# wellbore volume for the storage regularization: 0.1 cu ft
WELLBORE_VOLUME = 0.002831684659200


def _select(conds, choices, default):
    """``jnp.select``: the first true condition wins."""
    out = default
    for c, v in zip(reversed(conds), reversed(choices)):
        out = torch.where(c, v, out)
    return out


def _scal(like):
    return torch.tensor(SCAL, dtype=like.dtype, device=like.device)


def _onehot(phase, like):
    """[..., 3] indicator of the phase index (vmap-safe)."""
    return (torch.arange(3, device=phase.device)
            == phase[..., None]).to(like.dtype)


def invert44(m):
    """Branch-free cofactor inverse of [...,4,4] blocks and the
    determinant."""
    a, b, c, d = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2], m[..., 0, 3]
    e, f, g, h = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2], m[..., 1, 3]
    i, j, k, ll = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2], m[..., 2, 3]
    mm, n, o, p = m[..., 3, 0], m[..., 3, 1], m[..., 3, 2], m[..., 3, 3]
    s0 = a * f - b * e
    s1 = a * g - c * e
    s2 = a * h - d * e
    s3 = b * g - c * f
    s4 = b * h - d * f
    s5 = c * h - d * g
    c5 = k * p - ll * o
    c4 = j * p - ll * n
    c3 = j * o - k * n
    c2 = i * p - ll * mm
    c1 = i * o - k * mm
    c0 = i * n - j * mm
    det = s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0
    inv_det = 1.0 / torch.where(torch.abs(det) > 0, det,
                                torch.ones_like(det))
    st = lambda *xs: torch.stack(xs, dim=-1)  # noqa: E731
    adj = torch.stack([
        st(f * c5 - g * c4 + h * c3, -b * c5 + c * c4 - d * c3,
           n * s5 - o * s4 + p * s3, -j * s5 + k * s4 - ll * s3),
        st(-e * c5 + g * c2 - h * c1, a * c5 - c * c2 + d * c1,
           -mm * s5 + o * s2 - p * s1, i * s5 - k * s2 + ll * s1),
        st(e * c4 - f * c2 + h * c0, -a * c4 + b * c2 - d * c0,
           mm * s4 - n * s2 + p * s0, -i * s4 + j * s2 - ll * s0),
        st(-e * c3 + f * c1 - g * c0, a * c3 - b * c1 + c * c0,
           -mm * s3 + n * s1 - o * s0, i * s3 - j * s1 + k * s0),
    ], dim=-2)
    return adj * inv_det[..., None, None], det


class Well4Result(NamedTuple):
    q_perf: torch.Tensor    # [W,P,3] surface rates into cells (efac-scaled)
    dq_du: torch.Tensor     # [W,P,3,3] d q_perf / d u_cell
    dq_dxw: torch.Tensor    # [W,P,3,4] d q_perf / d xw
    res_well: torch.Tensor  # [W,4]
    b_blk: torch.Tensor     # [W,P,4,3] d res_well / d u_cell(perf)
    d_inv: torch.Tensor     # [W,4,4] D^-1
    rho_conn: torch.Tensor  # [W,P]


# ---------------------------------------------------------------------------
# primary-variable helpers (broadcast over leading axes)
# ---------------------------------------------------------------------------

def _volume_fractions(f_w, f_g):
    return torch.stack([f_w, 1.0 - f_w - f_g, f_g], dim=-1)


def _surface_fractions(f_w, f_g):
    f_scaled = _volume_fractions(f_w, f_g) / _scal(f_w)
    total = f_scaled[..., 0] + f_scaled[..., 1] + f_scaled[..., 2]
    safe = torch.where(torch.abs(total) > 1e-12, total,
                       torch.ones_like(total))
    return f_scaled / safe[..., None]


def _get_qs(xw, is_injector, inj_phase):
    """Per-component surface rates Q [...,3] from the primary variables."""
    q_t, f_w, f_g = xw[..., 0], xw[..., 1], xw[..., 2]
    q_prod = q_t[..., None] * (_volume_fractions(f_w, f_g) / _scal(xw))
    q_inj = _onehot(inj_phase, xw) * q_t[..., None]
    return torch.where(is_injector[..., None], q_inj, q_prod)


def init_xw(u, ws: WellSet, pbh=None, q_rates=None):
    """Initialize ``xw`` from the reservoir state / previous rates
    (reference: StandardWellEval.cpp:248 updatePrimaryVariables)."""
    nw = ws.num_wells
    if pbh is None:
        p_perf0 = u[ws.cell[:, 0], 0]
        pbh = p_perf0 + torch.where(ws.is_injector, 1e5, -1e5)
    dt = u.dtype
    if q_rates is None:
        prod_target = _select(
            [ws.ctrl_mode == CTRL_ORAT, ws.ctrl_mode == CTRL_WRAT,
             ws.ctrl_mode == CTRL_GRAT, ws.ctrl_mode == CTRL_LRAT],
            [ws.orat, ws.wrat, ws.grat, ws.lrat],
            torch.full_like(ws.orat, 1e-3))
        prod_target = torch.where(
            torch.isfinite(prod_target) & (prod_target > 0), prod_target,
            torch.full_like(prod_target, 1e-3))
        inj_target = torch.where(torch.isfinite(ws.inj_rate), ws.inj_rate,
                                 torch.full_like(ws.inj_rate, 1e-3))
        q_rates = torch.where(
            ws.is_injector[:, None],
            _onehot(ws.inj_phase, u) * inj_target[:, None],
            -torch.ones((nw, 3), dtype=dt, device=u.device)
            * (prod_target[:, None] / 3.0))
    total_scaled = q_rates @ _scal(q_rates)
    big = torch.abs(total_scaled) > 1e-12
    safe_tot = torch.where(big, total_scaled, torch.ones_like(total_scaled))
    third = torch.full_like(total_scaled, 1.0 / 3.0)
    f_w = torch.where(big, SCAL[0] * q_rates[:, 0] / safe_tot,
                      torch.where(ws.is_injector,
                                  (ws.inj_phase == 0).to(dt), third))
    f_g = torch.where(big, SCAL[2] * q_rates[:, 2] / safe_tot,
                      torch.where(ws.is_injector,
                                  (ws.inj_phase == 2).to(dt), third))
    q_inj = q_rates[torch.arange(nw, device=u.device), ws.inj_phase]
    q_t = torch.where(ws.is_injector, q_inj, total_scaled)
    return torch.stack([q_t, f_w, f_g, pbh.to(dt)], dim=1)


def xw_surface_rates(xw, ws: WellSet):
    """[W,3] signed surface rates into cells from the primary variables."""
    return _get_qs(xw, ws.is_injector, ws.inj_phase)


# ---------------------------------------------------------------------------
# per-perforation inflow from packed channels
# ---------------------------------------------------------------------------

def _perf_cq_channels(ch, xw, rho_conn, wi, dz, is_injector, inj_phase,
                      allow_cf):
    """Surface component rates cq_s [3] INTO the cell at one perforation
    from the cell's packed channels ``ch`` [17] (p[3], 1/B[3], mob[3],
    rho[3], rs, rv, acc[3]): producing perfs use per-phase mobilities +
    Rs/Rv transfer; injecting perfs push the wellbore surface mixture
    through the total mobility (StandardWellEval.cpp:965)."""
    p_o = ch[1]
    inv_b = ch[3:6]
    mob = ch[6:9]
    rs, rv = ch[12], ch[13]
    p_conn = xw[3] + rho_conn * U.GRAVITY * dz
    drawdown = p_o - p_conn  # > 0 -> producing perforation

    cq_p = -wi * mob * inv_b * drawdown
    cq_prod = torch.stack([cq_p[0], cq_p[1] + rv * cq_p[2],
                           cq_p[2] + rs * cq_p[1]])

    total_mob = mob[0] + mob[1] + mob[2]
    cqt_i = -wi * total_mob * drawdown
    cmix = _surface_fractions(xw[1], xw[2])
    d = 1.0 - rv * rs
    tiny = torch.full_like(d, 1e-12)
    d = torch.where(torch.abs(d) > 1e-12, d, tiny)
    tmp_o = (cmix[1] - rv * cmix[2]) / d
    tmp_g = (cmix[2] - rs * cmix[1]) / d
    vol_ratio = cmix[0] / inv_b[0] + tmp_o / inv_b[1] + tmp_g / inv_b[2]
    vol_ratio = torch.where(torch.abs(vol_ratio) > 1e-12, vol_ratio, tiny)
    cq_inj = cmix * (cqt_i / vol_ratio)

    producing = drawdown > 0
    cq = torch.where(producing, cq_prod, cq_inj)
    crossflow = torch.where(producing, is_injector, ~is_injector)
    return torch.where(crossflow & ~allow_cf, torch.zeros_like(cq), cq)


def _perf_sweep(ch, dch, xw, ws: WellSet, rho_conn):
    """(q [W,P,3], dq_du [W,P,3,3], dq_dxw [W,P,3,4]) in the channels'
    dtype, Jacobians through the channels by the chain rule."""
    w, p = ws.cell.shape
    dt = ch.dtype
    dz = (ws.perf_depth - ws.ref_depth[:, None]).to(dt)
    allow_cf = torch.ones(w, dtype=torch.bool, device=ch.device)

    def one_perf(c, x, rho, wi, dzc, inj, phase, acf, m):
        def f(cc, xx):
            cq = _perf_cq_channels(cc, xx, rho, wi, dzc, inj, phase, acf)
            cq = torch.where(m, cq, torch.zeros_like(cq))
            return cq, cq

        (jc, jx), val = jacfwd(f, argnums=(0, 1), has_aux=True)(c, x)
        return val, jc, jx

    ex = lambda a: a[:, None].expand(w, p).reshape(-1)  # noqa: E731
    val, dcq_dch, dq_dxw = vmap(one_perf)(
        ch.reshape(w * p, 17),
        xw.to(dt)[:, None, :].expand(w, p, 4).reshape(w * p, 4),
        rho_conn.to(dt).reshape(-1), ws.wi.to(dt).reshape(-1),
        dz.reshape(-1), ex(ws.is_injector), ex(ws.inj_phase), ex(allow_cf),
        ws.perf_mask.reshape(-1))
    dq_du = torch.einsum("nck,nkd->ncd", dcq_dch, dch.reshape(w * p, 17, 3))
    return (val.reshape(w, p, 3), dq_du.reshape(w, p, 3, 3),
            dq_dxw.reshape(w, p, 3, 4))


# ---------------------------------------------------------------------------
# control equation and well-level rows
# ---------------------------------------------------------------------------

def _control_eq(xw, mode, ws_row, is_injector, inj_phase):
    """Mode-dependent control residual on primary-variable rates
    (WellInterfaceEval.cpp:272/:386); BHP and rate modes."""
    (orat, wrat, grat, lrat, inj_rate, bhp_t, resv, vcoef) = ws_row
    bhp = xw[3]
    q = _get_qs(xw, is_injector, inj_phase)
    prod = -q
    r_prod = _select(
        [mode == CTRL_ORAT, mode == CTRL_WRAT, mode == CTRL_GRAT,
         mode == CTRL_LRAT, mode == CTRL_RESV],
        [prod[1] - orat, prod[0] - wrat, prod[2] - grat,
         prod[0] + prod[1] - lrat, torch.dot(vcoef, prod) - resv],
        bhp - bhp_t)
    inj_surf = q[0] + q[1] + q[2]
    r_inj = _select([mode == CTRL_RATE, mode == CTRL_RESV],
                    [inj_surf - inj_rate, torch.dot(vcoef, q) - resv],
                    bhp - bhp_t)
    r = torch.where(is_injector, r_inj,
                    torch.where(mode == CTRL_BHP, bhp - bhp_t, r_prod))
    return torch.where(mode == CTRL_STOP, xw[0], r)


def _well_tail(xw, ws: WellSet, active_mode, f0, dt, q_perf, dq_du,
               dq_dxw, rho_conn) -> Well4Result:
    """Well-level rows + Schur pieces from the per-perf sweep ([W]-sized
    math in float64)."""
    efac = ws.efac
    q_perf = q_perf * efac[:, None, None]
    dq_du = dq_du * efac[:, None, None, None]
    dq_dxw = dq_dxw * efac[:, None, None, None]
    sum_q = q_perf.sum(dim=1)
    sum_dq_dxw = dq_dxw.sum(dim=1)
    if f0 is None:
        f0 = _surface_fractions(xw[:, 1].detach(), xw[:, 2].detach())

    def rest_fn(xw_w, mode, is_inj, phase, ef, f0_w, orat, wrat, grat,
                lrat, inj_rate, bhp_t, resv, vcoef):
        q_w = _get_qs(xw_w, is_inj, phase)
        cmix = _surface_fractions(xw_w[1], xw_w[2])
        storage = (WELLBORE_VOLUME / dt) * (cmix - f0_w)
        rows = -ef * q_w + storage
        ctrl = _control_eq(xw_w, mode, (orat, wrat, grat, lrat, inj_rate,
                                        bhp_t, resv, vcoef), is_inj, phase)
        return torch.cat([rows, ctrl[None]])

    def both(*args):
        out = rest_fn(*args)
        return out, out

    rest_args = (xw, active_mode, ws.is_injector, ws.inj_phase, efac, f0,
                 ws.orat, ws.wrat, ws.grat, ws.lrat, ws.inj_rate,
                 ws.bhp_target, ws.resv_rate, ws.voidage_coeff)
    drest_dxw, rest = vmap(jacfwd(both, argnums=0, has_aux=True))(*rest_args)

    res_well = rest.clone()
    res_well[:, :3] += sum_q
    d_blk = drest_dxw.clone()
    d_blk[:, :3, :] += sum_dq_dxw
    b_blk = torch.cat([dq_du, torch.zeros_like(dq_du[:, :, :1, :])], dim=2)

    # singular / closed well: pin the well system
    _, det = invert44(d_blk)
    bad = (~torch.isfinite(det)) | (torch.abs(det) < 1e-300) | ~ws.open_mask
    eye = torch.eye(4, dtype=d_blk.dtype, device=d_blk.device).expand_as(d_blk)
    d_blk = torch.where(bad[:, None, None], eye, d_blk)
    res_pin = torch.stack([xw[:, 0], xw[:, 1], xw[:, 2],
                           xw[:, 3] - ws.bhp_target], dim=1)
    res_well = torch.where(bad[:, None], res_pin, res_well)
    zero = torch.zeros((), dtype=b_blk.dtype, device=b_blk.device)
    b_blk = torch.where(bad[:, None, None, None], zero, b_blk)
    zero_q = bad | ~ws.open_mask
    q_perf = torch.where(zero_q[:, None, None], zero, q_perf)
    dq_du = torch.where(zero_q[:, None, None, None], zero, dq_du)
    dq_dxw = torch.where(zero_q[:, None, None, None], zero, dq_dxw)
    d_inv, _ = invert44(d_blk)
    return Well4Result(q_perf=q_perf, dq_du=dq_du, dq_dxw=dq_dxw,
                       res_well=res_well, b_blk=b_blk, d_inv=d_inv,
                       rho_conn=rho_conn)


def check_controls(ws: WellSet) -> None:
    """The slice covers BHP and rate controls only."""
    if bool(((ws.ctrl_mode == CTRL_THP) | (ws.vfp_idx >= 0)).any()):
        raise NotImplementedError(
            "THP/VFP well control is not ported yet: ROADMAP.md Queue 1 "
            "item 12")


def well4_contributions_packed(packed, xw, ws: WellSet, active_mode=None,
                               rho_conn=None, f0=None,
                               dt=86400.0) -> Well4Result:
    """Assemble the 4-DOF well system from the assembly's K1 planes
    ``packed = (q [nz,17,ny,nx], dq [nz,17,3,ny,nx])`` at the perforated
    cells (reference: well4_contributions_packed)."""
    if active_mode is None:
        active_mode = ws.ctrl_mode
    if rho_conn is None:
        raise ValueError("well4_contributions_packed needs the explicit "
                         "per-substep rho_conn")
    q5, dq5 = packed
    nz, _, ny, nx = q5.shape
    cell = ws.cell
    k = cell // (ny * nx)
    rem = cell % (ny * nx)
    j = rem // nx
    i = rem % nx
    ch = q5[k, :, j, i]           # [W,P,17]
    dch = dq5[k, :, :, j, i]      # [W,P,17,3]
    return well4_from_channels(ch, dch, xw, ws, active_mode, rho_conn, f0,
                               dt)


def well4_from_channels(ch, dch, xw, ws, active_mode, rho_conn, f0, dt):
    q_perf, dq_du, dq_dxw = _perf_sweep(ch, dch, xw, ws, rho_conn)
    f64 = xw.dtype
    return _well_tail(xw, ws, active_mode, f0, dt, q_perf.to(f64),
                      dq_du.to(f64), dq_dxw.to(f64), rho_conn)


def well4_contributions(fs, u, flag, xw, ws: WellSet, active_mode=None,
                        regs=None, mob_mult=None, eps=None, rho_conn=None,
                        f0=None, dt=86400.0) -> Well4Result:
    """Assemble the 4-DOF well system from a fresh K1 evaluation of the
    perforated cells (the path when no assembly planes exist)."""
    if active_mode is None:
        active_mode = ws.ctrl_mode
    if rho_conn is None:
        rho_conn = connection_densities(fs, u, flag, ws, regs)
    ch, dch = perf_channels(fs, u, flag, regs, ws.cell, mob_mult, eps)
    return well4_from_channels(ch, dch, xw, ws, active_mode, rho_conn, f0,
                               dt)


# ---------------------------------------------------------------------------
# coupling into the reservoir system
# ---------------------------------------------------------------------------

def apply_to_residual(residual, wr: Well4Result, ws: WellSet):
    """R_c -= q at perforated cells (in the system's storage dtype)."""
    upd = (-wr.q_perf.reshape(-1, 3)).to(residual.dtype)
    return residual.index_add(0, ws.cell.reshape(-1), upd)


def apply_to_diag(diag, wr: Well4Result, ws: WellSet):
    """A_cc -= dq/du at perforated cells."""
    upd = (-wr.dq_du.reshape(-1, 3, 3)).to(diag.dtype)
    return diag.index_add(0, ws.cell.reshape(-1), upd)


def schur_matvec(wr: Well4Result, ws: WellSet, x):
    """y = -C D^-1 B x on cell vectors, in ``x``'s dtype
    (StandardWell_impl.hpp:1273 apply)."""
    dt = x.dtype
    x_perf = x[ws.cell]
    bx = torch.einsum("wpej,wpj->we", wr.b_blk.to(dt), x_perf)
    coef = torch.einsum("wef,wf->we", wr.d_inv.to(dt), bx)
    contrib = torch.einsum("wpce,we->wpc", -wr.dq_dxw.to(dt), coef)
    return torch.zeros_like(x).index_add(0, ws.cell.reshape(-1),
                                         -contrib.reshape(-1, 3))


def schur_rhs(residual, wr: Well4Result, ws: WellSet):
    """Correction C D^-1 r_w to ADD to the rhs (b = -R + corr)."""
    coef = torch.einsum("wef,wf->we", wr.d_inv, wr.res_well)
    contrib = torch.einsum("wpce,we->wpc", -wr.dq_dxw, coef)
    return torch.zeros_like(residual).index_add(
        0, ws.cell.reshape(-1), contrib.reshape(-1, 3).to(residual.dtype))


def recover_xw_update(wr: Well4Result, ws: WellSet, dx):
    """dxw = -D^-1 (res_well + B dx) (StandardWell_impl.hpp:1308)."""
    dx_perf = dx[ws.cell].to(wr.b_blk.dtype)
    bdx = torch.einsum("wpej,wpj->we", wr.b_blk, dx_perf)
    return -torch.einsum("wef,wf->we", wr.d_inv, wr.res_well + bdx)


# ---------------------------------------------------------------------------
# chopped update (StandardWellEval.cpp:717 + :450 processFractions)
# ---------------------------------------------------------------------------

def chop_xw_update(xw, dxw, ws: WellSet, df_limit=0.2, dbhp_limit=1.0):
    """Apply the Newton update ``new = old + dxw`` with the reference's
    chops."""
    q_t, f_w, f_g, bhp = xw[:, 0], xw[:, 1], xw[:, 2], xw[:, 3]
    dq, dfw, dfg, dbhp = dxw[:, 0], dxw[:, 1], dxw[:, 2], dxw[:, 3]
    one = torch.ones_like(q_t)
    zero = torch.zeros_like(q_t)

    def nz(d):
        return torch.where(d == 0, one, d)

    def relax_frac(old, d):
        new = old + d
        r = torch.where(new < 0.0, torch.abs(old / nz(d)),
                        torch.where(new > 1.0, torch.abs((1.0 - old) / nz(d)),
                                    one))
        return torch.clamp(r * 0.95 + (r == 1.0).to(r.dtype) * 0.05, 0.0, 1.0)

    r_frac = torch.minimum(relax_frac(f_w, dfw), relax_frac(f_g, dfg))
    sum_new = f_w + f_g + r_frac * (dfw + dfg)
    upd = r_frac * (dfw + dfg)
    r_sum = torch.where(sum_new > 1.0,
                        torch.abs((1.0 - f_w - f_g) / nz(upd)) * 0.95, one)
    r_frac = r_frac * torch.clamp(r_sum, 0.0, 1.0)
    r_frac = torch.where(ws.is_injector, one, r_frac)

    df_w = torch.clamp(r_frac * dfw, -df_limit, df_limit)
    df_g = torch.clamp(r_frac * dfg, -df_limit, df_limit)
    f_w_new = f_w + df_w
    f_g_new = f_g + df_g

    f_o = 1.0 - f_w_new - f_g_new
    neg_w = f_w_new < 0.0
    scale_w = 1.0 - torch.where(neg_w, f_w_new, zero)
    f_g_new = torch.where(neg_w, f_g_new / scale_w, f_g_new)
    f_o = torch.where(neg_w, f_o / scale_w, f_o)
    f_w_new = torch.where(neg_w, zero, f_w_new)
    neg_g = f_g_new < 0.0
    scale_g = 1.0 - torch.where(neg_g, f_g_new, zero)
    f_w_new = torch.where(neg_g, f_w_new / scale_g, f_w_new)
    f_o = torch.where(neg_g, f_o / scale_g, f_o)
    f_g_new = torch.where(neg_g, zero, f_g_new)
    neg_o = f_o < 0.0
    scale_o = 1.0 - torch.where(neg_o, f_o, zero)
    f_w_new = torch.where(neg_o, f_w_new / scale_o, f_w_new)
    f_g_new = torch.where(neg_o, f_g_new / scale_o, f_g_new)

    new_q = q_t + dq
    sign_change = q_t * new_q < 0.0
    r_rate = torch.where(sign_change, torch.abs(q_t / nz(dq)) * 0.8, one)
    q_t_new = q_t + r_rate * dq

    dbhp_lim = torch.abs(bhp) * dbhp_limit
    dbhp_c = torch.minimum(torch.maximum(dbhp, -dbhp_lim), dbhp_lim)
    bhp_new = torch.clamp(bhp + dbhp_c, min=1e5)
    return torch.stack([q_t_new, f_w_new, f_g_new, bhp_new], dim=1)


# ---------------------------------------------------------------------------
# inner well solve (solveWellEqUntilConverged; MaxWelleqIter=30)
# ---------------------------------------------------------------------------

def solve_well_eq(fs, u, flag, xw, ws: WellSet, active_mode=None,
                  regs=None, mob_mult=None, eps=None, rho_conn=None,
                  dt=86400.0, max_iter=30, tol=1e-10):
    """Solve the well equations with the reservoir state frozen: batched
    Newton on the [W,4] systems, dxw = -D^-1 res, chopped. The frozen
    reservoir means one K1 evaluation of the perforated cells serves
    every inner iteration."""
    if active_mode is None:
        active_mode = ws.ctrl_mode
    if rho_conn is None:
        rho_conn = connection_densities(fs, u, flag, ws, regs)
    ch, dch = perf_channels(fs, u, flag, regs, ws.cell, mob_mult, eps)
    bhp_scale = torch.clamp(torch.abs(ws.bhp_target), min=1e5)

    xw_c = xw
    for _ in range(max_iter):
        wr = well4_from_channels(ch, dch, xw_c, ws, active_mode, rho_conn,
                                 None, dt)
        dxw = -torch.einsum("wef,wf->we", wr.d_inv, wr.res_well)
        dxw = torch.where(torch.isfinite(dxw), dxw, torch.zeros_like(dxw))
        rate_mag = torch.clamp(torch.abs(xw_c[:, 0]), min=1e-6)
        s = torch.cat([rate_mag[:, None].expand(-1, 3), bhp_scale[:, None]],
                      dim=1)
        err = torch.where(ws.open_mask[:, None], torch.abs(wr.res_well) / s,
                          torch.zeros_like(s)).max()
        xw_c = chop_xw_update(xw_c, dxw, ws)
        if not bool(err > tol):
            break
    return torch.where(torch.isfinite(xw_c), xw_c, xw)


def well_convergence(wr: Well4Result, ws: WellSet, active_mode, b_avg=None):
    """Per-well scaled residual [W] (StandardWellEval.cpp:767)."""
    if b_avg is None:
        b_avg = torch.ones(3, dtype=wr.res_well.dtype,
                           device=wr.res_well.device)
    flux_err = torch.abs(wr.res_well[:, :3]) * b_avg[None, :]
    one = torch.ones_like(ws.inj_rate)
    rate_scale = torch.where(
        ws.is_injector,
        torch.where(torch.isfinite(ws.inj_rate), ws.inj_rate, one),
        _select([ws.ctrl_mode == CTRL_ORAT, ws.ctrl_mode == CTRL_WRAT,
                 ws.ctrl_mode == CTRL_GRAT, ws.ctrl_mode == CTRL_LRAT,
                 ws.ctrl_mode == CTRL_RESV],
                [ws.orat, ws.wrat, ws.grat, ws.lrat, ws.resv_rate], one))
    rate_scale = torch.where(torch.isfinite(rate_scale) & (rate_scale > 0),
                             rate_scale, one)
    is_p = (active_mode == CTRL_BHP) | (active_mode == CTRL_THP)
    ctrl_scale = torch.where(is_p, torch.clamp(torch.abs(ws.bhp_target),
                                               min=1e5), rate_scale)
    ctrl_err = torch.abs(wr.res_well[:, 3]) / ctrl_scale
    err = torch.maximum(flux_err.max(dim=1).values, ctrl_err)
    return torch.where(ws.open_mask, err, torch.zeros_like(err))
