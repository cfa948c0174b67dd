"""Black-oil model: primary variables, intensive quantities, accumulation.

Port of opm_autodiff_tpu/models/blackoil.py (opm-models' BlackOilModel
equations). Functions are written with broadcasting over leading axes:
one cell (scalars, under ``torch.func.vmap``/``jacfwd``) or a batch of
cells ([N] tensors) run through the same code.

Primary variables per cell (opm-models' variable-switching scheme):
  u = (po, sw, x3) with a per-cell meaning flag:
    flag == FLAG_SG: x3 = Sg   (oil+gas present; Rs=RsSat(po), Rv=RvSat)
    flag == FLAG_RS: x3 = Rs   (no free gas; Sg = 0, oil undersaturated)
    flag == FLAG_RV: x3 = Rv   (no oil; Sg = 1-Sw, gas undersaturated)
The flag is data, not control flow: every property evaluation is masked
arithmetic.

Phase and equation ordering: WATER=0, OIL=1, GAS=2, residuals in surface
m^3/s.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from opm_autodiff_tpu_torch.props.fluid import FluidSystem
from opm_autodiff_tpu_torch.props.tables import vmin

FLAG_SG = 0  # x3 means Sg
FLAG_RS = 1  # x3 means Rs
FLAG_RV = 2  # x3 means Rv (VAPOIL decks only)


class PrimaryState(NamedTuple):
    """Dynamic per-cell state (the Newton unknowns + meaning flags)."""

    u: torch.Tensor     # [N,3]: po [Pa], sw, x3 (float64)
    flag: torch.Tensor  # [N] int32


class CellStatic(NamedTuple):
    """Per-cell static data."""

    pore_vol_ref: torch.Tensor  # [N]
    depth: torch.Tensor         # [N]
    # [N,2] int32 zero-based regions: col 0 = SATNUM, col 1 = PVTNUM
    regs: torch.Tensor
    # [N,5] dynamic channels: [0:3] phase mobility multipliers, [3] Rs
    # cap, [4] Rv cap (DRSDT/DRVDT). Defaults [1,1,1,inf,inf].
    mob_mult: torch.Tensor
    # [N,12] end-point-scaling channels (props/eps.py) or None
    eps: torch.Tensor | None = None


class Intensive(NamedTuple):
    p: torch.Tensor       # [...,3] phase pressures (water, oil, gas)
    inv_b: torch.Tensor   # [...,3] inverse FVF
    mob: torch.Tensor     # [...,3] kr / mu  [1/(Pa s)]
    rho: torch.Tensor     # [...,3] mass densities at reservoir conditions
    rs: torch.Tensor      # dissolved GOR
    rv: torch.Tensor      # vaporized OGR
    sat: torch.Tensor     # [...,3] saturations


REG0 = (0, 0)  # default region pair (satnum, pvtnum)


def _regs(regs):
    if isinstance(regs, tuple):
        return regs[0], regs[1]
    return regs[..., 0], regs[..., 1]


def intensive(fs: FluidSystem, u, flag, regs=REG0, mob_mult=None,
              eps=None) -> Intensive:
    """Intensive quantities; differentiable in ``u`` [..., 3]."""
    sr, pr = _regs(regs)
    po, sw, x3 = u[..., 0], u[..., 1], u[..., 2]
    is_sg = flag == FLAG_SG
    is_rv = flag == FLAG_RV
    zero = torch.zeros_like(po)
    sg = torch.where(is_sg, x3, torch.where(is_rv, 1.0 - sw, zero))
    so = 1.0 - sw - sg
    rs_sat_eff = fs.rs_sat(po, pr)
    if mob_mult is not None:
        rs_sat_eff = vmin(rs_sat_eff, mob_mult[..., 3])
    rs = torch.where(flag == FLAG_RS, x3, rs_sat_eff)

    pw = po - fs.sat.pcow(sw, sr, eps)
    pg = po + fs.sat.pcog(sg, sr, eps)
    rv_sat_eff = fs.rv_sat(pg, pr)
    if mob_mult is not None:
        rv_sat_eff = vmin(rv_sat_eff, mob_mult[..., 4])
    rv = torch.where(is_rv, x3, rv_sat_eff)

    inv_bw = fs.water.inv_b(pw, pr)
    inv_bo = fs.oil_inv_b(po, rs, pr)
    inv_bg = fs.gas_inv_b(pg, rv, pr)

    mu_w = fs.water.viscosity(pw, pr)
    mu_o = fs.oil_viscosity(po, rs, pr)
    mu_g = fs.gas_viscosity(pg, rv, pr)

    krw = fs.sat.krw(sw, sr, eps)
    kro = fs.sat.kro(sw, sg, sr, eps)
    krg = fs.sat.krg(sg, sr, eps)

    rho = fs.rho_ref(pr)
    rho_w = rho[..., 0] * inv_bw
    rho_o = (rho[..., 1] + rs * rho[..., 2]) * inv_bo
    rho_g = (rho[..., 2] + rv * rho[..., 1]) * inv_bg

    mob = torch.stack([krw / mu_w, kro / mu_o, krg / mu_g], dim=-1)
    if mob_mult is not None:
        mob = mob * mob_mult[..., :3]
    return Intensive(
        p=torch.stack([pw, po, pg], dim=-1),
        inv_b=torch.stack([inv_bw, inv_bo, inv_bg], dim=-1),
        mob=mob,
        rho=torch.stack([rho_w, rho_o, rho_g], dim=-1),
        rs=rs,
        rv=rv,
        sat=torch.stack([sw, so, sg], dim=-1),
    )


def accumulation(fs: FluidSystem, u, flag, pore_vol_ref, regs=REG0,
                 eps=None):
    """Conserved surface volumes [..., 3] (water, oil, gas)."""
    q = intensive(fs, u, flag, regs, None, eps)
    pv = pore_vol_ref * fs.rock.mult(u[..., 0], _regs(regs)[1])
    sw, so, sg = q.sat[..., 0], q.sat[..., 1], q.sat[..., 2]
    aw = pv * sw * q.inv_b[..., 0]
    ao = pv * (so * q.inv_b[..., 1] + q.rv * sg * q.inv_b[..., 2])
    ag = pv * (sg * q.inv_b[..., 2] + q.rs * so * q.inv_b[..., 1])
    return torch.stack([aw, ao, ag], dim=-1)


def statics_from_geometry(geo, device=None):
    """(CellStatic, StructuredTopology) on ``device`` for a fully active
    cartesian grid — the only layout of this slice. Grids with inactive
    cells, NNCs or threshold pressures need the embedded layout."""
    from opm_autodiff_tpu_torch.models.structured import (
        structured_ok, topology_from_geometry)

    if not structured_ok(geo):
        raise NotImplementedError(
            "grids with inactive cells, NNCs or THPRES faces need the "
            "embedded banded layout: ROADMAP.md Queue 1 item 9")
    satnum = getattr(geo, "satnum", None)
    if satnum is None:
        satnum = np.zeros(geo.num_active, np.int32)
    pvtnum = getattr(geo, "pvtnum", None)
    if pvtnum is None:
        pvtnum = np.zeros(geo.num_active, np.int32)
    n = geo.num_active
    mob = np.tile(np.asarray([1.0, 1.0, 1.0, np.inf, np.inf]), (n, 1))
    cells = CellStatic(
        pore_vol_ref=torch.as_tensor(np.asarray(geo.pore_vol, np.float64),
                                     device=device),
        depth=torch.as_tensor(np.asarray(geo.depth, np.float64),
                              device=device),
        regs=torch.as_tensor(np.stack([satnum, pvtnum], axis=1)
                             .astype(np.int32), device=device),
        mob_mult=torch.as_tensor(mob, device=device),
        eps=None,
    )
    return cells, topology_from_geometry(geo, device=device)
