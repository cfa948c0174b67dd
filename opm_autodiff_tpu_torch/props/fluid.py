"""FluidSystem: the bundle of PVT + saturation functions + densities.

Port of opm_autodiff_tpu/props/fluid.py. Phase indexing throughout:
0 = WATER, 1 = OIL, 2 = GAS. Every table/record is banked per PVTNUM
region ([R, ...] leading axis); property methods take a region index
``reg`` (an int or a per-cell tensor).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from opm_autodiff_tpu_torch.io.state import EclState
from opm_autodiff_tpu_torch.props.pvt import (DeadOilPvt, DryGasPvt,
                                              LiveOilPvt, WaterPvt,
                                              WetGasPvt, _t, row,
                                              water_pvt_from_props)
from opm_autodiff_tpu_torch.props.satfunc import SatFunc
from opm_autodiff_tpu_torch.props.tables import interp1d, vmax

WATER, OIL, GAS = 0, 1, 2


def _to(nt, device):
    """Move every tensor field of a NamedTuple (recursively) to device."""
    vals = {}
    for k, v in nt._asdict().items():
        if torch.is_tensor(v):
            v = v.to(device)
        elif isinstance(v, tuple) and hasattr(v, "_fields"):
            v = _to(v, device)
        vals[k] = v
    return type(nt)(**vals)


class RockParams(NamedTuple):
    """ROCK compressibility per PVTNUM region ([R] tensors)."""

    p_ref: torch.Tensor
    comp: torch.Tensor

    def mult(self, p, reg=0):
        """Pore-volume multiplier (ECL ROCK second-order expansion)."""
        x = row(self.comp, reg) * (p - row(self.p_ref, reg))
        return 1.0 + x + 0.5 * x * x


class FluidSystem(NamedTuple):
    water: WaterPvt
    oil: LiveOilPvt | DeadOilPvt
    gas: DryGasPvt | WetGasPvt
    sat: SatFunc
    rock: RockParams
    rho_surf: torch.Tensor  # [R, (WATER, OIL, GAS)] kg/m^3

    @property
    def num_pvt_regions(self) -> int:
        return self.rho_surf.shape[0]

    def to(self, device) -> "FluidSystem":
        return _to(self, device)

    def rho_ref(self, reg=0):
        """Surface densities [..., 3] for a PVT region."""
        return row(self.rho_surf, reg)

    @property
    def live_oil(self) -> bool:
        return isinstance(self.oil, LiveOilPvt)

    @property
    def wet_gas(self) -> bool:
        return isinstance(self.gas, WetGasPvt)

    def oil_inv_b(self, p, rs, reg=0):
        if self.live_oil:
            return self.oil.inv_b(p, rs, reg)
        return self.oil.inv_b(p, reg)

    def oil_viscosity(self, p, rs, reg=0):
        if self.live_oil:
            return self.oil.viscosity(p, rs, reg)
        return self.oil.viscosity(p, reg)

    def rs_sat(self, p, reg=0):
        if self.live_oil:
            return self.oil.rs_sat(p, reg)
        return torch.zeros_like(p)

    def gas_inv_b(self, p, rv, reg=0):
        if self.wet_gas:
            return self.gas.inv_b(p, rv, reg)
        return self.gas.inv_b(p, reg)

    def gas_viscosity(self, p, rv, reg=0):
        if self.wet_gas:
            return self.gas.viscosity(p, rv, reg)
        return self.gas.viscosity(p, reg)

    def rv_sat(self, p, reg=0):
        if self.wet_gas:
            return self.gas.rv_sat(p, reg)
        return torch.zeros_like(p)

    def _sat_vec(self, p, pvtnum, bank_p, bank_v):
        """Batched multi-region saturated Rs/Rv in ``p``'s dtype (a static
        loop over the region count with masked interpolation)."""
        bank_p = bank_p.to(p.dtype)
        bank_v = bank_v.to(p.dtype)
        nr = bank_p.shape[0]
        if nr == 1 or pvtnum is None:
            return vmax(interp1d(p, bank_p[0], bank_v[0]), 0.0)
        out = torch.zeros_like(p)
        for r in range(nr):
            out = torch.where(pvtnum == r, interp1d(p, bank_p[r], bank_v[r]),
                              out)
        return vmax(out, 0.0)

    def rs_sat_vec(self, p, pvtnum=None):
        if not self.live_oil:
            return torch.zeros_like(p)
        return self._sat_vec(p, pvtnum, self.oil.p_sat, self.oil.rs_tab)

    def rv_sat_vec(self, p, pvtnum=None):
        if not self.wet_gas:
            return torch.zeros_like(p)
        return self._sat_vec(p, pvtnum, self.gas.p, self.gas.rv_tab)

    @staticmethod
    def from_state(state: EclState, device=None) -> "FluidSystem":
        """Build the fluid system (host numpy banks -> float64 tensors on
        ``device``, default CPU); absent phases get inert stub tables so
        the 3-equation layout is uniform."""
        props = state.props
        phases = state.runspec.phases
        if "EHYSTR" in getattr(state, "flags", ()):
            raise NotImplementedError(
                "Killough hysteresis (EHYSTR) is not ported yet: "
                "ROADMAP.md Queue 1 item 13")

        def recycle(lst, n):
            lst = list(lst)
            while lst and len(lst) < n:
                lst.append(lst[-1])
            return lst

        oil_tabs = props.pvto_regions or (
            [props.pvto] if props.pvto is not None else [])
        dead_tabs = props.pvdo_regions or (
            [props.pvdo] if props.pvdo is not None else [])
        gas_tabs = props.pvdg_regions or (
            [props.pvdg] if props.pvdg is not None else [])
        wet_tabs = list(props.pvtg_regions)
        pvtws = props.pvtw_regions or [props.pvtw]
        rocks = props.rock_regions or [props.rock]
        denss = props.density_regions or [props.density]
        ntpvt = max(len(oil_tabs), len(dead_tabs), len(gas_tabs),
                    len(wet_tabs), len(pvtws), len(rocks), len(denss))
        oil_tabs = recycle(oil_tabs, ntpvt)
        dead_tabs = recycle(dead_tabs, ntpvt)
        gas_tabs = recycle(gas_tabs, ntpvt)
        wet_tabs = recycle(wet_tabs, ntpvt)
        pvtws = recycle(pvtws, ntpvt)
        rocks = recycle(rocks, ntpvt)
        denss = recycle(denss, ntpvt)

        if oil_tabs:
            oil = LiveOilPvt.from_tables(oil_tabs)
        elif dead_tabs:
            oil = DeadOilPvt.from_tables(dead_tabs)
        elif "OIL" not in phases:
            oil = DeadOilPvt.from_tables([np.asarray(
                [[1e5, 1.0, 1e-3], [1e9, 1.0, 1e-3]])] * ntpvt)
        else:
            raise NotImplementedError("need PVTO or PVDO")
        if wet_tabs:
            gas = WetGasPvt.from_tables(wet_tabs)
        elif gas_tabs:
            gas = DryGasPvt.from_tables(gas_tabs)
        elif "GAS" not in phases:
            gas = DryGasPvt.from_tables([np.asarray(
                [[1e5, 1.0, 1e-3], [1e9, 1.0, 1e-3]])] * ntpvt)
        else:
            raise NotImplementedError("need PVDG or PVTG")
        props = dataclasses.replace(props, pvtw_regions=pvtws)
        fs = FluidSystem(
            water=water_pvt_from_props(props),
            oil=oil,
            gas=gas,
            sat=SatFunc.from_props(props, phases),
            rock=RockParams(_t([r.p_ref for r in rocks]),
                            _t([r.comp for r in rocks])),
            rho_surf=_t([[d.water, d.oil, d.gas] for d in denss]),
        )
        return fs if device is None else fs.to(device)
