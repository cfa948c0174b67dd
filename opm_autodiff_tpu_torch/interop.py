"""Carry a problem built elsewhere into the port's tensors.

The inputs are plain nested dicts of numpy arrays (field name -> array,
or -> nested dict for a sub-record), as produced by flattening another
implementation's containers with ``np.asarray`` — the field names are
those of the reference package's NamedTuples, which the port keeps. The
outputs are the port's containers on ``device``, so both sides of a
comparison compute from identical inputs. This module imports nothing
but numpy and torch.
"""

from __future__ import annotations

import numpy as np
import torch

from opm_autodiff_tpu_torch.models.blackoil import CellStatic, PrimaryState
from opm_autodiff_tpu_torch.models.structured import StructuredTopology
from opm_autodiff_tpu_torch.props.fluid import FluidSystem, RockParams
from opm_autodiff_tpu_torch.props.pvt import (DeadOilPvt, DryGasPvt,
                                              LiveOilPvt, WaterPvt,
                                              WetGasPvt)
from opm_autodiff_tpu_torch.props.satfunc import SatFunc
from opm_autodiff_tpu_torch.wells.standard import WellSet

_COUNTS = ("usat_nb", "usat_np")


def tensor(a, device=None):
    """numpy array -> tensor (floats as float64, ints as int64)."""
    a = np.asarray(a)
    if a.dtype.kind == "f":
        a = a.astype(np.float64)
    elif a.dtype.kind in "iu":
        a = a.astype(np.int64)
    return torch.as_tensor(a, device=device)


def _build(cls, d: dict, device):
    vals = {}
    for name in cls._fields:
        v = d.get(name)
        if v is None:
            vals[name] = None
        elif name in _COUNTS:
            vals[name] = tuple(int(x) for x in v)
        else:
            vals[name] = tensor(v, device)
    return cls(**vals)


def fluid_from_arrays(d: dict, device=None) -> FluidSystem:
    oil_cls = LiveOilPvt if "rs_tab" in d["oil"] else DeadOilPvt
    gas_cls = WetGasPvt if "rv_tab" in d["gas"] else DryGasPvt
    return FluidSystem(water=_build(WaterPvt, d["water"], device),
                       oil=_build(oil_cls, d["oil"], device),
                       gas=_build(gas_cls, d["gas"], device),
                       sat=_build(SatFunc, d["sat"], device),
                       rock=_build(RockParams, d["rock"], device),
                       rho_surf=tensor(d["rho_surf"], device))


def cells_from_arrays(d: dict, device=None) -> CellStatic:
    c = _build(CellStatic, d, device)
    return c._replace(regs=c.regs.to(torch.int32))


def topology_from_arrays(d: dict, device=None) -> StructuredTopology:
    return _build(StructuredTopology, d, device)


def wellset_from_arrays(d: dict, device=None) -> WellSet:
    return _build(WellSet, d, device)


def state_from_arrays(u, flag, device=None) -> PrimaryState:
    return PrimaryState(u=tensor(u, device),
                        flag=torch.as_tensor(np.asarray(flag, np.int32),
                                             device=device))
