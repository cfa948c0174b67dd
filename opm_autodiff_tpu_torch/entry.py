"""One Newton step on the SPE1 flagship model: the port's twin of the
reference package's ``__graft_entry__.entry()``.

``entry(device)`` returns ``(fn, example_args)``: ``fn(u, flag, xw, mode,
acc0, dt)`` runs one full Newton iteration (assembly through the cellpack
and flux kernels, 4-DOF wells, equilibrated f32 BiCGStab with the z-line
kernels, chopped update) and returns ``(u, flag, xw, cnv, q_tot)``.
"""

from __future__ import annotations

import os
import tempfile

import torch

from opm_autodiff_tpu_torch.device import resolve_device


def build_problem(nx=10, ny=10, nz=3, device=None):
    """The SPE1-physics problem on an nx x ny x nz grid: (state, geo, fs,
    cells, topo, init, ws, acc0, pbh) with device tensors."""
    from opm_autodiff_tpu_torch.grid import build_geometry
    from opm_autodiff_tpu_torch.io.state import load_state
    from opm_autodiff_tpu_torch.models.blackoil import (
        PrimaryState, accumulation, statics_from_geometry)
    from opm_autodiff_tpu_torch.models.init import equilibrate
    from opm_autodiff_tpu_torch.props.fluid import FluidSystem
    from opm_autodiff_tpu_torch.utils.synthetic import write_spe1_deck
    from opm_autodiff_tpu_torch.wells import build_wellset

    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "SPE1.DATA")
        write_spe1_deck(path, nx, ny, nz)
        state = load_state(path)
    geo = build_geometry(state)
    fs_host = FluidSystem.from_state(state)
    cells, topo = statics_from_geometry(geo, dev)
    init = equilibrate(state, geo, fs_host)
    init = PrimaryState(init.u.to(dev), init.flag.to(dev))
    fs = fs_host.to(dev)
    ws = build_wellset(geo, state.schedule.steps[0].wells, device=dev)
    acc0 = accumulation(fs, init.u, init.flag, cells.pore_vol_ref)
    pbh = init.u[ws.cell[:, 0], 0] + torch.where(ws.is_injector, 1e5, -1e5)
    return state, geo, fs, cells, topo, init, ws, acc0, pbh


def entry(device=None):
    """(fn, example_args): one forward Newton step on SPE1 with the 4-DOF
    StandardWell, on ``device`` (default ``"cuda"``)."""
    from opm_autodiff_tpu_torch.solvers.newton import (NewtonParams,
                                                       NewtonState,
                                                       newton_iteration)
    from opm_autodiff_tpu_torch.wells import standard4 as s4

    dev = resolve_device(device)
    (_state, _geo, fs, cells, topo, init, ws, acc0, pbh) = build_problem(
        device=dev)
    params = NewtonParams()
    xw0 = s4.init_xw(init.u, ws, pbh=pbh)

    def fn(u, flag, xw, mode, acc0, dt):
        st = NewtonState(u=u, flag=flag, pbh=xw[:, 3], active_mode=mode,
                         xw=xw)
        new_st, info, (q_tot, _q_perf, _res) = newton_iteration(
            params, fs, cells, topo, st, ws, acc0, dt)
        return new_st.u, new_st.flag, new_st.xw, info.cnv, q_tot

    return fn, (init.u, init.flag, xw0, ws.ctrl_mode, acc0, 86400.0)
