"""K1 cellpack: per-cell property pack with 3-tangent Jacobians.

Replaces opm_autodiff_tpu/ops/pallas_cellpack.py (``cellpack_planes``).
Output (both versions): plane layout ``q [nz,17,ny,nx]`` and
``dq [nz,17,3,ny,nx]``, channels [pw, po, pg, 1/Bw, 1/Bo, 1/Bg, mob_w,
mob_o, mob_g, rho_w, rho_o, rho_g, rs, rv, acc_w, acc_o, acc_g],
derivatives with respect to (po, sw, x3).

* ``cellpack_cuda`` launches ``csrc/cellpack.cu`` (float32).
* ``cellpack_plain`` is ``torch.func.vmap(torch.func.jacfwd(pack_cell))``
  in the input dtype — the CPU path and the kernel's oracle.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from opm_autodiff_tpu_torch import ops
from opm_autodiff_tpu_torch.ops import build

NQ = 17
META_SIZE = 51  # csrc/cellpack.cu enum Meta
MAX_REGIONS = 8

# device table buffers per fluid system, keyed by the identity of its
# surface-density tensor (kept alive in the entry, so ids stay unique)
_TABLE_CACHE: dict = {}


def supports(fs, cells) -> tuple[bool, str]:
    """(ok, reason): the fluid systems the kernel covers — live oil
    (PVTO with 1/(B mu) banks) with dry (PVDG) or wet (PVTG 2-D) gas,
    at most 8 SATNUM/PVTNUM regions, with or without the 12 end-point
    scaling channels (no hysteresis channels)."""
    from opm_autodiff_tpu_torch.props.pvt import (DryGasPvt, LiveOilPvt,
                                                  WetGasPvt)

    if not isinstance(fs.oil, LiveOilPvt) or fs.oil.inv_b_mu_sat is None:
        return False, "dead-oil (PVDO) or hand-built oil tables"
    if isinstance(fs.gas, DryGasPvt):
        if fs.gas.inv_b_mu_tab is None:
            return False, "dry-gas tables without the 1/(B mu) bank"
    elif isinstance(fs.gas, WetGasPvt):
        if fs.gas.usat_rv is None or fs.gas.usat_np is None:
            return False, "wet-gas tables without undersaturated banks"
    else:
        return False, "unknown gas PVT"
    if cells.eps is not None and cells.eps.shape[-1] != 12:
        return False, "hysteresis channels (EHYSTR)"
    counts = [fs.sat.sw.shape[0], fs.sat.sg.shape[0], fs.oil.p_sat.shape[0],
              fs.gas.p.shape[0], fs.water.p_ref.shape[0],
              fs.rock.p_ref.shape[0], fs.rho_surf.shape[0]]
    if max(counts) > MAX_REGIONS:
        return False, f"more than {MAX_REGIONS} regions"
    if fs.sat.sg.shape[0] != fs.sat.sw.shape[0]:
        return False, "different SWOF/SGOF region counts"
    return True, ""


def require_support(fs, cells) -> None:
    ok, why = supports(fs, cells)
    if not ok:
        raise NotImplementedError(
            f"cellpack does not cover this fluid system ({why}): "
            "ROADMAP.md Queue 1 items 13-14")


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def cellpack_plain(fs, cells, u, flag, dims):
    """(q, dq) planes via ``vmap(jacfwd(pack_cell))`` in ``u``'s dtype."""
    from torch.func import jacfwd, vmap

    from opm_autodiff_tpu_torch.models.structured import pack_cell

    nz, ny, nx = dims

    def one_cell(uu, ff, pv, rg, mm, ep):
        def f(x):
            q = pack_cell(fs, x, ff, pv, rg, mm, ep)
            return q, q

        jac, val = jacfwd(f, has_aux=True)(uu)
        return val, jac

    eps_dim = None if cells.eps is None else 0
    Q, dQ = vmap(one_cell, in_dims=(0, 0, 0, 0, 0, eps_dim))(
        u, flag, cells.pore_vol_ref.to(u.dtype), cells.regs,
        cells.mob_mult.to(u.dtype),
        None if cells.eps is None else cells.eps.to(u.dtype))
    q = Q.reshape(nz, ny, nx, NQ).permute(0, 3, 1, 2).contiguous()
    dq = dQ.reshape(nz, ny, nx, NQ, 3).permute(0, 3, 4, 1, 2).contiguous()
    return q, dq


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

def pack_tables(fs) -> tuple[np.ndarray, np.ndarray]:
    """Flatten the fluid system's banks into one float32 buffer and the
    int32 ``meta`` array read by csrc/cellpack.cu (host numpy)."""
    from opm_autodiff_tpu_torch.props.pvt import WetGasPvt

    def a(t):
        return np.asarray(t.detach().cpu().numpy(), np.float64).reshape(-1)

    sat, oil, gas = fs.sat, fs.oil, fs.gas
    wet = isinstance(gas, WetGasPvt)
    parts, meta = [], np.zeros(META_SIZE, np.int32)
    off = 0

    def put(arr):
        nonlocal off
        parts.append(arr)
        o = off
        off += arr.size
        return o

    meta[0] = sat.sw.shape[0]
    meta[1] = oil.p_sat.shape[0]
    meta[2] = gas.p.shape[0]
    meta[3] = fs.water.p_ref.shape[0]
    meta[4] = fs.rock.p_ref.shape[0]
    meta[5] = fs.rho_surf.shape[0]
    meta[6] = int(wet)
    meta[7] = sat.sw.shape[1]
    meta[8] = sat.sg.shape[1]
    meta[9] = oil.p_sat.shape[1]
    meta[10] = oil.usat_p.shape[2]
    meta[11] = gas.p.shape[1]
    meta[12] = gas.usat_rv.shape[2] if wet else 0
    for i, t in enumerate((sat.sw, sat.krw_tab, sat.krow_tab, sat.pcow_tab,
                           sat.sg, sat.krg_tab, sat.krog_tab, sat.pcog_tab,
                           oil.p_sat, oil.rs_tab, oil.usat_p,
                           oil.usat_inv_b, oil.usat_inv_b_mu, gas.p)):
        meta[13 + i] = put(a(t))
    g = ((gas.rv_tab, gas.usat_rv, gas.usat_inv_b, gas.usat_inv_b_mu)
         if wet else (gas.inv_b_tab, gas.inv_b_mu_tab))
    for i, t in enumerate(g):
        meta[27 + i] = put(a(t))
    w = fs.water
    meta[31] = put(np.concatenate([a(w.p_ref), a(w.inv_b_ref), a(w.comp),
                                   a(w.mu_ref), a(w.viscosibility)]))
    meta[32] = put(np.concatenate([a(fs.rock.p_ref), a(fs.rock.comp)]))
    meta[33] = put(a(fs.rho_surf))
    meta[34] = put(np.concatenate([a(x) for x in (
        sat.t_swl, sat.t_swcr, sat.t_swu, sat.t_sw0w, sat.t_sgcr,
        sat.t_sgu, sat.t_sg0g, sat.t_krw_mx, sat.t_kro_mx, sat.t_krg_mx,
        sat.swco)]))
    nb = (list(oil.usat_nb) if oil.usat_nb is not None
          else [oil.p_sat.shape[1]] * oil.p_sat.shape[0])
    meta[35:35 + len(nb)] = nb
    if wet:
        npl = list(gas.usat_np)
        meta[43:43 + len(npl)] = npl
    tab = np.concatenate(parts).astype(np.float32)
    return tab, meta


def _device_tables(fs, device):
    key = (id(fs.rho_surf), str(device))
    hit = _TABLE_CACHE.get(key)
    if hit is None or hit[0] is not fs.rho_surf:
        if len(_TABLE_CACHE) > 16:
            _TABLE_CACHE.clear()
        tab, meta = pack_tables(fs)
        hit = (fs.rho_surf, torch.as_tensor(tab, device=device),
               torch.as_tensor(meta, device=device))
        _TABLE_CACHE[key] = hit
    return hit[1], hit[2]


def cellpack_cuda(fs, cells, u, flag, dims):
    """(q, dq) float32 planes from the CUDA kernel."""
    nz, ny, nx = dims
    n = nz * ny * nx
    dev = u.device
    if u.shape != (n, 3):
        raise ValueError(f"u must be [{n},3], got {tuple(u.shape)}")
    require_support(fs, cells)
    f32 = torch.float32
    u32 = u.to(f32).contiguous()
    flag32 = flag.to(torch.int32).contiguous()
    pv = cells.pore_vol_ref.to(f32).contiguous()
    mob = cells.mob_mult.to(f32).contiguous()
    regs = cells.regs.to(torch.int32).contiguous()
    eps = None if cells.eps is None else cells.eps.to(f32).contiguous()
    build.require_device(dev, u32, flag32, pv, mob, regs, eps)
    tab, meta = _device_tables(fs, dev)
    q = torch.empty((nz, NQ, ny, nx), dtype=f32, device=dev)
    dq = torch.empty((nz, NQ, 3, ny, nx), dtype=f32, device=dev)
    lib = build.lib("cellpack")
    if lib.opm_cellpack_meta_size() != META_SIZE:
        raise RuntimeError("csrc/cellpack.cu and ops/cellpack.py disagree on "
                           "the table meta layout")
    P = build.ptr
    err = lib.opm_cellpack(P(u32), P(flag32), P(pv), P(mob), P(regs), P(eps),
                           P(tab), P(meta), P(q), P(dq),
                           ctypes.c_longlong(n), ctypes.c_longlong(ny * nx),
                           build.stream_ptr(dev))
    ops.LAUNCHES["cellpack"] += 1
    build.check("cellpack", err, "cellpack launch")
    return q, dq


def cellpack(fs, cells, u, flag, dims):
    """K1 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if u.is_cuda:
        return cellpack_cuda(fs, cells, u, flag, dims)
    return cellpack_plain(fs, cells, u, flag, dims)
