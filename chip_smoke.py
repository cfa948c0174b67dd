"""GPU smoke run of the PyTorch/CUDA port (opm_autodiff_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and exits non-zero):
  1. environment: the card's name and power limit (nvidia-smi).
  2. build: every CUDA kernel, compiled from csrc/ (one nvcc per source,
     all in parallel; ptxas registers and spills per kernel).
  3. kernels: each kernel against its plain PyTorch version on the card,
     at the paths' shapes (SPE1 physics, 2-region + end-point scaling,
     wet gas; nb = 3 and 4 and grids with singleton axes; the CPR inner
     pressure solve on random, singleton-axis, 85-layer, SPE10-grid,
     zero-rhs and diagonal-only systems).
  4. SPE1CASE1 end to end through the kernels (z-line BiCGStab), held
     against the golden summary vectors tests/data/golden/SPE1CASE1.npz.
  4b. the same with banded CPR + FGMRES (--linear-solver cpr).
  5. SPE1 physics on the SPE10 model-2 grid (60 x 220 x 85 =
     1,122,000 cells) for two report steps: cell-updates/s, per-kernel
     launches per Newton iteration.
  5b. the same with banded CPR + FGMRES.
Then a torch.profiler breakdown of one Newton iteration of each SPE10
path, the per-kernel JSON line (CUDA-event times against the bound), the
nvidia-smi line and, last, the device line. Each path's launch counts are
reset just before it runs and read just after; a kernel of the path that
never launched fails the run. Exits non-zero without a GPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from opm_autodiff_tpu_torch import ops  # noqa: E402
from opm_autodiff_tpu_torch.ops import (build, cellpack, cprinner, flux,  # noqa: E402
                                        spmv, zline)
from opm_autodiff_tpu_torch.solvers.cpr import CPR_INNER_ITERS  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
SPE10_DIMS = (60, 220, 85)  # Christie & Blunt 2001 (SPE 72469), model 2
GOLDEN_VECTORS = ["FOPR", "FGPR", "FPR", "FGOR", "FWCT", "FOPT", "FGPT",
                  "WBHP:PROD", "WBHP:INJ", "WGIR:INJ"]

REPLACES = {
    "cellpack": ("opm_autodiff_tpu_torch/csrc/cellpack.cu",
                 "opm_autodiff_tpu/ops/pallas_cellpack.py:638"),
    "flux": ("opm_autodiff_tpu_torch/csrc/flux.cu",
             "opm_autodiff_tpu/ops/pallas_flux.py:199"),
    "spmv": ("opm_autodiff_tpu_torch/csrc/spmv.cu",
             "opm_autodiff_tpu/ops/pallas_spmv.py:141"),
    "zline_factor": ("opm_autodiff_tpu_torch/csrc/zline.cu",
                     "opm_autodiff_tpu/ops/pallas_zline.py:169"),
    "zline_apply": ("opm_autodiff_tpu_torch/csrc/zline.cu",
                    "opm_autodiff_tpu/ops/pallas_zline.py:188"),
    "cprinner": ("opm_autodiff_tpu_torch/csrc/cprinner.cu",
                 "opm_autodiff_tpu/ops/pallas_cprinner.py:169"),
}
# the kernels each path must launch
ZLINE_PATH = ("cellpack", "flux", "spmv", "zline_factor", "zline_apply")
CPR_PATH = ZLINE_PATH + ("cprinner",)


def emit(obj):
    print(json.dumps(obj), flush=True)


def nbytes(*ts):
    return sum(int(t.numel()) * t.element_size() for t in ts
               if t is not None)


def cuda_ms(fn, reps=20, warmup=3):
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event timings."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# problems
# ---------------------------------------------------------------------------

def spe1_problem(nx, ny, nz, dev):
    from opm_autodiff_tpu_torch.entry import build_problem

    return build_problem(nx, ny, nz, device=dev)


def perturbed(init, seed):
    """Off-equilibrium state (the residual is ~0 at equilibrium, where
    f32 noise would dominate any relative comparison)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    u = init.u.cpu().clone()
    n = u.shape[0]
    u[:, 0] *= 1.0 + 0.02 * torch.randn(n, generator=g, dtype=u.dtype)
    u[:, 1] = torch.clamp(u[:, 1] + 0.05 * torch.randn(
        n, generator=g, dtype=u.dtype), 0.05, 0.9)
    return u.to(init.u.device)


def two_region(fs):
    """Duplicate every bank; region 1 carries 1.25x viscosities."""
    def dup(a, fac=1.0):
        return torch.cat([a, a * fac], dim=0)

    sat = fs.sat._replace(**{f: dup(getattr(fs.sat, f)) for f in (
        "sw", "krw_tab", "krow_tab", "pcow_tab", "sg", "krg_tab",
        "krog_tab", "pcog_tab", "t_swl", "t_swcr", "t_swu", "t_sw0w",
        "t_sgcr", "t_sgu", "t_sg0g", "t_krw_mx", "t_kro_mx", "t_krg_mx",
        "swco")})
    o = fs.oil
    oil = o._replace(p_sat=dup(o.p_sat), rs_tab=dup(o.rs_tab),
                     inv_b_sat=dup(o.inv_b_sat), mu_sat=dup(o.mu_sat, 1.25),
                     slope_inv_b=dup(o.slope_inv_b),
                     slope_mu=dup(o.slope_mu, 1.25), usat_p=dup(o.usat_p),
                     usat_inv_b=dup(o.usat_inv_b),
                     usat_mu=dup(o.usat_mu, 1.25),
                     inv_b_mu_sat=dup(o.inv_b_mu_sat, 1 / 1.25),
                     usat_inv_b_mu=dup(o.usat_inv_b_mu, 1 / 1.25),
                     usat_nb=tuple(o.usat_nb) * 2)
    g = fs.gas
    gas = g._replace(p=dup(g.p), inv_b_tab=dup(g.inv_b_tab),
                     mu_tab=dup(g.mu_tab, 1.25),
                     inv_b_mu_tab=dup(g.inv_b_mu_tab, 1 / 1.25))
    water = fs.water._replace(**{
        f: dup(getattr(fs.water, f), 1.25 if f == "mu_ref" else 1.0)
        for f in ("p_ref", "inv_b_ref", "comp", "mu_ref", "viscosibility")})
    rock = fs.rock._replace(p_ref=dup(fs.rock.p_ref), comp=dup(fs.rock.comp))
    return fs._replace(sat=sat, oil=oil, gas=gas, water=water, rock=rock,
                       rho_surf=dup(fs.rho_surf))


def random_eps(n, seed, dev):
    rng = np.random.default_rng(seed)
    eps = np.full((n, 12), np.nan)
    pick = rng.random(n) < 0.67
    m = int(pick.sum())
    for ch, lo, span in ((0, 0.10, 0.06), (1, 0.16, 0.08), (2, 0.92, 0.06),
                         (3, 0.75, 0.10), (4, 0.02, 0.05), (5, 0.80, 0.10),
                         (6, 0.70, 0.10), (7, 0.6, 0.4), (8, 0.7, 0.3),
                         (9, 0.6, 0.4), (10, 0.5, 1.0), (11, 0.5, 1.0)):
        eps[pick, ch] = lo + span * rng.random(m)
    return torch.as_tensor(eps, device=dev)


def wetgas_problem(dev):
    from opm_autodiff_tpu_torch.grid import build_geometry
    from opm_autodiff_tpu_torch.io.state import load_state
    from opm_autodiff_tpu_torch.models.blackoil import statics_from_geometry
    from opm_autodiff_tpu_torch.models.init import equilibrate
    from opm_autodiff_tpu_torch.props.fluid import FluidSystem
    from opm_autodiff_tpu_torch.utils.synthetic import wetgas_deck_text

    with tempfile.TemporaryDirectory() as tmp:
        p = os.path.join(tmp, "WG.DATA")
        with open(p, "w") as f:
            f.write(wetgas_deck_text())
        state = load_state(p)
    geo = build_geometry(state)
    fs_h = FluidSystem.from_state(state)
    cells, topo = statics_from_geometry(geo, dev)
    init = equilibrate(state, geo, fs_h)
    u = init.u.clone()
    flag = init.flag.clone()
    n = u.shape[0]
    rng = np.random.default_rng(3)
    # a mix of states: condensate (RV) cells and some flipped to SG
    flag[: n // 3] = 0
    u[: n // 3, 2] = torch.as_tensor(0.05 + 0.4 * rng.random(n // 3))
    u[:, 0] *= torch.as_tensor(1 + 0.031 * rng.standard_normal(n))
    u[:, 1] = torch.as_tensor(0.21 + 0.4 * rng.random(n))
    rv = flag == 2
    u[rv, 2] = torch.as_tensor(3.1e-5 + 1.4e-4 * rng.random(int(rv.sum())))
    return fs_h.to(dev), cells, topo, u.to(dev), flag.to(dev)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

# tolerances of the reference's own kernel tests, f32 kernel vs f64 plain:
# per-channel max|d|/scale of the pack values and of the assembly
# (tests/test_pallas_cellpack.py), allclose rtol of the matvec and of the
# z-line solve (tests/test_pallas_spmv.py, tests/test_pallas_zline.py)
PACK_Q_TOL = 2e-5
ASSEMBLY_TOL = 2e-3
KINK_FRACTION = 1e-4
SPMV_RTOL = 1e-5
ZLINE_RTOL = 2e-5


def _chan_err(got, ref, dims):
    """Per-channel max|got - ref| / max|ref| (the reference's kernel-test
    measure) and the max absolute difference."""
    d = (got.double() - ref).abs()
    rel = float((d.amax(dim=dims) / (ref.abs().amax(dim=dims) + 1e-30)).max())
    return rel, float(d.max())


def round32(x):
    """A NamedTuple tree (or tensor) with every float tensor rounded to
    float32 and back: the values the kernel actually reads."""
    if torch.is_tensor(x):
        return x.float().double() if x.is_floating_point() else x
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[round32(v) for v in x])
    return x


def check_pack(fs, cells, u, flag, dims):
    """K1 against its plain version on the same inputs: the plain version
    (float64 arithmetic) reads the float32 values the kernel reads — the
    state and every table node — so both evaluate the same piecewise-
    linear functions. Values must agree in every cell. Derivatives must
    agree in every cell but those where a kink of the property chain
    (a table node, min(Rs, RsSat(p)), max(kr, 0)) lies within float32
    rounding of a derived quantity: there the two sides legitimately take
    different one-sided derivatives. Such cells are counted and must stay
    below KINK_FRACTION of the cells. Returns (q, dq, errors, max_abs)."""
    q, dq = cellpack.cellpack_cuda(fs, cells, u, flag, dims)
    qr, dqr = cellpack.cellpack_plain(round32(fs), round32(cells),
                                      round32(u), flag, dims)
    torch.cuda.synchronize()
    eq, aq = _chan_err(q, qr, (0, 2, 3))
    # per-cell derivative error against the per-channel scale
    sd = dqr.abs().amax(dim=(0, 2, 3, 4), keepdim=True) + 1e-30
    cell_err = ((dq.double() - dqr).abs() / sd).amax(dim=(1, 2))
    bad = cell_err > ASSEMBLY_TOL
    n_bad = int(bad.sum())
    ok_err = float(torch.where(bad, torch.zeros_like(cell_err),
                               cell_err).max())
    ad = float(torch.where(bad[:, None, None], torch.zeros_like(dq.double()),
                           (dq.double() - dqr).abs()).max())
    worst = {}
    if n_bad:
        d = ((dq.double() - dqr).abs() / sd)          # [nz,17,3,ny,nx]
        k, ch, t, j, i = np.unravel_index(int(d.argmax()), tuple(d.shape))
        c = (k * dims[1] + j) * dims[2] + i
        worst = {"channel": int(ch), "tangent": int(t), "cell": int(c),
                 "flag": int(flag[c]), "u": [float(x) for x in u[c]],
                 "err": float(d.max())}
    return q, dq, {"q": eq, "dq": ok_err, "kink_cells": n_bad,
                   "kink_fraction": n_bad / float(cell_err.numel()),
                   "worst_kink": worst}, max(aq, ad)


def check_flux(q, dq, acc0, topo, dt):
    """K2 on the kernel's own planes against its plain version (float64
    on the same float32 planes). Returns (rel, max_abs)."""
    out = flux.flux_bands_cuda(q, dq, acc0, topo, dt)
    ref = flux.flux_bands_plain(q.double(), dq.double(), acc0.double(),
                                topo, dt)
    torch.cuda.synchronize()
    rel, mabs = _chan_err(out[0], ref[0], (0,))
    dscale = ref[1].abs().max() + 1e-30
    for a, b in zip(out[1:], ref[1:]):
        if b.numel():
            d = (a.double() - b).abs().max()
            rel = max(rel, float(d / dscale))
            mabs = max(mabs, float(d))
    return rel, mabs


def allclose_ratio(got, ref, rtol, atol_frac):
    """max |got-ref| / (atol + rtol |ref|) with atol = atol_frac max|ref|
    (np.testing.assert_allclose passes when this is <= 1)."""
    got = got.double()
    ref = ref.double()
    atol = atol_frac * float(ref.abs().max())
    r = (got - ref).abs() / (atol + rtol * ref.abs() + 1e-300)
    return float(r.max()), float((got - ref).abs().max())


def random_system(dims, nb, seed, dev):
    """Diagonally dominant random banded system in float32."""
    from opm_autodiff_tpu_torch.models.structured import StructuredSystem

    nx, ny, nz = dims
    n = nx * ny * nz
    g = torch.Generator(device="cpu").manual_seed(seed)

    def rnd(*s):
        return (torch.randn(*s, generator=g) * 0.1).to(dev)

    diag = rnd(n, nb, nb) + 4.0 * torch.eye(nb, device=dev)
    return StructuredSystem(
        residual=rnd(n, nb), diag=diag,
        x_lr=rnd(nz, ny, nx - 1, nb, nb), x_rl=rnd(nz, ny, nx - 1, nb, nb),
        y_lr=rnd(nz, ny - 1, nx, nb, nb), y_rl=rnd(nz, ny - 1, nx, nb, nb),
        z_lr=rnd(nz - 1, ny, nx, nb, nb), z_rl=rnd(nz - 1, ny, nx, nb, nb))


def f64(sys):
    return sys._replace(**{k: getattr(sys, k).double() for k in (
        "residual", "diag", "x_lr", "x_rl", "y_lr", "y_rl", "z_lr",
        "z_rl")})


def check_linear(sys32, seed):
    """K3 and K4 (factor + apply) against the plain versions in f64 on
    the same float32 system."""
    dev = sys32.diag.device
    nb = sys32.diag.shape[-1]
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(sys32.num_cells, nb, generator=g).to(dev)
    y = spmv.banded_spmv_cuda(sys32, x)
    y_ref = spmv.banded_spmv_plain(f64(sys32), x.double())
    fact = zline.build_zline_cuda(sys32)
    z = zline.zline_apply_cuda(fact, x)
    z_ref = zline.zline_apply_plain(zline.build_zline_plain(f64(sys32)),
                                    x.double())
    torch.cuda.synchronize()
    return (allclose_ratio(y, y_ref, SPMV_RTOL, 1e-6),
            allclose_ratio(z, z_ref, ZLINE_RTOL, 1e-5))


def equilibrated32(sys):
    """(scaled float32 system, row, col) as solve_linear builds them."""
    from opm_autodiff_tpu_torch.solvers.linear import equilibrate

    s32 = sys._replace(**{k: getattr(sys, k).float() for k in (
        "residual", "diag", "x_lr", "x_rl", "y_lr", "y_rl", "z_lr",
        "z_rl")})
    return equilibrate(s32, torch.float32)


# K5 against its plain version: in max-abs norms, on the same float32
# inputs, |K5_f32 - plain_f64| <= limit with
#   limit = min(max(CPR_F32_FACTOR |plain_f32 - plain_f64|,
#                   CPR_FLOOR max|plain_f64|),
#               CPR_CAP max|plain_f64|).
# The kernel may cost at most 4x what float32 arithmetic costs the plain
# version itself (a fixed-iteration Krylov solve amplifies rounding
# differently in each summation order), or 1e-5 of the answer's scale;
# the cap bounds that by the answer's size. On the SPE1-grid pressure
# system 12 iterations amplify float32 rounding to about 2 % of max|x| in
# the plain version alone (BiCGStab nears a breakdown at iteration 6), so
# the cap is 5 %; the real pressure systems are also checked after 2
# iterations, before the amplification, where the floor sets the limit.
# Both versions must be finite.
CPR_F32_FACTOR = 4.0
CPR_FLOOR = 1e-5
CPR_CAP = 0.05
CPR_SHORT_ITERS = 2
# per cell and inner iteration: two 7-point matvecs (13 each), four dot
# products (2 each), the p, s, x and r updates (4 + 2 + 4 + 2) and the two
# Jacobi scalings
CPR_FLOPS_PER_CELL_ITER = 50
_PFIELDS = ("p_diag", "px_lr", "px_rl", "py_lr", "py_rl", "pz_lr", "pz_rl")


def random_pressure(dims, seed, dev, diag_only=False):
    """Diagonally dominant scalar 7-point system (float32); diag_only:
    zero bands and a power-of-two diagonal, so the residual is exactly
    zero after one iteration and every breakdown guard fires."""
    from opm_autodiff_tpu_torch.solvers.cpr import CprBandedData

    nx, ny, nz = dims
    g = torch.Generator(device="cpu").manual_seed(seed)

    def band(*s):
        a = -(0.1 + 0.9 * torch.rand(*s, generator=g))
        return (a * (0.0 if diag_only else 1.0)).to(dev)

    d = 6.0 + 2.0 * torch.rand(nz, ny, nx, generator=g)
    if diag_only:
        d = 2.0 ** torch.randint(1, 4, (nz, ny, nx), generator=g).float()
    return CprBandedData(
        weights=None, p_diag=d.to(dev), px_lr=band(nz, ny, nx - 1),
        px_rl=band(nz, ny, nx - 1), py_lr=band(nz, ny - 1, nx),
        py_rl=band(nz, ny - 1, nx), pz_lr=band(nz - 1, ny, nx),
        pz_rl=band(nz - 1, ny, nx))


def cpr_pressure(sys):
    """The CPR pressure system of ``sys`` and the pressure-stage rhs of
    the first FGMRES step, as solve_linear builds them (quasi-IMPES)."""
    from opm_autodiff_tpu_torch.solvers.cpr import build_cpr_banded

    scaled, row, col = equilibrated32(sys)
    c = build_cpr_banded(scaled, col_p=col[:, 0])
    b = -sys.residual.float() * row
    r = b / torch.linalg.vector_norm(b)
    rp = (c.weights * r).sum(-1).reshape(c.p_diag.shape) * c.gamma
    return c, rp.contiguous()


def check_cprinner(c32, b3, iters=CPR_INNER_ITERS):
    """K5 against its plain version (float64 and float32) on the same
    float32 inputs. Returns the ratio to the limit, the max abs error, the
    limit and the term that set it, |plain_f32 - plain_f64| and
    max|plain_f64|."""
    x = cprinner.inner_solve_bands_cuda(c32, b3, iters)
    c64 = c32._replace(**{f: getattr(c32, f).double() for f in _PFIELDS})
    ref64 = cprinner.inner_solve_bands_plain(c64, b3.double(), iters)
    ref32 = cprinner.inner_solve_bands_plain(c32, b3, iters)
    torch.cuda.synchronize()
    err = float((x.double() - ref64).abs().max())
    e32 = float((ref32.double() - ref64).abs().max())
    scale = float(ref64.abs().max())
    terms = {"f32": CPR_F32_FACTOR * e32, "floor": CPR_FLOOR * scale}
    by = max(terms, key=terms.get)
    limit = terms[by]
    if CPR_CAP * scale < limit:
        by, limit = "cap", CPR_CAP * scale
    out = {"iters": iters, "max_abs": err, "e32": e32, "max_ref": scale,
           "limit": limit, "limit_by": by}
    finite = bool(torch.isfinite(x).all()) and bool(
        torch.isfinite(ref64).all())
    if not finite:
        out["ratio"] = float("inf")
    elif limit == 0.0:
        out["ratio"] = 0.0 if err == 0.0 else float("inf")
    else:
        out["ratio"] = err / limit
    return out


def phase_kernels(dev):
    """Every kernel against its plain version; returns the per-kernel
    (worst ratio to its limit, max abs error)."""
    from opm_autodiff_tpu_torch.models.blackoil import PrimaryState
    from opm_autodiff_tpu_torch.models.structured import assemble_structured

    ratio = {k: 0.0 for k in REPLACES}
    mabs = {k: 0.0 for k in REPLACES}
    cases = []
    dt = 86400.0

    def note(name, r, a):
        ratio[name] = max(ratio[name], r)
        mabs[name] = max(mabs[name], a)

    def pack_case(label, fs, cells, u, flag, dims, acc0, topo):
        q, dq, e, a = check_pack(fs, cells, u, flag, dims)
        note("cellpack", max(e["q"] / PACK_Q_TOL, e["dq"] / ASSEMBLY_TOL,
                             e["kink_fraction"] / KINK_FRACTION), a)
        ef, af = check_flux(q, dq, acc0, topo, dt)
        note("flux", ef / ASSEMBLY_TOL, af)
        cases.append({"case": label, "cellpack_q": e["q"],
                      "cellpack_dq": e["dq"],
                      "cellpack_kink_cells": e["kink_cells"],
                      "cellpack_worst_kink": e["worst_kink"], "flux": ef})

    def lin_case(label, sys32, seed):
        (r3, a3), (r4, a4) = check_linear(sys32, seed)
        note("spmv", r3, a3)
        note("zline_apply", r4, a4)
        cases.append({"case": label, "spmv_ratio": r3, "zline_ratio": r4})

    def cpr_case(label, c32, b3, iters=CPR_INNER_ITERS):
        out = check_cprinner(c32, b3, iters)
        note("cprinner", out["ratio"], out["max_abs"])
        cases.append({"case": label,
                      **{f"cprinner_{k}": v for k, v in out.items()}})

    # SPE1 physics on the SPE1CASE1 grid and on the SPE10 model-2 grid
    for dims in ((10, 10, 3), SPE10_DIMS):
        (_s, _g, fs, cells, topo, init, _ws, acc0, _p) = spe1_problem(
            *dims, dev)
        u = perturbed(init, 2)
        shape = (dims[2], dims[1], dims[0])
        pack_case(f"spe1 {dims}", fs, cells, u, init.flag, shape, acc0, topo)
        if dims == (10, 10, 3):
            n = init.u.shape[0]
            g = torch.Generator(device="cpu").manual_seed(5)
            regs = torch.randint(0, 2, (n, 2), generator=g,
                                 dtype=torch.int32).to(dev)
            cells2 = cells._replace(regs=regs, eps=random_eps(n, 9, dev))
            pack_case("2-region + EPS", two_region(fs), cells2,
                      perturbed(init, 3), init.flag, shape, acc0, topo)
        # K3/K4 on the equilibrated float32 assembled system (nb = 3)
        sys, _ = assemble_structured(fs, cells, topo,
                                     PrimaryState(u, init.flag), acc0, dt)
        lin_case(f"linear nb=3 {dims}", equilibrated32(sys)[0], 7)
        # K5 on this grid's CPR pressure system, before and after the
        # rounding amplification
        c32, rp = cpr_pressure(sys)
        for iters in (CPR_SHORT_ITERS, CPR_INNER_ITERS):
            cpr_case(f"cpr pressure {dims} iters={iters}", c32, rp, iters)
        del sys, c32, rp
    # wet gas (PVTG 2-D table, Rv state) on a flat [1,1,n] plane
    fsw, cw, tw, uw, flw = wetgas_problem(dev)
    n = uw.shape[0]
    qw, _ = cellpack.cellpack_plain(fsw, cw, uw, flw, (1, 1, n))
    accw = qw[0, 14:17, 0, :].T * 0.999
    pack_case("wet gas", fsw, cw, uw, flw, (1, 1, n), accw, tw)
    # nb = 4 and grids with singleton axes
    for dims, nb in (((6, 5, 7), 4), ((4, 1, 3), 3), ((1, 1, 5), 4),
                     ((5, 4, 1), 3)):
        lin_case(f"linear nb={nb} {dims}", random_system(dims, nb, 11, dev),
                 13)
    # K5 on random systems: singleton axes, 85-layer columns, b = 0, and
    # a diagonal-only system where the breakdown guards fire
    g = torch.Generator(device="cpu").manual_seed(17)
    for dims, iters in (((8, 6, 4), 6), ((8, 6, 4), 12), ((1, 1, 5), 12),
                        ((5, 4, 1), 12), ((1, 1, 85), 12),
                        ((6, 5, 85), 12)):
        b3 = torch.randn(dims[::-1], generator=g).to(dev)
        cpr_case(f"cpr random {dims} iters={iters}",
                 random_pressure(dims, 19, dev), b3, iters)
    cpr_case("cpr b=0 (8, 6, 4)", random_pressure((8, 6, 4), 23, dev),
             torch.zeros(4, 6, 8, device=dev))
    cpr_case("cpr diagonal-only (8, 6, 4)",
             random_pressure((8, 6, 4), 29, dev, diag_only=True),
             torch.randn(4, 6, 8, generator=g).to(dev))
    ratio["zline_factor"] = ratio["zline_apply"]
    mabs["zline_factor"] = mabs["zline_apply"]
    emit({"phase": "kernels", "cases": cases,
          "worst_ratio_to_limit": ratio, "max_abs_err": mabs,
          "limits": {"cellpack_q": PACK_Q_TOL, "cellpack_dq": ASSEMBLY_TOL,
                     "cellpack_kink_fraction": KINK_FRACTION,
                     "flux": ASSEMBLY_TOL, "spmv_rtol": SPMV_RTOL,
                     "zline_rtol": ZLINE_RTOL,
                     "cprinner": f"max-abs |K5 - plain_f64| <= max("
                                 f"{CPR_F32_FACTOR} |plain_f32 - plain_f64|,"
                                 f" {CPR_FLOOR} max|plain_f64|), capped at "
                                 f"{CPR_CAP} max|plain_f64|"}})
    bad = {k: v for k, v in ratio.items() if not v < 1.0}
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions "
                             f"(ratio to limit): {bad}")
    return mabs


# ---------------------------------------------------------------------------
# phase 4: SPE1CASE1 against the golden vectors
# ---------------------------------------------------------------------------

# the golden tolerance (tests/golden_util.py) holds step by step while the
# two runs take the same linear/Newton iteration counts; float32 rounding
# in the Krylov solve changes a count after a few report steps (on the
# CPU, against the reference package: first at report step 5), after
# which the trajectories differ by the time-discretization error. So:
# the golden tolerance over the first GOLDEN_STRICT_STEPS report steps,
# the reference's own SPE1 physics checks (tests/test_spe1.py) over the
# whole run, and the whole run within GOLDEN_ENVELOPE (relative, above
# the golden absolute tolerance) of the golden vectors — 2.5x the spread
# measured between the reference package and the port's CPU path (2.0%,
# FGPR at gas breakthrough), recorded in PERF.md.
GOLDEN_STRICT_STEPS = 5
GOLDEN_ENVELOPE = 5e-2
# The golden vectors come from the z-line path. CPR converges each linear
# solve to the same 1e-2 reduction along another Krylov path, so its
# Newton iterates differ within the nonlinear tolerance from the first
# report step on (the port's CPU path holds the golden tolerance through
# report step 7 with CPR, WBHP:PROD at 0.96 of it in step 3): the golden
# tolerance is checked over report step 1 only, the envelope and the
# physics checks over the whole run, and the leading steps that hold the
# golden tolerance are reported.
GOLDEN_STRICT_STEPS_CPR = 1


def sim_options(precond):
    import dataclasses

    from opm_autodiff_tpu_torch.simulator import SimulatorOptions
    from opm_autodiff_tpu_torch.solvers.newton import NewtonParams

    return SimulatorOptions(newton=dataclasses.replace(
        NewtonParams(), linear_precond=precond))


def phase_spe1case1(dev, precond="zline"):
    from opm_autodiff_tpu_torch.io.state import load_state
    from opm_autodiff_tpu_torch.models.blackoil import accumulation
    from opm_autodiff_tpu_torch.models.init import equilibrate
    from opm_autodiff_tpu_torch.simulator import Simulator

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sim = Simulator(load_state(os.path.join(ROOT, "tests", "data",
                                            "SPE1CASE1.DATA")),
                    sim_options(precond), device=dev)
    sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    with np.load(os.path.join(ROOT, "tests", "data", "golden",
                              "SPE1CASE1.npz")) as z:
        gold = {k: z[k] for k in z.files}
    cur = {v: np.asarray(sim.summary.series(v), float)
           for v in ["TIME"] + GOLDEN_VECTORS}
    msgs = []
    strict, rel = {}, {}
    k = GOLDEN_STRICT_STEPS if precond == "zline" else GOLDEN_STRICT_STEPS_CPR
    if not np.array_equal(cur["TIME"], gold["TIME"]):
        msgs.append(f"report times differ: {len(cur['TIME'])} rows")
    else:
        for v in GOLDEN_VECTORS:
            a, b = gold[v], cur[v]
            scale = np.maximum(np.abs(a), np.abs(b))
            ratio = np.abs(a - b) / (2e-2 + 1e-5 * scale)
            # relative deviation with the golden absolute floor (water cut
            # sits at ~1e-7, where a relative measure means nothing)
            r = np.maximum(np.abs(a - b) - 2e-2, 0.0) / np.maximum(scale,
                                                                  1e-300)
            strict[v] = float(ratio[:k].max())
            rel[v] = {"max": float(r.max()), "at_step": int(r.argmax()),
                      "first_step_over_golden_tol":
                          int(np.argmax(ratio > 1)) if (ratio > 1).any()
                          else None}
            if not np.all(np.isfinite(b)):
                msgs.append(f"{v}: non-finite values")
            if strict[v] > 1.0:
                msgs.append(f"{v}: {strict[v]:.3g}x the golden tolerance "
                            f"within the first {k} report steps")
            if r.max() > GOLDEN_ENVELOPE:
                msgs.append(f"{v}: {r.max():.3g} relative deviation at "
                            f"step {int(r.argmax())} > {GOLDEN_ENVELOPE}")
    # the reference's SPE1 physics checks (tests/test_spe1.py)
    t, fopr, fgor = cur["TIME"], cur["FOPR"], cur["FGOR"]
    fpr = cur["FPR"]
    ipk = int(np.argmax(fpr))
    wgir = cur["WGIR:INJ"]
    bhp = cur["WBHP:PROD"]
    phys = {
        "plateau": bool(abs(fopr[0] - 20000) <= 20000 * 1e-6
                        and abs(fgor[0] - 1.27) <= 1.27e-3
                        and abs(wgir[0] - 100000) <= 0.1),
        "buildup": bool(800 < t[ipk] < 2200 and fpr[ipk] > 6000
                        and fpr[-1] < 4500),
        "breakthrough": bool((fgor[t < 700] < 1.5).all() and fgor[-1] > 10),
        "bhp_floor": bool(abs(bhp[-1] - 1000) <= 0.1 and fopr[-1] < 15000),
    }
    init = equilibrate(sim.state, sim.geo, sim.fs)
    acc_init = accumulation(sim.fs, init.u.to(dev), init.flag.to(dev),
                            sim.cells.pore_vol_ref).cpu().numpy()
    acc_now = sim.acc0.cpu().numpy()
    dgas = (acc_now - acc_init)[:, 2].sum()
    doil = (acc_now - acc_init)[:, 1].sum()
    net_gas = sim.cum["FGIT"] - sim.cum["FGPT"]
    mb = {"gas": float(abs(dgas - net_gas) / abs(net_gas)),
          "oil": float(abs(-doil - sim.cum["FOPT"]) / sim.cum["FOPT"])}
    phys["material_balance"] = bool(mb["gas"] < 2e-3 and mb["oil"] < 2e-3)
    rep = sim.report
    phys["newton_efficiency"] = bool(
        rep.total_newton_iterations / rep.total_substeps < 8
        and rep.total_substeps < 200)
    msgs += [f"physics check failed: {k}" for k, ok in phys.items() if not ok]
    firsts = [v["first_step_over_golden_tol"] for v in rel.values()]
    held = min([f for f in firsts if f is not None], default=len(cur["TIME"]))
    emit({"phase": "spe1case1", "linear_solver": precond, "wall_s": wall,
          "report_steps": len(cur["TIME"]),
          "substeps": rep.total_substeps,
          "newton_iterations": rep.total_newton_iterations,
          "linear_iterations": rep.total_linear_iterations,
          "launches": launches,
          "golden_strict_steps": k,
          "report_steps_holding_golden_tol": held,
          "golden_ratio_first_steps": strict,
          "golden_relative_deviation": rel,
          "golden_envelope": GOLDEN_ENVELOPE,
          "physics": phys, "material_balance_rel": mb})
    if msgs:
        raise AssertionError("SPE1CASE1 against the golden vectors:\n  "
                             + "\n  ".join(msgs))
    missing = [k for k in path_kernels(precond) if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on SPE1CASE1 "
                             f"({precond}): {missing}")


# ---------------------------------------------------------------------------
# phase 5: the SPE10 model-2 grid
# ---------------------------------------------------------------------------

def path_kernels(precond):
    return CPR_PATH if precond in ("cpr", "cprt") else ZLINE_PATH


def phase_spe10(dev, precond="zline", tstep_days: str = "1 2"):
    from opm_autodiff_tpu_torch.io.state import load_state
    from opm_autodiff_tpu_torch.simulator import Simulator
    from opm_autodiff_tpu_torch.utils.synthetic import write_spe1_deck

    nx, ny, nz = SPE10_DIMS
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = write_spe1_deck(os.path.join(tmp, "SPE10.DATA"), nx, ny, nz,
                               tstep_days=tstep_days)
        state = load_state(path)
    sim = Simulator(state, sim_options(precond), device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(ops.LAUNCHES)
    rep = sim.report
    n = nx * ny * nz
    newton = sim.newton_executed
    u = sim.u
    ok = bool(torch.isfinite(u).all()) and u.shape == (n, 3)
    row = sim.summary.rows[-1]
    out = {"phase": "spe10_grid", "linear_solver": precond, "cells": n,
           "dims": list(SPE10_DIMS),
           "report_steps": len(sim.summary.rows), "setup_s": setup_s,
           "wall_s": wall, "substeps": rep.total_substeps,
           "newton_iterations_accepted": rep.total_newton_iterations,
           "newton_iterations_executed": newton,
           "linear_iterations_accepted": rep.total_linear_iterations,
           "linear_iterations_per_accepted_newton":
               rep.total_linear_iterations
               / max(rep.total_newton_iterations, 1),
           # bench.py's definition: cells x Newton iterations / wall time,
           # every executed iteration being one full pipeline
           "cell_updates_per_s": n * newton / wall if wall > 0 else 0.0,
           "launches": launches,
           "launches_per_newton": {k: v / max(newton, 1)
                                   for k, v in launches.items()},
           "FPR": row.get("FPR"), "FOPR": row.get("FOPR"),
           "finite": ok,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
    emit(out)
    if not ok or len(sim.summary.rows) < 2:
        raise AssertionError("SPE10-grid run produced a bad state")
    missing = [k for k in path_kernels(precond) if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the SPE10-grid "
                             f"{precond} path: {missing}")
    return sim, out


KERNEL_SYMBOLS = {"cellpack": "cellpack_kernel", "flux": "flux_kernel",
                  "spmv": "spmv_kernel", "zline_factor": "factor_kernel",
                  "zline_apply": "apply_kernel",
                  "cprinner": "cprinner_kernel"}


def phase_profile(sim, iters: int = 2):
    """Where the time of a Newton iteration goes at the SPE10-grid shapes:
    torch.profiler over ``iters`` full Newton iterations from the run's
    final state (after one warm-up): device time per kernel, all other
    device work, and the device's idle share of the window's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from opm_autodiff_tpu_torch.solvers.newton import (NewtonState,
                                                       newton_iteration)
    from opm_autodiff_tpu_torch.wells import build_wellset
    from opm_autodiff_tpu_torch.wells.standard import connection_densities

    save = dict(ops.LAUNCHES)
    dev = sim.device
    ws = build_wellset(sim.geo, sim.state.schedule.steps[-1].wells,
                       device=dev)
    st = NewtonState(sim.u, sim.flag, sim.pbh, sim.active_mode, sim.xw)
    rho = connection_densities(sim.fs, sim.u, sim.flag, ws, sim.cells.regs)
    params = sim.opts.newton
    dt = 86400.0

    def run():
        return newton_iteration(params, sim.fs, sim.cells, sim.topo, st, ws,
                                sim.acc0, dt, 1.0, rho, None, None)

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            _st, info, _q = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops.LAUNCHES.update(save)
    per_kernel = {k: 0.0 for k in KERNEL_SYMBOLS}
    busy = 0.0
    for evt in prof.key_averages():
        t = float(getattr(evt, "self_device_time_total", 0.0)) / 1e3  # ms
        if t <= 0.0:
            continue
        busy += t
        for k, sym in KERNEL_SYMBOLS.items():
            if sym in evt.key:
                per_kernel[k] += t
    ms_iter = wall * 1e3 / iters
    out = {"phase": "profile", "linear_solver": params.linear_precond,
           "newton_iterations": iters,
           "linear_iterations_per_newton": int(info.linear_iters),
           "wall_ms_per_newton": ms_iter,
           "device_busy_ms_per_newton": busy / iters,
           "device_idle_share": max(0.0, 1.0 - busy / (wall * 1e3)),
           "kernel_ms_per_newton": {k: v / iters
                                    for k, v in per_kernel.items()},
           "other_device_ms_per_newton":
               (busy - sum(per_kernel.values())) / iters}
    if busy <= 0.0:
        # the profiler traced no device activity: nothing to report
        out.update(device_busy_ms_per_newton=None, device_idle_share=None,
                   kernel_ms_per_newton=None, other_device_ms_per_newton=None)
    emit(out)
    return out


def kernel_timings(sim, cpr_sim, outs, errs):
    """CUDA-event times of each kernel and its plain version at the paths'
    shapes (the SPE10-grid runs' final states), with the bound. The
    launches are those of the CPR path's SPE10-grid run, which launches
    every kernel (the z-line path's beside them)."""
    from opm_autodiff_tpu_torch.models.blackoil import PrimaryState
    from opm_autodiff_tpu_torch.models.structured import assemble_structured

    fs, cells, topo = sim.fs, sim.cells, sim.topo
    nx, ny, nz = topo.dims
    dims = (nz, ny, nx)
    u, flag, acc0 = sim.u, sim.flag, sim.acc0
    dt = 86400.0
    n = nx * ny * nz
    res = {}
    save = dict(ops.LAUNCHES)

    q, dq = cellpack.cellpack_cuda(fs, cells, u, flag, dims)
    u32 = u.float()
    k1_in = nbytes(u32, flag.int(), cells.pore_vol_ref.float(),
                   cells.mob_mult.float(), cells.regs)
    res["cellpack"] = dict(
        ms=cuda_ms(lambda: cellpack.cellpack_cuda(fs, cells, u, flag, dims)),
        plain_ms=cuda_ms(lambda: cellpack.cellpack_plain(
            fs, cells, u, flag, dims), reps=3, warmup=1),
        bytes=k1_in + nbytes(q, dq), flops=2000 * n, library_ms=None)
    out = flux.flux_bands_cuda(q, dq, acc0, topo, dt)
    topo_b = nbytes(*[a.float() for a in topo])
    res["flux"] = dict(
        ms=cuda_ms(lambda: flux.flux_bands_cuda(q, dq, acc0, topo, dt)),
        plain_ms=cuda_ms(lambda: flux.flux_bands_plain(q, dq, acc0.float(),
                                                       topo, dt),
                         reps=5, warmup=1),
        bytes=nbytes(q, dq, acc0.float()) + topo_b + nbytes(*out),
        flops=6 * 400 * n, library_ms=None)
    sys, _ = assemble_structured(fs, cells, topo, PrimaryState(u, flag),
                                 acc0, dt, out_dtype=torch.float32)
    s32 = equilibrated32(sys)[0]
    x = torch.randn(n, 3, device=u.device)
    mat = nbytes(s32.diag, s32.x_lr, s32.x_rl, s32.y_lr, s32.y_rl,
                 s32.z_lr, s32.z_rl)
    # the library yardstick: one cuSPARSE CSR matvec of the same matrix
    csr = banded_to_csr(s32)
    res["spmv"] = dict(
        ms=cuda_ms(lambda: spmv.banded_spmv_cuda(s32, x)),
        plain_ms=cuda_ms(lambda: spmv.banded_spmv_plain(s32, x)),
        bytes=mat + 2 * nbytes(x), flops=2 * 7 * 9 * n,
        library_ms=cuda_ms(lambda: torch.mv(csr, x.reshape(-1))))
    del csr
    fact = zline.build_zline_cuda(s32)
    res["zline_factor"] = dict(
        ms=cuda_ms(lambda: zline.build_zline_cuda(s32)),
        plain_ms=cuda_ms(lambda: zline.build_zline_plain(s32), reps=3,
                         warmup=1),
        bytes=nbytes(s32.diag, s32.z_lr, s32.z_rl) + nbytes(fact[0],
                                                          fact[1]),
        flops=(27 * 2 * 2 + 40) * n, library_ms=None)
    res["zline_apply"] = dict(
        ms=cuda_ms(lambda: zline.zline_apply_cuda(fact, x)),
        plain_ms=cuda_ms(lambda: zline.zline_apply_plain(fact, x), reps=3,
                         warmup=1),
        bytes=nbytes(fact[0], fact[1], s32.z_rl) + 2 * nbytes(x),
        flops=3 * 18 * n, library_ms=None)
    del sys, s32, fact, q, dq, out
    # K5 on the CPR pressure system at the CPR run's final state, checked
    # against its plain version once more before it is timed
    sys, _ = assemble_structured(
        cpr_sim.fs, cpr_sim.cells, cpr_sim.topo,
        PrimaryState(cpr_sim.u, cpr_sim.flag), cpr_sim.acc0, dt,
        out_dtype=torch.float32)
    c32, rp = cpr_pressure(sys)
    del sys
    chk = check_cprinner(c32, rp)
    emit({"phase": "cprinner_spe10_cpr_state", **chk})
    if not chk["ratio"] < 1.0:
        raise AssertionError(f"K5 disagrees with its plain version at the "
                             f"SPE10-grid CPR state: {chk}")
    errs["cprinner"] = max(errs["cprinner"], chk["max_abs"])
    res["cprinner"] = dict(
        ms=cuda_ms(lambda: cprinner.inner_solve_bands_cuda(
            c32, rp, CPR_INNER_ITERS)),
        plain_ms=cuda_ms(lambda: cprinner.inner_solve_bands_plain(
            c32, rp, CPR_INNER_ITERS), reps=5, warmup=1),
        # each input read once, the output written once; the iterations'
        # own traffic (~39 floats per cell and iteration) is the kernel's
        # business, not the function's
        bytes=nbytes(*[getattr(c32, f) for f in _PFIELDS], rp)
        + nbytes(rp),
        flops=CPR_FLOPS_PER_CELL_ITER * CPR_INNER_ITERS * n,
        library_ms=None)
    ops.LAUNCHES.update(save)   # timing launches are not main-path launches
    launches = outs["cpr"]["launches"]
    newton = outs["cpr"]["newton_iterations_executed"]
    lz = outs["zline"]["launches"]
    nz_newton = outs["zline"]["newton_iterations_executed"]
    rows = []
    for name, r in res.items():
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["flops"] / F32_FLOPS * 1e3
        src, rep = REPLACES[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches[name],
                     "launches_per_newton": launches[name] / max(newton, 1),
                     "launches_zline_path": lz[name],
                     "launches_per_newton_zline_path":
                         lz[name] / max(nz_newton, 1),
                     "max_abs_err": errs[name], "ms": r["ms"],
                     "plain_ms": r["plain_ms"],
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "library_ms": r["library_ms"]})
    return rows


def banded_to_csr(s32):
    """The banded system as a torch CSR matrix (for the library timing)."""
    nz, ny, nx = s32.grid
    n = nz * ny * nx
    nb = s32.diag.shape[-1]
    dev = s32.diag.device
    cid = torch.arange(n, device=dev).reshape(nz, ny, nx)
    rows_l, cols_l, vals_l = [], [], []

    def add(r, c, blocks):
        r = r.reshape(-1)
        c = c.reshape(-1)
        b = blocks.reshape(-1, nb, nb)
        ii = torch.arange(nb, device=dev)
        rr = (r[:, None, None] * nb + ii[None, :, None]).expand(-1, nb, nb)
        cc = (c[:, None, None] * nb + ii[None, None, :]).expand(-1, nb, nb)
        rows_l.append(rr.reshape(-1))
        cols_l.append(cc.reshape(-1))
        vals_l.append(b.reshape(-1))

    add(cid, cid, s32.diag)
    add(cid[:, :, :-1], cid[:, :, 1:], s32.x_lr)
    add(cid[:, :, 1:], cid[:, :, :-1], s32.x_rl)
    add(cid[:, :-1], cid[:, 1:], s32.y_lr)
    add(cid[:, 1:], cid[:, :-1], s32.y_rl)
    add(cid[:-1], cid[1:], s32.z_lr)
    add(cid[1:], cid[:-1], s32.z_rl)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # beta-state notices of torch.sparse
        coo = torch.sparse_coo_tensor(
            torch.stack([torch.cat(rows_l), torch.cat(cols_l)]),
            torch.cat(vals_l), (n * nb, n * nb)).coalesce()
        return coo.to_sparse_csr()


def ptxas_summary(log: str) -> dict:
    """{kernel: "N registers, S spill bytes"} from nvcc's -Xptxas=-v."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            for k in ("cellpack", "flux", "spmv", "factor", "apply",
                      "cprinner"):
                if k in name:
                    tmpl = re.search(r"ILi(\d)E", name)
                    name = k + (f"<{tmpl.group(1)}>" if tmpl else "")
                    break
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out.setdefault(name, {})["spill_store_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({"phase": "environment", "device": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device_count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    done = build.build_all()
    for k in build.KERNEL_SOURCES:
        build.lib(k)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": {k: v[0] for k, v in done.items()},
          "ptxas": {k: ptxas_summary(v[1]) for k, v in done.items()},
          "build_dir": build.BUILD_DIR})

    errs = phase_kernels(dev)
    phase_spe1case1(dev, "zline")
    phase_spe1case1(dev, "cpr")
    sim, out = phase_spe10(dev, "zline")
    phase_profile(sim)
    cpr_sim, cpr_out = phase_spe10(dev, "cpr")
    phase_profile(cpr_sim)
    rows = kernel_timings(sim, cpr_sim, {"zline": out, "cpr": cpr_out}, errs)
    emit({"kernels": rows, "card": smi})
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
