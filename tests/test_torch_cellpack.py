"""K1 (cellpack) and K2 (flux) of the PyTorch/CUDA port against the JAX
package, on the CPU.

The port's kernels run only on the card; on CPU tensors their wrappers
run the plain PyTorch versions, which are what is compared here:

* K1: ``vmap(jacfwd(pack_cell))`` against the reference's
  ``jax.vmap(jax.jacfwd(_pack_cell))`` on SPE1 physics, on a 2-region +
  end-point-scaled variant and on the wet-gas (PVTG) deck;
* K2 (with K1 before it): the port's banded assembly against the
  reference's ``assemble_structured`` XLA branch (its Pallas kernels are
  disabled on the CPU).

Both sides compute in float64 from identical inputs (the JAX problem
carried over with opm_autodiff_tpu_torch.interop). Tolerance: per
channel, max|port - ref| <= 1e-10 * max|ref| (rounding-level agreement;
an elementwise rtol is meaningless on channels that cross zero).
"""

import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-10


def _np_tree(x):
    """JAX pytree of NamedTuples -> nested dicts of numpy arrays."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {k: _np_tree(v) for k, v in x._asdict().items()}
    if x is None:
        return None
    if hasattr(x, "vals"):
        return list(x.vals)
    return np.asarray(x)


def _close(got, ref, axes, what):
    got = np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = np.abs(ref).max(axis=axes) + 1e-300
    err = (np.abs(got - ref).max(axis=axes) / scale).max()
    assert err <= RTOL, f"{what}: {err:.3e} > {RTOL}"


def _jax_problem(deck_path):
    from opm_autodiff_tpu.grid import build_geometry
    from opm_autodiff_tpu.io.state import load_state
    from opm_autodiff_tpu.models.blackoil import statics_from_geometry
    from opm_autodiff_tpu.models.init import equilibrate
    from opm_autodiff_tpu.props import FluidSystem

    state = load_state(deck_path)
    geo = build_geometry(state)
    fs = FluidSystem.from_state(state)
    cells, topo = statics_from_geometry(geo)
    init = equilibrate(state, geo, fs)
    return fs, cells, topo, init


def _two_region(fs):
    """Every bank duplicated; region 1 carries 1.25x viscosities."""
    import jax.numpy as jnp

    def dup(a, fac=1.0):
        return jnp.concatenate([a, a * fac], axis=0)

    sat = fs.sat._replace(**{f: dup(getattr(fs.sat, f)) for f in (
        "sw", "krw_tab", "krow_tab", "pcow_tab", "sg", "krg_tab",
        "krog_tab", "pcog_tab", "t_swl", "t_swcr", "t_swu", "t_sw0w",
        "t_sgcr", "t_sgu", "t_sg0g", "t_krw_mx", "t_kro_mx", "t_krg_mx",
        "swco")})
    o = fs.oil
    oil = o._replace(
        p_sat=dup(o.p_sat), rs_tab=dup(o.rs_tab), inv_b_sat=dup(o.inv_b_sat),
        mu_sat=dup(o.mu_sat, 1.25), slope_inv_b=dup(o.slope_inv_b),
        slope_mu=dup(o.slope_mu, 1.25), usat_p=dup(o.usat_p),
        usat_inv_b=dup(o.usat_inv_b), usat_mu=dup(o.usat_mu, 1.25),
        inv_b_mu_sat=dup(o.inv_b_mu_sat, 1 / 1.25),
        usat_inv_b_mu=dup(o.usat_inv_b_mu, 1 / 1.25),
        usat_nb=type(o.usat_nb)(o.usat_nb.vals * 2))
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


def _jax_pack(fs, cells, u, flag):
    import jax

    from opm_autodiff_tpu.models import structured as S

    def one_cell(uu, ff, pv, rg, mm, ep):
        def f(x):
            q = S._pack_cell(fs, x, ff, pv, rg, mm, ep)
            return q, q

        jac, val = jax.jacfwd(f, has_aux=True)(uu)
        return val, jac

    eps_ax = None if cells.eps is None else 0
    Q, dQ = jax.jit(jax.vmap(one_cell, in_axes=(0, 0, 0, 0, 0, eps_ax)))(
        u, flag, cells.pore_vol_ref, cells.regs, cells.mob_mult, cells.eps)
    return np.asarray(Q), np.asarray(dQ)


def _port_pack(fs, cells, u, flag):
    from opm_autodiff_tpu_torch import interop
    from opm_autodiff_tpu_torch.ops.cellpack import cellpack

    tfs = interop.fluid_from_arrays(_np_tree(fs))
    tcells = interop.cells_from_arrays(_np_tree(cells))
    st = interop.state_from_arrays(np.asarray(u), np.asarray(flag))
    n = st.u.shape[0]
    q, dq = cellpack(tfs, tcells, st.u, st.flag, (1, 1, n))
    return (q.reshape(17, n).T.numpy(),
            dq.reshape(17, 3, n).permute(2, 0, 1).numpy())


def _perturbed(u0, seed):
    rng = np.random.default_rng(seed)
    u = np.asarray(u0).copy()
    n = u.shape[0]
    u[:, 0] *= 1.0 + 0.02 * rng.standard_normal(n)
    u[:, 1] = np.clip(u[:, 1] + 0.05 * rng.standard_normal(n), 0.05, 0.9)
    return u


def test_cellpack_plain_matches_reference_pack(tmp_path):
    """K1's plain version vs the reference's vmap(jacfwd(_pack_cell)):
    SPE1 physics (perturbed state, one case at the equilibrium state's
    table nodes), 2 regions + end-point scaling, wet gas."""
    import jax.numpy as jnp
    import torch

    torch.set_num_threads(1)
    from opm_autodiff_tpu.utils.synthetic import write_spe1_deck
    from opm_autodiff_tpu_torch.utils.synthetic import wetgas_deck_text

    deck = write_spe1_deck(str(tmp_path / "S.DATA"), 4, 3, 3)
    fs, cells, _topo, init = _jax_problem(deck)
    n = init.u.shape[0]
    # the equilibrium state (cells exactly on table nodes) and a
    # perturbed one, as one batch
    cells_x2 = cells._replace(**{
        k: jnp.concatenate([v, v]) for k, v in cells._asdict().items()
        if v is not None})
    u = np.concatenate([np.asarray(init.u), _perturbed(init.u, 2)])
    flag = np.concatenate([np.asarray(init.flag)] * 2)
    Qr, dQr = _jax_pack(fs, cells_x2, jnp.asarray(u), jnp.asarray(flag))
    Qp, dQp = _port_pack(fs, cells_x2, u, flag)
    _close(Qp, Qr, 0, "spe1 q")
    _close(dQp, dQr, (0, 2), "spe1 dq")

    rng = np.random.default_rng(9)
    regs = rng.integers(0, 2, (n, 2)).astype(np.int32)
    eps = np.full((n, 12), np.nan)
    pick = rng.random(n) < 0.67
    m = int(pick.sum())
    for ch, lo, span in ((0, 0.10, 0.06), (1, 0.16, 0.08), (2, 0.92, 0.06),
                         (3, 0.75, 0.10), (4, 0.02, 0.05), (5, 0.80, 0.10),
                         (6, 0.70, 0.10), (7, 0.6, 0.4), (8, 0.7, 0.3),
                         (9, 0.6, 0.4), (10, 0.5, 1.0), (11, 0.5, 1.0)):
        eps[pick, ch] = lo + span * rng.random(m)
    cells2 = cells._replace(regs=jnp.asarray(regs), eps=jnp.asarray(eps))
    fs2 = _two_region(fs)
    u = _perturbed(init.u, 3)
    Qr, dQr = _jax_pack(fs2, cells2, jnp.asarray(u), init.flag)
    Qp, dQp = _port_pack(fs2, cells2, u, init.flag)
    _close(Qp, Qr, 0, "2-region+eps q")
    _close(dQp, dQr, (0, 2), "2-region+eps dq")

    p = tmp_path / "WG.DATA"
    p.write_text(wetgas_deck_text())
    fsw, cw, _tw, iw = _jax_problem(str(p))
    nw = iw.u.shape[0]
    u = np.asarray(iw.u).copy()
    flag = np.asarray(iw.flag).copy()
    flag[: nw // 3] = 0
    u[: nw // 3, 2] = 0.05 + 0.4 * rng.random(nw // 3)
    u[:, 0] *= 1 + 0.031 * rng.standard_normal(nw)
    u[:, 1] = 0.21 + 0.4 * rng.random(nw)
    rv = flag == 2
    u[rv, 2] = 3.1e-5 + 1.4e-4 * rng.random(int(rv.sum()))
    Qr, dQr = _jax_pack(fsw, cw, jnp.asarray(u), jnp.asarray(flag))
    Qp, dQp = _port_pack(fsw, cw, u, flag)
    assert (flag == 2).any() and (flag == 0).any()
    _close(Qp, Qr, 0, "wet gas q")
    _close(dQp, dQr, (0, 2), "wet gas dq")


def test_assembly_matches_reference_xla_branch(tmp_path):
    """K1 -> K2 (plain versions) against the reference's
    assemble_structured on the CPU (its vmap(jacfwd) branch), 4x3x3 SPE1
    physics off equilibrium: residual, diagonal blocks, all six bands."""
    import jax
    import jax.numpy as jnp
    import torch

    torch.set_num_threads(1)
    from opm_autodiff_tpu.models.blackoil import PrimaryState
    from opm_autodiff_tpu.models.structured import assemble_structured
    from opm_autodiff_tpu.ops import pallas_cellpack
    from opm_autodiff_tpu.utils.synthetic import write_spe1_deck
    from opm_autodiff_tpu_torch import interop
    from opm_autodiff_tpu_torch.models.blackoil import accumulation
    from opm_autodiff_tpu_torch.models.structured import (
        assemble_structured as port_assemble)

    assert not pallas_cellpack.enabled()   # the XLA branch on the CPU
    deck = write_spe1_deck(str(tmp_path / "S.DATA"), 4, 3, 3)
    fs, cells, topo, init = _jax_problem(deck)
    u = _perturbed(init.u, 5)
    tfs = interop.fluid_from_arrays(_np_tree(fs))
    tcells = interop.cells_from_arrays(_np_tree(cells))
    ttopo = interop.topology_from_arrays(_np_tree(topo))
    st0 = interop.state_from_arrays(np.asarray(init.u), np.asarray(init.flag))
    acc0 = accumulation(tfs, st0.u, st0.flag, tcells.pore_vol_ref,
                        tcells.regs).numpy()
    dt = 86400.0
    ref = jax.jit(lambda uu: assemble_structured(
        fs, cells, topo, PrimaryState(uu, init.flag), jnp.asarray(acc0),
        dt))(jnp.asarray(u))
    st = interop.state_from_arrays(u, np.asarray(init.flag))
    got, _packed = port_assemble(tfs, tcells, ttopo, st,
                                 torch.as_tensor(acc0), dt)
    _close(got.residual.numpy(), ref.residual, 0, "residual")
    _close(got.diag.numpy(), ref.diag, 0, "diag")
    for name in ("x_lr", "x_rl", "y_lr", "y_rl", "z_lr", "z_rl"):
        g = getattr(got, name).numpy()
        r = np.asarray(getattr(ref, name))
        _close(g.reshape(-1, 3, 3), r.reshape(-1, 3, 3), 0, name)
    _close(got.inv_b.numpy(), ref.inv_b, 0, "inv_b")
