"""K3 (banded SpMV) and K4 (z-line block-Thomas) of the PyTorch/CUDA port
against the JAX package, on the CPU.

The port's kernels run only on the card; on CPU tensors their wrappers
run the plain PyTorch versions, compared here with the reference's
``structured_matvec`` and ``build_zline`` / ``zline_apply`` (and the
cofactor ``invert_blocks`` both use) on random diagonally dominant
banded systems made with numpy: nb = 3 and 4, and grids with singleton
axes (zero-width bands). float64 on both sides; tolerance
max|port - ref| <= 1e-10 * max|ref|.
"""

import numpy as np

RTOL = 1e-10
CASES = (((6, 5, 4), 3), ((4, 1, 3), 3), ((3, 4, 5), 4), ((1, 1, 5), 4),
         ((5, 4, 1), 3))


def _random_system(dims, nb, rng):
    nx, ny, nz = dims
    n = nx * ny * nz

    def r(*s):
        return 0.1 * rng.standard_normal(s)

    return dict(residual=r(n, nb), diag=r(n, nb, nb) + 4.0 * np.eye(nb),
                x_lr=r(nz, ny, nx - 1, nb, nb), x_rl=r(nz, ny, nx - 1, nb, nb),
                y_lr=r(nz, ny - 1, nx, nb, nb), y_rl=r(nz, ny - 1, nx, nb, nb),
                z_lr=r(nz - 1, ny, nx, nb, nb), z_rl=r(nz - 1, ny, nx, nb, nb))


def _close(got, ref, what):
    got = np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-300)
    assert err <= RTOL, f"{what}: {err:.3e} > {RTOL}"


def test_spmv_and_zline_match_reference():
    import jax
    import jax.numpy as jnp
    import torch

    torch.set_num_threads(1)
    from opm_autodiff_tpu.models.structured import (StructuredSystem,
                                                    structured_matvec)
    from opm_autodiff_tpu.solvers import linear as jlin
    from opm_autodiff_tpu_torch.models.structured import (
        StructuredSystem as TSystem)
    from opm_autodiff_tpu_torch.ops import spmv, zline
    from opm_autodiff_tpu_torch.solvers import linear as tlin

    @jax.jit
    def reference(sys, x):
        return (structured_matvec(sys, x),
                jlin.zline_apply(jlin.build_zline(sys), x),
                jlin.invert_blocks(sys.diag))

    rng = np.random.default_rng(1234)
    for dims, nb in CASES:
        arrs = _random_system(dims, nb, rng)
        x = rng.standard_normal((int(np.prod(dims)), nb))
        jsys = StructuredSystem(**{k: jnp.asarray(v) for k, v in arrs.items()})
        tsys = TSystem(**{k: torch.as_tensor(v) for k, v in arrs.items()})
        tag = f"{dims} nb={nb}"
        y_ref, z_ref, inv_ref = reference(jsys, jnp.asarray(x))
        _close(spmv.banded_spmv(tsys, torch.as_tensor(x)).numpy(), y_ref,
               f"spmv {tag}")
        got = zline.zline_apply(zline.build_zline(tsys), torch.as_tensor(x))
        _close(got.numpy(), z_ref, f"zline {tag}")
        _close(tlin.invert_blocks(tsys.diag).numpy(), inv_ref,
               f"invert_blocks {tag}")
