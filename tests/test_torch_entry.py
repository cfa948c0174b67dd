"""The slice as a whole, one Newton step: the PyTorch/CUDA port's
``opm_autodiff_tpu_torch.entry.entry`` against the reference package's
``__graft_entry__.entry()`` on the 10x10x3 SPE1 problem, on the CPU.

Both sides build the same problem from the same deck (checked: identical
inputs) and run one full Newton iteration: assembly, 4-DOF wells, the
equilibrated float32 BiCGStab with the z-line preconditioner, chopped
update. Tolerances, from what float32 permits:

* the meaning flags and the primary-variable well rates ``q_tot``
  (computed before the solve from identical inputs) agree exactly;
* ``cnv`` (from the float32-stored residual) to 1e-9 absolute and 1e-6
  relative;
* ``u`` and ``xw`` move by the Newton update, which comes out of a
  float32 Krylov solve whose dot products sum in a different order on
  the two sides: the updates agree to 1e-4 of each variable's largest
  update (measured: a few 1e-6).
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_one_newton_step_matches_reference():
    import jax
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    import __graft_entry__ as ge
    from opm_autodiff_tpu_torch.entry import entry

    fn_j, args_j = ge.entry()
    out_j = [np.asarray(o) for o in jax.jit(fn_j)(*args_j)]
    fn_t, args_t = entry(device="cpu")
    for a, b in zip(args_j, args_t):
        b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
        np.testing.assert_array_equal(b, np.asarray(a))
    out_t = [o.numpy() for o in fn_t(*args_t)]
    u_j, flag_j, xw_j, cnv_j, q_j = out_j
    u_t, flag_t, xw_t, cnv_t, q_t = out_t

    np.testing.assert_array_equal(flag_t, flag_j)
    np.testing.assert_array_equal(q_t, q_j)
    np.testing.assert_allclose(cnv_t, cnv_j, rtol=1e-6, atol=1e-9)
    for got, ref, x0, name in ((u_t, u_j, np.asarray(args_j[0]), "u"),
                               (xw_t, xw_j, np.asarray(args_j[2]), "xw")):
        step = np.abs(ref - x0).max(axis=0)
        err = np.abs(got - ref).max(axis=0)
        assert (err <= 1e-4 * step + 1e-300).all(), (name, err, step)
        assert np.isfinite(got).all()
