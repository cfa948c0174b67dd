"""Host-side modules of the PyTorch/CUDA port against the JAX package.

The deck reader, the semantic state, the geometry, the fluid tables and
the equilibration are numpy on both sides: field by field they must be
identical on SPE1CASE1 (and the fluid banks on the wet-gas deck). No JAX
computation runs here; the JAX package's numpy code is the reference.
"""

import dataclasses
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPE1 = os.path.join(ROOT, "tests", "data", "SPE1CASE1.DATA")


def _plain(x):
    """Containers -> plain python/numpy (tensors and device arrays to
    numpy), so two implementations' objects compare field by field."""
    if hasattr(x, "vals") and isinstance(getattr(x, "vals"), tuple):
        return list(x.vals)   # the reference's static region counts
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {k: _plain(v) for k, v in x._asdict().items()}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    if hasattr(x, "__array__") and not isinstance(x, (str, bytes)):
        return np.asarray(x)
    return x


def _assert_same(a, b, path="", rtol=0.0):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}", rtol)
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]", rtol)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a = np.asarray(a)
        b = np.asarray(b)
        assert a.shape == b.shape, (path, a.shape, b.shape)
        if a.dtype.kind in "fc":
            np.testing.assert_allclose(b, a, rtol=rtol, atol=0.0,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(b, a, err_msg=path)
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), path
    else:
        assert a == b, (path, a, b)


def test_state_geometry_fluid_and_equilibration_match():
    import torch

    torch.set_num_threads(1)
    from opm_autodiff_tpu import grid as jgrid
    from opm_autodiff_tpu.io import state as jstate
    from opm_autodiff_tpu.models import init as jinit
    from opm_autodiff_tpu.props import fluid as jfluid
    from opm_autodiff_tpu_torch import grid as tgrid
    from opm_autodiff_tpu_torch.io import state as tstate
    from opm_autodiff_tpu_torch.models import init as tinit
    from opm_autodiff_tpu_torch.props import fluid as tfluid

    js = jstate.load_state(SPE1)
    ts = tstate.load_state(SPE1)
    _assert_same(_plain(js), _plain(ts), "state")
    jg = jgrid.build_geometry(js)
    tg = tgrid.build_geometry(ts)
    _assert_same(_plain(jg), _plain(tg), "geometry")
    jfs = jfluid.FluidSystem.from_state(js)
    tfs = tfluid.FluidSystem.from_state(ts)
    _assert_same(_plain(jfs), _plain(tfs), "fluid")
    # the well set, carried over by interop and built by the port
    from opm_autodiff_tpu import wells as jwells
    from opm_autodiff_tpu_torch import interop
    from opm_autodiff_tpu_torch import wells as twells

    jws = jwells.build_wellset(jg, js.schedule.steps[0].wells)
    tws = twells.build_wellset(tg, ts.schedule.steps[0].wells)
    cws = interop.wellset_from_arrays(
        {k: np.asarray(v) for k, v in jws._asdict().items()})
    _assert_same(_plain(jws), _plain(tws), "wellset")
    _assert_same(_plain(cws), _plain(tws), "wellset via interop")
    ji = jinit.equilibrate(js, jg, jfs)
    ti = tinit.equilibrate(ts, tg, tfs)
    np.testing.assert_array_equal(ti.flag.numpy(), np.asarray(ji.flag))
    # the port vectorizes the per-cell saturation loop: same arithmetic
    np.testing.assert_allclose(ti.u.numpy(), np.asarray(ji.u), rtol=1e-14,
                               atol=0.0)


def test_wetgas_fluid_banks_match(tmp_path):
    from opm_autodiff_tpu.io import state as jstate
    from opm_autodiff_tpu.props import fluid as jfluid
    from opm_autodiff_tpu_torch.io import state as tstate
    from opm_autodiff_tpu_torch.props import fluid as tfluid
    from opm_autodiff_tpu_torch.utils.synthetic import wetgas_deck_text

    p = tmp_path / "WG.DATA"
    p.write_text(wetgas_deck_text())
    jfs = jfluid.FluidSystem.from_state(jstate.load_state(str(p)))
    tfs = tfluid.FluidSystem.from_state(tstate.load_state(str(p)))
    assert tfs.wet_gas and jfs.wet_gas
    _assert_same(_plain(jfs), _plain(tfs), "fluid")
