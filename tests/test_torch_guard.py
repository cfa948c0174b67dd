"""Guards of the PyTorch/CUDA port (opm_autodiff_tpu_torch).

* The port and chip_smoke.py import neither JAX nor the JAX package
  (parsed, not imported: an AST walk over every module).
* Entry points default to CUDA and raise on a machine without a GPU
  instead of dropping quietly to the CPU.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "opm_autodiff_tpu_torch")
BANNED = ("jax", "jaxlib", "opm_autodiff_tpu")


def _sources():
    for dirpath, _dirs, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    files = list(_sources())
    assert len(files) > 20
    rel = {os.path.relpath(f, PORT) for f in files}
    # the CPR slice's modules are among those checked
    assert {"solvers/cpr.py", "solvers/fgmres.py", "ops/cprinner.py"} <= rel
    bad = []
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read(), filename=path)
        for root in _imported_roots(tree):
            if root in BANNED:
                bad.append((os.path.relpath(path, ROOT), root))
    assert not bad, f"forbidden imports: {bad}"


def test_entry_points_require_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU refusal is not testable")
    from opm_autodiff_tpu_torch import main as cli
    from opm_autodiff_tpu_torch.entry import entry
    from opm_autodiff_tpu_torch.io.state import load_state
    from opm_autodiff_tpu_torch.simulator import Simulator

    deck = os.path.join(ROOT, "tests", "data", "SPE1CASE1.DATA")
    with pytest.raises(RuntimeError, match="CUDA"):
        Simulator(load_state(deck))
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([deck, "--quiet"])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([deck, "--quiet", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([deck, "--quiet", "--linear-solver", "cpr"])
    # the multigrid CPR variants are refused before any work, naming the
    # ROADMAP item that brings them
    for name in ("cpramg", "cpramgt"):
        with pytest.raises(NotImplementedError, match="item 10b"):
            cli.main([deck, "--quiet", "--device", "cpu", "--linear-solver",
                      name])
