"""opm_autodiff_tpu_torch — the PyTorch/CUDA port of opm_autodiff_tpu.

The black-oil main path (deck -> geometry -> fluid tables -> equilibration
-> banded assembly -> 4-DOF wells -> equilibrated f32 BiCGStab with the
z-line preconditioner -> chopped Newton -> adaptive report-step loop) runs
on an NVIDIA GPU through four hand-written CUDA kernels (``csrc/``):
cellpack (per-cell property pack with 3-tangent jets), flux (TPFA flux +
Jacobian bands), banded block SpMV and the z-line block-Thomas solve.
Every kernel has a plain PyTorch twin in the same module, used on CPU
tensors and as the oracle.

Host-side modules (deck parsing, geometry, equilibration) are numpy;
device modules take an explicit ``device`` and default to ``"cuda"``.
"""

__version__ = "0.1.0"
