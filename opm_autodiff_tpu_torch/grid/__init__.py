from opm_autodiff_tpu_torch.grid.geometry import Geometry, build_geometry  # noqa: F401
