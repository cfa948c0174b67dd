from opm_autodiff_tpu_torch.io.state import EclState, load_state  # noqa: F401
