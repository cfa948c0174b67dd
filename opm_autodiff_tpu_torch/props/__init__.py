from opm_autodiff_tpu_torch.props.fluid import FluidSystem  # noqa: F401
