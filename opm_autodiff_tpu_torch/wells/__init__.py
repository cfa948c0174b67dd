from opm_autodiff_tpu_torch.wells.standard import (WellSet,  # noqa: F401
                                                   build_wellset, CTRL_BHP,
                                                   CTRL_ORAT, CTRL_WRAT,
                                                   CTRL_GRAT, CTRL_LRAT,
                                                   CTRL_RATE)
