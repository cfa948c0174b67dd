"""Hand-written CUDA kernels of the port and their plain PyTorch twins.

Each module holds one kernel's wrapper (launches the CUDA kernel for CUDA
tensors, runs the plain version for CPU tensors) and the plain version.
``LAUNCHES`` counts kernel launches per kernel: a wrapper adds one where
it launches its kernel and nowhere else, so a run can show that its main
path went through the kernels.
"""

LAUNCHES = {"cellpack": 0, "flux": 0, "spmv": 0, "zline_factor": 0,
            "zline_apply": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
