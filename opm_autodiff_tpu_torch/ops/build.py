"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``; pointers and the
stream go in as ``c_void_p``. The libraries land in ``build/torch_kernels``
at the repository root (git-ignored), named by a hash of the sources and
flags, so a rebuild happens exactly when something changed. All sources
compile in parallel, one ``nvcc`` each. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
KERNEL_SOURCES = ("cellpack", "flux", "spmv", "zline")
ARCH_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v"]

_LIBS: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _flags() -> list:
    return ARCH_FLAGS + NVCC_FLAGS


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for f in (f"{name}.cu", "common.cuh"):
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(_flags()).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_all(names=KERNEL_SOURCES) -> dict:
    """Compile every missing library, all ``nvcc`` processes started
    together. Returns {name: (seconds, compiler log)} for the ones
    compiled (the log carries ptxas' registers / spills per kernel);
    raises with the compiler's output when one fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = {n: _lib_path(n) for n in names if not os.path.exists(_lib_path(n))}
    if not todo:
        return {}
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, out in todo.items():
        tmp = out + f".tmp{os.getpid()}"
        cmd = [nvcc, *_flags(), "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    done, errors = {}, []
    for name, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        done[name] = (time.perf_counter() - t0, log)
        if p.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return done


def lib(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built on first use)."""
    if name not in _LIBS:
        path = _lib_path(name)
        if not os.path.exists(path):
            build_all()
        cdll = ctypes.CDLL(path)
        cdll.opm_cuda_error_string.restype = ctypes.c_char_p
        cdll.opm_cuda_error_string.argtypes = [ctypes.c_int]
        _LIBS[name] = cdll
    return _LIBS[name]


def check(name: str, err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error (cudaGetLastError)."""
    if err != 0:
        msg = lib(name).opm_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def require_device(device, *tensors) -> None:
    """Raise unless every tensor lies on ``device`` (a CUDA device): the
    kernels dereference raw pointers."""
    for t in tensors:
        if t is not None and t.device != device:
            raise ValueError(f"kernel input on {t.device}, expected {device}")


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor (None -> NULL)."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
