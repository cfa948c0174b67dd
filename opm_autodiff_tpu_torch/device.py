"""Device selection shared by every entry point of the port.

Entry points default to ``"cuda"`` and raise when no GPU is present:
the port never drops quietly to the CPU. Callers that want the CPU path
(the tests) pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``torch.device`` for ``device`` (default ``"cuda"``); raises when
    CUDA is asked for and unavailable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
