"""ctypes binding for the native deck bulk-number lexer (native/decklex.cpp).

Used by the deck reader's DATA-keyword fast path; read_deck falls back
to the Python tokenizer whenever the native library is unavailable or
the text contains anything beyond numbers/repeats/'/'.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_BROKEN = False

_SRC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")


def _load_lib():
    global _LIB, _BROKEN
    if _LIB is not None or _BROKEN:
        return _LIB
    so = os.path.join(_SRC_DIR, "libdecklex.so")
    src = os.path.join(_SRC_DIR, "decklex.cpp")
    try:
        if (not os.path.exists(so)
                or os.path.getmtime(so) < os.path.getmtime(src)):
            subprocess.run(["g++", "-O2", "-Wall", "-fPIC", "-shared",
                            "-o", so, src], check=True)
        lib = ctypes.CDLL(so)
    except (OSError, subprocess.CalledProcessError):
        _BROKEN = True
        return None
    lib.decklex_count.restype = ctypes.c_long
    lib.decklex_count.argtypes = [ctypes.c_char_p, ctypes.c_long]
    lib.decklex_fill.restype = ctypes.c_long
    lib.decklex_fill.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                 ctypes.c_void_p, ctypes.c_long]
    _LIB = lib
    return lib


def available() -> bool:
    if os.environ.get("OPM_TPU_NATIVE_DECKLEX", "1") != "1":
        return False
    return _load_lib() is not None


def parse_numbers(text: str) -> np.ndarray | None:
    """All numbers (repeats expanded) up to the first '/', or None when
    the text needs the general tokenizer."""
    lib = _load_lib()
    if lib is None:
        return None
    raw = text.encode("ascii", errors="replace")
    n = lib.decklex_count(raw, len(raw))
    if n < 0:
        return None
    out = np.empty(n, np.float64)
    got = lib.decklex_fill(raw, len(raw),
                           out.ctypes.data_as(ctypes.c_void_p), n)
    if got != n:
        return None
    return out
