"""Differentiable 1-D table interpolation with linear extrapolation.

The workhorse under every PVT and saturation function (port of
opm_autodiff_tpu/props/tables.py). Deck table semantics require linear
extrapolation beyond both ends for pressure-dependent quantities; with
``extrapolate=False`` the value is clipped to the segment's end values.

Node convention: a point exactly on a node belongs to the segment on its
RIGHT (``searchsorted(side="right")``) — states initialized from table
nodes sit exactly there, so the derivative choice is load-bearing.

Written with broadcasting so one function serves a single cell (under
``torch.func.vmap``/``jacfwd``) and a batch of cells: ``xp``/``fp`` are
``[n]`` (one table) or ``[..., n]`` (a per-cell table row). The segment
search counts the nodes ``<= x`` (identical to ``searchsorted(side=
"right")`` for sorted nodes, +inf padding included) so it has a batching
rule and a forward-mode derivative. ``vmax``/``vmin`` split the
derivative evenly at ties, like ``jnp.maximum``/``jnp.minimum``.
"""

from __future__ import annotations

import torch


def _const(v, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def vmax(a, b):
    """``jnp.maximum`` semantics (tie derivative split 0.5/0.5)."""
    if not torch.is_tensor(b):
        b = _const(b, a)
    return torch.maximum(a, b)


def vmin(a, b):
    """``jnp.minimum`` semantics (tie derivative split 0.5/0.5)."""
    if not torch.is_tensor(b):
        b = _const(b, a)
    return torch.minimum(a, b)


def rows(bank, idx):
    """``bank[idx]`` for an index tensor of any shape (``index_select``,
    which also batches under ``torch.func.vmap``)."""
    return torch.index_select(bank, 0, idx.reshape(-1)).reshape(
        tuple(idx.shape) + tuple(bank.shape[1:]))


def take(arr, idx):
    """``arr[..., idx]`` along the last axis with broadcasting of the
    leading axes (``arr`` [n] or [..., n]; ``idx`` [...])."""
    if arr.dim() == 1:
        return rows(arr, idx)
    return torch.take_along_dim(arr, idx[..., None], -1)[..., 0]


def segment(x, xp, lo: int = 0, hi: int | None = None):
    """Segment index ``clip(searchsorted(xp, x, 'right') - 1, lo, hi)``;
    ``hi`` defaults to ``n - 2``. Accepts a per-cell ``hi`` tensor."""
    n = xp.shape[-1]
    cnt = (xp <= x[..., None]).sum(-1)
    if hi is None:
        hi = n - 2
    if torch.is_tensor(hi):
        return torch.minimum(torch.clamp(cnt - 1, min=lo), hi)
    return torch.clamp(cnt - 1, lo, hi)


def interp1d(x, xp, fp, extrapolate: bool = True):
    """Piecewise-linear y(x) on nodes (xp, fp); xp strictly increasing."""
    idx = segment(x, xp)
    x0 = take(xp, idx)
    x1 = take(xp, idx + 1)
    f0 = take(fp, idx)
    f1 = take(fp, idx + 1)
    slope = (f1 - f0) / (x1 - x0)
    y = f0 + slope * (x - x0)
    if not extrapolate:
        y = vmin(vmax(y, torch.minimum(f0, f1)), torch.maximum(f0, f1))
    return y
