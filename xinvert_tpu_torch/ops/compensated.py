# -*- coding: utf-8 -*-
"""Error-free transformations (EFT) and the compensated stencil residual,
in PyTorch.

Counterpart of ``xinvert_tpu/ops/compensated.py``.  The per-cell residual
``sum_k w_k S[.+off_k] + w0 S + g`` is evaluated with Dekker/Knuth
error-free transformations (TwoProd by Veltkamp splitting, TwoSum
cascades: Ogita-Rump-Oishi "Sum2"), so each cell's residual is accurate to
O(eps^2 * condition) from float32 arithmetic alone.  With a double-float32
state (the unevaluated pair ``hi + lo`` that
:mod:`xinvert_tpu_torch.refine` carries) this measures the true residual of
a state finer than float32, which is what certifies residuals below the
float32 floor.

**No FMA contraction.**  The identities hold only when every product and
every difference is rounded on its own, in IEEE round-to-nearest.  Each
line below is a separate torch op (a separate kernel launch on the card,
a separate loop on the CPU), which neither device contracts.  Do not write
these with ``addcmul``/``addcdiv``, under ``torch.compile``, or as a fused
kernel: any of them may turn ``ahi * bhi - p`` into one fused
multiply-add and break exactness.  ``chip_smoke.py`` checks exactness on
the card against float64.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["two_sum", "two_prod", "residual_compensated",
           "residual_norm_compensated", "masked_mean_abs"]


def two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly, s = fl(a + b)."""
    s = a + b
    t = s - a
    e = (a - (s - t)) + (b - t)
    return s, e


def _split_factor(dtype):
    """Veltkamp's splitting factor 2^ceil(p/2) + 1, p the significand bits
    (2^12 + 1 in float32, 2^27 + 1 in float64), as a Python float (exact)."""
    nmant = {torch.float32: np.finfo(np.float32).nmant,
             torch.float64: np.finfo(np.float64).nmant}[dtype]
    p = nmant + 1
    return 2.0 ** ((p + 1) // 2) + 1.0


def two_prod(a, b):
    """Dekker TwoProd (no FMA): p + e == a * b exactly, p = fl(a * b).

    Veltkamp splitting overflows for |a| > max/(2^12+1) (~8e34 in float32),
    far beyond any stencil weight this package builds.
    """
    dtype = torch.result_type(a, b)
    p = a * b
    f = _split_factor(dtype)
    ca = f * a
    ahi = ca - (ca - a)
    alo = a - ahi
    cb = f * b
    bhi = cb - (cb - b)
    blo = b - bhi
    e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, e


def _shift(S, off, nd):
    """S[. + off] with wrap on the core (trailing) axes, as ``jnp.roll``."""
    shifts = tuple(-o for o in off if o != 0)
    axes = tuple(ax - nd for ax, o in enumerate(off) if o != 0)
    return torch.roll(S, shifts=shifts, dims=axes) if shifts else S


def residual_compensated(spec, S, S_lo=None, shift=None):
    """Per-cell residual ``sum_k w_k S[.+off_k] + w0 S + g`` with
    compensated (Sum2/TwoProd) accumulation of the ``S`` contributions.

    ``S_lo`` (optional) is the low word of a double-float32 state: its
    contribution ``sum_k w_k S_lo[.+off_k] + w0 S_lo`` is O(eps) of the
    leading terms, so plain evaluation of it keeps the total at O(eps^2)
    accuracy.  Every offset wraps (boundaries are the caller's to mask with
    ``spec.active``): this is the unmasked residual.  ``shift(X, off)``
    gives X[. + off] over the cells of the planes (default: a roll; a block
    with ghost rings passes a slice of them, and shift(X, 0) its own
    cells).
    """
    nd = spec.ndim
    if shift is None:
        def shift(X, off):
            return _shift(X, off, nd)
    s = spec.g.to(S.dtype)
    e = torch.zeros((), dtype=S.dtype, device=S.device)
    for k, off in enumerate(spec.offsets):
        p, pe = two_prod(spec.w[k], shift(S, off))
        s, se = two_sum(s, p)
        e = e + (se + pe)
    zero = (0,) * nd
    p, pe = two_prod(spec.w0, shift(S, zero))
    s, se = two_sum(s, p)
    e = e + (se + pe)
    if S_lo is not None:
        c = spec.w0 * shift(S_lo, zero)
        for k, off in enumerate(spec.offsets):
            c = c + spec.w[k] * shift(S_lo, off)
        e = e + c
    return s + e


def masked_mean_abs(spec, r):
    """Mean |r| over the active cells, per batch slice (the active count
    stays on the device: no host sync)."""
    axes = tuple(range(-spec.ndim, 0))
    r = torch.where(spec.active, r, 0.0)
    n_active = torch.clamp(spec.active.sum(), min=1)
    return torch.sum(torch.abs(r), dim=axes) / n_active


def residual_norm_compensated(spec, S, S_lo=None):
    """Compensated mean |residual| over active cells, per batch slice.

    The per-cell residuals carry O(eps^2)-accurate values; the |r| terms are
    non-negative, so the reduction's relative error is O(eps log N) of the
    mean itself: the certified norm is accurate to ~1e-6 of its own value
    in float32.  No host sync: the active count stays on the device.
    """
    return masked_mean_abs(spec, residual_compensated(spec, S, S_lo))
