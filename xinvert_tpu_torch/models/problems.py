# -*- coding: utf-8 -*-
"""Coefficient builders: physics problem -> compiled StencilSpec.

Counterpart of ``xinvert_tpu/models/problems.py``.  Each ``build_*``
replicates one reference coefficient builder (xinvert/apps.py:1397-2109) as
plain array math — spherical metrics, half-grid staggering — and compiles
the result with the matching stencil family from
:mod:`xinvert_tpu_torch.stencil`.  This package ports the Poisson builder.

Inputs: ``F`` the forcing tensor with arbitrary leading batch dims and the
core grid trailing; ``Fdef`` a boolean defined-mask tensor of the same (or
core) shape on the same device; ``grid`` a
:class:`~xinvert_tpu_torch.grid.Grid`; ``mp`` the model-parameter dict.
Coefficient planes take F's dtype and device.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import stencil
from ..grid import Grid

__all__ = ["build_poisson", "poisson_coeffs", "BUILDERS"]


# ------------------------------------------------------------------ helpers

def _bcast(profile, core_ndim, axis):
    """Lift a coordinate profile / parameter to core rank.

    1-D profiles reshape onto core axis ``axis``; scalars become all-ones
    rank; arrays already at core rank pass through unchanged."""
    p = np.asarray(profile, dtype=np.float64)
    if p.ndim == core_ndim:
        return p
    if p.ndim == 0:
        return p.reshape((1,) * core_ndim)
    shape = [1] * core_ndim
    shape[axis] = p.size
    return p.reshape(shape)


def _half(profile):
    """Half-grid average: h[j] = (p[j] + p[j-1]) / 2, NaN at j=0.

    Matches the reference's ``(lats + lats.shift(1)) / 2`` staggering
    (e.g. apps.py:1404); the NaN leading entry only ever feeds rows that the
    sweep never updates, and is zeroed out during stencil finalisation.
    """
    p = np.asarray(profile, dtype=np.float64)
    h = np.empty_like(p)
    h[0] = np.nan
    h[1:] = 0.5 * (p[1:] + p[:-1])
    return h


def _fill(F, Fdef, value=0.0):
    return torch.where(Fdef, F, value)


def _like(a, F):
    """Host array -> tensor with F's dtype and device."""
    return torch.as_tensor(np.ascontiguousarray(a), dtype=F.dtype,
                           device=F.device)


# ----------------------------------------------------------------- builders

def poisson_coeffs(F, Fdef, grid: Grid):
    """The Poisson A/C planes (host arrays) and scaled forcing (a tensor)
    (apps.py:1397-1437)."""
    nd = grid.ndim
    shape = grid.shape
    ct = grid.coord_type
    if ct == "lat-lon":
        latr = np.deg2rad(grid.coords[0])
        cosG = _bcast(np.cos(latr), nd, 0)
        cosH = _bcast(np.cos(_half(latr)), nd, 0)
        A = np.broadcast_to(cosH, shape)
        C = np.broadcast_to(1.0 / cosG, shape)
        Fs = _fill(F, Fdef) * _like(cosG, F)
    elif ct == "z-lat":
        cosG = _bcast(np.cos(np.deg2rad(grid.coords[1])), nd, 1)
        A = np.ones(shape)
        C = np.ones(shape)
        Fs = _fill(F, Fdef) * _like(cosG, F)
    elif ct in ("z-lon", "cartesian"):
        A = np.ones(shape)
        C = np.ones(shape)
        Fs = _fill(F, Fdef)
    else:
        raise ValueError(f"unsupported coords {ct} for Poisson")
    return A, C, Fs


def build_poisson(F, Fdef, grid: Grid, mp):
    """Poisson equation (apps.py:1397-1437)."""
    A, C, Fs = poisson_coeffs(F, Fdef, grid)
    return stencil.standard_2d(_like(A, F), 0.0, _like(C, F), Fs, Fdef,
                               grid.deltas, grid.bcs, include_cross=False)


BUILDERS = {
    "poisson": build_poisson,
}
