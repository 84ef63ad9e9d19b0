# -*- coding: utf-8 -*-
"""Coefficient builders: physics problem -> compiled StencilSpec.

Counterpart of ``xinvert_tpu/models/problems.py``.  Each ``build_*``
replicates one reference coefficient builder (xinvert/apps.py:1397-2109) as
plain array math — spherical metrics, half-grid staggering — and compiles
the result with the matching stencil family from
:mod:`xinvert_tpu_torch.stencil`.  This package ports the Poisson builder
(standard 2-D) and the omega (standard 3-D) and 3-D ocean (general 3-D)
builders.

Inputs: ``F`` the forcing tensor with arbitrary leading batch dims and the
core grid trailing; ``Fdef`` a boolean defined-mask tensor of the same (or
core) shape on the same device; ``grid`` a
:class:`~xinvert_tpu_torch.grid.Grid`; ``mp`` the model-parameter dict, whose
Field-valued entries the API layer has already aligned to core rank.
Coefficient planes take F's dtype and device.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import stencil
from ..grid import Grid

__all__ = ["build_poisson", "poisson_coeffs", "build_omega", "omega_coeffs",
           "build_ocean3d", "ocean3d_coeffs", "BUILDERS"]


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
    """Host array -> a new tensor with F's dtype and device (a copy: the
    array may be a read-only broadcast view)."""
    return torch.tensor(np.asarray(a), dtype=F.dtype, device=F.device)


def _grad_coord(vals, coord, axis=0):
    """d(vals)/d(coord) via central differences (xarray.differentiate);
    ``axis`` locates the coordinate axis when ``vals`` is core-rank."""
    vals = np.asarray(vals, np.float64)
    coord = np.asarray(coord, np.float64)
    if vals.ndim <= 1:
        return np.gradient(vals, coord)
    return np.gradient(vals, coord, axis=axis)


def _deg2m(rearth):
    return rearth / 180.0 * np.pi


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


def omega_coeffs(F, Fdef, grid: Grid, mp):
    """The omega-equation A/B/C planes (host arrays) and scaled forcing (a
    tensor) (apps.py:2016-2052)."""
    nd, shape = grid.ndim, grid.shape
    N2 = np.asarray(mp["N2"], np.float64)
    if grid.coord_type == "lat-lon":
        latr = np.deg2rad(grid.coords[1])
        cosG = _bcast(np.cos(latr), nd, 1)
        cosH = _bcast(np.cos(_half(latr)), nd, 1)
        f = 2.0 * mp["Omega"] * _bcast(np.sin(latr), nd, 1)
        A = np.broadcast_to(f ** 2 * cosG, shape)
        B = np.broadcast_to(N2 * cosH, shape)
        C = np.broadcast_to(N2 / cosG, shape)
        Fs = _fill(F, Fdef) * _like(cosG, F)
    else:
        y = grid.coords[1]
        f = mp["f0"] + mp["beta"] * _bcast(y, nd, 1)
        A = np.broadcast_to(f ** 2, shape)
        B = np.broadcast_to(N2 * np.ones(shape), shape)
        C = np.broadcast_to(N2 * np.ones(shape), shape)
        Fs = _fill(F, Fdef)
    return A, B, C, Fs


def build_omega(F, Fdef, grid: Grid, mp):
    """QG omega equation, standard 3D (apps.py:2016-2052)."""
    A, B, C, Fs = omega_coeffs(F, Fdef, grid, mp)
    return stencil.standard_3d(_like(A, F), _like(B, F), _like(C, F), Fs,
                               Fdef, grid.deltas, grid.bcs)


def ocean3d_coeffs(F, Fdef, grid: Grid, mp):
    """3-D damped ocean flow general-3D coefficient planes (tensors with F's
    dtype and device) (apps.py:2055-2109)."""
    nd, shape = grid.ndim, grid.shape
    eps, k, N2 = mp["epsilon"], mp["k"], np.asarray(mp["N2"], np.float64)
    lev = grid.coords[0]
    # N2 may be a scalar, a 1-D lev profile, or (via _resolve_mp) a
    # Field profile already broadcast to core rank, e.g. (nz, 1, 1)
    c3 = np.asarray(k / N2, np.float64)
    if c3.ndim == 0:
        c3 = np.full(lev.shape, c3)
    if c3.ndim <= 1:
        dc3 = _grad_coord(c3, lev)
    else:
        dc3 = np.gradient(c3, np.asarray(lev, np.float64), axis=0)
    eps = _bcast(eps, nd, 1)
    if grid.coord_type == "lat-lon":
        lat = grid.coords[1]
        latr = _bcast(np.deg2rad(lat), nd, 1)
        cosL = np.cos(latr)
        f = 2.0 * mp["Omega"] * np.sin(latr)
        c1 = eps / (eps ** 2 + f ** 2)
        c2 = f / (eps ** 2 + f ** 2)
        deg2m = _deg2m(mp["Rearth"])
        dc1 = _grad_coord(c1, lat, axis=1) / deg2m
        dc2 = _grad_coord(c2, lat, axis=1) / deg2m
        E = dc1 - c1 * np.tan(latr) / mp["Rearth"]
        Fc = -dc2 / cosL
        C = c1 / cosL ** 2
    else:
        y = grid.coords[1]
        f = mp["f0"] + mp["beta"] * _bcast(np.asarray(y, np.float64), nd, 1)
        c1 = eps / (eps ** 2 + f ** 2)
        c2 = f / (eps ** 2 + f ** 2)
        dc1 = _grad_coord(c1, y, axis=1)
        dc2 = _grad_coord(c2, y, axis=1)
        E = dc1
        Fc = -dc2
        C = c1

    def bz(p):
        return _like(np.broadcast_to(_bcast(p, nd, 0), shape), F)

    def by(p):
        return _like(np.broadcast_to(_bcast(p, nd, 1), shape), F)

    zero = torch.zeros(shape, dtype=F.dtype, device=F.device)
    H = _fill(F, Fdef)
    return bz(c3), by(c1), by(C), bz(dc3), by(E), by(Fc), zero, H


def build_ocean3d(F, Fdef, grid: Grid, mp):
    """3-D damped ocean flow, general 3D (apps.py:2055-2109)."""
    A, B, C, D, E, Fc, G, H = ocean3d_coeffs(F, Fdef, grid, mp)
    return stencil.general_3d(A, B, C, D, E, Fc, G, H, Fdef,
                              grid.deltas, grid.bcs)


BUILDERS = {
    "poisson": build_poisson,
    "omega": build_omega,
    "3docean": build_ocean3d,
}
