# -*- coding: utf-8 -*-
"""Coefficient builders: physics problem -> compiled StencilSpec.

Counterpart of ``xinvert_tpu/models/problems.py``.  Each ``build_*``
replicates one reference coefficient builder (xinvert/apps.py:1397-2109) as
plain array math — spherical metrics, half-grid staggering — and compiles
the result with the matching stencil family from
:mod:`xinvert_tpu_torch.stencil`.  This package ports every 2-D builder
(Poisson, RefState, PV2D, Eliassen, Gill-Matsuno in both forms, Stommel in
both forms, Stommel-Munk, Stommel-Arons, geostrophic, Bretherton-Haidvogel,
Fofonoff), the omega (standard 3-D) and 3-D ocean (general 3-D) builders
and the two 1-D ones (geostrophic adjustment, the shallow-water reference
state).

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
from .params import UNDEFTMP

__all__ = [
    "build_poisson", "poisson_coeffs", "build_refstate",
    "refstate_std_coeffs", "build_pv2d", "pv2d_std_coeffs",
    "build_eliassen", "eliassen_std_coeffs", "build_gillmatsuno",
    "gillmatsuno_coeffs", "build_gillmatsuno_test",
    "gillmatsuno_test_e_coeffs", "build_stommel", "stommel_coeffs",
    "build_stommel_test", "stommel_test_e_coeffs", "build_stommelmunk",
    "stommelmunk_coeffs", "build_stommelarons", "stommelarons_coeffs",
    "build_geostrophic", "geostrophic_std_coeffs", "build_bretherton",
    "bretherton_e_coeffs", "build_fofonoff", "fofonoff_e_coeffs",
    "build_omega", "omega_coeffs", "build_ocean3d", "ocean3d_coeffs",
    "build_geoadjustment", "build_refstate_swm", "BUILDERS",
]


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


def _core(p, F, grid, axis=0):
    """A parameter or profile lifted to core rank along ``axis`` and
    broadcast to the core grid, as a tensor with F's dtype and device."""
    return _like(np.broadcast_to(_bcast(p, grid.ndim, axis), grid.shape), F)


def _zeros(F, grid):
    return torch.zeros(grid.shape, dtype=F.dtype, device=F.device)


def _ones(F, grid):
    return torch.ones(grid.shape, dtype=F.dtype, device=F.device)


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


def _coriolis_profiles(grid: Grid, mp, axis):
    """(f at grid, f at half grid, cos, cosH, lat_rad) along core `axis`."""
    lat = grid.coords[axis]
    latr = np.deg2rad(lat)
    f = 2.0 * mp["Omega"] * np.sin(latr)
    fH = 2.0 * mp["Omega"] * np.sin(_half(latr))
    return f, fH, np.cos(latr), np.cos(_half(latr)), latr


def _gm_c1c2(grid: Grid, mp):
    """The Gill-Matsuno c1/c2 profiles and metric pieces along y (axis 0),
    all lifted to core rank so Field-valued parameters (e.g. a 2-D epsilon)
    broadcast correctly against them."""
    nd = grid.ndim
    eps = _bcast(mp["epsilon"], nd, 0)
    if grid.coord_type == "lat-lon":
        lat = grid.coords[0]
        latr = _bcast(np.deg2rad(lat), nd, 0)
        f = 2.0 * mp["Omega"] * np.sin(latr)
        c1 = eps / (eps ** 2 + f ** 2)
        c2 = f / (eps ** 2 + f ** 2)
        deg2m = _deg2m(mp["Rearth"])
        dc1 = _grad_coord(c1, lat, axis=0) / deg2m
        dc2 = _grad_coord(c2, lat, axis=0) / deg2m
        return f, c1, c2, dc1, dc2, latr
    ydef = grid.coords[0]
    # lift the coordinate before the param product (a core-rank Field beta
    # against a raw 1-D y would mis-broadcast on the trailing dim)
    f = mp["f0"] + mp["beta"] * _bcast(ydef, nd, 0)
    c1 = eps / (eps ** 2 + f ** 2)
    c2 = f / (eps ** 2 + f ** 2)
    dc1 = _grad_coord(c1, ydef, axis=0)
    dc2 = _grad_coord(c2, ydef, axis=0)
    return f, c1, c2, dc1, dc2, None


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


def build_geoadjustment(h0, hdef, grid: Grid, mp):
    """Geostrophic adjustment, 1-D standard form (apps.py:1527-1552)."""
    if grid.coord_type != "lat":
        raise ValueError("geoadjustment supports coords='lat' only")
    g = mp["g"]
    f, fH, cosG, cosH, _ = _coriolis_profiles(grid, mp, 0)
    A = _like(cosH / fH, h0)
    B = -_like(f * cosG, h0) / g / _fill(h0, hdef, UNDEFTMP)
    Fs = _like(-f * cosG / g, h0).expand(h0.shape)
    return stencil.standard_1d(A, B, Fs, hdef, grid.deltas, grid.bcs)


def build_refstate_swm(Q, Qdef, grid: Grid, mp):
    """Shallow-water reference state, 1-D (apps.py:1470-1524)."""
    if grid.coord_type != "lat":
        raise ValueError("refstate_swm supports coords='lat' only")
    g, Re, Om = mp["g"], mp["Rearth"], mp["Omega"]
    M0 = np.asarray(mp["M0"], np.float64)
    C0 = np.asarray(mp["C0"], np.float64)
    latr = np.deg2rad(grid.coords[0])
    cosG, cosH, sinG = np.cos(latr), np.cos(_half(latr)), np.sin(latr)
    asin = Re * sinG
    acos = Re * cosG
    acos = np.where(acos < 0, -acos * 0.1, acos)  # positive near poles
    delY = abs(latr[0] - latr[1]) * Re
    # diff = d/dy((1/cosH) dM0/dy): the reference's local numba diff_2nd
    # (apps.py:1482-1493), zero at the end points; on the host
    diff = np.zeros_like(M0)
    dM = np.diff(M0)  # M[j+1] - M[j]
    diff[1:-1] = (dM[1:] / cosH[2:] - dM[:-1] / cosH[1:-1]) / delY ** 2
    A = _like(1.0 / cosH, Q)
    B = (-_like(C0, Q) * _fill(Q, Qdef, UNDEFTMP)
         * _like(asin / (np.pi * g * acos ** 3), Q))
    Fs = _like(-(asin * C0 ** 2 / (2.0 * np.pi * g * acos ** 3))
               + (2.0 * np.pi * Om ** 2 * asin * acos) / g - diff, Q)
    Fs = Fs.expand(Q.shape)
    return stencil.standard_1d(A, B, Fs, Qdef, grid.deltas, grid.bcs)


def refstate_std_coeffs(Q, Qdef, grid: Grid, mp):
    """The RefState A/C planes and filled forcing (apps.py:1440-1467).

    The reference divides by the sentinel-filled PV and by the raw second
    coordinate (degrees for z-lat); replicated as-is.
    """
    nd = grid.ndim
    shape = grid.shape
    Gamma = np.asarray(mp["Gamma"], np.float64)
    g = mp["g"]
    Q_sent = _fill(Q, Qdef, UNDEFTMP)
    x = _bcast(grid.coords[1], nd, 1)
    if grid.coord_type == "z-lat":
        A = np.broadcast_to(
            _bcast(np.sin(np.deg2rad(grid.coords[1])), nd, 1), shape)
    elif grid.coord_type == "cartesian":
        ang0 = mp.get("Ang0", mp.get("ang0"))
        A = np.broadcast_to(2.0 * ang0 / x ** 3, shape)
    else:
        raise ValueError("refstate supports z-lat or cartesian")
    C = _like(Gamma, Q) * g / Q_sent / _like(x, Q)
    return _like(A, Q), 0.0, C, _fill(Q, Qdef)


def build_refstate(Q, Qdef, grid: Grid, mp):
    """Balanced symmetric-vortex PV inversion (apps.py:1440-1467)."""
    A, B, C, Fs = refstate_std_coeffs(Q, Qdef, grid, mp)
    return stencil.standard_2d(A, B, C, Fs, Qdef, grid.deltas, grid.bcs,
                               include_cross=False)


def pv2d_std_coeffs(PV, PVdef, grid: Grid, mp):
    """The PV2D A/B/C planes and filled forcing (apps.py:1556-1579); shared
    by the SOR builder and the multigrid entry point."""
    A = np.broadcast_to(np.asarray(mp["f0"], np.float64) ** 2
                        / np.asarray(mp["N2"], np.float64), grid.shape)
    return _like(A, PV), 0.0, _ones(PV, grid), _fill(PV, PVdef)


def build_pv2d(PV, PVdef, grid: Grid, mp):
    """QG PV inversion in (p, y) (apps.py:1556-1579)."""
    A, B, C, Fs = pv2d_std_coeffs(PV, PVdef, grid, mp)
    return stencil.standard_2d(A, B, C, Fs, PVdef, grid.deltas, grid.bcs,
                               include_cross=False)


def eliassen_std_coeffs(F, Fdef, grid: Grid, mp):
    """The Eliassen A/B/C planes and filled forcing (apps.py:1582-1606)."""
    A, B, C = (_like(np.broadcast_to(np.asarray(mp[k], np.float64),
                                     grid.shape), F) for k in "ABC")
    return A, B, C, _fill(F, Fdef)


def build_eliassen(F, Fdef, grid: Grid, mp):
    """Sawyer-Eliassen overturning with full cross terms (apps.py:1582-1606)."""
    A, B, C, Fs = eliassen_std_coeffs(F, Fdef, grid, mp)
    return stencil.standard_2d(A, B, C, Fs, Fdef, grid.deltas, grid.bcs,
                               include_cross=True)


def gillmatsuno_coeffs(Q, Qdef, grid: Grid, mp):
    """Gill-Matsuno general-2D coefficient planes (A..F) and filled forcing
    G (apps.py:1609-1657)."""
    Phi = mp["Phi"]
    f, c1, c2, dc1, dc2, latr = _gm_c1c2(grid, mp)
    if grid.coord_type == "lat-lon":
        cosL = np.cos(latr)
        A = c1 * Phi
        C = c1 * Phi / cosL ** 2
        D = Phi * (dc1 + c1 * np.tan(latr) / mp["Rearth"])
        E = -Phi * dc2 / cosL
    else:
        A = c1 * Phi
        C = c1 * Phi
        D = Phi * dc1
        E = -Phi * dc2
    Fc = _core(-np.asarray(mp["epsilon"], np.float64), Q, grid)
    return (_core(A, Q, grid), _zeros(Q, grid), _core(C, Q, grid),
            _core(D, Q, grid), _core(E, Q, grid), Fc, _fill(Q, Qdef))


def build_gillmatsuno(Q, Qdef, grid: Grid, mp):
    """Gill-Matsuno heat-induced circulation, general 2D (apps.py:1609-1657)."""
    A, B, C, D, E, Fc, G = gillmatsuno_coeffs(Q, Qdef, grid, mp)
    return stencil.general_2d(A, B, C, D, E, Fc, G, Qdef, grid.deltas,
                              grid.bcs)


def gillmatsuno_test_e_coeffs(Q, Qdef, grid: Grid, mp):
    """Gill-Matsuno standardised-form +E psi planes (apps.py:1660-1709)."""
    nd = grid.ndim
    Phi, eps = mp["Phi"], _bcast(mp["epsilon"], nd, 0)

    def pr(p):                       # profiles to core rank (Field mp)
        return _bcast(p, nd, 0)
    if grid.coord_type == "lat-lon":
        latr = np.deg2rad(grid.coords[0])
        cosG, cosH = pr(np.cos(latr)), pr(np.cos(_half(latr)))
        # lift the sin profiles before the Omega product (Field Omega)
        fG = 2.0 * mp["Omega"] * pr(np.sin(latr))
        fH = 2.0 * mp["Omega"] * pr(np.sin(_half(latr)))
        scaleF = cosG
    else:
        y = np.asarray(grid.coords[0], np.float64)
        fG = mp["f0"] + mp["beta"] * pr(y)
        fH = mp["f0"] + mp["beta"] * pr(_half(y))
        cosG = np.ones(pr(y).shape)
        cosH = np.ones(pr(y).shape)
        scaleF = None
    c1G = eps / (eps ** 2 + fG ** 2)
    c1H = eps / (eps ** 2 + fH ** 2)
    c2G = fG / (eps ** 2 + fG ** 2)
    A = _core(c1H * Phi * cosH, Q, grid)
    B = _core(-c2G * Phi, Q, grid)
    C = _core(c2G * Phi, Q, grid)
    D = _core(c1G * Phi / cosG, Q, grid)
    E = _core(-eps * cosG, Q, grid)
    Fs = _fill(Q, Qdef)
    if scaleF is not None:
        Fs = Fs * _like(_bcast(scaleF, nd, 0), Q)
    return A, B, C, D, E, Fs


def build_gillmatsuno_test(Q, Qdef, grid: Grid, mp):
    """Gill-Matsuno in standardised (flux) form (apps.py:1660-1709)."""
    A, B, C, D, E, Fs = gillmatsuno_test_e_coeffs(Q, Qdef, grid, mp)
    return stencil.standard_2d_e(A, B, C, D, E, Fs, Qdef, grid.deltas,
                                 grid.bcs)


def stommel_coeffs(curl, cdef, grid: Grid, mp):
    """Stommel general-2D coefficient planes (apps.py:1712-1748)."""
    nd = grid.ndim
    R = _bcast(mp["R"], nd, 0)
    depth, rho0 = _bcast(mp["D"], nd, 0), _bcast(mp["rho0"], nd, 0)
    zero = _zeros(curl, grid)
    if grid.coord_type == "lat-lon":
        latr = np.deg2rad(grid.coords[0])
        cosL = _bcast(np.cos(latr), nd, 0)
        A = _core(-R / depth, curl, grid)
        C = _core(-R / depth / cosL ** 2, curl, grid)
        E = _core(-2.0 * np.asarray(mp["Omega"], np.float64)
                  / np.asarray(mp["Rearth"], np.float64), curl, grid)
    else:
        A = _core(-R / depth, curl, grid)
        C = _core(-R / depth, curl, grid)
        E = _core(-np.asarray(mp["beta"], np.float64), curl, grid)
    G = -_fill(curl, cdef) / _like(depth * rho0, curl)
    return A, zero, C, zero, E, zero, G


def build_stommel(curl, cdef, grid: Grid, mp):
    """Stommel wind-driven gyre, general 2D (apps.py:1712-1748)."""
    A, B, C, D, E, Fc, G = stommel_coeffs(curl, cdef, grid, mp)
    return stencil.general_2d(A, B, C, D, E, Fc, G, cdef, grid.deltas,
                              grid.bcs)


def stommel_test_e_coeffs(curl, cdef, grid: Grid, mp):
    """Stommel standardised-form +E psi planes (apps.py:1751-1790)."""
    nd = grid.ndim
    R = _bcast(mp["R"], nd, 0)
    depth, rho0 = _bcast(mp["D"], nd, 0), _bcast(mp["rho0"], nd, 0)

    def pr(p):
        return _bcast(p, nd, 0)
    if grid.coord_type == "lat-lon":
        latr = np.deg2rad(grid.coords[0])
        cosG, cosH = pr(np.cos(latr)), pr(np.cos(_half(latr)))
        f = 2.0 * mp["Omega"] * pr(np.sin(latr))
        A = _core(-R / depth * cosH, curl, grid)
        D = _core(-R / depth / cosG, curl, grid)
        Fs = (-_fill(curl, cdef) / _like(depth * rho0, curl)
              * _core(cosG, curl, grid))
    else:
        f = mp["f0"] + mp["beta"] * pr(np.asarray(grid.coords[0],
                                                  np.float64))
        A = _core(-R / depth, curl, grid)
        D = _core(-R / depth, curl, grid)
        Fs = -_fill(curl, cdef) / _like(depth * rho0, curl)
    return (A, _core(-f, curl, grid), _core(f, curl, grid), D,
            _zeros(curl, grid), Fs)


def build_stommel_test(curl, cdef, grid: Grid, mp):
    """Stommel in standardised form (apps.py:1751-1790)."""
    A, B, C, D, E, Fs = stommel_test_e_coeffs(curl, cdef, grid, mp)
    return stencil.standard_2d_e(A, B, C, D, E, Fs, cdef, grid.deltas,
                                 grid.bcs)


def stommelmunk_coeffs(curl, cdef, grid: Grid, mp):
    """The Stommel-Munk A..I planes and forcing J (apps.py:1793-1836)."""
    nd = grid.ndim
    A4, R = _bcast(mp["A4"], nd, 0), _bcast(mp["R"], nd, 0)
    depth, rho0 = _bcast(mp["D"], nd, 0), _bcast(mp["rho0"], nd, 0)
    zero = _zeros(curl, grid)
    if grid.coord_type == "lat-lon":
        latr = np.deg2rad(grid.coords[0])
        icos2 = _bcast(1.0 / np.cos(latr) ** 2, nd, 0)
        A = _core(A4, curl, grid)
        C = _core(A4 * icos2, curl, grid)
        D = _core(-R / depth, curl, grid)
        Fc = _core(-R / depth * icos2, curl, grid)
        H = _core(-2.0 * np.asarray(mp["Omega"], np.float64)
                  / np.asarray(mp["Rearth"], np.float64), curl, grid)
    else:
        A = _core(A4, curl, grid)
        C = _core(A4, curl, grid)
        D = _core(-R / depth, curl, grid)
        Fc = _core(-R / depth, curl, grid)
        H = _core(-np.asarray(mp["beta"], np.float64), curl, grid)
    J = -_fill(curl, cdef) / _like(depth * rho0, curl)
    return (A, zero, C, D, zero, Fc, zero, H, zero), J


def build_stommelmunk(curl, cdef, grid: Grid, mp):
    """Stommel-Munk gyre with biharmonic viscosity (apps.py:1793-1836)."""
    coeffs, J = stommelmunk_coeffs(curl, cdef, grid, mp)
    return stencil.general_2d_bih(*coeffs, J, cdef, grid.deltas, grid.bcs)


def stommelarons_coeffs(Q, Qdef, grid: Grid, mp):
    """Stommel-Arons general-2D coefficient planes (apps.py:1839-1886)."""
    f, c1, c2, dc1, dc2, latr = _gm_c1c2(grid, mp)
    if grid.coord_type == "lat-lon":
        cosL = np.cos(latr)
        A = c1
        C = c1 / cosL ** 2
        D = dc1 + c1 * np.tan(latr) / mp["Rearth"]
        E = -dc2 / cosL
    else:
        A, C, D, E = c1, c1, dc1, -dc2
    zero = _zeros(Q, grid)
    return (_core(A, Q, grid), zero, _core(C, Q, grid), _core(D, Q, grid),
            _core(E, Q, grid), zero, _fill(Q, Qdef))


def build_stommelarons(Q, Qdef, grid: Grid, mp):
    """Stommel-Arons abyssal circulation, general 2D (apps.py:1839-1886)."""
    A, B, C, D, E, Fc, G = stommelarons_coeffs(Q, Qdef, grid, mp)
    return stencil.general_2d(A, B, C, D, E, Fc, G, Qdef, grid.deltas,
                              grid.bcs)


def geostrophic_std_coeffs(lapPhi, Fdef, grid: Grid, mp):
    """The geostrophic A/C planes and scaled forcing (apps.py:1889-1931),
    with the near-equator f regularisation."""
    nd = grid.ndim

    def pr(p):
        return _bcast(p, nd, 0)
    if grid.coord_type == "lat-lon":
        latr = np.deg2rad(grid.coords[0])
        sinG, sinH = pr(np.sin(latr)), pr(np.sin(_half(latr)))
        cosG, cosH = pr(np.cos(latr)), pr(np.cos(_half(latr)))
        fH = 2.0 * mp["Omega"] * sinH
        fG = 2.0 * mp["Omega"] * sinG
        fH = np.where(np.abs(fH) < 2e-5, fH * 1.5, fH)   # apps.py:1909-1910
        fG = np.where(np.abs(fG) < 2e-5, fG * 1.5, fG)
        A = _core(fH * cosH, lapPhi, grid)
        C = _core(fG / cosG, lapPhi, grid)
        Fs = _fill(lapPhi, Fdef) * _core(cosG, lapPhi, grid)
    else:
        y = np.asarray(grid.coords[0], np.float64)
        fG = mp["f0"] + mp["beta"] * pr(y)
        fH = mp["f0"] + mp["beta"] * pr(_half(y))
        A = _core(fH, lapPhi, grid)
        C = _core(fG, lapPhi, grid)
        Fs = _fill(lapPhi, Fdef)
    return A, 0.0, C, Fs


def build_geostrophic(lapPhi, Fdef, grid: Grid, mp):
    """Geostrophic streamfunction from Laplacian of geopotential
    (apps.py:1889-1931), with the near-equator f regularisation."""
    A, B, C, Fs = geostrophic_std_coeffs(lapPhi, Fdef, grid, mp)
    return stencil.standard_2d(A, B, C, Fs, Fdef, grid.deltas, grid.bcs,
                               include_cross=False)


def _e_family_coeffs(F, grid, mp, E_param):
    """The A/D/E planes and the Coriolis profile f shared by the
    Bretherton-Haidvogel and Fofonoff +E psi forms (apps.py:1934-2013);
    the E plane is ``-E_param`` (times cos(lat) on the sphere)."""
    nd = grid.ndim
    if grid.coord_type == "lat-lon":
        latr = np.deg2rad(grid.coords[0])
        cosG = _bcast(np.cos(latr), nd, 0)
        cosH = _bcast(np.cos(_half(latr)), nd, 0)
        f = 2.0 * mp["Omega"] * _bcast(np.sin(latr), nd, 0)
        return (_core(cosH, F, grid), _core(1.0 / cosG, F, grid),
                _core(-E_param * cosG, F, grid), f, cosG)
    y = np.asarray(grid.coords[0], np.float64)
    f = mp["f0"] + mp["beta"] * _bcast(y, nd, 0)
    return (_ones(F, grid), _ones(F, grid), _core(-E_param, F, grid), f,
            None)


def bretherton_e_coeffs(h, hdef, grid: Grid, mp):
    """The Bretherton-Haidvogel +E psi planes (apps.py:1934-1972); shared
    by the SOR builder and the multigrid entry point."""
    nd = grid.ndim
    depth, lamb = _bcast(mp["D"], nd, 0), _bcast(mp["lambda"], nd, 0)
    A, D, E, f, cosG = _e_family_coeffs(h, grid, mp, lamb * depth)
    scale = f / depth if cosG is None else f / depth * cosG
    zero = _zeros(h, grid)
    return A, zero, zero, D, E, -_fill(h, hdef) * _like(scale, h)


def build_bretherton(h, hdef, grid: Grid, mp):
    """Bretherton-Haidvogel flow over topography (apps.py:1934-1972)."""
    A, B, C, D, E, Fs = bretherton_e_coeffs(h, hdef, grid, mp)
    return stencil.standard_2d_e(A, B, C, D, E, Fs, hdef, grid.deltas,
                                 grid.bcs)


def fofonoff_e_coeffs(F, Fdef, grid: Grid, mp):
    """The Fofonoff +E psi planes (apps.py:1975-2013); the forcing is made
    from the Coriolis profile, the input F gives only its shape and mask.
    Shared by the SOR builder and the multigrid entry point."""
    nd = grid.ndim
    c0, c1 = _bcast(mp["c0"], nd, 0), _bcast(mp["c1"], nd, 0)
    A, D, E, f, cosG = _e_family_coeffs(F, grid, mp, c0)
    Fs = _core(c1 - f if cosG is None else (c1 - f) * cosG, F, grid)
    zero = _zeros(F, grid)
    return A, zero, zero, D, E, torch.broadcast_to(Fs, F.shape)


def build_fofonoff(F, Fdef, grid: Grid, mp):
    """Fofonoff inviscid free mode (apps.py:1975-2013)."""
    A, B, C, D, E, Fs = fofonoff_e_coeffs(F, Fdef, grid, mp)
    return stencil.standard_2d_e(A, B, C, D, E, Fs, Fdef, grid.deltas,
                                 grid.bcs)


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
    "refstate": build_refstate,
    "pv2d": build_pv2d,
    "eliassen": build_eliassen,
    "gillmatsuno": build_gillmatsuno,
    "gillmatsuno_test": build_gillmatsuno_test,
    "stommel": build_stommel,
    "stommel_test": build_stommel_test,
    "stommelmunk": build_stommelmunk,
    "stommelarons": build_stommelarons,
    "geostrophic": build_geostrophic,
    "brethertonhaidvogel": build_bretherton,
    "fofonoff": build_fofonoff,
    "omega": build_omega,
    "3docean": build_ocean3d,
    "geoadjustment": build_geoadjustment,
    "refstateswm": build_refstate_swm,
}
