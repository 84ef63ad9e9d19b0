# -*- coding: utf-8 -*-
"""Plain reference of stommelmunk_soda05: the Stommel-Munk gyre with
biharmonic viscosity of xinvert's ``invert_StommelMunk`` (apps.py:537-582,
coefficients apps.py:1793-1836, the general biharmonic 2-D kernel
general_bih_2D) on a lat-lon grid, worked out again from the curl and the
coordinates:

    A Syyyy + C Sxxxx + D Syy + F Sxx + H Sx = J,
    A = A4, C = A4 / cos^2(lat), D = -R / depth, F = -R / (depth cos^2),
    H = -2 Omega / Rearth, J = -curl / (rho0 depth),

x and y in metres of arc on a sphere of radius Rearth.  Times dx^4 with
r = dx / dy, the centred differences (fourth 1 -4 6 -4 1, second 1 -2 1,
first -1/2 0 1/2) give the neighbour terms n and the centre term c; the
reference's form takes w = -n, w0 = -c, g = J dx^4.  The cross terms are
zero here, so the folded stencil keeps 8 offsets.

Active points: rows 2..ny-3 (the biharmonic's two-row ring), every column
(x periodic), where the curl is defined.  BCs: extend in y by the source's
sequential two-row pre-pass (``two_row_extend``), periodic in x; the
source's relaxation factor, its optArg, is 1.
"""
from __future__ import annotations

import numpy as np
import torch

from . import redblack

#: offsets of the folded stencil: the 8 nonzero terms of the biharmonic
OFFSETS = ((2, 0), (-2, 0), (1, 0), (-1, 0), (0, 2), (0, -2), (0, 1),
           (0, -1))
#: 2K + 4 with K = 8 (redblack.flops_per_point_sweep)
FLOPS_PER_POINT_SWEEP = 20
#: the source's optArg (tests/test_MunkWBC.py:66-84)
RELAXATION = 1.0


def two_row_extend(S):
    """The biharmonic extend of xinvert's general_bih_2D with x periodic,
    in its sequential order: S[0] = S[1], then S[1] = S[2];
    S[-1] = S[-2] = S[-3]."""
    S = S.clone()
    S[..., 0, :] = S[..., 1, :]
    S[..., 1, :] = S[..., 2, :]
    bottom = S[..., -3, :].clone()
    S[..., -1, :] = bottom
    S[..., -2, :] = bottom
    return S


def coords(cfg):
    (y0, y1, ny), (x0, x1, nx) = cfg["grid"]["lat"], cfg["grid"]["lon"]
    return np.linspace(y0, y1, ny), np.linspace(x0, x1, nx)


def active(cfg, values):
    """(B, ny, nx) bool: the points a sweep updates."""
    inner = np.zeros(values.shape[-2:], bool)
    inner[2:-2, :] = True
    return ~np.isnan(values) & inner


def coefficient_elements(cfg):
    """Elements of the coefficient planes at their own shapes: C and F vary
    with latitude alone, A, D and H are constants."""
    return 2 * cfg["grid"]["lat"][2] + 3


def build(cfg, values, dtype, device):
    """The folded problem of B curls ``values`` (B, ny, nx, NaN over land),
    its planes computed in float64 and then cast to ``dtype``."""
    mp, const = cfg["mParams"], cfg["constants"]
    lat, lon = coords(cfg)
    Re = float(const["Rearth"])
    dy = np.deg2rad(lat[1] - lat[0]) * Re
    dx = np.deg2rad(lon[1] - lon[0]) * Re
    r4, r2 = (dx / dy) ** 4, (dx / dy) ** 2
    icos2 = 1.0 / np.cos(np.deg2rad(lat)) ** 2
    A4, R, depth = float(mp["A4"]), float(mp["R"]), float(mp["D"])
    A, C = A4, A4 * icos2
    D, F = -R / depth, -R / depth * icos2
    H = -2.0 * float(const["Omega"]) / Re
    n = {(2, 0): A * r4, (-2, 0): A * r4,
         (1, 0): -4 * A * r4 + D * r2 * dx ** 2,
         (-1, 0): -4 * A * r4 + D * r2 * dx ** 2,
         (0, 2): C, (0, -2): C,
         (0, 1): -4 * C + F * dx ** 2 + H * dx ** 3 / 2,
         (0, -1): -4 * C + F * dx ** 2 - H * dx ** 3 / 2}
    c = 6 * (A * r4 + C) - 2 * (D * r2 + F) * dx ** 2
    act = active(cfg, values)
    J = -np.nan_to_num(values.astype(np.float64)) / (
        float(const["rho0"]) * depth)
    ny, nx = values.shape[-2:]

    def plane(col):
        """A term that varies with latitude (or is constant), where
        active."""
        col = np.broadcast_to(col, (ny,))[:, None]
        return np.where(act, np.broadcast_to(col, (ny, nx)), 0.0)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64,
                               device=device).to(dtype)

    return redblack.Problem(
        weights={off: t(plane(-n[off])) for off in OFFSETS},
        w0=t(plane(-c)), g=t(np.where(act, J * dx ** 4, 0.0)),
        active=torch.as_tensor(act, device=device),
        zero_norm_stops=False, prepass=two_row_extend)
