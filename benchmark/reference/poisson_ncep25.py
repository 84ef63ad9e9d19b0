# -*- coding: utf-8 -*-
"""Plain reference of poisson_ncep25: the masked spherical Poisson
equation of xinvert's ``invert_Poisson`` (apps.py:67-100, coefficients
apps.py:1397-1437, the standard 2-D kernel numbas.py:216-416) on a lat-lon
grid, worked out again from the forcing and the coordinates:

    d/dy(A dS/dy) + d/dx(C dS/dx) = F cos(lat),
    A = cos(lat) at the half grid in y (between rows j-1 and j),
    C = 1 / cos(lat),

with dy and dx the grid steps in metres on a sphere of radius Rearth.
Folded per point (ratio = dx/dy):

    w(+1,0) = A[j+1] ratio^2, w(-1,0) = A[j] ratio^2, w(0,+-1) = C[j],
    w0 = -(A[j+1] + A[j]) ratio^2 - 2 C[j],  g = -F cos(lat) dx^2.

Active points: rows 1..ny-2, every column (x periodic), where the forcing
is defined.  BCs: extend in y (``redblack.one_row_extend``), periodic in
x.
"""
from __future__ import annotations

import numpy as np
import torch

from . import redblack

#: offsets of the folded stencil: four neighbours
OFFSETS = ((1, 0), (-1, 0), (0, 1), (0, -1))
#: 2K + 4 with K = 4 (redblack.flops_per_point_sweep)
FLOPS_PER_POINT_SWEEP = 12


def coords(cfg):
    (y0, y1, ny), (x0, x1, nx) = cfg["grid"]["lat"], cfg["grid"]["lon"]
    return np.linspace(y0, y1, ny), np.linspace(x0, x1, nx)


def active(cfg, values):
    """(B, ny, nx) bool: the points a sweep updates."""
    defined = ~np.isnan(values)
    inner = np.zeros(values.shape[-2:], bool)
    inner[1:-1, :] = True
    return defined & inner


def coefficient_elements(cfg):
    """Elements of the coefficient planes at their own shapes: A and C
    vary with latitude alone."""
    return 2 * cfg["grid"]["lat"][2]


def build(cfg, values, dtype, device):
    """The folded problem of B fields ``values`` (B, ny, nx, NaN where
    undefined), its planes computed in float64 and then cast to
    ``dtype``."""
    lat, lon = coords(cfg)
    R = float(cfg["constants"]["Rearth"])
    latr = np.deg2rad(lat)
    dy = np.deg2rad(lat[1] - lat[0]) * R
    dx = np.deg2rad(lon[1] - lon[0]) * R
    rsq = (dx / dy) ** 2
    ny, nx = values.shape[-2:]
    cosG = np.cos(latr)
    A = np.empty(ny)                       # A[j] between rows j-1 and j
    A[0] = np.nan
    A[1:] = np.cos(0.5 * (latr[1:] + latr[:-1]))
    Anext = np.append(A[1:], np.nan)       # A[j+1]
    C = 1.0 / cosG
    act = active(cfg, values)
    F = np.where(act, np.nan_to_num(values.astype(np.float64)), 0.0)

    def plane(col):
        p = np.broadcast_to(col[:, None], (ny, nx))
        return np.where(act, p, 0.0)

    weights = {(1, 0): plane(Anext * rsq), (-1, 0): plane(A * rsq),
               (0, 1): plane(C), (0, -1): plane(C)}
    w0 = plane(-(Anext + A) * rsq - 2.0 * C)
    g = np.where(act, -F * cosG[:, None] * dx * dx, 0.0)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64,
                               device=device).to(dtype)

    return redblack.Problem(
        weights={k: t(v) for k, v in weights.items()}, w0=t(w0), g=t(g),
        active=torch.as_tensor(act, device=device),
        zero_norm_stops=True, prepass=redblack.one_row_extend)
