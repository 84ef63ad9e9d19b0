# -*- coding: utf-8 -*-
"""Plain reference of omega_nb11: the quasi-geostrophic omega equation of
xinvert's ``invert_omega`` (apps.py:766-827, coefficients
apps.py:2016-2052, the standard 3-D kernel numbas.py:16-212) on pressure
levels of a lat-lon grid, worked out again from the forcing, the
coordinates and the N2 level profile:

    d/dp(A dw/dp) + d/dy(B dw/dy) + d/dx(C dw/dx) = F cos(lat),
    A = f^2 cos(lat), f = 2 Omega sin(lat),
    B = N2(p) cos(lat) at the half grid in y (between rows j-1 and j),
    C = N2(p) / cos(lat),

with dp the level step (Pa) and dy, dx the grid steps in metres on a sphere
of radius Rearth.  Folded per point (r2 = (dx/dp)^2, r1 = (dx/dy)^2):

    w(+-1,0,0) = A r2, w(0,+1,0) = B[j+1] r1, w(0,-1,0) = B[j] r1,
    w(0,0,+-1) = C,  w0 = -2 A r2 - (B[j+1] + B[j]) r1 - 2 C,
    g = -F cos(lat) dx^2.

Active points: levels 1..nz-2, rows 1..ny-2, every column (x periodic),
where the forcing is defined.  BCs: fixed in p and y, periodic in x; no
extend.  The 3-D kernel has no zero-norm stop.
"""
from __future__ import annotations

import numpy as np
import torch

from . import redblack

OFFSETS = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
           (0, 0, -1))
#: 2K + 4 with K = 6 (redblack.flops_per_point_sweep)
FLOPS_PER_POINT_SWEEP = 16


def coords(cfg):
    g = cfg["grid"]
    return tuple(np.linspace(*g[d]) for d in ("LEV", "lat", "lon"))


def n2_profile(cfg):
    """N2 on each level: ``upper`` above ``split_pa``, ``lower`` below."""
    lev = coords(cfg)[0]
    n2 = cfg["N2"]
    return np.where(lev > n2["split_pa"], n2["lower"], n2["upper"])


def active(cfg, values):
    defined = ~np.isnan(values)
    inner = np.zeros(values.shape[-3:], bool)
    inner[1:-1, 1:-1, :] = True
    return defined & inner


def coefficient_elements(cfg):
    """Elements of the coefficient planes at their own shapes: A varies
    with latitude, B and C with level and latitude."""
    nz, ny = cfg["grid"]["LEV"][2], cfg["grid"]["lat"][2]
    return ny + 2 * nz * ny


def build(cfg, values, dtype, device):
    lev, lat, lon = coords(cfg)
    R = float(cfg["constants"]["Rearth"])
    Om = float(cfg["constants"]["Omega"])
    latr = np.deg2rad(lat)
    dp = lev[1] - lev[0]
    dy = np.deg2rad(lat[1] - lat[0]) * R
    dx = np.deg2rad(lon[1] - lon[0]) * R
    r2, r1 = (dx / dp) ** 2, (dx / dy) ** 2
    nz, ny, nx = values.shape[-3:]
    N2 = n2_profile(cfg)[:, None]                      # (nz, 1)
    cosG = np.cos(latr)
    cosH = np.empty(ny)
    cosH[0] = np.nan
    cosH[1:] = np.cos(0.5 * (latr[1:] + latr[:-1]))
    f = 2.0 * Om * np.sin(latr)
    A = (f ** 2 * cosG)[None, :]                       # (1, ny)
    B = N2 * cosH[None, :]                             # (nz, ny), B[j]
    Bnext = np.concatenate([B[:, 1:], np.full((nz, 1), np.nan)], axis=1)
    C = N2 / cosG[None, :]
    act = active(cfg, values)
    F = np.where(act, np.nan_to_num(values.astype(np.float64)), 0.0)

    def plane(a):
        p = np.broadcast_to(np.broadcast_to(a, (nz, ny))[:, :, None],
                            (nz, ny, nx))
        return np.where(act, p, 0.0)

    weights = {(1, 0, 0): plane(A * r2), (-1, 0, 0): plane(A * r2),
               (0, 1, 0): plane(Bnext * r1), (0, -1, 0): plane(B * r1),
               (0, 0, 1): plane(C), (0, 0, -1): plane(C)}
    w0 = plane(-2.0 * A * r2 - (Bnext + B) * r1 - 2.0 * C)
    g = np.where(act, -F * cosG[None, :, None] * dx * dx, 0.0)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64,
                               device=device).to(dtype)

    return redblack.Problem(
        weights={k: t(v) for k, v in weights.items()}, w0=t(w0), g=t(g),
        active=torch.as_tensor(act, device=device),
        zero_norm_stops=False)
