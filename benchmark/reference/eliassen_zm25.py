# -*- coding: utf-8 -*-
"""Plain reference of eliassen_zm25: the Sawyer-Eliassen balanced
overturning of xinvert's ``invert_Eliassen`` (apps.py:300-346,
coefficients apps.py:1582-1606, which pass the user's A, B and C through,
and the standard 2-D kernel numbas.py:216-416) on a (p, lat) grid, worked
out again from the forcing, the coordinates and the basic state:

    d/dp(A dS/dp + B dS/dy) + d/dy(B dS/dp + C dS/dy) = F,

y in metres of arc on a sphere of radius Rearth, p in Pa (its step is
negative: the levels run from 1000 to 100 hPa), A, B and C the basic
state's planes (``benchmark.inputs.eliassen_zm25.coefficients``: data, as
weights are).  The source's kernel, with ratio = dy / dp of the steps,
r2 = ratio^2, rq = ratio / 4, and j along p, i along lat, reads A[j+1]
and A[j] at the half levels around row j and C[i+1] and C[i] at the half
latitudes around column i:

    w(+1, 0) = A[j+1] r2,  w(-1, 0) = A[j] r2,
    w(0, +1) = C[i+1],     w(0, -1) = C[i],
    w(+1, +1) =  (B[j+1, i] + B[j, i+1]) rq,
    w(+1, -1) = -(B[j+1, i] + B[j, i-1]) rq,
    w(-1, +1) = -(B[j-1, i] + B[j, i+1]) rq,
    w(-1, -1) =  (B[j-1, i] + B[j, i-1]) rq,
    w0 = -(A[j+1] + A[j]) r2 - (C[i+1] + C[i]),  g = -F dy^2.

The four diagonal weights are the cross derivative's.  Active points:
rows 1..ny-2 and columns 1..nx-2 (BCs fixed on both axes: no pre-pass),
where the forcing is defined.  Relaxation: the grid's optimal factor, as
the source's Hadley case takes it.  One departure from the source: the
sweeps run in red-black order, not the source's lexicographic order, as
the program documents for its engine.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.inputs import eliassen_zm25 as inputs

from . import redblack

#: offsets of the folded stencil: four axis neighbours and four diagonals
OFFSETS = ((1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (1, -1), (-1, 1),
           (-1, -1))
#: 2K + 4 with K = 8 (redblack.flops_per_point_sweep)
FLOPS_PER_POINT_SWEEP = 20


def active(cfg, values):
    """(B, ny, nx) bool: the points a sweep updates."""
    inner = np.zeros(values.shape[-2:], bool)
    inner[1:-1, 1:-1] = True
    return ~np.isnan(values) & inner


def coefficient_elements(cfg):
    """Elements of the coefficient planes at their own shapes: A, B and C
    each vary over (LEV, lat)."""
    return 3 * cfg["grid"]["LEV"][2] * cfg["grid"]["lat"][2]


def build(cfg, values, dtype, device):
    """The folded problem of B forcings ``values`` (B, ny, nx, NaN where
    undefined), its planes computed in float64 and then cast to
    ``dtype``."""
    c = inputs.coords(cfg)
    lev, lat = c["LEV"], c["lat"]
    dp = lev[1] - lev[0]
    dy = np.deg2rad(lat[1] - lat[0]) * float(cfg["constants"]["Rearth"])
    r2, rq = (dy / dp) ** 2, dy / dp / 4.0
    A, B, C = inputs.coefficients(cfg)

    def at(P, oj, oi):
        """P[j + oj, i + oi] (wrapping; read only where active)."""
        return np.roll(P, (-oj, -oi), axis=(0, 1))

    n = {(1, 0): at(A, 1, 0) * r2, (-1, 0): A * r2,
         (0, 1): at(C, 0, 1), (0, -1): C,
         (1, 1): (at(B, 1, 0) + at(B, 0, 1)) * rq,
         (1, -1): -(at(B, 1, 0) + at(B, 0, -1)) * rq,
         (-1, 1): -(at(B, -1, 0) + at(B, 0, 1)) * rq,
         (-1, -1): (at(B, -1, 0) + at(B, 0, -1)) * rq}
    w0 = -(at(A, 1, 0) + A) * r2 - (at(C, 0, 1) + C)
    act = active(cfg, values)
    F = np.nan_to_num(values.astype(np.float64))

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(np.where(act, a, 0.0)),
                               dtype=torch.float64, device=device).to(dtype)

    return redblack.Problem(
        weights={off: t(n[off]) for off in OFFSETS}, w0=t(w0),
        g=t(-F * dy * dy), active=torch.as_tensor(act, device=device),
        zero_norm_stops=True)
