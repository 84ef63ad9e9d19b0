# -*- coding: utf-8 -*-
"""Seeded forcing of poisson_ncep25: relative-vorticity-like maps on the
73 x 144 global 2.5-degree grid, land masked.

A frozen copy of the recipe of chip_smoke.py:249-267 (``poisson_field``):
sin(3 lon) cos(2 lat) plus 0.1 times standard normal noise, NaN over the
continent-shaped block (rows ny//3 .. ny//2-1, columns nx//4 .. nx//2-1).
The one change: every field draws its own noise from the run's seed, in
order (chip_smoke's draws one batch from a fixed seed).  Values are
float32, as reanalysis files store them.  A change to chip_smoke.py moves
no number here.
"""
from __future__ import annotations

import numpy as np


def coords(cfg):
    g = cfg["grid"]
    return {d: np.linspace(*g[d]) for d in cfg["dims"]}


def fields(cfg, n, rng):
    """(n, ny, nx) float32: ``n`` fields drawn from ``rng``."""
    c = coords(cfg)
    lat, lon = c["lat"], c["lon"]
    ny, nx = lat.size, lon.size
    base = (np.sin(3 * np.deg2rad(lon))[None, :]
            * np.cos(2 * np.deg2rad(lat))[:, None]).astype(np.float32)
    out = rng.standard_normal((n, ny, nx), dtype=np.float32)
    out *= np.float32(0.1)
    out += base
    out[:, ny // 3:ny // 2, nx // 4:nx // 2] = np.nan
    return out


def mparams(cfg):
    """Field-valued mParams as (values, dims, coords): none; the call
    keeps xinvert's defaults."""
    return {}
