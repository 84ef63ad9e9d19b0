# -*- coding: utf-8 -*-
"""Seeded forcing of omega_nb11: QG-omega right-hand sides on 37 pressure
levels of a 72 x 288 lat-lon grid, and the N2 level profile.

A frozen copy of the recipe of chip_smoke.py:313-340 (``atmos3d``): a
baroclinic wave train at mid-latitudes,
    F = 1e-15 sum_{k=4..8} a_k sin(k lon + p_k) / k
        * exp(-((|lat| - 45 deg) / 15 deg)^2) * sin(pi (1e5 - p) / 9e4),
a_k standard normal and p_k uniform on [0, 6); N2 of 1.5e-5 below 250 hPa
and 6e-5 above.  The one change: every field draws its own amplitudes and
phases from the run's seed, in order (chip_smoke's stacks scaled copies of
one field).  Values are float32.  A change to chip_smoke.py moves no
number here.
"""
from __future__ import annotations

import numpy as np

from benchmark.reference.omega_nb11 import n2_profile


def coords(cfg):
    g = cfg["grid"]
    return {d: np.linspace(*g[d]) for d in cfg["dims"]}


def fields(cfg, n, rng):
    """(n, nz, ny, nx) float32: ``n`` fields drawn from ``rng``."""
    c = coords(cfg)
    lev, lat, lon = c["LEV"], c["lat"], c["lon"]
    L = np.deg2rad(lat)
    envelope = np.exp(-((np.abs(L) - np.deg2rad(45)) / np.deg2rad(15)) ** 2)
    vertical = np.sin(np.pi * (100000.0 - lev) / 90000.0)
    k = np.arange(4, 9)
    amp = rng.standard_normal((n, k.size))
    phase = rng.uniform(0.0, 6.0, (n, k.size))
    wave = np.einsum("nk,nkx->nx", amp / k,
                     np.sin(k[None, :, None] * np.deg2rad(lon)[None, None, :]
                            + phase[:, :, None]))
    plane = (1e-15 * vertical[:, None] * envelope[None, :]).astype(np.float32)
    return (plane[None, :, :, None]
            * wave.astype(np.float32)[:, None, None, :])


def mparams(cfg):
    lev = coords(cfg)["LEV"]
    return {"N2": (n2_profile(cfg), ("LEV",), {"LEV": lev})}
