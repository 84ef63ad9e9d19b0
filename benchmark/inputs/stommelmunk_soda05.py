# -*- coding: utf-8 -*-
"""Seeded forcing of stommelmunk_soda05: monthly wind-stress curl (N m^-3)
of SODA's 0.5-degree global ocean, 330 x 720, NaN over land.

A frozen copy of the recipe of chip_smoke.py:330-377 (``soda_land_mask``
and ``soda_curl``): smooth blob continents, an Antarctic cap and a partly
closed Arctic (37.4% of the points land); subtropical and subpolar gyre
bands with a seasonal cycle,
    curl = (1 + 0.35 cos(2 pi (m - 1) / 12)) base(lat)
           + 2e-8 texture(lat, lon) cos(lat),
    base = 1e-7 (sin(3 lat) cos(lat) + 0.25 sin(5 lat)),
    texture = sum_{k=2..7} a_k sin(k lon + p_k) cos((k - 1) lat) / k.
The changes: field i is calendar month m = i mod 12 of the cycle; every
field draws its own a_k (standard normal) and p_k (uniform on [0, 6)) from
the run's seed, in order, and a noise of ``NOISE`` times standard normal
at every point (chip_smoke's has one texture from a fixed seed and no
noise).  Values are float32.  A change to chip_smoke.py moves no number
here.
"""
from __future__ import annotations

import numpy as np

#: the noise's standard deviation (N m^-3): 2% of the gyre bands' 1e-7
NOISE = 2e-9
#: fields made at a time (bounds the float32 temporaries)
_CHUNK = 24
#: (lat0, lon0, amplitude, lat scale, lon scale) of the blob continents
_BLOBS = ((10, 280, 1.6, 55, 25), (-25, 295, 1.2, 30, 18),
          (15, 20, 1.7, 45, 30), (50, 80, 1.5, 35, 55),
          (-25, 133, 1.0, 18, 22), (72, 320, 0.9, 12, 25))


def coords(cfg):
    g = cfg["grid"]
    return {d: np.linspace(*g[d]) for d in cfg["dims"]}


def land_mask(lat, lon):
    """(ny, nx) bool: True over land (chip_smoke.py's soda_land_mask)."""
    L, Lo = np.meshgrid(np.deg2rad(lat), np.deg2rad(lon), indexing="ij")
    field = np.zeros_like(L)
    for lat0, lon0, amp, sy, sx in _BLOBS:
        dlat = (L - np.deg2rad(lat0)) / np.deg2rad(sy)
        dlon = np.angle(np.exp(1j * (Lo - np.deg2rad(lon0)))) / np.deg2rad(sx)
        field += amp * np.exp(-dlat ** 2 - dlon ** 2)
    land = field > 0.55
    land |= lat[:, None] < -70.0                     # Antarctica
    land |= (lat[:, None] > 82.0) & (np.cos(2 * Lo) > -0.3)   # Arctic shelf
    return land


def fields(cfg, n, rng):
    """(n, ny, nx) float32: ``n`` monthly fields drawn from ``rng``."""
    c = coords(cfg)
    lat, lon = c["lat"], c["lon"]
    ny, nx = lat.size, lon.size
    land = land_mask(lat, lon)
    L, Lo = np.deg2rad(lat), np.deg2rad(lon)
    k = np.arange(2, 8)
    amp = rng.normal(size=(n, k.size))
    phase = rng.uniform(0.0, 6.0, (n, k.size))
    month = np.arange(n) % 12
    seasonal = 1.0 + 0.35 * np.cos(2 * np.pi * (month - 1) / 12.0)
    base = (np.sin(3 * L) * np.cos(L) + 0.25 * np.sin(5 * L)) * 1e-7
    # texture x 2e-8 cos(lat) = rows @ waves: rows (ny, k), waves (n, k, nx)
    rows = (2e-8 * np.cos((k[None, :] - 1) * L[:, None])
            * np.cos(L)[:, None]).astype(np.float32)
    out = np.empty((n, ny, nx), np.float32)
    for i in range(0, n, _CHUNK):
        j = min(n, i + _CHUNK)
        waves = ((amp[i:j] / k)[:, :, None]
                 * np.sin(k[None, :, None] * Lo[None, None, :]
                          + phase[i:j, :, None])).astype(np.float32)
        block = np.matmul(rows[None], waves)
        block += (seasonal[i:j, None] * base[None, :]).astype(
            np.float32)[:, :, None]
        noise = rng.standard_normal((j - i, ny, nx), dtype=np.float32)
        noise *= np.float32(NOISE)
        block += noise
        block[:, land] = np.nan
        out[i:j] = block
    return out


def mparams(cfg):
    """Field-valued mParams as (values, dims, coords): A4, R and D as 0-d
    Fields, as the harness hands every mParam over."""
    return {name: (np.float64(v), (), {})
            for name, v in cfg["mParams"].items()}
