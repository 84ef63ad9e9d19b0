# -*- coding: utf-8 -*-
"""Seeded inputs of eliassen_zm25: the basic state's coefficients A, B and
C of the Sawyer-Eliassen equation on (LEV, lat), one set for every field,
and the daily zonal-mean eddy forcing F, 37 levels x 72 latitudes.

The basic state is an analytic annual-mean zonal mean in SI units (p in Pa,
lat in radians, a the earth's radius, f = 2 Omega sin(lat)):

    T(p, lat) = T0(p) - dT_pole (p / 1e5) sin^2(lat),
    T0(p)     = max(T_surface (p / 1e5)^(Rd lapse / g), T_stratosphere),
    u(p, lat) = u_jet sin^2(2 lat) (1e5 - p) / 9e4,
    A = max(f (f - d(u cos(lat)) / dlat / (a cos(lat))), A_min),
    B = -f du/dp,
    C = (Rd / p) (Rd T / (cp p) - dT/dp),

with A_min = (2 Omega sin(A_min_lat))^2, then |B| clipped to
B_clip sqrt(A C), so that A C - B^2 >= (1 - B_clip^2) A C: the equation is
elliptic at every point.  The derivatives are analytic (T0's lapse rate
ends at the tropopause).  The numbers are the configuration's ``state``
and ``constants``.

The forcing of field i (day d = i mod 365.25, season angle
t = 2 pi d / 365.25) is, times ``forcing_scale``,

    F = (1 + 0.5 cos t) band(+45) + (1 - 0.25 cos t) band(-45)
        + 0.1 vert(p) sum_{k=1..6} a_k sin(k (lat + 90 deg) + p_k) / k
        + 0.02 noise,
    band(c) = heat(p) dgauss(lat; c) + 0.6 mom(p) d2gauss(lat; c),

an eddy heat-flux dipole (heat: the lower troposphere, a Gaussian in p
centred at 850 hPa, 200 hPa wide) and an eddy momentum-flux tripole (mom:
the upper troposphere, centred at 250 hPa, 150 hPa wide) over each storm
track (gauss: 12 degrees wide, dgauss and d2gauss its first and second
derivatives in units of the width), the northern track strongest in
January and the southern one in July; vert(p) = sin(pi (1e5 - p) / 9e4).
Every field draws its own a_k (standard normal) and p_k (uniform on
[0, 2 pi)) from the run's seed, in order, then a standard normal noise at
every point.  F is NaN below the zonal-mean Antarctic surface, p > 700 hPa
south of 72S.  Values are float32.
"""
from __future__ import annotations

import numpy as np

#: fields made at a time (bounds the float32 temporaries)
_CHUNK = 2048
#: wave numbers of the texture
_K = np.arange(1, 7)


def coords(cfg):
    g = cfg["grid"]
    return {d: np.linspace(*g[d]) for d in cfg["dims"]}


def coefficients(cfg):
    """(A, B, C): float64 (ny, nx) planes of the basic state on the
    configuration's grid."""
    c = coords(cfg)
    st, k = cfg["state"], cfg["constants"]
    p = c["LEV"][:, None]
    lat = np.deg2rad(c["lat"])[None, :]
    Rd, cp, g = float(k["Rd"]), float(k["cp"]), float(k["g"])
    a, Om = float(k["Rearth"]), float(k["Omega"])
    kappa_l = Rd * float(st["lapse_rate"]) / g
    T0 = float(st["T_surface"]) * (p / 1e5) ** kappa_l
    trop = T0 > float(st["T_stratosphere"])
    dT0 = np.where(trop, kappa_l * T0 / p, 0.0)
    T0 = np.where(trop, T0, float(st["T_stratosphere"]))
    s2 = np.sin(lat) ** 2
    T = T0 - float(st["dT_pole"]) * (p / 1e5) * s2
    dTdp = dT0 - float(st["dT_pole"]) / 1e5 * s2
    uj = float(st["u_jet"])
    vert = (1e5 - p) / 9e4
    dudp = -uj * np.sin(2 * lat) ** 2 / 9e4
    # d(u cos)/dlat of u_jet sin^2(2 lat) cos(lat) vert
    ducos = uj * vert * (4 * np.sin(2 * lat) * np.cos(2 * lat) * np.cos(lat)
                         - np.sin(2 * lat) ** 2 * np.sin(lat))
    f = 2 * Om * np.sin(lat)
    A_min = (2 * Om * np.sin(np.deg2rad(float(st["A_min_lat"])))) ** 2
    A = np.maximum(f * (f - ducos / (a * np.cos(lat))), A_min)
    B = -f * dudp
    C = (Rd / p) * (Rd * T / (cp * p) - dTdp)
    cap = float(st["B_clip"]) * np.sqrt(A * C)
    B = np.clip(B, -cap, cap)
    shape = (p.size, lat.size)
    return tuple(np.ascontiguousarray(np.broadcast_to(x, shape))
                 for x in (A, B, C))


def mparams(cfg):
    """A, B and C as Fields over (LEV, lat): (values, dims, coords)."""
    c = coords(cfg)
    dims = tuple(cfg["dims"])
    return {name: (v, dims, {d: c[d] for d in dims})
            for name, v in zip("ABC", coefficients(cfg))}


def undefined(cfg):
    """(ny, nx) bool: below the zonal-mean Antarctic surface."""
    c = coords(cfg)
    return (c["LEV"][:, None] > 7e4) & (c["lat"][None, :] < -72.0)


def _gauss_derivatives(lat, centre, width=12.0):
    """The first two derivatives of a Gaussian in latitude, in units of
    its width."""
    x = (lat - centre) / width
    e = np.exp(-x * x)
    return -2 * x * e, (4 * x * x - 2) * e


def _bands(cfg):
    """(2, ny, nx): the northern and the southern storm track's band."""
    c = coords(cfg)
    p, lat = c["LEV"][:, None], c["lat"][None, :]
    heat = np.exp(-((p - 8.5e4) / 2e4) ** 2)
    mom = np.exp(-((p - 2.5e4) / 1.5e4) ** 2)
    out = []
    for centre in (45.0, -45.0):
        d1, d2 = _gauss_derivatives(lat, centre)
        out.append(heat * d1 + 0.6 * mom * d2)
    return np.stack(out)


def fields(cfg, n, rng):
    """(n, ny, nx) float32: ``n`` daily fields drawn from ``rng``."""
    c = coords(cfg)
    ny, nx = c["LEV"].size, c["lat"].size
    scale = float(cfg["forcing_scale"])
    amp = rng.normal(size=(n, _K.size))
    phase = rng.uniform(0.0, 2 * np.pi, (n, _K.size))
    t = 2 * np.pi * (np.arange(n) % 365.25) / 365.25
    season = np.stack([1 + 0.5 * np.cos(t), 1 - 0.25 * np.cos(t)], axis=1)
    band = _bands(cfg).reshape(2, ny * nx)
    vert = np.sin(np.pi * (1e5 - c["LEV"]) / 9e4).astype(np.float32)
    x = np.deg2rad(c["lat"] + 90.0)
    # sin(k x + p) / k = (cos p sin kx + sin p cos kx) / k: coef @ basis
    basis = np.concatenate([np.sin(_K[:, None] * x), np.cos(_K[:, None] * x)])
    basis = (basis / np.concatenate([_K, _K])[:, None]).astype(np.float32)
    undef = undefined(cfg)
    out = np.empty((n, ny, nx), np.float32)
    for i in range(0, n, _CHUNK):
        j = min(n, i + _CHUNK)
        block = (season[i:j] @ band).astype(np.float32).reshape(j - i, ny, nx)
        coef = 0.1 * np.concatenate([amp[i:j] * np.cos(phase[i:j]),
                                     amp[i:j] * np.sin(phase[i:j])], axis=1)
        rows = coef.astype(np.float32) @ basis             # (j - i, nx)
        block += vert[None, :, None] * rows[:, None, :]
        noise = rng.standard_normal((j - i, ny, nx), dtype=np.float32)
        noise *= np.float32(0.02)
        block += noise
        block *= np.float32(scale)
        block[:, undef] = np.nan
        out[i:j] = block
    return out
