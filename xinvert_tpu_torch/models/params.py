# -*- coding: utf-8 -*-
"""Default iteration and model parameters.

Mirrors the reference defaults (apps.py:21-60) so user code ports 1:1.
"""
from __future__ import annotations

import copy

import numpy as np

__all__ = ["default_iParams", "default_mParams", "merge_params", "UNDEFTMP"]

# internal sentinel used by the reference to mark undefined cells
# (core.py:15, apps.py:18).  Kept for interop; internally we use boolean masks.
UNDEFTMP = -9.99e8

default_iParams = {
    "BCs": ["fixed", "fixed"],
    "undef": np.nan,
    "mxLoop": 5000,
    "tolerance": 1e-8,
    "optArg": None,      # None -> grid-optimal omega (per-family default
                         # for the advective/biharmonic problems)
    "printInfo": True,
    "debug": False,
    "checkEvery": 1,     # extension: amortise the convergence reduction
                         # over k sweeps (k=1 = reference parity)
    "warmStart": False,  # extension: use icbc EVERYWHERE as the initial
                         # guess (the reference keeps icbc only on domain
                         # edges and undef cells, apps.py:2144-2156)
    "scheme": "sor",     # 'sor', 'cheby' (cyclic Chebyshev), 'direct'
                         # (one-shot spectral solve) or 'lexico' (the
                         # reference's exact lexicographic iterates, with
                         # the per-sweep stopping rule)
    "tolType": "change", # 'change' (the reference's solution-change rule),
                         # 'residual' (true relative discrete residual
                         # mean|r|/mean|g|) or 'refined' (certified
                         # double-float32 refinement, refine.py)
    "streamChunk": None, # out-of-core batch: slices streamed through the
                         # device this many at a time (stream.py)
    "mesh": None,        # multi-device solve over a parallel.Mesh (the
                         # block executor, parallel/); with scheme='lexico'
                         # or an *_mg entry it raises NotImplementedError
}

default_mParams = {
    "f0": 1e-5,          # Coriolis parameter at south BC on beta plane
    "beta": 2e-11,       # meridional derivative of f
    "Phi": 1e4,          # background geopotential (Gill-Matsuno)
    "epsilon": 7e-6,     # linear damping coefficient
    "N2": 2e-4,          # stratification
    "A": 1e5,            # Laplacian viscosity (Munk)
    "A4": 1e5,           # biharmonic viscosity (Stommel-Munk); the reference
                         # lists 'A4' as valid but ships no default (apps.py:42-60)
    "R": 5e-5,           # linear drag coefficient
    "D": 100,            # depth of ocean / mixed layer ('depth' in docs)
    "depth": 100,
    "rho0": 1027,        # seawater density
    "ang0": 2e5,         # background angular momentum
    "Ang0": 2e5,         # alias accepted by the reference's validParams
    "lambda": 1e-8,      # Bretherton-Haidvogel
    "c0": 8e-9,          # Fofonoff
    "c1": 8e-5,          # Fofonoff
    "k": 1e-5,           # buoyancy damping (3D ocean)

    "Rearth": 6371200.0,
    "Omega": 7.292e-5,
    "g": 9.80665,
}


def merge_params(default, users, valid=None):
    """Overlay user params on deep-copied defaults, validating keys
    (apps.py:2361-2375)."""
    users = users or {}
    if valid is not None and users is not default:
        for k in users:
            if k not in valid:
                raise ValueError(f"mParams['{k}'] is not used, valid are {valid}")
    out = copy.deepcopy(default)
    for k, v in users.items():
        if v is not None:
            out[k] = v
    return out
