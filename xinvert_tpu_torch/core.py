# -*- coding: utf-8 -*-
"""Dispatch-level API: ``inv_standard1D``, ``inv_standard2D``,
``inv_standard2D_test``, ``inv_general2D``, ``inv_general2D_bih``,
``inv_standard3D`` and ``inv_general3D``, taking coefficient fields directly
(mirrors xinvert/core.py:20-532).

Counterpart of ``xinvert_tpu/core.py``.  The application layer builds
coefficients and solves through the same engine; power users call these
entries with custom coefficients.  The batch dims ride through one batched
solve.  ``device=None`` runs on the CUDA card (and raises without one),
``device="cpu"`` on the CPU; tensors are built in
``torch.get_default_dtype()``.
"""
from __future__ import annotations

import numpy as np
import torch

from .field import Field, as_field
from .solver import solve
from . import stencil
from .models.api import (_finish, _numpy_dtype, _prologue, _reserve_answer,
                         _resolve_device)
from .models.params import default_iParams, default_mParams, merge_params

__all__ = ["inv_standard1D", "inv_standard2D", "inv_standard2D_test",
           "inv_general2D", "inv_general2D_bih", "inv_standard3D",
           "inv_general3D"]


def _run(family, coeffs, F, dims, coords, iParams, ndim, icbc=None,
         device=None):
    iP = merge_params(default_iParams, iParams)
    device = _resolve_device(device)
    f = as_field(F)
    dims = [dims] if isinstance(dims, str) else list(dims)
    if len(dims) != ndim:
        raise ValueError(f"{ndim:2d} dimensional forcing are needed")

    def build(vals, Fdef, grid, _):
        # align coefficient fields to the core grid
        cs = []
        for c in coeffs:
            if np.isscalar(c):
                cs.append(torch.full(grid.shape, float(c), dtype=vals.dtype,
                                     device=device))
                continue
            cf = (as_field(c) if hasattr(c, "dims")
                  else Field(np.asarray(c), dims))
            cdims = [d for d in dims if d in cf.dims]
            if tuple(cdims) != cf.dims:
                cf = cf.transpose(*cdims)
            shape = [1] * ndim
            for d in cf.dims:
                shape[dims.index(d)] = cf.shape[cf.dims.index(d)]
            cs.append(torch.tensor(np.broadcast_to(
                np.asarray(cf.values, _numpy_dtype(vals.dtype))
                .reshape(shape), grid.shape), device=device))
        return family(*cs, torch.where(Fdef, vals, 0.0), Fdef, grid.deltas,
                      grid.bcs)

    ft, _, Fdef, spec, S0, grid, _, _ = _prologue(
        f, dims, coords, icbc, iP, default_mParams, ndim, build, device)
    into = _reserve_answer(S0.shape, icbc, iP["undef"], device)
    omega = iP["optArg"] if iP["optArg"] is not None else grid.omega_opt
    # iParams['scheme'] reaches the engine here (the JAX package's core
    # drops it and always runs SOR): 'direct' solves a qualifying spec in
    # one shot and raises ValueError for the rest
    res = solve(spec, S0, omega=omega, tol=iP["tolerance"],
                max_iters=iP["mxLoop"], scheme=iP.get("scheme", "sor"))
    return _finish(res.S, Fdef, icbc, iP["undef"], ft, f, into)


def inv_standard2D(A, B, C, F, dims, coords="lat-lon", icbc=None,
                   iParams=None, device=None):
    """d/dy(A Sy + B Sx) + d/dx(B Sy + C Sx) = F (core.py:88-155)."""
    def fam(A_, B_, C_, Fm, Fdef, deltas, bcs):
        return stencil.standard_2d(A_, B_, C_, Fm, Fdef, deltas, bcs)
    return _run(fam, (A, B, C), F, dims, coords, iParams, 2, icbc, device)


def inv_standard2D_test(A, B, C, D, E, F, dims, coords="lat-lon", icbc=None,
                        iParams=None, device=None):
    """Standard 2D + separate cross coefficients + linear E S term
    (core.py:159-230)."""
    def fam(A_, B_, C_, D_, E_, Fm, Fdef, deltas, bcs):
        return stencil.standard_2d_e(A_, B_, C_, D_, E_, Fm, Fdef, deltas,
                                     bcs)
    return _run(fam, (A, B, C, D, E), F, dims, coords, iParams, 2, icbc,
                device)


def inv_general2D(A, B, C, D, E, F, G, dims, coords="lat-lon", icbc=None,
                  iParams=None, device=None):
    """A Syy + B Syx + C Sxx + D Sy + E Sx + F S = G (core.py:374-443)."""
    def fam(A_, B_, C_, D_, E_, F_, Gm, Fdef, deltas, bcs):
        return stencil.general_2d(A_, B_, C_, D_, E_, F_, Gm, Fdef, deltas,
                                  bcs)
    return _run(fam, (A, B, C, D, E, F), G, dims, coords, iParams, 2, icbc,
                device)


def inv_general2D_bih(A, B, C, D, E, F, G, H, I, J, dims, coords="lat-lon",
                      icbc=None, iParams=None, device=None):
    """Biharmonic general 2D, 13/17-point stencil (core.py:447-532)."""
    def fam(A_, B_, C_, D_, E_, F_, G_, H_, I_, Jm, Fdef, deltas, bcs):
        return stencil.general_2d_bih(A_, B_, C_, D_, E_, F_, G_, H_, I_, Jm,
                                      Fdef, deltas, bcs)
    return _run(fam, (A, B, C, D, E, F, G, H, I), J, dims, coords, iParams,
                2, icbc, device)


def inv_standard1D(A, B, F, dims, coords="lat", icbc=None, iParams=None,
                   device=None):
    """d/dx(A Sx) + B S = F (core.py:234-290)."""
    def fam(A_, B_, Fm, Fdef, deltas, bcs):
        return stencil.standard_1d(A_, B_, Fm, Fdef, deltas, bcs)
    return _run(fam, (A, B), F, dims, coords, iParams, 1, icbc, device)


def inv_standard3D(A, B, C, F, dims, coords="lat-lon", icbc=None,
                   iParams=None, device=None):
    """d/dz(A Sz) + d/dy(B Sy) + d/dx(C Sx) = F (core.py:20-85)."""
    def fam(A_, B_, C_, Fm, Fdef, deltas, bcs):
        return stencil.standard_3d(A_, B_, C_, Fm, Fdef, deltas, bcs)
    return _run(fam, (A, B, C), F, dims, coords, iParams, 3, icbc, device)


def inv_general3D(A, B, C, D, E, F, G, H, dims, coords="lat-lon", icbc=None,
                  iParams=None, device=None):
    """A Szz + B Syy + C Sxx + D Sz + E Sy + F Sx + G S = H
    (core.py:294-370)."""
    def fam(A_, B_, C_, D_, E_, F_, G_, Hm, Fdef, deltas, bcs):
        return stencil.general_3d(A_, B_, C_, D_, E_, F_, G_, Hm, Fdef,
                                  deltas, bcs)
    return _run(fam, (A, B, C, D, E, F, G), H, dims, coords, iParams, 3, icbc,
                device)
