# -*- coding: utf-8 -*-
"""Dispatch-level API: ``inv_standard2D``, ``inv_standard2D_test``,
``inv_general2D``, ``inv_general2D_bih``, ``inv_standard3D`` and
``inv_general3D``, taking coefficient fields directly (mirrors
xinvert/core.py:20-532, without the 1-D ``inv_standard1D``).

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
from .grid import Grid
from .solver import solve
from . import stencil
from .models.api import (_collapse_mask, _init_state, _prepare,
                         _resolve_device, _validate_bcs)
from .models.params import default_iParams, merge_params

__all__ = ["inv_standard2D", "inv_standard2D_test", "inv_general2D",
           "inv_general2D_bih", "inv_standard3D", "inv_general3D"]


def _run(family, coeffs, F, dims, coords, iParams, ndim, icbc=None,
         device=None):
    iP = merge_params(default_iParams, iParams)
    device = _resolve_device(device)
    f = as_field(F)
    dims = [dims] if isinstance(dims, str) else list(dims)
    if len(dims) != ndim:
        raise ValueError(f"{ndim:2d} dimensional forcing are needed")
    ft, vals, Fdef, _ = _prepare(f, dims, iP)
    grid = Grid.make(dims, [ft.coords[d] for d in dims], coords,
                     _validate_bcs(iP, ndim))

    # align coefficient fields to the core grid
    cs = []
    for c in coeffs:
        if np.isscalar(c):
            cs.append(torch.full(grid.shape, float(c),
                                 dtype=torch.get_default_dtype(),
                                 device=device))
            continue
        cf = as_field(c) if hasattr(c, "dims") else Field(np.asarray(c), dims)
        cdims = [d for d in dims if d in cf.dims]
        if tuple(cdims) != cf.dims:
            cf = cf.transpose(*cdims)
        shape = [1] * ndim
        for d in cf.dims:
            shape[dims.index(d)] = cf.shape[cf.dims.index(d)]
        cs.append(torch.tensor(np.broadcast_to(
            np.asarray(cf.values, vals.dtype).reshape(shape), grid.shape),
            device=device))

    Fdef_t = torch.as_tensor(Fdef, device=device)
    Fm = torch.where(Fdef_t, torch.as_tensor(vals, device=device), 0.0)
    spec = family(*cs, Fm,
                  torch.as_tensor(_collapse_mask(Fdef, ndim), device=device),
                  grid.deltas, grid.bcs)

    S0 = _init_state(vals, Fdef, icbc, grid, ft)
    omega = iP["optArg"] if iP["optArg"] is not None else grid.omega_opt
    # iParams['scheme'] reaches the engine here (the JAX package's core
    # drops it and always runs SOR): 'direct' solves a qualifying spec in
    # one shot and raises ValueError for the rest
    res = solve(spec, torch.as_tensor(S0, device=device), omega=omega,
                tol=iP["tolerance"], max_iters=iP["mxLoop"],
                scheme=iP.get("scheme", "sor"))
    S = res.S.cpu().numpy()
    if icbc is None:
        S = np.where(Fdef, S, iP["undef"])
    out = Field(S, ft.dims, ft.coords, name="inverted")
    return out.transpose(*f.dims) if out.dims != f.dims else out


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
