# -*- coding: utf-8 -*-
"""Public inversion API: ``invert_Poisson``, the other 2-D inverters
(``invert_RefState``, ``invert_PV2D``, ``invert_Eliassen``,
``invert_GillMatsuno[_test]``, ``invert_Stommel[_test]``,
``invert_StommelMunk``, ``invert_StommelArons``, ``invert_geostrophic``,
``invert_BrethertonHaidvogel``, ``invert_Fofonoff``), ``invert_omega`` and
``invert_3DOcean``.

Counterpart of ``xinvert_tpu/models/api.py``, mirroring the reference
application layer (xinvert/apps.py): the forcing's non-core dims become one
batch axis solved in a single batched SOR loop (the reference loops slices
sequentially), coefficients compile to a
:class:`~xinvert_tpu_torch.stencil.StencilSpec`, and the red-black engine
runs the sweeps.

Every entry point takes ``device``: ``None`` (the default) runs on the CUDA
card and raises when there is none; ``device="cpu"`` runs the plain PyTorch
version on the CPU.  Tensors are built in ``torch.get_default_dtype()``
(float32 or float64).  Options of the JAX package that are not ported raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..field import Field, as_field
from ..grid import Grid
from ..solver import NOT_PORTED_SCHEMES, solve
from . import problems
from .params import default_iParams, default_mParams, merge_params

__all__ = ["invert_Poisson", "invert_RefState", "invert_PV2D",
           "invert_Eliassen", "invert_GillMatsuno", "invert_GillMatsuno_test",
           "invert_Stommel", "invert_Stommel_test", "invert_StommelMunk",
           "invert_StommelArons", "invert_geostrophic",
           "invert_BrethertonHaidvogel", "invert_Fofonoff", "invert_omega",
           "invert_3DOcean"]


#: Telemetry of the most recent ``invert_*`` call: a
#: :class:`~xinvert_tpu_torch.solver.SolveResult` (iters, rel_change,
#: overflow) — the machine-readable analog of the reference's per-slice
#: ``flags`` array (apps.py:2308-2311), which only surfaces through prints.
LAST_SOLVE = None


def _resolve_device(device=None):
    """The device an entry point runs on: ``device`` when given, else the
    CUDA card.  Without CUDA and without an explicit device this raises; it
    never carries on quietly on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the entry points run on the GPU by default; "
            "pass device='cpu' to run the plain PyTorch version on the CPU")
    return torch.device("cuda")


def _dtype():
    """numpy dtype of the solve: ``torch.get_default_dtype()``."""
    dt = torch.get_default_dtype()
    if dt == torch.float64:
        return np.float64
    if dt == torch.float32:
        return np.float32
    raise TypeError(f"the default dtype {dt} is not float32/float64")


def _undef_mask(vals, undef):
    """True where the forcing is defined: not ``undef`` and not NaN."""
    if isinstance(undef, float) and math.isnan(undef):
        return ~np.isnan(vals)
    return (vals != undef) & ~np.isnan(vals)


def _prepare(F, dims, iParams):
    """Field -> (transposed field, values[batch..., core...], Fdef, batch dims)."""
    f = as_field(F)
    dims = [dims] if isinstance(dims, str) else list(dims)
    for d in dims:
        if d not in f.dims:
            raise ValueError(f"dim {d} not found in forcing dims {f.dims}")
    batch = tuple(d for d in f.dims if d not in dims)
    order = batch + tuple(dims)
    ft = f.transpose(*order) if f.dims != order else f
    vals = np.asarray(ft.values, dtype=_dtype())
    return ft, vals, _undef_mask(vals, iParams["undef"]), batch


def _collapse_mask(Fdef, core_ndim):
    """Use a core-shaped mask when it is batch-invariant (the common case);
    keeps the compiled stencil weights unbatched."""
    if Fdef.ndim == core_ndim:
        return Fdef
    flat = Fdef.reshape((-1,) + Fdef.shape[-core_ndim:])
    if bool(np.all(flat == flat[0])):
        return flat[0]
    return Fdef


def _resolve_mp(mp, core_dims, core_shape):
    """Align Field-valued model parameters to the core grid by dim name."""
    out = {}
    pos = {d: i for i, d in enumerate(core_dims)}
    for k, v in mp.items():
        if isinstance(v, Field) or (hasattr(v, "dims") and hasattr(v, "values")):
            fv = as_field(v)
            extra = [d for d in fv.dims if d not in pos]
            if extra:
                raise ValueError(
                    f"mParams['{k}'] has non-core dims {extra}; batch-varying "
                    "parameters are not supported")
            fdims = sorted(fv.dims, key=lambda d: pos[d])
            if tuple(fdims) != fv.dims:
                fv = fv.transpose(*fdims)
            shape = [1] * len(core_dims)
            for d in fv.dims:
                shape[pos[d]] = fv.shape[fv.dims.index(d)]
            out[k] = np.asarray(fv.values, np.float64).reshape(shape)
        else:
            out[k] = v
    return out


def _init_state(vals, Fdef, icbc, grid, ft, warm=False):
    """Initial guess per the reference's __mask_FS (apps.py:2112-2159):
    zeros without icbc; with icbc, icbc on undef cells and non-periodic
    domain edges, zeros elsewhere.  ``warm=True`` (the ``warmStart``
    iParam) instead uses icbc EVERYWHERE as a true warm start."""
    if icbc is None:
        return np.zeros_like(vals)
    fi = as_field(icbc)
    order = [d for d in ft.dims if d in fi.dims]
    if tuple(order) != fi.dims:
        fi = fi.transpose(*order)
    ic = np.broadcast_to(np.asarray(fi.values, vals.dtype), vals.shape)
    if warm:
        return np.array(ic, dtype=vals.dtype)
    mask = ~Fdef
    nd = grid.ndim
    for ax_core, bc in enumerate(grid.bcs):
        if bc == "periodic":
            continue
        ax = vals.ndim - nd + ax_core
        edge = np.zeros(vals.shape[ax], bool)
        edge[0] = edge[-1] = True
        shape = [1] * vals.ndim
        shape[ax] = -1
        mask = mask | edge.reshape(shape)
    return np.where(mask, ic, 0.0)


def _auto_check_every(user_iParams, iP, device, dtype) -> int:
    """Amortised convergence checking on the card.

    The reference checks convergence after EVERY sweep (numbas.py:401-414);
    on the card that is a norm and a host sync per sweep.  When the user did
    not ask for a specific cadence, CUDA float32 solves check every
    min(32, mxLoop/10) sweeps: termination can only land later than the
    per-sweep rule (never earlier), so the tolerance contract still holds.
    CPU, float64 and any explicit ``checkEvery`` keep the given cadence.
    """
    if user_iParams and "checkEvery" in user_iParams:
        return int(user_iParams["checkEvery"])
    ce = int(iP.get("checkEvery", 1))
    if ce == 1 and device.type == "cuda" and dtype == torch.float32:
        ce = max(1, min(32, int(iP["mxLoop"]) // 10))
    return ce


def _validate_bcs(iParams, ndim):
    bcs = list(iParams["BCs"])
    if ndim == 1:
        return (bcs[0],)
    if len(bcs) < ndim:
        raise ValueError(f"iParams['BCs'] needs {ndim} entries, got {bcs}")
    return tuple(bcs[:ndim])


def _check_ported(iP):
    """Raise for the options this package does not have yet."""
    scheme = iP.get("scheme", "sor")
    if scheme in NOT_PORTED_SCHEMES:
        raise NotImplementedError(
            f"iParams['scheme']={scheme!r} is not ported yet "
            f"({NOT_PORTED_SCHEMES[scheme]})")
    if iP.get("tolType", "change") == "refined":
        raise NotImplementedError("iParams['tolType']='refined' is not "
                                  "ported yet (ROADMAP queue A item 13)")
    if iP.get("streamChunk"):
        raise NotImplementedError("iParams['streamChunk'] is not ported yet "
                                  "(ROADMAP queue A item 14)")
    if iP.get("mesh") is not None:
        raise NotImplementedError("iParams['mesh'] is not ported yet "
                                  "(ROADMAP queue A item 16)")


# auto over-relaxation overrides for problems where the grid-optimal
# Laplacian formula diverges: the damped advective families and the stiff
# biharmonic stencil.  Passing iParams['optArg'] still wins.
_AUTO_OMEGA = {
    "gillmatsuno": 1.4, "gillmatsuno_test": 1.4, "stommelarons": 1.4,
    "3docean": 1.4, "stommelmunk": 1.0,
}


def _invert(problem_key, F, dims, coords, icbc, valid_mp, mParams, iParams,
            ndim, device=None):
    dims = [dims] if isinstance(dims, str) else list(dims)
    if len(dims) != ndim:
        raise ValueError(f"{ndim:2d} dimensional forcing are needed")
    iP = merge_params(default_iParams, iParams)
    _check_ported(iP)
    validate = mParams is not None and mParams is not default_mParams
    mP = merge_params(default_mParams, mParams,
                      valid_mp if validate else None)
    device = _resolve_device(device)
    dtype = torch.get_default_dtype()

    ft, vals, Fdef, batch = _prepare(F, dims, iP)
    bcs = _validate_bcs(iP, ndim)
    grid = Grid.make(dims, [ft.coords[d] for d in dims], coords, bcs,
                     rearth=mP["Rearth"])
    mPr = _resolve_mp(mP, dims, grid.shape)

    Fdef_c = _collapse_mask(Fdef, ndim)
    spec = problems.BUILDERS[problem_key](
        torch.as_tensor(vals, device=device),
        torch.as_tensor(Fdef_c, device=device), grid, mPr)
    S0 = _init_state(vals, Fdef, icbc, grid, ft,
                     warm=bool(iP.get("warmStart", False)))
    if iP["optArg"] is not None:
        omega = iP["optArg"]
    else:
        omega = _AUTO_OMEGA.get(problem_key, grid.omega_opt)

    if iP.get("debug"):
        print(f"dim grids  : {grid.shape}\ndim intervs: {grid.deltas}\n"
              f"optArg     : {omega}\nmax loops  : {iP['mxLoop']}\n"
              f"tolerance  : {iP['tolerance']}\nboundaries : {grid.bcs}")

    res = solve(spec, torch.as_tensor(S0, device=device), omega=omega,
                tol=iP["tolerance"], max_iters=iP["mxLoop"],
                check_every=_auto_check_every(iParams, iP, device, dtype),
                scheme=iP.get("scheme", "sor"),
                tol_type=iP.get("tolType", "change"))
    global LAST_SOLVE
    LAST_SOLVE = res
    S = res.S.cpu().numpy()

    if iP.get("printInfo"):
        iters = np.atleast_1d(res.iters.cpu().numpy())
        rel = np.atleast_1d(res.rel_change.cpu().numpy())
        ovf = np.atleast_1d(res.overflow.cpu().numpy())
        for i in range(iters.size):
            suffix = " (overflows!)" if ovf.flat[i] else ""
            print(f"loops {iters.flat[i]:4.0f} and tolerance is "
                  f"{rel.flat[i]:e}{suffix}")

    if icbc is None:
        S = np.where(Fdef, S, iP["undef"])
    out = Field(S, ft.dims, ft.coords, name="inverted")
    if out.dims != as_field(F).dims:
        out = out.transpose(*as_field(F).dims)
    return out


def invert_Poisson(F, dims, coords="lat-lon", icbc=None,
                   mParams=None, iParams=None, device=None):
    """Poisson equation for streamfunction/velocity potential
    (apps.py:67-100)."""
    return _invert("poisson", F, dims, coords, icbc,
                   ["g", "Omega", "Rearth"], mParams, iParams, 2, device)


def invert_RefState(PV, dims, coords="z-lat", icbc=None,
                    mParams=None, iParams=None, device=None):
    """Balanced symmetric-vortex PV inversion (apps.py:104-145)."""
    return _invert("refstate", PV, dims, coords, icbc,
                   ["Ang0", "ang0", "Gamma", "g", "Omega", "Rearth"],
                   mParams, iParams, 2, device)


def invert_PV2D(PV, dims, coords="z-lat", icbc=None,
                mParams=None, iParams=None, device=None):
    """QG PV inversion in a vertical plane (apps.py:246-297)."""
    return _invert("pv2d", PV, dims, coords, icbc,
                   ["f0", "beta", "N2", "g", "Omega", "Rearth"],
                   mParams, iParams, 2, device)


def invert_Eliassen(F, dims, coords="z-lat", icbc=None,
                    mParams=None, iParams=None, device=None):
    """Sawyer-Eliassen overturning circulation (apps.py:300-346)."""
    return _invert("eliassen", F, dims, coords, icbc,
                   ["A", "B", "C", "g", "Omega", "Rearth"],
                   mParams, iParams, 2, device)


def invert_GillMatsuno(Q, dims, coords="lat-lon", icbc=None,
                       mParams=None, iParams=None, device=None):
    """Gill-Matsuno heat-induced mass/wind response (apps.py:349-394)."""
    return _invert("gillmatsuno", Q, dims, coords, icbc,
                   ["f0", "beta", "epsilon", "Phi", "g", "Omega", "Rearth"],
                   mParams, iParams, 2, device)


def invert_GillMatsuno_test(Q, dims, coords="lat-lon", icbc=None,
                            mParams=None, iParams=None, device=None):
    """Gill-Matsuno, standardised form (apps.py:397-442)."""
    return _invert("gillmatsuno_test", Q, dims, coords, icbc,
                   ["f0", "beta", "epsilon", "Phi", "g", "Omega", "Rearth"],
                   mParams, iParams, 2, device)


def invert_Stommel(curl, dims, coords="lat-lon", icbc=None,
                   mParams=None, iParams=None, device=None):
    """Stommel wind-driven gyre (apps.py:445-488)."""
    return _invert("stommel", curl, dims, coords, icbc,
                   ["beta", "R", "D", "rho0", "g", "Omega", "Rearth"],
                   mParams, iParams, 2, device)


def invert_Stommel_test(curl, dims, coords="lat-lon", icbc=None,
                        mParams=None, iParams=None, device=None):
    """Stommel gyre, standardised form (apps.py:491-534)."""
    return _invert("stommel_test", curl, dims, coords, icbc,
                   ["f0", "beta", "R", "D", "rho0", "g", "Omega", "Rearth"],
                   mParams, iParams, 2, device)


def invert_StommelMunk(curl, dims, coords="lat-lon", icbc=None,
                       mParams=None, iParams=None, device=None):
    """Stommel-Munk gyre with biharmonic viscosity (apps.py:537-582)."""
    return _invert("stommelmunk", curl, dims, coords, icbc,
                   ["A4", "beta", "R", "D", "rho0", "g", "Omega", "Rearth"],
                   mParams, iParams, 2, device)


def invert_StommelArons(Q, dims, coords="lat-lon", icbc=None,
                        mParams=None, iParams=None, device=None):
    """Stommel-Arons abyssal circulation (apps.py:585-629)."""
    return _invert("stommelarons", Q, dims, coords, icbc,
                   ["f0", "beta", "epsilon", "g", "Omega", "Rearth"],
                   mParams, iParams, 2, device)


def invert_geostrophic(lapPhi, dims, coords="lat-lon", icbc=None,
                       mParams=None, iParams=None, device=None):
    """Geostrophic streamfunction from Laplacian of geopotential
    (apps.py:632-673)."""
    return _invert("geostrophic", lapPhi, dims, coords, icbc,
                   ["f0", "beta", "Omega", "g", "Rearth"],
                   mParams, iParams, 2, device)


def invert_BrethertonHaidvogel(h, dims, coords="cartesian", icbc=None,
                               mParams=None, iParams=None, device=None):
    """Steady flow over topography (apps.py:676-718)."""
    return _invert("brethertonhaidvogel", h, dims, coords, icbc,
                   ["f0", "beta", "D", "lambda", "g", "Omega", "Rearth"],
                   mParams, iParams, 2, device)


def invert_Fofonoff(F, dims, coords="cartesian", icbc=None,
                    mParams=None, iParams=None, device=None):
    """Fofonoff inviscid free mode (apps.py:721-763)."""
    return _invert("fofonoff", F, dims, coords, icbc,
                   ["c0", "c1", "f0", "beta", "g", "Omega", "Rearth"],
                   mParams, iParams, 2, device)


def _check_N2(mParams):
    """Refuse a stratification profile with a non-finite or non-positive
    value past its first level, as the reference does (apps.py:766-888)."""
    if mParams is None:
        return
    N2 = mParams.get("N2", None)
    if N2 is None or np.isscalar(N2):
        return
    arr = np.asarray(as_field(N2).values if hasattr(N2, "dims") else N2,
                     np.float64).ravel()
    if not np.isfinite(arr[1:]).all():
        raise ValueError("infinite stratification coefficient N2")
    if np.isnan(arr[1:]).any():
        raise ValueError("nan in coefficient N2")
    if (arr[1:] <= 0).any():
        raise ValueError("unstable stratification in coefficient N2")


def invert_omega(F, dims, coords="lat-lon", icbc=None,
                 mParams=None, iParams=None, device=None):
    """QG omega equation, 3-D (apps.py:766-827)."""
    _check_N2(mParams)
    return _invert("omega", F, dims, coords, icbc,
                   ["f0", "beta", "N2", "g", "Omega", "Rearth"],
                   mParams, iParams, 3, device)


def invert_3DOcean(F, dims, coords="lat-lon", icbc=None,
                   mParams=None, iParams=None, device=None):
    """3-D damped ocean flow (apps.py:830-888)."""
    _check_N2(mParams)
    return _invert("3docean", F, dims, coords, icbc,
                   ["f0", "beta", "epsilon", "N2", "k", "g", "Omega", "Rearth"],
                   mParams, iParams, 3, device)
