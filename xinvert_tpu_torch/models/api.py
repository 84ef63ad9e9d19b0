# -*- coding: utf-8 -*-
"""Public inversion API: ``invert_Poisson``, the other 2-D inverters
(``invert_RefState``, ``invert_PV2D``, ``invert_Eliassen``,
``invert_GillMatsuno[_test]``, ``invert_Stommel[_test]``,
``invert_StommelMunk``, ``invert_StommelArons``, ``invert_geostrophic``,
``invert_BrethertonHaidvogel``, ``invert_Fofonoff``), the 1-D ones
(``invert_GeoAdjustment``, ``invert_RefStateSWM``), ``invert_omega``,
``invert_3DOcean``, their 15 multigrid twins ``invert_*_mg``, the
coarse-to-fine cascade ``invert_MultiGrid``, the solution trajectory
``animate_iteration``, the flow diagnostics ``cal_flow`` and
``loop_noncore``.

Counterpart of ``xinvert_tpu/models/api.py``, mirroring the reference
application layer (xinvert/apps.py): the forcing's non-core dims become one
batch axis solved in a single batched SOR loop (the reference loops slices
sequentially), coefficients compile to a
:class:`~xinvert_tpu_torch.stencil.StencilSpec`, and the red-black engine
runs the sweeps.

Every entry point takes ``device``: ``None`` (the default) runs on the CUDA
card and raises when there is none; ``device="cpu"`` runs the plain PyTorch
version on the CPU.  Tensors are built in ``torch.get_default_dtype()``
(float32 or float64).  ``iParams["mesh"]`` splits a SOR or cheby solve over
the mesh's blocks; ``scheme="lexico"`` and the multigrid entries solve whole,
as the JAX package does.
"""
from __future__ import annotations

import dataclasses
import math
import warnings

import numpy as np
import torch

from ..field import Field, as_field
from ..grid import Grid
from ..solver import SolveResult, direct_result, solve, solve_trajectory
from ..stencil import _interior_mask
from . import problems
from .params import default_iParams, default_mParams, merge_params

__all__ = ["invert_Poisson", "invert_RefState", "invert_PV2D",
           "invert_Eliassen", "invert_GillMatsuno", "invert_GillMatsuno_test",
           "invert_Stommel", "invert_Stommel_test", "invert_StommelMunk",
           "invert_StommelArons", "invert_geostrophic",
           "invert_BrethertonHaidvogel", "invert_Fofonoff", "invert_omega",
           "invert_3DOcean", "invert_Poisson_mg", "invert_omega_mg",
           "invert_StommelMunk_mg", "invert_PV2D_mg", "invert_Eliassen_mg",
           "invert_geostrophic_mg", "invert_RefState_mg",
           "invert_Fofonoff_mg", "invert_BrethertonHaidvogel_mg",
           "invert_GillMatsuno_test_mg", "invert_Stommel_test_mg",
           "invert_GillMatsuno_mg", "invert_Stommel_mg",
           "invert_StommelArons_mg", "invert_3DOcean_mg",
           "invert_MultiGrid", "invert_GeoAdjustment", "invert_RefStateSWM",
           "animate_iteration", "cal_flow", "loop_noncore"]


#: Telemetry of the most recent ``invert_*`` call: a
#: :class:`~xinvert_tpu_torch.solver.SolveResult` (iters, rel_change,
#: overflow) — the machine-readable analog of the reference's per-slice
#: ``flags`` array (apps.py:2308-2311), which only surfaces through prints.
#: After an ``invert_*_mg`` call its fields are numpy values, as in the JAX
#: package: the solution, the cycles, the relative residual and whether it
#: is non-finite.
LAST_SOLVE = None
#: The :class:`~xinvert_tpu_torch.refine.RefineResult` of the last
#: ``tolType='refined'`` call: the (hi, lo) pair and the certified residual.
LAST_REFINE = None


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


def loop_noncore(F, dims):
    """Yield selection dicts over all combinations of non-core dims
    (reference utils.py:10-51).  Kept for API parity; the solver itself
    batches these combinations in one batched solve."""
    f = as_field(F)
    non_core = [d for d in f.dims if d not in dims]
    if not non_core:
        yield {}
        return
    import itertools
    ranges = [range(len(f.coords[d])) if d in f.coords
              else range(f.shape[f.dims.index(d)]) for d in non_core]
    for idx in itertools.product(*ranges):
        yield {d: (f.coords[d][i] if d in f.coords else i)
               for d, i in zip(non_core, idx)}


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
    CPU, float64 and any explicit ``checkEvery`` keep the given cadence;
    so does ``scheme="lexico"``, whose point is the reference's per-sweep
    stopping rule.
    """
    if user_iParams and "checkEvery" in user_iParams:
        return int(user_iParams["checkEvery"])
    ce = int(iP.get("checkEvery", 1))
    if iP.get("scheme") == "lexico":
        return ce
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


def _solve_on_mesh(spec, S0, omega, iP, check_every):
    """The mesh route of ``_invert``.  The JAX package picks its windowed
    2-D executor, then the 3-D one (scheme 'sor' under 'change' or
    'residual'), else GSPMD ``solve_sharded`` on a mesh lifted to all three
    axes; here all three are one block executor, which takes any subset of
    the axes in any order, so the route is ``solve_sharded`` (which solves
    ``scheme="lexico"`` whole)."""
    from ..parallel.mesh import solve_sharded
    mesh = iP["mesh"]
    if not set(mesh.shape) <= {"batch", "y", "x"}:
        raise ValueError(
            "iParams['mesh'] axes must be named 'batch'/'y'/'x' "
            f"(got {tuple(mesh.shape)}): non-core dims shard over "
            "'batch', the core grid over ('y', 'x')")
    return solve_sharded(spec, S0, mesh=mesh, omega=omega,
                         tol=iP["tolerance"], max_iters=iP["mxLoop"],
                         check_every=check_every,
                         scheme=iP.get("scheme", "sor"),
                         tol_type=iP.get("tolType", "change"))


# auto over-relaxation overrides for problems where the grid-optimal
# Laplacian formula diverges: the damped advective families and the stiff
# biharmonic stencil.  Passing iParams['optArg'] still wins.
_AUTO_OMEGA = {
    "gillmatsuno": 1.4, "gillmatsuno_test": 1.4, "stommelarons": 1.4,
    "3docean": 1.4, "stommelmunk": 1.0,
}


def _spec_to(spec, device):
    """``spec`` with its tensors on ``device`` (itself when already there)."""
    if spec.w.device == device:
        return spec
    return dataclasses.replace(
        spec, **{n: getattr(spec, n).to(device)
                 for n in ("w", "w0", "g", "relax", "active")})


def _try_masked_direct(problem_key, vals, Fdef_c, grid, mPr, spec, S0):
    """scheme='direct' on a masked domain: the capacitance-matrix
    one-shot solve (ops/direct.solve_direct_masked) when the UNMASKED
    operator qualifies and the hole count fits the dense budget; None
    otherwise (the caller falls through to solve(), which handles the
    fully active direct case and raises a clear error for the rest)."""
    from ..ops.direct import masked_direct_applicable, solve_direct_masked

    if grid.ndim != 2:
        return None
    Fdef_np = np.asarray(Fdef_c)
    interior = _interior_mask(grid.shape, grid.bcs, False)
    holes = interior & ~Fdef_np
    if not holes.any():
        return None
    # undefined cells may be NaN in the forcing; the active-cell answer is
    # independent of g at the holes (they are pinned), so zero-fill there
    vals_f = np.where(Fdef_np, np.nan_to_num(vals), 0.0).astype(vals.dtype)
    device = S0.device
    spec_full = problems.BUILDERS[problem_key](
        torch.as_tensor(vals_f, device=device),
        torch.ones(grid.shape, dtype=torch.bool, device=device), grid, mPr)
    if not masked_direct_applicable(spec_full, holes,
                                    S_shape=tuple(S0.shape)):
        return None
    return direct_result(spec, solve_direct_masked(spec_full, holes, S0))


def _invert(problem_key, F, dims, coords, icbc, valid_mp, mParams, iParams,
            ndim, device=None):
    dims = [dims] if isinstance(dims, str) else list(dims)
    if len(dims) != ndim:
        raise ValueError(f"{ndim:2d} dimensional forcing are needed")
    iP = merge_params(default_iParams, iParams)
    refined = iP.get("tolType", "change") == "refined"
    stream = bool(iP.get("streamChunk"))
    if refined and stream:
        # refinement keeps a resident double-float32 state; the streaming
        # executor pages slices between host and device.  They do not
        # compose: refuse instead of dropping one of them.
        raise ValueError(
            "tolType='refined' cannot be combined with streamChunk: "
            "iterative refinement needs the (hi, lo) state resident on "
            "device.  Drop streamChunk (refine in-core) or use "
            "tolType='change'/'residual' for the streamed solve.")
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
    # a streamed batch lives on the host: its spec is built there and
    # solve_streamed sends it to the device a chunk at a time
    spec_dev = torch.device("cpu") if stream else device
    spec = problems.BUILDERS[problem_key](
        torch.as_tensor(vals, device=spec_dev),
        torch.as_tensor(Fdef_c, device=spec_dev), grid, mPr)
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

    S0_t = torch.as_tensor(S0, device=spec_dev)
    res = None
    if iP.get("scheme", "sor") == "direct":
        # the capacitance path solves the whole batch resident on the
        # device, streamed or not
        res = _try_masked_direct(problem_key, vals, Fdef_c, grid, mPr,
                                 _spec_to(spec, device), S0_t.to(device))
        if res is None and grid.ndim == 2 \
                and not bool(np.all(np.asarray(Fdef_c))):
            # a masked domain the capacitance-matrix path declined (hole
            # count past the dense budget, as a realistic land/sea mask
            # has, or a non-separable operator): the iterative solve, with
            # a warning, under the requested tolerance semantics
            warnings.warn(
                "scheme='direct' declined for this masked domain (hole "
                "count exceeds the dense capacitance budget or the "
                "operator is not x-invariant); falling back to the "
                "iterative SOR solve.  Use an *_mg entry point for "
                "residual-certified convergence on large masked grids.")
            iP = dict(iP)
            iP["scheme"] = "sor"
    if res is None and refined:
        # mixed-precision iterative refinement (refine.solve_refined): a
        # double-float32 state and EFT-certified residuals; `tolerance` is
        # the certified relative residual, `mxLoop` bounds each inner
        # correction solve
        from ..refine import solve_refined
        global LAST_REFINE
        r = solve_refined(spec, S0_t, omega=omega, tol=iP["tolerance"],
                          inner_iters=iP["mxLoop"], mesh=iP.get("mesh"))
        LAST_REFINE = r
        rel = r.rel_residual
        res = SolveResult(
            S=r.S_hi,           # the correctly rounded float32 word; the
            # (hi, lo) pair stays in LAST_REFINE
            iters=torch.full(rel.shape, r.rounds, dtype=torch.int32,
                             device=rel.device),
            rel_change=rel, overflow=~torch.isfinite(rel))
    check_every = _auto_check_every(iParams, iP, device, dtype)
    if res is None and stream:
        # out-of-core batch: slices stream through the device a chunk at a
        # time (stream.solve_streamed; bit-identical to the resident solve)
        from ..stream import solve_streamed
        res = solve_streamed(spec, S0_t, omega, tol=iP["tolerance"],
                             max_iters=iP["mxLoop"],
                             chunk=int(iP["streamChunk"]),
                             check_every=check_every,
                             scheme=iP.get("scheme", "sor"),
                             tol_type=iP.get("tolType", "change"),
                             device=device)
    if res is None and iP.get("mesh") is not None:
        # multi-device: the block executor (parallel/); every rank passes
        # the whole forcing, takes its blocks and returns the whole field
        res = _solve_on_mesh(spec, S0_t, omega, iP, check_every)
    if res is None:
        res = solve(spec, S0_t, omega=omega, tol=iP["tolerance"],
                    max_iters=iP["mxLoop"], check_every=check_every,
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


def invert_GeoAdjustment(h0, dims, coords="lat", icbc=None,
                         mParams=None, iParams=None, device=None):
    """Geostrophically adjusted free surface, 1-D (apps.py:148-191)."""
    return _invert("geoadjustment", h0, dims, coords, icbc,
                   ["g", "Rearth", "Omega"], mParams, iParams, 1, device)


def invert_RefStateSWM(Q, dims, coords="lat", icbc=None,
                       mParams=None, iParams=None, device=None):
    """Steady shallow-water reference state, 1-D (apps.py:194-243)."""
    return _invert("refstateswm", Q, dims, coords, icbc,
                   ["M0", "C0", "g", "Rearth", "Omega"], mParams, iParams, 1,
                   device)


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


# ---------------------------------------------------------------------------
# multigrid entry points
# ---------------------------------------------------------------------------

def _invert_mg(F, dims, coords, icbc, valid_mp, mParams, iParams, ndim,
               build_levels, tol, max_cycles, device=None, **mg_kw):
    """Shared multigrid driver for the invert_*_mg entry points.

    ``build_levels(vals, Fdef_core, grid, mPr) -> (levels, g0)`` constructs
    the coefficient pyramid from the SHARED operator (``vals`` and
    ``Fdef_core`` are tensors on the solve's device) and the folded
    constant term ``g0``, batched like the forcing (None when it is folded
    into the finest level).  Batch dims run through the V-cycle together;
    icbc provides Dirichlet values and (with ``warmStart``) a true warm
    start.

    ``iParams["mesh"]`` is not read: the pyramid is solved whole on the
    solve's device, as the JAX package's ``_invert_mg`` does.  A sharded
    pyramid (``shard_mg_levels`` / ``solve_mg_sharded``) is ROADMAP queue A
    item 17.
    """
    from ..mg import solve_mg

    dims = [dims] if isinstance(dims, str) else list(dims)
    if len(dims) != ndim:
        raise ValueError(f"{ndim:2d} dimensional forcing are needed")
    iP = merge_params(default_iParams, iParams)
    validate = mParams is not None and mParams is not default_mParams
    mP = merge_params(default_mParams, mParams,
                      valid_mp if validate else None)
    device = _resolve_device(device)
    ft, vals, Fdef, batch = _prepare(F, dims, iP)
    bcs = _validate_bcs(iP, ndim)
    grid = Grid.make(dims, [ft.coords[d] for d in dims], coords, bcs,
                     rearth=mP["Rearth"])
    mPr = _resolve_mp(mP, dims, grid.shape)
    Fdef_c = _collapse_mask(Fdef, ndim)
    if Fdef_c.ndim != ndim:
        raise ValueError("the multigrid path needs a batch-invariant mask; "
                         "use the SOR inverter for batch-varying masks")

    levels, g0 = build_levels(torch.as_tensor(vals, device=device),
                              torch.as_tensor(Fdef_c, device=device),
                              grid, mPr)
    S0 = _init_state(vals, Fdef, icbc, grid, ft,
                     warm=bool(iP.get("warmStart", False)))
    # fmg: full-multigrid nested iteration warm-starts the V-cycle loop;
    # disabled with an icbc warm start, which already provides the state
    warm = bool(iP.get("warmStart", False)) and icbc is not None
    if iP.get("tolType") == "refined":
        # multigrid-backed refinement: a certified relative residual `tol`
        # with V-cycle correction solves (a few cycles a round)
        from ..refine import solve_refined, mg_inner
        global LAST_REFINE
        spec_f = (levels[0].spec if (g0 is None or not batch)
                  else dataclasses.replace(levels[0].spec, g=g0))
        r = solve_refined(spec_f, torch.as_tensor(S0, device=device),
                          tol=tol, inner=mg_inner(levels, **mg_kw))
        LAST_REFINE = r
        S, cycles = r.S_hi, r.rounds
        res = float(torch.max(r.rel_residual))
        converged = res <= tol
    else:
        S, cycles, res, converged = solve_mg(
            levels, S0=torch.as_tensor(S0, device=device),
            g0=g0 if batch else None, tol=tol, max_cycles=max_cycles,
            fmg=not warm, **mg_kw)
    S = S.cpu().numpy().reshape(vals.shape)
    global LAST_SOLVE
    LAST_SOLVE = SolveResult(S=S, iters=np.asarray(cycles),
                             rel_change=np.asarray(res),
                             overflow=np.asarray(~np.isfinite(res)))
    if not converged:
        warnings.warn(f"multigrid stopped after {cycles} cycles with relative "
                      f"residual {res:.3e} > tol {tol:.3e}")
    if iP.get("printInfo"):
        print(f"cycles {cycles:3d} and residual is {res:e}")
    if icbc is None:
        S = np.where(Fdef, S, iP["undef"])
    out = Field(S, ft.dims, ft.coords, name="inverted")
    if out.dims != as_field(F).dims:
        out = out.transpose(*as_field(F).dims)
    return out


def _mg_with_g(level, g0):
    return dataclasses.replace(level, spec=dataclasses.replace(level.spec,
                                                               g=g0))


def _fold_g(pyr, g0, ndim):
    """The finest level takes an unbatched ``g0``; a batched one stays
    apart for solve_mg.  Returns (levels, g0 or None)."""
    if g0.ndim == ndim:
        pyr[0] = _mg_with_g(pyr[0], g0)
        return pyr, None
    return pyr, g0


def _zeros_like_grid(vals, grid):
    return torch.zeros(grid.shape, dtype=vals.dtype, device=vals.device)


def invert_Poisson_mg(F, dims, coords="lat-lon", icbc=None, mParams=None,
                      iParams=None, tol: float = 1e-8, max_cycles: int = 60,
                      device=None):
    """Poisson inversion via geometric multigrid: the coefficients and
    masking of :func:`invert_Poisson`, solved with V-cycles to a RESIDUAL
    tolerance instead of SOR's solution-change rule (the zebra line
    smoother auto-selected for the full-sphere polar metric)."""
    from ..mg import build_pyramid_standard2d

    def build(vals, Fdef_c, grid, mPr):
        A, C, Fs = problems.poisson_coeffs(vals, Fdef_c, grid)
        pyr = build_pyramid_standard2d(
            problems._like(A, vals), 0.0, problems._like(C, vals),
            _zeros_like_grid(vals, grid), Fdef_c, grid.deltas, grid.bcs)
        dxsq = grid.deltas[-1] ** 2
        return _fold_g(pyr, torch.where(pyr[0].spec.active, -Fs * dxsq, 0.0),
                       2)

    return _invert_mg(F, dims, coords, icbc, ["g", "Omega", "Rearth"],
                      mParams, iParams, 2, build, tol, max_cycles, device)


def invert_omega_mg(F, dims, coords="lat-lon", icbc=None, mParams=None,
                    iParams=None, tol: float = 1e-6, max_cycles: int = 30,
                    device=None):
    """3-D QG-omega inversion via semicoarsened multigrid with z/x-line
    smoothing; the coefficients of :func:`invert_omega`."""
    from ..mg import build_pyramid_standard3d

    _check_N2(mParams)

    def build(vals, Fdef_c, grid, mPr):
        A, B, C, Fs = problems.omega_coeffs(vals, Fdef_c, grid, mPr)
        pyr = build_pyramid_standard3d(
            *(problems._like(p, vals) for p in (A, B, C)),
            _zeros_like_grid(vals, grid), Fdef_c, grid.deltas, grid.bcs)
        dxsq = grid.deltas[-1] ** 2
        return _fold_g(pyr, torch.where(pyr[0].spec.active, -Fs * dxsq, 0.0),
                       3)

    return _invert_mg(F, dims, coords, icbc,
                      ["f0", "beta", "N2", "g", "Omega", "Rearth"],
                      mParams, iParams, 3, build, tol, max_cycles, device)


def invert_StommelMunk_mg(curl, dims, coords="lat-lon", icbc=None,
                          mParams=None, iParams=None, tol: float = 1e-6,
                          max_cycles: int = 40, device=None):
    """Stommel-Munk gyre via biharmonic multigrid (the coefficients of
    :func:`invert_StommelMunk`; heavier smoothing, nu = 3)."""
    from ..mg import build_pyramid_bih2d

    def build(vals, Fdef_c, grid, mPr):
        coeffs, J = problems.stommelmunk_coeffs(vals, Fdef_c, grid, mPr)
        pyr = build_pyramid_bih2d(coeffs, _zeros_like_grid(vals, grid),
                                  Fdef_c, grid.deltas, grid.bcs)
        dxssr = grid.deltas[-1] ** 4
        return _fold_g(pyr, torch.where(pyr[0].spec.active, J * dxssr, 0.0),
                       2)

    return _invert_mg(curl, dims, coords, icbc,
                      ["A4", "beta", "R", "D", "rho0", "g", "Omega",
                       "Rearth"],
                      mParams, iParams, 2, build, tol, max_cycles, device,
                      nu1=3, nu2=3)


def _std2d_mg_build(coeffs_fn):
    """Shared build closure for standard-2D-family MG entries:
    ``coeffs_fn -> (A, B, C, Fs)`` planes -> coefficient pyramid with the
    forcing folded as ``g = -Fs*dx^2``."""
    def build(vals, Fdef_c, grid, mPr):
        from ..mg import build_pyramid_standard2d
        A, B, C, Fs = coeffs_fn(vals, Fdef_c, grid, mPr)
        pyr = build_pyramid_standard2d(A, B, C, _zeros_like_grid(vals, grid),
                                       Fdef_c, grid.deltas, grid.bcs)
        dxsq = grid.deltas[-1] ** 2
        return _fold_g(pyr, torch.where(pyr[0].spec.active, -Fs * dxsq, 0.0),
                       2)
    return build


def invert_PV2D_mg(PV, dims, coords="z-lat", icbc=None, mParams=None,
                   iParams=None, tol: float = 1e-8, max_cycles: int = 60,
                   device=None):
    """QG PV inversion in a vertical plane via multigrid (the coefficients
    of :func:`invert_PV2D`)."""
    return _invert_mg(PV, dims, coords, icbc,
                      ["f0", "beta", "N2", "g", "Omega", "Rearth"],
                      mParams, iParams, 2,
                      _std2d_mg_build(problems.pv2d_std_coeffs),
                      tol, max_cycles, device)


def invert_Eliassen_mg(F, dims, coords="z-lat", icbc=None, mParams=None,
                       iParams=None, tol: float = 1e-8,
                       max_cycles: int = 60, device=None):
    """Sawyer-Eliassen overturning via multigrid (the cross-coupled
    coefficients of :func:`invert_Eliassen`, coarsened together)."""
    return _invert_mg(F, dims, coords, icbc,
                      ["A", "B", "C", "g", "Omega", "Rearth"],
                      mParams, iParams, 2,
                      _std2d_mg_build(problems.eliassen_std_coeffs),
                      tol, max_cycles, device)


def invert_geostrophic_mg(lapPhi, dims, coords="lat-lon", icbc=None,
                          mParams=None, iParams=None, tol: float = 1e-8,
                          max_cycles: int = 60, device=None):
    """Geostrophic streamfunction via multigrid (the coefficients of
    :func:`invert_geostrophic`, near-equator f regularisation included)."""
    return _invert_mg(lapPhi, dims, coords, icbc,
                      ["f0", "beta", "Omega", "g", "Rearth"],
                      mParams, iParams, 2,
                      _std2d_mg_build(problems.geostrophic_std_coeffs),
                      tol, max_cycles, device)


def _std2de_mg_build(coeffs_fn):
    """Shared build closure for the standard-2D+E psi family MG entries:
    ``coeffs_fn -> (A, B, C, D, E, Fs)`` planes -> +E psi coefficient
    pyramid, the forcing folded as ``g = -Fs*dx^2``."""
    def build(vals, Fdef_c, grid, mPr):
        from ..mg import build_pyramid_standard2d_e
        A, B, C, D, E, Fs = coeffs_fn(vals, Fdef_c, grid, mPr)
        if any(np.ndim(p) > 2 for p in (A, B, C, D, E)):
            raise ValueError(
                "the multigrid path needs batch-invariant coefficient "
                "planes; use the SOR inverter for batch-varying "
                "coefficients")
        pyr = build_pyramid_standard2d_e(A, B, C, D, E,
                                         _zeros_like_grid(vals, grid),
                                         Fdef_c, grid.deltas, grid.bcs)
        dxsq = grid.deltas[-1] ** 2
        return _fold_g(pyr, torch.where(pyr[0].spec.active, -Fs * dxsq, 0.0),
                       2)
    return build


def invert_RefState_mg(PV, dims, coords="z-lat", icbc=None, mParams=None,
                       iParams=None, tol: float = 1e-8,
                       max_cycles: int = 60, device=None):
    """Balanced symmetric-vortex PV inversion via multigrid (the
    coefficients of :func:`invert_RefState`, the PV-dependent C plane
    included).  Single-slice only: the operator depends on the PV field."""
    def coeffs(vals, Fdef_c, grid, mPr):
        A, B, C, Fs = problems.refstate_std_coeffs(vals, Fdef_c, grid, mPr)
        if C.ndim > 2:
            raise ValueError(
                "invert_RefState_mg needs a single PV slice (the C plane "
                "depends on the PV); use invert_RefState for batches")
        return A, B, C, Fs
    return _invert_mg(PV, dims, coords, icbc,
                      ["Ang0", "ang0", "Gamma", "g", "Omega", "Rearth"],
                      mParams, iParams, 2, _std2d_mg_build(coeffs),
                      tol, max_cycles, device)


def invert_Fofonoff_mg(F, dims, coords="cartesian", icbc=None,
                       mParams=None, iParams=None, tol: float = 1e-8,
                       max_cycles: int = 60, device=None):
    """Fofonoff inviscid free mode via multigrid (the +E psi coefficients
    of :func:`invert_Fofonoff`)."""
    return _invert_mg(F, dims, coords, icbc,
                      ["c0", "c1", "f0", "beta", "g", "Omega", "Rearth"],
                      mParams, iParams, 2,
                      _std2de_mg_build(problems.fofonoff_e_coeffs),
                      tol, max_cycles, device)


def invert_BrethertonHaidvogel_mg(h, dims, coords="cartesian", icbc=None,
                                  mParams=None, iParams=None,
                                  tol: float = 1e-8, max_cycles: int = 60,
                                  device=None):
    """Bretherton-Haidvogel flow over topography via multigrid (the +E psi
    coefficients of :func:`invert_BrethertonHaidvogel`)."""
    return _invert_mg(h, dims, coords, icbc,
                      ["f0", "beta", "D", "lambda", "g", "Omega",
                       "Rearth"],
                      mParams, iParams, 2,
                      _std2de_mg_build(problems.bretherton_e_coeffs),
                      tol, max_cycles, device)


def invert_GillMatsuno_test_mg(Q, dims, coords="lat-lon", icbc=None,
                               mParams=None, iParams=None,
                               tol: float = 1e-6, max_cycles: int = 40,
                               device=None):
    """Gill-Matsuno (standardised +E psi form) via multigrid (the
    coefficients of :func:`invert_GillMatsuno_test`)."""
    return _invert_mg(Q, dims, coords, icbc,
                      ["f0", "beta", "epsilon", "Phi", "g", "Omega",
                       "Rearth"],
                      mParams, iParams, 2,
                      _std2de_mg_build(problems.gillmatsuno_test_e_coeffs),
                      tol, max_cycles, device)


def invert_Stommel_test_mg(curl, dims, coords="lat-lon", icbc=None,
                           mParams=None, iParams=None, tol: float = 1e-6,
                           max_cycles: int = 40, device=None):
    """Stommel gyre (standardised +E psi form) via multigrid (the
    coefficients of :func:`invert_Stommel_test`)."""
    return _invert_mg(curl, dims, coords, icbc,
                      ["f0", "beta", "R", "D", "rho0", "g", "Omega",
                       "Rearth"],
                      mParams, iParams, 2,
                      _std2de_mg_build(problems.stommel_test_e_coeffs),
                      tol, max_cycles, device)


def _general_mg_build(coeffs_fn, ndim):
    """Shared build closure for the damped advective general-family MG
    entries: coefficients -> upwind-coarsened pyramid -> the forcing folded
    as g = -G*dx^2."""
    def build(vals, Fdef_c, grid, mPr):
        from ..mg import build_pyramid_general2d, build_pyramid_general3d
        *AtoG, G = coeffs_fn(vals, Fdef_c, grid, mPr)
        builder = (build_pyramid_general2d if ndim == 2
                   else build_pyramid_general3d)
        pyr = builder(*AtoG, _zeros_like_grid(vals, grid), Fdef_c,
                      grid.deltas, grid.bcs)
        g0 = torch.where(pyr[0].spec.active, -G * grid.deltas[-1] ** 2, 0.0)
        return _fold_g(pyr, g0, ndim)
    return build


def invert_GillMatsuno_mg(Q, dims, coords="lat-lon", icbc=None,
                          mParams=None, iParams=None, tol: float = 1e-6,
                          max_cycles: int = 40, device=None):
    """Gill-Matsuno response via multigrid (the coefficients of
    :func:`invert_GillMatsuno`; V-cycles with upwind-stabilised coarse
    operators)."""
    return _invert_mg(Q, dims, coords, icbc,
                      ["f0", "beta", "epsilon", "Phi", "g", "Omega",
                       "Rearth"],
                      mParams, iParams, 2,
                      _general_mg_build(problems.gillmatsuno_coeffs, 2),
                      tol, max_cycles, device)


def invert_Stommel_mg(curl, dims, coords="lat-lon", icbc=None,
                      mParams=None, iParams=None, tol: float = 1e-6,
                      max_cycles: int = 40, device=None):
    """Stommel gyre via multigrid (the coefficients of
    :func:`invert_Stommel`; coarse levels upwind the beta term)."""
    return _invert_mg(curl, dims, coords, icbc,
                      ["beta", "R", "D", "rho0", "g", "Omega", "Rearth"],
                      mParams, iParams, 2,
                      _general_mg_build(problems.stommel_coeffs, 2),
                      tol, max_cycles, device)


def invert_StommelArons_mg(Q, dims, coords="lat-lon", icbc=None,
                           mParams=None, iParams=None, tol: float = 1e-6,
                           max_cycles: int = 40, device=None):
    """Stommel-Arons abyssal circulation via multigrid (the coefficients of
    :func:`invert_StommelArons`)."""
    return _invert_mg(Q, dims, coords, icbc,
                      ["f0", "beta", "epsilon", "g", "Omega", "Rearth"],
                      mParams, iParams, 2,
                      _general_mg_build(problems.stommelarons_coeffs, 2),
                      tol, max_cycles, device)


def invert_3DOcean_mg(F, dims, coords="lat-lon", icbc=None,
                      mParams=None, iParams=None, tol: float = 1e-6,
                      max_cycles: int = 30, device=None):
    """3-D damped ocean flow via semicoarsened multigrid (the coefficients
    of :func:`invert_3DOcean`; z-line smoothing, upwinded coarse
    levels)."""
    _check_N2(mParams)
    return _invert_mg(F, dims, coords, icbc,
                      ["f0", "beta", "epsilon", "N2", "k", "g", "Omega",
                       "Rearth"],
                      mParams, iParams, 3,
                      _general_mg_build(problems.ocean3d_coeffs, 3),
                      tol, max_cycles, device)


# ---------------------------------------------------------------------------
# the coarse-to-fine cascade
# ---------------------------------------------------------------------------

def _coarsen(f: Field, dims, ratio):
    """Strided subsampling along `dims` (keeps uniform spacing)."""
    if ratio == 1:
        return f
    return f.isel({d: slice(None, None, ratio) for d in dims})


def _interp_like(src: Field, like: Field, dims):
    """Linear interpolation of `src` onto `like`'s coordinates along dims."""
    vals = src.values
    for d in dims:
        ax = src.dims.index(d)
        xi = like.coords[d]
        xp = src.coords[d]
        vals = np.apply_along_axis(lambda col: np.interp(xi, xp, col), ax,
                                   vals)
    coords = dict(src.coords)
    for d in dims:
        coords[d] = like.coords[d]
    return Field(vals, src.dims, coords, src.name)


def invert_MultiGrid(invert_func, F, dims, ratios=(8, 4, 2, 1),
                     mxLoop=5000, **kwargs):
    """Coarse-to-fine cascade (the reference's experimental
    invert_MultiGrid, apps.py:1061-1135, made functional): solves on
    strided-coarsened grids from coarsest to finest, linearly prolongating
    each solution as the next level's icbc warm start.  ``kwargs`` go to
    ``invert_func`` (``device`` among them)."""
    F = as_field(F)
    iParams = dict(kwargs.pop("iParams", {}) or {})
    # a problem with no Dirichlet anchor anywhere (no 'fixed' BC, no masked
    # cells) is singular up to a constant; strided-coarsened forcings are
    # slightly inconsistent there, so coarse solves drift along the null
    # mode: project it out (demean) before prolongating the warm start
    bcs = list(iParams.get("BCs", ["fixed", "fixed"]))
    unanchored = ("fixed" not in bcs
                  and bool(np.isfinite(np.asarray(F.values, float)).all()))
    sol = None
    for ratio in ratios:
        Fc = _coarsen(F, dims, ratio)
        iP = dict(iParams)
        # coarser levels accumulate null-mode drift longer: budget sweeps
        # inversely with the coarsening ratio
        iP["mxLoop"] = max(1, int(mxLoop if ratio == 1 else mxLoop // ratio))
        icbc = None
        if sol is not None:
            icbc = _interp_like(sol, Fc, dims).fillna(0.0)
            # true interior warm start (the reference's icbc semantics zero
            # interior cells, which would defeat the cascade)
            iP["warmStart"] = True
        sol = invert_func(Fc, dims, icbc=icbc, iParams=iP, **kwargs)
        sol = sol.fillna(0.0)
        if unanchored and ratio != 1:
            sol = sol - float(np.nanmean(sol.values))
    return sol


# ---------------------------------------------------------------------------
# the solution trajectory and the flow diagnostics
# ---------------------------------------------------------------------------

_ANIMATE = {
    "poisson": ("poisson", 2),
    "pv2d": ("pv2d", 2),
    "geostrophic": ("geostrophic", 2),
    "gillmatsuno": ("gillmatsuno", 2),
    "eliassen": ("eliassen", 2),
    "stommel": ("stommel", 2),
    "stommelmunk": ("stommelmunk", 2),
    "refstate": ("refstate", 2),
    "brethertonhaidvogel": ("brethertonhaidvogel", 2),
    "fofonoff": ("fofonoff", 2),
    "omega": ("omega", 3),
    "3docean": ("3docean", 3),
}


def _animate_problem(app_name, F, dims, coords, icbc, mParams, iParams,
                     device):
    """What :func:`animate_iteration` iterates: (spec, S0, omega, scheme,
    Fdef, the transposed forcing Field, the merged iParams), on
    ``device``."""
    key = app_name.lower()
    if key not in _ANIMATE:
        raise ValueError(f"unsupported problem: {app_name}")
    problem_key, ndim = _ANIMATE[key]
    dims = [dims] if isinstance(dims, str) else list(dims)
    if len(dims) != ndim:
        raise ValueError(f"{ndim} dims needed for {app_name}")

    iP = merge_params(default_iParams, iParams)
    mP = merge_params(default_mParams, mParams)
    scheme = iP.get("scheme", "sor")
    if scheme not in ("sor", "lexico", "cheby"):
        raise ValueError(
            f"animate_iteration supports scheme 'sor', 'lexico' or "
            f"'cheby', got {scheme!r} (a one-shot 'direct' solve has no "
            "trajectory)")
    device = _resolve_device(device)
    ft, vals, Fdef, batch = _prepare(F, dims, iP)
    if batch:
        raise ValueError("only a single slice (no non-core dims) is allowed")
    bcs = _validate_bcs(iP, ndim)
    grid = Grid.make(dims, [ft.coords[d] for d in dims], coords, bcs,
                     rearth=mP["Rearth"])
    mPr = _resolve_mp(mP, dims, grid.shape)
    spec = problems.BUILDERS[problem_key](
        torch.as_tensor(vals, device=device),
        torch.as_tensor(Fdef, device=device), grid, mPr)
    S0 = torch.as_tensor(_init_state(vals, Fdef, icbc, grid, ft),
                         device=device)
    if iP["optArg"] is not None:
        omega = iP["optArg"]
    else:
        omega = _AUTO_OMEGA.get(problem_key, grid.omega_opt)
    return spec, S0, omega, scheme, Fdef, ft, iP


def animate_iteration(app_name, F, dims, coords="lat-lon", icbc=None,
                      mParams=None, iParams=None,
                      loop_per_frame=5, max_frames=30, device=None):
    """Snapshot the iteration every ``loop_per_frame`` sweeps along a new
    'iter' dim (apps.py:895-1058), through
    :func:`~xinvert_tpu_torch.solver.solve_trajectory`: ``iParams['scheme']``
    'sor' (the sweep kernels on the card), 'cheby' or 'lexico' (the
    reference's own iterates).  One slice only: a forcing with non-core
    dims raises."""
    spec, S0, omega, scheme, Fdef, ft, iP = _animate_problem(
        app_name, F, dims, coords, icbc, mParams, iParams, device)
    frames = solve_trajectory(spec, S0, omega,
                              loop_per_frame=int(loop_per_frame),
                              max_frames=int(max_frames),
                              scheme=scheme).cpu().numpy()
    if icbc is None:
        frames = np.where(Fdef, frames, iP["undef"])
    iters = np.arange(loop_per_frame, loop_per_frame * (max_frames + 1),
                      loop_per_frame)
    coords_out = dict(ft.coords)
    coords_out["iter"] = iters
    return Field(frames, ("iter",) + ft.dims, coords_out, name="inverted")


def cal_flow(S, dims, coords="lat-lon", BCs=("fixed", "fixed"),
             vtype="streamfunction", mParams=None):
    """Recover (u, v) from streamfunction/velocity potential, or the
    Gill-Matsuno winds from geopotential (apps.py:1181-1317).  Finite
    differences on the host (numpy on Fields, :mod:`xinvert_tpu_torch.fd`),
    as in the JAX package."""
    from ..fd import FiniteDiff

    S = as_field(S)
    vt = vtype.lower()
    if vt not in ("streamfunction", "velocitypotential", "gillmatsuno"):
        raise ValueError(f"unsupported vtype: {vtype}")

    if vt != "gillmatsuno":
        sf = vt == "streamfunction"
        ct = coords.lower()
        if ct == "lat-lon":
            fd = FiniteDiff({"Y": dims[0], "X": dims[1]},
                            {"Y": (BCs[0], BCs[0]), "X": (BCs[1], BCs[1])},
                            coords="lat-lon")
            grdy, grdx = fd.grad(S, ["Y", "X"])
            return (-grdy, grdx) if sf else (grdx, grdy)
        if ct == "z-lat":
            fd = FiniteDiff({"Z": dims[0], "Y": dims[1]},
                            {"Z": (BCs[0], BCs[0]), "Y": (BCs[1], BCs[1])},
                            coords="lat-lon")
            grdz, grdy = fd.grad(S, ["Z", "Y"])
            cosv = np.cos(np.deg2rad(S.coords[dims[1]]))
            cos = Field(cosv, (dims[1],), {dims[1]: S.coords[dims[1]]})
            grdz, grdy = grdz / cos, grdy / cos
            lat = Field(S.coords[dims[1]], (dims[1],),
                        {dims[1]: S.coords[dims[1]]})
            grdy = grdy.where(abs(lat) != 90, other=0)
            return (-grdz, grdy) if sf else (grdy, grdz)
        if ct == "z-lon":
            fd = FiniteDiff({"Z": dims[0], "X": dims[1]},
                            {"Z": (BCs[0], BCs[0]), "X": (BCs[1], BCs[1])},
                            coords="lat-lon")
            grdz, grdx = fd.grad(S, ["Z", "X"])
            return (grdz, -grdx) if sf else (grdx, grdz)
        if ct == "cartesian":
            fd = FiniteDiff({"Y": dims[0], "X": dims[1]},
                            {"Y": (BCs[0], BCs[0]), "X": (BCs[1], BCs[1])},
                            coords="cartesian")
            grdy, grdx = fd.grad(S, ["Y", "X"])
            return (-grdy, grdx) if sf else (grdx, grdy)
        raise ValueError(f"unsupported coords {coords}")

    mP = merge_params(default_mParams, mParams,
                      None if mParams is None else
                      ["f0", "beta", "epsilon", "Phi", "Omega", "Rearth"])
    eps, f0, beta = mP["epsilon"], mP["f0"], mP["beta"]
    if coords.lower() == "lat-lon":
        latv = S.coords[dims[0]]
        latr = np.deg2rad(latv)
        f = 2.0 * mP["Omega"] * np.sin(latr)
        deg2m = np.deg2rad(1.0) * mP["Rearth"]
        cos = Field(np.cos(latr), (dims[0],), {dims[0]: latv})
        coef1 = Field(eps / (eps ** 2 + f ** 2), (dims[0],), {dims[0]: latv})
        coef2 = Field(f / (eps ** 2 + f ** 2), (dims[0],), {dims[0]: latv})
        dSx = S.differentiate(dims[1]) / deg2m / cos
        dSy = S.differentiate(dims[0]) / deg2m
    elif coords.lower() == "cartesian":
        y = S.coords[dims[0]]
        f = f0 + beta * y
        coef1 = Field(eps / (eps ** 2 + f ** 2), (dims[0],), {dims[0]: y})
        coef2 = Field(f / (eps ** 2 + f ** 2), (dims[0],), {dims[0]: y})
        dSx = S.differentiate(dims[1])
        dSy = S.differentiate(dims[0])
    else:
        raise ValueError(f"unsupported coords {coords}")
    u = -coef1 * dSx - coef2 * dSy
    v = -coef1 * dSy + coef2 * dSx
    return u, v
