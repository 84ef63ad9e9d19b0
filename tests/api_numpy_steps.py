# -*- coding: utf-8 -*-
"""The port's ``invert_*`` calls as they ran with numpy steps on the host,
kept as a reference for the API's device steps: the defined-point mask and
its collapse over the batch, a zero first guess (or the icbc guess), the
``undef`` fill by ``np.where``; between them the package's own builder and
engine, fed the same values.  Imports no JAX, so the card tests use it
too (tests/test_torch_api_staging.py on the CPU, tests/test_torch_cuda.py
on the card)."""
import math

import numpy as np
import torch

from xinvert_tpu_torch.field import Field, as_field
from xinvert_tpu_torch.grid import Grid
from xinvert_tpu_torch.models import api, problems
from xinvert_tpu_torch.models.params import (default_iParams,
                                             default_mParams, merge_params)
from xinvert_tpu_torch.solver import solve, solve_trajectory


def _undef_mask(vals, undef):
    if isinstance(undef, float) and math.isnan(undef):
        return ~np.isnan(vals)
    return (vals != undef) & ~np.isnan(vals)


def _collapse_mask(Fdef, core_ndim):
    if Fdef.ndim == core_ndim:
        return Fdef
    flat = Fdef.reshape((-1,) + Fdef.shape[-core_ndim:])
    if bool(np.all(flat == flat[0])):
        return flat[0]
    return Fdef


def _init_state(vals, Fdef, icbc, grid, ft, warm):
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
    for ax_core, bc in enumerate(grid.bcs):
        if bc == "periodic":
            continue
        ax = vals.ndim - grid.ndim + ax_core
        edge = np.zeros(vals.shape[ax], bool)
        edge[0] = edge[-1] = True
        shape = [1] * vals.ndim
        shape[ax] = -1
        mask = mask | edge.reshape(shape)
    return np.where(mask, ic, 0.0)


def sor(key):
    """The SOR route of ``_invert`` for ``problems.BUILDERS[key]``."""
    def run(vals, Fdef, grid, mPr, S0, iP, iParams, icbc):
        spec = problems.BUILDERS[key](vals, Fdef, grid, mPr)
        omega = (iP["optArg"] if iP["optArg"] is not None
                 else api._AUTO_OMEGA.get(key, grid.omega_opt))
        ce = api._auto_check_every(iParams, iP, S0.device, S0.dtype)
        return solve(spec, S0, omega=omega, tol=iP["tolerance"],
                     max_iters=iP["mxLoop"], check_every=ce,
                     scheme=iP.get("scheme", "sor"),
                     tol_type=iP.get("tolType", "change")).S
    return run


def direct(key):
    """``_invert``'s capacitance route for ``problems.BUILDERS[key]`` on a
    masked 2-D domain, which must take it."""
    def run(vals, Fdef, grid, mPr, S0, iP, iParams, icbc):
        spec = problems.BUILDERS[key](vals, Fdef, grid, mPr)
        res = api._try_masked_direct(key, vals.cpu().numpy(), Fdef, grid,
                                     mPr, spec, S0)
        assert res is not None
        return res.S
    return run


def core(family, coeffs):
    """``core._run``'s build and SOR solve for a stencil ``family`` with
    scalar coefficients."""
    def run(vals, Fdef, grid, mPr, S0, iP, iParams, icbc):
        cs = [torch.full(grid.shape, float(c), dtype=vals.dtype,
                         device=vals.device) for c in coeffs]
        spec = family(*cs, torch.where(Fdef, vals, 0.0), Fdef, grid.deltas,
                      grid.bcs)
        omega = iP["optArg"] if iP["optArg"] is not None else grid.omega_opt
        return solve(spec, S0, omega=omega, tol=iP["tolerance"],
                     max_iters=iP["mxLoop"],
                     scheme=iP.get("scheme", "sor")).S
    return run


def frame(key, k, loop_per_frame, max_frames):
    """Frame ``k`` of ``animate_iteration``'s SOR trajectory for
    ``problems.BUILDERS[key]``."""
    def run(vals, Fdef, grid, mPr, S0, iP, iParams, icbc):
        spec = problems.BUILDERS[key](vals, Fdef, grid, mPr)
        omega = (iP["optArg"] if iP["optArg"] is not None
                 else api._AUTO_OMEGA.get(key, grid.omega_opt))
        return solve_trajectory(spec, S0, omega,
                                loop_per_frame=loop_per_frame,
                                max_frames=max_frames)[k]
    return run


def poisson_mg(tol, max_cycles):
    """``invert_Poisson_mg``'s pyramid and V-cycles."""
    from xinvert_tpu_torch.mg import build_pyramid_standard2d, solve_mg

    def run(vals, Fdef, grid, mPr, S0, iP, iParams, icbc):
        A, C, Fs = problems.poisson_coeffs(vals, Fdef, grid)
        pyr = build_pyramid_standard2d(
            problems._like(A, vals), 0.0, problems._like(C, vals),
            torch.zeros(grid.shape, dtype=vals.dtype, device=vals.device),
            Fdef, grid.deltas, grid.bcs)
        g0 = torch.where(pyr[0].spec.active, -Fs * grid.deltas[-1] ** 2, 0.0)
        levels, g0 = api._fold_g(pyr, g0, 2)
        warm = bool(iP.get("warmStart", False)) and icbc is not None
        return solve_mg(levels, S0=S0, g0=g0 if vals.ndim > 2 else None,
                        tol=tol, max_cycles=max_cycles, fmg=not warm)[0]
    return run


def numpy_steps(run, F, dims, ndim, coords="lat-lon", icbc=None,
                mParams=None, iParams=None, device="cpu"):
    """The returned Field of an ``invert_*`` call through the numpy steps;
    ``run(vals, Fdef, grid, mPr, S0, iP, iParams, icbc)`` builds and
    solves on ``device`` (``sor(key)``, ``poisson_mg(...)``)."""
    device = torch.device(device)
    iP = merge_params(default_iParams, iParams)
    mP = merge_params(default_mParams, mParams)
    f = as_field(F)
    batch = tuple(d for d in f.dims if d not in dims)
    ft = f.transpose(*(batch + tuple(dims)))
    vals = np.asarray(ft.values, dtype=torch.empty(
        0, dtype=torch.get_default_dtype()).numpy().dtype)
    Fdef = _undef_mask(vals, iP["undef"])
    grid = Grid.make(dims, [ft.coords[d] for d in dims], coords,
                     tuple(iP["BCs"][:ndim]), rearth=mP["Rearth"])
    mPr = api._resolve_mp(mP, dims, grid.shape)
    S0 = _init_state(vals, Fdef, icbc, grid, ft,
                     bool(iP.get("warmStart", False)))
    S = run(torch.as_tensor(vals, device=device),
            torch.as_tensor(_collapse_mask(Fdef, ndim), device=device),
            grid, mPr, torch.as_tensor(S0, device=device), iP, iParams,
            icbc)
    S = S.cpu().numpy().reshape(vals.shape)
    if icbc is None:
        S = np.where(Fdef, S, iP["undef"])
    return Field(S, ft.dims, ft.coords, name="inverted").transpose(*f.dims)


def same_field(a, b):
    """Whether two Fields are the same: dims, coords, name, dtype and every
    value, NaN where the other has NaN."""
    return (a.dims == b.dims and a.name == b.name
            and a.coords.keys() == b.coords.keys()
            and all(np.array_equal(a.coords[d], b.coords[d])
                    for d in a.coords)
            and a.values.dtype == b.values.dtype
            and np.array_equal(a.values, b.values, equal_nan=True))
