# -*- coding: utf-8 -*-
"""Mixed-precision iterative refinement: certified residuals below the
float32 floor, in PyTorch.

Counterpart of ``xinvert_tpu/refine.py``.  A single float32 state cannot
certify tight residuals: rounding the exact solution to float32 already
perturbs the per-cell residual by ~eps*|w0*S|, so the relative floor
``eps * mean|w0*S| / mean|g|`` is a limit of the state's precision, not
only of the measurement.  Refinement lifts both limits:

1. keep the state as an unevaluated double-float32 pair ``S = hi + lo``;
2. measure the true residual of ``hi + lo`` with error-free transformations
   (:mod:`xinvert_tpu_torch.ops.compensated`);
3. solve the correction system ``A e = -r`` in plain float32 (the SOR
   kernels, or multigrid through :func:`mg_inner`) and absorb ``e`` into
   the pair with a TwoSum renormalisation.

Each round multiplies the residual by about the inner solve's reduction
factor.  The round loop runs on the host, with one host sync a round (the
``max(rel)`` test); its semantics are those of the JAX package's single
traced loop: keep the best iterate, restore it and stop when a round more
than doubles the best residual, stop at ``tol`` or after ``max_rounds``
corrections.  The card has float64 too: ``chip_smoke.py`` times this
against a plain float64 solve of the same operator (PERF.md).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from .grid import optimal_omega
from .ops.compensated import (two_sum, residual_compensated,
                              masked_mean_abs)
from .solver import solve, _residual_scale
from .stencil import StencilSpec

__all__ = ["solve_refined", "RefineResult", "mg_inner"]


def _residual(spec, S_hi, S_lo, mesh=None):
    """The compensated residual of hi + lo, per cell (unmasked); with a
    mesh computed block by block and gathered
    (``parallel.halo.residual_compensated_blocks``): the same cells, bit
    for bit."""
    if mesh is None:
        return residual_compensated(spec, S_hi, S_lo)
    from .parallel.halo import residual_compensated_blocks
    return residual_compensated_blocks(spec, S_hi, S_lo, mesh)


def _correction_rhs(spec, r):
    """The masked compensated residual: the correction system's forcing."""
    return torch.where(spec.active, r, 0.0).to(r.dtype)


def _absorb(S_hi, S_lo, e):
    """(hi, lo) <- TwoSum(hi, lo + e): keeps hi correctly rounded."""
    return two_sum(S_hi, S_lo + e)


class RefineResult(NamedTuple):
    """``S = S_hi + S_lo`` (sum them in float64 for the full accuracy;
    ``S_hi`` alone is the correctly rounded float32 solution)."""
    S_hi: torch.Tensor
    S_lo: torch.Tensor
    rel_residual: torch.Tensor   # certified mean|r|/mean|g| per batch slice
    rounds: int                  # corrections run (0: round 0 certified)

    @property
    def S(self):
        return self.S_hi


def _default_inner(omega, inner_tol: float, inner_iters: int) -> Callable:
    """Correction solver: the stock checked SOR solve (the sweep kernels on
    the card) under the solution-CHANGE rule at ``inner_tol * 1e-3``,
    checking every 32 sweeps.

    The change rule reads the norm the kernels fuse into their last launch;
    the residual rule would add a residual pass every check window.  A
    cruder correction only costs another round, and certification is
    measured on its own by the compensated residual."""
    tol = inner_tol * 1e-3

    def inner(cspec, S0):
        return solve(cspec, S0, omega=omega, tol=tol, max_iters=inner_iters,
                     check_every=32, tol_type="change").S
    return inner


def _mesh_inner(mesh, omega, inner_tol: float, inner_iters: int) -> Callable:
    """The correction solver on a mesh (the JAX package's ``refine.py``
    mesh inner): :func:`_default_inner`'s solve through the checked block
    executor (``solve_sharded``; the JAX package's windowed executors and
    its GSPMD solve are one executor here)."""
    from .parallel.mesh import solve_sharded
    tol = inner_tol * 1e-3

    def inner(cspec, S0):
        return solve_sharded(cspec, S0, mesh=mesh, omega=omega, tol=tol,
                             max_iters=inner_iters, check_every=32,
                             tol_type="change").S
    return inner


def mg_inner(levels, tol: float = 1e-4, max_cycles: int = 25, **kw):
    """An ``inner`` callable for :func:`solve_refined` backed by multigrid
    V-cycles on a prebuilt pyramid: each correction system rides the
    ``g0`` override of :func:`xinvert_tpu_torch.mg.solve_mg` (the finest
    level's constant term is the current residual), a few cycles a round
    instead of thousands of SOR sweeps."""
    from .mg import solve_mg

    def inner(cspec, S0):
        S, _, _, _ = solve_mg(levels, S0=S0, g0=cspec.g, tol=tol,
                              max_cycles=max_cycles, fmg=False, **kw)
        return S
    return inner


def solve_refined(spec: StencilSpec, S0, omega: Optional[float] = None,
                  tol: float = 1e-6, max_rounds: int = 8,
                  inner: Optional[Callable] = None,
                  inner_tol: float = 1e-4, inner_iters: int = 20000,
                  mesh=None) -> RefineResult:
    """Solve to a CERTIFIED relative residual ``tol`` in double-float32.

    ``inner(correction_spec, S0) -> S`` solves one correction system (the
    same operator with ``g`` replaced by the current residual); the default
    is the stock checked SOR solve under the change rule at
    ``inner_tol * 1e-3`` (``inner_tol`` tunes the correction's depth; it
    bounds no residual: the certificate is measured on its own).  Pass
    :func:`mg_inner` (or any closure) for V-cycle corrections.

    Round 0 is the plain solve; each further round computes the compensated
    residual of ``hi + lo``, solves the correction and absorbs it.  The
    loop keeps the best iterate, restores it and stops when a round more
    than doubles the best residual (nullspace drift), and stops when the
    certified residual reaches ``tol`` or after ``max_rounds`` corrections.
    ``rounds`` counts the corrections run.  Runs on the device of ``spec``
    and ``S0``.

    ``mesh`` (a :class:`~xinvert_tpu_torch.parallel.mesh.Mesh`) splits the
    inner solves over its blocks (the checked block executor, whose
    iterates and stopping are the meshless solve's) and runs the
    compensated residual block by block, gathered in a fixed block order:
    the rounds and the certificate are those without the mesh.  Every rank
    of a distributed mesh passes the whole problem and gets the whole
    result.
    """
    if omega is None:
        omega = optimal_omega(S0.shape[-spec.ndim:])
    if inner is None:
        inner = (_default_inner(omega, inner_tol, inner_iters)
                 if mesh is None
                 else _mesh_inner(mesh, omega, inner_tol, inner_iters))
    scale = _residual_scale(spec)
    # the stopping tests compare in the state's dtype, as the JAX
    # package's traced loop does
    tol_d = float(torch.tensor(tol, dtype=S0.dtype))

    # round 0: the plain solve
    S_hi = inner(spec, S0)
    S_lo = torch.zeros_like(S_hi)
    r = _residual(spec, S_hi, S_lo, mesh)
    rel = masked_mean_abs(spec, r) / scale
    best = (S_hi, S_lo, rel)
    best_max = m = float(torch.max(rel))         # one host sync a round
    rounds = 0
    while not m <= tol_d and rounds < max_rounds:
        # correction system A e = -r: the engine solves
        # sum w e + w0 e + g_c = 0, so g_c = r (per cell, compensated)
        e = inner(dataclasses.replace(spec, g=_correction_rhs(spec, r)),
                  torch.zeros_like(S_hi))
        S_hi, S_lo = _absorb(S_hi, S_lo, e)
        r = _residual(spec, S_hi, S_lo, mesh)
        rel = masked_mean_abs(spec, r) / scale
        m = float(torch.max(rel))
        rounds += 1
        if m <= best_max:
            best, best_max = (S_hi, S_lo, rel), m
        elif m > 2.0 * best_max:
            # diverging corrections (e.g. nullspace drift): keep the best
            S_hi, S_lo, rel = best
            break
    return RefineResult(S_hi=S_hi, S_lo=S_lo, rel_residual=rel,
                        rounds=rounds)
