# -*- coding: utf-8 -*-
"""Differentiable inversions: implicit differentiation through the SOR
solve, in PyTorch.

Counterpart of ``xinvert_tpu/ops/implicit.py``.  The solved system is
linear in the state: the folded stencil equation is

    R_i(S) = sum_o w_o(i) S(i+o) + w0(i) S(i) + g(i) = 0   (active i),
    S(j) = S0(j)                                           (pinned j),

i.e. ``M_aa S_a = -(g_a + M_ap S0_p)``.  By the implicit function theorem
the vector-Jacobian product needs ONE adjoint solve with the transpose
operator:

    lambda = M_aa^{-T} cot_a,
    g_bar      = -lambda
    w_o_bar(i) = -lambda(i) * S(i+o)
    w0_bar(i)  = -lambda(i) * S(i)
    S0_bar(j)  = cot_j - sum_{i,o: i+o=j} lambda(i) w_o(i)   (pinned j)

and the transpose operator is itself a stencil on the same grid: ``M^T``'s
weight for offset ``o`` at cell ``i`` is ``w_{-o}(i+o)``, plane rolls of the
flipped-offset weights (:func:`transpose_spec`), so the adjoint solve runs
on the same engine (the sweep kernels on the card) as the forward one.

Gradients are exact for the exactly solved system; with iterative solves
the error is O(forward tol + adjoint tol).  :func:`solve_implicit` is a
``torch.autograd.Function``: autograd never records the iteration (no
O(iters) memory).  The backward pass is first order (it runs under
``torch.no_grad``).
"""
from __future__ import annotations

import dataclasses

import torch

from ..stencil import StencilSpec

__all__ = ["transpose_spec", "solve_implicit"]


def _roll(a, off, nd, sign):
    """``a`` rolled by ``sign * off`` on the core axes (``jnp.roll``'s
    convention)."""
    shifts = tuple(sign * o for o in off if o != 0)
    axes = tuple(ax - nd for ax, o in enumerate(off) if o != 0)
    return torch.roll(a, shifts=shifts, dims=axes) if shifts else a


def transpose_spec(spec: StencilSpec) -> StencilSpec:
    """The adjoint operator's stencil: same grid, same active set and
    diagonal, weights ``w^T_o = roll(w_{-o}, -o)`` (M^T[i, i+o] =
    M[i+o, i] = w_{-o}(i+o)).  Offsets of the reference families come in
    +-o pairs, so the offset list is unchanged."""
    nd = spec.ndim
    idx = {tuple(off): k for k, off in enumerate(spec.offsets)}
    new_w = []
    for off in spec.offsets:
        neg = tuple(-o for o in off)
        src = (spec.w[idx[neg]] if neg in idx
               else torch.zeros_like(spec.w[0]))
        new_w.append(_roll(src, off, nd, -1))
    return dataclasses.replace(spec, w=torch.stack(new_w))


def _sum_to(x, shape):
    """Reduce a full-shape cotangent to a (possibly broadcast) input shape:
    the transpose of broadcasting."""
    shape = tuple(shape)
    if tuple(x.shape) == shape:
        return x
    extra = x.dim() - len(shape)
    if extra > 0:
        x = torch.sum(x, dim=tuple(range(extra)))
    axes = tuple(i for i, (a, b) in enumerate(zip(x.shape, shape))
                 if b == 1 and a != 1)
    if axes:
        x = torch.sum(x, dim=axes, keepdim=True)
    return x.reshape(shape)


class _ImplicitSolve(torch.autograd.Function):
    """forward: the stock checked solve; backward: one adjoint solve on
    :func:`transpose_spec` and the cotangent algebra of the module
    docstring.  ``relax`` and the active mask get zero cotangents: relax
    (= active/(-w0)) steers the iteration only, and the fixed point depends
    on (w, w0, g) alone."""

    @staticmethod
    def forward(ctx, w, w0, g, relax, act_f, S0, meta, kw, adj_kw):
        from ..solver import solve
        sp = dataclasses.replace(meta, w=w, w0=w0, g=g, relax=relax,
                                 active=act_f > 0.5)
        S = solve(sp, S0, **kw).S
        ctx.save_for_backward(w, w0, g, relax, act_f, S)
        ctx.meta, ctx.adj_kw, ctx.S0_shape = meta, adj_kw, tuple(S0.shape)
        return S

    @staticmethod
    def backward(ctx, cot):
        from ..solver import solve
        w, w0, g, relax, act_f, S = ctx.saved_tensors
        need = ctx.needs_input_grad
        with torch.no_grad():
            active = act_f > 0.5
            sp = dataclasses.replace(ctx.meta, w=w, w0=w0, g=g, relax=relax,
                                     active=active)
            nd = sp.ndim
            cot_a = torch.where(active, cot, 0.0)
            # the engine solves M^T lam + g_T = 0, so lam = M^{-T} cot
            # needs g_T = -cot (on active cells; lam pinned to 0 elsewhere)
            spT = dataclasses.replace(transpose_spec(sp), g=-cot_a)
            lam = solve(spT, torch.zeros_like(cot), **ctx.adj_kw).S
            lam = torch.where(active, lam, 0.0)

            g_bar = _sum_to(-lam, g.shape) if need[2] else None
            w0_bar = _sum_to(-lam * S, w0.shape) if need[1] else None
            wb = []
            T = torch.zeros(torch.broadcast_shapes(lam.shape, S.shape),
                            dtype=lam.dtype, device=lam.device)
            for k, off in enumerate(sp.offsets):
                if need[0]:
                    wb.append(_sum_to(-lam * _roll(S, off, nd, -1),
                                      w.shape[1:]))
                # sum_{i: i+o=j} lam(i) w_o(i) at j (a shift by +o)
                T = T + _roll(lam * w[k], off, nd, 1)
            w_bar = torch.stack(wb) if need[0] else None
            # pinned cells: the pass-through cotangent and the influence on
            # the active solution through the neighbour reads
            S0_bar = (_sum_to(torch.where(active, 0.0, cot - T),
                              ctx.S0_shape) if need[5] else None)
            relax_bar = torch.zeros_like(relax) if need[3] else None
            act_bar = torch.zeros_like(act_f) if need[4] else None
        return (w_bar, w0_bar, g_bar, relax_bar, act_bar, S0_bar, None, None,
                None)


def solve_implicit(spec: StencilSpec, S0, omega=None, tol: float = 1e-10,
                   max_iters: int = 20000, check_every: int = 32,
                   adjoint_tol=None, adjoint_iters=None, **solve_kw):
    """Solve the stencil system, differentiably in ``spec.w``,
    ``spec.w0``, ``spec.g`` and the pinned entries of ``S0``.

    Returns the solved state, as ``solve(...).S``; under autograd the
    backward pass runs one adjoint solve on the transpose stencil
    (:func:`transpose_spec`) with the same engine and, by default, the
    same tolerances.  Gradients with respect to physical parameters follow
    by the chain rule when the coefficient builder runs on tensors that
    require grad.

    Extend boundaries are not pinned constants (they track the interior),
    so the plain formulation does not hold for them.  The (extend,
    periodic) radius-1 2-D class, the flagship global Poisson family, folds
    the copy into the stencil (:func:`~xinvert_tpu_torch.ops.sor2d._fold_extend`),
    solves the folded spec and re-applies the extension with differentiable
    torch ops: the same fixed point and gradient.  Other extend specs raise
    ``NotImplementedError``.
    """
    from ..grid import optimal_omega

    if omega is None:
        omega = optimal_omega(tuple(S0.shape[-spec.ndim:]))
    if any(bc == "extend" for bc in spec.bcs):
        from .sor2d import _extend_foldable, _fold_extend
        from ..solver import _apply_extend
        if spec.ndim == 2 and _extend_foldable(spec):
            S_int = solve_implicit(_fold_extend(spec), S0, omega=omega,
                                   tol=tol, max_iters=max_iters,
                                   check_every=check_every,
                                   adjoint_tol=adjoint_tol,
                                   adjoint_iters=adjoint_iters, **solve_kw)
            return _apply_extend(spec, S_int)
        raise NotImplementedError(
            "solve_implicit supports 'fixed'/'periodic' BCs exactly, and "
            "('extend', 'periodic') for radius-1 no-cross 2-D stencils "
            "via the extend fold; other extend combinations need the "
            "boundary-tracking operator folded in and are not "
            "implemented")
    adjoint_tol = tol if adjoint_tol is None else adjoint_tol
    adjoint_iters = max_iters if adjoint_iters is None else adjoint_iters
    kw = dict(omega=omega, tol=tol, max_iters=max_iters,
              check_every=check_every, **solve_kw)
    adj_kw = dict(kw, tol=adjoint_tol, max_iters=adjoint_iters)
    meta = dataclasses.replace(spec, w=None, w0=None, g=None, relax=None,
                               active=None)
    return _ImplicitSolve.apply(spec.w, spec.w0, spec.g, spec.relax,
                                spec.active.to(spec.w0.dtype), S0, meta, kw,
                                adj_kw)
