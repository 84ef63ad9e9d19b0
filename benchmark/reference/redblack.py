# -*- coding: utf-8 -*-
"""Plain red-black SOR in PyTorch: the yardstick's own solver.

It follows the rules that xinvert (github.com/miniufo/xinvert, apps.py and
numbas.py) sets for the standard 2-D and 3-D equations, in the red-black
order that the program documents for its engine:

- a sweep is the problem's boundary pre-pass (``Problem.prepass``, such
  as ``one_row_extend``: rows 0 and ny-1 copy rows 1 and ny-2), where it
  has one, then the red half-sweep (points whose core indices sum to an
  even number), then the black one;
- a half-sweep updates each of its active points by
      S += omega * (g + sum_k w_k S[. + off_k] + w0 S) / (-w0)
  reading the state from before the half-sweep; x wraps (periodic);
- omega is the factor that the configuration's reference states
  (``relaxation``): the grid's optimal one (apps.py:2206-2209, :2289-2290,
  :2342-2343) unless the reference module sets its own ``RELAXATION``;
- the stopping rule compares mean |S| over all core cells at checks
  ``check_every`` sweeps apart (and at the mxLoop cap, after its
  remainder): a field stops once the relative change is below the
  tolerance, its norm is not finite, or (standard 2-D only) its norm is 0.
  A stopped field is frozen.

A configuration's reference module (``benchmark/reference/<config>.py``)
defines ``build(cfg, values, dtype, device)``, which returns a ``Problem``
with the boundary pre-pass of its source, ``active(cfg, values)``,
``coefficient_elements(cfg)`` and ``FLOPS_PER_POINT_SWEEP``, and may set
``RELAXATION``, the constant relaxation factor its source sets.

It imports nothing of the program and takes nothing the program made.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Callable

import torch

__all__ = ["Problem", "flops_per_point_sweep", "optimal_omega",
           "relaxation", "one_row_extend", "sweep", "states_at", "solve"]


def flops_per_point_sweep(n_offsets):
    """Floating-point operations of one point's update in the formula
    above, with K = ``n_offsets`` neighbours: K products w_k * S_k and K
    sums onto g, the product w0 * S and its sum, the product with
    omega / (-w0) and the sum onto S: 2K + 4."""
    return 2 * n_offsets + 4


def optimal_omega(shape):
    """The reference's grid-optimal over-relaxation factor; the slowest of
    three dims takes 2n+3 where the others take 2n+2."""
    shape = list(shape)
    eps = (math.sin(math.pi / (2.0 * shape[-1] + 2.0)) ** 2
           + math.sin(math.pi / (2.0 * shape[-2] + 2.0)) ** 2)
    if len(shape) == 3:
        eps += math.sin(math.pi / (2.0 * shape[0] + 3.0)) ** 2
    return 2.0 / (1.0 + math.sqrt((2.0 - eps) * eps))


def relaxation(reference, core_shape):
    """The relaxation factor of a configuration: its reference module's
    ``RELAXATION`` where the module sets one, else the grid-optimal
    ``optimal_omega(core_shape)``."""
    own = getattr(reference, "RELAXATION", None)
    return optimal_omega(core_shape) if own is None else float(own)


def one_row_extend(S):
    """The 'extend' pre-pass of the standard kernels on the second-to-last
    axis: rows 0 and ny-1 copy rows 1 and ny-2."""
    S = S.clone()
    S[..., 0, :] = S[..., 1, :]
    S[..., -1, :] = S[..., -2, :]
    return S


@dataclasses.dataclass
class Problem:
    """B fields on one core grid.  ``weights`` maps a neighbour offset to
    its weight plane, ``w0`` is the centre weight, ``g`` the folded
    forcing (B, *core), ``active`` the points a sweep updates (B, *core);
    every plane is zero where a point is inactive.  ``prepass``, where
    set, is the boundary pre-pass a sweep opens with: a callable from a
    state (B, *core) to a new state that leaves its argument unchanged,
    chosen or written by the configuration's reference from its source
    (``one_row_extend`` for the standard 2-D kernel's extend)."""
    weights: dict
    w0: torch.Tensor
    g: torch.Tensor
    active: torch.Tensor
    zero_norm_stops: bool
    prepass: Callable | None = None

    @property
    def core(self):
        return tuple(self.active.shape[1:])

    def relax(self, omega):
        """The red and the black relaxation planes omega / (-w0)."""
        idx = torch.zeros(self.core, dtype=torch.int64,
                          device=self.active.device)
        for ax, n in enumerate(self.core):
            shape = [1] * len(self.core)
            shape[ax] = n
            idx = idx + torch.arange(n, device=idx.device).reshape(shape)
        red = (idx % 2 == 0)
        w0 = torch.where(self.active, self.w0, -1.0)
        r = torch.where(self.active, omega / -w0, 0.0).to(self.g.dtype)
        return torch.where(red, r, 0.0), torch.where(red, 0.0, r)


def _neighbour(S, off):
    """S[. + off] on the core axes (wrapping)."""
    shifts = tuple(-o for o in off if o != 0)
    dims = tuple(ax - len(off) for ax, o in enumerate(off) if o != 0)
    return torch.roll(S, shifts=shifts, dims=dims)


def sweep(prob, S, red, black):
    """One sweep: the boundary pre-pass, the red half, the black half."""
    if prob.prepass is not None:
        S = prob.prepass(S)
    for r in (red, black):
        acc = prob.g + prob.w0 * S
        for off, w in prob.weights.items():
            acc = acc + w * _neighbour(S, off)
        S = S + r * acc
    return S


def _norm(S):
    return S.abs().mean(dim=tuple(range(1, S.ndim)))


def states_at(prob, omega, wanted):
    """The state of each field after the sweep counts it asks for, from
    zero: ``wanted`` lists, per field, the counts; returns
    ``{(field, count): state}`` as float64 host tensors."""
    by_count = {}
    for f, counts in enumerate(wanted):
        for n in counts:
            by_count.setdefault(int(n), []).append(f)
    red, black = prob.relax(omega)
    S = torch.zeros_like(prob.g)
    out = {}
    for n in range(1, max(by_count, default=0) + 1):
        S = sweep(prob, S, red, black)
        for f in by_count.get(n, ()):
            out[(f, n)] = S[f].double().cpu()
    return out


def solve(prob, omega, tol, check_every, max_iters):
    """Every field solved from zero under the stopping rule: (S, sweeps)."""
    red, black = prob.relax(omega)
    B = prob.g.shape[0]
    dev = prob.g.device
    S = torch.zeros_like(prob.g)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    loop = torch.zeros(B, dtype=torch.int64, device=dev)
    prev = torch.full((B,), -1.0, dtype=prob.g.dtype, device=dev)
    frozen = (B,) + (1,) * len(prob.core)
    it = 0
    while it < max_iters and not bool(done.all()):
        k = check_every if it + check_every <= max_iters else max_iters - it
        S_new = S
        for _ in range(k):
            S_new = sweep(prob, S_new, red, black)
        it += k
        norm = _norm(S_new)
        rel = torch.where(prev >= 0,
                          (norm - prev).abs() / torch.where(prev > 0, prev,
                                                            1.0),
                          torch.ones_like(norm))
        stop = (~torch.isfinite(norm)) | (rel < tol) | (loop + k >= max_iters)
        if prob.zero_norm_stops:
            stop = stop | (norm == 0)
        S = torch.where(done.reshape(frozen), S, S_new)
        loop = torch.where(done, loop, loop + k)
        prev = torch.where(done, prev, norm)
        done = done | stop
    return S, loop
