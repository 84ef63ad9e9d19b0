# -*- coding: utf-8 -*-
"""Geometric multigrid for the standard-2D, standard-3D, general and
biharmonic stencil families, in PyTorch.

Counterpart of ``xinvert_tpu/mg.py``: a V-cycle on the residual equation
with coefficient coarsening, full-weighting restriction and bilinear
prolongation, full-multigrid nested iteration, masked damping, and a
V-cycle-preconditioned BiCGStab rescue for the advection-dominated
families.  Even sizes coarsen cell-wise (n -> n/2), odd sizes vertex-wise
(n -> (n+1)/2); periodic dims must be even.  3-D problems SEMICOARSEN:
only (y, x) coarsen, the z column stays fine.

Smoothers (``solve_mg(smoother=None)`` takes the one stamped on the finest
level at build time, chosen from the operator's coupling anisotropy):
- ``point``: red-black Gauss-Seidel through the SOR engine's executor
  (:func:`xinvert_tpu_torch.solver._select_kernel`): on CUDA tensors the
  hand-written tiled kernel (``ops.sor2d.sor2d_sweeps_tiled``) on every
  level, in float32 and float64, with the batch through its batch
  dimension; on CPU tensors its plain version.  A level the wrappers refuse
  raises;
- ``xline``: zebra x-line relaxation (exact cyclic-tridiagonal row solves,
  :func:`xinvert_tpu_torch.ops.tridiag.tridiag_cyclic_pscan`);
- ``zline``: zebra z-line relaxation; ``zxline``: z- then x-lines.

The pyramids are built eagerly (the JAX package builds all levels in one
compiled program).  The JAX package's ``while_loop`` drivers are Python
loops here: each loop test is one host sync (``HOST_SYNCS`` counts them).
Batched solves run batched, the V-cycle stage and the Krylov rescue
alike, so the kernel sees the batch: each member's loop tests and inner
products are its own, and a member is frozen with ``torch.where`` once its
own test ends its loop (the semantics of JAX's ``vmap`` over the
``while_loop``s).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import stencil
from .grid import optimal_omega
from .solver import _apply_extend, _neighbor_sum, _select_kernel
from .stencil import StencilSpec

__all__ = ["build_pyramid_standard2d", "build_pyramid_standard2d_e",
           "build_pyramid_standard3d", "build_pyramid_general2d",
           "build_pyramid_general3d", "build_pyramid_bih2d", "solve_mg",
           "MGLevel", "levels_from_arrays"]

#: loop tests of the solve drivers read on the host (one sync each)
HOST_SYNCS = 0


def _sync(flags):
    """A device boolean tensor read on the host: one counted sync."""
    global HOST_SYNCS
    HOST_SYNCS += 1
    return flags.tolist()


@dataclasses.dataclass(frozen=True)
class MGLevel:
    spec: StencilSpec
    omega: float
    odd: Tuple[bool, ...]        # per coarsened dim (the trailing y, x):
    #                              vertex (odd) vs cell coarsening
    masked: bool = False         # fine problem has interior inactive cells
    smoother: Optional[str] = None   # auto-selected at BUILD time

    @classmethod
    def from_arrays(cls, spec, omega, odd, masked=False, smoother=None, *,
                    device=None, dtype=None):
        """A level from host arrays: ``spec`` is anything with a
        :class:`~xinvert_tpu_torch.stencil.StencilSpec`'s fields whose
        planes ``np.asarray`` takes (e.g. another package's spec), as
        :meth:`StencilSpec.from_arrays` takes them."""
        sp = StencilSpec.from_arrays(
            spec.w, spec.w0, spec.g, spec.relax, spec.active, spec.offsets,
            spec.bcs, spec.bih, spec.stop_on_zero_norm, device=device,
            dtype=dtype)
        return cls(spec=sp, omega=float(np.asarray(omega)),
                   odd=tuple(bool(o) for o in odd), masked=bool(masked),
                   smoother=smoother)


def levels_from_arrays(levels, *, device=None, dtype=None) -> List[MGLevel]:
    """A pyramid of levels from host arrays: each entry has ``spec``,
    ``omega``, ``odd``, ``masked`` and ``smoother`` (:meth:`MGLevel.
    from_arrays`)."""
    return [MGLevel.from_arrays(lv.spec, lv.omega, lv.odd, lv.masked,
                                getattr(lv, "smoother", None), device=device,
                                dtype=dtype)
            for lv in levels]


def _coupling_ratio(act, cnum, cden, floor):
    """max over active cells of cnum/cden, on the planes' device."""
    den = torch.maximum(cden, torch.tensor(floor, dtype=cden.dtype,
                                           device=cden.device))
    return torch.max(torch.where(act, cnum / den, 0.0))


def _auto_smoother(spec) -> str:
    """Coupling-anisotropy smoother selection, at pyramid build time: line
    relaxation along any axis whose coupling dominates the others by >10x
    anywhere (the 1/cos^2 polar metric in x; the f^2 (delx/delz)^2
    stiffness in z).  The ratio is reduced on the planes' device and only
    the scalar comes to the host."""
    nd = spec.ndim
    offs = {tuple(o): k for k, o in enumerate(spec.offsets)}
    w = spec.w
    act = spec.active
    floor = float(torch.finfo(spec.w0.dtype).tiny)

    def coupling(axis):
        unit = tuple(1 if i == axis else 0 for i in range(nd))
        nunit = tuple(-u for u in unit)
        if unit not in offs or nunit not in offs:
            return None
        return torch.abs(w[offs[unit]] + w[offs[nunit]])

    if nd == 2 and bool(torch.any(act)):
        cx, cy = coupling(1), coupling(0)
        ratio = (float(_coupling_ratio(act, cx, cy, floor))
                 if cx is not None and cy is not None else 0.0)
        return "xline" if ratio > 10.0 else "point"
    if nd == 3 and bool(torch.any(act)):
        # semicoarsening quadruples the relative z coupling per level, so
        # z-lines are ALWAYS needed once the hierarchy has depth; add
        # x-lines for the polar 1/cos^2 metric
        cy, cx = coupling(1), coupling(2)
        rx = (float(_coupling_ratio(act, cx, cy, floor))
              if cx is not None and cy is not None else 0.0)
        return "zxline" if rx > 10.0 else "zline"
    return "point"


# ---------------------------------------------------------------- transfer

def _every_other(a, axis, start=0):
    """a[..., start::2, ...] along ``axis``, contiguous."""
    axis = axis % a.ndim
    return a.index_select(axis, torch.arange(start, a.shape[axis], 2,
                                             device=a.device))


def _coarsen_axis_vertex(a, axis):
    """Sample every other point (vertex-centred), keeping both ends."""
    return _every_other(a, axis)


def _coarsen_axis_cell(a, axis):
    """Average adjacent pairs (cell-centred)."""
    return 0.5 * (_every_other(a, axis) + _every_other(a, axis, 1))


def _coarsen_plane(a, odd):
    for ax_rel, o in enumerate(odd):
        ax = a.ndim - 2 + ax_rel
        a = _coarsen_axis_vertex(a, ax) if o else _coarsen_axis_cell(a, ax)
    return a


def _shifted(a, axis, periodic):
    """(a[i-1], a[i+1]) along ``axis``: wrapped when periodic, else with
    the end values repeated."""
    if periodic:
        return torch.roll(a, 1, axis), torch.roll(a, -1, axis)
    n = a.shape[axis]
    lo = torch.cat([a.narrow(axis, 0, 1), a.narrow(axis, 0, n - 1)], axis)
    hi = torch.cat([a.narrow(axis, 1, n - 1), a.narrow(axis, n - 1, 1)],
                   axis)
    return lo, hi


def _coarsen_mask(mask, odd):
    """Conservative coarse mask: a coarse point is active only if ALL fine
    points in its support are.  Odd (vertex-coarsened) axes pool the full
    3-point support {2i-1, 2i, 2i+1} so thin masked features on skipped
    rows/cols cannot vanish from coarse levels; even (cell) axes pool the
    pair."""
    m = mask
    for ax_rel, o in enumerate(odd):
        ax = m.ndim - 2 + ax_rel
        if o:
            lo, hi = _shifted(m, ax, False)
            m = _coarsen_axis_vertex(lo & m & hi, ax)
        else:
            m = _every_other(m, ax) & _every_other(m, ax, 1)
    return m


def _restrict_axis(r, axis, odd, periodic):
    """Full-weighting along one axis."""
    if odd:
        # vertex: (r[2i-1] + 2 r[2i] + r[2i+1]) / 4, one-sided at the ends
        lo, hi = _shifted(r, axis, periodic)
        w = 0.25 * lo + 0.5 * r + 0.25 * hi
        return _coarsen_axis_vertex(w, axis)
    return _coarsen_axis_cell(r, axis)


def restrict(r, odd, bcs):
    for ax_rel, o in enumerate(odd):
        ax = r.ndim - 2 + ax_rel
        r = _restrict_axis(r, ax, o, bcs[ax_rel] == "periodic")
    return r


def _prolong_axis(e, axis, n_fine, odd, periodic):
    shp = list(e.shape)
    shp[axis] = 2 * e.shape[axis]
    if odd:
        # vertex linear: p[2i] = e[i]; p[2i+1] = (e[i] + e[i+1]) / 2
        nxt = _shifted(e, axis, periodic)[1]
        mid = 0.5 * (e + nxt)
        out = torch.stack([e, mid], dim=axis + 1).reshape(shp)
        return out.narrow(axis, 0, n_fine)
    # cell: nearest-neighbor injection of each coarse cell into its pair
    return torch.stack([e, e], dim=axis + 1).reshape(shp)


def prolong(e, fine_shape, odd, bcs):
    for ax_rel in reversed(range(2)):
        ax = e.ndim - 2 + ax_rel
        e = _prolong_axis(e, ax, fine_shape[ax_rel], odd[ax_rel],
                          bcs[ax_rel] == "periodic")
    return e


# ---------------------------------------------------------------- pyramid

def _pyramid_plan(shape, bcs, deltas, min_size, max_levels):
    """Static level plan [(shape, deltas, odd)], replicating the build
    loop's stopping rule (depth cap, min size, odd-periodic halt).

    ``shape``/``bcs`` cover only the COARSENED (trailing) dims; ``deltas``
    is the full per-dim spacing tuple, of which only the trailing
    ``len(shape)`` entries double per level (3-D semicoarsening keeps
    delz)."""
    out = []
    lvl = tuple(shape)
    dd = tuple(deltas)
    keep = len(dd) - len(lvl)
    while True:
        odd = tuple(n % 2 == 1 for n in lvl)
        out.append((lvl, dd, odd))
        nxt = tuple((n + 1) // 2 if n % 2 else n // 2 for n in lvl)
        if (len(out) >= max_levels or min(nxt) < min_size
                or any(bcs[i] == "periodic" and lvl[i] % 2
                       for i in range(len(lvl)))):
            return tuple(out)
        dd = dd[:keep] + tuple(d * 2 for d in dd[keep:])
        lvl = nxt


def _ref(*xs):
    """(dtype, device) of the first floating tensor among ``xs``, else
    torch's defaults: the pyramid's planes take them."""
    for x in xs:
        if torch.is_tensor(x) and x.is_floating_point():
            return x.dtype, x.device
    return torch.get_default_dtype(), torch.get_default_device()


def _plane(x, dtype, device, shape=None):
    """``x`` as a tensor of ``dtype`` on ``device``; a Python scalar
    becomes a plane of ``shape``."""
    if np.isscalar(x):
        return torch.zeros(shape, dtype=dtype, device=device) + x
    if not torch.is_tensor(x):
        x = torch.tensor(np.array(x))
    return x.to(dtype=dtype, device=device)


def _mask(Fdef, device, shape=None):
    m = Fdef if torch.is_tensor(Fdef) else torch.tensor(np.array(Fdef))
    m = m.to(device=device, dtype=torch.bool)
    return m if shape is None or m.ndim == len(shape) else \
        m.broadcast_to(shape).contiguous()


def _levels(specs, plan, masked):
    """Omega-1 levels over the plan (the near-2 'optimal' SOR factor kills
    the smoothing property)."""
    return [MGLevel(spec=sp, omega=1.0, odd=odd, masked=masked)
            for sp, (shape, dd, odd) in zip(specs, plan)]


def build_pyramid_standard2d(A, B, C, F, Fdef, deltas, bcs,
                             min_size: int = 15,
                             max_levels: int = 10) -> List[MGLevel]:
    """Coefficient pyramid for d/dy(A Sy + B Sx) + d/dx(B Sy + C Sx) = F.

    Level 0 is the fine problem; deeper levels re-discretise the coarsened
    coefficients on doubled spacings.  BC types carry through unchanged:
    the error equation inherits the fine operator's boundary behaviour.
    """
    dtype, device = _ref(A, C, F)
    A = _plane(A, dtype, device)
    B = _plane(B, dtype, device, A.shape)
    C = _plane(C, dtype, device)
    F = _plane(F, dtype, device)
    mask = _mask(Fdef, device)
    is_masked = not bool(torch.all(mask))
    include_cross = bool(torch.any(B != 0))

    bcs = tuple(bcs)
    plan = _pyramid_plan(F.shape[-2:], bcs, tuple(deltas), min_size,
                         max_levels)
    specs = []
    for i, (shape, dd, odd) in enumerate(plan):
        specs.append(stencil.standard_2d(A, B, C, F, mask, dd, bcs,
                                         include_cross=include_cross))
        if i + 1 < len(plan):
            A, B, C = (_coarsen_plane(p, odd) for p in (A, B, C))
            # conservative coarse mask: Dirichlet anchor cells must
            # SURVIVE coarsening (with extend+periodic BCs they are the
            # only thing fixing the constant nullspace)
            mask = _coarsen_mask(mask, odd)
            F = torch.zeros(plan[i + 1][0], dtype=dtype, device=device)
    levels = _levels(specs, plan, is_masked)
    # the coarsest level iterates to convergence: the optimal factor
    levels[-1] = dataclasses.replace(levels[-1],
                                     omega=optimal_omega(plan[-1][0]))
    return _stamp_smoother(levels)


def _ddy(p, d):
    """Central-difference d/dy of a coefficient plane (one-sided edges)."""
    g = (torch.roll(p, -1, -2) - torch.roll(p, 1, -2)) / (2.0 * d)
    g[..., 0, :] = (p[..., 1, :] - p[..., 0, :]) / d
    g[..., -1, :] = (p[..., -1, :] - p[..., -2, :]) / d
    return g


def _ddx(p, d):
    g = (torch.roll(p, -1, -1) - torch.roll(p, 1, -1)) / (2.0 * d)
    g[..., 0] = (p[..., 1] - p[..., 0]) / d
    g[..., -1] = (p[..., -1] - p[..., -2]) / d
    return g


def _fill_stagger_nan(p):
    """The half-grid staggering leaves a NaN leading row/column
    (problems._half); level 0 is immune (finalisation zeroes inactive
    cells) but the coarse derivative stencils would drag it into active
    interior cells: fill with the adjacent genuine value."""
    p = p.clone()
    r0 = p[..., 0, :]
    p[..., 0, :] = torch.where(torch.isfinite(r0), r0, p[..., 1, :])
    c0 = p[..., :, 0]
    p[..., :, 0] = torch.where(torch.isfinite(c0), c0, p[..., :, 1])
    return p


def build_pyramid_standard2d_e(A, B, C, D, E, F, Fdef, deltas, bcs,
                               min_size: int = 15,
                               max_levels: int = 10) -> List[MGLevel]:
    """Coefficient pyramid for the standard-2D+E psi family:
    d/dy(A Sy + B Sx) + d/dx(C Sy + D Sx) + E S = F.

    Level 0 is the exact reference discretisation (stencil.standard_2d_e).
    Coarser levels re-express the operator in GENERAL form with first-order
    upwind advection (the flux cross terms hide advection:
    d/dy(B Sx) + d/dx(C Sy) = (B+C) Sxy + B_y Sx + C_x Sy):

        A Syy + (B+C) Syx + D Sxx + (A_y + C_x) Sy + (D_x + B_y) Sx + E S

    upwinded with the per-cell sign normalisation; E coarsens with the
    fluxes and re-enters each level's diagonal."""
    dtype, device = _ref(A, D, F)
    A = _plane(A, dtype, device)
    B = _plane(B, dtype, device, A.shape)
    C = _plane(C, dtype, device, A.shape)
    D = _plane(D, dtype, device)
    E = _plane(E, dtype, device, A.shape)
    F = _plane(F, dtype, device)
    mask = _mask(Fdef, device)
    is_masked = not bool(torch.all(mask))
    # the near-2 Laplacian-optimal coarsest factor only without advection
    # in the cross fluxes; gate on the planes being individually zero (the
    # antisymmetric B = -C has B + C == 0 while carrying advection)
    no_cross = not bool(torch.any(B != 0) | torch.any(C != 0))

    bcs = tuple(bcs)
    plan = _pyramid_plan(F.shape[-2:], bcs, tuple(deltas), min_size,
                         max_levels)
    specs = []
    for i, (shape, dd, odd) in enumerate(plan):
        if i == 0:
            specs.append(stencil.standard_2d_e(A, B, C, D, E, F, mask, dd,
                                               bcs))
            A, B, C, D, E = (_fill_stagger_nan(p) for p in (A, B, C, D, E))
        else:
            dely, delx = dd[-2], dd[-1]
            Ag, Bg, Cg = A, B + C, D
            Dg = _ddy(A, dely) + _ddx(C, delx)
            Eg = _ddx(D, delx) + _ddy(B, dely)
            s = _upwind_sign(Ag, Cg)
            specs.append(stencil.general_2d(Ag, Bg, Cg, Dg, Eg, E, F, mask,
                                            dd, bcs, upwind=s))
        if i + 1 < len(plan):
            A, B, C, D, E = (_coarsen_plane(p, odd) for p in (A, B, C, D, E))
            mask = _coarsen_mask(mask, odd)
            F = torch.zeros(plan[i + 1][0], dtype=dtype, device=device)
    levels = _levels(specs, plan, is_masked)
    if no_cross:
        levels[-1] = dataclasses.replace(levels[-1],
                                         omega=optimal_omega(plan[-1][0]))
    return _stamp_smoother(levels)


def _stamp_smoother(levels):
    """Record the auto-selected smoother on the finest level."""
    levels[0] = dataclasses.replace(levels[0],
                                    smoother=_auto_smoother(levels[0].spec))
    return levels


def build_pyramid_standard3d(A, B, C, F, Fdef, deltas, bcs,
                             min_size: int = 9,
                             max_levels: int = 10) -> List[MGLevel]:
    """Coefficient pyramid for d/dz(A Sz) + d/dy(B Sy) + d/dx(C Sx) = F
    (the QG-omega family).  SEMICOARSENING: only the trailing (y, x) dims
    coarsen; each level re-discretises on the doubled (dely, delx) with the
    original delz."""
    dtype, device = _ref(A, C, F)
    A, B, C, F = (_plane(p, dtype, device) for p in (A, B, C, F))
    mask = _mask(Fdef, device, tuple(F.shape))
    is_masked = not bool(torch.all(mask))

    nz = F.shape[0]
    bcs = tuple(bcs)
    plan = _pyramid_plan(F.shape[-2:], bcs[1:], tuple(deltas), min_size,
                         max_levels)
    specs = []
    for i, (shape, dd, odd) in enumerate(plan):
        specs.append(stencil.standard_3d(A, B, C, F, mask, dd, bcs))
        if i + 1 < len(plan):
            A, B, C = (_coarsen_plane(p, odd) for p in (A, B, C))
            mask = _coarsen_mask(mask, odd)
            F = torch.zeros((nz,) + plan[i + 1][0], dtype=dtype,
                            device=device)
    levels = _levels(specs, plan, is_masked)
    levels[-1] = dataclasses.replace(
        levels[-1], omega=optimal_omega((nz,) + plan[-1][0]))
    return _stamp_smoother(levels)


def _upwind_sign(A, C):
    """PER-CELL sign normalisation for coarse-level upwinding: +-1 such
    that s * (A, C) is locally the non-negative-diffusion convention (a
    region of mixed sign gets its own orientation)."""
    return torch.where(A + C >= 0, 1.0, -1.0).to(A.dtype)


def build_pyramid_general2d(A, B, C, D, E, F, G, Fdef, deltas, bcs,
                            min_size: int = 15,
                            max_levels: int = 10) -> List[MGLevel]:
    """Coefficient pyramid for the damped advective general-2D family
    A Syy + B Syx + C Sxx + D Sy + E Sx + F S = G (Gill-Matsuno, Stommel,
    Stommel-Arons).  Level 0 keeps the reference's centered first
    derivatives; coarser levels re-discretise with first-order UPWIND
    advection (the converged answer is still the fine centered one)."""
    dtype, device = _ref(G, A, C)
    G = _plane(G, dtype, device)
    planes = [_plane(p, dtype, device, tuple(G.shape[-2:]))
              for p in (A, B, C, D, E, F)]
    mask = _mask(Fdef, device)
    is_masked = not bool(torch.all(mask))

    bcs = tuple(bcs)
    plan = _pyramid_plan(G.shape[-2:], bcs, tuple(deltas), min_size,
                         max_levels)
    specs = []
    Gl = G
    for i, (shape, dd, odd) in enumerate(plan):
        s = _upwind_sign(planes[0], planes[2])
        specs.append(stencil.general_2d(*planes, Gl, mask, dd, bcs,
                                        upwind=(0.0 if i == 0 else s)))
        if i + 1 < len(plan):
            planes = [_coarsen_plane(p, odd) for p in planes]
            mask = _coarsen_mask(mask, odd)
            Gl = torch.zeros(plan[i + 1][0], dtype=dtype, device=device)
    # omega ~ 1 on every level: on the (upwinded) coarsest level GS
    # iterates robustly where the Laplacian-optimal factor can diverge
    return _stamp_smoother(_levels(specs, plan, is_masked))


def build_pyramid_general3d(A, B, C, D, E, F, G, H, Fdef, deltas, bcs,
                            min_size: int = 9,
                            max_levels: int = 10) -> List[MGLevel]:
    """Coefficient pyramid for the general-3D family A Szz + B Syy + C Sxx
    + D Sz + E Sy + F Sx + G S = H (the damped 3DOcean flow):
    semicoarsening over (y, x), coarse levels upwinded."""
    dtype, device = _ref(H, A, C)
    H = _plane(H, dtype, device)
    planes = [_plane(p, dtype, device, tuple(H.shape[-3:]))
              for p in (A, B, C, D, E, F, G)]
    mask = _mask(Fdef, device, tuple(H.shape[-3:]))
    is_masked = not bool(torch.all(mask))

    nz = H.shape[-3]
    bcs = tuple(bcs)
    plan = _pyramid_plan(H.shape[-2:], bcs[1:], tuple(deltas), min_size,
                         max_levels)
    specs = []
    Hl = H
    for i, (shape, dd, odd) in enumerate(plan):
        s = _upwind_sign(planes[0], planes[2])
        specs.append(stencil.general_3d(*planes, Hl, mask, dd, bcs,
                                        upwind=(0.0 if i == 0 else s)))
        if i + 1 < len(plan):
            planes = [_coarsen_plane(p, odd) for p in planes]
            mask = _coarsen_mask(mask, odd)
            Hl = torch.zeros((nz,) + plan[i + 1][0], dtype=dtype,
                             device=device)
    return _stamp_smoother(_levels(specs, plan, is_masked))


def build_pyramid_bih2d(coeffs, J, Fdef, deltas, bcs,
                        min_size: int = 15,
                        max_levels: int = 10) -> List[MGLevel]:
    """Coefficient pyramid for the general biharmonic family
    A Syyyy + B Syyxx + C Sxxxx + D Syy + E Syx + F Sxx + G Sy + H Sx
    + I S = J (the Stommel-Munk gyre); ``coeffs`` is (A, ..., I).  Every
    level relaxes with omega 1 (the near-2 factor diverges on the 13-point
    stencil)."""
    dtype, device = _ref(J, *coeffs)
    J = _plane(J, dtype, device)
    cs = [_plane(c, dtype, device, tuple(J.shape[-2:])) for c in coeffs]
    mask = _mask(Fdef, device)
    is_masked = not bool(torch.all(mask))

    bcs = tuple(bcs)
    plan = _pyramid_plan(J.shape[-2:], bcs, tuple(deltas), min_size,
                         max_levels)
    specs = []
    Jl = J
    for i, (shape, dd, odd) in enumerate(plan):
        specs.append(stencil.general_2d_bih(*cs, Jl, mask, dd, bcs))
        if i + 1 < len(plan):
            cs = [_coarsen_plane(c, odd) for c in cs]
            mask = _coarsen_mask(mask, odd)
            Jl = torch.zeros(plan[i + 1][0], dtype=dtype, device=device)
    return _stamp_smoother(_levels(specs, plan, is_masked))


# ---------------------------------------------------------------- smoothers

def _smooth(level: MGLevel, S, n):
    """n red-black SOR sweeps, the point smoother, through the SOR engine's
    executor: the tiled kernel on CUDA tensors, its plain version on CPU
    tensors."""
    if not n:
        return S
    run_sweeps = _select_kernel(level.spec, S)
    return run_sweeps(level.spec, S, level.omega, n)


def _line_system(spec, axis, S, origin=None):
    """What a zebra sweep along ``axis`` (negative, core-relative) solves
    that does not change from sweep to sweep: the line bands with ``axis``
    last (inactive cells identity rows, b=1), their log-depth factor and
    periodic corner columns
    (:func:`xinvert_tpu_torch.ops.tridiag._pscan_factor`,
    ``_cyclic_units``), and the cells each parity updates (the
    checkerboard of the OTHER core dims, on active cells).  The bands stay
    at the planes' shape; a batched state's lines ride the rhs batch.
    ``origin`` (per core dim): the global index of the planes' first cell
    (a block of a split level), so the parity is the whole grid's."""
    from .ops.tridiag import _cyclic_units, _pscan_factor

    nd = spec.ndim
    offs = {tuple(o): k for k, o in enumerate(spec.offsets)}
    unit = tuple(1 if i == nd + axis else 0 for i in range(nd))
    nunit = tuple(-u for u in unit)
    active = spec.active
    # per-line system: a x_{i-1} + b x_i + c x_{i+1} = d along `axis`
    a_l = torch.movedim(torch.where(active, spec.w[offs[nunit]], 0.0), axis,
                        -1)
    c_l = torch.movedim(torch.where(active, spec.w[offs[unit]], 0.0), axis,
                        -1)
    b_l = torch.movedim(torch.where(active, spec.w0, 1.0), axis, -1)
    factor = _pscan_factor(a_l[..., 1:], b_l, c_l[..., :-1])
    if spec.bcs[axis] == "periodic":
        units = _cyclic_units(factor, a_l[..., 0], c_l[..., -1])
    else:
        units = _cyclic_units(factor, 0.0, 0.0)
    par = 0
    core_shape = S.shape[-nd:]
    for ax in range(nd):
        if ax == nd + axis:
            continue
        view = [1] * nd
        view[ax] = core_shape[ax]
        par = par + (torch.arange(core_shape[ax], device=S.device)
                     + (origin[ax] if origin else 0)).reshape(view)
    take = tuple((par % 2 == parity) & active for parity in (0, 1))
    return factor, units, take


def _zebra_line_sweep(spec, S, axis, system=None):
    """One zebra line iteration along ``axis`` (negative, core-relative):
    solve every odd line's (cyclic) tridiagonal exactly, then every even
    line's; parity is the checkerboard of the OTHER core dims, so
    same-parity lines do not couple through the off-axis offsets.
    Inactive cells become identity rows (b=1, rhs=S).  ``system`` is
    :func:`_line_system`'s, made here when not given."""
    from .ops.tridiag import _cyclic_substitute

    nd = spec.ndim
    factor, units, take = system or _line_system(spec, axis, S)
    active = spec.active

    def solve_parity(S, parity):
        acc = spec.g
        for k, off in enumerate(spec.offsets):
            if off[nd + axis] != 0:
                continue
            shifts = tuple(-o for o in off if o != 0)
            axes = tuple(ax - nd for ax, o in enumerate(off) if o != 0)
            acc = acc + spec.w[k] * torch.roll(S, shifts=shifts, dims=axes)
        d_l = torch.movedim(torch.where(active, -acc, S), axis, -1)
        sol = torch.movedim(_cyclic_substitute(factor, d_l, units), -1, axis)
        return torch.where(take[parity], sol, S)

    S = _apply_extend(spec, S)
    S = solve_parity(S, 1)
    S = solve_parity(S, 0)
    return S


_SMOOTH_AXES = {"line": (-1,), "xline": (-1,), "zline": (-3,),
                "zxline": (-3, -1)}


def _smooth_line(level: MGLevel, S, n, axes=(-1,)):
    """n zebra iterations along ``axes`` in turn, each axis's line system
    made once for the n."""
    systems = {ax: _line_system(level.spec, ax, S) for ax in axes} if n \
        else {}
    for _ in range(int(n)):
        for ax in axes:
            S = _zebra_line_sweep(level.spec, S, ax, systems[ax])
    return S


def _residual(spec, S):
    """Folded-system residual (the restriction of the folded residual
    differs from the coarse fold by the constant (delx_c/delx_f)^2 = 4,
    applied explicitly in the V-cycle)."""
    r = _neighbor_sum(spec, S) + spec.w0 * S
    return torch.where(spec.active, r, 0.0)


def _with_g(spec, g):
    """``spec`` with its constant term replaced by ``g`` on active cells."""
    return dataclasses.replace(spec, g=torch.where(spec.active, g, 0.0))


def _vcycle(levels: List[MGLevel], lvl: int, S, g_override,
            nu1: int, nu2: int, coarse_iters: int, alpha: float = 1.0,
            smoother: str = "point"):
    if smoother in _SMOOTH_AXES:
        axes = _SMOOTH_AXES[smoother]

        def sm(level, S, n):
            return _smooth_line(level, S, n, axes)
    else:
        sm = _smooth
    level = levels[lvl]
    spec = level.spec
    if g_override is not None:
        spec = _with_g(spec, g_override)
        level = dataclasses.replace(level, spec=spec)

    if lvl == len(levels) - 1:
        return sm(level, S, coarse_iters)

    S = sm(level, S, nu1)
    # residual of the folded system: sum w S + w0 S + g = 0
    r = _residual(spec, S)
    bcs2 = spec.bcs[-2:]          # only the trailing (y, x) dims coarsen
    r_c = restrict(r, level.odd, bcs2)
    # the error e solves M e = r, i.e. folded form M_c e + g_c = 0 with
    # g_c = -scale * r_c; the folded system carries the level's delx^2
    # (delx^4 for the biharmonic family), so scale = (delx_c/delx_f)^p
    g_c = (-16.0 if spec.bih else -4.0) * r_c
    e = _vcycle(levels, lvl + 1, torch.zeros_like(r_c), g_c, nu1, nu2,
                coarse_iters, alpha, smoother)
    corr = prolong(e, spec.w0.shape[-2:], level.odd, bcs2)
    # alpha < 1 damps the coarse-grid correction (irregular masks)
    S = torch.where(spec.active, S - alpha * corr, S)
    return sm(level, S, nu2)


def _g_scale(g, nd):
    """max |g| over the core axes, floored at the dtype's tiny (an all-zero
    forcing then reports res 0, not 0/0)."""
    m = torch.amax(torch.abs(g), dim=tuple(range(-nd, 0)))
    return torch.maximum(m, torch.tensor(torch.finfo(g.dtype).tiny,
                                         dtype=g.dtype, device=g.device))


def _bdot(x, y, nd):
    """Per-member inner product over the ``nd`` core axes."""
    return torch.sum(x * y, dim=tuple(range(-nd, 0)))


def _bwhere(go, new, old, nd=0):
    """``new`` where the member's ``go`` is set, else ``old`` (``go`` per
    member, lifted over ``nd`` core axes)."""
    return torch.where(go.reshape(go.shape + (1,) * nd), new, old)


def _bicgstab(A, b, x0, M, maxiter, live, nd, tol=0.0, atol=0.0):
    """``jax.scipy.sparse.linalg.bicgstab(A, b, x0, M=M, tol=tol,
    atol=atol, maxiter=maxiter)`` step for step (JAX's ``_bicgstab_solve``,
    preconditioned BiCGStab), per member of a batch: rho0 = alpha0 = omega0
    = 1; a member iterates while it is ``live``, |r|^2 > max(tol^2 |b|^2,
    atol^2) and 0 <= k < maxiter, and is held fixed once its test fails,
    as under ``vmap``; the early-exit select; the breakdown codes k = -10
    (rho = 0) and -11 (omega = 0 or alpha = 0) that end its loop.  One
    host sync per loop test."""
    bs = _bdot(b, b, nd)
    atol2 = torch.maximum(tol * tol * bs, torch.full_like(bs, atol * atol))
    one = torch.ones_like(bs)
    r0 = b - A(x0)
    x, r, rhat, p, q = x0, r0, r0, r0, r0
    alpha, omega, rho = one, one, one
    k = torch.zeros(bs.shape, dtype=torch.int64, device=b.device)
    while True:
        go = live & (_bdot(r, r, nd) > atol2) & (k < maxiter) & (k >= 0)
        any_go, all_go = _sync(torch.stack([go.any(), go.all()]))
        if not any_go:
            return x

        def lift(v):
            return v.reshape(v.shape + (1,) * nd)
        rho_ = _bdot(rhat, r, nd)
        beta = rho_ / rho * alpha / omega
        p_ = r + lift(beta) * (p - lift(omega) * q)
        phat = M(p_)
        q_ = A(phat)
        alpha_ = rho_ / _bdot(rhat, q_, nd)
        s = r - lift(alpha_) * q_
        exit_early = lift(_bdot(s, s, nd) < atol2)
        shat = M(s)
        t = A(shat)
        omega_ = _bdot(t, s, nd) / _bdot(t, t, nd)
        x_ = torch.where(exit_early, x + lift(alpha_) * phat,
                         x + (lift(alpha_) * phat + lift(omega_) * shat))
        r_ = torch.where(exit_early, s, s - lift(omega_) * t)
        k_ = torch.where((omega_ == 0) | (alpha_ == 0), -11, k + 1)
        k_ = torch.where(rho_ == 0, -10, k_)
        new = (x_, r_, alpha_, omega_, rho_, p_, q_, k_)
        if not all_go:
            new = tuple(_bwhere(go, n, o, n.ndim - go.ndim)
                        for n, o in zip(new, (x, r, alpha, omega, rho, p, q,
                                              k)))
        x, r, alpha, omega, rho, p, q, k = new


def _solve_mg_krylov(levels, S0, g0, tol, max_cycles, nu1, nu2,
                     coarse_iters, alpha, smoother, vcycle=None):
    """V-cycle-preconditioned BiCGStab on the folded system.

    Plain coarse-grid correction fails on advection-dominated operators
    (the Stommel/Stommel-Arons beta terms); wrapping the SAME V-cycle as a
    Krylov preconditioner restores fast convergence.  Solves for the
    CORRECTION e with A e = r(S0), inactive cells pinned at zero, so icbc
    Dirichlet data in S0 rides through untouched.  ``max_cycles`` bounds
    the Krylov iterations, checked in chunks of 8; the stall rule watches
    the BEST iterate, keeps it, and gives up after 4 chunks without a 5%
    new best.  ``S0`` (and ``g0``) may carry one leading batch axis: each
    member runs its own loops and is held fixed once they end, as under
    JAX's ``vmap``.  Returns (S, V-cycle-equivalents (2 per iteration),
    res), the last two per member.  ``vcycle``: the preconditioner's
    V-cycle, :func:`_vcycle`'s signature (a sharded pyramid's)."""
    vcycle = vcycle or _vcycle
    spec = levels[0].spec
    nd = spec.ndim
    if g0 is not None:
        spec = _with_g(spec, g0)
        levels = [dataclasses.replace(levels[0], spec=spec)] + \
            list(levels[1:])
    act = spec.active
    spec_l = dataclasses.replace(spec, g=torch.zeros_like(spec.g))
    g_scale = _g_scale(spec.g, nd)
    tol_t = torch.tensor(tol, dtype=S0.dtype, device=S0.device)
    core = tuple(range(-nd, 0))

    def matvec(x):
        return torch.where(act, _neighbor_sum(spec_l, x) + spec.w0 * x, x)

    def precond(r):
        return vcycle(levels, 0, torch.zeros_like(r),
                       torch.where(act, -r, 0.0), nu1, nu2, coarse_iters,
                       alpha, smoother)

    b = torch.where(act, -(_neighbor_sum(spec_l, S0) + spec.w0 * S0
                           + spec.g), 0.0)
    inner = 8
    n_chunks = max(1, -(-int(max_cycles) // inner))
    # seed `best` with S0's own residual (e = 0), not inf: members that
    # already satisfy the tolerance skip the loop
    best = (torch.amax(torch.abs(b), dim=core) / g_scale).to(S0.dtype)
    e = e_best = torch.zeros_like(S0)
    k = torch.zeros(best.shape, dtype=torch.int64, device=S0.device)
    stall = torch.zeros_like(k)
    while True:
        go = (k < n_chunks * inner) & (best >= tol_t) & (stall < 4)
        any_go, all_go = _sync(torch.stack([go.any(), go.all()]))
        if not any_go:
            return S0 + torch.where(act, e_best, 0.0), 2 * k, best
        e_new = _bicgstab(matvec, b, e, precond, inner, go, nd)
        # a Krylov breakdown producing nan falls back to the previous
        # iterate and lets the stall counter end the solve
        bad = ~torch.isfinite(torch.amax(torch.abs(e_new), dim=core))
        e_new = _bwhere(bad, e, e_new, nd)
        new_res = torch.amax(torch.abs(matvec(e_new) - b), dim=core) / g_scale
        new = (e_new, _bwhere(new_res < best, e_new, e_best, nd),
               torch.minimum(best, new_res), k + inner,
               torch.where(new_res <= 0.95 * best, 0, stall + 1))
        if not all_go:
            new = tuple(_bwhere(go, n, o, n.ndim - go.ndim)
                        for n, o in zip(new, (e, e_best, best, k, stall)))
        e, e_best, best, k, stall = new


def _fmg_init(levels, spec, S0, nu1, nu2, coarse_iters, alpha, smoother,
              vcycle=None):
    """Full-multigrid (nested-iteration) initial guess: the forcing
    restricts down the hierarchy (x4 per coarsening, x16 biharmonic), the
    coarsest level is smoothed to convergence, and the solution prolongs up
    with one V-cycle per level.  Replaces S0 on active cells.  ``vcycle``:
    :func:`_vcycle` or a sharded pyramid's, with its signature."""
    vcycle = vcycle or _vcycle
    gs = [spec.g]
    for lv, nxt in zip(levels[:-1], levels[1:]):
        scale = 16.0 if lv.spec.bih else 4.0
        gc = scale * restrict(gs[-1], lv.odd, lv.spec.bcs[-2:])
        gs.append(torch.where(nxt.spec.active, gc, 0.0))
    e = vcycle(levels, len(levels) - 1, torch.zeros_like(gs[-1]), gs[-1],
               nu1, nu2, coarse_iters, alpha, smoother)
    for lv_i in range(len(levels) - 2, -1, -1):
        lv = levels[lv_i]
        e = prolong(e, lv.spec.w0.shape[-2:], lv.odd, lv.spec.bcs[-2:])
        e = torch.where(lv.spec.active, e, 0.0)
        e = vcycle(levels, lv_i, e, gs[lv_i], nu1, nu2, coarse_iters, alpha,
                   smoother)
    return torch.where(spec.active, e, S0)


class _FinestState:
    """The finest level's state between :func:`_solve_mg`'s V-cycles: one
    tensor.  A sharded pyramid keeps it on its blocks instead
    (:class:`xinvert_tpu_torch.parallel.pyramid.BlockState`), with the same
    constructor and methods."""

    def __init__(self, levels, spec, S, args):
        self.levels, self.spec, self.S, self.args = levels, spec, S, args

    def cycle(self, go):
        """One V-cycle; the members outside ``go`` (None: every member
        goes) keep their state.  Returns each member's max |r| over the
        core."""
        nd = self.spec.ndim
        S_new = _vcycle(self.levels, 0, self.S, self.spec.g, *self.args)
        r = torch.amax(torch.abs(_residual(self.spec, S_new)),
                       dim=tuple(range(-nd, 0)))
        self.S = S_new if go is None else _bwhere(go, S_new, self.S, nd)
        return r

    def field(self):
        return self.S


def _solve_mg(levels, S0, g0, tol, max_cycles, nu1, nu2, coarse_iters,
              alpha, smoother, fmg=False, vcycle=None, state=None):
    """V-cycles to the residual tolerance.  ``S0`` may carry one leading
    batch axis (then ``g0`` does too): every member runs until its own test
    ends it and is then held fixed, as under JAX's ``vmap``.  Returns (S,
    cycles, res), the last two per member.  A sharded pyramid passes its
    ``vcycle`` (:func:`_vcycle`'s signature, for the nested start) and
    ``state`` (:class:`_FinestState`'s)."""
    spec = levels[0].spec
    nd = spec.ndim
    if g0 is not None:
        spec = _with_g(spec, g0)
    args = (nu1, nu2, coarse_iters, alpha, smoother)
    if fmg and len(levels) > 1:
        S0 = _fmg_init(levels, spec, S0, *args, vcycle=vcycle)
    g_scale = _g_scale(spec.g, nd)
    tol_t = torch.tensor(tol, dtype=S0.dtype, device=S0.device)
    batch = S0.shape[:S0.ndim - nd]
    S = (state or _FinestState)(levels, spec, S0, args)
    k = torch.zeros(batch, dtype=torch.int64, device=S0.device)
    stall = torch.zeros_like(k)
    res = torch.full(batch, float("inf"), dtype=S0.dtype, device=S0.device)
    while True:
        # stop on tolerance, cycle budget, or 2 consecutive non-improving
        # cycles (the residual floor is precision-limited)
        go = (k < max_cycles) & (res >= tol_t) & (stall < 2)
        any_go, all_go = _sync(torch.stack([go.any(), go.all()]))
        if not any_go:
            return S.field(), k, res
        new_res = S.cycle(None if all_go else go) / g_scale
        new = (k + 1, new_res,
               torch.where(new_res <= 0.9 * res, 0, stall + 1))
        if not all_go:
            new = tuple(_bwhere(go, n, o)
                        for n, o in zip(new, (k, res, stall)))
        k, res, stall = new


def solve_mg(levels: List[MGLevel], S0=None, tol: float = 1e-6,
             max_cycles: int = 50, nu1: int = 2, nu2: int = 2,
             coarse_iters: int = 60, alpha: Optional[float] = None,
             smoother: Optional[str] = None, g0=None,
             accel: Optional[str] = "auto", fmg: bool = False):
    """V-cycle to a RESIDUAL tolerance (relative to max |g|).

    ``g0`` overrides the finest level's folded constant term, enabling
    BATCHED solves over a shared operator: when ``S0``/``g0`` carry leading
    batch axes, each member converges by its own residual test.  ``S0``
    doubles as the icbc warm start: inactive cells keep their initial
    values.  ``accel``: ``None`` runs plain V-cycles; ``'bicgstab'`` the
    V-cycle-preconditioned Krylov solver; ``'auto'`` (default) plain
    V-cycles and, only if they end above ``tol``, Krylov-wrapped from the
    partial result.  Runs on the levels' device.

    Returns ``(solution, cycles, res, converged)``; ``converged`` is False
    when the budget or the stagnation guard ended the solve with ``res``
    above ``tol`` (any member, for batched solves).
    """
    return _solve_stages(levels, S0, tol, max_cycles, nu1, nu2,
                         coarse_iters, alpha, smoother, g0, accel, fmg)


def _solve_stages(levels, S0, tol, max_cycles, nu1, nu2, coarse_iters,
                  alpha, smoother, g0, accel, fmg, vcycle=None, state=None):
    """:func:`solve_mg`'s body: the defaults, the batch, and the plain and
    Krylov stages.  A sharded pyramid passes its ``vcycle`` (the nested
    start's and the Krylov preconditioner's) and the ``state`` that keeps
    the plain stage's state on its blocks (:func:`_solve_mg`); None: the
    meshless ones."""
    spec = levels[0].spec
    nd = spec.ndim
    if smoother is None:
        smoother = getattr(levels[0], "smoother", None) or \
            _auto_smoother(spec)
    if alpha is None:
        # undamped correction on fully active domains; irregular masks
        # need damping for stability
        alpha = 0.8 if levels[0].masked else 1.0
    if accel not in (None, "auto", "bicgstab"):
        raise ValueError(f"unknown accel {accel!r}")
    dtype, device = spec.w0.dtype, spec.w0.device
    if S0 is None:
        S0 = torch.zeros(spec.w0.shape[-nd:], dtype=dtype, device=device)
    S0 = torch.as_tensor(S0, dtype=dtype, device=device)
    kw = dict(nu1=nu1, nu2=nu2, coarse_iters=coarse_iters,
              alpha=float(alpha), smoother=str(smoother))

    batched = S0.ndim > nd
    if batched:
        S0 = S0.reshape((-1,) + S0.shape[-nd:])
        if g0 is None:
            raise ValueError("batched solve_mg needs a batched g0")
        g0 = torch.as_tensor(g0, dtype=dtype, device=device).reshape(
            (-1,) + S0.shape[1:])
    elif g0 is not None:
        g0 = torch.as_tensor(g0, dtype=dtype, device=device)
    stages = ([(False, 0)] if accel is None else
              [(True, 0)] if accel == "bicgstab" else
              [(False, 0), (True, 1)])
    S, k_tot, res_f = S0, 0, float("inf")
    for krylov, rescue in stages:
        # a NaN residual ends a single solve but goes on to the rescue in a
        # batch, as in the JAX package
        if rescue and (res_f < tol if batched else not res_f >= tol):
            break
        if krylov:
            S, k, res = _solve_mg_krylov(levels, S, g0, tol, max_cycles,
                                         vcycle=vcycle, **kw)
        else:
            S, k, res = _solve_mg(levels, S, g0, tol, max_cycles,
                                  fmg=bool(fmg), vcycle=vcycle, state=state,
                                  **kw)
        # a batch reports its slowest member's cycles and worst residual
        k_tot += int(torch.max(k))
        res_f = float(torch.max(res))
    return S, k_tot, res_f, res_f < tol
