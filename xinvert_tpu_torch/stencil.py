# -*- coding: utf-8 -*-
"""Universal stencil-program representation for elliptic SOR, in PyTorch.

Every kernel family of the reference (xinvert/numbas.py) shares one
algebraic form once the per-point coefficients are folded:

    residual(S) = sum_k  w_k * S[. + off_k]  +  w0 * S  +  g
    S          <- S + omega * residual(S) / (-w0)

with the SOR denominator equal to ``-w0`` in all seven families.  This module
compiles a family's staggered coefficient planes into a :class:`StencilSpec`
(static neighbor offsets plus dense precomputed weight planes) that the
red-black engine (:mod:`xinvert_tpu_torch.solver`) executes.  Periodicity is
folded into wrap-around neighbor access and masks, so the interior update is
uniform.

Counterpart of ``xinvert_tpu/stencil.py``, with all seven families: the
four 2-D ones (standard-2D, the Poisson path; standard-2D with separate
cross coefficients and a linear term; general-2D; the biharmonic
general-2D), the two 3-D ones (standard-3D, the omega equation; general-3D,
the 3-D ocean) and standard-1D.  The helpers (``shift_plane``,
``_interior_mask``, ``_finalize``) are rank-generic: a 3-D spec updates z on
levels 1..nz-2 only (never periodic, never extended).  Tensors stay on the
device they were built on.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

__all__ = ["StencilSpec", "standard_2d", "standard_2d_e", "general_2d",
           "general_2d_bih", "standard_3d", "general_3d", "standard_1d",
           "prune_zero_offsets", "shift_plane"]


def prune_zero_offsets(spec):
    """Drop offsets whose weight plane is identically zero.

    Exact: a zero weight contributes ``0 * S == +-0`` to the neighbor
    accumulation, and removing it leaves every other term's order unchanged.
    The per-plane test runs on the spec's device and comes back as one
    transfer of K booleans.
    """
    if len(spec.offsets) <= 1:
        return spec
    nz = (spec.w != 0).flatten(1).any(dim=1).cpu().tolist()
    if all(nz):
        return spec
    keep = [k for k in range(len(spec.offsets)) if nz[k]] or [0]
    return dataclasses.replace(
        spec, w=spec.w[keep], offsets=tuple(spec.offsets[k] for k in keep))


@dataclasses.dataclass(frozen=True)
class StencilSpec:
    """A compiled elliptic problem.

    Data (tensors over the core grid, possibly with leading batch dims):
      w      : (K, *grid) neighbor weights; zeroed at inactive points.
      w0     : (*grid) center weight (== minus the SOR denominator).
      g      : (*grid) constant term (forcing folded in), zeroed if inactive.
      relax  : (*grid) active/(-w0), zeroed at inactive points.  The engine
               multiplies by the scalar over-relaxation factor omega.
      active : (*grid) bool, True where the point is updated.

    Meta (static):
      offsets: K neighbor offsets, each a tuple of core-dim shifts.
      bcs    : per-core-dim boundary conditions ('fixed'/'extend'/'periodic').
      bih    : biharmonic (two-ring) problem — controls the extend pre-pass.
      stop_on_zero_norm: replicate the reference's ``norm == 0`` break, which
               exists in the standard 1D/2D kernels only.
    """

    w: torch.Tensor
    w0: torch.Tensor
    g: torch.Tensor
    relax: torch.Tensor
    active: torch.Tensor
    offsets: Tuple[Tuple[int, ...], ...]
    bcs: Tuple[str, ...]
    bih: bool = False
    stop_on_zero_norm: bool = True

    @property
    def ndim(self) -> int:
        return len(self.bcs)

    @classmethod
    def from_arrays(cls, w, w0, g, relax, active, offsets, bcs, bih=False,
                    stop_on_zero_norm=True, *, device=None, dtype=None):
        """A spec from host arrays (numpy, or anything ``np.asarray`` takes,
        e.g. the planes of another package's spec).

        ``dtype`` defaults to ``torch.get_default_dtype()`` and ``device`` to
        ``torch.get_default_device()``; ``active`` is always bool.
        """
        device = torch.get_default_device() if device is None else device
        dtype = torch.get_default_dtype() if dtype is None else dtype

        def t(a, dt):
            return torch.tensor(np.array(a), dtype=dt, device=device)

        return cls(w=t(w, dtype), w0=t(w0, dtype), g=t(g, dtype),
                   relax=t(relax, dtype), active=t(active, torch.bool),
                   offsets=tuple(tuple(int(o) for o in off) for off in offsets),
                   bcs=tuple(bcs), bih=bool(bih),
                   stop_on_zero_norm=bool(stop_on_zero_norm))


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _shift(a, off_axis_pairs):
    """a[(..., j+dj, i+di)] via wrap-around roll on the core (trailing) axes
    (``jnp.roll``'s sign convention: result[x] = a[x + off])."""
    shifts = tuple(-o for o, _ in off_axis_pairs)
    axes = tuple(ax for _, ax in off_axis_pairs)
    return torch.roll(a, shifts=shifts, dims=axes)


def shift_plane(a, off):
    """Shifted coefficient plane: result[x] = a[x + off] (wrap-around).

    The wrap only feeds points that are (a) periodic in x — where wrapping is
    exactly the reference's periodic stanza semantics — or (b) outside the
    update region, where the value is irrelevant and later zeroed.
    """
    pairs = [(o, ax - len(off)) for ax, o in enumerate(off) if o != 0]
    if not pairs:
        return a
    return _shift(a, pairs)


def _interior_mask(shape, bcs, bih):
    """Boolean mask (numpy) of points the SOR sweep updates.

    Replicates the reference loop ranges: all dims except the last update
    indices 1..n-2 (2..n-3 for biharmonic); the last dim additionally updates
    its edge columns when periodic.  The reference honours 'periodic' only
    on the last dim and 'extend' only on the second-to-last (and 1D last)
    dim; other combinations act as 'fixed'.
    """
    nd = len(shape)
    ring = 2 if bih else 1
    masks = []
    for ax, (n, bc) in enumerate(zip(shape, bcs)):
        m = np.zeros(n, dtype=bool)
        if ax == nd - 1:  # x: periodic edges are updated
            m[ring:n - ring] = True
            if bc == "periodic":
                m[:ring] = True
                m[n - ring:] = True
        else:
            r = ring if ax == nd - 2 or nd == 1 else 1
            m[r:n - r] = True
        masks.append(m)
    out = masks[0]
    for m in masks[1:]:
        out = out[..., None] & m
    return out


def _result_dtype(*tensors):
    return functools.reduce(torch.promote_types, [t.dtype for t in tensors])


def _finalize(weights, w0, g, Fdef, shape, bcs, bih, stop_on_zero_norm, dtype):
    """Assemble a StencilSpec from an offset->weight dict."""
    interior = torch.as_tensor(_interior_mask(shape, bcs, bih),
                               device=Fdef.device)
    active = interior & Fdef
    offsets = tuple(weights.keys())
    w = torch.stack([torch.where(active, weights[o], 0.0).to(dtype)
                     for o in offsets])
    w0 = torch.where(active, w0, 0.0).to(dtype)
    g = torch.where(active, g, 0.0).to(dtype)
    relax = torch.where(active, 1.0 / torch.where(active, -w0, 1.0),
                        0.0).to(dtype)
    return StencilSpec(w=w, w0=w0, g=g, relax=relax, active=active,
                       offsets=offsets, bcs=tuple(bcs), bih=bih,
                       stop_on_zero_norm=stop_on_zero_norm)


# ---------------------------------------------------------------------------
# family compilers.  They take dense coefficient tensors shaped like the
# core grid, a boolean Fdef mask (True where forcing defined), the grid
# deltas, and return a StencilSpec on the tensors' device.
# ---------------------------------------------------------------------------

def standard_2d(A, B, C, F, Fdef, deltas, bcs, include_cross=None):
    r"""d/dy(A dS/dy + B dS/dx) + d/dx(B dS/dy + C dS/dx) = F.

    Coefficients staggered as in the reference (numbas.py:216-416): A at
    half-grid in y (A[j] sits between j-1 and j), C at half-grid in x.
    ``B`` may be a tensor or a scalar; with ``include_cross=None`` the cross
    terms are kept when B has a nonzero entry.
    """
    dely, delx = deltas
    ratio = delx / dely
    rsq = ratio ** 2
    rq = ratio / 4.0
    dxsq = delx ** 2
    dtype = _result_dtype(A, C, F)

    Ajp = shift_plane(A, (1, 0))
    Cip = shift_plane(C, (0, 1))
    weights = {
        (1, 0): Ajp * rsq,
        (-1, 0): A * rsq,
        (0, 1): Cip,
        (0, -1): C,
    }
    if include_cross is None:
        include_cross = bool(torch.any(torch.as_tensor(B) != 0))
    if include_cross:
        B = torch.as_tensor(B, dtype=dtype, device=A.device)
        Bjp = shift_plane(B, (1, 0))
        Bjm = shift_plane(B, (-1, 0))
        Bip = shift_plane(B, (0, 1))
        Bim = shift_plane(B, (0, -1))
        weights[(1, 1)] = (Bjp + Bip) * rq
        weights[(1, -1)] = -(Bjp + Bim) * rq
        weights[(-1, 1)] = -(Bjm + Bip) * rq
        weights[(-1, -1)] = (Bjm + Bim) * rq
    w0 = -(Ajp + A) * rsq - (Cip + C)
    g = -F * dxsq
    return _finalize(weights, w0, g, Fdef, F.shape[-2:], bcs, False, True,
                     dtype)


def standard_2d_e(A, B, C, D, E, F, Fdef, deltas, bcs):
    r"""d/dy(A dS/dy + B dS/dx) + d/dx(C dS/dy + D dS/dx) + E S = F.

    The reference's invert_standard_2D_test (numbas.py:421-629): separate
    cross coefficients B (y-staggered) and C (x-staggered) plus a linear term
    E that also enters the denominator.
    """
    dely, delx = deltas
    ratio = delx / dely
    rsq = ratio ** 2
    rq = ratio / 4.0
    dxsq = delx ** 2
    dtype = _result_dtype(A, D, F)

    Ajp = shift_plane(A, (1, 0))
    Dip = shift_plane(D, (0, 1))
    Bjp = shift_plane(B, (1, 0))
    Bjm = shift_plane(B, (-1, 0))
    Cip = shift_plane(C, (0, 1))
    Cim = shift_plane(C, (0, -1))
    weights = {
        (1, 0): Ajp * rsq,
        (-1, 0): A * rsq,
        (0, 1): Dip,
        (0, -1): D,
        (1, 1): (Bjp + Cip) * rq,
        (1, -1): -(Bjp + Cim) * rq,
        (-1, 1): -(Bjm + Cip) * rq,
        (-1, -1): (Bjm + Cim) * rq,
    }
    w0 = -(Ajp + A) * rsq - (Dip + D) + E * dxsq
    g = -F * dxsq
    return _finalize(weights, w0, g, Fdef, F.shape[-2:], bcs, False, True,
                     dtype)


def _upwind_terms(coef, s, scale):
    """First-order upwind split of a first-derivative term with coefficient
    ``coef`` (sign-normalised by ``s``: the equation times s has
    non-negative diffusion).  Returns (w_plus, w_minus, w_center) folded
    weight contributions with w_plus + w_minus + w_center == 0, the center
    contribution strengthening the diagonal."""
    pos = torch.where(s * coef > 0, coef, 0.0)
    neg = torch.where(s * coef < 0, coef, 0.0)
    return pos * scale, -neg * scale, -s * torch.abs(coef) * scale


def _upwind_on(upwind) -> bool:
    """True when ``upwind`` requests the upwinded discretisation: a nonzero
    scalar (+-1 global convention) or a per-cell sign plane (tensors are
    always 'on' — plain truthiness would raise on them)."""
    if upwind is None:
        return False
    if isinstance(upwind, (int, float)):
        return upwind != 0
    return True


def general_2d(A, B, C, D, E, F, G, Fdef, deltas, bcs, upwind=0.0):
    r"""A Syy + B Syx + C Sxx + D Sy + E Sx + F S = G  (numbas.py:988-1201).

    ``upwind`` (0 = centered first derivatives, reference parity) selects
    first-order upwinding of the D/E advection terms with sign
    normalisation ``upwind = +-1`` or a per-cell +-1 plane.
    """
    dely, delx = deltas
    ratio = delx / dely
    rsq = ratio ** 2
    rq = ratio / 4.0
    dxsq = delx ** 2
    half = delx / 2.0
    dtype = _result_dtype(A, C, G)

    w0 = -2.0 * (A * rsq + C) + F * dxsq
    if _upwind_on(upwind):
        dyp, dym, dy0 = _upwind_terms(D, upwind, ratio * delx)
        exp, exm, ex0 = _upwind_terms(E, upwind, delx)
        weights = {
            (1, 0): A * rsq + dyp,
            (-1, 0): A * rsq + dym,
            (0, 1): C + exp,
            (0, -1): C + exm,
        }
        w0 = w0 + dy0 + ex0
    else:
        weights = {
            (1, 0): A * rsq + D * ratio * half,
            (-1, 0): A * rsq - D * ratio * half,
            (0, 1): C + E * half,
            (0, -1): C - E * half,
        }
    weights.update({
        (1, 1): B * rq,
        (1, -1): -B * rq,
        (-1, 1): -B * rq,
        (-1, -1): B * rq,
    })
    g = -G * dxsq
    return _finalize(weights, w0, g, Fdef, G.shape[-2:], bcs, False, False,
                     dtype)


def general_2d_bih(A, B, C, D, E, F, G, H, I, J, Fdef, deltas, bcs):
    r"""A Syyyy + B Syyxx + C Sxxxx + D Syy + E Syx + F Sxx + G Sy + H Sx
    + I S = J  — the 13/17-point biharmonic family (numbas.py:1205-1586).

    The reference updates with ``S -= omega * temp / denom``; negating all
    terms brings it to the universal ``denominator == -w0`` form.
    """
    dely, delx = deltas
    ratio = delx / dely
    rsq = ratio ** 2
    rq = ratio / 4.0
    rssr = ratio ** 4
    dxsq = delx ** 2
    dxtr = delx ** 3
    dxssr = delx ** 4
    dtype = _result_dtype(A, C, J)

    n = {}  # neighbor coefficients of `temp` (to be negated)

    def add(off, val):
        n[off] = n.get(off, 0.0) + val

    # A d4/dy4 and C d4/dx4
    add((2, 0), A * rssr); add((1, 0), -4.0 * A * rssr)
    add((-1, 0), -4.0 * A * rssr); add((-2, 0), A * rssr)
    add((0, 2), C); add((0, 1), -4.0 * C)
    add((0, -1), -4.0 * C); add((0, -2), C)
    # B d4/dy2dx2 (coarse +-2 cross, /16)
    b = B * rsq / 16.0
    for sy in (2, -2):
        add((sy, 2), b); add((sy, 0), -2.0 * b); add((sy, -2), b)
    add((0, 2), -2.0 * b); add((0, -2), -2.0 * b)
    # D d2/dy2, F d2/dx2
    add((1, 0), D * rsq * dxsq); add((-1, 0), D * rsq * dxsq)
    add((0, 1), F * dxsq); add((0, -1), F * dxsq)
    # E d2/dydx
    e = E * rq * dxsq
    add((1, 1), e); add((-1, 1), -e); add((1, -1), -e); add((-1, -1), e)
    # G d/dy, H d/dx
    add((1, 0), G * dxtr * ratio / 2.0); add((-1, 0), -G * dxtr * ratio / 2.0)
    add((0, 1), H * dxtr / 2.0); add((0, -1), -H * dxtr / 2.0)

    center = (6.0 * (A * rssr + C) + B * rsq / 4.0
              - 2.0 * (D * rsq + F) * dxsq + I * dxssr)
    weights = {off: -val for off, val in n.items()}
    w0 = -center
    g = J * dxssr
    return _finalize(weights, w0, g, Fdef, J.shape[-2:], bcs, True, False,
                     dtype)


def standard_3d(A, B, C, F, Fdef, deltas, bcs):
    r"""d/dz(A Sz) + d/dy(B Sy) + d/dx(C Sx) = F  (numbas.py:16-212).

    A staggered half-grid in z, B in y, C in x.  BCz is accepted but unused in
    the reference kernel body (z boundaries act fixed) — replicated here.
    """
    delz, dely, delx = deltas
    r2sq = (delx / delz) ** 2
    r1sq = (delx / dely) ** 2
    dxsq = delx ** 2
    dtype = _result_dtype(A, C, F)

    Akp = shift_plane(A, (1, 0, 0))
    Bjp = shift_plane(B, (0, 1, 0))
    Cip = shift_plane(C, (0, 0, 1))
    weights = {
        (1, 0, 0): Akp * r2sq,
        (-1, 0, 0): A * r2sq,
        (0, 1, 0): Bjp * r1sq,
        (0, -1, 0): B * r1sq,
        (0, 0, 1): Cip,
        (0, 0, -1): C,
    }
    w0 = -(Akp + A) * r2sq - (Bjp + B) * r1sq - (Cip + C)
    g = -F * dxsq
    return _finalize(weights, w0, g, Fdef, F.shape[-3:], bcs, False, False,
                     dtype)


def general_3d(A, B, C, D, E, F, G, H, Fdef, deltas, bcs, upwind=0.0):
    r"""A Szz + B Syy + C Sxx + D Sz + E Sy + F Sx + G S = H
    (numbas.py:746-984).

    ``upwind`` (0 = centered first derivatives, reference parity) selects
    first-order upwinding of the D/E/F advection terms with sign
    normalisation ``upwind = +-1`` or a per-cell +-1 plane.
    """
    delz, dely, delx = deltas
    r2 = delx / delz
    r1 = delx / dely
    r2sq = r2 ** 2
    r1sq = r1 ** 2
    dxsq = delx ** 2
    half = delx / 2.0
    dtype = _result_dtype(A, C, H)

    w0 = -2.0 * (A * r2sq + B * r1sq + C) + G * dxsq
    if _upwind_on(upwind):
        dzp, dzm, dz0 = _upwind_terms(D, upwind, r2 * delx)
        dyp, dym, dy0 = _upwind_terms(E, upwind, r1 * delx)
        dxp, dxm, dx0 = _upwind_terms(F, upwind, delx)
        weights = {
            (1, 0, 0): A * r2sq + dzp,
            (-1, 0, 0): A * r2sq + dzm,
            (0, 1, 0): B * r1sq + dyp,
            (0, -1, 0): B * r1sq + dym,
            (0, 0, 1): C + dxp,
            (0, 0, -1): C + dxm,
        }
        w0 = w0 + dz0 + dy0 + dx0
    else:
        weights = {
            (1, 0, 0): A * r2sq + D * r2 * half,
            (-1, 0, 0): A * r2sq - D * r2 * half,
            (0, 1, 0): B * r1sq + E * r1 * half,
            (0, -1, 0): B * r1sq - E * r1 * half,
            (0, 0, 1): C + F * half,
            (0, 0, -1): C - F * half,
        }
    g = -H * dxsq
    return _finalize(weights, w0, g, Fdef, H.shape[-3:], bcs, False, False,
                     dtype)


def standard_1d(A, B, F, Fdef, deltas, bcs):
    r"""d/dx(A Sx) + B S = F  (numbas.py:633-742)."""
    (delx,) = deltas
    dxsq = delx ** 2
    dtype = _result_dtype(A, F)
    Aip = shift_plane(A, (1,))
    weights = {
        (1,): Aip / dxsq,
        (-1,): A / dxsq,
    }
    w0 = -(Aip + A) / dxsq + B
    g = -F
    return _finalize(weights, w0, g, Fdef, F.shape[-1:], bcs, False, True,
                     dtype)
