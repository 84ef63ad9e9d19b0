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

Counterpart of ``xinvert_tpu/stencil.py``; this package ports the
standard-2D family (the Poisson path).  Tensors stay on the device they were
built on.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

__all__ = ["StencilSpec", "standard_2d", "prune_zero_offsets", "shift_plane"]


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
