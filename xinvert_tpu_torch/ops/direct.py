# -*- coding: utf-8 -*-
"""Direct spectral solve for x-invariant 2-D stencil problems, in PyTorch.

Counterpart of ``xinvert_tpu/ops/direct.py``.  For a 2-D, non-biharmonic
:class:`~xinvert_tpu_torch.stencil.StencilSpec` whose weight planes do not
vary along x, with periodic x and an unmasked interior, the real FFT along
x block-diagonalises the folded system

    sum_k w_k S[. + off_k] + w0 S = -g

into one complex tridiagonal system in y per zonal wavenumber, solved
exactly in one pass by the log-depth Thomas solve of
:mod:`xinvert_tpu_torch.ops.tridiag`, over every mode at once.  This covers
the reference's canonical global problems (Poisson/Helmholtz
streamfunction, Gill-Matsuno, geostrophic balance) in one shot instead of
hundreds to thousands of SOR sweeps.

NON-periodic x (fixed or extend) is covered when the x-coupling is
left-right symmetric per row and there are no cross or advective x terms
(the whole standard-2D family): the x-operator is then ``c(y)·T0`` with
``T0`` the unit Dirichlet tridiagonal, so one host-side eigendecomposition
of ``T0`` turns the system into ``nxi`` real tridiagonal solves in y, and
the transform pair is a matrix product.  The reference's 'extend' is a ROW
pre-pass only (numbas.py:284-310): a non-periodic trailing dim keeps its
initial boundary columns whatever its label, so it is Dirichlet, and this
branch is never singular.  1-D specs are one tridiagonal system.

Boundary conditions (y):
- ``fixed``: boundary rows are Dirichlet data taken from ``S0`` (zeros or
  the user's icbc), moved to the right-hand side;
- ``extend``: the fixed point of the reference's extend pre-pass satisfies
  S[0,:] == S[1,:] (numbas.py:284-310), so the boundary-pointing weight of
  the adjacent row folds onto its diagonal and the boundary rows are
  rebuilt by a row copy afterwards.

The pure-Neumann gauge: with ``extend`` at both ends the m=0 (zonal-mean)
block of a conservative operator is singular up to an additive constant,
the same nullspace SOR inherits.  The solve anchors that block (the first
interior row's zonal mean pinned to 0) and then shifts the whole solution
so its mean over the interior rows matches ``S0``'s.  Solutions of singular
problems are unique only up to this gauge.

Masked domains with few holes take the capacitance-matrix path
(:func:`solve_direct_masked`).

Where it runs: on the device of ``S0`` (and the spec), in plain torch ops,
as the JAX package leaves these to XLA (``rfft``, the log-depth scans, a
matrix product).  The host does what the JAX package does there: the
applicability and gauge checks (the full planes compared on the device,
the per-row weights brought over), the ``eigh`` of ``T0``, and the dense
capacitance solve.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .tridiag import tridiag_solve_pscan

__all__ = ["direct_applicable", "solve_direct",
           "masked_direct_applicable", "solve_direct_masked", "MAX_HOLES"]


def _offset_groups(offsets):
    """Split offsets by dy in {-1, 0, +1}; None if any |dy| > 1."""
    groups = {-1: [], 0: [], 1: []}
    for k, (dy, dx) in enumerate(offsets):
        if abs(dy) > 1 or abs(dx) > 1:
            return None
        groups[dy].append((k, dx))
    return groups


def _host(t):
    """A tensor as a numpy array of its own dtype."""
    return t.detach().cpu().numpy()


def _all(cond):
    """One boolean of a device-side test, brought to the host."""
    return bool(torch.all(cond))


def _interior(shape, device, x_edges):
    """The mask of interior rows (and, with ``x_edges``, columns)."""
    m = torch.zeros(shape, dtype=torch.bool, device=device)
    if x_edges:
        m[1:-1, 1:-1] = True
    else:
        m[1:-1, :] = True
    return m


def _sym_x_bands(spec, S_shape):
    """Per-row bands for the non-periodic symmetric-x branch, or None.

    Qualifies a 2-D spec with fixed/extend BCs on BOTH dims whose trailing
    (x) coupling is x-invariant and left-right symmetric per row and whose
    cross/advective terms vanish (offsets only (±1,0)/(0,±1)).  The folded
    x-operator is then c(y)·T0 with T0 a fixed symmetric tridiagonal.  The
    bands sum in float64 on the host, as the JAX package's do.
    """
    ny, nx = S_shape[-2:]
    if ny < 3 or nx < 4:
        return None
    w, w0, active = spec.w, spec.w0, spec.active
    if w.dim() != 3 or w0.dim() != 2 or active.dim() != 2:
        return None                       # batched weights: not supported
    if tuple(active.shape) != (ny, nx):
        return None
    if not torch.equal(active, _interior((ny, nx), active.device, True)):
        return None                       # boundary rows AND columns fixed
    rows, cols = slice(1, ny - 1), slice(1, nx - 1)
    # bitwise x-invariance over the interior (builders apply identical
    # per-row ops to x-invariant coefficient planes)
    if not _all(w[:, rows, cols] == w[:, rows, 1:2]):
        return None
    if not _all(w0[rows, cols] == w0[rows, 1:2]):
        return None
    nyi = ny - 2
    sub = np.zeros(nyi)
    sup = np.zeros(nyi)
    ce = np.zeros(nyi)
    cw = np.zeros(nyi)
    w_rows = _host(w[:, rows, 1])
    for k, (dy, dx) in enumerate(spec.offsets):
        if abs(dy) > 1 or abs(dx) > 1:
            return None
        if dy != 0 and dx != 0:
            # diagonal terms do not separate, but the standard-2D(+E)
            # compilers emit the cross offsets even when B == 0 (zero
            # weight planes); those are inert and qualify
            if _all(w[k] == 0):
                continue
            return None
        wk = w_rows[k]
        if dy == -1:
            sub = sub + wk
        elif dy == 1:
            sup = sup + wk
        elif dx == 1:
            ce = ce + wk
        elif dx == -1:
            cw = cw + wk
        else:
            return None
    # left-right symmetry (staggered builders give this bitwise whenever the
    # plane is x-invariant: east = shift(C)[i] = C[i+1] = C[i] = west)
    if not (ce == cw).all():
        return None
    return {"sub": sub, "sup": sup, "c": ce, "w0": _host(w0[rows, 1])}


def direct_applicable(spec, S_shape) -> bool:
    """True when :func:`solve_direct` handles this problem exactly.

    Requirements (checked on the spec's tensors): 2-D non-biharmonic spec,
    neighbor reach |dy| <= 1 and |dx| <= 1, fixed/extend y, unbatched
    x-invariant weights, and a fully active interior (no land/sea mask
    holes); x either periodic (any offsets, complex Fourier symbols) or
    fixed/extend with left-right symmetric coupling and no cross terms
    (real eigenbasis of the folded tridiagonal x-operator; the standard-2D
    family qualifies).  1-D specs (the GeoAdjustment / RefStateSWM family)
    are pure tridiagonal systems and qualify with fixed or extend BCs and a
    fully active interior, no x-invariance needed.
    """
    if spec.ndim == 1:
        if spec.bcs[0] not in ("fixed", "extend"):
            return False
        if any(abs(o[0]) > 1 for o in spec.offsets):
            return False
        if spec.w.dim() != 2 or spec.active.dim() != 1:
            return False
        n = S_shape[-1]
        if n < 3 or tuple(spec.active.shape) != (n,):
            return False
        interior = torch.zeros(n, dtype=torch.bool, device=spec.active.device)
        interior[1:-1] = True
        return torch.equal(spec.active, interior)
    if spec.ndim != 2 or spec.bih:
        return False
    if spec.bcs[-2] not in ("fixed", "extend"):
        return False
    if spec.bcs[-1] in ("fixed", "extend"):
        # non-periodic x: symmetric-coupling eigenbasis branch
        return _sym_x_bands(spec, S_shape) is not None
    if spec.bcs[-1] != "periodic":
        return False
    if _offset_groups(spec.offsets) is None:
        return False
    w, w0, active = spec.w, spec.w0, spec.active
    if w.dim() != 3 or w0.dim() != 2 or active.dim() != 2:
        return False                      # batched weights: not supported
    ny, nx = S_shape[-2:]
    if ny < 3 or tuple(active.shape) != (ny, nx):
        return False
    # fully active interior (the mask path needs iteration), inactive edges
    if not torch.equal(active, _interior((ny, nx), active.device, False)):
        return False
    # exact x-invariance: builders apply identical per-row ops to x-invariant
    # coefficient planes, so equality is bitwise when it holds at all
    rows = slice(1, ny - 1)
    if not _all(w[:, rows] == w[:, rows, :1]):
        return False
    return _all(w0[rows] == w0[rows, :1])


def _gauge_tol(w0):
    """The size below which the host-side gauge tests count a row or
    column sum of the folded weights as zero: 1e-10 of max|w0|, as in the
    JAX package, unless the weights' own rounding is larger, then 32 ulps
    of max|w0|.  In float64 that is the JAX package's threshold exactly.
    In float32 the weights' row sums round to 3e-8-9e-8 of max|w0|, so the
    JAX package's test never fires there: the singular zonal-mean block
    stays unanchored and unprojected, and on the H100 bench.py's 2048x2048
    Poisson came back non-finite.  This is a deliberate difference from
    the JAX package (ROADMAP §C)."""
    return max(1e-10, 32 * float(np.finfo(w0.dtype).eps)) * np.max(np.abs(w0))


def _complex(dtype):
    return torch.complex64 if dtype == torch.float32 else torch.complex128


def _thomas_modes(sub, dia, sup, rhs):
    """Thomas elimination vectorised over the trailing mode axis.

    sub/dia/sup: (n, M), sub[0] and sup[-1] ignored; rhs: (..., n, M).
    Returns x with rhs's shape.  Through the log-depth batched Thomas solve
    (ops/tridiag.tridiag_solve_pscan, complex dtypes included), the bands
    at (M, n): their elimination is computed once, and only the affine
    scans broadcast over any leading rhs batch (the capacitance path's
    unit responses).
    """
    subT, diaT, supT = sub.mT, dia.mT, sup.mT      # (M, n)
    x = tridiag_solve_pscan(subT[..., 1:], diaT, supT[..., :-1], rhs.mT)
    return x.mT


def _rows(t, bshape):
    """``t`` broadcast to the batch shape ``bshape`` (its last two axes
    kept), as a fresh tensor."""
    return t.expand(bshape + tuple(t.shape[-2:])).clone()


def _solve_direct_periodic(w_rows, w0_rows, g, S0, offsets, extend, gauge,
                           project):
    """The periodic-x branch.  w_rows: (K, nyi) per-row weights; w0_rows:
    (nyi,); g, S0: (..., ny, nx)."""
    ny, nx = S0.shape[-2:]
    nyi = ny - 2
    rdtype = S0.dtype
    cdtype = _complex(rdtype)
    dev = S0.device
    M = nx // 2 + 1
    theta = torch.arange(M, device=dev).to(rdtype) * (2.0 * np.pi / nx)

    groups = _offset_groups(offsets)
    bands = {}
    for dy in (-1, 0, 1):
        band = torch.zeros((nyi, M), dtype=cdtype, device=dev)
        for k, dx in groups[dy]:
            phase = torch.exp(1j * dx * theta).to(cdtype)
            band = band + w_rows[k].to(cdtype)[:, None] * phase[None, :]
        bands[dy] = band
    sub, sup = bands[-1], bands[1]
    dia = bands[0] + w0_rows.to(cdtype)[:, None]

    rhs = -torch.fft.rfft(g[..., 1:-1, :], dim=-1).to(cdtype)
    bshape = torch.broadcast_shapes(rhs.shape[:-2], S0.shape[:-2])
    rhs = _rows(rhs, bshape)
    if extend:
        # fixed point of the extend pre-pass: S[0] == S[1], S[-1] == S[-2]
        dia[0] += sub[0]
        dia[-1] += sup[-1]
        sub[0] = 0.0
        sup[-1] = 0.0
        if gauge:
            if project:
                # least-squares consistency: remove the component of the
                # zonal-mean rhs along the left nullvector (the constant,
                # for the symmetric conservative families).  An
                # inconsistent forcing (nonzero area integral) has no
                # steady solution (SOR drifts secularly there); this
                # returns the least-squares solution instead.
                b0 = rhs[..., :, 0]
                rhs[..., :, 0] = b0 - torch.mean(b0, dim=-1, keepdim=True)
            # anchor the singular zonal-mean block: pins the first interior
            # row's m=0 coefficient to 0; the constant is restored by the
            # mean-gauge shift below
            dia[0, 0] = torch.max(torch.abs(w0_rows)).to(cdtype)
            sub[0, 0] = 0.0
            sup[0, 0] = 0.0
            rhs[..., 0, 0] = 0.0
    else:
        X0 = torch.fft.rfft(S0[..., 0, :], dim=-1).to(cdtype)
        X1 = torch.fft.rfft(S0[..., -1, :], dim=-1).to(cdtype)
        rhs[..., 0, :] += -sub[0] * X0
        rhs[..., -1, :] += -sup[-1] * X1

    X = _thomas_modes(sub, dia, sup, rhs)
    Sin = torch.fft.irfft(X, n=nx, dim=-1).to(rdtype)

    if extend:
        S = torch.cat([Sin[..., :1, :], Sin, Sin[..., -1:, :]], dim=-2)
        if gauge:
            S = S + (torch.mean(S0[..., 1:-1, :], dim=(-2, -1), keepdim=True)
                     - torch.mean(Sin, dim=(-2, -1), keepdim=True))
    else:
        top = S0[..., :1, :].expand(bshape + (1, nx))
        bot = S0[..., -1:, :].expand(bshape + (1, nx))
        S = torch.cat([top, Sin, bot], dim=-2)
    return S


def _solve_direct_sym(spec, S0):
    """The symmetric non-periodic-x branch: one host ``eigh`` of the unit
    Dirichlet tridiagonal ``T0`` in float64, the transform pair a matrix
    product on the device, ``nxi`` real tridiagonal solves in y."""
    b = _sym_x_bands(spec, tuple(S0.shape))
    ny, nx = S0.shape[-2:]
    nyi, nxi = ny - 2, nx - 2
    # The trailing dim is Dirichlet regardless of its BC label: the
    # reference's extend pre-pass touches rows only (numbas.py:284-310), so
    # non-periodic boundary COLUMNS keep their initial values, as
    # solver._apply_extend does.  The system is never singular here.
    T0 = np.zeros((nxi, nxi))
    idx = np.arange(nxi - 1)
    T0[idx, idx + 1] = 1.0
    T0[idx + 1, idx] = 1.0
    lam, Q = np.linalg.eigh(T0)
    extend_y = spec.bcs[-2] == "extend"
    rdtype, dev = S0.dtype, S0.device

    def t(a):
        return torch.tensor(a, dtype=rdtype, device=dev)
    sub_rows, sup_rows, c_rows, w0_rows = (t(b[k]) for k in
                                           ("sub", "sup", "c", "w0"))
    Q, lam = t(Q), t(lam)

    rhs = -spec.g[..., 1:-1, 1:-1].to(rdtype)
    bshape = torch.broadcast_shapes(rhs.shape[:-2], S0.shape[:-2])
    rhs = _rows(rhs, bshape)
    # Dirichlet columns (S0 data) move to the right-hand side; the coupling
    # weight into the first interior column is c(y)
    rhs[..., :, 0] += -c_rows * S0[..., 1:-1, 0]
    rhs[..., :, -1] += -c_rows * S0[..., 1:-1, -1]
    rhsm = rhs @ Q                                 # x -> eigenmode space

    sub = sub_rows[:, None].expand(nyi, nxi).clone()
    sup = sup_rows[:, None].expand(nyi, nxi).clone()
    dia = w0_rows[:, None] + c_rows[:, None] * lam[None, :]
    if extend_y:
        # fixed point of the extend pre-pass: S[0, 1:-1] == S[1, 1:-1]
        dia[0] += sub[0]
        dia[-1] += sup[-1]
        sub[0] = 0.0
        sup[-1] = 0.0
    else:
        X0 = S0[..., 0, 1:-1] @ Q                  # Dirichlet rows (icbc)
        X1 = S0[..., -1, 1:-1] @ Q
        rhsm[..., 0, :] += -sub[0] * X0
        rhsm[..., -1, :] += -sup[-1] * X1

    X = _thomas_modes(sub, dia, sup, rhsm)
    Sin = (X @ Q.T).to(rdtype)                     # eigenmode space -> x

    left = S0[..., 1:-1, :1].expand(bshape + (nyi, 1))
    right = S0[..., 1:-1, -1:].expand(bshape + (nyi, 1))
    Sin = torch.cat([left, Sin, right], dim=-1)
    if extend_y:
        # the pre-pass row copy with its corner copies
        # (solver._apply_extend, non-periodic stanza)
        def edge_row(row):
            return torch.cat([row[..., 1:2], row[..., 1:-1],
                              row[..., -2:-1]], dim=-1)
        top = edge_row(Sin[..., :1, :])
        bot = edge_row(Sin[..., -1:, :])
    else:
        top = S0[..., :1, :].expand(bshape + (1, nx))
        bot = S0[..., -1:, :].expand(bshape + (1, nx))
    return torch.cat([top, Sin, bot], dim=-2)


def _solve_direct_1d(spec, S0):
    """The 1-D branch: one tridiagonal system, with the extend fold and the
    pure-Neumann gauge as in 2-D."""
    n = S0.shape[-1]
    w = _host(spec.w[:, 1:n - 1])
    w0 = _host(spec.w0[1:n - 1])
    by = {off[0]: k for k, off in enumerate(spec.offsets)}
    sub = w[by[-1]] if -1 in by else np.zeros_like(w0)
    sup = w[by[1]] if 1 in by else np.zeros_like(w0)
    extend = spec.bcs[0] == "extend"
    gauge = project = False
    if extend:
        tol = _gauge_tol(w0)
        gauge = bool(np.max(np.abs(sub + sup + w0)) <= tol)
        if gauge:
            dia0 = w0.copy()
            dia0[0] += sub[0]
            dia0[-1] += sup[-1]
            colsum = dia0.copy()
            colsum[:-1] += sub[1:]
            colsum[1:] += sup[:-1]
            project = bool(np.max(np.abs(colsum)) <= tol)
    rdtype, dev = S0.dtype, S0.device
    sub, dia, sup = (torch.tensor(a, dtype=rdtype, device=dev)
                     for a in (sub, w0, sup))
    rhs = -spec.g[..., 1:-1].to(rdtype)
    bshape = torch.broadcast_shapes(rhs.shape[:-1], S0.shape[:-1])
    rhs = rhs.expand(bshape + (n - 2,)).clone()
    if extend:
        dia[0] += sub[0]
        dia[-1] += sup[-1]
        sub[0] = 0.0
        sup[-1] = 0.0
        if gauge:
            if project:
                rhs = rhs - torch.mean(rhs, dim=-1, keepdim=True)
            dia[0] = torch.max(torch.abs(dia))
            sup[0] = 0.0
            rhs[..., 0] = 0.0
    else:
        rhs[..., 0] += -sub[0] * S0[..., 0]
        rhs[..., -1] += -sup[-1] * S0[..., -1]
    x = _thomas_modes(sub[:, None], dia[:, None], sup[:, None],
                      rhs[..., None])[..., 0]
    if extend:
        S = torch.cat([x[..., :1], x, x[..., -1:]], dim=-1)
        if gauge:
            S = S + (torch.mean(S0[..., 1:-1], dim=-1, keepdim=True)
                     - torch.mean(x, dim=-1, keepdim=True))
    else:
        top = S0[..., :1].expand(bshape + (1,))
        bot = S0[..., -1:].expand(bshape + (1,))
        S = torch.cat([top, x, bot], dim=-1)
    return S.to(rdtype)


# ---------------------------------------------------------------------------
# masked domains: capacitance-matrix (Schur-on-the-holes) correction
# ---------------------------------------------------------------------------

# dense-capacitance budget: p holes cost p batched spectral solves (chunked)
# plus one (p[+1])^2 dense factorisation: island/topography-scale masks;
# continent-scale masks (the 180x360 ocean fixture has ~19k holes) go to
# multigrid or SOR instead
MAX_HOLES = 2048
_UNIT_CHUNK = 256      # unit-response solves per batched call (memory cap)

#: Host seconds of the last :func:`solve_direct_masked` call: ``unit`` from
#: its start to the capacitance matrix on the host (the unmasked solve and
#: the chunked unit responses, which that transfer waits for), ``dense``
#: the dense solve.  The re-solve and the pin that follow are queued
#: without a sync.
LAST_MASKED_SECONDS = {}


def masked_direct_applicable(spec_full, holes, max_holes: int = MAX_HOLES,
                             S_shape=None) -> bool:
    """True when :func:`solve_direct_masked` handles this problem exactly:
    the UNMASKED operator qualifies for :func:`solve_direct` (2-D branch)
    and the interior hole count fits the dense-capacitance budget."""
    holes = np.asarray(holes)
    if S_shape is None:
        S_shape = holes.shape
    if spec_full.ndim != 2:
        return False
    if not direct_applicable(spec_full, S_shape):
        return False
    if holes[0, :].any() or holes[-1, :].any():
        return False                      # boundary rows are not "holes"
    p = int(holes.sum())
    return 0 < p <= max_holes


def solve_direct_masked(spec_full, holes, S0):
    """Exact one-shot solve on a masked (irregular) 2-D domain.

    Masking breaks the x-invariance the spectral solve needs; the
    capacitance-matrix method restores the direct path.  The masked system
    equals the UNMASKED x-invariant operator ``L`` (``spec_full``, built
    with a fully active interior: active-cell weights are identical, only
    the hole rows differ) with the ``p`` hole cells pinned at their ``S0``
    values.  Writing ``y = y0 + R mu`` with ``y0 = L^{-1} b`` and ``R`` the
    unit responses at the holes, the pin conditions give a dense p x p
    capacitance system ``C mu = S0_holes - y0_holes`` with
    ``C[j, k] = (L^{-1} e_k)[hole_j]``: ``p`` batched spectral solves
    (chunked) plus one dense solve, in float64 on the host.

    Singular (extend + conservative, pure-Neumann gauge) operators get the
    bordered system: an explicit constant column and the consistency row
    ``sum(mu) = sum(g)`` close the gauge, which the masked problem itself
    fixes through its Dirichlet holes.

    ``S0`` (and ``spec_full.g``) may carry leading batch dims: the hole
    pattern, and so the capacitance matrix, is shared across the batch.
    Returns S shaped like ``S0`` with hole cells at exactly ``S0``.
    """
    t0 = time.perf_counter()
    holes_np = np.asarray(holes)
    if not masked_direct_applicable(spec_full, holes_np,
                                    S_shape=tuple(S0.shape)):
        raise ValueError(
            "solve_direct_masked needs an unmasked spec qualifying for "
            "solve_direct and an interior hole count within MAX_HOLES; "
            "use multigrid or SOR for this problem")
    batch = tuple(S0.shape[:-2])
    ny, nx = holes_np.shape
    yj, xj = np.nonzero(holes_np)
    p = len(yj)
    dev, dt, gdt = S0.device, S0.dtype, spec_full.g.dtype
    yj_t = torch.as_tensor(yj, device=dev)
    xj_t = torch.as_tensor(xj, device=dev)

    # gauge bookkeeping mirrors solve_direct's host-side detection
    singular = False
    if spec_full.bcs[-2] == "extend" and spec_full.bcs[-1] == "periodic":
        w = _host(spec_full.w[:, 1:ny - 1, 0])
        w0 = _host(spec_full.w0[1:ny - 1, 0])
        tol = _gauge_tol(w0)
        singular = bool(np.max(np.abs(w.sum(axis=0) + w0)) <= tol)

    y0 = solve_direct(spec_full, S0)

    # unit responses, chunked batched solves: A r = e_k  <=>  g = -e_k
    cols = []
    zero_S = torch.zeros((ny, nx), dtype=dt, device=dev)
    for c0 in range(0, p, _UNIT_CHUNK):
        sel = slice(c0, min(c0 + _UNIT_CHUNK, p))
        nb = sel.stop - sel.start
        E = torch.zeros((nb, ny, nx), dtype=gdt, device=dev)
        E[torch.arange(nb, device=dev), yj_t[sel], xj_t[sel]] = -1.0
        spec_u = dataclasses.replace(spec_full, g=E)
        R = solve_direct(spec_u, zero_S.expand(nb, ny, nx))
        cols.append(R[:, yj_t, xj_t])             # (nb, p) responses
    C = _host(torch.cat(cols, dim=0).T).astype(np.float64)  # C[j, k]

    # multi-RHS solve over the batch: d has shape (p, *batch)
    d = np.moveaxis(_host(S0[..., yj_t, xj_t] - y0[..., yj_t, xj_t]),
                    -1, 0).reshape(p, -1).astype(np.float64)
    nb_rhs = d.shape[1]
    t1 = time.perf_counter()
    if singular:
        # bordered system: explicit constant DOF + the consistency row
        # sum(b + mu) = 0 with b = -g over the interior rows
        gsum = _host(spec_full.g.expand(batch + (ny, nx))[..., 1:-1, :]
                     .sum(dim=(-2, -1))).reshape(1, nb_rhs)
        M = np.zeros((p + 1, p + 1))
        M[:p, :p] = C
        M[:p, p] = 1.0
        M[p, :p] = 1.0
        sol = np.linalg.solve(M, np.concatenate([d, gsum], axis=0))
        mu, const = sol[:p], sol[p]
    else:
        mu = np.linalg.solve(C, d)
        const = np.zeros(nb_rhs)
    t2 = time.perf_counter()
    LAST_MASKED_SECONDS.clear()
    LAST_MASKED_SECONDS.update(unit=t1 - t0, dense=t2 - t1)

    # assemble: rather than a batched pass accumulating R mu, re-solve once
    # with the holes' sources folded into g
    gmu = torch.zeros(batch + (ny, nx), dtype=gdt, device=dev)
    gmu[..., yj_t, xj_t] = -torch.as_tensor(
        np.moveaxis(mu.reshape((p,) + batch), 0, -1), dtype=gdt, device=dev)
    spec_c = dataclasses.replace(spec_full, g=spec_full.g + gmu)
    S = solve_direct(spec_c, S0) + torch.as_tensor(
        const.reshape(batch + (1, 1)), dtype=dt, device=dev)
    # pin the holes exactly (they satisfy the pin up to rounding already)
    return torch.where(torch.as_tensor(holes_np, device=dev), S0, S)


def solve_direct(spec, S0):
    """Solve the spec's folded system exactly (see the module docstring).

    ``S0`` supplies Dirichlet boundary rows (fixed BC; zeros or icbc), the
    gauge mean for singular extend-extend problems, and any leading batch
    shape.  Check :func:`direct_applicable` first: inapplicable specs
    raise.  Returns S shaped like ``S0`` (broadcast with ``spec.g``), on
    ``S0``'s device, which must be the spec's.
    """
    if spec.g.device != S0.device:
        raise ValueError(f"the spec is on {spec.g.device} but the state is "
                         f"on {S0.device}")
    if not direct_applicable(spec, tuple(S0.shape)):
        raise ValueError(
            "solve_direct needs a 2-D non-biharmonic spec with x-invariant "
            "unbatched weights, a fully active interior (no mask holes), "
            "fixed/extend y, and either periodic x (|dy|,|dx| <= 1 offsets) "
            "or fixed/extend x with symmetric coupling and no cross terms; "
            "or a 1-D spec with fixed/extend BCs; this problem does not "
            "qualify — use the iterative solver")
    if spec.ndim == 1:
        return _solve_direct_1d(spec, S0)
    if spec.bcs[-1] != "periodic":
        return _solve_direct_sym(spec, S0)
    ny = S0.shape[-2]
    w_rows = spec.w[:, 1:ny - 1, 0]
    w0_rows = spec.w0[1:ny - 1, 0]
    g = spec.g.to(S0.dtype)
    extend = spec.bcs[-2] == "extend"
    gauge = project = False
    if extend:
        # conservative row sums (w0 + sum_k w_k == 0) make the zonal-mean
        # block singular after the extend fold: its nullspace is the
        # constant vector, exactly SOR's pure-Neumann gauge freedom
        w = _host(w_rows)
        w0 = _host(w0_rows)
        tol = _gauge_tol(w0)
        rowsum = w.sum(axis=0) + w0
        gauge = bool(np.max(np.abs(rowsum)) <= tol)
        if gauge:
            # symmetric-conservative (column sums of the folded m=0 block
            # also vanish): the left nullvector is the constant, so the
            # least-squares projection is a plain mean removal
            groups = _offset_groups(spec.offsets)
            sub0 = sum(w[k] for k, dx in groups[-1]) if groups[-1] else 0 * w0
            sup0 = sum(w[k] for k, dx in groups[1]) if groups[1] else 0 * w0
            dia0 = w0 + (sum(w[k] for k, dx in groups[0]) if groups[0]
                         else 0 * w0)
            dia0 = dia0.copy()
            dia0[0] += sub0[0]
            dia0[-1] += sup0[-1]
            colsum = dia0.copy()
            colsum[:-1] += sub0[1:]
            colsum[1:] += sup0[:-1]
            project = bool(np.max(np.abs(colsum)) <= tol)
    return _solve_direct_periodic(w_rows, w0_rows, g, S0, spec.offsets,
                                  extend, gauge, project)
