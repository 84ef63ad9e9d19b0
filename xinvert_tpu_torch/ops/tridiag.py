# -*- coding: utf-8 -*-
"""Tridiagonal (Thomas) solvers, plain and cyclic, in PyTorch.

Counterpart of ``xinvert_tpu/ops/tridiag.py``: the reference's exported
``trace``/``traceCyclic`` (xinvert/numbas.py:1590-1685), the sequential
Thomas solve they run on, and the batched log-depth solves the zebra line
smoothers of :mod:`xinvert_tpu_torch.mg` call.  Torch has no associative
scan, so the prefix scans here run as log2(N) rounds of doubling on tensors
(Hillis-Steele): every round combines each element with the one ``d``
places before it.  The combination order differs from the JAX package's
tree, so the two agree to roundoff, not bit for bit.  Plain torch ops
throughout: the JAX package leaves these to XLA too.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["trace", "traceCyclic", "tridiag_solve",
           "tridiag_solve_pscan", "tridiag_cyclic_pscan"]


def _bshape(*shapes):
    """Broadcast shape of ``shapes`` (numpy's rule, which torch's follows;
    without the cost of ``torch.broadcast_shapes`` on every small solve)."""
    return tuple(np.broadcast_shapes(*(tuple(s) for s in shapes)))


def _tensors(*xs):
    """The arguments as tensors of their promoted dtype, on the device of
    the first tensor among them."""
    device = next((x.device for x in xs if torch.is_tensor(x)), None)
    ts = [torch.as_tensor(x, device=device) for x in xs]
    dtype = functools.reduce(torch.promote_types, [t.dtype for t in ts])
    return [t.to(dtype) for t in ts]


def tridiag_solve(a, b, c, d):
    """Solve a tridiagonal system: a sub-diagonal (N-1), b diagonal (N),
    c super-diagonal (N-1), d rhs (N); a loop over N (the tests and
    :func:`trace` use it)."""
    a, b, c, d = _tensors(a, b, c, d)
    n = b.shape[0]
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    a_full = torch.cat([zero[None], a])          # a[i] couples i, i-1
    c_full = torch.cat([c, zero[None]])
    # forward elimination: cp[i] = c[i]/(b[i]-a[i]*cp[i-1]),
    #                      dp[i] = (d[i]-a[i]*dp[i-1])/(b[i]-a[i]*cp[i-1])
    cp, dp = [], []
    cp_prev, dp_prev = zero, zero
    for i in range(n):
        denom = b[i] - a_full[i] * cp_prev
        cp_prev = c_full[i] / denom
        dp_prev = (d[i] - a_full[i] * dp_prev) / denom
        cp.append(cp_prev)
        dp.append(dp_prev)
    # back substitution: x[i] = dp[i] - cp[i]*x[i+1]
    xs = [None] * n
    x_next = zero
    for i in range(n - 1, -1, -1):
        x_next = dp[i] - cp[i] * x_next
        xs[i] = x_next
    return torch.stack(xs)


def _scan(comb, elems):
    """Inclusive prefix scan of the tuple ``elems`` along the last axis by
    doubling: log2(N) rounds, each setting e[i] = comb(e[i-d], e[i]) for
    i >= d from the previous round's values (``comb(l, r)`` applies r after
    l)."""
    n = elems[0].shape[-1]
    elems = tuple(e.clone() for e in elems)
    d = 1
    while d < n:
        new = comb(tuple(e[..., :n - d] for e in elems),
                   tuple(e[..., d:] for e in elems))
        for e, x in zip(elems, new):
            e[..., d:] = x
        d *= 2
    return elems


def _affine_rounds(A):
    """The multipliers of each doubling round of an affine scan along the
    last axis (round r holds A's partial products over 2^r elements): they
    depend on A alone, so a scan that is run on many rhs reuses them."""
    n = A.shape[-1]
    rounds = [A]
    d = 1
    while 2 * d < n:
        A = A.clone()
        A[..., d:] = A[..., :n - d] * A[..., d:]
        rounds.append(A)
        d *= 2
    return rounds


def _affine_scan(rounds, B, reverse=False):
    """Prefix (or suffix) evaluation of y_i = A_i y_prev + B_i along the
    last axis with y_prev(start) = 0, by doubling on :func:`_affine_rounds`
    of A (flipped for a suffix scan): round r sets
    B[i] = B[i-d] A_r[i] + B[i], the affine maps' composition (al ar,
    bl ar + br)."""
    B = B.flip(-1) if reverse else B.clone()
    n = B.shape[-1]
    d = 1
    for A in rounds:
        B[..., d:] = torch.addcmul(B[..., d:], B[..., :n - d], A[..., d:])
        d *= 2
    return B.flip(-1) if reverse else B


def _moebius_comb(l, r):
    l11, l12, l21, l22 = l
    r11, r12, r21, r22 = r
    p11 = r11 * l11 + r12 * l21
    p12 = r11 * l12 + r12 * l22
    p21 = r21 * l11 + r22 * l21
    p22 = r21 * l12 + r22 * l22
    # projective normalisation: scale-invariant Moebius representative
    s = torch.maximum(torch.maximum(torch.abs(p11), torch.abs(p12)),
                      torch.maximum(torch.abs(p21), torch.abs(p22)))
    s = torch.where(s > 0, s, 1.0)
    return p11 / s, p12 / s, p21 / s, p22 / s


def _pscan_factor(a, b, c):
    """The part of :func:`tridiag_solve_pscan` that depends only on the
    bands, at their batch shape: the forward elimination's
    ``cp_i = c_i / (b_i - a_i cp_{i-1})`` as a prefix scan of projectively
    normalised 2x2 Moebius maps, the denominators, and the multipliers of
    the two affine scans that follow, round by round.  A caller that
    solves the same bands many times (the line smoothers) computes it
    once."""
    a, b, c = _tensors(a, b, c)
    n = b.shape[-1]
    band_batch = _bshape(a.shape[:-1], b.shape[:-1], c.shape[:-1])
    bb = b.broadcast_to(band_batch + (n,))
    zb = torch.zeros(band_batch + (1,), dtype=b.dtype, device=b.device)
    a_full = torch.cat([zb, a.broadcast_to(band_batch + (n - 1,))], dim=-1)
    c_full = torch.cat([c.broadcast_to(band_batch + (n - 1,)), zb], dim=-1)
    # cp_i as a Moebius chain: cp_i = (0*cp + c_i) / (-a_i*cp + b_i)
    P11, P12, P21, P22 = _scan(_moebius_comb,
                               (torch.zeros_like(bb), c_full, -a_full, bb))
    cp = P12 / P22                        # applied to cp_0 = 0
    cp_prev = torch.cat([zb, cp[..., :-1]], dim=-1)
    denom = bb - a_full * cp_prev
    return (_affine_rounds(-a_full / denom), denom,
            _affine_rounds((-cp).flip(-1)))


def _pscan_substitute(factor, d):
    """The rhs part of :func:`tridiag_solve_pscan` on a
    :func:`_pscan_factor`: the dp and back-substitution recurrences as
    affine scans, broadcast over any extra rhs batch axes."""
    fwd, denom, rev = factor
    n = denom.shape[-1]
    batch = _bshape(denom.shape[:-1], d.shape[:-1])
    d = d.to(denom.dtype).broadcast_to(batch + (n,))
    dp = _affine_scan(fwd, d / denom)
    # x_i = dp_i - cp_i x_{i+1}, x_N = 0  (suffix recurrence)
    return _affine_scan(rev, dp, reverse=True)


def tridiag_solve_pscan(a, b, c, d):
    """Batched log-depth Thomas solve along the last axis.

    Same system convention as :func:`tridiag_solve` (a: N-1 subdiagonal,
    b: N diagonal, c: N-1 superdiagonal, d: N rhs), with arbitrary leading
    batch axes.  The forward elimination's rational recurrence runs as a
    prefix scan of projectively normalised 2x2 Moebius maps at the BANDS'
    batch shape (:func:`_pscan_factor`); the dp and back-substitution
    recurrences (affine once cp is known) as affine scans broadcast over
    any extra rhs batch axes (:func:`_pscan_substitute`)."""
    a, b, c, d = _tensors(a, b, c, d)
    return _pscan_substitute(_pscan_factor(a, b, c), d)


def _cyclic_units(factor, a0, cn):
    """The two corner columns of a cyclic system on :func:`_pscan_factor`'s
    band batch, stacked: ``a0`` e_1 and ``cn`` e_N (one per line)."""
    denom = factor[1]
    batch, n = denom.shape[:-1], denom.shape[-1]
    units = torch.zeros((2,) + batch + (n,), dtype=denom.dtype,
                        device=denom.device)
    units[0, ..., 0] = torch.as_tensor(a0, dtype=denom.dtype,
                                       device=denom.device)
    units[1, ..., n - 1] = torch.as_tensor(cn, dtype=denom.dtype,
                                           device=denom.device)
    return units


def _cyclic_substitute(factor, d, units):
    """:func:`tridiag_cyclic_pscan` on a :func:`_pscan_factor` of its bands
    and their :func:`_cyclic_units`: the rhs and the two unit responses
    stacked in one substitution, then the bordering."""
    denom = factor[1]
    n = denom.shape[-1]
    d = torch.as_tensor(d, dtype=denom.dtype, device=denom.device)
    rbatch = _bshape(denom.shape[:-1], d.shape[:-1])
    # bands stay at the line batch; only the affine scans see the
    # 3-way rhs stack (the Moebius elimination is computed once)
    extra = (1,) * (len(rbatch) - (units.dim() - 2))
    rhs = torch.cat([d.broadcast_to(rbatch + (n,))[None],
                     units.reshape((2,) + extra + units.shape[1:])
                     .broadcast_to((2,) + rbatch + (n,))])
    sol = _pscan_substitute(factor, rhs)
    x0, u1, u2 = sol[0], sol[1], sol[2]
    det = ((1.0 + u2[..., 0]) * (1.0 + u1[..., n - 1])
           - u1[..., 0] * u2[..., n - 1])
    x0c = ((1.0 + u1[..., n - 1]) * x0[..., 0]
           - u1[..., 0] * x0[..., n - 1]) / det
    xN1 = ((1.0 + u2[..., 0]) * x0[..., n - 1]
           - u2[..., n - 1] * x0[..., 0]) / det
    return x0 - u1 * xN1[..., None] - u2 * x0c[..., None]


def tridiag_cyclic_pscan(a, b, c, d, a0, cn):
    """Batched log-depth cyclic tridiagonal solve along the last axis
    (corner couplings ``a0``: row 0 -> col N-1, ``cn``: row N-1 -> col 0;
    leading axes batch, a0/cn shaped like the bands' batch).
    Sherman-Morrison bordering over :func:`tridiag_solve_pscan`, with the
    three rhs solved in ONE stacked call; ``d`` may carry extra leading
    batch axes (the bands stay at their batch, the unit responses broadcast
    to d's)."""
    factor = _pscan_factor(a, b, c)
    return _cyclic_substitute(factor, d, _cyclic_units(factor, a0, cn))


def trace(a, b, c, d):
    """Reference-compatible Thomas solve (numbas.py:1590-1636)."""
    a, b, c, d = _tensors(a, b, c, d)
    n = b.shape[0]
    if a.shape[0] != n - 1 or c.shape[0] != n - 1 or d.shape[0] != n:
        raise ValueError("lengths of given arrays are not satisfied")
    return tridiag_solve(a, b, c, d)


def traceCyclic(a, b, c, d, a0, cn):
    """Cyclic tridiagonal solve with corner couplings a0 (row 0 -> col N-1)
    and cn (row N-1 -> col 0), via bordering (numbas.py:1640-1685)."""
    a, b, c, d = _tensors(a, b, c, d)
    n = b.shape[0]
    e1 = torch.zeros((n,), dtype=b.dtype, device=b.device)
    e1[0] = 1.0
    en = torch.zeros((n,), dtype=b.dtype, device=b.device)
    en[n - 1] = 1.0
    # columns of the correction: A x = d with A = T + a0*e1 en^T + cn*en e1^T
    u1 = tridiag_solve(a, b, c, e1 * a0)   # T^-1 (a0 e1)
    u2 = tridiag_solve(a, b, c, en * cn)   # T^-1 (cn en)
    x0 = tridiag_solve(a, b, c, d)
    # Bordering: x = x0 - u1 * x_{n-1} - u2 * x_0; evaluating it at rows 0
    # and n-1 gives the 2x2 system
    #   (1 + u2[0]) x_0   + u1[0] x_{n-1}         = x0[0]
    #   u2[n-1] x_0       + (1 + u1[n-1]) x_{n-1} = x0[n-1]
    det = (1.0 + u2[0]) * (1.0 + u1[n - 1]) - u1[0] * u2[n - 1]
    x0c = ((1.0 + u1[n - 1]) * x0[0] - u1[0] * x0[n - 1]) / det
    xN1 = ((1.0 + u2[0]) * x0[n - 1] - u2[n - 1] * x0[0]) / det
    return x0 - u1 * xN1 - u2 * x0c
