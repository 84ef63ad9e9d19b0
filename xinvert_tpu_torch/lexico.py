# -*- coding: utf-8 -*-
"""Lexicographic Gauss-Seidel executor: the reference's exact iterate
sequence, in PyTorch.

Counterpart of ``xinvert_tpu/lexico.py``.  The red-black engine
(:mod:`xinvert_tpu_torch.solver`) reaches the same fixed point as the
reference but along a different transient.  This executor reproduces the
reference's lexicographic in-place sweep (numbas.py:216-416): the same
values after every sweep, to roundoff.  Within a row the update is a
first-order linear recurrence,

    S_new[i] = S_old[i] + r_i (g_i + sum_offrow w S_ctx
                               + w_xp[i] S_old[i+1] + w0_i S_old[i])
               + r_i w_xm[i] S_new[i-1]
             = A_i S_new[i-1] + B_i ,

evaluated in log2(nx) doubling rounds (torch has no associative scan; the
rounds of A depend on the spec alone and are computed once per solve, as in
``ops/tridiag._affine_rounds``).  The terms that read rows not yet updated
in this sweep (the rows below, and the row's own old values) are summed for
the whole grid at the start of the sweep; only the rows above are read row
by row.  Periodic x keeps the reference's stanza order: the west column
first (reading the old east value), the interior recurrence, the east
column last (reading the new west and interior values).

The 2-D radius-1 executor walks the rows top to bottom.  The 3-D one walks
hyperplanes ``a (k-1) + (j-1) = const`` of (level, row) pairs: every row of
a hyperplane reads only rows of earlier hyperplanes as new and rows of
later ones as old, exactly as in the serial k-outer, j-inner order, so it
updates them together (gathered, then scattered back) with the same
arithmetic per row.  The 1-D and biharmonic executors follow the JAX
package's.  All of them are batched by broadcasting: leading batch dims on
the state and on the spec's planes.  No host sync happens inside a sweep.

The JAX package runs these as XLA ops, so there is no TPU kernel to port:
plain torch ops on either device.  Results agree with the JAX package to
roundoff (the doubling order differs from its associative scan), not bit
for bit.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .ops.tridiag import _affine_rounds, _affine_scan
from .solver import _apply_extend

__all__ = ["solve_fixed_lexicographic", "solve_fixed_lexicographic_1d",
           "solve_fixed_lexicographic_3d", "solve_fixed_lexicographic_bih",
           "lexico_sweeper"]


def _scan_linear(A, B):
    """y_i = A_i y_{i-1} + B_i along the last axis with y_{-1} = 0."""
    A, B = torch.broadcast_tensors(A, B)
    return _affine_scan(_affine_rounds(A), B)


def _scan_into(rounds, bufs, pad, out):
    """Evaluate y_i = A_i y_{i-1} + B_i (i = 0..n-1, y_{-1} = 0) by
    doubling, B being ``bufs[0][..., pad:]`` and ``rounds`` the multipliers
    of A round by round (:func:`~xinvert_tpu_torch.ops.tridiag._affine_rounds`);
    writes y into ``out`` (..., n).  The buffers hold zeros in their first
    ``pad`` >= n/2 columns, so each round is one ``addcmul`` that reads the
    element ``d`` places back; the last round writes ``out``."""
    cur, nxt = bufs
    n = out.shape[-1]
    if not rounds:
        out.copy_(cur[..., pad:])
        return
    d = 1
    last = len(rounds) - 1
    for r, A in enumerate(rounds):
        dst = out if r == last else nxt[..., pad:]
        torch.addcmul(cur[..., pad:], cur[..., pad - d:pad - d + n], A,
                      out=dst)
        cur, nxt = nxt, cur
        d *= 2


def _buffers(shape, n, dtype, device):
    """Two zero-padded ping-pong buffers for :func:`_scan_into` over n
    elements, and their pad."""
    pad = max(1, 1 << max(0, (n - 1).bit_length() - 1))
    return ([torch.zeros(shape + (pad + n,), dtype=dtype, device=device)
             for _ in range(2)], pad)


def _row_update(row, t, rw, rounds, east, periodic, bufs, pad):
    """One reference-ordered row update, in place: ``row`` (..., nx) holds
    the old values on entry and the new ones on exit.

    ``t`` is the row's context: g, the terms of the other rows (old below,
    new above), w_xp S_old[i+1] and w0 S_old[i] (for periodic x, w_xm
    S_old[nx-1] at column 0 and no w_xp term at column nx-1); ``rw`` is
    omega * relax on the row; ``rounds`` the doubling multipliers of
    A' = (0, r_i w_xm,i for i = 1..nx-2) over columns 0..nx-2; ``east``
    (periodic x) the weights (w_xp, w_xm) at column nx-1, or None."""
    n = row.shape[-1] - 1
    B = bufs[0][..., pad:]
    if periodic:
        # the west column is the recurrence's first element, with A' = 0
        torch.addcmul(row[..., :n], rw[..., :n], t[..., :n], out=B)
    else:
        torch.addcmul(row[..., 1:n], rw[..., 1:n], t[..., 1:n],
                      out=B[..., 1:])
        B[..., 0] = row[..., 0]
    _scan_into(rounds, bufs, pad, row[..., :n])
    if periodic:
        acc = t[..., n]
        if east[0] is not None:
            acc = torch.addcmul(acc, east[0], row[..., 0])
        if east[1] is not None:
            acc = torch.addcmul(acc, east[1], row[..., n - 1])
        row[..., n].addcmul_(rw[..., n], acc)


def _full_batch(spec, S_shape):
    """The batch shape of a sweep: the state's and the spec planes' batch
    dims broadcast together."""
    nd = spec.ndim
    nbatch = len(S_shape) - nd
    if nbatch < 0:
        raise ValueError(f"state rank {len(S_shape)} below spec.ndim")
    shapes = [tuple(S_shape[:nbatch]), tuple(spec.w.shape[1:-nd])]
    shapes += [tuple(getattr(spec, k).shape[:-nd])
               for k in ("w0", "g", "relax")]
    return tuple(np.broadcast_shapes(*shapes))


def _start(spec, S, batch):
    """The state a sweep updates in place: the extend pre-pass applied, on
    the full batch, in a buffer of its own."""
    full = batch + tuple(S.shape[-spec.ndim:])
    E = _apply_extend(spec, S)
    if tuple(E.shape) != full:
        return E.expand(full).clone(memory_format=torch.contiguous_format)
    if E is S or not E.is_contiguous():
        return E.clone(memory_format=torch.contiguous_format)
    return E


class _RowSweeper:
    """One reference-ordered sweep of a radius-1 spec (1-D, 2-D or 3-D) as
    an ``S -> S`` callable (batched), rows flattened over the leading core
    dims; see the module docstring.  All set-up that depends on the spec
    alone runs once, here."""

    def __init__(self, spec, omega, S_shape):
        nd = spec.ndim
        if any(abs(o) > 1 for off in spec.offsets for o in off):
            raise ValueError("the lexicographic executor takes radius-1 "
                             "stencils only (no biharmonic)")
        core = tuple(spec.w0.shape[-nd:])
        nx = core[-1]
        self.spec, self.nd = spec, nd
        self.batch = _full_batch(spec, S_shape)
        self.periodic = spec.bcs[-1] == "periodic"
        nrows = int(np.prod(core[:-1]))
        dt, dev = spec.w0.dtype, spec.w0.device

        def flat(a):
            return a.reshape(a.shape[:a.dim() - nd] + (nrows, nx))

        offs = {tuple(o): k for k, o in enumerate(spec.offsets)}
        kxp = offs.get((0,) * (nd - 1) + (1,))
        kxm = offs.get((0,) * (nd - 1) + (-1,))
        self.wxp = spec.w[kxp] if kxp is not None else None
        self.wxm = wxm = spec.w[kxm] if kxm is not None else None
        # the flat row step of each offset: dz*ny + dy (3-D), dy (2-D); in
        # 1-D every offset is in the row
        steps = {1: lambda o: 0, 2: lambda o: o[0],
                 3: lambda o: o[0] * core[1] + o[1]}[nd]
        self.down, up = [], []
        for k, off in enumerate(spec.offsets):
            dr = steps(off)
            if dr > 0:
                self.down.append((off, spec.w[k]))
            elif dr < 0:
                up.append((dr, off[-1], flat(spec.w[k])))
        r = flat(float(omega) * spec.relax)
        rounds = []
        if wxm is not None:
            A = (r * flat(wxm))[..., :nx - 1].clone()
            A[..., 0] = 0.0
            rounds = _affine_rounds(A)
        east = [flat(w)[..., nx - 1] if w is not None else None
                for w in (self.wxp, wxm)]
        # the rows, in fronts that may be updated together: the 1-D row, the
        # 2-D rows one at a time, the 3-D hyperplanes a (k-1) + (j-1) = const
        if nd == 1:
            rows = [np.array([0])]
        elif nd == 2:
            rows = [np.array([j]) for j in range(1, core[0] - 1)]
        else:
            nz, ny = core[0], core[1]
            a = 1 + max([abs(o[1]) for o in spec.offsets if o[0] != 0],
                        default=0)
            kk, jj = np.meshgrid(np.arange(1, nz - 1), np.arange(1, ny - 1),
                                 indexing="ij")
            kk, jj = kk.ravel(), jj.ravel()
            front = a * (kk - 1) + (jj - 1)
            rows = [kk[front == f] * ny + jj[front == f]
                    for f in np.unique(front)]
        self.fronts = []
        m_max = max(len(f) for f in rows) if rows else 1
        for fr in rows:
            if len(fr) == 1:
                i = int(fr[0])
                sel = (lambda X, i=i: X[..., i, :])
                key = i
            else:
                idx = torch.as_tensor(fr, device=dev)
                sel = (lambda X, idx=idx: X.index_select(-2, idx))
                key = idx
            self.fronts.append(dict(
                key=key,
                up=[(key + dr, dx, sel(w)) for dr, dx, w in up],
                r=sel(r), rounds=[sel(R) for R in rounds],
                east=[sel(e[..., None])[..., 0] if e is not None else None
                      for e in east]))
        n = nx - 1
        self.bufs1, self.pad = _buffers(self.batch, n, dt, dev)
        self.bufsm, _ = _buffers(self.batch + (m_max,), n, dt, dev)
        self.nrows, self.nx = nrows, nx

    def _context(self, S):
        """The old-value part of every row's context (see
        :func:`_row_update`), for the whole grid, flattened by row."""
        spec, nd = self.spec, self.nd
        dims = tuple(range(-nd, 0))
        P = spec.g
        for off, w in self.down:
            P = torch.addcmul(P, w, torch.roll(S, tuple(-o for o in off),
                                               dims))
        P = torch.addcmul(P, spec.w0, S)
        if self.wxp is not None:
            xt = self.wxp * torch.roll(S, -1, -1)
            if self.periodic:
                xt[..., -1] = 0.0
            P = P + xt
        if self.periodic and self.wxm is not None:
            P[..., 0] = torch.addcmul(P[..., 0], self.wxm[..., 0],
                                      S[..., -1])
        return P.reshape(P.shape[:P.dim() - nd] + (self.nrows, self.nx))

    def __call__(self, S):
        S = _start(self.spec, S, self.batch)
        P = self._context(S)
        Sf = S.view(S.shape[:S.dim() - self.nd] + (self.nrows, self.nx))
        for f in self.fronts:
            key = f["key"]
            single = isinstance(key, int)
            if single:
                row, t = Sf[..., key, :], P[..., key, :]
                bufs = self.bufs1
            else:
                row, t = Sf.index_select(-2, key), P.index_select(-2, key)
                m = key.shape[0]
                bufs = [b[..., :m, :] for b in self.bufsm]
            for idx, dx, w in f["up"]:
                nb = Sf[..., idx, :] if single else Sf.index_select(-2, idx)
                if dx:
                    nb = torch.roll(nb, -dx, -1)
                t = torch.addcmul(t, w, nb)
            _row_update(row, t, f["r"], f["rounds"], f["east"],
                        self.periodic, bufs, self.pad)
            if not single:
                Sf.index_copy_(-2, key, row)
        return S


def _one_iter_2d(spec, omega, S_shape=None):
    """One reference-ordered 2-D sweep as a reusable ``S -> S`` callable
    (batched states and specs).  2-D specs with radius 1 only."""
    if spec.ndim != 2:
        raise ValueError("lexicographic executor supports 2-D specs")
    if any(abs(off[1]) > 1 for off in spec.offsets):
        raise ValueError("within-row radius must be 1 (no biharmonic)")
    return _RowSweeper(spec, omega, S_shape or tuple(spec.w0.shape))


def _one_iter_3d(spec, omega, S_shape=None):
    """One 3-D reference-ordered sweep (numbas.py:16-212 ordering: k outer,
    j middle, i inner) as an ``S -> S`` callable, the (k, j) rows in
    hyperplanes (module docstring).  Radius-1 specs only."""
    if spec.ndim != 3:
        raise ValueError("use solve_fixed_lexicographic for 2-D specs")
    if any(abs(off[2]) > 1 for off in spec.offsets):
        raise ValueError("within-row radius must be 1")
    return _RowSweeper(spec, omega, S_shape or tuple(spec.w0.shape))


def _one_iter_1d(spec, omega, S_shape=None):
    """One reference-ordered 1-D sweep (invert_standard_1D,
    numbas.py:633) as an ``S -> S`` callable: extend pre-pass, then the
    periodic west stanza (old east value), the in-place interior
    recurrence (i = 1..nx-2), and the periodic east stanza (new values)."""
    if spec.ndim != 1:
        raise ValueError("1-D specs only")
    return _RowSweeper(spec, omega, S_shape or tuple(spec.w0.shape))


def _affine2_rounds(m11, m12, m21, m22):
    """The 2x2 multipliers of each doubling round of s_i = M_i s_{i-1} + v_i
    along the last axis: round r holds M's products over 2^r elements,
    M_i M_{i-1} ... (they depend on M alone)."""
    n = m11.shape[-1]
    rounds = [(m11, m12, m21, m22)]
    d = 1
    while 2 * d < n:
        m = rounds[-1]
        l11, l12, l21, l22 = (x[..., :n - d] for x in m)
        r11, r12, r21, r22 = (x[..., d:] for x in m)
        prods = (r11 * l11 + r12 * l21, r11 * l12 + r12 * l22,
                 r21 * l11 + r22 * l21, r21 * l12 + r22 * l22)
        rounds.append(tuple(torch.cat([x[..., :d], p], -1)
                            for x, p in zip(m, prods)))
        d *= 2
    return rounds


def _affine2_eval(rounds, v1, v2):
    """The first component of s_i = M_i s_{i-1} + v_i (s_{-1} = 0) by
    doubling on :func:`_affine2_rounds` of M."""
    d = 1
    for m11, m12, m21, m22 in rounds:
        s1 = F.pad(v1[..., :-d], (d, 0))
        s2 = F.pad(v2[..., :-d], (d, 0))
        v1, v2 = v1 + m11 * s1 + m12 * s2, v2 + m21 * s1 + m22 * s2
        d *= 2
    return v1


def _scan_affine2(A1, A2, B, y1, y0):
    """Second-order linear recurrence y_i = A1_i y_{i-1} + A2_i y_{i-2} + B_i
    (i = 0..n-1 of the supplied arrays) with seeds (y1, y0) = (y_{-1},
    y_{-2}), by doubling 2x2 affine maps on the state (y_i, y_{i-1})."""
    A1, A2, B = torch.broadcast_tensors(A1, A2, B)
    v1 = B.clone()
    v2 = torch.zeros_like(B)
    # fold the seed into element 0: s_0 = M_0 (y1, y0) + b_0, M_0 <- 0
    v1[..., 0] += A1[..., 0] * y1 + A2[..., 0] * y0
    v2[..., 0] += y1
    m11, m12 = A1.clone(), A2.clone()
    m21, m22 = torch.ones_like(A1), torch.zeros_like(A1)
    for m in (m11, m12, m21):
        m[..., 0] = 0.0
    return _affine2_eval(_affine2_rounds(m11, m12, m21, m22), v1, v2)


def _one_iter_bih(spec, omega, S_shape=None):
    """One reference-ordered biharmonic sweep (invert_general_bih_2D,
    numbas.py:1205) as an ``S -> S`` callable.

    Stanza order as in the reference: extend pre-pass, then per row
    (j = 2..ny-3) west columns 0 and 1, the interior in-place update
    (i = 2..nx-3), east columns nx-2 and nx-1 (periodic x only).  The
    interior reads the already-updated i-1 AND i-2: a second-order
    recurrence, evaluated by doubling 2x2 companion maps whose rounds are
    computed once; the row's two first values enter as the recurrence's
    first two elements.  The east periodic stanzas implement the intended
    symmetric discretization, as the JAX package's do (the reference's
    read a stale loop index for the B-cross term, numbas.py:1495-1497)."""
    if spec.ndim != 2 or not spec.bih:
        raise ValueError("bih executor: 2-D biharmonic specs only")
    offs = {tuple(o): k for k, o in enumerate(spec.offsets)}
    periodic = spec.bcs[-1] == "periodic"
    ny, nx = spec.w0.shape[-2:]
    batch = _full_batch(spec, S_shape or tuple(spec.w0.shape))
    r = float(omega) * spec.relax
    zeros = torch.zeros_like(spec.w0)
    wx = {dx: spec.w[offs[(0, dx)]] if (0, dx) in offs else zeros
          for dx in (-2, -1, 1, 2)}
    down = [(off, spec.w[k]) for k, off in enumerate(spec.offsets)
            if off[0] > 0]
    up = [(off, spec.w[k]) for k, off in enumerate(spec.offsets)
          if off[0] < 0]
    # elements 0 and 1 carry the seeds y0, y1: M_0 = 0, M_1 = [[0,0],[1,0]]
    n = nx - 2
    m11, m12 = (r * wx[-1])[..., :n].clone(), (r * wx[-2])[..., :n].clone()
    m21, m22 = torch.ones_like(m11), torch.zeros_like(m11)
    m11[..., :2] = 0.0
    m12[..., :2] = 0.0
    m21[..., 0] = 0.0
    rounds = _affine2_rounds(m11, m12, m21, m22)
    rounds_j = {j: [tuple(m[..., j, :] for m in R) for R in rounds]
                for j in range(2, ny - 2)}
    v2 = torch.zeros(batch + (n,), dtype=spec.w0.dtype,
                     device=spec.w0.device)

    def one_iter(S):
        S = _start(spec, S, batch)
        ctx_all = spec.g
        for off, w in down:
            ctx_all = torch.addcmul(ctx_all, w,
                                    torch.roll(S, (-off[0], -off[1]),
                                               (-2, -1)))
        for j in range(2, ny - 2):
            ctx = ctx_all[..., j, :]
            for off, w in up:
                rr = S[..., j + off[0], :]
                if off[1]:
                    rr = torch.roll(rr, -off[1], -1)
                ctx = torch.addcmul(ctx, w[..., j, :], rr)
            rowv = S[..., j, :]
            rj, w0j = r[..., j, :], spec.w0[..., j, :]
            wxj = {dx: w[..., j, :] for dx, w in wx.items()}

            def gs_at(i):
                # one in-place update at column i (wrap via % nx)
                acc = ctx[..., i] + w0j[..., i] * rowv[..., i]
                for dx in (-2, -1, 1, 2):
                    acc = acc + wxj[dx][..., i] * rowv[..., (i + dx) % nx]
                rowv[..., i] += rj[..., i] * acc

            if periodic:
                gs_at(0)
                gs_at(1)
            base = rowv + rj * (ctx + wxj[1] * torch.roll(rowv, -1, -1)
                                + wxj[2] * torch.roll(rowv, -2, -1)
                                + w0j * rowv)
            v1 = torch.cat([rowv[..., :2], base[..., 2:nx - 2]], -1)
            rowv[..., :n] = _affine2_eval(rounds_j[j], v1, v2)
            if periodic:
                gs_at(nx - 2)
                gs_at(nx - 1)
        return S

    return one_iter


def solve_fixed_lexicographic(spec, S, omega, n_iters: int):
    """Run n_iters reference-ordered sweeps (lexicographic in-place GS/SOR)
    of a 2-D radius-1 spec; batched states and specs broadcast."""
    one = _one_iter_2d(spec, omega, tuple(S.shape))
    for _ in range(int(n_iters)):
        S = one(S)
    return S


def solve_fixed_lexicographic_1d(spec, S, omega, n_iters: int):
    """Run n_iters reference-ordered 1-D sweeps (a parity tool); batched
    states and specs broadcast."""
    one = _one_iter_1d(spec, omega, tuple(S.shape))
    for _ in range(int(n_iters)):
        S = one(S)
    return S


def solve_fixed_lexicographic_bih(spec, S, omega, n_iters: int):
    """Run n_iters reference-ordered biharmonic sweeps (a parity tool; the
    red-black engine is the throughput path); batched states and specs
    broadcast."""
    one = _one_iter_bih(spec, omega, tuple(S.shape))
    for _ in range(int(n_iters)):
        S = one(S)
    return S


def solve_fixed_lexicographic_3d(spec, S, omega, n_iters: int):
    """Run n_iters 3-D reference-ordered sweeps (a parity tool); batched
    states and specs broadcast."""
    one = _one_iter_3d(spec, omega, tuple(S.shape))
    for _ in range(int(n_iters)):
        S = one(S)
    return S


def lexico_sweeper(spec, omega, S_shape):
    """One reference-ordered sweep for any family as an ``S -> S``
    callable (the ``scheme='lexico'`` engine behind
    :func:`xinvert_tpu_torch.solver.solve`), for states of shape
    ``S_shape``.  Every executor is batched by broadcasting: the JAX
    package's ``vmap`` over the spec's and the state's batch dims becomes
    leading dims on the tensors, since in-place row writes do not go under
    ``torch.func.vmap``."""
    S_shape = tuple(S_shape)
    if len(S_shape) < spec.ndim:
        raise ValueError(f"state rank {len(S_shape)} below spec.ndim")
    if spec.ndim == 2 and not spec.bih \
            and all(abs(off[1]) <= 1 for off in spec.offsets):
        return _one_iter_2d(spec, omega, S_shape)
    if spec.ndim == 1:
        return _one_iter_1d(spec, omega, S_shape)
    if spec.ndim == 2 and spec.bih:
        return _one_iter_bih(spec, omega, S_shape)
    if spec.ndim == 3:
        return _one_iter_3d(spec, omega, S_shape)
    raise ValueError(
        f"no lexicographic executor for ndim={spec.ndim} offsets="
        f"{spec.offsets}")
