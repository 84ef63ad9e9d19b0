# -*- coding: utf-8 -*-
"""The block executor every sharded solve of :mod:`xinvert_tpu_torch.parallel`
shares, and the fixed-count halo solve.

Counterpart of ``xinvert_tpu/parallel/halo.py`` (``_ring_halo``,
``solve_fixed_halo``, ``last_traffic_bytes_per_iter``) and of the
machinery its JAX siblings ``halo_window.py`` / ``halo_window3d.py`` build
inside ``shard_map``.  A :class:`Decomposition` cuts the grid into blocks
over a :class:`~xinvert_tpu_torch.parallel.mesh.Mesh`: batch slices over
'batch', rows over 'y', columns over 'x' (``mesh.block_sizes``).  A
:class:`BlockExecutor` keeps each block of this process in a buffer padded
with ghost rings, (B, [nz,] by + 2gy, bx + 2gx), and runs:

- once a solve: the blocks of the planes (w, w0, g, relax) padded and their
  rings exchanged;
- every step of k sweeps: one block-kernel call per block
  (``ops.sor2d.make_block_sweeper``: one launch of ``sor2d_sweeps_block``;
  ``ops.sor3d.make_block_sweeper``: 2k launches of
  ``sor3d_color_sweep_block``), then the state's rings exchanged.

The ghost width is the k sweeps' dependence cone, ``2 r k`` plus the
extend pre-pass's reach (1, or 2 for the biharmonic), on each split axis;
an unsplit axis has no ghosts and its windows wrap inside the block, as
the whole-grid kernels wrap.  The exchange goes x first, then the rows of
the column-padded block, so the corners come along; it wraps on every axis
(``_ring_halo``): the top block's ghost rows hold rows ny-g..ny-1, as
torch.roll sees them, so the owned cells come out as the whole grid's bit
for bit, NaN in the wrapped boundary lines included.  On a local mesh the
exchange is device copies; on a distributed mesh
``torch.distributed.batch_isend_irecv`` (gloo for CPU tensors, NCCL for
CUDA tensors).

The port exchanges full rings every k sweeps (k = 4 at radius 1), where the
JAX executor's k=1 mode exchanges color-packed half rings every half-sweep
(``halo.py:90-111``): a schedule choice, not a change in semantics.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..solver import _check_operands, _solve_impl
from ..stencil import StencilSpec, prune_zero_offsets
from ..ops._driver import slice_totals
from .mesh import AXES, Mesh, block_sizes, make_grid_mesh

__all__ = ["solve_fixed_halo", "last_traffic_bytes_per_iter",
           "Decomposition", "BlockExecutor", "padded_block",
           "padded_block_spec"]

# bytes the last solve's ghost exchanges moved per sweep ("bytes") and
# once, for the planes ("setup"): a diagnostic, never read by the solves
_traffic = {"bytes": 0, "setup": 0}


def last_traffic_bytes_per_iter() -> int:
    """Bytes the state's ghost exchanges of the last executor run moved per
    sweep, summed over the blocks of this process: per exchange, each block
    on an axis split m > 1 ways receives 2 g lines on that axis (x: by rows
    of gx columns; then y: gy rows of the column-padded bx + 2gx), times
    the slices, the levels and the item size; one exchange a step, divided
    by the step's sweeps (k, or fewer in a remainder step).  The planes'
    exchange, once a solve, is ``_traffic["setup"]``."""
    return _traffic["bytes"]


@dataclasses.dataclass(frozen=True)
class Block:
    """One block: mesh coordinates (batch, y, x), its batch slices
    [b0, b1), owned rows [oy, oy + by) and columns [ox, ox + bx), and the
    device it runs on in this process (None: another rank's block)."""
    index: tuple
    b0: int
    b1: int
    oy: int
    by: int
    ox: int
    bx: int
    rank: Optional[int]
    device: Optional[torch.device]


def _ghosts(spec, dtype, ys, xs, nd, k):
    """(k, gy, gx): the sweeps between exchanges and the ghost widths.  k
    defaults to the kernels' own (the 2-D tile plan's on the largest block,
    4 in 3-D) and comes down until every block of a split axis is as thick
    as its ghost ring (thicker, for rows under an extend pre-pass: a
    neighbour's extend row inside the ring goes stale); an explicit k that
    does not fit raises."""
    from ..ops import sor2d
    if nd == 2:
        r = sor2d._radius(spec)
        ey, ex = sor2d._extend_reach(spec)
    else:
        r = max((max(abs(o[1]), abs(o[2])) for o in spec.offsets), default=0)
        ey = 1 if spec.bcs[-2] == "extend" else 0
        ex = ey if spec.bcs[-1] != "periodic" else 0
    if k is None:
        k0 = sor2d.tile_plan(spec, (ys[0], xs[0]), dtype).k if nd == 2 else 4
    strict = spec.bcs[-2] == "extend"
    for kk in ((int(k),) if k is not None else range(k0, 0, -1)):
        gy = 2 * r * kk + ey if len(ys) > 1 else 0
        gx = 2 * r * kk + ex if len(xs) > 1 else 0
        thin_y = gy and (min(ys) < gy or (strict and min(ys) <= gy))
        if not (thin_y or (gx and min(xs) < gx)):
            return kk, gy, gx
    raise ValueError(
        f"blocks of {min(ys)} rows x {min(xs)} columns are thinner than "
        f"their ghost ring (radius {r}{', k=%d' % k if k else ''}); use "
        "fewer blocks on the split axes")


class Decomposition:
    """The blocks of a (spec, state shape) over ``mesh``.  ``checked``
    aligns rows to 8 and columns to 32 (the |S| partials' blocks);
    ``sizes`` = (rows, columns) gives the blocks' extents on the 'y' and
    'x' axes instead (a multigrid level's plan); ``device`` is where the
    caller's tensors live, and the device of this rank's block on a
    distributed mesh.  ``replicate``: a 'batch' axis that does not divide
    the slices gives every batch row of blocks all of them (each row
    computes the same), as the JAX package's ``_fit_pspec`` replicates a
    dim its mesh does not divide; without it such an axis raises."""

    def __init__(self, spec, S_shape, mesh: Mesh, k=None, checked=True,
                 device=None, dtype=torch.float64, sizes=None,
                 replicate=False):
        if not set(mesh.shape) <= set(AXES):
            raise ValueError(f"mesh axes must be named 'batch'/'y'/'x', got "
                             f"{tuple(mesh.shape)}")
        nd = spec.ndim
        if nd not in (2, 3):
            raise ValueError("the block executor takes 2-D and 3-D specs")
        self.nd = nd
        self.core = tuple(S_shape[-nd:])
        self.batch_shape = tuple(S_shape[:len(S_shape) - nd])
        self.B = math.prod(self.batch_shape)
        self.mb, self.my, self.mx = (mesh.shape.get(a, 1) for a in AXES)
        self.replicated = bool(self.B % self.mb)
        if self.replicated and not replicate:
            raise ValueError(f"batch axis {self.mb} does not divide "
                             f"{self.B} slices")
        ny, nx = self.core[-2:]
        if sizes is None:
            self.ys = block_sizes(ny, self.my, 8 if checked else 1)
            self.xs = block_sizes(nx, self.mx, 32 if checked else 1)
        else:
            self.ys, self.xs = (list(s) for s in sizes)
        self.k, self.gy, self.gx = _ghosts(spec, dtype, self.ys, self.xs,
                                           nd, k)
        self.mesh = mesh
        self.distributed = mesh.distributed
        me = None
        if mesh.distributed:
            import torch.distributed as dist
            me = dist.get_rank()
            if sorted(mesh.devices.reshape(-1)) != list(range(
                    dist.get_world_size())):
                raise ValueError("a distributed mesh lists every rank of "
                                 "the world once")
        bb = self.B if self.replicated else self.B // self.mb
        oys = [sum(self.ys[:i]) for i in range(self.my)]
        oxs = [sum(self.xs[:i]) for i in range(self.mx)]
        self.blocks = {}
        for ib in range(self.mb):
            for iy in range(self.my):
                for ix in range(self.mx):
                    coord = {"batch": ib, "y": iy, "x": ix}
                    entry = mesh.devices[tuple(coord[a]
                                               for a in mesh.axis_names)]
                    rank = entry if mesh.distributed else None
                    dev = (entry if not mesh.distributed
                           else (device if rank == me else None))
                    b0 = 0 if self.replicated else ib * bb
                    self.blocks[(ib, iy, ix)] = Block(
                        (ib, iy, ix), b0, b0 + bb, oys[iy],
                        self.ys[iy], oxs[ix], self.xs[ix], rank, dev)
        self.local = [b for b in self.blocks.values() if b.device is not None]

    # ------------------------------------------------------------ cutting
    def _own(self, b, lead):
        """Index of block b's owned cells in an array with ``lead`` leading
        (batch) dims before the core."""
        sl = (slice(b.b0, b.b1),) if lead else ()
        return sl + (slice(None),) * (self.nd - 2) + (
            slice(b.oy, b.oy + b.by), slice(b.ox, b.ox + b.bx))

    def cut(self, X, b):
        """Block b's owned cells of X, (B, *core) or (*core)."""
        return X[self._own(b, X.dim() > self.nd)]

    def _flat(self, p, stacked=0):
        """A plane with its batch dims flattened to one (B) axis; a plane
        the batch shares as it is."""
        if p.dim() - self.nd - stacked == 0:
            return p
        return p.reshape(p.shape[:stacked] + (self.B,) + self.core)

    def owned_spec(self, spec, b):
        """The spec's planes cut to block b's owned cells (batch dims
        flattened; per-slice planes follow the batch split), on its
        device."""
        w = self._flat(spec.w, 1)
        w = torch.stack([self.cut(w[i], b) for i in range(w.shape[0])])
        kw = {n: self.cut(self._flat(getattr(spec, n)), b).to(b.device)
              for n in ("w0", "g", "relax", "active")}
        return dataclasses.replace(spec, w=w.to(b.device), **kw)

    def own_view(self, P, b):
        """The owned region of block b's padded buffer P."""
        gy, gx = self.gy, self.gx
        return P[..., gy:gy + b.by, gx:gx + b.bx]

    def pad(self, X, b):
        """A padded buffer holding X (block b's owned cells); ghosts 0."""
        P = torch.zeros(tuple(X.shape[:-2]) + (b.by + 2 * self.gy,
                                               b.bx + 2 * self.gx),
                        dtype=X.dtype, device=X.device)
        self.own_view(P, b).copy_(X)
        return P

    # ----------------------------------------------------------- exchange
    def _neighbor(self, b, axis, step):
        ib, iy, ix = b.index
        if axis == "x":
            return self.blocks[(ib, iy, (ix + step) % self.mx)]
        return self.blocks[(ib, (iy + step) % self.my, ix)]

    def exchange(self, bufs, widths=None):
        """Fill the ghost rings of this process's padded buffers (a dict
        block index -> tensor (..., py, px)), x first, then the rows of the
        column-padded blocks; returns the bytes received.  ``widths`` =
        (gy, gx): the buffers' rings, when not the executor's (a
        multigrid transfer's ring of one)."""
        gy, gx = (self.gy, self.gx) if widths is None else widths
        nbytes = 0
        for axis, m, g in (("x", self.mx, gx), ("y", self.my, gy)):
            if m > 1:
                nbytes += (self._pass_dist(bufs, axis, g, gy)
                           if self.distributed
                           else self._pass_local(bufs, axis, g, gy))
        return nbytes

    def _edges(self, b, axis, g, gy):
        """(lo ghost, hi ghost, first g owned lines, last g owned lines) of
        block b's buffer along ``axis``, as index tuples over the last two
        dims (the x pass spans the owned rows below ``gy`` ghost rows, the
        y pass the full column-padded width)."""
        if axis == "x":
            rows = slice(gy, gy + b.by)
            n = b.bx
            return ((rows, slice(0, g)), (rows, slice(g + n, n + 2 * g)),
                    (rows, slice(g, 2 * g)), (rows, slice(n, n + g)))
        n = b.by
        return ((slice(0, g), slice(None)),
                (slice(g + n, n + 2 * g), slice(None)),
                (slice(g, 2 * g), slice(None)), (slice(n, n + g), slice(None)))

    def _pass_local(self, bufs, axis, g, gy):
        nbytes = 0
        for b in self.local:
            P = bufs[b.index]
            lo_g, hi_g, _, _ = self._edges(b, axis, g, gy)
            lo_b, hi_b = self._neighbor(b, axis, -1), self._neighbor(b, axis,
                                                                     1)
            src_lo = bufs[lo_b.index][(Ellipsis,)
                                      + self._edges(lo_b, axis, g, gy)[3]]
            src_hi = bufs[hi_b.index][(Ellipsis,)
                                      + self._edges(hi_b, axis, g, gy)[2]]
            P[(Ellipsis,) + lo_g].copy_(src_lo)
            P[(Ellipsis,) + hi_g].copy_(src_hi)
            nbytes += 2 * src_lo.numel() * src_lo.element_size()
        return nbytes

    def _pass_dist(self, bufs, axis, g, gy):
        import torch.distributed as dist
        (b,) = self.local
        P = bufs[b.index]
        lo_g, hi_g, first, last = self._edges(b, axis, g, gy)
        lo, hi = self._neighbor(b, axis, -1).rank, self._neighbor(b, axis,
                                                                  1).rank
        send_hi = P[(Ellipsis,) + last].contiguous()
        send_lo = P[(Ellipsis,) + first].contiguous()
        recv_lo = torch.empty_like(send_hi)
        recv_hi = torch.empty_like(send_lo)
        # tag 0 travels toward +axis, tag 1 toward -axis; every rank posts
        # its ops in this order, so NCCL (which ignores tags) pairs them too
        ops = [dist.P2POp(dist.isend, send_hi, hi, tag=0),
               dist.P2POp(dist.isend, send_lo, lo, tag=1),
               dist.P2POp(dist.irecv, recv_lo, lo, tag=0),
               dist.P2POp(dist.irecv, recv_hi, hi, tag=1)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        P[(Ellipsis,) + lo_g].copy_(recv_lo)
        P[(Ellipsis,) + hi_g].copy_(recv_hi)
        return 2 * recv_lo.numel() * recv_lo.element_size()

    # ------------------------------------------------------------- gather
    def gather(self, pieces, lead_shape, where, device, dtype):
        """Assemble this process's pieces (dict block index -> tensor) into
        one tensor of ``lead_shape`` on ``device`` on every rank;
        ``where(b)`` is the index of block b's piece in it.  A distributed
        mesh all-gathers the pieces, padded to one shape."""
        out = torch.empty(lead_shape, dtype=dtype, device=device)
        if not self.distributed:
            for b in self.local:
                out[where(b)].copy_(pieces[b.index])
            return out
        import torch.distributed as dist
        (b,) = self.local
        mine = pieces[b.index]
        big = [max(s) for s in zip(*(
            tuple(torch.empty(lead_shape, device="meta")[where(c)].shape)
            for c in self.blocks.values()))]
        buf = torch.zeros(big, dtype=dtype, device=mine.device)
        buf[tuple(slice(0, s) for s in mine.shape)].copy_(mine)
        got = [torch.empty_like(buf) for _ in range(self.mesh.size)]
        dist.all_gather(got, buf)
        for c in self.blocks.values():
            piece = got[c.rank]
            shape = torch.empty(lead_shape, device="meta")[where(c)].shape
            out[where(c)].copy_(piece[tuple(slice(0, s) for s in shape)])
        return out


class BlockExecutor:
    """The blocks of (spec, S) over ``mesh`` in padded buffers, stepped k
    sweeps at a time through the block kernels (their plain versions on
    CPU tensors).  ``omega`` scales the relaxation planes (1.0 under
    Chebyshev factors); ``k`` the sweeps between exchanges (None: the
    kernels' own); ``checked`` the aligned layout whose |S| partials are
    the whole grid's."""

    def __init__(self, spec: StencilSpec, S, mesh: Mesh, omega, k=None,
                 checked=True, sizes=None, replicate=False):
        from ..ops import sor2d, sor3d
        self.nd = spec.ndim
        self.home = S.device
        self.dtype = S.dtype
        self.dec = dec = Decomposition(spec, tuple(S.shape), mesh, k,
                                       checked, S.device, S.dtype, sizes,
                                       replicate)
        self.k = dec.k
        S = S.reshape((dec.B,) + dec.core)
        make = (sor2d if self.nd == 2 else sor3d).make_block_sweeper
        shape2 = dec.core[-2:]
        ghosts = (dec.gy, dec.gx)
        self.blocks = {}
        planes = {b.index: dec.owned_spec(spec, b) for b in dec.local}
        # the planes' rings, exchanged once a solve
        padded = {}
        setup = 0
        for name in ("w", "w0", "g", "relax"):
            bufs = {i: dec.pad(getattr(p, name), dec.blocks[i])
                    for i, p in planes.items()}
            setup += dec.exchange(bufs)
            for i, P in bufs.items():
                padded.setdefault(i, {})[name] = P
        _traffic["setup"] = setup
        for b in dec.local:
            pp = padded[b.index]
            bspec = dataclasses.replace(
                spec, w=pp["w"], w0=pp["w0"], g=pp["g"], relax=pp["relax"],
                active=planes[b.index].active)
            A = dec.pad(dec.cut(S, b).to(b.device), b)
            self.blocks[b.index] = dict(
                block=b, spec=bspec, own=planes[b.index], A=A,
                Bf=torch.empty_like(A),
                sweep=make(bspec, A, omega, (b.oy, b.ox), shape2, ghosts,
                           self.k))
        self._exchange_state()
        _traffic["bytes"] = 0
        self.n_active = self._count_active(planes)

    def _exchange_state(self):
        self._last_bytes = self.dec.exchange(
            {i: d["A"] for i, d in self.blocks.items()})

    def _count_active(self, planes):
        """Active cells over the whole problem, summed over the blocks (a
        plane the batch shares, or replicated slices, counted by the first
        batch block only)."""
        n = 0
        for i, p in planes.items():
            if i[0] == 0 or (p.active.dim() > self.nd
                             and not self.dec.replicated):
                n += int(p.active.sum())
        if self.dec.distributed:
            import torch.distributed as dist
            t = torch.tensor([n], dtype=torch.int64, device=self.home)
            dist.all_reduce(t)
            n = int(t.item())
        return max(n, 1)

    # -------------------------------------------------------------- steps
    def step(self, n, fac=None, with_norm=False):
        """n <= k sweeps of every block (``fac``: their 2n factors), then
        the state's ghost exchange; with ``with_norm`` the blocks' |S|
        partials (dict block index -> tensor)."""
        parts = {}
        for i, d in self.blocks.items():
            res, part = d["sweep"](d["A"], d["Bf"], n, fac, with_norm)
            if res is d["Bf"]:
                d["A"], d["Bf"] = d["Bf"], d["A"]
            parts[i] = part
        self._exchange_state()
        _traffic["bytes"] = self._last_bytes // n
        return parts

    def sweeps(self, n, fac=None, with_norm=False):
        """n sweeps in steps of at most k; the partials of the last."""
        done, parts = 0, None
        while done < n:
            m = min(self.k, n - done)
            f = None if fac is None else fac[2 * done:2 * (done + m)]
            parts = self.step(m, f, with_norm and done + m == n)
            done += m
        return parts

    # ---------------------------------------------------- global readings
    def _part_where(self, lead):
        def where(b):
            return ((slice(b.b0, b.b1),) + (slice(None),) * (len(lead) - 3)
                    + (slice(b.oy // 8, b.oy // 8 + -(-b.by // 8)),
                       slice(b.ox // 32, b.ox // 32 + -(-b.bx // 32))))
        return where

    def totals(self, parts):
        """Per-slice totals (B,) of the blocks' partials, assembled into the
        whole grid's partial layout (the aligned layout puts each 32 x 8
        block in one block) and summed by ``slice_totals``: the meshless
        kernels' norm, bit for bit."""
        ny, nx = self.dec.core[-2:]
        lead = ((self.dec.B,) + self.dec.core[:-2]
                + (-(-ny // 8), -(-nx // 32)))
        full = self.dec.gather(
            {i: p.reshape((-1,) + tuple(lead[1:-2]) + tuple(p.shape[-2:]))
             for i, p in parts.items()},
            lead, self._part_where(lead), self.home, self.dtype)
        return slice_totals(full.reshape(self.dec.B, -1))

    def _residual(self, d):
        """Block d's residual on its owned cells, masked to the active
        ones, from its current buffer (whose ghosts the last step
        refreshed: the rings the residual's radius needs)."""
        sp, own, A = d["spec"], d["own"], d["A"]
        dec = self.dec
        gs = (0,) * (self.nd - 2) + (dec.gy, dec.gx)
        bs = dec.core[:-2] + (d["block"].by, d["block"].bx)
        acc = own.g + own.w0 * _shifted(A, (0,) * self.nd, gs, bs)
        for k, off in enumerate(sp.offsets):
            acc = acc + own.w[k] * _shifted(A, off, gs, bs)
        return torch.where(own.active, acc, 0.0)

    def residual_norm(self):
        """Per-slice mean |r| over the active cells (B,): the blocks' |r|
        partials assembled and summed like :meth:`totals`."""
        from ..ops.sor2d import block_partials
        parts = {}
        for i, d in self.blocks.items():
            r = self._residual(d)
            p = block_partials(r)
            parts[i] = p.reshape((r.shape[0], -1) + tuple(p.shape[-2:]))
        return self.totals(parts) / self.n_active

    def load_state(self, pieces):
        """Put ``pieces`` (dict block index -> owned cells) into the blocks'
        buffers and exchange their rings (None: every cell 0, rings
        included)."""
        for i, d in self.blocks.items():
            if pieces is None:
                d["A"].zero_()
            else:
                self.dec.own_view(d["A"], d["block"]).copy_(pieces[i])
        if pieces is not None:
            self._exchange_state()

    def load_g(self, pieces):
        """Replace the blocks' constant term g by ``pieces`` (dict block
        index -> owned cells) and exchange its rings; the padded w, w0 and
        relax stay, and the sweepers read the same buffer."""
        bufs = {i: d["spec"].g for i, d in self.blocks.items()}
        for i, d in self.blocks.items():
            self.dec.own_view(bufs[i], d["block"]).copy_(pieces[i])
        self.dec.exchange(bufs)

    def own_g(self, i):
        """Block i's current g on its owned cells."""
        d = self.blocks[i]
        return self.dec.own_view(d["spec"].g, d["block"])

    def snapshot(self):
        return {i: self.dec.own_view(d["A"], d["block"]).clone()
                for i, d in self.blocks.items()}

    def restore(self, saved, done):
        """Put back the saved owned cells of the slices ``done`` (B,)."""
        flat = done.reshape(-1)
        for i, d in self.blocks.items():
            b = d["block"]
            m = flat[b.b0:b.b1].to(d["A"].device).reshape(
                (-1,) + (1,) * self.nd)
            own = self.dec.own_view(d["A"], b)
            own.copy_(torch.where(m, saved[i], own))

    def gather(self):
        """The whole state (B, *core) on the caller's device."""
        dec = self.dec
        return dec.gather(
            {i: dec.own_view(d["A"], d["block"])
             for i, d in self.blocks.items()},
            (dec.B,) + dec.core, lambda b: dec._own(b, True), self.home,
            self.dtype)


def padded_block(X, origin, owned, ghosts):
    """The block of X (its last two dims the whole grid's rows and
    columns) with owned cells ``owned`` = (by, bx) from ``origin`` =
    (oy, ox) and ``ghosts`` = (gy, gx) rings, cut by wrapped indices: what
    the ring exchange leaves in a block's buffer."""
    ny, nx = X.shape[-2:]
    rows = torch.remainder(torch.arange(owned[0] + 2 * ghosts[0],
                                        device=X.device)
                           + origin[0] - ghosts[0], ny)
    cols = torch.remainder(torch.arange(owned[1] + 2 * ghosts[1],
                                        device=X.device)
                           + origin[1] - ghosts[1], nx)
    return X.index_select(-2, rows).index_select(-1, cols).contiguous()


def padded_block_spec(spec, origin, owned, ghosts):
    """``spec`` with every plane cut to a padded block
    (:func:`padded_block`)."""
    return dataclasses.replace(spec, **{
        n: padded_block(getattr(spec, n), origin, owned, ghosts)
        for n in ("w", "w0", "g", "relax", "active")})


def _shifted(P, off, gs, bs):
    """The cells S[. + off] of a padded block's owned region: a slice where
    the axis has ghosts, a roll where the block spans the axis."""
    out = P
    for ax, (d, g, b) in enumerate(zip(off, gs, bs)):
        axis = ax - len(off)
        if g == 0:
            if d:
                out = torch.roll(out, -d, axis)
        else:
            out = out.narrow(axis, g + d, b)
    return out


# ---------------------------------------------------------------------------
# the solves that run it
# ---------------------------------------------------------------------------

def solve_fixed_blocks(spec, S, omega, n_iters, mesh, k, caller):
    """Exactly n_iters SOR sweeps through the block executor (no prune, as
    ``solver.solve_fixed``); the whole field on the caller's device."""
    _check_operands(spec, S)
    if mesh is None:
        mesh = make_grid_mesh()
    if spec.ndim not in (2, 3):
        raise ValueError(f"{caller} takes 2-D and 3-D problems")
    ex = BlockExecutor(spec, S, mesh, float(omega), k, checked=False)
    ex.sweeps(int(n_iters))
    return ex.gather().reshape(S.shape)


def solve_fixed_halo(spec: StencilSpec, S, omega, n_iters: int,
                     mesh: Optional[Mesh] = None, k_sweeps: int = 1):
    """Fixed-iteration sharded solve with explicit ghost exchange, every
    ``k_sweeps`` sweeps (the JAX executor's communication-avoiding mode;
    k_sweeps=1 exchanges once a sweep, with rings of 2r plus the extend's
    reach).  Bit-identical to ``solve_fixed`` for 2-D and 3-D specs and any
    k: owned cells read ghost values only inside their fresh dependence
    cone."""
    return solve_fixed_blocks(spec, S, omega, n_iters, mesh,
                              max(int(k_sweeps), 1), "solve_fixed_halo")


def solve_checked(spec, S0, mesh, omega, tol, max_iters, check_every,
                  scheme, tol_type, caller):
    """:func:`xinvert_tpu_torch.solver.solve` through the block executor:
    its own check-window loop (``solver._solve_impl``) over sweeps that
    step the executor, which holds the state; the change rule's norm from
    the kernels' partials in the whole grid's layout
    (:meth:`BlockExecutor.totals`), the residual rule's from the blocks'
    |r| partials, and finished slices frozen by restoring their owned
    cells.  On a distributed mesh every rank gathers the same partials, so
    every rank decides alike."""
    from ..grid import optimal_omega
    if tol_type not in ("change", "residual"):
        raise ValueError(f"unknown tol_type {tol_type!r}; "
                         "use 'change' or 'residual'")
    if scheme not in ("sor", "cheby"):
        raise ValueError(f"{caller} takes scheme 'sor' or 'cheby', got "
                         f"{scheme!r}")
    if int(check_every) < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    _check_operands(spec, S0)
    if mesh is None:
        mesh = make_grid_mesh()
    nd = spec.ndim
    if omega is None:
        omega = optimal_omega(tuple(S0.shape[-nd:]))
    omega = float(omega)
    spec = prune_zero_offsets(spec)
    batch_shape = tuple(S0.shape[:S0.dim() - nd])
    single = math.prod(batch_shape) == 1
    ex = BlockExecutor(spec, S0, mesh, 1.0 if scheme == "cheby" else omega,
                       checked=True)
    saved = {}

    def run_sweeps(spec_, S, omega_, k, with_norm=False, fac=None):
        # the executor holds the state and its omega; S stands for it
        if not single:
            saved["own"] = ex.snapshot()
        parts = ex.sweeps(k, fac, with_norm)
        if with_norm:
            return ex, ex.totals(parts).reshape(batch_shape)
        return ex

    def residual_norm(spec_, S):
        return ex.residual_norm().reshape(batch_shape)

    def freeze_state(old, new, done):
        ex.restore(saved["own"], done)
        return ex

    res = _solve_impl(spec, S0, omega, float(tol), int(max_iters),
                      int(check_every), run_sweeps, tol_type, scheme,
                      residual_norm, freeze_state)
    return dataclasses.replace(res, S=ex.gather().reshape(S0.shape))


def residual_compensated_blocks(spec, S, S_lo, mesh):
    """``ops.compensated.residual_compensated`` of (S, S_lo), block by
    block over ``mesh``: each block takes its cells with a ring of the
    stencil's radius (every rank holds the whole field, so the ring is a
    wrapped cut of it), runs the compensated cascade on its owned cells,
    and the blocks are gathered in their fixed order into the whole field
    on every rank.  Each cell's residual is the meshless one, bit for
    bit."""
    from ..ops.compensated import residual_compensated
    nd = spec.ndim
    dec = Decomposition(spec, tuple(S.shape), mesh, k=1, checked=False,
                        device=S.device, dtype=S.dtype)
    r = max((abs(o) for off in spec.offsets for o in off[-2:]), default=0)
    gy = r if dec.my > 1 else 0
    gx = r if dec.mx > 1 else 0
    Sf = S.reshape((dec.B,) + dec.core)
    Lf = S_lo.reshape((dec.B,) + dec.core)
    pieces = {}
    for b in dec.local:
        def ring(X):
            return padded_block(X[b.b0:b.b1], (b.oy, b.ox), (b.by, b.bx),
                                (gy, gx)).to(b.device)
        own = dec.owned_spec(spec, b)
        gs = (0,) * (nd - 2) + (gy, gx)
        bs = dec.core[:-2] + (b.by, b.bx)
        pieces[b.index] = residual_compensated(
            own, ring(Sf), ring(Lf),
            shift=lambda X, off, gs=gs, bs=bs: _shifted(X, off, gs, bs))
    out = dec.gather(pieces, (dec.B,) + dec.core, lambda b: dec._own(b, True),
                     S.device, S.dtype)
    return out.reshape(S.shape)

