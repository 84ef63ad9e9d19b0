# -*- coding: utf-8 -*-
"""The sharded multigrid pyramid behind ``shard_mg_levels`` and
``solve_mg_sharded`` (:mod:`.mesh`).

Counterpart of the placement ``xinvert_tpu/parallel/mesh.py`` gives a
pyramid (``shard_mg_levels``: every level's planes over the mesh where it
divides them, replicated elsewhere) and of the V-cycle XLA partitions on
it.  PyTorch has no partitioner, so the cycle is written out here on
blocks, with the semantics of the meshless :func:`xinvert_tpu_torch.mg.
solve_mg`:

- **The plan.** The finest level's rows split over 'y' and its columns
  over 'x' in units of 2^j cells (the largest j whose blocks stay within
  1/8 of an even split), so that level l's block origins are the finest
  ones over 2^l.  Level l is *split* while those origins are whole
  numbers, even where the level is restricted on its blocks (every level
  but the coarsest), and every block is thicker than its ghost ring
  (:func:`~xinvert_tpu_torch.parallel.halo._ghosts`); from the first level
  that fails, every level is *whole*: it stays on the pyramid's device
  (every rank of a distributed mesh holds it, as JAX replicates what its
  ``_fit_pspec`` drops) and runs the meshless V-cycle.  A state's batch
  splits over 'batch' where that axis divides it; elsewhere every batch
  row of blocks holds all of it (replicated, as ``_fit_pspec`` does).
- **A split level** keeps its state in a
  :class:`~xinvert_tpu_torch.parallel.halo.BlockExecutor` built once a
  solve (w, w0 and relax padded and exchanged once); a V-cycle reloads its
  state and its constant term g.  Point smoothing is the executor's sweeps:
  the block kernels ``sor2d_sweeps_block`` (B2s) and ``sor3d_block_sweep``
  (B5s) on the card, their plain versions on the CPU.  Zebra lines along
  an axis the mesh does not split are solved block by block, their parity
  the checkerboard of the other axes in global coordinates, the ring
  exchanged after each parity; lines along a split axis are gathered,
  solved whole and cut again (JAX reshards the scan axis).  The residual
  is :func:`mg._residual`'s expression in its order on the owned cells;
  restriction exchanges a ring of one cell of it and maps fine block
  [o, o + n) onto coarse block [o/2, ...); prolongation reads a ring of one
  coarse cell, from the coarse executor's ghosts or cut from a whole
  level's field.  The end values :func:`mg._shifted` repeats are repeated
  only at the global ends of a non-periodic axis.
- **The loop** is :func:`mg._solve_mg`'s, its state kept on the finest
  blocks between cycles (:class:`BlockState`); its test takes the max of
  the blocks' max |r| (one all-reduce on a distributed mesh), so every
  rank decides alike; full multigrid's
  nested start and the BiCGStab rescue run on the gathered field with this
  V-cycle as their V-cycle.

Every piece is elementwise, a max, or the meshless code on the same
values, so a split solve equals the meshless one bit for bit where the
block kernels equal the whole-grid kernels (they do, on the card and in
their plain versions).
"""
from __future__ import annotations

import dataclasses
import inspect
import math
from typing import List, Optional

import numpy as np
import torch

from .. import mg
from ..ops.tridiag import _cyclic_substitute
from ..solver import _apply_extend
from .halo import BlockExecutor, _ghosts, _shifted, padded_block
from .mesh import Mesh, block_sizes

__all__ = ["ShardedLevel", "LevelBlocks", "ShardedPyramid", "BlockState",
           "level_plan", "place"]

_BALANCE = (9, 8)     # the finest blocks stay within 9/8 of an even split


# ---------------------------------------------------------------- the plan

def _finest_sizes(n, m, n_levels):
    """The finest level's block extents on one axis: ``block_sizes`` in
    units of the largest 2^j (j < n_levels) that keeps every block within
    9/8 of n/m; None when n cells do not split over m blocks."""
    if m == 1:
        return [n]
    cap = -(-n * _BALANCE[0] // (_BALANCE[1] * m))
    for j in range(n_levels - 1, -1, -1):
        try:
            sizes = block_sizes(n, m, 1 << j)
        except ValueError:
            continue
        if max(sizes) <= cap:
            return sizes
    return None


def _sizes_at(sizes0, n, lvl, even):
    """Level ``lvl``'s extents on one axis of n cells: the finest origins
    over 2^lvl, which must be whole numbers (even ones with ``even``);
    None when they are not, or a block would be empty."""
    if len(sizes0) == 1:
        return [n]
    origins = [sum(sizes0[:i]) for i in range(len(sizes0))]
    if any(o % (1 << (lvl + int(even))) for o in origins):
        return None
    cuts = [o >> lvl for o in origins] + [n]
    sizes = [b - a for a, b in zip(cuts, cuts[1:])]
    return sizes if min(sizes) >= 1 else None


def level_plan(levels, mesh: Mesh, dtype=None):
    """Per level, its blocks' (row extents, column extents) on ``mesh``, or
    None for a whole level; the split levels come first (module
    docstring)."""
    my, mx = mesh.shape.get("y", 1), mesh.shape.get("x", 1)
    n = len(levels)
    nd = levels[0].spec.ndim
    cores = [tuple(lv.spec.w0.shape[-2:]) for lv in levels]
    dtype = dtype or levels[0].spec.w0.dtype
    ys0 = _finest_sizes(cores[0][0], my, n)
    xs0 = _finest_sizes(cores[0][1], mx, n)
    out = []
    if ys0 is not None and xs0 is not None and mesh.size > 1:
        for lvl, ((ny, nx), lv) in enumerate(zip(cores, levels)):
            even = lvl < n - 1
            ys = _sizes_at(ys0, ny, lvl, even)
            xs = _sizes_at(xs0, nx, lvl, even)
            if ys is None or xs is None:
                break
            try:
                _ghosts(lv.spec, dtype, ys, xs, nd, None)
            except ValueError:
                break
            out.append((ys, xs))
    return out + [None] * (n - len(out))


# ----------------------------------------------------- a level's transfers

def _restrict_axis_block(X, axis, ring, o, n, odd, periodic):
    """:func:`mg._restrict_axis` on a block: ``X`` holds the owned cells
    with ``ring`` (0 or 1) cells either side on ``axis``, from global
    origin ``o`` of an axis of ``n`` cells (o even); no ring: the block
    spans the axis."""
    if not ring:
        return mg._restrict_axis(X, axis, odd, periodic)
    nb = X.shape[axis] - 2
    own = X.narrow(axis, 1, nb)
    if not odd:
        return mg._coarsen_axis_cell(own, axis)
    lo, hi = X.narrow(axis, 0, nb), X.narrow(axis, 2, nb)
    if not periodic:
        # mg._shifted repeats the end values at the global ends only
        if o == 0:
            lo = torch.cat([own.narrow(axis, 0, 1),
                            lo.narrow(axis, 1, nb - 1)], axis)
        if o + nb == n:
            hi = torch.cat([hi.narrow(axis, 0, nb - 1),
                            own.narrow(axis, nb - 1, 1)], axis)
    return mg._coarsen_axis_vertex(0.25 * lo + 0.5 * own + 0.25 * hi, axis)


def _prolong_axis_block(E, axis, ring, n_fine, co, nc, n_fine_global, odd,
                        periodic):
    """:func:`mg._prolong_axis` on a block: ``E`` holds the coarse block's
    cells from global origin ``co`` of an axis of ``nc`` cells with
    ``ring`` (0 or 1) cells either side; the result has the fine block's
    ``n_fine`` cells (no ring: the whole axis, ``n_fine_global``)."""
    if not ring:
        return mg._prolong_axis(E, axis, n_fine_global, odd, periodic)
    cb = E.shape[axis] - 2
    ec = E.narrow(axis, 1, cb)
    shp = list(ec.shape)
    shp[axis] = 2 * cb
    if not odd:
        return torch.stack([ec, ec], dim=axis + 1).reshape(shp)
    nxt = E.narrow(axis, 2, cb)
    if not periodic and co + cb == nc:
        nxt = torch.cat([nxt.narrow(axis, 0, cb - 1),
                         ec.narrow(axis, cb - 1, 1)], axis)
    mid = 0.5 * (ec + nxt)
    out = torch.stack([ec, mid], dim=axis + 1).reshape(shp)
    return out.narrow(axis, 0, n_fine)


def _extend_block(spec, O, origin, shape):
    """:func:`solver._apply_extend` on a block's owned cells ``O`` (...,
    by, bx) at ``origin`` of a ``shape`` = (ny, nx) grid, as a new tensor:
    the pre-pass runs on a frame that holds the block with two dummy
    columns on a side that is not a global end and three dummy rows on
    such a side, so its writes and corner clamps land where the whole
    grid's do (a block is at least three cells thick)."""
    (oy, ox), (by, bx), (ny, nx) = origin, O.shape[-2:], shape
    top, bot = oy == 0, oy + by == ny
    if spec.bcs[-2] != "extend" or not (top or bot):
        return O
    pad = (0 if ox == 0 else 2, 0 if ox + bx == nx else 2,
           0 if top else 3, 0 if bot else 3)
    F = _apply_extend(spec, torch.nn.functional.pad(O, pad))
    return F[..., pad[2]:pad[2] + by, pad[0]:pad[0] + bx]


# ------------------------------------------------------------ split levels

class LevelBlocks:
    """A split level: its executor (the state and g of this process's
    blocks in padded buffers) and what the V-cycle does on the blocks."""

    def __init__(self, level, mesh, sizes, batch, device, dtype):
        spec = level.spec
        nd = spec.ndim
        core = tuple(spec.w0.shape[-nd:])
        shape = tuple(batch) + core
        if batch:
            spec = dataclasses.replace(spec, g=torch.zeros(
                shape, dtype=dtype, device=device))
        self.level, self.nd, self.batch = level, nd, tuple(batch)
        self.ex = BlockExecutor(spec, torch.zeros(shape, dtype=dtype,
                                                  device=device),
                                mesh, level.omega, None, checked=False,
                                sizes=sizes, replicate=True)
        self.dec = dec = self.ex.dec
        self.ring = (int(dec.my > 1), int(dec.mx > 1))
        self.gs = (0,) * (nd - 2) + (dec.gy, dec.gx)
        self._lines = {}       # axis -> per-block line systems
        self._whole_lines = {}
        self._g_whole = None

    # ------------------------------------------------------------ helpers
    def items(self):
        return self.ex.blocks.items()

    def own(self, d):
        return self.dec.own_view(d["A"], d["block"])

    def _bs(self, b):
        return self.dec.core[:-2] + (b.by, b.bx)

    def cut(self, X, b):
        """Block b's owned cells of a whole field X on its device."""
        return self.dec.cut(self.dec._flat(X), b).to(b.device)

    def load(self, S, g):
        """Load a whole state (None: zeros) and a whole g."""
        self.ex.load_g({i: self.cut(g, d["block"]) for i, d in self.items()})
        self.ex.load_state(None if S is None else {
            i: self.cut(S, d["block"]) for i, d in self.items()})
        self._g_whole = g

    def load_pieces(self, g_pieces):
        """Load g (owned pieces, masked; an unbatched level's g has no
        batch dim) and a zero state."""
        self.ex.load_g({i: p.reshape(self.ex.own_g(i).shape)
                        for i, p in g_pieces.items()})
        self.ex.load_state(None)
        self._g_whole = None

    def gather(self):
        return self.ex.gather()

    def g_whole(self):
        """The level's g as one whole field (gathered once a load)."""
        if self._g_whole is None:
            dec, lead = self.dec, bool(self.batch)
            self._g_whole = dec.gather(
                {i: self.ex.own_g(i) for i in self.ex.blocks},
                ((dec.B,) if lead else ()) + dec.core,
                lambda b: dec._own(b, lead), self.ex.home, self.ex.dtype)
        return self._g_whole

    # ---------------------------------------------------------- smoothing
    def smooth(self, n, smoother):
        if not n:
            return
        if smoother not in mg._SMOOTH_AXES:
            self.ex.sweeps(int(n))
            return
        for _ in range(int(n)):
            for ax in mg._SMOOTH_AXES[smoother]:
                split = (ax == -1 and self.dec.mx > 1) or (
                    ax == -2 and self.dec.my > 1)
                if split:
                    self._zebra_whole(ax)
                else:
                    self._zebra_blocks(ax)

    def _zebra_whole(self, axis):
        """Lines along a split axis: gathered, solved whole, cut again."""
        S = self.gather()
        spec = dataclasses.replace(self.level.spec, g=self.g_whole())
        if axis not in self._whole_lines:
            self._whole_lines[axis] = mg._line_system(self.level.spec, axis,
                                                      S)
        S = mg._zebra_line_sweep(spec, S, axis, self._whole_lines[axis])
        self.ex.load_state({i: self.cut(S, d["block"])
                            for i, d in self.items()})

    def _zebra_blocks(self, axis):
        """:func:`mg._zebra_line_sweep` block by block (lines along an
        axis no block splits), the ring exchanged after the extend
        pre-pass and after each parity."""
        nd, dec = self.nd, self.dec
        if axis not in self._lines:
            self._lines[axis] = {
                i: mg._line_system(d["own"], axis, self.own(d),
                                   (0,) * (nd - 2) + (d["block"].oy,
                                                      d["block"].ox))
                for i, d in self.items()}
        systems = self._lines[axis]
        if self.level.spec.bcs[-2] == "extend":
            for i, d in self.items():
                b = d["block"]
                O = self.own(d)
                O.copy_(_extend_block(self.level.spec, O, (b.oy, b.ox),
                                      dec.core[-2:]))
            self.ex._exchange_state()
        for parity in (1, 0):
            new = {}
            for i, d in self.items():
                own, A, b = d["own"], d["A"], d["block"]
                factor, units, take = systems[i]
                acc = self.ex.own_g(i)
                for k, off in enumerate(own.offsets):
                    if off[nd + axis] != 0:
                        continue
                    acc = acc + own.w[k] * _shifted(A, off, self.gs,
                                                    self._bs(b))
                S = self.own(d)
                d_l = torch.movedim(torch.where(own.active, -acc, S), axis,
                                    -1)
                sol = torch.movedim(_cyclic_substitute(factor, d_l, units),
                                    -1, axis)
                new[i] = torch.where(take[parity], sol, S)
            for i, d in self.items():
                self.own(d).copy_(new[i])
            self.ex._exchange_state()

    # ---------------------------------------------- residual and transfers
    def residual(self):
        """:func:`mg._residual` on each block's owned cells, in its order:
        g, the offsets' terms in turn, then w0 S; 0 off the active
        cells."""
        out = {}
        for i, d in self.items():
            own, A, b = d["own"], d["A"], d["block"]
            bs = self._bs(b)
            acc = self.ex.own_g(i)
            for k, off in enumerate(own.offsets):
                acc = acc + own.w[k] * _shifted(A, off, self.gs, bs)
            r = acc + own.w0 * _shifted(A, (0,) * self.nd, self.gs, bs)
            out[i] = torch.where(own.active, r, 0.0)
        return out

    def res_max(self, r):
        """Per member max |r| over the core, the max over the blocks (one
        all-reduce on a distributed mesh): (B,) on the home device."""
        dec = self.dec
        out = torch.zeros(dec.B, dtype=self.ex.dtype, device=self.ex.home)
        core = tuple(range(-self.nd, 0))
        for i, d in self.items():
            b = d["block"]
            m = torch.amax(torch.abs(r[i]), dim=core).to(self.ex.home)
            out[b.b0:b.b1] = torch.maximum(out[b.b0:b.b1], m)
        if dec.distributed:
            import torch.distributed as dist
            dist.all_reduce(out, op=dist.ReduceOp.MAX)
        return out

    def _coarse_block(self, b, coarse_core):
        """Block b's coarse origin and extents: half the fine ones on a
        split axis, the whole axis on another."""
        (ry, rx), (ncy, ncx) = self.ring, coarse_core
        return ((b.oy // 2 if ry else 0, b.ox // 2 if rx else 0),
                (-(-b.by // 2) if ry else ncy, -(-b.bx // 2) if rx else ncx))

    def restrict(self, r):
        """:func:`mg.restrict` of the residual pieces: a ring of one cell
        exchanged on the split axes, then each block restricted to its
        coarse block."""
        ry, rx = self.ring
        dec = self.dec
        bufs = {}
        for i, x in r.items():
            P = torch.zeros(x.shape[:-2] + (x.shape[-2] + 2 * ry,
                                            x.shape[-1] + 2 * rx),
                            dtype=x.dtype, device=x.device)
            P[..., ry:ry + x.shape[-2], rx:rx + x.shape[-1]] = x
            bufs[i] = P
        dec.exchange(bufs, (ry, rx))
        odd, bcs = self.level.odd, self.level.spec.bcs[-2:]
        out = {}
        for i, d in self.items():
            b = d["block"]
            X = bufs[i]
            for ax_rel, (o, n, rg) in enumerate(zip(
                    (b.oy, b.ox), dec.core[-2:], self.ring)):
                X = _restrict_axis_block(X, X.ndim - 2 + ax_rel, rg, o, n,
                                         odd[ax_rel],
                                         bcs[ax_rel] == "periodic")
            out[i] = X
        return out

    def gather_coarse(self, pieces, coarse_core):
        """The coarse pieces as one whole (B, *coarse) field on the home
        device (an all-gather on a distributed mesh)."""
        dec = self.dec

        def where(b):
            (coy, cox), (cby, cbx) = self._coarse_block(b, coarse_core)
            return ((slice(b.b0, b.b1),) + (slice(None),) * (self.nd - 2)
                    + (slice(coy, coy + cby), slice(cox, cox + cbx)))
        shape = (dec.B,) + dec.core[:-2] + tuple(coarse_core)
        return dec.gather(pieces, shape, where, self.ex.home, self.ex.dtype)

    def rings_of_whole(self, e):
        """Each block's coarse cells with a ring of one on the split axes,
        cut from a whole coarse field e (B, *coarse)."""
        e = e.reshape((self.dec.B,) + tuple(e.shape[-self.nd:]))
        out = {}
        for i, d in self.items():
            b = d["block"]
            origin, owned = self._coarse_block(b, e.shape[-2:])
            out[i] = padded_block(e[b.b0:b.b1], origin, owned,
                                  self.ring).to(b.device)
        return out

    def rings(self):
        """Each block's state with a ring of one cell on the split axes,
        read from its ghosts (fresh after every smoothing step and
        load)."""
        dec = self.dec
        (ry, rx), out = self.ring, {}
        for i, d in self.items():
            b = d["block"]
            out[i] = d["A"][..., dec.gy - ry:dec.gy + b.by + ry,
                            dec.gx - rx:dec.gx + b.bx + rx]
        return out

    def prolong(self, e_rings, coarse_core):
        """:func:`mg.prolong` of each block's coarse ring onto its owned
        cells: x first, then y."""
        dec = self.dec
        odd, bcs = self.level.odd, self.level.spec.bcs[-2:]
        out = {}
        for i, d in self.items():
            b = d["block"]
            (coy, cox), _ = self._coarse_block(b, coarse_core)
            E = e_rings[i]
            for ax_rel in reversed(range(2)):
                E = _prolong_axis_block(
                    E, E.ndim - 2 + ax_rel, self.ring[ax_rel],
                    (b.by, b.bx)[ax_rel], (coy, cox)[ax_rel],
                    coarse_core[ax_rel], dec.core[-2 + ax_rel], odd[ax_rel],
                    bcs[ax_rel] == "periodic")
            out[i] = E
        return out

    def correct(self, corr, alpha):
        """S - alpha * corr on the active owned cells; the rings
        exchanged."""
        for i, d in self.items():
            S = self.own(d)
            S.copy_(torch.where(d["own"].active, S - alpha * corr[i], S))
        self.ex._exchange_state()


@dataclasses.dataclass(frozen=True)
class ShardedLevel(mg.MGLevel):
    """A level placed on ``mesh``: ``sizes`` = (row extents, column
    extents) of its blocks, or None for a whole level (on the pyramid's
    device).  It is an :class:`~xinvert_tpu_torch.mg.MGLevel` as it was,
    so :func:`mg.solve_mg` takes a placed pyramid too and solves it
    whole."""
    mesh: Optional[Mesh] = None
    sizes: Optional[tuple] = None

    @property
    def split(self) -> bool:
        return self.sizes is not None


def place(levels, mesh: Mesh) -> List[ShardedLevel]:
    """The pyramid's levels with their block plans on ``mesh``
    (:func:`level_plan`)."""
    fields = [f.name for f in dataclasses.fields(mg.MGLevel)]
    return [ShardedLevel(**{f: getattr(lv, f) for f in fields}, mesh=mesh,
                         sizes=None if p is None else tuple(map(tuple, p)))
            for lv, p in zip(levels, level_plan(levels, mesh))]


class ShardedPyramid:
    """The V-cycle of :func:`mg.solve_mg` over a placed pyramid, its split
    levels on executors built for a state of ``batch`` slices (() for
    none)."""

    def __init__(self, levels: List[ShardedLevel], batch):
        spec = levels[0].spec
        dtype, device = spec.w0.dtype, spec.w0.device
        self.levels = levels
        self.blocks = [None if not lv.split else LevelBlocks(
            lv, lv.mesh, lv.sizes, batch, device, dtype) for lv in levels]

    def _coarse_core(self, lvl):
        return tuple(self.levels[lvl + 1].spec.w0.shape[-2:])

    def vcycle_blocks(self, lvl, nu1, nu2, coarse_iters, alpha, smoother):
        """:func:`mg._vcycle` from split level ``lvl``, whose executor holds
        the state and g; the result stays in it."""
        L = self.blocks[lvl]
        if lvl == len(self.levels) - 1:
            L.smooth(coarse_iters, smoother)
            return
        L.smooth(nu1, smoother)
        rc = L.restrict(L.residual())
        scale = -16.0 if self.levels[lvl].spec.bih else -4.0
        coarse = self._coarse_core(lvl)
        nxt = self.blocks[lvl + 1]
        args = (nu1, nu2, coarse_iters, alpha, smoother)
        if nxt is not None:
            nxt.load_pieces({
                i: torch.where(d["own"].active, scale * rc[i], 0.0)
                for i, d in nxt.items()})
            self.vcycle_blocks(lvl + 1, *args)
            e_rings = nxt.rings()
        else:
            g_c = L.gather_coarse({i: scale * x for i, x in rc.items()},
                                  coarse)
            e = mg._vcycle(self.levels, lvl + 1, torch.zeros_like(g_c),
                           g_c, *args)
            e_rings = L.rings_of_whole(e)
        L.correct(L.prolong(e_rings, coarse), alpha)
        L.smooth(nu2, smoother)

    def vcycle(self, levels, lvl, S, g_override, nu1, nu2, coarse_iters,
               alpha=1.0, smoother="point"):
        """:func:`mg._vcycle`'s signature on whole fields: a split level
        loads them, runs :meth:`vcycle_blocks` and gathers the state."""
        L = self.blocks[lvl]
        if L is None:
            return mg._vcycle(levels, lvl, S, g_override, nu1, nu2,
                              coarse_iters, alpha, smoother)
        spec = levels[lvl].spec
        g = spec.g if g_override is None else torch.where(
            spec.active, g_override, 0.0)
        L.load(S, g)
        self.vcycle_blocks(lvl, nu1, nu2, coarse_iters, alpha, smoother)
        return L.gather().reshape(S.shape)

    def state(self, levels, spec, S, args):
        return BlockState(self, spec, S, args)


class BlockState:
    """:class:`mg._FinestState` on the finest level's blocks: the state
    stays in the executor between V-cycles, a member that does not go gets
    its owned cells back, and the residual's max is the blocks' max."""

    def __init__(self, pyr, spec, S, args):
        self.pyr, self.args, self.shape = pyr, args, S.shape
        self.batch = S.shape[:S.ndim - spec.ndim]
        self.L = pyr.blocks[0]
        self.L.load(S, torch.where(spec.active, spec.g, 0.0))

    def cycle(self, go):
        ex = self.L.ex
        saved = None if go is None else ex.snapshot()
        self.pyr.vcycle_blocks(0, *self.args)
        r = self.L.res_max(self.L.residual()).reshape(self.batch)
        if go is not None:
            ex.restore(saved, ~go)
            ex._exchange_state()
        return r

    def field(self):
        return self.L.gather().reshape(self.shape)


def solve(levels, S0, g0, kw):
    """:func:`mg.solve_mg` on a placed pyramid (``kw``: its keyword
    arguments)."""
    args = inspect.signature(mg.solve_mg).bind(levels, S0, g0=g0, **kw)
    args.apply_defaults()
    a = args.arguments
    if not levels[0].split:
        return mg.solve_mg(**a)
    nd = levels[0].spec.ndim
    shape = () if a["S0"] is None else tuple(np.shape(a["S0"]))
    batch = shape[:len(shape) - nd]
    pyr = ShardedPyramid(levels, (math.prod(batch),) if batch else ())
    return mg._solve_stages(
        levels, a["S0"], a["tol"], a["max_cycles"], a["nu1"], a["nu2"],
        a["coarse_iters"], a["alpha"], a["smoother"], a["g0"], a["accel"],
        a["fmg"], vcycle=pyr.vcycle, state=pyr.state)
