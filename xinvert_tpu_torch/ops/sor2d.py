# -*- coding: utf-8 -*-
"""Red-black SOR sweeps of a 2-D stencil: CUDA kernels and plain versions.

The kernels (``csrc/sor2d.cu``) replace the three TPU kernels of the 2-D
paths, ``xinvert_tpu/ops/pallas_sor.py::_kernel``,
``xinvert_tpu/ops/pallas_sor_window.py::_kernel`` (with its fused |S|
partials and its Chebyshev factors) and
``xinvert_tpu/ops/pallas_sor_window.py::_kernel_inplace``; the source says
how.  Each kernel has a wrapper here and a plain PyTorch version built from
:mod:`xinvert_tpu_torch.solver`'s sweep pieces:

- ``sor2d_sweeps_tiled`` (k sweeps per launch on shared-memory windows, the
  extend pre-pass folded in): :func:`sor2d_sweeps_tiled`, plain
  :func:`sor2d_sweeps_reference` and :func:`sor2d_sweeps_reference_norm`;
- ``sor2d_sweeps_tiled_inplace`` (the same with one buffer, B3's design):
  :func:`sor2d_sweeps_tiled_inplace`, the same plain versions;
- ``sor2d_sweeps_resident`` (every slice held whole in shared memory for
  up to a check window of sweeps a launch, in place; slices that fit one
  SM): :func:`sor2d_sweeps_resident`, the same plain versions;
- ``sor2d_sweeps_block`` (B2s: the ping-pong tiled kernel on one
  ghost-padded block of a decomposition, the pallas ``_kernel``'s block
  arguments): :func:`sor2d_sweeps_block` and :func:`make_block_sweeper`
  (the multi-device executor's), plain
  :func:`sor2d_sweeps_block_reference` with :func:`block_partials`.

:func:`sor2d_sweeps`, which the solver calls, makes the route: the resident
kernel where :func:`resident_plan` takes the spec, the slice's shape and
the dtype (a radius-1 stencil without cross terms whose slice fits the
kernel's shared memory and registers), else the tiled kernels: the
in-place one when ``INPLACE_KERNEL`` is set (the environment variable
``XINVERT_INPLACE=1`` at import, as in the JAX package) and the spec passes
:func:`_no_cross_r1` and the race check of :func:`inplace_eligible`, the
ping-pong one otherwise.  :func:`tile_plan` sizes the tiled kernels'
tiles and sweeps per launch; :func:`sor2d_sweeps_tiled_emulated` replays a
plan's windows, and :func:`sor2d_sweeps_resident_emulated` the resident
kernel's color arrays and modes, with torch ops, so their semantics are
testable on the CPU.

A wrapper launches its kernel for CUDA tensors and takes the plain version
only for CPU tensors; any other input raises.  ``RESIDENT_LAUNCHES``,
``TILED_LAUNCHES``, ``TILED_INPLACE_LAUNCHES`` and ``BLOCK_LAUNCHES`` count
kernel launches, ``PLAIN_CALLS`` calls of the plain versions, so a run can
show which path it took; ``TILED_WINDOW_CELLS`` and ``TILED_CELLS`` count
the cells the tiled launches' windows load and the cells they update
(:func:`tiled_cells`), so a run can show how much of their traffic is
halo; ``TILED_SLICES`` and ``TILED_STAGED_SLICES`` count the slice windows
the tiled launches load and those of them staged while the slice before
swept (:func:`tiled_slices`).  No function here changes the caller's tensors:
the kernels work on buffers the wrappers allocate.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
import os
from typing import NamedTuple

import torch

from .. import solver
from . import _driver
from ._driver import relax_plane

__all__ = ["sor2d_sweeps", "sor2d_sweeps_tiled",
           "sor2d_sweeps_tiled_inplace", "sor2d_sweeps_tiled_emulated",
           "tile_plan", "TilePlan", "tiled_cells", "tiled_slices",
           "sor2d_sweeps_resident",
           "sor2d_sweeps_resident_emulated", "resident_plan",
           "resident_footprint", "ResidentPlan", "sor2d_sweeps_reference",
           "sor2d_sweeps_reference_norm", "inplace_eligible",
           "sor2d_sweeps_block", "sor2d_sweeps_block_reference",
           "make_block_sweeper", "block_partials", "relax_plane", "MAX_K"]

MAX_K = 16          # offsets the kernels take (csrc SOR2D_MAX_K)
_MAX_GRID_Z = 65535  # the grid's z limit (the tiled kernels' slice groups)
MAX_TILED_SWEEPS = 8  # sweeps per tiled launch (csrc TILED_MAX_SWEEPS)
MAX_RESIDENT_SWEEPS = 64  # sweeps per resident launch (csrc
#                           RESIDENT_MAX_SWEEPS): a check window of 32

#: sweeps take the in-place kernel for eligible specs (off by default, as
#: in the JAX package; tests and smoke runs set the attribute)
INPLACE_KERNEL = os.environ.get("XINVERT_INPLACE") == "1"

RESIDENT_LAUNCHES = 0       # sor2d_sweeps_resident kernel launches
TILED_LAUNCHES = 0          # sor2d_sweeps_tiled kernel launches
TILED_INPLACE_LAUNCHES = 0  # sor2d_sweeps_tiled_inplace kernel launches
BLOCK_LAUNCHES = 0          # sor2d_sweeps_block kernel launches
PLAIN_CALLS = 0             # calls of the plain versions
TILED_WINDOW_CELLS = 0      # cells the tiled launches' windows load
TILED_CELLS = 0             # cells the tiled launches update
TILED_SLICES = 0            # slice windows the tiled launches load
TILED_STAGED_SLICES = 0     # of them, staged while the slice before swept


# ---------------------------------------------------------------------------
# the tile plan of the tiled kernels
# ---------------------------------------------------------------------------

#: (itemsize, kmax, inplace) -> (threads, cells per thread, weight planes
#: in shared memory): the kernel instantiations of csrc/sor2d.cu
#: (TILED_CASE).  A thread holds the coefficients of its cells in registers
#: (the weight planes in shared memory where the last entry is 1), so
#: threads x cells bounds a window: 4096 cells in float32 (2048 with 8
#: offsets), 2048 in float64; one block fills an SM.  Chosen from
#: chip_smoke.py's phase-4 scans (PERF.md, PR 4).
_CONFIGS = {(4, 4, False): (1024, 4, 0), (4, 4, True): (1024, 4, 0),
            (4, 8, False): (512, 4, 0), (4, 16, False): (1024, 2, 1),
            (8, 4, False): (512, 4, 0), (8, 4, True): (512, 4, 0),
            (8, 8, False): (512, 4, 1), (8, 16, False): (512, 2, 1)}
_SMEM_MAX = 232448  # shared memory a block can have on Hopper
#: sweeps per launch by stencil radius, and the preferred tile width
_SWEEPS = {1: 4, 2: 1}
_WIDTH = 64   # columns of a tile


class TilePlan(NamedTuple):
    """The tiling of one (spec, core, dtype, kernel): owned tiles of
    ``ty`` x ``tx`` cells in windows of (ty + 2hy) x (tx + 2hx), ``k``
    sweeps per launch, ``threads`` per block each holding ``cpt`` cells,
    ``smem`` bytes of shared memory (the state, padded by ``pad``, the
    weight planes where ``wsmem``, the row sums of the |S| partials, and
    where ``stage`` the buffers a pipelined slice walk stages the next
    slice's state and g windows in)."""
    ty: int
    tx: int
    k: int
    hy: int
    hx: int
    pad: int
    threads: int
    cpt: int
    wsmem: int
    kmax: int
    inplace: bool
    smem: int
    stage: bool

    @property
    def winy(self):
        return self.ty + 2 * self.hy

    @property
    def winx(self):
        return self.tx + 2 * self.hx

    def tiles(self, core):
        """(tiles along y, tiles along x) of a ``core`` = (ny, nx) grid."""
        return (-(-core[0] // self.ty), -(-core[1] // self.tx))


def tiled_cells(plan, B, core):
    """(window cells, grid cells) of one tiled launch of ``plan`` on ``B``
    slices of a ``core`` = (ny, nx) grid: the winy x winx window of every
    tile of every slice, which the launch loads, and the B x ny x nx cells
    it updates.  Their ratio is the launch's read of the state over the
    grid, halo and the last tiles' overhang included."""
    tiles_y, tiles_x = plan.tiles(core)
    return (B * tiles_y * tiles_x * plan.winy * plan.winx,
            B * core[0] * core[1])


def tiled_slices(plan, B, spb, core):
    """(staged, total) slice windows of one tiled launch of ``plan`` on
    ``B`` slices of a ``core`` = (ny, nx) grid, each block walking ``spb``
    slices of its tile: the launch loads B windows a tile, and where it is
    pipelined (the plan holds the stage and spb > 1) every slice of a block's
    walk but the first is staged while the slice before it sweeps, B less
    the ceil(B / spb) groups a tile."""
    tiles = math.prod(plan.tiles(core))
    groups = -(-B // spb)
    staged = B - groups if plan.stage and spb > 1 else 0
    return tiles * staged, tiles * B


def _radius(spec):
    return max((abs(o) for off in spec.offsets for o in off), default=0)


def _extend_reach(spec):
    """(rows, columns) the extend pre-pass reads away from a cell it writes
    (csrc/sor2d.cu: the e added to the halo)."""
    if spec.bcs[-2] != "extend":
        return 0, 0
    e = 2 if spec.bih else 1
    return e, (0 if spec.bcs[-1] == "periodic" else e)


def make_plan(spec, core, dtype, inplace, k, ty, tx):
    """The plan with ``k`` sweeps per launch and ``ty`` x ``tx`` tiles, its
    halo the least that covers k sweeps; raises if the window does not fit
    the instantiation's threads x cells or shared memory.  A ping-pong plan
    of more than 4 offsets holds the stage of a pipelined slice walk (a
    third state buffer and the g window) where that fits too: this is the
    one place that decides which plans stage (csrc/sor2d.cu has a staged
    instantiation for these alone, and refuses the stage elsewhere); the
    tiles do not depend on it.
    The kernels write the fused |S| partials only for tiles that hold
    whole 32 x 8 blocks (ty a multiple of 8, tx of 32, or one tile along
    the axis): :func:`tile_plan`'s plans do."""
    K = len(spec.offsets)
    kmax = 4 if K <= 4 else (8 if K <= 8 else 16)
    itemsize = torch.empty((), dtype=dtype).element_size()
    nt, cpt, wsmem = _CONFIGS[(itemsize, kmax, bool(inplace))]
    r = _radius(spec)
    ey, ex = _extend_reach(spec)
    hy, hx = 2 * r * k + ey, 2 * r * k + ex
    if not (1 <= k <= MAX_TILED_SWEEPS and ty >= 1 and tx >= 1):
        raise ValueError(f"no tiled plan with k={k}, tile {ty}x{tx}")
    winy, winx = ty + 2 * hy, tx + 2 * hx
    if winy * winx > nt * cpt:
        raise ValueError(f"a {winy}x{winx} window exceeds the {nt * cpt} "
                         "cells of the kernel")
    # the state buffers, the weight planes where they live in shared
    # memory, the row sums of the tile's 32 x 8 blocks; the stage: one more
    # state buffer and the g window (csrc/sor2d.cu::launch_tiled)
    buf = (winy + 2 * r) * (winx + 2 * r)
    smem = ((1 if inplace else 2) * buf + (K * winy * winx if wsmem else 0)
            + -(-ty // 8) * 8 * -(-tx // 32)) * itemsize
    if smem > _SMEM_MAX:
        raise ValueError(f"a {winy}x{winx} window needs {smem} bytes of "
                         "shared memory")
    staged = smem + (buf + winy * winx) * itemsize
    stage = not inplace and kmax > 4 and staged <= _SMEM_MAX
    return TilePlan(ty, tx, k, hy, hx, r, nt, cpt, wsmem, kmax, bool(inplace),
                    staged if stage else smem, stage)


def tile_plan(spec, core, dtype, inplace=False, k=None):
    """The tiled kernels' plan for ``spec`` on a ``core`` = (ny, nx) grid
    in ``dtype``: ``_SWEEPS`` sweeps per launch by radius (fewer where no
    window fits; exactly ``k`` when given, for a block); tiles ``_WIDTH``
    columns wide (32 where that leaves no rows), or the whole x axis where
    its window fits; as many rows as the
    instantiation's cells allow, a multiple of 8, or the whole y axis.
    The tiles thus hold whole 32 x 8 blocks, whose |S| sums the kernels
    add in one order (:func:`block_partials`).  Raises where even one
    sweep per launch leaves no such window (a radius beyond the package's
    stencils with 16 offsets in float64)."""
    ny, nx = core
    K = len(spec.offsets)
    kmax = 4 if K <= 4 else (8 if K <= 8 else 16)
    itemsize = torch.empty((), dtype=dtype).element_size()
    nt, cpt = _CONFIGS[(itemsize, kmax, bool(inplace))][:2]
    r = _radius(spec)
    ey, ex = _extend_reach(spec)
    ks = (range(min(_SWEEPS.get(r, 1), MAX_TILED_SWEEPS), 0, -1)
          if k is None else (int(k),))
    for k in ks:
        hy, hx = 2 * r * k + ey, 2 * r * k + ex
        for tx in (nx, _WIDTH, 32):
            if tx > nx or (tx < nx and tx % 32):
                continue
            rows = nt * cpt // (tx + 2 * hx) - 2 * hy
            ty = ny if ny <= rows else rows // 8 * 8
            while ty >= 1:
                try:
                    return make_plan(spec, core, dtype, inplace, k, ty, tx)
                except ValueError:      # shared memory: fewer rows
                    ty = ty - 8 if ty > 8 and ty % 8 == 0 else 0
    raise ValueError(f"no tiled plan for radius {r} with {K} offsets in "
                     f"{dtype}")


# ---------------------------------------------------------------------------
# the resident kernel's plan: does a whole slice fit one SM?
# ---------------------------------------------------------------------------

#: itemsize -> (threads, slots per thread): the resident kernel's
#: instantiations (csrc/sor2d.cu RESIDENT_CASE).
#: A slot is a pair of cells of one row, one of each color, whose w0, g and
#: rel a thread holds in registers, so threads x slots bounds a slice:
#: ny x ceil(nx / 2) <= 5376 pairs in float32, 3072 in float64.  Chosen
#: from chip_smoke.py's phase-4 scan (PERF.md §6).
_RESIDENT_CONFIGS = {4: (896, 6), 8: (512, 6)}


class ResidentPlan(NamedTuple):
    """The resident kernel for one (spec, core, dtype): ``k`` sweeps per
    launch at most, ``threads`` per block each holding ``cpt`` slots,
    color arrays of row stride ``rs``, ``smem`` bytes of shared memory
    (the two color arrays with their ghost ring, the weights, the row sums
    of the |S| partials)."""
    threads: int
    cpt: int
    rs: int
    smem: int
    k: int = MAX_RESIDENT_SWEEPS


def resident_footprint(core, itemsize):
    """(slots, row stride, shared-memory bytes) of a ``core`` = (ny, nx)
    slice (csrc/sor2d.cu::launch_resident): ny x ceil(nx / 2) slots; two
    color arrays of (ny + 2) x (ceil(nx / 2) + 2) cells (the slice and its
    ghost ring), rounded up to 4 cells; the weights, 4 a cell (K <= 4) over
    the two colors' ny rows; the row sums of the slice's 32 x 8 blocks."""
    ny, nx = core
    hx = -(-nx // 2)
    rs = hx + 2
    cells = (-(-2 * (ny + 2) * rs // 4) * 4 + 8 * ny * rs
             + -(-ny // 8) * 8 * -(-nx // 32))
    return ny * hx, rs, cells * itemsize


def resident_plan(spec, core, dtype):
    """The resident kernel's plan for ``spec`` on a ``core`` = (ny, nx)
    slice in ``dtype``, or None where the kernel does not take it: a
    slice that is not 2-D, a stencil with cross terms, a radius beyond 1 or
    the biharmonic (a
    neighbour of the slice's own color), or a slice whose pairs exceed the
    instantiation's threads x slots or whose footprint exceeds
    ``_SMEM_MAX``.  Chosen from the shape, the spec and the dtype alone."""
    if len(core) != 2:
        return None
    ny, nx = core
    K = len(spec.offsets)
    if not _radius1_no_cross(spec) or K > 4 or ny < 3 or nx < 3:
        return None
    itemsize = torch.empty((), dtype=dtype).element_size()
    nt, cpt = _RESIDENT_CONFIGS[itemsize]
    slots, rs, smem = resident_footprint(core, itemsize)
    if slots > nt * cpt or smem > _SMEM_MAX or (ny + 2) * rs > 0xFFFF:
        return None
    return ResidentPlan(nt, cpt, rs, smem)


# ---------------------------------------------------------------------------
# the plan replayed with torch ops (tests the tiling's semantics on the CPU;
# not the plain version, and no entry point calls it)
# ---------------------------------------------------------------------------

def _extend_window(spec, win, R, C, ny, nx):
    """The extend pre-pass on a window whose cells are global (R, C): each
    cell the pre-pass writes takes its source cell's value from the window
    (read all, then write), as csrc/sor2d.cu::extend_source."""
    periodic_x = spec.bcs[-1] == "periodic"
    zero = torch.zeros_like(R)
    if not spec.bih:
        tgt = (R == 0) | (R == ny - 1)
        dr = torch.where(R == 0, 1, -1)
        dc = zero if periodic_x else torch.where(
            C == 0, 1, torch.where(C == nx - 1, -1, 0))
    else:
        tgt = (R == 0) | (R == 1) | (R == ny - 2) | (R == ny - 1)
        dr = torch.where(R == 0, 1 if periodic_x else 2,
                         torch.where(R == 1, 1,
                                     torch.where(R == ny - 2, -1, -2)))
        dc = zero if periodic_x else torch.where(
            C < 2, 2 - C, torch.where(C >= nx - 2, nx - 3 - C, 0))
    winy, winx = R.shape
    ll = torch.arange(winy, device=R.device)[:, None] + dr
    mm = torch.arange(winx, device=R.device)[None, :] + dc
    ok = tgt & (ll >= 0) & (ll < winy) & (mm >= 0) & (mm < winx)
    src = win[..., ll.clamp(0, winy - 1), mm.clamp(0, winx - 1)]
    return torch.where(ok, src, win)


def _window_planes(spec, rel, B, rows, cols):
    """The coefficient planes over a window: w (K, B', wy, wx), w0, g, rel
    (B', wy, wx), B' being 1 for a plane the batch shares."""
    def cut(p):
        p = p.reshape((-1,) + tuple(p.shape[-2:]))
        return p[:, rows][:, :, cols]
    K = len(spec.offsets)
    w = spec.w.reshape((K, -1) + tuple(spec.w.shape[-2:]))
    w = w[:, :, rows][:, :, :, cols]
    return w, cut(spec.w0), cut(spec.g), cut(rel)


def _window_sweeps(spec, win, planes, R, C, ny, nx, n, fac, inplace=False):
    """n sweeps of a window (or a ghost-padded block) ``win`` whose cells
    are the global (R, C), as the tiled kernels run them in shared memory:
    the extend pre-pass where it writes a row (sources outside the window
    skipped), then red, then black, every neighbour read wrapping inside the
    window (cells near its edge hold what their cone lets them); the parity
    is the global (R + C) & 1.  ``planes`` = (w, w0, g, rel) over the window;
    ``fac`` the 2n factors or None; ``inplace`` updates the active color
    only, as the in-place kernel."""
    w, w0, g, rl = planes
    red = (R + C) % 2 == 0
    for s in range(n):
        if spec.bcs[-2] == "extend":
            win = _extend_window(spec, win, R, C, ny, nx)
        for color in (0, 1):
            f = 1.0 if fac is None else fac[2 * s + color]
            sel = red if color == 0 else ~red
            r = (rl * sel.to(win.dtype)) * f
            acc = g
            for k, (dy, dx) in enumerate(spec.offsets):
                acc = acc + w[k] * torch.roll(win, shifts=(-dy, -dx),
                                              dims=(-2, -1))
            new = win + r * (acc + w0 * win)
            win = torch.where(sel, new, win) if inplace else new
    return win


def sor2d_sweeps_tiled_emulated(spec, S, omega, n, with_norm=False,
                                fac=None, inplace=False, plan=None):
    """n sweeps as the tiled kernels run them, with torch ops: ``plan``
    (default :func:`tile_plan`) cut into launches of at most ``plan.k``
    sweeps; each launch loads every tile's window with modular indices,
    runs its sweeps there (the extend pre-pass in windows that hold a row
    it writes, then red, then black; ``inplace`` updates the active color
    only, as the in-place kernel) and writes back only the owned tile.
    With ``with_norm`` also the per-slice total |S'| of the last launch's
    owned tiles.  Equal to :func:`sor2d_sweeps_reference` wherever the plan
    is right; it exists to test that."""
    ny, nx = S.shape[-2:]
    batch_shape = tuple(S.shape[:-2])
    B = max(1, S.numel() // (ny * nx))
    plan = plan or tile_plan(spec, (ny, nx), S.dtype, inplace)
    rel = relax_plane(spec, omega)
    A = S.reshape(B, ny, nx).clone()
    n = int(n)
    nty, ntx = plan.tiles((ny, nx))
    done, sums = 0, None
    while done < n:
        m = min(plan.k, n - done)
        out = torch.empty_like(A)
        sums = torch.zeros(B, dtype=S.dtype)
        for ti in range(nty):
            for tj in range(ntx):
                ty0, tx0 = ti * plan.ty, tj * plan.tx
                rows = torch.remainder(
                    torch.arange(plan.winy) + ty0 - plan.hy, ny)
                cols = torch.remainder(
                    torch.arange(plan.winx) + tx0 - plan.hx, nx)
                R = rows[:, None].expand(plan.winy, plan.winx)
                C = cols[None, :].expand(plan.winy, plan.winx)
                win = _window_sweeps(
                    spec, A[:, rows][:, :, cols],
                    _window_planes(spec, rel, B, rows, cols), R, C, ny, nx,
                    m, None if fac is None else fac[2 * done:2 * (done + m)],
                    inplace)
                oy, ox = min(plan.ty, ny - ty0), min(plan.tx, nx - tx0)
                own = win[:, plan.hy:plan.hy + oy, plan.hx:plan.hx + ox]
                out[:, ty0:ty0 + oy, tx0:tx0 + ox] = own
                sums = sums + own.abs().sum(dim=(-2, -1))
        A = out
        done += m
    out = A.reshape(S.shape)
    if with_norm:
        return out, sums.reshape(batch_shape)
    return out


#: the resident kernel's fast-mode bounds (csrc/sor2d.cu::res_bounds):
#: itemsize -> (|w_k|, |w0|; |g|; |state|)
_RESIDENT_BOUNDS = {4: (2.0 ** 40, 2.0 ** 126, 2.0 ** 80),
                    8: (2.0 ** 400, 2.0 ** 1022, 2.0 ** 600)}


def _resident_index(spec, ny, nx, rs):
    """The resident kernel's addresses: each cell's (ny, nx) index into its
    two color arrays laid end to end, each ghost's (cells, index) and each
    offset's (base, mask) (csrc/sor2d.cu: res_ix, res_put_edge,
    ResidentArgs.obase/omask)."""
    sa = (ny + 2) * rs
    j = torch.arange(ny)[:, None].expand(ny, nx)
    i = torch.arange(nx)[None, :].expand(ny, nx)

    def at(jj, ii):
        return ((jj + ii) & 1) * sa + (jj + 1) * rs + ((ii + 2) >> 1)
    ghosts = [(i == 0, at(j, torch.full_like(i, nx))),
              (i == nx - 1, at(j, torch.full_like(i, -1))),
              (j == 0, at(torch.full_like(j, ny), i)),
              (j == ny - 1, at(torch.full_like(j, -1), i))]
    offs = [(dy * rs + (-1 if dx < 0 else 0), -1 if dx else 0)
            for dy, dx in spec.offsets]
    return at(j, i), ghosts, offs, j, i


def _resident_put(buf, idx, ghosts, vals, mask):
    """Writes ``vals`` (B, ny, nx) where ``mask`` into the color arrays
    ``buf`` (B, 2 sa), with their ghosts."""
    buf[:, idx[mask]] = vals[:, mask]
    for gm, gidx in ghosts:
        m = mask & gm
        buf[:, gidx[m]] = vals[:, m]


def sor2d_sweeps_resident_emulated(spec, S, omega, n, with_norm=False,
                                   fac=None, plan=None, modes=None):
    """n sweeps as the resident kernel runs them, with torch ops: launches
    of at most ``plan.k`` sweeps (default :func:`resident_plan`), each
    loading every slice into the kernel's two color arrays with their ghost
    ring (unwritten slots hold NaN), its weight planes into their arrays,
    then for each sweep the extend pre-pass in place and two half-sweeps,
    each in the mode the kernel takes for the slice (``modes``, a list,
    gets "fast" or "exact" per slice and half-sweep): fast updates the
    active color alone, in place (raising if an active cell reads a cell
    another active cell's write changes: the ghosts wait where an odd
    size's wrap pair of one color may move); exact also turns NaN the other
    color's cells whose plain update is NaN.  Reads every neighbour through the
    kernel's offsets.  With ``with_norm`` also the per-slice total |S'| as
    the kernel's partials give it.  Equal to :func:`sor2d_sweeps_reference`
    wherever the kernel's design is right; it exists to test that."""
    ny, nx = S.shape[-2:]
    batch_shape = tuple(S.shape[:-2])
    B = max(1, S.numel() // (ny * nx))
    plan = plan or resident_plan(spec, (ny, nx), S.dtype)
    if plan is None:
        raise ValueError("the resident kernel does not take this spec")
    rs = plan.rs
    sa, wa = (ny + 2) * rs, ny * rs
    K = len(spec.offsets)
    bw, bg, bs = _RESIDENT_BOUNDS[S.element_size()]
    idx, ghosts, offs, J, I = _resident_index(spec, ny, nx, rs)
    color = (J + I) & 1
    par_of = J & 1                    # (par ^ c): the cell's column parity
    rel = relax_plane(spec, omega)

    def per_slice(p):
        return p.reshape((-1, ny, nx)).expand(B, ny, nx)
    w = spec.w.reshape((K, -1, ny, nx)).expand(K, B, ny, nx)
    w0, g, rl = per_slice(spec.w0), per_slice(spec.g), per_slice(rel)
    # the weights: the 4 of the cell at index ix of color c at
    # (c wa + ix - rs) 4 + k, 0 past K
    wsm = torch.full((B, 8 * wa), float("nan"), dtype=S.dtype)
    ix = idx - color * sa
    for k in range(4):
        wsm[:, (color * wa + ix - rs) * 4 + k] = w[k] if k < K else 0.0
    # the planes' test (the kernel's bad_w, bad_w0, bad_g, bad_rel)
    planes_bad = ((~(w.abs() <= bw)).flatten(2).any(2).any(0)
                  | (~(w0.abs() <= bw)).flatten(1).any(1)
                  | (~(g.abs() <= bg)).flatten(1).any(1)
                  | (~torch.isfinite(rl)).flatten(1).any(1))
    odd = (ny | nx) & 1
    pair = torch.zeros(ny, nx, dtype=torch.bool)
    if nx % 2:
        pair[:, 0] = pair[:, -1] = True
    if ny % 2:
        pair[0, :] = pair[-1, :] = True
    wrap_moves = (pair & (rl != 0)).flatten(1).any(1)
    periodic_x = spec.bcs[-1] == "periodic"
    erow = (J == 0) | (J == ny - 1)
    dr = torch.where(J == 0, 1, -1)
    dc = (torch.zeros_like(I) if periodic_x else
          torch.where(I == 0, 1, torch.where(I == nx - 1, -1, 0)))
    src = idx[(J + dr).clamp(0, ny - 1), (I + dc).clamp(0, nx - 1)]
    A = S.reshape(B, ny, nx)
    done = 0
    n = int(n)
    while done < n:
        m = min(plan.k, n - done)
        buf = torch.full((B, 2 * sa), float("nan"), dtype=S.dtype)
        _resident_put(buf, idx, ghosts, A, torch.ones_like(erow))
        state_bad = (~(A.abs() <= bs)).flatten(1).any(1)
        for sw in range(done, done + m):
            if spec.bcs[-2] == "extend":
                _resident_put(buf, idx, ghosts, buf[:, src], erow)
            for c in (0, 1):
                f = 1.0 if fac is None else fac[2 * sw + c]
                exact = planes_bad | state_bad | (not math.isfinite(f))
                # the active cells' ghosts wait (written after the race
                # check) where an odd wrap pair of one color may move
                defer = (exact | wrap_moves) & bool(odd)
                act = color == c
                new = torch.empty_like(A)
                reads = []
                for cc, mask in ((c, act), (1 - c, ~act)):
                    par = par_of ^ cc
                    base = cc * sa
                    acc = g
                    for k, (ob, om) in enumerate(offs):
                        nb = (1 - cc) * sa + ix + ob + (par & om)
                        if cc == c:
                            reads.append(nb[mask])
                        acc = acc + (wsm[:, (cc * wa + ix - rs) * 4 + k]
                                     * buf[:, nb])
                    sv = buf[:, base + ix]
                    out = relax_cell(sv, acc, w0, rl, float(cc == c), f)
                    new = torch.where(mask, out, new)
                old = buf[:, idx]
                turns_nan = ~act & ~(new == old)
                bad = ((act & ~(new.abs() <= bs))
                       | (turns_nan & exact[:, None, None]))
                # no active cell may read a cell another active cell's
                # in-place write (with its ghosts, unless they wait) changes
                changed = act & ~(new == old)
                hit = torch.zeros(B, 2 * sa, dtype=torch.bool)
                hit[:, idx[act]] = changed[:, act]
                for gm, gidx in ghosts:
                    mm = act & gm
                    hit[:, gidx[mm]] |= changed[:, mm] & ~defer[:, None]
                race = torch.stack([hit[:, r] for r in reads], 0).any(0)
                if bool(race.any()):
                    raise RuntimeError("an in-place half-sweep raced")
                if modes is not None:
                    modes.extend("exact" if e else "fast"
                                 for e in exact.tolist())
                upd = act | (turns_nan & exact[:, None, None])
                vals = torch.where(turns_nan, torch.full_like(new, math.nan),
                                   new)
                for b in range(B):
                    _resident_put(buf[b:b + 1], idx, ghosts,
                                  vals[b:b + 1], upd[b])
                state_bad = bad.flatten(1).any(1)
        A = buf[:, idx]
        done += m
    out = A.reshape(S.shape)
    if with_norm:
        sums = _driver.slice_totals(block_partials(A).reshape(B, -1))
        return out, sums.reshape(batch_shape)
    return out


def relax_cell(s, acc, w0, rel, sel, fac):
    """s + ((rel * sel) * fac) * (acc + w0 * s): the kernels' per-cell
    update (csrc/sor2d.cu::relax_cell) with torch ops."""
    return s + ((rel * sel) * fac) * (acc + w0 * s)


# ---------------------------------------------------------------------------
# plain versions (CPU path; on the card only tests and smoke runs call them)
# ---------------------------------------------------------------------------

def sor2d_sweeps_reference(spec, S, omega, n, fac=None):
    """n full red-black sweeps with PyTorch ops (``fac``: the 2n Chebyshev
    factors, see :func:`sor2d_sweeps`)."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    return solver.sweeps(spec, S, omega, n, fac)


def sor2d_sweeps_reference_norm(spec, S, omega, n, fac=None):
    """:func:`sor2d_sweeps_reference` plus the per-slice total |S| over the
    core cells (the fused norm output of the kernel path)."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    S = solver.sweeps(spec, S, omega, n, fac)
    return S, torch.sum(torch.abs(S), dim=(-2, -1))


# ---------------------------------------------------------------------------
# the in-place gate
# ---------------------------------------------------------------------------

def _radius1_no_cross(spec) -> bool:
    """Nearest-neighbour radius-1 stencil without cross terms (the standard
    Poisson family and every family whose cross planes prune away)."""
    return (not spec.bih
            and all(sum(1 for o in off if o != 0) == 1
                    and max(abs(o) for o in off) == 1
                    for off in spec.offsets))


def _no_cross_r1(spec) -> bool:
    """The JAX package's gate of its in-place kernel
    (``pallas_sor_window.py:_no_cross_r1``): the switch is on and the spec
    is a radius-1 stencil without cross terms.  Checked on the spec the
    sweeps get, which :func:`~xinvert_tpu_torch.solver.solve` has pruned."""
    return INPLACE_KERNEL and _radius1_no_cross(spec)


def inplace_eligible(spec, core) -> bool:
    """True when the in-place kernel computes the ping-pong one's function on
    ``spec`` over a ``core`` = (ny, nx) grid without a race: a radius-1
    stencil without cross terms, and along each periodic axis an even size
    (with an odd one the wrap joins two cells of one color, which read each
    other).  B3's VMEM size gates (ny % 8, the window plan) are TPU-only
    and not ported."""
    ny, nx = core
    odd_wrap = ((spec.bcs[-1] == "periodic" and nx % 2)
                or (spec.bcs[-2] == "periodic" and ny % 2))
    return _radius1_no_cross(spec) and not odd_wrap


def _use_inplace(spec, core) -> bool:
    return _no_cross_r1(spec) and inplace_eligible(spec, core)


# ---------------------------------------------------------------------------
# the extend fold (``pallas_sor_window.py:_extend_foldable``/``_fold_extend``):
# a spec transform, used by ops/implicit.py; no sweep of the port folds
# (the JAX package's FOLD_EXTEND is off, and is not ported)
# ---------------------------------------------------------------------------

def _extend_foldable(spec) -> bool:
    """(extend, periodic) nearest-neighbour radius-1 specs can fold the
    extend rows' copies into the weights (see :func:`_fold_extend`)."""
    return (spec.bcs[-2] == "extend" and spec.bcs[-1] == "periodic"
            and _radius1_no_cross(spec))


def _fold_extend(spec):
    """Fold the extend pre-pass into the stencil: the rows next to the y
    boundary absorb their boundary-pointing weight into w0.

    With periodic x and no cross couplings, the extend copy makes
    S[0, i] == S[1, i] at the start of every iteration, and row 1's own
    value is unchanged within the half-sweep that reads it, so reading
    S[0, i] is reading S[1, i]: row 1's south weight belongs on its
    diagonal (and row ny-2's north weight on its).  The boundary rows are
    made inert (relax 0) and the folded spec's bcs drop to
    ('fixed', 'periodic'); the fixed point is the same once the extension
    is applied to the result.  Torch ops on clones, so gradients flow
    through the fold."""
    offs = {tuple(o): i for i, o in enumerate(spec.offsets)}
    iS, iN = offs[(-1, 0)], offs[(1, 0)]
    w, w0, relax = spec.w.clone(), spec.w0.clone(), spec.relax.clone()
    w0[..., 1, :] = w0[..., 1, :] + spec.w[iS][..., 1, :]
    w0[..., -2, :] = w0[..., -2, :] + spec.w[iN][..., -2, :]
    w[iS, ..., 1, :] = 0.0
    w[iN, ..., -2, :] = 0.0
    relax[..., 0, :] = 0.0
    relax[..., -1, :] = 0.0
    return dataclasses.replace(spec, w=w, w0=w0, relax=relax,
                               bcs=spec.bcs[:-2] + ("fixed", spec.bcs[-1]))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _layout(spec, S, rel=None):
    """Validate (spec, S[, rel]) for the kernels; return the launch layout
    (building the kernels on first use)."""
    lay = _driver.check_planes("sor2d", spec, S, rel, 2, MAX_K)
    ny, nx = lay["core"]
    nmin = 5 if spec.bih else 3
    if ny < nmin or nx < nmin:
        raise ValueError(f"grid {ny}x{nx} is below the {nmin}x{nmin} "
                         "the kernels take")
    if lay["B"] < 1:
        raise ValueError("an empty batch; the kernels take one slice or more")
    from ._build import load
    lib = load("sor2d")
    sfx = "f32" if S.dtype == torch.float32 else "f64"
    lay.update(ny=ny, nx=nx,
               dy=(ctypes.c_int * MAX_K)(*[o[0] for o in spec.offsets]),
               dx=(ctypes.c_int * MAX_K)(*[o[1] for o in spec.offsets]),
               n_partials=lib.sor2d_partials_per_slice(ny, nx),
               tiled_fn=getattr(lib, f"sor2d_sweeps_tiled_{sfx}"),
               resident_fn=getattr(lib, f"sor2d_sweeps_resident_{sfx}"),
               block_fn=getattr(lib, f"sor2d_sweeps_block_{sfx}"))
    return lay


class _TiledParams(ctypes.Structure):
    """csrc/sor2d.cu::TiledParams, field by field."""
    _fields_ = ([(f, ctypes.c_int) for f in (
        "B", "ny", "nx", "K", "nsweeps", "ty", "tx", "hy", "hx", "winy",
        "winx", "pad", "tiles_y", "tiles_x", "spb", "extend", "periodic_x",
        "bih", "kmax", "cpt", "nt", "inplace", "wsmem", "stage", "oy", "ox",
        "by", "bx", "gy", "gx", "buf_y", "buf_x")]
                + [("dy", ctypes.c_int * MAX_K), ("dx", ctypes.c_int * MAX_K)]
                + [(f, ctypes.c_longlong) for f in (
                    "w_kstride", "w_bstride", "w0_bstride", "g_bstride",
                    "rel_bstride")]
                + [("fac", ctypes.c_double * (2 * MAX_TILED_SWEEPS))])


def _slices_per_block(lay, plan, S, core=None):
    """Batch slices each block walks: one where no plane is shared; where
    the batch shares a plane (its coefficients then stay in registers from
    slice to slice), as many as leave two blocks per SM to go round.
    ``core``: the cells the tiles cover (the owned region of a block).
    The launch's grid z, ceil(B / spb), stays at or under the grid's
    65 535 in both branches: ceil(B / 65535) slices a block bound it in
    the first, and at most 2 x SMs groups in the second.  Slice offsets
    are 64-bit in the kernel; a slice's plane must stay under 2^31
    cells."""
    B = lay["B"]
    if B == 1 or all(lay[f"{p}_bstride"] for p in ("w", "w0", "g", "relax")):
        return max(1, -(-B // _MAX_GRID_Z))
    if "sms" not in lay:
        lay["sms"] = torch.cuda.get_device_properties(
            S.device).multi_processor_count
    tiles = math.prod(plan.tiles(core or lay["core"]))
    groups = min(B, max(1, -(-2 * lay["sms"] // tiles)))
    return -(-B // groups)


def _launch_tiled(spec, lay, plan, rel, S_in, S_out, n, fac, partials=None):
    """sor2d_sweeps_tiled (or its in-place twin, as ``plan.inplace`` says):
    S_out = n sweeps of S_in in one launch, ``fac`` its 2n factors; the
    slice walk pipelined where :func:`tiled_slices` stages any window."""
    global TILED_LAUNCHES, TILED_INPLACE_LAUNCHES, TILED_WINDOW_CELLS
    global TILED_CELLS, TILED_SLICES, TILED_STAGED_SLICES
    ny, nx = lay["core"]
    tiles_y, tiles_x = plan.tiles(lay["core"])
    spb = _slices_per_block(lay, plan, S_in)
    staged, slices = tiled_slices(plan, lay["B"], spb, lay["core"])
    p = _TiledParams(
        B=lay["B"], ny=ny, nx=nx, K=lay["K"], nsweeps=int(n), ty=plan.ty,
        tx=plan.tx, hy=plan.hy, hx=plan.hx, winy=plan.winy, winx=plan.winx,
        pad=plan.pad, tiles_y=tiles_y, tiles_x=tiles_x, spb=spb,
        extend=int(spec.bcs[-2] == "extend"),
        periodic_x=int(spec.bcs[-1] == "periodic"), bih=int(spec.bih),
        kmax=plan.kmax, cpt=plan.cpt, nt=plan.threads, wsmem=plan.wsmem,
        inplace=int(plan.inplace), stage=int(staged > 0), dy=lay["dy"],
        dx=lay["dx"],
        w_kstride=lay["w_kstride"], w_bstride=lay["w_bstride"],
        w0_bstride=lay["w0_bstride"], g_bstride=lay["g_bstride"],
        rel_bstride=lay["relax_bstride"], by=ny, bx=nx, buf_y=ny, buf_x=nx)
    p.fac[:2 * int(n)] = [float(f) for f in fac]
    err = lay["tiled_fn"](S_in.data_ptr(), S_out.data_ptr(),
                          spec.w.data_ptr(), spec.w0.data_ptr(),
                          spec.g.data_ptr(), rel.data_ptr(),
                          None if partials is None else partials.data_ptr(),
                          ctypes.byref(p), lay["stream"])
    name = "sor2d_sweeps_tiled"
    if plan.inplace:
        TILED_INPLACE_LAUNCHES += 1
        name += "_inplace"
    else:
        TILED_LAUNCHES += 1
    window, cells = tiled_cells(plan, lay["B"], lay["core"])
    TILED_WINDOW_CELLS += window
    TILED_CELLS += cells
    TILED_SLICES += slices
    TILED_STAGED_SLICES += staged
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


class _ResidentParams(ctypes.Structure):
    """csrc/sor2d.cu::ResidentParams, field by field."""
    _fields_ = ([(f, ctypes.c_int) for f in (
        "B", "ny", "nx", "K", "nsweeps", "rs", "extend", "periodic_x",
        "cpt", "nt")]
                + [("dy", ctypes.c_int * MAX_K), ("dx", ctypes.c_int * MAX_K)]
                + [(f, ctypes.c_longlong) for f in (
                    "w_kstride", "w_bstride", "w0_bstride", "g_bstride",
                    "rel_bstride")]
                + [("fac", ctypes.c_double * (2 * MAX_RESIDENT_SWEEPS))])


def _launch_resident(spec, lay, plan, rel, S, n, fac, partials=None):
    """sor2d_sweeps_resident: n sweeps of S in place in one launch, ``fac``
    its 2n factors."""
    global RESIDENT_LAUNCHES
    ny, nx = lay["core"]
    p = _ResidentParams(
        B=lay["B"], ny=ny, nx=nx, K=lay["K"], nsweeps=int(n), rs=plan.rs,
        extend=int(spec.bcs[-2] == "extend"),
        periodic_x=int(spec.bcs[-1] == "periodic"), cpt=plan.cpt,
        nt=plan.threads,
        dy=lay["dy"], dx=lay["dx"], w_kstride=lay["w_kstride"],
        w_bstride=lay["w_bstride"], w0_bstride=lay["w0_bstride"],
        g_bstride=lay["g_bstride"], rel_bstride=lay["relax_bstride"])
    p.fac[:2 * int(n)] = [float(f) for f in fac]
    err = lay["resident_fn"](S.data_ptr(), spec.w.data_ptr(),
                             spec.w0.data_ptr(), spec.g.data_ptr(),
                             rel.data_ptr(),
                             None if partials is None else partials.data_ptr(),
                             ctypes.byref(p), lay["stream"])
    RESIDENT_LAUNCHES += 1
    if err:
        raise RuntimeError(f"sor2d_sweeps_resident launch failed: CUDA "
                           f"error {err}")


def _sweeps(spec, S, omega, n, with_norm, fac, resident=None,
            inplace=False):
    """n sweeps through the resident kernel with the plan ``resident``,
    else through the tiled kernel (``inplace``: its in-place twin):
    ceil(n / k) launches of the plan, each taking its slice of the factors,
    the last one also the |S| partials.  The resident kernel sweeps one
    buffer in place; the tiled kernels write a second, and the two swap
    between launches.  CPU tensors take the plain version."""
    n = _driver._check_sweeps(n, with_norm, fac)
    if S.device.type == "cpu":
        if with_norm:
            return sor2d_sweeps_reference_norm(spec, S, omega, n, fac)
        return sor2d_sweeps_reference(spec, S, omega, n, fac)
    rel = relax_plane(spec, omega)
    lay = _layout(spec, S, rel)
    plan = (resident if resident is not None
            else tile_plan(spec, lay["core"], S.dtype, inplace))
    A = _driver._buffer(S, lay)
    Bf = None if resident is not None else torch.empty_like(A)
    partials = _driver._partials(S, lay, with_norm)
    done = 0
    with torch.cuda.device(S.device):
        while done < n:
            m = min(plan.k, n - done)
            f = [1.0] * (2 * m) if fac is None else fac[2 * done:
                                                        2 * (done + m)]
            last = partials if done + m == n else None
            if resident is not None:
                _launch_resident(spec, lay, plan, rel, A, m, f, last)
            else:
                _launch_tiled(spec, lay, plan, rel, A, Bf, m, f, last)
                A, Bf = Bf, A
            done += m
    return _driver._result(A, S, lay, partials)


def sor2d_sweeps(spec, S, omega, n, with_norm=False, fac=None):
    """n full red-black sweeps (extend pre-pass when the y boundary is
    'extend', then red, then black) of ``spec`` on ``S``: through the
    resident kernel, ceil(n / 64) launches, where :func:`resident_plan`
    takes (spec, slice shape, dtype); else through the tiled kernels,
    ceil(n / k) launches of the spec's :func:`tile_plan`.

    With ``with_norm`` returns ``(S', sumabs)``, sumabs being the per-slice
    total |S'| over the core cells, which the last launch sums per tile as
    it writes S' (n >= 1 then).  ``fac`` (cyclic Chebyshev,
    :func:`~xinvert_tpu_torch.solver.solve_fixed_cheby`) holds 2n factors in
    the state's dtype, one per half-sweep, each scaling ``omega * relax``.
    Of the specs the resident kernel does not take, with ``INPLACE_KERNEL``
    set, a spec that :func:`_no_cross_r1` and :func:`inplace_eligible` take
    runs the in-place tiled kernel; any other runs the ping-pong one.  CPU
    tensors take the plain version.
    """
    core = tuple(S.shape[-2:])
    return _sweeps(spec, S, omega, n, with_norm, fac,
                   resident_plan(spec, core, S.dtype),
                   _use_inplace(spec, core))


def sor2d_sweeps_resident(spec, S, omega, n, with_norm=False, fac=None):
    """:func:`sor2d_sweeps` through the resident kernel; a spec or slice
    that :func:`resident_plan` refuses raises.  CPU tensors take the plain
    version."""
    plan = resident_plan(spec, tuple(S.shape[-2:]), S.dtype)
    if S.device.type != "cpu" and plan is None:
        raise ValueError("the resident kernel takes radius-1 stencils "
                         "without cross terms on slices that fit one SM")
    return _sweeps(spec, S, omega, n, with_norm, fac, plan)


def sor2d_sweeps_tiled(spec, S, omega, n, with_norm=False, fac=None):
    """:func:`sor2d_sweeps` through the ping-pong tiled kernel, whatever
    ``INPLACE_KERNEL`` says.  CPU tensors take the plain version."""
    return _sweeps(spec, S, omega, n, with_norm, fac)


def sor2d_sweeps_tiled_inplace(spec, S, omega, n, with_norm=False, fac=None):
    """:func:`sor2d_sweeps` through the in-place tiled kernel, whatever
    ``INPLACE_KERNEL`` says; a spec that :func:`inplace_eligible` refuses
    raises.  CPU tensors take the plain version."""
    if S.device.type != "cpu" and not inplace_eligible(
            spec, tuple(S.shape[-2:])):
        raise ValueError("the in-place kernel takes radius-1 stencils "
                         "without cross terms and an even size along a "
                         "periodic axis")
    return _sweeps(spec, S, omega, n, with_norm, fac, inplace=True)


# ---------------------------------------------------------------------------
# B2s: the tiled kernel on one ghost-padded block of a decomposition
# (xinvert_tpu/ops/pallas_sor_window.py::_kernel with its block arguments,
# called by xinvert_tpu/parallel/halo_window.py:292 _device_step); the
# executor is xinvert_tpu_torch.parallel.halo
# ---------------------------------------------------------------------------

def block_geometry(padded, origin, shape, ghosts):
    """The owned extents (by, bx) of a block whose padded core is
    ``padded`` = (by + 2gy, bx + 2gx), owned origin ``origin`` = (oy, ox)
    in a global ``shape`` = (ny, nx), ``ghosts`` = (gy, gx); raises on a
    geometry the kernel does not take.  An axis without ghosts is the whole
    axis (origin 0); one with ghosts holds at most the axis, and fewer than
    the axis's cells on each side."""
    owned = []
    for b2, o, n, g in zip(padded, origin, shape, ghosts):
        b = b2 - 2 * g
        ok = (b >= 1 and o >= 0 and o + b <= n and 0 <= g < n
              and (g > 0 or (o == 0 and b == n)))
        if not ok:
            raise ValueError(
                f"block of {b2} padded cells with {g} ghosts at origin {o} "
                f"does not fit an axis of {n} (an axis without ghosts must "
                "be the whole axis)")
        owned.append(b)
    return tuple(owned)


def _block_coords(padded, origin, shape, ghosts, device=None):
    """Each buffer cell's global (R, C), wrapped, as (py, px) tensors."""
    R = torch.remainder(torch.arange(padded[0], device=device)
                        + origin[0] - ghosts[0], shape[0])
    C = torch.remainder(torch.arange(padded[1], device=device)
                        + origin[1] - ghosts[1], shape[1])
    return (R[:, None].expand(padded), C[None, :].expand(padded))


def block_partials(own):
    """|S| sums over the 32 x 8 blocks of ``own`` (..., by, bx), as
    (B, ceil(by/8), ceil(bx/32)), in the kernels' order: each row of 32
    cells by the warp's shuffle tree (halves added pairwise), then the 8 row
    sums in turn; cells past the edge add +0.  For a block whose origin is a
    multiple of (8, 32) these are the whole grid's partials at the block."""
    by, bx = own.shape[-2:]
    a = own.reshape((-1, by, bx))
    a = torch.where(a < 0, -a, a)
    a = torch.nn.functional.pad(a, (0, -bx % 32, 0, -by % 8))
    a = a.reshape(a.shape[0], a.shape[1] // 8, 8, a.shape[2] // 32, 32)
    for h in (16, 8, 4, 2, 1):
        a = a[..., :h] + a[..., h:2 * h]
    rows = a[..., 0]
    t = rows[:, :, 0]
    for r in range(1, 8):
        t = t + rows[:, :, r]
    return t


def sor2d_sweeps_block_reference(spec, P, omega, n, origin, shape, ghosts,
                                 fac=None, with_norm=False):
    """The block kernel's plain version: n sweeps of the ghost-padded block
    ``P`` (..., by + 2gy, bx + 2gx) with torch ops, the spec's planes cut to
    the same padded block; parity, the extend pre-pass and its corner
    clamps from each cell's global (R, C) (:func:`_window_sweeps`).
    Returns the owned cells (..., by, bx), and with ``with_norm`` also
    their :func:`block_partials`."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    padded = tuple(P.shape[-2:])
    by, bx = block_geometry(padded, origin, shape, ghosts)
    gy, gx = ghosts
    R, C = _block_coords(padded, origin, shape, ghosts, P.device)
    rel = relax_plane(spec, omega)
    win = _window_sweeps(spec, P, (spec.w, spec.w0, spec.g, rel), R, C,
                         shape[0], shape[1], int(n), fac)
    own = win[..., gy:gy + by, gx:gx + bx]
    if with_norm:
        return own, block_partials(own)
    return own


def make_block_sweeper(spec, P, omega, origin, shape, ghosts, k):
    """A function ``sweep(A, out, n, fac=None, with_norm=False)`` for
    blocks shaped like ``P`` with ``spec``'s padded planes: n <= k sweeps
    of the padded state A, whose owned cells it writes into the owned
    region of the padded buffer ``out`` (ghosts untouched), returning
    (out, partials or None).  On CUDA tensors one launch of
    ``sor2d_sweeps_block`` (the layout, the tile plan of k sweeps on the
    owned cells and the launch parameters built here, once); on CPU tensors
    the plain version.  The ghosts must cover k sweeps' cone on every axis
    that has them."""
    padded = tuple(P.shape[-2:])
    by, bx = block_geometry(padded, origin, shape, ghosts)
    gy, gx = ghosts
    k = int(k)
    if P.device.type == "cpu":
        def sweep(A, out, n, fac=None, with_norm=False):
            res = sor2d_sweeps_block_reference(spec, A, omega, n, origin,
                                               shape, ghosts, fac, with_norm)
            own, part = res if with_norm else (res, None)
            out[..., gy:gy + by, gx:gx + bx] = own
            return out, part
        return sweep
    rel = relax_plane(spec, omega)
    lay = _layout(spec, P, rel)
    plan = tile_plan(spec, (by, bx), P.dtype, k=k)
    if (gy and plan.hy > gy) or (gx and plan.hx > gx):
        raise ValueError(f"ghosts {ghosts} do not cover {k} sweeps (halo "
                         f"{plan.hy}x{plan.hx})")
    tiles_y, tiles_x = plan.tiles((by, bx))
    params = _TiledParams(
        B=lay["B"], ny=shape[0], nx=shape[1], K=lay["K"], ty=plan.ty,
        tx=plan.tx, hy=plan.hy, hx=plan.hx, winy=plan.winy, winx=plan.winx,
        pad=plan.pad, tiles_y=tiles_y, tiles_x=tiles_x,
        spb=_slices_per_block(lay, plan, P, (by, bx)),
        extend=int(spec.bcs[-2] == "extend"),
        periodic_x=int(spec.bcs[-1] == "periodic"), bih=int(spec.bih),
        kmax=plan.kmax, cpt=plan.cpt, nt=plan.threads, wsmem=plan.wsmem,
        inplace=0, dy=lay["dy"], dx=lay["dx"], w_kstride=lay["w_kstride"],
        w_bstride=lay["w_bstride"], w0_bstride=lay["w0_bstride"],
        g_bstride=lay["g_bstride"], rel_bstride=lay["relax_bstride"],
        oy=origin[0], ox=origin[1], by=by, bx=bx, gy=gy, gx=gx,
        buf_y=padded[0], buf_x=padded[1])
    ptrs = (spec.w.data_ptr(), spec.w0.data_ptr(), spec.g.data_ptr(),
            rel.data_ptr())
    pshape = (lay["B"], -(-by // 8), -(-bx // 32))

    def sweep(A, out, n, fac=None, with_norm=False):
        global BLOCK_LAUNCHES
        n = int(n)
        if not 1 <= n <= k:
            raise ValueError(f"{n} sweeps; this block takes 1..{k}")
        params.nsweeps = n
        params.fac[:2 * n] = ([1.0] * (2 * n) if fac is None
                              else [float(f) for f in fac])
        part = (torch.empty(pshape, dtype=A.dtype, device=A.device)
                if with_norm else None)
        # the launch goes to the block's device stream: that device must be
        # current (a mesh's blocks may sit on several cards)
        with torch.cuda.device(A.device):
            err = lay["block_fn"](A.data_ptr(), out.data_ptr(), *ptrs,
                                  None if part is None else part.data_ptr(),
                                  ctypes.byref(params), lay["stream"])
        BLOCK_LAUNCHES += 1
        if err:
            raise RuntimeError(f"sor2d_sweeps_block launch failed: CUDA "
                               f"error {err}")
        return out, part
    sweep.rel = rel        # the launch reads it: keep it alive
    return sweep


def sor2d_sweeps_block(spec, P, omega, n, origin, shape, ghosts,
                       with_norm=False, fac=None):
    """n (<= 8) sweeps of one ghost-padded block ``P`` (..., by + 2gy,
    bx + 2gx), in one launch of the block kernel (B2s): ``spec``'s planes
    are the block's padded planes, ``origin`` = (oy, ox) the global origin
    of its owned cells, ``shape`` = (ny, nx) the whole grid, ``ghosts`` =
    (gy, gx) the ghost widths (0 on an axis the block spans whole), which
    must cover n sweeps' cone.  Returns the owned cells (..., by, bx), and
    with ``with_norm`` also their |S| partials (B, ceil(by/8), ceil(bx/32)),
    the whole grid's where the origin is a multiple of (8, 32).  ``fac``:
    2n Chebyshev factors.  CPU tensors take the plain version."""
    if P.device.type == "cpu":
        return sor2d_sweeps_block_reference(spec, P, omega, n, origin, shape,
                                            ghosts, fac, with_norm)
    sweep = make_block_sweeper(spec, P, omega, origin, shape, ghosts, n)
    A = _driver._buffer(P, {"B": math.prod(P.shape[:-2]),
                            "core": tuple(P.shape[-2:])})
    out = torch.empty_like(A)
    _, part = sweep(A, out, n, fac, with_norm)
    gy, gx = ghosts
    py, px = P.shape[-2:]
    own = out.reshape(P.shape)[..., gy:py - gy, gx:px - gx]
    return (own, part) if with_norm else own
