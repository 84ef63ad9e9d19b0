# -*- coding: utf-8 -*-
"""Red-black SOR sweeps of a 3-D stencil: CUDA kernels and plain versions.

The kernels (``csrc/sor3d.cu``) replace the two TPU kernels of the 3-D path,
``xinvert_tpu/ops/pallas_sor3d.py::_kernel`` and
``xinvert_tpu/ops/pallas_sor3d_window.py::_kernel`` (its direct and z<->y
permuted layouts); the source says how.  Each kernel has a wrapper here and
a plain PyTorch version built from :mod:`xinvert_tpu_torch.solver`'s sweep
pieces:

=====================  ==========================  ==============================
kernel                 wrapper                     plain version
=====================  ==========================  ==============================
``sor3d_color_sweep``  :func:`sor3d_color_sweep`   :func:`sor3d_color_sweep_reference`
n sweeps               :func:`sor3d_sweeps`        :func:`sor3d_sweeps_reference`,
                                                   :func:`sor3d_sweeps_reference_norm`
=====================  ==========================  ==============================

A sweep is two launches of ``sor3d_color_sweep``, the red one with the
extend pre-pass folded in (:func:`sor3d_sweeps`, the solver's executor).
:func:`sor3d_color_sweep_emulated` replays the folded launch's reads with
torch ops on the CPU (tests only).

B5s (the pallas ``_kernel``'s block arguments) sweeps one ghost-padded block
of a decomposition for the multi-device executor
(:mod:`xinvert_tpu_torch.parallel.halo`) in a kernel of its own,
``sor3d_block_sweep`` (a z-march over tiles classed on the host by
:func:`block_plan`): wrapper :func:`sor3d_color_sweep_block`, n sweeps
:func:`make_block_sweeper`, plain version
:func:`sor3d_color_sweep_block_reference`;
:func:`sor3d_color_sweep_block_emulated` replays the plan's tile classes
with torch ops on the CPU (tests only).

A wrapper launches its kernel for CUDA tensors and takes the plain version
only for CPU tensors; any other input raises.  ``LAUNCHES`` and
``BLOCK_LAUNCHES`` count kernel launches, ``PLAIN_CALLS`` calls of the
plain versions, so a run can show which path it took.  No function here
changes the caller's tensors: the kernels work on buffers the wrappers
allocate.
"""
from __future__ import annotations

import ctypes

import torch

from .. import solver
from . import _driver
from ._driver import relax_plane

__all__ = ["sor3d_sweeps", "sor3d_sweeps_reference",
           "sor3d_sweeps_reference_norm", "sor3d_color_sweep",
           "sor3d_color_sweep_reference", "sor3d_color_sweep_emulated",
           "sor3d_color_sweep_block", "sor3d_color_sweep_block_reference",
           "sor3d_color_sweep_block_emulated", "block_plan",
           "make_block_sweeper", "relax_plane", "MAX_K"]

MAX_K = 8            # offsets the kernels take (csrc SOR3D_MAX_K)

LAUNCHES = 0         # sor3d_color_sweep kernel launches
BLOCK_LAUNCHES = 0   # sor3d_block_sweep kernel launches (B5s)
PLAIN_CALLS = 0      # calls of the plain versions

_CORE = (-3, -2, -1)


# ---------------------------------------------------------------------------
# plain versions (CPU path; on the card only tests and smoke runs call them)
# ---------------------------------------------------------------------------

def sor3d_sweeps_reference(spec, S, omega, n, fac=None):
    """n full red-black sweeps with PyTorch ops (``fac``: the 2n Chebyshev
    factors, see :func:`sor3d_sweeps`)."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    return solver.sweeps(spec, S, omega, n, fac)


def sor3d_sweeps_reference_norm(spec, S, omega, n, fac=None):
    """:func:`sor3d_sweeps_reference` plus the per-slice total |S| over the
    core cells (the fused norm output of the kernel path)."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    S = solver.sweeps(spec, S, omega, n, fac)
    return S, torch.sum(torch.abs(S), dim=_CORE)


def sor3d_color_sweep_reference(spec, S, rel, color, fac=1.0, extend=False):
    """One half-sweep of ``color`` (0 red, 1 black) with PyTorch ops;
    ``rel`` is :func:`relax_plane`, scaled by ``fac``; ``extend``: the
    extend pre-pass first."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    if extend:
        S = solver._apply_extend(spec, S)
    red = solver._checkerboard(S.shape[-3:], S.dtype, S.device)
    sel = red if color == 0 else 1.0 - red
    return solver._half_sweep(spec, S, fac * (rel * sel))


def extend_source(spec, core, device=None):
    """The folded launch's read map over a core volume, as the kernel
    computes it (``extend_src`` in csrc/sor3d.cu): for each cell (l, j, i),
    the flat index of the cell whose value the extend pre-pass leaves
    there.  The identity unless the y boundary is 'extend'."""
    nz, ny, nx = core
    l = torch.arange(nz, device=device)[:, None, None]
    j = torch.arange(ny, device=device)[None, :, None]
    i = torch.arange(nx, device=device)[None, None, :]
    l, j, i = torch.broadcast_tensors(l, j, i)
    if spec.bcs[-2] == "extend":
        hit = (l >= 1) & (l <= nz - 2) & ((j == 0) | (j == ny - 1))
        if spec.bcs[-1] != "periodic":
            i = torch.where(hit, i.clamp(1, nx - 2), i)
        j = torch.where(hit & (j == 0), 1, torch.where(hit, ny - 2, j))
    return (l * ny + j) * nx + i


def sor3d_color_sweep_emulated(spec, S, rel, color, fac=1.0):
    """The flagged launch's half-sweep replayed with torch ops on the CPU:
    each state value read by index, its own cell's and each neighbour's
    after the wrap, through :func:`extend_source`, and the kernel's
    arithmetic in its order.  Tests hold it against
    :func:`sor3d_color_sweep_reference` with ``extend`` (tests only)."""
    core = tuple(S.shape[-3:])
    src = extend_source(spec, core, S.device)
    flat = S.reshape(S.shape[:-3] + (-1,))

    def at(index):
        return flat[..., index.reshape(-1)].reshape(S.shape)

    acc = spec.g
    for k, off in enumerate(spec.offsets):
        # the cell (l, j, i) reads src[wrap(l + dz), wrap(j + dy), wrap(i + dx)]
        acc = acc + spec.w[k] * at(torch.roll(src, tuple(-o for o in off),
                                              (0, 1, 2)))
    s = at(src)
    red = solver._checkerboard(core, S.dtype, S.device)
    sel = red if color == 0 else 1.0 - red
    return s + ((rel * sel) * fac) * (acc + spec.w0 * s)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _layout(spec, S, rel=None):
    """Validate (spec, S[, rel]) for the kernels; return the launch layout
    (building the kernels on first use)."""
    lay = _driver.check_planes("sor3d", spec, S, rel, 3, MAX_K)
    nz, ny, nx = lay["core"]
    if spec.bih:
        raise NotImplementedError("the sor3d kernels take one-ring stencils; "
                                  "no 3-D family is biharmonic")
    if min(lay["core"]) < 3:
        raise ValueError(f"volume {nz}x{ny}x{nx} is below the 3x3x3 the "
                         "kernels take")
    if lay["B"] < 1:
        raise ValueError("an empty batch; the kernels take one slice or more")
    from ._build import load
    lib = load("sor3d")
    sfx = "f32" if S.dtype == torch.float32 else "f64"
    offs = [(ctypes.c_int * MAX_K)(*[o[a] for o in spec.offsets])
            for a in range(3)]
    lay.update(nz=nz, ny=ny, nx=nx, dz=offs[0], dy=offs[1], dx=offs[2],
               n_partials=lib.sor3d_partials_per_slice(nz, ny, nx),
               sweep_fn=getattr(lib, f"sor3d_color_sweep_{sfx}"),
               block_fn=getattr(lib, f"sor3d_block_sweep_{sfx}"))
    return lay


def _launch_color_sweep(spec, lay, rel, S_in, S_out, color, fac=1.0,
                        partials=None, extend=False):
    """sor3d_color_sweep: S_out = half-sweep ``color`` of S_in (with
    ``extend``, of S_in after the extend pre-pass, read through it)."""
    global LAUNCHES
    err = lay["sweep_fn"](
        S_in.data_ptr(), S_out.data_ptr(), spec.w.data_ptr(),
        spec.w0.data_ptr(), spec.g.data_ptr(), rel.data_ptr(),
        None if partials is None else partials.data_ptr(),
        lay["B"], lay["nz"], lay["ny"], lay["nx"], lay["K"],
        ctypes.addressof(lay["dz"]), ctypes.addressof(lay["dy"]),
        ctypes.addressof(lay["dx"]),
        lay["w_kstride"], lay["w_bstride"], lay["w0_bstride"],
        lay["g_bstride"], lay["relax_bstride"], int(color),
        int(extend and spec.bcs[-2] == "extend"),
        int(spec.bcs[-1] == "periodic"), float(fac), lay["stream"])
    LAUNCHES += 1
    if err:
        raise RuntimeError(f"sor3d_color_sweep launch failed: CUDA error "
                           f"{err}")


def sor3d_sweeps(spec, S, omega, n, with_norm=False, fac=None):
    """n full red-black sweeps (extend pre-pass when the y boundary is
    'extend', then red, then black) of ``spec`` on ``S``: two launches a
    sweep, the pre-pass folded into the red one, on two buffers that
    ping-pong.

    With ``with_norm`` returns ``(S', sumabs)``, sumabs being the per-slice
    total |S'| over the core cells, which the last black half-sweep sums
    per block as it writes S' (n >= 1 then).  ``fac`` (cyclic Chebyshev)
    holds 2n factors in the state's dtype, one per half-sweep, each scaling
    ``omega * relax``.  CPU tensors take the plain version.
    """
    n = _driver._check_sweeps(n, with_norm, fac)
    if S.device.type == "cpu":
        if with_norm:
            return sor3d_sweeps_reference_norm(spec, S, omega, n, fac)
        return sor3d_sweeps_reference(spec, S, omega, n, fac)
    rel = relax_plane(spec, omega)
    lay = _layout(spec, S, rel)
    A = _driver._buffer(S, lay)
    Bf = torch.empty_like(A)
    partials = _driver._partials(S, lay, with_norm)
    extend = spec.bcs[-2] == "extend"
    with torch.cuda.device(S.device):
        for it in range(n):
            f_red, f_black = (1.0, 1.0) if fac is None else fac[2 * it:
                                                                 2 * it + 2]
            _launch_color_sweep(spec, lay, rel, A, Bf, 0, f_red,
                                extend=extend)
            _launch_color_sweep(spec, lay, rel, Bf, A, 1, f_black,
                                partials if it == n - 1 else None)
    return _driver._result(A, S, lay, partials)


def sor3d_color_sweep(spec, S, rel, color, fac=1.0, extend=False):
    """One half-sweep of ``color`` (0 red, 1 black) into a new tensor
    (one kernel launch); ``rel`` is :func:`relax_plane`, scaled by
    ``fac``; ``extend``: of S after the extend pre-pass, folded into the
    launch.  CPU tensors take the plain version."""
    if S.device.type == "cpu":
        return sor3d_color_sweep_reference(spec, S, rel, color, fac, extend)
    if color not in (0, 1):
        raise ValueError(f"color must be 0 or 1, got {color}")
    lay = _layout(spec, S, rel)
    S_in = S if S.is_contiguous() else S.contiguous()
    out = torch.empty((lay["B"],) + lay["core"], dtype=S.dtype,
                      device=S.device)
    with torch.cuda.device(S.device):
        _launch_color_sweep(spec, lay, rel, S_in, out, color, fac,
                            extend=extend)
    return out.reshape(S.shape)


# ---------------------------------------------------------------------------
# B5s: the color sweep on one ghost-padded block of a (y, x) decomposition
# (xinvert_tpu/ops/pallas_sor3d_window.py::_kernel with its block
# arguments, called by xinvert_tpu/parallel/halo_window3d.py:205
# _device_step3); the executor is xinvert_tpu_torch.parallel.halo
# ---------------------------------------------------------------------------

def _ry(spec):
    return max((abs(o[1]) for o in spec.offsets), default=0)


def sor3d_color_sweep_block_reference(spec, P, rel, color, origin, shape,
                                      ghosts, fac=1.0, extend=False,
                                      with_norm=False):
    """The block kernel's plain version: one half-sweep of ``color`` of the
    ghost-padded block ``P`` (..., nz, by + 2gy, bx + 2gx) with torch ops,
    every cell of the buffer, each read as the kernel makes it: wrapped
    inside the buffer, and, with ``extend`` and a cell whose global row is
    within the offsets' y reach of row 0 or ny - 1, through the extend map
    on global coordinates (moving inside the buffer only); parity
    (l + R + C) & 1 on the global (R, C).  ``spec``'s planes are the
    block's padded planes, ``rel`` the padded :func:`relax_plane`.  Returns
    the new buffer, and with ``with_norm`` also the |S| partials of its
    owned cells (B, nz, ceil(by/8), ceil(bx/32))."""
    from .sor2d import _block_coords, block_geometry, block_partials
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    nz, py, px = P.shape[-3:]
    ny, nx = shape
    by, bx = block_geometry((py, px), origin, shape, ghosts)
    gy, gx = ghosts
    dev = P.device
    R, C = (t[None] for t in _block_coords((py, px), origin, shape, ghosts,
                                            dev))
    lv = torch.arange(nz, device=dev)[:, None, None]
    idx = torch.arange(nz * py * px, device=dev).reshape(nz, py, px)
    flat = P.reshape(P.shape[:-3] + (-1,))

    def at(index):
        return flat[..., index.reshape(-1)].reshape(P.shape)

    mapped = extend and spec.bcs[-2] == "extend"
    if mapped:
        # the extend map as a read over the buffer (csrc extend_src)
        hit = ((lv >= 1) & (lv <= nz - 2) & ((R == 0) | (R == ny - 1))
               ).expand(nz, py, px)
        jj = torch.arange(py, device=dev)[None, :, None] + torch.where(
            R == 0, 1, -1)
        ii = torch.arange(px, device=dev)[None, None, :].expand(nz, py, px)
        if spec.bcs[-1] != "periodic":
            ii = ii + torch.where(C == 0, 1, torch.where(C == nx - 1, -1, 0))
        ok = hit & (jj >= 0) & (jj < py) & (ii >= 0) & (ii < px)
        src = torch.where(ok, (lv * py + jj.clamp(0, py - 1)) * px
                          + ii.clamp(0, px - 1), idx)
        ry = _ry(spec)
        near = ((R <= ry) | (R >= ny - 1 - ry)).expand(nz, py, px)
    acc = spec.g
    for k, off in enumerate(spec.offsets):
        nb = torch.roll(idx, tuple(-o for o in off), (0, 1, 2))
        if mapped:
            nb = torch.where(near, src.reshape(-1)[nb], nb)
        acc = acc + spec.w[k] * at(nb)
    s = at(torch.where(near, src, idx)) if mapped else P
    sel = ((lv + R + C) % 2 == color).to(P.dtype)
    out = s + ((rel * sel) * fac) * (acc + spec.w0 * s)
    if with_norm:
        part = block_partials(out[..., gy:gy + by, gx:gx + bx])
        return out, part.reshape((-1, nz) + tuple(part.shape[-2:]))
    return out


_TILE = (8, 32)          # the kernels' tile: rows, columns (csrc SWEEP_BY/BX)
_MAX_EDGE_BANDS = 8      # edge tile-row intervals a launch takes (csrc)


def _one_ring(spec):
    return all(abs(o) <= 1 for off in spec.offsets for o in off)


def block_plan(spec, pshape, origin, shape, ghosts):
    """The block sweep kernel's tiles for a padded block of ``pshape`` =
    (rows, columns), as a dict: ``lead`` = (rows, columns) the launch grid
    starts before the buffer, ``tiles`` = its (rows, columns) of 32 x 8
    tiles (the owned region's tiles, so that the |S| partials stay
    whole), and ``edge``, the [lo, hi) intervals of tile rows
    that take the full rule in a flagged (extend) launch: those holding a
    buffer row whose global row is within the offsets' y reach of row 0 or
    ny - 1, where the extend map moves reads (the kernel stages a two-cell
    ring for them and reads their near rows through the map).  Every other
    tile is lean: its reads come from the one-cell ring the kernel stages
    in shared memory, with no extend map.  An unflagged launch has no edge
    tiles."""
    py, px = pshape
    ny = shape[0]
    gy, gx = ghosts
    lead = tuple(-(-g // t) * t - g for g, t in zip(ghosts, _TILE))
    tiles = (-(-(lead[0] + py) // _TILE[0]), -(-(lead[1] + px) // _TILE[1]))
    rows = []
    if spec.bcs[-2] == "extend":
        ry = _ry(spec)
        for t in range(tiles[0]):
            R = [(origin[0] - gy + j) % ny
                 for j in range(max(0, t * _TILE[0] - lead[0]),
                                min(py, (t + 1) * _TILE[0] - lead[0]))]
            if any(r <= ry or r >= ny - 1 - ry for r in R):
                rows.append(t)
    # a buffer spans fewer than 3 ny rows (ghosts < ny), so the near rows
    # form at most four intervals
    edge = []
    for t in rows:
        if edge and edge[-1][1] == t:
            edge[-1][1] = t + 1
        else:
            edge.append([t, t + 1])
    return {"lead": lead, "tiles": tiles,
            "edge": tuple(tuple(e) for e in edge)}


def _block_layout(spec, P, rel, origin, shape, ghosts):
    """:func:`_layout` of a padded block, with its block arguments and the
    block sweep's plan."""
    from .sor2d import block_geometry
    by, bx = block_geometry(tuple(P.shape[-2:]), origin, shape, ghosts)
    if not _one_ring(spec):
        raise ValueError("the block sweep kernel stages a one-cell ring: "
                         f"offsets {spec.offsets} reach further")
    lay = _layout(spec, P, rel)
    plan = block_plan(spec, tuple(P.shape[-2:]), origin, shape, ghosts)
    lay["blk"] = (shape[0], shape[1], origin[0], origin[1], by, bx,
                  ghosts[0], ghosts[1])
    lay["pshape"] = (lay["B"], lay["nz"], -(-by // 8), -(-bx // 32))
    lay["edge"] = (ctypes.c_int * (2 * _MAX_EDGE_BANDS))(
        *[t for e in plan["edge"] for t in e])
    lay["n_edge"] = len(plan["edge"])
    lay["zc"] = 0       # levels a CTA walks: the launcher's choice
    return lay


def _launch_block(spec, lay, rel, S_in, S_out, color, fac=1.0,
                  partials=None, extend=False):
    """sor3d_block_sweep: S_out = half-sweep ``color`` of the padded block
    S_in (every cell; with ``extend``, the edge tiles read through the
    extend map)."""
    global BLOCK_LAUNCHES
    # the launch goes to the block's device stream: that device must be
    # current (a mesh's blocks may sit on several cards)
    with torch.cuda.device(S_in.device):
        err = lay["block_fn"](
            S_in.data_ptr(), S_out.data_ptr(), spec.w.data_ptr(),
            spec.w0.data_ptr(), spec.g.data_ptr(), rel.data_ptr(),
            None if partials is None else partials.data_ptr(),
            lay["B"], lay["nz"], *lay["blk"], lay["K"],
            ctypes.addressof(lay["dz"]), ctypes.addressof(lay["dy"]),
            ctypes.addressof(lay["dx"]),
            lay["w_kstride"], lay["w_bstride"], lay["w0_bstride"],
            lay["g_bstride"], lay["relax_bstride"], int(color),
            int(extend and spec.bcs[-2] == "extend"),
            int(spec.bcs[-1] == "periodic"), float(fac), lay["zc"],
            ctypes.addressof(lay["edge"]), lay["n_edge"], lay["stream"])
    BLOCK_LAUNCHES += 1
    if err:
        raise RuntimeError(f"sor3d_block_sweep launch failed: CUDA error "
                           f"{err}")


def sor3d_color_sweep_block_emulated(spec, P, rel, color, origin, shape,
                                     ghosts, fac=1.0, extend=False,
                                     with_norm=False):
    """The block sweep kernel's half-sweep replayed with torch ops on the
    CPU, tile class by tile class of :func:`block_plan` (tests only).  A
    lean tile reads each neighbour where the kernel's ring holds it, at
    ((l + dz) mod nz, (j + dy) mod py, (i + dx) mod px) of the buffer, with
    no extend map, and takes the parity (l + (oy - gy + j) mod ny +
    (ox - gx + i) mod nx) & 1; the edge tiles of a flagged launch take
    :func:`sor3d_color_sweep_block_reference`'s full rule.  Tests hold it
    torch.equal to the reference, so a tile filed in the wrong class
    fails on the CPU."""
    from .sor2d import block_geometry, block_partials
    if not _one_ring(spec):
        raise ValueError("the block sweep kernel stages a one-cell ring")
    nz, py, px = P.shape[-3:]
    ny, nx = shape
    gy, gx = ghosts
    by, bx = block_geometry((py, px), origin, shape, ghosts)
    plan = block_plan(spec, (py, px), origin, shape, ghosts)
    dev = P.device
    lv = torch.arange(nz, device=dev)[:, None, None]
    jv = torch.arange(py, device=dev)[None, :, None]
    iv = torch.arange(px, device=dev)[None, None, :]
    flat = P.reshape(P.shape[:-3] + (-1,))

    def at(index):
        index = index.expand(nz, py, px).reshape(-1)
        return flat[..., index].reshape(P.shape)

    acc = spec.g
    for k, (dz, dy, dx) in enumerate(spec.offsets):
        acc = acc + spec.w[k] * at(((lv + dz) % nz * py + (jv + dy) % py)
                                   * px + (iv + dx) % px)
    par = (lv + (origin[0] - gy + jv) % ny + (origin[1] - gx + iv) % nx) % 2
    sel = (par == color).to(P.dtype)
    out = P + ((rel * sel) * fac) * (acc + spec.w0 * P)
    if extend and spec.bcs[-2] == "extend" and plan["edge"]:
        tile = (torch.arange(py, device=dev) + plan["lead"][0]) // _TILE[0]
        rows = torch.zeros(py, dtype=torch.bool, device=dev)
        for lo, hi in plan["edge"]:
            rows |= (tile >= lo) & (tile < hi)
        full = sor3d_color_sweep_block_reference(
            spec, P, rel, color, origin, shape, ghosts, fac, True)
        out = torch.where(rows[:, None], full, out)
    if with_norm:
        part = block_partials(out[..., gy:gy + by, gx:gx + bx])
        return out, part.reshape((-1, nz) + tuple(part.shape[-2:]))
    return out


def sor3d_color_sweep_block(spec, P, rel, color, origin, shape, ghosts,
                            fac=1.0, extend=False, with_norm=False):
    """One half-sweep of ``color`` of one ghost-padded block ``P`` (...,
    nz, by + 2gy, bx + 2gx) into a new buffer, every cell (one launch of
    the block sweep kernel, B5s): ``spec``'s planes are the block's padded
    planes, ``rel`` the padded :func:`relax_plane` (scaled by ``fac``),
    ``origin`` = (oy, ox) the global origin of the owned cells, ``shape`` =
    (ny, nx) the whole grid's rows and columns, ``ghosts`` = (gy, gx) (0 on
    an axis the block spans whole); ``extend``: read through the extend
    pre-pass, folded in.  With ``with_norm`` also the owned cells' |S|
    partials (B, nz, ceil(by/8), ceil(bx/32)).  CPU tensors take the plain
    version."""
    if P.device.type == "cpu":
        return sor3d_color_sweep_block_reference(
            spec, P, rel, color, origin, shape, ghosts, fac, extend,
            with_norm)
    if color not in (0, 1):
        raise ValueError(f"color must be 0 or 1, got {color}")
    lay = _block_layout(spec, P, rel, origin, shape, ghosts)
    A = _driver._buffer(P, lay)
    out = torch.empty_like(A)
    part = (torch.empty(lay["pshape"], dtype=P.dtype, device=P.device)
            if with_norm else None)
    _launch_block(spec, lay, rel, A, out, color, fac, part, extend)
    out = out.reshape(P.shape)
    return (out, part) if with_norm else out


def make_block_sweeper(spec, P, omega, origin, shape, ghosts, k):
    """A function ``sweep(A, Bf, n, fac=None, with_norm=False)`` for
    blocks shaped like ``P`` with ``spec``'s padded planes: n <= k full
    sweeps of the padded state A, two half-sweep launches each (the extend
    pre-pass folded into the red one), ping-ponging through the spare
    buffer Bf and ending in A; returns (A, owned partials of the last black
    launch or None).  The ghosts must cover k sweeps' cone.  On CUDA
    tensors the block kernel, its layout built here once; on CPU tensors
    the plain version."""
    from .sor2d import block_geometry
    block_geometry(tuple(P.shape[-2:]), origin, shape, ghosts)
    k = int(k)
    rel = relax_plane(spec, omega)
    extend = spec.bcs[-2] == "extend"
    cpu = P.device.type == "cpu"
    lay = None if cpu else _block_layout(spec, P, rel, origin, shape,
                                         ghosts)

    def half(S_in, S_out, color, f, last):
        if cpu:
            res = sor3d_color_sweep_block_reference(
                spec, S_in, rel, color, origin, shape, ghosts, f,
                extend and color == 0, last)
            out, part = res if last else (res, None)
            S_out.copy_(out)
            return part
        part = (torch.empty(lay["pshape"], dtype=S_in.dtype,
                            device=S_in.device) if last else None)
        _launch_block(spec, lay, rel, S_in, S_out, color, f, part,
                      extend and color == 0)
        return part

    def sweep(A, Bf, n, fac=None, with_norm=False):
        n = int(n)
        if not 1 <= n <= k:
            raise ValueError(f"{n} sweeps; this block takes 1..{k}")
        part = None
        for it in range(n):
            f_red, f_black = ((1.0, 1.0) if fac is None
                              else (fac[2 * it], fac[2 * it + 1]))
            half(A, Bf, 0, f_red, False)
            part = half(Bf, A, 1, f_black, with_norm and it == n - 1)
        return A, part
    sweep.rel = rel        # the launches read it: keep it alive
    return sweep
