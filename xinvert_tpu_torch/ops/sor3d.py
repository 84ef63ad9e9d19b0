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
``sor3d_extend_rows``  :func:`sor3d_extend`        :func:`sor3d_extend_reference`
``sor3d_color_sweep``  :func:`sor3d_color_sweep`   :func:`sor3d_color_sweep_reference`
both, n sweeps         :func:`sor3d_sweeps`        :func:`sor3d_sweeps_reference`,
                                                   :func:`sor3d_sweeps_reference_norm`
=====================  ==========================  ==============================

A wrapper launches its kernel for CUDA tensors and takes the plain version
only for CPU tensors; any other input raises.  ``LAUNCHES`` and
``EXTEND_LAUNCHES`` count kernel launches, ``PLAIN_CALLS`` calls of the plain
versions, so a run can show which path it took.  No function here changes
the caller's tensors: the kernels work on buffers the wrappers allocate.
"""
from __future__ import annotations

import ctypes

import torch

from .. import solver
from . import _driver
from ._driver import relax_plane

__all__ = ["sor3d_sweeps", "sor3d_sweeps_reference",
           "sor3d_sweeps_reference_norm", "sor3d_extend",
           "sor3d_extend_reference", "sor3d_color_sweep",
           "sor3d_color_sweep_reference", "relax_plane", "MAX_K"]

MAX_K = 8            # offsets the color-sweep kernel takes (csrc SOR3D_MAX_K)
_MAX_GRID = 65535    # batch slices and interior levels per launch (grid dims)

LAUNCHES = 0         # sor3d_color_sweep kernel launches
EXTEND_LAUNCHES = 0  # sor3d_extend_rows kernel launches
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


def sor3d_extend_reference(spec, S):
    """The extend pre-pass with PyTorch ops."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    return solver._apply_extend(spec, S)


def sor3d_color_sweep_reference(spec, S, rel, color, fac=1.0):
    """One half-sweep of ``color`` (0 red, 1 black) with PyTorch ops;
    ``rel`` is :func:`relax_plane`, scaled by ``fac``."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    red = solver._checkerboard(S.shape[-3:], S.dtype, S.device)
    sel = red if color == 0 else 1.0 - red
    return solver._half_sweep(spec, S, fac * (rel * sel))


# ---------------------------------------------------------------------------
# kernel wrappers (the driving loop is :mod:`._driver`'s)
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
    if not 1 <= lay["B"] <= _MAX_GRID or nz - 2 > _MAX_GRID:
        raise ValueError(f"{lay['B']} batch slices of {nz} levels; the "
                         f"kernels take 1..{_MAX_GRID} slices of at most "
                         f"{_MAX_GRID + 2} levels")
    from ._build import load
    lib = load("sor3d")
    sfx = "f32" if S.dtype == torch.float32 else "f64"
    offs = [(ctypes.c_int * MAX_K)(*[o[a] for o in spec.offsets])
            for a in range(3)]
    lay.update(nz=nz, ny=ny, nx=nx, dz=offs[0], dy=offs[1], dx=offs[2],
               n_partials=lib.sor3d_partials_per_slice(nz, ny, nx),
               extend_fn=getattr(lib, f"sor3d_extend_rows_{sfx}"),
               sweep_fn=getattr(lib, f"sor3d_color_sweep_{sfx}"))
    return lay


def _launch_extend(spec, lay, A):
    """sor3d_extend_rows on the (B, nz, ny, nx) buffer A, in place."""
    global EXTEND_LAUNCHES
    err = lay["extend_fn"](A.data_ptr(), lay["B"], lay["nz"], lay["ny"],
                           lay["nx"], int(spec.bcs[-1] == "periodic"),
                           lay["stream"])
    EXTEND_LAUNCHES += 1
    if err:
        raise RuntimeError(f"sor3d_extend_rows launch failed: CUDA error "
                           f"{err}")


def _launch_color_sweep(spec, lay, rel, S_in, S_out, color, fac=1.0,
                        partials=None):
    """sor3d_color_sweep: S_out = half-sweep ``color`` of S_in."""
    global LAUNCHES
    err = lay["sweep_fn"](
        S_in.data_ptr(), S_out.data_ptr(), spec.w.data_ptr(),
        spec.w0.data_ptr(), spec.g.data_ptr(), rel.data_ptr(),
        None if partials is None else partials.data_ptr(),
        lay["B"], lay["nz"], lay["ny"], lay["nx"], lay["K"],
        ctypes.addressof(lay["dz"]), ctypes.addressof(lay["dy"]),
        ctypes.addressof(lay["dx"]),
        lay["w_kstride"], lay["w_bstride"], lay["w0_bstride"],
        lay["g_bstride"], lay["relax_bstride"], int(color), float(fac),
        lay["stream"])
    LAUNCHES += 1
    if err:
        raise RuntimeError(f"sor3d_color_sweep launch failed: CUDA error "
                           f"{err}")


def sor3d_sweeps(spec, S, omega, n, with_norm=False, fac=None):
    """n full red-black sweeps (extend pre-pass when the y boundary is
    'extend', then red, then black) of ``spec`` on ``S``.

    With ``with_norm`` returns ``(S', sumabs)``, sumabs being the per-slice
    total |S'| over the core cells, which the last black half-sweep sums
    per block as it writes S' (n >= 1 then).  ``fac`` (cyclic Chebyshev)
    holds 2n factors in the state's dtype, one per half-sweep, each scaling
    ``omega * relax``.  CPU tensors take the plain version.
    """
    return _driver.sweeps(_FAMILY, spec, S, omega, n, with_norm, fac)


def sor3d_extend(spec, S):
    """The extend pre-pass on a copy of S (one kernel launch; a no-op copy
    when the y boundary is not 'extend').  CPU tensors take the plain
    version."""
    return _driver.extend(_FAMILY, spec, S)


def sor3d_color_sweep(spec, S, rel, color, fac=1.0):
    """One half-sweep of ``color`` (0 red, 1 black) into a new tensor
    (one kernel launch); ``rel`` is :func:`relax_plane`, scaled by
    ``fac``.  CPU tensors take the plain version."""
    return _driver.color_sweep(_FAMILY, spec, S, rel, color, fac)


_FAMILY = _driver.Family(_layout, _launch_extend, _launch_color_sweep,
                         sor3d_sweeps_reference, sor3d_sweeps_reference_norm,
                         sor3d_extend_reference, sor3d_color_sweep_reference)
