# -*- coding: utf-8 -*-
"""Red-black SOR sweeps of a 2-D stencil: CUDA kernels and plain versions.

The kernels (``csrc/sor2d.cu``) replace the three TPU kernels of the 2-D
paths, ``xinvert_tpu/ops/pallas_sor.py::_kernel``,
``xinvert_tpu/ops/pallas_sor_window.py::_kernel`` (with its fused |S|
partials and its Chebyshev factors) and
``xinvert_tpu/ops/pallas_sor_window.py::_kernel_inplace``; the source says
how.  Each kernel has a wrapper here and a plain PyTorch version built from
:mod:`xinvert_tpu_torch.solver`'s sweep pieces:

- ``sor2d_extend_rows``: :func:`sor2d_extend`, plain
  :func:`sor2d_extend_reference`;
- ``sor2d_color_sweep``: :func:`sor2d_color_sweep`, plain
  :func:`sor2d_color_sweep_reference`;
- ``sor2d_color_sweep_inplace``: :func:`sor2d_color_sweep_inplace`, plain
  :func:`sor2d_color_sweep_inplace_reference`;
- all of them, n sweeps: :func:`sor2d_sweeps`, plain
  :func:`sor2d_sweeps_reference` and :func:`sor2d_sweeps_reference_norm`.

:func:`sor2d_sweeps` takes the in-place kernel in place of the two
``sor2d_color_sweep`` launches when ``INPLACE_KERNEL`` is set (the
environment variable ``XINVERT_INPLACE=1`` at import, as in the JAX
package) and the spec passes :func:`_no_cross_r1` and the race check of
:func:`inplace_eligible`; otherwise it runs the ping-pong pair.

A wrapper launches its kernel for CUDA tensors and takes the plain version
only for CPU tensors; any other input raises.  ``LAUNCHES``,
``INPLACE_LAUNCHES`` and ``EXTEND_LAUNCHES`` count kernel launches,
``PLAIN_CALLS`` calls of the plain versions, so a run can show which path
it took.  No function here changes the caller's tensors: the kernels work
on buffers the wrappers allocate.
"""
from __future__ import annotations

import ctypes
import os

import torch

from .. import solver
from . import _driver
from ._driver import relax_plane

__all__ = ["sor2d_sweeps", "sor2d_sweeps_reference",
           "sor2d_sweeps_reference_norm", "sor2d_extend",
           "sor2d_extend_reference", "sor2d_color_sweep",
           "sor2d_color_sweep_reference", "sor2d_color_sweep_inplace",
           "sor2d_color_sweep_inplace_reference", "inplace_eligible",
           "relax_plane", "MAX_K"]

MAX_K = 16          # offsets the color-sweep kernel takes (csrc SOR2D_MAX_K)
_MAX_BATCH = 65535  # batch slices per launch (a grid dimension)

#: sweeps take the in-place kernel for eligible specs (off by default, as
#: in the JAX package; tests and smoke runs set the attribute)
INPLACE_KERNEL = os.environ.get("XINVERT_INPLACE") == "1"

LAUNCHES = 0          # sor2d_color_sweep kernel launches
INPLACE_LAUNCHES = 0  # sor2d_color_sweep_inplace kernel launches
EXTEND_LAUNCHES = 0   # sor2d_extend_rows kernel launches
PLAIN_CALLS = 0       # calls of the plain versions


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


def sor2d_extend_reference(spec, S):
    """The extend pre-pass with PyTorch ops."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    return solver._apply_extend(spec, S)


def _color_sweep_plain(spec, S, rel, color, fac):
    red = solver._checkerboard(S.shape[-2:], S.dtype, S.device)
    sel = red if color == 0 else 1.0 - red
    return solver._half_sweep(spec, S, fac * (rel * sel))


def sor2d_color_sweep_reference(spec, S, rel, color, fac=1.0):
    """One half-sweep of ``color`` (0 red, 1 black) with PyTorch ops;
    ``rel`` is :func:`relax_plane`, scaled by ``fac``."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    return _color_sweep_plain(spec, S, rel, color, fac)


def sor2d_color_sweep_inplace_reference(spec, S, rel, color, fac=1.0):
    """The in-place kernel's plain version: the function of
    :func:`sor2d_color_sweep_reference`, which the in-place update computes
    on the specs it takes."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    return _color_sweep_plain(spec, S, rel, color, fac)


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
    """True when the in-place kernel computes the pair's function on
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
# kernel wrappers (the driving loop is :mod:`._driver`'s)
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
    if not 1 <= lay["B"] <= _MAX_BATCH:
        raise ValueError(f"batch of {lay['B']} slices; the kernels take 1.."
                         f"{_MAX_BATCH}")
    from ._build import load
    lib = load("sor2d")
    sfx = "f32" if S.dtype == torch.float32 else "f64"
    lay.update(ny=ny, nx=nx,
               dy=(ctypes.c_int * MAX_K)(*[o[0] for o in spec.offsets]),
               dx=(ctypes.c_int * MAX_K)(*[o[1] for o in spec.offsets]),
               n_partials=lib.sor2d_partials_per_slice(ny, nx),
               extend_fn=getattr(lib, f"sor2d_extend_rows_{sfx}"),
               sweep_fn=getattr(lib, f"sor2d_color_sweep_{sfx}"),
               inplace_fn=getattr(lib, f"sor2d_color_sweep_inplace_{sfx}"))
    return lay


def _launch_extend(spec, lay, A):
    """sor2d_extend_rows on the (B, ny, nx) buffer A, in place."""
    global EXTEND_LAUNCHES
    err = lay["extend_fn"](A.data_ptr(), lay["B"], lay["ny"], lay["nx"],
                           int(spec.bcs[-1] == "periodic"), int(spec.bih),
                           lay["stream"])
    EXTEND_LAUNCHES += 1
    if err:
        raise RuntimeError(f"sor2d_extend_rows launch failed: CUDA error "
                           f"{err}")


def _plane_args(spec, lay, rel, partials):
    """The launch arguments after the state pointer(s), up to ``color``."""
    return (spec.w.data_ptr(), spec.w0.data_ptr(), spec.g.data_ptr(),
            rel.data_ptr(),
            None if partials is None else partials.data_ptr(),
            lay["B"], lay["ny"], lay["nx"], lay["K"],
            ctypes.addressof(lay["dy"]), ctypes.addressof(lay["dx"]),
            lay["w_kstride"], lay["w_bstride"], lay["w0_bstride"],
            lay["g_bstride"], lay["relax_bstride"])


def _launch_color_sweep(spec, lay, rel, S_in, S_out, color, fac=1.0,
                        partials=None):
    """sor2d_color_sweep: S_out = half-sweep ``color`` of S_in."""
    global LAUNCHES
    err = lay["sweep_fn"](S_in.data_ptr(), S_out.data_ptr(),
                          *_plane_args(spec, lay, rel, partials), int(color),
                          float(fac), lay["stream"])
    LAUNCHES += 1
    if err:
        raise RuntimeError(f"sor2d_color_sweep launch failed: CUDA error "
                           f"{err}")


def _launch_color_sweep_inplace(spec, lay, rel, S, color, fac=1.0,
                                partials=None):
    """sor2d_color_sweep_inplace: half-sweep ``color`` of S, in place."""
    global INPLACE_LAUNCHES
    err = lay["inplace_fn"](S.data_ptr(),
                            *_plane_args(spec, lay, rel, partials),
                            int(color), float(fac), lay["stream"])
    INPLACE_LAUNCHES += 1
    if err:
        raise RuntimeError(f"sor2d_color_sweep_inplace launch failed: CUDA "
                           f"error {err}")


def sor2d_sweeps(spec, S, omega, n, with_norm=False, fac=None):
    """n full red-black sweeps (extend pre-pass when the y boundary is
    'extend', then red, then black) of ``spec`` on ``S``.

    With ``with_norm`` returns ``(S', sumabs)``, sumabs being the per-slice
    total |S'| over the core cells, which the last black half-sweep sums
    per block as it writes S' (n >= 1 then).  ``fac`` (cyclic Chebyshev,
    :func:`~xinvert_tpu_torch.solver.solve_fixed_cheby`) holds 2n factors in
    the state's dtype, one per half-sweep, each scaling ``omega * relax``.
    With ``INPLACE_KERNEL`` set, a spec that :func:`_no_cross_r1` and
    :func:`inplace_eligible` take runs the in-place kernel; any other runs
    the ping-pong pair.  CPU tensors take the plain version.
    """
    return _driver.sweeps(_FAMILY, spec, S, omega, n, with_norm, fac)


def sor2d_extend(spec, S):
    """The extend pre-pass on a copy of S (one kernel launch; a no-op copy
    when the y boundary is not 'extend').  CPU tensors take the plain
    version."""
    return _driver.extend(_FAMILY, spec, S)


def sor2d_color_sweep(spec, S, rel, color, fac=1.0):
    """One half-sweep of ``color`` (0 red, 1 black) into a new tensor
    (one kernel launch); ``rel`` is :func:`relax_plane`, scaled by
    ``fac``.  CPU tensors take the plain version."""
    return _driver.color_sweep(_FAMILY, spec, S, rel, color, fac)


def sor2d_color_sweep_inplace(spec, S, rel, color, fac=1.0):
    """:func:`sor2d_color_sweep` through the in-place kernel, on a copy of
    S (one kernel launch), whatever ``INPLACE_KERNEL`` says; a spec that
    :func:`inplace_eligible` refuses raises.  CPU tensors take the plain
    version."""
    if S.device.type == "cpu":
        return sor2d_color_sweep_inplace_reference(spec, S, rel, color, fac)
    if color not in (0, 1):
        raise ValueError(f"color must be 0 or 1, got {color}")
    lay = _layout(spec, S, rel)
    if not inplace_eligible(spec, lay["core"]):
        raise ValueError("the in-place kernel takes radius-1 stencils "
                         "without cross terms and an even size along a "
                         "periodic axis")
    A = _driver._buffer(S, lay)
    with torch.cuda.device(S.device):
        _launch_color_sweep_inplace(spec, lay, rel, A, color, fac)
    return A.reshape(S.shape)


_FAMILY = _driver.Family(_layout, _launch_extend, _launch_color_sweep,
                         sor2d_sweeps_reference, sor2d_sweeps_reference_norm,
                         sor2d_extend_reference, sor2d_color_sweep_reference,
                         _use_inplace, _launch_color_sweep_inplace)
