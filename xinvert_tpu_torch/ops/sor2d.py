# -*- coding: utf-8 -*-
"""Red-black SOR sweeps of a 2-D stencil: CUDA kernels and plain versions.

The kernels (``csrc/sor2d.cu``) replace the two TPU kernels of the 2-D main
path, ``xinvert_tpu/ops/pallas_sor.py::_kernel`` and
``xinvert_tpu/ops/pallas_sor_window.py::_kernel`` (with its fused |S|
partials); the source says how.  Each kernel has a wrapper here and a plain
PyTorch version built from :mod:`xinvert_tpu_torch.solver`'s sweep pieces:

=====================  ==========================  ==============================
kernel                 wrapper                     plain version
=====================  ==========================  ==============================
``sor2d_extend_rows``  :func:`sor2d_extend`        :func:`sor2d_extend_reference`
``sor2d_color_sweep``  :func:`sor2d_color_sweep`   :func:`sor2d_color_sweep_reference`
both, n sweeps         :func:`sor2d_sweeps`        :func:`sor2d_sweeps_reference`,
                                                   :func:`sor2d_sweeps_reference_norm`
=====================  ==========================  ==============================

A wrapper launches its kernel for CUDA tensors and takes the plain version
only for CPU tensors; any other input raises.  ``LAUNCHES`` and
``EXTEND_LAUNCHES`` count kernel launches, ``PLAIN_CALLS`` calls of the plain
versions, so a run can show which path it took.  No function here changes
the caller's tensors: the kernels work on buffers the wrappers allocate.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import solver

__all__ = ["sor2d_sweeps", "sor2d_sweeps_reference",
           "sor2d_sweeps_reference_norm", "sor2d_extend",
           "sor2d_extend_reference", "sor2d_color_sweep",
           "sor2d_color_sweep_reference", "relax_plane", "MAX_K"]

MAX_K = 16          # offsets the color-sweep kernel takes (csrc SOR2D_MAX_K)
_MAX_BATCH = 65535  # batch slices per launch (a grid dimension)

LAUNCHES = 0         # sor2d_color_sweep kernel launches
EXTEND_LAUNCHES = 0  # sor2d_extend_rows kernel launches
PLAIN_CALLS = 0      # calls of the plain versions


def relax_plane(spec, omega):
    """``omega * relax``: the relaxation plane both versions scale by the
    color selector."""
    return float(omega) * spec.relax


# ---------------------------------------------------------------------------
# plain versions (CPU path; on the card only tests and smoke runs call them)
# ---------------------------------------------------------------------------

def _plain_sweeps(spec, S, omega, n):
    rr, rb = solver._color_relax(spec, omega)
    for _ in range(int(n)):
        S = solver._sweep_with(spec, S, rr, rb)
    return S


def sor2d_sweeps_reference(spec, S, omega, n):
    """n full red-black sweeps with PyTorch ops."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    return _plain_sweeps(spec, S, omega, n)


def sor2d_sweeps_reference_norm(spec, S, omega, n):
    """:func:`sor2d_sweeps_reference` plus the per-slice total |S| over the
    core cells (the fused norm output of the kernel path)."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    S = _plain_sweeps(spec, S, omega, n)
    return S, torch.sum(torch.abs(S), dim=(-2, -1))


def sor2d_extend_reference(spec, S):
    """The extend pre-pass with PyTorch ops."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    return solver._apply_extend(spec, S)


def sor2d_color_sweep_reference(spec, S, rel, color):
    """One half-sweep of ``color`` (0 red, 1 black) with PyTorch ops;
    ``rel`` is :func:`relax_plane`."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    red = solver._checkerboard(S.shape[-2:], S.dtype, S.device)
    sel = red if color == 0 else 1.0 - red
    return solver._half_sweep(spec, S, rel * sel)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _layout(spec, S, rel=None):
    """Validate (spec, S[, rel]) for the kernels; return the launch layout
    (building the kernels on first use)."""
    if not S.is_cuda:
        raise ValueError(f"the sor2d kernels take CUDA tensors, got {S.device}")
    if S.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the sor2d kernels take float32/float64, got "
                        f"{S.dtype}")
    if spec.ndim != 2 or S.dim() < 2:
        raise NotImplementedError(
            "the sor2d kernels take 2-D specs; 3-D is ROADMAP queue B "
            "(kernels B4, B5)")
    ny, nx = S.shape[-2:]
    batch_shape = tuple(S.shape[:-2])
    B = math.prod(batch_shape)
    nmin = 5 if spec.bih else 3
    if ny < nmin or nx < nmin:
        raise ValueError(f"grid {ny}x{nx} is below the {nmin}x{nmin} "
                         "the kernels take")
    if not 1 <= B <= _MAX_BATCH:
        raise ValueError(f"batch of {B} slices; the kernels take 1.."
                         f"{_MAX_BATCH}")
    K = len(spec.offsets)
    if K > MAX_K:
        raise ValueError(f"{K} offsets; the kernel takes at most {MAX_K}")
    for off in spec.offsets:
        if len(off) != 2 or abs(off[0]) >= ny or abs(off[1]) >= nx:
            raise ValueError(f"offset {off} does not fit a {ny}x{nx} grid")
    planes = {"w0": spec.w0, "g": spec.g,
              "relax": spec.relax if rel is None else rel}
    for name, p in list(planes.items()) + [("w", spec.w)]:
        if p.device != S.device or p.dtype != S.dtype:
            raise ValueError(f"plane {name} is {p.dtype} on {p.device}; "
                             f"the state is {S.dtype} on {S.device}")
        if not p.is_contiguous():
            raise ValueError(f"plane {name} is not contiguous")
    bstride = {}
    for name, p in planes.items():
        if tuple(p.shape) not in ((ny, nx), tuple(S.shape)):
            raise ValueError(f"plane {name} has shape {tuple(p.shape)}; "
                             f"the kernels take {(ny, nx)} or "
                             f"{tuple(S.shape)}")
        bstride[name] = ny * nx if p.dim() > 2 else 0
    if tuple(spec.w.shape) not in ((K, ny, nx), (K,) + tuple(S.shape)):
        raise ValueError(f"spec.w has shape {tuple(spec.w.shape)}; the "
                         f"kernels take {(K, ny, nx)} or "
                         f"{(K,) + tuple(S.shape)}")
    w_batched = spec.w.dim() > 3
    from ._build import load
    lib = load()
    sfx = "f32" if S.dtype == torch.float32 else "f64"
    return dict(B=B, ny=ny, nx=nx, K=K, batch_shape=batch_shape,
                dy=(ctypes.c_int * MAX_K)(*[o[0] for o in spec.offsets]),
                dx=(ctypes.c_int * MAX_K)(*[o[1] for o in spec.offsets]),
                w_kstride=B * ny * nx if w_batched else ny * nx,
                w_bstride=ny * nx if w_batched else 0,
                w0_bstride=bstride["w0"], g_bstride=bstride["g"],
                rel_bstride=bstride["relax"],
                n_partials=lib.sor2d_partials_per_slice(ny, nx),
                extend_fn=getattr(lib, f"sor2d_extend_rows_{sfx}"),
                sweep_fn=getattr(lib, f"sor2d_color_sweep_{sfx}"),
                stream=torch.cuda.current_stream(S.device).cuda_stream)


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


def _launch_color_sweep(spec, lay, rel, S_in, S_out, color, partials=None):
    """sor2d_color_sweep: S_out = half-sweep ``color`` of S_in."""
    global LAUNCHES
    err = lay["sweep_fn"](
        S_in.data_ptr(), S_out.data_ptr(), spec.w.data_ptr(),
        spec.w0.data_ptr(), spec.g.data_ptr(), rel.data_ptr(),
        None if partials is None else partials.data_ptr(),
        lay["B"], lay["ny"], lay["nx"], lay["K"],
        ctypes.addressof(lay["dy"]), ctypes.addressof(lay["dx"]),
        lay["w_kstride"], lay["w_bstride"], lay["w0_bstride"],
        lay["g_bstride"], lay["rel_bstride"], int(color), lay["stream"])
    LAUNCHES += 1
    if err:
        raise RuntimeError(f"sor2d_color_sweep launch failed: CUDA error "
                           f"{err}")


def _buffer(S, lay):
    """A fresh contiguous (B, ny, nx) copy of S."""
    A = torch.empty((lay["B"], lay["ny"], lay["nx"]), dtype=S.dtype,
                    device=S.device)
    A.copy_(S.reshape(A.shape))
    return A


def sor2d_sweeps(spec, S, omega, n, with_norm=False):
    """n full red-black sweeps (extend pre-pass when the y boundary is
    'extend', then red, then black) of ``spec`` on ``S``.

    With ``with_norm`` returns ``(S', sumabs)``, sumabs being the per-slice
    total |S'| over the core cells, which the last black half-sweep sums
    per block as it writes S' (n >= 1 then).  CPU tensors take the plain
    version.
    """
    n = int(n)
    if n < (1 if with_norm else 0):
        raise ValueError(f"n must be >= {1 if with_norm else 0}, got {n}")
    if S.device.type == "cpu":
        if with_norm:
            return sor2d_sweeps_reference_norm(spec, S, omega, n)
        return sor2d_sweeps_reference(spec, S, omega, n)
    rel = relax_plane(spec, omega)
    lay = _layout(spec, S, rel)
    A = _buffer(S, lay)
    Bf = torch.empty_like(A)
    partials = None
    if with_norm:
        partials = torch.empty((lay["B"], lay["n_partials"]), dtype=S.dtype,
                               device=S.device)
    extend = spec.bcs[-2] == "extend"
    with torch.cuda.device(S.device):
        for it in range(n):
            if extend:
                _launch_extend(spec, lay, A)
            _launch_color_sweep(spec, lay, rel, A, Bf, 0)
            _launch_color_sweep(spec, lay, rel, Bf, A, 1,
                                partials if it == n - 1 else None)
    out = A.reshape(S.shape)
    if with_norm:
        return out, partials.sum(-1).reshape(lay["batch_shape"])
    return out


def sor2d_extend(spec, S):
    """The extend pre-pass on a copy of S (one kernel launch; a no-op copy
    when the y boundary is not 'extend').  CPU tensors take the plain
    version."""
    if S.device.type == "cpu":
        return sor2d_extend_reference(spec, S)
    lay = _layout(spec, S)
    A = _buffer(S, lay)
    if spec.bcs[-2] == "extend":
        with torch.cuda.device(S.device):
            _launch_extend(spec, lay, A)
    return A.reshape(S.shape)


def sor2d_color_sweep(spec, S, rel, color):
    """One half-sweep of ``color`` (0 red, 1 black) into a new tensor
    (one kernel launch); ``rel`` is :func:`relax_plane`.  CPU tensors take
    the plain version."""
    if S.device.type == "cpu":
        return sor2d_color_sweep_reference(spec, S, rel, color)
    if color not in (0, 1):
        raise ValueError(f"color must be 0 or 1, got {color}")
    lay = _layout(spec, S, rel)
    S_in = S if S.is_contiguous() else S.contiguous()
    out = torch.empty((lay["B"], lay["ny"], lay["nx"]), dtype=S.dtype,
                      device=S.device)
    with torch.cuda.device(S.device):
        _launch_color_sweep(spec, lay, rel, S_in, out, color)
    return out.reshape(S.shape)
