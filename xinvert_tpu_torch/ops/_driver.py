# -*- coding: utf-8 -*-
"""What the 2-D and 3-D red-black SOR wrappers share.

:mod:`.sor2d` and :mod:`.sor3d` each run their own sweep loop: ceil(n / k)
resident or tiled launches in 2-D, two color-sweep launches a sweep (the
extend pre-pass folded into the red one) in 3-D.  What both loops do is
here, once: the checks on the state and the planes and the launch layout
they share (:func:`check_planes`), the relaxation plane, the working copy
of the state, the buffer of the fused |S| partials the last launch writes
and their per-slice totals.
"""
from __future__ import annotations

import math

import torch


def relax_plane(spec, omega):
    """``omega * relax``: the relaxation plane both versions scale by the
    color selector."""
    return float(omega) * spec.relax


def check_planes(name, spec, S, rel, nd, max_k):
    """Validate (spec, S[, rel]) for the ``name`` kernels, which take
    ``nd`` core axes and at most ``max_k`` offsets.  Returns the layout
    entries both modules use: the core shape, the batch, and the batch and
    offset strides of the planes (0 for a plane the slices share)."""
    if not S.is_cuda:
        raise ValueError(f"the {name} kernels take CUDA tensors, got "
                         f"{S.device}")
    if S.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the {name} kernels take float32/float64, got "
                        f"{S.dtype}")
    if spec.ndim != nd or S.dim() < nd:
        raise NotImplementedError(f"the {name} kernels take {nd}-D specs, "
                                  f"got a {spec.ndim}-D one")
    core = tuple(S.shape[-nd:])
    batch_shape = tuple(S.shape[:-nd])
    B = math.prod(batch_shape)
    K = len(spec.offsets)
    if K > max_k:
        raise ValueError(f"{K} offsets; the kernel takes at most {max_k}")
    extent = "x".join(map(str, core))
    for off in spec.offsets:
        if len(off) != nd or any(abs(o) >= n for o, n in zip(off, core)):
            raise ValueError(f"offset {off} does not fit a {extent} core")
    planes = {"w0": spec.w0, "g": spec.g,
              "relax": spec.relax if rel is None else rel}
    for pname, p in list(planes.items()) + [("w", spec.w)]:
        if p.device != S.device or p.dtype != S.dtype:
            raise ValueError(f"plane {pname} is {p.dtype} on {p.device}; "
                             f"the state is {S.dtype} on {S.device}")
        if not p.is_contiguous():
            raise ValueError(f"plane {pname} is not contiguous")
    vol = math.prod(core)
    lay = dict(B=B, core=core, batch_shape=batch_shape, K=K)
    for pname, p in planes.items():
        if tuple(p.shape) not in (core, tuple(S.shape)):
            raise ValueError(f"plane {pname} has shape {tuple(p.shape)}; "
                             f"the kernels take {core} or {tuple(S.shape)}")
        lay[f"{pname}_bstride"] = vol if p.dim() > nd else 0
    if tuple(spec.w.shape) not in ((K,) + core, (K,) + tuple(S.shape)):
        raise ValueError(f"spec.w has shape {tuple(spec.w.shape)}; the "
                         f"kernels take {(K,) + core} or "
                         f"{(K,) + tuple(S.shape)}")
    w_batched = spec.w.dim() > nd + 1
    lay.update(w_kstride=B * vol if w_batched else vol,
               w_bstride=vol if w_batched else 0,
               stream=torch.cuda.current_stream(S.device).cuda_stream)
    return lay


def slice_totals(partials):
    """Per-slice totals of the (B, P) |S| partials, summed in an order set
    by P alone: a pairwise tree of elementwise adds.  ``torch.sum`` picks
    its reduction layout by the batch size too, so a slice's total would
    change its last bits with the batch it rides in; this way a streamed
    chunk and the resident batch give every slice the same total.  The
    zero padding to a power of two adds nothing: partials are >= 0."""
    P = partials.shape[-1]
    x = torch.nn.functional.pad(partials, (0, (1 << (P - 1).bit_length())
                                           - P))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _buffer(S, lay):
    """A fresh contiguous (B, *core) copy of S."""
    A = torch.empty((lay["B"],) + lay["core"], dtype=S.dtype, device=S.device)
    A.copy_(S.reshape(A.shape))
    return A


def _check_sweeps(n, with_norm, fac):
    n = int(n)
    if n < (1 if with_norm else 0):
        raise ValueError(f"n must be >= {1 if with_norm else 0}, got {n}")
    if fac is not None and len(fac) != 2 * n:
        raise ValueError(f"{len(fac)} factors for {n} sweeps; need {2 * n}")
    return n


def _partials(S, lay, with_norm):
    """The (B, n_partials) buffer of the |S| partials, or None without
    ``with_norm``."""
    if not with_norm:
        return None
    return torch.empty((lay["B"], lay["n_partials"]), dtype=S.dtype,
                       device=S.device)


def _result(A, S, lay, partials):
    """The swept buffer A in the caller's shape, and with ``partials``
    also the per-slice |S| totals (:func:`slice_totals`)."""
    out = A.reshape(S.shape)
    if partials is None:
        return out
    return out, slice_totals(partials).reshape(lay["batch_shape"])
