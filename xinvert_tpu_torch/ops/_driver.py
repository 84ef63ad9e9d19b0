# -*- coding: utf-8 -*-
"""What the 2-D and 3-D red-black SOR wrappers share.

:mod:`.sor2d` and :mod:`.sor3d` differ only in their layout (the number of
core axes, their limits, the launch arguments), in their launch calls, and
in that :mod:`.sor2d` also has an in-place color sweep, the tiled
kernels (k sweeps per launch) and the resident kernel (a whole slice on an
SM, a check window a launch), while :mod:`.sor3d`'s color sweep can fold
the extend pre-pass in.  Everything else is here, once: the checks
on the state and the planes, the sweep loops (ceil(n / k) tiled or
resident launches; or three launches a sweep, two with the pre-pass
folded, on ping-pong buffers or on one buffer where the family's
``use_inplace`` lets it) with the fused |S| partials on
the last launch and the per-half-sweep Chebyshev factors, and the dispatch
of CPU tensors to the plain versions.  Each module describes itself with a :class:`Family`; its
launch functions and plain versions keep counting into that module's own
counters.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch


class Family(NamedTuple):
    """One kernel pair, its launch layout and its plain versions; the
    in-place color sweep and its gate where the family has one."""
    layout: Callable                 # (spec, S, rel=None) -> layout dict
    launch_extend: Callable          # (spec, lay, A): extend A in place
    launch_color_sweep: Callable     # (spec, lay, rel, S_in, S_out, color,
                                     #  fac=1.0, partials=None[, extend])
    sweeps_reference: Callable       # (spec, S, omega, n, fac=None)
    sweeps_reference_norm: Callable  # (spec, S, omega, n, fac=None)
                                     #  -> (S, sumabs)
    extend_reference: Callable       # (spec, S)
    color_sweep_reference: Callable  # (spec, S, rel, color, fac=1.0)
    use_inplace: Optional[Callable] = None      # (spec, core) -> bool:
                                     #  sweeps() takes the in-place kernel
    launch_color_sweep_inplace: Optional[Callable] = None
                                     # (spec, lay, rel, S, color, fac=1.0,
                                     #  partials=None)
    tile_plan: Optional[Callable] = None  # (spec, core, dtype, inplace)
                                     #  -> plan with .k and .tiles(core)
    launch_tiled: Optional[Callable] = None
                                     # (spec, lay, plan, rel, S_in, S_out,
                                     #  n, fac, partials=None): n sweeps
    resident_plan: Optional[Callable] = None  # (spec, core, dtype) -> plan
                                     #  with .k, or None where no slice fits
    launch_resident: Optional[Callable] = None
                                     # (spec, lay, plan, rel, S, n, fac,
                                     #  partials=None): n sweeps in place


def relax_plane(spec, omega):
    """``omega * relax``: the relaxation plane both versions scale by the
    color selector."""
    return float(omega) * spec.relax


def check_planes(name, spec, S, rel, nd, max_k):
    """Validate (spec, S[, rel]) for the ``name`` kernels, which take
    ``nd`` core axes and at most ``max_k`` offsets.  Returns the layout
    entries every family has: the core shape, the batch, and the batch and
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


def _plain(fam, spec, S, omega, n, with_norm, fac):
    if with_norm:
        return fam.sweeps_reference_norm(spec, S, omega, n, fac)
    return fam.sweeps_reference(spec, S, omega, n, fac)


def sweeps(fam, spec, S, omega, n, with_norm=False, fac=None):
    """n full red-black sweeps of ``spec`` on ``S`` (the extend pre-pass
    when the y boundary is 'extend', then red, then black): through the
    family's resident kernel where its ``resident_plan`` takes (spec,
    core, dtype), else through its tiled kernels where it has them (in
    place where its ``use_inplace`` takes (spec, core)), else
    :func:`sweeps_pair`.  With ``with_norm`` also the per-slice total
    |S'| (n >= 1 then).  ``fac``
    (cyclic Chebyshev) holds 2n factors, one per half-sweep in order, each
    scaling that half-sweep's relaxation plane; None runs every half-sweep
    with factor 1."""
    if fam.launch_tiled is None:
        return sweeps_pair(fam, spec, S, omega, n, with_norm, fac)
    core = tuple(S.shape[-spec.ndim:])
    if S.device.type != "cpu" and fam.resident_plan is not None:
        plan = fam.resident_plan(spec, core, S.dtype)
        if plan is not None:
            return sweeps_resident(fam, spec, S, omega, n, with_norm, fac,
                                   plan)
    inplace = (S.device.type != "cpu" and fam.use_inplace is not None
               and fam.use_inplace(spec, core))
    return sweeps_tiled(fam, spec, S, omega, n, with_norm, fac, inplace)


def sweeps_resident(fam, spec, S, omega, n, with_norm, fac, plan):
    """:func:`sweeps` through the family's resident kernel with ``plan``,
    every slice held whole on one SM: ceil(n / plan.k) launches on one
    buffer, each taking its slice of the factors, the last one also the
    |S| partials (the tiled kernel's blocks and order)."""
    n = _check_sweeps(n, with_norm, fac)
    if S.device.type == "cpu":
        return _plain(fam, spec, S, omega, n, with_norm, fac)
    rel = relax_plane(spec, omega)
    lay = fam.layout(spec, S, rel)
    A = _buffer(S, lay)
    partials = None
    if with_norm:
        partials = torch.empty((lay["B"], lay["n_partials"]), dtype=S.dtype,
                               device=S.device)
    done = 0
    with torch.cuda.device(S.device):
        while done < n:
            m = min(plan.k, n - done)
            f = [1.0] * (2 * m) if fac is None else fac[2 * done:
                                                        2 * (done + m)]
            fam.launch_resident(spec, lay, plan, rel, A, m, f,
                                partials if done + m == n else None)
            done += m
    out = A.reshape(S.shape)
    if with_norm:
        return out, slice_totals(partials).reshape(lay["batch_shape"])
    return out


def sweeps_tiled(fam, spec, S, omega, n, with_norm=False, fac=None,
                 inplace=False):
    """:func:`sweeps` through the tiled kernel (``inplace``: its in-place
    twin): ceil(n / k) launches of the family's plan, each taking its
    slice of the factors, the last one also the |S| partials (the same
    ``n_partials`` blocks, summed in the same order, as the color sweeps);
    the buffers ping-pong between launches."""
    n = _check_sweeps(n, with_norm, fac)
    if S.device.type == "cpu":
        return _plain(fam, spec, S, omega, n, with_norm, fac)
    rel = relax_plane(spec, omega)
    lay = fam.layout(spec, S, rel)
    plan = fam.tile_plan(spec, lay["core"], S.dtype, inplace)
    A = _buffer(S, lay)
    Bf = torch.empty_like(A)
    partials = None
    if with_norm:
        partials = torch.empty((lay["B"], lay["n_partials"]), dtype=S.dtype,
                               device=S.device)
    done = 0
    with torch.cuda.device(S.device):
        while done < n:
            m = min(plan.k, n - done)
            f = [1.0] * (2 * m) if fac is None else fac[2 * done:
                                                        2 * (done + m)]
            fam.launch_tiled(spec, lay, plan, rel, A, Bf, m, f,
                             partials if done + m == n else None)
            A, Bf = Bf, A
            done += m
    out = A.reshape(S.shape)
    if with_norm:
        return out, slice_totals(partials).reshape(lay["batch_shape"])
    return out


def sweeps_pair(fam, spec, S, omega, n, with_norm=False, fac=None,
                fold_extend=False):
    """:func:`sweeps` through three launches a sweep: the extend kernel,
    then the red and black color sweeps, which ping-pong between two
    buffers or update one buffer in place where the family's
    ``use_inplace`` takes (spec, core); the last black half-sweep sums the
    |S| partials per block.  ``fold_extend`` (a family whose color sweep
    takes the extend flag): two launches a sweep, the extend pre-pass
    folded into the red launch, which ping-pongs."""
    n = _check_sweeps(n, with_norm, fac)
    if S.device.type == "cpu":
        return _plain(fam, spec, S, omega, n, with_norm, fac)
    rel = relax_plane(spec, omega)
    lay = fam.layout(spec, S, rel)
    A = _buffer(S, lay)
    inplace = (not fold_extend and fam.use_inplace is not None
               and fam.use_inplace(spec, lay["core"]))
    Bf = None if inplace else torch.empty_like(A)
    partials = None
    if with_norm:
        partials = torch.empty((lay["B"], lay["n_partials"]), dtype=S.dtype,
                               device=S.device)
    extend = spec.bcs[-2] == "extend"
    red_kw = {"extend": True} if extend and fold_extend else {}
    with torch.cuda.device(S.device):
        for it in range(n):
            f_red, f_black = (1.0, 1.0) if fac is None else fac[2 * it:
                                                                 2 * it + 2]
            last = partials if it == n - 1 else None
            if extend and not fold_extend:
                fam.launch_extend(spec, lay, A)
            if inplace:
                fam.launch_color_sweep_inplace(spec, lay, rel, A, 0, f_red)
                fam.launch_color_sweep_inplace(spec, lay, rel, A, 1, f_black,
                                               last)
            else:
                fam.launch_color_sweep(spec, lay, rel, A, Bf, 0, f_red,
                                       **red_kw)
                fam.launch_color_sweep(spec, lay, rel, Bf, A, 1, f_black,
                                       last)
    out = A.reshape(S.shape)
    if with_norm:
        return out, slice_totals(partials).reshape(lay["batch_shape"])
    return out


def extend(fam, spec, S):
    """The extend pre-pass on a copy of S (one launch; a plain copy when
    the y boundary is not 'extend')."""
    if S.device.type == "cpu":
        return fam.extend_reference(spec, S)
    lay = fam.layout(spec, S)
    A = _buffer(S, lay)
    if spec.bcs[-2] == "extend":
        with torch.cuda.device(S.device):
            fam.launch_extend(spec, lay, A)
    return A.reshape(S.shape)


def color_sweep(fam, spec, S, rel, color, fac=1.0, extend=False):
    """One half-sweep of ``color`` (0 red, 1 black), its relaxation plane
    scaled by ``fac``, into a new tensor (one launch); ``extend`` (a family
    whose color sweep takes the flag): of S after the extend pre-pass,
    folded into the launch."""
    kw = {"extend": True} if extend else {}
    if S.device.type == "cpu":
        return fam.color_sweep_reference(spec, S, rel, color, fac, **kw)
    if color not in (0, 1):
        raise ValueError(f"color must be 0 or 1, got {color}")
    lay = fam.layout(spec, S, rel)
    S_in = S if S.is_contiguous() else S.contiguous()
    out = torch.empty((lay["B"],) + lay["core"], dtype=S.dtype,
                      device=S.device)
    with torch.cuda.device(S.device):
        fam.launch_color_sweep(spec, lay, rel, S_in, out, color, fac, **kw)
    return out.reshape(S.shape)
