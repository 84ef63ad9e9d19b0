# -*- coding: utf-8 -*-
"""Red-black SOR engine and convergence driver, in PyTorch.

Counterpart of ``xinvert_tpu/solver.py``.  A sweep is an extend pre-pass
followed by two half-sweeps (red, then black) of the folded stencil
``S += r_c * (g + sum_k w_k S[.+off_k] + w0 S)``, on 2-D and 3-D specs;
``scheme="cheby"`` scales each half-sweep's ``r_c`` by the next factor of
the cyclic Chebyshev recurrence, computed on the host.  On
CUDA tensors the sweeps run in the hand-written kernels of
:mod:`xinvert_tpu_torch.ops.sor2d` and :mod:`xinvert_tpu_torch.ops.sor3d`; on
CPU tensors in their plain PyTorch versions, built from the functions below.

Convergence control replicates the reference exactly: the mean-|S| norm
(numbas.py:absNorm2D), the relative-change stopping rule, overflow detection
and the (overflow, rel-change, loop-count) telemetry.  Arrays may carry
leading batch dims; every slice runs in one batched sweep, and slices that
have stopped are frozen.

The engine runs on the device of the tensors it is given and never changes
the caller's tensors in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .grid import optimal_omega
from .stencil import StencilSpec, prune_zero_offsets

__all__ = ["SolveResult", "solve", "solve_fixed", "solve_fixed_cheby",
           "sweep", "sweeps", "rho2_from_omega"]


@dataclasses.dataclass
class SolveResult:
    """Solution plus the reference's ``flags`` telemetry (apps.py:2308-2311)."""
    S: torch.Tensor
    iters: torch.Tensor       # loop count at termination (per batch element)
    rel_change: torch.Tensor  # last relative change of the norm
    overflow: torch.Tensor    # bool, divergence detected


# ---------------------------------------------------------------------------
# boundary pre-pass ('extend' rows), applied once per iteration before the
# sweep, exactly like the reference kernels (numbas.py:284-310, :1299-1343).
# Only the second-to-last dim honours 'extend'; 3-D specs extend on interior
# z levels only, and ignore 'extend' on z as the reference does.
# ---------------------------------------------------------------------------

def _apply_extend(spec: StencilSpec, S):
    """The extend pre-pass on a copy of S (2-D and 3-D specs)."""
    if spec.ndim not in (2, 3):
        raise NotImplementedError(
            "the extend pre-pass is ported for 2-D and 3-D specs; 1-D is "
            "ROADMAP queue A item 7")
    if spec.bcs[-2] != "extend":
        return S
    S = S.clone()
    periodic_x = spec.bcs[-1] == "periodic"
    if spec.ndim == 3:
        # rows 0 and ny-1 copy rows 1 and ny-2 on levels 1..nz-2, with the
        # corner clamps when x is not periodic (numbas.py:87-115)
        if periodic_x:
            S[..., 1:-1, 0, :] = S[..., 1:-1, 1, :]
            S[..., 1:-1, -1, :] = S[..., 1:-1, -2, :]
        else:
            S[..., 1:-1, 0, 1:-1] = S[..., 1:-1, 1, 1:-1]
            S[..., 1:-1, -1, 1:-1] = S[..., 1:-1, -2, 1:-1]
            S[..., 1:-1, 0, 0] = S[..., 1:-1, 1, 1]
            S[..., 1:-1, 0, -1] = S[..., 1:-1, 1, -2]
            S[..., 1:-1, -1, 0] = S[..., 1:-1, -2, 1]
            S[..., 1:-1, -1, -1] = S[..., 1:-1, -2, -2]
    elif not spec.bih:
        if periodic_x:
            S[..., 0, :] = S[..., 1, :]
            S[..., -1, :] = S[..., -2, :]
        else:
            S[..., 0, 1:-1] = S[..., 1, 1:-1]
            S[..., -1, 1:-1] = S[..., -2, 1:-1]
            S[..., 0, 0] = S[..., 1, 1]
            S[..., 0, -1] = S[..., 1, -2]
            S[..., -1, 0] = S[..., -2, 1]
            S[..., -1, -1] = S[..., -2, -2]
    elif periodic_x:
        # sequential reference semantics: S[0]=old S[1]; S[1]=S[2]
        S[..., 0, :] = S[..., 1, :]
        S[..., 1, :] = S[..., 2, :]
        bm3 = S[..., -3, :].clone()
        S[..., -1, :] = bm3
        S[..., -2, :] = bm3
    else:
        top = S[..., 2, 1:-1].clone()
        S[..., 0, 1:-1] = top
        S[..., 1, 1:-1] = top
        bot = S[..., -3, 1:-1].clone()
        S[..., -1, 1:-1] = bot
        S[..., -2, 1:-1] = bot
        for (ys, xs, yy, xx) in (((0, 2), (0, 2), 2, 2),
                                 ((0, 2), (-2, None), 2, -3),
                                 ((-2, None), (0, 2), -3, 2),
                                 ((-2, None), (-2, None), -3, -3)):
            c = S[..., yy, xx].clone()
            S[..., slice(*ys), slice(*xs)] = c[..., None, None]
    return S


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def _checkerboard(shape, dtype, device):
    """(sum of core indices) % 2 == 0 mask."""
    total = 0
    for ax, n in enumerate(shape):
        view = [1] * len(shape)
        view[ax] = n
        total = total + torch.arange(n, device=device).reshape(view)
    return (total % 2 == 0).to(dtype)


def _neighbor_sum(spec: StencilSpec, S):
    """sum_k w_k * S[. + off_k] + g  over the core (trailing) axes."""
    nd = spec.ndim
    acc = spec.g
    for k, off in enumerate(spec.offsets):
        shifts = tuple(-o for o in off if o != 0)
        axes = tuple(ax - nd for ax, o in enumerate(off) if o != 0)
        acc = acc + spec.w[k] * torch.roll(S, shifts=shifts, dims=axes)
    return acc


def _color_relax(spec: StencilSpec, omega):
    """The two per-color relaxation planes: omega * active/(-w0) * color."""
    core_shape = spec.w0.shape[-spec.ndim:]
    red = _checkerboard(core_shape, spec.w0.dtype, spec.w0.device)
    r = float(omega) * spec.relax
    return r * red, r * (1.0 - red)


def _half_sweep(spec: StencilSpec, S, r):
    """One color's half-sweep with relaxation plane ``r``; every term reads
    the state from before the half-sweep."""
    acc = _neighbor_sum(spec, S)
    return S + r * (acc + spec.w0 * S)


def sweep(spec: StencilSpec, S, omega):
    """One full SOR iteration: extend pre-pass + red half + black half."""
    rr, rb = _color_relax(spec, omega)
    return _sweep_with(spec, S, rr, rb)


def _sweep_with(spec: StencilSpec, S, rr, rb):
    S = _apply_extend(spec, S)
    for r in (rr, rb):
        S = _half_sweep(spec, S, r)
    return S


def sweeps(spec: StencilSpec, S, omega, n, fac=None):
    """n full SOR iterations with PyTorch ops: the plain version of the
    sweep kernels.  ``fac`` (cyclic Chebyshev) holds 2n factors, one per
    half-sweep, scaling ``omega * relax``; see :func:`_sweep_cheby`."""
    rr, rb = _color_relax(spec, omega)
    for it in range(int(n)):
        if fac is None:
            S = _sweep_with(spec, S, rr, rb)
        else:
            S = _sweep_cheby(spec, S, fac[2 * it], fac[2 * it + 1], rr, rb)
    return S


# ---------------------------------------------------------------------------
# cyclic Chebyshev (scheme="cheby").  The factors are host scalars in the
# state's dtype, computed in the JAX package's operation order, so a launch
# needs no device sync and the kernels and the plain version see one
# sequence.
# ---------------------------------------------------------------------------

def _np_dtype(dtype):
    return np.float32 if dtype == torch.float32 else np.float64


def rho2_from_omega(omega, dtype):
    """Jacobi spectral-radius estimate rho^2 from an SOR factor, as a numpy
    scalar of the torch ``dtype``.

    Inverts omega_opt = 2 / (1 + sqrt(1 - rho^2)) (apps.py:2289-2290), so
    the grid-derived omega doubles as the Chebyshev parameter source.
    """
    dt = _np_dtype(dtype)
    s = dt(2.0) / dt(omega) - dt(1.0)
    return np.clip(dt(1.0) - s * s, dt(0.0), dt(1.0 - 1e-12))


def _cheby_next(m, w, rho2):
    """The cyclic Chebyshev semi-iterative factor for half-sweep ``m``
    (0-based), given the previous factor ``w`` (Golub & Varga 1961):
    w(0)=1, w(1)=1/(1-rho2/2), w(m+1)=1/(1-rho2*w(m)/4); in rho2's dtype."""
    dt = type(rho2)
    if m == 0:
        return dt(1.0)
    if m == 1:
        return dt(1.0) / (dt(1.0) - rho2 / dt(2.0))
    return dt(1.0) / (dt(1.0) - rho2 * w / dt(4.0))


def _cheby_factors(m, w, rho2, count):
    """The next ``count`` factors after half-sweep state (m, w), as Python
    floats (exact), and the state after them."""
    out = []
    for _ in range(count):
        w = _cheby_next(m, w, rho2)
        m += 1
        out.append(float(w))
    return out, m, w


def _sweep_cheby(spec: StencilSpec, S, fac_r, fac_b, base_r, base_b):
    """One full iteration of cyclic-Chebyshev red-black SOR: each
    half-sweep's relaxation plane ``base`` (omega 1) scaled by its factor,
    ``(w * base)`` as in the JAX package (the kernels compute
    ``base * w``: the product commutes, so the two stay bit-equal)."""
    S = _apply_extend(spec, S)
    for w, base in ((fac_r, base_r), (fac_b, base_b)):
        S = _half_sweep(spec, S, w * base)
    return S


def _residual_norm(spec: StencilSpec, S):
    """Mean |sum_k w_k S[.+off_k] + w0 S + g| over active cells, per slice —
    the true discrete residual of the folded system."""
    axes = tuple(range(-spec.ndim, 0))
    r = torch.where(spec.active, _neighbor_sum(spec, S) + spec.w0 * S, 0.0)
    n_active = max(int(spec.active.sum()), 1)
    return torch.sum(torch.abs(r), dim=axes) / n_active


def _residual_scale(spec: StencilSpec):
    """Normaliser for the relative residual: per-slice mean |g| over active
    cells (the forcing magnitude), with a dtype floor for zero forcing."""
    axes = tuple(range(-spec.ndim, 0))
    g = torch.where(spec.active, spec.g, 0.0)
    n_active = max(int(spec.active.sum()), 1)
    s = torch.sum(torch.abs(g), dim=axes) / n_active
    return torch.clamp(s, min=torch.finfo(spec.g.dtype).tiny)


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------

def _select_kernel(spec: StencilSpec, S):
    """The sweep executor for (spec, S): ``ops.sor2d.sor2d_sweeps`` or
    ``ops.sor3d.sor3d_sweeps``, which launch the hand-written kernels on
    CUDA tensors and run their plain PyTorch versions on CPU tensors.
    Anything else raises: there is no silent fallback."""
    for name in ("w", "w0", "g", "relax", "active"):
        if getattr(spec, name).device != S.device:
            raise ValueError(
                f"spec.{name} is on {getattr(spec, name).device} but the "
                f"state is on {S.device}")
    if spec.ndim not in (2, 3):
        raise NotImplementedError(
            f"{spec.ndim}-D specs are not ported yet (1-D: ROADMAP queue A "
            "item 7)")
    if S.dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(f"no sweep kernel for dtype {S.dtype}")
    if spec.w0.dtype != S.dtype:
        raise TypeError(f"spec dtype {spec.w0.dtype} != state dtype "
                        f"{S.dtype}")
    if S.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no sweep kernel for device {S.device}")
    from .ops import sor2d, sor3d
    return sor2d.sor2d_sweeps if spec.ndim == 2 else sor3d.sor3d_sweeps


def _solve_impl(spec, S0, omega, tol, max_iters, check_every,
                run_sweeps, tol_type, scheme):
    dtype, device = S0.dtype, S0.device
    batch_shape = S0.shape[: S0.ndim - spec.ndim]
    ncells = math.prod(S0.shape[-spec.ndim:])
    r_scale = _residual_scale(spec) if tol_type == "residual" else None
    tol_t = torch.tensor(tol, dtype=dtype, device=device)

    if scheme == "cheby":
        # the (m, w) recurrence state rides the loop carry across check
        # windows; the sweeps run at omega 1 with the factors on top
        rho2 = rho2_from_omega(omega, dtype)
        aux0 = (0, rho2.dtype.type(1.0))

        def step(S, aux, k, with_norm):
            fac, m, w = _cheby_factors(aux[0], aux[1], rho2, 2 * k)
            return (run_sweeps(spec, S, 1.0, k, with_norm=with_norm,
                               fac=fac), (m, w))
    else:
        aux0 = ()

        def step(S, aux, k, with_norm):
            return run_sweeps(spec, S, omega, k, with_norm=with_norm), aux

    # norm_prev < 0 marks "no previous norm yet".  (The reference uses a
    # float-max sentinel; |norm - MAX| / MAX multiplies by a subnormal,
    # which flush-to-zero turns into rel == 0 -> instant false convergence.)
    c = dict(
        S=S0,
        it=0,                                         # total sweeps run
        loop=torch.zeros(batch_shape, dtype=torch.int32, device=device),
        norm_prev=torch.full(batch_shape, -1.0, dtype=dtype, device=device),
        rel=torch.ones(batch_shape, dtype=dtype, device=device),
        overflow=torch.zeros(batch_shape, dtype=torch.bool, device=device),
        done=torch.zeros(batch_shape, dtype=torch.bool, device=device),
        aux=aux0,                            # cheby (m, w) recurrence state
    )
    single = math.prod(batch_shape) == 1

    def advance(c, k):
        # one check window: k sweeps, then the convergence/telemetry update
        if tol_type == "residual":
            S_new, aux = step(c["S"], c["aux"], k, False)
            norm = torch.broadcast_to(_residual_norm(spec, S_new),
                                      batch_shape)
            rel = norm / r_scale
        else:
            # the reference's mean-|S| norm (absNorm*, numbas.py:1690-1747)
            # from the per-slice total |S| the sweeps return
            (S_new, sum_abs), aux = step(c["S"], c["aux"], k, True)
            norm = sum_abs / ncells
            prev = c["norm_prev"]
            rel = torch.where(prev >= 0,
                              torch.abs(norm - prev)
                              / torch.where(prev > 0, prev, 1.0),
                              torch.ones_like(norm))
        # reference: isnan(norm) or norm > 1e100 (numbas.py:403); ~isfinite
        # additionally catches inf, which for float32 subsumes the 1e100 test
        overflow = ~torch.isfinite(norm)
        if dtype == torch.float64:
            overflow = overflow | (norm > 1e100)
        # reference loop semantics (numbas.py:401-414): sweep, increment,
        # then test — exactly mxLoop sweeps run at the cap and `iters`
        # counts sweeps performed
        new_loop = c["loop"] + k
        stop = overflow | (rel < tol_t) | (new_loop >= max_iters)
        if spec.stop_on_zero_norm and tol_type != "residual":
            stop = stop | (norm == 0)
        if single:
            # the loop exits the moment `done` flips, so it never advances
            # a finished slice: the freeze would be the identity
            def frz(old, new, d=None):
                return new
        else:
            done = c["done"]

            def frz(old, new, d=done):
                return torch.where(d, old, new)
        d_state = c["done"].reshape(batch_shape + (1,) * spec.ndim)
        return dict(
            S=frz(c["S"], S_new, d_state),
            it=c["it"] + k,
            loop=frz(c["loop"], new_loop),
            norm_prev=frz(c["norm_prev"], norm),
            rel=frz(c["rel"], rel),
            overflow=frz(c["overflow"], overflow),
            done=c["done"] | stop,
            aux=aux,
        )

    # only FULL check windows run in the loop (one host sync per window);
    # the clamped mxLoop remainder runs once after it, so exactly mxLoop
    # sweeps run even when check_every does not divide it
    while (c["it"] + check_every <= max_iters
           and not bool(torch.all(c["done"]))):
        c = advance(c, check_every)
    rem = max_iters - c["it"]
    if rem > 0 and not bool(torch.all(c["done"])):
        c = advance(c, rem)
    return SolveResult(S=c["S"], iters=c["loop"], rel_change=c["rel"],
                       overflow=c["overflow"])


#: schemes of the JAX package not ported yet, with their ROADMAP item
NOT_PORTED_SCHEMES = {"lexico": "ROADMAP queue A item 11"}


def _norm(spec: StencilSpec, S):
    """Mean |S| over the core dims, per slice (absNorm*,
    numbas.py:1690-1747)."""
    return torch.mean(torch.abs(S), dim=tuple(range(-spec.ndim, 0)))


def direct_result(spec: StencilSpec, S) -> SolveResult:
    """The telemetry of a one-shot direct solution ``S``: iters 1,
    ``rel_change`` the true relative residual of ``S``, and whether its
    norm is non-finite."""
    batch_shape = S.shape[: S.dim() - spec.ndim]
    rel = torch.broadcast_to(
        _residual_norm(spec, S) / _residual_scale(spec), batch_shape)
    return SolveResult(
        S=S, iters=torch.ones(batch_shape, dtype=torch.int32,
                              device=S.device),
        rel_change=rel.to(S.dtype),
        overflow=~torch.isfinite(_norm(spec, S))
        & torch.ones(batch_shape, dtype=torch.bool, device=S.device))


def solve(spec: StencilSpec, S0, omega: Optional[float] = None,
          tol: float = 1e-8, max_iters: int = 5000,
          check_every: int = 1,
          scheme: str = "sor",
          tol_type: str = "change") -> SolveResult:
    """Iterate to convergence with the reference's stopping rule.

    Parameters mirror iParams: ``tol`` is the relative change of the mean-|S|
    norm between checks (a solution-change criterion, not a residual),
    ``max_iters`` the reference's mxLoop.  ``omega`` defaults to the
    grid-optimal factor if None.

    ``check_every`` amortises the convergence test over k sweeps (the
    termination test then sees the norm every k-th iterate; k=1 reproduces
    the reference exactly).  ``tol_type="residual"`` stops on the true
    relative discrete residual mean|r|/mean|g| over active cells instead;
    ``rel_change`` then reports the final relative residual.

    ``scheme="cheby"`` runs cyclic-Chebyshev red-black SOR: each half-sweep
    takes the next factor of the Golub-Varga recurrence seeded by the
    Jacobi spectral radius that ``omega`` implies (:func:`rho2_from_omega`),
    carried across check windows.

    ``scheme="direct"`` is the one-shot spectral solve
    (:mod:`xinvert_tpu_torch.ops.direct`), exact, with no iteration:
    ``iters`` reports 1 and ``rel_change`` the true relative discrete
    residual of the returned solution.  Specs it does not take raise
    ``ValueError``.

    Runs on the device of ``spec`` and ``S0`` (which must agree): the CUDA
    kernels on a CUDA device, their plain PyTorch versions on the CPU.
    The iterative schemes take 2-D and 3-D specs; 1-D specs raise
    ``NotImplementedError`` there.
    """
    if scheme in NOT_PORTED_SCHEMES:
        raise NotImplementedError(f"scheme={scheme!r} is not ported yet "
                                  f"({NOT_PORTED_SCHEMES[scheme]})")
    if scheme not in ("sor", "cheby", "direct"):
        raise ValueError(f"unknown scheme {scheme!r}; "
                         "use 'sor', 'cheby' or 'direct'")
    if scheme == "direct":
        from .ops.direct import solve_direct
        return direct_result(spec, solve_direct(spec, S0))
    if tol_type not in ("change", "residual"):
        raise ValueError(f"unknown tol_type {tol_type!r}; "
                         "use 'change' or 'residual'")
    if int(check_every) < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    if omega is None:
        omega = optimal_omega(S0.shape[-spec.ndim:])
    run_sweeps = _select_kernel(spec, S0)
    # drop identically-zero weight planes: the sweep's memory traffic scales
    # with the plane count (stencil.prune_zero_offsets; exact)
    spec = prune_zero_offsets(spec)
    return _solve_impl(spec, S0, float(omega), float(tol), int(max_iters),
                       int(check_every), run_sweeps, tol_type, scheme)


def solve_fixed(spec: StencilSpec, S0, omega, n_iters: int):
    """Run exactly n_iters SOR iterations (no convergence checks).

    The hot path for benchmarking and for fixed-iteration parity tests.
    Unlike :func:`solve`, this does not prune zero weight planes: callers
    chain many calls on one spec, and the prune test is a host sync.
    """
    return _select_kernel(spec, S0)(spec, S0, float(omega), int(n_iters))


def solve_fixed_cheby(spec: StencilSpec, S0, omega, n_iters: int):
    """Run exactly ``n_iters`` cyclic-Chebyshev red-black SOR iterations
    (no convergence checks).  The half-sweep factor follows the Golub-Varga
    recurrence seeded by the Jacobi spectral radius implied by ``omega``
    (:func:`rho2_from_omega`); like :func:`solve_fixed`, no pruning."""
    run_sweeps = _select_kernel(spec, S0)
    rho2 = rho2_from_omega(omega, S0.dtype)
    fac, _, _ = _cheby_factors(0, rho2.dtype.type(1.0), rho2,
                               2 * int(n_iters))
    return run_sweeps(spec, S0, 1.0, int(n_iters), fac=fac)
