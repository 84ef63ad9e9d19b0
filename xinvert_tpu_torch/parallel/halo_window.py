# -*- coding: utf-8 -*-
"""The sharded 2-D solves on the block kernel ``sor2d_sweeps_block`` (B2s).

Counterpart of ``xinvert_tpu/parallel/halo_window.py``, where each device
of a ``shard_map`` runs the windowed Pallas kernel on its block with
``ppermute`` ghost rings.  Here each block of a
:class:`~xinvert_tpu_torch.parallel.mesh.Mesh` runs the tiled kernel's block
mode, k sweeps a launch, and the rings are exchanged between launches
(:mod:`.halo`).  Rows split over 'y' and columns over 'x' in balanced
units of 8 rows and 32 columns (``mesh.block_sizes``: the units as evenly
as they go, the first blocks taking the extra ones, the last cut at the
grid's edge; 72 rows over 4 give 24 + 16 + 16 + 16), flattened batch dims
over 'batch'.  Parity, the extend pre-pass and its corner clamps follow
global coordinates inside the kernel, so one kernel serves every block
position: the JAX executor's per-position variants (top / interior /
bottom rows, west / interior / east columns, ``ext_bot``) are not needed.
The result is the meshless solve's, bit for bit.
"""
from __future__ import annotations

from typing import Optional

from ..stencil import StencilSpec, prune_zero_offsets
from .halo import Decomposition, solve_checked, solve_fixed_blocks
from .mesh import AXES, Mesh

__all__ = ["solve_fixed_halo_window", "solve_halo_window",
           "halo_window_applicable"]


def halo_window_applicable(spec, S_shape, mesh: Mesh) -> bool:
    """True when the block executor takes this 2-D problem on ``mesh``:
    axes among 'batch', 'y', 'x', the batch divides over 'batch', and no
    block of a split axis is thinner than its ghost ring (k comes down to 1
    before that counts).  Where JAX's rule differs: it is bound by Mosaic,
    needing 128-lane column blocks and a single-call window plan per
    device; the port's kernel takes columns in multiples of 32 and tiles
    any block."""
    if spec.ndim != 2 or not set(mesh.shape) <= set(AXES):
        return False
    spec = prune_zero_offsets(spec)
    try:
        Decomposition(spec, tuple(S_shape), mesh, checked=True,
                      dtype=spec.w0.dtype)
    except ValueError:
        return False
    return True


def solve_fixed_halo_window(spec: StencilSpec, S, omega, n_iters: int,
                            mesh: Optional[Mesh] = None):
    """Fixed-iteration sharded 2-D solve: ``sor2d_sweeps_block`` on each
    block, the ghost rings exchanged every k sweeps.  Bit-identical to
    ``solve_fixed`` for any mesh; blocks split as evenly as ceil(n/m)
    allows (no partials to align)."""
    if spec.ndim != 2:
        raise ValueError("solve_fixed_halo_window supports 2-D problems")
    return solve_fixed_blocks(spec, S, omega, n_iters, mesh, None,
                              "solve_fixed_halo_window")


def solve_halo_window(spec: StencilSpec, S, omega, tol, max_iters: int,
                      check_every: int = 32, mesh: Optional[Mesh] = None,
                      tol_type: str = "change"):
    """Convergence-checked sharded 2-D SOR solve on the block kernel:
    :func:`xinvert_tpu_torch.solver.solve`'s stopping rule (sweep,
    increment, test; the mxLoop remainder once after the loop; the
    ``norm_prev = -1`` sentinel) as a host loop.  ``tol_type='change'``
    reads the kernels' fused |S| partials, assembled in the whole grid's
    layout: the meshless solve's norm bit for bit, so the same iters and
    field.  ``tol_type='residual'`` sums the blocks' |r| partials from the
    fresh rings of the last step, over the blocks' active cells.  Returns a
    :class:`~xinvert_tpu_torch.solver.SolveResult` with per-slice
    telemetry; every rank of a distributed mesh returns the whole field."""
    if spec.ndim != 2:
        raise ValueError("solve_halo_window supports 2-D problems")
    return solve_checked(spec, S, mesh, omega, tol, max_iters, check_every,
                         "sor", tol_type, "solve_halo_window")
