# -*- coding: utf-8 -*-
"""The sharded 3-D solves on the block kernel ``sor3d_color_sweep_block``
(B5s).

Counterpart of ``xinvert_tpu/parallel/halo_window3d.py``.  Each block of a
:class:`~xinvert_tpu_torch.parallel.mesh.Mesh` keeps its z column whole
(the reference never updates z boundaries) and its rows and columns with
ghost rings of the k-sweep cone (2rk, plus 1 for the extend pre-pass: the
JAX executor's ``_HY``); it runs k sweeps, two launches each, on the
padded block, the rings exchanged between steps (:mod:`.halo`).  Row
blocks may start on odd rows (72 rows over 8 blocks of 9): the kernel's
parity is the global (l + R + C) & 1, which the TPU kernel needs a
``parity_off`` variant for.
"""
from __future__ import annotations

from typing import Optional

from ..stencil import StencilSpec, prune_zero_offsets
from .halo import Decomposition, solve_checked, solve_fixed_blocks
from .mesh import AXES, Mesh

__all__ = ["solve_fixed_halo_window3d", "solve_halo_window3d",
           "halo_window3d_applicable"]


def halo_window3d_applicable(spec, S_shape, mesh: Mesh) -> bool:
    """True when the block executor takes this 3-D problem on ``mesh``:
    axes among 'batch', 'y', 'x', the batch divides over 'batch', and no
    block of a split axis is thinner than its ghost ring (thicker than it
    on rows under an extend pre-pass, JAX's ``by > hy``).  Where JAX's rule
    differs: no 128-lane column blocks, no single-call z-window plan."""
    if spec.ndim != 3 or not set(mesh.shape) <= set(AXES):
        return False
    spec = prune_zero_offsets(spec)
    try:
        Decomposition(spec, tuple(S_shape), mesh, checked=True,
                      dtype=spec.w0.dtype)
    except ValueError:
        return False
    return True


def solve_fixed_halo_window3d(spec: StencilSpec, S, omega, n_iters: int,
                              mesh: Optional[Mesh] = None):
    """Fixed-iteration sharded 3-D solve: ``sor3d_color_sweep_block`` on
    each block, the rings exchanged every k sweeps; bit-identical to
    ``solve_fixed``.  Blocks split as evenly as ceil(n/m) allows."""
    if spec.ndim != 3:
        raise ValueError("solve_fixed_halo_window3d supports 3-D problems")
    return solve_fixed_blocks(spec, S, omega, n_iters, mesh, None,
                              "solve_fixed_halo_window3d")


def solve_halo_window3d(spec: StencilSpec, S, omega, tol, max_iters: int,
                        check_every: int = 32, mesh: Optional[Mesh] = None,
                        tol_type: str = "change"):
    """Convergence-checked sharded 3-D SOR solve on the block kernel, with
    the stopping rule of :func:`.halo_window.solve_halo_window`."""
    if spec.ndim != 3:
        raise ValueError("solve_halo_window3d supports 3-D problems")
    return solve_checked(spec, S, mesh, omega, tol, max_iters, check_every,
                         "sor", tol_type, "solve_halo_window3d")
