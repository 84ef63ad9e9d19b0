# -*- coding: utf-8 -*-
"""Device meshes, the block layout and the sharded solves.

Counterpart of ``xinvert_tpu/parallel/mesh.py``.  A :class:`Mesh` names
the axes ('batch', 'y', 'x') over which a problem splits: non-core dims
over 'batch', the grid's rows over 'y' and its columns over 'x'.  It has
two kinds:

- *local*: every block lives in this process, on the devices the mesh
  lists; a list may repeat a device (``[torch.device("cuda", 0)] * 4``), as
  the JAX package's tests run on virtual CPU devices;
- *distributed*: the mesh lists ``torch.distributed`` ranks, one block a
  rank, each on the device of the tensors its rank passes.

A distributed mesh is an array of ranks rather than a
``torch.distributed.device_mesh.DeviceMesh``: the executor needs only
point-to-point exchanges with its ring neighbours and one all-gather over
the world, not the per-dimension process groups a DeviceMesh builds.

The JAX package's ``solve_sharded`` is GSPMD: the partitioner derives the
halo traffic from sharding annotations.  PyTorch has no such partitioner,
so here every sharded solve runs the explicit block executor of
:mod:`xinvert_tpu_torch.parallel.halo` (ghost rings exchanged every k
sweeps, the block kernels ``sor2d_sweeps_block`` / ``sor3d_color_sweep_block``
on the card, their plain versions on the CPU).

``scheme="lexico"`` is solved whole: the reference's serial order has no
block-parallel form, and the JAX package's GSPMD run computes exactly the
meshless iterates.  The multigrid entries ignore the mesh, as the JAX
package's do; the sharded pyramid (``shard_mg_levels``,
``solve_mg_sharded``) is ROADMAP queue A item 17.
"""
from __future__ import annotations

import collections
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..stencil import StencilSpec

__all__ = ["Mesh", "make_grid_mesh", "problem_pspecs", "shard_problem",
           "solve_sharded", "solve_fixed_sharded", "block_sizes"]

AXES = ("batch", "y", "x")


class Mesh:
    """Blocks laid out over named axes: ``devices`` is an array with one
    entry a block, ``axis_names`` names its axes (a subset of 'batch', 'y',
    'x', in any order).  Entries are torch devices (a local mesh; the same
    device may recur) or ``torch.distributed`` ranks (ints: a distributed
    mesh)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        names = tuple(axis_names)
        if arr.ndim != len(names) or len(set(names)) != len(names):
            raise ValueError(f"a mesh of shape {arr.shape} needs one name "
                             f"per axis, got {names}")
        flat = list(arr.reshape(-1))
        ranks = [isinstance(d, (int, np.integer)) for d in flat]
        if any(ranks) and not all(ranks):
            raise ValueError("a mesh lists devices or ranks, not both")
        self.distributed = bool(ranks and all(ranks))
        out = np.empty(len(flat), dtype=object)
        out[:] = ([int(d) for d in flat] if self.distributed
                  else [torch.device(d) for d in flat])
        self.devices = out.reshape(arr.shape)
        self.axis_names = names
        self.shape = collections.OrderedDict(zip(names, arr.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self):
        kind = "distributed" if self.distributed else "local"
        return f"Mesh({dict(self.shape)}, {kind})"


def _factor2(n: int) -> Tuple[int, int]:
    """Split n into the most-square (a, b) with a*b == n, a <= b."""
    a = int(np.sqrt(n))
    while a > 1 and n % a:
        a -= 1
    return a, n // a


def _dist_world():
    """The ranks of the ``torch.distributed`` world, or None when it is not
    up."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return list(range(dist.get_world_size()))
    return None


def make_grid_mesh(n_devices: Optional[int] = None, batch: int = 1,
                   devices: Optional[Sequence] = None) -> Mesh:
    """A ('batch', 'y', 'x') mesh: ``batch`` entries go to data parallelism
    over non-core dims, the rest are factored near-square into ('y', 'x')
    (the JAX package's ``_factor2``), so the ghost surface is least.

    ``devices`` lists torch devices (a local mesh; repeats allowed) or
    ranks (a distributed mesh).  Left None it is the world's ranks once
    ``torch.distributed`` is up, else the visible CUDA devices; without
    either it raises (a mesh never falls back to the CPU on its own: pass
    ``devices=[torch.device("cpu")] * n`` for a CPU mesh)."""
    if devices is None:
        devices = _dist_world()
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_grid_mesh: no torch.distributed world and no CUDA "
                "device; pass devices= (e.g. [torch.device('cpu')] * 4)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n == 0 or n % batch:
        raise ValueError(f"batch axis {batch} does not divide {n} devices")
    ny, nx = _factor2(n // batch)
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(batch, ny, nx), AXES)


def problem_pspecs(spec: StencilSpec, batch_ndim: int):
    """The axis names each array of (spec, S) splits over, as tuples (the
    JAX package's PartitionSpecs): core dims map to ('y', 'x') (1-D
    problems to 'x'), the leading batch dim of an array that has one to
    'batch'; the weight stack's offset axis is never split."""
    nd = spec.ndim
    core = ("x",) if nd == 1 else (None,) * (nd - 2) + ("y", "x")

    def lead_pspec(lead_rank, stacked=0):
        lead = (None,) * stacked
        if lead_rank > 0 and batch_ndim > 0:
            lead = lead + ("batch",) + (None,) * (lead_rank - 1)
        else:
            lead = lead + (None,) * lead_rank
        return lead + core

    def spec_pspec(a, stacked=0):
        return lead_pspec(a.dim() - nd - stacked, stacked)

    spec_specs = StencilSpec(
        w=spec_pspec(spec.w, stacked=1), w0=spec_pspec(spec.w0),
        g=spec_pspec(spec.g), relax=spec_pspec(spec.relax),
        active=spec_pspec(spec.active), offsets=spec.offsets, bcs=spec.bcs,
        bih=spec.bih, stop_on_zero_norm=spec.stop_on_zero_norm)
    return spec_specs, lead_pspec(batch_ndim)


def block_sizes(n: int, m: int, align: int = 1):
    """Split n cells over m blocks in units of ``align`` cells: the
    ceil(n / align) units as evenly as they go, the first blocks taking
    the extra ones, the last block cut at n; raises when a block would be
    empty.  Every origin is a multiple of ``align``.  Checked solves align
    rows to 8 and columns to 32, so the kernels' 32 x 8 |S| partials fall
    whole in one block each (330 rows over 2: 168 + 162; 72 over 4:
    24 + 16 + 16 + 16, where ceil(72/4/8)*8 = 24-row blocks would leave
    the fourth empty); fixed-count solves split cell by cell (72 over 8:
    9 each)."""
    units = -(-n // align)
    if units < m:
        raise ValueError(f"{n} cells do not split over {m} blocks in units "
                         f"of {align}")
    q, r = divmod(units, m)
    sizes = [(q + (i < r)) * align for i in range(m)]
    sizes[-1] -= sum(sizes) - n
    return sizes


def shard_problem(spec: StencilSpec, S0, mesh: Mesh):
    """This process's blocks of (spec, S0): a list of (Block, spec block,
    state block), each on its block's device, without ghosts (the
    executor pads them and exchanges the rings).  Every rank of a
    distributed mesh passes the whole problem and takes its own block, as
    the JAX package's ``shard_problem`` places each shard."""
    from .halo import Decomposition
    dec = Decomposition(spec, tuple(S0.shape), mesh, k=1, checked=True,
                        device=S0.device)
    S0 = S0.reshape((dec.B,) + dec.core)
    return [(b, dec.owned_spec(spec, b), dec.cut(S0, b).to(b.device))
            for b in dec.local]


def solve_sharded(spec: StencilSpec, S0, mesh: Optional[Mesh] = None,
                  omega: Optional[float] = None, tol: float = 1e-8,
                  max_iters: int = 5000, check_every: int = 1,
                  scheme: str = "sor", tol_type: str = "change"):
    """Convergence-checked solve with the problem split over ``mesh``:
    :func:`xinvert_tpu_torch.solver.solve`'s semantics (``check_every``,
    ``scheme`` 'sor' or 'cheby', ``tol_type`` 'change' or 'residual'),
    through the block executor (:mod:`.halo`).  The change rule's norm is
    the kernels' |S| partials in the whole grid's layout, so on the card
    the iterates and the stopping decisions are the meshless solve's, bit
    for bit.  ``scheme='lexico'`` (the reference's serial order, which has
    no block-parallel form) and a 1-D spec (a few hundred cells; no kernel,
    no block executor) are solved whole, on the device of ``S0``: every
    rank of a distributed mesh holds the whole problem, so each solves it
    whole."""
    from ..solver import solve
    if scheme not in ("sor", "cheby", "lexico"):
        raise ValueError(f"solve_sharded takes scheme 'sor', 'cheby' or "
                         f"'lexico', got {scheme!r} (scheme='direct' is "
                         "one-shot: solver.solve)")
    if spec.ndim == 1 or scheme == "lexico":
        return solve(spec, S0, omega=omega, tol=tol, max_iters=max_iters,
                     check_every=check_every, scheme=scheme,
                     tol_type=tol_type)
    from .halo import solve_checked
    return solve_checked(spec, S0, mesh, omega, tol, max_iters,
                         check_every, scheme, tol_type, "solve_sharded")


def solve_fixed_sharded(spec: StencilSpec, S0, n_iters: int,
                        mesh: Optional[Mesh] = None,
                        omega: Optional[float] = None):
    """Fixed-iteration sharded solve through the block executor: equal to
    :func:`xinvert_tpu_torch.solver.solve_fixed` bit for bit."""
    from ..grid import optimal_omega
    from .halo import solve_fixed_blocks
    if omega is None:
        omega = optimal_omega(tuple(S0.shape[-spec.ndim:]))
    return solve_fixed_blocks(spec, S0, omega, n_iters, mesh, None,
                              "solve_fixed_sharded")
