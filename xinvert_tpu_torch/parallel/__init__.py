# -*- coding: utf-8 -*-
"""Multi-device layer: meshes, the block decomposition and the sharded
solves, in PyTorch.

Counterpart of ``xinvert_tpu/parallel``.  The grid splits over a
('batch', 'y', 'x') :class:`~.mesh.Mesh`: non-core dims over 'batch', the
core grid over ('y', 'x').  Every sharded solve runs one block executor
(:mod:`.halo`): each block sweeps in the block kernels
(``sor2d_sweeps_block``, ``sor3d_color_sweep_block``) and its ghost rings
are exchanged every k sweeps, by device copies on a local mesh or
``torch.distributed`` point-to-point on a distributed one; the convergence
norm is the blocks' |S| partials, gathered.  ``scheme="lexico"`` and the
multigrid entries solve whole, as the JAX package's do;
``solve_mg_sharded`` runs a multigrid pyramid on the mesh
(``shard_mg_levels`` places it: its leading levels on blocks, the coarse
ones whole; :mod:`.pyramid`).
"""
from .mesh import (                                              # noqa: F401
    make_grid_mesh, shard_problem, solve_sharded, solve_fixed_sharded,
    problem_pspecs, shard_mg_levels, solve_mg_sharded,
)
from .halo import solve_fixed_halo                               # noqa: F401
from .halo_window import (                                       # noqa: F401
    solve_fixed_halo_window, solve_halo_window, halo_window_applicable,
)
from .halo_window3d import (                                     # noqa: F401
    solve_fixed_halo_window3d, solve_halo_window3d,
    halo_window3d_applicable,
)
from .scaling import (                                           # noqa: F401
    initialize_distributed, make_hybrid_mesh, scaling_bench,
    format_scaling_table,
)
