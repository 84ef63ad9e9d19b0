# -*- coding: utf-8 -*-
"""xinvert_tpu_torch — the PyTorch / CUDA port of xinvert_tpu, a framework
for inverting elliptic equations of geophysical fluid dynamics.

This package carries the 2-D inverters (the masked spherical Poisson
inversion ``invert_Poisson``; ``invert_RefState``, ``invert_PV2D``,
``invert_Eliassen``, ``invert_GillMatsuno[_test]``,
``invert_Stommel[_test]``, ``invert_StommelMunk``, ``invert_StommelArons``,
``invert_geostrophic``, ``invert_BrethertonHaidvogel``,
``invert_Fofonoff``; ``inv_standard2D[_test]``, ``inv_general2D[_bih]``)
and the 3-D ones (``invert_omega``, the QG omega equation;
``invert_3DOcean``, the 3-D damped ocean; ``inv_standard3D``,
``inv_general3D``) end to end: each builds a stencil program and a
red-black SOR engine (or its cyclic-Chebyshev variant, ``scheme="cheby"``)
iterates it under the reference's stopping rule.  Their 15 multigrid twins
(``invert_*_mg``, module :mod:`~xinvert_tpu_torch.mg`) solve the same
equations with V-cycles to a residual tolerance, smoothing through the
same kernels; ``invert_MultiGrid`` runs any inverter coarse to fine.
``scheme="direct"`` (module :mod:`~xinvert_tpu_torch.ops.direct`) solves
the x-invariant problems exactly in one shot: an rFFT along x (or a
symmetric eigenbasis), tridiagonal solves in y, and a capacitance-matrix
correction for small masks.  The sweeps run on the
NVIDIA GPU in hand-written CUDA kernels (``csrc/sor2d.cu``,
``csrc/sor3d.cu``, built with nvcc on first use; ``XINVERT_INPLACE=1``
selects the in-place 2-D kernel for radius-1 stencils without cross terms);
with ``device="cpu"`` they run in their plain PyTorch versions on the CPU.
The entry points default to the GPU and raise without one.  Tensors are
built in ``torch.get_default_dtype()``.  The package imports neither JAX
nor ``xinvert_tpu``.
"""

__version__ = "0.1.0"

from .field import Field, as_field, concat                      # noqa: F401
from .io import open_dataset, save_dataset, Dataset             # noqa: F401
from .grid import Grid, optimal_omega                           # noqa: F401
from .stencil import StencilSpec                                # noqa: F401
from .solver import (solve, solve_fixed, solve_fixed_cheby,     # noqa: F401
                     SolveResult)
from .core import (inv_standard2D, inv_standard2D_test,         # noqa: F401
                   inv_general2D, inv_general2D_bih, inv_standard3D,
                   inv_general3D)
from .models.params import default_iParams, default_mParams     # noqa: F401
from .models.api import (invert_Poisson, invert_RefState,       # noqa: F401
                         invert_PV2D, invert_Eliassen, invert_GillMatsuno,
                         invert_GillMatsuno_test, invert_Stommel,
                         invert_Stommel_test, invert_StommelMunk,
                         invert_StommelArons, invert_geostrophic,
                         invert_BrethertonHaidvogel, invert_Fofonoff,
                         invert_omega, invert_3DOcean, invert_Poisson_mg,
                         invert_omega_mg, invert_StommelMunk_mg,
                         invert_PV2D_mg, invert_Eliassen_mg,
                         invert_geostrophic_mg, invert_RefState_mg,
                         invert_Fofonoff_mg, invert_BrethertonHaidvogel_mg,
                         invert_GillMatsuno_test_mg, invert_Stommel_test_mg,
                         invert_GillMatsuno_mg, invert_Stommel_mg,
                         invert_StommelArons_mg, invert_3DOcean_mg,
                         invert_MultiGrid)
from . import mg                                                # noqa: F401
from .mg import (                                               # noqa: F401
    build_pyramid_standard2d, build_pyramid_standard3d, build_pyramid_bih2d,
    build_pyramid_general2d, build_pyramid_general3d, solve_mg,
)
from .ops.tridiag import trace, traceCyclic, tridiag_solve      # noqa: F401
from .ops.direct import solve_direct, direct_applicable         # noqa: F401
