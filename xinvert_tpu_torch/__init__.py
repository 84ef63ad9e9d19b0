# -*- coding: utf-8 -*-
"""xinvert_tpu_torch — the PyTorch / CUDA port of xinvert_tpu, a framework
for inverting elliptic equations of geophysical fluid dynamics.

This package carries the masked spherical Poisson inversion end to end:
``invert_Poisson`` and ``inv_standard2D`` build a 2-D stencil program and a
red-black SOR engine iterates it under the reference's stopping rule.  On an
NVIDIA GPU the sweeps run in hand-written CUDA kernels (``csrc/sor2d.cu``,
built with nvcc on first use); on the CPU in their plain PyTorch versions.
Tensors live on ``torch.get_default_device()`` in
``torch.get_default_dtype()``.  The package imports neither JAX nor
``xinvert_tpu``.
"""

__version__ = "0.1.0"

from .field import Field, as_field, concat                      # noqa: F401
from .io import open_dataset, save_dataset, Dataset             # noqa: F401
from .grid import Grid, optimal_omega                           # noqa: F401
from .stencil import StencilSpec                                # noqa: F401
from .solver import solve, solve_fixed, SolveResult             # noqa: F401
from .core import inv_standard2D                                # noqa: F401
from .models.params import default_iParams, default_mParams     # noqa: F401
from .models.api import invert_Poisson                          # noqa: F401
