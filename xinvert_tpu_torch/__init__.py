# -*- coding: utf-8 -*-
"""xinvert_tpu_torch — the PyTorch / CUDA port of xinvert_tpu, a framework
for inverting elliptic equations of geophysical fluid dynamics.

This package carries the masked spherical Poisson inversion
(``invert_Poisson``, ``inv_standard2D``) and the 3-D inverters
(``invert_omega``, the QG omega equation; ``invert_3DOcean``, the 3-D damped
ocean; ``inv_standard3D``, ``inv_general3D``) end to end: each builds a
stencil program and a red-black SOR engine iterates it under the
reference's stopping rule.  The sweeps run on the NVIDIA GPU in hand-written
CUDA kernels (``csrc/sor2d.cu``, ``csrc/sor3d.cu``, built with nvcc on first
use); with ``device="cpu"`` they run in their plain PyTorch versions on the
CPU.  The entry points default to the GPU and raise without one.  Tensors
are built in ``torch.get_default_dtype()``.  The package imports neither JAX
nor ``xinvert_tpu``.
"""

__version__ = "0.1.0"

from .field import Field, as_field, concat                      # noqa: F401
from .io import open_dataset, save_dataset, Dataset             # noqa: F401
from .grid import Grid, optimal_omega                           # noqa: F401
from .stencil import StencilSpec                                # noqa: F401
from .solver import solve, solve_fixed, SolveResult             # noqa: F401
from .core import inv_standard2D, inv_standard3D, inv_general3D  # noqa: F401
from .models.params import default_iParams, default_mParams     # noqa: F401
from .models.api import (invert_Poisson, invert_omega,          # noqa: F401
                         invert_3DOcean)
