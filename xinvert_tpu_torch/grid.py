# -*- coding: utf-8 -*-
"""Grid/geometry descriptor for the elliptic solvers.

Encodes the uniform-grid semantics of the reference framework
(xinvert/apps.py:2162-2379): uniform spacing enforced per
dimension, degrees->metres conversion on spherical dims, precomputed stencil
ratios, and the grid-derived optimal SOR relaxation factor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np

__all__ = ["Grid", "BCS", "optimal_omega"]

# boundary-condition vocabulary of the solver layer
BCS = ("fixed", "extend", "periodic")

_DEG2RAD = math.pi / 180.0


def _uniform_step(coord: np.ndarray, name: str) -> float:
    """Return the (enforced-uniform) step of a 1-D coordinate.

    Mirrors the reference's uniformity check (apps.py:2377-2379).
    """
    coord = np.asarray(coord, dtype=np.float64)
    if coord.ndim != 1 or coord.size < 2:
        raise ValueError(f"coordinate {name} must be 1-D with >=2 points")
    d = np.diff(coord)
    if not np.allclose(d, d[0], rtol=1e-4, atol=0.0):
        raise ValueError(f"coordinate {name} is non-uniform")
    return float(d[0])


def optimal_omega(counts: Sequence[int]) -> float:
    """Grid-derived optimal SOR over-relaxation factor.

    Replicates the reference formulas (apps.py:2206-2209, :2289-2290,
    :2342-2343): eps = sum of sin^2(pi/(2*gc+2)) over the fastest two dims,
    with the third (slowest, e.g. lev) dim using 2*gc+3.
    """
    counts = list(counts)
    if len(counts) == 1:
        eps = math.sin(math.pi / (2.0 * counts[0] + 2.0)) ** 2
    elif len(counts) == 2:
        eps = (math.sin(math.pi / (2.0 * counts[1] + 2.0)) ** 2
               + math.sin(math.pi / (2.0 * counts[0] + 2.0)) ** 2)
    elif len(counts) == 3:
        eps = (math.sin(math.pi / (2.0 * counts[2] + 2.0)) ** 2
               + math.sin(math.pi / (2.0 * counts[1] + 2.0)) ** 2
               + math.sin(math.pi / (2.0 * counts[0] + 3.0)) ** 2)
    else:
        raise ValueError("1-3 core dims supported")
    return 2.0 / (1.0 + math.sqrt((2.0 - eps) * eps))


@dataclasses.dataclass(frozen=True)
class Grid:
    """Static geometry of an inversion problem.

    Attributes
    ----------
    dims:    core dim names ordered slowest..fastest, e.g. ('lev','lat','lon')
    coords:  the raw 1-D coordinate arrays (degrees for spherical dims)
    coord_type: one of 'lat-lon', 'z-lat', 'z-lon', 'cartesian', 'lat'
    deltas:  physical spacing per dim in metres (or native units), ordered
             like dims.  Matches the reference's (del3, del2, del1).
    bcs:     boundary condition per dim, ordered like dims.
    """

    dims: Tuple[str, ...]
    coords: Tuple[np.ndarray, ...]
    coord_type: str
    deltas: Tuple[float, ...]
    bcs: Tuple[str, ...]
    rearth: float = 6371200.0

    # ------------------------------------------------------------ constructors
    @staticmethod
    def make(dims, coords, coord_type="lat-lon", bcs=None, rearth=6371200.0) -> "Grid":
        """Build a Grid; converts degree spacings to metres per the reference
        rules (apps.py:2192-2194, :2269-2275, :2335-2336)."""
        dims = tuple(dims)
        coords = tuple(np.asarray(c, dtype=np.float64) for c in coords)
        n = len(dims)
        if bcs is None:
            bcs = ("fixed",) * n
        bcs = tuple(bcs)
        if len(bcs) != n or len(coords) != n:
            raise ValueError("dims, coords and bcs must have equal length")
        for bc in bcs:
            if bc not in BCS:
                raise ValueError(f"unsupported BC {bc}, must be one of {BCS}")

        ct = coord_type.lower()
        steps = [_uniform_step(c, d) for c, d in zip(coords, dims)]
        # which dims are angular (degrees) and need deg->m scaling
        if n == 3:
            if ct == "lat-lon":        # (lev, lat, lon)
                ang = (False, True, True)
            elif ct == "cartesian":
                ang = (False, False, False)
            else:
                raise ValueError(f"unsupported coord_type for 3D: {coord_type}")
        elif n == 2:
            if ct == "lat-lon":        # (lat, lon)
                ang = (True, True)
            elif ct in ("z-lat", "z-lon"):   # (z, lat) / (z, lon)
                ang = (False, True)
            elif ct == "cartesian":
                ang = (False, False)
            else:
                raise ValueError(f"unsupported coord_type for 2D: {coord_type}")
        elif n == 1:
            if ct == "lat":
                ang = (True,)
            elif ct == "cartesian":
                ang = (False,)
            else:
                raise ValueError(f"unsupported coord_type for 1D: {coord_type}")
        else:
            raise ValueError("1-3 core dims supported")

        deltas = tuple(
            (_DEG2RAD * s * rearth) if a else s for s, a in zip(steps, ang)
        )
        return Grid(dims, coords, ct, deltas, bcs, rearth)

    # -------------------------------------------------------------- properties
    @property
    def ndim(self) -> int:
        return len(self.dims)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(len(c) for c in self.coords)

    @property
    def del1(self) -> float:
        """Spacing of the fastest (last) dim — the reference's del1."""
        return self.deltas[-1]

    @property
    def ratios(self) -> Tuple[float, ...]:
        """del1/del_k for the slower dims: 2D -> (ratio,), 3D -> (ratio2, ratio1)
        where ratio2 = del1/del3 (z) and ratio1 = del1/del2 (y)."""
        d1 = self.deltas[-1]
        return tuple(d1 / d for d in self.deltas[:-1])

    @property
    def omega_opt(self) -> float:
        return optimal_omega(self.shape)

    def periodic_axes(self, offset: int = 0) -> Tuple[int, ...]:
        """Axes (relative to the core block, plus offset) that are periodic.

        Note: the reference kernels honour 'periodic' only on the LAST (x)
        dim (numbas.py has periodic stanzas only for i); we replicate that in
        the stencil builders but keep the general machinery here.
        """
        return tuple(i + offset for i, bc in enumerate(self.bcs) if bc == "periodic")
