#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Smoke run of the PyTorch / CUDA port (xinvert_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

It imports only torch, numpy and xinvert_tpu_torch, builds its inputs from a
seed, and runs these phases, each printing its lines:

  0  environment: CUDA must be available; the card's name and power limit
     (nvidia-smi), torch and CUDA versions;
  1  build: nvcc compiles xinvert_tpu_torch/csrc/sor2d.cu and csrc/sor3d.cu,
     one process per source started together (first use), with the seconds
     each took and ptxas's registers and spills of the tiled kernels and
     the 3-D color sweep;
  2  each kernel against its plain PyTorch version on the card: bit-equal
     (torch.equal) in float32 and float64 on several 2-D grids and 3-D
     volumes (every shape the main paths below drive): the two tiled 2-D
     kernels over n in {1, k, 20, 37} sweeps, at omega and with Chebyshev
     factors; the first version's kernels (extend, color sweep, in-place
     color sweep) alone and over 20 sweeps; the 3-D pair, with the extend
     pre-pass folded into the red launch over n in {1, 2, 37} with factors,
     NaN/Inf-seeded boundary rows, the folded red launch alone, and the
     first version's three launches a sweep (sor3d_sweeps_pair); the fused
     |S| sums against sum|S| (rtol 1e-5 / 1e-12); multigrid's point smoother
     (mg._smooth) on every level of three pyramids (bench.py's 2048x2048
     Poisson, the SODA Stommel-Munk biharmonic one, a Fofonoff-like
     standard_2d_e one), n in {1, 2, 3, 60}, one state and a batch under a
     batched forcing, the in-place switch off and on;
  3  the main paths, in float32 and with no device argument (the entry
     points default to the card): invert_Poisson at 2048x2048 and at a
     batched 8x73x144; invert_omega at 37x72x288; invert_3DOcean at
     30x330x720; on the SODA-class monthly curl at 12x330x720,
     invert_Stommel with the in-place switch on and off (the same iters and
     bit-equal states), invert_StommelMunk, and invert_Stommel with
     scheme="cheby"; invert_Poisson 2048x2048 again through the in-place
     kernel (equal to the first run).  Each path runs with every launch
     count set to 0 just before it and read just after, which must show it
     went through its kernels alone (in 2-D the tiled kernels, with no
     launch of the first version's), most then once more under
     torch.profiler for the device's busy time against the wall time.
     Each 2-D path runs again through the first version's three launches a
     sweep, which must give the same iters and bit-equal states; so does
     invert_3DOcean, whose folded run must launch sor3d_extend_rows 0
     times.  Smaller
     runs of the same calls are held against a float64 CPU run
     (device="cpu", the plain version): Poisson 8x73x144, omega 37x72x144,
     ocean 20x110x240, and the three SODA calls at 2x110x240 (mxLoop cut to
     2000), within 1e-4 of max|S|.  Then the direct engine
     (scheme="direct", float32 and float64, no device argument, no kernel
     launch): bench.py's 2048x2048 spherical Poisson unmasked, its wall
     time and residual, its gap to float64 and to SOR at mxLoop 4000 (mean
     removed); a float64 manufactured-field check at 2048x2048 (within
     1e-7); the capacitance path on a 0.25-degree 720x1440 grid with a
     2000-cell island (time split, residual, below 1e-8 in float64, gap to
     SOR); the 2048x2048 blob mask, past MAX_HOLES, which must warn and
     give phase 3's SOR field exactly.  Then the multigrid paths, float32, no
     device argument: solve_mg with full multigrid on bench.py's 2048x2048
     masked Poisson (must converge to 1e-6 through the tiled kernel alone),
     invert_Stommel_mg on the SODA curl (12 months), invert_StommelMunk_mg
     on 2 of its months, invert_omega_mg at 37x72x288, invert_3DOcean_mg at
     30x330x720: cycles, residual, converged, wall and set-up seconds, host
     syncs, the idle share (of the whole 2048x2048 solve; of one V-cycle
     of the others), and the field beside the SOR one; smaller runs
     against float64 on the CPU (256x256, 2x55x120, the cartesian Munk
     gyre 65x129, 37x36x72, 20x55x120), within 1e-4 of max|S|;
  4  timing, float32: solve_fixed, 500 sweeps per call, median of 5 chained
     calls timed with CUDA events, for the kernels and the plain version,
     beside a device-to-device copy of the bytes a sweep of the kernels
     must move (2-D 2048x2048, float64 too; 3-D 37x72x288, 73x72x288,
     30x330x720); in 2-D at 2048x2048, Stommel and Stommel-Munk 12x330x720,
     the tiled kernels per sweep in turns against the first version's pair
     and B3, and a scan of sweeps per launch and window width beside the
     plan's choice; each kernel's device time per launch (CUDA events
     around back-to-back launches queued behind a device-side spin, so no
     host gap counts), per sweep for the tiled kernels, beside its plain
     version's, its bound (k sweeps for the tiled kernels) and a copy of
     its bytes; the folded 3-D pair per sweep in turns against the first
     version, and its red launch (folded and not) against the black one;
     where a 2048x2048 V-cycle's device time goes (smoothing
     against the rest), its wall time and host gap, host syncs per cycle.

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.  Any failed phase raises, and the
script exits non-zero without printing that line.
"""
import dataclasses
import inspect
import json
import math
import os
import subprocess
import time
import warnings

import numpy as np
import torch

import xinvert_tpu_torch as xt
from xinvert_tpu_torch import mg
from xinvert_tpu_torch.grid import Grid
from xinvert_tpu_torch.models import api, problems
from xinvert_tpu_torch.models.params import default_mParams
from xinvert_tpu_torch.ops import _build, sor2d, sor3d
from xinvert_tpu_torch.stencil import (StencilSpec, _interior_mask,
                                       prune_zero_offsets, standard_2d)

KERNELS = {   # name: (source, replaces, also_replaces)
    "sor2d_sweeps_tiled": ("xinvert_tpu_torch/csrc/sor2d.cu",
                           "xinvert_tpu/ops/pallas_sor_window.py:252",
                           "xinvert_tpu/ops/pallas_sor.py:94"),
    "sor2d_sweeps_tiled_inplace": ("xinvert_tpu_torch/csrc/sor2d.cu",
                                   "xinvert_tpu/ops/pallas_sor_window.py:414",
                                   None),
    "sor2d_extend_rows": ("xinvert_tpu_torch/csrc/sor2d.cu",
                          "xinvert_tpu/ops/pallas_sor.py:43",
                          "xinvert_tpu/ops/pallas_sor_window.py:67"),
    "sor2d_color_sweep": ("xinvert_tpu_torch/csrc/sor2d.cu",
                          "xinvert_tpu/ops/pallas_sor.py:94",
                          "xinvert_tpu/ops/pallas_sor_window.py:252"),
    "sor2d_color_sweep_inplace": ("xinvert_tpu_torch/csrc/sor2d.cu",
                                  "xinvert_tpu/ops/pallas_sor_window.py:414",
                                  None),
    "sor3d_extend_rows": ("xinvert_tpu_torch/csrc/sor3d.cu",
                          "xinvert_tpu/ops/pallas_sor3d.py:50",
                          "xinvert_tpu/ops/pallas_sor3d_window.py:174"),
    "sor3d_color_sweep": ("xinvert_tpu_torch/csrc/sor3d.cu",
                          "xinvert_tpu/ops/pallas_sor3d.py:75",
                          "xinvert_tpu/ops/pallas_sor3d_window.py:174"),
}
# each kernel's launch counter
COUNTERS = {"sor2d_sweeps_tiled": (sor2d, "TILED_LAUNCHES"),
            "sor2d_sweeps_tiled_inplace": (sor2d, "TILED_INPLACE_LAUNCHES"),
            "sor2d_extend_rows": (sor2d, "EXTEND_LAUNCHES"),
            "sor2d_color_sweep": (sor2d, "LAUNCHES"),
            "sor2d_color_sweep_inplace": (sor2d, "INPLACE_LAUNCHES"),
            "sor3d_extend_rows": (sor3d, "EXTEND_LAUNCHES"),
            "sor3d_color_sweep": (sor3d, "LAUNCHES")}
# published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): HBM
# bytes/s and float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BIH_OFFSETS = ((2, 0), (1, 0), (-1, 0), (-2, 0), (0, 2), (0, 1), (0, -1),
               (0, -2), (2, 2), (2, -2), (-2, 2), (-2, -2), (1, 1), (-1, 1),
               (1, -1), (-1, -1))
OFFSETS_3D = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
              (0, 0, -1))
DIMS_3D = ["LEV", "lat", "lon"]


def log(msg):
    print(msg, flush=True)


# ----------------------------------------------------------------- inputs

def poisson_field(ny, nx, batch=0, seed=0, masked=True):
    """The masked spherical Poisson forcing: sin(3 lon) cos(2 lat) + 0.1
    noise on a lat-lon grid, NaN over a continent-shaped block (``masked``;
    without it, __graft_entry__._poisson_problem(masked=False)'s field)."""
    lat = np.linspace(-88.75, 88.75, ny)
    lon = np.linspace(0.0, 360.0 - 360.0 / nx, nx)
    rng = np.random.default_rng(seed)
    llat, llon = np.deg2rad(lat)[:, None], np.deg2rad(lon)[None, :]
    shape = (batch, ny, nx) if batch else (ny, nx)
    vor = np.sin(3 * llon) * np.cos(2 * llat) + 0.1 * rng.standard_normal(shape)
    if masked:
        vor[..., ny // 3:ny // 2, nx // 4:nx // 2] = np.nan
    dims = (("time",) if batch else ()) + ("lat", "lon")
    coords = {"lat": lat, "lon": lon}
    if batch:
        coords["time"] = np.arange(batch)
    return xt.Field(vor, dims, coords)


def poisson_spec(ny, nx, batch, dtype, device, seed=0):
    f = poisson_field(ny, nx, batch, seed)
    vals = torch.as_tensor(f.values, dtype=dtype, device=device)
    Fdef = ~torch.isnan(vals)
    Fdef_c = Fdef[0] if batch else Fdef        # the mask is batch-invariant
    grid = Grid.make(("lat", "lon"), (f.coords["lat"], f.coords["lon"]),
                     "lat-lon", bcs=("extend", "periodic"))
    spec = problems.build_poisson(vals, Fdef_c, grid, default_mParams)
    return spec, grid.omega_opt


def cross_spec(ny, nx, bcs, dtype, device, seed=1):
    """standard_2d with cross terms (8 offsets) and a masked block."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    A = np.abs(rng.normal(1.0, 0.1, (ny, nx))) + 0.5
    B = rng.normal(0.0, 0.05, (ny, nx))
    C = np.abs(rng.normal(1.0, 0.1, (ny, nx))) + 0.5
    Fdef = np.ones((ny, nx), bool)
    Fdef[ny // 3:ny // 2, nx // 4:nx // 2] = False
    spec = standard_2d(t(A), t(B), t(C), t(rng.normal(0, 1, (ny, nx))),
                       torch.as_tensor(Fdef, device=device), (1.1e5, 1.0e5),
                       bcs)
    assert len(spec.offsets) == 8
    return spec, 1.3


def random_spec(core, offsets, bcs, bih, batch, per_slice, dtype, device,
                seed=2):
    """A diagonally dominant spec from random planes (from_arrays) on a
    2-D grid or 3-D volume ``core``."""
    rng = np.random.default_rng(seed)
    core = tuple(core)
    shape = ((batch,) + core) if (batch and per_slice) else core
    active = np.broadcast_to(_interior_mask(core, bcs, bih), shape).copy()
    active &= rng.random(shape) > 0.05
    w = rng.uniform(0.05, 0.25, (len(offsets),) + shape) * active
    w0 = np.where(active, -1.05 * w.sum(0), 0.0)
    relax = np.where(active, 1.0 / np.where(active, -w0, 1.0), 0.0)
    g = rng.normal(0.0, 1.0, ((batch,) if batch else ()) + core) * active
    spec = StencilSpec.from_arrays(w, w0, g, relax, active, offsets, bcs, bih,
                                   False, device=device, dtype=dtype)
    return spec, 1.2


def atmos3d(nz, ny, nx, batch=0):
    """The QG-omega forcing and N2 level profile of the repository's
    atmosphere fixture recipe (baroclinic wave train at mid-latitudes,
    weak troposphere / strong stratosphere stratification); ``batch``
    stacks scaled copies on a leading time dim."""
    lev = np.linspace(100000.0, 10000.0, nz)
    lat = np.linspace(-87.5, 87.5, ny)
    lon = np.linspace(0.0, 360.0 - 360.0 / nx, nx)
    L = np.deg2rad(lat)[None, :, None]
    Lo = np.deg2rad(lon)[None, None, :]
    P = lev[:, None, None]
    N2 = np.where(lev > 25000.0, 1.5e-5, 6e-5)
    rng = np.random.default_rng(2)
    envelope = np.exp(-((np.abs(L) - np.deg2rad(45)) / np.deg2rad(15)) ** 2)
    vertical = np.sin(np.pi * (100000.0 - P) / 90000.0)
    F = np.zeros((nz, ny, nx))
    for k in range(4, 9):
        F += (rng.normal() * np.sin(k * Lo + rng.uniform(0, 6)) *
              envelope * vertical / k)
    F *= 1e-15
    coords = {"LEV": lev, "lat": lat, "lon": lon}
    dims = tuple(DIMS_3D)
    if batch:
        F = F[None] * np.linspace(1.0, -0.5, batch)[:, None, None, None]
        dims = ("time",) + dims
        coords["time"] = np.arange(batch, dtype=np.float64)
    return (xt.Field(F, dims, coords),
            xt.Field(N2, ("LEV",), {"LEV": lev}))


def soda_land_mask(lat, lon):
    """Continent-like land/sea mask of the 0.5-degree global ocean grid
    (the repository's SODA-analog fixture recipe): smooth blob continents,
    an Antarctic cap and a partially closed Arctic."""
    L, Lo = np.meshgrid(np.deg2rad(lat), np.deg2rad(lon), indexing="ij")
    field = np.zeros_like(L)
    blobs = [
        (10, 280, 1.6, 55, 25), (-25, 295, 1.2, 30, 18),
        (15, 20, 1.7, 45, 30), (50, 80, 1.5, 35, 55),
        (-25, 133, 1.0, 18, 22), (72, 320, 0.9, 12, 25),
    ]
    for lat0, lon0, amp, sy, sx in blobs:
        dlat = (L - np.deg2rad(lat0)) / np.deg2rad(sy)
        dlon = np.angle(np.exp(1j * (Lo - np.deg2rad(lon0)))) / np.deg2rad(sx)
        field += amp * np.exp(-dlat ** 2 - dlon ** 2)
    land = field > 0.55
    land |= lat[:, None] < -70.0                     # Antarctica
    land |= (lat[:, None] > 82.0) & (np.cos(2 * Lo) > -0.3)   # Arctic shelf
    return land


def soda_curl(months=12, step=1):
    """The SODA-class monthly wind-stress curl of the 0.5-degree global
    ocean (the repository's SODA-analog fixture recipe,
    tools/make_fixtures.py::make_soda_curl): subtropical and subpolar gyre
    bands with a seasonal cycle and deterministic synoptic texture, NaN
    over the land mask; the first ``months`` months at every ``step``-th
    point."""
    ny, nx = 330, 720
    lat = np.linspace(-74.75, 89.75, ny)
    lon = np.linspace(0.25, 360.0 - 360.0 / nx + 0.25, nx)
    land = soda_land_mask(lat, lon)
    L = np.deg2rad(lat)[:, None]
    Lo = np.deg2rad(lon)[None, :]
    rng = np.random.default_rng(3)
    texture = np.zeros((ny, nx))
    for k in range(2, 8):
        texture += (rng.normal() * np.sin(k * Lo + rng.uniform(0, 6)) *
                    np.cos((k - 1) * L) / k)
    months_idx = np.arange(12)
    seasonal = 1.0 + 0.35 * np.cos(2 * np.pi * (months_idx - 1) / 12.0)
    base = (np.sin(3 * L) * np.cos(L) + 0.25 * np.sin(5 * L)) * 1e-7
    curl = (seasonal[:, None, None] * base[None]
            + 2e-8 * texture[None] * np.cos(L)[None])
    curl = np.where(land[None], np.nan, curl)[:months, ::step, ::step]
    coords = {"time": months_idx[:months].astype(np.float64),
              "lat": lat[::step], "lon": lon[::step]}
    return xt.Field(curl, ("time", "lat", "lon"), coords)


def ocean3d(nz, step=1):
    """The wide, flat global ocean volume of the 3-D ocean example: the
    0.5-degree 330x720 land mask (every ``step``-th point), ``nz`` levels
    150 m apart, deep cells shrinking below level 12 (a crude shelf),
    high-latitude mass sources over a uniform sink decaying with depth,
    and an exponential N2 profile."""
    lat_f = np.linspace(-74.75, 89.75, 330)
    lon_f = np.linspace(0.25, 360.0 - 360.0 / 720 + 0.25, 720)
    land2d = soda_land_mask(lat_f, lon_f)[::step, ::step]
    lat, lon = lat_f[::step], lon_f[::step]
    lev = np.linspace(0.0, 150.0 * (nz - 1), nz)
    mask = np.broadcast_to(~land2d, (nz,) + land2d.shape).copy()
    mask[12:] &= np.roll(mask[0], 2, axis=0)
    zprof = np.exp(-lev / 700.0)[:, None, None]
    src = np.exp(-((lat[None, :, None] - 62.0) / 8.0) ** 2) \
        + np.exp(-((lat[None, :, None] + 58.0) / 8.0) ** 2)
    F = np.broadcast_to(1e-11 * zprof * (src - 0.35), mask.shape)
    F = np.where(mask, F, np.nan)
    coords = {"LEV": lev, "lat": lat, "lon": lon}
    N2 = xt.Field(1e-5 * np.exp(-lev / 1000.0) + 1e-7, ("LEV",),
                  {"LEV": lev})
    return xt.Field(F, tuple(DIMS_3D), coords), N2


OCEAN_MP = {"epsilon": 7e-6, "k": 1e-5}


def _grid3(f, bcs):
    return Grid.make(DIMS_3D, [f.coords[d] for d in DIMS_3D], "lat-lon",
                     bcs=bcs)


def omega_spec(nz, ny, nx, batch, dtype, device):
    """build_omega on the fixture recipe, (fixed, fixed, periodic): batched
    forcing, shared weights."""
    F, N2 = atmos3d(nz, ny, nx, batch)
    grid = _grid3(F, ("fixed", "fixed", "periodic"))
    vals = torch.as_tensor(F.values, dtype=dtype, device=device)
    mp = dict(default_mParams, N2=N2.values[:, None, None])
    spec = problems.build_omega(
        vals, torch.ones((nz, ny, nx), dtype=torch.bool, device=device),
        grid, mp)
    return spec, grid.omega_opt


def ocean_spec(nz, dtype, device, step=1):
    """build_ocean3d (general_3d) on the masked ocean volume of
    :func:`ocean3d`, (fixed, extend, periodic)."""
    F, N2 = ocean3d(nz, step)
    grid = _grid3(F, ("fixed", "extend", "periodic"))
    vals = torch.as_tensor(F.values, dtype=dtype, device=device)
    Fdef = ~torch.isnan(vals)
    mp = dict(default_mParams, N2=N2.values[:, None, None], **OCEAN_MP)
    return problems.build_ocean3d(vals, Fdef, grid, mp), 1.4


# the SODA workloads of tests/test_ocean_workloads.py (the reference's
# test_StommelWBC.py and test_MunkWBC.py): Stommel R 2e-4, D 100;
# Stommel-Munk with A4 5e3
STOMMEL_MP = {"R": 2e-4, "D": 100}
MUNK_MP = {"R": 2e-4, "D": 100, "A4": 5e3}


def soda_spec(builder, mp, months, dtype, device, step=1):
    """A builder of models.problems on the SODA-class curl, (extend,
    periodic), pruned as solve prunes it: Stommel's zero cross planes go
    (4 offsets, radius 1), Stommel-Munk keeps 8 of its 16."""
    f = soda_curl(months, step)
    grid = Grid.make(("lat", "lon"), (f.coords["lat"], f.coords["lon"]),
                     "lat-lon", bcs=("extend", "periodic"))
    vals = torch.as_tensor(f.values, dtype=dtype, device=device)
    Fdef = ~torch.isnan(vals[0])              # the land mask of every month
    spec = builder(vals, Fdef, grid, dict(default_mParams, **mp))
    return prune_zero_offsets(spec), 1.0


# ------------------------------------------------------- multigrid inputs

def extra_mg_pyramid(dtype, device, n=2048):
    """The JAX package's bench.py multigrid problem (``_extra_mg``),
    rebuilt from its recipe: an n x n cartesian Poisson, A = C = 1, F =
    N(0, 1) * 1e-9 from seed 0, the block [n/3:n/2, n/4:n/2] masked,
    spacing 1e5, BCs fixed/fixed; its point-smoothed pyramid."""
    rng = np.random.default_rng(0)
    A = torch.ones((n, n), dtype=dtype, device=device)
    F = torch.as_tensor((rng.normal(0, 1, (n, n)) * 1e-9).astype(np.float32),
                        dtype=dtype, device=device)
    Fdef = torch.ones((n, n), dtype=torch.bool, device=device)
    Fdef[n // 3:n // 2, n // 4:n // 2] = False
    return mg.build_pyramid_standard2d(A, 0.0, A, F, Fdef, (1.0e5, 1.0e5),
                                       ("fixed", "fixed"))


def soda_munk_pyramid(dtype, device):
    """The biharmonic Stommel-Munk pyramid of the SODA-class curl
    (12x330x720, extend/periodic, the land mask), 16 offsets on every
    level (multigrid does not prune)."""
    f = soda_curl(12)
    grid = Grid.make(("lat", "lon"), (f.coords["lat"], f.coords["lon"]),
                     "lat-lon", bcs=("extend", "periodic"))
    vals = torch.as_tensor(f.values, dtype=dtype, device=device)
    Fdef = ~torch.isnan(vals[0])
    coeffs, _ = problems.stommelmunk_coeffs(
        vals, Fdef, grid, dict(default_mParams, **MUNK_MP))
    return mg.build_pyramid_bih2d(
        coeffs, torch.zeros(grid.shape, dtype=dtype, device=device), Fdef,
        grid.deltas, grid.bcs)


def fofonoff_pyramid(dtype, device, ny=257, nx=385):
    """A Fofonoff-like standard_2d_e pyramid (cartesian, fixed/fixed, the
    screening term -c0 psi): level 0 standard_2d_e, coarser levels the
    upwinded general_2d with its 8 cross and first-derivative offsets."""
    y = np.linspace(0.0, 5e5, ny)
    x = np.linspace(0.0, 6e5, nx)
    grid = Grid.make(("y", "x"), (y, x), "cartesian", bcs=("fixed", "fixed"))
    F = torch.zeros((ny, nx), dtype=dtype, device=device)
    Fdef = torch.ones((ny, nx), dtype=torch.bool, device=device)
    A, B, C, D, E, Fs = problems.fofonoff_e_coeffs(
        F, Fdef, grid, dict(default_mParams, f0=1e-4, beta=2e-11, c0=8e-9,
                            c1=1e-4))
    return mg.build_pyramid_standard2d_e(A, B, C, D, E, Fs, Fdef,
                                         grid.deltas, grid.bcs)


MG_PYRAMIDS = {
    "multigrid main path 2048x2048 masked Poisson (fixed, fixed)":
        extra_mg_pyramid,
    "multigrid Stommel-Munk bih 330x720 SODA (extend, periodic)":
        soda_munk_pyramid,
    "multigrid Fofonoff-like standard_2d_e 257x385 (fixed, fixed)":
        fofonoff_pyramid,
}


# ---------------------------------------------------------------- phase 0

def phase0():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this smoke "
                           "run needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0].strip()
    log("[0] environment")
    log(card)
    log(f"[0] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}; CPU threads "
        f"{torch.get_num_threads()} of {len(os.sched_getaffinity(0))} cores")
    return card


# ---------------------------------------------------------------- phase 1

def phase1():
    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.SOURCES:
        _build.load(name)
    nvcc = ", ".join(f"{name}.cu {_build.BUILD_SECONDS[name]:.3f} s"
                     if name in _build.BUILD_SECONDS
                     else f"{name}.cu already built"
                     for name in _build.SOURCES)
    log(f"[1] kernels built and loaded in {time.perf_counter() - t0:.3f} s "
        f"(nvcc in parallel: {nvcc}; flags {' '.join(_build.NVCC_FLAGS)})")
    # ptxas -v on the tiled kernels and the 3-D color sweep (the extend
    # read-through's registers): registers, spills, shared memory
    for src, key in (("sor2d", "tiled"), ("sor3d", "color_sweep")):
        lines = _build.BUILD_LOG.get(src, "").splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and key in line:
                inst = line.split("'")[1] if "'" in line else line
                info = " | ".join(x.split(":", 1)[-1].strip()
                                  for x in lines[i + 2:i + 4])
                log(f"[1] ptxas {inst}: {info}")


# ---------------------------------------------------------------- phase 2

def _max_err(a, b):
    return float((a.double() - b.double()).abs().max())


def _check_kernels(mod, name, make, errs, n=20):
    """Each kernel of ``mod`` alone and n sweeps of them, against the plain
    versions, in float32 and float64: the color sweep with and without a
    Chebyshev factor, and, where the spec takes it, the in-place color
    sweep and the sweeps through it (``sor2d.INPLACE_KERNEL`` set); in 2-D
    the sweeps of the first version (``sor2d_sweeps_pair``) and the tiled
    kernels (:func:`_check_tiled`); raises on any difference."""
    p = mod.__name__.rsplit(".", 1)[-1]           # "sor2d" / "sor3d"
    extend, extend_ref = (getattr(mod, f"{p}_extend"),
                          getattr(mod, f"{p}_extend_reference"))
    color, color_ref = (getattr(mod, f"{p}_color_sweep"),
                        getattr(mod, f"{p}_color_sweep_reference"))
    sweeps = sor2d.sor2d_sweeps_pair if p == "sor2d" else mod.sor3d_sweeps
    sweeps_ref = getattr(mod, f"{p}_sweeps_reference")
    core = (-3, -2, -1) if p == "sor3d" else (-2, -1)
    for dt, rtol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        spec, omega = make(dt)
        inplace = p == "sor2d" and sor2d.inplace_eligible(
            spec, tuple(spec.g.shape[-2:]))
        gen = torch.Generator(device="cpu").manual_seed(7)
        S0 = (torch.randn(spec.g.shape, generator=gen, dtype=torch.float64)
              * 1e-3).to(dt).to(spec.g.device)
        ext_k = extend(spec, S0)
        ext_p = extend_ref(spec, S0)
        ok = torch.equal(ext_k, ext_p)
        errs[f"{p}_extend_rows"] = max(errs[f"{p}_extend_rows"],
                                       _max_err(ext_k, ext_p))
        rel = mod.relax_plane(spec, omega)
        fac_1 = float(torch.tensor(1.37, dtype=dt))
        for c in (0, 1):
            for fac in (1.0, fac_1):
                cs_k = color(spec, ext_k, rel, c, fac)
                cs_p = color_ref(spec, ext_p, rel, c, fac)
                ok &= torch.equal(cs_k, cs_p)
                errs[f"{p}_color_sweep"] = max(errs[f"{p}_color_sweep"],
                                               _max_err(cs_k, cs_p))
                if inplace:
                    ip_k = sor2d.sor2d_color_sweep_inplace(spec, ext_k, rel,
                                                           c, fac)
                    ip_p = sor2d.sor2d_color_sweep_inplace_reference(
                        spec, ext_p, rel, c, fac)
                    ok &= torch.equal(ip_k, ip_p)
                    errs["sor2d_color_sweep_inplace"] = max(
                        errs["sor2d_color_sweep_inplace"],
                        _max_err(ip_k, ip_p))
        # n sweeps at omega, and n cheby sweeps (omega 1 with factors)
        facs = [float(torch.tensor(1.0 + 0.45 * (1 - 0.9 ** k), dtype=dt))
                for k in range(2 * n)]
        kernels = [f"{p}_extend_rows", f"{p}_color_sweep"]
        runs = [(False, omega, None), (False, 1.0, facs)]
        if inplace:
            kernels.append("sor2d_color_sweep_inplace")
            runs += [(True, omega, None), (True, 1.0, facs)]
        norm_err = 0.0
        for switch, om, fac in runs:
            sor2d.INPLACE_KERNEL = switch
            i0 = sor2d.INPLACE_LAUNCHES
            out_k = sweeps(spec, S0, om, n, fac=fac)
            out_n, sumabs = sweeps(spec, S0, om, n, with_norm=True, fac=fac)
            sor2d.INPLACE_KERNEL = False
            out_p = sweeps_ref(spec, S0, om, n, fac)
            torch.cuda.synchronize()
            ok &= (sor2d.INPLACE_LAUNCHES > i0) == switch
            err = _max_err(out_k, out_p)
            for k in kernels:
                errs[k] = max(errs[k], err)
            ok &= torch.equal(out_k, out_p) and torch.equal(out_n, out_k)
            ok &= bool(torch.isfinite(out_p).all())
            ref = out_p.double().abs().sum(dim=core)
            norm_err = max(norm_err, float(
                ((sumabs.double() - ref).abs() / ref).max()))
        log(f"[2] {name} {str(dt)[6:]}: bit-equal={ok} "
            f"(in-place kernel: {'checked' if inplace else 'not eligible'}) "
            f"max|kernel-plain|={err:.3e} sumabs rel err={norm_err:.3e} "
            f"(tol {rtol:g})")
        if not ok or not norm_err <= rtol:
            raise RuntimeError(f"kernel disagrees with its plain version "
                               f"on {name} {dt}")
        if p == "sor2d":
            _check_tiled(name, spec, omega, S0, rtol, errs)
        elif spec.bcs[-2] == "extend":
            _check_fold(name, spec, omega, S0, rtol, errs)


def _check_tiled(name, spec, omega, S0, rtol, errs):
    """Both tiled kernels (the in-place one where the spec takes it) over
    n in {1, k, 20, 37} sweeps, at omega and as cheby (omega 1 with 2n
    factors), against the plain version: torch.equal, finite, and the
    fused |S| sums of the last launch against sum|S|."""
    dt = S0.dtype
    shape = tuple(S0.shape[-2:])
    facs = [float(torch.tensor(1.0 + 0.45 * (1 - 0.9 ** k), dtype=dt))
            for k in range(74)]
    kinds = [("sor2d_sweeps_tiled", sor2d.sor2d_sweeps_tiled, False)]
    if sor2d.inplace_eligible(spec, shape):
        kinds.append(("sor2d_sweeps_tiled_inplace",
                      sor2d.sor2d_sweeps_tiled_inplace, True))
    for kname, fn, inplace in kinds:
        plan = sor2d.tile_plan(spec, shape, dt, inplace)
        counter = COUNTERS[kname][1]
        ok, norm_err, err = True, 0.0, 0.0
        for n in sorted({1, plan.k, 20, 37}):
            for om, fac in ((omega, None), (1.0, facs[:2 * n])):
                c0 = getattr(sor2d, counter)
                out, sumabs = fn(spec, S0, om, n, with_norm=True, fac=fac)
                ref = sor2d.sor2d_sweeps_reference(spec, S0, om, n, fac)
                torch.cuda.synchronize()
                ok &= getattr(sor2d, counter) == c0 + -(-n // plan.k)
                ok &= torch.equal(out, ref) and bool(
                    torch.isfinite(ref).all())
                err = max(err, _max_err(out, ref))
                tot = ref.double().abs().sum(dim=(-2, -1))
                norm_err = max(norm_err, float(
                    ((sumabs.double() - tot).abs() / tot).max()))
        errs[kname] = max(errs[kname], err)
        log(f"[2] {name} {str(dt)[6:]}: {kname} (k {plan.k}, tile "
            f"{plan.ty}x{plan.tx}, halo {plan.hy}x{plan.hx}, "
            f"{plan.threads} threads x {plan.cpt} cells) n in "
            f"{sorted({1, plan.k, 20, 37})}, with and without factors: "
            f"bit-equal={ok} max|kernel-plain|={err:.3e} sumabs rel err="
            f"{norm_err:.3e} (tol {rtol:g})")
        if not ok or not norm_err <= rtol:
            raise RuntimeError(f"{kname} disagrees with its plain version "
                               f"on {name} {dt}")


def _check_fold(name, spec, omega, S0, rtol, errs):
    """The 3-D pair with the extend pre-pass folded into the red launch
    (sor3d_sweeps, the solver's executor) over n in {1, 2, 37}, at omega
    and as cheby, against the plain version: torch.equal, finite, two
    launches a sweep and no extend launch, the fused |S| sums of the last
    black launch against sum|S|; NaN and Inf seeded in the boundary rows of
    the interior levels (the pre-pass overwrites them: finite, equal); the
    folded red launch alone; and the first version (sor3d_sweeps_pair:
    the extend launch, then the unfolded pair) over 37 sweeps, equal."""
    dt = S0.dtype
    facs = [float(torch.tensor(1.0 + 0.45 * (1 - 0.9 ** k), dtype=dt))
            for k in range(74)]
    ok, norm_err, err = True, 0.0, 0.0
    seeded = S0.clone()
    seeded[..., 1:-1, 0, :] = float("nan")
    seeded[..., 1:-1, -1, :] = float("inf")
    for n in (1, 2, 37):
        for om, fac in ((omega, None), (1.0, facs[:2 * n])):
            for S in ((S0, seeded) if n == 2 else (S0,)):
                l0, e0 = sor3d.LAUNCHES, sor3d.EXTEND_LAUNCHES
                out, sumabs = sor3d.sor3d_sweeps(spec, S, om, n,
                                                 with_norm=True, fac=fac)
                ref = sor3d.sor3d_sweeps_reference(spec, S, om, n, fac)
                torch.cuda.synchronize()
                ok &= (sor3d.LAUNCHES, sor3d.EXTEND_LAUNCHES) == (l0 + 2 * n,
                                                                  e0)
                ok &= torch.equal(out, ref) and bool(
                    torch.isfinite(ref).all())
                err = max(err, _max_err(out, ref))
                tot = ref.double().abs().sum(dim=(-3, -2, -1))
                norm_err = max(norm_err, float(
                    ((sumabs.double() - tot).abs() / tot).max()))
    rel = sor3d.relax_plane(spec, omega)
    for S in (S0, seeded):
        red = sor3d.sor3d_color_sweep(spec, S, rel, 0, facs[1], extend=True)
        ref = sor3d.sor3d_color_sweep_reference(spec, S, rel, 0, facs[1],
                                                extend=True)
        ok &= torch.equal(red, ref)
        err = max(err, _max_err(red, ref))
    e0 = sor3d.EXTEND_LAUNCHES
    first = sor3d.sor3d_sweeps_pair(spec, S0, 1.0, 37, fac=facs)
    ref = sor3d.sor3d_sweeps_reference(spec, S0, 1.0, 37, facs)
    torch.cuda.synchronize()
    ok &= sor3d.EXTEND_LAUNCHES == e0 + 37 and torch.equal(first, ref)
    errs["sor3d_color_sweep"] = max(errs["sor3d_color_sweep"], err)
    log(f"[2] {name} {str(dt)[6:]}: sor3d_color_sweep with the extend "
        f"pre-pass folded in, n in [1, 2, 37], with and without factors, "
        f"NaN/Inf-seeded boundary rows, the red launch alone, and the first "
        f"version's three launches a sweep: bit-equal={ok} "
        f"max|kernel-plain|={err:.3e} sumabs rel err={norm_err:.3e} "
        f"(tol {rtol:g})")
    if not ok or not norm_err <= rtol:
        raise RuntimeError(f"the folded 3-D pair disagrees with its plain "
                           f"version on {name} {dt}")


def _bit_equal(a, b):
    """torch.equal, NaN matching NaN in place."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(torch.where(na, 0.0, a),
                                               torch.where(nb, 0.0, b))


def _check_mg_smoothing(name, make, dev, errs):
    """mg._smooth on every level of a pyramid, through the solver's
    executor (the tiled kernels), against the plain version on the same
    CUDA tensors: torch.equal, in float32 and float64, n in {1, 2, 3, 60},
    one state and a batch of three under a batched g_override, with the
    in-place switch off and on (the in-place kernel where the gate takes
    the level); a smoothing that launched no tiled kernel or called the
    plain version fails.  A level whose smoothing diverges (the coarse
    levels of the SODA biharmonic pyramid do, as in the JAX package) must
    grow its NaN and Inf as the plain version does."""
    gen = torch.Generator(device="cpu").manual_seed(11)
    for dt, rtol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        levels = make(dt, dev)
        ok, checks, blown, used = True, 0, 0, set()
        for lv in levels:
            core = tuple(lv.spec.w0.shape)
            g3 = torch.randn((3,) + core, generator=gen, dtype=torch.float64)
            batched = dataclasses.replace(lv, spec=mg._with_g(
                lv.spec, g3.to(dtype=dt, device=dev)))
            for level, batch in ((lv, ()), (batched, (3,))):
                S = torch.randn(batch + core, generator=gen,
                                dtype=torch.float64).to(dtype=dt, device=dev)
                for switch in (False, True):
                    sor2d.INPLACE_KERNEL = switch
                    for n in (1, 2, 3, 60):
                        t0, i0 = (sor2d.TILED_LAUNCHES,
                                  sor2d.TILED_INPLACE_LAUNCHES)
                        p0 = sor2d.PLAIN_CALLS
                        out = mg._smooth(level, S, n)
                        ok &= sor2d.PLAIN_CALLS == p0
                        ref = sor2d.sor2d_sweeps_reference(level.spec, S,
                                                           level.omega, n)
                        torch.cuda.synchronize()
                        inplace = sor2d.TILED_INPLACE_LAUNCHES > i0
                        ok &= inplace or sor2d.TILED_LAUNCHES > t0
                        ok &= inplace == (switch and sor2d._use_inplace(
                            level.spec, core))
                        ok &= _bit_equal(out, ref)
                        blown += not bool(torch.isfinite(ref).all())
                        kname = TILED[inplace][0]
                        used.add(kname)
                        errs[kname] = max(errs[kname], _max_err(out, ref))
                        checks += 1
                    sor2d.INPLACE_KERNEL = False
        log(f"[2] {name} {str(dt)[6:]}: mg._smooth on levels "
            f"{[tuple(lv.spec.w0.shape) for lv in levels]} (omega "
            f"{[round(lv.omega, 4) for lv in levels]}), one state and a "
            f"batch of 3 under a batched g_override, n in {{1, 2, 3, 60}}, "
            f"in-place switch off and on: {checks} checks through "
            f"{sorted(used)}, bit-equal={ok} ({blown} of them grew "
            f"non-finite in both versions alike)")
        if not ok:
            raise RuntimeError(f"mg._smooth disagrees with the plain version "
                               f"on {name} {dt}")
        del levels


def phase2(dev):
    errs = {name: 0.0 for name in KERNELS}
    cases_2d = [
        ("gallery 3x73x144 (extend, periodic) masked",
         lambda dt: poisson_spec(73, 144, 3, dt, dev)),
        ("main path 8x73x144 (extend, periodic) masked",
         lambda dt: poisson_spec(73, 144, 8, dt, dev, seed=4)),
        ("201x301 (fixed, fixed) cross terms",
         lambda dt: cross_spec(201, 301, ("fixed", "fixed"), dt, dev)),
        ("main path 2048x2048 (extend, periodic) masked",
         lambda dt: poisson_spec(2048, 2048, 0, dt, dev)),
        ("main path Stommel 12x330x720 (extend, periodic) SODA, pruned",
         lambda dt: soda_spec(problems.build_stommel, STOMMEL_MP, 12, dt,
                              dev)),
        ("Stommel 2x110x240 (extend, periodic) SODA, pruned",
         lambda dt: soda_spec(problems.build_stommel, STOMMEL_MP, 2, dt, dev,
                              step=3)),
        ("main path Stommel-Munk bih 12x330x720 (extend, periodic) SODA, "
         "pruned", lambda dt: soda_spec(problems.build_stommelmunk, MUNK_MP,
                                        12, dt, dev)),
        ("Stommel-Munk bih 2x110x240 (extend, periodic) SODA, pruned",
         lambda dt: soda_spec(problems.build_stommelmunk, MUNK_MP, 2, dt,
                              dev, step=3)),
        ("bih 16-offset 29x31 (extend, fixed)",
         lambda dt: random_spec((29, 31), BIH_OFFSETS, ("extend", "fixed"),
                                True, 0, False, dt, dev)),
        ("bih 16-offset 2x33x37 (extend, periodic) per-slice planes",
         lambda dt: random_spec((33, 37), BIH_OFFSETS, ("extend", "periodic"),
                                True, 2, True, dt, dev, seed=3)),
        ("odd 2x37x53 (extend, fixed) per-slice planes",
         lambda dt: random_spec((37, 53), ((1, 0), (-1, 0), (0, 1), (0, -1)),
                                ("extend", "fixed"), False, 2, True, dt, dev,
                                seed=5)),
        ("odd 5x7 (extend, fixed) cross", lambda dt: random_spec(
            (5, 7), ((1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (-1, -1)),
            ("extend", "fixed"), False, 0, False, dt, dev, seed=6)),
    ]
    cases_3d = [
        ("omega 3x37x72x144 (fixed, fixed, periodic) batched g",
         lambda dt: omega_spec(37, 72, 144, 3, dt, dev)),
        ("main path omega 37x72x288 (fixed, fixed, periodic)",
         lambda dt: omega_spec(37, 72, 288, 0, dt, dev)),
        ("main path ocean general_3d 30x330x720 (fixed, extend, periodic) "
         "masked", lambda dt: ocean_spec(30, dt, dev)),
        ("ocean general_3d 20x110x240 (fixed, extend, periodic) masked",
         lambda dt: ocean_spec(20, dt, dev, step=3)),
        ("2x9x17x23 (fixed, extend, fixed) per-slice planes",
         lambda dt: random_spec((9, 17, 23), OFFSETS_3D,
                                ("fixed", "extend", "fixed"), False, 2, True,
                                dt, dev, seed=8)),
        ("odd 5x7x9 (fixed, extend, fixed)",
         lambda dt: random_spec((5, 7, 9), OFFSETS_3D,
                                ("fixed", "extend", "fixed"), False, 0, False,
                                dt, dev, seed=9)),
        ("one interior level 2x3x9x11 (fixed, extend, periodic) shared "
         "planes", lambda dt: random_spec((3, 9, 11), OFFSETS_3D,
                                          ("fixed", "extend", "periodic"),
                                          False, 2, False, dt, dev,
                                          seed=10)),
    ]
    for name, make in cases_2d:
        _check_kernels(sor2d, name, make, errs)
    for name, make in cases_3d:
        _check_kernels(sor3d, name, make, errs)
    t0 = time.perf_counter()
    for name, make in MG_PYRAMIDS.items():
        _check_mg_smoothing(name, make, dev, errs)
    log(f"[t] phase 2's multigrid smoothing checks took "
        f"{time.perf_counter() - t0:.1f} s")
    return errs


# ---------------------------------------------------------------- phase 3

def _zero_counts():
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)
    sor2d.PLAIN_CALLS = sor3d.PLAIN_CALLS = 0


def _check_field(out, field, name):
    land = np.isnan(field.values)
    vals = out.values
    if not (np.array_equal(np.isnan(vals), land)
            and np.isfinite(vals[~land]).all()):
        raise RuntimeError(f"{name}: NaN not exactly on the mask, or "
                           "non-finite values over the ocean")
    if bool(api.LAST_SOLVE.overflow.any()):
        raise RuntimeError(f"{name}: the solve overflowed")
    if not np.abs(vals[~land]).max() > 0:
        raise RuntimeError(f"{name}: the solution is zero")


def _drive(name, kernels, call, field, launches=None):
    """One call of an entry point with every count set to 0 just before it
    and read just after; it must have gone through ``kernels`` alone, with
    no plain call.  The full-size main-path runs add their launches to
    ``launches``."""
    _zero_counts()
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: getattr(mod, attr) for k, (mod, attr) in COUNTERS.items()}
    plain = sor2d.PLAIN_CALLS + sor3d.PLAIN_CALLS
    res = api.LAST_SOLVE
    ran = ", ".join(f"{k} {v}" for k, v in counts.items() if v)
    log(f"[3] {name} float32: iters {res.iters.cpu().tolist()} rel_change "
        f"{res.rel_change.cpu().tolist()} overflow "
        f"{res.overflow.cpu().tolist()} wall {wall:.3f} s; launches: "
        f"{ran}; plain calls {plain}")
    if {k for k, v in counts.items() if v} != set(kernels) or plain:
        raise RuntimeError(f"{name}: the main path did not run through "
                           f"{sorted(kernels)} alone")
    if launches is not None:
        for k, v in counts.items():
            launches[k] += v
    _check_field(out, field, name)
    return out


TILED = {False: ("sor2d_sweeps_tiled",),
         True: ("sor2d_sweeps_tiled_inplace",)}
FIRST = {False: ("sor2d_extend_rows", "sor2d_color_sweep"),
         True: ("sor2d_extend_rows", "sor2d_color_sweep_inplace")}


def _drive2d(name, call, field, inplace, launches):
    """A 2-D main path through the tiled kernels alone (the in-place one
    with ``inplace``, the switch set), then the same call through the
    first version's three launches a sweep (``sor2d_sweeps`` set to
    ``sor2d_sweeps_pair``, B3 where the switch takes the spec): the same
    iters, bit-equal states and fields.  Returns the tiled run as
    (Field, SolveResult)."""
    sor2d.INPLACE_KERNEL = inplace
    try:
        tiled = (_drive(name, TILED[inplace], call, field, launches),
                 api.LAST_SOLVE)
        tiled_sweeps = sor2d.sor2d_sweeps
        sor2d.sor2d_sweeps = sor2d.sor2d_sweeps_pair
        try:
            first = (_drive(f"{name}, first version", FIRST[inplace], call,
                            field), api.LAST_SOLVE)
        finally:
            sor2d.sor2d_sweeps = tiled_sweeps
    finally:
        sor2d.INPLACE_KERNEL = False
    _same(f"{name}, tiled vs first version", tiled, first)
    return tiled


def _profiled(call):
    """``call()`` under torch.profiler: (its result, the wall time, the
    device's busy time: the sum of its kernels and copies, which run in
    order on one stream)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(ev.self_device_time_total for ev in prof.key_averages()) / 1e6
    return out, wall, busy


def _idle(wall, busy):
    if not busy > 0:
        # the profiler's device trace is a diagnostic here, not a check
        return ("device busy not measured (torch.profiler recorded no "
                "device time)")
    return (f"device busy {busy:.4f} s of {wall:.4f} s wall, idle share "
            f"{1.0 - busy / wall:.3f}")


def _busy_share(name, call):
    """One more call of an entry point under torch.profiler: the device's
    busy time against the call's wall time."""
    _, wall, busy = _profiled(call)
    log(f"[3] {name} float32, profiled call: {_idle(wall, busy)}")


def _against_cpu(name, card_out, call):
    """The card's float32 answer against a float64 CPU run of ``call``."""
    torch.set_default_dtype(torch.float64)
    t0 = time.perf_counter()
    ref = call()
    cpu_s = time.perf_counter() - t0
    torch.set_default_dtype(torch.float32)
    ok = ~np.isnan(ref.values)
    dev = (np.abs(card_out.values[ok] - ref.values[ok]).max()
           / np.abs(ref.values[ok]).max())
    log(f"[3] {name} float32 card vs float64 CPU: max|diff|/max|S| = "
        f"{dev:.3e} (limit 1e-4); CPU iters "
        f"{api.LAST_SOLVE.iters.tolist()} in {cpu_s:.1f} s")
    if not dev <= 1e-4:
        raise RuntimeError(f"{name}: the card's answer disagrees with the "
                           "float64 CPU run")


def phase3():
    launches = {name: 0 for name in KERNELS}
    torch.set_default_dtype(torch.float32)
    iP_big = {"BCs": ["extend", "periodic"], "undef": np.nan,
              "mxLoop": 4000, "tolerance": 1e-8, "printInfo": False}
    iP_gal = {"BCs": ["extend", "periodic"], "undef": np.nan,
              "mxLoop": 5000, "tolerance": 1e-6, "printInfo": False}
    big = poisson_field(2048, 2048)
    gal = poisson_field(73, 144, batch=8, seed=1)
    out = {}
    for name, field, iP in (("2048x2048", big, iP_big),
                            ("8x73x144", gal, iP_gal)):
        call = lambda f=field, i=iP: xt.invert_Poisson(  # noqa: E731
            f, dims=["lat", "lon"], iParams=i)
        out[name] = _drive2d(f"invert_Poisson {name}", call, field, False,
                             launches)
        _busy_share(f"invert_Poisson {name}", call)

    iP_om = {"BCs": ["fixed", "fixed", "periodic"], "mxLoop": 2000,
             "tolerance": 1e-8, "printInfo": False}
    F_om, N2_om = atmos3d(37, 72, 288)
    call = lambda: xt.invert_omega(  # noqa: E731
        F_om, dims=DIMS_3D, mParams={"N2": N2_om}, iParams=iP_om)
    sor = {"omega": _drive("invert_omega 37x72x288", ("sor3d_color_sweep",),
                           call, F_om, launches)}
    _busy_share("invert_omega 37x72x288", call)
    iP_oc = {"BCs": ["fixed", "extend", "periodic"], "undef": np.nan,
             "mxLoop": 2000, "tolerance": 1e-8, "printInfo": False}
    F_oc, N2_oc = ocean3d(30)
    call = lambda: xt.invert_3DOcean(  # noqa: E731
        F_oc, dims=DIMS_3D, mParams=dict(OCEAN_MP, N2=N2_oc), iParams=iP_oc)
    sor["3docean"] = _drive3d("invert_3DOcean 30x330x720", call, F_oc,
                              launches)
    _busy_share("invert_3DOcean 30x330x720", call)

    # the 2-D families on the SODA-class curl, 12x330x720: Stommel with the
    # in-place switch on and off, which must agree bit for bit;
    # Stommel-Munk (biharmonic, the ping-pong kernel); Stommel with
    # scheme="cheby" (in place, with its factors); the reference
    # workload's iParams, a cheby omega that converges (1.3); each also
    # through the first version, equal
    iP_soda = {"BCs": ["extend", "periodic"], "undef": np.nan,
               "mxLoop": 5000, "tolerance": 1e-12, "optArg": 1,
               "printInfo": False}
    iP_cheby = dict(iP_soda, scheme="cheby", optArg=1.3)
    soda = soda_curl()
    paths = {
        "Stommel": lambda f, i, **kw: xt.invert_Stommel(
            f, dims=["lat", "lon"], iParams=i, mParams=STOMMEL_MP, **kw),
        "StommelMunk": lambda f, i, **kw: xt.invert_StommelMunk(
            f, dims=["lat", "lon"], iParams=i, mParams=MUNK_MP, **kw),
    }
    st_call = lambda: paths["Stommel"](soda, iP_soda)  # noqa: E731
    st_on = _drive2d("invert_Stommel 12x330x720 in-place", st_call, soda,
                     True, launches)
    sor2d.INPLACE_KERNEL = True
    _busy_share("invert_Stommel 12x330x720 in-place", st_call)
    sor2d.INPLACE_KERNEL = False
    st_off = _drive2d("invert_Stommel 12x330x720 ping-pong", st_call, soda,
                      False, launches)
    _busy_share("invert_Stommel 12x330x720 ping-pong", st_call)
    sor["stommel"] = st_off[0]
    _same("invert_Stommel 12x330x720, in-place vs ping-pong", st_on, st_off)
    munk_call = lambda: paths["StommelMunk"](soda, iP_soda)  # noqa: E731
    sor["stommelmunk"] = _drive2d("invert_StommelMunk 12x330x720", munk_call,
                                  soda, False, launches)[0]
    _busy_share("invert_StommelMunk 12x330x720", munk_call)
    cheby_call = lambda: paths["Stommel"](soda, iP_cheby)  # noqa: E731
    _drive2d("invert_Stommel cheby 12x330x720 in-place", cheby_call, soda,
             True, launches)
    sor2d.INPLACE_KERNEL = True
    _busy_share("invert_Stommel cheby 12x330x720 in-place", cheby_call)
    sor2d.INPLACE_KERNEL = False
    # invert_Poisson 2048x2048 through the in-place kernel against the
    # ping-pong run above
    call = lambda: xt.invert_Poisson(  # noqa: E731
        big, dims=["lat", "lon"], iParams=iP_big)
    big_on = _drive2d("invert_Poisson 2048x2048 in-place", call, big, True,
                      launches)
    _same("invert_Poisson 2048x2048, in-place vs ping-pong", big_on,
          out["2048x2048"])

    # answers against float64 runs of the same calls on the CPU (the plain
    # path), both sides checking every 32 sweeps as the card's float32 runs
    # do by default; the 3-D and SODA ones at sizes the CPU can afford (the
    # SODA ones with mxLoop cut to 2000)
    _against_cpu("invert_Poisson 8x73x144", out["8x73x144"][0],
                 lambda: xt.invert_Poisson(
                     gal, dims=["lat", "lon"],
                     iParams=dict(iP_gal, checkEvery=32), device="cpu"))
    F_s, N2_s = atmos3d(37, 72, 144)
    iP_s = dict(iP_om, checkEvery=32)
    om_out = _drive("invert_omega 37x72x144", ("sor3d_color_sweep",),
                    lambda: xt.invert_omega(F_s, dims=DIMS_3D,
                                            mParams={"N2": N2_s},
                                            iParams=iP_s), F_s)
    _against_cpu("invert_omega 37x72x144", om_out, lambda: xt.invert_omega(
        F_s, dims=DIMS_3D, mParams={"N2": N2_s}, iParams=iP_s, device="cpu"))
    F_d, N2_d = ocean3d(20, step=3)
    iP_d = dict(iP_oc, checkEvery=32)
    mP_d = dict(OCEAN_MP, N2=N2_d)
    oc_out = _drive("invert_3DOcean 20x110x240", ("sor3d_color_sweep",),
                    lambda: xt.invert_3DOcean(F_d, dims=DIMS_3D,
                                              mParams=mP_d, iParams=iP_d),
                    F_d)
    _against_cpu("invert_3DOcean 20x110x240", oc_out,
                 lambda: xt.invert_3DOcean(F_d, dims=DIMS_3D, mParams=mP_d,
                                           iParams=iP_d, device="cpu"))
    small = soda_curl(months=2, step=3)
    for name, path, iP, inplace in (
            ("invert_Stommel", "Stommel", iP_soda, True),
            ("invert_StommelMunk", "StommelMunk", iP_soda, False),
            ("invert_Stommel cheby", "Stommel", iP_cheby, True)):
        iP_sm = dict(iP, mxLoop=2000, checkEvery=32)
        sor2d.INPLACE_KERNEL = True
        card_out = _drive(f"{name} 2x110x240", TILED[inplace],
                          lambda p=path, i=iP_sm: paths[p](small, i), small)
        sor2d.INPLACE_KERNEL = False
        _against_cpu(f"{name} 2x110x240", card_out,
                     lambda p=path, i=iP_sm: paths[p](small, i,
                                                      device="cpu"))
    sor["poisson"] = out["2048x2048"]
    return launches, sor


def _drive3d(name, call, field, launches):
    """A 3-D main path with an extend y boundary through the folded pair
    alone (two launches of sor3d_color_sweep a sweep, no
    sor3d_extend_rows launch), then the same call through the first
    version's three launches a sweep (``sor3d_sweeps`` set to
    ``sor3d_sweeps_pair``): the same iters, bit-equal states and fields.
    Returns the folded run's Field."""
    folded = (_drive(name, ("sor3d_color_sweep",), call, field, launches),
              api.LAST_SOLVE)
    sweeps = sor3d.LAUNCHES / max(int(folded[1].iters.max()), 1)
    folded_sweeps = sor3d.sor3d_sweeps
    sor3d.sor3d_sweeps = sor3d.sor3d_sweeps_pair
    try:
        first = (_drive(f"{name}, first version",
                        ("sor3d_color_sweep", "sor3d_extend_rows"), call,
                        field), api.LAST_SOLVE)
    finally:
        sor3d.sor3d_sweeps = folded_sweeps
    log(f"[3] {name}: the folded pair {sweeps:.2f} launches a sweep, "
        f"sor3d_extend_rows 0 launches")
    _same(f"{name}, folded vs first version", folded, first)
    return folded[0]


def _same(name, a, b):
    """Two runs of one call, each given as (Field, SolveResult): the same
    iters and bit-equal states (torch.equal) and fields."""
    (fa, ra), (fb, rb) = a, b
    same = (torch.equal(ra.iters, rb.iters) and torch.equal(ra.S, rb.S)
            and np.array_equal(fa.values, fb.values, equal_nan=True))
    log(f"[3] {name}: iters {ra.iters.cpu().tolist()} and "
        f"{rb.iters.cpu().tolist()}, states and fields equal: {same}")
    if not same:
        raise RuntimeError(f"{name}: the two runs differ")


# --------------------------------------------------------- phase 3, direct

def masked_025_field(seed=5):
    """A 0.25-degree cell-centred global lat-lon field (720x1440): the
    Poisson recipe's sin(3 lon) cos(2 lat) + 0.1 noise, NaN over a 40x50
    = 2000-cell island at 10-20N, 150-162.5E (within MAX_HOLES)."""
    ny, nx = 720, 1440
    lat = -89.875 + 0.25 * np.arange(ny)
    lon = 0.125 + 0.25 * np.arange(nx)
    rng = np.random.default_rng(seed)
    llat, llon = np.deg2rad(lat)[:, None], np.deg2rad(lon)[None, :]
    vor = (np.sin(3 * llon) * np.cos(2 * llat)
           + 0.1 * rng.standard_normal((ny, nx)))
    vor[400:440, 600:650] = np.nan
    return xt.Field(vor, ("lat", "lon"), {"lat": lat, "lon": lon})


def _direct(name, field, iP, dtype):
    """invert_Poisson with scheme='direct' in ``dtype`` and no device
    argument, with every count set to 0 just before it and read just
    after: it must launch no kernel and call no plain version (the direct
    engine is torch ops), and leave its answer on the card, NaN exactly on
    the mask.  Returns (Field, SolveResult, wall seconds)."""
    torch.set_default_dtype(dtype)
    try:
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = xt.invert_Poisson(field, dims=["lat", "lon"], iParams=iP)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        torch.set_default_dtype(torch.float32)
    res = api.LAST_SOLVE
    ran = {k for k, (mod, attr) in COUNTERS.items() if getattr(mod, attr)}
    plain = sor2d.PLAIN_CALLS + sor3d.PLAIN_CALLS
    if ran or plain or not res.S.is_cuda or int(res.iters.max()) != 1:
        raise RuntimeError(f"{name}: the direct path launched {sorted(ran)}"
                           f", made {plain} plain calls, or left the card")
    _check_field(out, field, name)
    return out, res, wall


def _gap(a, b):
    """max|a - b| / max|b| over the cells finite in both, each with its
    mean removed (the singular problems' gauge constant)."""
    ok = np.isfinite(a) & np.isfinite(b)
    a, b = a[ok] - a[ok].mean(), b[ok] - b[ok].mean()
    return float(np.abs(a - b).max() / np.abs(b).max())


def _manufactured_2048(dev):
    """solve_direct on the card in float64 at 2048x2048 (the unmasked
    spherical Poisson, extend/periodic) against a manufactured field: the
    forcing made from a smooth field St by the operator itself, so St
    solves it up to the gauge constant."""
    from xinvert_tpu_torch import solver
    from xinvert_tpu_torch.ops import direct
    f = poisson_field(2048, 2048, masked=False)
    grid = Grid.make(("lat", "lon"), (f.coords["lat"], f.coords["lon"]),
                     "lat-lon", bcs=("extend", "periodic"))
    spec = problems.build_poisson(
        torch.zeros((2048, 2048), dtype=torch.float64, device=dev),
        torch.ones((2048, 2048), dtype=torch.bool, device=dev), grid,
        default_mParams)
    y = torch.linspace(-1.0, 1.0, 2048, dtype=torch.float64,
                       device=dev)[:, None]
    x = (torch.arange(2048, dtype=torch.float64, device=dev)
         * (2 * np.pi / 2048))[None, :]
    St = torch.cos(2 * y) * torch.sin(3 * x) + 0.5 * torch.cos(y) * torch.cos(
        5 * x)
    St[0], St[-1] = St[1].clone(), St[-2].clone()
    g = -(solver._neighbor_sum(dataclasses.replace(
        spec, g=torch.zeros_like(spec.g)), St) + spec.w0 * St)
    spec = dataclasses.replace(spec, g=torch.where(spec.active, g, 0.0))
    t0 = time.perf_counter()
    S = direct.solve_direct(spec, torch.zeros_like(St))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    err = S - St
    err = float((err - err[1:-1].mean()).abs().max() / St.abs().max())
    log(f"[3] direct solve_direct 2048x2048 float64 on a manufactured field "
        f"(extend, periodic, the gauge): max|S - St|/max|St| = {err:.3e} "
        f"with the mean removed (limit 1e-7) in {wall:.3f} s")
    if not err <= 1e-7:
        raise RuntimeError("solve_direct missed the manufactured field")


def phase3_direct(sor, dev):
    """The direct engine (scheme='direct') in float32 and float64 with no
    device argument: bench.py's 2048x2048 spherical Poisson unmasked
    (__graft_entry__._poisson_problem(masked=False)), beside SOR at mxLoop
    4000; a manufactured-field check at that size; the capacitance path on
    a 0.25-degree 720x1440 grid with a 2000-cell island, its time split,
    beside SOR; and the blob mask at 2048x2048, which it declines: a
    warning and exactly phase 3's scheme='sor' field."""
    from xinvert_tpu_torch.ops import direct
    base = {"BCs": ["extend", "periodic"], "undef": np.nan,
            "printInfo": False}
    iP = dict(base, scheme="direct")
    iP_sor = dict(base, mxLoop=4000, tolerance=1e-8)
    big = poisson_field(2048, 2048, masked=False)
    fields = {}
    for dt in (torch.float32, torch.float64):
        name = f"direct invert_Poisson 2048x2048 unmasked {str(dt)[6:]}"
        out, res, wall = _direct(name, big, iP, dt)
        wall2 = _direct(name, big, iP, dt)[2]
        fields[dt] = out.values
        log(f"[3] {name}: wall {wall:.3f} s (a second call {wall2:.3f} s), "
            f"relative residual {float(res.rel_change):.4e} (the "
            f"inconsistent forcing's projected-out part), iters 1, no "
            f"kernel launch")
    sor_big = _drive("invert_Poisson 2048x2048 unmasked (SOR, beside "
                     "direct)", TILED[False], lambda: xt.invert_Poisson(
                         big, dims=["lat", "lon"], iParams=iP_sor), big)
    ref = fields[torch.float64]
    log(f"[3] direct 2048x2048 unmasked, mean removed: float32 vs float64 "
        f"{_gap(fields[torch.float32], ref):.4e}; SOR float32 (mxLoop 4000, "
        f"iters {api.LAST_SOLVE.iters.tolist()}) vs direct float64 "
        f"{_gap(sor_big.values, ref):.4e} (of max|S|)")
    _manufactured_2048(dev)

    isl = masked_025_field()
    land = np.isnan(isl.values)
    holes = int(land.sum())
    masked = {}
    for dt in (torch.float32, torch.float64):
        name = (f"direct invert_Poisson 720x1440 0.25-degree, a 2000-cell "
                f"island, {str(dt)[6:]}")
        out, res, wall = _direct(name, isl, iP, dt)
        split = dict(direct.LAST_MASKED_SECONDS)
        masked[dt] = (out.values, float(res.rel_change))
        log(f"[3] {name}: capacitance path, wall {wall:.3f} s: the unmasked "
            f"and unit solves {split['unit']:.3f} s ({-(-holes // 256)} "
            f"chunks of up to 256), the dense solve ({holes} holes, float64 "
            f"on the host) {split['dense']:.3f} s, the re-solve and pin "
            f"{wall - split['unit'] - split['dense']:.3f} s; relative "
            f"residual {float(res.rel_change):.4e}")
    sor_isl = _drive("invert_Poisson 720x1440 island (SOR, beside direct)",
                     TILED[False], lambda: xt.invert_Poisson(
                         isl, dims=["lat", "lon"], iParams=iP_sor), isl)
    ref = masked[torch.float64][0]
    log(f"[3] direct 720x1440 island vs float64 direct, over the "
        f"{int((~land).sum())} ocean cells (no gauge: the island pins it): "
        f"float32 {np.abs(masked[torch.float32][0] - ref)[~land].max() / np.abs(ref[~land]).max():.4e}, "
        f"SOR float32 (mxLoop 4000, iters {api.LAST_SOLVE.iters.tolist()}) "
        f"{np.abs(sor_isl.values - ref)[~land].max() / np.abs(ref[~land]).max():.4e}")
    if not masked[torch.float64][1] <= 1e-8:
        raise RuntimeError("the float64 capacitance solve's relative "
                           "residual is above 1e-8")

    blob = poisson_field(2048, 2048)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fb = _drive("invert_Poisson 2048x2048 blob mask, scheme='direct' "
                    "(declined: SOR)", TILED[False], lambda: xt.invert_Poisson(
                        blob, dims=["lat", "lon"],
                        iParams=dict(iP_sor, scheme="direct")), blob)
    warned = any("falling back" in str(w.message) for w in caught)
    log(f"[3] the blob mask's {int(np.isnan(blob.values)[1:-1].sum())} holes "
        f"(past MAX_HOLES {direct.MAX_HOLES}): warned {warned}")
    if not warned:
        raise RuntimeError("the declined direct solve did not warn")
    _same("invert_Poisson 2048x2048, scheme='direct' fallback vs "
          "scheme='sor'", (fb, api.LAST_SOLVE), sor["poisson"])


# ------------------------------------------------------ phase 3, multigrid

_SETUP = {}


def _timed_solve_mg(levels, **kw):
    """mg.solve_mg, noting when it starts (the entry's set-up ends) and
    what it was given."""
    torch.cuda.synchronize()
    _SETUP.update(t=time.perf_counter(), levels=levels, kw=kw)
    return _SOLVE_MG(levels, **kw)


_SOLVE_MG = mg.solve_mg


def _entry_call(fn, field, **kw):
    """A call of an ``invert_*_mg`` entry with no device argument, returning
    (Field, cycles, residual, converged) from its LAST_SOLVE and its
    default tol."""
    tol = kw.get("tol", inspect.signature(fn).parameters["tol"].default)

    def call():
        out = fn(field, **kw)
        res = api.LAST_SOLVE
        return (out, int(res.iters), float(res.rel_change),
                float(res.rel_change) < tol)
    return call


def _drive_mg(name, kernels, call, launches=None):
    """One multigrid solve (``call`` returns (out, cycles, residual,
    converged)) with every count set to 0 just before it and read just
    after: it must have launched ``kernels`` alone, with no plain call.
    Prints cycles, residual, converged, wall time, the set-up seconds (the
    call's start to solve_mg's), host syncs and launches; the full-size
    runs add their launches to ``launches``."""
    _zero_counts()
    mg.HOST_SYNCS = 0
    _SETUP.clear()
    t0 = time.perf_counter()
    out, cycles, res, conv = call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    setup = _SETUP.get("t", t0) - t0
    counts = {k: getattr(mod, attr) for k, (mod, attr) in COUNTERS.items()}
    plain = sor2d.PLAIN_CALLS + sor3d.PLAIN_CALLS
    ran = ", ".join(f"{k} {v}" for k, v in counts.items() if v) or "none"
    log(f"[3] {name} float32: cycles {cycles} residual {res:.4e} converged "
        f"{conv} wall {wall:.3f} s (set-up {setup:.3f} s, solve "
        f"{wall - setup:.3f} s); host syncs {mg.HOST_SYNCS}; launches: "
        f"{ran}; plain calls {plain}")
    if {k for k, v in counts.items() if v} != set(kernels) or plain:
        raise RuntimeError(f"{name}: the multigrid path did not run through "
                           f"{sorted(kernels) or 'torch ops'} alone")
    if launches is not None:
        for k, v in counts.items():
            launches[k] += v
    return out, cycles, res, conv


def _cycle_share(name):
    """The device idle share of one V-cycle of the last solve_mg call (its
    levels, its first state and forcing, its smoothing counts) under
    torch.profiler.  A whole line-smoothed solve launches about a million
    small kernels, which the profiler takes minutes to digest; its
    V-cycles all repeat one launch pattern."""
    levels, kw = _SETUP["levels"], _SETUP["kw"]
    nd = levels[0].spec.ndim
    S = kw["S0"]
    S = S.reshape((-1,) + S.shape[-nd:]) if S.dim() > nd else S
    g = kw.get("g0")
    g = None if g is None else g.reshape(S.shape)
    args = (kw.get("nu1", 2), kw.get("nu2", 2), 60,
            0.8 if levels[0].masked else 1.0, levels[0].smoother)
    _, wall, busy = _profiled(lambda: mg._vcycle(levels, 0, S, g, *args))
    log(f"[3] {name}, one V-cycle ({levels[0].smoother} smoothing, "
        f"{len(levels)} levels) under torch.profiler: {_idle(wall, busy)}")


def _vs_sor(name, out, sor):
    """The multigrid field beside phase 3's SOR field of the same call."""
    a, b = out.values, sor.values
    ok = np.isfinite(a) & np.isfinite(b)
    if not ok.any():
        log(f"[3] {name}: the multigrid field has no finite cell (it "
            f"diverged); no comparison with the SOR field")
        return
    log(f"[3] {name}: max|MG - SOR|/max|SOR| = "
        f"{np.abs(a[ok] - b[ok]).max() / np.abs(b[ok]).max():.4e} over "
        f"{ok.sum()} of {np.isfinite(b).sum()} ocean cells (the SOR field "
        f"of phase 3, stopped by its own rule)")


def phase3_mg(launches, sor):
    """The multigrid paths in float32 with no device argument: bench.py's
    2048x2048 FMG problem through solve_mg (must converge to 1e-6 through
    the tiled kernel alone), then invert_Stommel_mg and
    invert_StommelMunk_mg on the SODA-class curl, invert_omega_mg at
    37x72x288 and invert_3DOcean_mg at 30x330x720, each beside phase 3's
    SOR field, with its device idle share; smaller runs of each against a
    float64 CPU run.  Returns the host syncs per cycle of the 2048x2048
    solve."""
    torch.set_default_dtype(torch.float32)
    mg.solve_mg = _timed_solve_mg
    try:
        dev = torch.device("cuda", 0)

        def extra(n, device, dtype):
            def call():
                pyr = extra_mg_pyramid(dtype, device, n)
                return mg.solve_mg(pyr, tol=1e-6, max_cycles=80, fmg=True)
            return call
        S, cycles, res, conv = _drive_mg(
            "solve_mg 2048x2048 FMG (bench.py's problem)",
            TILED[False], extra(2048, dev, torch.float32), launches)
        syncs = mg.HOST_SYNCS / max(cycles, 1)
        if not (conv and res < 1e-6 and bool(torch.isfinite(S).all())):
            raise RuntimeError("solve_mg 2048x2048 did not converge to 1e-6")
        _busy_share("solve_mg 2048x2048 FMG", extra(2048, dev,
                                                     torch.float32))
        # the same recipe at 256x256 against float64 on the CPU
        S_c = _drive_mg("solve_mg 256x256 FMG", TILED[False],
                        extra(256, dev, torch.float32))[0]
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        t0 = time.perf_counter()
        try:
            S_r, k_r, res_r, _ = extra(256, "cpu", torch.float64)()
        finally:
            torch.set_num_threads(threads)
        cpu_s = time.perf_counter() - t0
        dev_ = float((S_c.double().cpu() - S_r).abs().max()
                     / S_r.abs().max())
        log(f"[3] solve_mg 256x256 float32 card vs float64 CPU: "
            f"max|diff|/max|S| = {dev_:.3e} (limit 1e-4); CPU cycles {k_r} "
            f"residual {res_r:.3e} in {cpu_s:.1f} s")
        if not dev_ <= 1e-4:
            raise RuntimeError("solve_mg: the card's answer disagrees with "
                               "the float64 CPU run")

        soda = soda_curl()
        iP = {"BCs": ["extend", "periodic"], "undef": np.nan}
        kw2 = dict(dims=["lat", "lon"], iParams=iP)
        # the SODA-class grid reaches 89.75N: the polar metric picks x-line
        # smoothing (torch ops, no kernel) for both gyres
        st = _entry_call(xt.invert_Stommel_mg, soda, mParams=STOMMEL_MP,
                         **kw2)
        out = _drive_mg("invert_Stommel_mg 12x330x720", (), st, launches)[0]
        _cycle_share("invert_Stommel_mg 12x330x720")
        _vs_sor("invert_Stommel_mg 12x330x720", out, sor["stommel"])
        munk_months = 2
        soda_m = soda_curl(months=munk_months)
        mk = _entry_call(xt.invert_StommelMunk_mg, soda_m, mParams=MUNK_MP,
                         **kw2)
        out = _drive_mg(f"invert_StommelMunk_mg {munk_months}x330x720", (),
                        mk, launches)[0]
        _cycle_share(f"invert_StommelMunk_mg {munk_months}x330x720")
        _vs_sor(f"invert_StommelMunk_mg {munk_months}x330x720", out,
                xt.Field(sor["stommelmunk"].values[:munk_months],
                         soda_m.dims, soda_m.coords))
        F_om, N2_om = atmos3d(37, 72, 288)
        kw3 = dict(dims=DIMS_3D, iParams={"BCs": ["fixed", "fixed",
                                                 "periodic"]})
        om = _entry_call(xt.invert_omega_mg, F_om, mParams={"N2": N2_om},
                         **kw3)
        out = _drive_mg("invert_omega_mg 37x72x288", (), om, launches)[0]
        _cycle_share("invert_omega_mg 37x72x288")
        _vs_sor("invert_omega_mg 37x72x288", out, sor["omega"])
        F_oc, N2_oc = ocean3d(30)
        kw_oc = dict(dims=DIMS_3D, iParams={"BCs": ["fixed", "extend",
                                                   "periodic"],
                                            "undef": np.nan})
        oc = _entry_call(xt.invert_3DOcean_mg, F_oc,
                         mParams=dict(OCEAN_MP, N2=N2_oc), **kw_oc)
        out = _drive_mg("invert_3DOcean_mg 30x330x720", (), oc, launches)[0]
        _cycle_share("invert_3DOcean_mg 30x330x720")
        _vs_sor("invert_3DOcean_mg 30x330x720", out, sor["3docean"])

        # smaller runs against float64 on the CPU; Stommel-Munk's is the
        # cartesian Munk gyre of the JAX package's tests at half its size
        # (point smoothing: the biharmonic tiled kernel), as its SODA run
        # diverges in both packages
        small = soda_curl(months=2, step=6)
        F_s, N2_s = atmos3d(37, 36, 72)
        F_d, N2_d = ocean3d(20, step=6)
        Ly = 2 * np.pi * 1e6
        y, x = np.linspace(0.0, Ly, 65), np.linspace(0.0, 1e7, 129)
        gyre = xt.Field(-0.3 * np.sin(np.pi * y[:, None] / Ly) * np.pi / Ly
                        * np.ones((1, 129)), ("y", "x"), {"y": y, "x": x})
        for name, kernels, fn, field, kw in (
                ("invert_Stommel_mg 2x55x120", (), xt.invert_Stommel_mg,
                 small, dict(kw2, mParams=STOMMEL_MP)),
                ("invert_StommelMunk_mg cartesian gyre 65x129",
                 TILED[False], xt.invert_StommelMunk_mg, gyre,
                 dict(dims=["y", "x"], coords="cartesian",
                      iParams={"BCs": ["fixed", "fixed"]},
                      mParams={"beta": 1.8e-11, "R": 0.0008, "D": 200,
                               "A4": 5e3})),
                ("invert_omega_mg 37x36x72", (), xt.invert_omega_mg, F_s,
                 dict(kw3, mParams={"N2": N2_s})),
                ("invert_3DOcean_mg 20x55x120", (), xt.invert_3DOcean_mg,
                 F_d, dict(kw_oc, mParams=dict(OCEAN_MP, N2=N2_d)))):
            card_out = _drive_mg(name, kernels,
                                 _entry_call(fn, field, **kw))[0]
            # many small ops: one CPU thread spends least on each
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                _against_cpu(name, card_out,
                             lambda fn=fn, f=field, kw=kw: fn(
                                 f, device="cpu", **kw))
            finally:
                torch.set_num_threads(threads)
    finally:
        mg.solve_mg = _SOLVE_MG
        torch.set_default_dtype(torch.float32)
    return syncs


# ---------------------------------------------------------------- phase 4

def _time_ms(fn, reps, inner=1):
    """Median over ``reps`` of the CUDA-event time of ``inner`` back-to-back
    calls of fn(), per call."""
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    return float(np.median(times))


def _chain_ms(step, S0, calls=5):
    """Median of ``calls`` chained calls S <- step(S), after one warm-up."""
    state = {"S": step(S0)}

    def one():
        state["S"] = step(state["S"])
    ms = _time_ms(one, calls)
    if not bool(torch.isfinite(state["S"]).all()):
        raise RuntimeError("non-finite state in the timing chain")
    return ms


def _copy_ms(nbytes, dev):
    """CUDA-event time of a device-to-device copy of ``nbytes`` bytes."""
    src = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    dst.copy_(src)
    return _time_ms(lambda: dst.copy_(src), 5, inner=20)


def _rates(card, label, spec, omega, shape, plain, dev, n=500):
    """solve_fixed rates of the kernels (twice) and the plain version, and
    a device copy of the bytes a sweep of the kernels must move (2-D: the
    tiled kernel's planes and state once per launch of k sweeps)."""
    S0 = torch.zeros(shape, dtype=spec.w0.dtype, device=dev)
    K = len(spec.offsets)
    t_k = _chain_ms(lambda S: xt.solve_fixed(spec, S, omega, n), S0)
    t_p = _chain_ms(lambda S: plain(spec, S, omega, n), S0)
    t_k2 = _chain_ms(lambda S: xt.solve_fixed(spec, S, omega, n), S0)
    pts = int(np.prod(shape)) * n
    itemsize = spec.w0.element_size()
    if spec.ndim == 2:
        k = sor2d.tile_plan(spec, tuple(shape[-2:]), spec.w0.dtype).k
        sweep_bytes = _bound("sor2d_sweeps_tiled", spec, shape, k)[2] // k
    else:
        sweep_bytes = 2 * (K + 5) * int(np.prod(shape)) * itemsize
    t_copy = _copy_ms(sweep_bytes // 2, dev)
    t_kern = min(t_k, t_k2)
    log(f"[4] {card} | solve_fixed {label} {str(spec.w0.dtype)[6:]}, {n} "
        f"sweeps per call, median of 5 chained calls: kernels {t_k:.3f} ms "
        f"then {t_k2:.3f} ms = {pts / (t_kern * 1e-3):.4e} point-sweeps/s; "
        f"plain {t_p:.3f} ms = {pts / (t_p * 1e-3):.4e} point-sweeps/s")
    log(f"[4] {card} | {label}: kernels must move {sweep_bytes} B per sweep "
        f"= {sweep_bytes * n / (t_kern * 1e-3) / 1e9:.1f} GB/s; device copy "
        f"of {sweep_bytes // 2} B: {t_copy:.4f} ms = "
        f"{sweep_bytes / (t_copy * 1e-3) / 1e9:.1f} GB/s")
    return S0


def _turns(card, label, spec, omega, shape, dev, n=200):
    """n sweeps per call, median of 5 chained calls, in turns: the first
    version's pair, the tiled kernel, the tiled kernel, the pair; and,
    where the spec takes them, B3, the in-place tiled kernel, the in-place
    tiled kernel, B3.  Returns ms per sweep, the best of each pair of
    turns."""
    S0 = torch.zeros(shape, dtype=spec.w0.dtype, device=dev)
    runs = [("pair", False, sor2d.sor2d_sweeps_pair),
            ("sor2d_sweeps_tiled", False, sor2d.sor2d_sweeps_tiled)]
    if sor2d.inplace_eligible(spec, tuple(shape[-2:])):
        runs += [("B3", True, sor2d.sor2d_sweeps_pair),
                 ("sor2d_sweeps_tiled_inplace", True,
                  sor2d.sor2d_sweeps_tiled_inplace)]
    times = {}
    for i in range(0, len(runs), 2):
        for label_, switch, fn in (runs[i], runs[i + 1], runs[i + 1],
                                   runs[i]):
            sor2d.INPLACE_KERNEL = switch
            times.setdefault(label_, []).append(_chain_ms(
                lambda S, fn=fn: fn(spec, S, omega, n), S0) / n)
            sor2d.INPLACE_KERNEL = False
    pts = int(np.prod(shape))
    log(f"[4] {card} | {label} {str(spec.w0.dtype)[6:]}, {n} sweeps per "
        f"call, median of 5 chained calls, in turns: " + "; ".join(
            f"{k} {v[0]:.5f} / {v[1]:.5f} ms per sweep = "
            f"{pts / (min(v) * 1e-3):.4e} point-sweeps/s"
            for k, v in times.items()))
    return {k: min(v) for k, v in times.items()}


# the instantiations each plan scan tries (itemsize 4 only): (threads,
# cells per thread, weight planes in shared memory)
SCAN_CONFIGS = {4: ((1024, 4, 0),), 8: ((1024, 4, 1), (512, 4, 0))}


def _plan_scan(card, label, spec, omega, shape, dev, n=48):
    """The ping-pong tiled kernel's time per sweep over its instantiations
    (``SCAN_CONFIGS``), sweeps per launch and window widths (windows as
    tall as the instantiation allows), beside the plan's own choice: the
    table behind ``sor2d.tile_plan``."""
    S0 = torch.zeros(shape, dtype=spec.w0.dtype, device=dev)
    core = tuple(shape[-2:])
    dt = spec.w0.dtype
    chosen = sor2d.tile_plan(spec, core, dt)
    r = sor2d._radius(spec)
    ey, ex = sor2d._extend_reach(spec)
    key = (4, chosen.kmax, False)
    table = sor2d._CONFIGS[key]
    fam = sor2d._FAMILY
    results = []
    for conf in SCAN_CONFIGS.get(chosen.kmax, (table,)):
        sor2d._CONFIGS[key] = conf
        for k in ((2, 3, 4, 5, 6) if r == 1 else (1, 2, 3)):
            for tx in (32, 64, 96):
                hy, hx = 2 * r * k + ey, 2 * r * k + ex
                ty = (conf[0] * conf[1] // (tx + 2 * hx) - 2 * hy) // 8 * 8
                try:
                    plan = sor2d.make_plan(spec, core, dt, False, k, ty, tx)
                except ValueError:
                    continue
                sor2d._FAMILY = fam._replace(
                    tile_plan=lambda *a, p=plan: p)
                try:
                    ms = _chain_ms(lambda S: sor2d.sor2d_sweeps_tiled(
                        spec, S, omega, n), S0, calls=3) / n
                finally:
                    sor2d._FAMILY = fam
                results.append((ms, conf, k, plan.ty, plan.tx))
    sor2d._CONFIGS[key] = table
    results.sort()
    log(f"[4] {card} | plan scan {label}: the plan {table} k {chosen.k} "
        f"tile {chosen.ty}x{chosen.tx}; ms per sweep ((threads, cells, "
        f"weights in shared memory), k, tile): " + ", ".join(
            f"{ms:.5f} ({c}, {k}, {ty}x{tx})"
            for ms, c, k, ty, tx in results))


def _launch_cost(card, label, spec, omega, S, dev):
    """Where a tiled launch's time goes: the plan's launch (device time
    behind a spin) at 1..k sweeps; the fit's intercept is what a launch
    pays whatever its sweeps (loading the windows, writing the tiles), its
    slope what each sweep adds (with k = 1 no fit: the slope is the whole
    launch); beside them the bytes of the windows and of the launch itself
    at 3.35 TB/s."""
    core = tuple(S.shape[-2:])
    dt = S.dtype
    plan = sor2d.tile_plan(spec, core, dt)
    fam = sor2d._FAMILY
    rel = sor2d.relax_plane(spec, omega)
    lay = fam.layout(spec, S, rel)
    A = torch.empty((lay["B"],) + lay["core"], dtype=dt, device=dev)
    A.copy_(S.reshape(A.shape))
    A2 = torch.empty_like(A)
    ns = list(range(1, plan.k + 1))
    ts = [_device_ms(lambda n=n: fam.launch_tiled(spec, lay, plan, rel, A,
                                                  A2, n, [1.0] * 2 * n), 20)
          for n in ns]
    slope, icpt = np.polyfit(ns, ts, 1) if len(ns) > 1 else (ts[0], 0.0)
    blocks = math.prod(plan.tiles(core)) * lay["B"]
    nbytes = _bound("sor2d_sweeps_tiled", spec, S.shape, 1)[2]
    win_bytes = (blocks * plan.winy * plan.winx
                 * (len(spec.offsets) + 4) * dt.itemsize)
    log(f"[4] {card} | launch cost {label}: window {plan.winy}x{plan.winx}"
        f" (tile {plan.ty}x{plan.tx}), {blocks} "
        f"tiles x slices over "
        f"{torch.cuda.get_device_properties(dev).multi_processor_count} "
        f"SMs; ms per launch at " + ", ".join(
            f"{n} sweeps {t:.5f}" for n, t in zip(ns, ts))
        + f"; fit: {icpt:.5f} ms a launch + {slope:.5f} ms a sweep; the "
        f"windows' {win_bytes} B at 3.35 TB/s {win_bytes / 3.35e9:.5f} ms, "
        f"the launch's own {nbytes} B {nbytes / 3.35e9:.5f} ms")


def _bound(name, spec, shape, k=1):
    """(bound_ms, bound_by, nbytes) of one launch of kernel ``name`` on
    ``spec`` (``k`` sweeps for the tiled kernels): the bytes it must move
    (each input read once, each output written once) over the HBM rate,
    against its float32 operations over the peak rate."""
    itemsize = spec.w0.element_size()
    cells = int(np.prod(shape))
    K = len(spec.offsets)
    planes = [spec.w0, spec.g, spec.relax]
    plane_bytes = (sum(p.numel() for p in planes) + spec.w.numel()) * itemsize
    if name.endswith("extend_rows"):
        # rows 1 and ny-2 read, rows 0 and ny-1 written, in every (batch
        # slice, level) the pre-pass touches: interior levels in 3-D
        slabs = cells // (shape[-2] * shape[-1])
        if spec.ndim == 3:
            slabs = slabs // shape[-3] * (shape[-3] - 2)
        nbytes, ops = 4 * slabs * shape[-1] * itemsize, 0
    elif "tiled" in name:
        # k sweeps: the planes and S read once, S written once; each sweep
        # updates every cell once (2K+5 operations)
        nbytes = 2 * cells * itemsize + plane_bytes
        ops = (2 * K + 5) * cells * k
    else:
        # S, K weights, w0, g, rel read; S' written (planes shared by the
        # batch read once: a checkerboard write still dirties every sector,
        # so the in-place kernel moves the same bytes); 2K+5 operations per
        # cell updated (the in-place kernel computes one color only)
        nbytes = 2 * cells * itemsize + plane_bytes
        ops = (2 * K + 5) * (cells // 2 if name.endswith("inplace")
                             else cells)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def _per_launch(card, label, calls, dev):
    """Each kernel's device time per launch against its plain version's, on
    the same inputs (:func:`_device_ms`), the wrappers' CUDA-event times,
    and the bound beside a device copy moving the launch's bytes; per sweep
    too for the tiled kernels (k sweeps a launch)."""
    per = {}
    for name, (kern, plain, launch, k, (bound_ms, bound_by, nbytes)) \
            in calls.items():
        t_launch = _device_ms(launch, 50)
        try:
            t_plain = _device_ms(plain, 10)
            how = ("device time per call (10 calls; CUDA events behind a "
                   "device spin)")
        except RuntimeError:
            # the plain version's allocations can hold the host back; then
            # CUDA events around back-to-back calls, host gaps included
            t_plain = _time_ms(plain, 3, 10)
            how = ("per call (10 calls; CUDA events, host gaps included: the "
                   "host could not queue ahead of a device spin)")
        w_kern = _time_ms(kern, 5, 50)
        w_plain = _time_ms(plain, 5, 50)
        t_copy = _copy_ms(nbytes // 2, dev)
        per[name] = (t_launch, t_plain, bound_ms, bound_by)
        sweeps = (f" ({k} sweeps: {t_launch / k:.5f} ms per sweep, bound "
                  f"{bound_ms / k:.5f})" if k > 1 else "")
        log(f"[4] {card} | {name} {label} float32: kernel "
            f"{t_launch:.5f} ms device time per launch (50 launches){sweeps},"
            f" plain version {t_plain:.4f} ms {how}; bound "
            f"{bound_ms:.5f} ms ({bound_by}, {nbytes} B at 3.35 TB/s), a "
            f"device copy moving those bytes {t_copy:.4f} ms; wrapper call "
            f"{w_kern:.4f} ms vs plain call {w_plain:.4f} ms (CUDA events, "
            f"median of 5 runs of 50)")
    return per


def phase4(card, dev):
    per = {}
    # 2-D: the 2048x2048 masked Poisson
    spec, omega = poisson_spec(2048, 2048, 0, torch.float32, dev)
    S0 = _rates(card, "2048x2048", spec, omega, (2048, 2048),
                sor2d.sor2d_sweeps_reference, dev)
    spec64, _ = poisson_spec(2048, 2048, 0, torch.float64, dev)
    _rates(card, "2048x2048", spec64, omega, (2048, 2048),
           sor2d.sor2d_sweeps_reference, dev)
    del spec64
    _turns(card, "2048x2048", spec, omega, (2048, 2048), dev)
    _plan_scan(card, "2048x2048", spec, omega, (2048, 2048), dev)
    S = xt.solve_fixed(spec, S0, omega, 50)
    _launch_cost(card, "2048x2048", spec, omega, S, dev)
    per.update(_per_launch(card, "2048x2048",
                           _launch_calls(sor2d, spec, omega, S), dev))
    del spec, S, S0
    # the SODA-class Stommel (pruned: 4 offsets, in-place eligible) and
    # Stommel-Munk (pruned: 8 offsets, radius 2), 12x330x720
    for label, builder, mp in (
            ("Stommel 12x330x720", problems.build_stommel, STOMMEL_MP),
            ("Stommel-Munk 12x330x720", problems.build_stommelmunk,
             MUNK_MP)):
        spec, omega = soda_spec(builder, mp, 12, torch.float32, dev)
        _turns(card, label, spec, omega, (12, 330, 720), dev)
        _plan_scan(card, label, spec, omega, (12, 330, 720), dev)
        S = xt.solve_fixed(spec, torch.zeros((12, 330, 720), device=dev),
                           omega, 50)
        _launch_cost(card, label, spec, omega, S, dev)
        _per_launch(card, label, _launch_calls(sor2d, spec, omega, S), dev)
        del spec, S
    # 3-D: the omega volumes (the 37-level one is L2-resident in float32)
    # and the 0.5-degree ocean
    for nz in (37, 73):
        spec, omega = omega_spec(nz, 72, 288, 0, torch.float32, dev)
        _rates(card, f"omega {nz}x72x288", spec, omega, (nz, 72, 288),
               sor3d.sor3d_sweeps_reference, dev)
    spec, omega = ocean_spec(30, torch.float32, dev)
    S0 = _rates(card, "ocean 30x330x720", spec, omega, (30, 330, 720),
                sor3d.sor3d_sweeps_reference, dev)
    S = xt.solve_fixed(spec, S0, omega, 50)
    per.update(_per_launch(card, "30x330x720",
                           _launch_calls(sor3d, spec, omega, S), dev))
    per["sor3d_color_sweep"] = _fold_timing(card, spec, omega, S, dev,
                                            per["sor3d_color_sweep"])
    return per


def _fold_timing(card, spec, omega, S, dev, per_color, n=200):
    """The 3-D pair with the extend pre-pass folded in against the first
    version (the extend launch and the unfolded pair): ms per sweep, n
    sweeps per call, median of 5 chained calls, in turns (first, folded,
    folded, first); and the device time per launch of the folded red
    launch, the unfolded red and the black one, each 50 bare launches
    behind a device spin.  Returns the color sweep's entry of the kernels
    line with its time per launch on the main path: the mean of the folded
    red and the black launch."""
    S0 = torch.zeros(S.shape, dtype=S.dtype, device=dev)
    runs = (("first version", sor3d.sor3d_sweeps_pair),
            ("folded", sor3d.sor3d_sweeps))
    times = {}
    for label, fn in (runs[0], runs[1], runs[1], runs[0]):
        times.setdefault(label, []).append(_chain_ms(
            lambda S_, fn=fn: fn(spec, S_, omega, n), S0) / n)
    fam = sor3d._FAMILY
    rel = sor3d.relax_plane(spec, omega)
    lay = fam.layout(spec, S, rel)
    A = S.reshape((lay["B"],) + lay["core"]).clone()
    A2 = torch.empty_like(A)
    red_f = _device_ms(lambda: fam.launch_color_sweep(
        spec, lay, rel, A, A2, 0, extend=True), 50)
    red = _device_ms(lambda: fam.launch_color_sweep(spec, lay, rel, A, A2,
                                                    0), 50)
    black = _device_ms(lambda: fam.launch_color_sweep(spec, lay, rel, A, A2,
                                                      1), 50)
    ext = _device_ms(lambda: fam.launch_extend(spec, lay, A), 50)
    pts = int(np.prod(S.shape))
    log(f"[4] {card} | 3-D pair 30x330x720 float32, {n} sweeps per call, "
        f"median of 5 chained calls, in turns: " + "; ".join(
            f"{k} {v[0]:.5f} / {v[1]:.5f} ms per sweep = "
            f"{pts / (min(v) * 1e-3):.4e} point-sweeps/s"
            for k, v in times.items()))
    log(f"[4] {card} | 3-D pair 30x330x720 float32, device time per launch "
        f"(50 launches behind a spin): red with the extend folded in "
        f"{red_f:.5f} ms, red unfolded {red:.5f} ms (the fold adds "
        f"{red_f - red:+.5f} ms, {100 * (red_f / red - 1):+.2f}%), black "
        f"{black:.5f} ms, the extend launch {ext:.5f} ms; a sweep: folded "
        f"{red_f + black:.5f} ms, first version {ext + red + black:.5f} ms")
    return ((red_f + black) / 2,) + tuple(per_color[1:])


def phase4_mg(card, dev, syncs):
    """Where a V-cycle's time goes on bench.py's 2048x2048 FMG problem,
    float32: ten chained V-cycles under torch.profiler, their device time
    split by kernel into the smoothing (the tiled kernel) and the rest
    (residuals, transfers, corrections: torch's kernels), the tiled
    launches per cycle, the wall time per cycle and its host gap (wall
    minus device busy), and phase 3's host syncs per cycle.  (A V-cycle
    queues about 400 kernels, more than the host can queue ahead of a
    device spin, so no spin-based device time here.)"""
    pyr = extra_mg_pyramid(torch.float32, dev)
    args = (2, 2, 60, 0.8, "point")
    S = mg._vcycle(pyr, 0, torch.zeros_like(pyr[0].spec.w0), None, *args)
    reps = 10
    t0 = sor2d.TILED_LAUNCHES

    def cycles():
        out = S
        for _ in range(reps):
            out = mg._vcycle(pyr, 0, out, None, *args)
        return out
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        cycles()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - w0) / reps * 1e3
    launches = (sor2d.TILED_LAUNCHES - t0) / reps
    smooth = rest = 0.0
    for ev in prof.key_averages():
        if "sor2d_sweeps_tiled" in ev.key:
            smooth += ev.self_device_time_total
        else:
            rest += ev.self_device_time_total
    smooth, rest = smooth / 1e3 / reps, rest / 1e3 / reps
    if not smooth + rest > 0:
        log(f"[4] {card} | multigrid V-cycle 2048x2048 float32: wall "
            f"{wall:.4f} ms per cycle; device time not measured "
            f"(torch.profiler recorded no device time)")
        return
    log(f"[4] {card} | multigrid V-cycle 2048x2048 float32 ({len(pyr)} "
        f"levels, nu 2+2, 60 coarse sweeps, point smoothing; {reps} "
        f"chained cycles under torch.profiler): device "
        f"{smooth + rest:.4f} ms per cycle, of which smoothing "
        f"{smooth:.4f} ms ({launches:.0f} tiled launches) and the rest "
        f"(residuals, transfers, corrections) {rest:.4f} ms; wall "
        f"{wall:.4f} ms per cycle, host gap {wall - smooth - rest:.4f} ms; "
        f"host syncs per cycle {syncs:.2f} (phase 3's solve)")


def _launch_calls(mod, spec, omega, S):
    """For each kernel of ``mod`` (sor2d / sor3d) that takes ``spec``: its
    wrapper, its plain version, one bare launch of the kernel on a buffer
    holding S (through the module's own launch call, so no copy or
    allocation is timed with it), its sweeps per launch and its bound,
    for :func:`_per_launch`."""
    p = mod.__name__.rsplit(".", 1)[-1]
    fam = mod._FAMILY
    rel = mod.relax_plane(spec, omega)
    lay = fam.layout(spec, S, rel)
    A = torch.empty((lay["B"],) + lay["core"], dtype=S.dtype,
                    device=S.device)
    A.copy_(S.reshape(A.shape))
    A2 = torch.empty_like(A)
    calls = {
        f"{p}_extend_rows": (
            lambda: getattr(mod, f"{p}_extend")(spec, S),
            lambda: getattr(mod, f"{p}_extend_reference")(spec, S),
            lambda: fam.launch_extend(spec, lay, A), 1),
        f"{p}_color_sweep": (
            lambda: getattr(mod, f"{p}_color_sweep")(spec, S, rel, 0),
            lambda: getattr(mod, f"{p}_color_sweep_reference")(spec, S, rel,
                                                               0),
            lambda: fam.launch_color_sweep(spec, lay, rel, A, A2, 0), 1),
    }
    if p == "sor2d":
        core = lay["core"]
        kinds = [("sor2d_sweeps_tiled", sor2d.sor2d_sweeps_tiled, False)]
        if sor2d.inplace_eligible(spec, core):
            calls["sor2d_color_sweep_inplace"] = (
                lambda: sor2d.sor2d_color_sweep_inplace(spec, S, rel, 0),
                lambda: sor2d.sor2d_color_sweep_inplace_reference(
                    spec, S, rel, 0),
                lambda: fam.launch_color_sweep_inplace(spec, lay, rel, A, 0),
                1)
            kinds.append(("sor2d_sweeps_tiled_inplace",
                          sor2d.sor2d_sweeps_tiled_inplace, True))
        for name, fn, inplace in kinds:
            plan = sor2d.tile_plan(spec, core, S.dtype, inplace)
            calls[name] = (
                lambda fn=fn, k=plan.k: fn(spec, S, omega, k),
                lambda k=plan.k: sor2d.sor2d_sweeps_reference(spec, S,
                                                              omega, k),
                lambda plan=plan: fam.launch_tiled(
                    spec, lay, plan, rel, A, A2, plan.k, [1.0] * 2 * plan.k),
                plan.k)
    return {name: c + (_bound(name, spec, S.shape, c[3]),)
            for name, c in calls.items()}


_SPIN_CYCLES_PER_S = []


def _device_ms(fn, calls):
    """Device time per call of ``calls`` back-to-back calls of fn(): CUDA
    events around them, queued behind a device-side spin
    (torch.cuda._sleep) that lasts longer than the host takes to queue the
    calls, so the device never waits for the host between the events.  A
    spin that ended too soon is made longer and the run repeated."""
    if not _SPIN_CYCLES_PER_S:
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        torch.cuda._sleep(10 ** 7)
        e1.record()
        e1.synchronize()
        _SPIN_CYCLES_PER_S.append(10 ** 7 / (e0.elapsed_time(e1) * 1e-3))
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    spin_s = 2.0 * (time.perf_counter() - t0) + 2e-3
    torch.cuda.synchronize()
    for _ in range(4):
        es, e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        es.record()
        torch.cuda._sleep(int(spin_s * _SPIN_CYCLES_PER_S[0]))
        e0.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        queued_s = time.perf_counter() - t0
        e1.record()
        e1.synchronize()
        if es.elapsed_time(e0) * 1e-3 > queued_s + 1e-3:
            return e0.elapsed_time(e1) / calls
        spin_s *= 4.0
    raise RuntimeError("the host could not queue the timed calls ahead of "
                       "the device")


def main():
    t_start = time.perf_counter()

    def stamp(phase):
        log(f"[t] {phase} ended at {time.perf_counter() - t_start:.1f} s")
    card = phase0()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase1()
    stamp("phase 1")
    errs = phase2(dev)
    stamp("phase 2")
    launches, sor = phase3()
    stamp("phase 3 (SOR paths)")
    phase3_direct(sor, dev)
    stamp("phase 3 (direct)")
    syncs = phase3_mg(launches, sor)
    stamp("phase 3 (multigrid paths)")
    torch.set_default_dtype(torch.float32)
    per = phase4(card, dev)
    phase4_mg(card, dev, syncs)
    stamp("phase 4")
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "also_replaces": also,
                "launches": launches[name], "max_abs_err": errs[name],
                "ms": per[name][0], "plain_ms": per[name][1],
                "bound_ms": per[name][2], "bound_by": per[name][3],
                "library_ms": None}
               for name, (src, rep, also) in KERNELS.items()]
    log(f"[5] all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
