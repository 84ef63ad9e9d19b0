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
     each took and ptxas's registers and spills of the tiled kernels, the
     3-D color sweep and the 3-D block sweep (B5s);
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
     batched forcing, the in-place switch off and on; the block kernels
     (B2s sor2d_sweeps_block; B5s sor3d_color_sweep_block, through the
     block sweep kernel with three z chunkings and through its first
     version, the color sweep's block mode) on ghost-padded blocks cut
     from the main paths' grids (row blocks at odd and even origins, x
     splits with the extend corner clamps, the biharmonic on a row mesh,
     batched forcings, NaN boundary lines), one launch against its plain
     version, owned cells, partials or every buffer cell torch.equal, then
     37 sweeps with Chebyshev factors through the block
     executor on a local mesh against the plain meshless sweeps, and its
     norm on the aligned layout against the whole-grid kernels';
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
     gyre 65x129, 37x36x72, 20x55x120), within 1e-4 of max|S|.  Then
     the trajectories, float32, no device argument, each with the counts
     set to 0 just before it: animate_iteration("poisson") on the
     2048x2048 masked field, 30 frames of 5 sweeps, scheme "sor" and
     "cheby", through the tiled kernel alone, every frame equal
     (torch.equal) to the same trajectory through the plain sweeps on the
     card and the last to 150 sweeps of solve_fixed / solve_fixed_cheby;
     animate_iteration("omega") at 37x72x288, 6 frames, through the 3-D
     pair, checked the same way.  Then scheme="lexico" on the card in
     float64 (torch ops, no kernel launch) against the repository's
     notebook records (tests/notebook_truth.json), the fixtures rebuilt
     from their recipes (tools/make_fixtures.py): notebook 05's nonlinear
     invert_RefStateSWM chain (round 5 within 2 sweeps, mean|M| within
     1e-10), notebook 11's invert_omega on Data/atmos3d_like.nc, with and
     without icbc (31 sweeps, the tolerance within 1e-6), notebook 03's
     72x144 invert_Poisson: 50 sweeps against the CPU (within 1e-10 of
     max|S|, ms a sweep), then its 2001-sweep record when that fits 25 s.
     Then the 1-D inverters on the card (torch ops, chosen by the spec's
     rank), float64 and float32, 64 slices, scheme "sor" and "direct":
     invert_RefStateSWM on notebook 05's 121 latitudes,
     invert_GeoAdjustment on its 60 southern ones, the same iters as the
     CPU run, within 1e-12 of max|S| of it in float64, 1e-4 in float32.
     Then cal_flow of the 2048x2048 invert_Poisson field, on the host;
     refinement, streaming and implicit gradients.  Then the multi-device
     layer on local meshes whose blocks all run on the card, each path
     beside its meshless run (the same iters, torch.equal states and
     fields, through the block kernels alone; wall time and idle share of
     both): invert_Poisson 2048x2048 on ('y'=2, 'x'=2) and ('y'=4,), the
     SODA invert_Stommel on ('batch'=2, 'y'=2), invert_omega 37x72x288 on
     ('y'=3,), invert_3DOcean 30x330x720 on ('y'=2, 'x'=2),
     solve_fixed_halo_window3d on ('y'=8,) (9-row blocks) against
     solve_fixed, solve_refined on the 2048x2048 sphere (rounds,
     certificate, pair), and scaling_bench on 1, 2 and 4 blocks; then
     scheme="lexico" (notebook 03's 72x144 invert_Poisson, 50 sweeps) and
     invert_Poisson_mg on the same forcing with iParams["mesh"] on ('y'=2,):
     both solve whole, so each equals its meshless run (the same launches,
     iters, states and fields);
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
     the block kernels per launch on a 2x2 mesh's block of the 2048x2048
     Poisson and of the 30x330x720 ocean, beside their plain versions and
     bounds (B5s's block sweep in turns against its first version, red and
     black, and a scan of the levels a CTA walks); where a 2048x2048
     V-cycle's device time goes (smoothing against the rest), its wall
     time and host gap, host syncs per cycle.  With --parent-sor3d PATH
     (another tree's csrc/sor3d.cu), also the whole-grid 3-D color sweep
     of this tree against that one's build, in turns.  --blocks runs only
     phases 0 and 1, phase 2's 3-D block checks and phase 4's block
     timings (and prints no result line).

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
import sys
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
from xinvert_tpu_torch.parallel import halo as phalo
from xinvert_tpu_torch.parallel.mesh import Mesh
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
    # B2s and B5s: the block arguments of B2 and B5, which the multi-device
    # executors call (parallel/halo_window.py:292, halo_window3d.py:205)
    "sor2d_sweeps_block": ("xinvert_tpu_torch/csrc/sor2d.cu",
                           "xinvert_tpu/ops/pallas_sor_window.py:252",
                           "xinvert_tpu/parallel/halo_window.py:292"),
    # B5s's wrapper launches the block sweep kernel (sor3d_block_sweep);
    # its first version, the color sweep's block mode, is the yardstick
    "sor3d_color_sweep_block": ("xinvert_tpu_torch/csrc/sor3d.cu",
                                "xinvert_tpu/ops/pallas_sor3d_window.py:174",
                                "xinvert_tpu/parallel/halo_window3d.py:205"),
    "sor3d_color_sweep_block_first": (
        "xinvert_tpu_torch/csrc/sor3d.cu",
        "xinvert_tpu/ops/pallas_sor3d_window.py:174",
        "xinvert_tpu/parallel/halo_window3d.py:205"),
}
# each kernel's launch counter
COUNTERS = {"sor2d_sweeps_tiled": (sor2d, "TILED_LAUNCHES"),
            "sor2d_sweeps_tiled_inplace": (sor2d, "TILED_INPLACE_LAUNCHES"),
            "sor2d_extend_rows": (sor2d, "EXTEND_LAUNCHES"),
            "sor2d_color_sweep": (sor2d, "LAUNCHES"),
            "sor2d_color_sweep_inplace": (sor2d, "INPLACE_LAUNCHES"),
            "sor3d_extend_rows": (sor3d, "EXTEND_LAUNCHES"),
            "sor3d_color_sweep": (sor3d, "LAUNCHES"),
            "sor2d_sweeps_block": (sor2d, "BLOCK_LAUNCHES"),
            "sor3d_color_sweep_block": (sor3d, "BLOCK_LAUNCHES"),
            "sor3d_color_sweep_block_first": (sor3d, "BLOCK_FIRST_LAUNCHES")}
# another tree's csrc/sor3d.cu to time the whole-grid color sweep against
# (--parent-sor3d; phase 4)
PARENT_SOR3D = None
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
    # ptxas -v on the tiled kernels, the 3-D color sweep (the extend
    # read-through's registers) and the block sweep: registers, spills,
    # shared memory
    spills = []
    for src, key in (("sor2d", "tiled"), ("sor3d", "color_sweep"),
                     ("sor3d", "block_sweep")):
        lines = _build.BUILD_LOG.get(src, "").splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and key in line:
                inst = line.split("'")[1] if "'" in line else line
                info = " | ".join(x.split(":", 1)[-1].strip()
                                  for x in lines[i + 2:i + 4])
                log(f"[1] ptxas {inst}: {info}")
                if key == "block_sweep":
                    spills += [int(w) for w, u in zip(info.split(),
                                                      info.split()[1:])
                               if u == "bytes" and w.isdigit()][1:3]
    if spills:
        log(f"[1] the block sweep's instantiations spill {sum(spills)} B "
            f"(stores and loads, ptxas)")


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
    t0 = time.perf_counter()
    cases2, cases3 = block_cases(dev)
    for case in cases2:
        _check_block2d(*case, errs)
    for case in cases3:
        _check_block3d(*case, errs)
    log(f"[t] phase 2's block-kernel checks took "
        f"{time.perf_counter() - t0:.1f} s")
    return errs


# ------------------------------------------------ phase 2, block kernels

def local_mesh(dev, shape, names):
    """A local mesh whose every block runs on ``dev``."""
    arr = np.empty(int(np.prod(shape)), dtype=object)
    arr[:] = [dev] * arr.size
    return Mesh(arr.reshape(shape), names)


def _nan_err(a, b):
    """max |a - b| over the cells finite in both (0.0 when none)."""
    ok = torch.isfinite(a) & torch.isfinite(b)
    if not bool(ok.any()):
        return 0.0
    return float((a.double() - b.double())[ok].abs().max())


def _rand_state(shape, dt, dev, seed=7, nan_rows=False, levels=False):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    S0 = (torch.randn(shape, generator=gen, dtype=torch.float64)
          * 1e-3).to(dt).to(dev)
    if nan_rows:
        rows = (slice(1, -1),) if levels else ()
        S0[(Ellipsis,) + rows + (0, slice(None))] = float("nan")
        S0[(Ellipsis,) + rows + (-1, slice(None))] = float("nan")
    return S0


def block_cases(dev):
    """The block checks of phase 2: (name, make(dtype) -> (spec, S0,
    omega), the blocks as ((oy, ox), (by, bx), (gy, gx)), k, the mesh of
    the 37-sweep executor runs)."""
    def poisson2048(dt):
        spec, om = poisson_spec(2048, 2048, 0, dt, dev)
        return spec, _rand_state((2048, 2048), dt, dev), om

    def gallery(dt):
        spec, om = poisson_spec(73, 144, 8, dt, dev, seed=4)
        return spec, _rand_state((8, 73, 144), dt, dev, nan_rows=True), om

    def corners(dt):
        spec, om = random_spec((37, 53), ((1, 0), (-1, 0), (0, 1), (0, -1)),
                               ("extend", "fixed"), False, 2, True, dt, dev,
                               seed=5)
        return spec, _rand_state((2, 37, 53), dt, dev), om

    def soda(builder, mp):
        def make(dt):
            spec, om = soda_spec(builder, mp, 12, dt, dev)
            return spec, _rand_state((12, 330, 720), dt, dev), om
        return make

    def bih16(dt):
        spec, om = random_spec((33, 37), BIH_OFFSETS, ("extend", "periodic"),
                               True, 2, True, dt, dev, seed=3)
        return spec, _rand_state((2, 33, 37), dt, dev), om

    def omega(dt):
        spec, om = omega_spec(37, 72, 288, 0, dt, dev)
        return spec, _rand_state((37, 72, 288), dt, dev), om

    def omega_b(dt):
        spec, om = omega_spec(37, 72, 144, 3, dt, dev)
        return spec, _rand_state((3, 37, 72, 144), dt, dev), om

    def ocean(dt):
        spec, om = ocean_spec(30, dt, dev)
        return spec, _rand_state((30, 330, 720), dt, dev), om

    def corners3(dt):
        spec, om = random_spec((9, 17, 23), OFFSETS_3D,
                               ("fixed", "extend", "fixed"), False, 2, True,
                               dt, dev, seed=8)
        return spec, _rand_state((2, 9, 17, 23), dt, dev, nan_rows=True,
                                 levels=True), om

    two = local_mesh(dev, (2, 2), ("y", "x"))
    cases2 = [
        ("main path 2048x2048 (extend, periodic) masked, block (1, 1) of a "
         "2x2 mesh", poisson2048, [((1024, 1024), (1024, 1024), (9, 8))], 4,
         two),
        ("8x73x144 (extend, periodic) masked, batched forcing, NaN boundary "
         "lines, row blocks at an odd and an even origin", gallery,
         [((13, 0), (30, 144), (9, 0)), ((40, 0), (33, 144), (9, 0))], 4,
         local_mesh(dev, (3,), ("y",))),
        ("2x37x53 (extend, fixed) per-slice planes, x splits with the "
         "extend corner clamps", corners,
         [((0, 0), (16, 32), (9, 9)), ((16, 32), (21, 21), (9, 9))], 4, two),
        ("main path Stommel 12x330x720 SODA, batched forcing, pruned, "
         "block (0, 1) of a 2x2 mesh", soda(problems.build_stommel,
                                            STOMMEL_MP),
         [((0, 384), (168, 336), (9, 8))], 4, two),
        ("Stommel-Munk bih 12x330x720 SODA, pruned, a row block",
         soda(problems.build_stommelmunk, MUNK_MP),
         [((168, 0), (162, 720), (6, 0))], 1, local_mesh(dev, (2,), ("y",))),
        ("bih 16-offset 2x33x37 (extend, periodic) per-slice planes, a row "
         "block", bih16, [((8, 0), (17, 37), (6, 0))], 1,
         local_mesh(dev, (2,), ("y",))),
    ]
    cases3 = [
        ("main path omega 37x72x288 (fixed, fixed, periodic), a 9-row block "
         "at an odd origin", omega, [((9, 0), (9, 288), (8, 0))], 4,
         local_mesh(dev, (8,), ("y",))),
        ("omega 3x37x72x144 batched forcing, a row block", omega_b,
         [((24, 0), (24, 144), (8, 0))], 4, local_mesh(dev, (3,), ("y",))),
        ("main path ocean 30x330x720 (fixed, extend, periodic) masked, block "
         "(1, 1) of a 2x2 mesh", ocean, [((168, 384), (162, 336), (9, 8))], 4,
         two),
        ("2x9x17x23 (fixed, extend, fixed) per-slice planes, NaN rows, x "
         "splits with the extend corner clamps", corners3,
         [((0, 11), (17, 12), (0, 9)), ((8, 0), (9, 11), (9, 9))], 3, two),
    ]
    return cases2, cases3


def _facs(dt, n):
    return [float(torch.tensor(1.0 + 0.45 * (1 - 0.9 ** k), dtype=dt))
            for k in range(2 * n)]


def _check_block2d(name, make, blocks, k, mesh, errs):
    """sor2d_sweeps_block on each block, one launch of n in {1, k} sweeps,
    at omega and with Chebyshev factors, against its plain version on the
    same padded block: the owned cells and the |S| partials (where the
    origin is aligned) torch.equal, NaN matching NaN; then 37 sweeps with
    factors through the executor on ``mesh`` (the ghost exchange between
    launches) against the plain meshless sweeps, and on the aligned layout
    the executor's norm against the whole-grid tiled kernel's."""
    for dt in (torch.float32, torch.float64):
        spec, S0, om = make(dt)
        shape = tuple(S0.shape[-2:])
        ok, err = True, 0.0
        for origin, owned, g in blocks:
            P = phalo.padded_block(S0, origin, owned, g)
            bspec = phalo.padded_block_spec(spec, origin, owned, g)
            aligned = origin[0] % 8 == 0 and origin[1] % 32 == 0
            for n in sorted({1, k}):
                for o, f in ((om, None), (1.0, _facs(dt, n))):
                    b0 = sor2d.BLOCK_LAUNCHES
                    res = sor2d.sor2d_sweeps_block(
                        bspec, P, o, n, origin, shape, g, with_norm=aligned,
                        fac=f)
                    ref = sor2d.sor2d_sweeps_block_reference(
                        bspec, P, o, n, origin, shape, g, f, aligned)
                    torch.cuda.synchronize()
                    ok &= sor2d.BLOCK_LAUNCHES == b0 + 1
                    if aligned:
                        ok &= _bit_equal(res[1], ref[1])
                        res, ref = res[0], ref[0]
                    ok &= _bit_equal(res, ref)
                    err = max(err, _nan_err(res, ref))
        facs = _facs(dt, 37)
        ex = phalo.BlockExecutor(spec, S0, mesh, 1.0, checked=False)
        b0 = sor2d.BLOCK_LAUNCHES
        ex.sweeps(37, facs)
        out = ex.gather().reshape(S0.shape)
        ref = sor2d.sor2d_sweeps_reference(spec, S0, 1.0, 37, facs)
        torch.cuda.synchronize()
        ok &= (sor2d.BLOCK_LAUNCHES - b0
               == -(-37 // ex.k) * len(ex.dec.local))
        ok &= _bit_equal(out, ref)
        err = max(err, _nan_err(out, ref))
        exc = phalo.BlockExecutor(spec, S0, mesh, om, checked=True)
        tot = exc.totals(exc.sweeps(37, with_norm=True))
        whole = sor2d.sor2d_sweeps_tiled(spec, S0, om, 37, with_norm=True)[1]
        ok &= _bit_equal(tot.reshape(whole.shape), whole)
        errs["sor2d_sweeps_block"] = max(errs["sor2d_sweeps_block"], err)
        log(f"[2] {name} {str(dt)[6:]}: sor2d_sweeps_block on "
            f"{len(blocks)} block(s) (ghosts {[b[2] for b in blocks]}), n in "
            f"{sorted({1, k})} with and without factors, then 37 sweeps "
            f"through the executor on {dict(mesh.shape)} (k {ex.k}) and its "
            f"norm on the aligned layout (k {exc.k}): bit-equal={ok} "
            f"max|kernel-plain|={err:.3e}")
        if not ok:
            raise RuntimeError(f"sor2d_sweeps_block disagrees with its plain "
                               f"version on {name} {dt}")


def _check_block3d(name, make, blocks, k, mesh, errs):
    """B5s on each block, through the block sweep kernel (three z chunkings:
    the plan's, one level and five levels a CTA) and through its first
    version (the color sweep's block mode): the red launch with the extend
    pre-pass folded in and the black launch with the owned |S| partials,
    with and without a Chebyshev factor, against the plain version: every
    cell of the padded buffer torch.equal, NaN matching NaN; then 37 sweeps
    with factors through the executor on ``mesh`` against the plain
    meshless sweeps, and on the aligned layout its norm against the
    whole-grid pair's."""
    def block_sweep(zc):
        """The block sweep's one launch walking zc levels a CTA (0: the
        launcher's choice)."""
        def launch(spec, lay, *args):
            sor3d._launch_block(spec, dict(lay, zc=zc), *args)
        return lambda *args: sor3d._block_once(launch, *args)
    wrappers = [("sor3d_color_sweep_block", block_sweep(zc), "BLOCK_LAUNCHES")
                for zc in (0, 1, 5)]
    wrappers.append(("sor3d_color_sweep_block_first",
                     sor3d.sor3d_color_sweep_block_first,
                     "BLOCK_FIRST_LAUNCHES"))
    for dt in (torch.float32, torch.float64):
        spec, S0, om = make(dt)
        shape = tuple(S0.shape[-2:])
        ok, err = True, {kname: 0.0 for kname, *_ in wrappers}
        for origin, owned, g in blocks:
            P = phalo.padded_block(S0, origin, owned, g)
            bspec = phalo.padded_block_spec(spec, origin, owned, g)
            rel = sor3d.relax_plane(bspec, om)
            for fac in (1.0, float(torch.tensor(1.37, dtype=dt))):
                for color, ext, norm in ((0, True, False), (1, False, True)):
                    ref = sor3d.sor3d_color_sweep_block_reference(
                        bspec, P, rel, color, origin, shape, g, fac, ext,
                        norm)
                    for kname, fn, counter in wrappers:
                        b0 = getattr(sor3d, counter)
                        res = fn(bspec, P, rel, color, origin, shape, g, fac,
                                 ext, norm)
                        torch.cuda.synchronize()
                        ok &= getattr(sor3d, counter) == b0 + 1
                        if norm:
                            ok &= _bit_equal(res[1], ref[1])
                            res = res[0]
                        r = ref[0] if norm else ref
                        ok &= _bit_equal(res, r)
                        err[kname] = max(err[kname], _nan_err(res, r))
        facs = _facs(dt, 37)
        ex = phalo.BlockExecutor(spec, S0, mesh, 1.0, checked=False)
        b0 = sor3d.BLOCK_LAUNCHES
        ex.sweeps(37, facs)
        out = ex.gather().reshape(S0.shape)
        ref = sor3d.sor3d_sweeps_reference(spec, S0, 1.0, 37, facs)
        torch.cuda.synchronize()
        ok &= sor3d.BLOCK_LAUNCHES - b0 == 74 * len(ex.dec.local)
        ok &= _bit_equal(out, ref)
        err["sor3d_color_sweep_block"] = max(err["sor3d_color_sweep_block"],
                                             _nan_err(out, ref))
        try:
            exc = phalo.BlockExecutor(spec, S0, mesh, om, checked=True)
        except ValueError:
            exc = None          # the aligned layout leaves a block too thin
        if exc is not None:
            tot = exc.totals(exc.sweeps(37, with_norm=True))
            whole = sor3d.sor3d_sweeps(spec, S0, om, 37, with_norm=True)[1]
            ok &= _bit_equal(tot.reshape(whole.shape), whole)
        for kname in err:
            errs[kname] = max(errs[kname], err[kname])
        log(f"[2] {name} {str(dt)[6:]}: B5s on {len(blocks)} block(s) "
            f"(ghosts {[b[2] for b in blocks]}), red (extend folded in) and "
            f"black (owned partials), factors 1 and 1.37, through the block "
            f"sweep kernel (z chunks: the launcher's, 1, 5) and its first "
            f"version, then 37 sweeps through the executor on "
            f"{dict(mesh.shape)} (k {ex.k})"
            + ("" if exc is None else " and its norm on the aligned layout")
            + f": bit-equal={ok} max|kernel-plain|="
            f"{max(err.values()):.3e}")
        if not ok:
            raise RuntimeError(f"B5s disagrees with its plain version on "
                               f"{name} {dt}")


# ---------------------------------------------------------------- phase 3

def _zero_counts():
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)
    sor2d.PLAIN_CALLS = sor3d.PLAIN_CALLS = 0


def _counts():
    """Every kernel's launch count, and the plain versions' calls."""
    return ({k: getattr(mod, attr) for k, (mod, attr) in COUNTERS.items()},
            sor2d.PLAIN_CALLS + sor3d.PLAIN_CALLS)


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
    counts, plain = _counts()
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
    counts, plain = _counts()
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


# ------------------------------- phase 3, trajectories, lexico, 1-D, flow

TRAJ_N = 2048         # the 2048x2048 masked Poisson of phase 3
NB_TRUTH = os.path.join("tests", "notebook_truth.json")
NB03_SWEEPS = 50      # lexico sweeps held against the CPU at NB03's grid
NB03_BUDGET_S = 25.0  # the full 2001-sweep NB03 record runs within this


def _plain_frames(spec, S0, omega, lpf, frames, scheme):
    """The trajectory of ``scheme`` through the plain sweeps
    (solver.sweeps) on the card, frame by frame."""
    from xinvert_tpu_torch import solver
    rho2 = solver.rho2_from_omega(omega, S0.dtype)
    m, w, S, out = 0, rho2.dtype.type(1.0), S0, []
    for _ in range(frames):
        if scheme == "cheby":
            fac, m, w = solver._cheby_factors(m, w, rho2, 2 * lpf)
            S = solver.sweeps(spec, S, 1.0, lpf, fac)
        else:
            S = solver.sweeps(spec, S, omega, lpf)
        out.append(S)
    return out


def _trajectory(name, key, field, dims, iP, mP, lpf, frames, kernels,
                launches):
    """animate_iteration with no device argument, every count set to 0
    just before it and read just after: it must run through ``kernels``
    alone.  Every frame must equal (torch.equal, the undef mask applied
    the same way) the same trajectory through the plain sweeps on the
    card, and the last one solve_fixed / solve_fixed_cheby of all its
    sweeps."""
    from xinvert_tpu_torch import solver
    _zero_counts()
    t0 = time.perf_counter()
    out = xt.animate_iteration(key, field, dims, mParams=mP, iParams=iP,
                               loop_per_frame=lpf, max_frames=frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, plain = _counts()
    ran = ", ".join(f"{k} {v}" for k, v in counts.items() if v)
    log(f"[3] animate_iteration {name} float32: {frames} frames of {lpf} "
        f"sweeps in {wall:.3f} s; launches: {ran}; plain calls {plain}")
    if {k for k, v in counts.items() if v} != set(kernels) or plain:
        raise RuntimeError(f"animate_iteration {name}: the trajectory did "
                           f"not run through {sorted(kernels)} alone")
    for k, v in counts.items():
        launches[k] += v
    spec, S0, omega, scheme, Fdef, _, iP_m = api._animate_problem(
        key, field, dims, "lat-lon", None, mP, iP, None)
    t0 = time.perf_counter()
    ref = _plain_frames(spec, S0, omega, lpf, frames, scheme)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    fixed = (solver.solve_fixed if scheme == "sor"
             else solver.solve_fixed_cheby)(spec, S0, omega, lpf * frames)

    def masked(S):
        return np.where(Fdef, S.cpu().numpy(), iP_m["undef"])

    same = [np.array_equal(out.values[k], masked(ref[k]), equal_nan=True)
            for k in range(frames)]
    last = (torch.equal(ref[-1], fixed)
            and np.array_equal(out.values[-1], masked(fixed),
                               equal_nan=True))
    log(f"[3] animate_iteration {name}: frames equal to the plain "
        f"sweeps on the card {sum(same)}/{frames} (plain trajectory "
        f"{plain_s:.3f} s); last frame equal to {lpf * frames} sweeps of "
        f"solve_fixed{'_cheby' if scheme == 'cheby' else ''}: {last}; "
        f"iter {out.coords['iter'][0]}..{out.coords['iter'][-1]}")
    if not all(same) or not last:
        raise RuntimeError(f"animate_iteration {name}: the trajectory "
                           "differs from the plain sweeps")
    return out


def phase3_traj(launches):
    """Solution trajectories in float32 through the kernels."""
    torch.set_default_dtype(torch.float32)
    big = poisson_field(TRAJ_N, TRAJ_N)
    iP = {"BCs": ["extend", "periodic"], "undef": np.nan,
          "printInfo": False}
    for scheme in ("sor", "cheby"):
        _trajectory(f"poisson {TRAJ_N}x{TRAJ_N} {scheme}", "poisson", big,
                    ["lat", "lon"], dict(iP, scheme=scheme), None, 5, 30,
                    ("sor2d_sweeps_tiled",), launches)
    F_om, N2_om = atmos3d(37, 72, 288)
    iP_om = {"BCs": ["fixed", "fixed", "periodic"], "printInfo": False}
    _trajectory("omega 37x72x288 sor", "omega", F_om, DIMS_3D, iP_om,
                {"N2": N2_om}, 5, 6, ("sor3d_color_sweep",), launches)


def barotropic2d(ny=121, nc=181):
    """The latitudes and the contour tabulations (PV, Mass, Circ) of
    Data/barotropic2d_like.nc, rebuilt from its recipe
    (tools/make_fixtures.py::make_barotropic2d, bit-equal to the file, so
    the run needs no HDF5 reader): an exactly balanced zonally symmetric
    shallow-water state, tabulated M(Q) and C(Q)."""
    R, Om, g = 6371200.0, 7.292e-5, 9.80665
    lat = np.linspace(-90.0, 90.0, ny)
    phif = np.deg2rad(np.linspace(-90.0, 90.0, 4 * (ny - 1) + 1))
    uf = 8.0 * np.sin(2 * phif) * np.cos(phif) ** 2
    f = 2 * Om * np.sin(phif)
    dh = -R * (f + uf * np.tan(np.clip(phif, -1.55, 1.55)) / R) * uf / g
    hf = 5000.0 + np.concatenate(
        [[0.0], np.cumsum(0.5 * (dh[1:] + dh[:-1]) * np.diff(phif))])
    ucos = uf * np.cos(phif)
    cosf = np.cos(phif)
    zetaf = -np.gradient(ucos, phif) / (R * np.where(cosf > 1e-6, cosf, 1.0))
    zetaf[0], zetaf[-1] = zetaf[1], zetaf[-2]
    Qf = (f + zetaf) / hf
    Cf = 2 * np.pi * R * np.cos(phif) * (uf + Om * R * np.cos(phif))
    dM = 2 * np.pi * R ** 2 * np.cos(phif) * hf
    Mf = np.concatenate(
        [[0.0], np.cumsum(0.5 * (dM[1:] + dM[:-1]) * np.diff(phif))])
    Q, C, M = Qf[::4], Cf[::4], Mf[::4]
    qs = np.linspace(Q.min(), Q.max(), nc)
    return lat, qs, np.interp(qs, Q, M), np.interp(qs, Q, C)


def nb11_fields():
    """The forcing, the 3-D N2 field and the lower-boundary icbc of
    Data/atmos3d_like.nc (37x72x144), rebuilt from its recipe
    (tools/make_fixtures.py::make_atmos3d, the same as :func:`atmos3d`'s)."""
    F, N2 = atmos3d(37, 72, 144)
    lev, lat, lon = (F.coords[d] for d in DIMS_3D)
    N2v = np.broadcast_to(N2.values[:, None, None], F.shape).copy()
    W = np.zeros(F.shape)
    W[-1] = 0.1 * np.sin(2 * np.deg2rad(lon))[None, :] * \
        np.cos(np.deg2rad(lat))[:, None]
    return (F, xt.Field(N2v, tuple(DIMS_3D), dict(F.coords)),
            xt.Field(W, tuple(DIMS_3D), dict(F.coords)))


def _nb05_chain():
    """Notebook 05's nonlinear RefStateSWM chain (five outer rounds on
    Data/barotropic2d_like.nc's tabulations,
    tests/notebook_workloads.py::run_nb05), scheme="lexico", no device
    argument.  Returns mean|M| of the last round's M."""
    lat, ctr, Mass, Circ = barotropic2d()
    iP = {"BCs": ["fixed"], "mxLoop": 5001, "tolerance": 1e-15,
          "undef": np.nan, "scheme": "lexico", "printInfo": False}
    Mref = Mass.max() * (np.sin(np.deg2rad(lat)) + 1.0) / 2.0
    for _ in range(5):
        Q = np.interp(Mref, Mass, ctr)
        Q[lat == 90] = ctr.max()
        C = np.interp(Q, ctr, Circ)
        mP = {"M0": xt.Field(Mref, ("lat",), {"lat": lat}),
              "C0": xt.Field(C, ("lat",), {"lat": lat})}
        dM = xt.invert_RefStateSWM(xt.Field(Q, ("lat",), {"lat": lat}),
                                   dims=["lat"], iParams=iP, mParams=mP)
        Mref = Mref + dM.values
    return float(np.mean(np.abs(Mref)))


def _nb03_fields():
    """Notebook 03's balanced-mass workload (tests/notebook_workloads.py::
    nb03_fields): the Laplacian of a synthetic 500-hPa geopotential on the
    72x144 2.5-degree grid, and the geopotential itself (the icbc)."""
    from xinvert_tpu_torch.fd import FiniteDiff
    lat = np.linspace(-87.5, 87.5, 72)
    lon = np.arange(144) * 2.5
    latr, lonr = np.deg2rad(lat)[:, None], np.deg2rad(lon)[None, :]
    h = (5600.0 - 380.0 * np.sin(latr) ** 2
         + 90.0 * np.cos(latr) ** 2 * np.sin(3 * lonr + 2.0 * np.sin(latr))
         + 40.0 * np.cos(latr) ** 4 * np.cos(5 * lonr - 1.0)) * 9.81
    fd = FiniteDiff({"Y": "lat", "X": "lon"},
                    BCs={"Y": "extend", "X": "periodic"}, coords="lat-lon")
    hbc = xt.Field(h, ("lat", "lon"), {"lat": lat, "lon": lon})
    return fd.Laplacian(hbc, ["Y", "X"]), hbc


def _lexico_run(name, call):
    """One lexico call with no device argument: no kernel launch and no
    plain call of the kernel wrappers (torch ops); its wall time."""
    _zero_counts()
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, plain = _counts()
    if any(counts.values()) or plain:
        raise RuntimeError(f"{name}: lexico launched a sweep kernel")
    res = api.LAST_SOLVE
    if not res.S.is_cuda:
        raise RuntimeError(f"{name}: lexico did not run on the card")
    return out, res, wall


def _record(name, res, rec, wall, sweeps_slack=0, rtol=1e-6):
    it, rel = int(res.iters.reshape(-1)[0]), float(
        res.rel_change.reshape(-1)[0])
    ok = (abs(it - rec["sweeps"]) <= sweeps_slack
          and abs(rel - rec["tolerance"]) <= rtol * abs(rec["tolerance"]))
    log(f"[3] {name} lexico float64: sweeps {it} (record {rec['sweeps']}), "
        f"rel_change {rel:.10e} (record {rec['tolerance']:.10e}, rtol "
        f"{rtol:g}) in {wall:.3f} s, {1e3 * wall / max(it, 1):.3f} ms a "
        f"sweep: {'held' if ok else 'MISSED'}")
    if not ok:
        raise RuntimeError(f"{name}: lexico misses the notebook record")


def phase3_lexico():
    """scheme="lexico" on the card in float64 against the repository's
    notebook records, with no device argument."""
    torch.set_default_dtype(torch.float64)
    with open(NB_TRUTH) as fh:
        truth = json.load(fh)
    # NB05: the nonlinear RefStateSWM chain (1-D)
    _zero_counts()
    t0 = time.perf_counter()
    mean_M = _nb05_chain()
    wall = time.perf_counter() - t0
    rec = truth["nb05_swm_round5"]
    it = int(api.LAST_SOLVE.iters)
    ok = (abs(it - rec["sweeps"]) <= 2
          and abs(mean_M - rec["mean_abs_M"]) <= 1e-10 * rec["mean_abs_M"])
    counts, plain = _counts()
    log(f"[3] NB05 RefStateSWM chain lexico float64: round 5 sweeps {it} "
        f"(record {rec['sweeps']}, slack 2), mean|M| {mean_M:.16e} (record "
        f"{rec['mean_abs_M']:.16e}, rel 1e-10) in {wall:.3f} s for five "
        f"rounds: {'held' if ok else 'MISSED'}")
    if not ok or any(counts.values()) or plain:
        raise RuntimeError("NB05: lexico misses the notebook record")
    # NB11: invert_omega on the atmosphere fixture, 31 sweeps (3-D)
    F, N2, WBC = nb11_fields()
    iP = {"BCs": ["fixed", "fixed", "periodic"], "mxLoop": 31,
          "tolerance": 1e-16, "scheme": "lexico", "printInfo": False}
    for key, icbc in (("nb11_omega", None), ("nb11_omega_icbc", WBC)):
        _, res, wall = _lexico_run(key, lambda ic=icbc: xt.invert_omega(
            F, dims=DIMS_3D, mParams={"N2": N2}, iParams=iP, icbc=ic))
        _record(f"NB11 invert_omega {'x'.join(map(str, F.shape))} "
                f"({key})", res, truth[key], wall)
    # NB03: invert_Poisson at 72x144 (2-D rows), a fixed count against
    # the CPU, then the full record when it fits the budget
    force, hbc = _nb03_fields()
    iP3 = {"BCs": ["fixed", "periodic"], "mxLoop": NB03_SWEEPS,
           "tolerance": 0.0, "scheme": "lexico", "printInfo": False}
    out, res, wall = _lexico_run("NB03", lambda: xt.invert_Poisson(
        force, dims=["lat", "lon"], icbc=hbc, iParams=iP3))
    t0 = time.perf_counter()
    ref = xt.invert_Poisson(force, dims=["lat", "lon"], icbc=hbc,
                            iParams=iP3, device="cpu")
    cpu_s = time.perf_counter() - t0
    gap = (np.abs(out.values - ref.values).max()
           / np.abs(ref.values).max())
    ms = 1e3 * wall / NB03_SWEEPS
    log(f"[3] NB03 invert_Poisson 72x144 lexico float64: {NB03_SWEEPS} "
        f"sweeps on the card in {wall:.3f} s ({ms:.3f} ms a sweep, a check "
        f"each), on the CPU {cpu_s:.3f} s; max|diff|/max|S| {gap:.3e} "
        f"(limit 1e-10)")
    if not gap <= 1e-10:
        raise RuntimeError("NB03: lexico on the card disagrees with the CPU")
    rec = truth["nb03_poisson_icbc"]
    if rec["sweeps"] * ms / 1e3 <= NB03_BUDGET_S:
        iPr = dict(iP3, mxLoop=2001, tolerance=1e-12)
        _, res, wall = _lexico_run("NB03 record", lambda: xt.invert_Poisson(
            force, dims=["lat", "lon"], icbc=hbc, iParams=iPr))
        _record("NB03 invert_Poisson 72x144 (nb03_poisson_icbc)", res, rec,
                wall)
    else:
        log(f"[3] NB03 record (2001 sweeps) not run: "
            f"{rec['sweeps'] * ms / 1e3:.1f} s projected, above the "
            f"{NB03_BUDGET_S} s budget")


def _geo_field(lat, batch=64, seed=11):
    rng = np.random.default_rng(seed)
    h = (1500.0 + 20.0 * (lat > lat.mean())
         + rng.standard_normal((batch, lat.size)))
    return xt.Field(h, ("time", "lat"), {"time": np.arange(batch),
                                         "lat": lat})


def _swm_field(lat, ctr, Mass, Circ, batch=64, seed=12):
    M = Mass.max() * (np.sin(np.deg2rad(lat)) + 1.0) / 2.0
    Q = np.interp(M, Mass, ctr)
    Q[lat == 90] = ctr.max()
    C = np.interp(Q, ctr, Circ)
    rng = np.random.default_rng(seed)
    Qb = Q * (1.0 + 1e-3 * rng.standard_normal((batch, lat.size)))
    return (xt.Field(Qb, ("time", "lat"), {"time": np.arange(batch),
                                           "lat": lat}),
            {"M0": xt.Field(M, ("lat",), {"lat": lat}),
             "C0": xt.Field(C, ("lat",), {"lat": lat})})


def phase3_1d():
    """The 1-D inverters on the card (plain torch ops, chosen by the spec's
    rank), float64 and float32, 64 slices, against the same calls on the
    CPU."""
    lat, ctr, Mass, Circ = barotropic2d()
    Fs, mPs = _swm_field(lat, ctr, Mass, Circ)
    # the geostrophic adjustment needs one hemisphere (f changes sign at
    # the equator and the global grid overflows in both packages): the
    # NB05 grid's 60 southern latitudes
    Fg = _geo_field(lat[lat < 0])
    calls = {
        "invert_GeoAdjustment 64x60": lambda iP, **kw:
            xt.invert_GeoAdjustment(Fg, ["lat"], iParams=dict(iP, optArg=1.8),
                                    **kw),
        "invert_RefStateSWM 64x121": lambda iP, **kw:
            xt.invert_RefStateSWM(Fs, ["lat"], iParams=iP, mParams=mPs,
                                  **kw)}
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-5)):
        torch.set_default_dtype(dtype)
        for name, call in calls.items():
            for scheme in ("sor", "direct"):
                iP = {"BCs": ["fixed"], "mxLoop": 5000, "tolerance": tol,
                      "checkEvery": 1, "scheme": scheme, "printInfo": False}
                _zero_counts()
                t0 = time.perf_counter()
                out = call(iP)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                r_k = api.LAST_SOLVE
                counts, plain = _counts()
                t0 = time.perf_counter()
                ref = call(iP, device="cpu")
                cpu_s = time.perf_counter() - t0
                r_c = api.LAST_SOLVE
                same = torch.equal(r_k.iters.cpu(), r_c.iters)
                gap = (np.abs(out.values - ref.values).max()
                       / np.abs(ref.values).max())
                # float32: phase 3's limit for the card against the CPU
                limit = 1e-12 if dtype == torch.float64 else 1e-4
                log(f"[3] {name} {scheme} {str(dtype)[6:]}: card iters "
                    f"{r_k.iters.min().item()}..{r_k.iters.max().item()} in "
                    f"{wall:.3f} s, CPU in {cpu_s:.3f} s, iters equal "
                    f"{same}; max|diff|/max|S| {gap:.3e} (limit {limit:g});"
                    f" kernel launches {sum(counts.values())}, plain calls "
                    f"{plain}")
                if (not same or not gap <= limit or any(counts.values())
                        or plain or bool(r_k.overflow.any())
                        or not r_k.S.is_cuda):
                    raise RuntimeError(f"{name} {scheme}: the card's 1-D "
                                       "solve disagrees with the CPU")
    torch.set_default_dtype(torch.float32)


def phase3_calflow(sor):
    """cal_flow of phase 3's 2048x2048 Poisson field (a host Field, numpy
    finite differences as in the JAX package): equal to the same call on
    a copy of its values held on the host."""
    sf = sor["poisson"][0]
    t0 = time.perf_counter()
    u, v = xt.cal_flow(sf, ["lat", "lon"], BCs=("extend", "periodic"))
    wall = time.perf_counter() - t0
    copy = xt.Field(np.array(sf.values), sf.dims, dict(sf.coords))
    u2, v2 = xt.cal_flow(copy, ["lat", "lon"], BCs=("extend", "periodic"))
    same = (np.array_equal(u.values, u2.values, equal_nan=True)
            and np.array_equal(v.values, v2.values, equal_nan=True))
    finite = float(np.mean(np.isfinite(u.values) & np.isfinite(v.values)))
    ocean = float(np.mean(~np.isnan(sf.values)))
    log(f"[3] cal_flow of invert_Poisson {TRAJ_N}x{TRAJ_N}: {wall:.3f} s "
        f"on the host, (u, v) {u.shape}, finite share {finite:.4f} (ocean "
        f"{ocean:.4f}), max|u| {np.nanmax(np.abs(u.values)):.4e}, equal to "
        f"the call on the host copy: {same}")
    if not same or not finite > 0.9 * ocean or u.shape != sf.shape:
        raise RuntimeError("cal_flow: wrong (u, v)")


# ---------------- phase 3, refinement, streaming and implicit gradients

def _path(name, kernels, call, launches=None):
    """``call()`` with every count set to 0 just before it and read just
    after: it must have launched each of ``kernels`` and nothing else, with
    no plain call.  The full-size runs add their launches to ``launches``.
    Returns (its result, the wall seconds)."""
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, plain = _counts()
    ran = ", ".join(f"{k} {v}" for k, v in counts.items() if v) or "none"
    log(f"[3] {name}: wall {wall:.3f} s; launches: {ran}; plain calls "
        f"{plain}")
    if {k for k, v in counts.items() if v} != set(kernels) or plain:
        raise RuntimeError(f"{name}: the path did not run through "
                           f"{sorted(kernels) or 'torch ops'} alone")
    if launches is not None:
        for k, v in counts.items():
            launches[k] += v
    return out, wall


def _to(spec, device=None, dtype=None):
    """``spec`` with its tensors moved to ``device`` and its float planes
    cast to ``dtype`` (an exact up-cast from float32 to float64)."""
    out = {}
    for n in ("w", "w0", "g", "relax", "active"):
        t = getattr(spec, n)
        if device is not None:
            t = t.to(device)
        if dtype is not None and n != "active":
            t = t.to(dtype)
        out[n] = t
    return dataclasses.replace(spec, **out)


class _Capture:
    """While active, ``module.name`` records the arguments (``calls``) and
    results (``results``) of its calls and runs as before: what an entry
    point handed on and got back."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.calls, self.results = [], []

    def __enter__(self):
        self.real = getattr(self.module, self.name)
        setattr(self.module, self.name, self._call)
        return self

    def _call(self, *a, **k):
        self.calls.append((a, k))
        out = self.real(*a, **k)
        self.results.append(out)
        return out

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def phase3_eft(dev):
    """TwoSum and TwoProd on the card, 1M float32 pairs with exponents
    spread over 1e+-8 (tests/test_refine.py's recipe): s + e must equal the
    float64 sum and product exactly."""
    from xinvert_tpu_torch.ops.compensated import two_prod, two_sum
    rng = np.random.default_rng(0)
    n = 1 << 20
    a, b = ((rng.normal(0, 1, n) * 10.0 ** rng.integers(-8, 9, n)).astype(
        np.float32) for _ in range(2))
    ta, tb = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    for fn, exact in ((two_sum, a64 + b64), (two_prod, a64 * b64)):
        s, e = fn(ta, tb)
        got = s.double().cpu().numpy() + e.double().cpu().numpy()
        bad = int(np.count_nonzero(got != exact))
        log(f"[3] {fn.__name__} on the card, {n} float32 pairs: s + e "
            f"differs from the float64 value at {bad} pairs")
        if bad:
            raise RuntimeError(f"{fn.__name__} is not exact on the card")


def sphere_spec(n, dtype, device):
    """The full-sphere n x n lat-lon Poisson (extend, periodic), every
    cell active, forcing sin(3 lon) cos(2 lat) 1e-5 (tests/test_refine.py's
    polar-metric case)."""
    lat = np.linspace(-88.75, 88.75, n)
    lon = np.linspace(0.0, 360.0 - 360.0 / n, n)
    grid = Grid.make(("lat", "lon"), (lat, lon), "lat-lon",
                     bcs=("extend", "periodic"))
    vor = (np.sin(3 * np.deg2rad(lon))[None, :]
           * np.cos(2 * np.deg2rad(lat))[:, None] * 1e-5)
    spec = problems.build_poisson(
        torch.as_tensor(vor, dtype=dtype, device=device),
        torch.ones((n, n), dtype=torch.bool, device=device), grid,
        default_mParams)
    return spec, grid.omega_opt


def _truth(spec, r):
    """The float64 relative residual of the pair S_hi + S_lo (exact in
    float64) against the same operator cast to float64: evaluated with the
    error-free transformations in float64, whose error is far below the
    certificate's, and plainly (whose own rounding, eps64 * mean|w0 S| /
    mean|g|, can reach the certificate on the full sphere)."""
    from xinvert_tpu_torch.ops.compensated import residual_norm_compensated
    from xinvert_tpu_torch.solver import _residual_norm, _residual_scale
    s64 = _to(spec, dtype=torch.float64)
    Sd = r.S_hi.double() + r.S_lo.double()
    scale = _residual_scale(s64)
    return (residual_norm_compensated(s64, Sd) / scale,
            _residual_norm(s64, Sd) / scale)


def _eft_bound(spec, S):
    """The double-float32 measurement bound of a certificate, per slice:
    eps32^2 * mean(|g| + |w0 S| + sum_k |w_k S_k|) / mean|g| over active
    cells.  Each cell's compensated residual is exact to O(eps^2) of the
    sum of its terms; where that sum dwarfs |g| (the polar rows of the
    full sphere) the certificate cannot resolve residuals below it."""
    from xinvert_tpu_torch.ops.compensated import _shift
    from xinvert_tpu_torch.solver import _residual_scale
    s64, S = _to(spec, dtype=torch.float64), S.double()
    tot = s64.g.abs() + (s64.w0 * S).abs()
    for k, off in enumerate(s64.offsets):
        tot = tot + (s64.w[k] * _shift(S, off, s64.ndim)).abs()
    tot = torch.where(s64.active, tot, 0.0)
    axes = tuple(range(-s64.ndim, 0))
    mean = tot.sum(dim=axes) / s64.active.sum()
    return mean / _residual_scale(s64) * float(np.finfo(np.float32).eps) ** 2


def _certified(name, r, spec, tol):
    """The certificate of a refined solve against the float64 residual of
    its pair: within 1e-3 of its value plus the double-float32 measurement
    bound (:func:`_eft_bound`), and at most ``tol`` unless None."""
    cert = r.rel_residual.double()
    truth, plain = _truth(spec, r)
    bound = _eft_bound(spec, r.S_hi)
    err = (cert - truth).abs()
    gap = float((err / truth).max())
    ok = bool((err <= 1e-3 * truth + bound).all())
    log(f"[3] {name}: rounds {r.rounds}, certified residual "
        f"{float(cert.max()):.4e}, float64 residual of S_hi + S_lo "
        f"{float(truth.max()):.4e} (evaluated plainly in float64 "
        f"{float(plain.max()):.4e}); relative gap {gap:.2e}, |gap| "
        f"{float(err.max()):.3e} against 1e-3 of the value plus the "
        f"double-float32 bound {float(bound.max()):.3e}: {ok}")
    if not (ok and (tol is None or float(cert.max()) <= tol)):
        raise RuntimeError(f"{name}: the certificate does not hold")


REFINE_N = 2048        # the full-sphere grid of the refined 2-D phase


def phase3_refined(launches):
    """Certified refinement in float32 through the kernels: solve_refined
    on the 2048x2048 full sphere (tol 1e-8) beside the plain float32 floor
    and the plain float64 solve to the same residual; invert_Stommel_mg
    with tolType='refined' on the SODA curl (12x330x720, x-line smoothing:
    torch ops); invert_omega with tolType='refined' at 37x72x288 through
    the 3-D pair.  Returns the timings for PERF.md."""
    from xinvert_tpu_torch.solver import _residual_scale
    from xinvert_tpu_torch.ops.compensated import residual_norm_compensated
    dev = torch.device("cuda", 0)
    n = REFINE_N
    spec, omega = sphere_spec(n, torch.float32, dev)
    S0 = torch.zeros((n, n), dtype=torch.float32, device=dev)
    r, wall = _path(f"solve_refined {n}x{n} full sphere float32, tol 1e-8",
                    TILED[False], lambda: xt.solve_refined(
                        spec, S0, omega=omega, tol=1e-8), launches)
    _certified(f"solve_refined {n}x{n} float32", r, spec, 1e-8)
    plain, wall_p = _path(
        f"solve {n}x{n} float32, residual rule, tol 1e-10, 10000 sweeps "
        f"(the float32 floor)", TILED[False], lambda: xt.solve(
            spec, S0, omega, tol=1e-10, max_iters=10000, check_every=32,
            tol_type="residual"))
    floor = float(residual_norm_compensated(spec, plain.S)
                  / _residual_scale(spec))
    log(f"[3] solve {n}x{n} float32 floor: iters {int(plain.iters)}, "
        f"float32 residual {float(plain.rel_change):.4e}, its compensated "
        f"residual {floor:.4e}, against the refined pair's "
        f"{float(r.rel_residual):.4e}")
    s64 = _to(spec, dtype=torch.float64)
    r64, wall64 = _path(
        f"solve {n}x{n} float64, residual rule, tol 1e-8", TILED[False],
        lambda: xt.solve(s64, S0.double(), omega, tol=1e-8,
                         max_iters=60000, check_every=32,
                         tol_type="residual"))
    log(f"[3] {n}x{n} to a residual of 1e-8: refined float32 {wall:.3f} s "
        f"({r.rounds} rounds, {float(r.rel_residual):.4e}); plain float64 "
        f"{wall64:.3f} s ({int(r64.iters)} sweeps, "
        f"{float(r64.rel_change):.4e}); ratio f64/refined "
        f"{wall64 / wall:.3f}")
    if not float(r64.rel_change) <= 1e-8:
        raise RuntimeError("the float64 solve did not reach 1e-8")

    from xinvert_tpu_torch import refine
    from xinvert_tpu_torch.solver import _residual_norm
    soda = soda_curl()
    iP = {"BCs": ["extend", "periodic"], "undef": np.nan}
    with _Capture(refine, "solve_refined") as cap, \
            _Capture(mg, "solve_mg") as inner:
        out, wall_mg = _path(
            "invert_Stommel_mg 12x330x720 float32, tolType='refined'", (),
            lambda: xt.invert_Stommel_mg(
                soda, dims=["lat", "lon"], mParams=STOMMEL_MP,
                iParams=dict(iP, tolType="refined")), launches)
    rr = api.LAST_REFINE
    log("[3] invert_Stommel_mg refined, its multigrid solves (round 0 "
        "first): " + "; ".join(
            f"{k} cycles to {res:.3e} (max|r|/max|g|)"
            for _, k, res, _ in inner.results))
    _certified("invert_Stommel_mg 12x330x720 float32 refined", rr,
               cap.calls[0][0][0], None)
    land = np.isnan(soda.values)
    if not (np.array_equal(np.isnan(out.values), land)
            and np.isfinite(rr.rel_residual.cpu().numpy()).all()):
        raise RuntimeError("invert_Stommel_mg refined: non-finite answer")
    log(f"[3] invert_Stommel_mg 12x330x720 float32 refined: rounds "
        f"{rr.rounds}, certified residual (mean|r|/mean|g|) per month max "
        f"{float(rr.rel_residual.max()):.4e}, {wall_mg:.3f} s; converged "
        f"{float(rr.rel_residual.max()) <= 1e-6} (tol 1e-6); plain "
        f"multigrid stalls near 1.6e-3 (max|r|/max|g|, phase 3 above)")
    # the same call in plain float64, to a max-norm residual of 1e-8
    torch.set_default_dtype(torch.float64)
    try:
        with _Capture(mg, "solve_mg") as run:
            out64, wall_mg64 = _path(
                "invert_Stommel_mg 12x330x720 float64, tol 1e-8", (),
                lambda: xt.invert_Stommel_mg(
                    soda, dims=["lat", "lon"], mParams=STOMMEL_MP,
                    iParams=iP, tol=1e-8))
    finally:
        torch.set_default_dtype(torch.float32)
    (levels,), kw64 = run.calls[0]
    S64, k64, res64, conv64 = run.results[0]
    spec64 = dataclasses.replace(levels[0].spec, g=kw64["g0"].reshape(
        S64.shape)) if kw64.get("g0") is not None else levels[0].spec
    from xinvert_tpu_torch.solver import _residual_scale
    mean64 = float(torch.max(_residual_norm(spec64, S64)
                             / _residual_scale(spec64)))
    log(f"[3] invert_Stommel_mg 12x330x720 float64: {k64} cycles to "
        f"{res64:.3e} (max|r|/max|g|), mean|r|/mean|g| {mean64:.4e}, "
        f"converged {conv64}, {wall_mg64:.3f} s; against refined float32 "
        f"{wall_mg:.3f} s to {float(rr.rel_residual.max()):.4e}; ratio "
        f"f64/refined {wall_mg64 / wall_mg:.3f}")

    F_om, N2_om = atmos3d(37, 72, 288)
    iP_om = {"BCs": ["fixed", "fixed", "periodic"], "mxLoop": 5000,
             "tolerance": 1e-9, "tolType": "refined", "printInfo": False}
    with _Capture(refine, "solve_refined") as cap:
        out, wall_om = _path(
            "invert_omega 37x72x288 float32, tolType='refined', tol 1e-9",
            ("sor3d_color_sweep",), lambda: xt.invert_omega(
                F_om, DIMS_3D, mParams={"N2": N2_om}, iParams=iP_om),
            launches)
    if not np.isfinite(out.values).all():
        raise RuntimeError("invert_omega refined: non-finite answer")
    _certified("invert_omega 37x72x288 float32 refined", api.LAST_REFINE,
               cap.calls[0][0][0], 1e-9)
    return {"refined_s": wall, "rounds": r.rounds,
            "cert": float(r.rel_residual), "f64_s": wall64,
            "f64_sweeps": int(r64.iters), "floor": floor,
            "mg_s": wall_mg, "mg_rounds": rr.rounds,
            "mg_cert": float(rr.rel_residual.max()), "mg64_s": wall_mg64}


def daily_fields(days=365, ny=721, nx=1440, seed=0):
    """``days`` daily global 0.25-degree vorticity-like fields (a planetary
    wave pattern drifting with the day plus synoptic noise), built on the
    card in bulk and returned in host memory as a Field."""
    dev = torch.device("cuda", 0)
    lat = np.linspace(-90.0, 90.0, ny)
    lon = np.arange(nx) * (360.0 / nx)
    gen = torch.Generator(device=dev).manual_seed(seed)
    L = torch.deg2rad(torch.as_tensor(lat, device=dev))[:, None]
    Lo = torch.deg2rad(torch.as_tensor(lon, device=dev))[None, :]
    out = torch.empty((days, ny, nx), dtype=torch.float32)
    for d0 in range(0, days, 73):
        d = torch.arange(d0, min(d0 + 73, days), device=dev,
                         dtype=torch.float64)[:, None, None]
        ph = 2 * np.pi * d / 365.0
        v = (torch.sin(3 * Lo + ph) * torch.cos(2 * L)
             + 0.5 * torch.sin(5 * Lo - 2 * ph) * torch.cos(L) ** 2)
        v = v + 0.2 * torch.randn(v.shape, generator=gen, device=dev,
                                  dtype=torch.float64)
        out[d0:d0 + v.shape[0]] = (v * 1e-5).float().cpu()
    coords = {"time": np.arange(days, dtype=np.float64), "lat": lat,
              "lon": lon}
    return xt.Field(out.numpy(), ("time", "lat", "lon"), coords)


def _intervals(prof):
    """The device intervals (µs) of a profiled run: host-to-device and
    device-to-host copies, and everything else (kernels, device copies)."""
    h2d, d2h, compute = [], [], []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        iv = (ev.time_range.start, ev.time_range.end)
        (h2d if "HtoD" in ev.name else d2h if "DtoH" in ev.name
         else compute).append(iv)
    return h2d, d2h, compute


def _union(ivs):
    out = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap_us(a, b):
    """Length of the intersection of two sorted unions of intervals."""
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        tot += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


STREAM_DAYS = 365      # the streamed year of daily 0.25-degree fields
STREAM_CHUNK = 32


def phase3_stream(launches):
    """invert_Poisson with streamChunk 32 on 365 daily 0.25-degree global
    fields (365x721x1440 float32, 1.5 GB an array on the host): through
    the tiled kernel alone, bit-equal to the resident solve of the same
    spec (S, iters, rel_change, overflow), and chunks 1 and 365 at a cut
    mxLoop the same way; the streamed and resident times, and under
    torch.profiler the share of the host<->device copy time that overlaps
    the solves.  Returns the numbers for PERF.md."""
    from xinvert_tpu_torch import stream
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    F = daily_fields(STREAM_DAYS)
    log(f"[3] streaming: {STREAM_DAYS}x721x1440 float32 fields made in "
        f"{time.perf_counter() - t0:.1f} s ({F.values.nbytes / 1e9:.2f} GB)")
    iP = {"BCs": ["extend", "periodic"], "undef": np.nan, "mxLoop": 300,
          "tolerance": 1e-11, "printInfo": False,
          "streamChunk": STREAM_CHUNK}
    with _Capture(stream, "solve_streamed") as cap:
        out, wall_s = _path(
            f"invert_Poisson {STREAM_DAYS}x721x1440 float32, streamChunk "
            f"{STREAM_CHUNK}", TILED[False],
            lambda: xt.invert_Poisson(F, ["lat", "lon"], iParams=iP),
            launches)
    got = api.LAST_SOLVE
    if not np.isfinite(out.values).all():
        raise RuntimeError("streamed invert_Poisson: non-finite answer")
    (spec, S0, omega), kw = cap.calls[0]
    kw = dict(kw)
    chunk = kw.pop("chunk")
    kw.pop("device", None)
    log(f"[3] streamed solve: chunk {chunk}, check_every "
        f"{kw['check_every']}, iters {int(got.iters.min())}.."
        f"{int(got.iters.max())}")
    spec_d = _to(spec, dev)
    ref, wall_r = _path(
        f"solve {STREAM_DAYS}x721x1440 float32 resident, the same spec",
        TILED[False], lambda: xt.solve(spec_d, S0.to(dev), omega, **kw))

    def same(name, a, b):
        eq = {f: torch.equal(getattr(a, f), getattr(b, f).cpu())
              for f in ("S", "iters", "rel_change", "overflow")}
        log(f"[3] {name}: bit-equal to the resident solve: {eq}")
        if not all(eq.values()):
            raise RuntimeError(f"{name} differs from the resident solve")

    same(f"streamed chunk {chunk}", got, ref)
    del ref
    cut = dict(kw, max_iters=2 * kw["check_every"])
    ref = xt.solve(spec_d, S0.to(dev), omega, **cut)
    for c in (1, STREAM_DAYS):
        r, _ = _path(f"solve_streamed chunk {c}, mxLoop {cut['max_iters']}",
                     TILED[False], lambda c=c: xt.solve_streamed(
                         spec, S0, omega, chunk=c, **cut))
        same(f"streamed chunk {c} (mxLoop {cut['max_iters']})", r, ref)
    del ref, spec_d

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        xt.solve_streamed(spec, S0, omega, chunk=chunk, **kw)
        torch.cuda.synchronize()
        wall_p = time.perf_counter() - t0
    h2d, d2h, compute = _intervals(prof)
    cu, ku = _union(h2d + d2h), _union(compute)
    copy_us = sum(e - s for s, e in cu)
    busy_us = sum(e - s for s, e in ku)
    if copy_us > 0:
        ov = _overlap_us(cu, ku)
        share = ov / copy_us
        parts = []
        for label, ivs in (("host-to-device", h2d), ("device-to-host",
                                                      d2h)):
            u = _union(ivs)
            tot = sum(e - s for s, e in u)
            big = [iv for iv in ivs if iv[1] - iv[0] > 100.0]
            parts.append(
                f"{label} {len(ivs)} copies ({len(big)} over 0.1 ms) "
                f"{tot / 1e6:.4f} s, overlapped "
                f"{_overlap_us(u, ku) / max(tot, 1e-9):.3f}")
        log(f"[3] streamed solve under torch.profiler ({wall_p:.3f} s "
            f"wall): host<->device copies {copy_us / 1e6:.4f} s, kernels "
            f"{busy_us / 1e6:.4f} s, copy time overlapping kernels "
            f"{ov / 1e6:.4f} s, overlap share {share:.3f}; "
            + "; ".join(parts))
    else:
        share = None
        log("[3] streamed solve: copy overlap not measured (torch.profiler "
            "recorded no host<->device copy)")
    iP_r = {k: v for k, v in iP.items() if k != "streamChunk"}
    out_r, wall_e = _path(
        f"invert_Poisson {STREAM_DAYS}x721x1440 float32, resident (no "
        f"streamChunk)", TILED[False],
        lambda: xt.invert_Poisson(F, ["lat", "lon"], iParams=iP_r))
    gap = float(np.abs(out_r.values - out.values).max()
                / np.abs(out_r.values).max())
    log(f"[3] streaming {STREAM_DAYS}x721x1440: the streamed entry "
        f"{wall_s:.3f} s against the resident entry {wall_e:.3f} s (its "
        f"spec built on the card: max|diff|/max|S| {gap:.3e}); the solve "
        f"alone resident {wall_r:.3f} s, streamed under the profiler "
        f"{wall_p:.3f} s")
    return {"stream_s": wall_s, "resident_s": wall_r, "entry_s": wall_e,
            "overlap": share, "copy_s": copy_us / 1e6}


IMPLICIT_N = 2048      # bench.py's masked spherical Poisson
IMPLICIT_SWEEPS = 1000


def _plain_sweeps(spec, S, omega, n, with_norm=False, fac=None):
    """The plain version with the 2-D wrapper's signature, set over
    sor2d.sor2d_sweeps to run a solve's sweeps as torch ops on the card."""
    if with_norm:
        return sor2d.sor2d_sweeps_reference_norm(spec, S, omega, n, fac)
    return sor2d.sor2d_sweeps_reference(spec, S, omega, n, fac)


def phase3_implicit(launches):
    """Implicit gradients of sum(c S) in g and w on bench.py's 2048x2048
    masked spherical Poisson (the extend fold), float32 and float64, at a
    fixed sweep count: through the tiled kernel (forward and adjoint),
    bit-equal to the same gradient through the plain sweeps on the card;
    forward and forward+backward times; then the fixed-count linearity
    identity of tests/test_implicit.py in float64 at 256x256 through the
    kernel.  Returns the timings for PERF.md."""
    dev = torch.device("cuda", 0)
    n, k = IMPLICIT_N, IMPLICIT_SWEEPS
    times = {}
    for dt in (torch.float32, torch.float64):
        spec, omega = poisson_spec(n, n, 0, dt, dev)
        c = torch.as_tensor(np.random.default_rng(5).standard_normal(
            (n, n)), dtype=dt, device=dev)
        S0 = torch.zeros((n, n), dtype=dt, device=dev)
        kw = dict(omega=omega, tol=0.0, max_iters=k, check_every=k)

        def fwd():
            return xt.solve_implicit(spec, S0, **kw)

        def grads():
            g = spec.g.clone().requires_grad_()
            w = spec.w.clone().requires_grad_()
            S = xt.solve_implicit(dataclasses.replace(spec, g=g, w=w), S0,
                                  **kw)
            torch.sum(c * S).backward()
            return S.detach(), g.grad, w.grad

        name = f"solve_implicit {n}x{n} {str(dt)[6:]}, {k} sweeps"
        grads()                  # warm: the autograd engine's first use
        _, t_f = _path(f"{name}, forward", TILED[False], fwd)
        kern, t_fb = _path(f"{name}, forward+backward", TILED[False], grads,
                           launches)
        tiled = sor2d.sor2d_sweeps
        sor2d.sor2d_sweeps = _plain_sweeps
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain = grads()
            torch.cuda.synchronize()
            t_p = time.perf_counter() - t0
        finally:
            sor2d.sor2d_sweeps = tiled
        eq = [torch.equal(a, b) for a, b in zip(kern, plain)]
        gmax = float(kern[1].abs().max())
        log(f"[3] {name}: forward {t_f:.3f} s, forward+backward "
            f"{t_fb:.3f} s (x{t_fb / t_f:.2f}); through the plain sweeps "
            f"{t_p:.3f} s; S, g_bar, w_bar bit-equal to the plain path: "
            f"{eq}; max|g_bar| {gmax:.4e}")
        if not all(eq) or not gmax > 0:
            raise RuntimeError(f"{name}: the gradient through the kernel "
                               "differs from the plain version's")
        times[str(dt)[6:]] = (t_f, t_fb, t_p)

    # the linearity identity (tests/test_implicit.py), float64, 256x256,
    # its problem: (fixed, periodic) with cross terms and a mask, unit
    # spacing, through the kernel
    rng = np.random.default_rng(0)
    sh = (256, 256)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    Fdef = np.ones(sh, bool)
    Fdef[256 // 3:256 // 2, 256 // 3:256 // 2] = False
    spec = standard_2d(t(np.abs(rng.normal(1, .1, sh)) + .5),
                       t(rng.normal(0, .1, sh)),
                       t(np.abs(rng.normal(1, .1, sh)) + .5),
                       t(rng.normal(0, 1, sh)), t(Fdef), (1.1, 1.0),
                       ("fixed", "periodic"))
    omega = xt.optimal_omega(sh)
    rng = np.random.default_rng(11)
    S0 = torch.zeros((256, 256), dtype=torch.float64, device=dev)
    c = torch.as_tensor(rng.normal(0, 1, (256, 256)), device=dev)
    dg = torch.where(spec.active, torch.as_tensor(
        rng.normal(0, 1, (256, 256)), device=dev), 0.0)

    def loss(g, iters):
        s = dataclasses.replace(spec, g=g)
        return torch.sum(xt.solve_implicit(s, S0, omega=omega, tol=0.0,
                                           max_iters=iters,
                                           check_every=iters) * c)

    def identity():
        r1 = float(loss(spec.g + dg, 40) - loss(spec.g, 40))
        r2 = float(loss(spec.g + 2.0 * dg, 40) - loss(spec.g, 40))
        g = spec.g.clone().requires_grad_()
        L = loss(g, 6000)
        L.backward()
        lin = float(loss(spec.g + dg, 6000)) - L.item()
        return r1, r2, lin, float(torch.sum(g.grad * dg))

    (r1, r2, lin, an), _ = _path("linearity identity 256x256 float64",
                                 TILED[False], identity)
    e1 = abs(r2 - 2.0 * r1) / max(abs(r1), 1.0)
    e2 = abs(lin - an) / max(abs(an), 1.0)
    log(f"[3] linearity identity 256x256 float64: 40 sweeps |r2 - 2 r1| = "
        f"{e1:.3e} (limit 1e-10); converged (6000 sweeps) step response "
        f"{lin:.10e} against <g_bar, dg> {an:.10e}: {e2:.3e} (limit 1e-9)")
    if not (e1 <= 1e-10 and e2 <= 1e-9):
        raise RuntimeError("the linearity identity does not hold")
    return times


# ------------------------------------------------ phase 3, multi-device

def _profiled_raw(call, check=False):
    """:func:`_profiled` with the device's busy time summed over the
    profiler's raw device events (kernels, copies), without the parse into
    function events that ``key_averages`` runs (which takes seconds for a
    mesh solve's tens of thousands of launches and copies); with
    ``check``, also that parse's sum, logged beside it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.duration_ns()
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA) / 1e9
    if check:
        parsed = sum(ev.self_device_time_total
                     for ev in prof.key_averages()) / 1e6
        log(f"[3] device busy from the raw events {busy:.4f} s, from "
            f"key_averages {parsed:.4f} s")
    return out, wall, busy


def _mesh_pair(name, ref_kernels, mesh_kernels, ref_call, mesh_call,
               launches, same, profile_ref=True, check=False):
    """The meshless call, then the same call on a local mesh over the card,
    each with every count set to 0 just before it: the mesh run through
    ``mesh_kernels`` alone, its result held to the meshless one by
    ``same(ref, out)``; then one more call of the mesh run (and of the
    meshless one, with ``profile_ref``; else phase 3 profiled it above)
    under torch.profiler: the wall times and idle shares side by side."""
    t0 = time.perf_counter()
    ref, w_ref = _path(f"{name}, meshless", ref_kernels, ref_call)
    ref_solve = api.LAST_SOLVE
    out, w_mesh = _path(f"{name}, on the mesh", mesh_kernels, mesh_call,
                        launches)
    same((ref, ref_solve), (out, api.LAST_SOLVE))
    _, wm, bm = _profiled_raw(mesh_call, check)
    ref_idle = ("phase 3's profiled call above" if not profile_ref
                else _idle(*_profiled_raw(ref_call)[1:]))
    log(f"[3] {name}: wall meshless {w_ref:.3f} s, on the mesh {w_mesh:.3f} "
        f"s ({w_mesh / w_ref:.2f}x); profiled calls: on the mesh "
        f"{_idle(wm, bm)}; meshless {ref_idle}")
    log(f"[t] {name} took {time.perf_counter() - t0:.1f} s")
    return w_ref, w_mesh


def phase3_multi(launches):
    """The multi-device layer in float32 on local meshes whose blocks all
    run on the card (``__graft_entry__.dryrun_multichip``'s paths): each
    through the block kernels alone (no whole-grid launch), the meshless
    run's iters and torch.equal states and fields."""
    dev = torch.device("cuda", 0)
    torch.set_default_dtype(torch.float32)

    def entry_same(name):
        def same(a, b):
            _same(f"{name}, mesh vs meshless", a, b)
        return same

    # bench.py's 2048x2048 masked spherical Poisson through invert_Poisson
    big = poisson_field(2048, 2048)
    iP_big = {"BCs": ["extend", "periodic"], "undef": np.nan,
              "mxLoop": 4000, "tolerance": 1e-8, "printInfo": False}
    walls = {}
    for shape, names in (((2, 2), ("y", "x")), ((4,), ("y",))):
        mesh = local_mesh(dev, shape, names)
        name = f"invert_Poisson 2048x2048 on {dict(mesh.shape)}"
        walls[name] = _mesh_pair(
            name, TILED[False], ("sor2d_sweeps_block",),
            lambda: xt.invert_Poisson(big, dims=["lat", "lon"],
                                      iParams=iP_big),
            lambda m=mesh: xt.invert_Poisson(big, dims=["lat", "lon"],
                                             iParams=dict(iP_big, mesh=m)),
            launches, entry_same(name), profile_ref=False,
            check=len(walls) == 0)
    # the SODA 12x330x720 invert_Stommel on ('batch'=2, 'y'=2): 330 rows
    # split 168 + 162
    soda = soda_curl()
    iP_soda = {"BCs": ["extend", "periodic"], "undef": np.nan,
               "mxLoop": 5000, "tolerance": 1e-12, "optArg": 1,
               "printInfo": False}
    mesh = local_mesh(dev, (2, 2), ("batch", "y"))
    name = "invert_Stommel 12x330x720 on {'batch': 2, 'y': 2}"
    walls[name] = _mesh_pair(
        name, TILED[False], ("sor2d_sweeps_block",),
        lambda: xt.invert_Stommel(soda, dims=["lat", "lon"],
                                  mParams=STOMMEL_MP, iParams=iP_soda),
        lambda: xt.invert_Stommel(soda, dims=["lat", "lon"],
                                  mParams=STOMMEL_MP,
                                  iParams=dict(iP_soda, mesh=mesh)),
        launches, entry_same(name), profile_ref=False)
    # invert_omega 37x72x288 on ('y'=3,), invert_3DOcean 30x330x720 on 2x2
    F_om, N2_om = atmos3d(37, 72, 288)
    iP_om = {"BCs": ["fixed", "fixed", "periodic"], "mxLoop": 2000,
             "tolerance": 1e-8, "printInfo": False}
    mesh = local_mesh(dev, (3,), ("y",))
    name = "invert_omega 37x72x288 on {'y': 3}"
    walls[name] = _mesh_pair(
        name, ("sor3d_color_sweep",), ("sor3d_color_sweep_block",),
        lambda: xt.invert_omega(F_om, dims=DIMS_3D, mParams={"N2": N2_om},
                                iParams=iP_om),
        lambda: xt.invert_omega(F_om, dims=DIMS_3D, mParams={"N2": N2_om},
                                iParams=dict(iP_om, mesh=mesh)),
        launches, entry_same(name), profile_ref=False)
    F_oc, N2_oc = ocean3d(30)
    iP_oc = {"BCs": ["fixed", "extend", "periodic"], "undef": np.nan,
             "mxLoop": 2000, "tolerance": 1e-8, "printInfo": False}
    mesh = local_mesh(dev, (2, 2), ("y", "x"))
    name = "invert_3DOcean 30x330x720 on {'y': 2, 'x': 2}"
    walls[name] = _mesh_pair(
        name, ("sor3d_color_sweep",), ("sor3d_color_sweep_block",),
        lambda: xt.invert_3DOcean(F_oc, dims=DIMS_3D,
                                  mParams=dict(OCEAN_MP, N2=N2_oc),
                                  iParams=iP_oc),
        lambda: xt.invert_3DOcean(F_oc, dims=DIMS_3D,
                                  mParams=dict(OCEAN_MP, N2=N2_oc),
                                  iParams=dict(iP_oc, mesh=mesh)),
        launches, entry_same(name), profile_ref=False)

    # solve_fixed_halo_window3d on ('y'=8,): 9-row blocks, odd origins
    spec, om = omega_spec(37, 72, 288, 0, torch.float32, dev)
    S0 = _rand_state((37, 72, 288), torch.float32, dev)
    mesh = local_mesh(dev, (8,), ("y",))

    def fixed_same(a, b):
        ok = torch.equal(a[0], b[0])
        log(f"[3] solve_fixed_halo_window3d 37x72x288 on {{'y': 8}}, 9-row "
            f"blocks, 40 sweeps: torch.equal to solve_fixed: {ok}")
        if not ok:
            raise RuntimeError("solve_fixed_halo_window3d differs from "
                               "solve_fixed")
    walls["solve_fixed_halo_window3d"] = _mesh_pair(
        "solve_fixed_halo_window3d 37x72x288 on {'y': 8}",
        ("sor3d_color_sweep",), ("sor3d_color_sweep_block",),
        lambda: xt.solve_fixed(spec, S0, om, 40),
        lambda: xt.parallel.solve_fixed_halo_window3d(spec, S0, om, 40,
                                                      mesh=mesh),
        launches, fixed_same)

    # solve_refined on the 2048x2048 sphere: the rounds and the certificate
    # of the meshless run
    n = REFINE_N
    spec, om = sphere_spec(n, torch.float32, dev)
    S0 = torch.zeros((n, n), dtype=torch.float32, device=dev)
    mesh = local_mesh(dev, (2, 2), ("y", "x"))

    def refined_same(a, b):
        ra, rb = a[0], b[0]
        ok = (ra.rounds == rb.rounds
              and torch.equal(ra.rel_residual, rb.rel_residual)
              and torch.equal(ra.S_hi, rb.S_hi)
              and torch.equal(ra.S_lo, rb.S_lo))
        log(f"[3] solve_refined {n}x{n} on {{'y': 2, 'x': 2}}: rounds "
            f"{rb.rounds} (meshless {ra.rounds}), certificate "
            f"{float(rb.rel_residual):.4e} (meshless "
            f"{float(ra.rel_residual):.4e}); rounds, certificate and pair "
            f"equal: {ok}")
        if not ok:
            raise RuntimeError("solve_refined on the mesh differs")
    walls["solve_refined"] = _mesh_pair(
        f"solve_refined {n}x{n} full sphere, tol 1e-8, on {{'y': 2, 'x': 2}}",
        TILED[False], ("sor2d_sweeps_block",),
        lambda: xt.solve_refined(spec, S0, omega=om, tol=1e-8),
        lambda: xt.solve_refined(spec, S0, omega=om, tol=1e-8, mesh=mesh),
        launches, refined_same)

    # scaling_bench on 1, 2 and 4 blocks of the card (weak scaling, 1024^2
    # a block): what the decomposition costs on one card
    t0 = time.perf_counter()
    rows = xt.parallel.scaling_bench(device_counts=[1, 2, 4], base_ny=1024,
                                     base_nx=1024, n_iters=200,
                                     devices=[dev] * 4,
                                     dtype=torch.float32)
    for line in xt.parallel.format_scaling_table(rows).splitlines():
        log(f"[3] scaling_bench: {line}")
    log(f"[t] scaling_bench took {time.perf_counter() - t0:.1f} s")
    return walls


def _whole_on_mesh(name, call, mesh):
    """``call(iParams_extra)`` without and then with ``{"mesh": mesh}``,
    each with every count set to 0 just before it: the mesh run solves
    whole, so it launches what the meshless run launches, no plain call,
    and gives its iters and an equal state and field."""
    runs = []
    for extra in ({}, {"mesh": mesh}):
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call(extra)
        torch.cuda.synchronize()
        runs.append((out, api.LAST_SOLVE, time.perf_counter() - t0,
                     _counts()))
    (fa, ra, wa, (ca, pa)), (fb, rb, wb, (cb, pb)) = runs
    ran = ", ".join(f"{k} {v}" for k, v in cb.items() if v) or "none"
    as_t = (lambda x: x if torch.is_tensor(x) else torch.as_tensor(x))
    same = (ca == cb and pa == pb == 0
            and torch.equal(as_t(ra.iters), as_t(rb.iters))
            and torch.equal(as_t(ra.S), as_t(rb.S))
            and np.array_equal(fa.values, fb.values, equal_nan=True))
    log(f"[3] {name} on {dict(mesh.shape)} against meshless: iters "
        f"{as_t(rb.iters).reshape(-1).tolist()} and "
        f"{as_t(ra.iters).reshape(-1).tolist()}, walls {wb:.3f} s and "
        f"{wa:.3f} s; launches on the mesh: {ran} (the meshless run's: "
        f"{ca == cb}); states and fields equal: {same}")
    if not same:
        raise RuntimeError(f"{name} on a mesh differs from the meshless run")


def phase3_whole_on_mesh():
    """scheme="lexico" and an ``_mg`` entry with ``iParams["mesh"]`` (a
    ('y'=2,) local mesh of the card): both solve whole, as the JAX package
    does, equal to their meshless runs; the NB03 forcing (72x144), float64,
    lexico cut to NB03_SWEEPS sweeps as in phase 3's lexico lines."""
    torch.set_default_dtype(torch.float64)
    dev = torch.device("cuda", 0)
    mesh = local_mesh(dev, (2,), ("y",))
    force, hbc = _nb03_fields()
    iP3 = {"BCs": ["fixed", "periodic"], "mxLoop": NB03_SWEEPS,
           "tolerance": 0.0, "scheme": "lexico", "printInfo": False}
    _whole_on_mesh(
        f"NB03 invert_Poisson 72x144 lexico float64, {NB03_SWEEPS} sweeps",
        lambda extra: xt.invert_Poisson(force, dims=["lat", "lon"], icbc=hbc,
                                        iParams=dict(iP3, **extra)), mesh)
    iPm = {"BCs": ["fixed", "periodic"], "printInfo": False}
    _whole_on_mesh(
        "NB03 invert_Poisson_mg 72x144 float64 (fixed, periodic), tol 1e-6",
        lambda extra: xt.invert_Poisson_mg(force, dims=["lat", "lon"],
                                           icbc=hbc, tol=1e-6,
                                           iParams=dict(iPm, **extra)), mesh)


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


def _block_bound(bspec, P, written):
    """(bound_ms, bound_by, nbytes) of one block launch: the padded state
    and the padded planes read once, ``written`` cells written, over the
    HBM rate; against its float32 operations (2K+5 a cell update, over the
    owned cells for k sweeps in 2-D, over the buffer's cells in 3-D:
    ``written`` x its sweeps), over the peak rate."""
    itemsize = P.element_size()
    K = len(bspec.offsets)
    planes = (bspec.w.numel() + bspec.w0.numel() + bspec.g.numel()
              + bspec.relax.numel())
    nbytes = (P.numel() + planes + written[0]) * itemsize
    ops = (2 * K + 5) * written[0] * written[1]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def _plain_ms(plain):
    try:
        return _device_ms(plain, 10)
    except RuntimeError:
        return _time_ms(plain, 3, 10)


def phase4_blocks(card, dev):
    """Each block kernel's device time per launch at the main path's
    shapes (CUDA events around 50 bare launches behind a device spin),
    beside its plain version's (10 calls) and its bound: 2-D block (1, 1)
    of bench.py's 2048x2048 on a 2x2 mesh, k 4; 3-D block (1, 1) of the
    30x330x720 ocean on a 2x2 mesh, the folded red and the black launch
    (their mean is the kernels line's time) of the block sweep kernel in
    turns against its first version (first, block sweep, block sweep,
    first), then the block sweep at several z chunks."""
    per = {}
    n = 2048
    spec, om = poisson_spec(n, n, 0, torch.float32, dev)
    S = xt.solve_fixed(spec, torch.zeros((n, n), device=dev), om, 50)
    origin, owned, g = (1024, 1024), (1024, 1024), (9, 8)
    P = phalo.padded_block(S, origin, owned, g)
    bspec = phalo.padded_block_spec(spec, origin, owned, g)
    sweep = sor2d.make_block_sweeper(bspec, P, om, origin, (n, n), g, 4)
    A, Bf = P.clone(), torch.empty_like(P)
    t_k = _device_ms(lambda: sweep(A, Bf, 4), 50)
    t_p = _plain_ms(lambda: sor2d.sor2d_sweeps_block_reference(
        bspec, P, om, 4, origin, (n, n), g))
    bound = _block_bound(bspec, P, (owned[0] * owned[1], 4))
    t_w = _device_ms(lambda: xt.solve_fixed(spec, S, om, 4), 50)
    per["sor2d_sweeps_block"] = (t_k, t_p) + bound[:2]
    log(f"[4] {card} | sor2d_sweeps_block {n}x{n} block (1, 1) of a 2x2 "
        f"mesh, padded {tuple(P.shape)}, 4 sweeps a launch, float32: kernel "
        f"{t_k:.5f} ms device time per launch (50 launches), plain version "
        f"{t_p:.4f} ms; bound {bound[0]:.5f} ms ({bound[1]}, {bound[2]} B "
        f"at 3.35 TB/s); the whole grid's 4 sweeps (solve_fixed) "
        f"{t_w:.5f} ms, a quarter of it {t_w / 4:.5f} ms")
    del spec, S, P, bspec, sweep, A, Bf
    spec, om = ocean_spec(30, torch.float32, dev)
    S = xt.solve_fixed(spec, torch.zeros((30, 330, 720), device=dev), om, 50)
    origin, owned, g = (168, 384), (162, 336), (9, 8)
    P = phalo.padded_block(S, origin, owned, g)
    bspec = phalo.padded_block_spec(spec, origin, owned, g)
    rel = sor3d.relax_plane(bspec, om)
    lay = sor3d._block_layout(bspec, P, rel, origin, (330, 720), g)
    A, Bf = P.clone(), torch.empty_like(P)
    launch = {"block sweep": sor3d._launch_block,
              "first version": sor3d._launch_block_first}

    def red_black(label):
        return (_device_ms(lambda: launch[label](bspec, lay, rel, A, Bf, 0,
                                                 extend=True), 50),
                _device_ms(lambda: launch[label](bspec, lay, rel, A, Bf, 1),
                           50))
    times = {}
    for label in ("first version", "block sweep", "block sweep",
                  "first version"):
        times.setdefault(label, []).append(red_black(label))
    t_p = _plain_ms(lambda: sor3d.sor3d_color_sweep_block_reference(
        bspec, P, rel, 1, origin, (330, 720), g))
    bound = _block_bound(bspec, P, (P.numel(), 1))
    for label, kname in (("block sweep", "sor3d_color_sweep_block"),
                         ("first version", "sor3d_color_sweep_block_first")):
        red = float(np.mean([t[0] for t in times[label]]))
        black = float(np.mean([t[1] for t in times[label]]))
        per[kname] = ((red + black) / 2, t_p) + bound[:2]
        log(f"[4] {card} | B5s {label} ({kname}) ocean 30x330x720 block "
            f"(1, 1) of a 2x2 mesh, padded {tuple(P.shape)}, float32, in "
            f"turns (first, block sweep, block sweep, first): red (extend "
            f"folded in) " + " / ".join(f"{t[0]:.5f}" for t in times[label])
            + " ms, black " + " / ".join(f"{t[1]:.5f}" for t in times[label])
            + f" ms device time per launch (50 launches); mean "
            f"{(red + black) / 2:.5f} ms, red/black {red / black:.3f}; "
            f"bound {bound[0]:.5f} ms ({bound[1]}, {bound[2]} B at 3.35 "
            f"TB/s), {100 * bound[0] / ((red + black) / 2):.1f}% of it; "
            f"plain version {t_p:.4f} ms")
    # what the flag costs: the flagged launch with no edge tiles (a wrong
    # field, timed only) and the red launch unflagged, beside black
    no_edge = dict(lay, n_edge=0)
    flag = [_device_ms(fn, 50) for fn in (
        lambda: sor3d._launch_block(bspec, no_edge, rel, A, Bf, 0,
                                    extend=True),
        lambda: sor3d._launch_block(bspec, lay, rel, A, Bf, 0),
        lambda: sor3d._launch_block(bspec, lay, rel, A, Bf, 1))]
    log(f"[4] {card} | B5s block sweep, the flag's cost: red flagged with "
        f"no edge tiles {flag[0]:.5f} ms, red unflagged {flag[1]:.5f} ms, "
        f"black {flag[2]:.5f} ms a launch")
    # the block sweep's z chunk: levels a CTA walks (the plan's choice
    # first)
    scan = []
    for zc in (0, 30, 15, 10, 6, 4, 2):
        lay_z = dict(lay, zc=zc)
        r, b = (_device_ms(lambda c=c: sor3d._launch_block(
            bspec, lay_z, rel, A, Bf, c, extend=c == 0), 50) for c in (0, 1))
        scan.append(f"{zc or 'the launcher'} {r:.5f} / {b:.5f}")
    log(f"[4] {card} | B5s block sweep, levels a CTA walks: red / black ms "
        f"a launch: " + "; ".join(scan))
    return per


def phase4_parent(card, dev, parent_src):
    """The whole-grid ``sor3d_color_sweep`` of this tree against the one
    built from ``parent_src`` (another tree's csrc/sor3d.cu, same flags),
    in turns (parent, this tree, this tree, parent), twice: the folded red
    and the black launch at 30x330x720 float32, device time per launch."""
    import ctypes
    import tempfile
    nvcc = _build._nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, "libsor3d_parent.so")
        subprocess.run([nvcc, *_build.NVCC_FLAGS, "-o", so, parent_src],
                       check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(so)
    args, res = _build._SIGNATURES["sor3d"]["sor3d_color_sweep_f32"]
    fn = lib.sor3d_color_sweep_f32
    fn.argtypes, fn.restype = args, res
    spec, om = ocean_spec(30, torch.float32, dev)
    S = xt.solve_fixed(spec, torch.zeros((30, 330, 720), device=dev), om, 50)
    fam = sor3d._FAMILY
    rel = sor3d.relax_plane(spec, om)
    lays = {"this tree": fam.layout(spec, S, rel)}
    lays["parent"] = dict(lays["this tree"], sweep_fn=fn)
    A = S.reshape((1,) + tuple(S.shape)).clone()
    A2 = torch.empty_like(A)
    times = {}
    for label in ("parent", "this tree", "this tree", "parent") * 2:
        lay = lays[label]
        times.setdefault(label, []).append(tuple(
            _device_ms(lambda c=c: fam.launch_color_sweep(
                spec, lay, rel, A, A2, c, extend=c == 0), 50)
            for c in (0, 1)))
    mean = {k: [float(np.mean([t[c] for t in v])) for c in (0, 1)]
            for k, v in times.items()}
    log(f"[4] {card} | sor3d_color_sweep 30x330x720 float32, this tree "
        f"against the parent's build, in turns (parent, this, this, parent, "
        f"twice), device time per launch (50 launches): " + "; ".join(
            f"{k}: red (folded) " + " / ".join(f"{t[0]:.5f}" for t in v)
            + ", black " + " / ".join(f"{t[1]:.5f}" for t in v)
            for k, v in times.items())
        + f"; this tree / parent: red "
        f"{mean['this tree'][0] / mean['parent'][0]:.4f}, black "
        f"{mean['this tree'][1] / mean['parent'][1]:.4f}")


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


def main_blocks():
    """--blocks: phases 0 and 1, phase 2's 3-D block checks and phase 4's
    block timings alone (and --parent-sor3d's turns): B5s's loop."""
    card = phase0()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase1()
    errs = {name: 0.0 for name in KERNELS}
    for case in block_cases(dev)[1]:
        _check_block3d(*case, errs)
    torch.set_default_dtype(torch.float32)
    phase4_blocks(card, dev)
    if PARENT_SOR3D:
        phase4_parent(card, dev, PARENT_SOR3D)
    log("[5] the block phases passed (no result line: --blocks)")


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
    phase3_traj(launches)
    stamp("phase 3 (trajectories)")
    phase3_lexico()
    stamp("phase 3 (lexico)")
    phase3_1d()
    phase3_calflow(sor)
    stamp("phase 3 (1-D, cal_flow)")
    torch.set_default_dtype(torch.float32)
    phase3_eft(dev)
    phase3_refined(launches)
    stamp("phase 3 (EFT, refinement)")
    phase3_stream(launches)
    stamp("phase 3 (streaming)")
    phase3_implicit(launches)
    stamp("phase 3 (implicit gradients)")
    phase3_multi(launches)
    phase3_whole_on_mesh()
    stamp("phase 3 (multi-device)")
    torch.set_default_dtype(torch.float32)
    per = phase4(card, dev)
    per.update(phase4_blocks(card, dev))
    if PARENT_SOR3D:
        phase4_parent(card, dev, PARENT_SOR3D)
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
    # --parent-sor3d PATH: also time the whole-grid 3-D color sweep against
    # another tree's csrc/sor3d.cu in turns (phase 4); --blocks: only the
    # 3-D block kernels' phases
    args = sys.argv[1:]
    blocks = "--blocks" in args
    if blocks:
        args.remove("--blocks")
    if len(args) == 2 and args[0] == "--parent-sor3d":
        PARENT_SOR3D = os.path.abspath(args[1])
    elif args:
        raise SystemExit("usage: chip_smoke.py [--blocks] "
                         "[--parent-sor3d PATH]")
    if blocks:
        main_blocks()
    else:
        main()
