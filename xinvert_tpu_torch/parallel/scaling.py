# -*- coding: utf-8 -*-
"""Multi-process entry and the scaling harness.

Counterpart of ``xinvert_tpu/parallel/scaling.py``:

- :func:`initialize_distributed` starts ``torch.distributed`` (the
  ``jax.distributed.initialize`` of the JAX package);
- :func:`make_hybrid_mesh` lays the batch axis over the slowest links;
- :func:`scaling_bench` times fixed-count sharded solves of the masked
  spherical Poisson (or a 3-D omega-class volume) against the block count,
  with the JAX package's row schema; :func:`format_scaling_table` prints
  them.

``python -m xinvert_tpu_torch.parallel`` prints the table for the
visible CUDA devices (``parallel/__main__.py``).

A local mesh whose devices repeat one card runs its blocks one after
another on that card: its rows measure what the decomposition costs
there (the ghost copies, the smaller launches), not scaling.
"""
from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .mesh import Mesh, make_grid_mesh

__all__ = ["initialize_distributed", "make_hybrid_mesh", "scaling_bench",
           "format_scaling_table"]


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> bool:
    """Start ``torch.distributed`` (gloo for CPU tensors, NCCL for CUDA
    tensors where the machine has CUDA).  Returns True when more than one
    process is up after the call.

    ``coordinator_address`` is an init method (``tcp://host:port``); left
    None, ``env://`` reads MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK
    from the environment.  Safe to call again, and in a single process
    with nothing set (then nothing starts)."""
    import torch.distributed as dist
    if not dist.is_available():
        return False
    if not dist.is_initialized():
        if coordinator_address is None and "MASTER_ADDR" not in os.environ:
            return False
        backend = ("cpu:gloo,cuda:nccl" if torch.cuda.is_available()
                   else "gloo")
        kw = {}
        if num_processes is not None:
            kw["world_size"] = int(num_processes)
        if process_id is not None:
            kw["rank"] = int(process_id)
        dist.init_process_group(backend,
                                init_method=coordinator_address or "env://",
                                **kw)
    return dist.get_world_size() > 1


def make_hybrid_mesh(batch: int = 1, devices: Optional[Sequence] = None):
    """A ('batch', 'y', 'x') mesh whose batch axis spans the slowest links.

    A solve exchanges ghost rings and the norm's partials only between the
    blocks of one batch group; batch groups never talk.  The ranks of a
    host are consecutive, and :func:`make_grid_mesh` gives each batch
    index a consecutive range of them, so with ``batch`` a multiple of the
    host count each group stays on one host.  On one host it is the flat
    near-square mesh."""
    return make_grid_mesh(batch=batch, devices=devices)


def _poisson_problem(ny, nx, dtype, device):
    """The masked spherical Poisson problem of the scaling rows: a
    synthetic vorticity on a (ny, nx) lat-lon grid, BCs (extend, periodic),
    a continent-like block masked (the JAX package's synthetic problem)."""
    from ..grid import Grid
    from ..models.params import default_mParams
    from ..models.problems import build_poisson
    lat = np.linspace(-88.75, 88.75, ny)
    lon = np.linspace(0.0, 360.0 - 360.0 / nx, nx)
    grid = Grid.make(("lat", "lon"), (lat, lon), "lat-lon",
                     bcs=("extend", "periodic"))
    rng = np.random.default_rng(0)
    vor = (np.sin(3 * np.deg2rad(lon))[None, :]
           * np.cos(2 * np.deg2rad(lat))[:, None]
           + 0.1 * rng.standard_normal((ny, nx)))
    Fdef = np.ones((ny, nx), bool)
    Fdef[ny // 3:ny // 2, nx // 4:nx // 2] = False
    spec = build_poisson(torch.as_tensor(vor, dtype=dtype, device=device),
                         torch.as_tensor(Fdef, device=device), grid,
                         default_mParams)
    return spec, torch.zeros((ny, nx), dtype=dtype, device=device), grid


def _omega_problem3(nz, ny, nx, dtype, device):
    """A synthetic omega-class 3-D problem for the 3-D scaling rows."""
    from ..stencil import standard_3d
    rng = np.random.default_rng(0)
    sh = (nz, ny, nx)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)
    A = t((np.abs(rng.normal(1.0, 0.1, sh)) + 0.5) * 2e-4)
    B = t(np.abs(rng.normal(1.0, 0.1, sh)) + 0.5)
    F = t(rng.normal(0.0, 1e-9, sh))
    spec = standard_3d(A, B, B, F, torch.ones(sh, dtype=torch.bool,
                                              device=device),
                       (5e3, 1.1e5, 1.0e5), ("fixed", "extend", "periodic"))
    return spec, torch.zeros(sh, dtype=dtype, device=device)


def _sync(devices):
    """Wait for every CUDA device of ``devices``: a mesh's blocks may run on
    several cards, and the call has ended only when each of them has."""
    for d in {torch.device(d) for d in devices}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _bench_once(spec, S0, mesh, omega, n_iters, reps=3, executor="gspmd",
                k_sweeps=1):
    """Median wall time of a fixed-count sharded solve (host clock around
    calls that end in a synchronise of every device of the mesh), after
    one untimed call."""
    from . import halo, halo_window, halo_window3d, mesh as mesh_mod
    if executor == "gspmd":
        def fn(s):
            return mesh_mod.solve_fixed_sharded(spec, s, n_iters, mesh=mesh,
                                                omega=omega)
    elif executor in ("halo_window", "halo_window_xy"):
        def fn(s):
            return halo_window.solve_fixed_halo_window(spec, s, omega,
                                                       n_iters, mesh=mesh)
    elif executor == "halo_window3d":
        def fn(s):
            return halo_window3d.solve_fixed_halo_window3d(
                spec, s, omega, n_iters, mesh=mesh)
    else:
        def fn(s):
            return halo.solve_fixed_halo(spec, s, omega, n_iters, mesh=mesh,
                                         k_sweeps=k_sweeps)
    devices = [S0.device] + ([] if mesh.distributed
                             else list(mesh.devices.reshape(-1)))
    fn(S0)
    _sync(devices)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(S0)
        _sync(devices)
        times.append(time.perf_counter() - t0)
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError("non-finite state in the scaling run")
    return float(np.median(times))


def scaling_bench(device_counts: Optional[Sequence[int]] = None,
                  base_ny: int = 256, base_nx: int = 256,
                  n_iters: int = 50, mode: str = "weak", dtype=None,
                  executor: str = "gspmd", k_sweeps: int = 1,
                  devices: Optional[Sequence] = None):
    """Throughput against the block count for the masked spherical
    Poisson (``executor='halo_window3d'``: an omega-class 24-level volume).

    ``mode='weak'`` grows the grid with the blocks (fixed work a block);
    ``'strong'`` keeps (base_ny, base_nx).  ``devices`` (a local mesh's
    device list, repeats allowed; default the visible CUDA devices) gives
    the first c entries to the c-block row.  ``executor``: 'gspmd' and
    'halo_window_xy' a near-square ('y', 'x') mesh, 'halo_window' and
    'halo_window3d' a row mesh, 'halo' :func:`solve_fixed_halo` with
    ``k_sweeps``.  Rows: ``{'devices', 'mesh', 'grid', 'pts_per_s',
    'pts_per_s_per_device', 'efficiency', 'emulated'}``; ``emulated`` is
    True when the row's blocks share a device (see the module's note)."""
    if dtype is None:
        dtype = torch.get_default_dtype()
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise RuntimeError("scaling_bench: no CUDA device; pass devices=")
    if device_counts is None:
        device_counts = [c for c in (1, 2, 4, 8, 16, 32)
                         if c <= len(devices)]
    rows, base_rate = [], None
    for c in device_counts:
        devs = devices[:c]
        if executor in ("halo_window", "halo_window3d"):
            arr = np.empty(c, dtype=object)
            arr[:] = devs
            mesh = Mesh(arr, ("y",))
        else:
            mesh = make_grid_mesh(devices=devs)
        my_, mx_ = mesh.shape.get("y", 1), mesh.shape.get("x", 1)
        ny, nx = ((base_ny * my_, base_nx * mx_) if mode == "weak"
                  else (base_ny, base_nx))
        if executor == "halo_window3d":
            nz = 24
            spec, S0 = _omega_problem3(nz, ny, nx, dtype, devs[0])
            dt = _bench_once(spec, S0, mesh, 1.2, n_iters,
                             executor=executor)
            pts0 = nz * ny * nx
        else:
            spec, S0, grid = _poisson_problem(ny, nx, dtype, devs[0])
            dt = _bench_once(spec, S0, mesh, grid.omega_opt, n_iters,
                             executor=executor, k_sweeps=k_sweeps)
            pts0 = ny * nx
        pts = pts0 * n_iters / dt
        per_dev = pts / c
        if base_rate is None:
            base_rate = per_dev
        rows.append({"devices": c, "mesh": f"{my_}x{mx_}",
                     "grid": f"{ny}x{nx}", "pts_per_s": pts,
                     "pts_per_s_per_device": per_dev,
                     "efficiency": per_dev / base_rate,
                     "emulated": len(set(devs)) < c})
    return rows


def format_scaling_table(rows) -> str:
    """The rows as a table; a row whose blocks share a device is marked,
    and a note says its numbers are emulation overhead, not scaling."""
    head = (f"{'devices':>8} {'mesh':>6} {'grid':>12} "
            f"{'pt-sweeps/s':>12} {'per-device':>12} {'eff':>6}")
    lines = [head]
    for r in rows:
        lines.append(f"{r['devices']:>8} {r['mesh']:>6} {r['grid']:>12} "
                     f"{r['pts_per_s']:>12.3e} "
                     f"{r['pts_per_s_per_device']:>12.3e} "
                     f"{r['efficiency']:>6.2f}"
                     + (" *" if r.get("emulated") else ""))
    if any(r.get("emulated") for r in rows):
        lines.append("* blocks share one device and run one after another: "
                     "emulation overhead, not scaling")
    return "\n".join(lines)

