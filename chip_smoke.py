#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Smoke run of the PyTorch / CUDA port (xinvert_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

It imports only torch, numpy and xinvert_tpu_torch, builds its inputs from a
seed, and runs these phases, each printing its lines:

  0  environment: CUDA must be available; the card's name and power limit
     (nvidia-smi), torch and CUDA versions;
  1  build: nvcc compiles xinvert_tpu_torch/csrc/sor2d.cu (first use);
  2  each kernel against its plain PyTorch version on the card: bit-equal
     (torch.equal) in float32 and float64 after 20 sweeps on several grids,
     and the fused |S| sums against sum|S| (rtol 1e-5 / 1e-12);
  3  the main path: invert_Poisson on the masked spherical problem in
     float32 at 2048x2048 and at a batched 8x73x144, with the launch counts
     showing it ran through the kernels, and the 8x73x144 answer held
     against a float64 CPU run of the same call;
  4  timing at 2048x2048 float32: solve_fixed, 500 sweeps per call, median
     of 5 chained calls timed with CUDA events, for the kernels and for the
     plain version, beside a device-to-device copy of the same byte count;
     the kernels' float64 rate; each kernel's device time per launch
     (torch.profiler) beside its plain version's.

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.  Any failed phase raises, and the
script exits non-zero without printing that line.
"""
import json
import subprocess
import time

import numpy as np
import torch

import xinvert_tpu_torch as xt
from xinvert_tpu_torch.grid import Grid
from xinvert_tpu_torch.models import api, problems
from xinvert_tpu_torch.models.params import default_mParams
from xinvert_tpu_torch.ops import _build, sor2d
from xinvert_tpu_torch.stencil import StencilSpec, _interior_mask, standard_2d

SOURCE = "xinvert_tpu_torch/csrc/sor2d.cu"
BIH_OFFSETS = ((2, 0), (1, 0), (-1, 0), (-2, 0), (0, 2), (0, 1), (0, -1),
               (0, -2), (2, 2), (2, -2), (-2, 2), (-2, -2), (1, 1), (-1, 1),
               (1, -1), (-1, -1))


def log(msg):
    print(msg, flush=True)


# ----------------------------------------------------------------- inputs

def poisson_field(ny, nx, batch=0, seed=0):
    """The masked spherical Poisson forcing: sin(3 lon) cos(2 lat) + 0.1
    noise on a lat-lon grid, NaN over a continent-shaped block."""
    lat = np.linspace(-88.75, 88.75, ny)
    lon = np.linspace(0.0, 360.0 - 360.0 / nx, nx)
    rng = np.random.default_rng(seed)
    llat, llon = np.deg2rad(lat)[:, None], np.deg2rad(lon)[None, :]
    shape = (batch, ny, nx) if batch else (ny, nx)
    vor = np.sin(3 * llon) * np.cos(2 * llat) + 0.1 * rng.standard_normal(shape)
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


def random_spec(ny, nx, offsets, bcs, bih, batch, per_slice, dtype, device,
                seed=2):
    """A diagonally dominant spec from random planes (from_arrays)."""
    rng = np.random.default_rng(seed)
    shape = (batch, ny, nx) if (batch and per_slice) else (ny, nx)
    active = np.broadcast_to(_interior_mask((ny, nx), bcs, bih), shape).copy()
    active &= rng.random(shape) > 0.05
    w = rng.uniform(0.05, 0.25, (len(offsets),) + shape) * active
    w0 = np.where(active, -1.05 * w.sum(0), 0.0)
    relax = np.where(active, 1.0 / np.where(active, -w0, 1.0), 0.0)
    g = rng.normal(0.0, 1.0, ((batch,) if batch else ()) + (ny, nx)) * active
    spec = StencilSpec.from_arrays(w, w0, g, relax, active, offsets, bcs, bih,
                                   False, device=device, dtype=dtype)
    return spec, 1.2


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
        f"count {torch.cuda.device_count()}")
    return card


# ---------------------------------------------------------------- phase 1

def phase1():
    t0 = time.perf_counter()
    _build.load()
    log(f"[1] kernels built and loaded in {time.perf_counter() - t0:.3f} s "
        f"(nvcc {_build.BUILD_SECONDS:.3f} s, flags "
        f"{' '.join(_build.NVCC_FLAGS)})")


# ---------------------------------------------------------------- phase 2

def _max_err(a, b):
    return float((a.double() - b.double()).abs().max())


def phase2(dev):
    errs = {"sor2d_extend_rows": 0.0, "sor2d_color_sweep": 0.0}
    cases = [
        ("gallery 3x73x144 (extend, periodic) masked",
         lambda dt: poisson_spec(73, 144, 3, dt, dev)),
        ("main path 8x73x144 (extend, periodic) masked",
         lambda dt: poisson_spec(73, 144, 8, dt, dev, seed=4)),
        ("201x301 (fixed, fixed) cross terms",
         lambda dt: cross_spec(201, 301, ("fixed", "fixed"), dt, dev)),
        ("main path 2048x2048 (extend, periodic) masked",
         lambda dt: poisson_spec(2048, 2048, 0, dt, dev)),
        ("bih 16-offset 29x31 (extend, fixed)",
         lambda dt: random_spec(29, 31, BIH_OFFSETS, ("extend", "fixed"),
                                True, 0, False, dt, dev)),
        ("bih 16-offset 2x33x37 (extend, periodic) per-slice planes",
         lambda dt: random_spec(33, 37, BIH_OFFSETS, ("extend", "periodic"),
                                True, 2, True, dt, dev, seed=3)),
        ("odd 2x37x53 (extend, fixed) per-slice planes",
         lambda dt: random_spec(37, 53, ((1, 0), (-1, 0), (0, 1), (0, -1)),
                                ("extend", "fixed"), False, 2, True, dt, dev,
                                seed=5)),
        ("odd 5x7 (extend, fixed) cross", lambda dt: random_spec(
            5, 7, ((1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (-1, -1)),
            ("extend", "fixed"), False, 0, False, dt, dev, seed=6)),
    ]
    for name, make in cases:
        for dt, rtol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
            spec, omega = make(dt)
            gen = torch.Generator(device="cpu").manual_seed(7)
            S0 = (torch.randn(spec.g.shape, generator=gen,
                              dtype=torch.float64)
                  * 1e-3).to(dt).to(dev)
            # each kernel alone
            ext_k = sor2d.sor2d_extend(spec, S0)
            ext_p = sor2d.sor2d_extend_reference(spec, S0)
            ok = torch.equal(ext_k, ext_p)
            errs["sor2d_extend_rows"] = max(errs["sor2d_extend_rows"],
                                            _max_err(ext_k, ext_p))
            rel = sor2d.relax_plane(spec, omega)
            for color in (0, 1):
                cs_k = sor2d.sor2d_color_sweep(spec, ext_k, rel, color)
                cs_p = sor2d.sor2d_color_sweep_reference(spec, ext_p, rel,
                                                         color)
                ok &= torch.equal(cs_k, cs_p)
                errs["sor2d_color_sweep"] = max(errs["sor2d_color_sweep"],
                                                _max_err(cs_k, cs_p))
            # 20 full sweeps, and the fused |S| sums
            out_k = sor2d.sor2d_sweeps(spec, S0, omega, 20)
            out_p = sor2d.sor2d_sweeps_reference(spec, S0, omega, 20)
            out_n, sumabs = sor2d.sor2d_sweeps(spec, S0, omega, 20,
                                               with_norm=True)
            torch.cuda.synchronize()
            err = _max_err(out_k, out_p)
            for k in errs:
                errs[k] = max(errs[k], err)
            ok &= torch.equal(out_k, out_p) and torch.equal(out_n, out_k)
            ok &= bool(torch.isfinite(out_p).all())
            ref = out_p.double().abs().sum(dim=(-2, -1))
            norm_err = float(((sumabs.double() - ref).abs() / ref).max())
            log(f"[2] {name} {str(dt)[6:]}: bit-equal={ok} "
                f"max|kernel-plain|={err:.3e} sumabs rel err={norm_err:.3e} "
                f"(tol {rtol:g})")
            if not ok or not norm_err <= rtol:
                raise RuntimeError(f"kernel disagrees with its plain version "
                                   f"on {name} {dt}")
    return errs


# ---------------------------------------------------------------- phase 3

def _counts():
    return (sor2d.EXTEND_LAUNCHES, sor2d.LAUNCHES, sor2d.PLAIN_CALLS)


def _check_field(sf, field, name):
    land = np.isnan(field.values)
    out = sf.values
    if not (np.array_equal(np.isnan(out), land)
            and np.isfinite(out[~land]).all()):
        raise RuntimeError(f"{name}: NaN not exactly on the mask, or "
                           "non-finite values over the ocean")
    if bool(api.LAST_SOLVE.overflow.any()):
        raise RuntimeError(f"{name}: the solve overflowed")
    if not np.abs(out[~land]).max() > 0:
        raise RuntimeError(f"{name}: the solution is zero")


def phase3():
    iP_big = {"BCs": ["extend", "periodic"], "undef": np.nan,
              "mxLoop": 4000, "tolerance": 1e-8, "printInfo": False}
    iP_gal = {"BCs": ["extend", "periodic"], "undef": np.nan,
              "mxLoop": 5000, "tolerance": 1e-6, "printInfo": False}
    big = poisson_field(2048, 2048)
    gal = poisson_field(73, 144, batch=8, seed=1)
    torch.set_default_dtype(torch.float32)
    torch.set_default_device("cuda")
    results = {}
    # every count starts at 0 just before the main path runs
    sor2d.EXTEND_LAUNCHES = sor2d.LAUNCHES = sor2d.PLAIN_CALLS = 0
    for name, field, iP in (("2048x2048", big, iP_big),
                            ("8x73x144", gal, iP_gal)):
        before = _counts()
        t0 = time.perf_counter()
        sf = xt.invert_Poisson(field, dims=["lat", "lon"], iParams=iP)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = _counts()
        res = api.LAST_SOLVE
        results[name] = sf
        log(f"[3] invert_Poisson {name} float32: iters "
            f"{res.iters.cpu().tolist()} rel_change "
            f"{res.rel_change.cpu().tolist()} overflow "
            f"{res.overflow.cpu().tolist()} wall {wall:.3f} s; launches "
            f"extend {after[0] - before[0]} color_sweep "
            f"{after[1] - before[1]}, plain calls {after[2] - before[2]}")
        if not (after[0] > before[0] and after[1] > before[1]
                and after[2] == before[2]):
            raise RuntimeError(f"{name}: the main path did not run through "
                               "the kernels alone")
        _check_field(sf, field, name)
    launches = {"sor2d_extend_rows": sor2d.EXTEND_LAUNCHES,
                "sor2d_color_sweep": sor2d.LAUNCHES}

    # the batched answer against a float64 run of the same call on the CPU
    # (plain path), both checking every 32 sweeps as the card's run does
    torch.set_default_device("cpu")
    torch.set_default_dtype(torch.float64)
    ref = xt.invert_Poisson(gal, dims=["lat", "lon"],
                            iParams=dict(iP_gal, checkEvery=32))
    ocean = ~np.isnan(ref.values)
    dev = (np.abs(results["8x73x144"].values[ocean] - ref.values[ocean]).max()
           / np.abs(ref.values[ocean]).max())
    log(f"[3] 8x73x144 float32 card vs float64 CPU: max|diff|/max|S| = "
        f"{dev:.3e} (limit 1e-4); CPU iters "
        f"{api.LAST_SOLVE.iters.tolist()}")
    if not dev <= 1e-4:
        raise RuntimeError("the card's answer disagrees with the float64 "
                           "CPU run")
    return launches


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


def phase4(card, dev):
    ny = nx = 2048
    n = 500
    spec, omega = poisson_spec(ny, nx, 0, torch.float32, dev)
    S0 = torch.zeros((ny, nx), dtype=torch.float32, device=dev)
    K = len(spec.offsets)
    t_k = _chain_ms(lambda S: xt.solve_fixed(spec, S, omega, n), S0)
    t_p = _chain_ms(lambda S: sor2d.sor2d_sweeps_reference(spec, S, omega, n),
                    S0)
    t_k2 = _chain_ms(lambda S: xt.solve_fixed(spec, S, omega, n), S0)
    # a device-to-device copy moving the kernel path's bytes per sweep:
    # 2 * (K + 5) planes (read + write)
    sweep_bytes = 2 * (K + 5) * ny * nx * 4
    src = torch.empty(sweep_bytes // 2, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    dst.copy_(src)
    t_copy = _time_ms(lambda: dst.copy_(src), 5, inner=20)
    copy_bw = sweep_bytes / (t_copy * 1e-3)
    pts = ny * nx * n
    t_kern = min(t_k, t_k2)
    spec64, _ = poisson_spec(ny, nx, 0, torch.float64, dev)
    t_64 = _chain_ms(lambda S: xt.solve_fixed(spec64, S, omega, n),
                     S0.double())
    log(f"[4] {card} | solve_fixed 2048x2048 float32, {n} sweeps per call, "
        f"median of 5 chained calls: kernels {t_k:.3f} ms then "
        f"{t_k2:.3f} ms = {pts / (t_kern * 1e-3):.4e} point-sweeps/s; "
        f"plain {t_p:.3f} ms = {pts / (t_p * 1e-3):.4e} point-sweeps/s")
    log(f"[4] {card} | solve_fixed 2048x2048 float64, kernels: "
        f"{t_64:.3f} ms = {pts / (t_64 * 1e-3):.4e} point-sweeps/s")
    log(f"[4] {card} | kernels move {sweep_bytes} B per sweep = "
        f"{sweep_bytes * n / (t_kern * 1e-3) / 1e9:.1f} GB/s; "
        f"device copy of {sweep_bytes // 2} B: {t_copy:.4f} ms = "
        f"{copy_bw / 1e9:.1f} GB/s")
    # each kernel against its plain version, per call on the same inputs:
    # device time (torch.profiler) and CUDA-event time of the wrapper call
    S = xt.solve_fixed(spec, S0, omega, 50)
    rel = sor2d.relax_plane(spec, omega)
    calls = {
        "sor2d_extend_rows": (
            lambda: sor2d.sor2d_extend(spec, S),
            lambda: sor2d.sor2d_extend_reference(spec, S)),
        "sor2d_color_sweep": (
            lambda: sor2d.sor2d_color_sweep(spec, S, rel, 0),
            lambda: sor2d.sor2d_color_sweep_reference(spec, S, rel, 0)),
    }
    per = {}
    for name, (kern, plain) in calls.items():
        _, kern_keys = _device_ms(kern, 50)
        launch = [v for k, v in kern_keys.items() if f"{name}_kernel" in k]
        if len(launch) != 1:
            raise RuntimeError(f"the profiler shows no launch of {name}")
        t_launch = launch[0]
        t_plain, _ = _device_ms(plain, 50)
        w_kern = _time_ms(kern, 5, 50)
        w_plain = _time_ms(plain, 5, 50)
        per[name] = (t_launch, t_plain)
        log(f"[4] {card} | {name} 2048x2048 float32: kernel "
            f"{t_launch:.4f} ms device time per launch, plain version "
            f"{t_plain:.4f} ms device time per call (torch.profiler, 50 "
            f"calls); wrapper call {w_kern:.4f} ms vs plain call "
            f"{w_plain:.4f} ms (CUDA events, median of 5 runs of 50)")
    return per


def _device_ms(fn, calls):
    """Device time of ``calls`` calls of fn() from torch.profiler: (ms per
    call over every kernel and copy, {kernel name: ms per launch})."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per_launch, total_us = {}, 0.0
    for ev in prof.key_averages():
        us = ev.self_device_time_total
        total_us += us
        if ev.count:
            per_launch[ev.key] = us / ev.count / 1e3
    if not total_us > 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return total_us / calls / 1e3, per_launch


def main():
    card = phase0()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase1()
    errs = phase2(dev)
    launches = phase3()
    torch.set_default_device("cpu")
    torch.set_default_dtype(torch.float32)
    per = phase4(card, dev)
    replaces = {"sor2d_extend_rows": ("xinvert_tpu/ops/pallas_sor.py:43",
                                      "xinvert_tpu/ops/pallas_sor_window.py:67"),
                "sor2d_color_sweep": ("xinvert_tpu/ops/pallas_sor.py:94",
                                      "xinvert_tpu/ops/pallas_sor_window.py:252")}
    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                "replaces": replaces[name][0],
                "also_replaces": replaces[name][1],
                "launches": launches[name], "max_abs_err": errs[name],
                "ms": per[name][0], "plain_ms": per[name][1]}
               for name in ("sor2d_extend_rows", "sor2d_color_sweep")]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
