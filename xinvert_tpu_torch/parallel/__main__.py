# -*- coding: utf-8 -*-
"""Weak scaling of the sharded Poisson solve over the visible CUDA devices,
one block a card (the JAX package's ``python -m
xinvert_tpu.parallel.scaling``)::

    python -m xinvert_tpu_torch.parallel [--base 1024] [--iters 200]
"""
import argparse

from .scaling import format_scaling_table, scaling_bench

ap = argparse.ArgumentParser(
    prog="python -m xinvert_tpu_torch.parallel",
    description="weak scaling of the sharded Poisson solve over the "
    "visible CUDA devices (1, 2, 4, ... blocks, one a card)")
ap.add_argument("--base", type=int, default=256,
                help="rows and columns of a block (default 256)")
ap.add_argument("--iters", type=int, default=50,
                help="sweeps a timed call (default 50)")
ap.add_argument("--executor", default="gspmd",
                choices=("gspmd", "halo_window", "halo_window_xy",
                         "halo_window3d", "halo"))
args = ap.parse_args()
print(format_scaling_table(scaling_bench(
    base_ny=args.base, base_nx=args.base, n_iters=args.iters,
    executor=args.executor)))
