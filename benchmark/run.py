#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""The benchmark of xinvert_tpu_torch on one NVIDIA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout.  It resolves the cell by its name in
BENCHMARK.json, makes the cell's inputs from the seed, warms the cell's
shapes up, then calls the configuration's entry point back to back for
``--seconds`` (``--trace 0``: the end-to-end metrics) or profiles a steady
stretch of calls (``--trace 1``: the per-layer metrics and the device's
busy time), checks what the calls returned against the plain reference,
and prints one JSON line as the last line of standard output.  The numbers
compared, each with its limit, are the last lines of standard error and
the last key of that line.

It exits non-zero and prints no result without a CUDA card (or with fewer
than the cell asks for), without the program beside it, or when jax,
jaxlib, flax or the JAX package is loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "xinvert_tpu")


def forbidden_loaded(modules=None):
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``xinvert_tpu_torch`` is not ``xinvert_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness import cell as cells
    cell = cells.resolve(args.workload)

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    import xinvert_tpu_torch  # noqa: F401  (the program under test)
    torch.cuda.init()

    from benchmark.harness.window import run_cell
    result, rows = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            t_start=T_START)
    bad = forbidden_loaded()
    if bad:
        print(f"loaded in the run: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, value, limit in rows:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
