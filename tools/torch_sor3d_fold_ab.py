#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""The 3-D color sweep of checkouts of the PyTorch port, in turns, on one
NVIDIA GPU: the parent (first version: the extend launch and an unfolded
pair) against this tree (the extend pre-pass folded into the red launch),
and any other variants given.

    python3 tools/torch_sor3d_fold_ab.py PARENT_ROOT [OTHER_ROOT ...]

Each root holds a checkout (``git archive`` of the parent commit, or a
copy with another csrc/sor3d.cu, unpacked into a git-ignored directory).
The roots run in turns, PARENT_ROOT, this tree, the others, then the same
in reverse, each in a process of its own that builds that root's
csrc/sor3d.cu and imports that root's xinvert_tpu_torch; the
inputs come from this tree's chip_smoke.py recipe (the 30x330x720 global
ocean, float32, ``ocean_spec``).  Each process prints one line ``AB
{json}``: ptxas's registers and spills of each color-sweep instantiation,
the device time per launch (50 launches behind a device spin) of the red
launch, unfolded and (this tree) folded, the black launch and the extend
launch, the time per sweep of ``sor3d_sweeps`` (200 sweeps a call, median
of 5 chained calls) and the wall time of ``invert_3DOcean`` (median of 3
calls after a warm-up).  The card's name and power limit come first.
"""
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _one(root):
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    import xinvert_tpu_torch as xt
    from xinvert_tpu_torch.ops import _build, sor3d
    assert os.path.abspath(xt.__file__).startswith(os.path.abspath(root))
    spec_ = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(cs)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.build_all()
    lines = _build.BUILD_LOG.get("sor3d", "").splitlines()
    ptxas = {}
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "color_sweep" in line:
            name = line.split("'")[1]
            ptxas[name] = " | ".join(x.split(":", 1)[-1].strip()
                                     for x in lines[i + 2:i + 4])
    spec, omega = cs.ocean_spec(30, torch.float32, dev)
    S0 = torch.zeros((30, 330, 720), dtype=torch.float32, device=dev)
    S = xt.solve_fixed(spec, S0, omega, 50)
    fam = sor3d._FAMILY
    rel = sor3d.relax_plane(spec, omega)
    lay = fam.layout(spec, S, rel)
    A = S.reshape((lay["B"],) + lay["core"]).clone()
    A2 = torch.empty_like(A)
    out = {"root": root, "ptxas": ptxas}
    out["red_ms"] = cs._device_ms(
        lambda: fam.launch_color_sweep(spec, lay, rel, A, A2, 0), 50)
    if "extend" in inspect.signature(fam.launch_color_sweep).parameters:
        out["red_folded_ms"] = cs._device_ms(
            lambda: fam.launch_color_sweep(spec, lay, rel, A, A2, 0,
                                           extend=True), 50)
    out["black_ms"] = cs._device_ms(
        lambda: fam.launch_color_sweep(spec, lay, rel, A, A2, 1), 50)
    out["extend_ms"] = cs._device_ms(lambda: fam.launch_extend(spec, lay, A),
                                     50)
    out["sweep_ms"] = cs._chain_ms(
        lambda S_: sor3d.sor3d_sweeps(spec, S_, omega, 200), S0) / 200
    F, N2 = cs.ocean3d(30)
    iP = {"BCs": ["fixed", "extend", "periodic"], "undef": np.nan,
          "mxLoop": 2000, "tolerance": 1e-8, "printInfo": False}

    def call():
        t0 = time.perf_counter()
        xt.invert_3DOcean(F, dims=cs.DIMS_3D,
                          mParams=dict(cs.OCEAN_MP, N2=N2), iParams=iP)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    call()
    out["ocean_wall_s"] = float(np.median([call() for _ in range(3)]))
    out["ocean_iters"] = int(xt.models.api.LAST_SOLVE.iters)
    print("AB " + json.dumps(out), flush=True)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        return _one(sys.argv[2])
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    roots = [sys.argv[1], HERE] + sys.argv[2:]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    for root in roots + roots[::-1]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        root], check=True, timeout=900)


if __name__ == "__main__":
    main()
