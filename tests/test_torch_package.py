# -*- coding: utf-8 -*-
"""Package boundaries of the PyTorch port: it imports neither JAX nor
xinvert_tpu, chip_smoke.py refuses to run (and prints no result) on a
machine without CUDA, and the ctypes signatures that ``ops/_build.py``
sets are the ``extern "C"`` functions of the CUDA sources, read as text."""
import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_pulls_in_no_jax():
    code = ("import sys, xinvert_tpu_torch, xinvert_tpu_torch.ops.sor2d, "
            "xinvert_tpu_torch.ops.sor3d, xinvert_tpu_torch.ops._build, "
            "xinvert_tpu_torch.ops.direct, xinvert_tpu_torch.ops.tridiag; "
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'xinvert_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_fails_without_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: chip_smoke.py would run")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def _extern_functions(src):
    """name -> parameter count of every function defined in the
    ``extern "C"`` block of a CUDA source."""
    body = src[src.index('extern "C" {'):src.rindex('}  // extern "C"')]
    found = {}
    for m in re.finditer(r"^int (\w+)\(([^)]*)\)", body, re.M):
        found[m.group(1)] = len(m.group(2).split(","))
    return found


@pytest.mark.parametrize("name", ["sor2d", "sor3d"])
def test_signatures_match_the_sources(name):
    """Every ``_SIGNATURES`` entry of a source is one of its ``extern "C"``
    functions, with as many arguments, and every such function has an
    entry."""
    from xinvert_tpu_torch.ops import _build
    with open(_build.SOURCES[name]) as fh:
        defined = _extern_functions(fh.read())
    sigs = _build._SIGNATURES[name]
    assert sorted(sigs) == sorted(defined)
    for fn, (argtypes, _) in sigs.items():
        assert len(argtypes) == defined[fn], fn
