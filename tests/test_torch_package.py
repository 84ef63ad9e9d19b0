# -*- coding: utf-8 -*-
"""Package boundaries of the PyTorch port: it imports neither JAX nor
xinvert_tpu, and chip_smoke.py refuses to run (and prints no result) on a
machine without CUDA."""
import os
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
