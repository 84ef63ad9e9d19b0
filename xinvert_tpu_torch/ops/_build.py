# -*- coding: utf-8 -*-
"""Build and load the hand-written CUDA kernels.

At first use, ``nvcc`` compiles ``csrc/sor2d.cu`` into a shared library with
a plain C interface under ``xinvert_tpu_torch/_build/`` (git-ignored); the
file name carries a hash of the source and the flags, so an edit rebuilds.
The library is loaded with ``ctypes``: device pointers and the stream pass
as ``c_void_p``.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["load", "NVCC_FLAGS", "BUILD_SECONDS"]

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "sor2d.cu"
_BUILD_DIR = _PKG / "_build"

# -fmad=false: no contraction of a*b+c, so every step rounds as the plain
# PyTorch version's separate ops do (bit-for-bit equality)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

#: seconds the last build in this process took (0.0 when the library was
#: already built)
BUILD_SECONDS = 0.0

_LIB = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "sor2d_partials_per_slice": ([_I, _I], _I),
    "sor2d_extend_rows_f32": ([_P, _I, _I, _I, _I, _I, _P], _I),
    "sor2d_extend_rows_f64": ([_P, _I, _I, _I, _I, _I, _P], _I),
}
for _t in ("f32", "f64"):
    _SIGNATURES[f"sor2d_color_sweep_{_t}"] = (
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P,
         _L, _L, _L, _L, _L, _I, _P], _I)


def _nvcc():
    """Path of nvcc: ``$CUDA_HOME/bin``, then ``PATH``, then the toolkit's
    default install location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    return None


def load():
    """The loaded kernel library, built on first use."""
    global _LIB, BUILD_SECONDS
    if _LIB is not None:
        return _LIB
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = _BUILD_DIR / f"libsor2d_{tag}.so"
    if not lib_path.exists():
        nvcc = _nvcc()
        if nvcc is None:
            raise RuntimeError(
                "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                "/usr/local/cuda/bin): the CUDA toolkit is needed to build "
                f"{_SRC}")
        _BUILD_DIR.mkdir(exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {_SRC} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib_path)
        BUILD_SECONDS = time.perf_counter() - t0
    lib = ctypes.CDLL(str(lib_path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _LIB = lib
    return lib
