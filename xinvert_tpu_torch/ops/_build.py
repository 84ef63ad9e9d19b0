# -*- coding: utf-8 -*-
"""Build and load the hand-written CUDA kernels.

Each source in ``csrc/`` (``sor2d.cu``, ``sor3d.cu``) compiles with ``nvcc``
into a shared library of its own with a plain C interface under
``xinvert_tpu_torch/_build/`` (git-ignored).  A library's file name carries
a hash of its source and the flags, so an edit of either source rebuilds
that source's library.  The first :func:`load` builds every missing library,
one ``nvcc`` per source, all started together.  The libraries are loaded
with ``ctypes``: device pointers and the stream pass as ``c_void_p``.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["load", "build_all", "SOURCES", "NVCC_FLAGS", "BUILD_SECONDS",
           "BUILD_LOG"]

_PKG = Path(__file__).resolve().parent.parent
SOURCES = {name: _PKG / "csrc" / f"{name}.cu" for name in ("sor2d", "sor3d")}
_BUILD_DIR = _PKG / "_build"

# -fmad=false: no contraction of a*b+c, so every step rounds as the plain
# PyTorch version's separate ops do (bit-for-bit equality); -Xptxas -v:
# each kernel's registers, shared memory and spills (BUILD_LOG)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")

#: seconds each source's nvcc took in this process (absent when its library
#: was already built)
BUILD_SECONDS = {}
#: what each source's nvcc printed on stderr in this process (ptxas -v)
BUILD_LOG = {}

_LIBS = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
_SIGNATURES = {"sor2d": {"sor2d_partials_per_slice": ([_I, _I], _I)},
               "sor3d": {"sor3d_partials_per_slice": ([_I, _I, _I], _I)}}
for _t in ("f32", "f64"):
    _SIGNATURES["sor2d"][f"sor2d_sweeps_tiled_{_t}"] = ([_P] * 9, _I)
    _SIGNATURES["sor2d"][f"sor2d_sweeps_block_{_t}"] = ([_P] * 9, _I)
    _SIGNATURES["sor2d"][f"sor2d_sweeps_resident_{_t}"] = ([_P] * 8, _I)
    _SIGNATURES["sor3d"][f"sor3d_color_sweep_{_t}"] = (
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P,
         _L, _L, _L, _L, _L, _I, _I, _I, _D, _P], _I)
    _SIGNATURES["sor3d"][f"sor3d_block_sweep_{_t}"] = (
        [_P] * 7 + [_I] * 11 + [_P, _P, _P, _L, _L, _L, _L, _L, _I, _I, _I,
                                _D, _I, _P, _I, _P], _I)


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


def _lib_path(name):
    src = SOURCES[name].read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"lib{name}_{tag}.so"


def build_all():
    """Build every library that is missing, one nvcc per source, all
    started together; raise if any build fails."""
    todo = {name: _lib_path(name) for name in SOURCES}
    todo = {n: p for n, p in todo.items() if not p.exists()}
    if not todo:
        return
    nvcc = _nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
            "/usr/local/cuda/bin): the CUDA toolkit is needed to build "
            f"{', '.join(str(SOURCES[n]) for n in todo)}")
    _BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    for name, path in todo.items():
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        procs[name] = (tmp, time.perf_counter(), subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, t0, proc) in procs.items():
        _, err = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        BUILD_LOG[name] = err
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {SOURCES[name]} "
                          f"(exit {proc.returncode}):\n{err}")
        else:
            os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name):
    """The loaded kernel library of source ``name`` ("sor2d" or "sor3d"),
    building every missing library on first use."""
    if name in _LIBS:
        return _LIBS[name]
    build_all()
    lib = ctypes.CDLL(str(_lib_path(name)))
    for fn_name, (argtypes, restype) in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
    _LIBS[name] = lib
    return lib
