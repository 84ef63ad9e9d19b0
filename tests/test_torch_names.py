# -*- coding: utf-8 -*-
"""The port's top-level names against the JAX package's: every public
name of ``xinvert_tpu`` (functions, classes and values; submodules left
out) is a name of ``xinvert_tpu_torch``, except those of modules not
ported yet, listed here with their ROADMAP item; later slices shrink the
list.  The port exports nothing the JAX package does not."""
import inspect

import pytest

pytest.importorskip("torch")

import xinvert_tpu as xi  # noqa: E402
import xinvert_tpu_torch as xt  # noqa: E402

NOT_PORTED = {
    # queue A item 7: the 1-D families, trajectories, cal_flow, fd.py
    "inv_standard1D", "invert_GeoAdjustment", "invert_RefStateSWM",
    "solve_trajectory", "animate_iteration", "cal_flow", "loop_noncore",
    "FiniteDiff", "padBCs", "deriv", "deriv2",
    # item 11: lexico.py
    "solve_fixed_lexicographic",
    # item 13: refine.py
    "solve_refined", "RefineResult",
    # item 14: stream.py
    "solve_streamed",
    # item 15: ops/implicit.py
    "solve_implicit", "transpose_spec",
    # TPU-only (ROADMAP queue A, "Not to port"): the XLA compile cache
    "enable_compile_cache",
}


def _public(pkg):
    return {n for n in dir(pkg) if not n.startswith("_")
            and not inspect.ismodule(getattr(pkg, n))}


def test_top_level_names_match_the_jax_package():
    jax_names, port_names = _public(xi), _public(xt)
    assert NOT_PORTED <= jax_names
    assert port_names == jax_names - NOT_PORTED


@pytest.mark.parametrize("name", ["solve_mg", "trace", "traceCyclic",
                                  "tridiag_solve", "build_pyramid_standard2d",
                                  "build_pyramid_standard3d",
                                  "build_pyramid_bih2d",
                                  "build_pyramid_general2d",
                                  "build_pyramid_general3d", "solve_direct",
                                  "direct_applicable"])
def test_ported_names_are_the_modules_functions(name):
    from xinvert_tpu_torch import mg
    from xinvert_tpu_torch.ops import direct, tridiag
    home = next(m for m in (mg, direct, tridiag) if hasattr(m, name))
    assert getattr(xt, name) is getattr(home, name)
