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
                                  "direct_applicable", "solve_refined",
                                  "RefineResult", "solve_streamed",
                                  "solve_implicit", "transpose_spec"])
def test_ported_names_are_the_modules_functions(name):
    from xinvert_tpu_torch import mg, refine, stream
    from xinvert_tpu_torch.ops import direct, implicit, tridiag
    home = next(m for m in (mg, direct, tridiag, refine, stream, implicit)
                if hasattr(m, name))
    assert getattr(xt, name) is getattr(home, name)


def test_parallel_names_match_the_jax_package():
    """``xinvert_tpu_torch.parallel`` exports ``xinvert_tpu.parallel``'s
    names, the sharded multigrid (``shard_mg_levels``,
    ``solve_mg_sharded``) included."""
    from xinvert_tpu import parallel as jpar
    from xinvert_tpu_torch import parallel as tpar
    assert {"shard_mg_levels", "solve_mg_sharded"} <= _public(tpar)
    assert _public(tpar) == _public(jpar)
