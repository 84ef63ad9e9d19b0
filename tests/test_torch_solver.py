# -*- coding: utf-8 -*-
"""The port's SOR engine (solve / solve_fixed) against xinvert_tpu's on
identical specs (StencilSpec.from_arrays), float64 on the CPU: the JAX side
runs its XLA path, the port its plain sweeps.  Equal iters and overflow;
S at rtol 1e-10, rel_change at atol 1e-13."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread keeps the parallel test workers from
# oversubscribing the cores (spinning OpenMP threads stall the others)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import xinvert_tpu as xv  # noqa: E402
from xinvert_tpu import stencil as jst  # noqa: E402
from xinvert_tpu.grid import Grid as JGrid  # noqa: E402
from xinvert_tpu.models import problems as jprob  # noqa: E402
from xinvert_tpu.models.params import default_mParams  # noqa: E402
import xinvert_tpu_torch as xt  # noqa: E402
from xinvert_tpu_torch.ops import sor2d  # noqa: E402
from xinvert_tpu_torch.stencil import StencilSpec  # noqa: E402


def _port(js):
    return StencilSpec.from_arrays(
        np.asarray(js.w), np.asarray(js.w0), np.asarray(js.g),
        np.asarray(js.relax), np.asarray(js.active), js.offsets, js.bcs,
        js.bih, js.stop_on_zero_norm, device="cpu", dtype=torch.float64)


def _poisson(vals, ny=37, nx=72, bcs=("extend", "periodic")):
    """The masked spherical Poisson spec (JAX builder) for forcing ``vals``."""
    lat = np.linspace(-88.75, 88.75, ny)
    lon = np.linspace(0.0, 360.0 - 360.0 / nx, nx)
    grid = JGrid.make(("lat", "lon"), (lat, lon), "lat-lon", bcs=bcs)
    Fdef = np.ones((ny, nx), bool)
    Fdef[ny // 3:ny // 2, nx // 4:nx // 2] = False
    return jprob.build_poisson(jnp.asarray(vals), jnp.asarray(Fdef), grid,
                               default_mParams)


def _forcing(batch=0, ny=37, nx=72, seed=0):
    rng = np.random.default_rng(seed)
    lat = np.deg2rad(np.linspace(-88.75, 88.75, ny))[:, None]
    lon = np.deg2rad(np.linspace(0.0, 360.0 - 360.0 / nx, nx))[None, :]
    shape = (batch, ny, nx) if batch else (ny, nx)
    return (np.sin(3 * lon) * np.cos(2 * lat)
            + 0.1 * rng.standard_normal(shape)) * 1e-5


def _compare(rj, rt):
    np.testing.assert_array_equal(rt.iters.numpy(), np.asarray(rj.iters))
    np.testing.assert_array_equal(rt.overflow.numpy(),
                                  np.asarray(rj.overflow))
    np.testing.assert_allclose(rt.rel_change.numpy(),
                               np.asarray(rj.rel_change), rtol=0, atol=1e-13)
    Sj = np.asarray(rj.S)
    St = rt.S.numpy()
    fin = np.isfinite(Sj)
    np.testing.assert_array_equal(np.isfinite(St), fin)
    np.testing.assert_allclose(St[fin], Sj[fin], rtol=1e-10,
                               atol=1e-10 * np.abs(Sj[fin]).max())


def _both(js, S0, **kw):
    rj = xv.solve(js, jnp.asarray(S0), **kw)
    rt = xt.solve(_port(js), torch.as_tensor(S0), **kw)
    return rj, rt


@pytest.mark.parametrize("tol_type,tol,check_every,max_iters", [
    ("change", 1e-5, 1, 400),      # stops on the change rule
    ("residual", 1e-3, 1, 400),    # stops on the residual rule
    ("change", 1e-14, 1, 50),      # runs to the mxLoop cap
    ("change", 1e-14, 7, 50),      # cap not a multiple: remainder window
    ("residual", 1e-12, 7, 50),
    ("change", 1e-4, 7, 400),      # amortised check stops early
])
def test_solve_matches_jax(tol_type, tol, check_every, max_iters):
    js = _poisson(_forcing())
    S0 = np.zeros((37, 72))
    rj, rt = _both(js, S0, omega=1.9, tol=tol, max_iters=max_iters,
                   check_every=check_every, tol_type=tol_type)
    _compare(rj, rt)
    if tol < 1e-10:
        assert int(rt.iters) == max_iters
    else:
        assert int(rt.iters) < max_iters


@pytest.mark.parametrize("check_every", [1, 3])
def test_batch_freezes_finished_slices(check_every):
    """Slices stop at different sweeps: a zero slice stops on the zero norm
    at its first check, the smooth and the noisy slices later."""
    F = _forcing(batch=3)
    F[0] = 0.0
    F[2] = np.random.default_rng(1).standard_normal((37, 72)) * 1e-5
    js = _poisson(F)
    rj, rt = _both(js, np.zeros((3, 37, 72)), omega=1.9, tol=1e-5,
                   max_iters=600, check_every=check_every)
    _compare(rj, rt)
    iters = rt.iters.numpy()
    assert iters[0] == check_every
    assert len(set(iters.tolist())) == 3


def test_overflow_detected():
    js = _poisson(_forcing())
    rj, rt = _both(js, np.zeros((37, 72)), omega=2.5, tol=1e-12,
                   max_iters=3000)
    _compare(rj, rt)
    assert bool(rt.overflow) and int(rt.iters) < 3000


@pytest.mark.parametrize("batch,bcs", [(0, ("extend", "periodic")),
                                       (2, ("fixed", "fixed"))])
def test_solve_fixed_matches_jax(batch, bcs):
    js = _poisson(_forcing(batch=batch), bcs=bcs)
    S0 = np.zeros(js.g.shape)
    out_j = xv.solve_fixed(js, jnp.asarray(S0), 1.7, 25)
    l0 = sor2d.LAUNCHES
    out_t = xt.solve_fixed(_port(js), torch.as_tensor(S0), 1.7, 25)
    assert sor2d.LAUNCHES == l0
    ref = np.asarray(out_j)
    np.testing.assert_allclose(out_t.numpy(), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


def test_solve_prunes_zero_planes_like_jax():
    rng = np.random.default_rng(4)
    ny, nx = 24, 30
    A = np.abs(rng.normal(1.0, 0.1, (ny, nx))) + 0.5
    js = jst.standard_2d(jnp.asarray(A), jnp.zeros((ny, nx)), jnp.asarray(A),
                         jnp.asarray(rng.normal(0, 1, (ny, nx))),
                         jnp.ones((ny, nx), bool), (1.0, 1.0),
                         ("fixed", "periodic"), include_cross=True)
    assert len(js.offsets) == 8
    rj, rt = _both(js, np.zeros((ny, nx)), omega=1.5, tol=1e-7,
                   max_iters=300)
    _compare(rj, rt)


def test_solve_rejects_unported_and_mismatched():
    ts = _port(_poisson(_forcing()))
    S0 = torch.zeros(37, 72, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        xt.solve(ts, S0, scheme="lexico")
    # direct is ported: a spec it does not take raises as in the JAX package
    with pytest.raises(ValueError, match="does not qualify"):
        xt.solve(ts, S0, scheme="direct")
    with pytest.raises(ValueError):
        xt.solve(ts, S0, scheme="nope")
    with pytest.raises(ValueError):
        xt.solve(ts, S0, tol_type="refined")
    with pytest.raises(TypeError):
        xt.solve(ts, S0.float())
