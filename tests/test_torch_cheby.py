# -*- coding: utf-8 -*-
"""Cyclic-Chebyshev SOR (``scheme="cheby"``) of the PyTorch port against the
JAX package's, float64 on the CPU: the factor sequence (rho2_from_omega,
_cheby_next) in float32 and float64, solve_fixed_cheby on 2-D and 3-D specs,
solve(scheme="cheby") under both stopping rules, at the mxLoop cap with a
remainder window and with per-slice freezing, the entry points with
iParams["scheme"] = "cheby", and the 2-D and 3-D wrappers' factor argument
on the CPU.  Equal iters and overflow; S at rtol 1e-10 (solves) or within
1e-12 * max|S| (fixed counts)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread keeps the parallel test workers from
# oversubscribing the cores (spinning OpenMP threads stall the others)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import xinvert_tpu as xv  # noqa: E402
from xinvert_tpu import solver as jsolver  # noqa: E402
from xinvert_tpu.grid import Grid as JGrid  # noqa: E402
from xinvert_tpu.models import api as japi  # noqa: E402
from xinvert_tpu.models import problems as jprob  # noqa: E402
from xinvert_tpu.models.params import default_mParams  # noqa: E402
import xinvert_tpu_torch as xt  # noqa: E402
from xinvert_tpu_torch import solver as tsolver  # noqa: E402
from xinvert_tpu_torch.models import api as tapi  # noqa: E402
from xinvert_tpu_torch.ops import sor2d, sor3d  # noqa: E402
from xinvert_tpu_torch.stencil import StencilSpec  # noqa: E402


def _port(js):
    return StencilSpec.from_arrays(
        np.asarray(js.w), np.asarray(js.w0), np.asarray(js.g),
        np.asarray(js.relax), np.asarray(js.active), js.offsets, js.bcs,
        js.bih, js.stop_on_zero_norm, device="cpu", dtype=torch.float64)


def _poisson(batch=0, ny=37, nx=72, bcs=("extend", "periodic"), seed=0):
    rng = np.random.default_rng(seed)
    lat = np.linspace(-88.75, 88.75, ny)
    lon = np.linspace(0.0, 360.0 - 360.0 / nx, nx)
    grid = JGrid.make(("lat", "lon"), (lat, lon), "lat-lon", bcs=bcs)
    L, Lo = np.deg2rad(lat)[:, None], np.deg2rad(lon)[None, :]
    shape = (batch, ny, nx) if batch else (ny, nx)
    F = (np.sin(3 * Lo) * np.cos(2 * L)
         + 0.1 * rng.standard_normal(shape)) * 1e-5
    Fdef = np.ones((ny, nx), bool)
    Fdef[ny // 3:ny // 2, nx // 4:nx // 2] = False
    return jprob.build_poisson(jnp.asarray(F), jnp.asarray(Fdef), grid,
                               default_mParams)


def _omega3d():
    rng = np.random.default_rng(2)
    nz, ny, nx = 6, 11, 16
    grid = JGrid.make(("lev", "lat", "lon"),
                      (np.linspace(100000.0, 10000.0, nz),
                       np.linspace(-70.0, 70.0, ny),
                       np.linspace(0.0, 360.0 - 360.0 / nx, nx)),
                      "lat-lon", bcs=("fixed", "extend", "periodic"))
    F = rng.standard_normal((2, nz, ny, nx)) * 1e-15
    return jprob.build_omega(jnp.asarray(F), jnp.ones((nz, ny, nx), bool),
                             grid, default_mParams)


def _close(out_t, out_j):
    ref = np.asarray(out_j)
    got = out_t.numpy()
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("omega", [1.0, 1.3, 1.6, 1.93, 1.9995])
def test_factor_sequence_matches_jax(dtype, omega):
    """The host factors equal the JAX recurrence's in the state's dtype,
    bit for bit (float32 included, weak-typed constants and all)."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    rho2_j = jsolver.rho2_from_omega(jnp.asarray(omega, jdt))
    rho2_t = tsolver.rho2_from_omega(omega, dtype)
    assert float(rho2_t) == float(rho2_j)
    assert rho2_t.dtype == np.dtype(jdt)
    m, w, ref = jnp.zeros((), jnp.int32), jnp.ones((), jdt), []
    for _ in range(60):
        w = jsolver._cheby_next(m, w, rho2_j).astype(jdt)
        m = m + 1
        ref.append(float(w))
    got, m_t, w_t = tsolver._cheby_factors(0, rho2_t.dtype.type(1.0), rho2_t,
                                           60)
    assert got == ref and m_t == 60 and float(w_t) == ref[-1]


@pytest.mark.parametrize("case", ["2d", "2d_batched_fixed", "3d"])
def test_solve_fixed_cheby_matches_jax(case):
    if case == "3d":
        js = _omega3d()
    elif case == "2d":
        js = _poisson()
    else:
        js = _poisson(batch=2, bcs=("fixed", "fixed"), seed=1)
    S0 = np.zeros(js.g.shape)
    ref = jsolver.solve_fixed_cheby(js, jnp.asarray(S0), 1.7, 23)
    got = xt.solve_fixed_cheby(_port(js), torch.as_tensor(S0), 1.7, 23)
    _close(got, ref)


def _compare(rj, rt):
    np.testing.assert_array_equal(rt.iters.numpy(), np.asarray(rj.iters))
    np.testing.assert_array_equal(rt.overflow.numpy(),
                                  np.asarray(rj.overflow))
    np.testing.assert_allclose(rt.rel_change.numpy(),
                               np.asarray(rj.rel_change), rtol=0, atol=1e-13)
    Sj, St = np.asarray(rj.S), rt.S.numpy()
    np.testing.assert_allclose(St, Sj, rtol=1e-10,
                               atol=1e-10 * np.abs(Sj).max())


@pytest.mark.parametrize("tol_type,tol,check_every,max_iters,batch", [
    ("change", 1e-5, 1, 400, 0),     # stops on the change rule
    ("residual", 1e-3, 1, 400, 0),   # stops on the residual rule
    ("change", 1e-14, 7, 50, 0),     # cap not a multiple: remainder window
    ("change", 1e-5, 3, 600, 3),     # slices stop at different sweeps
])
def test_solve_cheby_matches_jax(tol_type, tol, check_every, max_iters,
                                 batch):
    js = _poisson(batch=batch, seed=3)
    S0 = np.zeros(js.g.shape)
    if batch:
        S0[1] = 1e3        # one slice starts far from the others
    kw = dict(omega=1.9, tol=tol, max_iters=max_iters,
              check_every=check_every, tol_type=tol_type, scheme="cheby")
    rj = xv.solve(js, jnp.asarray(S0), **kw)
    rt = xt.solve(_port(js), torch.as_tensor(S0), **kw)
    _compare(rj, rt)
    if batch:
        assert len(set(rt.iters.tolist())) > 1


@pytest.mark.parametrize("entry", ["invert_Poisson", "invert_Stommel"])
def test_entry_point_cheby_matches_jax(entry):
    dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        rng = np.random.default_rng(4)
        lat = np.linspace(-70.0, 80.0, 31)
        lon = np.linspace(0.0, 355.0, 72)
        F = rng.normal(0, 1e-7, (31, 72))
        F[10:15, 20:30] = np.nan
        iP = {"BCs": ["extend", "periodic"], "mxLoop": 400,
              "tolerance": 1e-9, "undef": np.nan, "printInfo": False,
              "scheme": "cheby", "optArg": 1.6}
        # a strong drag keeps the 5-degree Stommel problem diagonally
        # dominant (its cell Peclet number below 1)
        mp = {"R": 2e-3, "D": 100} if entry == "invert_Stommel" else None

        def run(pkg):
            kw = {"device": "cpu"} if pkg is xt else {}
            return getattr(pkg, entry)(
                pkg.Field(F, ("lat", "lon"), {"lat": lat, "lon": lon}),
                dims=["lat", "lon"], iParams=iP, mParams=mp, **kw)
        out_j, out_t = run(xv), run(xt)
    finally:
        torch.set_default_dtype(dtype)
    ok = ~np.isnan(out_j.values)
    np.testing.assert_array_equal(np.isnan(out_t.values), ~ok)
    np.testing.assert_allclose(out_t.values[ok], out_j.values[ok], rtol=1e-10,
                               atol=1e-10 * np.abs(out_j.values[ok]).max())
    np.testing.assert_array_equal(tapi.LAST_SOLVE.iters.numpy(),
                                  np.asarray(japi.LAST_SOLVE.iters))
    assert not bool(tapi.LAST_SOLVE.overflow)


def test_wrappers_take_factors_on_cpu():
    """sor2d_sweeps / sor3d_sweeps with factors run the plain cheby sweeps
    on CPU tensors; the 3-D color-sweep wrapper (the red launch with the
    extend pre-pass folded in, then the black) scales the relaxation plane
    by the factor, and a count of factors that does not match raises."""
    ts2 = _port(_poisson(batch=2, seed=5))
    ts3 = _port(_omega3d())
    for mod, ts, p in ((sor2d, ts2, "sor2d"), (sor3d, ts3, "sor3d")):
        S0 = torch.as_tensor(np.random.default_rng(6).normal(
            0, 1e-3, tuple(ts.g.shape)))
        fac = [1.0, 1.3, 1.45, 1.5]
        out = getattr(mod, f"{p}_sweeps")(ts, S0, 1.0, 2, fac=fac)
        assert torch.equal(out, tsolver.sweeps(ts, S0, 1.0, 2, fac))
        out_n, sumabs = getattr(mod, f"{p}_sweeps")(ts, S0, 1.0, 2,
                                                    with_norm=True, fac=fac)
        assert torch.equal(out_n, out)
        if mod is sor3d:
            rel = mod.relax_plane(ts, 1.0)
            S = sor3d.sor3d_color_sweep(ts, S0, rel, 0, fac[0], extend=True)
            S = sor3d.sor3d_color_sweep(ts, S, rel, 1, fac[1])
            assert torch.equal(S, tsolver.sweeps(ts, S0, 1.0, 1, fac[:2]))
        with pytest.raises(ValueError, match="factors"):
            getattr(mod, f"{p}_sweeps")(ts, S0, 1.0, 2, fac=fac[:3])


def test_cheby_at_omega_one_is_sor():
    """omega 1 gives rho2 = 0 and every factor 1: cheby is Gauss-Seidel."""
    ts = _port(_poisson(seed=7))
    S0 = torch.zeros(tuple(ts.g.shape), dtype=torch.float64)
    assert torch.equal(xt.solve_fixed_cheby(ts, S0, 1.0, 9),
                       xt.solve_fixed(ts, S0, 1.0, 9))
