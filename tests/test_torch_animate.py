# -*- coding: utf-8 -*-
"""Solution trajectories of the PyTorch port (``solve_trajectory``,
``animate_iteration``) against the JAX package's, float64 on the CPU at
33x64 (and a small 3-D volume): frames of ``scheme`` sor, cheby and lexico,
frame k against a fixed count of k * loop_per_frame sweeps of the port's
own ``solve_fixed``/``solve_fixed_cheby`` (torch.equal), the 'iter'
coordinate, undef masking, and the rejections (direct, unknown schemes and
problem names, non-core dims).  Tolerance: within 1e-12 of max|S| for sor
and cheby, 1e-10 for lexico."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import xinvert_tpu as xv  # noqa: E402
from xinvert_tpu import solver as jsolver  # noqa: E402
from xinvert_tpu.grid import Grid as JGrid  # noqa: E402
from xinvert_tpu.models import problems as jprob  # noqa: E402
from xinvert_tpu.models.params import default_mParams  # noqa: E402
import xinvert_tpu_torch as xt  # noqa: E402
from xinvert_tpu_torch import solver as tsolver  # noqa: E402
from xinvert_tpu_torch.stencil import StencilSpec  # noqa: E402

TOL = {"sor": 1e-12, "cheby": 1e-12, "lexico": 1e-10}
NY, NX = 33, 64


@pytest.fixture(autouse=True)
def f64_cpu():
    """The port builds its tensors in the default dtype: float64 here."""
    dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(dtype)


def _port(js):
    return StencilSpec.from_arrays(
        np.asarray(js.w), np.asarray(js.w0), np.asarray(js.g),
        np.asarray(js.relax), np.asarray(js.active), js.offsets, js.bcs,
        js.bih, js.stop_on_zero_norm, device="cpu", dtype=torch.float64)


def _close(got, want, tol):
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ok = ~np.isnan(want)
    assert np.array_equal(ok, ~np.isnan(got))
    scale = np.abs(want[ok]).max()
    assert scale > 0
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=tol * scale)


def _vor(pkg, masked=True, batch=0):
    """A vorticity-like forcing on a 33x64 global grid, NaN over a block of
    'land' (masked)."""
    lat = np.linspace(-80.0, 80.0, NY)
    lon = np.arange(NX) * 360.0 / NX
    L, Lo = np.meshgrid(np.deg2rad(lat), np.deg2rad(lon), indexing="ij")
    vals = (np.sin(3 * Lo) * np.cos(2 * L) + 0.3 * np.cos(Lo - L)) * 1e-5
    if masked:
        vals[12:16, 20:30] = np.nan
    if batch:
        vals = np.stack([vals * (1 + 0.1 * i) for i in range(batch)])
        return pkg.Field(vals, ("t", "lat", "lon"),
                         {"t": np.arange(batch), "lat": lat, "lon": lon})
    return pkg.Field(vals, ("lat", "lon"), {"lat": lat, "lon": lon})


def _poisson_spec():
    f = _vor(xv)
    grid = JGrid.make(("lat", "lon"), (f.coords["lat"], f.coords["lon"]),
                      "lat-lon", bcs=("extend", "periodic"))
    Fdef = ~np.isnan(f.values)
    return (jprob.build_poisson(jnp.asarray(np.nan_to_num(f.values)),
                                jnp.asarray(Fdef), grid, default_mParams),
            grid.omega_opt)


@pytest.mark.parametrize("scheme", ["sor", "cheby", "lexico"])
def test_solve_trajectory_matches_jax(scheme):
    """Four frames of three sweeps each on the masked 33x64 Poisson."""
    js, omega = _poisson_spec()
    S0 = np.zeros((NY, NX))
    fj = jsolver.solve_trajectory(js, jnp.asarray(S0), omega,
                                  loop_per_frame=3, max_frames=4,
                                  scheme=scheme)
    ft = tsolver.solve_trajectory(_port(js), torch.tensor(S0), omega,
                                  loop_per_frame=3, max_frames=4,
                                  scheme=scheme)
    assert tuple(ft.shape) == (4, NY, NX)
    for k in range(4):
        _close(ft[k], fj[k], TOL[scheme])


@pytest.mark.parametrize("scheme", ["sor", "cheby"])
def test_frames_equal_fixed_counts(scheme):
    """Frame k is the state after (k+1) * loop_per_frame sweeps: for cheby
    the factor recurrence carries across frames.  Bit for bit."""
    js, omega = _poisson_spec()
    spec, S0 = _port(js), torch.zeros(2, NY, NX)
    frames = tsolver.solve_trajectory(spec, S0, omega, loop_per_frame=4,
                                      max_frames=3, scheme=scheme)
    fixed = (tsolver.solve_fixed if scheme == "sor"
             else tsolver.solve_fixed_cheby)
    for k in range(3):
        assert torch.equal(frames[k], fixed(spec, S0, omega, 4 * (k + 1)))


def test_solve_trajectory_3d_matches_jax():
    rng = np.random.default_rng(2)
    nz, ny, nx = 6, 11, 16
    grid = JGrid.make(("lev", "lat", "lon"),
                      (np.linspace(100000.0, 10000.0, nz),
                       np.linspace(-70.0, 70.0, ny),
                       np.linspace(0.0, 360.0 - 360.0 / nx, nx)),
                      "lat-lon", bcs=("fixed", "extend", "periodic"))
    F = rng.standard_normal((nz, ny, nx)) * 1e-15
    js = jprob.build_omega(jnp.asarray(F), jnp.ones((nz, ny, nx), bool),
                           grid, default_mParams)
    S0 = np.zeros((nz, ny, nx))
    for scheme in ("sor", "lexico"):
        fj = jsolver.solve_trajectory(js, jnp.asarray(S0), 1.5,
                                      loop_per_frame=2, max_frames=3,
                                      scheme=scheme)
        ft = tsolver.solve_trajectory(_port(js), torch.tensor(S0), 1.5,
                                      loop_per_frame=2, max_frames=3,
                                      scheme=scheme)
        _close(ft, fj, TOL[scheme])


@pytest.mark.parametrize("scheme", ["sor", "cheby", "lexico"])
@pytest.mark.parametrize("with_icbc", [False, True])
def test_animate_iteration_matches_jax(scheme, with_icbc):
    """animate_iteration("Poisson") on the masked field: undef over the
    mask without icbc, the icbc values there with it; the 'iter' dim."""
    iP = {"BCs": ["extend", "periodic"], "undef": np.nan, "scheme": scheme,
          "printInfo": False}
    kw_t = {"icbc": _vor(xt, masked=False) * 1e3} if with_icbc else {}
    kw_j = {"icbc": _vor(xv, masked=False) * 1e3} if with_icbc else {}
    at = xt.animate_iteration("Poisson", _vor(xt), ["lat", "lon"],
                              iParams=iP, loop_per_frame=3, max_frames=4,
                              device="cpu", **kw_t)
    aj = xv.animate_iteration("Poisson", _vor(xv), ["lat", "lon"],
                              iParams=iP, loop_per_frame=3, max_frames=4,
                              **kw_j)
    assert at.dims == aj.dims == ("iter", "lat", "lon")
    assert list(at.coords["iter"]) == [3, 6, 9, 12]
    assert np.isnan(at.values).any() != with_icbc
    _close(at.values, aj.values, TOL[scheme])


@pytest.mark.parametrize("name,field,mP,iP", [
    ("Stommel", "curl", {"R": 2e-4, "D": 100},
     {"BCs": ["fixed", "periodic"], "optArg": 1.4}),
    ("GillMatsuno", "heat", {"epsilon": 1e-5, "Phi": 5000},
     {"BCs": ["fixed", "periodic"]})])
def test_animate_other_apps_match_jax(name, field, mP, iP):
    """Two more names of the dispatch table (the GillMatsuno one takes its
    automatic omega, 1.4)."""
    lat = np.linspace(-88.0, 88.0, NY)
    lon = np.linspace(0.0, 355.0, NX)
    L, Lo = np.meshgrid(np.deg2rad(lat), np.deg2rad(lon), indexing="ij")
    vals = (1e-7 * np.sin(2 * L) * np.cos(3 * Lo) if field == "curl" else
            0.05 * np.exp(-(np.rad2deg(L) ** 2
                            + (np.rad2deg(Lo) - 120) ** 2) / 100.0))
    out = []
    for pkg, kw in ((xt, {"device": "cpu"}), (xv, {})):
        f = pkg.Field(vals, ("lat", "lon"), {"lat": lat, "lon": lon})
        out.append(pkg.animate_iteration(
            name, f, ["lat", "lon"], mParams=mP,
            iParams=dict(iP, printInfo=False), loop_per_frame=5,
            max_frames=3, **kw).values)
    _close(out[0], out[1], 1e-12)


def test_animate_omega_matches_jax():
    rng = np.random.default_rng(6)
    lev = np.linspace(100000.0, 20000.0, 6)
    lat, lon = np.linspace(-60.0, 60.0, 9), np.arange(16) * 22.5
    F = rng.standard_normal((6, 9, 16)) * 1e-16
    iP = {"BCs": ["fixed", "fixed", "periodic"], "printInfo": False}
    out = []
    for pkg, kw in ((xt, {"device": "cpu"}), (xv, {})):
        f = pkg.Field(F, ("lev", "lat", "lon"),
                      {"lev": lev, "lat": lat, "lon": lon})
        a = pkg.animate_iteration("omega", f, ["lev", "lat", "lon"],
                                  iParams=iP, loop_per_frame=2, max_frames=3,
                                  **kw)
        assert a.dims == ("iter", "lev", "lat", "lon")
        out.append(a.values)
    _close(out[0], out[1], 1e-12)


def test_rejections():
    f = _vor(xt)
    with pytest.raises(ValueError, match="trajectory"):
        xt.animate_iteration("Poisson", f, ["lat", "lon"], device="cpu",
                             iParams={"scheme": "direct"})
    with pytest.raises(ValueError, match="unsupported problem"):
        xt.animate_iteration("NotAProblem", f, ["lat", "lon"], device="cpu")
    with pytest.raises(ValueError, match="single slice"):
        xt.animate_iteration("Poisson", _vor(xt, batch=2), ["lat", "lon"],
                             device="cpu")
    with pytest.raises(ValueError, match="dims needed"):
        xt.animate_iteration("Poisson", f, ["lat"], device="cpu")
    js, omega = _poisson_spec()
    for scheme in ("direct", "gauss"):
        with pytest.raises(ValueError, match="trajectory"):
            tsolver.solve_trajectory(_port(js), torch.zeros(NY, NX), omega,
                                     scheme=scheme)
    assert xt.solve_trajectory is tsolver.solve_trajectory
    assert xt.animate_iteration is xt.models.api.animate_iteration
