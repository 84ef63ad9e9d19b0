# -*- coding: utf-8 -*-
"""The 15 ``invert_*_mg`` entry points and ``invert_MultiGrid`` of the
PyTorch port against their JAX twins, float64, the port on the CPU
(``device="cpu"``): the same NaN pattern, the field within 1e-8 max|S|,
equal cycles (``LAST_SOLVE.iters``) and the same converged verdict, at the
sizes of tests/test_mg.py, tests/test_mg_general.py and
tests/test_multigrid.py or smaller.  Also icbc with ``warmStart``, a
batched forcing, the two ValueErrors (a batch-varying mask, batch-varying
planes) and ``tolType='refined'`` on a batched forcing."""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from xinvert_tpu.field import Field as JField  # noqa: E402
from xinvert_tpu.models import api as japi  # noqa: E402
import xinvert_tpu_torch as xt  # noqa: E402
from xinvert_tpu_torch.models import api as tapi  # noqa: E402

FIELD_TOL = 1e-8


@pytest.fixture(autouse=True)
def f64():
    """The port builds its tensors in the default dtype: float64 here."""
    dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(dtype)


def _fields(vals, dims, coords):
    """The same values as a JAX-package Field and a port Field."""
    return (JField(vals, dims, coords), xt.Field(vals, dims, coords))


def _latlon(ny, nx, lat0, lat1, batch=0, seed=0, mask=False):
    lat = np.linspace(lat0, lat1, ny)
    lon = np.linspace(0.0, 360.0 - 360.0 / nx, nx)
    rng = np.random.default_rng(seed)
    shape = (batch, ny, nx) if batch else (ny, nx)
    v = (np.sin(3 * np.deg2rad(lon))[None, :]
         * np.cos(np.deg2rad(lat))[:, None]
         + 0.3 * rng.standard_normal(shape)) * 1e-5
    if mask:
        v[..., ny // 3:ny // 2, nx // 4:nx // 2] = np.nan
    dims = (("time",) if batch else ()) + ("lat", "lon")
    coords = {"lat": lat, "lon": lon}
    if batch:
        coords["time"] = np.arange(batch, dtype=np.float64)
    return _fields(v, dims, coords)


def _cart(ny, nx, Ly, Lx, vals, dims=("y", "x")):
    y = np.linspace(0.0, Ly, ny)
    x = np.linspace(0.0, Lx, nx)
    return _fields(vals(y[:, None], x[None, :]), dims,
                   {dims[0]: y, dims[1]: x})


def _case(name):
    """(entry name, (JAX field, port field), dims, kwargs) of a case."""
    if name == "Poisson":
        return ("invert_Poisson_mg",
                _latlon(33, 64, -60, 60, batch=2, mask=True), ["lat", "lon"],
                dict(iParams={"BCs": ["extend", "periodic"],
                              "undef": np.nan}, tol=1e-9))
    if name == "omega":
        nz, ny, nx = 7, 33, 64
        lev = np.linspace(100000.0, 10000.0, nz)
        lat = np.linspace(-60.0, 60.0, ny)
        lon = np.linspace(0.0, 360.0 - 360.0 / nx, nx)
        F = np.random.default_rng(1).normal(0, 1e-15, (nz, ny, nx))
        N2 = np.where(lev > 25000.0, 1.5e-5, 6e-5)
        coords = {"LEV": lev, "lat": lat, "lon": lon}
        jf, tf = _fields(F, ("LEV", "lat", "lon"), coords)
        return ("invert_omega_mg", (jf, tf), ["LEV", "lat", "lon"],
                dict(iParams={"BCs": ["fixed", "fixed", "periodic"]},
                     mParams={"N2": None}, n2=(N2, lev)))
    if name == "StommelMunk":
        Ly = 2 * np.pi * 1e6
        return ("invert_StommelMunk_mg", _cart(
            33, 65, Ly, 1e7,
            lambda y, x: -0.3 * np.sin(np.pi * y / Ly) * np.pi / Ly + 0 * x),
            ["y", "x"], dict(coords="cartesian",
                             iParams={"BCs": ["fixed", "fixed"]},
                             mParams={"beta": 1.8e-11, "R": 0.0008,
                                      "D": 200, "A4": 5e3}))
    rng = np.random.default_rng(0)
    if name == "PV2D":
        return ("invert_PV2D_mg", _cart(
            33, 48, 9000.0, 4.75e6,
            lambda y, x: rng.normal(0, 1e-9, (33, 48)), ("lev", "yc")),
            ["lev", "yc"], dict(coords="cartesian",
                                iParams={"BCs": ["fixed", "fixed"]},
                                mParams={"f0": 1e-4, "N2": 2e-4},
                                tol=1e-10))
    if name == "Eliassen":
        return ("invert_Eliassen_mg", _cart(
            33, 48, 9000.0, 4.75e6,
            lambda y, x: rng.normal(0, 1e-12, (33, 48)), ("lev", "yc")),
            ["lev", "yc"], dict(coords="cartesian",
                                iParams={"BCs": ["fixed", "fixed"]},
                                mParams={"A": 1e-6, "B": 1e-9, "C": 1e-4},
                                tol=1e-8))
    if name == "geostrophic":
        return ("invert_geostrophic_mg", _latlon(33, 64, 20, 60),
                ["lat", "lon"], dict(iParams={"BCs": ["fixed", "periodic"]},
                                     tol=1e-10))
    if name == "RefState":
        theta = np.linspace(300.0, 380.0, 33)
        r = np.linspace(10e3, 810e3, 41)
        Q = 1e-6 + 4e-6 * np.exp(-(r[None, :] / 150e3) ** 2) \
            * np.exp(-((theta[:, None] - 330.0) / 25.0) ** 2)
        return ("invert_RefState_mg",
                _fields(Q, ("theta", "r"), {"theta": theta, "r": r}),
                ["theta", "r"], dict(coords="cartesian",
                                     iParams={"BCs": ["fixed", "fixed"]},
                                     mParams={"Ang0": 2e5, "Gamma": 1e-6},
                                     tol=1e-6))
    if name == "Fofonoff":
        return ("invert_Fofonoff_mg", _cart(
            33, 65, 5e5, 6e5, lambda y, x: y - x), ["y", "x"],
            dict(coords="cartesian", iParams={"BCs": ["fixed", "fixed"]},
                 mParams={"f0": 1e-4, "beta": 2e-11, "c0": 8e-9,
                          "c1": 1e-4}, tol=1e-10))
    if name == "BrethertonHaidvogel":
        return ("invert_BrethertonHaidvogel_mg", _cart(
            33, 49, 1e6, 1.5e6,
            lambda y, x: 500 * np.exp(-((y - 5e5) / 2e5) ** 2
                                      - ((x - 7e5) / 3e5) ** 2)),
            ["y", "x"], dict(coords="cartesian",
                             iParams={"BCs": ["fixed", "fixed"]},
                             mParams={"f0": 1e-4, "beta": 2e-11,
                                      "D": 1000.0, "lambda": 1e-12},
                             tol=1e-10))
    if name == "GillMatsuno_test":
        return ("invert_GillMatsuno_test_mg", _latlon(33, 64, -64, 64),
                ["lat", "lon"], dict(iParams={"BCs": ["fixed", "periodic"]},
                                     mParams={"epsilon": 7e-5,
                                              "Phi": 5000.0}, tol=1e-8))
    if name == "Stommel_test":
        lat = np.linspace(15, 60, 33)
        lon = np.linspace(0, 60, 64)
        return ("invert_Stommel_test_mg", _fields(
            rng.normal(0, 1e-7, (33, 64)), ("lat", "lon"),
            {"lat": lat, "lon": lon}), ["lat", "lon"],
            dict(iParams={"BCs": ["fixed", "fixed"]},
                 mParams={"f0": 1e-4, "R": 5e-3, "D": 200.0,
                          "rho0": 1027.0}, tol=1e-8))
    if name == "GillMatsuno":
        return ("invert_GillMatsuno_mg", _latlon(33, 64, -60, 60),
                ["lat", "lon"], dict(iParams={"BCs": ["fixed", "periodic"]},
                                     mParams={"epsilon": 1e-5,
                                              "Phi": 5000.0}, tol=1e-7))
    if name == "Stommel":
        return ("invert_Stommel_mg", _cart(
            33, 64, 6e6, 1e7,
            lambda y, x: -1e-7 * np.sin(np.pi * y / 6e6) + 0 * x),
            ["y", "x"], dict(coords="cartesian",
                             iParams={"BCs": ["fixed", "fixed"]},
                             mParams={"R": 2e-4, "D": 100.0,
                                      "beta": 2e-11}, tol=1e-8))
    if name == "StommelArons":
        lat = np.linspace(-60.0, 60.0, 36)
        lon = np.linspace(0.0, 360.0 - 360.0 / 72, 72)
        return ("invert_StommelArons_mg", _fields(
            np.random.default_rng(2).normal(0.0, 1e-6, (36, 72)),
            ("lat", "lon"),
            {"lat": lat, "lon": lon}), ["lat", "lon"],
            dict(iParams={"BCs": ["fixed", "periodic"]},
                 mParams={"epsilon": 7e-6}))
    if name == "3DOcean":
        nz, ny, nx = 6, 20, 30
        coords = {"LEV": np.linspace(0.0, 2100.0, nz),
                  "lat": np.linspace(-60.0, 60.0, ny),
                  "lon": np.linspace(0.0, 360.0 - 360.0 / nx, nx)}
        return ("invert_3DOcean_mg", _fields(
            rng.normal(0.0, 1e-11, (nz, ny, nx)), ("LEV", "lat", "lon"),
            coords), ["LEV", "lat", "lon"],
            dict(iParams={"BCs": ["fixed", "extend", "periodic"]},
                 mParams={"epsilon": 7e-6, "k": 1e-5, "N2": 1e-5},
                 tol=1e-7))
    raise KeyError(name)


def _compare(jout, tout, jres, tres, tol):
    a, b = np.asarray(jout.values), np.asarray(tout.values)
    assert tout.dims == jout.dims and b.shape == a.shape
    np.testing.assert_array_equal(np.isnan(b), np.isnan(a))
    ok = ~np.isnan(a)
    assert np.abs(b[ok] - a[ok]).max() <= FIELD_TOL * np.abs(a[ok]).max()
    assert int(np.max(tres.iters)) == int(np.max(jres.iters))
    assert (float(tres.rel_change) < tol) == (float(jres.rel_change) < tol)


ENTRIES = ["Poisson", "omega", "StommelMunk", "PV2D", "Eliassen",
           "geostrophic", "RefState", "Fofonoff", "BrethertonHaidvogel",
           "GillMatsuno_test", "Stommel_test", "GillMatsuno", "Stommel",
           "StommelArons", "3DOcean"]


@pytest.mark.parametrize("name", ENTRIES)
def test_mg_entry_matches_jax(name):
    entry, (jf, tf), dims, kw = _case(name)
    if "n2" in kw:                       # the N2 profile as a Field of LEV
        N2, lev = kw.pop("n2")
        kw["mParams"] = {"N2": JField(N2, ("LEV",), {"LEV": lev})}
        kw_t = dict(kw, mParams={"N2": xt.Field(N2, ("LEV",), {"LEV": lev})})
    else:
        kw_t = kw
    tol = kw.get("tol", getattr(japi, entry).__defaults__[-2])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jout = getattr(japi, entry)(jf, dims=dims, **kw)
        jres = japi.LAST_SOLVE
        tout = getattr(xt, entry)(tf, dims=dims, device="cpu", **kw_t)
    tres = tapi.LAST_SOLVE
    assert isinstance(tres.S, torch.Tensor) and tres.S.device.type == "cpu"
    _compare(jout, tout, jres, tres, tol)


def test_poisson_mg_icbc_warm_start():
    """icbc with warmStart: the Dirichlet data ride in unchanged and the
    warm start replaces full multigrid, as in the JAX package."""
    jf, tf = _latlon(33, 64, -60, 60, seed=4)
    ic = np.cos(np.deg2rad(jf.coords["lat"]))[:, None] * np.ones((1, 64))
    jic, tic = _fields(ic * 1e4, ("lat", "lon"),
                       {"lat": jf.coords["lat"], "lon": jf.coords["lon"]})
    iP = {"BCs": ["fixed", "periodic"], "warmStart": True}
    jout = japi.invert_Poisson_mg(jf, ["lat", "lon"], icbc=jic, iParams=iP)
    jres = japi.LAST_SOLVE
    tout = xt.invert_Poisson_mg(tf, ["lat", "lon"], icbc=tic, iParams=iP,
                                device="cpu")
    _compare(jout, tout, jres, tapi.LAST_SOLVE, 1e-8)
    np.testing.assert_array_equal(tout.values[0], ic[0] * 1e4)


def test_multigrid_cascade_matches_jax():
    """invert_MultiGrid over the SOR inverter, coarse to fine."""
    jf, tf = _latlon(33, 64, -80, 80, seed=5)
    iP = {"BCs": ["fixed", "periodic"], "tolerance": 1e-10}
    jout = japi.invert_MultiGrid(japi.invert_Poisson, jf, ["lat", "lon"],
                                 ratios=(4, 2, 1), mxLoop=2000, iParams=iP)
    tout = xt.invert_MultiGrid(xt.invert_Poisson, tf, ["lat", "lon"],
                               ratios=(4, 2, 1), mxLoop=2000, iParams=iP,
                               device="cpu")
    a, b = np.asarray(jout.values), np.asarray(tout.values)
    assert b.shape == a.shape
    assert np.abs(b - a).max() <= FIELD_TOL * np.abs(a).max()


def test_mg_refusals():
    """A batch-varying mask and batch-varying planes raise ValueError (use
    the SOR inverter); tolType='refined' runs the multigrid-backed
    refinement on a batched forcing and certifies the tolerance."""
    _, tf = _latlon(33, 64, -80, 80, batch=2, mask=True)
    v = tf.values.copy()
    v[1, 2, 3] = np.nan
    varying = xt.Field(v, tf.dims, tf.coords)
    iP = {"BCs": ["extend", "periodic"], "undef": np.nan}
    with pytest.raises(ValueError, match="batch-invariant mask"):
        xt.invert_Poisson_mg(varying, ["lat", "lon"], iParams=iP,
                             device="cpu")
    theta = np.linspace(300.0, 380.0, 17)
    r = np.linspace(10e3, 810e3, 21)
    Q = 1e-6 + np.random.default_rng(6).random((2, 17, 21)) * 1e-6
    pv = xt.Field(Q, ("t", "theta", "r"),
                  {"t": np.arange(2.0), "theta": theta, "r": r})
    with pytest.raises(ValueError, match="single PV slice"):
        xt.invert_RefState_mg(pv, ["theta", "r"], coords="cartesian",
                              iParams={"BCs": ["fixed", "fixed"]},
                              mParams={"Ang0": 2e5, "Gamma": 1e-6},
                              device="cpu")
    out = xt.invert_Poisson_mg(tf, ["lat", "lon"], tol=1e-9,
                               iParams=dict(iP, tolType="refined"),
                               device="cpu")
    assert np.array_equal(np.isnan(out.values), np.isnan(tf.values))
    assert tapi.LAST_REFINE.rel_residual.shape == (2,)
    assert float(tapi.LAST_REFINE.rel_residual.max()) <= 1e-9


def test_mg_entries_default_to_the_card():
    """With no device argument an entry runs on the CUDA card, and without
    one it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: tests/test_torch_cuda.py")
    _, tf = _latlon(33, 64, -80, 80)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        xt.invert_Poisson_mg(tf, ["lat", "lon"])
