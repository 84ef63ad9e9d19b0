# -*- coding: utf-8 -*-
"""The finite differences (``xinvert_tpu_torch.fd``), ``cal_flow`` and
``loop_noncore`` of the PyTorch port against the JAX package's.  Both run
in numpy on host Fields (the port's ``fd.py`` is a copy), so every result
is held with ``np.array_equal``: ``padBCs`` under each boundary condition,
``deriv`` in its three schemes, ``deriv2``, the FiniteDiff operators
(grad, divg, vort, curl, Laplacian, the strains and Okubo-Weiss) on a
lat-lon and a cartesian grid, and ``cal_flow``'s four coordinate types and
its Gill-Matsuno winds."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import xinvert_tpu as xv  # noqa: E402
import xinvert_tpu_torch as xt  # noqa: E402


def _same(a, b):
    """Two Fields (or tuples of them) with equal dims, coords and values."""
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    assert a.dims == b.dims
    for d in a.dims:
        if d in a.coords:
            assert np.array_equal(a.coords[d], b.coords[d])
    assert np.array_equal(np.asarray(a.values), np.asarray(b.values),
                          equal_nan=True)


def _field(pkg, dims, coords, seed=0, smooth=True):
    rng = np.random.default_rng(seed)
    shape = tuple(len(coords[d]) for d in dims)
    grids = np.meshgrid(*[np.asarray(coords[d], float) for d in dims],
                        indexing="ij")
    vals = np.ones(shape)
    for k, g in enumerate(grids):
        span = np.ptp(g) or 1.0
        vals = vals * np.sin((k + 2) * np.pi * (g - g.min()) / span + k)
    if not smooth:
        vals = vals + 0.1 * rng.standard_normal(shape)
    return pkg.Field(vals, tuple(dims), {d: coords[d] for d in dims})


LATLON = {"time": np.arange(2.0), "lat": np.linspace(-80.0, 80.0, 17),
          "lon": np.arange(0.0, 360.0, 15.0)}
CART = {"y": np.linspace(0.0, 1e6, 13), "x": np.linspace(0.0, 2e6, 21)}


@pytest.mark.parametrize("dim,BCs,fill", [
    ("lon", ("fixed", "fixed"), (1, 1)), ("lat", ("extend", "fixed"), (2, 2)),
    ("lat", ("periodic", "periodic"), (0, 0)),
    ("lat", ("reflect", "extend"), (3, 3)), ("lon", "periodic", 0)])
def test_padbcs_equal(dim, BCs, fill):
    args = (("time", "lat", "lon"), LATLON)
    _same(xt.padBCs(_field(xt, *args), dim, BCs, fill),
          xv.padBCs(_field(xv, *args), dim, BCs, fill))


@pytest.mark.parametrize("scheme", ["center", "forward", "backward"])
@pytest.mark.parametrize("BCs", [("extend", "extend"), ("periodic",
                                                         "periodic"),
                                 ("fixed", "reflect")])
def test_deriv_equal(scheme, BCs):
    args = (("lat", "lon"), LATLON, 1, False)
    _same(xt.deriv(_field(xt, *args), "lon", BCs, scale=2.5, scheme=scheme),
          xv.deriv(_field(xv, *args), "lon", BCs, scale=2.5, scheme=scheme))
    _same(xt.deriv(_field(xt, *args), "lat", BCs, scheme=scheme),
          xv.deriv(_field(xv, *args), "lat", BCs, scheme=scheme))


@pytest.mark.parametrize("BCs", [("extend", "extend"), ("periodic",
                                                         "periodic")])
def test_deriv2_equal(BCs):
    args = (("lat", "lon"), LATLON, 2, False)
    _same(xt.deriv2(_field(xt, *args), "lon", BCs, scale=3.0),
          xv.deriv2(_field(xv, *args), "lon", BCs, scale=3.0))


@pytest.mark.parametrize("coords", ["lat-lon", "cartesian"])
def test_finitediff_operators_equal(coords):
    if coords == "lat-lon":
        dims, grid, mapping = (("time", "lat", "lon"), LATLON,
                               {"T": "time", "Y": "lat", "X": "lon"})
    else:
        dims, grid, mapping = ("y", "x"), CART, {"Y": "y", "X": "x"}
    out = []
    for pkg in (xt, xv):
        fd = pkg.FiniteDiff(mapping, BCs={"Y": "reflect", "X": "periodic"},
                            coords=coords)
        T = _field(pkg, dims, grid, 3, False)
        u, v = _field(pkg, dims, grid, 4), _field(pkg, dims, grid, 5) * 0.5
        Ty, Tx = fd.grad(T, dims=["Y", "X"])
        out.append((Ty, Tx, fd.curl(Tx, Ty), fd.divg([Tx, Ty], ["X", "Y"]),
                    fd.Laplacian(T, ["Y", "X"]), fd.vort(u=u, v=v),
                    fd.tension_strain(u, v), fd.shear_strain(u, v),
                    fd.deformation_rate(u, v), fd.Okubo_Weiss(u, v)))
    _same(out[0], out[1])


@pytest.mark.parametrize("coords,dims,grid,BCs", [
    ("lat-lon", ("lat", "lon"), LATLON, ("extend", "periodic")),
    ("z-lat", ("lev", "lat"),
     {"lev": np.linspace(1e5, 1e4, 9), "lat": np.linspace(-90, 90, 13)},
     ("fixed", "fixed")),
    ("z-lon", ("lev", "lon"),
     {"lev": np.linspace(1e5, 1e4, 9), "lon": np.arange(0.0, 360.0, 20.0)},
     ("fixed", "periodic")),
    ("cartesian", ("y", "x"), CART, ("fixed", "fixed"))])
@pytest.mark.parametrize("vtype", ["streamfunction", "velocitypotential"])
def test_cal_flow_equal(coords, dims, grid, BCs, vtype):
    _same(xt.cal_flow(_field(xt, dims, grid, 6), list(dims), coords=coords,
                      BCs=BCs, vtype=vtype),
          xv.cal_flow(_field(xv, dims, grid, 6), list(dims), coords=coords,
                      BCs=BCs, vtype=vtype))


@pytest.mark.parametrize("coords,dims,grid", [
    ("lat-lon", ("lat", "lon"), LATLON), ("cartesian", ("y", "x"), CART)])
def test_cal_flow_gillmatsuno_equal(coords, dims, grid):
    mP = {"epsilon": 1e-5, "f0": 1e-5, "beta": 2e-11}
    _same(xt.cal_flow(_field(xt, dims, grid, 7), list(dims), coords=coords,
                      vtype="gillmatsuno", mParams=mP),
          xv.cal_flow(_field(xv, dims, grid, 7), list(dims), coords=coords,
                      vtype="gillmatsuno", mParams=mP))
    _same(xt.cal_flow(_field(xt, dims, grid, 7), list(dims), coords=coords,
                      vtype="gillmatsuno"),
          xv.cal_flow(_field(xv, dims, grid, 7), list(dims), coords=coords,
                      vtype="gillmatsuno"))


def test_cal_flow_rejects_what_the_jax_package_rejects():
    f = _field(xt, ("lat", "lon"), LATLON)
    with pytest.raises(ValueError, match="vtype"):
        xt.cal_flow(f, ["lat", "lon"], vtype="nope")
    with pytest.raises(ValueError, match="coords"):
        xt.cal_flow(f, ["lat", "lon"], coords="polar")


@pytest.fixture
def f64_cpu():
    """The port builds its tensors in the default dtype: float64 here."""
    dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(dtype)


def test_cal_flow_of_a_port_solution(f64_cpu):
    """cal_flow of an invert_Poisson field of the port equals the JAX
    package's cal_flow of the same values."""
    vor = _field(xt, ("lat", "lon"), LATLON, 8) * 1e-5
    sf = xt.invert_Poisson(vor, ["lat", "lon"], device="cpu",
                           iParams={"BCs": ["extend", "periodic"],
                                    "mxLoop": 50, "printInfo": False})
    sf_j = xv.Field(sf.values, sf.dims, sf.coords)
    _same(xt.cal_flow(sf, ["lat", "lon"], BCs=("extend", "periodic")),
          xv.cal_flow(sf_j, ["lat", "lon"], BCs=("extend", "periodic")))


@pytest.mark.parametrize("dims", [["lat", "lon"], ["time", "lat", "lon"],
                                  ["lon"]])
def test_loop_noncore_equal(dims):
    fx = _field(xt, ("time", "lat", "lon"), LATLON)
    fv = _field(xv, ("time", "lat", "lon"), LATLON)
    a, b = list(xt.loop_noncore(fx, dims)), list(xv.loop_noncore(fv, dims))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert np.array_equal(x[k], y[k])
