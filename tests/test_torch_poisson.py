# -*- coding: utf-8 -*-
"""The slice end to end: xinvert_tpu_torch.invert_Poisson and inv_standard2D
against xinvert_tpu's, float64 on the CPU.  Same NaN pattern, values at
rtol 1e-10, equal LAST_SOLVE.iters / .overflow; ``scheme='lexico'`` with a
mesh equal to the meshless call under every option.  The port's entry points run on the GPU
unless asked for the CPU: every call here passes device="cpu", and one test
checks that a call without it raises on a machine without CUDA."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread keeps the parallel test workers from
# oversubscribing the cores (spinning OpenMP threads stall the others)
torch.set_num_threads(1)

import xinvert_tpu as xv  # noqa: E402
from xinvert_tpu.models import api as japi  # noqa: E402
import xinvert_tpu_torch as xt  # noqa: E402
from xinvert_tpu_torch.models import api as tapi  # noqa: E402

DATA = "Data/ocean_masked.nc"


CPU = {"device": "cpu"}


@pytest.fixture
def f64_cpu():
    """The port builds its tensors in the default dtype: float64 here,
    restored afterwards (the device is passed to each call)."""
    dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(dtype)


def _kw(pkg):
    """The CPU request for the port; the JAX package takes no device."""
    return CPU if pkg is xt else {}


def _compare_fields(a, b):
    assert a.dims == b.dims and a.shape == b.shape
    na, nb = np.isnan(a.values), np.isnan(b.values)
    np.testing.assert_array_equal(nb, na)
    va, vb = a.values[~na], b.values[~na]
    np.testing.assert_allclose(vb, va, rtol=1e-10,
                               atol=1e-10 * np.abs(va).max())


def _compare_last_solve():
    np.testing.assert_array_equal(tapi.LAST_SOLVE.iters.numpy(),
                                  np.asarray(japi.LAST_SOLVE.iters))
    np.testing.assert_array_equal(tapi.LAST_SOLVE.overflow.numpy(),
                                  np.asarray(japi.LAST_SOLVE.overflow))


def test_ocean_fixture_matches_jax(f64_cpu):
    iP = {"BCs": ["extend", "periodic"], "undef": np.nan, "mxLoop": 300,
          "tolerance": 1e-11, "printInfo": False}
    sf_j = xv.invert_Poisson(xv.open_dataset(DATA).vor, dims=["lat", "lon"],
                             iParams=iP)
    vor = xt.open_dataset(DATA).vor
    sf_t = xt.invert_Poisson(vor, dims=["lat", "lon"], iParams=iP, **CPU)
    _compare_fields(sf_j, sf_t)
    _compare_last_solve()
    assert int(tapi.LAST_SOLVE.iters) == 300      # runs to the cap
    land = np.isnan(vor.values)
    assert land.any() and np.isnan(sf_t.values[land]).all()
    assert np.isfinite(sf_t.values[~land]).all()


def _synthetic(Field, nb=3, ny=37, nx=72, seed=0):
    rng = np.random.default_rng(seed)
    lat = np.linspace(-88.75, 88.75, ny)
    lon = np.linspace(0.0, 360.0 - 360.0 / nx, nx)
    llat, llon = np.deg2rad(lat)[:, None], np.deg2rad(lon)[None, :]
    vor = (np.sin(3 * llon) * np.cos(2 * llat)
           + 0.1 * rng.standard_normal((nb, ny, nx))) * 1e-5
    vor[:, ny // 3:ny // 2, nx // 4:nx // 2] = np.nan
    # (lat, time, lon) order: the batch dim is not leading
    vals = np.transpose(vor, (1, 0, 2))
    return Field(vals, ("lat", "time", "lon"),
                 {"lat": lat, "lon": lon, "time": np.arange(nb)})


def test_batched_synthetic_matches_jax(f64_cpu):
    iP = {"BCs": ["extend", "periodic"], "undef": np.nan, "mxLoop": 2000,
          "tolerance": 1e-6, "printInfo": False}
    sf_j = xv.invert_Poisson(_synthetic(xv.Field), dims=["lat", "lon"],
                             iParams=iP)
    sf_t = xt.invert_Poisson(_synthetic(xt.Field), dims=["lat", "lon"],
                             iParams=iP, **CPU)
    _compare_fields(sf_j, sf_t)
    _compare_last_solve()
    iters = tapi.LAST_SOLVE.iters.numpy()
    assert iters.shape == (3,) and (iters < 2000).all()      # stops early


@pytest.mark.parametrize("warm", [False, True])
def test_icbc_matches_jax(f64_cpu, warm):
    """icbc: the reference's boundary/undef initial state, or (warmStart)
    a warm start everywhere; the output keeps icbc values where undefined."""
    iP = {"BCs": ["fixed", "periodic"], "undef": np.nan, "mxLoop": 60,
          "tolerance": 1e-12, "printInfo": False, "warmStart": warm}

    def run(pkg):
        f = _synthetic(pkg.Field, nb=2)
        ic = pkg.Field(np.full(f.shape, 2e4), f.dims, f.coords)
        return pkg.invert_Poisson(f, dims=["lat", "lon"], icbc=ic,
                                  iParams=iP, **_kw(pkg))
    sf_j, sf_t = run(xv), run(xt)
    _compare_fields(sf_j, sf_t)
    _compare_last_solve()
    assert not np.isnan(sf_t.values).any()


def test_print_info_and_debug(f64_cpu, capsys):
    iP = {"BCs": ["extend", "periodic"], "mxLoop": 40, "tolerance": 1e-3,
          "printInfo": True, "debug": True}
    xt.invert_Poisson(_synthetic(xt.Field, nb=2), dims=["lat", "lon"],
                      iParams=iP, **CPU)
    out = capsys.readouterr().out
    assert sum(ln.startswith("loops") for ln in out.splitlines()) == 2
    assert "optArg" in out


@pytest.mark.parametrize("with_icbc", [False, True])
def test_inv_standard2D_matches_jax(f64_cpu, with_icbc):
    rng = np.random.default_rng(2)
    ny, nx = 30, 40
    y = np.arange(ny) * 1e4
    x = np.arange(nx) * 1e4
    A = np.abs(rng.normal(1.0, 0.1, (ny, nx))) + 0.5
    B = rng.normal(0.0, 0.05, (ny, nx))
    C = np.abs(rng.normal(1.0, 0.1, (ny, nx))) + 0.5
    F = rng.normal(0.0, 1e-8, (ny, nx))
    F[10:14, 5:12] = np.nan
    ic = rng.normal(0.0, 1e-3, (ny, nx))
    iP = {"BCs": ["fixed", "fixed"], "mxLoop": 500, "tolerance": 1e-9}

    def run(pkg):
        coords = {"y": y, "x": x}
        f = pkg.Field(F, ("y", "x"), coords)
        return pkg.inv_standard2D(
            pkg.Field(A, ("y", "x"), coords), pkg.Field(B, ("y", "x"), coords),
            pkg.Field(C, ("y", "x"), coords), f, ["y", "x"],
            coords="cartesian", iParams=iP,
            icbc=pkg.Field(ic, ("y", "x"), coords) if with_icbc else None,
            **_kw(pkg))
    sf_j, sf_t = run(xv), run(xt)
    _compare_fields(sf_j, sf_t)
    if with_icbc:       # icbc values kept on the undefined block and edges
        assert np.array_equal(sf_t.values[10:14, 5:12], ic[10:14, 5:12])
        assert np.array_equal(sf_t.values[0], ic[0])


def _cpu_mesh():
    from xinvert_tpu_torch.parallel import make_grid_mesh
    return make_grid_mesh(devices=[torch.device("cpu")] * 2)


@pytest.mark.parametrize("iParams", [
    {"scheme": "lexico", "tolType": "refined"},
    {"scheme": "lexico", "tolType": "residual"},
    {"scheme": "lexico", "streamChunk": 2},
    {"scheme": "lexico", "checkEvery": 4},
    {"scheme": "lexico", "optArg": 1.2},
    {"scheme": "lexico"},
])
def test_unported_options_raise(f64_cpu, iParams):
    """``scheme='lexico'`` on ``iParams['mesh']`` was the last option not
    ported (ROADMAP queue C fault 7).  It now solves whole, as the JAX
    package's GSPMD run does, whatever it is combined with: the call with
    a mesh gives the meshless call's field and iters exactly, and nothing
    raises."""
    f = _synthetic(xt.Field, nb=1)
    iP = dict(iParams, printInfo=False)
    ref = xt.invert_Poisson(f, dims=["lat", "lon"], iParams=iP, **CPU)
    iters = tapi.LAST_SOLVE.iters.clone()
    out = xt.invert_Poisson(f, dims=["lat", "lon"],
                            iParams=dict(iP, mesh=_cpu_mesh()), **CPU)
    assert torch.equal(tapi.LAST_SOLVE.iters, iters)
    np.testing.assert_array_equal(out.values, ref.values)


def test_default_dtype_float32(f64_cpu):
    torch.set_default_dtype(torch.float32)
    xt.invert_Poisson(_synthetic(xt.Field, nb=1), dims=["lat", "lon"],
                      iParams={"BCs": ["extend", "periodic"], "mxLoop": 20,
                               "printInfo": False}, **CPU)
    assert tapi.LAST_SOLVE.S.dtype == torch.float32
    assert tapi.LAST_SOLVE.S.device.type == "cpu"     # as the call asked


@pytest.mark.parametrize("entry", ["invert_Poisson", "inv_standard2D"])
def test_default_device_is_the_card(f64_cpu, entry):
    """Without a device argument an entry point runs on CUDA; on a machine
    without CUDA it raises and says how to ask for the CPU, rather than
    carrying on there.  PyTorch's default device is not consulted."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the call would run on it")
    f = _synthetic(xt.Field, nb=1).isel(time=0)
    iP = {"BCs": ["extend", "periodic"], "mxLoop": 20, "printInfo": False}
    if entry == "invert_Poisson":
        args = (f, ["lat", "lon"])
    else:
        one = xt.Field(np.ones(f.shape), f.dims, f.coords)
        args = (one, 0.0, one, f, ["lat", "lon"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(xt, entry)(*args, iParams=iP)
    out = getattr(xt, entry)(*args, iParams=iP, **CPU)
    assert out.shape == f.shape
    assert np.isfinite(out.values[~np.isnan(f.values)]).all()
