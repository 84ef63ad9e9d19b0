# -*- coding: utf-8 -*-
"""The 3-D slice end to end: xinvert_tpu_torch.invert_omega, invert_3DOcean,
inv_standard3D and inv_general3D against xinvert_tpu's, float64 on the CPU
(device="cpu"; the entry points run on the GPU by default).  Same NaN
pattern, equal LAST_SOLVE.iters / .overflow, values within
1e-12 * max|S| (XLA on the CPU may contract an FMA, so exact equality is
not asked for); _check_N2 raises as the JAX package's does."""
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

DATA = "Data/atmos3d_like.nc"
DIMS = ["LEV", "lat", "lon"]


@pytest.fixture
def f64():
    dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(dtype)


def _kw(pkg):
    """The CPU request for the port; the JAX package takes no device."""
    return {"device": "cpu"} if pkg is xt else {}


def _compare(a, b, res_j=None, res_t=None):
    """Fields a (JAX) and b (port), and their solves' telemetry: the
    ``LAST_SOLVE`` of the invert_* entry points unless given."""
    assert a.dims == b.dims and a.shape == b.shape
    na, nb = np.isnan(a.values), np.isnan(b.values)
    np.testing.assert_array_equal(nb, na)
    va, vb = a.values[~na], b.values[~na]
    scale = np.abs(va).max()
    assert scale > 0
    np.testing.assert_allclose(vb, va, rtol=0, atol=1e-12 * scale)
    res_j = japi.LAST_SOLVE if res_j is None else res_j
    res_t = tapi.LAST_SOLVE if res_t is None else res_t
    np.testing.assert_array_equal(res_t.iters.numpy(),
                                  np.asarray(res_j.iters))
    np.testing.assert_array_equal(res_t.overflow.numpy(),
                                  np.asarray(res_j.overflow))


@pytest.fixture
def core_solves(monkeypatch):
    """The inv_* entries keep no LAST_SOLVE: record the result of the solve
    each package's core runs, keyed by package."""
    import xinvert_tpu.core as jcore
    import xinvert_tpu_torch.core as tcore
    seen = {}
    for key, mod in (("jax", jcore), ("torch", tcore)):
        def rec(*a, _solve=mod.solve, _key=key, **kw):
            seen[_key] = _solve(*a, **kw)
            return seen[_key]
        monkeypatch.setattr(mod, "solve", rec)
    return seen


# ------------------------------------------------------------ invert_omega


@pytest.mark.parametrize("icbc", [False, True])
def test_invert_omega_matches_jax(f64, icbc):
    """The omega fixture (37x72x144) with the N2 level profile, and with the
    lower-boundary pattern WBC as icbc."""
    iP = {"BCs": ["fixed", "fixed", "periodic"], "mxLoop": 60,
          "tolerance": 1e-12, "printInfo": False}

    def run(pkg):
        a = pkg.open_dataset(DATA)
        return pkg.invert_omega(a.F, dims=DIMS, mParams={"N2": a.N2prof},
                                icbc=a.WBC if icbc else None, iParams=iP,
                                **_kw(pkg))
    w_j, w_t = run(xv), run(xt)
    _compare(w_j, w_t)
    assert int(tapi.LAST_SOLVE.iters) == 60
    if icbc:                        # the imposed lower boundary is kept
        wbc = xt.open_dataset(DATA).WBC.values
        np.testing.assert_array_equal(w_t.values[-1], wbc[-1])


def test_invert_omega_stops_early_like_jax(f64):
    """A loose tolerance stops both packages at the same sweep."""
    iP = {"BCs": ["fixed", "fixed", "periodic"], "mxLoop": 400,
          "tolerance": 1e-3, "printInfo": False}

    def run(pkg):
        a = pkg.open_dataset(DATA)
        F = a.F.isel(lon=slice(0, 48))
        return pkg.invert_omega(F, dims=DIMS, mParams={"N2": a.N2prof},
                                iParams=iP, **_kw(pkg))
    w_j, w_t = run(xv), run(xt)
    _compare(w_j, w_t)
    assert int(tapi.LAST_SOLVE.iters) < 400


# ---------------------------------------------------------- invert_3DOcean


def _ocean(pkg, n2_field):
    """The masked 8x20x30 case of tests/test_ocean_workloads.py."""
    rng = np.random.default_rng(3)
    nz, ny, nx = 8, 20, 30
    lev = np.linspace(0.0, 2100.0, nz)
    lat = np.linspace(-60.0, 60.0, ny)
    lon = np.linspace(0.0, 360.0 - 360.0 / nx, nx)
    F = rng.normal(0.0, 1e-11, (nz, ny, nx))
    mask = np.ones((nz, ny, nx), bool)
    mask[:, 8:12, 10:16] = False
    Ff = pkg.Field(np.where(mask, F, np.nan), tuple(DIMS),
                   {"LEV": lev, "lat": lat, "lon": lon})
    N2 = 1e-5 * np.exp(-lev / 800.0) + 1e-7
    if n2_field:
        N2 = pkg.Field(N2, ("LEV",), {"LEV": lev})
    iP = {"BCs": ["fixed", "extend", "periodic"], "undef": np.nan,
          "tolerance": 1e-8, "mxLoop": 300, "printInfo": False}
    return pkg.invert_3DOcean(Ff, dims=DIMS, iParams=iP,
                              mParams={"epsilon": 7e-6, "k": 1e-5, "N2": N2},
                              **_kw(pkg))


@pytest.mark.parametrize("n2_field", [True, False])
def test_invert_3docean_matches_jax(f64, n2_field):
    w_t = _ocean(xt, n2_field)
    w_j = _ocean(xv, n2_field)
    _compare(w_j, w_t)
    land = np.zeros(w_t.shape, bool)
    land[:, 8:12, 10:16] = True
    assert np.isnan(w_t.values[land]).all()
    assert np.isfinite(w_t.values[~land]).all()


def test_invert_3docean_n2_field_equals_array(f64):
    np.testing.assert_array_equal(_ocean(xt, True).values,
                                  _ocean(xt, False).values)


def test_invert_3docean_auto_omega(f64, capsys):
    """The 3-D ocean family takes omega = 1.4, not the grid-optimal factor
    (which diverges there), unless optArg is given."""
    f = xt.Field(np.ones((5, 6, 7)), tuple(DIMS),
                 {"LEV": np.arange(5.0), "lat": np.linspace(-30, 30, 6),
                  "lon": np.arange(7.0) * 50})
    iP = {"BCs": ["fixed", "extend", "periodic"], "mxLoop": 2,
          "printInfo": False, "debug": True}
    xt.invert_3DOcean(f, dims=DIMS, iParams=iP, device="cpu")
    assert "optArg     : 1.4\n" in capsys.readouterr().out
    xt.invert_omega(f, dims=DIMS, iParams=iP, device="cpu")
    assert "optArg     : 1.4\n" not in capsys.readouterr().out
    xt.invert_3DOcean(f, dims=DIMS, iParams=dict(iP, optArg=1.1),
                      device="cpu")
    assert "optArg     : 1.1\n" in capsys.readouterr().out


@pytest.mark.parametrize("N2,msg", [
    (np.array([np.nan, 1e-5, np.inf]), "infinite"),
    (np.array([1e-5, np.nan, 1e-5]), "infinite"),
    (np.array([1e-5, 2e-5, -1e-6]), "unstable"),
    (np.array([1e-5, 0.0, 1e-5]), "unstable"),
])
def test_check_n2_raises_like_jax(N2, msg):
    for api in (japi, tapi):
        with pytest.raises(ValueError, match=msg):
            api._check_N2({"N2": N2})
    # scalars, None and a first level that is not checked pass
    for ok in (None, {"N2": 2e-4}, {"N2": np.array([-1.0, 1e-5, 2e-5])}):
        tapi._check_N2(ok)
        japi._check_N2(ok)


# ------------------------------------------------- inv_standard3D / general


def _coeff_case(seed=2, shape=(7, 12, 16)):
    rng = np.random.default_rng(seed)
    nz, ny, nx = shape
    coords = {"z": np.arange(nz) * 50.0, "y": np.arange(ny) * 1e4,
              "x": np.arange(nx) * 1e4}
    pos = [np.abs(rng.normal(1.0, 0.1, shape)) + 0.5 for _ in range(3)]
    F = rng.normal(0.0, 1e-8, shape)
    F[2:4, 4:7, 5:9] = np.nan
    return rng, coords, pos, F


@pytest.mark.parametrize("with_icbc", [False, True])
def test_inv_standard3D_matches_jax(f64, core_solves, with_icbc):
    rng, coords, (A, B, C), F = _coeff_case()
    A = A * 1e-4
    ic = rng.normal(0.0, 1e-3, F.shape)
    iP = {"BCs": ["fixed", "extend", "periodic"], "mxLoop": 150,
          "tolerance": 1e-9}

    def run(pkg):
        fld = lambda a: pkg.Field(a, ("z", "y", "x"), coords)  # noqa: E731
        return pkg.inv_standard3D(
            fld(A), fld(B), fld(C), fld(F), ["z", "y", "x"],
            coords="cartesian", iParams=iP,
            icbc=fld(ic) if with_icbc else None, **_kw(pkg))
    _compare(run(xv), run(xt), core_solves["jax"], core_solves["torch"])
    assert int(core_solves["torch"].iters) < 150              # stops early


def test_inv_general3D_matches_jax(f64, core_solves):
    rng, coords, (A, B, C), H = _coeff_case(seed=4)
    A = A * 1e-4
    D, E, Fc = (rng.normal(0, 1e-6, H.shape) for _ in range(3))
    G = -np.abs(rng.normal(1e-10, 1e-11, H.shape))
    iP = {"BCs": ["fixed", "extend", "fixed"], "mxLoop": 150,
          "tolerance": 1e-9, "optArg": 1.5}

    def run(pkg):
        fld = lambda a: pkg.Field(a, ("z", "y", "x"), coords)  # noqa: E731
        return pkg.inv_general3D(
            fld(A), fld(B), fld(C), fld(D), fld(E), fld(Fc), fld(G), fld(H),
            ["z", "y", "x"], coords="cartesian", iParams=iP, **_kw(pkg))
    _compare(run(xv), run(xt), core_solves["jax"], core_solves["torch"])


def test_3d_entry_points_default_to_the_card(f64):
    """Without a device argument the 3-D entry points run on CUDA; with no
    CUDA they raise instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the calls would run on it")
    _, coords, (A, B, C), F = _coeff_case(shape=(5, 6, 7))
    fld = lambda a: xt.Field(a, ("z", "y", "x"), coords)  # noqa: E731
    f = xt.Field(F, tuple(DIMS), {"LEV": coords["z"],
                                  "lat": np.linspace(-30, 30, 6),
                                  "lon": coords["x"] / 1e5})
    calls = [
        lambda **kw: xt.invert_omega(f, dims=DIMS, **kw),
        lambda **kw: xt.invert_3DOcean(f, dims=DIMS, **kw),
        lambda **kw: xt.inv_standard3D(fld(A), fld(B), fld(C), fld(F),
                                       ["z", "y", "x"], coords="cartesian",
                                       **kw),
        lambda **kw: xt.inv_general3D(fld(A), fld(B), fld(C), 0.0, 0.0, 0.0,
                                      0.0, fld(F), ["z", "y", "x"],
                                      coords="cartesian", **kw),
    ]
    iP = {"BCs": ["fixed", "extend", "periodic"], "mxLoop": 3,
          "printInfo": False}
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call(iParams=iP)
        out = call(iParams=iP, device="cpu")
        assert out.shape == F.shape
