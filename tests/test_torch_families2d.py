# -*- coding: utf-8 -*-
"""The 2-D inverter families of the PyTorch port against the JAX package,
float64 on the CPU:

- the three 2-D stencil compilers (standard_2d_e, general_2d centered and
  upwinded, general_2d_bih) and every 2-D builder, plane by plane at rtol
  1e-13, on lat-lon, z-lat and cartesian grids;
- the port's in-place gate ``sor2d._no_cross_r1`` against JAX's
  ``pallas_sor_window._no_cross_r1`` on every family's pruned spec;
- the twelve 2-D ``invert_*`` entry points and ``inv_standard2D_test``,
  ``inv_general2D``, ``inv_general2D_bih``: same NaN pattern, values at
  rtol 1e-10, equal LAST_SOLVE.iters and .overflow, at gallery sizes, on
  ``Data/soda_curl_like.nc`` coarsened and on synthetic cases;
- ``api._AUTO_OMEGA`` against the JAX table."""
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
from xinvert_tpu.models import api as japi  # noqa: E402
from xinvert_tpu.models import problems as jprob  # noqa: E402
from xinvert_tpu.models.params import default_mParams  # noqa: E402
from xinvert_tpu.ops import pallas_sor_window as win  # noqa: E402
import xinvert_tpu_torch as xt  # noqa: E402
from xinvert_tpu_torch import stencil as tst  # noqa: E402
from xinvert_tpu_torch.grid import Grid as TGrid  # noqa: E402
from xinvert_tpu_torch.models import api as tapi  # noqa: E402
from xinvert_tpu_torch.models import problems as tprob  # noqa: E402
from xinvert_tpu_torch.ops import sor2d  # noqa: E402

RTOL = 1e-13
SODA = "Data/soda_curl_like.nc"


@pytest.fixture
def f64_cpu():
    """The port builds its tensors in the default dtype: float64 here."""
    dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(dtype)


def _assert_same_spec(js, ts):
    assert tuple(ts.offsets) == tuple(js.offsets)
    assert ts.bcs == tuple(js.bcs)
    assert ts.bih == js.bih
    assert ts.stop_on_zero_norm == js.stop_on_zero_norm
    np.testing.assert_array_equal(ts.active.numpy(), np.asarray(js.active))
    for name in ("w", "w0", "g", "relax"):
        a, b = getattr(ts, name).numpy(), np.asarray(getattr(js, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=0, err_msg=name)


# ------------------------------------------------------- stencil compilers


def _planes(ny=14, nx=18, seed=21):
    rng = np.random.default_rng(seed)
    pos = [np.abs(rng.normal(1.0, 0.1, (ny, nx))) + 0.5 for _ in range(3)]
    small = [rng.normal(0, 1e-3, (ny, nx)) for _ in range(8)]
    F = rng.normal(0, 1.0, (2, ny, nx))
    Fdef = np.ones((ny, nx), bool)
    Fdef[4:7, 5:9] = False
    return pos, small, F, Fdef


@pytest.mark.parametrize("family", ["standard_e", "general", "general_up",
                                    "general_up_plane", "bih"])
@pytest.mark.parametrize("bcs", [("extend", "periodic"), ("fixed", "fixed")])
def test_2d_family_planes(family, bcs):
    (A, C, D), small, F, Fdef = _planes()
    deltas = (1.1e5, 1.0e5)
    j, t = jnp.asarray, torch.as_tensor
    if family == "standard_e":
        args = (A, small[0], small[1], D, small[2], F, Fdef)
        js = jst.standard_2d_e(*map(j, args), deltas, bcs)
        ts = tst.standard_2d_e(*map(t, args), deltas, bcs)
    elif family.startswith("general"):
        args = (A, small[0], C, small[1], small[2], -np.abs(small[3]), F,
                Fdef)
        up = {"general": 0.0, "general_up": -1.0}.get(family)
        ju = tu = up
        if up is None:           # a per-cell sign plane
            plane = np.where(np.random.default_rng(2).random(A.shape) > 0.5,
                             1.0, -1.0)
            ju, tu = j(plane), t(plane)
        js = jst.general_2d(*map(j, args), deltas, bcs, upwind=ju)
        ts = tst.general_2d(*map(t, args), deltas, bcs, upwind=tu)
    else:
        args = (A, small[0], C, small[1], small[2], small[3], small[4],
                small[5], small[6], F, Fdef)
        js = jst.general_2d_bih(*map(j, args), deltas, bcs)
        ts = tst.general_2d_bih(*map(t, args), deltas, bcs)
    _assert_same_spec(js, ts)
    assert len(ts.offsets) == (16 if family == "bih" else 8)


# ----------------------------------------------------------- the builders


def _grids(coords_type, bcs, ny=13, nx=20):
    if coords_type == "lat-lon":
        axes = (np.linspace(-80.0, 80.0, ny),
                np.linspace(0.0, 360.0 - 360.0 / nx, nx))
        dims = ("lat", "lon")
    elif coords_type == "z-lat":
        axes = (np.linspace(100000.0, 10000.0, ny),
                np.linspace(-60.0, 60.0, nx))
        dims = ("lev", "lat")
    else:
        axes = (np.arange(ny) * 5e4 + 1e5, np.arange(nx) * 5e4 + 2e5)
        dims = ("y", "x")
    return (JGrid.make(dims, axes, coords_type, bcs=bcs),
            TGrid.make(dims, axes, coords_type, bcs=bcs))


# (problem, coords, extra mParams, batched forcing)
BUILDER_CASES = [
    ("refstate", "cartesian", {"Gamma": 1e-6, "Ang0": 2e5}, False),
    ("refstate", "z-lat", {"Gamma": 1e-6}, False),
    ("pv2d", "z-lat", {}, True),
    ("eliassen", "z-lat", "ABC", True),
    ("gillmatsuno", "lat-lon", {"Phi": 5000, "epsilon": 1e-5}, True),
    ("gillmatsuno", "cartesian", {}, True),
    ("gillmatsuno_test", "lat-lon", {"Phi": 5000, "epsilon": 1e-5}, True),
    ("gillmatsuno_test", "cartesian", {}, False),
    ("stommel", "lat-lon", {"R": 2e-4}, True),
    ("stommel", "cartesian", {}, False),
    ("stommel_test", "lat-lon", {}, True),
    ("stommel_test", "cartesian", {}, False),
    ("stommelmunk", "lat-lon", {"A4": 5e3}, True),
    ("stommelmunk", "cartesian", {"A4": 5e3}, False),
    ("stommelarons", "lat-lon", {"epsilon": 1e-5}, True),
    ("stommelarons", "cartesian", {}, False),
    ("geostrophic", "lat-lon", {}, True),
    ("geostrophic", "cartesian", {}, False),
    ("brethertonhaidvogel", "cartesian", {}, True),
    ("brethertonhaidvogel", "lat-lon", {}, False),
    ("fofonoff", "cartesian", {}, True),
    ("fofonoff", "lat-lon", {}, False),
]


def _builder_inputs(problem, coords_type, extra, batched, bcs):
    jg, tg = _grids(coords_type, bcs)
    rng = np.random.default_rng(sum(map(ord, problem + coords_type)))
    shape = ((2,) if batched else ()) + jg.shape
    vals = rng.normal(0.0, 1e-7, shape)
    if problem == "refstate":
        vals = 1e-6 + np.abs(vals)
    Fdef = np.ones(jg.shape, bool)
    Fdef[4:7, 6:11] = False
    mp = dict(default_mParams)
    if extra == "ABC":         # core-rank coefficient planes, as _resolve_mp
        for k, lo in zip("ABC", (1.0, -0.1, 1.0)):
            mp[k] = lo + 0.05 * rng.standard_normal(jg.shape)
    else:
        mp.update(extra)
    return jg, tg, vals, Fdef, mp


def _both_specs(problem, coords_type, extra, batched, bcs):
    jg, tg, vals, Fdef, mp = _builder_inputs(problem, coords_type, extra,
                                             batched, bcs)
    js = jprob.BUILDERS[problem](jnp.asarray(vals), jnp.asarray(Fdef), jg, mp)
    ts = tprob.BUILDERS[problem](torch.as_tensor(vals),
                                 torch.as_tensor(Fdef), tg, mp)
    return js, ts


@pytest.mark.parametrize("problem,coords_type,extra,batched", BUILDER_CASES)
def test_builder_planes(problem, coords_type, extra, batched):
    js, ts = _both_specs(problem, coords_type, extra, batched,
                         ("extend", "periodic"))
    _assert_same_spec(js, ts)
    assert ts.w.dtype == torch.float64


@pytest.mark.parametrize("switch", [False, True])
def test_no_cross_r1_matches_jax_on_pruned_specs(monkeypatch, switch):
    """The in-place gate, on the spec solve hands the sweeps (pruned):
    radius-1 families without cross terms are eligible; cross terms,
    separate-cross (+E psi) families with nonzero cross planes and the
    biharmonic family are not."""
    monkeypatch.setattr(win, "INPLACE_KERNEL", switch)
    monkeypatch.setattr(sor2d, "INPLACE_KERNEL", switch)
    eligible = set()
    for problem, coords_type, extra, batched in BUILDER_CASES:
        js, ts = _both_specs(problem, coords_type, extra, batched,
                             ("extend", "periodic"))
        js, ts = jst.prune_zero_offsets(js), tst.prune_zero_offsets(ts)
        assert ts.offsets == tuple(js.offsets), problem
        got = sor2d._no_cross_r1(ts)
        assert got == win._no_cross_r1(js), (problem, coords_type)
        if got:
            eligible.add(problem)
    assert eligible == (set() if not switch else {
        "refstate", "pv2d", "gillmatsuno", "stommel", "stommelarons",
        "geostrophic", "brethertonhaidvogel", "fofonoff"})


def test_auto_omega_matches_jax():
    assert tapi._AUTO_OMEGA == japi._AUTO_OMEGA


# ------------------------------------------------------ the entry points


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


def _soda(pkg, months=2, step=5):
    """The SODA-class monthly curl, every ``step``-th point: 66x144."""
    curl = xv.open_dataset(SODA).curl
    lat, lon = curl.coords["lat"][::step], curl.coords["lon"][::step]
    vals = curl.values[:months, ::step, ::step]
    return pkg.Field(vals, ("time", "lat", "lon"),
                     {"time": np.arange(float(months)), "lat": lat,
                      "lon": lon})


def _heating(pkg):
    """Gill-Matsuno's idealized heating on the 73x144 gallery grid
    (reference tests/test_GillMatsuno.py)."""
    lon = np.linspace(0, 360, 144)
    lat = np.linspace(-90, 90, 73)
    L, Lo = np.meshgrid(lat, lon, indexing="ij")
    Q = 0.05 * np.exp(-((L - 10) ** 2 + (Lo - 120) ** 2) / 100.0)
    return pkg.Field(Q, ("lat", "lon"), {"lat": lat, "lon": lon})


def _sources(pkg):
    """Stommel-Arons mass sources on the coarsened SODA ocean (reference
    tests/test_StommelArons.py scenario)."""
    f = _soda(pkg, months=1).isel(time=0)
    lat, lon = f.coords["lat"], f.coords["lon"]
    m = np.where(np.isfinite(f.values), 0.0, np.nan)
    m += -1e-3 * np.exp(-((lat[:, None] - 63) ** 2 / 30
                          + (lon[None, :] - 330) ** 2 / 120))
    return pkg.Field(m, ("lat", "lon"), {"lat": lat, "lon": lon})


def _latlon_synthetic(pkg, ny=29, nx=72, scale=1e-9, seed=0):
    """A Laplacian-of-geopotential-like field on the northern hemisphere
    (f keeps its sign, so the geostrophic operator stays definite)."""
    rng = np.random.default_rng(seed)
    lat = np.linspace(15.0, 85.0, ny)
    lon = np.linspace(0.0, 360.0 - 360.0 / nx, nx)
    L, Lo = np.deg2rad(lat)[:, None], np.deg2rad(lon)[None, :]
    v = (np.sin(2 * Lo) * np.cos(L) + 0.1 * rng.standard_normal((ny, nx)))
    return pkg.Field(v * scale, ("lat", "lon"), {"lat": lat, "lon": lon})


def _zlat(pkg, ny=21, nx=33, scale=1e-10, seed=1):
    rng = np.random.default_rng(seed)
    lev = np.linspace(100000.0, 10000.0, ny)
    lat = np.linspace(-60.0, 60.0, nx)
    v = scale * rng.standard_normal((ny, nx))
    return pkg.Field(v, ("lev", "lat"), {"lev": lev, "lat": lat})


def _cartesian(pkg, ny=31, nx=41, scale=1.0, seed=2, name=("y", "x")):
    rng = np.random.default_rng(seed)
    y = np.arange(ny) * 2e4
    x = np.arange(nx) * 2e4
    Y, X = np.meshgrid(y, x, indexing="ij")
    v = scale * (np.exp(-((Y - y.mean()) ** 2 + (X - x.mean()) ** 2)
                        / (3 * 2e4) ** 2)
                 + 0.01 * rng.standard_normal((ny, nx)))
    return pkg.Field(v, name, {name[0]: y, name[1]: x})


def _vortex(pkg):
    """A warm-core PV tower in (theta, r) (tests/test_refstate.py)."""
    theta = np.linspace(300.0, 380.0, 21)
    r = np.linspace(10e3, 810e3, 41)
    Q = 1e-6 + 4e-6 * np.exp(-(r[None, :] / 150e3) ** 2) \
        * np.exp(-((theta[:, None] - 330.0) / 25.0) ** 2)
    return pkg.Field(Q, ("theta", "r"), {"theta": theta, "r": r})


SODA_IP = {"BCs": ["extend", "periodic"], "mxLoop": 200, "tolerance": 1e-12,
           "undef": np.nan, "printInfo": False}

# entry point, forcing, dims, coords, mParams, iParams
ENTRY_CASES = {
    "Stommel": ("invert_Stommel", _soda, ["lat", "lon"], "lat-lon",
                {"R": 2e-4, "D": 100}, dict(SODA_IP, optArg=1.0)),
    "Stommel_test": ("invert_Stommel_test", _soda, ["lat", "lon"],
                     "lat-lon", {"R": 2e-4, "D": 100},
                     dict(SODA_IP, optArg=1.0)),
    "StommelMunk": ("invert_StommelMunk", _soda, ["lat", "lon"], "lat-lon",
                    {"R": 2e-4, "D": 100, "A4": 5e3}, SODA_IP),
    "StommelArons": ("invert_StommelArons", _sources, ["lat", "lon"],
                     "lat-lon", {"epsilon": 1e-5},
                     dict(SODA_IP, tolerance=1e-7)),
    "GillMatsuno": ("invert_GillMatsuno", _heating, ["lat", "lon"],
                    "lat-lon", {"epsilon": 1e-5, "Phi": 5000},
                    {"BCs": ["fixed", "periodic"], "mxLoop": 400,
                     "tolerance": 1e-7, "printInfo": False}),
    "GillMatsuno_test": ("invert_GillMatsuno_test", _heating, ["lat", "lon"],
                         "lat-lon", {"epsilon": 1e-5, "Phi": 5000},
                         {"BCs": ["fixed", "periodic"], "mxLoop": 150,
                          "tolerance": 1e-12, "printInfo": False}),
    "geostrophic": ("invert_geostrophic", _latlon_synthetic, ["lat", "lon"],
                    "lat-lon", None,
                    {"BCs": ["extend", "periodic"], "mxLoop": 400,
                     "tolerance": 1e-7, "printInfo": False}),
    "RefState": ("invert_RefState", _vortex, ["theta", "r"], "cartesian",
                 {"Ang0": 2e5, "Gamma": 1e-6},
                 {"BCs": ["fixed", "fixed"], "mxLoop": 300, "optArg": 1.4,
                  "tolerance": 1e-9, "printInfo": False}),
    "PV2D": ("invert_PV2D", _zlat, ["lev", "lat"], "z-lat", None,
             {"BCs": ["fixed", "fixed"], "mxLoop": 300, "tolerance": 1e-8,
              "printInfo": False}),
    "Eliassen": ("invert_Eliassen", _zlat, ["lev", "lat"], "z-lat", "ABC",
                 {"BCs": ["fixed", "fixed"], "mxLoop": 300, "optArg": 1.4,
                  "tolerance": 1e-9, "printInfo": False}),
    "BrethertonHaidvogel": ("invert_BrethertonHaidvogel", _cartesian,
                            ["y", "x"], "cartesian", {"D": 100},
                            {"BCs": ["fixed", "fixed"], "mxLoop": 300,
                             "tolerance": 1e-9, "printInfo": False}),
    "Fofonoff": ("invert_Fofonoff", _cartesian, ["y", "x"], "cartesian",
                 None, {"BCs": ["fixed", "fixed"], "mxLoop": 300,
                        "tolerance": 1e-9, "printInfo": False}),
}


def _eliassen_mp(pkg, f):
    """Eliassen's A, B, C as Fields on the forcing's grid (the TC2D
    notebook passes them so)."""
    rng = np.random.default_rng(7)
    shape = f.shape
    return {k: pkg.Field(lo + 0.05 * rng.standard_normal(shape), f.dims,
                         f.coords)
            for k, lo in zip("ABC", (1.0, -0.1, 1.0))}


@pytest.mark.parametrize("case", list(ENTRY_CASES))
def test_entry_point_matches_jax(f64_cpu, case):
    name, make, dims, coords, mp, iP = ENTRY_CASES[case]

    def run(pkg):
        f = make(pkg)
        m = _eliassen_mp(pkg, f) if mp == "ABC" else mp
        kw = {"device": "cpu"} if pkg is xt else {}
        return getattr(pkg, name)(f, dims=dims, coords=coords, mParams=m,
                                  iParams=iP, **kw)
    out_j = run(xv)
    out_t = run(xt)
    _compare_fields(out_j, out_t)
    _compare_last_solve()
    assert not tapi.LAST_SOLVE.overflow.any()


def test_entry_points_take_auto_omega_like_jax(f64_cpu):
    """Without optArg, Gill-Matsuno and Stommel-Munk take the family's
    omega from _AUTO_OMEGA (the grid-optimal one diverges): the same
    iterates as the JAX package, no overflow."""
    iP = {"BCs": ["fixed", "periodic"], "mxLoop": 80, "tolerance": 1e-12,
          "printInfo": False}
    mp = {"epsilon": 1e-5, "Phi": 5000}
    out_j = xv.invert_GillMatsuno(_heating(xv), dims=["lat", "lon"],
                                  iParams=iP, mParams=mp)
    out_t = xt.invert_GillMatsuno(_heating(xt), dims=["lat", "lon"],
                                  iParams=iP, mParams=mp, device="cpu")
    _compare_fields(out_j, out_t)
    _compare_last_solve()


# --------------------------------------------------- the inv_* functions


def _coeff_fields(pkg, n, ny=24, nx=30, seed=3):
    rng = np.random.default_rng(seed)
    coords = {"y": np.arange(ny) * 1e4, "x": np.arange(nx) * 1e4}
    return coords, [pkg.Field(a, ("y", "x"), coords) for a in (
        [np.abs(rng.normal(1.0, 0.1, (ny, nx))) + 0.5 for _ in range(2)]
        + [rng.normal(0, 0.02, (ny, nx)) for _ in range(n - 2)])]


@pytest.mark.parametrize("entry", ["inv_standard2D_test", "inv_general2D",
                                   "inv_general2D_bih"])
def test_inv_entries_match_jax(f64_cpu, entry):
    iP = {"BCs": ["fixed", "periodic"], "mxLoop": 200, "tolerance": 1e-9,
          "optArg": 1.0 if entry == "inv_general2D_bih" else 1.3}

    def run(pkg):
        n = {"inv_standard2D_test": 5, "inv_general2D": 6,
             "inv_general2D_bih": 9}[entry]
        coords, cs = _coeff_fields(pkg, n)
        if entry == "inv_standard2D_test":     # E S with E <= 0
            cs[4] = pkg.Field(-np.abs(cs[4].values) * 1e-8, cs[4].dims,
                              cs[4].coords)
        if entry == "inv_general2D":           # A, C > 0 on Syy, Sxx
            cs = [cs[0], cs[2], cs[1], cs[3], cs[4],
                  pkg.Field(-np.abs(cs[5].values) * 1e-8, cs[5].dims,
                            cs[5].coords)]
        if entry == "inv_general2D_bih":
            cs = [cs[0], cs[2], cs[1]] + [
                pkg.Field(c.values * 1e-9, c.dims, c.coords) for c in cs[3:]]
        F = np.random.default_rng(5).normal(0, 1e-9, (24, 30))
        F[8:12, 10:15] = np.nan
        kw = {"device": "cpu"} if pkg is xt else {}
        return getattr(pkg, entry)(*cs, pkg.Field(F, ("y", "x"), coords),
                                   ["y", "x"], coords="cartesian",
                                   iParams=iP, **kw)
    _compare_fields(run(xv), run(xt))
