# -*- coding: utf-8 -*-
"""The lexicographic executor (``scheme="lexico"``,
``xinvert_tpu_torch.lexico``) against the JAX package's, float64 on the
CPU: the 2-D radius-1 sweep (standard_2d with and without cross terms,
standard_2d_e, general_2d; fixed, extend and periodic boundaries; a mask),
the 1-D, biharmonic and 3-D twins, after 1, 5 and 20 sweeps, on single and
batched states and specs; checked solves (equal iters and overflow); the
entry points with ``iParams["scheme"] = "lexico"``; the two doubling
scans; and the NB05 nonlinear RefStateSWM chain against the repo's
notebook record, which needs no JAX run.  Tolerance: 1e-10 of max|S| (the
doubling scans combine in another order than the JAX package's associative
scans), never bit-equality."""
import json
import os
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xinvert_tpu import lexico as jlex  # noqa: E402
from xinvert_tpu import solver as jsolver  # noqa: E402
from xinvert_tpu import stencil as jst  # noqa: E402
from xinvert_tpu.models import api as japi  # noqa: E402
import xinvert_tpu as xv  # noqa: E402
import xinvert_tpu_torch as xt  # noqa: E402
from xinvert_tpu_torch import lexico as tlex  # noqa: E402
from xinvert_tpu_torch import solver as tsolver  # noqa: E402
from xinvert_tpu_torch.models import api as tapi  # noqa: E402
from xinvert_tpu_torch.stencil import StencilSpec  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
TOL = 1e-10


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


def _close(got, want):
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


def _u(rng, shape, lo=0.5, hi=1.5):
    return jnp.asarray(rng.uniform(lo, hi, shape))


def _mask(core, rng):
    m = np.ones(core, bool)
    idx = tuple(slice(n // 3, n // 3 + 2) for n in core)
    m[idx] = False
    return jnp.asarray(m)


def _case(name, batch=(), spec_batch=False):
    """(JAX spec, S0, omega) of a named test family at a small size."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    fam, *bcs = name.split("-")
    bcs = tuple(bcs)
    fb = batch if spec_batch else ()
    if fam in ("std2d", "std2dx", "std2d_e", "general2d"):
        core = (11, 14)
        F = _u(rng, fb + core, -1, 1)
        A, C = _u(rng, core), _u(rng, core)
        small = lambda: _u(rng, core, -0.15, 0.15)  # noqa: E731
        mask = _mask(core, rng)
        if fam == "std2d":
            sp = jst.standard_2d(A, 0.0, C, F, mask, (1.0, 1.3), bcs,
                                 include_cross=False)
        elif fam == "std2dx":
            sp = jst.standard_2d(A, small(), C, F, mask, (1.0, 1.3), bcs,
                                 include_cross=True)
        elif fam == "std2d_e":
            sp = jst.standard_2d_e(A, small(), small(), C,
                                   _u(rng, core, -0.3, -0.1), F, mask,
                                   (1.0, 1.3), bcs)
        else:
            sp = jst.general_2d(A, small(), C, small(), small(),
                                _u(rng, core, -0.3, -0.1), F, mask,
                                (1.0, 1.3), bcs)
        omega = 1.4
    elif fam == "std1d":
        core = (17,)
        sp = jst.standard_1d(_u(rng, core), _u(rng, fb + core, -0.3, -0.1),
                             _u(rng, fb + core, -1, 1),
                             jnp.ones(core, bool), (0.7,), bcs)
        omega = 1.2
    elif fam == "bih":
        core = (12, 15)
        small = lambda: _u(rng, core, -0.1, 0.1)  # noqa: E731
        sp = jst.general_2d_bih(
            _u(rng, core), small(), _u(rng, core), small(), small(),
            _u(rng, core), small(), small(), _u(rng, core, -0.5, -0.1),
            _u(rng, fb + core, -1, 1), jnp.ones(core, bool), (1.0, 1.1),
            bcs)
        omega = 1.0
    else:  # std3d / general3d
        core = (5, 7, 9)
        F = _u(rng, fb + core, -1, 1)
        if fam == "std3d":
            sp = jst.standard_3d(_u(rng, core), _u(rng, core),
                                 _u(rng, core), F, jnp.ones(core, bool),
                                 (1.0, 1.0, 1.2), bcs)
        else:
            small = lambda: _u(rng, core, -0.2, 0.2)  # noqa: E731
            sp = jst.general_3d(_u(rng, core), _u(rng, core), _u(rng, core),
                                small(), small(), small(),
                                _u(rng, core, -0.3, -0.1), F,
                                _mask(core, rng), (1.0, 1.0, 1.2), bcs)
        omega = 1.3
    S0 = rng.standard_normal(batch + core)
    return sp, S0, omega


def _frames(sweeper, S, ns=(1, 5, 20)):
    out = []
    for i in range(1, max(ns) + 1):
        S = sweeper(S)
        if i in ns:
            out.append(S)
    return out


def _hold(name, batch=(), spec_batch=False):
    js, S0, omega = _case(name, batch, spec_batch)
    one_j = jax.jit(jlex.lexico_sweeper(js, jnp.asarray(omega), S0.shape))
    one_t = tlex.lexico_sweeper(_port(js), omega, S0.shape)
    for got, want in zip(_frames(one_t, torch.tensor(S0)),
                         _frames(one_j, jnp.asarray(S0))):
        _close(got, want)


CASES = ["std2d-fixed-fixed", "std2d-extend-periodic", "std2d-fixed-periodic",
         "std2dx-fixed-fixed", "std2dx-extend-periodic",
         "std2d_e-extend-periodic", "general2d-fixed-periodic",
         "general2d-extend-fixed", "std1d-fixed", "std1d-extend",
         "std1d-periodic", "bih-fixed-fixed", "bih-extend-periodic",
         "bih-fixed-periodic", "std3d-fixed-fixed-periodic",
         "std3d-fixed-extend-periodic", "general3d-fixed-extend-fixed"]


@pytest.mark.parametrize("name", CASES)
def test_sweeps_match_jax(name):
    """1, 5 and 20 sweeps of one state."""
    _hold(name)


@pytest.mark.parametrize("name", ["std2dx-extend-periodic",
                                  "general2d-fixed-periodic",
                                  "std1d-periodic", "bih-extend-periodic",
                                  "std3d-fixed-extend-periodic"])
@pytest.mark.parametrize("spec_batch", [False, True])
def test_batched_sweeps_match_jax(name, spec_batch):
    """A batched state (3 slices) under an unbatched spec, and under a spec
    whose forcing (and for 1-D the linear coefficient) is batched too."""
    _hold(name, (3,), spec_batch)


def test_named_twins_match_jax():
    """solve_fixed_lexicographic and its 1-D, biharmonic and 3-D twins."""
    for name, jfn, tfn in (
            ("std2d-extend-periodic", jlex.solve_fixed_lexicographic,
             tlex.solve_fixed_lexicographic),
            ("std1d-extend", jlex.solve_fixed_lexicographic_1d,
             tlex.solve_fixed_lexicographic_1d),
            ("bih-fixed-periodic", jlex.solve_fixed_lexicographic_bih,
             tlex.solve_fixed_lexicographic_bih),
            ("std3d-fixed-fixed-periodic", jlex.solve_fixed_lexicographic_3d,
             tlex.solve_fixed_lexicographic_3d)):
        js, S0, omega = _case(name)
        _close(tfn(_port(js), torch.tensor(S0), omega, 7),
               jfn(js, jnp.asarray(S0), omega, 7))
    assert xt.solve_fixed_lexicographic is tlex.solve_fixed_lexicographic


@pytest.mark.parametrize("name", ["std2d-extend-periodic", "std1d-fixed",
                                  "std2dx-fixed-fixed",
                                  "std3d-fixed-fixed-periodic"])
@pytest.mark.parametrize("tol_type", ["change", "residual"])
def test_checked_solves_match_jax(name, tol_type):
    """solve(scheme="lexico") under both stopping rules, checked every
    sweep, two slices that stop at different sweeps: equal iters and
    overflow, S within 1e-10."""
    js, S0, omega = _case(name, (2,))
    tol = 1e-5 if tol_type == "change" else 1e-3
    rj = jsolver.solve(js, jnp.asarray(S0), omega=omega, tol=tol,
                       max_iters=500, scheme="lexico", tol_type=tol_type)
    rt = tsolver.solve(_port(js), torch.tensor(S0), omega=omega, tol=tol,
                       max_iters=500, scheme="lexico", tol_type=tol_type)
    assert rt.iters.tolist() == np.asarray(rj.iters).tolist()
    assert rt.overflow.tolist() == np.asarray(rj.overflow).tolist()
    assert int(rt.iters.max()) < 500
    _close(rt.S, rj.S)


def test_scans_match_jax():
    """The first- and second-order recurrences by doubling against the JAX
    package's associative scans, batched, with the seeds folded in."""
    rng = np.random.default_rng(3)
    A = rng.uniform(-0.9, 0.9, (4, 37))
    B = rng.standard_normal((4, 37))
    _close(tlex._scan_linear(torch.tensor(A), torch.tensor(B)),
           jlex._scan_linear(jnp.asarray(A), jnp.asarray(B)))
    A2 = rng.uniform(-0.4, 0.4, (4, 37))
    y1, y0 = rng.standard_normal(4), rng.standard_normal(4)
    _close(tlex._scan_affine2(torch.tensor(A), torch.tensor(A2),
                              torch.tensor(B), torch.tensor(y1),
                              torch.tensor(y0)),
           jlex._scan_affine2(jnp.asarray(A), jnp.asarray(A2),
                              jnp.asarray(B), jnp.asarray(y1),
                              jnp.asarray(y0)))


def _lat_lon_field(pkg, ny=21, nx=32, batch=0, seed=0):
    rng = np.random.default_rng(seed)
    lat = np.linspace(-80.0, 80.0, ny)
    lon = np.arange(nx) * 360.0 / nx
    L, Lo = np.meshgrid(np.deg2rad(lat), np.deg2rad(lon), indexing="ij")
    vals = np.sin(3 * Lo) * np.cos(2 * L) * 1e-5
    if batch:
        vals = vals + 1e-6 * rng.standard_normal((batch, ny, nx))
        return pkg.Field(vals, ("t", "lat", "lon"),
                         {"t": np.arange(batch), "lat": lat, "lon": lon})
    return pkg.Field(vals, ("lat", "lon"), {"lat": lat, "lon": lon})


def test_entry_points_match_jax():
    """invert_Poisson (two slices) and invert_omega with
    iParams["scheme"] = "lexico": the same per-slice iters, checked every
    sweep, S within 1e-10."""
    iP = {"BCs": ["fixed", "periodic"], "mxLoop": 300, "tolerance": 1e-6,
          "scheme": "lexico", "printInfo": False}
    out_t = xt.invert_Poisson(_lat_lon_field(xt, batch=2), ["lat", "lon"],
                              iParams=iP, device="cpu")
    it_t = tapi.LAST_SOLVE.iters.tolist()
    out_j = xv.invert_Poisson(_lat_lon_field(xv, batch=2), ["lat", "lon"],
                              iParams=iP)
    assert it_t == np.asarray(japi.LAST_SOLVE.iters).tolist()
    assert max(it_t) < 300
    _close(torch.tensor(out_t.values), out_j.values)

    rng = np.random.default_rng(4)
    lev = np.linspace(100000.0, 20000.0, 6)
    lat, lon = np.linspace(-60.0, 60.0, 9), np.arange(12) * 30.0
    F = rng.standard_normal((6, 9, 12)) * 1e-16
    iP3 = {"BCs": ["fixed", "extend", "periodic"], "mxLoop": 60,
           "tolerance": 1e-5, "scheme": "lexico", "printInfo": False}
    outs, iters = [], []
    for pkg, kw in ((xt, {"device": "cpu"}), (xv, {})):
        f = pkg.Field(F, ("lev", "lat", "lon"),
                      {"lev": lev, "lat": lat, "lon": lon})
        outs.append(pkg.invert_omega(f, ["lev", "lat", "lon"],
                                     iParams=iP3, **kw).values)
        api = tapi if pkg is xt else japi
        iters.append(np.asarray(api.LAST_SOLVE.iters).tolist())
    assert iters[0] == iters[1]
    _close(torch.tensor(outs[0]), outs[1])


def test_lexico_checks_every_sweep_on_the_card():
    """A CUDA float32 lexico solve keeps the per-sweep check (the JAX
    package never amortises it); the red-black schemes check every 32."""
    iP = dict(xt.default_iParams, mxLoop=5000)
    cuda = torch.device("cuda")
    assert tapi._auto_check_every(None, dict(iP, scheme="lexico"), cuda,
                                  torch.float32) == 1
    assert tapi._auto_check_every(None, dict(iP, scheme="sor"), cuda,
                                  torch.float32) == 32
    assert tapi._auto_check_every({"checkEvery": 4},
                                  dict(iP, scheme="lexico"), cuda,
                                  torch.float32) == 4


def test_non_radius1_spec_is_refused():
    core = (6, 8)
    z = np.zeros(core)
    spec = StencilSpec.from_arrays(np.ones((1,) + core), -np.ones(core), z,
                                   np.ones(core), np.ones(core, bool),
                                   ((0, 2),), ("fixed", "fixed"),
                                   device="cpu")
    with pytest.raises(ValueError):
        tlex.lexico_sweeper(spec, 1.0, core)


def test_nb05_chain_meets_the_notebook_record():
    """The NB05 nonlinear invert_RefStateSWM chain (five outer rounds on
    Data/barotropic2d_like.nc, as tests/notebook_workloads.py::run_nb05
    builds it) through the port alone, held to nb05_swm_round5 of
    tests/notebook_truth.json: sweeps within 2, mean|M| within 1e-10."""
    with open(os.path.join(ROOT, "tests", "notebook_truth.json")) as fh:
        rec = json.load(fh)["nb05_swm_round5"]
    b = xt.open_dataset(os.path.join(ROOT, "Data", "barotropic2d_like.nc"))
    lat = np.asarray(b["href"].coords["lat"], np.float64)
    ctr, Mass, Circ = (b[k].values.astype(np.float64)
                       for k in ("PV", "Mass", "Circ"))
    iP = {"BCs": ["fixed"], "mxLoop": 5001, "tolerance": 1e-15,
          "undef": np.nan, "scheme": "lexico", "printInfo": False}
    Mref = Mass.max() * (np.sin(np.deg2rad(lat)) + 1.0) / 2.0
    for _ in range(5):
        Q = np.interp(Mref, Mass, ctr)
        Q[lat == 90] = ctr.max()
        C = np.interp(Q, ctr, Circ)
        mP = {"M0": xt.Field(Mref, ("lat",), {"lat": lat}),
              "C0": xt.Field(C, ("lat",), {"lat": lat})}
        dM = xt.invert_RefStateSWM(xt.Field(Q, ("lat",), {"lat": lat}),
                                   dims=["lat"], iParams=iP, mParams=mP,
                                   device="cpu")
        Mref = Mref + dM.values
    assert abs(int(tapi.LAST_SOLVE.iters) - rec["sweeps"]) <= 2
    assert float(np.mean(np.abs(Mref))) == pytest.approx(rec["mean_abs_M"],
                                                         rel=1e-10)
