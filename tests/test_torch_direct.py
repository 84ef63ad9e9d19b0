# -*- coding: utf-8 -*-
"""The direct engine of the PyTorch port (``xinvert_tpu_torch/ops/direct.py``,
``scheme="direct"``) against the JAX package's (``xinvert_tpu/ops/direct.py``)
on the same specs, float64 on the CPU, at grids of 17-65 points per axis
(the cases of tests/test_direct.py cut to size):

- the periodic-x rFFT branch: extend with the pure-Neumann gauge, fixed
  with icbc rows, a batched forcing, the least-squares projection of an
  inconsistent forcing;
- the symmetric non-periodic branch under all four BC pairs, and batched;
- the 1-D branch on a ``standard_1d`` spec carried across, with and
  without the gauge;
- the masked capacitance path: the residual at machine precision, the
  bordered singular gauge, a batch sharing the capacitance matrix, the pin
  values, the applicability gates;
- applicability against the JAX package's on specs it must refuse;
- the API: ``scheme="direct"`` through ``invert_Poisson``,
  ``invert_GillMatsuno``, a masked ``invert_Poisson`` and
  ``core.inv_standard2D``; a mask past the budget warns and gives the
  ``scheme="sor"`` field.

Tolerance: within 1e-10 of max|S| of the JAX field.  The FFTs, the scans
and ``eigh`` combine in another order than JAX's, so never ``torch.equal``.
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import xinvert_tpu as xi  # noqa: E402
import xinvert_tpu_torch as xt  # noqa: E402
from __graft_entry__ import _poisson_problem  # noqa: E402
from xinvert_tpu import solver as jsolver  # noqa: E402
from xinvert_tpu import stencil as jst  # noqa: E402
from xinvert_tpu.grid import Grid as JGrid  # noqa: E402
from xinvert_tpu.models import problems as jproblems  # noqa: E402
from xinvert_tpu.models.params import default_mParams  # noqa: E402
from xinvert_tpu.ops import direct as jdirect  # noqa: E402
from xinvert_tpu_torch import solver as tsolver  # noqa: E402
from xinvert_tpu_torch import telemetry  # noqa: E402
from xinvert_tpu_torch.field import Field  # noqa: E402
from xinvert_tpu_torch.ops import direct as tdirect  # noqa: E402
from xinvert_tpu_torch.stencil import StencilSpec  # noqa: E402

RTOL = 1e-10


def _port(js):
    return StencilSpec.from_arrays(
        np.asarray(js.w), np.asarray(js.w0), np.asarray(js.g),
        np.asarray(js.relax), np.asarray(js.active), js.offsets, js.bcs,
        js.bih, js.stop_on_zero_norm, device="cpu", dtype=torch.float64)


def _close(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0 and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale)


def _both(js, S0):
    """solve_direct of both packages on one spec and state."""
    ts = _port(js)
    assert tdirect.direct_applicable(ts, S0.shape)
    assert jdirect.direct_applicable(js, S0.shape)
    got = tdirect.solve_direct(ts, torch.tensor(np.asarray(S0)))
    want = jdirect.solve_direct(js, jnp.asarray(S0))
    _close(got, want)
    return got, want


def _manufactured(js, St):
    """Replace js.g so that St solves the folded system on active cells."""
    zero_g = dataclasses.replace(js, g=jnp.zeros_like(js.g))
    g = -(np.asarray(jsolver._neighbor_sum(zero_g, jnp.asarray(St)))
          + np.asarray(js.w0) * St)
    return dataclasses.replace(
        js, g=jnp.asarray(np.where(np.asarray(js.active), g, 0.0)))


def _smooth(ny, nx):
    y = np.linspace(-1.0, 1.0, ny)[:, None]
    x = np.linspace(0, 2 * np.pi, nx, endpoint=False)[None, :]
    return np.cos(2 * y) * np.sin(3 * x) + 0.5 * np.cos(y) * np.cos(5 * x)


def _cartesian_poisson(ny, nx, bcs, F=None):
    y = np.arange(ny) * 1e4
    x = np.arange(nx) * 1e4
    grid = JGrid.make(("y", "x"), (y, x), "cartesian", bcs=bcs)
    F = np.zeros((ny, nx)) if F is None else F
    return jproblems.build_poisson(jnp.asarray(F), jnp.ones((ny, nx), bool),
                                   grid, default_mParams)


# ------------------------------------------------------ periodic-x branch


def test_periodic_extend_gauge_manufactured():
    """The singular (pure-Neumann) Poisson: the anchor and the mean gauge;
    both packages land on the manufactured field up to the constant."""
    js, S0, _ = _poisson_problem(batch=0, ny=33, nx=64, masked=False,
                                 dtype=np.float64)
    St = _smooth(33, 64)
    St[0], St[-1] = St[1], St[-2]
    got, _ = _both(_manufactured(js, St), np.asarray(S0))
    err = got.numpy() - St
    err -= err[1:-1].mean()
    assert np.abs(err).max() < 1e-11


def test_periodic_fixed_icbc_rows():
    ny, nx = 24, 48
    lat = np.linspace(-80, 80, ny)
    lon = np.linspace(0, 360 - 360 / nx, nx)
    grid = JGrid.make(("lat", "lon"), (lat, lon), "lat-lon",
                      bcs=("fixed", "periodic"))
    js = jproblems.build_poisson(jnp.zeros((ny, nx)),
                                 jnp.ones((ny, nx), bool), grid,
                                 default_mParams)
    St = _smooth(ny, nx)
    S0 = np.zeros((ny, nx))
    S0[0], S0[-1] = St[0], St[-1]       # boundary rows carry icbc data
    got, _ = _both(_manufactured(js, St), S0)
    assert np.abs(got.numpy() - St).max() < 1e-11


def test_periodic_batched_forcing():
    js, S0, _ = _poisson_problem(batch=3, ny=33, nx=64, masked=False,
                                 dtype=np.float64)
    _both(js, np.asarray(S0))


def test_periodic_least_squares_inconsistent():
    """Nonzero-integral forcing on the singular problem: the projection to
    the least-squares solution; solve(scheme='direct') reports the same
    nonzero residual as the JAX package's."""
    js, S0, _ = _poisson_problem(batch=0, ny=33, nx=64, masked=False,
                                 dtype=np.float64)
    ts = _port(js)
    r_t = tsolver.solve(ts, torch.tensor(np.asarray(S0)), scheme="direct")
    r_j = jsolver.solve(js, S0, scheme="direct")
    _close(r_t.S, r_j.S)
    assert int(r_t.iters) == 1 and not bool(r_t.overflow)
    assert 0 < float(r_t.rel_change) < 0.1
    np.testing.assert_allclose(float(r_t.rel_change),
                               float(r_j.rel_change), rtol=1e-8)


def test_periodic_float32_gauge():
    """In float32 the gauge test fires (a threshold of 32 ulps of max|w0|
    where 1e-10 is below the weights' rounding; the JAX package's does not
    fire in float32): the float32 field lands within 1e-4 of max|S| of the
    JAX package's float64 one, mean removed, and the float64 threshold is
    the JAX package's."""
    js32, _, _ = _poisson_problem(batch=0, ny=33, nx=64, masked=False,
                                  dtype=np.float32)
    js64, S0, _ = _poisson_problem(batch=0, ny=33, nx=64, masked=False,
                                   dtype=np.float64)
    ts = StencilSpec.from_arrays(
        np.asarray(js32.w), np.asarray(js32.w0), np.asarray(js32.g),
        np.asarray(js32.relax), np.asarray(js32.active), js32.offsets,
        js32.bcs, device="cpu", dtype=torch.float32)
    got = tdirect.solve_direct(ts, torch.zeros((33, 64))).double().numpy()
    want = np.asarray(jdirect.solve_direct(js64, S0))
    got, want = got - got[1:-1].mean(), want - want[1:-1].mean()
    assert np.abs(got - want).max() < 1e-4 * np.abs(want).max()
    w0 = np.asarray(js64.w0)[1:-1, 0]
    assert tdirect._gauge_tol(w0) == 1e-10 * np.max(np.abs(w0))


# -------------------------------------------- symmetric non-periodic branch


@pytest.mark.parametrize("bcs", [("fixed", "fixed"), ("fixed", "extend"),
                                 ("extend", "fixed"), ("extend", "extend")])
def test_symmetric_branch(bcs):
    ny, nx = 24, 40
    St = _smooth(ny, nx)
    if bcs[0] == "extend":
        St[0, 1:-1], St[-1, 1:-1] = St[1, 1:-1], St[-2, 1:-1]
        St[0, 0], St[0, -1] = St[1, 1], St[1, -2]
        St[-1, 0], St[-1, -1] = St[-2, 1], St[-2, -2]
    js = _manufactured(_cartesian_poisson(ny, nx, bcs), St)
    S0 = np.zeros((ny, nx))
    if bcs[0] == "fixed":
        S0[0], S0[-1] = St[0], St[-1]
    S0[:, 0], S0[:, -1] = St[:, 0], St[:, -1]    # Dirichlet columns
    got, _ = _both(js, S0)
    assert np.abs(got.numpy() - St).max() < 1e-10


def test_symmetric_batched():
    ny, nx = 20, 28
    F = np.random.default_rng(1).normal(0.0, 1e-9, (3, ny, nx))
    js = _cartesian_poisson(ny, nx, ("fixed", "fixed"), F)
    _both(js, np.zeros((3, ny, nx)))


# ------------------------------------------------------------ 1-D branch


@pytest.mark.parametrize("bc,B", [("extend", -0.5), ("extend", 0.0),
                                  ("fixed", -0.5)])
def test_one_d(bc, B):
    """A standard_1d spec carried across: extend without the gauge, extend
    with the gauge and the projection (B = 0: conservative), fixed with
    boundary data."""
    n = 48
    A = jnp.asarray(1.0 + 0.3 * np.cos(np.linspace(0, 3, n)))
    St = np.sin(np.linspace(0, 2 * np.pi, n))
    js = jst.standard_1d(A, jnp.full(n, B), jnp.zeros(n), jnp.ones(n, bool),
                         (0.1,), (bc,))
    S0 = np.zeros(n)
    if bc == "extend":
        St[0], St[-1] = St[1], St[-2]
    else:
        S0[0], S0[-1] = St[0], St[-1]
    js = _manufactured(js, St)
    if B == 0.0:
        # an inconsistent forcing on top: the least-squares projection
        js = dataclasses.replace(js, g=js.g + 0.3 * jnp.asarray(js.active))
    got, _ = _both(js, S0)
    if B != 0.0:
        assert np.abs(got.numpy() - St).max() < 1e-10


# ----------------------------------------------- masked capacitance path


def _holes(ny, nx):
    holes = np.zeros((ny, nx), bool)
    holes[5:9, 10:16] = True          # island
    holes[18:21, 24:27] = True        # second island
    holes[12, 3] = True               # isolated cell
    return holes


def _pair(ny, nx, bcs, holes, batch=0, seed=0):
    """(unmasked spec, masked spec) Poisson pair sharing coefficients."""
    rng = np.random.default_rng(seed)
    y = np.arange(ny) * 1e4
    x = np.arange(nx) * 1e4
    grid = JGrid.make(("y", "x"), (y, x), "cartesian", bcs=bcs)
    F = jnp.asarray(rng.normal(0.0, 1.0, ((batch,) if batch else ())
                               + (ny, nx)))
    full = jproblems.build_poisson(F, jnp.ones((ny, nx), bool), grid,
                                   default_mParams)
    masked = jproblems.build_poisson(F, jnp.asarray(~holes), grid,
                                     default_mParams)
    return full, masked


@pytest.mark.parametrize("bcs", [("fixed", "periodic"), ("fixed", "fixed"),
                                 ("extend", "periodic")])
def test_masked_matches_jax_at_machine_precision(bcs):
    """Both BC families and the bordered singular gauge (extend,
    periodic): the port's field equals the JAX package's, its residual on
    the masked system is at roundoff, and the holes hold S0 exactly."""
    ny, nx = 28, 32
    holes = _holes(ny, nx)
    full, masked = _pair(ny, nx, bcs, holes)
    tf = _port(full)
    assert tdirect.masked_direct_applicable(tf, holes)
    S0 = np.zeros((ny, nx))
    telemetry.drain()
    telemetry.enable()
    try:
        got = tdirect.solve_direct_masked(tf, holes, torch.as_tensor(S0))
    finally:
        telemetry.disable()
    spans = telemetry.drain()
    _close(got, jdirect.solve_direct_masked(full, holes, jnp.asarray(S0)))
    tm = _port(masked)
    res = torch.where(tm.active, tsolver._neighbor_sum(tm, got)
                      + tm.w0 * got, 0.0)
    assert float(res.abs().max()) < 1e-11 * float(tm.g.abs().max())
    assert float(got[torch.as_tensor(holes)].abs().max()) == 0.0
    assert [s[0] for s in spans] == ["engine.direct.unit",
                                     "engine.direct.dense"]


def test_masked_batch_shares_capacitance():
    ny, nx = 24, 32
    holes = _holes(ny, nx)
    full, _ = _pair(ny, nx, ("fixed", "periodic"), holes, batch=3, seed=2)
    S0 = np.zeros((3, ny, nx))
    tf = _port(full)
    got = tdirect.solve_direct_masked(tf, holes, torch.as_tensor(S0))
    _close(got, jdirect.solve_direct_masked(full, holes, jnp.asarray(S0)))
    for b in range(3):
        one = dataclasses.replace(tf, g=tf.g[b])
        _close(got[b], tdirect.solve_direct_masked(
            one, holes, torch.as_tensor(S0[b])))


def test_masked_pin_values():
    """Nonzero S0 at the holes acts as interior Dirichlet data."""
    ny, nx = 24, 32
    holes = _holes(ny, nx)
    full, _ = _pair(ny, nx, ("fixed", "periodic"), holes, seed=3)
    S0 = np.zeros((ny, nx))
    S0[holes] = 3.14
    got = tdirect.solve_direct_masked(_port(full), holes,
                                      torch.as_tensor(S0))
    assert bool(torch.all(got[torch.as_tensor(holes)] == 3.14))
    _close(got, jdirect.solve_direct_masked(full, holes, jnp.asarray(S0)))


def test_masked_applicability_gates():
    ny, nx = 24, 32
    full, _ = _pair(ny, nx, ("fixed", "periodic"), _holes(ny, nx))
    tf = _port(full)
    none = np.zeros((ny, nx), bool)
    bdry = none.copy()
    bdry[0, 5] = True
    many = none.copy()
    many[1:-1, :] = True
    for holes, kw in ((none, {}), (bdry, {}), (many, {"max_holes": 600})):
        assert not tdirect.masked_direct_applicable(tf, holes, **kw)
        assert not jdirect.masked_direct_applicable(full, holes, **kw)
    with pytest.raises(ValueError, match="MAX_HOLES"):
        tdirect.solve_direct_masked(tf, none, torch.zeros((ny, nx)))


# --------------------------------------------------------- applicability


def _rejected_specs():
    base, S0, _ = _poisson_problem(batch=0, ny=33, nx=64, masked=False,
                                   dtype=np.float64)
    masked, _, _ = _poisson_problem(batch=0, ny=33, nx=64, masked=True,
                                    dtype=np.float64)
    w = np.asarray(base.w).copy()
    w[0, 10, 5] *= 1.5
    x_varying = dataclasses.replace(base, w=jnp.asarray(w))
    sym = _cartesian_poisson(24, 40, ("fixed", "fixed"))
    e = sym.offsets.index((0, 1))
    w = np.asarray(sym.w).copy()
    w[e, 1:-1, 1:-1] *= 1.5           # still x-invariant, now asymmetric
    asym = dataclasses.replace(sym, w=jnp.asarray(w))
    A = jnp.ones((24, 40))
    cross = jst.standard_2d(A, jnp.full((24, 40), 0.3), A,
                            jnp.zeros((24, 40)), jnp.ones((24, 40), bool),
                            (1e4, 1e4), ("fixed", "fixed"),
                            include_cross=True)
    grid = JGrid.make(("y", "x"), (np.arange(24) * 1e5, np.arange(40) * 1e5),
                      "cartesian", bcs=("fixed", "periodic"))
    mp = dict(default_mParams, A4=1e3, beta=2e-11, R=1e-4, D=100.0)
    bih = jproblems.build_stommelmunk(jnp.ones((24, 40)),
                                      jnp.ones((24, 40), bool), grid, mp)
    return {"masked": (masked, S0.shape), "x-varying": (x_varying, S0.shape),
            "asymmetric": (asym, (24, 40)), "cross": (cross, (24, 40)),
            "biharmonic": (bih, (24, 40))}


@pytest.mark.parametrize("case", ["masked", "x-varying", "asymmetric",
                                  "cross", "biharmonic"])
def test_applicability_rejects(case):
    js, shape = _rejected_specs()[case]
    assert not jdirect.direct_applicable(js, shape)
    ts = _port(js)
    assert not tdirect.direct_applicable(ts, shape)
    with pytest.raises(ValueError, match="does not qualify"):
        tdirect.solve_direct(ts, torch.zeros(shape))


# ------------------------------------------------------------------- API


@pytest.fixture(autouse=True)
def _f64():
    """The entry points build in torch's default dtype: float64 here."""
    dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(dtype)


def _iP(bcs, **kw):
    return dict({"BCs": list(bcs), "printInfo": False, "undef": np.nan}, **kw)


def _api(name, F, dims, iP, **kw):
    """The same entry point of both packages (the port on the CPU)."""
    jf = getattr(xi, name)(xi.Field(F.values, F.dims, F.coords), dims,
                           iParams=iP, **kw)
    tf = getattr(xt, name)(F, dims, iParams=iP, device="cpu", **kw)
    return tf, jf


def test_api_invert_poisson_direct():
    ny, nx = 25, 48
    lat = np.linspace(-80, 80, ny)
    lon = np.linspace(0, 360 - 360 / nx, nx)
    rng = np.random.default_rng(4)
    F = Field(rng.normal(0.0, 1e-5, (2, ny, nx)), ("time", "lat", "lon"),
              {"time": np.arange(2.0), "lat": lat, "lon": lon})
    tf, jf = _api("invert_Poisson", F, ["lat", "lon"],
                  _iP(("extend", "periodic"), scheme="direct"))
    _close(tf.values, jf.values)
    from xinvert_tpu_torch.models import api as tapi
    assert tapi.LAST_SOLVE.iters.tolist() == [1, 1]


def test_api_gillmatsuno_direct():
    """The general-2D family with advective terms (complex Fourier
    symbols)."""
    ny, nx = 37, 72
    lat = np.linspace(-90, 90, ny)
    lon = np.linspace(0, 355, nx)
    Q = -0.1 * np.exp(-(lat[:, None] ** 2 / 100
                        + (lon[None, :] - 120) ** 2 / 400))
    F = Field(Q, ("lat", "lon"), {"lat": lat, "lon": lon})
    tf, jf = _api("invert_GillMatsuno", F, ["lat", "lon"],
                  _iP(("fixed", "periodic"), scheme="direct"),
                  mParams={"epsilon": 7e-6, "Phi": 5000.0})
    _close(tf.values, jf.values)
    from xinvert_tpu_torch.models import api as tapi
    assert float(tapi.LAST_SOLVE.rel_change) < 1e-11


def test_api_masked_poisson_direct():
    """NaN-masked forcing with scheme='direct' takes the capacitance path
    in both packages; the holes come back undef."""
    ny, nx = 28, 32
    holes = _holes(ny, nx)
    rng = np.random.default_rng(7)
    vals = rng.normal(0.0, 1e-9, (ny, nx))
    vals[holes] = np.nan
    F = Field(vals, ("y", "x"), {"y": np.arange(ny) * 1e4,
                                 "x": np.arange(nx) * 1e4})
    tf, jf = _api("invert_Poisson", F, ["y", "x"],
                  _iP(("fixed", "periodic"), scheme="direct"),
                  coords="cartesian")
    ok = ~holes
    _close(tf.values[ok], jf.values[ok])
    assert np.isnan(tf.values[holes]).all()
    from xinvert_tpu_torch.models import api as tapi
    assert int(tapi.LAST_SOLVE.iters) == 1
    assert float(tapi.LAST_SOLVE.rel_change) < 1e-10


def test_api_masked_over_budget_falls_back_to_sor():
    """A mask past the dense budget (MAX_HOLES) warns with the JAX
    package's text and gives the scheme='sor' field exactly."""
    ny, nx = 64, 128
    rng = np.random.default_rng(7)
    land = np.kron(rng.normal(0, 1, (ny // 8, nx // 8)),
                   np.ones((8, 8))) > 0.25
    assert land[1:-1].sum() > tdirect.MAX_HOLES
    vals = rng.normal(0, 1e-5, (ny, nx))
    vals[land] = np.nan
    F = Field(vals, ("lat", "lon"), {"lat": np.linspace(-80, 80, ny),
                                     "lon": np.linspace(0, 357.1875, nx)})
    iP = _iP(("extend", "periodic"), mxLoop=200, tolerance=1e-9)
    ref = xt.invert_Poisson(F, ["lat", "lon"], iParams=iP, device="cpu")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = xt.invert_Poisson(F, ["lat", "lon"], device="cpu",
                                iParams=dict(iP, scheme="direct"))
    msgs = [str(x.message) for x in w]
    assert any(m.startswith("scheme='direct' declined for this masked "
                            "domain") and "falling back" in m for m in msgs)
    assert np.array_equal(got.values, ref.values, equal_nan=True)


def test_core_inv_standard2d_direct():
    """core.inv_standard2D with scheme='direct' reaches the direct engine
    through solve: the JAX package's direct solve of the same spec."""
    ny, nx = 21, 40
    lat = np.linspace(-70, 70, ny)
    lon = np.linspace(0, 360 - 360 / nx, nx)
    rng = np.random.default_rng(9)
    Fv = rng.normal(0.0, 1.0, (ny, nx))
    A = np.broadcast_to(1.0 + 0.2 * np.cos(np.deg2rad(lat))[:, None],
                        (ny, nx)).copy()
    F = Field(Fv, ("lat", "lon"), {"lat": lat, "lon": lon})
    out = xt.inv_standard2D(A, 0.0, A, F, ["lat", "lon"], coords="cartesian",
                            iParams=_iP(("fixed", "periodic"),
                                        scheme="direct"),
                            device="cpu")
    grid = JGrid.make(("lat", "lon"), (lat, lon), "cartesian",
                      bcs=("fixed", "periodic"))
    js = jst.standard_2d(jnp.asarray(A), jnp.zeros((ny, nx)), jnp.asarray(A),
                         jnp.asarray(Fv), jnp.ones((ny, nx), bool),
                         grid.deltas, grid.bcs)
    _close(out.values, jdirect.solve_direct(js, jnp.zeros((ny, nx))))
