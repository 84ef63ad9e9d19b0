# -*- coding: utf-8 -*-
"""The 1-D family of the PyTorch port against the JAX package's, float64
on the CPU: ``stencil.standard_1d``, the 1-D extend pre-pass, the engine's
explicit 1-D route (plain torch ops on either device), ``invert_GeoAdjustment``
and ``invert_RefStateSWM`` (fixed and extend boundaries, batched forcings)
with ``scheme`` sor, cheby, lexico and direct, and ``inv_standard1D``.
Checked solves: equal iters and overflow; fixed sweep counts: S at rtol
1e-11 (lexico: within 1e-10 of max|S|); direct: within 1e-10 of max|S|."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import xinvert_tpu as xv  # noqa: E402
from xinvert_tpu import solver as jsolver  # noqa: E402
from xinvert_tpu import stencil as jst  # noqa: E402
from xinvert_tpu.models import api as japi  # noqa: E402
import xinvert_tpu_torch as xt  # noqa: E402
from xinvert_tpu_torch import solver as tsolver  # noqa: E402
from xinvert_tpu_torch import stencil as tst  # noqa: E402
from xinvert_tpu_torch.models import api as tapi  # noqa: E402
from xinvert_tpu_torch.ops import sor2d, sor3d  # noqa: E402

GEO_LAT = np.linspace(-75.0, -25.0, 41)


@pytest.fixture(autouse=True)
def f64_cpu():
    """The port builds its tensors in the default dtype: float64 here."""
    dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(dtype)


def _geo(pkg, batch=3, seed=0):
    """An interface height with a step (reference test_GeoAdjustment.py),
    a few noisy slices along 't'."""
    rng = np.random.default_rng(seed)
    h = (1500.0 + 20.0 * (GEO_LAT > -50.0)
         + rng.standard_normal((batch, GEO_LAT.size)))
    return pkg.Field(h, ("t", "lat"), {"t": np.arange(batch), "lat": GEO_LAT})


def _swm(pkg, batch=3, seed=1):
    """One round of notebook 05's RefStateSWM on Data/barotropic2d_like.nc
    (121 latitudes): the forcing Q with a few perturbed slices along 't',
    M0 and C0 as Fields on 'lat'."""
    b = xt.open_dataset("Data/barotropic2d_like.nc")
    lat = np.asarray(b["href"].coords["lat"], np.float64)
    ctr, Mass, Circ = (b[k].values.astype(np.float64)
                       for k in ("PV", "Mass", "Circ"))
    M = Mass.max() * (np.sin(np.deg2rad(lat)) + 1.0) / 2.0
    Q = np.interp(M, Mass, ctr)
    Q[lat == 90] = ctr.max()
    C = np.interp(Q, ctr, Circ)
    rng = np.random.default_rng(seed)
    Qb = Q * (1.0 + 1e-3 * rng.standard_normal((batch, lat.size)))
    return (pkg.Field(Qb, ("t", "lat"), {"t": np.arange(batch), "lat": lat}),
            {"M0": pkg.Field(M, ("lat",), {"lat": lat}),
             "C0": pkg.Field(C, ("lat",), {"lat": lat})})


def _run(entry, bc, scheme, mxLoop, tol):
    """The entry point through both packages: (port S, JAX S, port result,
    JAX result)."""
    iP = {"BCs": [bc], "mxLoop": mxLoop, "tolerance": tol,
          "scheme": scheme, "printInfo": False}
    if entry == "geo":
        iP["optArg"] = 1.8
        out_t = xt.invert_GeoAdjustment(_geo(xt), ["lat"], iParams=iP,
                                        device="cpu")
        res_t = tapi.LAST_SOLVE
        out_j = xv.invert_GeoAdjustment(_geo(xv), ["lat"], iParams=iP)
    else:
        F_t, mP_t = _swm(xt)
        F_j, mP_j = _swm(xv)
        out_t = xt.invert_RefStateSWM(F_t, ["lat"], iParams=iP, mParams=mP_t,
                                      device="cpu")
        res_t = tapi.LAST_SOLVE
        out_j = xv.invert_RefStateSWM(F_j, ["lat"], iParams=iP, mParams=mP_j)
    return out_t.values, out_j.values, res_t, japi.LAST_SOLVE


@pytest.mark.parametrize("bcs", [("fixed",), ("extend",), ("periodic",)])
def test_standard_1d_spec_matches_jax(bcs):
    rng = np.random.default_rng(2)
    n = 23
    A, B = rng.uniform(0.5, 1.5, n), rng.uniform(-0.3, -0.1, (2, n))
    F = rng.standard_normal((2, n))
    Fdef = np.ones(n, bool)
    Fdef[7] = False
    js = jst.standard_1d(jnp.asarray(A), jnp.asarray(B), jnp.asarray(F),
                         jnp.asarray(Fdef), (0.3,), bcs)
    ts = tst.standard_1d(torch.tensor(A), torch.tensor(B), torch.tensor(F),
                         torch.tensor(Fdef), (0.3,), bcs)
    assert ts.offsets == js.offsets and ts.bcs == js.bcs
    assert ts.stop_on_zero_norm == js.stop_on_zero_norm and not ts.bih
    for name in ("w", "w0", "g", "relax", "active"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)),
                                   rtol=1e-14, atol=0)


@pytest.mark.parametrize("bc", ["fixed", "extend", "periodic"])
def test_extend_prepass_1d_matches_jax(bc):
    rng = np.random.default_rng(3)
    S = rng.standard_normal((2, 9))
    js = jst.standard_1d(jnp.ones(9), jnp.zeros(9), jnp.zeros(9),
                         jnp.ones(9, bool), (1.0,), (bc,))
    ts = tst.standard_1d(torch.ones(9), torch.zeros(9), torch.zeros(9),
                         torch.ones(9, dtype=torch.bool), (1.0,), (bc,))
    np.testing.assert_array_equal(
        tsolver._apply_extend(ts, torch.tensor(S)).numpy(),
        np.asarray(jsolver._apply_extend(js, jnp.asarray(S))))


def test_the_1d_route_is_chosen_by_ndim_alone():
    """1-D specs run the plain sweeps (no kernel takes them, as no Pallas
    kernel does in the JAX package); 2-D and 3-D specs keep their kernel
    wrappers, and a 1-D solve makes no call of theirs."""
    one = tst.standard_1d(torch.ones(9), -0.1 * torch.ones(9),
                          torch.ones(9), torch.ones(9, dtype=torch.bool),
                          (1.0,), ("fixed",))
    two = tst.standard_2d(torch.ones(5, 6), 0.0, torch.ones(5, 6),
                          torch.ones(5, 6), torch.ones(5, 6, dtype=bool),
                          (1.0, 1.0), ("fixed", "periodic"))
    three = tst.standard_3d(*(torch.ones(4, 5, 6) for _ in range(4)),
                            torch.ones(4, 5, 6, dtype=bool), (1.0, 1.0, 1.0),
                            ("fixed", "fixed", "periodic"))
    assert tsolver._select_kernel(one, torch.zeros(9)) is tsolver.sweeps_1d
    assert tsolver._select_kernel(two, torch.zeros(5, 6)) is \
        sor2d.sor2d_sweeps
    assert tsolver._select_kernel(three, torch.zeros(4, 5, 6)) is \
        sor3d.sor3d_sweeps
    sor2d.PLAIN_CALLS = sor3d.PLAIN_CALLS = 0
    res = tsolver.solve(one, torch.zeros(3, 9), omega=1.5, tol=1e-10,
                        max_iters=200)
    assert sor2d.PLAIN_CALLS == sor3d.PLAIN_CALLS == 0
    assert int(res.iters.max()) < 200


@pytest.mark.parametrize("entry", ["geo", "swm"])
@pytest.mark.parametrize("bc", ["fixed", "extend"])
@pytest.mark.parametrize("scheme", ["sor", "cheby", "lexico"])
def test_checked_solves_match_jax(entry, bc, scheme):
    """Three slices to convergence: equal iters and overflow per slice."""
    S_t, S_j, r_t, r_j = _run(entry, bc, scheme, 4000, 1e-9)
    assert r_t.iters.tolist() == np.asarray(r_j.iters).tolist()
    assert r_t.overflow.tolist() == np.asarray(r_j.overflow).tolist()
    assert int(r_t.iters.max()) < 4000
    np.testing.assert_allclose(S_t, S_j, rtol=0,
                               atol=1e-10 * np.abs(S_j).max())


@pytest.mark.parametrize("entry", ["geo", "swm"])
@pytest.mark.parametrize("bc", ["fixed", "extend"])
@pytest.mark.parametrize("scheme", ["sor", "cheby", "lexico"])
def test_fixed_counts_match_jax(entry, bc, scheme):
    """40 sweeps (tolerance 0, so mxLoop stops them)."""
    S_t, S_j, r_t, _ = _run(entry, bc, scheme, 40, 0.0)
    assert r_t.iters.tolist() == [40, 40, 40]
    if scheme == "lexico":
        np.testing.assert_allclose(S_t, S_j, rtol=0,
                                   atol=1e-10 * np.abs(S_j).max())
    else:
        np.testing.assert_allclose(S_t, S_j, rtol=1e-11, atol=0)


@pytest.mark.parametrize("entry", ["geo", "swm"])
@pytest.mark.parametrize("bc", ["fixed", "extend"])
def test_direct_matches_jax(entry, bc):
    """scheme="direct" on the batched forcing reaches the 1-D branch of
    ops/direct.py in one solve; held against the JAX package's direct
    solve of each slice alone (its 1-D branch takes no batched linear
    coefficient) and against the port's converged SOR."""
    iP = {"BCs": [bc], "scheme": "direct", "printInfo": False}
    if entry == "geo":
        iP["optArg"] = 1.8
        S_t = xt.invert_GeoAdjustment(_geo(xt), ["lat"], iParams=iP,
                                      device="cpu").values
        Fj = _geo(xv)
        S_j = np.stack([xv.invert_GeoAdjustment(
            Fj.isel({"t": i}), ["lat"], iParams=iP).values
            for i in range(3)])
    else:
        F_t, mP_t = _swm(xt)
        S_t = xt.invert_RefStateSWM(F_t, ["lat"], iParams=iP, mParams=mP_t,
                                    device="cpu").values
        Fj, mP_j = _swm(xv)
        S_j = np.stack([xv.invert_RefStateSWM(
            Fj.isel({"t": i}), ["lat"], iParams=iP, mParams=mP_j).values
            for i in range(3)])
    assert tapi.LAST_SOLVE.iters.tolist() == [1, 1, 1]
    np.testing.assert_allclose(S_t, S_j, rtol=0,
                               atol=1e-10 * np.abs(S_j).max())
    S_sor, _, _, _ = _run(entry, bc, "sor", 20000, 1e-14)
    np.testing.assert_allclose(S_t, S_sor, rtol=0,
                               atol=1e-6 * np.abs(S_sor).max())


@pytest.mark.parametrize("scheme", ["sor", "cheby", "direct"])
def test_inv_standard1D_matches_jax(scheme):
    """inv_standard1D on two slices.  The JAX package's core drops
    iParams['scheme'] (always SOR) and the port's passes it on, so the
    port is held against the JAX engine's solve of the same spec."""
    rng = np.random.default_rng(5)
    x = np.linspace(0.0, 1e6, 31)
    A = xt.Field(1.0 + 0.2 * np.sin(x / 2e5), ("x",), {"x": x})
    B = xt.Field(-1e-10 * np.ones(31), ("x",), {"x": x})
    F = rng.standard_normal((2, 31)) * 1e-9
    Ft = xt.Field(F, ("t", "x"), {"t": np.arange(2), "x": x})
    iP = {"BCs": ["fixed"], "mxLoop": 3000, "tolerance": 1e-10,
          "scheme": scheme, "printInfo": False}
    S_t = xt.inv_standard1D(A, B, Ft, ["x"], coords="cartesian",
                            iParams=iP, device="cpu").values
    js = jst.standard_1d(jnp.asarray(A.values), jnp.asarray(B.values),
                         jnp.asarray(F), jnp.ones(31, bool),
                         (x[1] - x[0],), ("fixed",))
    rj = jsolver.solve(js, jnp.zeros((2, 31)),
                       omega=xv.Grid.make(["x"], [x], "cartesian",
                                          ("fixed",)).omega_opt,
                       tol=1e-10, max_iters=3000, scheme=scheme)
    S_j = np.asarray(rj.S)
    assert np.abs(S_j).max() > 0
    np.testing.assert_allclose(S_t, S_j, rtol=0,
                               atol=1e-10 * np.abs(S_j).max())
    if scheme == "sor":
        S_core = xv.inv_standard1D(xv.Field(A.values, ("x",), {"x": x}),
                                   xv.Field(B.values, ("x",), {"x": x}),
                                   xv.Field(F, ("t", "x"),
                                            {"t": np.arange(2), "x": x}),
                                   ["x"], coords="cartesian",
                                   iParams=iP).values
        np.testing.assert_allclose(S_t, S_core, rtol=0,
                                   atol=1e-10 * np.abs(S_j).max())


def test_builders_refuse_other_coordinates():
    f = xt.Field(np.ones(9), ("y",), {"y": np.arange(9.0)})
    for entry in (xt.invert_GeoAdjustment, xt.invert_RefStateSWM):
        with pytest.raises(ValueError):
            entry(f, ["y"], coords="cartesian", device="cpu",
                  iParams={"printInfo": False})
