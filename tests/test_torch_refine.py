# -*- coding: utf-8 -*-
"""Certified refinement of the PyTorch port (ops/compensated.py,
refine.py, ``tolType="refined"``) against xinvert_tpu's on the same numpy
inputs, on the CPU: the error-free transformations exact against float64
and equal to the JAX package's; the compensated norm equal to the float64
truth at 96x192 within 1e-3 of its value; ``solve_refined`` in float32
with the JAX call's rounds (its single traced loop), a certificate within
1e-3 of the float64 residual of the port's own pair, and ``S_hi + S_lo``
within 1e-6 max|S| of the JAX pair (full sphere, batched, 3-D); the
``tolType='refined'`` entries (``invert_Poisson``, ``invert_Poisson_mg``)
and the divergence-restore branch, forced."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from xinvert_tpu import stencil as jst  # noqa: E402
from xinvert_tpu.field import Field as JField  # noqa: E402
from xinvert_tpu.grid import Grid as JGrid  # noqa: E402
from xinvert_tpu.models import api as japi  # noqa: E402
from xinvert_tpu.models.params import default_mParams  # noqa: E402
from xinvert_tpu.models.problems import build_poisson  # noqa: E402
from xinvert_tpu.ops import compensated as jcomp  # noqa: E402
from xinvert_tpu.refine import solve_refined as jrefined  # noqa: E402
import xinvert_tpu_torch as xt  # noqa: E402
from xinvert_tpu_torch import refine  # noqa: E402
from xinvert_tpu_torch.models import api as tapi  # noqa: E402
from xinvert_tpu_torch.ops import compensated  # noqa: E402
from xinvert_tpu_torch.solver import (_residual_norm,  # noqa: E402
                                      _residual_scale)
from xinvert_tpu_torch.stencil import StencilSpec  # noqa: E402

CERT_RTOL = 1e-3     # certificate against the float64 residual of the pair
PAIR_TOL = 1e-6      # port pair against the JAX pair, of max|S|


def _cast(js, dt):
    return dataclasses.replace(
        js, w=js.w.astype(dt), w0=js.w0.astype(dt), g=js.g.astype(dt),
        relax=js.relax.astype(dt))


def _port(js, dtype=torch.float32):
    return StencilSpec.from_arrays(
        np.asarray(js.w), np.asarray(js.w0), np.asarray(js.g),
        np.asarray(js.relax), np.asarray(js.active), js.offsets, js.bcs,
        js.bih, js.stop_on_zero_norm, device="cpu", dtype=dtype)


def _to64(ts):
    """The same operator in float64 (the up-cast is exact): the truth."""
    return dataclasses.replace(ts, **{n: getattr(ts, n).double() for n in
                                      ("w", "w0", "g", "relax")})


def _sphere(ny, nx):
    """Full-sphere lat-lon Poisson (extend, periodic), float32: the polar
    metric makes it the hard certification case."""
    lat = np.linspace(-88.75, 88.75, ny)
    lon = np.linspace(0.0, 360.0 - 360.0 / nx, nx)
    grid = JGrid.make(("lat", "lon"), (lat, lon), "lat-lon",
                      bcs=("extend", "periodic"))
    vor = (np.sin(3 * np.deg2rad(lon))[None, :]
           * np.cos(2 * np.deg2rad(lat))[:, None] * 1e-5)
    js = _cast(build_poisson(jnp.asarray(vor), jnp.ones((ny, nx), bool),
                             grid, default_mParams), jnp.float32)
    return js, _port(js), grid.omega_opt


def _pair64(hi, lo):
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def _check_refined(rj, rt, ts, tol):
    """Equal rounds, the port certified below tol and within CERT_RTOL of
    the float64 residual of its own pair, the pairs within PAIR_TOL."""
    assert rt.rounds == int(rj.rounds)
    cert = rt.rel_residual.double()
    assert float(cert.max()) <= tol
    ts64 = _to64(ts)
    Sd = rt.S_hi.double() + rt.S_lo.double()
    truth = _residual_norm(ts64, Sd) / _residual_scale(ts64)
    assert float(((cert - truth).abs() / truth).max()) <= CERT_RTOL, \
        (cert, truth)
    Sj = _pair64(rj.S_hi, rj.S_lo)
    St = Sd.numpy()
    assert np.abs(St - Sj).max() <= PAIR_TOL * np.abs(Sj).max()


@pytest.fixture(scope="module")
def sphere96():
    return _sphere(96, 192)


def _eft_inputs(n=20000, seed=0):
    rng = np.random.default_rng(seed)
    a = (rng.normal(0, 1, n) * 10.0 ** rng.integers(-8, 9, n)).astype(
        np.float32)
    b = (rng.normal(0, 1, n) * 10.0 ** rng.integers(-8, 9, n)).astype(
        np.float32)
    return a, b


@pytest.mark.parametrize("op", ["two_sum", "two_prod"])
def test_eft_exact_vs_f64_and_equal_to_jax(op):
    """TwoSum / TwoProd are error-free (s + e is the float64 value
    exactly) and give the JAX functions' words bit for bit."""
    a, b = _eft_inputs()
    s, e = getattr(compensated, op)(torch.from_numpy(a), torch.from_numpy(b))
    exact = (a.astype(np.float64) + b.astype(np.float64) if op == "two_sum"
             else a.astype(np.float64) * b.astype(np.float64))
    assert np.array_equal(s.double().numpy() + e.double().numpy(), exact)
    sj, ej = getattr(jcomp, op)(jnp.asarray(a), jnp.asarray(b))
    assert np.array_equal(s.numpy(), np.asarray(sj))
    assert np.array_equal(e.numpy(), np.asarray(ej))


def test_split_factor():
    assert compensated._split_factor(torch.float32) == 2.0 ** 12 + 1.0
    assert compensated._split_factor(torch.float64) == 2.0 ** 27 + 1.0


def test_compensated_norm_matches_f64_truth(sphere96):
    """The compensated float32 residual norm of a float32 state equals the
    float64 evaluation of the same operator and state within 1e-3 of its
    value, and the JAX package's compensated norm within 1e-5."""
    js, ts, omega = sphere96
    r = xt.solve(ts, torch.zeros(ts.w0.shape), omega, tol=1e-9,
                 max_iters=3000, check_every=32, tol_type="residual")
    comp = float(compensated.residual_norm_compensated(ts, r.S)
                 / _residual_scale(ts))
    ts64 = _to64(ts)
    truth = float(_residual_norm(ts64, r.S.double()) / _residual_scale(ts64))
    assert abs(comp - truth) <= 1e-3 * truth, (comp, truth)
    jc = float(jcomp.residual_norm_compensated(js, jnp.asarray(r.S.numpy()))
               / float(_residual_scale(ts)))
    assert abs(comp - jc) <= 1e-5 * jc, (comp, jc)


def test_refined_matches_jax_full_sphere(sphere96):
    """96x192 full sphere, float32: below the single-float32 floor, with
    the JAX call's rounds and pair."""
    js, ts, omega = sphere96
    kw = dict(omega=omega, tol=1e-7, max_rounds=5, inner_tol=1e-4,
              inner_iters=30000)
    rj = jrefined(js, jnp.zeros(js.w0.shape, jnp.float32), **kw)
    rt = xt.solve_refined(ts, torch.zeros(ts.w0.shape), **kw)
    _check_refined(rj, rt, ts, 1e-7)
    # the single float32 state stalls far above: a plain solve of the
    # same depth, measured by the compensated norm
    plain = xt.solve(ts, torch.zeros(ts.w0.shape), omega, tol=1e-9,
                     max_iters=3000, check_every=32, tol_type="residual")
    assert float(plain.rel_change) > 100 * float(rt.rel_residual)


def test_refined_batched():
    """A batch of three forcings: per-slice certificates, the JAX rounds."""
    rng = np.random.default_rng(3)
    ny, nx, B = 48, 64, 3
    A = (np.abs(rng.normal(1, 0.1, (ny, nx))) + 0.5).astype(np.float32)
    F = rng.normal(0, 1, (B, ny, nx)).astype(np.float32) * 1e-9
    js = jst.standard_2d(jnp.asarray(A), 0.0, jnp.asarray(A),
                         jnp.asarray(F), jnp.ones((ny, nx), bool),
                         (1.3e5, 1.0e5), ("fixed", "periodic"))
    ts = _port(js)
    kw = dict(tol=1e-7, max_rounds=5, inner_tol=1e-4, inner_iters=20000)
    rj = jrefined(js, jnp.zeros((B, ny, nx), jnp.float32), **kw)
    rt = xt.solve_refined(ts, torch.zeros(B, ny, nx), **kw)
    assert rt.rel_residual.shape == (B,)
    _check_refined(rj, rt, ts, 1e-7)


def test_refined_3d():
    """A 3-D standard family certifies through the same machinery."""
    rng = np.random.default_rng(11)
    sh = (12, 24, 32)
    A = ((np.abs(rng.normal(1.0, 0.1, sh)) + 0.5) * 2e-4).astype(np.float32)
    B = (np.abs(rng.normal(1.0, 0.1, sh)) + 0.5).astype(np.float32)
    F = rng.normal(0.0, 1e-9, sh).astype(np.float32)
    js = jst.standard_3d(jnp.asarray(A), jnp.asarray(B), jnp.asarray(B),
                         jnp.asarray(F), jnp.ones(sh, bool),
                         (5e3, 1.1e5, 1.0e5), ("fixed", "extend", "periodic"))
    ts = _port(js)
    kw = dict(tol=1e-7, max_rounds=5, inner_tol=1e-4, inner_iters=20000)
    rj = jrefined(js, jnp.zeros(sh, jnp.float32), **kw)
    rt = xt.solve_refined(ts, torch.zeros(sh), **kw)
    _check_refined(rj, rt, ts, 1e-7)


def _vor_fields(ny, nx, lat0=-88.75, lat1=88.75):
    lat = np.linspace(lat0, lat1, ny)
    lon = np.linspace(0, 360 - 360 / nx, nx)
    # smooth zero-mean forcing (noise is incompatible with the extend and
    # periodic operator's constant nullspace and pins the residual)
    vor = (np.sin(3 * np.deg2rad(lon))[None, :]
           * np.cos(2 * np.deg2rad(lat))[:, None] * 1e-5).astype(np.float32)
    coords = {"lat": lat, "lon": lon}
    return (JField(vor, ("lat", "lon"), coords),
            xt.Field(vor, ("lat", "lon"), coords))


@pytest.fixture
def dtype_default():
    """Restores torch's default dtype after a test that sets it."""
    dtype = torch.get_default_dtype()
    yield
    torch.set_default_dtype(dtype)


FIELD_TOL = 1e-10    # float64 entries against the JAX package's, of max|S|


def _refined_entry(name, jf, tf, kw, tol):
    """The entry ``name`` with tolType='refined': float64 against the JAX
    package (which builds its operator in float64 here): the rounds
    (LAST_SOLVE.iters) and the field; then the port in float32 alone, its
    certificate at ``tol`` and rounds in its telemetry."""
    torch.set_default_dtype(torch.float64)
    jout = getattr(japi, name)(jf, **kw)
    tout = getattr(xt, name)(tf, device="cpu", **kw)
    r = tapi.LAST_REFINE
    assert r.S_hi.dtype == torch.float64
    assert r.rounds == int(japi.LAST_REFINE.rounds)
    assert float(r.rel_residual.max()) <= tol
    a = np.asarray(jout.values)
    assert np.abs(tout.values - a).max() <= FIELD_TOL * np.abs(a).max()

    torch.set_default_dtype(torch.float32)
    out = getattr(xt, name)(tf, device="cpu", **kw)
    assert np.isfinite(out.values).all()
    r = tapi.LAST_REFINE
    assert r.S_hi.dtype == torch.float32 and r.S_lo.shape == out.shape
    assert float(r.rel_residual.max()) <= tol
    assert np.all(np.asarray(tapi.LAST_SOLVE.iters) == r.rounds)
    assert float(np.max(np.asarray(tapi.LAST_SOLVE.rel_change))) <= tol
    return r


def test_api_toltype_refined(dtype_default):
    """iParams tolType='refined' routes invert_Poisson through
    solve_refined: the certificate in LAST_SOLVE.rel_change, the rounds in
    its iters, the pair in LAST_REFINE, S the high word."""
    jf, tf = _vor_fields(72, 144)
    iP = {"BCs": ["extend", "periodic"], "undef": np.nan, "mxLoop": 20000,
          "tolerance": 1e-7, "printInfo": False, "tolType": "refined"}
    r = _refined_entry("invert_Poisson", jf, tf,
                       dict(dims=["lat", "lon"], iParams=iP), 1e-7)
    assert torch.equal(tapi.LAST_SOLVE.S, r.S_hi)
    assert not bool(tapi.LAST_SOLVE.overflow.any())


def test_api_mg_refined(dtype_default):
    """invert_Poisson_mg with tolType='refined': V-cycle corrections (the
    g0 override of solve_mg) certify the tolerance."""
    jf, tf = _vor_fields(65, 128, -80.0, 80.0)
    iP = {"BCs": ["extend", "periodic"], "undef": np.nan,
          "printInfo": False, "tolType": "refined"}
    _refined_entry("invert_Poisson_mg", jf, tf,
                   dict(dims=["lat", "lon"], tol=1e-9, iParams=iP), 1e-9)


def test_divergence_restores_the_best(sphere96):
    """A correction that blows the residual up past twice the best ends
    the loop with the best iterate restored, in both packages alike (the
    JAX host loop, the same forced inner)."""
    js, ts, omega = sphere96

    def forced(solve_fn, zeros_like):
        calls = {"n": 0}

        def inner(cspec, S0):
            calls["n"] += 1
            S = solve_fn(cspec, S0)
            return S * 1e3 + 1.0 if calls["n"] == 3 else S
        return inner

    def jsolve(cspec, S0):
        from xinvert_tpu.solver import solve
        return solve(cspec, S0, omega=omega, tol=1e-9, max_iters=400,
                     check_every=32).S

    def tsolve(cspec, S0):
        return xt.solve(cspec, S0, omega=omega, tol=1e-9, max_iters=400,
                        check_every=32).S

    kw = dict(tol=1e-30, max_rounds=6)
    rj = jrefined(js, jnp.zeros(js.w0.shape, jnp.float32),
                  inner=forced(jsolve, jnp.zeros_like), **kw)
    rt = xt.solve_refined(ts, torch.zeros(ts.w0.shape),
                          inner=forced(tsolve, torch.zeros_like), **kw)
    assert rt.rounds == int(rj.rounds) == 2      # round 2's correction
    # the restored state is round 1's: re-run rounds 0-1 alone
    r1 = xt.solve_refined(ts, torch.zeros(ts.w0.shape),
                          inner=tsolve, tol=1e-30, max_rounds=1)
    assert torch.equal(rt.S_hi, r1.S_hi) and torch.equal(rt.S_lo, r1.S_lo)
    assert torch.equal(rt.rel_residual, r1.rel_residual)


def test_refined_mesh_and_streamchunk_refused():
    """Refinement keeps a resident (hi, lo) state: with streamChunk it is
    refused, with or without a mesh (a mesh alone is taken:
    tests/test_torch_parallel.py)."""
    from xinvert_tpu_torch.parallel import make_grid_mesh
    _, tf = _vor_fields(24, 48)
    iP = {"BCs": ["extend", "periodic"], "undef": np.nan, "mxLoop": 50,
          "tolerance": 1e-6, "printInfo": False, "tolType": "refined",
          "streamChunk": 1}
    mesh = make_grid_mesh(devices=[torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="refined.*streamChunk"):
        xt.invert_Poisson(tf, dims=["lat", "lon"], device="cpu",
                          iParams=dict(iP, mesh=mesh))
    with pytest.raises(ValueError, match="refined.*streamChunk"):
        xt.invert_Poisson(tf, dims=["lat", "lon"], iParams=iP, device="cpu")
