# -*- coding: utf-8 -*-
"""Geometric multigrid of the PyTorch port (``xinvert_tpu_torch/mg.py``)
against the JAX package's (``xinvert_tpu/mg.py``), float64 on the CPU:

- the transfers (restriction, prolongation, plane and mask coarsening, the
  coarse-level derivatives) on odd and even sizes, periodic and not, at
  rtol 1e-14;
- the level plans and the pyramids of all six builders: equal plans,
  ``odd``, ``masked``, ``smoother``, ``omega``, offsets and ``active``;
  the planes at rtol 1e-12;
- one ``_vcycle`` from the same state on JAX's levels carried across with
  ``levels_from_arrays``, for each smoother (point, xline, zline, zxline)
  and batched: within 1e-10 max|S|;
- ``solve_mg`` with ``accel`` None / "auto" / "bicgstab", with and without
  ``fmg``, single and batched, on a masked 65x128 Poisson, a full-sphere
  37x72 (x-lines), a 7x33x64 omega (z-lines), a 65x128 Stommel (the Krylov
  rescue; batched on a 33x64 one) and a biharmonic Munk gyre: equal cycles
  and ``converged``, the field within 1e-8 max|S|.

The port runs its plain (CPU) path here; the kernels are held against it
on the card by tests/test_torch_cuda.py."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xinvert_tpu import mg as jmg  # noqa: E402
from xinvert_tpu.grid import Grid as JGrid  # noqa: E402
from xinvert_tpu.models import problems as jprob  # noqa: E402
from xinvert_tpu.models.params import default_mParams  # noqa: E402
from xinvert_tpu_torch import mg as tmg  # noqa: E402

RTOL_TRANSFER = 1e-14
RTOL_PLANES = 1e-12
VCYCLE_TOL = 1e-10
FIELD_TOL = 1e-8


@pytest.fixture(scope="module", autouse=True)
def f64():
    """The port builds its tensors in the default dtype: float64 here."""
    dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(dtype)


def _t(x):
    return torch.tensor(np.asarray(x))


# ---------------------------------------------------------------- transfers

@pytest.mark.parametrize("shape", [(9, 12), (3, 10, 13)])
@pytest.mark.parametrize("bcs", [("fixed", "fixed"), ("extend", "periodic")])
def test_transfers(shape, bcs):
    rng = np.random.default_rng(sum(shape))
    ny, nx = shape[-2:]
    odd = (ny % 2 == 1, nx % 2 == 1)
    r = rng.normal(0.0, 1.0, shape)

    def close(got, want):
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_TRANSFER,
                                   atol=RTOL_TRANSFER * np.abs(want).max())

    rc = tmg.restrict(_t(r), odd, bcs)
    close(rc, jmg.restrict(jnp.asarray(r), odd, bcs))
    close(tmg.prolong(rc, (ny, nx), odd, bcs),
          jmg.prolong(jnp.asarray(rc.numpy()), (ny, nx), odd, bcs))
    close(tmg._coarsen_plane(_t(r), odd), jmg._coarsen_plane(r, odd))
    close(tmg._ddy(_t(r), 1.3), jmg._ddy(jnp.asarray(r), 1.3))
    close(tmg._ddx(_t(r), 0.7), jmg._ddx(jnp.asarray(r), 0.7))
    m = rng.random(shape) > 0.2
    np.testing.assert_array_equal(
        tmg._coarsen_mask(_t(m), odd).numpy(),
        np.asarray(jmg._coarsen_mask(jnp.asarray(m), odd)))


def test_thin_mask_survives_coarsening():
    m = np.ones((65, 65), bool)
    m[33, :] = False              # odd row: vertex sampling would skip it
    mc = tmg._coarsen_mask(_t(m), (True, True)).numpy()
    assert mc.shape == (33, 33) and not mc[16:18, :].all()


@pytest.mark.parametrize("shape,bcs,deltas,min_size", [
    ((2048, 2048), ("fixed", "fixed"), (1e5, 1e5), 15),
    ((129, 128), ("extend", "periodic"), (1.2e5, 1e5), 15),
    ((37, 72), ("fixed", "periodic"), (5.0, 5.0), 15),
    ((330, 720), ("fixed", "periodic"), (100.0, 7.0, 7.0), 9),
    ((10, 14), ("fixed", "fixed"), (1.0, 1.0), 15),
])
def test_pyramid_plan(shape, bcs, deltas, min_size):
    assert (tmg._pyramid_plan(shape, bcs, deltas, min_size, 10)
            == jmg._pyramid_plan(shape, bcs, deltas, min_size, 10))


# ---------------------------------------------------------------- problems

def _poisson(ny=65, nx=128, bcs=("extend", "periodic"), cross=False):
    rng = np.random.default_rng(0)
    A = np.abs(rng.normal(1, .05, (ny, nx))) + 1.0
    C = np.abs(rng.normal(1, .05, (ny, nx))) + 1.0
    B = rng.normal(0, .05, (ny, nx)) if cross else 0.0
    F = rng.normal(0, 1, (ny, nx))
    Fdef = np.ones((ny, nx), bool)
    Fdef[ny // 3:ny // 2, nx // 4:3 * nx // 4] = False
    return "standard2d", (A, B, C, F, Fdef, (1.2e5, 1.0e5), bcs), {}


def _sphere(ny=37, nx=72):
    """Full-sphere spherical Poisson (poles included): the polar 1/cos^2
    metric picks x-line smoothing."""
    lat = np.linspace(-90.0, 90.0, ny)
    latr = np.deg2rad(lat)
    latH = np.empty_like(latr)
    latH[0] = np.nan
    latH[1:] = 0.5 * (latr[1:] + latr[:-1])
    A = np.broadcast_to(np.cos(latH)[:, None], (ny, nx))
    C = np.broadcast_to((1 / np.cos(latr))[:, None], (ny, nx))
    lon = np.deg2rad(np.linspace(0.0, 360.0 - 360.0 / nx, nx))
    F = (np.sin(3 * lon)[None, :] * np.cos(2 * latr)[:, None] * 1e-5
         * np.cos(latr)[:, None])
    deg2m = np.pi / 180 * 6371200
    return "standard2d", (A, 0.0, C, F, np.ones((ny, nx), bool),
                          (5 * deg2m, 5 * deg2m), ("fixed", "periodic")), {}


def _grid(dims, coords, ctype, bcs):
    return JGrid.make(dims, coords, ctype, bcs=bcs)


def _gm_test_e():
    """Gill-Matsuno standardised +E psi planes on a lat-lon grid (the
    half-grid NaN row the coarse levels fill)."""
    ny, nx = 65, 128
    lat = np.linspace(-64, 64, ny)
    lon = np.linspace(0, 360 - 360 / nx, nx)
    g = _grid(("lat", "lon"), (lat, lon), "lat-lon", ("fixed", "periodic"))
    Q = (-0.1 * np.exp(-(np.deg2rad(lat)[:, None] / 0.3) ** 2)
         * np.cos(3 * np.deg2rad(lon)[None, :]))
    mp = dict(default_mParams, epsilon=7e-5, Phi=5000.0)
    Fdef = np.ones((ny, nx), bool)
    planes = jprob.gillmatsuno_test_e_coeffs(jnp.asarray(Q),
                                             jnp.asarray(Fdef), g, mp)
    return "standard2d_e", tuple(np.asarray(p) for p in planes) + (
        Fdef, g.deltas, g.bcs), {}


def _fofonoff_e():
    """Fofonoff (B = C = 0: the coarsest level takes the optimal omega)."""
    yc, xc = np.linspace(0, 5e5, 33), np.linspace(0, 6e5, 65)
    g = _grid(("y", "x"), (yc, xc), "cartesian", ("fixed", "fixed"))
    mp = dict(default_mParams, f0=1e-4, beta=2e-11, c0=8e-9, c1=1e-4)
    F = np.zeros((33, 65))
    Fdef = np.ones((33, 65), bool)
    planes = jprob.fofonoff_e_coeffs(jnp.asarray(F), jnp.asarray(Fdef), g,
                                     mp)
    return "standard2d_e", tuple(np.asarray(p) for p in planes) + (
        Fdef, g.deltas, g.bcs), {}


def _omega(nz=7, ny=33, nx=64, batch=0):
    """QG omega on a -60..60 band: z-line smoothing."""
    lev = np.linspace(100000.0, 10000.0, nz)
    lat = np.linspace(-60.0, 60.0, ny)
    lon = np.linspace(0.0, 360.0 - 360.0 / nx, nx)
    g = _grid(("LEV", "lat", "lon"), (lev, lat, lon), "lat-lon",
              ("fixed", "fixed", "periodic"))
    mp = dict(default_mParams)
    mp["N2"] = np.where(lev > 25000.0, 1.5e-5, 6e-5).reshape(-1, 1, 1)
    F = np.random.default_rng(1).normal(0, 1e-15, (nz, ny, nx))
    Fdef = np.ones(F.shape, bool)
    A, B, C, Fs = jprob.omega_coeffs(jnp.asarray(F), jnp.asarray(Fdef), g,
                                     mp)
    return "standard3d", tuple(np.asarray(p) for p in (A, B, C, Fs)) + (
        Fdef, g.deltas, g.bcs), {}


def _stommel(ny=65, nx=128):
    y = np.linspace(0.0, 6e6, ny)
    x = np.linspace(0.0, 1e7, nx)
    g = _grid(("y", "x"), (y, x), "cartesian", ("fixed", "fixed"))
    curl = -1e-7 * np.sin(np.pi * y / 6e6)[:, None] * np.ones((1, nx))
    mp = dict(default_mParams, R=2e-4, D=100.0, beta=2e-11)
    planes = jprob.stommel_coeffs(jnp.asarray(curl),
                                  jnp.ones((ny, nx), bool), g, mp)
    return "general2d", tuple(np.asarray(p) for p in planes) + (
        np.ones((ny, nx), bool), g.deltas, g.bcs), {}


def _ocean3d():
    nz, ny, nx = 6, 33, 64
    lev = np.linspace(0.0, 2100.0, nz)
    lat = np.linspace(-60.0, 60.0, ny)
    lon = np.linspace(0.0, 360.0 - 360.0 / nx, nx)
    g = _grid(("lev", "lat", "lon"), (lev, lat, lon), "lat-lon",
              ("fixed", "extend", "periodic"))
    F = np.random.default_rng(1).normal(0.0, 1e-11, (nz, ny, nx))
    Fdef = np.ones((nz, ny, nx), bool)
    Fdef[:, 14:20, 20:30] = False
    mp = dict(default_mParams, epsilon=7e-6, k=1e-5, N2=1e-5)
    planes = jprob.ocean3d_coeffs(jnp.asarray(F), jnp.asarray(Fdef), g, mp)
    return "general3d", tuple(np.asarray(p) for p in planes) + (
        Fdef, g.deltas, g.bcs), {}


def _munk(ny=33, nx=65):
    Lx, Ly = 1e7, 2 * np.pi * 1e6
    x = np.linspace(0, Lx, nx)
    y = np.linspace(0, Ly, ny)
    g = _grid(("ydef", "xdef"), (y, x), "cartesian", ("fixed", "fixed"))
    curl = -0.3 * np.sin(np.pi * y[:, None] / Ly) * np.pi / Ly \
        * np.ones((1, nx))
    mp = dict(default_mParams, beta=1.8e-11, R=0.0008, D=200, A4=5e3)
    Fdef = np.ones((ny, nx), bool)
    coeffs, J = jprob.stommelmunk_coeffs(jnp.asarray(curl),
                                         jnp.asarray(Fdef), g, mp)
    return "bih2d", (tuple(np.asarray(c) for c in coeffs), np.asarray(J),
                     Fdef, g.deltas, g.bcs), dict(nu1=3, nu2=3)


CASES = {"poisson": _poisson, "poisson_fixed": functools.partial(
    _poisson, 33, 65, ("fixed", "fixed")),
    "cross": functools.partial(_poisson, 65, 65, ("fixed", "fixed"), True),
    "sphere": _sphere, "gm_test_e": _gm_test_e, "fofonoff_e": _fofonoff_e,
    "omega": _omega, "omega_small": functools.partial(_omega, 5, 17, 32),
    "stommel": _stommel, "stommel_small": functools.partial(_stommel, 33, 64),
    "ocean3d": _ocean3d, "munk": _munk}


@functools.lru_cache(maxsize=None)
def _pyramids(case):
    """(JAX pyramid, port pyramid, solve options) of a case, both built
    from the same host arrays."""
    kind, args, opts = CASES[case]()
    jp = getattr(jmg, f"build_pyramid_{kind}")(*args)
    targs = tuple(tuple(_t(c) for c in a) if isinstance(a, tuple)
                  and a and isinstance(a[0], np.ndarray)
                  else _t(a) if isinstance(a, np.ndarray) else a
                  for a in args)
    tp = getattr(tmg, f"build_pyramid_{kind}")(*targs)
    return jp, tp, opts


def _assert_same_levels(jp, tp):
    assert len(tp) == len(jp)
    for j, t in zip(jp, tp):
        assert t.odd == tuple(j.odd) and t.masked == j.masked
        assert t.smoother == j.smoother
        assert t.omega == pytest.approx(float(j.omega), rel=1e-15)
        js, ts = j.spec, t.spec
        assert ts.offsets == tuple(js.offsets) and ts.bcs == tuple(js.bcs)
        assert ts.bih == js.bih
        np.testing.assert_array_equal(ts.active.numpy(),
                                      np.asarray(js.active))
        for name in ("w", "w0", "g", "relax"):
            want = np.asarray(getattr(js, name))
            got = getattr(ts, name).numpy()
            assert got.shape == want.shape, name
            np.testing.assert_allclose(got, want, rtol=RTOL_PLANES, atol=0,
                                       err_msg=name)
            assert getattr(ts, name).is_contiguous(), name


@pytest.mark.parametrize("case", ["poisson", "cross", "sphere", "gm_test_e",
                                  "fofonoff_e", "omega", "stommel",
                                  "ocean3d", "munk"])
def test_pyramids(case):
    jp, tp, _ = _pyramids(case)
    _assert_same_levels(jp, tp)
    assert len(tp) >= 2


def test_pyramid_smoothers_and_omega_gate():
    """The stamped smoothers and the coarsest omega of each family."""
    want = {"poisson": "point", "sphere": "xline", "omega": "zline",
            "stommel": "point", "munk": "point", "ocean3d": "zline"}
    for case, sm in want.items():
        assert _pyramids(case)[1][0].smoother == sm, case
    assert _pyramids("gm_test_e")[1][-1].omega == 1.0       # B = -C
    assert _pyramids("fofonoff_e")[1][-1].omega > 1.0       # B = C = 0
    assert all(lv.omega == 1.0 for lv in _pyramids("munk")[1])


# ---------------------------------------------------------------- V-cycle

@pytest.mark.parametrize("case,smoother", [
    ("poisson", "point"), ("sphere", "xline"), ("omega_small", "zline"),
    ("omega_small", "zxline"), ("munk", "point")])
def test_vcycle_on_carried_levels(case, smoother):
    """One V-cycle from the same state and forcing on JAX's levels carried
    across, and the same on a batch of three (the port batched, JAX one
    member at a time)."""
    jp = _pyramids(case)[0]
    tp = tmg.levels_from_arrays(jp, dtype=torch.float64)
    spec = jp[0].spec
    rng = np.random.default_rng(7)
    act = np.asarray(spec.active)
    shape = act.shape
    S = rng.normal(0, 1e-2, (3,) + shape)
    g = np.where(act, rng.normal(0, 1.0, (3,) + shape), 0.0)
    args = (2, 2, 12, 0.8, smoother)
    # JAX one member at a time (vmap), in one compiled program
    want = np.asarray(jax.jit(lambda lv, s, g: jax.vmap(
        lambda s1, g1: jmg._vcycle(lv, 0, s1, g1, *args))(s, g))(
            tuple(jp), jnp.asarray(S), jnp.asarray(g)))
    got1 = tmg._vcycle(tp, 0, _t(S[0]), _t(g[0]), *args).numpy()
    got3 = tmg._vcycle(tp, 0, _t(S), _t(g), *args).numpy()
    scale = np.abs(want[0]).max()
    assert np.abs(got1 - want[0]).max() <= VCYCLE_TOL * scale
    for m in range(3):
        assert (np.abs(got3[m] - want[m]).max()
                <= VCYCLE_TOL * np.abs(want[m]).max())


# ---------------------------------------------------------------- solve_mg

def _batch_g(tp, scales=(1.0, 1e-3, 10.0), seed=3):
    spec = tp[0].spec
    act = spec.active.numpy()
    rng = np.random.default_rng(seed)
    g = rng.normal(0, 1, (len(scales),) + act.shape)
    g *= np.asarray(scales).reshape((-1,) + (1,) * act.ndim)
    return np.where(act, g * np.abs(spec.g.numpy()).max(), 0.0)


@pytest.mark.parametrize("case,accel,fmg,batched,kw", [
    ("poisson", None, False, False, dict(tol=1e-8, max_cycles=40)),
    ("poisson_fixed", "bicgstab", False, False, dict(tol=1e-8,
                                                     max_cycles=16)),
    ("sphere", None, True, True, dict(tol=1e-6, max_cycles=6)),
    ("omega", "auto", False, True, dict(tol=1e-6, max_cycles=15)),
    ("stommel", "auto", False, False, dict(tol=1e-10, max_cycles=5)),
    ("stommel_small", "auto", True, True, dict(tol=1e-10, max_cycles=5)),
    ("munk", "bicgstab", False, False, dict(tol=1e-6, max_cycles=8)),
])
def test_solve_mg(case, accel, fmg, batched, kw):
    """Equal cycles and ``converged``, the field within 1e-8 max|S|.  The
    Stommel cases end their V-cycle stage above tol, so "auto" runs the
    Krylov rescue (batched: member by member, a zero member skipping it)."""
    jp, tp, opts = _pyramids(case)
    kw = dict(kw, accel=accel, fmg=fmg, **opts)
    if batched:
        scales = ((1.0, 0.0, 10.0) if case.startswith("stommel")
                  else (1.0, 1e-3, 10.0))
        g0 = _batch_g(tp, scales)
        S0 = np.zeros(g0.shape)
        Sj, kj, rj, cj = jmg.solve_mg(jp, S0=jnp.asarray(S0),
                                      g0=jnp.asarray(g0), **kw)
        St, kt, rt, ct = tmg.solve_mg(tp, S0=_t(S0), g0=_t(g0), **kw)
    else:
        Sj, kj, rj, cj = jmg.solve_mg(jp, **kw)
        St, kt, rt, ct = tmg.solve_mg(tp, **kw)
    Sj = np.asarray(Sj)
    assert St.shape == Sj.shape
    assert (kt, ct) == (kj, cj), (kt, rt, kj, rj)
    assert np.abs(St.numpy() - Sj).max() <= FIELD_TOL * np.abs(Sj).max()


def test_solve_mg_refuses():
    tp = _pyramids("poisson")[1]
    with pytest.raises(ValueError):
        tmg.solve_mg(tp, accel="cg")
    with pytest.raises(ValueError):
        tmg.solve_mg(tp, S0=torch.zeros((2,) + tuple(tp[0].spec.w0.shape)))


def test_zero_forcing_no_nan():
    """All-zero forcing: relative residual 0 (the dtype floor), converged,
    in float32 too."""
    A = np.ones((33, 33), np.float32)
    F = np.zeros((33, 33), np.float32)
    for dt in (torch.float32, torch.float64):
        tp = tmg.build_pyramid_standard2d(
            torch.tensor(A, dtype=dt), 0.0, torch.tensor(A, dtype=dt),
            torch.tensor(F, dtype=dt), np.ones((33, 33), bool), (1.0, 1.0),
            ("fixed", "fixed"))
        S, k, res, conv = tmg.solve_mg(tp, tol=1e-6, max_cycles=5)
        assert np.isfinite(res) and res < 1e-6 and conv
        assert S.dtype == dt and float(S.abs().max()) == 0.0
