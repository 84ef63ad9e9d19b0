# -*- coding: utf-8 -*-
"""Stencil planes of the PyTorch port against the JAX package: the Poisson
builder (build_poisson -> standard_2d -> _finalize) on the masked ocean
fixture and on a batched synthetic lat-lon case, standard_2d with cross
terms, prune_zero_offsets, the 3-D families (standard_3d; general_3d
centered and upwinded) and the omega and 3-D ocean builders on lat-lon and
cartesian grids.  float64 on the CPU; planes at rtol 1e-13."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread keeps the parallel test workers from
# oversubscribing the cores (spinning OpenMP threads stall the others)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from xinvert_tpu import stencil as jst  # noqa: E402
from xinvert_tpu.grid import Grid as JGrid  # noqa: E402
from xinvert_tpu.io import open_dataset  # noqa: E402
from xinvert_tpu.models import problems as jprob  # noqa: E402
from xinvert_tpu.models.params import default_mParams  # noqa: E402
from xinvert_tpu_torch import stencil as tst  # noqa: E402
from xinvert_tpu_torch.grid import Grid as TGrid  # noqa: E402
from xinvert_tpu_torch.models import problems as tprob  # noqa: E402

RTOL = 1e-13
DATA = "Data/ocean_masked.nc"


def _assert_same_spec(js, ts):
    assert tuple(ts.offsets) == tuple(js.offsets)
    assert ts.bcs == tuple(js.bcs)
    assert ts.bih == js.bih
    assert ts.stop_on_zero_norm == js.stop_on_zero_norm
    np.testing.assert_array_equal(ts.active.numpy(), np.asarray(js.active))
    for name in ("w", "w0", "g", "relax"):
        a, b = getattr(ts, name).numpy(), np.asarray(getattr(js, name))
        assert a.shape == b.shape, name
        assert a.dtype == np.float64, name
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=0, err_msg=name)


def _poisson_both(vals, Fdef, lat, lon, bcs):
    jg = JGrid.make(("lat", "lon"), (lat, lon), "lat-lon", bcs=bcs)
    tg = TGrid.make(("lat", "lon"), (lat, lon), "lat-lon", bcs=bcs)
    js = jprob.build_poisson(jnp.asarray(vals), jnp.asarray(Fdef), jg,
                             default_mParams)
    ts = tprob.build_poisson(torch.as_tensor(vals), torch.as_tensor(Fdef),
                             tg, default_mParams)
    return js, ts


def test_poisson_planes_ocean_fixture():
    vor = open_dataset(DATA).vor
    vals = np.asarray(vor.values, np.float64)
    Fdef = ~np.isnan(vals)
    assert vals.shape == (180, 360) and (~Fdef).any()
    js, ts = _poisson_both(vals, Fdef, vor.coords["lat"], vor.coords["lon"],
                           ("extend", "periodic"))
    _assert_same_spec(js, ts)
    assert len(ts.offsets) == 4


@pytest.mark.parametrize("per_slice_mask", [False, True])
@pytest.mark.parametrize("bcs", [("extend", "periodic"), ("fixed", "fixed")])
def test_poisson_planes_batched_synthetic(per_slice_mask, bcs):
    rng = np.random.default_rng(3)
    nb, ny, nx = 3, 37, 72
    lat = np.linspace(-88.75, 88.75, ny)
    lon = np.linspace(0.0, 360.0 - 360.0 / nx, nx)
    vals = rng.standard_normal((nb, ny, nx))
    Fdef = np.ones((ny, nx), bool)
    Fdef[ny // 3:ny // 2, nx // 4:nx // 2] = False
    if per_slice_mask:
        Fdef = np.broadcast_to(Fdef, (nb, ny, nx)).copy()
        Fdef[1, 5:9, 10:20] = False
    js, ts = _poisson_both(vals, Fdef, lat, lon, bcs)
    _assert_same_spec(js, ts)
    # a batch-invariant mask keeps the weights unbatched; g is per slice
    assert ts.w.shape == ((4, nb, ny, nx) if per_slice_mask
                          else (4, ny, nx))
    assert ts.g.shape == (nb, ny, nx)


@pytest.mark.parametrize("include_cross", [None, True, False])
def test_standard_2d_cross_terms(include_cross):
    rng = np.random.default_rng(11)
    ny, nx = 20, 24
    A = np.abs(rng.normal(1.0, 0.1, (ny, nx))) + 0.5
    B = rng.normal(0.0, 0.05, (ny, nx))
    C = np.abs(rng.normal(1.0, 0.1, (ny, nx))) + 0.5
    F = rng.normal(0.0, 1.0, (2, ny, nx))
    Fdef = np.ones((ny, nx), bool)
    Fdef[4:7, 3:9] = False
    bcs = ("extend", "fixed")
    js = jst.standard_2d(jnp.asarray(A), jnp.asarray(B), jnp.asarray(C),
                         jnp.asarray(F), jnp.asarray(Fdef), (1.1e5, 1.0e5),
                         bcs, include_cross=include_cross)
    ts = tst.standard_2d(torch.as_tensor(A), torch.as_tensor(B),
                         torch.as_tensor(C), torch.as_tensor(F),
                         torch.as_tensor(Fdef), (1.1e5, 1.0e5), bcs,
                         include_cross=include_cross)
    _assert_same_spec(js, ts)
    assert len(ts.offsets) == (4 if include_cross is False else 8)


def test_prune_zero_offsets_keeps_same_offsets():
    rng = np.random.default_rng(5)
    ny, nx = 16, 20
    A = np.abs(rng.normal(1.0, 0.1, (ny, nx))) + 0.5
    C = np.abs(rng.normal(1.0, 0.1, (ny, nx))) + 0.5
    F = rng.normal(0.0, 1.0, (ny, nx))
    Fdef = np.ones((ny, nx), bool)
    zero = np.zeros((ny, nx))
    args = ((1.0, 1.0), ("fixed", "periodic"))
    # cross terms forced on with B == 0: four identically-zero planes
    js = jst.prune_zero_offsets(jst.standard_2d(
        jnp.asarray(A), jnp.asarray(zero), jnp.asarray(C), jnp.asarray(F),
        jnp.asarray(Fdef), *args, include_cross=True))
    ts = tst.prune_zero_offsets(tst.standard_2d(
        torch.as_tensor(A), torch.as_tensor(zero), torch.as_tensor(C),
        torch.as_tensor(F), torch.as_tensor(Fdef), *args,
        include_cross=True))
    assert len(ts.offsets) == 4
    _assert_same_spec(js, ts)
    # nothing to prune: the same spec object comes back
    full = tst.standard_2d(torch.as_tensor(A), 0.0, torch.as_tensor(C),
                           torch.as_tensor(F), torch.as_tensor(Fdef), *args)
    assert tst.prune_zero_offsets(full) is full


def test_from_arrays_round_trip():
    rng = np.random.default_rng(9)
    ny, nx = 12, 14
    js = jst.standard_2d(jnp.asarray(np.abs(rng.normal(1, .1, (ny, nx)))),
                         0.0, jnp.asarray(np.abs(rng.normal(1, .1, (ny, nx)))),
                         jnp.asarray(rng.normal(0, 1, (ny, nx))),
                         jnp.ones((ny, nx), bool), (1.0, 1.0),
                         ("extend", "periodic"))
    ts = tst.StencilSpec.from_arrays(
        np.asarray(js.w), np.asarray(js.w0), np.asarray(js.g),
        np.asarray(js.relax), np.asarray(js.active), js.offsets, js.bcs,
        js.bih, js.stop_on_zero_norm, device="cpu", dtype=torch.float64)
    _assert_same_spec(js, ts)
    assert ts.active.dtype == torch.bool
    f32 = tst.StencilSpec.from_arrays(
        np.asarray(js.w), np.asarray(js.w0), np.asarray(js.g),
        np.asarray(js.relax), np.asarray(js.active), js.offsets, js.bcs,
        device="cpu", dtype=torch.float32)
    assert f32.w.dtype == torch.float32 and f32.ndim == 2


# ---------------------------------------------------------------- 3-D


def _planes3d(shape=(6, 9, 11), seed=13):
    rng = np.random.default_rng(seed)
    pos = [np.abs(rng.normal(1.0, 0.1, shape)) + 0.5 for _ in range(3)]
    small = [rng.normal(0, 1e-6, shape) for _ in range(3)]
    G = -np.abs(rng.normal(1e-10, 1e-11, shape))
    H = rng.normal(0, 1.0, (2,) + shape)          # batched forcing
    Fdef = np.ones(shape, bool)
    Fdef[2:4, 3:6, 4:8] = False
    return pos, small, G, H, Fdef


@pytest.mark.parametrize("family,upwind", [
    ("standard", None), ("general", 0.0), ("general", 1.0),
    ("general", "plane")])
@pytest.mark.parametrize("bcs", [("fixed", "extend", "periodic"),
                                 ("fixed", "fixed", "fixed")])
def test_3d_family_planes(family, upwind, bcs):
    (A, B, C), (D, E, Fc), G, H, Fdef = _planes3d()
    deltas = (5e3, 1.1e5, 1.0e5)
    if family == "standard":
        js = jst.standard_3d(*map(jnp.asarray, (A, B, C, H, Fdef)), deltas,
                             bcs)
        ts = tst.standard_3d(*map(torch.as_tensor, (A, B, C, H, Fdef)),
                             deltas, bcs)
    else:
        if upwind == "plane":   # a per-cell sign plane
            up = np.where(np.random.default_rng(1).random(A.shape) > 0.5,
                          1.0, -1.0)
            ju, tu = jnp.asarray(up), torch.as_tensor(up)
        else:
            ju = tu = upwind
        args = (A, B, C, D, E, Fc, G, H, Fdef)
        js = jst.general_3d(*map(jnp.asarray, args), deltas, bcs, upwind=ju)
        ts = tst.general_3d(*map(torch.as_tensor, args), deltas, bcs,
                            upwind=tu)
    _assert_same_spec(js, ts)
    assert ts.ndim == 3 and len(ts.offsets) == 6
    assert ts.w.shape == (6,) + A.shape and ts.g.shape == H.shape
    # z boundaries are never updated, whatever the BCs
    assert not ts.active[[0, -1]].any()
    # from_arrays carries 3-D planes and 3-component offsets unchanged
    ta = tst.StencilSpec.from_arrays(
        np.asarray(js.w), np.asarray(js.w0), np.asarray(js.g),
        np.asarray(js.relax), np.asarray(js.active), js.offsets, js.bcs,
        js.bih, js.stop_on_zero_norm, device="cpu", dtype=torch.float64)
    _assert_same_spec(js, ta)


def _grid_pair(coords_type, bcs, shape=(7, 10, 12)):
    nz, ny, nx = shape
    if coords_type == "lat-lon":
        axes = (np.linspace(0.0, 1800.0, nz), np.linspace(-60.0, 60.0, ny),
                np.linspace(0.0, 360.0 - 360.0 / nx, nx))
    else:
        axes = (np.linspace(0.0, 1800.0, nz), np.arange(ny) * 1e5,
                np.arange(nx) * 1e5)
    dims = ("LEV", "lat", "lon")
    return (JGrid.make(dims, axes, coords_type, bcs=bcs),
            TGrid.make(dims, axes, coords_type, bcs=bcs))


@pytest.mark.parametrize("coords_type", ["lat-lon", "cartesian"])
@pytest.mark.parametrize("n2", ["scalar", "profile"])
@pytest.mark.parametrize("problem", ["omega", "3docean"])
def test_3d_builder_planes(problem, n2, coords_type):
    bcs = ("fixed", "extend", "periodic")
    jg, tg = _grid_pair(coords_type, bcs)
    nz = jg.shape[0]
    rng = np.random.default_rng(17)
    vals = rng.normal(0.0, 1e-11, (2,) + jg.shape)
    Fdef = np.ones(jg.shape, bool)
    Fdef[2:4, 3:6, 4:8] = False
    mp = dict(default_mParams)
    if n2 == "profile":          # a Field profile aligned to core rank
        mp["N2"] = (1e-5 * np.exp(-np.arange(nz) / 3.0) + 1e-7)[:, None,
                                                               None]
    js = jprob.BUILDERS[problem](jnp.asarray(vals), jnp.asarray(Fdef), jg, mp)
    ts = tprob.BUILDERS[problem](torch.as_tensor(vals),
                                 torch.as_tensor(Fdef), tg, mp)
    _assert_same_spec(js, ts)
