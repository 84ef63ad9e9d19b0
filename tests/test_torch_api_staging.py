# -*- coding: utf-8 -*-
"""The API's steps around the solve on the solve's device
(``models/api.py``: ``_prologue``, ``_device_mask``, ``_finish``): the
fields of the entry points (``invert_*``, ``invert_*_mg``, ``core``'s
``inv_*``, ``animate_iteration``) equal, value for value with NaN in place,
dtype, dims and coords, the same call through the numpy steps they replaced
(``tests/api_numpy_steps.py``), and ``api.HOST_PASSES`` grows by 0 a call
without ``icbc`` and off the masked direct route.  Float32 on the CPU, the solve's dtype in both cells of
the benchmark."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import xinvert_tpu_torch as xt  # noqa: E402
from xinvert_tpu_torch.models import api  # noqa: E402

from xinvert_tpu_torch import stencil  # noqa: E402
from api_numpy_steps import (core, direct, frame, numpy_steps,  # noqa: E402
                             poisson_mg, same_field, sor)

LAT = np.linspace(-90.0, 90.0, 19)
LON = np.arange(36) * 10.0
TENTH = float(np.float32(0.1))


def _forcing(batch=3, block=np.nan, vary=False):
    """A smooth zonal-wave forcing on a 10-degree grid with a block of
    ``block`` (undefined) cells, shifted a column a slice when ``vary``."""
    base = (np.cos(np.deg2rad(LAT))[:, None] ** 2
            * np.sin(2 * np.deg2rad(LON))[None, :]) * 1e-5
    v = base[None] * np.arange(1.0, max(batch, 1) + 1)[:, None, None]
    for i in range(v.shape[0]):
        s = i if vary else 0
        v[i, 6:10, 10 + s:20 + s] = block
    coords = {"time": np.arange(v.shape[0]), "lat": LAT, "lon": LON}
    if not batch:
        return xt.Field(v[0].astype(np.float32), ("lat", "lon"), coords)
    return xt.Field(v.astype(np.float32), ("time", "lat", "lon"), coords)


def _omega():
    lev = np.linspace(100000.0, 20000.0, 5)
    lat, lon = np.linspace(-82.5, 82.5, 12), np.arange(24) * 15.0
    v = (np.sin(np.pi * (1e5 - lev) / 8e4)[:, None, None]
         * np.cos(np.deg2rad(lat))[None, :, None]
         * np.sin(2 * np.deg2rad(lon))[None, None, :])[None] \
        * np.arange(1.0, 3.0)[:, None, None, None] * 1e-15
    v[:, 2, 4:6, 8:12] = np.nan
    F = xt.Field(v.astype(np.float32), ("time", "LEV", "lat", "lon"),
                 {"time": np.arange(2), "LEV": lev, "lat": lat, "lon": lon})
    mP = {"N2": xt.Field(np.full(5, 2e-5), ("LEV",), {"LEV": lev})}
    return F, mP


def _case(name):
    """(entry, forcing, dims, ndim, run, icbc, mParams, iParams) of a
    case; the reference's ``run`` beside the entry point."""
    iP = {"BCs": ["fixed", "periodic"], "mxLoop": 150, "tolerance": 1e-7,
          "printInfo": False}
    dims, F, icbc, mP = ["lat", "lon"], _forcing(), None, None
    entry, ndim, run = xt.invert_Poisson, 2, sor("poisson")
    if name == "nan":                       # the year cell's BCs
        iP["BCs"] = ["extend", "periodic"]
    elif name == "numeric":
        F, iP["undef"] = _forcing(block=-9999.0), -9999.0
    elif name == "numeric_np64":            # np.where gives float64
        F, iP["undef"] = _forcing(block=-9999.0), np.float64(-9999.0)
    elif name == "tenth":                   # compared in float32: masked
        F, iP["undef"] = _forcing(block=TENTH), 0.1
    elif name == "tenth_np64":              # compared in float64: defined
        F, iP["undef"] = _forcing(block=TENTH), np.float64(0.1)
    elif name == "varying":
        F = _forcing(vary=True)
    elif name == "unbatched":
        F = _forcing(batch=0)
    elif name == "transposed":
        F = F.transpose("lat", "time", "lon")
    elif name in ("icbc", "icbc_warm"):
        icbc = xt.Field(np.full((19, 36), 2.0e5), ("lat", "lon"),
                        {"lat": LAT, "lon": LON})
        iP["warmStart"] = name == "icbc_warm"
    elif name == "stream":
        iP["streamChunk"] = 2
    elif name == "direct_stream":           # the capacitance route
        iP.update(scheme="direct", streamChunk=2)
        run = direct("poisson")
    elif name == "core":
        def entry(F, dims, mParams, **k):
            return xt.inv_standard2D(1.0, 0.0, 1.0, F, dims, **k)
        run = core(stencil.standard_2d, (1.0, 0.0, 1.0))
    elif name == "omega":
        F, mP = _omega()
        dims, ndim, entry, run = ["LEV", "lat", "lon"], 3, \
            xt.invert_omega, sor("omega")
        iP["BCs"] = ["fixed", "fixed", "periodic"]
    elif name == "mg":
        iP = {"BCs": ["fixed", "periodic"], "printInfo": False}
        return (lambda *a, **k: xt.invert_Poisson_mg(
            *a, tol=1e-5, max_cycles=8, **k), F, dims, ndim,
            poisson_mg(1e-5, 8), icbc, mP, iP)
    return entry, F, dims, ndim, run, icbc, mP, iP


CASES = ["nan", "numeric", "numeric_np64", "tenth", "tenth_np64", "varying",
         "unbatched", "transposed", "icbc", "icbc_warm", "stream",
         "direct_stream", "omega", "mg", "core"]


@pytest.mark.parametrize("name", CASES)
def test_fields_equal_the_numpy_steps(name):
    """Every case returns the numpy steps' Field, and makes a numpy pass
    over the batch only for the icbc first guess and the direct route's
    zero-filled forcing."""
    entry, F, dims, ndim, run, icbc, mP, iP = _case(name)
    want = numpy_steps(run, F, dims, ndim, icbc=icbc, mParams=mP,
                       iParams=iP)
    passes = api.HOST_PASSES
    got = entry(F, dims=dims, icbc=icbc, mParams=mP, iParams=iP,
                device="cpu")
    assert api.HOST_PASSES - passes == (icbc is not None
                                        or name == "direct_stream")
    assert same_field(got, want), name
    assert got.dims == F.dims


def test_the_cases_differ_where_they_should():
    """The dtype and masking cases reach what they are named for: a
    float64 scalar ``undef`` makes the answer float64, a float32 tenth is
    undefined only where numpy compares it in float32, and a mask that
    differs across the batch stays batched."""
    def run(name):
        entry, F, dims, ndim, _, icbc, mP, iP = _case(name)
        return entry(F, dims=dims, iParams=iP, device="cpu")
    assert run("numeric").values.dtype == np.float32
    assert run("numeric_np64").values.dtype == np.float64
    vals = torch.as_tensor(_forcing(block=TENTH).values)
    assert not api._device_mask(vals, 0.1, 2)[6:10, 10:20].any()
    assert api._device_mask(vals, np.float64(0.1), 2).all()
    same = torch.as_tensor(_forcing().values)
    assert api._device_mask(same, np.nan, 2).shape == (19, 36)
    vary = torch.as_tensor(_forcing(vary=True).values)
    assert api._device_mask(vary, np.nan, 2).shape == (3, 19, 36)


def test_animate_equals_the_numpy_steps():
    """``animate_iteration``'s frames, their undefined cells filled on the
    device, are the frames of the same trajectory through the numpy
    steps."""
    F = _forcing(batch=0)
    iP = {"BCs": ["fixed", "periodic"]}
    passes = api.HOST_PASSES
    got = xt.animate_iteration("Poisson", F, ["lat", "lon"], iParams=iP,
                               loop_per_frame=4, max_frames=3, device="cpu")
    assert api.HOST_PASSES == passes
    assert got.dims == ("iter", "lat", "lon") and got.shape[0] == 3
    for k in range(3):
        want = numpy_steps(frame("poisson", k, 4, 3), F, ["lat", "lon"], 2,
                           iParams=iP)
        assert got.values.dtype == want.values.dtype
        assert np.array_equal(got.values[k], want.values, equal_nan=True)
