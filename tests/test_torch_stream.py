# -*- coding: utf-8 -*-
"""Host streaming of the PyTorch port (stream.solve_streamed,
``streamChunk``), on the CPU: chunked solves bit-identical to the resident
batched port solve of the same spec (S, iters, rel_change, overflow)
across chunk sizes, padding, shared and per-slice coefficients,
multi-dimensional batches, an unbatched state under a batched forcing and
the one-chunk fast path; the JAX package's streamed solve on the same
numpy inputs with equal iters (float64, S within 1e-10 of max|S|); the
``streamChunk`` iParam through ``invert_Poisson`` equal to the resident
call, and refused together with ``tolType='refined'``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from xinvert_tpu import stencil as jst  # noqa: E402
from xinvert_tpu.stream import solve_streamed as jstreamed  # noqa: E402
import xinvert_tpu_torch as xt  # noqa: E402
from xinvert_tpu_torch import stream  # noqa: E402
from xinvert_tpu_torch.models import api as tapi  # noqa: E402
from xinvert_tpu_torch.stencil import StencilSpec  # noqa: E402

CPU = {"device": "cpu"}


def _port(js):
    return StencilSpec.from_arrays(
        np.asarray(js.w), np.asarray(js.w0), np.asarray(js.g),
        np.asarray(js.relax), np.asarray(js.active), js.offsets, js.bcs,
        js.bih, js.stop_on_zero_norm, device="cpu", dtype=torch.float64)


def _batched_problem(B, ny=32, nx=48, seed=0, shared_weights=True,
                     varied=False):
    """A masked (extend, periodic) batch, as the JAX package's spec and the
    port's, and a zero state."""
    rng = np.random.default_rng(seed)
    A = np.abs(rng.normal(1, 0.1, (ny, nx))) + 0.5
    if not shared_weights:
        A = np.abs(rng.normal(1, 0.1, (B, ny, nx))) + 0.5
    F = rng.normal(0, 1, (B, ny, nx))
    if varied:
        # the change rule is scale-invariant, so the forcing's structure
        # sets the convergence speed: rough, smooth and point-source slices
        # give different per-slice loop counts
        yy, xx = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
        for b in range(1, B, 3):
            F[b] = np.sin(2 * np.pi * yy / ny) * np.cos(2 * np.pi * xx / nx)
        for b in range(2, B, 3):
            F[b] = 0.0
            F[b, ny // 2, nx // 2] = 1.0
    Fdef = np.ones((ny, nx), bool)
    Fdef[10:16, 20:30] = False
    js = jst.standard_2d(A, 0.0, A, F, Fdef, (1.3, 1.0),
                         ("extend", "periodic"))
    return js, _port(js), np.zeros((B, ny, nx))


def _assert_equal(got, ref):
    for f in ("S", "iters", "rel_change", "overflow"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.device.type == "cpu" and a.shape == b.shape, f
        assert torch.equal(a, b), f


def _resident(ts, S0, omega, **kw):
    return xt.solve(ts, torch.as_tensor(S0), omega, **kw)


@pytest.mark.parametrize("B,chunk", [(6, 2), (5, 2), (7, 3)])
def test_streamed_matches_resident(B, chunk):
    """Divisible and padded (B % chunk != 0) chunkings are bit-identical,
    per-slice telemetry included; the JAX streamed solve of the padded
    chunkings agrees."""
    js, ts, S0 = _batched_problem(B, varied=True)
    kw = dict(tol=1e-6, max_iters=2000, check_every=4)
    ref = _resident(ts, S0, None, **kw)
    got = xt.solve_streamed(ts, S0, None, chunk=chunk, **kw, **CPU)
    assert got.S.shape == (B,) + S0.shape[1:]
    assert len(set(ref.iters.tolist())) > 1      # really different counts
    _assert_equal(got, ref)
    if B % chunk == 0:
        return
    rj = jstreamed(js, S0, None, chunk=chunk, **kw)
    assert np.array_equal(got.iters.numpy(), np.asarray(rj.iters))
    Sj = np.asarray(rj.S)
    assert np.abs(got.S.numpy() - Sj).max() <= 1e-10 * np.abs(Sj).max()


def test_streamed_per_slice_weights():
    """Per-slice coefficient planes stream with the forcing."""
    _, ts, S0 = _batched_problem(5, seed=3, shared_weights=False)
    assert ts.w.ndim == 4                        # (K, B, ny, nx)
    kw = dict(tol=1e-7, max_iters=500)
    ref = _resident(ts, S0, 1.5, **kw)
    _assert_equal(xt.solve_streamed(ts, S0, 1.5, chunk=2, **kw, **CPU), ref)


def test_streamed_multidim_batch():
    """(time, member) batches flatten onto the stream axis and reshape
    back, like the resident batched path."""
    ny, nx = 32, 48
    rng = np.random.default_rng(7)
    A = np.abs(rng.normal(1, 0.1, (ny, nx))) + 0.5
    F = rng.normal(0, 1, (2, 3, ny, nx))
    js = jst.standard_2d(A, 0.0, A, F, np.ones((ny, nx), bool), (1.3, 1.0),
                         ("extend", "periodic"))
    ts = _port(js)
    S0 = np.zeros((2, 3, ny, nx))
    kw = dict(tol=1e-7, max_iters=400)
    ref = _resident(ts, S0, 1.5, **kw)
    got = xt.solve_streamed(ts, S0, 1.5, chunk=2, **kw, **CPU)
    assert got.S.shape == (2, 3, ny, nx) and got.iters.shape == (2, 3)
    _assert_equal(got, ref)


def test_streamed_unbatched_state_batched_forcing():
    """An unbatched state broadcasts across the stream (one device copy);
    the result's batch shape follows the spec's."""
    _, ts, S0 = _batched_problem(5, seed=11)
    kw = dict(tol=1e-7, max_iters=300)
    ref = _resident(ts, S0, 1.5, **kw)
    got = xt.solve_streamed(ts, np.zeros(S0.shape[1:]), 1.5, chunk=2, **kw,
                            **CPU)
    _assert_equal(got, ref)


def test_streamed_single_chunk_fastpath(monkeypatch):
    """B <= chunk is one resident solve of the untouched spec."""
    _, ts, S0 = _batched_problem(3, seed=13)
    kw = dict(tol=1e-7, max_iters=300)
    ref = _resident(ts, S0, 1.5, **kw)
    calls = []
    real = stream.solve
    monkeypatch.setattr(stream, "solve",
                        lambda *a, **k: calls.append(a[1].shape)
                        or real(*a, **k))
    _assert_equal(xt.solve_streamed(ts, S0, 1.5, chunk=8, **kw, **CPU), ref)
    assert calls == [S0.shape]


def test_streamed_pads_the_last_chunk(monkeypatch):
    """Every chunk solve has the chunk's shape: the last one is padded
    with its final slice."""
    _, ts, S0 = _batched_problem(5, seed=17)
    shapes = []
    real = stream.solve
    monkeypatch.setattr(stream, "solve",
                        lambda *a, **k: shapes.append(tuple(a[1].shape))
                        or real(*a, **k))
    xt.solve_streamed(ts, S0, 1.5, tol=1e-7, max_iters=50, chunk=2, **CPU)
    assert shapes == [(2, 32, 48)] * 3


def test_streamed_under_thread_switching():
    """The staging and fetching workers share the pinned buffers and the
    output arrays with the solving thread: with the interpreter switching
    threads every microsecond, chunk 1 (the most hand-offs) still gives
    the resident solve bit for bit."""
    import sys
    _, ts, S0 = _batched_problem(7, ny=16, nx=24, seed=23, varied=True)
    kw = dict(tol=1e-6, max_iters=200, check_every=4)
    ref = _resident(ts, S0, None, **kw)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = xt.solve_streamed(ts, S0, None, chunk=1, **kw, **CPU)
    finally:
        sys.setswitchinterval(old)
    _assert_equal(got, ref)


def test_streamed_refuses_device_tensors_and_bad_chunks():
    _, ts, S0 = _batched_problem(3, seed=19)
    with pytest.raises(ValueError, match="chunk"):
        xt.solve_streamed(ts, S0, 1.5, chunk=0, **CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            xt.solve_streamed(ts, S0, 1.5, chunk=2)


@pytest.mark.parametrize("P", [1, 2, 7, 64, 1000])
def test_slice_totals_batch_invariant(P):
    """The kernels' per-slice |S| totals (ops._driver.slice_totals): the
    sum of the partials, each slice's bits the same whatever batch it is
    summed in."""
    from xinvert_tpu_torch.ops._driver import slice_totals
    x = torch.as_tensor(np.random.default_rng(P).random((5, P))
                        * np.logspace(-8, 8, P), dtype=torch.float32)
    tot = slice_totals(x)
    assert tot.shape == (5,)
    np.testing.assert_allclose(tot.double().numpy(),
                               x.double().sum(-1).numpy(), rtol=1e-6)
    for i in range(5):
        for c in (1, 2):
            assert torch.equal(slice_totals(x[i:i + c]), tot[i:i + c])


def _helmholtz_like():
    """A masked global vorticity batch on the repository's fixture."""
    vor = xt.open_dataset("Data/ocean_masked.nc").vor.isel(
        lat=slice(None, None, 3), lon=slice(None, None, 3))   # 60x120
    return xt.Field(np.stack([vor.values, 0.5 * vor.values,
                              -vor.values]),
                    ("time",) + vor.dims,
                    dict(vor.coords, time=np.arange(3.0)))


@pytest.fixture
def f64():
    dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(dtype)


@pytest.mark.parametrize("chunk", [1, 2])
def test_streamchunk_iparam_matches_resident(f64, chunk):
    """iParams['streamChunk'] routes invert_Poisson through solve_streamed
    and reproduces the resident call exactly; LAST_SOLVE holds host
    tensors."""
    vor = _helmholtz_like()
    iP = {"BCs": ["extend", "periodic"], "undef": np.nan,
          "mxLoop": 300, "tolerance": 1e-11, "printInfo": False}
    res = xt.invert_Poisson(vor, dims=["lat", "lon"], iParams=iP, **CPU)
    ref = tapi.LAST_SOLVE
    got = xt.invert_Poisson(vor, dims=["lat", "lon"],
                            iParams={**iP, "streamChunk": chunk}, **CPU)
    assert np.array_equal(got.values, res.values, equal_nan=True)
    _assert_equal(tapi.LAST_SOLVE, ref)


def test_refined_plus_streamchunk_rejected(f64):
    """tolType='refined' with streamChunk is an explicit error (the
    refined state must stay resident on the device)."""
    vor = _helmholtz_like()
    iP = {"BCs": ["extend", "periodic"], "undef": np.nan,
          "mxLoop": 50, "tolerance": 1e-6, "printInfo": False,
          "tolType": "refined", "streamChunk": 1}
    with pytest.raises(ValueError, match="refined.*streamChunk"):
        xt.invert_Poisson(vor, dims=["lat", "lon"], iParams=iP, **CPU)
