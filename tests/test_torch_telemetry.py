# -*- coding: utf-8 -*-
"""The port's spans and counters (xinvert_tpu_torch.telemetry,
solver.HOST_SYNCS) on the CPU: tracing off records nothing and counts no
copy; tracing on gives one span tree a call (names, order, nesting, one
call id, a sync around every check window); the sync counter grows by
exactly the reads that the iterations imply; the spans share
torch.profiler's clock; every route of ``_invert`` and ``_invert_mg``
leaves its ``engine.solve`` span.  The card's byte counts are in
tests/test_torch_cuda.py."""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import xinvert_tpu_torch as xt  # noqa: E402
from xinvert_tpu_torch import _staging, solver, telemetry  # noqa: E402
from xinvert_tpu_torch.models import api  # noqa: E402

PIECES = ["api.prepare", "builders.build", "api.init_state", "engine.solve",
          "api.finish"]


@pytest.fixture
def recording():
    """Tracing on for the test; off and drained after it."""
    telemetry.drain()
    telemetry.enable()
    try:
        yield
    finally:
        telemetry.disable()
        telemetry.drain()


def _poisson(noise=0.0, batch=2):
    """A masked batch of smooth (or, with ``noise``, rough) vorticity on a
    25 x 48 sphere."""
    lat = np.linspace(-90.0, 90.0, 25)
    lon = np.arange(48) * 7.5
    rng = np.random.default_rng(3)
    base = (np.cos(np.deg2rad(lat))[:, None] ** 2
            * np.sin(2 * np.deg2rad(lon))[None, :])
    v = 1e-5 * (base[None] * (1.0 + np.arange(batch))[:, None, None]
                + noise * rng.standard_normal((batch, 25, 48)))
    v[:, 6:9, 10:16] = np.nan
    return xt.Field(v.astype(np.float32), ("time", "lat", "lon"),
                    {"time": np.arange(batch), "lat": lat, "lon": lon})


def _omega(batch=2):
    """A batch of the benchmark's wave-train forcing on 9 x 12 x 24."""
    lev = np.linspace(100000.0, 10000.0, 9)
    lat = np.linspace(-82.5, 82.5, 12)
    lon = np.arange(24) * 15.0
    env = np.exp(-((np.abs(np.deg2rad(lat)) - np.deg2rad(45))
                   / np.deg2rad(15)) ** 2)
    vert = np.sin(np.pi * (100000.0 - lev) / 90000.0)
    wave = np.stack([np.sin((4 + b) * np.deg2rad(lon)) for b in range(batch)])
    v = 1e-15 * vert[None, :, None, None] * env[None, None, :, None] \
        * wave[:, None, None, :]
    F = xt.Field(v.astype(np.float32), ("time", "LEV", "lat", "lon"),
                 {"time": np.arange(batch), "LEV": lev, "lat": lat,
                  "lon": lon})
    N2 = xt.Field(np.where(lev > 25000.0, 1.5e-5, 6e-5), ("LEV",),
                  {"LEV": lev})
    return F, N2


def _call(kind, check_every=8, mx=3000, noise=0.0, **extra):
    """One CPU call of ``kind`` ('poisson' or 'omega')."""
    iP = {"undef": np.nan, "mxLoop": mx, "tolerance": 1e-6,
          "checkEvery": check_every, "printInfo": False, **extra}
    if kind == "poisson":
        iP["BCs"] = ["extend", "periodic"]
        return xt.invert_Poisson(_poisson(noise), dims=["lat", "lon"],
                                 iParams=iP, device="cpu")
    F, N2 = _omega()
    iP["BCs"] = ["fixed", "fixed", "periodic"]
    return xt.invert_omega(F, dims=["LEV", "lat", "lon"], iParams=iP,
                           mParams={"N2": N2}, device="cpu")


def _children(spans, parent):
    return [s for s in spans if s[3] == parent]


def _expected_reads(stop, check_every, mx):
    """Host reads of ``done`` in ``solver._solve_impl`` when every slice
    has stopped after ``stop`` sweeps (a multiple of ``check_every``) or
    never (None): one before each full window, and one for the clamped
    remainder unless the loop's last read already said done."""
    it = reads = 0
    while it + check_every <= mx:
        reads += 1
        if stop is not None and it >= stop:
            return reads
        it += check_every
    return reads + (mx - it > 0)


@pytest.mark.parametrize("kind", ["poisson", "omega"])
def test_off_records_nothing(kind):
    telemetry.drain()
    h2d, d2h = telemetry.H2D_BYTES, telemetry.D2H_BYTES
    _call(kind)
    assert telemetry.drain() == []
    assert (telemetry.H2D_BYTES, telemetry.D2H_BYTES) == (h2d, d2h)
    assert telemetry.span("api.invert") is telemetry.span("engine.sync")


@pytest.mark.parametrize("kind", ["poisson", "omega"])
def test_span_tree_of_a_call(recording, kind):
    _call(kind)
    spans = telemetry.drain()
    root = [i for i, s in enumerate(spans) if s[3] == -1]
    assert root == [0] and spans[0][0] == "api.invert"
    assert {s[4] for s in spans} == {0}
    for name, s, e, parent, _ in spans:
        assert s <= e, name
        if parent >= 0:
            assert spans[parent][1] <= s and e <= spans[parent][2], name
    assert [s[0] for s in _children(spans, 0)] == PIECES
    starts = [s[1] for s in spans]
    assert starts == sorted(starts)
    engine = next(i for i, s in enumerate(spans) if s[0] == "engine.solve")
    steps = [s[0] for s in _children(spans, engine)]
    windows = steps.count("engine.window")
    # the call stops on its tolerance: a read before every window and the
    # read that ends the loop, nothing after it
    assert int(api.LAST_SOLVE.iters.max()) < 3000
    assert steps == ["engine.sync", "engine.window"] * windows \
        + ["engine.sync"]
    assert windows == steps.count("engine.sync") - 1 > 1
    assert all(not _children(spans, i) for i, s in enumerate(spans)
               if s[0] in ("engine.window", "engine.sync"))


@pytest.mark.parametrize("kind,check_every,mx,noise", [
    ("poisson", 8, 3000, 0.0),        # stops on its tolerance
    ("poisson", 1, 3000, 0.0),        # the reference's cadence
    ("poisson", 8, 60, 1.0),          # the cap, a remainder of 4 sweeps
    ("poisson", 10, 60, 1.0),         # the cap, no remainder
    ("omega", 8, 3000, 0.0),
    ("omega", 32, 50, 0.0),           # the cap before the first full check
])
def test_host_syncs_follow_the_iterations(kind, check_every, mx, noise):
    before = solver.HOST_SYNCS
    _call(kind, check_every, mx, noise)
    iters = int(api.LAST_SOLVE.iters.max())
    stop = None if iters >= mx else iters
    assert solver.HOST_SYNCS - before \
        == _expected_reads(stop, check_every, mx)
    if stop is not None:
        assert solver.HOST_SYNCS - before == stop // check_every + 1


@pytest.mark.parametrize("kind", ["poisson", "omega"])
def test_spans_share_the_profilers_clock(recording, kind):
    """torch.profiler's CPU events and the spans read one clock: every
    ATen event that starts inside the call lies inside ``api.invert``,
    and the sweeps' norms (``aten::abs``, which the API and the builders
    do not call) lie inside ``engine.window`` spans."""
    from torch.profiler import ProfilerActivity, profile
    _call(kind)                              # warm
    telemetry.drain()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns()
        _call(kind)
        t1 = time.time_ns()
    spans = telemetry.drain()
    root = spans[0]
    assert root[0] == "api.invert" and t0 <= root[1] <= root[2] <= t1
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("aten::") and t0 <= e.start_ns() < t1]
    assert len(events) > 100
    for name, s, e in events:
        assert root[1] <= s and e <= root[2], name
    windows = [(s, e) for n, s, e, _, _ in spans if n == "engine.window"]
    sweeps = [ev for ev in events if ev[0] == "aten::abs"]
    assert len(sweeps) >= len(windows) > 1
    for name, s, e in sweeps:
        assert any(ws <= s and e <= we for ws, we in windows), name


@pytest.mark.parametrize("route,extra", [
    ("cheby", {"scheme": "cheby", "optArg": 1.2}),
    ("refined", {"tolType": "refined", "tolerance": 1e-5, "mxLoop": 200}),
    ("streamed", {"streamChunk": 1}),
])
def test_every_route_under_engine_solve(recording, route, extra):
    """The routes ``_invert`` takes in place of ``solve`` leave the call's
    five pieces, with the engine's work under ``engine.solve``."""
    _call("poisson", **extra)
    spans = telemetry.drain()
    assert [s[0] for s in _children(spans, 0)][:3] == PIECES[:3]
    top = [s[0] for s in _children(spans, 0)]
    assert top[-1] == "api.finish" and "engine.solve" in top
    names = {s[0] for s in spans}
    assert "engine.sync" in names and "engine.window" in names
    assert not names & {"copy.h2d", "copy.d2h"}


def test_masked_direct_spans(recording):
    """A masked direct solve through the API: the capacitance path's two
    pieces under its ``engine.solve``."""
    lat = np.linspace(-80.0, 80.0, 24)
    lon = np.arange(32) * 11.25
    v = (np.cos(np.deg2rad(lat))[:, None]
         * np.sin(np.deg2rad(lon))[None, :]) * 1e-5
    v[10:12, 8:10] = np.nan
    F = xt.Field(v, ("lat", "lon"), {"lat": lat, "lon": lon})
    xt.invert_Poisson(F, dims=["lat", "lon"], device="cpu",
                      iParams={"BCs": ["fixed", "periodic"],
                               "undef": np.nan, "scheme": "direct",
                               "printInfo": False})
    spans = telemetry.drain()
    assert [s[0] for s in _children(spans, 0)] == PIECES
    engine = PIECES.index("engine.solve")
    engine = [i for i, s in enumerate(spans) if s[3] == 0][engine]
    assert [s[0] for s in _children(spans, engine)] == \
        ["engine.direct.unit", "engine.direct.dense"]


def test_mg_entry_spans(recording):
    lat = np.linspace(-90.0, 90.0, 33)
    lon = np.arange(64) * 5.625
    v = (np.cos(np.deg2rad(lat))[:, None] ** 2
         * np.sin(2 * np.deg2rad(lon))[None, :]) * 1e-5
    F = xt.Field(v.astype(np.float32), ("lat", "lon"),
                 {"lat": lat, "lon": lon})
    with pytest.warns(UserWarning):
        xt.invert_Poisson_mg(F, dims=["lat", "lon"], device="cpu",
                             iParams={"BCs": ["extend", "periodic"],
                                      "printInfo": False},
                             tol=1e-30, max_cycles=2)
    spans = telemetry.drain()
    assert [s[0] for s in _children(spans, 0)] == PIECES
    assert {s[4] for s in spans} == {0}


def test_recorder_nesting_threads_and_drain(recording):
    """Spans nest by the open stack of their thread; a span opened on a
    worker thread hangs under the open root; drain clears the record."""
    seen = []
    with telemetry.span("api.invert"):
        with telemetry.span("engine.solve"):
            worker = threading.Thread(
                target=lambda: seen.append(
                    telemetry.span("copy.h2d").__enter__().__exit__()))
            worker.start()
            worker.join(timeout=10)
            assert not worker.is_alive()
            with telemetry.span("engine.sync"):
                pass
    with telemetry.span("api.invert"):
        pass
    spans = telemetry.drain()
    assert [(s[0], s[3], s[4]) for s in spans] == [
        ("api.invert", -1, 0), ("engine.solve", 0, 0), ("copy.h2d", 0, 0),
        ("engine.sync", 1, 0), ("api.invert", -1, 4)]
    assert telemetry.drain() == []


def test_copies_on_the_cpu_count_nothing():
    a = np.arange(12.0).reshape(3, 4)
    h2d, d2h = telemetry.H2D_BYTES, telemetry.D2H_BYTES
    t = telemetry.to_device(a, "cpu")
    assert t.device.type == "cpu" and np.shares_memory(t.numpy(), a)
    assert telemetry.to_host(t) is t
    assert (telemetry.H2D_BYTES, telemetry.D2H_BYTES) == (h2d, d2h)


C = _staging.CHUNK


@pytest.mark.parametrize("numel,itemsize,want", [
    (2 * C, 1, [(0, C), (C, C)]),                       # exact multiple
    (3 * C // 8, 4, [(0, C // 4), (C // 4, C // 8)]),   # a tail chunk
    (C + 1, 1, [(0, C), (C, 1)]),                       # one byte over
    (C // 8 - 1, 8, [(0, C // 8 - 1)]),                 # below one chunk
])
def test_staging_chunk_plan(numel, itemsize, want):
    assert _staging.plan(numel, itemsize) == want


def _sources():
    """(name, source, staged) with a chunk of 4096 bytes."""
    big = np.arange(64 * 64, dtype=np.float64).reshape(64, 64)
    grad = torch.ones(4096, requires_grad=True)
    return [
        ("numpy", big, True),
        ("tensor", torch.from_numpy(big), True),
        ("bool", big > 100, True),
        ("sub_chunk", big[:7], False),
        ("non_contiguous", big[:, ::2], False),
        ("fortran", big.T, False),
        ("negative_stride", big[::-1], False),
        ("tensor_non_contiguous", torch.from_numpy(big).t(), False),
        ("grad", grad, False),
        ("bfloat16", torch.ones(4096, dtype=torch.bfloat16), False),
        ("big_endian", big.astype(">f8"), False),
    ]


@pytest.mark.parametrize("case", [c[0] for c in _sources()])
def test_staging_routes_by_what_it_sees(monkeypatch, case):
    """Contiguous sources of a chunk or more are staged; CPU devices,
    smaller, strided, negative-stride and other sources take the plain
    copies, whose results stay torch.as_tensor's and count nothing
    staged."""
    monkeypatch.setattr(_staging, "CHUNK", 4096)
    _, a, staged = next(c for c in _sources() if c[0] == case)
    src = _staging.source(a)
    assert (src is not None) == staged
    if staged:
        assert src.data_ptr() == (a.data_ptr() if torch.is_tensor(a)
                                  else a.ctypes.data)
    before = telemetry.STAGED_BYTES
    try:
        want = torch.as_tensor(a)
    except (TypeError, ValueError) as e:
        with pytest.raises(type(e)):
            telemetry.to_device(a, "cpu")
    else:
        got = telemetry.to_device(a, "cpu")
        assert got.dtype == want.dtype and torch.equal(got, want)
        assert not _staging.takes(got)
        assert telemetry.to_host(got) is got
    assert telemetry.STAGED_BYTES == before


class _PlainBuffer(_staging._Buffer):
    """A staging buffer in pageable memory whose events are no-ops: the
    chunk loops run on the CPU."""
    __slots__ = ()

    def __init__(self):
        self.mem = torch.empty(_staging.CHUNK, dtype=torch.uint8)
        self.mem.fill_(0xA5)
        self.event = None

    def wait(self):
        pass

    def record(self, device):
        self.event = device


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.int64, torch.bool])
def test_staging_chunk_loops_round_trip(monkeypatch, dtype):
    """upload and download copy every chunk and the tail, whatever the
    size: one element under a chunk, one chunk, one element over, 2.5
    chunks; the download is a new writeable numpy array."""
    monkeypatch.setattr(_staging, "CHUNK", 256)
    monkeypatch.setattr(_staging, "_BUFFERS", {})
    monkeypatch.setattr(_staging, "_Buffer", _PlainBuffer)
    step = 256 // torch.empty(0, dtype=dtype).element_size()
    rng = np.random.default_rng(5)
    for n in (step - 1, step, step + 1, 5 * step // 2):
        a = torch.from_numpy(rng.standard_normal(n) * 100).to(dtype)
        if n % 5 == 0:
            a = a.reshape(5, -1)
        up = _staging.upload(a, torch.device("cpu"))
        down = _staging.download(up)
        assert up.data_ptr() != a.data_ptr()
        assert torch.equal(up, a) and torch.equal(down, a)
        v = down.numpy()
        assert v.flags.writeable and v.dtype == a.numpy().dtype
        assert not any(np.shares_memory(v, b.mem.numpy())
                       for bufs in _staging._BUFFERS.values()
                       for b in bufs)
    assert sorted(_staging._BUFFERS) == [(None, "d2h"), (None, "h2d")]


def test_staging_reserves_the_answer_array(monkeypatch):
    """``reserve`` gives a future of a new writeable array of the shape
    and dtype asked (None below one chunk or for a dtype numpy lacks);
    a download lands in it where shape and dtype fit, and in a new array
    where they do not."""
    monkeypatch.setattr(_staging, "CHUNK", 256)
    monkeypatch.setattr(_staging, "_BUFFERS", {})
    monkeypatch.setattr(_staging, "_Buffer", _PlainBuffer)
    assert _staging.reserve((7, 9), np.float32) is None
    assert _staging.reserve((700,), np.dtype("V4")) is None
    t = torch.arange(4 * 50 * 3, dtype=torch.float32).reshape(4, 50, 3)
    for shape, dtype, lands in [((4, 50, 3), np.float32, True),
                                ((4, 150), np.float32, False),
                                ((4, 50, 3), np.float64, False)]:
        into = _staging.reserve(shape, dtype)
        a = into.result(timeout=60)
        assert a.shape == shape and a.dtype == dtype and a.flags.writeable
        out = _staging.download(t, into)
        assert torch.equal(out, t)
        assert np.shares_memory(out.numpy(), a) == lands
