# -*- coding: utf-8 -*-
"""A run of one cell: set-up, the timed window (or, traced, a steady
stretch of calls under torch.profiler), then the check of what the calls
returned.

The loop is closed with one caller: each call of the configuration's entry
point (``invert_Poisson``, ``invert_omega``, ...) starts when the one
before it has returned its numpy field, as a script over a reanalysis
record runs.  The window starts after set-up and runs calls back to back
until ``seconds`` have passed; the call in flight then is completed and
counted.
"""
from __future__ import annotations

import dataclasses
import math
import sys
import time
import traceback

import numpy as np

from benchmark.harness import devtrace, judge

#: the modules whose ``*LAUNCHES`` integers count kernel launches
LAUNCH_MODULES = ("xinvert_tpu_torch.ops.sor2d", "xinvert_tpu_torch.ops.sor3d")


@dataclasses.dataclass
class Call:
    pool: int                 # which input of the pool
    start: float              # host clock (s)
    end: float
    out: object               # the returned values (numpy) or None
    sweeps: np.ndarray        # sweeps the program reports, a field each
    launches: int             # kernel launches the call counted
    error: str = ""


@dataclasses.dataclass
class Trace:
    ops: list                 # (name, start_ns, end_ns, correlation)
    launches: dict            # correlation -> host ns of the launch
    spans: devtrace.Spans     # call / builders / engine
    lo: int                   # the traced stretch, ns
    hi: int


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    cell: object
    calls: list
    t0: float                 # window start and end (host clock, s)
    t1: float
    setup_s: float           # process start to window start
    active: list              # per pool input: active points a field
    itemsize: int
    device_kind: str
    trace: Trace = None


def streams(seed):
    """Independent generators for the inputs and for the check's sample,
    from any whole number."""
    ss = np.random.SeedSequence(int(seed) % 2 ** 64)
    return [np.random.default_rng(s) for s in ss.spawn(2)]


def make_pool(cell, rng):
    """The calls' inputs: ``pool_calls`` blocks of ``fields_per_call``
    fields drawn from the seed (a single map where a call takes one)."""
    k, n = cell.mix["fields_per_call"], cell.mix["pool_calls"]
    vals = cell.inputs.fields(cell.config, n * k, rng)
    return [vals[i] if k == 1 else vals[i * k:(i + 1) * k] for i in range(n)]


def prepare(cell, rng, device=None):
    """(pool values, their Fields, the entry point, its keyword
    arguments): the inputs of the calls, made from ``rng`` and handed to
    the entry point as a user's script does."""
    import xinvert_tpu_torch as xt
    cfg, k = cell.config, cell.mix["fields_per_call"]
    pool = make_pool(cell, rng)
    coords = cell.inputs.coords(cfg)
    dims = tuple(cfg["dims"]) if k == 1 else \
        (cfg["batch_dim"],) + tuple(cfg["dims"])
    fields = []
    for v in pool:
        c = dict(coords)
        if k > 1:
            c[cfg["batch_dim"]] = np.arange(v.shape[0])
        fields.append(xt.Field(v, dims, c))
    mparams = {name: xt.Field(*spec)
               for name, spec in cell.inputs.mparams(cfg).items()}
    iparams = dict(cfg["iParams"])
    if isinstance(iparams.get("undef"), str):
        iparams["undef"] = float(iparams["undef"])
    iparams.update(cell.mix.get("iParams", {}))
    kwargs = dict(dims=list(cfg["dims"]), coords=cfg["coords"],
                  iParams=iparams, mParams=mparams or None)
    if device is not None:
        kwargs["device"] = device
    return pool, fields, getattr(xt, cfg["entry"]), kwargs


def _launch_total():
    total = 0
    for name in LAUNCH_MODULES:
        mod = sys.modules.get(name)
        if mod is None:
            continue
        for attr, v in vars(mod).items():
            if attr.endswith("LAUNCHES") and isinstance(v, int):
                total += v
    return total


class _SpanHooks:
    """The benchmark's own spans around the entry point (``call``), the
    builder the API looks up in ``problems.BUILDERS`` (``builders``) and
    ``solve`` as ``models.api`` binds it (``engine``), read on the
    profiler's clock; installed for the traced stretch only."""

    def __init__(self, problem_key):
        from xinvert_tpu_torch.models import api, problems
        self.api, self.problems, self.key = api, problems, problem_key
        self.spans = []

    def wrap(self, name, fn):
        spans = self.spans

        def wrapped(*a, **k):
            t0 = time.time_ns()
            try:
                return fn(*a, **k)
            finally:
                spans.append((name, t0, time.time_ns()))
        return wrapped

    def __enter__(self):
        self.solve = self.api.solve
        self.builder = self.problems.BUILDERS[self.key]
        self.api.solve = self.wrap("engine", self.solve)
        self.problems.BUILDERS[self.key] = self.wrap("builders", self.builder)
        return self

    def __exit__(self, *exc):
        self.api.solve = self.solve
        self.problems.BUILDERS[self.key] = self.builder


def _loop(entry, fields, kwargs, seconds, max_calls, api, sync, on_call=None):
    calls = []
    t0 = time.perf_counter()
    i = 0
    while True:
        n0 = _launch_total()
        s = time.perf_counter()
        out, err = None, ""
        try:
            if on_call is not None:
                out = on_call(entry, fields[i % len(fields)], kwargs)
            else:
                out = entry(fields[i % len(fields)], **kwargs)
        except Exception:                         # a failed call, counted
            err = traceback.format_exc()
        e = time.perf_counter()
        sweeps = (api.LAST_SOLVE.iters if out is not None
                  else np.zeros(0, np.int64))
        calls.append(Call(i % len(fields), s, e, out, sweeps,
                          _launch_total() - n0, err))
        i += 1
        if e - t0 >= seconds or len(calls) >= max_calls:
            break
    sync()
    for c in calls:
        c.sweeps = np.atleast_1d(np.asarray(
            c.sweeps.cpu() if hasattr(c.sweeps, "cpu") else c.sweeps)
        ).astype(np.int64).ravel()
        if c.out is not None:
            if tuple(c.out.dims) != tuple(fields[c.pool].dims):
                c.out, c.error = None, f"dims {c.out.dims}"
            else:
                c.out = c.out.values
    return calls, t0, calls[-1].end


def run_cell(cell, seed, seconds, trace, device=None, t_start=None,
             log=print):
    """Run ``cell``: returns (result dict, check rows).  ``device=None``
    calls the entry points as users do (on the card); ``"cpu"`` runs the
    plain versions, for tests at small sizes."""
    import torch

    from xinvert_tpu_torch.models import api
    from xinvert_tpu_torch.ops import _build

    cfg, mix = cell.config, cell.mix
    on_card = device is None
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    setup = {"import_s": time.perf_counter() - t_start}
    rng_in, rng_sample = streams(seed)

    t = time.perf_counter()
    pool, fields, entry, kwargs = prepare(cell, rng_in, device)
    setup["inputs_s"] = time.perf_counter() - t

    t = time.perf_counter()
    entry(fields[0], **kwargs)
    sync()
    # the sources build together: the longest build is the wait
    build = max(_build.BUILD_SECONDS.values(), default=0.0)
    setup["kernel_build_s"] = build
    setup["warm_call_s"] = time.perf_counter() - t - build
    setup_s = time.perf_counter() - t_start
    log(f"setup: import {setup['import_s']:.3f} s, kernel build "
        f"{build:.3f} s, inputs {setup['inputs_s']:.3f} s, warm call "
        f"{setup['warm_call_s']:.3f} s; set-up {setup_s:.3f} s")

    tr = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU]
        hooks = _SpanHooks(cfg["problem"])

        def traced_call(entry, field, kw):
            t0 = time.time_ns()
            try:
                return entry(field, **kw)
            finally:
                hooks.spans.append(("call", t0, time.time_ns()))

        sync()
        with hooks, profile(activities=acts) as prof:
            lo = time.time_ns()
            calls, t0, t1 = _loop(entry, fields, kwargs, seconds,
                                  mix["trace_calls"], api, sync, traced_call)
            hi = time.time_ns()
        ops, launches = devtrace.device_ops(prof)
        tr = Trace(ops, launches, devtrace.Spans(hooks.spans), lo, hi)
        print(f"trace: {len(ops)} device ops, "
              f"{sum(op[3] in launches for op in ops)} with their launch, "
              f"{len(hooks.spans)} spans, {len(calls)} calls",
              file=sys.stderr)
    else:
        calls, t0, t1 = _loop(entry, fields, kwargs, seconds, math.inf, api,
                              sync)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    fifths = np.array_split(np.array([c.end - c.start for c in calls]), 5)
    print("calls: " + " ".join(f"{1e3 * f.mean():.2f}" for f in fifths
                               if f.size) + " ms a call, by fifth of the "
          f"window ({len(calls)} calls)", file=sys.stderr)

    errors = [c.error for c in calls if c.error]
    if errors:
        print(f"{len(errors)} calls failed; the first:\n{errors[0]}",
              file=sys.stderr)
    # the check, after the window and the peak's reading
    failed, mismatch = judge.scan_calls(calls, pool)
    answers = judge.sample(calls, mix["fields_per_call"], mix["check_fields"],
                           rng_sample)
    numbers = judge.judge(cfg, cell.reference, answers, pool,
                          mix["fields_per_call"],
                          "cuda" if on_card else "cpu")
    numbers["mask_mismatch"] = mismatch
    ok, rows = judge.verdict(numbers, cfg["limits"])

    active = [cell.reference.active(cfg, v).reshape(
        (-1,) + tuple(v.shape[-len(cfg["dims"]):])).sum(
            axis=tuple(range(1, 1 + len(cfg["dims"])))) for v in pool]
    run = Run(cell, calls, t0, t1, setup_s, active,
              np.dtype(cfg["dtype"]).itemsize,
              torch.cuda.get_device_name(0) if on_card else "cpu", tr)
    readers = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for entry_, reader in readers:
        v = reader.read(run)
        if v is not None:
            metrics[entry_["name"]] = {"value": v, "unit": entry_["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": run.device_kind,
           "count": cell.chips if on_card else 0,
           "memory_peak_bytes": int(peak)}
    result = {"correct": bool(ok and failed == 0 and calls),
              "attempted": len(calls), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = devtrace.busy_ns(tr.ops, tr.lo, tr.hi) / 1e9
        dev["window_s"] = (tr.hi - tr.lo) / 1e9
        result["breakdown"] = breakdown(tr)
    result["check"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result, rows


def breakdown(tr, top=10):
    """The device operations that took most time, by name, and the idle
    time of the device by the span the host was in."""
    by_name = {}
    for name, s, e, _ in tr.ops:
        by_name[name] = by_name.get(name, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = devtrace.union([(s, e) for _, s, e, _ in tr.ops])
    idle = {}
    for s, e in devtrace.gaps(busy, tr.lo, tr.hi):
        for where, ns in tr.spans.by_span(s, e):
            idle[where] = idle.get(where, 0) + ns
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:120], v / 1e9] for n, v in ops],
            "idle_gaps": [[n, v / 1e9] for n, v in gaps]}
