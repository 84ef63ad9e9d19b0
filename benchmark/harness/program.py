# -*- coding: utf-8 -*-
"""The program's own spans and counters in a traced stretch, and the
arithmetic of the per-layer metrics that read them.

The program (``xinvert_tpu_torch``) records host spans when its recorder
is on (``xinvert_tpu_torch.telemetry``: ``enable``, ``disable``,
``drain``) as ``(name, start_ns, end_ns, parent, call)`` on the
profiler's clock, and counts, always, the bytes it copies between the
host and the card (``telemetry.H2D_BYTES``, ``D2H_BYTES``) and its host
reads of the engine's stop flags (``solver.HOST_SYNCS``).  Against a
program without them (an older checkout), :func:`counters` returns None
and every reader here returns None; nothing raises.

``benchmark/trace_program.py`` runs a cell's traced stretch with the
recorder on and prints what these readers read.
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np

from benchmark.harness import devtrace

#: the program's copy spans
COPIES = ("copy.h2d", "copy.d2h")


def counters():
    """(bytes copied both ways, host syncs of the engine) as the program
    counts them now, or None where the program has no such counters."""
    tele = sys.modules.get("xinvert_tpu_torch.telemetry")
    solver = sys.modules.get("xinvert_tpu_torch.solver")
    if tele is None or not hasattr(solver, "HOST_SYNCS"):
        return None
    return tele.H2D_BYTES + tele.D2H_BYTES, solver.HOST_SYNCS


def recorder():
    """The program's recorder module, or None where it has none."""
    try:
        from xinvert_tpu_torch import telemetry
    except ImportError:
        return None
    return telemetry


@dataclasses.dataclass
class Program:
    """What the program recorded over the traced calls."""
    spans: list               # (name, start_ns, end_ns, parent, call)
    copy_bytes: list          # per call: growth of H2D_BYTES + D2H_BYTES
    syncs: list               # per call: growth of solver.HOST_SYNCS


def counting(on_call):
    """``on_call`` for ``window._loop`` that also keeps each call's growth
    of the program's counters; returns (on_call, the per-call lists)."""
    grown = ([], [])

    def call(entry, field, kwargs):
        before = counters()
        try:
            return on_call(entry, field, kwargs)
        finally:
            after = counters()
            if before is not None:
                grown[0].append(after[0] - before[0])
                grown[1].append(after[1] - before[1])
    return call, grown


def _under_calls(spans, names):
    """Nanoseconds in spans called one of ``names`` that belong to an
    ``api.invert`` call, and the number of such calls."""
    roots = {i for i, s in enumerate(spans)
             if s[3] < 0 and s[0] == "api.invert"}
    ns = sum(e - s for n, s, e, _, call in spans
             if n in names and call in roots)
    return ns, len(roots)


def api_copy_ms(prog):
    """Host time a call in ``copy.h2d`` and ``copy.d2h`` spans under
    ``api.invert``: the API's pageable copies (and the streamed solve's
    enqueues), mean per call, ms."""
    if prog is None:
        return None
    ns, n = _under_calls(prog.spans, COPIES)
    return ns / n / 1e6 if n else None


def engine_enqueue_ms(prog):
    """Host time a call in ``engine.window`` spans: the host queuing each
    check window's sweeps and its stop test; the card waits through the
    part that follows a sync.  Mean per call, ms."""
    if prog is None:
        return None
    ns, n = _under_calls(prog.spans, ("engine.window",))
    return ns / n / 1e6 if n else None


def api_copy_bytes_per_field(prog, fields_per_call):
    """Growth of ``H2D_BYTES + D2H_BYTES`` over the traced calls, divided
    by their fields."""
    if prog is None or not prog.copy_bytes:
        return None
    return sum(prog.copy_bytes) / (len(prog.copy_bytes) * fields_per_call)


def engine_syncs_per_call(prog):
    """Growth of ``solver.HOST_SYNCS`` over the traced calls, divided by
    the calls."""
    if prog is None or not prog.syncs:
        return None
    return sum(prog.syncs) / len(prog.syncs)


class Nested:
    """Host spans ``(name, start_ns, end_ns)`` from several sources,
    nested to any depth; the innermost span that holds a time is the
    latest-starting one among those that hold it (the shortest on a
    tie)."""

    def __init__(self, spans):
        spans = sorted(spans, key=lambda s: (s[1], -s[2]))
        self.names = [s[0] for s in spans]
        self.starts = np.array([s[1] for s in spans], np.int64)
        self.ends = np.array([s[2] for s in spans], np.int64)

    def innermost(self, t, outside="between calls"):
        held = np.nonzero((self.starts <= t) & (t < self.ends))[0]
        return self.names[held[-1]] if held.size else outside

    def by_span(self, lo, hi, outside="between calls"):
        """[lo, hi) cut at every span boundary inside it: (name, ns) of
        each piece, named by the innermost span that holds it."""
        edges = np.concatenate([self.starts, self.ends])
        cuts = np.unique(edges[(edges > lo) & (edges < hi)])
        points = [lo, *cuts.tolist(), hi]
        return [(self.innermost((a + b) // 2, outside), b - a)
                for a, b in zip(points, points[1:])]


def merged(bench_spans, prog):
    """The benchmark's spans and the program's, together."""
    spans = list(bench_spans)
    if prog is not None:
        spans += [(n, s, e) for n, s, e, _, _ in prog.spans]
    return Nested(spans)


def idle_gaps(ops, lo, hi, nested):
    """Seconds of [lo, hi) in which the card ran nothing, by the innermost
    span the host was in, largest first."""
    busy = devtrace.union([(s, e) for _, s, e, _ in ops])
    idle = {}
    for s, e in devtrace.gaps(busy, lo, hi):
        for where, ns in nested.by_span(s, e):
            idle[where] = idle.get(where, 0) + ns
    return [[n, v / 1e9] for n, v in
            sorted(idle.items(), key=lambda kv: -kv[1])]


def launch_homes(ops, launches, nested, match):
    """For the device ops whose name contains ``match``: how many were
    launched inside each innermost span (by the host time of the runtime
    call that queued them), and how many have no launch record."""
    homes = {}
    for name, _, _, corr in ops:
        if match not in name:
            continue
        where = (nested.innermost(launches[corr]) if corr in launches
                 else "no launch record")
        homes[where] = homes.get(where, 0) + 1
    return homes
