# -*- coding: utf-8 -*-
"""The device's work in a traced stretch, read from torch.profiler's raw
events, and the interval arithmetic the per-layer readers share.

``split`` and ``union`` are frozen copies of ``_intervals`` and ``_union``
in chip_smoke.py (lines 2600-2620), so a change there moves no number
here.  The one change: ``split`` takes the raw events that
:func:`device_ops` reads (``kineto_results.events()``), not the parsed
function events, whose parse takes seconds for tens of thousands of
launches; user-annotation ranges are not device work and are left out.
Times are nanoseconds on the profiler's clock, the Unix-epoch wall clock
that ``time.time_ns()`` reads.
"""
from __future__ import annotations

import bisect


def device_ops(prof):
    """(ops, launches): every operation that ran on the device as
    ``(name, start_ns, end_ns, correlation)``, and the host time of each
    runtime call that queued one, ``{correlation: start_ns}``."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    ops, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            continue
        if e.device_type() == cuda:
            s = e.start_ns()
            ops.append((e.name(), s, s + e.duration_ns(), e.correlation_id()))
        elif e.name().startswith("cu"):
            launches[e.correlation_id()] = e.start_ns()
    return ops, launches


def split(ops):
    """The device intervals of a traced stretch: host-to-device copies,
    device-to-host copies, and everything else (kernels, device copies)."""
    h2d, d2h, compute = [], [], []
    for name, s, e, _ in ops:
        (h2d if "HtoD" in name else d2h if "DtoH" in name
         else compute).append((s, e))
    return h2d, d2h, compute


def union(ivs):
    out = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def clip(merged, lo, hi):
    """A sorted union cut to [lo, hi]."""
    return [[max(s, lo), min(e, hi)] for s, e in merged if e > lo and s < hi]


def length(merged):
    return sum(e - s for s, e in merged)


def busy_ns(ops, lo, hi):
    """Nanoseconds of [lo, hi] in which some operation ran on the device."""
    return length(clip(union([(s, e) for _, s, e, _ in ops]), lo, hi))


def gaps(merged, lo, hi):
    """The idle intervals of [lo, hi] around a sorted union."""
    out, t = [], lo
    for s, e in clip(merged, lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


class Spans:
    """Host spans ``(name, start_ns, end_ns)``, nested or apart; answers
    which one holds a host time, the innermost first."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s[1], -s[2]))
        self.starts = [s[1] for s in self.spans]

    def holding(self, t):
        """Names of the spans that hold ``t``, the innermost first."""
        i = bisect.bisect_right(self.starts, t)
        out = []
        for name, s, e in reversed(self.spans[max(0, i - 64):i]):
            if s <= t < e:
                out.append((e - s, name))
        return [n for _, n in sorted(out)]

    def innermost(self, t, outside="between calls"):
        held = self.holding(t)
        return held[0] if held else outside

    def by_span(self, lo, hi, outside="between calls"):
        """[lo, hi) cut at every span boundary inside it: (name, ns) of
        each piece, named by the innermost span that holds it."""
        cuts = sorted({t for _, s, e in self.spans for t in (s, e)
                       if lo < t < hi})
        edges = [lo] + cuts + [hi]
        return [(self.innermost((a + b) // 2, outside), b - a)
                for a, b in zip(edges, edges[1:])]

    def total(self, name):
        return sum(e - s for n, s, e in self.spans if n == name)

    def count(self, name):
        return sum(1 for n, _, _ in self.spans if n == name)


def launched_in(ops, launches, spans, name):
    """The ops whose launch the host made inside a span called ``name``."""
    return [op for op in ops
            if op[3] in launches and name in spans.holding(launches[op[3]])]
