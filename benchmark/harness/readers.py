# -*- coding: utf-8 -*-
"""The arithmetic of the metrics, one function a quantity; each file in
benchmark/metrics/ names the function it reads with.  A reader takes a
:class:`~benchmark.harness.window.Run` and returns a number, or None where
the run has nothing for it to read."""
from __future__ import annotations

import math

import numpy as np

from benchmark.harness import devtrace, peaks


def fields_per_s(run):
    """Fields returned over the window: every field of every call run back
    to back from the window's start, divided by the time from that start to
    the end of the last call (the one in flight at the deadline completed
    and counted)."""
    fields = run.cell.mix["fields_per_call"] * len(run.calls)
    return fields / (run.t1 - run.t0)


def setup_s(run):
    """From the process's start to the start of the window: imports, the
    card, the kernels' build (none on a cache hit), the inputs and one warm
    call at the cell's own shapes."""
    return run.setup_s


def api_host_ms(run):
    """Host time a call spends in the ``call`` span outside its
    ``builders`` and ``engine`` spans (models/api.py, field.py, grid.py:
    masking, the host-device copies, the returned Field), mean per call, in
    the traced stretch."""
    sp = run.trace.spans
    n = sp.count("call")
    if not n:
        return None
    return (sp.total("call") - sp.total("builders")
            - sp.total("engine")) / n / 1e6


def builders_host_ms(run):
    """Host time of the ``builders`` span (the builder the API looks up in
    models.problems.BUILDERS: coefficient planes, the stencil compile),
    mean per call, in the traced stretch."""
    sp = run.trace.spans
    n = sp.count("call")
    if not n or not sp.count("builders"):
        return None
    return sp.total("builders") / n / 1e6


def engine_sweeps_per_field(run):
    """The mean over the traced calls' fields of the sweeps the engine
    reports for each (models.api.LAST_SOLVE.iters)."""
    sweeps = [c.sweeps for c in run.calls if c.sweeps.size]
    if not sweeps:
        return None
    return float(np.mean(np.concatenate(sweeps)))


def wrappers_launches_per_sweep(run):
    """Growth of every module-level integer whose name ends in LAUNCHES in
    xinvert_tpu_torch.ops.sor2d and .sor3d over the traced calls, divided
    by the sweeps their batches ran (each call's largest count)."""
    sweeps = sum(int(c.sweeps.max()) for c in run.calls if c.sweeps.size)
    if not sweeps:
        return None
    return sum(c.launches for c in run.calls) / sweeps


def kernels_roofline_pct(run):
    """The least time the card could take for the fields' work, as a share
    of the device time of everything launched inside the ``engine`` span.

    Least time is the larger of
      - point-sweeps x FLOPs a point-sweep / the float32 peak outside the
        tensor cores, where point-sweeps are, over the traced fields, the
        sweeps the engine reports for the field x its active points, and
        the FLOPs come from the plain formula of the configuration's
        reference;
      - the calls' inputs (the forcing and the reference's coefficient
        planes at their own shapes) read once and their outputs written
        once, at the peak HBM bandwidth.
    Sweeps spent on slices already frozen count as device time, not as
    work.  Nothing here depends on the kernels' names, launches or sweeps a
    launch."""
    peak = peaks.lookup(run.device_kind)
    tr = run.trace
    if peak is None or tr is None:
        return None
    ref, cfg = run.cell.reference, run.cell.config
    k = run.cell.mix["fields_per_call"]
    done = [c for c in run.calls if c.sweeps.size]
    point_sweeps = sum(float((c.sweeps * run.active[c.pool]).sum())
                       for c in done)
    cells = math.prod(cfg["grid"][d][2] for d in cfg["dims"])
    bytes_ = len(done) * run.itemsize * (2 * k * cells
                                         + ref.coefficient_elements(cfg))
    least = max(point_sweeps * ref.FLOPS_PER_POINT_SWEEP / peak["flops_f32"],
                bytes_ / peak["hbm_bytes_per_s"])
    engine = devtrace.launched_in(tr.ops, tr.launches, tr.spans, "engine")
    device_s = sum(e - s for _, s, e, _ in engine) / 1e9
    if not device_s > 0 or not least > 0:
        return None
    return 100.0 * least / device_s


def device_idle_pct(run):
    """The share of the traced stretch in which no operation (kernel,
    copy) ran on the card: 1 - (union of the device intervals) / (the
    stretch's wall time), with chip_smoke.py's interval arithmetic, copied
    (harness/devtrace.py)."""
    tr = run.trace
    if tr is None or not tr.ops or tr.hi <= tr.lo:
        return None
    busy = devtrace.busy_ns(tr.ops, tr.lo, tr.hi)
    return 100.0 * (1.0 - busy / (tr.hi - tr.lo))
