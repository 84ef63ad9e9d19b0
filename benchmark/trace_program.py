#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""A cell's traced stretch with the program's recorder on: the program's
own spans and counters beside the device trace.

    python3 benchmark/trace_program.py --workload <cell> --seed <n> \
        [--turns 2]

run from the root of a checkout on a CUDA card.  It resolves the cell by
its name in BENCHMARK.json, makes the inputs from the seed and makes one
warm call, as ``benchmark/run.py`` does; then ``--turns`` times, in turn,
a stretch of the mix's ``trace_calls`` calls under torch.profiler (CUDA
activity) with the benchmark's own spans and the program's recorder
(``xinvert_tpu_torch.telemetry``) on, and the same calls with it off.  It
prints one JSON line: from the stretches with the recorder on, the four
readings of ``harness/program.py`` (a ``.host`` suffix where the cell
reports ``fields_per_s.host``), the card's idle time by the innermost of
the benchmark's and the program's spans, and the span each sweep kernel
and each host<->device copy was launched in; from both, the calls' wall
time, device operations and host syncs, and the recorder's own host cost
a span.  The numbers are the card's: it exits non-zero without one.
"""
import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: where a cell's sweep kernels and the copies show in a device trace
KERNELS = ("sweeps_tiled", "color_sweep")
COPIES = ("Memcpy HtoD", "Memcpy DtoH")
#: the benchmark's own spans and the name of host time outside them
BENCH_SPANS = ("call", "builders", "engine", "between calls")


def _stretch(cell, entry, fields, kwargs, tele, on):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.harness import devtrace, program, window
    from xinvert_tpu_torch.models import api

    hooks = window._SpanHooks(cell.config["problem"])

    def traced_call(entry, field, kw):
        t0 = time.time_ns()
        try:
            return entry(field, **kw)
        finally:
            hooks.spans.append(("call", t0, time.time_ns()))

    on_call, grown = program.counting(traced_call)
    torch.cuda.synchronize()
    tele.drain()
    if on:
        tele.enable()
    try:
        with hooks, profile(activities=[ProfilerActivity.CUDA]) as prof:
            lo = time.time_ns()
            calls, _, _ = window._loop(entry, fields, kwargs, math.inf,
                                       cell.mix["trace_calls"], api,
                                       torch.cuda.synchronize, on_call)
            hi = time.time_ns()
    finally:
        tele.disable()
    ops, launches = devtrace.device_ops(prof)
    prog = program.Program(tele.drain(), *grown)
    return dict(calls=calls, ops=ops, launches=launches, spans=hooks.spans,
                prog=prog, lo=lo, hi=hi)


def _span_cost_ns(tele, n=200_000):
    """Host ns a span costs with the recorder on and with it off."""
    out = {}
    for on in (False, True):
        tele.drain()
        if on:
            tele.enable()
        t = time.perf_counter_ns()
        for _ in range(n):
            with tele.span("engine.sync"):
                pass
        out["on" if on else "off"] = (time.perf_counter_ns() - t) / n
        tele.disable()
        tele.drain()
    return out


def _readings(cell, st, suffix):
    from benchmark.harness import devtrace, program
    prog, k = st["prog"], cell.mix["fields_per_call"]
    both = program.merged(st["spans"], prog)
    alone = program.Nested([(n, s, e) for n, s, e, _, _ in prog.spans])
    gaps = program.idle_gaps(st["ops"], st["lo"], st["hi"], both)
    idle = sum(v for _, v in gaps)
    named = sum(v for n, v in gaps if n not in BENCH_SPANS)
    busy = devtrace.busy_ns(st["ops"], st["lo"], st["hi"])
    by_name = {}
    for n, s, e, _, _ in prog.spans:
        tot = by_name.setdefault(n, [0, 0])
        tot[0] += 1
        tot[1] += e - s
    return {
        "metrics": {
            "api.copy_ms" + suffix: program.api_copy_ms(prog),
            "api.copy_bytes_per_field" + suffix:
                program.api_copy_bytes_per_field(prog, k),
            "engine.syncs_per_call" + suffix:
                program.engine_syncs_per_call(prog),
            "engine.enqueue_ms" + suffix: program.engine_enqueue_ms(prog)},
        "window_s": (st["hi"] - st["lo"]) / 1e9,
        "idle_pct": 100.0 * (1 - busy / (st["hi"] - st["lo"])),
        "idle_gaps": gaps,
        "idle_named_by_program_pct": 100.0 * named / idle if idle else None,
        "spans_by_name": {n: [c, ns / 1e9] for n, (c, ns) in
                          sorted(by_name.items())},
        "launched_in": {m: program.launch_homes(st["ops"], st["launches"],
                                                alone, m)
                        for m in KERNELS + COPIES},
        "copy_bytes": prog.copy_bytes, "syncs": prog.syncs,
        "sweeps": [int(c.sweeps.max()) for c in st["calls"]],
    }


def _cost(st):
    n = len(st["calls"])
    return {"call_ms": [1e3 * (c.end - c.start) for c in st["calls"]],
            "device_ops_per_call": len(st["ops"]) / n,
            "syncs": st["prog"].syncs,
            "spans_per_call": len(st["prog"].spans) / n}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args(argv)

    from benchmark.harness import cell as cells
    from benchmark.harness import program, window
    cell = cells.resolve(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the readings are the card's",
              file=sys.stderr)
        return 2
    tele = program.recorder()
    if tele is None:
        print("the program has no recorder (xinvert_tpu_torch.telemetry)",
              file=sys.stderr)
        return 2
    rng_in, _ = window.streams(args.seed)
    pool, fields, entry, kwargs = window.prepare(cell, rng_in)
    entry(fields[0], **kwargs)
    torch.cuda.synchronize()
    suffix = (".host" if any(m["name"] == "fields_per_s.host"
                             for m, _ in cell.end_to_end) else "")
    traced, cost = [], {"on": [], "off": []}
    for _ in range(args.turns):
        for on in (True, False):
            st = _stretch(cell, entry, fields, kwargs, tele, on)
            cost["on" if on else "off"].append(_cost(st))
            if on:
                traced.append(_readings(cell, st, suffix))
    result = {"workload": cell.name, "seed": args.seed,
              "device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "traced": traced, "cost": cost,
              "span_ns": _span_cost_ns(tele)}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
