# -*- coding: utf-8 -*-
"""CPU tests of harness/program.py and trace_program.py: the readers of
the program's spans and counters computed by hand on a synthetic record,
the span lookup at any depth, idle time named by a program span, the
per-call counter growth, and no reading (and no exception) from a program
that records nothing.

    python -m pytest benchmark/tests -q
"""
from __future__ import annotations

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import trace_program  # noqa: E402
from benchmark.harness import program  # noqa: E402


def _record():
    """Two calls, as the program's recorder leaves them (ns)."""
    spans = []

    def add(name, s, e, parent, call):
        spans.append((name, s, e, parent, call))
        return len(spans) - 1

    for t in (0, 10_000):
        root = add("api.invert", t, t + 9_000, -1, len(spans))
        add("api.prepare", t + 100, t + 500, root, root)
        add("copy.h2d", t + 600, t + 1_600, root, root)
        add("builders.build", t + 1_700, t + 2_000, root, root)
        engine = add("engine.solve", t + 2_100, t + 7_000, root, root)
        for w in range(3):
            add("engine.sync", t + 2_200 + 1_000 * w, t + 2_400 + 1_000 * w,
                engine, root)
            add("engine.window", t + 2_500 + 1_000 * w,
                t + 2_800 + 1_000 * w, engine, root)
        add("engine.sync", t + 5_200, t + 5_400, engine, root)
        fin = add("api.finish", t + 7_100, t + 8_900, root, root)
        add("copy.d2h", t + 7_200, t + 8_200, fin, root)
    return program.Program(spans, copy_bytes=[4_000, 4_000], syncs=[4, 5])


def test_readers_by_hand():
    prog = _record()
    assert math.isclose(program.api_copy_ms(prog), 2_000 / 1e6)
    assert math.isclose(program.engine_enqueue_ms(prog), 900 / 1e6)
    assert program.api_copy_bytes_per_field(prog, 4) == 8_000 / 8
    assert program.engine_syncs_per_call(prog) == 4.5


def test_readers_read_nothing_from_a_silent_program():
    for reader in (program.api_copy_ms, program.engine_enqueue_ms,
                   program.engine_syncs_per_call):
        assert reader(None) is None
        assert reader(program.Program([], [], [])) is None
    assert program.api_copy_bytes_per_field(None, 4) is None
    assert program.api_copy_bytes_per_field(program.Program([], [], []),
                                            4) is None


def test_copies_outside_a_call_are_not_the_apis():
    prog = _record()
    prog.spans.append(("copy.h2d", 30_000, 90_000, -1, len(prog.spans)))
    assert math.isclose(program.api_copy_ms(prog), 2_000 / 1e6)


def test_innermost_at_any_depth():
    """A span that opened hundreds of spans earlier still holds a time
    after its last child (the benchmark's lookup window is 64 spans)."""
    spans = [("call", 0, 10_000), ("engine.solve", 10, 9_000)]
    spans += [("engine.window", 20 + 10 * i, 25 + 10 * i)
              for i in range(300)]
    nested = program.Nested(spans)
    assert nested.innermost(22) == "engine.window"
    assert nested.innermost(27) == "engine.solve"
    assert nested.innermost(8_000) == "engine.solve"
    assert nested.innermost(9_500) == "call"
    assert nested.innermost(20_000) == "between calls"
    # equal starts: the shorter is inner
    assert program.Nested([("a", 0, 10), ("b", 0, 5)]).innermost(3) == "b"


def test_breakdown_names_a_gap_by_a_program_span():
    prog = _record()
    bench = [("call", -50, 9_050), ("engine", 2_050, 7_050),
             ("call", 9_950, 19_050), ("engine", 12_050, 17_050)]
    # the card is busy from each window's start to its sync's end, and
    # over the copies
    ops = []
    for t in (0, 10_000):
        ops.append(("Memcpy HtoD", t + 700, t + 1_600, 1))
        ops += [("k", t + 2_550 + 1_000 * w, t + 3_300 + 1_000 * w, 2)
                for w in range(3)]
        ops.append(("Memcpy DtoH", t + 7_300, t + 8_200, 3))
    gaps = dict(program.idle_gaps(ops, 0, 19_000,
                                  program.merged(bench, prog)))
    assert gaps["engine.sync"] == pytest.approx(2 * (200 + 3 * 100) / 1e9)
    assert gaps["copy.h2d"] == pytest.approx(2 * 100 / 1e9)
    assert gaps["engine.window"] == pytest.approx(3 * 2 * 50 / 1e9)
    assert gaps["between calls"] == pytest.approx(900 / 1e9)
    assert sum(gaps.values()) == pytest.approx(
        (19_000 - 2 * (900 + 3 * 750 + 900)) / 1e9)
    assert "call" in gaps and "engine" in gaps
    # without the program's spans the same gaps fall to the wrappers
    coarse = dict(program.idle_gaps(ops, 0, 19_000,
                                    program.merged(bench, None)))
    assert set(coarse) == {"call", "engine", "between calls"}


def test_launch_homes():
    prog = _record()
    nested = program.Nested([(n, s, e) for n, s, e, _, _ in prog.spans])
    ops = [("void sor2d_sweeps_tiled_kernel", 0, 1, 1),
           ("void sor2d_sweeps_tiled_kernel", 0, 1, 2),
           ("Memcpy HtoD (Pageable -> Device)", 0, 1, 3),
           ("void sor2d_sweeps_tiled_kernel", 0, 1, 4)]
    launches = {1: 2_600, 2: 12_600, 3: 700}
    assert program.launch_homes(ops, launches, nested, "sweeps_tiled") == \
        {"engine.window": 2, "no launch record": 1}
    assert program.launch_homes(ops, launches, nested, "Memcpy HtoD") == \
        {"copy.h2d": 1}


def test_counting_keeps_each_calls_growth():
    from xinvert_tpu_torch import solver, telemetry

    def fake(entry, field, kwargs):
        telemetry.count_h2d(100)
        telemetry.count_d2h(20)
        solver.HOST_SYNCS += field
        return field

    call, (nbytes, syncs) = program.counting(fake)
    h2d, d2h = telemetry.H2D_BYTES, telemetry.D2H_BYTES
    try:
        assert [call(None, k, {}) for k in (3, 5)] == [3, 5]
        assert nbytes == [120, 120] and syncs == [3, 5]
    finally:
        telemetry.H2D_BYTES, telemetry.D2H_BYTES = h2d, d2h


def test_no_reading_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert trace_program.main(["--workload", "poisson_ncep25.year",
                               "--seed", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_span_lookup_matches_the_benchmarks_where_both_see():
    """Where nesting is shallow the lookup names what the benchmark's
    own ``devtrace.Spans`` names."""
    from benchmark.harness import devtrace
    spans = [("call", 0, 100), ("builders", 10, 20), ("engine", 30, 90),
             ("call", 200, 300)]
    ours, theirs = program.Nested(spans), devtrace.Spans(spans)
    for t in np.arange(-10, 320, 5):
        assert ours.innermost(int(t)) == theirs.innermost(int(t))
