# -*- coding: utf-8 -*-
"""CPU tests of the benchmark's harness: names resolve to files, each
configuration's CPU grid is usable, the generators repeat with the seed,
the interval and roofline arithmetic on hand-made inputs, the plain
reference against known solves, the import rules, the check's verdict on
sound runs, on its control and on planted faults, and the hooks by which
a configuration's reference states its own relaxation factor and boundary
pre-pass.  Tests that need the card carry the ``cuda`` marker.

    python -m pytest benchmark/tests -q
"""
from __future__ import annotations

import ast
import copy
import dataclasses
import functools
import json
import math
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import calibrate, run  # noqa: E402
from benchmark.harness import cell as cells  # noqa: E402
from benchmark.harness import devtrace, judge, window  # noqa: E402
from benchmark.reference import redblack  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
CONFIGS = [c["name"] for c in BENCH["configs"]]

#: each configuration's cell
CELL_OF = {w["config"]: w["name"] for w in BENCH["workloads"]}


def small_cell(name, **mix):
    """The cell on its configuration's ``cpu_grid`` (the cells' own sizes
    run on the card), 4 fields a call (or ``fields_per_call``) and the
    card's check cadence (the engine checks every sweep on the CPU unless
    told)."""
    c = cells.resolve(name)
    c.config = copy.deepcopy(c.config)
    c.config["grid"] = c.config["cpu_grid"]
    c.mix = dict(c.mix, iParams={"checkEvery": c.config["check_window"]},
                 **dict(dict(fields_per_call=4), **mix))
    return c


def run_small(name, seed=12345, **mix):
    c = small_cell(name, **dict(dict(pool_calls=3, check_fields=3,
                                     trace_calls=3), **mix))
    return window.run_cell(c, seed, 0.2, False, device="cpu",
                           t_start=time.perf_counter(), log=lambda *_: None)


# ------------------------------------------------------------ by name

@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    c = cells.resolve(name)
    w = {x["name"]: x for x in BENCH["workloads"]}[name]
    conf = {x["name"]: x for x in BENCH["configs"]}[w["config"]]
    assert Path(ROOT / conf["file"]).is_file()
    assert c.config["name"] == w["config"]
    for key in ("fields_per_call", "pool_calls", "check_fields",
                "trace_calls"):
        assert c.mix[key] >= 1
    assert callable(c.inputs.fields) and callable(c.reference.build)
    assert c.reference.FLOPS_PER_POINT_SWEEP == \
        redblack.flops_per_point_sweep(len(c.reference.OFFSETS))
    names = {m["name"] for m, _ in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert {m["name"] for m, _ in c.per_layer} == \
        {m["name"] for m in BENCH["per_layer"]
         if name in m.get("workloads", [name])}
    for m, _ in c.per_layer:
        assert m["moves"] in names
    for _, reader in c.end_to_end + c.per_layer:
        assert callable(reader.read)
    assert set(c.config["limits"]) == {"mask_mismatch", "field_gap",
                                       "stop_change"}


def test_unknown_cell_refused():
    with pytest.raises(KeyError):
        cells.resolve("no_such.cell")


def test_benchmark_json_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()


def test_benchmark_json_contract():
    """The limits of BENCHMARK.json's own format: names, units, lines,
    bounds, cells and the files each names."""
    import re
    name_re = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit_re = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

    def line(x):
        return isinstance(x, str) and 1 <= len(x) <= 200 and \
            "\n" not in x and "\t" not in x

    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32 and all(map(line,
                                                          BENCH["command"]))
    assert 1 <= len(BENCH["paths"]) <= 16
    assert isinstance(BENCH["run_seconds"], int) and \
        1 <= BENCH["run_seconds"] <= 51
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for group in (BENCH["configs"], BENCH["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(name_re.match(n) for n in names)
    configs = {c["name"] for c in BENCH["configs"]}
    cells_ = {w["name"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["source"]) and line(c["why"]) and c["reduced"] == []
        assert c["file"].startswith("benchmark/")
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1
        assert line(w["why"]) and name_re.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line(m["layer"]) and m["moves"] in e2e
        for w in m.get("workloads", cells_):
            assert w in e2e[m["moves"]].get("workloads", cells_)
    for m in metrics:
        assert unit_re.match(m["unit"]) and m["better"] in ("lower",
                                                            "higher")
        assert set(m.get("workloads", cells_)) <= cells_
    for w in cells_:
        got = [m for m in metrics if w in m.get("workloads", cells_)]
        assert sum(m in BENCH["end_to_end"] for m in got) >= 2
        assert any(m in BENCH["per_layer"] for m in got)
    # the layers are named alike, letter for letter
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


# ---------------------------------------------------------- generators

@pytest.mark.parametrize("config", CONFIGS)
def test_cpu_grid_is_usable(config):
    """The configuration's ``cpu_grid`` has the axes of its ``grid``, in
    order; each axis 5 to the full count of points, strictly monotonic
    and evenly spaced, running the way the full grid's axis runs."""
    c = cells.resolve(CELL_OF[config])
    cfg = c.config
    assert list(cfg["cpu_grid"]) == list(cfg["grid"]) == list(cfg["dims"])
    got = c.inputs.coords(dict(cfg, grid=cfg["cpu_grid"]))
    whole = c.inputs.coords(cfg)
    for d, (_, _, n) in cfg["cpu_grid"].items():
        assert type(n) is int and 5 <= n <= cfg["grid"][d][2], d
        assert got[d].shape == (n,)
        step = np.diff(got[d])
        assert np.all(np.sign(step) == np.sign(whole[d][1] - whole[d][0]))
        np.testing.assert_allclose(step, step[0], rtol=1e-9)


@pytest.mark.parametrize("config", CONFIGS)
def test_generators_repeat_with_the_seed(config):
    c = small_cell(CELL_OF[config])
    a = c.inputs.fields(c.config, 5, window.streams(2 ** 31 + 7)[0])
    b = c.inputs.fields(c.config, 5, window.streams(2 ** 31 + 7)[0])
    d = c.inputs.fields(c.config, 5, window.streams(2 ** 31 + 8)[0])
    assert a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(np.nan_to_num(a), np.nan_to_num(d))
    # every field draws its own: no two fields alike
    flat = np.nan_to_num(a).reshape(5, -1)
    assert len({f.tobytes() for f in flat}) == 5


def test_poisson_forcing_recipe():
    c = small_cell("poisson_ncep25.year")
    v = c.inputs.fields(c.config, 2, window.streams(1)[0])
    ny, nx = v.shape[1:]
    assert np.isnan(v[:, ny // 3:ny // 2, nx // 4:nx // 2]).all()
    assert np.isnan(v).sum() == 2 * (ny // 2 - ny // 3) * (nx // 2 - nx // 4)


def test_pool_blocks():
    c = small_cell("omega_nb11.month", pool_calls=3)
    pool = window.make_pool(c, window.streams(3)[0])
    assert [p.shape for p in pool] == [(4, 9, 12, 24)] * 3
    c = small_cell("poisson_ncep25.year", pool_calls=2, fields_per_call=1)
    assert [p.shape for p in window.make_pool(c, window.streams(3)[0])] == \
        [(25, 24)] * 2


# --------------------------------------------------- interval arithmetic

def test_union_gaps_and_idle():
    ivs = [(5, 7), (0, 2), (1, 3), (10, 12), (6, 8)]
    u = devtrace.union(ivs)
    assert u == [[0, 3], [5, 8], [10, 12]]
    assert devtrace.length(u) == 8
    assert devtrace.clip(u, 1, 11) == [[1, 3], [5, 8], [10, 11]]
    assert devtrace.gaps(u, -1, 14) == [(-1, 0), (3, 5), (8, 10), (12, 14)]
    h2d, d2h, comp = devtrace.split([
        ("Memcpy HtoD (Pageable -> Device)", 0, 1, 1),
        ("Memcpy DtoH (Device -> Pinned)", 2, 3, 2), ("k", 4, 5, 3)])
    assert (h2d, d2h, comp) == ([(0, 1)], [(2, 3)], [(4, 5)])


def test_spans_innermost_and_launch_attribution():
    sp = devtrace.Spans([("call", 0, 100), ("builders", 10, 20),
                         ("engine", 30, 90), ("call", 200, 300)])
    assert sp.innermost(15) == "builders"
    assert sp.innermost(50) == "engine"
    assert sp.innermost(95) == "call"
    assert sp.innermost(150) == "between calls"
    assert sp.total("call") == 200 and sp.count("call") == 2
    ops = [("k1", 100, 110, 1), ("k2", 120, 125, 2), ("k3", 130, 131, 3)]
    launches = {1: 35, 2: 15, 3: 250}
    got = devtrace.launched_in(ops, launches, sp, "engine")
    assert [o[0] for o in got] == ["k1"]


def _fake_run(name, calls, ops, launches, spans, lo, hi):
    c = cells.resolve(name)
    return window.Run(cell=c, calls=calls, t0=0.0, t1=1.0, setup_s=1.0,
                      active=[np.array([100, 50])],
                      itemsize=4, device_kind="NVIDIA H100 80GB HBM3",
                      trace=window.Trace(ops, launches,
                                         devtrace.Spans(spans), lo, hi))


def test_roofline_and_idle_readers_by_hand():
    reader = {m["name"]: r for m, r in
              cells.resolve("poisson_ncep25.year").per_layer}
    calls = [window.Call(0, 0.0, 1.0, None, np.array([10, 20]), 7)]
    spans = [("call", 0, 1000), ("builders", 100, 200),
             ("engine", 300, 900)]
    ops = [("k", 400, 600, 1), ("k", 700, 800, 2), ("copy", 950, 990, 3)]
    run_ = _fake_run("poisson_ncep25.year", calls, ops,
                     {1: 310, 2: 320, 3: 910}, spans, 0, 1000)
    # point-sweeps 10*100 + 20*50 = 2000, 12 FLOPs each, at 67 TFLOP/s;
    # bytes (2 fields in and out of 73*144 cells, and the planes) at
    # 3.35 TB/s: the larger is the least time
    flops_t = 2000 * 12 / 67e12
    cells_ = 73 * 144
    bytes_t = 4 * (2 * 1460 * cells_ + 2 * 73) / 3.35e12
    least = max(flops_t, bytes_t)
    assert math.isclose(reader["kernels.roofline_pct"].read(run_),
                        100 * least / 300e-9)
    busy = 200 + 100 + 40
    assert math.isclose(reader["device.idle_pct"].read(run_),
                        100 * (1 - busy / 1000))
    assert math.isclose(reader["api.host_ms"].read(run_),
                        (1000 - 100 - 600) / 1e6)
    assert math.isclose(reader["builders.host_ms"].read(run_), 100 / 1e6)
    assert reader["engine.sweeps_per_field"].read(run_) == 15.0
    assert reader["wrappers.launches_per_sweep"].read(run_) == 7 / 20
    bd = window.breakdown(run_.trace)
    assert bd["device_ops"][0] == ["k", 300e-9]
    idle = dict(bd["idle_gaps"])
    assert idle["engine"] == pytest.approx(300e-9)
    assert idle["builders"] == pytest.approx(100e-9)
    assert idle["call"] == pytest.approx(260e-9)


def test_window_readers_by_hand():
    c = cells.resolve("omega_nb11.month")
    calls = [window.Call(0, s, s + d, None, np.array([1]), 0)
             for s, d in ((0.0, 0.1), (0.1, 0.2), (0.3, 0.1), (0.4, 0.3))]
    run_ = window.Run(c, calls, 0.0, 0.7, 3.5, [], 4, "cpu")
    r = {m["name"]: mod for m, mod in c.end_to_end}
    assert set(r) == {"fields_per_s.host", "setup_s"}
    assert math.isclose(r["fields_per_s.host"].read(run_), 4 * 124 / 0.7)
    assert r["setup_s"].read(run_) == 3.5


# ------------------------------------------------------------ reference

def test_reference_converges_to_a_known_solution():
    """A manufactured field: g chosen so that S* solves the folded
    system; the reference's stopping solve comes back to S*."""
    c = small_cell("poisson_ncep25.year")
    v = c.inputs.fields(c.config, 1, window.streams(4)[0]).astype(float)
    prob = c.reference.build(c.config, v, torch.float64, "cpu")
    ny, nx = v.shape[1:]
    y, x = np.meshgrid(np.linspace(0, np.pi, ny), np.linspace(
        0, 2 * np.pi, nx, endpoint=False), indexing="ij")
    star = torch.tensor((np.sin(y) ** 2 * np.cos(2 * x))[None])
    star = torch.where(prob.active, star, 0.0)
    star[..., 0, :] = star[..., 1, :]
    star[..., -1, :] = star[..., -2, :]
    lhs = prob.w0 * star
    for off, w in prob.weights.items():
        lhs = lhs + w * redblack._neighbour(star, off)
    prob.g = torch.where(prob.active, -lhs, 0.0)
    S, n = redblack.solve(prob, redblack.optimal_omega((ny, nx)), 1e-13,
                          1, 20000)
    assert int(n[0]) < 20000
    ok = prob.active[0]
    np.testing.assert_allclose(S[0][ok].numpy(), star[0][ok].numpy(),
                               atol=1e-9)


@pytest.mark.parametrize("name", CELLS)
def test_reference_equals_the_program_in_float64(name):
    """At fixed sweep counts in float64 on the CPU, the reference's states
    and the program's plain path agree: the reference's coefficients,
    pre-pass and relaxation factor are the configuration's."""
    import xinvert_tpu_torch as xt
    c = small_cell(name)
    rng = window.streams(99)[0]
    pool, fields, fn, kw = window.prepare(c, rng, device="cpu")
    vals = pool[0]
    vals = vals[None] if c.mix["fields_per_call"] == 1 else vals
    prob = c.reference.build(c.config, vals.astype(float), torch.float64,
                             "cpu")
    omega = redblack.relaxation(c.reference, vals.shape[1:])
    states = redblack.states_at(prob, omega, [[40]] * vals.shape[0])
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        kw = dict(kw, iParams=dict(kw["iParams"], mxLoop=40,
                                   tolerance=1e-30, checkEvery=40))
        out = fn(xt.Field(fields[0].values.astype(float), fields[0].dims,
                          fields[0].coords), **kw).values
    finally:
        torch.set_default_dtype(old)
    out = out[None] if c.mix["fields_per_call"] == 1 else out
    for f in range(vals.shape[0]):
        ref = states[(f, 40)].numpy()
        d = ~np.isnan(vals[f])
        np.testing.assert_allclose(out[f][d], ref[d], rtol=1e-10,
                                   atol=1e-12 * np.abs(ref).max())


# -------------------------------------------------------------- imports

def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_and_a_reference_apart_from_the_program():
    files = sorted((ROOT / "benchmark").rglob("*.py"))
    assert files
    for p in files:
        names = set(_imports(p))
        assert not names & {"jax", "jaxlib", "flax", "xinvert_tpu"}, p
        if "reference" in p.relative_to(ROOT / "benchmark").parts:
            assert "xinvert_tpu_torch" not in names, p


def test_forbidden_modules_by_whole_top_level_name():
    assert run.forbidden_loaded(["xinvert_tpu_torch", "xinvert_tpu_torch.ops",
                                 "jax_utils", "numpy"]) == []
    assert run.forbidden_loaded(["xinvert_tpu.ops", "jaxlib", "flax.nn",
                                 "jax"]) == ["flax.nn", "jax", "jaxlib",
                                             "xinvert_tpu.ops"]


def test_no_result_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_no_result_beside_no_program(tmp_path):
    """In a directory with BENCHMARK.json and benchmark/ alone the run
    exits non-zero and prints nothing on standard output."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


# ------------------------------------------------ the check's verdicts

#: (cell, fields a call): the batched path and the single map
SHAPES = [(name, k) for name in CELLS for k in (4, 1)]


@pytest.mark.parametrize("name,k", SHAPES)
def test_sound_run_is_correct(name, k):
    res, rows = run_small(name, fields_per_call=k)
    assert res["correct"], rows
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "check"
    assert set(res["metrics"]) == {
        m["name"] for m in BENCH["end_to_end"]
        if name in m.get("workloads", [name])}


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    """The reference in bfloat16 in the program's place fails the check."""
    c = small_cell(name)
    rng_in, rng_s = window.streams(77)
    pool = window.make_pool(c, rng_in)
    k = c.mix["fields_per_call"]
    answers = [judge.Answer(p, j, None, 0) for p in range(2)
               for j in range(k)]
    ctrl = calibrate.control_answers(c, answers, pool, "cpu", torch.bfloat16)
    nums = judge.judge(c.config, c.reference, ctrl, pool, k, "cpu")
    nums["mask_mismatch"] = 0
    ok, rows = judge.verdict(nums, c.config["limits"])
    assert not ok, rows


def _fault_state_unchanged(monkeypatch):
    from xinvert_tpu_torch import solver

    def still(spec, S, omega, k, with_norm=False, fac=None):
        if with_norm:
            return S, S.abs().sum(dim=tuple(range(-spec.ndim, 0)))
        return S
    monkeypatch.setattr(solver, "_select_kernel", lambda spec, S: still)


def _wrap_solve(monkeypatch, change):
    from xinvert_tpu_torch.models import api
    solve = api.solve

    def broken(spec, S0, **kw):
        res = solve(spec, S0, **kw)
        return dataclasses.replace(res, S=change(res.S, S0))
    monkeypatch.setattr(api, "solve", broken)


def _fault_half_batch(monkeypatch):
    def change(S, S0):
        S = S.clone()
        S[S.shape[0] // 2:] = S0[S.shape[0] // 2:]
        return S
    _wrap_solve(monkeypatch, change)


def _fault_answer_altered(monkeypatch):
    def change(S, S0):
        S = S.clone()
        flat = S.reshape(-1, S.shape[-1])
        flat[:, S.shape[-1] // 3] += 0.1 * S.abs().max()
        return S
    _wrap_solve(monkeypatch, change)


# each fault a cell can have: one card, so no exchange between chips; a
# single map has no batch to halve
FAULTS = [(name, k, fault) for name, k in SHAPES
          for fault in (_fault_state_unchanged, _fault_half_batch,
                        _fault_answer_altered)
          if not (fault is _fault_half_batch and k == 1)]


@pytest.mark.parametrize("name,k,fault", FAULTS, ids=[
    f"{n}-{k}-{f.__name__[7:]}" for n, k, f in FAULTS])
def test_planted_fault_is_not_correct(name, k, fault, monkeypatch):
    fault(monkeypatch)
    res, rows = run_small(name, check_fields=8, fields_per_call=k)
    assert not res["correct"], rows


def test_failed_call_counted(monkeypatch):
    from xinvert_tpu_torch.models import api
    solve, calls = api.solve, []

    def sometimes(spec, S0, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("planted")
        return solve(spec, S0, **kw)
    monkeypatch.setattr(api, "solve", sometimes)
    res, _ = run_small("omega_nb11.month")
    assert res["failed"] == 1 and not res["correct"]


# ------------------------------------------------------------- the card

@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        name, "--seed", "31", "--seconds", "3", "--trace",
                        "1"], cwd=ROOT, capture_output=True, text=True,
                       timeout=360)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"], res["check"]
    assert res["device"]["busy_s"] > 0
    assert set(res["metrics"]) == {m["name"] for m in BENCH["per_layer"]
                                   if name in m.get("workloads", [name])}
    roofline = [v["value"] for k, v in res["metrics"].items()
                if k.startswith("kernels.roofline_pct")]
    assert roofline and 0 < roofline[0] <= 100


# ------------------------- a reference's own factor and pre-pass

def core_shape(grid):
    return tuple(int(n) for _, _, n in grid.values())


# The default-path tests below freeze the sweep of poisson_ncep25 and
# omega_nb11 as it stood before a reference could state its own factor
# and pre-pass: they name those two, and a configuration added later is
# held by the tests over every cell instead.

#: whether each of the two configurations' sources extends in y (its BCs)
EXTENDS = {"poisson_ncep25": True, "omega_nb11": False}
DEFAULT_PATH = ("omega_nb11", "poisson_ncep25")


def one_row_sweep(extend):
    """``redblack.sweep`` as it stood before the pre-pass hook, for a
    problem that does or does not ``extend``."""
    return functools.partial(_one_row_sweep, extend)


def _one_row_sweep(extend, prob, S, red, black):
    """The one-row extend where ``extend``, the red half, the black half."""
    if extend:
        S = S.clone()
        S[..., 0, :] = S[..., 1, :]
        S[..., -1, :] = S[..., -2, :]
    for r in (red, black):
        acc = prob.g + prob.w0 * S
        for off, w in prob.weights.items():
            acc = acc + w * redblack._neighbour(S, off)
        S = S + r * acc
    return S


@pytest.mark.parametrize("config", DEFAULT_PATH)
def test_default_relaxation_is_the_grid_optimal(config):
    """Neither configuration states its own factor: the grid-optimal one,
    at the cell's grid and at the small one."""
    full = cells.resolve(CELL_OF[config])
    assert not hasattr(full.reference, "RELAXATION")
    for grid in (full.config["grid"], full.config["cpu_grid"]):
        shape = core_shape(grid)
        got = redblack.relaxation(full.reference, shape)
        assert type(got) is float
        assert got == redblack.optimal_omega(shape)


@pytest.mark.parametrize("config", DEFAULT_PATH)
def test_default_states_equal_the_one_row_sweep(config):
    """Neither configuration states its own pre-pass: the states are
    bit-equal to the one-row sweep at the grid-optimal factor."""
    c = small_cell(CELL_OF[config])
    vals = c.inputs.fields(c.config, 3, window.streams(2 ** 31 + 11)[0])
    prob = c.reference.build(c.config, vals.astype(np.float64),
                             torch.float64, "cpu")
    assert prob.prepass is (redblack.one_row_extend if EXTENDS[config]
                            else None)
    omega = redblack.relaxation(c.reference, vals.shape[1:])
    wanted = [[1, 7, 24], [24], [2, 3, 24]]
    got = redblack.states_at(prob, omega, wanted)
    red, black = prob.relax(redblack.optimal_omega(vals.shape[1:]))
    S = torch.zeros_like(prob.g)
    seen = 0
    old_sweep = one_row_sweep(EXTENDS[config])
    for n in range(1, 25):
        S = old_sweep(prob, S, red, black)
        for f, counts in enumerate(wanted):
            if n in counts:
                assert torch.equal(got[(f, n)], S[f].double().cpu())
                seen += 1
    assert seen == len(got) == 7


@pytest.mark.parametrize("config", DEFAULT_PATH)
def test_default_judge_equals_the_one_row_sweep(config, monkeypatch):
    """The judge's numbers on answers that stop before and at mxLoop, with
    the hooks and with the one-row sweep at the grid-optimal factor."""
    c = small_cell(CELL_OF[config])
    k = c.mix["fields_per_call"]
    pool = window.make_pool(c, window.streams(2 ** 31 + 12)[0])
    asked = [judge.Answer(p, j, None, 0) for p in range(2)
             for j in range(min(k, 3))]
    answers = calibrate.control_answers(c, asked, pool, "cpu", torch.float32)
    mx = int(c.config["iParams"]["mxLoop"])
    # one answer at the cap, the rest where they stopped
    answers[0] = judge.Answer(answers[0].pool, answers[0].index,
                              answers[0].values, mx)
    assert any(a.sweeps < mx for a in answers)
    new = judge.judge(c.config, c.reference, answers, pool, k, "cpu")
    monkeypatch.setattr(redblack, "sweep", one_row_sweep(EXTENDS[config]))
    monkeypatch.setattr(redblack, "relaxation",
                        lambda ref, shape: redblack.optimal_omega(shape))
    old = judge.judge(c.config, c.reference, answers, pool, k, "cpu")
    assert all(np.isfinite(v) and v > 0 for v in new.values()), new
    assert new == old


# a biharmonic configuration: a Stommel-Munk reference written here, with
# the factor 1 and the two-row sequential extend of its source, follows
# the program's invert_StommelMunk; each hook left out breaks that

#: a 0.5-degree lat-lon band (SODA's spacing; at 5 degrees the beta term
#: outweighs the centre and the sweeps diverge at the factor 1) with a land
#: block, and xinvert's Stommel-Munk test parameters
#: (tests/test_MunkWBC.py:66-84: R 2e-4, D 100, A4 5e3)
MUNK = {
    "grid": {"lat": [20.0, 32.0, 25], "lon": [0.0, 35.5, 72]},
    "mParams": {"A4": 5e3, "R": 2e-4, "D": 100.0, "rho0": 1027.0,
                "beta": 2e-11, "Omega": 7.292e-5, "Rearth": 6371200.0},
    "iParams": {"mxLoop": 200, "tolerance": 1e-30},
    "check_window": 200,
}
LAND = (slice(9, 13), slice(20, 31))


def munk_curl(n_fields, seed):
    """Wind-stress curls (N m^-3) with land as NaN, large in the rows
    next to the y edges so that the boundary pre-pass matters."""
    rng = np.random.default_rng(seed)
    ny, nx = MUNK["grid"]["lat"][2], MUNK["grid"]["lon"][2]
    lat = np.linspace(*MUNK["grid"]["lat"])[:, None]
    lon = np.linspace(*MUNK["grid"]["lon"])[None, :]
    base = 1e-7 * np.sin(np.deg2rad(3 * lat)) * np.cos(np.deg2rad(2 * lon))
    curl = base + 5e-8 * rng.standard_normal((n_fields, ny, nx))
    curl[:, [1, 2, -3, -2], :] += 2e-7
    curl[(slice(None),) + LAND] = np.nan
    return curl


def munk_active(cfg, values):
    """Rows 2..ny-3 (the biharmonic's two-row ring), every column (x
    periodic), where the curl is defined."""
    inner = np.zeros(values.shape[-2:], bool)
    inner[2:-2, :] = True
    return ~np.isnan(values) & inner


def two_row_extend(S):
    """The biharmonic extend of xinvert's general_bih_2D with x periodic,
    in its sequential order: S[0] = S[1], then S[1] = S[2];
    S[-1] = S[-2] = S[-3]."""
    S = S.clone()
    S[..., 0, :] = S[..., 1, :]
    S[..., 1, :] = S[..., 2, :]
    bottom = S[..., -3, :].clone()
    S[..., -1, :] = bottom
    S[..., -2, :] = bottom
    return S


def munk_build(cfg, values, dtype, device, prepass):
    """A4 Syyyy + C Sxxxx + D Syy + F Sxx + H Sx = J on a lat-lon grid
    (xinvert apps.py:1793-1836): A = A4, C = A4 / cos^2, D = -R / depth,
    F = -R / (depth cos^2), H = -2 Omega / Rearth, J = -curl / (rho0
    depth); x and y in metres of arc.  Times dx^4 with r = dx / dy, the
    centred differences give the neighbour terms n and the centre term c
    (the fourth differences 1 -4 6 -4 1, the second 1 -2 1, the first
    -1/2 0 1/2); the reference's form takes w = -n, w0 = -c, g = J dx^4."""
    mp = cfg["mParams"]
    lat = np.linspace(*cfg["grid"]["lat"])
    lon = np.linspace(*cfg["grid"]["lon"])
    Re = mp["Rearth"]
    dy = np.deg2rad(lat[1] - lat[0]) * Re
    dx = np.deg2rad(lon[1] - lon[0]) * Re
    r4, r2 = (dx / dy) ** 4, (dx / dy) ** 2
    icos2 = 1.0 / np.cos(np.deg2rad(lat)) ** 2
    A, C = mp["A4"], mp["A4"] * icos2
    D, F = -mp["R"] / mp["D"], -mp["R"] / mp["D"] * icos2
    H = -2.0 * mp["Omega"] / Re
    n = {(2, 0): A * r4, (-2, 0): A * r4,
         (1, 0): -4 * A * r4 + D * r2 * dx ** 2,
         (-1, 0): -4 * A * r4 + D * r2 * dx ** 2,
         (0, 2): C, (0, -2): C,
         (0, 1): -4 * C + F * dx ** 2 + H * dx ** 3 / 2,
         (0, -1): -4 * C + F * dx ** 2 - H * dx ** 3 / 2}
    c = 6 * (A * r4 + C) - 2 * (D * r2 + F) * dx ** 2
    act = munk_active(cfg, values)
    J = -np.nan_to_num(values) / (mp["rho0"] * mp["D"])
    ny, nx = values.shape[-2:]

    def plane(col):
        """A term that varies with latitude (or is constant), where
        active."""
        col = np.broadcast_to(col, (ny,))[:, None]
        return np.where(act, np.broadcast_to(col, (ny, nx)), 0.0)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64,
                               device=device).to(dtype)

    return redblack.Problem(
        weights={off: t(plane(-v)) for off, v in n.items()}, w0=t(plane(-c)),
        g=t(np.where(act, J * dx ** 4, 0.0)),
        active=torch.as_tensor(act, device=device),
        zero_norm_stops=False, prepass=prepass)


def munk_reference(own_omega=True, prepass=two_row_extend):
    """The reference module: ``build``, ``active``, and where
    ``own_omega`` the source's factor 1 (its ``optArg``) as
    ``RELAXATION``."""
    ref = types.SimpleNamespace(
        build=lambda cfg, v, dtype, device: munk_build(cfg, v, dtype, device,
                                                       prepass),
        active=munk_active,
        FLOPS_PER_POINT_SWEEP=redblack.flops_per_point_sweep(8))
    if own_omega:
        ref.RELAXATION = 1.0
    return ref


def munk_solve(curl):
    """The program's fields after mxLoop sweeps from ``curl`` (B, ny, nx):
    float64 on the CPU, B fields a call, the program's own factor."""
    import xinvert_tpu_torch as xt
    g = MUNK["grid"]
    coords = {"time": np.arange(len(curl)), "lat": np.linspace(*g["lat"]),
              "lon": np.linspace(*g["lon"])}
    ip = dict(MUNK["iParams"], BCs=["extend", "periodic"], undef=np.nan,
              checkEvery=MUNK["iParams"]["mxLoop"], printInfo=False)
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        out = xt.invert_StommelMunk(
            xt.Field(curl, ("time", "lat", "lon"), coords),
            dims=["lat", "lon"], coords="lat-lon", iParams=ip,
            mParams=dict(MUNK["mParams"]), device="cpu").values
    finally:
        torch.set_default_dtype(old)
    return np.asarray(out, np.float64)


@pytest.fixture(scope="module")
def munk_program():
    """(curls, the program's fields): two fields a call."""
    curl = munk_curl(2, seed=2 ** 31 + 5)
    return curl, munk_solve(curl)


def munk_numbers(reference, munk_program):
    curl, out = munk_program
    mx = MUNK["iParams"]["mxLoop"]
    answers = [judge.Answer(0, j, out[j], mx) for j in range(len(out))]
    return judge.judge(MUNK, reference, answers, [curl], len(out), "cpu")


def test_biharmonic_reference_follows_the_program(munk_program):
    curl, out = munk_program
    assert np.isnan(out[(slice(None),) + LAND]).all()
    # a gyre's streamfunction (m^3/s), not a diverging iteration
    assert np.isfinite(out[~np.isnan(curl)]).all()
    assert 1e3 < np.nanmax(np.abs(out)) < 1e7
    ref = munk_reference()
    assert redblack.relaxation(ref, (25, 72)) == 1.0
    nums = munk_numbers(ref, munk_program)
    assert nums["field_gap"] <= 1e-10, nums


def test_biharmonic_needs_its_own_omega(munk_program):
    """With the grid-optimal factor in place of the source's 1, the
    reference reads a gap above poisson_ncep25's limit."""
    ref = munk_reference(own_omega=False)
    assert redblack.relaxation(ref, (25, 72)) == \
        redblack.optimal_omega((25, 72))
    nums = munk_numbers(ref, munk_program)
    assert nums["field_gap"] > 5e-3, nums


def test_biharmonic_needs_its_own_prepass(munk_program):
    """With the one-row extend in place of the two-row pre-pass, the
    reference reads a gap above 1e-6."""
    nums = munk_numbers(munk_reference(prepass=redblack.one_row_extend),
                        munk_program)
    assert nums["field_gap"] > 1e-6, nums


def test_control_takes_the_references_factor_and_prepass():
    """The control solve runs the reference's own rules: in float64 in the
    program's place it reads no gap to the judge's states."""
    cell = types.SimpleNamespace(config=MUNK, reference=munk_reference(),
                                 mix={"fields_per_call": 2})
    curl = munk_curl(2, seed=2 ** 31 + 6)
    asked = [judge.Answer(0, j, None, 0) for j in range(2)]
    ctrl = calibrate.control_answers(cell, asked, [curl], "cpu",
                                     torch.float64)
    assert [a.sweeps for a in ctrl] == [MUNK["iParams"]["mxLoop"]] * 2
    nums = judge.judge(MUNK, cell.reference, ctrl, [curl], 2, "cpu")
    assert nums["field_gap"] == 0.0, nums
