# -*- coding: utf-8 -*-
"""Everything a cell needs, found by the names in BENCHMARK.json.

A cell ``<config>.<mix>`` names its configuration and its traffic mix; the
files are

    benchmark/configs/<config>.json     entry, dims, grid, iParams, limits,
                                        and cpu_grid: a smaller grid on the
                                        same axes, at a spacing its sweeps
                                        converge on, where the CPU tests
                                        run its cells
    benchmark/inputs/<config>.py        the seeded generator of its fields
    benchmark/reference/<config>.py     its plain reference: build(),
                                        active(), coefficient_elements(),
                                        OFFSETS (the tests hold
                                        FLOPS_PER_POINT_SWEEP to them), the
                                        Problem.prepass of its source, and
                                        where the source sets one, the
                                        constant RELAXATION
    benchmark/traffic/<mix>.json        fields a call, pool, sample, trace
    benchmark/metrics/<metric>.py       one reader a metric

A new cell is an entry of BENCHMARK.json's ``workloads``, appended to the
``workloads`` list of one end-to-end rate (``fields_per_s`` where the card
sets the pace, ``fields_per_s.host`` where the host does) and of each
per-layer metric that ``moves`` that rate.  So a later change adds a
configuration, a mix or a metric by adding files and entries, and edits
none.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent      # benchmark/
ROOT = HERE.parent                                 # the checkout


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    chips: int
    inputs: object          # module: fields(), coords(), mparams()
    # module: build(), active(), coefficient_elements(),
    # FLOPS_PER_POINT_SWEEP, optionally RELAXATION (redblack.relaxation)
    reference: object
    end_to_end: list        # [(entry of BENCHMARK.json, reader module)]
    per_layer: list


def load_bench(root=ROOT):
    with open(Path(root) / "BENCHMARK.json") as fh:
        return json.load(fh)


def _module(kind, name):
    """benchmark/<kind>/<name>.py; a name may hold dots (metric names)."""
    if "." not in name:
        return importlib.import_module(f"benchmark.{kind}.{name}")
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(kind, name):
    with open(HERE / kind / f"{name}.json") as fh:
        return json.load(fh)


def _readers(entries, cell_name):
    """The metrics this cell reports: those without ``workloads`` and
    those that list it."""
    return [(m, _module("metrics", m["name"])) for m in entries
            if cell_name in m.get("workloads", [cell_name])]


def resolve(name, bench=None):
    """The cell called ``name`` in BENCHMARK.json, with its files loaded;
    KeyError when BENCHMARK.json has no such cell."""
    bench = load_bench() if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    config = load_json("configs", w["config"])
    return Cell(name=name, config=config,
                mix=load_json("traffic", w["traffic"]), chips=w["chips"],
                inputs=_module("inputs", w["config"]),
                reference=_module("reference", w["config"]),
                end_to_end=_readers(bench["end_to_end"], name),
                per_layer=_readers(bench["per_layer"], name))
