# -*- coding: utf-8 -*-
"""CPU tests of the reader of ``wrappers.cross_cell_share`` and of the cell
that reports it, ``eliassen_zm25.daily40``: the ratio of the program's
cross-coupled and total tiled cell counters where it has them, None where
it has none (a program from before the counters) or ran no tiled launch;
the counters as the tiled wrapper grows them, launched with a stand-in
for the kernel, for the cell's 9-point spec and for Stommel-Munk's
axis-only one; the reference's operation count against its offsets; and
one short pass of the cell's mix on its CPU grid.

    python -m pytest benchmark/tests -q
"""
from __future__ import annotations

import copy
import ctypes
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import cell as cells  # noqa: E402
from benchmark.harness import window  # noqa: E402
from benchmark.reference import redblack  # noqa: E402

NAME = "wrappers.cross_cell_share"
MODULE = "xinvert_tpu_torch.ops.sor2d"
CELL = "eliassen_zm25.daily40"
MUNK = "stommelmunk_soda05.decade"


@pytest.fixture
def reader():
    return cells._module("metrics", NAME)


def test_none_without_the_counters(reader, monkeypatch):
    """A sor2d module without TILED_CROSS_CELLS (it has the other tiled
    counters), and no sor2d module at all: None."""
    monkeypatch.setitem(sys.modules, MODULE, types.SimpleNamespace(
        TILED_LAUNCHES=5, TILED_WINDOW_CELLS=10, TILED_CELLS=4,
        TILED_STAGED_SLICES=1, TILED_SLICES=2))
    assert reader.read(None) is None
    monkeypatch.delitem(sys.modules, MODULE)
    assert reader.read(None) is None


def test_none_without_a_tiled_launch(reader, monkeypatch):
    monkeypatch.setitem(sys.modules, MODULE, types.SimpleNamespace(
        TILED_CROSS_CELLS=0, TILED_CELLS=0))
    assert reader.read(None) is None


def _spec(name, B=3):
    """The program's pruned spec of cell ``name`` on its CPU grid, built
    through the builder its entry point looks up, with B forcings."""
    from xinvert_tpu_torch.grid import Grid
    from xinvert_tpu_torch.models import problems
    from xinvert_tpu_torch.models.params import default_mParams
    from xinvert_tpu_torch.stencil import prune_zero_offsets
    c = cells.resolve(name)
    cfg = dict(c.config, grid=c.config["cpu_grid"])
    co = c.inputs.coords(cfg)
    vals = c.inputs.fields(cfg, B, window.streams(2 ** 31 + 3)[0])
    grid = Grid.make(tuple(cfg["dims"]), [co[d] for d in cfg["dims"]],
                     cfg["coords"], bcs=tuple(cfg["iParams"]["BCs"]))
    mp = dict(default_mParams)
    mp.update({k: v[0] for k, v in c.inputs.mparams(cfg).items()})
    F = torch.as_tensor(vals, dtype=torch.float32)
    Fdef = torch.as_tensor(~np.isnan(vals[0]))
    spec = prune_zero_offsets(problems.BUILDERS[cfg["problem"]](
        torch.nan_to_num(F), Fdef, grid, mp))
    return spec, torch.zeros_like(F)


def _launch_counts(spec, S):
    """The growth of the tiled counters by one launch through
    ``sor2d._launch_tiled``, the kernel replaced by a stand-in that
    returns success: the wrapper's own arithmetic on the CPU."""
    from xinvert_tpu_torch.ops import sor2d
    core = tuple(S.shape[-2:])
    plan = sor2d.tile_plan(spec, core, S.dtype)
    vol = core[0] * core[1]
    lay = dict(B=S.shape[0], core=core, K=len(spec.offsets), sms=132,
               dy=(ctypes.c_int * sor2d.MAX_K)(*[o[0] for o in spec.offsets]),
               dx=(ctypes.c_int * sor2d.MAX_K)(*[o[1] for o in spec.offsets]),
               w_kstride=vol, w_bstride=0, w0_bstride=0,
               g_bstride=vol if spec.g.dim() > 2 else 0, relax_bstride=0,
               stream=None, tiled_fn=lambda *a: 0)
    names = ("TILED_CROSS_CELLS", "TILED_CELLS", "TILED_WINDOW_CELLS")
    before = [getattr(sor2d, n) for n in names]
    rel = sor2d.relax_plane(spec, 1.0)
    sor2d._launch_tiled(spec, lay, plan, rel, S, S.clone(), plan.k,
                        [1.0] * (2 * plan.k))
    grown = {n: getattr(sor2d, n) - b for n, b in zip(names, before)}
    assert (grown["TILED_WINDOW_CELLS"], grown["TILED_CELLS"]) == \
        sor2d.tiled_cells(plan, S.shape[0], core)
    return grown, plan


@pytest.mark.parametrize("name,share", [(CELL, 1.0), (MUNK, 0.0)])
def test_ratio_after_a_tiled_launch(reader, monkeypatch, name, share):
    """The Eliassen spec keeps its four diagonal offsets (radius 1, 8
    offsets, k 4) and its launch grows TILED_CROSS_CELLS by the cells it
    updates: the reader reads 1.0.  Stommel-Munk's 8 offsets all lie on
    an axis: it grows TILED_CELLS alone, and the reader reads 0."""
    spec, S = _spec(name)
    cross = [o for o in spec.offsets if o[0] and o[1]]
    assert len(cross) == (4 if share else 0)
    grown, plan = _launch_counts(spec, S)
    assert grown["TILED_CELLS"] > 0
    assert grown["TILED_CROSS_CELLS"] == share * grown["TILED_CELLS"]
    assert plan.k == (4 if share else 1)
    monkeypatch.setitem(sys.modules, MODULE, types.SimpleNamespace(
        TILED_CROSS_CELLS=grown["TILED_CROSS_CELLS"],
        TILED_CELLS=grown["TILED_CELLS"]))
    assert reader.read(None) == share


def test_window_cells_of_the_cells_plan():
    """At the cell's own 37 x 72 in float32: 8 x 64 tiles in 24 x 80
    windows, 5 x 2 of them a slice, 19 200 window cells for 2 664
    updated, 7.21 a cell; the walk stages (8 offsets)."""
    from xinvert_tpu_torch.ops import sor2d
    spec, _ = _spec(CELL, B=1)
    c = cells.resolve(CELL)
    core = tuple(c.config["grid"][d][2] for d in c.config["dims"])
    plan = sor2d.tile_plan(spec, core, torch.float32)
    assert (plan.ty, plan.tx, plan.k, plan.winy, plan.winx, plan.stage) == \
        (8, 64, 4, 24, 80, True)
    window_cells, updated = sor2d.tiled_cells(plan, 1, core)
    assert (window_cells, updated) == (19200, 2664)
    assert window_cells / updated == pytest.approx(7.2072, abs=1e-4)


@pytest.mark.parametrize("name", [CELL, MUNK, "poisson_ncep25.year"])
def test_flops_agree_with_the_offsets(name):
    ref = cells.resolve(name).reference
    assert ref.FLOPS_PER_POINT_SWEEP == redblack.flops_per_point_sweep(
        len(ref.OFFSETS))
    assert len(set(ref.OFFSETS)) == len(ref.OFFSETS)


def test_reference_offsets_are_the_programs():
    """The reference's 8 couplings are those the program keeps after its
    prune, diagonals included."""
    spec, _ = _spec(CELL)
    assert set(spec.offsets) == set(cells.resolve(CELL).reference.OFFSETS)


def test_cell_resolves_and_runs_a_short_pass():
    """The cell by its name, then one short pass of its mix on the CPU
    grid: 4 fields a call, sound, every call counted, and the NaN block
    below the Antarctic surface returned NaN."""
    c = cells.resolve(CELL)
    assert c.mix["fields_per_call"] == 14610 and c.chips == 1
    assert {m["name"] for m, _ in c.per_layer} >= {
        NAME, "wrappers.window_cells_per_cell",
        "wrappers.staged_slice_share", "kernels.roofline_pct"}
    c.config = copy.deepcopy(c.config)
    c.config["grid"] = c.config["cpu_grid"]
    c.mix = dict(c.mix, fields_per_call=4, pool_calls=2, check_fields=3,
                 trace_calls=2,
                 iParams={"checkEvery": c.config["check_window"]})
    res, rows = window.run_cell(c, 2 ** 31 + 9, 0.2, False, device="cpu",
                                t_start=time.perf_counter(),
                                log=lambda *_: None)
    assert res["correct"], rows
    assert res["failed"] == 0 and res["check"]["mask_mismatch"]["value"] == 0
    assert set(res["metrics"]) == {"fields_per_s", "setup_s"}
