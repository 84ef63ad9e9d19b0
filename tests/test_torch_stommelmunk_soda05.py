# -*- coding: utf-8 -*-
"""invert_StommelMunk of the port on the benchmark configuration
stommelmunk_soda05 (benchmark/configs/stommelmunk_soda05.json), held on
the CPU in float64 to its plain reference
(benchmark/reference/stommelmunk_soda05.py) on the configuration's
cpu_grid with the benchmark's seeded curl, called as a user calls it; and
the tiled launches' cell counters (ops.sor2d.tiled_cells) held to the
tile plans, the radius-2 plan of the configuration's 330 x 720 grid among
them.  Imports no JAX.
"""
import copy
import ctypes
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import xinvert_tpu_torch as xt  # noqa: E402
from benchmark.harness import cell as cells  # noqa: E402
from benchmark.harness import window  # noqa: E402
from benchmark.reference import redblack  # noqa: E402
from xinvert_tpu_torch.grid import Grid  # noqa: E402
from xinvert_tpu_torch.models import api, problems  # noqa: E402
from xinvert_tpu_torch.models.params import default_mParams  # noqa: E402
from xinvert_tpu_torch.ops import sor2d  # noqa: E402
from xinvert_tpu_torch.stencil import prune_zero_offsets  # noqa: E402

CELL = "stommelmunk_soda05.decade"
SEEDS = (2 ** 31 + 21, 4_200_000_021)


def small_cell(fields_per_call=2):
    """The cell on its configuration's cpu_grid, ``fields_per_call``
    fields a call and one pool call."""
    c = cells.resolve(CELL)
    c.config = copy.deepcopy(c.config)
    c.config["grid"] = c.config["cpu_grid"]
    c.mix = dict(c.mix, fields_per_call=fields_per_call, pool_calls=1)
    return c


def program_and_reference(seed, **iparams):
    """(curls, the program's fields, the reference's problem) for one call
    of invert_StommelMunk on the CPU in float64, the configuration's
    iParams updated by ``iparams``."""
    c = small_cell()
    pool, fields, fn, kw = window.prepare(c, window.streams(seed)[0],
                                          device="cpu")
    vals = pool[0].astype(np.float64)
    kw = dict(kw, iParams=dict(kw["iParams"], **iparams))
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        out = fn(xt.Field(vals, fields[0].dims, fields[0].coords), **kw)
    finally:
        torch.set_default_dtype(old)
    prob = c.reference.build(c.config, vals, torch.float64, "cpu")
    assert redblack.relaxation(c.reference, vals.shape[1:]) == 1.0
    return vals, np.asarray(out.values, np.float64), prob


@pytest.mark.parametrize("seed", SEEDS)
def test_fixed_sweeps_equal_the_reference(seed):
    """200 sweeps (checkEvery = mxLoop = 200) against the reference's
    state after 200 sweeps.  Both sweep in float64 in the same red-black
    order with the same two-row extend and factor 1; they differ only in
    the order in which a point's eight neighbour terms are summed, which
    moves the last bits of each update, so the gap stays at rounding
    (about 1e-15 of the largest value): rtol 1e-10 with an atol of 1e-12
    of the largest |S| leaves that room and catches any term, plane or
    boundary row that differs."""
    vals, out, prob = program_and_reference(seed, mxLoop=200, checkEvery=200,
                                            tolerance=1e-30)
    states = redblack.states_at(prob, 1.0, [[200]] * len(vals))
    assert int(np.asarray(api.LAST_SOLVE.iters).max()) == 200
    for f in range(len(vals)):
        ref = states[(f, 200)].numpy()
        d = ~np.isnan(vals[f])
        assert np.isnan(out[f][~d]).all()
        np.testing.assert_allclose(out[f][d], ref[d], rtol=1e-10,
                                   atol=1e-12 * np.abs(ref).max())


def test_source_stop_rule_equals_the_reference():
    """The source's stop rule (tolerance 1e-12, mxLoop 5000, a check every
    sweep on the CPU) against the reference's stopping solve: the same
    sweep count for every field and the same fields, to the tolerance of
    the fixed-sweep test."""
    vals, out, prob = program_and_reference(SEEDS[0])
    S, loops = redblack.solve(prob, 1.0, 1e-12, 1, 5000)
    iters = np.asarray(api.LAST_SOLVE.iters).ravel()
    np.testing.assert_array_equal(iters, loops.numpy())
    assert (iters < 5000).all()
    for f in range(len(vals)):
        ref = S[f].numpy()
        d = ~np.isnan(vals[f])
        np.testing.assert_allclose(out[f][d], ref[d], rtol=1e-10,
                                   atol=1e-12 * np.abs(ref).max())


# ------------------------------------------------ the tiled cell counters

def soda_spec():
    """invert_StommelMunk's spec on the configuration's 330 x 720 grid
    (float32, zero curl, no land), pruned as solve prunes it."""
    cfg = cells.load_json("configs", "stommelmunk_soda05")
    lat, lon = (np.linspace(*cfg["grid"][d]) for d in ("lat", "lon"))
    grid = Grid.make(("lat", "lon"), (lat, lon), "lat-lon",
                     bcs=tuple(cfg["iParams"]["BCs"]))
    curl = torch.zeros(grid.shape, dtype=torch.float32)
    mp = dict(default_mParams, **cfg["mParams"])
    return prune_zero_offsets(problems.build_stommelmunk(
        curl, torch.ones(grid.shape, dtype=torch.bool), grid, mp))


def test_tiled_cells_of_the_radius2_plan():
    """The configuration's plan: 8 offsets kept, one sweep a launch, 16 x
    64 tiles in 28 x 72 windows; a 120-field launch loads 21 x 12 windows
    a slice, 2.138 cells a cell."""
    spec = soda_spec()
    assert len(spec.offsets) == 8 and spec.bih
    plan = sor2d.tile_plan(spec, (330, 720), torch.float32)
    assert (plan.k, plan.ty, plan.tx, plan.hy, plan.hx) == (1, 16, 64, 6, 4)
    assert (plan.winy, plan.winx, plan.tiles((330, 720))) == (28, 72,
                                                              (21, 12))
    window_cells, grid_cells = sor2d.tiled_cells(plan, 120, (330, 720))
    assert window_cells == 120 * 21 * 12 * 28 * 72
    assert grid_cells == 120 * 330 * 720
    assert window_cells / grid_cells == pytest.approx(2.14, rel=0.01)


def test_tiled_cells_of_a_radius1_plan():
    """A radius-1 plan (Poisson on a 2048 x 2048 grid, k 4) by the plan's
    own tiles and window."""
    n = 2048
    lat = np.linspace(-89.0, 89.0, n)
    lon = np.linspace(0.0, 360.0 - 360.0 / n, n)
    grid = Grid.make(("lat", "lon"), (lat, lon), "lat-lon",
                     bcs=("extend", "periodic"))
    spec = problems.build_poisson(torch.zeros((n, n)),
                                  torch.ones((n, n), dtype=torch.bool), grid,
                                  default_mParams)
    plan = sor2d.tile_plan(spec, (n, n), torch.float32)
    assert plan.k == 4 and plan.hy == 9 and plan.hx == 8
    ty, tx = plan.tiles((n, n))
    assert sor2d.tiled_cells(plan, 3, (n, n)) == (
        3 * ty * tx * plan.winy * plan.winx, 3 * n * n)
    assert ty * tx * plan.winy * plan.winx > n * n


def test_tiled_launch_counts_its_cells(monkeypatch):
    """``_launch_tiled`` adds tiled_cells to the two counters and one to
    TILED_LAUNCHES (a stand-in launcher: the kernel runs on the card
    only)."""
    spec = soda_spec()
    core = (330, 720)
    plan = sor2d.tile_plan(spec, core, torch.float32)
    S = torch.zeros(core)
    for name in ("TILED_WINDOW_CELLS", "TILED_CELLS", "TILED_LAUNCHES"):
        monkeypatch.setattr(sor2d, name, getattr(sor2d, name))
    lay = dict(B=1, core=core, K=len(spec.offsets),
               dy=(ctypes.c_int * sor2d.MAX_K)(), dx=(ctypes.c_int *
                                                    sor2d.MAX_K)(),
               w_kstride=0, w_bstride=0, w0_bstride=0, g_bstride=0,
               relax_bstride=0, stream=None, tiled_fn=lambda *a: 0)
    before = (sor2d.TILED_WINDOW_CELLS, sor2d.TILED_CELLS,
              sor2d.TILED_LAUNCHES)
    sor2d._launch_tiled(spec, lay, plan, spec.relax, S, S.clone(), 1,
                        [1.0, 1.0])
    win, cells_ = sor2d.tiled_cells(plan, 1, core)
    assert (sor2d.TILED_WINDOW_CELLS, sor2d.TILED_CELLS,
            sor2d.TILED_LAUNCHES) == (before[0] + win, before[1] + cells_,
                                      before[2] + 1)
