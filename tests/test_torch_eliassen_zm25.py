# -*- coding: utf-8 -*-
"""invert_Eliassen of the port on the benchmark configuration eliassen_zm25
(benchmark/configs/eliassen_zm25.json), on the configuration's cpu_grid
with the benchmark's seeded basic state and forcing, called as a user
calls it (a batch of forcings over ``time`` against one A, B, C set, NaN
below the Antarctic surface):

- in float64 at fixed sweep counts, held to its plain reference
  (benchmark/reference/eliassen_zm25.py);
- in float32 under the configuration's stopping rule, judged as a run
  judges it: within the configuration's limits, where the reference
  computed in bfloat16 fails them;
- in float64 under the source's stopping rule, held to the JAX package's
  invert_Eliassen: the same values and the same sweeps for every slice;

and the tiled launch of its spec at the configuration's 37 x 72 counted
in ``ops.sor2d.TILED_CROSS_CELLS``.
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

import xinvert_tpu as xv  # noqa: E402
import xinvert_tpu_torch as xt  # noqa: E402
from benchmark import calibrate  # noqa: E402
from benchmark.harness import cell as cells  # noqa: E402
from benchmark.harness import judge, window  # noqa: E402
from benchmark.reference import redblack  # noqa: E402
from xinvert_tpu.models import api as japi  # noqa: E402
from xinvert_tpu_torch.grid import Grid  # noqa: E402
from xinvert_tpu_torch.models import api, problems  # noqa: E402
from xinvert_tpu_torch.models.params import default_mParams  # noqa: E402
from xinvert_tpu_torch.ops import sor2d  # noqa: E402
from xinvert_tpu_torch.stencil import prune_zero_offsets  # noqa: E402

CELL = "eliassen_zm25.daily40"
SEEDS = (2 ** 31 + 23, 4_200_000_023)


def small_cell(fields_per_call=3):
    """The cell on its configuration's cpu_grid, ``fields_per_call``
    fields a call and one pool call."""
    c = cells.resolve(CELL)
    c.config = copy.deepcopy(c.config)
    c.config["grid"] = c.config["cpu_grid"]
    c.mix = dict(c.mix, fields_per_call=fields_per_call, pool_calls=1)
    return c


def call(c, seed, dtype, **iparams):
    """(forcings, the program's fields, its sweeps) of one call of
    invert_Eliassen on the CPU in ``dtype``, the configuration's iParams
    updated by ``iparams``."""
    pool, fields, fn, kw = window.prepare(c, window.streams(seed)[0],
                                          device="cpu")
    kw = dict(kw, iParams=dict(kw["iParams"], **iparams))
    f = fields[0]
    old = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        out = fn(xt.Field(f.values.astype(np.float64), f.dims, f.coords),
                 **kw)
    finally:
        torch.set_default_dtype(old)
    return (pool[0], np.asarray(out.values, np.float64),
            np.asarray(api.LAST_SOLVE.iters).ravel())


@pytest.mark.parametrize("seed", SEEDS)
def test_fixed_sweeps_equal_the_reference(seed):
    """120 sweeps (checkEvery = mxLoop = 120) against the reference's
    state after 120 sweeps.  Both sweep in float64 in the same red-black
    order at the grid's optimal factor; they differ only in the order in
    which a point's eight neighbour terms are summed, which moves the last
    bits of each update, so the gap stays at rounding: rtol 1e-10 with an
    atol of 1e-12 of the largest |S| leaves that room and catches any
    term, plane or edge that differs, a diagonal weight among them."""
    c = small_cell()
    vals, out, iters = call(c, seed, torch.float64, mxLoop=120,
                            checkEvery=120, tolerance=1e-30)
    assert (iters == 120).all()
    prob = c.reference.build(c.config, vals.astype(np.float64),
                             torch.float64, "cpu")
    omega = redblack.relaxation(c.reference, vals.shape[1:])
    assert omega == redblack.optimal_omega(vals.shape[1:])
    states = redblack.states_at(prob, omega, [[120]] * len(vals))
    for f in range(len(vals)):
        ref = states[(f, 120)].numpy()
        d = ~np.isnan(vals[f])
        assert (~d).sum() == 24 and np.isnan(out[f][~d]).all()
        np.testing.assert_allclose(out[f][d], ref[d], rtol=1e-10,
                                   atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("seed", SEEDS)
def test_float32_within_the_limits_and_bfloat16_not(seed):
    """The program in float32 under the configuration's stopping rule
    (a check every ``check_window`` sweeps, as on the card), judged against
    the float64 reference as a run judges it: inside every limit of the
    configuration.  The reference itself in bfloat16 in the program's
    place fails at least one of them."""
    c = small_cell()
    cfg, k = c.config, c.mix["fields_per_call"]
    vals, out, iters = call(c, seed, torch.float32,
                            checkEvery=cfg["check_window"])
    answers = [judge.Answer(0, j, out[j], int(iters[j])) for j in range(k)]
    ok, rows = judge.verdict(
        dict(judge.judge(cfg, c.reference, answers, [vals], k, "cpu"),
             mask_mismatch=0), cfg["limits"])
    assert ok, rows
    ctrl = calibrate.control_answers(c, answers, [vals], "cpu",
                                     torch.bfloat16)
    bad, rows = judge.verdict(
        dict(judge.judge(cfg, c.reference, ctrl, [vals], k, "cpu"),
             mask_mismatch=0), cfg["limits"])
    assert not bad, rows


def test_batch_matches_the_jax_package():
    """Three forcings with the NaN block over ``time``, A, B and C as
    Fields over (LEV, lat), the source's iParams (tolerance 1e-10, mxLoop
    600, the grid's optimal factor): the port's plain path and the JAX
    package's invert_Eliassen in float64 give the same NaN pattern, values
    to rtol 1e-11 and equal sweeps for every slice."""
    c = small_cell()
    cfg = c.config
    vals = c.inputs.fields(cfg, 3, window.streams(SEEDS[0])[0]).astype(
        np.float64)
    co = c.inputs.coords(cfg)
    dims = ("time",) + tuple(cfg["dims"])
    ip = dict(cfg["iParams"], undef=np.nan)

    def run(pkg):
        mp = {k: pkg.Field(*v) for k, v in c.inputs.mparams(cfg).items()}
        f = pkg.Field(vals, dims, dict(co, time=np.arange(3.0)))
        kw = {"device": "cpu"} if pkg is xt else {}
        return pkg.invert_Eliassen(f, dims=list(cfg["dims"]),
                                   coords=cfg["coords"], mParams=mp,
                                   iParams=ip, **kw)
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        out_t = run(xt)
    finally:
        torch.set_default_dtype(old)
    out_j = run(xv)
    assert out_t.dims == out_j.dims == dims
    nt, nj = np.isnan(out_t.values), np.isnan(out_j.values)
    np.testing.assert_array_equal(nt, nj)
    assert nt.sum() == 3 * 24
    a, b = out_t.values[~nt], np.asarray(out_j.values)[~nj]
    np.testing.assert_allclose(a, b, rtol=1e-11, atol=1e-11 * np.abs(b).max())
    it_t = np.asarray(api.LAST_SOLVE.iters).ravel()
    it_j = np.asarray(japi.LAST_SOLVE.iters).ravel()
    np.testing.assert_array_equal(it_t, it_j)
    assert (it_t < int(ip["mxLoop"])).all()


def test_tiled_launch_counts_its_cross_cells(monkeypatch):
    """invert_Eliassen's spec on the configuration's 37 x 72 grid keeps
    its four diagonal offsets; its plan (k 4, 8 x 64 tiles in 24 x 80
    windows) loads 7.21 cells a cell, and ``_launch_tiled`` (a stand-in
    launcher: the kernel runs on the card only) adds the launch's updated
    cells to TILED_CROSS_CELLS as to TILED_CELLS.  The spec without its
    cross planes adds nothing there."""
    c = cells.resolve(CELL)
    cfg = c.config
    co = c.inputs.coords(cfg)
    grid = Grid.make(tuple(cfg["dims"]), [co[d] for d in cfg["dims"]],
                     cfg["coords"], bcs=tuple(cfg["iParams"]["BCs"]))
    mp = dict(default_mParams,
              **{k: v[0] for k, v in c.inputs.mparams(cfg).items()})
    F = torch.zeros((2,) + grid.shape)
    Fdef = torch.as_tensor(~c.inputs.undefined(cfg))
    spec = prune_zero_offsets(problems.build_eliassen(F, Fdef, grid, mp))
    axis = prune_zero_offsets(problems.build_eliassen(
        F, Fdef, grid, dict(mp, B=0.0)))
    assert sorted(spec.offsets) == sorted(c.reference.OFFSETS)
    assert len(axis.offsets) == 4
    core = grid.shape
    plan = sor2d.tile_plan(spec, core, torch.float32)
    assert (plan.k, plan.ty, plan.tx, plan.winy, plan.winx) == (4, 8, 64,
                                                                24, 80)
    win, cells_ = sor2d.tiled_cells(plan, 2, core)
    assert win / cells_ == pytest.approx(19200 / 2664)
    for name in ("TILED_CROSS_CELLS", "TILED_CELLS"):
        monkeypatch.setattr(sor2d, name, 0)
    lay = dict(B=2, core=core, K=len(spec.offsets), sms=132,
               dy=(ctypes.c_int * sor2d.MAX_K)(),
               dx=(ctypes.c_int * sor2d.MAX_K)(), w_kstride=0, w_bstride=0,
               w0_bstride=0, g_bstride=0, relax_bstride=0, stream=None,
               tiled_fn=lambda *a: 0)
    S = torch.zeros((2,) + core)
    for s in (spec, axis):
        sor2d._launch_tiled(s, lay, plan, s.relax, S, S.clone(), 1,
                            [1.0, 1.0])
    assert (sor2d.TILED_CROSS_CELLS, sor2d.TILED_CELLS) == (cells_,
                                                            2 * cells_)
