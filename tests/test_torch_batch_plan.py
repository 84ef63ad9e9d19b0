# -*- coding: utf-8 -*-
"""The launch plan of batches over 65 535 slices (fault 8), on the CPU:
the tiled kernel's grid z, ceil(B / spb), stays at or under the grid's
65 535 in both branches of ``ops.sor2d._slices_per_block`` (planes one a
slice; planes the batch shares).  The kernels themselves run such batches
in tests/test_torch_cuda.py.  The decade cell's slice walk: the slice
windows its launches stage, and the stage the wrapper passes the kernel."""
import ctypes

import pytest

torch = pytest.importorskip("torch")

from xinvert_tpu_torch.ops import sor2d  # noqa: E402
from xinvert_tpu_torch.stencil import StencilSpec  # noqa: E402

P4 = ((1, 0), (-1, 0), (0, 1), (0, -1))


def _spec(core):
    z = torch.zeros(core, dtype=torch.float32)
    return StencilSpec(w=torch.zeros((4,) + core), w0=z, g=z, relax=z,
                       active=torch.ones(core, dtype=torch.bool),
                       offsets=P4, bcs=("extend", "periodic"), bih=False,
                       stop_on_zero_norm=False)


@pytest.mark.parametrize("B", [1, 65535, 65536, 70080, 3 * 65535 + 1])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("core", [(8, 8), (73, 144), (2048, 2048)])
def test_grid_z_within_the_limit(B, shared, core):
    plan = sor2d.tile_plan(_spec(core), core, torch.float32)
    vol = core[0] * core[1]
    lay = {"B": B, "core": core, "sms": 132}
    for p in ("w", "w0", "g", "relax"):
        lay[f"{p}_bstride"] = 0 if shared else vol
    if shared:
        lay["g_bstride"] = vol      # a batched forcing, shared weights
    spb = sor2d._slices_per_block(lay, plan, None)
    z = -(-B // spb)
    assert spb >= 1 and z <= 65535
    assert (z - 1) * spb < B <= z * spb      # every slice walked once


# ------------------------------------------- the staged walk of the decade

#: the pruned Stommel-Munk stencil of the decade cell (radius 2, the
#: biharmonic's two-row extend)
MUNK8 = ((2, 0), (1, 0), (-1, 0), (-2, 0), (0, 2), (0, 1), (0, -1), (0, -2))
DECADE = (120, 330, 720)


def _decade_lay(B):
    """The decade cell's layout on an H100 (132 SMs): one land mask, so w,
    w0 and relax are shared and g varies a slice."""
    vol = DECADE[1] * DECADE[2]
    return {"B": B, "core": DECADE[1:], "sms": 132, "w_bstride": 0,
            "w0_bstride": 0, "relax_bstride": 0, "g_bstride": vol}


def _munk_spec():
    core = DECADE[1:]
    z = torch.zeros(core, dtype=torch.float32)
    return StencilSpec(w=torch.zeros((8,) + core), w0=z, g=z, relax=z,
                       active=torch.ones(core, dtype=torch.bool),
                       offsets=MUNK8, bcs=("extend", "periodic"), bih=True,
                       stop_on_zero_norm=False)


def test_decade_walk_stages_118_of_120_slices():
    """The decade's plan (16 x 64 tiles in 28 x 72 windows, 252 tiles) and
    walk (two groups of 60 slices a tile): 118 x 252 of the 120 x 252 slice
    windows load while the slice before them sweeps."""
    plan = sor2d.tile_plan(_munk_spec(), DECADE[1:], torch.float32)
    assert (plan.k, plan.winy, plan.winx, plan.stage) == (1, 28, 72, True)
    assert plan.tiles(DECADE[1:]) == (21, 12)
    spb = sor2d._slices_per_block(_decade_lay(120), plan, None)
    assert spb == 60
    assert sor2d.tiled_slices(plan, 120, spb, DECADE[1:]) == (
        118 * 252, 120 * 252)


@pytest.mark.parametrize("B,stage,staged", [(120, 1, 118), (1, 0, 0)])
def test_tiled_launch_stages_its_walk(monkeypatch, B, stage, staged):
    """``_launch_tiled`` pipelines the slice walk (TiledParams.stage) where
    its blocks walk more than one slice, and adds ``tiled_slices`` to
    TILED_SLICES and TILED_STAGED_SLICES (a stand-in launcher: the kernel
    runs on the card only)."""
    spec = _munk_spec()
    plan = sor2d.tile_plan(spec, DECADE[1:], torch.float32)
    for name in ("TILED_SLICES", "TILED_STAGED_SLICES"):
        monkeypatch.setattr(sor2d, name, getattr(sor2d, name))
    got = []
    lay = dict(_decade_lay(B), K=8, dy=(ctypes.c_int * sor2d.MAX_K)(),
               dx=(ctypes.c_int * sor2d.MAX_K)(), w_kstride=0, stream=None,
               tiled_fn=lambda *a: got.append(a[7]._obj.stage) or 0)
    S = torch.zeros(1)
    before = (sor2d.TILED_SLICES, sor2d.TILED_STAGED_SLICES)
    sor2d._launch_tiled(spec, lay, plan, spec.relax, S, S.clone(), 1,
                        [1.0, 1.0])
    assert got == [stage]
    assert (sor2d.TILED_SLICES, sor2d.TILED_STAGED_SLICES) == (
        before[0] + 252 * B, before[1] + 252 * staged)
