# -*- coding: utf-8 -*-
"""The launch plan of batches over 65 535 slices (fault 8), on the CPU:
the tiled kernel's grid z, ceil(B / spb), stays at or under the grid's
65 535 in both branches of ``ops.sor2d._slices_per_block`` (planes one a
slice; planes the batch shares).  The kernels themselves run such batches
in tests/test_torch_cuda.py."""
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
