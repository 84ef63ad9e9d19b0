"""wrappers.cross_cell_share: the share of the cells the tiled launches
update that belong to specs with a cross (diagonal) coupling (moves
fields_per_s).

The ratio of xinvert_tpu_torch.ops.sor2d's counters TILED_CROSS_CELLS
(ny x nx a slice, every tiled launch whose spec has an offset with dy != 0
and dx != 0) and TILED_CELLS (ny x nx a slice, every tiled launch), read
as the process left them: the warm call and the run's calls have the same
shapes, so the ratio over the process is the ratio of every launch.  None
where the program has no such counters or ran no tiled launch."""
import sys


def read(run):
    mod = sys.modules.get("xinvert_tpu_torch.ops.sor2d")
    cross = getattr(mod, "TILED_CROSS_CELLS", None)
    cells = getattr(mod, "TILED_CELLS", None)
    if not isinstance(cross, int) or not isinstance(cells, int) \
            or cells <= 0:
        return None
    return cross / cells
