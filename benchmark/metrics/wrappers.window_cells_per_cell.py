"""wrappers.window_cells_per_cell: cells the tiled launches' windows load a
cell they update (moves fields_per_s).

The ratio of xinvert_tpu_torch.ops.sor2d's counters TILED_WINDOW_CELLS
(tiles x winy x winx a slice, every launch) and TILED_CELLS (ny x nx a
slice, every launch), read as the process left them: the warm call and
the run's calls have the same shapes, so the ratio over the process is
the ratio of every launch.  None where the program has no such counters
or ran no tiled launch."""
import sys


def read(run):
    mod = sys.modules.get("xinvert_tpu_torch.ops.sor2d")
    window = getattr(mod, "TILED_WINDOW_CELLS", None)
    cells = getattr(mod, "TILED_CELLS", None)
    if not isinstance(window, int) or not isinstance(cells, int) \
            or cells <= 0:
        return None
    return window / cells
