"""wrappers.staged_slice_share: the share of the tiled launches' slice
windows that load while the slice before them sweeps (moves fields_per_s).

The ratio of xinvert_tpu_torch.ops.sor2d's counters TILED_STAGED_SLICES
(tiles x the slices each block's walk stages, every pipelined launch) and
TILED_SLICES (tiles x B, every tiled launch), read as the process left
them: the warm call and the run's calls have the same shapes, so the ratio
over the process is the ratio of every launch.  None where the program has
no such counters or ran no tiled launch."""
import sys


def read(run):
    mod = sys.modules.get("xinvert_tpu_torch.ops.sor2d")
    staged = getattr(mod, "TILED_STAGED_SLICES", None)
    slices = getattr(mod, "TILED_SLICES", None)
    if not isinstance(staged, int) or not isinstance(slices, int) \
            or slices <= 0:
        return None
    return staged / slices
