"""kernels.roofline_pct: the fields' least time over the engine's device time (moves fields_per_s)."""
from benchmark.harness.readers import kernels_roofline_pct as read  # noqa: F401
