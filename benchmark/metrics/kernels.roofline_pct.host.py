"""kernels.roofline_pct.host: the fields' least time over the engine's device time (moves fields_per_s.host)."""
from benchmark.harness.readers import kernels_roofline_pct as read  # noqa: F401
