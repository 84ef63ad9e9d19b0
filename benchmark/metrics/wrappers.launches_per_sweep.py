"""wrappers.launches_per_sweep: kernel launches a sweep (moves fields_per_s)."""
from benchmark.harness.readers import wrappers_launches_per_sweep as read  # noqa: F401
