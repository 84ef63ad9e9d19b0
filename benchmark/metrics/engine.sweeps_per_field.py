"""engine.sweeps_per_field: sweeps the engine reports a field (moves fields_per_s)."""
from benchmark.harness.readers import engine_sweeps_per_field as read  # noqa: F401
