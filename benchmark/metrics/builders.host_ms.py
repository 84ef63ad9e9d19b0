"""builders.host_ms: the builders' host time a call (moves fields_per_s)."""
from benchmark.harness.readers import builders_host_ms as read  # noqa: F401
