"""api.host_ms: the API's host time a call (moves fields_per_s)."""
from benchmark.harness.readers import api_host_ms as read  # noqa: F401
