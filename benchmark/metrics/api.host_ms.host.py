"""api.host_ms.host: the API's host time a call (moves fields_per_s.host)."""
from benchmark.harness.readers import api_host_ms as read  # noqa: F401
