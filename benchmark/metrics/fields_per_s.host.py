"""fields_per_s.host: fields returned a second in the cell whose calls the host paces."""
from benchmark.harness.readers import fields_per_s as read  # noqa: F401
