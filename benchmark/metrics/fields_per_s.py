"""fields_per_s: fields returned a second in the cell whose calls the card paces."""
from benchmark.harness.readers import fields_per_s as read  # noqa: F401
