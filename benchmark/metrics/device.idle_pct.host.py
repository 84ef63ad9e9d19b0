"""device.idle_pct.host: the card's idle share of the traced stretch (moves fields_per_s.host)."""
from benchmark.harness.readers import device_idle_pct as read  # noqa: F401
