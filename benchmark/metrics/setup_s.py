"""setup_s: from the process's start to the window's."""
from benchmark.harness.readers import setup_s as read  # noqa: F401
