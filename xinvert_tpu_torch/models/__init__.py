"""Application layer: problem builders, parameters and the invert_* API."""
