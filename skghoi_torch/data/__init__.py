"""Fixed-shape batch containers."""
