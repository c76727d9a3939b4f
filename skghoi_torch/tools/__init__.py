"""Command-line tools of the port: train, evaluate, cache results."""
