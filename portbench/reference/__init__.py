"""Frozen plain references the benchmark holds the port to."""
