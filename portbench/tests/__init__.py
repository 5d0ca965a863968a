"""CPU tests of the benchmark harness (card-only ones carry the cuda marker)."""
