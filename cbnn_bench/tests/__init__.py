"""CPU tests of the benchmark (small sizes; no card needed)."""
