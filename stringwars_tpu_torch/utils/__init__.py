"""Config (L0), measurement harness (L2), reporting (L3) and the profiler."""
