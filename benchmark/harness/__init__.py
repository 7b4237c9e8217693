"""What the benchmark's drivers share: finding files by name, seeded
weights, the wrappers, the trace and the checks."""
