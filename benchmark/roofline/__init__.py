"""Work counts and kernel names of the roofline metrics."""
