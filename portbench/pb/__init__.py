"""The harness of the port's benchmark: the cell's files found by name,
the synthetic data and seeded weights, the phases that drive the port's own
loops through a measured window, the trace's reduction, the operation and
byte counts, and the comparison that decides ``correct``."""
