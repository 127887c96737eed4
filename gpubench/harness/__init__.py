"""The cell-independent parts of the benchmark: the manifest, statistics,
trace reading, inputs, the comparison with the reference and the run."""
