"""Operation and byte counts of the kernels whose rooflines the metrics
read, counted by the benchmark from a frame's data, never from the
program's own work lists."""
