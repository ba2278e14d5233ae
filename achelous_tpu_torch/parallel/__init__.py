"""Data parallelism across processes: the process group, the global-batch
reductions and a launcher of ranks."""
