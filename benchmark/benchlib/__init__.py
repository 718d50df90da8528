"""The benchmark's general code: declarations, seeded inputs and weights,
device readings, the profiler slice, operation counts and the result line.

Nothing here names a cell: a cell is `BENCHMARK.json`'s entry, its
configuration file (`configs/`), its traffic file (`traffic/`), its cell
file (`workloads/`) and the readers of its metrics (`metrics/`), all found
by name.
"""
