"""The harness's generic machinery: loading the benchmark's files by name, the
device record, the no-JAX check, seeded weights and the reduction of a profiler
trace."""
