"""Shared pieces of the harness: files by name, weights and traffic from the
seed, the profiler's arithmetic and the kernels' bounds."""
