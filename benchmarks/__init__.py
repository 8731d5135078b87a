"""Benchmarks and the GPU tuning sweep; see each module."""
