"""Benchmarks of the port."""
