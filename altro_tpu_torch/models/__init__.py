"""Benchmark problem families."""
