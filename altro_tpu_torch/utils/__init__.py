"""Utilities: the LQR test oracles (numpy) and timing and tracing helpers."""
