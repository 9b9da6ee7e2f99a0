"""The benchmark of altro_tpu_torch (see run.py and BENCHMARK.json)."""
