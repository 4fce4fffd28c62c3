"""Benchmark of spark_ensemble_tpu_torch: see README.md."""
