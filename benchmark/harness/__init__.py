"""General machinery of the benchmark: cells by name, data, trace, run."""
