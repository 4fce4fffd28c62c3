"""Plain references the benchmark judges the program against."""
