"""Plain references of the benchmark: they import nothing of the program."""
