"""The harness: the command line, the profile's reduction, peaks, weights,
comparisons and planted faults."""
