"""The port's benchmark: ``python3 perfbench/run.py --workload <name> ...``."""
