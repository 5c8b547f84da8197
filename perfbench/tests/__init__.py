"""CPU tests of the port's benchmark; run with
``python -m pytest -q perfbench/tests`` from the root of the repo."""
