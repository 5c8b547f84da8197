"""Wall ms a round in the ``optimize`` phase inside the plan: the adaptive
offloading optimizer (the strategy's ``_plan_round``); the program's
spans, averaged over the window's rounds."""
from perfbench.lib.spans import phase_ms


def read(data):
    return phase_ms(data, "optimize")
