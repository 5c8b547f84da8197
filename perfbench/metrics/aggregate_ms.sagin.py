"""Wall ms a round in the ``aggregate`` phase: the eq.-(13) weights and the
``fedavg_agg`` launch, fenced by a synchronize (``device_timing``); the
program's spans, averaged over the window's rounds."""
from perfbench.lib.spans import phase_ms


def read(data):
    return phase_ms(data, "aggregate")
