"""Wall ms a round in the ``plan`` phase, ``RegionTrainer.step`` around the
orchestrator's step: dynamics, the offloading plan and the handover
schedule; the program's spans, averaged over the window's rounds."""
from perfbench.lib.spans import phase_ms


def read(data):
    return phase_ms(data, "plan")
