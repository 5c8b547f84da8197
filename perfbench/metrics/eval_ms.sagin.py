"""Wall ms a round in the ``evaluate`` phase: the held-out evaluation and
the host's read of its accuracy; the program's spans, averaged over the
window's rounds."""
from perfbench.lib.spans import phase_ms


def read(data):
    return phase_ms(data, "evaluate")
