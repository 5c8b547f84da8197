"""Wall ms a round in the ``cohort_build`` phase, ``CohortEngine.build``:
the bucket plan and the host gather of the round's images into the
bucket arrays; the program's spans, averaged over the window's rounds."""
from perfbench.lib.spans import phase_ms


def read(data):
    return phase_ms(data, "cohort_build")
