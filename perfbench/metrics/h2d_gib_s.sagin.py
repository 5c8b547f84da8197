"""The rate of the cohort's copies to the card, in GiB/s: the bytes that
land on the device over the wall time of the window's ``h2d`` phases
(one a bucket dispatch, each fenced by a synchronize in the traced
window)."""
from perfbench.lib.spans import phases


def read(data):
    spans = phases(data, "h2d")
    secs = sum(s["dur_wall"] for s in spans)
    if not spans or secs <= 0:
        return None
    return sum(s["attrs"]["bytes"] for s in spans) / secs / 2 ** 30
