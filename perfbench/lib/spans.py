"""The program's ``phase`` spans, as the per-layer readers take them.

``data["spans"]`` holds the traced window's spans as dicts (``Span``'s
fields).  A phase's time a round is the sum of its spans' ``dur_wall``
over the window's rounds (``data["rounds"]``).  Where the program emits
no such span (a program that predates them) every reading is None.
"""


def phases(data, name):
    """The window's ``phase`` spans named ``name``."""
    return [s for s in data.get("spans", ())
            if s["kind"] == "phase" and s["name"] == name]


def phase_ms(data, name):
    """Wall ms a round in the ``name`` phases; None without them."""
    spans = phases(data, name)
    if not spans or not data.get("rounds"):
        return None
    return 1000.0 * sum(s["dur_wall"] for s in spans) / len(data["rounds"])
