"""What the examples print, kept for their callers."""
from __future__ import annotations

import argparse
from typing import List


class Lines:
    """``print`` that also keeps every line printed, in order."""

    def __init__(self):
        self.lines: List[str] = []

    def __call__(self, text: str = "") -> None:
        print(text, flush=True)
        self.lines.extend(text.split("\n"))


def add_device(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="where the example runs (default: cuda; it raises "
                         "when no card is visible, pass cpu to run on the "
                         "CPU)")
